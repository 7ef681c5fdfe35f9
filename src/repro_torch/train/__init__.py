"""repro_torch.train — the train step, checkpoints and the straggler
watchdog.

loop        TrainConfig, make_train_step
checkpoint  save_checkpoint, restore_checkpoint, latest_step (the
            reference's byte format)
watchdog    StragglerWatchdog
"""
from repro_torch.train.loop import TrainConfig, make_train_step  # noqa: F401
from repro_torch.train.checkpoint import save_checkpoint, restore_checkpoint  # noqa: F401
from repro_torch.train.watchdog import StragglerWatchdog  # noqa: F401

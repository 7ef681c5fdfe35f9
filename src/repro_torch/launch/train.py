"""Training driver: data pipeline -> train step -> checkpoint/restart ->
straggler watchdog.

The counterpart of ``repro.launch.train`` on one device:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_4b --smoke \\
      --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--device cpu]

Runs on CUDA unless ``--device`` names another device.  A restart with the
same ``--ckpt-dir`` resumes from the latest atomic checkpoint, and the
data pipeline replays the steps after it.  Model parallelism
(``--tp > 1``) and more than one process wait for the port of
``dist/sharding.py`` (ROADMAP item 20 (c)) and raise.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import configs
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train.checkpoint import (latest_step, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.loop import TrainConfig, make_train_step
from repro_torch.train.watchdog import StragglerWatchdog


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3_4b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--wbits", type=int, nargs="+", default=[8])
    ap.add_argument("--abits", type=int, nargs="+", default=[8])
    ap.add_argument("--tp", type=int, default=1,
                    help="model-parallel ways (only 1 is ported)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    world = (torch.distributed.get_world_size()
             if torch.distributed.is_available()
             and torch.distributed.is_initialized() else 1)
    if args.tp > 1 or world > 1:
        raise NotImplementedError(
            f"--tp {args.tp} on a world of {world}: sharded training waits "
            f"for the port of dist/sharding.py (ROADMAP item 20 (c)); the "
            f"launcher trains on one device")
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=args.lr),
                       n_accum=args.accum,
                       wbits=tuple(args.wbits), abits=tuple(args.abits))
    return run(args, cfg, tcfg, cm.resolve_device(args.device))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args, cfg, tcfg: TrainConfig, dev: torch.device) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init_params(cfg, gen, device=dev)
    opt = adamw_init(params, tcfg.optimizer)
    step_fn, _ = make_train_step(tcfg, cfg, device=dev)
    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        restored, start = restore_checkpoint(
            args.ckpt_dir, {"params": params, "opt": opt}, device=dev)
        params, opt = restored["params"], restored["opt"]
        print(f"[train] resumed from step {start}")

    data = SyntheticLM(seed=0, batch=args.batch, seq_len=args.seq + 1,
                       vocab=cfg.vocab_size, cfg=cfg, start_step=start,
                       device=dev)
    wd = StragglerWatchdog()
    t_start = time.time()
    step, loss = start - 1, float("nan")
    try:
        for _ in range(args.steps):
            step, batch = next(data)
            wd.start()
            params, opt, metrics = step_fn(params, opt, batch)
            _sync(dev)                   # a step's time is the device's
            dt = wd.stop(step)
            loss = float(metrics["loss"])
            if step % args.log_every == 0 or step == start:
                print(f"[train] step={step} loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} {dt:.2f}s")
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                save_checkpoint(args.ckpt_dir, step + 1,
                                {"params": params, "opt": opt})
                print(f"[train] checkpoint @ {step + 1}")
    finally:
        data.close()
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, step + 1,
                        {"params": params, "opt": opt})
    print(f"[train] done: {args.steps} steps in {time.time() - t_start:.1f}s;"
          f" stragglers flagged: {len(wd.events)}")
    out = {"final_loss": loss, "steps": args.steps, "start": start,
           "device": str(dev)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

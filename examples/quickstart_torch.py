"""Quickstart on the PyTorch port: train a tiny bit-fluid LM, quantize it,
serve it at two runtime precisions — the whole paper pipeline in one
script (the counterpart of ``examples/quickstart.py``).

  PYTHONPATH=src python examples/quickstart_torch.py            # CUDA
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Weights are random (seed 0, drawn on the CPU and placed on the device).
The engine runs eagerly, so where the reference prints its compiled
program counts this prints the model forwards it ran.  ``main(argv)``
returns the host numbers it printed.
"""
import argparse

import torch

from repro_torch import configs
from repro_torch.core import policy as pol
from repro_torch.data.pipeline import make_batch
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.loop import TrainConfig, make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    dev = cm.resolve_device(ap.parse_args(argv).device)
    cfg = configs.get_smoke("qwen3_4b")
    print(f"model: {cfg.name} (smoke) — {cfg.n_layers}L d={cfg.d_model}")

    # ---- 1. mixed-precision training (per-layer bits are runtime data)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-2),
                       wbits=(8, 4), abits=(8,))     # layer0=8b, rest 4b
    step_fn, _ = make_train_step(tcfg, cfg, device=dev)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device=dev)
    opt = adamw_init(params, tcfg.optimizer)
    losses = []
    for i in range(20):
        batch = {k: v.to(dev) for k, v in
                 make_batch(0, i, 8, 65, cfg.vocab_size).items()}
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        if i % 5 == 0:
            print(f"  step {i:3d}  loss {losses[-1]:.3f}")

    # ---- 2. quantize once, serve at ANY precision (dyadic requant)
    qparams = lm.quantize_params(params, cfg)
    n = lm.n_bit_slots(cfg)
    ctrl = pol.BudgetController(
        {"int4": pol.fixed(4), "int8": pol.fixed(8)},
        {"int4": 1.0, "int8": 2.0}, n)
    eng = ServeEngine(cfg, qparams, max_len=128, controller=ctrl,
                      device=dev)
    batch = {"tokens": make_batch(0, 99, 2, 17, cfg.vocab_size)["tokens"]}

    served, steps = {}, 8
    for name, budget in (("int8", 10.0), ("int4", 0.5)):
        eng.set_budget(budget)  # loose budget -> int8, tight -> int4
        out = eng.generate(batch, steps=steps).cpu()
        wv, _ = ctrl.resolve(torch.tensor(budget))
        served[name] = {"budget_s": budget,
                        "mean_wbits": float(wv.float().mean()),
                        "tokens": out.tolist()}
    print(f"  int8 tokens: {served['int8']['tokens'][0]}")
    print(f"  int4 tokens: {served['int4']['tokens'][0]}")
    print(f"  model forwards: prefill x{len(served)}, decode "
          f"x{len(served) * (steps - 1)} (eager: nothing is compiled; the "
          f"precision switched between calls with no rebuild of any "
          f"kernel)")
    return {"losses": losses, "served": served}


if __name__ == "__main__":
    main()

"""Table VII end-to-end on the PyTorch port, through the real kernels (the
counterpart of ``examples/mixed_precision_resnet18.py``): HAWQ-V3's
per-layer INT4/INT8 ResNet18 configs run (a) the serve-form CNN — weights
quantized once into int8 containers, every conv-as-GEMM dispatched
through ``ops.serve_linear`` with the bit vector as a tensor, so all five
configs run the bit-plane kernel at the container width — and (b) the
BF-IMNA simulator (hardware cost path): accuracy proxy vs EDP trade-off,
plus a mixed-budget batch through the CNN serving engine with
per-request EDP.

  PYTHONPATH=src python examples/mixed_precision_resnet18_torch.py   # CUDA
  PYTHONPATH=src python examples/mixed_precision_resnet18_torch.py --device cpu

Weights are random (seed 0, drawn on the CPU and placed on the device).
The engine runs eagerly: where the reference prints its trace counts,
this prints the bit-plane kernel's launches by plane count (none on the
CPU) and the engine's forwards.  ``main(argv)`` returns the host numbers
it printed.
"""
import argparse

import numpy as np
import torch

from repro_torch.apsim.energy import SRAM
from repro_torch.apsim.mapper import LR_CONFIG, simulate_network
from repro_torch.apsim.workloads import (HAWQV3_METADATA, HAWQV3_RESNET18,
                                         per_layer_bits, resnet18)
from repro_torch.core import policy as pol
from repro_torch.models import cnn
from repro_torch.models import common as cm
from repro_torch.serve.cnn import CNNServeEngine, hawq_fidelity_sweep


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    dev = cm.resolve_device(ap.parse_args(argv).device)
    gen = torch.Generator().manual_seed(0)
    params, layers = cnn.init_cnn("resnet18", gen, image=32, device=dev)
    x = torch.randn((4, 32, 32, 3), generator=gen).to(dev)

    # functional: quantize/prepack once, run every HAWQ config through
    # the serve-form kernels (fidelity vs fp)
    fid, launches = hawq_fidelity_sweep(image=32, batch=4, device=dev)

    sim_layers = resnet18()
    print(f"{'config':8s} {'avg_b':>6s} {'fidelity':>9s} "
          f"{'EDP(J.s)':>10s} {'norm_E':>7s} {'top1[53]':>8s}")
    base = simulate_network(sim_layers, LR_CONFIG, SRAM, bits=8)
    table = {}
    for name in ("int4", "low", "medium", "high", "int8"):
        vec = HAWQV3_RESNET18[name]
        # hardware: the paper's simulator on the same bit vector
        rep = simulate_network(sim_layers, LR_CONFIG, SRAM,
                               bits=list(vec), network="resnet18")
        meta = HAWQV3_METADATA[name]
        avg_b = float(np.mean(per_layer_bits(layers, vec)))
        print(f"{name:8s} {avg_b:6.2f} "
              f"{fid[name]:9.4f} {rep.edp:10.3e} "
              f"{rep.energy_j / base.energy_j:7.3f} {meta['top1']:8.2f}")
        table[name] = {"avg_bits": avg_b, "fidelity": fid[name],
                       "edp": rep.edp,
                       "norm_energy": rep.energy_j / base.energy_j}
    print(f"\nall five configs ran through the serve-form kernels "
          f"(bit-plane launches by plane count: {launches}; the bits are "
          f"tensors, so every GEMM runs at the container width); higher "
          f"bits -> higher fidelity & higher EDP: the Table VII trade-off "
          f"through the real kernels.")

    # ---- batched serving: per-image budgets -> per-request EDP ----------
    ctrl = pol.cnn_budget_controller("resnet18", layers=layers)
    eng = CNNServeEngine(params, layers, controller=ctrl, max_batch=4,
                         device=dev)
    preds = ctrl.predicted_latency_s
    budgets = [preds["hawqv3-int4"] * 1.01, preds["hawqv3-medium"] * 1.01,
               preds["hawqv3-high"] * 1.01, preds["hawqv3-int8"] * 1.01]
    logits, stats = eng.serve(x, budgets)
    print(f"\nmixed-budget batch (EDP budgets, J·s) — "
          f"{eng.stats.batches} forward")
    mixed = []
    for s in stats:
        print(f"  img{s.index}: budget={s.budget:.2e} "
              f"mean_wbits={s.mean_wbits:.2f} "
              f"ap_latency={s.ap_latency_s * 1e6:7.1f}us "
              f"ap_energy={s.ap_energy_j * 1e3:6.3f}mJ edp={s.edp:.3e}")
        mixed.append({"budget": s.budget, "mean_wbits": s.mean_wbits,
                      "ap_latency_s": s.ap_latency_s,
                      "ap_energy_j": s.ap_energy_j, "edp": s.edp})

    # ---- closed loop: the SLO picks the precision (DESIGN.md §8) --------
    # no per-image budgets at all — a FluidController charges each image's
    # priced cost against a tight system-level EDP window, so the batch
    # degrades precision image by image to honor it
    slo = 4 * preds["hawqv3-int8"] * 0.7
    fluid = pol.FluidController.from_open_loop(ctrl, slo=slo, window=4)
    eng2 = CNNServeEngine(params, layers, controller=fluid, max_batch=4,
                          device=dev)
    _, stats2 = eng2.serve(x)
    print(f"\nclosed loop (EDP SLO {slo:.3e} J·s for the batch, no "
          f"per-image budgets) — {eng2.stats.batches} forward")
    closed = []
    for s in stats2:
        print(f"  img{s.index}: headroom={s.budget:.2e} "
              f"mean_wbits={s.mean_wbits:.2f} edp={s.edp:.3e}")
        closed.append({"budget": s.budget, "mean_wbits": s.mean_wbits,
                       "edp": s.edp})
    spent = sum(s.edp for s in stats2)
    print(f"spent {spent:.3e} of {slo:.3e} J·s")
    return {"hawq": table, "mixed": mixed, "closed_loop": closed,
            "slo": slo, "spent": spent, "launches": launches,
            "logits_finite": bool(np.isfinite(logits).all())}


if __name__ == "__main__":
    main()

"""Per-request dynamic mixed-precision serving on the PyTorch port (paper
§V.B, at request granularity; the counterpart of
``examples/bitfluid_serving.py``): a continuous-batching slot pool and a
BudgetController that turns each request's latency budget into its own
per-layer bit vector — precision is runtime data, so interactive
traffic, background traffic, and everything between share one engine.

Act two closes the loop (DESIGN.md §8): the same stream under a
system-level EDP SLO with a FluidController — every admission's priced
AP cost is charged against the window, and later requests resolve from
the REMAINING budget, degrading precision live.

  PYTHONPATH=src python examples/bitfluid_serving_torch.py            # CUDA
  PYTHONPATH=src python examples/bitfluid_serving_torch.py --device cpu

Weights are random (seed 0, drawn on the CPU and placed on the device).
``main(argv)`` returns the host numbers it printed.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import policy as pol
from repro_torch.data.pipeline import make_batch
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.serve import aggregate, predict_table
from repro_torch.serve.engine import ServeEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    dev = cm.resolve_device(ap.parse_args(argv).device)
    cfg = configs.get_smoke("stablelm_12b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device=dev)
    qparams = lm.quantize_params(params, cfg)
    n = lm.n_bit_slots(cfg)

    # three registered configurations, as in Table VII; predicted
    # latencies come from the hardware model (here: bit-proportional)
    ctrl = pol.BudgetController(
        configs={"int4": pol.fixed(4),
                 "mixed": pol.per_layer([8, 4], name="mixed"),
                 "int8": pol.fixed(8)},
        predicted_latency_s={"int4": 0.5, "mixed": 0.75, "int8": 1.0},
        n_layers=n)
    eng = ServeEngine(cfg, qparams, max_len=128, controller=ctrl,
                      n_slots=2, prefill_len=16, decode_block=4, device=dev)

    # a mixed stream: relaxed analytics traffic, normal chat traffic, and
    # tight-SLO autocomplete traffic, interleaved — more requests than
    # slots, so the scheduler continuously admits into freed slots
    workload = [
        ("analytics (budget 2.0) ", 2.0, 0.0, 0),
        ("chat      (budget 0.8) ", 0.8, 0.8, 8),
        ("complete  (budget 0.4) ", 0.4, 0.0, 0),
        ("chat      (budget 0.8) ", 0.8, 0.8, 8),
        ("complete  (budget 0.4) ", 0.4, 0.0, 0),
    ]
    t0 = time.time()
    rids = {}
    for i, (desc, budget, temp, top_k) in enumerate(workload):
        prompt = np.asarray(make_batch(1, i, 1, 12, cfg.vocab_size)
                            ["tokens"][0])
        rids[eng.submit(prompt, max_new_tokens=6, budget_s=budget,
                        temperature=temp, top_k=top_k)] = desc
    results = eng.run()
    open_loop = []
    for rid, desc in rids.items():
        st = results[rid]
        print(f"{desc}: served at mean {st.mean_wbits:.1f} weight bits "
              f"on slot {st.slot} -> tokens={st.tokens} "
              f"(AP EDP {st.edp:.2e} J·s)")
        open_loop.append({"budget_s": st.budget_s,
                          "mean_wbits": st.mean_wbits, "slot": int(st.slot),
                          "edp": st.edp, "tokens": list(st.tokens)})
    print(f"\n{eng.stats.tokens} tokens, {len(workload)} requests, "
          f"{eng.pool.n_slots} slots, {time.time() - t0:.2f}s wall")
    print(f"model forwards: prefill x{eng.calls['prefill']}, decode "
          f"x{eng.calls['decode']} — per-request budgets, slot churn, and "
          f"sampling params are runtime data (eager: nothing is compiled).")

    # ---- act two: the same stream, closed-loop, under an EDP SLO --------
    # predictions are deliberately optimistic (half the priced cost): an
    # open loop would trust them and overspend; the FluidController sees
    # every admission's actual charge and adapts the tail of the stream
    preds = predict_table(lm.layer_gemm_dims(cfg), ctrl.configs,
                          axis="edp", units=12 + 6,   # tokens per request
                          head=lm.head_gemm_dims(cfg), optimism=0.5)
    slo = len(workload) * preds["int8"] * 1.2       # tight system budget
    fluid = pol.FluidController(ctrl.configs, preds, n, budget_axis="edp",
                                slo=slo, window=len(workload))
    eng2 = ServeEngine(cfg, qparams, max_len=128, controller=fluid,
                       n_slots=2, prefill_len=16, decode_block=4, device=dev)
    rids2 = [eng2.submit(np.asarray(make_batch(1, i, 1, 12, cfg.vocab_size)
                                    ["tokens"][0]), max_new_tokens=6)
             for i in range(len(workload))]         # no budgets: SLO drives
    results2 = eng2.run()
    print(f"\nclosed loop (EDP SLO {slo:.2e} J·s over "
          f"{len(workload)} requests):")
    closed = []
    for i, rid in enumerate(rids2):
        st = results2[rid]
        print(f"  req{i}: {st.mean_wbits:.1f} mean wbits, "
              f"EDP {st.edp:.2e} J·s")
        closed.append({"mean_wbits": st.mean_wbits, "edp": st.edp})
    agg = aggregate(results2.values())
    print(f"spent {agg['edp']:.2e} of {slo:.2e} J·s "
          f"({agg['edp'] / slo:.2f}x SLO) — precision degraded mid-stream "
          f"to honor the budget (model forwards: prefill "
          f"x{eng2.calls['prefill']}, decode x{eng2.calls['decode']}).")
    return {"open_loop": open_loop, "closed_loop": closed, "slo": slo,
            "spent": agg["edp"]}


if __name__ == "__main__":
    main()

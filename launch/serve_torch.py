"""Replay a synthesized traffic trace through one bit-fluid LM server, on
the PyTorch port (the counterpart of ``launch/serve.py``, with the same
flags plus ``--device``: CUDA unless it names another).

The CLI front end of the trace-driven traffic harness (DESIGN.md §9):
synthesize a seeded arrival schedule (``--trace poisson | diurnal |
spike | mmpp``, or ``--trace file --trace-file arrivals.jsonl`` to
import one), register every arrival with ``ServeRuntime.submit_at`` (the
runtime enqueues it when its scheduler clock reaches the arrival tick —
never all-up-front), pump ``run()``, and print the collector's report:
SLO attainment, p50/p99 latency (scheduler ticks) and EDP, queue depth
over time, unserved counts, and mean resolved bits per window.

By default the engine runs the closed loop: a FluidController with
deliberately optimistic predictions (``--optimism 0.5``) under a tight
whole-stream EDP SLO (``--slo-x`` times the predicted int8 cost), so a
spike trace visibly degrades bits mid-burst.  ``--open`` serves the same
trace open-loop for comparison; ``--window-ticks N`` switches to a rate
SLO (budget per N scheduler ticks — the diurnal experiment's shape).

The engine runs eagerly, so where the reference prints its compiled
program counts this prints the model forwards it ran.  The weights are
random (the SMOKE config, seed 0, drawn on the device); the engine has no
EOS, so the report does not depend on them.  ``main(argv)`` returns the
report.

  PYTHONPATH=src python launch/serve_torch.py --trace spike --ticks 24 --rate 0.8
  PYTHONPATH=src python launch/serve_torch.py --trace diurnal --window-ticks 6
  PYTHONPATH=src python launch/serve_torch.py --trace mmpp --ticks 48 --rate 0.5
  PYTHONPATH=src python launch/serve_torch.py --trace file --trace-file t.jsonl
  PYTHONPATH=src python launch/serve_torch.py --trace poisson --open --out rep.json
  PYTHONPATH=src python launch/serve_torch.py --trace spike --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import configs
from repro_torch.core import policy as pol
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.serve import predict_table
from repro_torch.serve import traffic as tf
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.prefix_cache import PrefixCache


def build_engine(cfg, qparams, n, *, slo, window, window_ticks, optimism,
                 open_loop, prompt_len, max_new, slots, prefix_cache=None,
                 device="cuda"):
    cfgs = {"int4": pol.fixed(4), "int8": pol.fixed(8)}
    preds = predict_table(lm.layer_gemm_dims(cfg), cfgs, axis="edp",
                          units=prompt_len + max_new,
                          head=lm.head_gemm_dims(cfg), optimism=optimism)
    # open loop = an unconstrained fluid controller (slo=inf): same code
    # path and trace shape, but no feedback — it trusts the table blindly
    ctrl = pol.FluidController(
        cfgs, preds, n, budget_axis="edp",
        slo=float("inf") if open_loop else slo(preds), window=window,
        window_ticks=0 if open_loop else window_ticks)
    return ServeEngine(cfg, qparams, max_len=64, controller=ctrl,
                       n_slots=slots, prefill_len=prompt_len,
                       decode_block=max_new,
                       prefix_cache=prefix_cache, device=device), preds


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--trace", default="spike",
                    choices=("poisson", "diurnal", "spike", "mmpp",
                             "file"))
    ap.add_argument("--trace-file", default=None,
                    help="JSONL arrival schedule for --trace file "
                         "(one {'t': tick, ...} object per line)")
    ap.add_argument("--mmpp-up", type=float, default=0.08,
                    help="mmpp calm→bursty transition probability")
    ap.add_argument("--mmpp-down", type=float, default=0.25,
                    help="mmpp bursty→calm transition probability")
    ap.add_argument("--ticks", type=int, default=24)
    ap.add_argument("--rate", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repetition", type=float, default=0.0,
                    help="unique-vs-repeated request mix in [0, 1)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="serve through the cross-request prefix/KV-"
                         "cache tier and print its hit/miss ledger")
    ap.add_argument("--cache-capacity", type=int, default=32,
                    help="prefix-cache entries (repetition-aware "
                         "eviction past this)")
    ap.add_argument("--cache-chunk", type=int, default=4,
                    help="prefix-cache chunk alignment for partial hits")
    ap.add_argument("--hit-policy", default="at_least",
                    choices=("exact", "at_least", "repriced"),
                    help="precision gate for cache hits")
    ap.add_argument("--burst-mag", type=float, default=10.0)
    ap.add_argument("--burst-len", type=int, default=3)
    ap.add_argument("--depth", type=float, default=0.9,
                    help="diurnal modulation depth")
    ap.add_argument("--arch", default="qwen3_4b")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--open", action="store_true",
                    help="open-loop baseline instead of the closed loop")
    ap.add_argument("--slo-x", type=float, default=1.2,
                    help="EDP SLO as a multiple of the predicted int8 "
                         "cost of the whole stream (or of one window "
                         "under --window-ticks)")
    ap.add_argument("--window-ticks", type=int, default=0,
                    help=">0: rate SLO per this many scheduler ticks")
    ap.add_argument("--optimism", type=float, default=0.5,
                    help="prediction-table scale (<1 = optimistic: the "
                         "closed loop must correct for it)")
    ap.add_argument("--max-ticks", type=int, default=10_000)
    ap.add_argument("--report-window", type=int, default=6,
                    help="ticks per bits/arrivals reporting window")
    ap.add_argument("--out", default=None, help="also write the report "
                                                "as JSON")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    args = ap.parse_args(argv)
    dev = cm.resolve_device(args.device)

    trace = tf.synth_trace(
        args.trace, ticks=args.ticks, rate=args.rate, seed=args.seed,
        repetition=args.repetition, burst_mag=args.burst_mag,
        burst_len=args.burst_len, depth=args.depth,
        mmpp_up=args.mmpp_up, mmpp_down=args.mmpp_down,
        lm_archs=(args.arch,), prompt_len=args.prompt_len,
        max_new_tokens=args.max_new, path=args.trace_file)
    print(f"trace: {args.trace}, {trace.n_requests} requests over "
          f"{trace.ticks} ticks (seed {args.seed})")

    cfg = configs.get_smoke(args.arch)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    qparams = lm.quantize_params(params, cfg)

    def slo(preds):
        if args.window_ticks:
            return args.window_ticks * args.rate * preds["int8"] * args.slo_x
        return trace.n_requests * preds["int8"] * args.slo_x

    cache = (PrefixCache(chunk=args.cache_chunk,
                         capacity=args.cache_capacity,
                         hit_policy=args.hit_policy)
             if args.prefix_cache else None)
    eng, _ = build_engine(
        cfg, qparams, lm.n_bit_slots(cfg), slo=slo, window=trace.n_requests,
        window_ticks=args.window_ticks, optimism=args.optimism,
        open_loop=args.open, prompt_len=args.prompt_len,
        max_new=args.max_new, slots=args.slots, prefix_cache=cache,
        device=dev)

    meta = {}

    def arrival(req):
        def submit():
            rid = eng.submit(
                tf.payload_tokens(trace, req, cfg.vocab_size),
                max_new_tokens=req.max_new_tokens, rep_key=req.key)
            meta[rid] = req
            return rid
        return submit

    for req in trace.requests:
        eng.submit_at(req.t, arrival(req))
    t0 = time.time()
    eng.run(args.max_ticks, on_exhaust="report")
    rep = tf.result_from_runtime(eng, meta).report(
        window=args.report_window)

    mode = "open loop" if args.open else (
        f"closed loop (rate SLO per {args.window_ticks} ticks)"
        if args.window_ticks else "closed loop (whole-stream SLO)")
    print(f"{mode}: {rep['completed']}/{rep['requests']} served, "
          f"{rep['unserved']} unserved, mean_wbits={rep['mean_wbits']}, "
          f"p50/p99 latency {rep['p50_latency_ticks']:.0f}/"
          f"{rep['p99_latency_ticks']:.0f} ticks, "
          f"total EDP {rep['total_edp_js']:.3e} J*s, "
          f"queue peak {rep['queue_depth']['peak']}")
    print(f"bits/window    : {rep['mean_wbits_per_window']}")
    print(f"arrivals/window: {rep['arrivals_per_window']}")
    kr = rep["repetition"]
    print(f"repetition     : {kr['distinct_keys']} distinct keys / "
          f"{kr['arrivals']} arrivals, top-key share "
          f"{kr['top_key_share']:.2f}, max hit-rate {kr['max_hit_rate']:.2f}")
    if cache is not None:
        led = cache.ledger
        print(f"prefix cache   : {led.hits} full + {led.partial_hits} "
              f"partial hits / {led.lookups} lookups "
              f"(rate {led.hit_rate:.2f}), {led.misses} misses "
              f"({led.refreshes} refreshes), {led.evictions} evictions, "
              f"{led.rejected} rejected, {led.hit_tokens} tokens served "
              f"from cache, prefill EDP saved "
              f"{led.prefill_edp_saved_js:.3e} J*s")
        rep["prefix_cache"] = led.as_dict()
    print(f"model forwards (eager: nothing is compiled, so there is no "
          f"trace count): prefill x{eng.calls['prefill']}, "
          f"decode x{eng.calls['decode']}, extend x{eng.calls['extend']} "
          f"({time.time() - t0:.1f}s wall)")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=1)
        print(f"wrote {args.out}")
    return rep


if __name__ == "__main__":
    raise SystemExit(0 if main()["unserved"] == 0 else 1)

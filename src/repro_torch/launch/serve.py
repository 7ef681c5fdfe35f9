"""Serving CLI: initialize (or restore) a model, quantize, and serve
requests with runtime latency budgets (dynamic bit fluidity).

The counterpart of ``repro.launch.serve`` on one device, with the same
flags, defaults and argument errors, plus ``--device`` (CUDA unless it
names another).  Two modes:

  * ``--continuous`` (default): the continuous-batching engine — every
    request carries its OWN budget (cycled from ``--budgets``) and streams
    through a persistent slot pool, each row at its own bits.

      PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_4b \\
          --smoke --requests 8 --steps 16 --budgets 2.0 0.75 0.5 \\
          [--device cpu]

  * ``--batch``: the whole-batch path (one budget per batch), the paper's
    §V.B batch-switch story.

``--slo-edp <J*s>`` (continuous mode) swaps the open-loop controller for
a closed-loop :class:`repro_torch.core.policy.FluidController`: every
admission's priced AP cost is charged against the system-level EDP SLO
window and later requests resolve from the REMAINING budget.

With ``--ckpt-dir`` it restores the ``params`` of a checkpoint written
by ``repro_torch.launch.train`` before quantizing: train -> checkpoint
-> quantized bit-fluid serving.

The engine runs eagerly, so where the reference prints its compiled
program counts this prints the model forwards the engine ran, and the
kernel specialisations the run launched
(``repro_torch.kernels.launch_keys``): their count does not grow with
the number of budget levels.
:func:`main` returns what it printed as a dict.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import policy as pol
from repro_torch.data.pipeline import make_batch
from repro_torch.kernels import launch_keys, launches_since
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.serve import aggregate, predict_table
from repro_torch.serve.engine import ServeEngine, default_controller
from repro_torch.train.checkpoint import latest_step, restore_checkpoint


def fluid_controller(cfg, n: int, args) -> pol.FluidController:
    """Closed-loop controller for --slo-edp: the same three configs, but
    predicted at their PRICED per-request AP EDP, charged against a
    system-level SLO window the size of the request stream."""
    base = default_controller(n)
    preds = predict_table(
        lm.layer_gemm_dims(cfg), base.configs, axis="edp",
        units=args.prompt_len + args.steps,     # planned tokens/request
        head=lm.head_gemm_dims(cfg))
    return pol.FluidController(base.configs, preds, n, budget_axis="edp",
                               slo=args.slo_edp, window=args.requests)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3_4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching mode (the default)")
    ap.add_argument("--batch", action="store_true",
                    help="legacy whole-batch mode (one budget per batch)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--n-slots", type=int, default=4)
    ap.add_argument("--decode-block", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--budgets", type=float, nargs="+", default=None,
                    help="per-request latency budgets, cycled over the "
                         "stream (default: 2.0 0.5)")
    ap.add_argument("--slo-edp", type=float, default=0.0,
                    help="closed-loop mode: total modeled AP EDP budget "
                         "(J*s) for the whole request stream (0 = open "
                         "loop; continuous mode only)")
    ap.add_argument("--kv-bits", type=int, default=0, choices=(0, 8))
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    args = ap.parse_args(argv)
    if args.continuous and args.batch:
        ap.error("--continuous and --batch are mutually exclusive")
    if args.slo_edp and args.batch:
        ap.error("--slo-edp needs the continuous scheduler")
    if args.slo_edp and args.budgets is not None:
        ap.error("--budgets are latency budgets; with --slo-edp the EDP "
                 "SLO window drives precision — omit --budgets")
    if args.budgets is None:
        args.budgets = [2.0, 0.5]
    return args


def main(argv=None) -> dict:
    """Parse ``argv`` and serve: weights drawn on the device from seed 0,
    or the ``params`` of the checkpoint in ``--ckpt-dir``."""
    args = parse_args(argv)
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    if args.kv_bits:
        cfg = cfg.with_(kv_cache_bits=args.kv_bits)
    dev = cm.resolve_device(args.device)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    out = {"restored_step": None}
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        restored, step = restore_checkpoint(args.ckpt_dir,
                                            {"params": params}, device=dev)
        params = restored["params"]
        print(f"[serve] restored weights from step {step}")
        out["restored_step"] = step
    qparams = lm.quantize_params(params, cfg)
    del params

    n = lm.n_bit_slots(cfg)
    if args.batch:
        out.update(_serve_batches(cfg, qparams, default_controller(n), args,
                                  dev))
    elif args.slo_edp:
        out.update(_serve_continuous(cfg, qparams,
                                     fluid_controller(cfg, n, args), args,
                                     dev))
    else:
        out.update(_serve_continuous(cfg, qparams, default_controller(n),
                                     args, dev))
    return out


def _specialisations(before: dict, levels: int) -> dict:
    """Print the kernel specialisations a run launched (the counterpart
    of the reference's compiled-programs line: a budget or bit
    configuration never adds one); returns the count per kernel."""
    ran = launches_since(before)
    counts = {name: sum(1 for k in ran if k[0] == name)
              for name in ("bitplane_matmul", "flash_attention")}
    print(f"[serve] kernel specialisations: "
          f"bitplane={counts['bitplane_matmul']} "
          f"flash={counts['flash_attention']} (fluid across {levels} "
          f"budget levels)")
    return counts


def _forwards_line(prefill: int, decode: int, what: str) -> str:
    return (f"[serve] model forwards (eager: nothing is compiled, so "
            f"there is no trace count): prefill={prefill} decode={decode} "
            f"({what})")


def _serve_continuous(cfg, qparams, ctrl, args, dev) -> dict:
    closed = isinstance(ctrl, pol.FluidController)
    eng = ServeEngine(cfg, qparams, max_len=args.max_len, controller=ctrl,
                      n_slots=args.n_slots, prefill_len=args.prompt_len,
                      decode_block=args.decode_block, device=dev)
    before = launch_keys()
    t0 = time.time()
    rids = []
    for i in range(args.requests):
        prompt = make_batch(7, i, 1, args.prompt_len,
                            cfg.vocab_size)["tokens"][0]
        rids.append(eng.submit(
            np.asarray(prompt), max_new_tokens=args.steps,
            # closed loop: the SLO window picks precision, not requests
            budget_s=(None if closed
                      else args.budgets[i % len(args.budgets)]),
            temperature=args.temperature, top_k=args.top_k))
    res = eng.run()
    dt = time.time() - t0
    requests = []
    for rid in rids:
        st = res[rid]
        print(f"[serve] req{rid}: budget={st.budget_s:.3g} -> "
              f"{st.mean_wbits:.1f} mean wbits, {st.n_tokens} tokens "
              f"(slot {st.slot}, {st.finished_s - st.submitted_s:.2f}s, "
              f"AP {st.ap_latency_s * 1e3:.2f}ms / "
              f"{st.ap_energy_j * 1e3:.2f}mJ, EDP {st.edp:.3e} J·s)")
        requests.append({
            "rid": rid, "budget_s": st.budget_s,
            "mean_wbits": st.mean_wbits, "n_tokens": st.n_tokens,
            "slot": int(st.slot), "ap_latency_s": st.ap_latency_s,
            "ap_energy_j": st.ap_energy_j, "edp": st.edp,
            "wall_s": st.finished_s - st.submitted_s,
            "tokens": list(st.tokens)})
    print(f"[serve] {eng.stats.tokens} tokens in {dt:.2f}s "
          f"({eng.stats.tokens / dt:.1f} tok/s) across "
          f"{args.requests} requests on {args.n_slots} slots")
    closed_loop = None
    if closed:
        agg = aggregate(res.values())
        print(f"[serve] closed loop: spent {agg['edp']:.3e} of "
              f"{ctrl.slo:.3e} J·s EDP SLO ({agg['edp'] / ctrl.slo:.2f}x) "
              f"over {agg['requests']} admissions")
        closed_loop = {"spent_edp": agg["edp"], "slo_edp": ctrl.slo,
                       "admissions": agg["requests"]}
    levels = 1 if closed else len(set(args.budgets))
    print(_forwards_line(
        eng.calls["prefill"], eng.calls["decode"],
        f"fluid across {levels} budget levels, {eng.stats.admitted} "
        f"admissions"))
    return {"mode": "continuous", "requests": requests,
            "closed_loop": closed_loop, "wall_s": dt,
            "calls": dict(eng.calls), "stats": _stats(eng.stats),
            "specialisations": _specialisations(before, levels)}


def _serve_batches(cfg, qparams, ctrl, args, dev) -> dict:
    eng = ServeEngine(cfg, qparams, max_len=args.max_len, controller=ctrl,
                      device=dev)
    before = launch_keys()
    batches = []
    for bi, budget in enumerate(args.budgets):
        eng.set_budget(budget)
        batch = {"tokens": make_batch(7, bi, args.requests, args.prompt_len,
                                      cfg.vocab_size)["tokens"]}
        t0 = time.time()
        toks = eng.generate(batch, steps=args.steps).cpu()
        dt = time.time() - t0
        wv, _ = ctrl.resolve(torch.tensor(budget, dtype=torch.float32))
        mean_bits = float(np.mean(wv.numpy()))
        cost = eng.price_budget(budget)
        print(f"[serve] budget={budget}: mean_bits={mean_bits:.1f} "
              f"{args.requests * args.steps} tokens in {dt:.2f}s "
              f"({args.requests * args.steps / dt:.1f} tok/s; AP "
              f"{cost.cycles:.0f} cy/tok, {cost.energy_j * 1e3:.3f} mJ/tok)")
        batches.append({"budget_s": budget, "mean_wbits": mean_bits,
                        "ap_cycles": cost.cycles,
                        "ap_energy_j": cost.energy_j, "wall_s": dt,
                        "tokens": toks.tolist()})
    n = len(args.budgets)
    print(_forwards_line(n, n * (args.steps - 1),
                         f"fluid across {n} budgets"))
    return {"mode": "batch", "batches": batches,
            "calls": {"prefill": n, "decode": n * (args.steps - 1)},
            "stats": _stats(eng.stats),
            "specialisations": _specialisations(before, n)}


def _stats(stats) -> dict:
    return {k: v for k, v in vars(stats).items() if k != "traces"}


if __name__ == "__main__":
    main()

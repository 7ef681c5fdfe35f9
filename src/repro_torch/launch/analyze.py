"""The port's analysis CLI: the four-pass auditor suite.

    PYTHONPATH=src python -m repro_torch.launch.analyze --all
    PYTHONPATH=src python -m repro_torch.launch.analyze --all --device cpu

runs the AST linter (host-sync / nondeterminism / RNG / static-bit
rules over the registered hot paths of ``src/repro_torch``), the retrace
auditor (one op-stream and kernel-specialisation signature per serving
entrypoint across every config x budget x k x (start, length) variant,
engines on SMOKE weights on ``--device``, the card unless ``cpu`` is
asked for), the sharding checker (every
spec divides every 1/2/4/8-device fake mesh for all ten FULL configs,
built as fake tensors) and the ledger auditor (every ``CostRecord``
field written in ``serve/`` is consumed by ``aggregate()`` or waived).
Exit status 0 if and only if there are no fresh findings and no stale
baseline entries.  ``--json PATH`` writes the machine-readable result.
The retrace pass needs a GPU unless ``--device cpu`` is given: on the
CPU the kernels' plain versions run, so the kernel specialisations are
not audited (the pass says so).  The lint, sharding and ledger passes
run on the host either way.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch import analysis


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repro_torch.launch.analyze",
        description="retrace/host-sync/sharding/ledger auditors of the "
                    "PyTorch port")
    p.add_argument("--all", action="store_true",
                   help="run every pass (same as naming all four)")
    for name in analysis.ALL_PASSES:
        p.add_argument(f"--{name}", action="store_true",
                       help=f"run the {name} pass")
    p.add_argument("--configs", nargs="*", default=None, metavar="ARCH",
                   help="restrict retrace/sharding to these arch ids")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="write the machine-readable suite result here")
    p.add_argument("--baseline", default=None, metavar="PATH",
                   help="override the checked-in baseline file")
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                   help="where the retrace pass runs its engines (cpu "
                        "runs the kernels' plain versions and audits no "
                        "kernel specialisation)")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    passes = [n for n in analysis.ALL_PASSES if getattr(args, n)]
    if args.all or not passes:
        passes = list(analysis.ALL_PASSES)
    if "retrace" in passes and args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            parser.error("the retrace pass runs on the card and no CUDA "
                         "device is present; pass --device cpu to run it "
                         "on the kernels' plain versions")

    t0 = time.time()
    res = analysis.run_suite(passes, arch_ids=args.configs,
                             baseline_path=args.baseline,
                             device=args.device)
    dt = time.time() - t0

    for pr in res.passes:
        status = "ok" if pr.ok else f"{len(pr.fresh)} finding(s)"
        extra = f" ({pr.notes[0]})" if pr.notes else ""
        print(f"[{pr.name}] {status}{extra}")
        for note in pr.notes[1:]:
            print(f"  {note}")
        for f in pr.fresh:
            print("  " + f.render().replace("\n", "\n  "))
        if pr.suppressed:
            print(f"  {len(pr.suppressed)} finding(s) suppressed by "
                  f"baseline")
    for e in res.stale_baseline:
        print(f"[baseline] STALE entry {e['rule']} {e['file']} "
              f"(match: {e['match']!r}): suppressed nothing — remove it")

    verdict = "PASS" if res.ok else "FAIL"
    print(f"analysis: {verdict} "
          f"({', '.join(p.name for p in res.passes)}; {dt:.1f}s)")

    if args.json:
        payload = res.to_dict()
        payload["elapsed_s"] = round(dt, 2)
        payload["device"] = args.device
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"wrote {args.json}")
    return 0 if res.ok else 1


if __name__ == "__main__":
    sys.exit(main())

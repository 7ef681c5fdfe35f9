"""The port's analysis suite: four passes, one gate.

The counterpart of ``repro.analysis``.  ``run_suite`` executes the AST
linter, the retrace auditor, the sharding checker and the ledger
auditor over ``src/repro_torch``, applies the checked-in baseline
(``baseline.json`` beside this package), and reports a single ok/fail:
the entry the ``repro_torch.launch.analyze`` CLI and chip_smoke.py's
path 13 use.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis.common import (Baseline, Finding, apply_baseline,
                                         repo_root)

ALL_PASSES = ("lint", "retrace", "sharding", "ledger")


@dataclasses.dataclass
class PassResult:
    name: str
    fresh: List[Finding]
    suppressed: List[Finding]
    notes: List[str]

    @property
    def ok(self) -> bool:
        return not self.fresh


@dataclasses.dataclass
class SuiteResult:
    passes: List[PassResult]
    stale_baseline: List[dict]

    @property
    def ok(self) -> bool:
        return (all(p.ok for p in self.passes)
                and not self.stale_baseline)

    def to_dict(self) -> Dict:
        return {
            "ok": self.ok,
            "passes": {
                p.name: {
                    "ok": p.ok,
                    "fresh": [dataclasses.asdict(f) for f in p.fresh],
                    "suppressed": len(p.suppressed),
                    "notes": p.notes,
                } for p in self.passes
            },
            "stale_baseline": self.stale_baseline,
        }


def _retrace_notes(reports, device) -> List[str]:
    n_variants = sum(sum(len(v) for v in r.signatures.values())
                     + len(r.errors) for r in reports)
    notes = [f"{len(reports)} entrypoint audits, {n_variants} recorded "
             f"variants, {sum(1 for r in reports if r.ok)} with one "
             f"signature per group"]
    multi = sorted({(r.entrypoint, r.captures) for r in reports
                    if r.captures > 1})
    if multi:
        notes.append("Python-int axes (CUDA graph captures an entrypoint "
                     "would need): " + ", ".join(f"{e} {n}"
                                                 for e, n in multi))
    keys = set()
    for r in reports:
        for launches in r.launches.values():
            keys |= set(launches)
    if str(device).startswith("cpu"):
        notes.append("kernel specialisations not audited: on the CPU the "
                     "kernels' plain versions ran (--device cuda audits "
                     "them)")
    else:
        notes.append(f"{len(keys)} kernel specialisations launched")
    return notes


def run_suite(passes: Sequence[str] = ALL_PASSES,
              arch_ids: Optional[Sequence[str]] = None,
              root: Optional[str] = None,
              baseline_path: Optional[str] = None,
              device="cuda") -> SuiteResult:
    """Run the requested passes against the repo at ``root``; the
    retrace pass runs its engines on ``device`` (the card by default;
    ``"cpu"`` runs the kernels' plain versions, so no kernel
    specialisation is audited).  The other passes run on the host.

    Baseline staleness is only judged when every pass ran (a subset run
    cannot tell whether the other passes' entries still suppress)."""
    from repro_torch.analysis import ledger, lint, retrace, sharding

    root = root or repo_root()
    bl = Baseline.load(baseline_path)
    results: List[PassResult] = []
    for name in passes:
        notes: List[str] = []
        if name == "lint":
            found = lint.run_lint(root)
            notes.append(f"{len(found)} raw finding(s) over "
                         f"{', '.join(lint.LINT_SUBDIRS)}")
        elif name == "retrace":
            found, reports = retrace.run_retrace(arch_ids, device=device)
            notes.extend(_retrace_notes(reports, device))
        elif name == "sharding":
            found, summary = sharding.run_sharding(arch_ids)
            leaves = sum(s["leaves"] for s in summary.values())
            sharded = sum(s["sharded"] for s in summary.values())
            notes.append(f"{len(summary)} configs, {leaves} leaf×mesh "
                         f"specs checked, {sharded} sharded")
        elif name == "ledger":
            found, detail = ledger.run_ledger(root)
            written, consumed = detail["written"], detail["consumed"]
            notes.append(f"{len(written)} fields written, "
                         f"{len(consumed)} consumed by aggregate(), "
                         f"{len(written - consumed)} waived")
        else:
            raise ValueError(f"unknown analysis pass {name!r}")
        fresh, suppressed = apply_baseline(found, bl)
        results.append(PassResult(name=name, fresh=fresh,
                                  suppressed=suppressed, notes=notes))
    stale = bl.stale() if set(passes) >= set(ALL_PASSES) else []
    return SuiteResult(passes=results, stale_baseline=stale)


__all__ = ["ALL_PASSES", "Baseline", "Finding", "PassResult",
           "SuiteResult", "run_suite"]

"""Ledger auditor (pass 4 of 4): no pricing field falls out of the
port's ledger silently.

The counterpart of the reference's ledger pass, over
``src/repro_torch/serve/``.  Its bug class has one shape: the serve
layer writes a :class:`~repro_torch.serve.accounting.CostRecord` field
(a new cost split, a speculative counter) and ``accounting.aggregate()``
keeps summing without it, so the ledger stays green while
under-counting.  This pass closes the loop symbolically:

* **writes** — every record field assigned anywhere under
  ``src/repro_torch/serve/`` (attribute stores *and* ``RequestStats(...)``
  / ``ImageStats(...)`` constructor keywords);
* **reads** — the transitive closure of attribute loads reachable from
  ``aggregate()``'s body through the record classes' properties and
  methods (``edp → ap_energy_j → _axis_total → ap_cost`` …);
* **LG701** (fatal) — a field written but neither consumed by
  ``aggregate()`` nor waived in
  :data:`repro_torch.analysis.registry.LEDGER_WAIVED`;
* **LG702** (fatal) — a STALE waiver: the waived field is now consumed
  by ``aggregate()`` (the waiver hides nothing and must go) or is no
  longer written anywhere (the code it excused is gone).
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis import registry
from repro_torch.analysis.common import (Finding, ParsedModule,
                                         iter_modules, parse_module,
                                         qualname_index, repo_root)

ACCOUNTING = "src/repro_torch/serve/accounting.py"
RECORD_CLASSES = ("CostRecord", "RequestStats", "ImageStats")
AGGREGATE = "aggregate"


def _attr_loads(node: ast.AST, self_only: bool = False) -> Set[str]:
    """Names of every attribute LOAD in the subtree.

    ``self_only`` restricts to ``self.<attr>`` — used when expanding
    record property bodies, so a same-named attribute on some OTHER
    object (``self.ap_cost.latency_s`` is a ``BitVectorCost`` field,
    not the record's ``latency_s`` property) can't leak into the
    transitive consumption set."""
    out: Set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Load):
            if self_only and not (isinstance(n.value, ast.Name)
                                  and n.value.id == "self"):
                continue
            out.add(n.attr)
    return out


def record_schema(mod: ParsedModule
                  ) -> Tuple[Set[str], Dict[str, Set[str]]]:
    """(dataclass field names, member name -> attr loads in its body)
    across the record class family in ``accounting.py``."""
    fields: Set[str] = set()
    members: Dict[str, Set[str]] = {}
    for node in mod.tree.body:
        if not (isinstance(node, ast.ClassDef)
                and node.name in RECORD_CLASSES):
            continue
        for stmt in node.body:
            if (isinstance(stmt, ast.AnnAssign)
                    and isinstance(stmt.target, ast.Name)
                    and not stmt.target.id.startswith("_")):
                fields.add(stmt.target.id)
            elif isinstance(stmt, ast.FunctionDef):
                loads = _attr_loads(stmt, self_only=True)
                members[stmt.name] = members.get(stmt.name, set()) | loads
    return fields, members


def consumed_fields(mod: ParsedModule, fields: Set[str],
                    members: Dict[str, Set[str]]) -> Set[str]:
    """Transitive closure of attribute loads from ``aggregate()``."""
    agg = next((n for n in mod.tree.body
                if isinstance(n, ast.FunctionDef)
                and n.name == AGGREGATE), None)
    if agg is None:
        return set()
    reached = _attr_loads(agg)
    frontier = [m for m in reached if m in members]
    seen: Set[str] = set()
    while frontier:
        m = frontier.pop()
        if m in seen:
            continue
        seen.add(m)
        loads = members[m]
        new = loads - reached
        reached |= loads
        frontier.extend(x for x in new if x in members)
    return reached & fields


def written_fields(mods: Sequence[ParsedModule], fields: Set[str]
                   ) -> Dict[str, List[Tuple[str, int, str]]]:
    """field -> [(file, line, scope)] for every write in serve/."""
    out: Dict[str, List[Tuple[str, int, str]]] = {}

    def note(field: str, mod: ParsedModule, node: ast.AST,
             scope: str) -> None:
        out.setdefault(field, []).append(
            (mod.relpath, getattr(node, "lineno", 0), scope))

    for mod in mods:
        qnames = qualname_index(mod.tree)

        def scope_of(node: ast.AST) -> str:
            best = ""
            for fn, qn in qnames.items():
                if (hasattr(fn, "lineno") and hasattr(node, "lineno")
                        and fn.lineno <= node.lineno
                        <= getattr(fn, "end_lineno", fn.lineno)
                        and len(qn) > len(best)):
                    best = qn
            return best

        for n in ast.walk(mod.tree):
            targets: List[ast.expr] = []
            if isinstance(n, ast.Assign):
                targets = list(n.targets)
            elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
                targets = [n.target]
            for t in targets:
                if isinstance(t, ast.Tuple):
                    elts = list(t.elts)
                else:
                    elts = [t]
                for e in elts:
                    if (isinstance(e, ast.Attribute)
                            and e.attr in fields):
                        note(e.attr, mod, n, scope_of(n))
            if isinstance(n, ast.Call):
                callee = n.func
                cname = callee.attr if isinstance(callee, ast.Attribute) \
                    else getattr(callee, "id", None)
                if cname in RECORD_CLASSES:
                    for kw in n.keywords:
                        if kw.arg and kw.arg in fields:
                            note(kw.arg, mod, n, scope_of(n))
    return out


def run_ledger(root: Optional[str] = None
               ) -> Tuple[List[Finding], Dict[str, Set[str]]]:
    root = root or repo_root()
    acct = parse_module(os.path.join(root, ACCOUNTING), ACCOUNTING)
    fields, members = record_schema(acct)
    consumed = consumed_fields(acct, fields, members)
    serve_mods = [m for m in iter_modules(root, ("src/repro_torch/serve",))
                  if m.relpath != ACCOUNTING]
    writes = written_fields(serve_mods, fields)

    findings: List[Finding] = []
    for field in sorted(writes):
        if field in consumed or registry.waiver_for(field):
            continue
        file, line, scope = writes[field][0]
        findings.append(Finding(
            rule="LG701", file=file, line=line, scope=scope,
            message=f"CostRecord field {field!r} is written here (and at "
                    f"{len(writes[field]) - 1} other site(s)) but "
                    f"aggregate() never consumes it",
            hint="sum it in accounting.aggregate() or add a justified "
                 "entry to registry.LEDGER_WAIVED naming the real "
                 "consumer"))
    for field, why in sorted(registry.LEDGER_WAIVED.items()):
        if field in consumed:
            findings.append(Finding(
                rule="LG702", file=ACCOUNTING, line=0, scope=AGGREGATE,
                message=f"stale waiver: {field!r} ({why.split(',')[0]}) "
                        f"IS consumed by aggregate() now",
                hint="delete the LEDGER_WAIVED entry"))
        elif field not in writes:
            findings.append(Finding(
                rule="LG702", file=ACCOUNTING, line=0, scope=AGGREGATE,
                message=f"stale waiver: {field!r} is never written "
                        f"under serve/ anymore",
                hint="delete the LEDGER_WAIVED entry"))
    detail = {"fields": fields, "consumed": consumed,
              "written": set(writes)}
    return findings, detail

"""Shared vocabulary of the port's analysis suite.

The counterpart of ``repro.analysis.common``, kept as a copy (the port
imports nothing of the JAX package).  Every pass (the AST linter, the
retrace auditor, the sharding checker, the ledger auditor) reports
:class:`Finding` objects carrying a rule ID, a location and a fix hint,
so one CLI (``repro_torch.launch.analyze``) renders and gates them
uniformly.  Grandfathered findings live in a checked-in
:class:`Baseline` file next to this package; every entry must carry a
``why``, and an entry that suppresses nothing is stale and fails the
suite.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

BASELINE_PATH = os.path.join(os.path.dirname(__file__), "baseline.json")


@dataclasses.dataclass
class Finding:
    """One analysis finding: where, what, and how to fix it."""
    rule: str                    # rule ID, e.g. "HS102"
    file: str                    # repo-relative path
    line: int                    # 1-based source line (0 = file-level)
    scope: str                   # enclosing qualname ("" = module level)
    message: str                 # what is wrong, concretely
    hint: str = ""               # how to fix it
    snippet: str = ""            # offending source excerpt

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.file, self.scope)

    def render(self) -> str:
        loc = f"{self.file}:{self.line}" if self.line else self.file
        scope = f" [{self.scope}]" if self.scope else ""
        out = f"{self.rule} {loc}{scope}: {self.message}"
        if self.snippet:
            out += f"\n      > {self.snippet.strip()}"
        if self.hint:
            out += f"\n      fix: {self.hint}"
        return out


class Baseline:
    """Checked-in grandfathered findings.

    Entries match on (rule, file, scope) plus a ``match`` substring of
    the offending snippet, so they survive line drift but die when the
    code they justify changes.  Every entry needs a ``why``.
    """

    def __init__(self, entries: Sequence[dict]) -> None:
        for e in entries:
            missing = {"rule", "file", "match", "why"} - set(e)
            if missing:
                raise ValueError(f"baseline entry {e} missing {missing}")
        self.entries = list(entries)
        self._used = [False] * len(self.entries)

    @classmethod
    def load(cls, path: Optional[str] = None) -> "Baseline":
        path = path or BASELINE_PATH
        if not os.path.exists(path):
            return cls([])
        with open(path) as f:
            data = json.load(f)
        return cls(data.get("entries", []))

    def suppresses(self, finding: Finding) -> bool:
        for i, e in enumerate(self.entries):
            if (e["rule"] == finding.rule and e["file"] == finding.file
                    and e.get("scope", finding.scope) == finding.scope
                    and e["match"] in (finding.snippet or finding.message)):
                self._used[i] = True
                return True
        return False

    def stale(self) -> List[dict]:
        """Entries that suppressed nothing — the code they justified is
        gone, so the grandfather clause should go too."""
        return [e for e, used in zip(self.entries, self._used) if not used]


def apply_baseline(findings: Iterable[Finding], baseline: Baseline
                   ) -> Tuple[List[Finding], List[Finding]]:
    """Split findings into (fresh, suppressed)."""
    fresh, suppressed = [], []
    for f in findings:
        (suppressed if baseline.suppresses(f) else fresh).append(f)
    return fresh, suppressed


# ---------------------------------------------------------------------------
# Source tree walking
# ---------------------------------------------------------------------------

def repo_root(start: Optional[str] = None) -> str:
    """The repository root: the directory holding ``src/repro_torch``."""
    here = start or os.path.dirname(__file__)   # .../src/repro_torch/analysis
    root = os.path.abspath(os.path.join(here, "..", "..", ".."))
    if not os.path.isdir(os.path.join(root, "src", "repro_torch")):
        # installed package: fall back to cwd if it looks like the repo
        cwd = os.getcwd()
        if os.path.isdir(os.path.join(cwd, "src", "repro_torch")):
            return cwd
    return root


@dataclasses.dataclass
class ParsedModule:
    """One parsed source file plus the qualname of every def."""
    relpath: str                 # repo-relative, '/'-separated
    source: str
    tree: ast.Module
    lines: List[str]

    def snippet(self, node: ast.AST) -> str:
        try:
            seg = ast.get_source_segment(self.source, node)
        except Exception:
            seg = None
        if seg:
            return seg.splitlines()[0][:120]
        ln = getattr(node, "lineno", 0)
        return self.lines[ln - 1].strip()[:120] if 0 < ln <= len(self.lines) \
            else ""


def parse_module(path: str, relpath: str) -> ParsedModule:
    with open(path) as f:
        source = f.read()
    return ParsedModule(relpath=relpath.replace(os.sep, "/"), source=source,
                        tree=ast.parse(source, filename=relpath),
                        lines=source.splitlines())


def iter_modules(root: str, subdirs: Sequence[str]) -> List[ParsedModule]:
    """Parse every ``.py`` file under ``root/<subdir>`` (sorted, stable)."""
    mods: List[ParsedModule] = []
    for sub in subdirs:
        base = os.path.join(root, sub)
        for dirpath, _dirnames, filenames in sorted(os.walk(base)):
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                full = os.path.join(dirpath, fn)
                mods.append(parse_module(full, os.path.relpath(full, root)))
    return mods


def qualname_index(tree: ast.Module) -> Dict[ast.AST, str]:
    """Map every FunctionDef/AsyncFunctionDef/ClassDef node to its
    dotted qualname (``Class.method``, ``outer.<locals>.inner``)."""
    out: Dict[ast.AST, str] = {}

    def walk(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                name = f"{prefix}{child.name}" if prefix else child.name
                out[child] = name
                sep = "." if isinstance(child, ast.ClassDef) else ".<locals>."
                walk(child, f"{name}{sep}")
            else:
                walk(child, prefix)

    walk(tree, "")
    return out


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None

"""The port's AST linter (pass 1 of 4), rebuilt for eager PyTorch.

The counterpart of ``repro.analysis.lint``, over ``src/repro_torch``
(the analyzers themselves excluded).  The rule IDs are the reference's:

* **HS101**: ``.item()`` / ``.tolist()`` on a device tensor inside a
  registered hot scope (``registry.HOT_SCOPES``): a per-element host
  sync on the serving tick path.
* **HS102**: host conversion of a device tensor in a hot scope:
  ``float()`` / ``int()`` / ``bool()`` / ``.numpy()`` / ``np.asarray`` /
  ``np.*``, formatting it, or passing it to a pricing call that converts
  internally (``registry.SYNC_ARG_METHODS``).  The fix is one coalesced
  ``.cpu()`` of a stacked tensor per tick (then ``.numpy()`` of the
  host copy), or the cached host helpers (``host_bits`` /
  ``_host_index`` / ``_config_cost``).
* **HS103**: host control flow (``if`` / ``while`` / ``assert``) over
  a device tensor in a hot scope: an implicit ``bool()`` sync.  (A
  ``for`` over a tensor unbinds it on the device, which does not sync,
  unlike the reference's device arrays; its elements stay device
  values.)
* **ND201**: iteration over a set (``for x in {...}``, a comprehension
  over ``set(...)``, ``tuple(<set>)``): hash-order nondeterminism.
  ``sorted(<set>)`` is the fix and is recognised as clean.
* **RNG301**: unseeded or global RNG: ``np.random.default_rng()`` with
  no seed, the legacy ``np.random.<fn>`` global generator, stdlib
  ``random.<fn>``, and torch's global generator (``torch.rand*``,
  ``randint``, ``randperm``, ``normal``, ``multinomial``, ``bernoulli``
  without ``generator=``, and ``torch.manual_seed``).
* **STAT401**, redefined for eager code, where nothing is jitted: a
  runtime bit value (a bit-named tensor) that becomes a Python number
  (``int()`` / ``float()`` / ``bool()`` / ``round()`` / ``.item()`` /
  ``.tolist()``), and that number reaching a kernel's static parameter
  (``n_planes=`` / ``planes=``, or any argument of a kernel entry,
  ``registry.KERNEL_ENTRIES``), a ``functools.lru_cache``d function of
  the module, or ``torch.compile``; and a ``torch.compile``d closure
  that captures a bit-named local.  Each bakes one precision into a
  kernel specialisation.  The bit-plane kernel's ``n_planes`` taken
  from the static family set (``ops.BIT_FAMILIES`` through
  ``bit_families``) is allowed: a kernel may specialise on the static
  family set, never on a runtime bit value.  The retrace auditor is the
  dynamic complement of this rule.

The host-sync dataflow is intraprocedural taint: device-ness seeds from
``torch.*`` calls, methods of a device tensor and
``registry.DEVICE_METHODS``; it clears through ``.cpu()`` (the
sanctioned coalesced transfer), tensor metadata and
``registry.HOST_METHODS``, and a flagged conversion yields a HOST result
(downstream use of the converted value is deliberately not re-flagged).
Tensor parameters are not seeds: a hot function's own arguments are its
caller's business.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis import registry
from repro_torch.analysis.common import (Finding, ParsedModule, dotted,
                                         iter_modules, qualname_index,
                                         repo_root)

LINT_SUBDIRS = ("src/repro_torch",)
# the analyzers themselves are not serving code
EXCLUDE_PREFIXES = ("src/repro_torch/analysis/",)


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    title: str
    hint: str


RULES: Dict[str, Rule] = {r.id: r for r in [
    Rule("HS101", "per-element host sync (.item()/.tolist()) in hot scope",
         "batch the transfer: one .cpu() of a stacked tensor per tick"),
    Rule("HS102", "host conversion of device value in hot scope",
         "coalesce into one .cpu() per tick, or use the cached host-side "
         "helpers (host_bits/_host_index/_config_cost)"),
    Rule("HS103", "host control flow on device value in hot scope",
         "copy to the host once, branch on the host copy (or keep the "
         "branch on the device with torch.where)"),
    Rule("ND201", "set iteration order is nondeterministic",
         "wrap in sorted(...): the order must be stable across processes"),
    Rule("RNG301", "unseeded / global RNG construction",
         "an explicitly seeded generator: np.random.default_rng(seed), or "
         "torch.Generator().manual_seed(seed) passed as generator="),
    Rule("STAT401", "runtime bit value specialises a kernel",
         "keep bits a tensor end to end (the container path at 8 planes, "
         "or the grouped path over the static family set) so one kernel "
         "specialisation serves every precision configuration"),
]}

_LEGACY_NP_RANDOM = frozenset({
    "rand", "randn", "randint", "random", "random_sample", "choice",
    "shuffle", "permutation", "normal", "uniform", "seed",
})
_STDLIB_RANDOM = frozenset({
    "random", "randint", "choice", "choices", "shuffle", "uniform",
    "sample", "randrange", "getrandbits", "seed", "gauss",
})
_CONVERTERS = frozenset({"float", "int", "bool", "complex"})


def _last_attr(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("set", "frozenset"):
        return True
    return False


# ---------------------------------------------------------------------------
# HS101/HS102/HS103: intraprocedural device taint in hot scopes
# ---------------------------------------------------------------------------

class _TaintVisitor:
    """Walks one hot function's statements in order, tracking which
    local (dotted) names hold device values."""

    def __init__(self, mod: ParsedModule, scope: str) -> None:
        self.mod = mod
        self.scope = scope
        self.tainted: Set[str] = set()
        self.findings: List[Finding] = []
        self._seen: Set[Tuple[str, int, str]] = set()

    # -- findings ---------------------------------------------------------

    def flag(self, rule: str, node: ast.AST, message: str) -> None:
        key = (rule, node.lineno, message)
        if key in self._seen:
            return
        self._seen.add(key)
        self.findings.append(Finding(
            rule=rule, file=self.mod.relpath, line=node.lineno,
            scope=self.scope, message=message, hint=RULES[rule].hint,
            snippet=self.mod.snippet(node)))

    # -- expression taint -------------------------------------------------

    def taint_of(self, node: ast.AST) -> bool:
        """True if evaluating ``node`` yields a device value.  Flags any
        sync the evaluation itself performs."""
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            d = dotted(node)
            return d in self.tainted if d else self.taint_of(node.value)
        if isinstance(node, ast.Call):
            return self._call_taint(node)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.taint_of(e) for e in node.elts)
        if isinstance(node, ast.Subscript):
            return self.taint_of(node.value)
        if isinstance(node, ast.BinOp):
            return self.taint_of(node.left) or self.taint_of(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.taint_of(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.taint_of(v) for v in node.values)
        if isinstance(node, ast.Compare):
            return (self.taint_of(node.left)
                    or any(self.taint_of(c) for c in node.comparators))
        if isinstance(node, ast.IfExp):
            return self.taint_of(node.body) or self.taint_of(node.orelse)
        if isinstance(node, ast.Starred):
            return self.taint_of(node.value)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return any(self.taint_of(g.iter) for g in node.generators) \
                or self.taint_of(node.elt)
        if isinstance(node, ast.JoinedStr):
            # f-string: formatting a device value is a sync
            for v in node.values:
                if isinstance(v, ast.FormattedValue) \
                        and self.taint_of(v.value):
                    self.flag("HS102", node,
                              "formatting a device value forces a host "
                              "sync")
            return False
        return False

    def _args_taint(self, node: ast.Call) -> bool:
        return (any(self.taint_of(a) for a in node.args)
                or any(self.taint_of(k.value) for k in node.keywords))

    def _call_taint(self, node: ast.Call) -> bool:
        func = node.func
        d = dotted(func) or ""
        name = _last_attr(func)

        # receiver.method(): syncs, the sanctioned transfer, metadata, and
        # every other method of a device tensor (a device tensor again)
        if isinstance(func, ast.Attribute):
            recv_taint = self.taint_of(func.value)
            if recv_taint:
                if name in ("item", "tolist"):
                    self.flag("HS101", node,
                              f".{name}() on a device value is a per-call "
                              f"host sync")
                    return False
                if name == "numpy":
                    self.flag("HS102", node,
                              ".numpy() on a device value forces a "
                              "device->host transfer")
                    return False
                if name in registry.TRANSFER_METHODS \
                        or name in registry.SHAPE_METHODS:
                    self._args_taint(node)
                    return False
        if (d in registry.TORCH_HOST_CALLS
                or d.startswith(registry.TORCH_HOST_PREFIXES)
                or name in registry.HOST_METHODS
                or (isinstance(func, ast.Name)
                    and name in registry.HOST_BUILTINS)):
            # host-returning: evaluate args (nested syncs still flag)
            self._args_taint(node)
            return False
        if name in registry.SYNC_ARG_METHODS:
            if self._args_taint(node):
                self.flag("HS102", node,
                          f"{name}() converts its arguments to host "
                          f"numpy — passing device values syncs per "
                          f"call")
            return False
        if name in _CONVERTERS and isinstance(func, ast.Name):
            if self._args_taint(node):
                self.flag("HS102", node,
                          f"{name}() on a device value forces a host "
                          f"sync")
            return False
        if d.startswith("np.") or d.startswith("numpy."):
            if self._args_taint(node):
                self.flag("HS102", node,
                          f"{d.split('(')[0]} on a device value forces "
                          f"a device->host transfer")
            return False
        if d.startswith("torch.") or name in registry.DEVICE_METHODS:
            self._args_taint(node)
            return True
        if isinstance(func, ast.Attribute) and self.taint_of(func.value):
            self._args_taint(node)
            return True
        # unknown callee: conservative propagate
        return self._args_taint(node)

    # -- statements -------------------------------------------------------

    def assign_target(self, target: ast.AST, taint: bool) -> None:
        if isinstance(target, ast.Name):
            (self.tainted.add if taint
             else self.tainted.discard)(target.id)
        elif isinstance(target, ast.Attribute):
            d = dotted(target)
            if d:
                (self.tainted.add if taint else self.tainted.discard)(d)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self.assign_target(e, taint)
        elif isinstance(target, ast.Starred):
            self.assign_target(target.value, taint)
        # subscript stores don't bind a trackable name

    def _bind_loop(self, target: ast.AST, it: ast.AST) -> None:
        """A loop target's taint: position by position over a literal of
        tuples (``for name, t in (("q", q), ...)``), else the iterable's."""
        rows = it.elts if isinstance(it, (ast.Tuple, ast.List)) else None
        if (rows and isinstance(target, ast.Tuple)
                and all(isinstance(r, ast.Tuple)
                        and len(r.elts) == len(target.elts) for r in rows)):
            for i, t in enumerate(target.elts):
                self.assign_target(t, any(self.taint_of(r.elts[i])
                                          for r in rows))
            return
        self.assign_target(target, self.taint_of(it))

    def run_body(self, body: Sequence[ast.stmt]) -> None:
        for stmt in body:
            self.run_stmt(stmt)

    def run_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.Assign):
            t = self.taint_of(stmt.value)
            for target in stmt.targets:
                self.assign_target(target, t)
        elif isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self.assign_target(stmt.target, self.taint_of(stmt.value))
        elif isinstance(stmt, ast.AugAssign):
            t = self.taint_of(stmt.value) or self.taint_of(stmt.target)
            self.assign_target(stmt.target, t)
        elif isinstance(stmt, (ast.If, ast.While)):
            if self.taint_of(stmt.test):
                self.flag("HS103", stmt.test,
                          "branching on a device value is an implicit "
                          "bool() host sync")
            self.run_body(stmt.body)
            self.run_body(stmt.orelse)
            if isinstance(stmt, ast.While):    # second pass: loop taint
                self.run_body(stmt.body)
        elif isinstance(stmt, ast.Assert):
            if self.taint_of(stmt.test):
                self.flag("HS103", stmt.test,
                          "asserting on a device value is an implicit "
                          "bool() host sync")
        elif isinstance(stmt, ast.For):
            # iterating a tensor unbinds it on the device (no sync): the
            # elements stay device values
            self._bind_loop(stmt.target, stmt.iter)
            self.run_body(stmt.body)
            self.run_body(stmt.body)           # second pass: loop taint
            self.run_body(stmt.orelse)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self.taint_of(item.context_expr)
                if item.optional_vars is not None:
                    self.assign_target(item.optional_vars, False)
            self.run_body(stmt.body)
        elif isinstance(stmt, ast.Try):
            self.run_body(stmt.body)
            for h in stmt.handlers:
                self.run_body(h.body)
            self.run_body(stmt.orelse)
            self.run_body(stmt.finalbody)
        elif isinstance(stmt, (ast.Expr, ast.Return)):
            if stmt.value is not None:
                self.taint_of(stmt.value)
        elif isinstance(stmt, ast.Raise):
            if stmt.exc is not None:
                self.taint_of(stmt.exc)
        elif isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                self.assign_target(t, False)
        # nested defs are visited when their own scope is analyzed


def _check_hot_scopes(mod: ParsedModule) -> List[Finding]:
    findings: List[Finding] = []
    for node, qual in qualname_index(mod.tree).items():
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not registry.is_hot(mod.relpath, qual):
            continue
        v = _TaintVisitor(mod, qual)
        v.run_body(node.body)
        findings.extend(v.findings)
    return findings


# ---------------------------------------------------------------------------
# ND201: set-iteration nondeterminism
# ---------------------------------------------------------------------------

def _check_set_order(mod: ParsedModule) -> List[Finding]:
    findings: List[Finding] = []
    quals = qualname_index(mod.tree)
    scopes: Dict[int, str] = {}

    def scope_of(node: ast.AST, current: str) -> str:
        return quals.get(node, current)

    def flag(node: ast.AST, scope: str, what: str) -> None:
        findings.append(Finding(
            rule="ND201", file=mod.relpath, line=node.lineno, scope=scope,
            message=f"{what} iterates a set in hash order",
            hint=RULES["ND201"].hint, snippet=mod.snippet(node)))

    def walk(node: ast.AST, scope: str) -> None:
        scope = scope_of(node, scope)
        if isinstance(node, ast.For) and _is_set_expr(node.iter):
            flag(node.iter, scope, "for loop")
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            for g in node.generators:
                if _is_set_expr(g.iter):
                    # a set comprehension over a set re-hashes: order
                    # nondeterminism only escapes via ordered outputs
                    if not isinstance(node, (ast.SetComp, ast.DictComp)):
                        flag(g.iter, scope, "comprehension")
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in ("list", "tuple") and node.args \
                and _is_set_expr(node.args[0]):
            flag(node, scope, f"{node.func.id}(...)")
        for child in ast.iter_child_nodes(node):
            walk(child, scope)

    walk(mod.tree, "")
    return findings


# ---------------------------------------------------------------------------
# RNG301: unseeded / global RNG construction
# ---------------------------------------------------------------------------

# torch's global-generator samplers: clean only with an explicit
# generator=
_TORCH_RANDOM = frozenset({
    "rand", "randn", "randint", "randperm", "normal", "multinomial",
    "bernoulli", "poisson", "rand_like", "randn_like", "randint_like",
})
_TORCH_GLOBAL_SEED = frozenset({
    "torch.manual_seed", "torch.seed", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all", "torch.random.manual_seed",
})


def _check_rng(mod: ParsedModule) -> List[Finding]:
    findings: List[Finding] = []
    quals = qualname_index(mod.tree)

    def flag(node: ast.AST, scope: str, message: str) -> None:
        findings.append(Finding(
            rule="RNG301", file=mod.relpath, line=node.lineno, scope=scope,
            message=message, hint=RULES["RNG301"].hint,
            snippet=mod.snippet(node)))

    def walk(node: ast.AST, scope: str) -> None:
        scope = quals.get(node, scope)
        if isinstance(node, ast.Call):
            d = dotted(node.func) or ""
            if d in ("np.random.default_rng", "numpy.random.default_rng") \
                    and not node.args and not node.keywords:
                flag(node, scope, "default_rng() without a seed draws "
                                  "from OS entropy — runs are not "
                                  "reproducible")
            parts = d.split(".")
            if len(parts) == 3 and parts[0] in ("np", "numpy") \
                    and parts[1] == "random" \
                    and parts[2] in _LEGACY_NP_RANDOM:
                flag(node, scope, f"{d}() uses the legacy GLOBAL numpy "
                                  f"generator (cross-module state)")
            if len(parts) == 2 and parts[0] == "random" \
                    and parts[1] in _STDLIB_RANDOM:
                flag(node, scope, f"{d}() uses the stdlib global "
                                  f"generator (cross-module state)")
            if len(parts) == 2 and parts[0] == "torch" \
                    and parts[1] in _TORCH_RANDOM \
                    and not any(k.arg == "generator" for k in node.keywords):
                flag(node, scope, f"{d}() without generator= draws from "
                                  f"torch's GLOBAL generator (cross-module "
                                  f"state)")
            if d in _TORCH_GLOBAL_SEED:
                flag(node, scope, f"{d}() seeds torch's GLOBAL generator "
                                  f"(cross-module state)")
        for child in ast.iter_child_nodes(node):
            walk(child, scope)

    walk(mod.tree, "")
    return findings


# ---------------------------------------------------------------------------
# STAT401: a runtime bit value specialises a kernel
# ---------------------------------------------------------------------------

_NUMBER_CONVERTERS = frozenset({"int", "float", "bool", "round"})
_NUMBER_METHODS = frozenset({"item", "tolist"})
_PASS_THROUGH = frozenset({"min", "max", "abs"})
_STATIC_ANNOTATIONS = frozenset({"int", "float", "bool"})


def _local_bindings(fn: ast.AST) -> Set[str]:
    """Names bound in ``fn``'s own scope: params + stores (nested defs'
    internals excluded — their stores bind in the nested scope)."""
    out: Set[str] = set()
    args = fn.args
    for a in (args.posonlyargs + args.args + args.kwonlyargs
              + ([args.vararg] if args.vararg else [])
              + ([args.kwarg] if args.kwarg else [])):
        out.add(a.arg)

    def walk(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                if not isinstance(child, ast.Lambda):
                    out.add(child.name)
                continue
            if isinstance(child, ast.Name) \
                    and isinstance(child.ctx, (ast.Store, ast.Del)):
                out.add(child.id)
            walk(child)

    walk(fn)
    return out


def _loads(fn: ast.AST) -> Set[str]:
    """Every Name load in ``fn``'s whole subtree (nested defs included:
    a name free in a nested def propagates outward)."""
    return {n.id for n in ast.walk(fn)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}


def _static_annotation(ann: Optional[ast.AST]) -> bool:
    """``int`` / ``float`` / ``bool`` (or ``Optional`` of one): a
    parameter declared a Python number, not a tensor."""
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.replace("Optional[", "").rstrip("]") \
            in _STATIC_ANNOTATIONS
    if isinstance(ann, ast.Name):
        return ann.id in _STATIC_ANNOTATIONS
    if isinstance(ann, ast.Subscript) and dotted(ann.value) in (
            "Optional", "typing.Optional"):
        return _static_annotation(ann.slice)
    return False


def _decorated_cached(fn: ast.AST) -> bool:
    for dec in fn.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        if (dotted(target) or "") in ("functools.lru_cache", "lru_cache",
                                      "functools.cache", "cache"):
            return True
    return False


def _compile_call(call: ast.Call) -> bool:
    return (dotted(call.func) or "") in ("torch.compile", "compile")


class _StaticBits:
    """One function's Python numbers converted from runtime bit values,
    and the sinks they reach."""

    def __init__(self, mod: ParsedModule, fn: ast.AST, scope: str,
                 cached: Set[str], findings: List[Finding]) -> None:
        self.mod, self.scope, self.findings = mod, scope, findings
        self.cached = cached
        self.static: Set[str] = set()          # converted bit numbers
        self.compiled: Set[str] = set()        # names bound to compile()
        runtime_params = any(mod.relpath.startswith(p)
                             for p in registry.RUNTIME_BIT_MODULES)
        a = fn.args
        self.runtime: Set[str] = set()          # bit-named tensors
        for p in a.posonlyargs + a.args + a.kwonlyargs:
            if (runtime_params and registry.is_bit_name(p.arg)
                    and not _static_annotation(p.annotation)):
                self.runtime.add(p.arg)
        self.fn = fn

    def flag(self, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(
            rule="STAT401", file=self.mod.relpath, line=node.lineno,
            scope=self.scope, message=message, hint=RULES["STAT401"].hint,
            snippet=self.mod.snippet(node)))

    def mentions_runtime(self, node: ast.AST) -> bool:
        for n in ast.walk(node):
            if isinstance(n, ast.Name) and (n.id in self.runtime
                                            or n.id in self.static):
                return True
        return False

    def is_static(self, node: ast.AST) -> bool:
        """Whether ``node`` evaluates to a Python number converted from
        a runtime bit value."""
        if isinstance(node, ast.Name):
            return node.id in self.static
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name) and f.id in _NUMBER_CONVERTERS:
                return any(self.mentions_runtime(x) for x in node.args)
            if isinstance(f, ast.Name) and f.id in _PASS_THROUGH:
                return any(self.is_static(x) for x in node.args)
            if isinstance(f, ast.Attribute) and f.attr in _NUMBER_METHODS:
                return self.mentions_runtime(f.value)
            return False
        if isinstance(node, ast.BinOp):
            return self.is_static(node.left) or self.is_static(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_static(node.operand)
        if isinstance(node, ast.IfExp):
            return self.is_static(node.body) or self.is_static(node.orelse)
        if isinstance(node, ast.Subscript):
            return self.is_static(node.value)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.is_static(e) for e in node.elts)
        return False

    def bind(self, target: ast.AST, value: ast.AST) -> None:
        names = [n.id for n in ast.walk(target) if isinstance(n, ast.Name)]
        static = self.is_static(value)
        runtime = (not static and isinstance(value, ast.Call)
                   and self._device_call(value))
        compiled = isinstance(value, ast.Call) and _compile_call(value)
        for name in names:
            (self.static.add if static else self.static.discard)(name)
            if runtime and registry.is_bit_name(name):
                self.runtime.add(name)
            if compiled:
                self.compiled.add(name)

    @staticmethod
    def _device_call(call: ast.Call) -> bool:
        d = dotted(call.func) or ""
        name = _last_attr(call.func)
        return d.startswith("torch.") or name in registry.DEVICE_METHODS

    def check_call(self, call: ast.Call) -> None:
        name = _last_attr(call.func) or ""
        args = list(call.args) + [k.value for k in call.keywords]
        hit = [a for a in args if self.is_static(a)]
        for kw in call.keywords:
            if kw.arg in registry.STATIC_PLANE_PARAMS \
                    and self.is_static(kw.value):
                self.flag(call, f"{kw.arg}= takes a Python number "
                                f"converted from a runtime bit value — "
                                f"each width launches its own kernel "
                                f"specialisation")
                return
        if not hit:
            return
        if name in registry.KERNEL_ENTRIES:
            self.flag(call, f"{name}() takes a Python number converted "
                            f"from a runtime bit value — the kernel "
                            f"specialises on it")
        elif isinstance(call.func, ast.Name) and name in self.cached:
            self.flag(call, f"lru_cached {name}() is keyed by a Python "
                            f"number converted from a runtime bit value "
                            f"— one cached specialisation per width")
        elif _compile_call(call) or (isinstance(call.func, ast.Name)
                                     and name in self.compiled):
            self.flag(call, "a torch.compile'd program takes a Python "
                            "number converted from a runtime bit value — "
                            "every distinct width recompiles")

    def run(self) -> None:
        # statements in source order (nested defs are their own scope)
        def walk(node: ast.AST) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda, ast.ClassDef)):
                    continue
                if isinstance(child, ast.Assign):
                    walk(child)
                    for t in child.targets:
                        self.bind(t, child.value)
                    continue
                if isinstance(child, (ast.AnnAssign, ast.AugAssign)) \
                        and child.value is not None:
                    walk(child)
                    self.bind(child.target, child.value)
                    continue
                if isinstance(child, ast.Call):
                    self.check_call(child)
                walk(child)

        walk(self.fn)


def _check_static_bits(mod: ParsedModule) -> List[Finding]:
    findings: List[Finding] = []
    quals = qualname_index(mod.tree)
    cached = {n.name for n in ast.walk(mod.tree)
              if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
              and _decorated_cached(n)}
    for node, qual in quals.items():
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        _StaticBits(mod, node, qual, cached, findings).run()
        # a torch.compile'd closure capturing a bit-named local
        locals_ = _local_bindings(node)
        nested = {c.name: c for c in ast.walk(node) if c is not node
                  and isinstance(c, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))}
        targets = []
        for call in ast.walk(node):
            if isinstance(call, ast.Call) and _compile_call(call) \
                    and call.args and isinstance(call.args[0], ast.Name) \
                    and call.args[0].id in nested:
                targets.append((call, nested[call.args[0].id]))
        for fn in nested.values():
            for dec in fn.decorator_list:
                d = dec.func if isinstance(dec, ast.Call) else dec
                if (dotted(d) or "") in ("torch.compile", "compile"):
                    targets.append((fn, fn))
        for site, fn in targets:
            captured = (_loads(fn) - _local_bindings(fn)) & locals_
            for name in sorted(captured):
                if registry.is_bit_name(name):
                    findings.append(Finding(
                        rule="STAT401", file=mod.relpath,
                        line=site.lineno, scope=qual,
                        message=f"torch.compile'd closure {fn.name!r} "
                                f"captures bit-named local {name!r} from "
                                f"its enclosing scope — the width is "
                                f"baked in when it compiles",
                        hint=RULES["STAT401"].hint,
                        snippet=mod.snippet(site)))
    return findings


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

CHECKERS: List[Callable[[ParsedModule], List[Finding]]] = [
    _check_hot_scopes, _check_set_order, _check_rng, _check_static_bits,
]


def lint_modules(modules: Sequence[ParsedModule]) -> List[Finding]:
    findings: List[Finding] = []
    for mod in modules:
        if any(mod.relpath.startswith(p) for p in EXCLUDE_PREFIXES):
            continue
        for check in CHECKERS:
            findings.extend(check(mod))
    findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return findings


def run_lint(root: Optional[str] = None) -> List[Finding]:
    """Lint the whole ``src/repro_torch`` tree; returns raw findings (the
    CLI applies the baseline)."""
    return lint_modules(iter_modules(root or repo_root(), LINT_SUBDIRS))

"""Sharding checker (pass 3 of 4): every spec of the port's
``dist/sharding`` rules must divide the mesh, for every config, at
analysis time.

The counterpart of the reference's sharding pass, run on the port's own
rules.  ``dist.api.logical_to_mesh`` deliberately falls back to
replication when a dimension does not divide its logical axis: safe at
run time, but a bad rule (or a config whose shapes silently stopped
dividing) then degrades to replicated execution with no error anywhere.
This pass builds the ten FULL configs' parameter, quantized-parameter,
optimizer, cache, bits, budgets and batch trees as fake tensors
(:mod:`repro_torch.launch.specs`: nothing is allocated, the
1T-parameter config audits in a fraction of a second) and resolves
every leaf through the port's public spec functions
(``param_shardings``, also under a fully replicated and a partial
8-device ``PlacementPlan``, ``opt_shardings``, ``batch_shardings``,
``cache_shardings``, ``bits_pspec``, ``budgets_pspec``) on fake 1/2/4/8
device meshes that carry only ``shape`` and ``axis_names`` (no gloo
group), checking three things:

* **SH601** (fatal): a *resolved* spec that is arithmetically wrong: an
  axis not in the mesh, an axis consumed twice, or a sharded dimension
  whose size does not divide the product of its mesh axes.
* **SH602** (fatal): a leaf whose LOGICAL spec requests an axis that
  exists in the mesh (size > 1) but was dropped by the divisibility
  fallback, named down to config x mesh x leaf path x dim.
* **SH603** (fatal): the safety net: on the 2x2 mesh every config must
  place at least one quantized-parameter leaf on ``model``, one on
  ``data``, and one cache leaf on ``data``.

``BATCH = 8`` divides every data-parallel size here, so the batch
caches take rows over the data axis.  The sequence-sharded cache (a B=1
row that no data axis divides: ``dist.sharding._kv_cache_spec`` puts the
SEQUENCE over the data axis, which ``models.transformer`` serves) is
asked for separately: every config with a KV cache is audited at B=1 on
the meshes with a data axis (``cache_b1``), and the 2x2 safety net must
place its k/v sequence on ``data`` (SH603).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.common import Finding

SHARDING_FILE = "src/repro_torch/dist/sharding.py"

# fake meshes at 1/2/4/8 devices, covering pure-dp, pure-tp, and mixed
MESH_SHAPES: Tuple[Dict[str, int], ...] = (
    {"data": 1},
    {"data": 2}, {"model": 2},
    {"data": 4}, {"model": 4}, {"data": 2, "model": 2},
    {"data": 8}, {"model": 8}, {"data": 2, "model": 4},
    {"data": 4, "model": 2},
)

SAFETY_NET_MESH: Dict[str, int] = {"data": 2, "model": 2}

BATCH = 8            # divisible by every dp size above
CACHE_LEN = 64


@dataclasses.dataclass(frozen=True)
class FakeMesh:
    """Duck-types the two attributes the spec rules read (``.shape``
    dict and ``.axis_names``): no devices and no process group."""
    axis_sizes: Tuple[Tuple[str, int], ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axis_sizes)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.axis_sizes)


def mesh_label(mesh: FakeMesh) -> str:
    return "x".join(f"{n}{s}" for n, s in mesh.axis_sizes)


def fake_meshes() -> List[FakeMesh]:
    return [FakeMesh(tuple(sorted(m.items()))) for m in MESH_SHAPES]


def _prod(vals: Iterable[int]) -> int:
    out = 1
    for v in vals:
        out *= v
    return out


# ---------------------------------------------------------------------------
# Spec arithmetic (independent of dist.api's own implementation)
# ---------------------------------------------------------------------------

def check_resolved(spec, shape: Tuple[int, ...], mesh: FakeMesh,
                   where: str) -> List[Finding]:
    """SH601: re-verify one resolved spec against the mesh."""
    out: List[Finding] = []
    entries = tuple(spec)
    if len(entries) > len(shape):
        out.append(Finding(
            rule="SH601", file=SHARDING_FILE, line=0, scope=where,
            message=f"spec {entries} has {len(entries)} entries for a "
                    f"rank-{len(shape)} leaf {shape}",
            hint="spec builders must emit at most one entry per dim"))
        return out
    used: set = set()
    for dim, entry in enumerate(entries):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for a in axes:
            if a not in mesh.shape:
                out.append(Finding(
                    rule="SH601", file=SHARDING_FILE, line=0, scope=where,
                    message=f"dim {dim} assigned axis {a!r} which is not "
                            f"in mesh {mesh.shape}",
                    hint="mesh_axes_for must filter to mesh.axis_names"))
            elif a in used:
                out.append(Finding(
                    rule="SH601", file=SHARDING_FILE, line=0, scope=where,
                    message=f"axis {a!r} consumed by two dims of {entries}",
                    hint="each mesh axis may shard at most one dim"))
            used.add(a)
        size = _prod(mesh.shape[a] for a in axes if a in mesh.shape)
        if size > 1 and shape[dim] % size != 0:
            out.append(Finding(
                rule="SH601", file=SHARDING_FILE, line=0, scope=where,
                message=f"dim {dim} of shape {shape} not divisible by "
                        f"{axes} (size {size}) in mesh {mesh.shape}",
                hint="logical_to_mesh must replicate non-dividing dims"))
    return out


def dropped_axes(mesh: FakeMesh, logical: Tuple[Optional[str], ...],
                 shape: Tuple[int, ...]) -> List[Tuple[int, str, int]]:
    """Dims whose requested logical axis exists in the mesh (size > 1)
    but was dropped by the divisibility fallback: mirrors
    ``logical_to_mesh``'s consumption loop, reporting what it silently
    replicated.  Returns (dim, logical name, axis size) triples."""
    from repro_torch.dist.api import mesh_axes_for

    used: set = set()
    fell: List[Tuple[int, str, int]] = []
    for dim, name in enumerate(logical):
        if name is None or dim >= len(shape):
            continue
        if shape[dim] <= 1:
            continue        # replicating a singleton dim loses nothing
        axes = tuple(a for a in mesh_axes_for(mesh, name)
                     if a not in used)
        size = _prod(mesh.shape[a] for a in axes)
        if not axes or size <= 1:
            continue                       # axis absent/trivial: no request
        if shape[dim] % size != 0:
            fell.append((dim, name, size))
        else:
            used.update(axes)
    return fell


# ---------------------------------------------------------------------------
# Abstract per-config state
# ---------------------------------------------------------------------------

def _abstract_state(cfg):
    """(params, qparams, opt, cache, {bits, budgets, batch}) as
    fake-tensor trees (:mod:`repro_torch.launch.specs`)."""
    from repro_torch.dist import sharding as dsh
    from repro_torch.launch import specs
    from repro_torch.models import lm
    from repro_torch.models.config import ShapeConfig

    params = specs.abstract_params(cfg)
    qparams = specs.abstract_qparams(cfg)
    opt = specs.abstract_opt(cfg, specs.optimizer_for(cfg))
    cache = specs.abstract_cache(cfg, ShapeConfig("audit", CACHE_LEN, BATCH,
                                                  "decode"))
    cache_b1 = specs.abstract_cache(cfg, ShapeConfig("audit_b1", CACHE_LEN,
                                                     1, "decode"))
    nb = lm.n_bit_slots(cfg)
    small = {"bits": specs.fake_tensor((BATCH, nb), torch.int32),
             "budgets": specs.fake_tensor((BATCH,), torch.float32),
             "batch": {"tokens": specs.fake_tensor((BATCH, CACHE_LEN),
                                                   torch.int32)}}
    if any(dsh._keys(p)[-1] in ("k", "v")
           for p, _ in dsh.tree_paths(cache_b1)):
        small["cache_b1"] = cache_b1        # the configs with a KV cache
    return params, qparams, opt, cache, small


def dp_meshes(meshes: Sequence[FakeMesh]) -> List[FakeMesh]:
    """The meshes with a data axis larger than 1."""
    return [m for m in meshes if m.shape.get("data", 1) > 1]


def _plans(cfg):
    """A fully replicated and a partial 8-device PlacementPlan."""
    from repro_torch.dist import placement as dpl
    from repro_torch.models import lm

    gd = lm.layer_gemm_dims(cfg)
    rep = [8] * len(gd)
    head = lm.head_gemm_dims(cfg)
    return (dpl.plan_placement(gd, rep, rep, n_devices=8, head=head),
            dpl.plan_placement(gd, rep, rep, n_devices=8, head=head,
                               memory_budget=1.5))


def audit_config_sharding(name: str, meshes: Sequence[FakeMesh],
                          resolved: Optional[Dict] = None
                          ) -> Tuple[List[Finding], Dict[str, int]]:
    """Every spec family for one FULL config across every mesh.
    ``resolved``, when given, collects ``(family, path, mesh label) ->
    resolved spec`` (a tuple) for every leaf."""
    from repro_torch import configs
    from repro_torch.dist import sharding as dsh
    from repro_torch.dist.sharding import tree_paths

    cfg = configs.get(name)
    params, qparams, opt, cache, small = _abstract_state(cfg)
    plan_full, plan_part = _plans(cfg)
    findings: List[Finding] = []
    stats = {"leaves": 0, "sharded": 0}

    def family(tag: str, tree, specs_of, logical_of=None, on=None):
        """``specs_of(mesh)``: the rule's resolved spec tree for ``tree``;
        ``logical_of(keys, leaf)``: its logical spec (SH602), or None
        for rules that resolve against the mesh themselves; ``on``: the
        meshes (default all)."""
        leaves = [(k, l) for k, l in tree_paths(tree)]
        for mesh in (meshes if on is None else on):
            got = [s for _, s in tree_paths(specs_of(mesh))]
            for (path, leaf), spec in zip(leaves, got):
                keys = dsh._keys(path)
                shape = tuple(leaf.shape)
                pstr = ".".join(keys)
                where = f"{name}/{tag}/{pstr}@{mesh_label(mesh)}"
                findings.extend(check_resolved(spec, shape, mesh, where))
                if logical_of is not None:
                    logical = logical_of(path, leaf)
                    for dim, lname, size in dropped_axes(mesh, logical,
                                                         shape):
                        findings.append(Finding(
                            rule="SH602", file=SHARDING_FILE, line=0,
                            scope=where,
                            message=f"logical axis {lname!r} requested on "
                                    f"dim {dim} of {shape} but dropped: "
                                    f"{shape[dim]} % {size} != 0",
                            hint=f"config {name} cannot shard this leaf "
                                 f"as specified; fix the shape or the "
                                 f"rule"))
                if resolved is not None:
                    resolved[(tag, pstr, mesh_label(mesh))] = tuple(spec)
                stats["leaves"] += 1
                stats["sharded"] += int(any(e is not None for e in spec))

    with warnings.catch_warnings():
        # the divisibility fallback warns once per shape; SH602 names it
        warnings.simplefilter("ignore", RuntimeWarning)
        family("params", params,
               lambda m: dsh.param_shardings(params, m),
               lambda p, l: dsh.param_pspec(p, l))
        family("qparams", qparams,
               lambda m: dsh.param_shardings(qparams, m),
               lambda p, l: dsh.param_pspec(p, l))
        # placement-plan overrides (dist/placement.py): a fully
        # replicated plan forces all-None on planned leaves; a partial
        # plan must fall back to the base rules unchanged
        family("qparams+plan_full", qparams,
               lambda m: dsh.param_shardings(qparams, m, plan=plan_full),
               lambda p, l: dsh.param_pspec(p, l, plan=plan_full))
        family("qparams+plan_partial", qparams,
               lambda m: dsh.param_shardings(qparams, m, plan=plan_part),
               lambda p, l: dsh.param_pspec(p, l, plan=plan_part))
        family("opt", opt, lambda m: dsh.opt_shardings(opt, m),
               lambda p, l: dsh.opt_pspec(p, l))
        for tag, pspec in (("bits", dsh.bits_pspec),
                           ("budgets", dsh.budgets_pspec)):
            leaf = small[tag]
            family(tag, {tag: leaf},
                   lambda m, leaf=leaf, pspec=pspec, tag=tag: {
                       tag: dsh.logical_to_mesh(m, pspec(leaf), leaf.shape)},
                   lambda p, l, pspec=pspec: pspec(l))
        family("batch", small["batch"],
               lambda m: dsh.batch_shardings(small["batch"], m),
               lambda p, l: dsh.batch_pspec(l))
        # cache specs resolve against the mesh with their own
        # divisibility logic: arithmetic-check them directly
        family("cache", cache, lambda m: dsh.cache_shardings(cache, m))
        b1 = small.get("cache_b1")
        if b1 is not None:        # B=1: the sequence over the data axis
            family("cache_b1", b1, lambda m: dsh.cache_shardings(b1, m),
                   on=dp_meshes(meshes))

        # safety net: the 2x2 mesh must actually place both axes
        net = FakeMesh(tuple(sorted(SAFETY_NET_MESH.items())))

        def placed(spec_tree, axis: str) -> bool:
            for _, spec in tree_paths(spec_tree):
                for e in spec:
                    axes = e if isinstance(e, tuple) else (e,)
                    if axis in axes:
                        return True
            return False

        qspecs = dsh.param_shardings(qparams, net)
        for axis in ("model", "data"):
            if not placed(qspecs, axis):
                findings.append(Finding(
                    rule="SH603", file=SHARDING_FILE, line=0,
                    scope=f"{name}/qparams@{mesh_label(net)}",
                    message=f"no quantized-param leaf sharded on {axis!r} "
                            f"on the 2x2 mesh — placement rules are inert "
                            f"for this config",
                    hint="check _logical_spec's key patterns against this "
                         "config's param tree"))
        if b1 is not None and not any(
                dsh._keys(p)[-1] in ("k", "v") and len(spec) > 2
                and "data" in dsh.entry_axes(spec[2])
                for p, spec in tree_paths(dsh.cache_shardings(b1, net))):
            findings.append(Finding(
                rule="SH603", file=SHARDING_FILE, line=0,
                scope=f"{name}/cache_b1@{mesh_label(net)}",
                message="no k/v cache leaf has its sequence on 'data' on "
                        "the 2x2 mesh at B=1",
                hint="check _kv_cache_spec's sequence placement"))
        if not placed(dsh.cache_shardings(cache, net), "data"):
            findings.append(Finding(
                rule="SH603", file=SHARDING_FILE, line=0,
                scope=f"{name}/cache@{mesh_label(net)}",
                message="no cache leaf sharded on 'data' on the 2x2 mesh "
                        f"at B={BATCH}",
                hint="check _cache_leaf_spec's batch-dim placement"))
    return findings, stats


def run_sharding(arch_ids: Optional[Sequence[str]] = None
                 ) -> Tuple[List[Finding], Dict[str, Dict[str, int]]]:
    """Audit every FULL config against the mesh matrix."""
    from repro_torch import configs

    meshes = fake_meshes()
    findings: List[Finding] = []
    summary: Dict[str, Dict[str, int]] = {}
    for name in (arch_ids if arch_ids is not None else configs.ARCH_IDS):
        f, stats = audit_config_sharding(name, meshes)
        findings.extend(f)
        summary[name] = stats
    return findings, summary

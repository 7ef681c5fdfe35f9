"""Path-based sharding rules for every parameter, optimizer, batch and
cache leaf, and the placement of parameters on a mesh.

The counterpart of ``repro.dist.sharding``.  The scheme is Megatron +
FSDP in logical axes (resolved by :mod:`repro_torch.dist.api`):

  * column-parallel linears (wq/wk/wv, wg/wu/wi, in_proj, router, head):
    output dim over "tp", input dim over "dp" (FSDP);
  * row-parallel linears (wo, wd, out_proj): input dim over "tp", output
    dim over "dp";
  * MoE expert stacks (..., E, d_in, d_out): experts over "tp" (expert
    parallelism) AND d_in over "dp";
  * embeddings: padded vocab over "tp", d_model over "dp";
  * Mamba2 conv kernels: channel dim over "tp"; scalar SSM params
    (A_log, D, dt_bias) and all norms replicate;
  * hybrid LoRA adapters: ``a`` FSDP-sharded on d_in, ``b`` on d_out/tp.

Every rule degrades to replication through the per-dimension
divisibility fallback of :func:`repro_torch.dist.api.logical_to_mesh`.

The spec functions are pure and take a leaf's key path: a sequence of
dict keys and list indices, named as the reference names jax tree paths
(``str(key)`` for a dict key, ``"[i]"`` for index i; :func:`tree_paths`
walks a tree so).  Where the reference returns ``NamedSharding`` trees,
the port returns trees of resolved :class:`~repro_torch.dist.api.P`
specs, and :func:`shard_params` places parameters: each rank keeps its
block of every sharded leaf, and the dict that holds such leaves becomes
a :class:`Local`, which keeps each one's whole shape and spec beside it.
:func:`full` gathers a :class:`Local` back whole.  ``shard_batch``,
``shard_bits`` and ``shard_budgets`` take this rank's block of a value
every rank holds whole.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.dist import api
from repro_torch.dist.api import P, entry_axes, logical_to_mesh  # noqa: F401

# Linear dicts whose INPUT dim is tensor-parallel (the reduction dim of
# the second GEMM in each pair: output resharded by one all-reduce).
_ROW_PARALLEL = ("wo", "wd", "out_proj")
# Leaf names that always replicate (norm scales, biases, SSM scalars).
_REPLICATED = frozenset(("scale", "bias", "b", "conv_b", "A_log", "D",
                         "dt_bias", "kpos", "step"))
_EXPERT_STACK = ("wg", "wu", "wd")
_LINEAR_LEAVES = ("w", "q", "q4", "s")


def _key(p) -> str:
    if isinstance(p, int) and not isinstance(p, bool):
        return f"[{p}]"
    return str(getattr(p, "key", p))


def _keys(path) -> Tuple[str, ...]:
    return tuple(_key(p) for p in path)


def tree_paths(tree, prefix: Tuple = ()):
    """(key path, leaf) of every leaf of a tree of dicts, lists and
    tuples, in insertion order; list indices are ints (a spec
    :class:`~repro_torch.dist.api.P` is a leaf)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        for i, v in enumerate(tree):
            yield from tree_paths(v, prefix + (i,))
    else:
        yield prefix, tree


def _tree_map(fn, tree, prefix: Tuple = ()):
    """``fn(path, leaf)`` over a tree, keeping its structure."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_tree_map(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _logical_spec(keys: Sequence[str], nd: int,
                  plan=None) -> Tuple[Optional[str], ...]:
    """Per-dimension logical axes for a parameter leaf at ``keys``.

    ``plan`` (a :class:`repro_torch.dist.placement.PlacementPlan`)
    overrides the base rule with replication for leaves whose priced
    entry the planner fully replicated; entries it left at fewer copies
    keep the base rule."""
    if nd == 0:
        return ()
    if plan is not None and plan.replicates(keys):
        return (None,) * nd
    name = keys[-1]
    parent = keys[-2] if len(keys) >= 2 else ""
    if "lora" in keys and name in ("a", "b"):
        spec = [None] * nd
        spec[-2 if name == "a" else -1] = "dp" if name == "a" else "tp"
        return tuple(spec)
    if name in _REPLICATED or nd == 1:
        return (None,) * nd
    if name == "emb":
        return (None,) * (nd - 2) + ("tp", "dp")
    if "experts" in keys and (name in _EXPERT_STACK
                              or parent in _EXPERT_STACK):
        # (..., E, d_in, d_out) train form, or {"q", "s"} serve form whose
        # middle dim is 1 for scales (falls back to replication there)
        if nd >= 3:
            return (None,) * (nd - 3) + ("tp", "dp", None)
        return (None,) * nd
    if name == "conv_w":
        return (None,) * (nd - 1) + ("tp",)
    if name in _LINEAR_LEAVES and nd >= 2:
        if parent in _ROW_PARALLEL:
            return (None,) * (nd - 2) + ("tp", "dp")
        return (None,) * (nd - 2) + ("dp", "tp")
    return (None,) * nd


def param_pspec(path, leaf, plan=None) -> Tuple[Optional[str], ...]:
    """Logical per-dimension spec for one parameter leaf (len == ndim)."""
    return _logical_spec(_keys(path), leaf.ndim, plan=plan)


def param_shardings(params, mesh, plan=None):
    """A tree of resolved specs mirroring ``params`` (train or serve
    form).  ``plan`` applies a placement planner's replication
    overrides."""
    return _tree_map(lambda path, leaf: logical_to_mesh(
        mesh, param_pspec(path, leaf, plan), leaf.shape), params)


# ---------------------------------------------------------------------------
# Optimizer state: moments mirror parameter sharding (FSDP shards Adam
# state too); the int8 / factored codecs reuse the base parameter's spec.
# ---------------------------------------------------------------------------

_CODEC_SUFFIXES = frozenset(("q", "s", "vr", "vc"))


def opt_pspec(path, leaf) -> Tuple[Optional[str], ...]:
    keys = _keys(path)
    if keys[0] == "step":
        return (None,) * leaf.ndim
    base = keys[1:]                       # drop the leading "m" / "v"
    name = base[-1] if base else ""
    if name in _CODEC_SUFFIXES:
        pkeys = base[:-1]
        if name in ("q", "s"):            # int8 codec: q = param shape,
            return _logical_spec(pkeys, leaf.ndim)   # s last dim 1 -> repl.
        full_ = _logical_spec(pkeys, leaf.ndim + 1)  # factored v drops a dim
        return full_[:-1] if name == "vr" else full_[:-2] + full_[-1:]
    return _logical_spec(base, leaf.ndim)


def opt_shardings(opt, mesh):
    return _tree_map(lambda path, leaf: logical_to_mesh(
        mesh, opt_pspec(path, leaf), leaf.shape), opt)


# ---------------------------------------------------------------------------
# Batches / activations
# ---------------------------------------------------------------------------

def batch_pspec(leaf) -> Tuple[Optional[str], ...]:
    """Inputs shard their leading (batch) dim over dp, rest replicated."""
    if leaf.ndim == 0:
        return ()
    return ("dp",) + (None,) * (leaf.ndim - 1)


def batch_shardings(batch, mesh):
    return _tree_map(lambda _, leaf: logical_to_mesh(
        mesh, batch_pspec(leaf), leaf.shape), batch)


def block(mesh, t: torch.Tensor, spec) -> torch.Tensor:
    """This rank's block of ``t`` (held whole) laid out as ``spec``."""
    for dim, e in enumerate(spec):
        if e is not None:
            t = mesh.local_block(t, entry_axes(e), dim)
    return t


def row_block(mesh, n_rows: int) -> slice:
    """This rank's rows of ``n_rows`` that every rank holds: block
    ``mesh.dp_index`` of ``dp_size(mesh)`` equal blocks (:func:`batch_pspec`
    resolved on ``mesh``), so every model rank of one data index takes
    the same rows; every row off a mesh or when the data ranks do not
    divide ``n_rows`` (the divisibility fallback)."""
    if mesh is None or logical_to_mesh(mesh, ("dp",), (n_rows,))[0] is None:
        return slice(0, n_rows)
    per = n_rows // api.dp_size(mesh)
    return slice(mesh.dp_index * per, (mesh.dp_index + 1) * per)


def shard_batch(batch, mesh=None):
    """This rank's rows (:func:`row_block`) of every leaf of a host batch
    every rank holds (identity off-mesh)."""
    mesh = mesh if mesh is not None else api.active_mesh()
    if mesh is None:
        return batch

    def rows(_, leaf):
        leaf = torch.as_tensor(leaf)
        return leaf[row_block(mesh, leaf.shape[0])] if leaf.ndim else leaf
    return _tree_map(rows, batch)


def bits_pspec(leaf) -> Tuple[Optional[str], ...]:
    """Per-layer bit tables: (L,) replicates; a per-request (B, L) bit
    matrix shards its batch dim over dp, so each dp shard carries exactly
    the bit rows of the activation rows it owns."""
    if leaf.ndim == 2:
        return ("dp", None)
    return (None,) * leaf.ndim


def budgets_pspec(leaf) -> Tuple[Optional[str], ...]:
    """Per-request (B,) budget vectors shard over dp like the rows they
    gate."""
    if leaf.ndim >= 1:
        return ("dp",) + (None,) * (leaf.ndim - 1)
    return ()


def shard_budgets(budgets, mesh=None):
    """This rank's block of a per-request budget vector (identity
    off-mesh; replication fallback for non-dividing B)."""
    mesh = mesh if mesh is not None else api.active_mesh()
    if mesh is None:
        return budgets
    return block(mesh, budgets, logical_to_mesh(
        mesh, budgets_pspec(budgets), budgets.shape))


def shard_bits(bits, mesh=None):
    """This rank's block of a resolved bit table (identity off-mesh);
    replication fallback covers non-dividing batch sizes."""
    mesh = mesh if mesh is not None else api.active_mesh()
    if mesh is None:
        return bits
    return block(mesh, bits, logical_to_mesh(mesh, bits_pspec(bits),
                                              bits.shape))


# ---------------------------------------------------------------------------
# KV / SSM caches
# ---------------------------------------------------------------------------

def _axis_entry(axes: Tuple[str, ...]):
    return axes[0] if len(axes) == 1 else tuple(axes)


def _kv_cache_spec(mesh, shape) -> P:
    """(L, B, S, KV, hd) cache spec.

    dp goes on the batch dim when it divides; a B=1 long-context decode
    shards the SEQUENCE over dp instead.  tp goes on KV heads when they
    divide, else on the per-head feature dim (small-GQA models)."""
    L, B, S, KV, hd = shape
    entries: list = [None] * 5
    dp_axes = api.mesh_axes_for(mesh, "dp")
    dp_sz = api.dp_size(mesh)
    if dp_sz > 1:
        if B % dp_sz == 0:
            entries[1] = _axis_entry(dp_axes)
        elif S % dp_sz == 0:
            entries[2] = _axis_entry(dp_axes)
    tp_axes = api.mesh_axes_for(mesh, "tp")
    tp_sz = api.tp_size(mesh)
    if tp_sz > 1:
        if KV % tp_sz == 0:
            entries[3] = _axis_entry(tp_axes)
        elif hd % tp_sz == 0:
            entries[4] = _axis_entry(tp_axes)
    return P(*entries)


def _cache_leaf_spec(mesh, keys: Tuple[str, ...], leaf) -> P:
    name = keys[-1]
    shape = tuple(leaf.shape)
    if name in ("k", "v") and leaf.ndim == 5:
        return _kv_cache_spec(mesh, shape)
    if name == "kpos" and leaf.ndim == 3:           # (L, B, Sc) per-row
        L, B, Sc = shape                            # positions follow the
        dp_sz = api.dp_size(mesh)                   # k/v batch placement
        if dp_sz > 1 and B % dp_sz == 0:
            return P(None, _axis_entry(api.mesh_axes_for(mesh, "dp")), None)
        return P(None, None, None)
    if name in ("ks", "vs") and leaf.ndim == 4:     # int8 cache scales:
        full_ = _kv_cache_spec(mesh, shape + (1,))  # (L, B, S, KV) = k/v
        return P(*tuple(full_)[:4])                 # minus the head dim
    if name == "ssm" and leaf.ndim >= 3:            # (L, B, H, P, N)
        return logical_to_mesh(
            mesh, (None, "dp", "tp") + (None,) * (leaf.ndim - 3), shape)
    if name == "conv" and leaf.ndim >= 2:           # (L, B, K-1, C)
        spec = [None] * leaf.ndim
        spec[1] = "dp"
        spec[-1] = "tp"
        return logical_to_mesh(mesh, tuple(spec), shape)
    return P(*(None,) * leaf.ndim)                  # kpos etc.


def cache_shardings(cache, mesh, plan=None):
    """Cache specs; ``plan`` is accepted for call-site symmetry with
    :func:`param_shardings` (a placement plan only moves WEIGHTS)."""
    del plan
    return _tree_map(lambda path, leaf: _cache_leaf_spec(
        mesh, _keys(path), leaf), cache)


# ---------------------------------------------------------------------------
# Parameters on a mesh: local blocks with their layout beside them
# ---------------------------------------------------------------------------

class Local(dict):
    """A parameter dict on a mesh whose sharded tensor leaves are this
    rank's blocks.

    ``layout[name] = (whole shape, spec)`` for each sharded leaf (specs
    resolved on ``mesh``); the other leaves are whole.  Shapes and specs
    of a stacked ``(L, ...)`` leaf align from the trailing dim, so a
    layer's view (``common.unstack``/``stack_slice``, which keep the
    class) reads the same entry."""

    def __init__(self, items, mesh, layout: Dict[str, tuple]):
        super().__init__(items)
        self.mesh = mesh
        self.layout = layout

    def like(self, items) -> "Local":
        """Another dict of the same leaves (a layer's views)."""
        return Local(items, self.mesh, self.layout)

    def spec(self, name: str):
        """(whole shape, spec) of leaf ``name`` trailing-aligned to its
        current ndim; a whole leaf reports its own shape and no axes."""
        t = self[name]
        if name not in self.layout:
            return tuple(t.shape), (None,) * t.ndim
        shape, spec = self.layout[name]
        return tuple(shape[-t.ndim:]), tuple(spec[-t.ndim:])


def shard_params(params, mesh, plan=None):
    """Place ``params`` on ``mesh`` by :func:`param_shardings`: each
    sharded leaf keeps this rank's block (its own memory, so the whole
    tensor can be freed) and its dict becomes a :class:`Local`."""
    def rec(node, keys):
        items, layout = {}, {}
        for k, v in node.items():
            if isinstance(v, dict):
                items[k] = rec(v, keys + (k,))
                continue
            spec = logical_to_mesh(mesh, _logical_spec(keys + (k,), v.ndim,
                                                       plan), v.shape)
            if all(e is None for e in spec):
                items[k] = v
                continue
            items[k] = block(mesh, v, spec).clone(
                memory_format=torch.contiguous_format)
            layout[k] = (tuple(v.shape), spec)
        return Local(items, mesh, layout) if layout else items
    return rec(params, ())


def is_sharded(tree) -> bool:
    """Whether any dict of ``tree`` holds a sharded block."""
    if isinstance(tree, Local):
        return True
    if isinstance(tree, dict):
        return any(is_sharded(v) for v in tree.values())
    return False


def gather_leaf(p: Local, name: str) -> torch.Tensor:
    """Leaf ``name`` of ``p`` whole (each sharded dim all-gathered, once
    per block inside ``mesh.reuse_gathers()``)."""
    t = p[name]
    _, spec = p.spec(name)
    for dim, e in enumerate(spec):
        if e is not None:
            t = p.mesh.gather_weight(t, entry_axes(e), dim - len(spec))
    return t


def full(tree):
    """``tree`` with every :class:`Local` gathered whole (plain dicts)."""
    if isinstance(tree, Local):
        return {k: (full(v) if isinstance(v, dict) else gather_leaf(tree, k))
                for k, v in tree.items()}
    if isinstance(tree, dict):
        return {k: full(v) for k, v in tree.items()}
    return tree

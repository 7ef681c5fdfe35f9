"""Mesh context, logical-axis resolution and the meshes' collectives: the
one sharding vocabulary of the port.

The counterpart of ``repro.dist.api``.  Models and engines speak LOGICAL
axes ("dp" data-parallel, "tp" tensor-parallel, "dp+tp" both, None
replicated); this module maps them onto the axes of whatever mesh is
active:

  1-axis mesh ("data",)                 dp -> "data"
  2-axis mesh ("data", "model")         dp -> "data",           tp -> "model"
  3-axis mesh ("pod", "data", "model")  dp -> ("pod", "data"),  tp -> "model"

A mesh is duck-typed as in the reference: ``.shape`` maps each axis name
to its size and ``.axis_names`` is a tuple, so the spec functions run on
any object of that form (the tests use a fake one).  The active mesh is
the innermost :func:`use_mesh` block's (thread-local, nestable); there is
no framework-level mesh context to fall back to.

:func:`logical_to_mesh` resolves per-dimension logical axes into a
:class:`P` (a tuple: its entries compare equal to the reference's
``PartitionSpec`` entries), with the reference's per-dimension
divisibility fallback and its one-shot ``RuntimeWarning``.

:class:`Mesh` is the concrete mesh: 1, 2 or 3 axes over an initialised
gloo ``torch.distributed`` group, one rank per mesh position (row-major
over the axes), and one subgroup per line of every combination of axes.
Its collectives are all-reduce (SUM, MAX), all-gather and broadcast along
a set of axes.  They stage through CPU tensors (page-locked for a card's
tensors): two ranks that share one GPU cannot use NCCL (it refuses a
duplicate device), and gloo's support for CUDA tensors is partial.  An
all-gather is an integer SUM of the blocks in zeroed slots, bit for bit
(gloo's all-reduce moves bytes about twice as fast as its all-gather),
and every payload travels as int32 or uint8 words, which every gloo
build reduces.  Each collective is counted by kind and by
the bytes this rank contributed (``Mesh.counts``).  :class:`DataMesh` is
its 1-axis case.

The collectives are differentiable, so a train step's gradients pass
through them (``torch.autograd.Function``s over the same counted calls,
taken when the operand requires grad under grad mode).  Activations
split over the data axis are its rows, and the loss of a data rank is
its rows' share, so a value summed over data ranks holds the whole
batch's gradient; over the model axis every rank holds the same loss.
Hence:

* an all-gather (a weight's FSDP blocks, a column-parallel output's
  columns) backs a SUM over the gathered data axes, then this rank's
  block: a reduce-scatter for an FSDP weight, a plain split for columns
  every model rank consumes alike;
* a SUM (a row-parallel output, the vocab-split embedding) backs the
  identity: each rank receives the whole gradient of the sum;
* :meth:`Mesh.enter` marks a value every model rank holds alike that
  each rank consumes in part (the input of a column-parallel linear, a
  replicated scale applied to this rank's heads): the identity forward,
  a SUM over the model axis backward;
* a MAX (an activation's amax) has no gradient: scales sit under the
  straight-through estimator's stop-gradient.

A gradient's SUM rounds once, as one device's sum does
(:meth:`Mesh.sum_grad`).

The port represents a sharded value as LOCAL tensors: each rank holds
its block, and the layout is kept beside it (``dist.sharding.Local`` for
parameters; the model code knows its activations').  The data axis of an
activation is laid out before the model runs (the engines give each data
rank its rows), so ``"dp"`` entries hold by construction inside the
model; :func:`constrain` lays out the tensor-parallel entries, gathering
or slicing, and never changes a value.  It is the identity off-mesh and
under :func:`manual_mode`.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import threading
import warnings
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

# Logical -> candidate mesh axes, in the order they combine.
_LOGICAL_AXES = {
    "dp": ("pod", "data"),
    "tp": ("model",),
}

_local = threading.local()


class P(tuple):
    """A partition spec: one entry per dimension, each None (replicated),
    a mesh axis name, or a tuple of axis names (combined, row-major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(tuple(self))


# ---------------------------------------------------------------------------
# Mesh context stack
# ---------------------------------------------------------------------------

def _stack() -> list:
    if not hasattr(_local, "meshes"):
        _local.meshes = []
    return _local.meshes


@contextlib.contextmanager
def use_mesh(mesh):
    """Push ``mesh`` as the active mesh for the enclosed block (nestable)."""
    _stack().append(mesh)
    try:
        yield mesh
    finally:
        _stack().pop()


def active_mesh():
    """Innermost active mesh, or None."""
    stack = _stack()
    return stack[-1] if stack else None


@contextlib.contextmanager
def manual_mode():
    """Mark the enclosed block as running INSIDE a :func:`shard_map_compat`
    body: each rank holds its local blocks and calls its collectives
    itself, so :func:`constrain`/:func:`constrain_heads` are the identity
    while the flag is up (thread-local)."""
    prev = getattr(_local, "manual", False)
    _local.manual = True
    try:
        yield
    finally:
        _local.manual = prev


def in_manual_mode() -> bool:
    return getattr(_local, "manual", False)


def dp_size(mesh=None) -> int:
    """Total data-parallel ways of the active (or given) mesh."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None:
        return 1
    return math.prod(mesh.shape[a] for a in _LOGICAL_AXES["dp"]
                     if a in mesh.shape)


def tp_size(mesh=None) -> int:
    """Tensor-parallel ways (size of the "model" axis), 1 without a mesh."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None:
        return 1
    return math.prod(mesh.shape[a] for a in _LOGICAL_AXES["tp"]
                     if a in mesh.shape)


def mesh_axes_for(mesh, logical: Optional[str]) -> Tuple[str, ...]:
    """Mesh axes a logical name maps to on this mesh ("dp+tp" combines)."""
    if logical is None:
        return ()
    names = set(mesh.axis_names)
    out = []
    for part in logical.split("+"):
        try:
            candidates = _LOGICAL_AXES[part]
        except KeyError:
            raise ValueError(f"unknown logical axis {part!r}; "
                             f"known: {sorted(_LOGICAL_AXES)}") from None
        out.extend(a for a in candidates if a in names)
    return tuple(out)


# ---------------------------------------------------------------------------
# Logical -> mesh resolution
# ---------------------------------------------------------------------------

# divisibility fallbacks already warned about (one-shot per distinct
# (logical axis, mesh axes, dim, shape): a serving loop resolves the same
# specs every tick and must not spam)
_warned_fallbacks: set = set()


def logical_to_mesh(mesh, logical_axes: Sequence[Optional[str]],
                    shape: Sequence[int]) -> P:
    """Resolve per-dimension logical axes into a :class:`P`.

    Per-dimension divisibility fallback: if the dim size does not divide
    the product of the mapped mesh-axis sizes, that dimension replicates,
    with a one-shot RuntimeWarning naming the axis and shape.  A mesh
    axis is consumed at most once per spec (first dim wins)."""
    assert len(logical_axes) == len(shape), (logical_axes, shape)
    used: set = set()
    entries = []
    for dim, logical in zip(shape, logical_axes):
        axes = tuple(a for a in mesh_axes_for(mesh, logical)
                     if a not in used)
        size = math.prod(mesh.shape[a] for a in axes) if axes else 0
        if not axes or size <= 1 or dim % size != 0:
            if axes and size > 1 and dim > 1:
                # a real sharding request fell back (absent/trivial axes
                # and singleton dims lose nothing: stay silent there)
                key = (logical, axes, int(dim), tuple(shape))
                if key not in _warned_fallbacks:
                    _warned_fallbacks.add(key)
                    warnings.warn(
                        f"logical axis {logical!r} -> mesh axes "
                        f"{axes} (size {size}) does not divide dim "
                        f"{dim} of shape {tuple(shape)}; replicating "
                        f"this dimension", RuntimeWarning, stacklevel=2)
            entries.append(None)
            continue
        used.update(axes)
        entries.append(axes[0] if len(axes) == 1 else axes)
    return P(*entries)


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None -> ())."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def is_tp_entry(entry) -> bool:
    """Whether a resolved entry shards over the tensor-parallel axis."""
    return bool(set(entry_axes(entry)) & set(_LOGICAL_AXES["tp"]))


def local_shape(mesh, spec: Sequence, shape: Sequence[int]) -> Tuple[int, ...]:
    """The block shape one rank holds of a ``shape`` value laid out as
    ``spec``."""
    return tuple(d // math.prod(mesh.shape[a] for a in entry_axes(e))
                 for d, e in zip(shape, spec))


# ---------------------------------------------------------------------------
# Layout statements (identity off-mesh and inside shard_map bodies)
# ---------------------------------------------------------------------------

def _tp_spec(mesh, logical_axes, shape):
    """The tensor-parallel entries of a resolved spec (the rest None)."""
    spec = logical_to_mesh(mesh, logical_axes, shape)
    return tuple(e if is_tp_entry(e) else None for e in spec)


def constrain(x: torch.Tensor, logical_axes: Sequence[Optional[str]], *,
              have: Optional[Sequence[Optional[str]]] = None
              ) -> torch.Tensor:
    """Lay ``x`` out as ``logical_axes`` on the active mesh; identity
    off-mesh and under :func:`manual_mode`.

    ``x`` is this rank's block laid out as ``have`` (logical axes; None:
    tensor-replicated).  Each tensor-parallel entry of the target that
    ``have`` lacks slices this rank's block out of ``x``; each one ``have``
    has and the target lacks all-gathers it.  The data axis is laid out by
    the engines' row split before the model runs, so ``"dp"`` entries
    hold by construction.  The value never changes."""
    mesh = active_mesh()
    if mesh is None or in_manual_mode() or tp_size(mesh) <= 1:
        return x
    have = tuple(have) if have is not None else (None,) * x.ndim
    tp = tp_size(mesh)
    cur_axes = tuple("tp" if a is not None and "tp" in a.split("+") else None
                     for a in have)
    gshape = tuple(d * tp if a else d for d, a in zip(x.shape, cur_axes))
    want = _tp_spec(mesh, logical_axes, gshape)
    cur = _tp_spec(mesh, cur_axes, gshape)
    for dim, (w, c) in enumerate(zip(want, cur)):
        if c is not None and w is None:
            x = mesh.all_gather(x, entry_axes(c), dim=dim, kind="constrain")
        elif w is not None and c is None:
            x = mesh.local_block(x, entry_axes(w), dim=dim)
    return x


def constrain_heads(x: torch.Tensor, head_dim: int, alt_dim: int,
                    use_head: bool, *, have=None) -> torch.Tensor:
    """Shard dim 0 over dp and ONE of (head_dim | alt_dim) over tp.

    Attention uses this to keep q/k/v/cache consistently sharded: when the
    (KV-)head count divides tp, shard heads (Megatron); otherwise the
    per-head feature dim (``alt_dim``)."""
    axes: list = [None] * x.ndim
    axes[0] = "dp"
    axes[head_dim if use_head else alt_dim] = "tp"
    return constrain(x, tuple(axes), have=have)


def shard_map_compat(f, *, mesh, in_specs, out_specs, check: bool = False):
    """The reference's ``shard_map`` on the port's meshes.

    Returns ``g(*args)``: each argument (a tensor or a dict of tensors,
    held whole on every rank) is sliced to this rank's block per its
    ``in_specs`` entry (a :class:`P` of mesh axes, or a dict of them), ``f``
    runs on the blocks under :func:`manual_mode` (it calls the mesh's
    collectives itself), and each output is all-gathered back whole per
    ``out_specs``.  ``check`` is accepted for signature parity and
    ignored, as the reference's callers pass False."""
    del check

    def place(tree, spec, fn):
        if isinstance(tree, dict):
            return {k: place(v, spec[k] if isinstance(spec, dict) else spec,
                             fn) for k, v in tree.items()}
        for dim, e in enumerate(spec):
            if e is not None:
                tree = fn(tree, entry_axes(e), dim)
        return tree

    def g(*args):
        blocks = [place(a, s, mesh.local_block)
                  for a, s in zip(args, in_specs)]
        with manual_mode():
            out = f(*blocks)
        multi = isinstance(out, tuple)
        outs = out if multi else (out,)
        specs = out_specs if multi else (out_specs,)
        whole = tuple(place(o, s, lambda t, ax, d: mesh.all_gather(
            t, ax, dim=d, kind="shard_map")) for o, s in zip(outs, specs))
        return whole if multi else whole[0]

    return g


# ---------------------------------------------------------------------------
# Concrete meshes over a gloo group
# ---------------------------------------------------------------------------

_MESH_AXES = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}


def _host(t: torch.Tensor) -> torch.Tensor:
    """A contiguous CPU copy of ``t`` (page-locked when ``t`` is on the
    card, so the copies to and from it run at the link's rate)."""
    t = t.detach()
    if t.device.type == "cpu":
        return t.clone(memory_format=torch.contiguous_format)
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf


def _words(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes as a flat int32 (or, for a size not a multiple of 4,
    uint8) tensor: integer SUMs of it with zeros move it bit for bit."""
    flat = t.reshape(-1).view(torch.uint8)
    return flat.view(torch.int32) if flat.numel() % 4 == 0 else flat


class Mesh:
    """A 1-, 2- or 3-axis mesh over the initialised default gloo group.

    ``shape`` gives each axis's size, row-major over the global ranks:
    ``("data",)``, ``("data", "model")`` or ``("pod", "data", "model")``
    by the number of axes (pass ``axis_names`` to name them otherwise).
    Their product must be the world size.  Every rank builds the same
    mesh (SPMD); construction creates one subgroup per line of every
    combination of axes larger than 1, collectively.

    ``coords`` is this rank's position on each axis; ``index(axes)`` its
    row-major position along a combination of axes.  ``counts`` maps a
    collective kind to ``[calls, bytes]``, the bytes this rank put in.
    Inside :meth:`reuse_gathers` a weight gather of the same block is
    made once (the FSDP weights of a scheduler tick)."""

    def __init__(self, shape: Sequence[int],
                 axis_names: Optional[Sequence[str]] = None) -> None:
        if not tdist.is_initialized():
            raise RuntimeError("a Mesh needs an initialised "
                               "torch.distributed process group")
        backend = tdist.get_backend()
        if backend != "gloo":
            raise NotImplementedError(
                f"the port's meshes stage their collectives through CPU "
                f"tensors and need a gloo group, not {backend!r}")
        shape, names = self._place(shape, axis_names, tdist.get_rank())
        if self.size != tdist.get_world_size():
            raise ValueError(f"mesh shape {shape} holds {self.size} ranks, "
                             f"the group {tdist.get_world_size()}")
        # one subgroup per line of each combination of non-trivial axes,
        # created by every rank in the same order
        self._groups: Dict[Tuple[str, ...], object] = {}
        live = tuple(a for a in names if self.shape[a] > 1)
        for r in range(1, len(live) + 1):
            for combo in itertools.combinations(live, r):
                if combo == live:
                    self._groups[combo] = tdist.group.WORLD
                    continue
                for ranks in self._lines(combo):
                    g = tdist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[combo] = g

    def _place(self, shape, axis_names, rank: int):
        """Set the layout: axis names and sizes, this rank's coordinates,
        empty counts.  Returns (shape, axis names) as tuples."""
        shape = tuple(int(s) for s in shape)
        names = (tuple(axis_names) if axis_names is not None
                 else _MESH_AXES.get(len(shape)))
        if names is None or len(names) != len(shape):
            raise ValueError(f"a mesh of shape {shape} needs axis names")
        self.size = math.prod(shape)
        self.axis_names = names
        self.shape: Dict[str, int] = dict(zip(names, shape))
        self.rank = rank
        self.coords: Dict[str, int] = {}
        rem = rank
        for a, n in reversed(list(zip(names, shape))):
            self.coords[a] = rem % n
            rem //= n
        self.counts: Dict[str, list] = {}
        self._gathered: Optional[dict] = None
        return shape, names

    def _lines(self, axes: Tuple[str, ...]):
        """Every group of global ranks that differ only along ``axes``."""
        strides, s = {}, 1
        for a in reversed(self.axis_names):
            strides[a] = s
            s *= self.shape[a]
        rest = [a for a in self.axis_names if a not in axes]
        out = []
        for fixed in itertools.product(*(range(self.shape[a]) for a in rest)):
            base = sum(i * strides[a] for a, i in zip(rest, fixed))
            out.append(sorted(
                base + sum(i * strides[a] for a, i in zip(axes, idx))
                for idx in itertools.product(
                    *(range(self.shape[a]) for a in axes))))
        return out

    # ---- positions
    def live_axes(self, axes) -> Tuple[str, ...]:
        """The axes of ``axes`` this mesh has with more than one rank, in
        the mesh's order."""
        axes = tuple(a for a in entry_axes(axes) if a in self.shape)
        return tuple(a for a in self.axis_names
                     if a in axes and self.shape[a] > 1)

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self.live_axes(axes))

    def index(self, axes) -> int:
        """This rank's row-major position along ``axes``."""
        i = 0
        for a in self.live_axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return mesh_axes_for(self, "dp")

    @property
    def tp_axes(self) -> Tuple[str, ...]:
        return mesh_axes_for(self, "tp")

    @property
    def dp_index(self) -> int:
        return self.index(self.dp_axes)

    @property
    def tp_index(self) -> int:
        return self.index(self.tp_axes)

    def _count(self, kind: str, t: torch.Tensor) -> None:
        c = self.counts.setdefault(kind, [0, 0])
        c[0] += 1
        c[1] += t.numel() * t.element_size()

    def reset_counts(self) -> None:
        self.counts = {}

    # ---- collectives (staged through CPU tensors)
    def all_reduce(self, t: torch.Tensor, axes, op: str = "sum", *,
                   kind: Optional[str] = None) -> torch.Tensor:
        """SUM or MAX of ``t`` over ``axes`` (int32 sums wrap modulo 2^32,
        as an int32 accumulator does), on ``t``'s device.  A SUM of a
        tensor that requires grad backs the identity (module
        docstring); a MAX has no gradient."""
        if op == "sum" and _tracks(t) and self.live_axes(axes):
            return _Sum.apply(t, self, axes, kind or "all_reduce_sum")
        return self._all_reduce(t, axes, op, kind=kind)

    def _all_reduce(self, t: torch.Tensor, axes, op: str = "sum", *,
                    kind: Optional[str] = None) -> torch.Tensor:
        live = self.live_axes(axes)
        if not live:
            return t
        self._count(kind or f"all_reduce_{op}", t)
        buf = _host(t)
        red = {"sum": tdist.ReduceOp.SUM, "max": tdist.ReduceOp.MAX}[op]
        tdist.all_reduce(buf, op=red, group=self._groups[live])
        return buf.to(t.device)

    def all_gather(self, t: torch.Tensor, axes, dim: int = 0, *,
                   kind: str = "all_gather") -> torch.Tensor:
        """Every rank's block along ``axes`` concatenated on ``dim`` in
        row-major order, on ``t``'s device.  For a tensor that requires
        grad it backs a SUM over the gathered data axes and this rank's
        block (module docstring)."""
        if _tracks(t) and self.live_axes(axes):
            return _Gather.apply(t, self, axes, dim, kind)
        return self._all_gather(t, axes, dim, kind=kind)

    def _all_gather(self, t: torch.Tensor, axes, dim: int = 0, *,
                    kind: str = "all_gather") -> torch.Tensor:
        live = self.live_axes(axes)
        if not live:
            return t
        self._count(kind, t)
        # every block in its own slot of a zeroed buffer, then one integer
        # SUM over the line (gloo's all-reduce outruns its all-gather)
        n = self.axis_size(live)
        t = t.detach().contiguous()
        buf = torch.zeros((n,) + tuple(t.shape), dtype=t.dtype,
                          pin_memory=t.device.type == "cuda")
        buf[self.index(live)].copy_(t)
        tdist.all_reduce(_words(buf), op=tdist.ReduceOp.SUM,
                         group=self._groups[live])
        out = torch.cat(buf.unbind(0), dim=dim % t.ndim) if t.ndim else buf
        return out.to(t.device)

    def gather_whole(self, t: torch.Tensor, spec, *,
                     kind: str = "gather_whole") -> Optional[torch.Tensor]:
        """The whole of a value laid out as ``spec`` (one entry per dim;
        ``t`` this rank's block), as a CPU tensor on the first rank of
        this rank's line along the spec's axes, None on its other ranks:
        one gloo gather, in which each block travels once."""
        live = self.live_axes(tuple(a for e in spec for a in entry_axes(e)))
        t = t.detach().to("cpu").contiguous()
        if not live:
            return t
        line = next(ln for ln in self._lines(live) if self.rank in ln)
        self._count(kind, t)
        root = line[0] == self.rank
        blocks = [torch.empty_like(t) for _ in line] if root else None
        tdist.gather(t, gather_list=blocks, dst=line[0],
                     group=self._groups[live])
        if not root:
            return None
        whole = torch.empty(tuple(d * self.axis_size(e) for d, e in
                                  zip(t.shape, spec)), dtype=t.dtype)
        for j, block in enumerate(blocks):    # row-major over ``live``
            coords, rem = {}, j
            for a in reversed(live):
                coords[a] = rem % self.shape[a]
                rem //= self.shape[a]
            index = []
            for d, e in zip(t.shape, spec):
                i = 0
                for a in self.live_axes(e):
                    i = i * self.shape[a] + coords[a]
                index.append(slice(i * d, (i + 1) * d))
            whole[tuple(index)] = block
        return whole

    def enter(self, t: torch.Tensor, axes, *,
              kind: str = "grad_tp") -> torch.Tensor:
        """``t`` as it is; its gradient SUMmed over ``axes`` (a value
        every rank of ``axes`` holds alike and consumes in part).  A
        tensor this returned is not entered again over the same axes, so
        the consumers of one value (q, k and v of one input) share one
        SUM."""
        live = self.live_axes(axes)
        if not _tracks(t) or not live or getattr(t, "_entered", None) == live:
            return t
        out = _Enter.apply(t, self, axes, kind)
        out._entered = live
        return out

    def sum_grad(self, g: torch.Tensor, axes, *, kind: str) -> torch.Tensor:
        """SUM of a gradient over ``axes``, in its own dtype (no gradient
        of its own).  Over two ranks a sum of two values rounds once in
        any dtype, so a bf16 gradient travels as bf16; over more, the
        ring's partial sums travel in float32 and the sum rounds once."""
        live = self.live_axes(axes)
        if not live:
            return g
        if self.axis_size(live) == 2 or g.dtype == torch.float32:
            return self._all_reduce(g.detach(), axes, "sum", kind=kind)
        out = self._all_reduce(g.detach().float(), axes, "sum", kind=kind)
        return out.to(g.dtype)

    def broadcast(self, t: torch.Tensor, src: int, axes=None, *,
                  kind: str = "broadcast") -> torch.Tensor:
        """The ``t`` of the rank at position ``src`` along ``axes`` (default:
        the data axes) on every rank of this rank's line, as a CPU tensor;
        each passes a tensor of the same shape and dtype."""
        live = self.live_axes(self.dp_axes if axes is None else axes)
        if not live:
            return t.detach().to("cpu").clone()
        self._count(kind, t)
        buf = t.detach().to("cpu").contiguous().clone()
        # the global rank at position src along the line
        strides, s = {}, 1
        for a in reversed(self.axis_names):
            strides[a] = s
            s *= self.shape[a]
        g = self.rank - sum(self.coords[a] * strides[a] for a in live)
        rem = src
        for a in reversed(live):
            g += (rem % self.shape[a]) * strides[a]
            rem //= self.shape[a]
        tdist.broadcast(_words(buf), src=g, group=self._groups[live])
        return buf

    def local_block(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """This rank's block of a value held whole (no communication)."""
        n = self.axis_size(axes)
        if n <= 1:
            return t
        size = t.shape[dim] // n
        return t.narrow(dim, self.index(axes) * size, size)

    def gather_rows(self, block: torch.Tensor) -> torch.Tensor:
        """All-gather each data rank's row block (the same shape on every
        rank) into the global rows, in rank order, as a CPU tensor."""
        return self.all_gather(block.detach().to("cpu"), self.dp_axes,
                               kind="gather_rows")

    @contextlib.contextmanager
    def reuse_gathers(self):
        """Gather each sharded weight block at most once in the enclosed
        block (FSDP resharding after it, not after every forward)."""
        if self._gathered is not None:
            yield
            return
        self._gathered = {}
        try:
            yield
        finally:
            self._gathered = None

    def gather_weight(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """:meth:`all_gather` of a weight block along ``dim``, once per
        block inside :meth:`reuse_gathers` (a block that requires grad is
        gathered at every call: each use backs its own reduce-scatter)."""
        if self._gathered is None or _tracks(t):
            return self.all_gather(t, axes, dim=dim, kind="gather_weight")
        # the block's storage and offset (a fake tensor has no data_ptr)
        key = (t.untyped_storage()._cdata, t.storage_offset(),
               tuple(t.shape), tuple(t.stride()), t.dtype,
               entry_axes(axes), dim % t.ndim)
        hit = self._gathered.get(key)
        if hit is None:
            hit = self.all_gather(t, axes, dim=dim, kind="gather_weight")
            self._gathered[key] = hit
        return hit


def enter_tp(t: torch.Tensor, float32: bool = False) -> torch.Tensor:
    """``t`` as it is, its gradient SUMmed over the active mesh's model
    axis (:meth:`Mesh.enter`): a replicated value applied to this rank's
    heads.  The identity off a model axis.  ``float32``: where autograd
    records ``t``, enter ``t.float()``, so the partial gradients of its
    column-parallel consumers stay float32 through the SUM."""
    mesh = active_mesh()
    if not isinstance(mesh, Mesh) or tp_size(mesh) <= 1:
        return t
    if float32 and _tracks(t):
        t = t.float()
    return mesh.enter(t, mesh.tp_axes)


def _tracks(t: torch.Tensor) -> bool:
    """Whether autograd records an operation on ``t`` here."""
    return t.requires_grad and torch.is_grad_enabled()


class _Sum(torch.autograd.Function):
    """SUM over mesh axes; the gradient passes as it is."""

    @staticmethod
    def forward(ctx, t, mesh, axes, kind):
        return mesh._all_reduce(t, axes, "sum", kind=kind)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _Gather(torch.autograd.Function):
    """All-gather over mesh axes; the gradient is SUMmed over the
    gathered data axes and split to this rank's block."""

    @staticmethod
    def forward(ctx, t, mesh, axes, dim, kind):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh._all_gather(t, axes, dim, kind=kind)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        data = tuple(a for a in mesh.live_axes(ctx.axes) if a in mesh.dp_axes)
        g = mesh.sum_grad(g, data, kind="grad_rs")
        return (mesh.local_block(g, ctx.axes, ctx.dim).contiguous(), None,
                None, None, None)


class _Enter(torch.autograd.Function):
    """Identity; the gradient is SUMmed over mesh axes."""

    @staticmethod
    def forward(ctx, t, mesh, axes, kind):
        ctx.mesh, ctx.axes, ctx.kind = mesh, axes, kind
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.sum_grad(g, ctx.axes, kind=ctx.kind), None, None,
                None)


class RecordingMesh(Mesh):
    """A :class:`Mesh` with no process group: one rank's view of a mesh
    of any size, whose collectives run nothing and are recorded.

    Built from a shape, axis names (the :class:`Mesh` default by the
    number of axes) and a rank, it sets ``coords``, ``shape`` and the
    rest as :class:`Mesh` does, so every layout rule and every local
    block is the one that rank would hold.  Each method of :class:`Mesh`
    that calls ``torch.distributed`` (construction, ``_all_reduce``,
    ``_all_gather``, ``gather_whole``, ``broadcast``; ``sum_grad``,
    ``gather_rows``, ``gather_weight`` and the autograd forms reach the
    group only through these) is overridden: it counts the call in
    ``counts`` exactly as the mesh would, records it in ``records`` by
    collective and axis combination with the bytes of its result, and
    returns an uninitialised tensor of the result's shape on the input's
    device.  So it serves to count a program on fake tensors (the
    lowering report, ``repro_torch.launch.dryrun``); its values are not
    the collectives'.

    ``records`` maps ``(collective, axes)`` to ``[calls, result bytes]``,
    ``collective`` one of ``all-reduce`` (SUM or MAX), ``all-gather``,
    ``gather`` (to one rank, the whole value) and ``broadcast``."""

    def __init__(self, shape: Sequence[int],
                 axis_names: Optional[Sequence[str]] = None, *,
                 rank: int = 0) -> None:
        self._place(shape, axis_names, rank)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is not in a mesh of {self.size}")
        self.records: Dict[Tuple[str, Tuple[str, ...]], list] = {}
        self._groups = {}

    def _record(self, collective: str, live, nbytes: int) -> None:
        r = self.records.setdefault((collective, tuple(live)), [0, 0])
        r[0] += 1
        r[1] += int(nbytes)

    def reset_counts(self) -> None:
        self.counts = {}
        self.records = {}

    def _all_reduce(self, t: torch.Tensor, axes, op: str = "sum", *,
                    kind: Optional[str] = None) -> torch.Tensor:
        live = self.live_axes(axes)
        if not live:
            return t
        self._count(kind or f"all_reduce_{op}", t)
        self._record("all-reduce", live, t.numel() * t.element_size())
        return torch.empty_like(t, memory_format=torch.contiguous_format)

    def _all_gather(self, t: torch.Tensor, axes, dim: int = 0, *,
                    kind: str = "all_gather") -> torch.Tensor:
        live = self.live_axes(axes)
        if not live:
            return t
        self._count(kind, t)
        n = self.axis_size(live)
        shape = list(t.shape) if t.ndim else [1]
        shape[dim % max(t.ndim, 1)] *= n
        self._record("all-gather", live, math.prod(shape) * t.element_size())
        return t.new_empty(shape)

    def gather_whole(self, t: torch.Tensor, spec, *,
                     kind: str = "gather_whole") -> Optional[torch.Tensor]:
        live = self.live_axes(tuple(a for e in spec for a in entry_axes(e)))
        t = t.detach().to("cpu").contiguous()
        if not live:
            return t
        self._count(kind, t)
        whole = tuple(d * self.axis_size(e) for d, e in zip(t.shape, spec))
        self._record("gather", live, math.prod(whole) * t.element_size())
        line = next(ln for ln in self._lines(live) if self.rank in ln)
        return t.new_empty(whole) if line[0] == self.rank else None

    def broadcast(self, t: torch.Tensor, src: int, axes=None, *,
                  kind: str = "broadcast") -> torch.Tensor:
        live = self.live_axes(self.dp_axes if axes is None else axes)
        if not live:
            return t.detach().to("cpu").clone()
        self._count(kind, t)
        self._record("broadcast", live, t.numel() * t.element_size())
        return torch.empty(t.shape, dtype=t.dtype, device="cpu")


class DataMesh(Mesh):
    """A 1-D ``("data",)`` mesh over the whole group: ``shape ==
    {"data": world_size}`` and ``rank`` is this process's position on the
    axis."""

    def __init__(self) -> None:
        super().__init__((tdist.get_world_size()
                          if tdist.is_initialized() else 0,), ("data",))
        self.group = tdist.group.WORLD

"""Mesh context and logical-axis sizes: the part of ``repro.dist.api``
that placement and row scale-out need.

Models and engines speak LOGICAL axes ("dp" data-parallel, "tp"
tensor-parallel); this module maps them onto the axes of whatever mesh is
active:

  1-axis mesh ("data",)                 dp -> "data"
  2-axis mesh ("data", "model")         dp -> "data",           tp -> "model"
  3-axis mesh ("pod", "data", "model")  dp -> ("pod", "data"),  tp -> "model"

A mesh is duck-typed as in the reference: ``.shape`` maps each axis name
to its size and ``.axis_names`` is a tuple.  The active mesh is the
innermost :func:`use_mesh` block's (thread-local, nestable); there is no
framework-level mesh context to fall back to.

:class:`DataMesh` is the one concrete mesh: a 1-D data axis over an
initialised ``torch.distributed`` process group, one rank per mesh
position.  The serving engines split request rows over it (each rank
computes its block of rows with every weight resident) and all-gather
the results; :meth:`DataMesh.gather_rows` and :meth:`DataMesh.broadcast`
are the only collectives they need.  Both stage through CPU tensors (the
operands are host-sized: tokens, logits), so the group runs on gloo,
which also lets several ranks share one GPU.

Not ported yet: ``constrain``, ``logical_to_mesh``, ``shard_map_compat``
and ``manual_mode`` (sharded weights, the reference's GSPMD path).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Tuple

import torch
import torch.distributed as tdist

# Logical -> candidate mesh axes, in the order they combine.
_LOGICAL_AXES = {
    "dp": ("pod", "data"),
    "tp": ("model",),
}

_local = threading.local()


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


class DataMesh:
    """A 1-D ``("data",)`` mesh over the initialised default gloo process
    group (``group``).

    ``shape == {"data": world_size}``; ``rank`` is this process's
    position on the axis.  The caller initialises the group
    (``torch.distributed.init_process_group("gloo", ...)``) and runs the
    same program on every rank (SPMD).
    """

    axis_names = ("data",)

    def __init__(self) -> None:
        if not tdist.is_initialized():
            raise RuntimeError("DataMesh needs an initialised "
                               "torch.distributed process group")
        backend = tdist.get_backend()
        if backend != "gloo":
            raise NotImplementedError(
                f"DataMesh stages its collectives through CPU tensors and "
                f"needs a gloo group, not {backend!r}")
        self.group = tdist.group.WORLD
        self.rank = tdist.get_rank()
        self.size = tdist.get_world_size()
        self.shape = {"data": self.size}

    def gather_rows(self, block: torch.Tensor) -> torch.Tensor:
        """All-gather each rank's row block (the same shape on every rank)
        into the global rows, in rank order, as a CPU tensor."""
        blk = block.detach().to("cpu").contiguous()
        parts = [torch.empty_like(blk) for _ in range(self.size)]
        tdist.all_gather(parts, blk, group=self.group)
        return torch.cat(parts)

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank (each passes a tensor of the
        same shape and dtype), as a CPU tensor."""
        buf = t.detach().to("cpu").clone().contiguous()
        tdist.broadcast(buf, src=src, group=self.group)
        return buf

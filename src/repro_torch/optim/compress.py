"""int8 gradient compression with error feedback for the data-parallel
all-reduce.

The counterpart of ``repro.optim.compress``.  ``compress_psum``
quantizes each gradient leaf to int8 on one scale shared by every rank
(the global absmax, one ``all_reduce(MAX)``), sums the int8 values as
int32 (``all_reduce(SUM)``), and keeps each rank's quantization residual
in an error-feedback buffer that the next step adds back.  The reference
runs it inside ``shard_map`` over a named axis; here the ranks are the
processes of a ``torch.distributed`` group (gloo), or of a
``repro_torch.dist.DataMesh``.  Collectives run on CPU copies of the
tensors (gloo's ground), and every result lands back on the leaf's
device.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as tdist

from repro_torch.optim.adamw import tree_leaves, tree_unflatten


def _group(group):
    """A process group from a group, a DataMesh or None (the default
    group)."""
    if group is None:
        return tdist.group.WORLD
    return getattr(group, "group", group)


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    buf = t.detach().to("cpu").contiguous()
    tdist.all_reduce(buf, op=op, group=group)
    return buf.to(t.device)


def compress_psum(grads, err, group=None) -> Tuple[dict, dict]:
    """Returns (averaged_grads, new_err), both nested as ``grads``.

    The scale is the GLOBAL absmax (one scalar MAX across ranks), so the
    int32 sum dequantizes exactly; ``n`` is the group's size."""
    group = _group(group)
    n = tdist.get_world_size(group)
    avg, new_err = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(err)):
        g32 = g.float() + e
        s = _all_reduce(g32.abs().amax(), tdist.ReduceOp.MAX, group) \
            / 127.0 + 1e-12
        q = torch.clamp(torch.round(g32 / s), -127, 127).to(torch.int8)
        new_err.append(g32 - q.float() * s)              # error feedback
        q_sum = _all_reduce(q.to(torch.int32), tdist.ReduceOp.SUM, group)
        avg.append((q_sum.float() * s / n).to(g.dtype))
    return tree_unflatten(grads, avg), tree_unflatten(grads, new_err)

"""Per-device cost of one rank's program, counted op by op on fake
tensors: the counterpart of ``repro.launch.hloparse``.

The reference compiles each cell and walks the scheduled HLO, multiplying
loop bodies by their trip counts.  The port has no compiled artifact:
its programs are eager Python, so :func:`count` runs one rank's program
(on fake tensors, ``launch/specs.py``, so nothing is allocated or
computed) under a ``TorchDispatchMode`` that sees every aten op it
dispatches.  Python loops over layers, microbatches and decode steps run
for real, so every count is exact per trip by construction.  There is
nothing like ``compiled.cost_analysis()`` to normalise, so
``hloparse.cost_analysis_dict`` has no counterpart.

What :class:`Cost` counts:

* **FLOPs** of every product op (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
  ``_int_mm``, ``mv``, ``dot``, ``convolution``; ``matmul``, ``linear``
  and ``einsum`` reach the mode as these): 2 x |result| x |contracted|,
  bucketed by the operands' type (``bf16``, ``f32``, ``int8``, others by
  their torch name).  Elementwise arithmetic is not counted: the decode
  attention of the port runs as elementwise products and row sums
  (``common.row_sum``, rows numerically independent), so its FLOPs do not
  appear here; its bytes do.
* **bytes**: the operands plus the results of every op that moves data
  (views, metadata ops and ``empty`` count nothing): the reference's
  CPU-fused upper bound (``hloparse``'s ``bytes``).
* **bytes_floor**: the operands and results of the products and of the
  kernel launches (``hloparse``'s ``bytes_opt`` without its collective
  term, which the report adds from the mesh's records).
* **kernel launches**: the kernels are ctypes calls no dispatch mode
  sees, so each wrapper's fake branch (``repro_torch.kernels``) tells
  :class:`Cost` through ``kernels.observe`` the launch's
  ``launch_keys()`` key and what its ``work`` function prices:
  operations in the kernel's bucket, and its bytes in both byte counts.
  None of a plain version's ops runs for a launch.
* **memory**: the high-water mark of the storages the program allocates
  (each op's results whose storage no operand shares; a storage is freed
  when its last tensor dies), scratch, collective outputs and autograd's
  saved tensors included.  Add the arguments' bytes
  (:func:`tree_bytes`) for the peak.
"""
from __future__ import annotations

import weakref
from typing import Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import kernels
from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_BF16,
                                     PEAK_FLOPS_F32, PEAK_OPS_INT8)

aten = torch.ops.aten
_PEAKS = {"int8": PEAK_OPS_INT8, "bf16": PEAK_FLOPS_BF16,
          "f32": PEAK_FLOPS_F32}

# product ops -> (lhs, rhs) argument positions
_PRODUCTS = {
    aten.mm.default: (0, 1), aten._int_mm.default: (0, 1),
    aten.bmm.default: (0, 1), aten.addmm.default: (1, 2),
    aten.baddbmm.default: (1, 2), aten.mv.default: (0, 1),
    aten.dot.default: (0, 1),
}
# ops that move no data: metadata, allocation without a fill (and every
# op of the ``prim`` namespace, which a fake tensor's metadata queries
# dispatch)
_NO_BYTES = {
    aten.empty.memory_format, aten.empty_strided.default,
    aten.empty_like.default, aten.new_empty.default,
    aten.new_empty_strided.default, aten.detach.default,
    aten.lift_fresh.default, aten._local_scalar_dense.default,
    aten.alias.default, aten._unsafe_view.default, aten.set_.source_Storage,
    aten.set_.source_Storage_storage_offset, aten.resize_.default,
}
_BUCKETS = {torch.bfloat16: "bf16", torch.float32: "f32", torch.int8: "int8"}


def bucket(dtype: torch.dtype) -> str:
    """The FLOP bucket of an operand type."""
    return _BUCKETS.get(dtype, str(dtype).replace("torch.", ""))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def tree_bytes(*trees) -> int:
    """Bytes of the distinct storages the tensors of ``trees`` (dicts,
    lists, tuples) hold: a program's argument bytes."""
    seen: Dict[int, int] = {}

    def rec(x):
        if isinstance(x, dict):
            for v in x.values():
                rec(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                rec(v)
        elif isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            seen[st._cdata] = st.nbytes()
    for t in trees:
        rec(t)
    return sum(seen.values())


def product_flops(func, args) -> float:
    """2 x |result| x |contracted| of one product op (0 for others)."""
    if func is aten.convolution.default:
        x, w = args[0], args[1]            # w: (C_out, C_in / groups, ...)
        out_n = x.shape[0] * w.shape[0]
        spatial = [(s + 2 * p - d * (k - 1) - 1) // st + 1 for s, k, st, p, d
                   in zip(x.shape[2:], w.shape[2:], args[3], args[4],
                          args[5])]
        for s in spatial:
            out_n *= s
        k = w.shape[1]
        for s in w.shape[2:]:
            k *= s
        return 2.0 * out_n * k
    lhs, rhs = (args[i] for i in _PRODUCTS[func])
    out_n = lhs.numel() // lhs.shape[-1] * (rhs.shape[-1]
                                            if rhs.ndim > 1 else 1)
    return 2.0 * out_n * lhs.shape[-1]


class Cost(TorchDispatchMode):
    """Counts the aten ops and kernel launches of the enclosed block
    (module docstring).  ``flops`` maps a bucket to FLOPs (operations
    for the int8 kernels); ``kernels`` a ``launch_keys()`` key to its
    launches; ``kernel_work`` a kernel name to its ``[ops, bytes,
    bound seconds]`` (the bound of each launch, the larger of its
    operations over the card's peak for their type and its bytes over
    the card's memory rate, summed);
    ``ops`` counts the aten ops dispatched, ``by_op`` each overload's;
    ``live_bytes`` and ``peak_bytes`` follow the storages allocated
    inside."""

    def __init__(self) -> None:
        super().__init__()
        self.flops: Dict[str, float] = {}
        self.bytes = 0.0
        self.bytes_floor = 0.0
        self.ops = 0
        self.by_op: Dict[str, int] = {}
        self.kernels: Dict[Tuple, int] = {}
        self.kernel_work: Dict[str, list] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}
        self._observing = None

    def __enter__(self):
        self._observing = kernels.observe(self._launch)
        self._observing.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._observing.__exit__(*exc)
        return out

    def _launch(self, kernel, key, ops, nbytes, dtype) -> None:
        k = (kernel,) + tuple(key)
        self.kernels[k] = self.kernels.get(k, 0) + 1
        w = self.kernel_work.setdefault(kernel, [0.0, 0.0, 0.0])
        w[0] += ops
        w[1] += nbytes
        w[2] += max(ops / _PEAKS[dtype], nbytes / HBM_BW)
        self.flops[dtype] = self.flops.get(dtype, 0.0) + ops
        self.bytes += nbytes
        self.bytes_floor += nbytes

    def _freed(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "prim":    # metadata a fake tensor queries
            return out
        self.ops += 1
        name = func.__name__
        self.by_op[name] = self.by_op.get(name, 0) + 1
        ins = list(_tensors(args)) + list(_tensors(list((kwargs or {})
                                                        .values())))
        outs = list(_tensors(out))
        if func in _PRODUCTS or func is aten.convolution.default:
            b = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
            k = bucket(ins[0].dtype)
            self.flops[k] = self.flops.get(k, 0.0) + product_flops(func,
                                                                  args)
            self.bytes += b
            self.bytes_floor += b
        elif not (func.is_view or func in _NO_BYTES):
            self.bytes += (sum(_nbytes(t) for t in ins)
                           + sum(_nbytes(t) for t in outs))
        if outs:
            have = {t.untyped_storage()._cdata for t in ins}
            for t in outs:
                st = t.untyped_storage()
                key = st._cdata
                if key in have or key in self._live:
                    continue
                n = st.nbytes()
                self._live[key] = n
                self.live_bytes += n
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
                weakref.finalize(st, self._freed, key)
        return out


def count(fn: Callable, *args, **kwargs):
    """``(fn(*args, **kwargs), Cost)``: one call, counted."""
    with Cost() as c:
        out = fn(*args, **kwargs)
    return out, c

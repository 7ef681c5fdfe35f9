"""Packed-int4 GEMM: the hand-written Hopper kernel and its plain version.

``int4_matmul(x_q, w_packed, scale)`` computes int8 ``(M, K)`` times int4
weights packed two to a byte in the halves layout, uint8 ``(K, N/2)``
(logical columns ``[0, N/2)`` in the low nibbles, ``[N/2, N)`` in the high
ones; ``core.bitfluid.pack_int4_halves``), accumulated exactly in int32,
then ``f32(acc) * scale[n]`` in ``out_dtype`` -> ``(M, N)``.  It is the
port of the Pallas TPU kernel ``repro.kernels.int4_matmul.int4_matmul``,
the fixed-INT4 path's GEMM: the weights cross device memory at half the
bytes of an int8 container.

On a CUDA tensor the wrapper launches ``csrc/int4_matmul.cu``, or raises:
there is no fallback.  The kernel runs in the bit-plane kernel's two
regimes, and :func:`plan` (the bit-plane kernel's, shared, with N in
logical columns: a GEMV block's 128 of them are 64 packed byte columns)
picks one per call: a split-K GEMV on the packed bytes for ``M <= 16``,
else a pre-pass that unpacks the weight K-major and the ``wgmma`` tile.
On a CPU tensor it takes the plain version, :func:`int4_matmul_ref`,
which is also the oracle the kernel is held against on the card.  A fake
tensor that stands for the card's (``kernels.card_fake``) plans and
allocates without running the kernel and reports the launch, priced
by :func:`work`, to ``kernels.observe``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch import kernels
from repro_torch.core import bitfluid as bf
from repro_torch.kernels import bitplane_matmul as bpm
from repro_torch.kernels import cuda_build

# the regime's plan, shared with the bit-plane kernel (lru_cached, pure;
# N logical)
plan = bpm.plan

launches = 0          # kernel launches (the main path's proof it ran here)
# the same launches by path (bpm.PATHS)
path_launches: Dict[str, int] = {p: 0 for p in bpm.PATHS}


def reset_launches() -> None:
    global launches
    launches = 0
    for p in path_launches:
        path_launches[p] = 0


def int4_matmul_ref(x_q: torch.Tensor, w_packed: torch.Tensor,
                    scale: torch.Tensor, out_dtype=torch.float32
                    ) -> torch.Tensor:
    """Plain version: unpack the halves, one exact integer product (in
    float64, exact below 2^53, as ``bitplane_matmul_ref``), then
    ``f32(acc) * scale`` rounded once to ``out_dtype``."""
    w = bf.unpack_int4_halves(w_packed)
    acc = (x_q.to(torch.float64) @ w.to(torch.float64)).to(torch.int32)
    return (acc.float() * scale).to(out_dtype)


def work(M: int, K: int, N: int, out_bytes: int = 4
         ) -> Tuple[float, float]:
    """(operations, bytes) one launch at (M, K, N logical columns) must
    do: 2 M N K multiply-adds; x, the packed weight (K N / 2 bytes) and
    the f32 scale read once, the output (``out_bytes`` an element)
    written once."""
    return 2.0 * M * N * K, float(M * K + K * N // 2 + 4 * N
                                  + out_bytes * M * N)


def _check(x_q, w_packed, scale, out_dtype) -> None:
    if x_q.dtype != torch.int8 or w_packed.dtype != torch.uint8:
        raise TypeError(f"int4_matmul takes int8 activations and uint8 "
                        f"packed weights, got {x_q.dtype} and "
                        f"{w_packed.dtype}")
    if x_q.ndim != 2 or w_packed.ndim != 2 or \
            x_q.shape[1] != w_packed.shape[0]:
        raise ValueError(f"int4_matmul: shapes {tuple(x_q.shape)} @ "
                         f"{tuple(w_packed.shape)} are not (M, K) @ "
                         f"(K, N/2)")
    N = 2 * w_packed.shape[1]
    if scale.dtype != torch.float32 or tuple(scale.shape) != (1, N):
        raise ValueError(f"int4_matmul: scale must be f32 (1, {N}), got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int4_matmul writes float32 or bfloat16, not "
                         f"{out_dtype}")
    if not (x_q.device == w_packed.device == scale.device):
        raise ValueError(f"operands on {x_q.device}, {w_packed.device} and "
                         f"{scale.device}")


def int4_matmul(x_q: torch.Tensor, w_packed: torch.Tensor,
                scale: torch.Tensor, *, out_dtype=torch.float32
                ) -> torch.Tensor:
    """int8 (M, K) @ halves-packed uint8 (K, N/2), times f32 scale (1, N)
    -> (M, N) in ``out_dtype`` (float32 or bfloat16)."""
    _check(x_q, w_packed, scale, out_dtype)
    fake = kernels.card_fake(x_q)         # the lowering report's launch
    if x_q.device.type == "cpu" and not fake:
        return int4_matmul_ref(x_q, w_packed, scale, out_dtype)
    if x_q.device.type != "cuda" and not fake:
        raise ValueError(f"int4_matmul runs on cuda or cpu tensors, not "
                         f"{x_q.device}")
    if not (x_q.is_contiguous() and w_packed.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("int4_matmul: the kernel takes contiguous "
                         "row-major operands")
    dev = x_q.device
    M, K = x_q.shape
    N = 2 * w_packed.shape[1]
    if max(M, K, N) >= 2 ** 31 or M * N >= 2 ** 40:
        raise ValueError(f"int4_matmul: ({M}, {K}) @ ({K}, {N // 2}) "
                         f"exceeds the kernel's grid")
    if fake:
        p = plan(M, K, N, bpm.H100_SMS, kernels.fake_aligned(x_q))
    else:
        p = plan(M, K, N, bpm.sm_count(dev), x_q.data_ptr() % 16 == 0)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    scratch = bpm.alloc_scratch(p, M, N, dev, partials=True)
    if fake:                # priced, not counted: nothing was launched
        kernels.launched("int4_matmul", (p.path,),
                         *work(M, K, N, out.element_size()), "int8")
        return out
    err = _entry()(x_q.data_ptr(), w_packed.data_ptr(), scale.data_ptr(),
                   out.data_ptr(), bpm.ptr_or_none(scratch), M, N, K,
                   int(out_dtype == torch.bfloat16), p.steps, int(p.copy_x),
                   bpm.current_stream(dev))
    if err != 0:
        raise RuntimeError(f"int4_matmul kernel launch failed: CUDA error "
                           f"{err} at ({M}, {K}) @ ({K}, {N // 2}), plan {p}")
    global launches
    launches += 1
    path_launches[p.path] += 1
    return out


@functools.cache
def _entry():
    lib = cuda_build.load("int4_matmul")
    fn = lib.int4_matmul_s4
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn

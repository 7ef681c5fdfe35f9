"""Bit-plane int8 GEMM: the hand-written Hopper kernel and its plain version.

``bitplane_matmul(x_q, w_q, n_planes)`` computes int8 ``(M, K)`` times the
low ``n_planes`` two's-complement field of an int8 weight container
``(K, N)``, accumulated exactly in int32 -> ``(M, N)``.  It is the port of
the Pallas TPU kernel ``repro.kernels.bitplane_matmul.bitplane_matmul``:
there the field is walked plane by plane (plane j weighted 2^j, the sign
plane -2^(n-1)); the weighted planes reassemble the sign-extended field,
so the CUDA kernel (``csrc/bitplane_matmul.cu``) sign-extends each weight
once and runs one int8 tensor-core product.

On a CUDA tensor the wrapper launches the kernel, or raises: there is no
fallback.  On a CPU tensor it takes the plain version,
:func:`bitplane_matmul_ref`, which is also the oracle the kernel is held
against on the card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch.kernels import cuda_build

# kernel launches per n_planes (the main path's proof that it ran here)
launches: Dict[int, int] = {n: 0 for n in range(1, 9)}


def reset_launches() -> None:
    for n in launches:
        launches[n] = 0


def sign_extend_field(w_q: torch.Tensor, n_planes: int) -> torch.Tensor:
    """The low ``n_planes`` bits of each int8, read as two's complement."""
    field = w_q.to(torch.int32) & ((1 << n_planes) - 1)
    sign = (field >> (n_planes - 1)) & 1
    return (field - sign * (1 << n_planes)).to(torch.int8)


def bitplane_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor,
                        n_planes: int = 8) -> torch.Tensor:
    """Plain version: mask, sign-extend, one exact integer product.

    The product runs in float64, on any device: every int8 x int8 term and
    every partial sum is an integer below 2^53 for K < 2^38, so the result
    is exact whatever the summation order (an int8 ``torch.mm`` would wrap
    at int8, and CUDA has no integer ``torch.mm``)."""
    w = sign_extend_field(w_q, n_planes)
    return (x_q.to(torch.float64) @ w.to(torch.float64)).to(torch.int32)


def _check(x_q: torch.Tensor, w_q: torch.Tensor, n_planes: int) -> None:
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"bitplane_matmul takes int8 operands, got "
                        f"{x_q.dtype} and {w_q.dtype}")
    if x_q.ndim != 2 or w_q.ndim != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"bitplane_matmul: shapes {tuple(x_q.shape)} @ "
                         f"{tuple(w_q.shape)} are not (M, K) @ (K, N)")
    if not 1 <= n_planes <= 8:
        raise ValueError(f"n_planes must be in 1..8, got {n_planes}")
    if x_q.device != w_q.device:
        raise ValueError(f"operands on {x_q.device} and {w_q.device}")


def bitplane_matmul(x_q: torch.Tensor, w_q: torch.Tensor, *,
                    n_planes: int = 8) -> torch.Tensor:
    """int8 (M, K) @ int8-container (K, N) -> int32 (M, N) at ``n_planes``."""
    _check(x_q, w_q, n_planes)
    if x_q.device.type == "cpu":
        return bitplane_matmul_ref(x_q, w_q, n_planes)
    if x_q.device.type != "cuda":
        raise ValueError(f"bitplane_matmul runs on cuda or cpu tensors, "
                         f"not {x_q.device}")
    if not (x_q.is_contiguous() and w_q.is_contiguous()):
        raise ValueError("bitplane_matmul: the kernel takes contiguous "
                         "row-major operands")
    M, K = x_q.shape
    N = w_q.shape[1]
    if max(M, K, N) >= 2 ** 31 or -(-N // 64) > 65535:
        raise ValueError(f"bitplane_matmul: ({M}, {K}) @ ({K}, {N}) exceeds "
                         f"the kernel's grid")
    out = torch.empty((M, N), dtype=torch.int32, device=x_q.device)
    fn = _entry()
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream(x_q.device).cuda_stream
        err = fn(x_q.data_ptr(), w_q.data_ptr(), out.data_ptr(),
                 M, N, K, n_planes, stream)
    if err != 0:
        raise RuntimeError(f"bitplane_matmul kernel launch failed: CUDA "
                           f"error {err} at ({M}, {K}) @ ({K}, {N}), "
                           f"n_planes={n_planes}")
    launches[n_planes] += 1
    return out


@functools.cache
def _entry():
    lib = cuda_build.load("bitplane_matmul")
    fn = lib.bitplane_matmul_s8
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn

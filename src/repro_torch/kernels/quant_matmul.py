"""Fused int8 GEMM + dequant epilogue: the hand-written Hopper kernel and
its plain version.

``quant_matmul(x_q, w_q, scale, bias, act=...)`` computes int8 ``(M, K)``
times int8 ``(K, N)``, accumulated exactly in int32, then
``act(f32(acc) * scale[n] + bias[n])`` in ``out_dtype`` -> ``(M, N)``, with
``act`` one of none, relu, silu or gelu (the tanh form, as
``jax.nn.gelu`` computes by default).  It is the port of the Pallas TPU
kernel ``repro.kernels.quant_matmul.quant_matmul``, the fixed-precision
int8 GEMM with its epilogue fused.

On a CUDA tensor the wrapper launches ``csrc/quant_matmul.cu``, or raises:
there is no fallback.  On a CPU tensor it takes the plain version,
:func:`quant_matmul_ref`, which is also the oracle the kernel is held
against on the card.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict

import torch

from repro_torch.kernels import cuda_build

ACTS = ("none", "relu", "silu", "gelu")
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)

# kernel launches per act (the main path's proof it ran here)
launches: Dict[str, int] = {a: 0 for a in ACTS}


def reset_launches() -> None:
    for a in launches:
        launches[a] = 0


def activate(y: torch.Tensor, act: str) -> torch.Tensor:
    """The epilogue's activation, in the reference's operation order."""
    if act == "relu":
        return torch.clamp_min(y, 0.0)
    if act == "silu":
        return y * torch.sigmoid(y)
    if act == "gelu":
        cdf = 0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI
                                      * (y + 0.044715 * (y * y * y))))
        return y * cdf
    return y


def quant_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor,
                     scale: torch.Tensor, bias: torch.Tensor,
                     act: str = "none", out_dtype=torch.float32
                     ) -> torch.Tensor:
    """Plain version: one exact integer product (in float64, exact below
    2^53), then ``act(f32(acc) * scale + bias)`` with the multiply and the
    add rounded separately, rounded once to ``out_dtype``."""
    acc = (x_q.to(torch.float64) @ w_q.to(torch.float64)).to(torch.int32)
    return activate(acc.float() * scale + bias, act).to(out_dtype)


def _check(x_q, w_q, scale, bias, act, out_dtype) -> None:
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"quant_matmul takes int8 operands, got "
                        f"{x_q.dtype} and {w_q.dtype}")
    if x_q.ndim != 2 or w_q.ndim != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"quant_matmul: shapes {tuple(x_q.shape)} @ "
                         f"{tuple(w_q.shape)} are not (M, K) @ (K, N)")
    N = w_q.shape[1]
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (1, N):
            raise ValueError(f"quant_matmul: {name} must be f32 (1, {N}), "
                             f"got {t.dtype} {tuple(t.shape)}")
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"quant_matmul writes float32 or bfloat16, not "
                         f"{out_dtype}")
    if not (x_q.device == w_q.device == scale.device == bias.device):
        raise ValueError(f"operands on {x_q.device}, {w_q.device}, "
                         f"{scale.device} and {bias.device}")


def quant_matmul(x_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, *, act: str = "none",
                 out_dtype=torch.float32) -> torch.Tensor:
    """int8 (M, K) @ int8 (K, N) -> act(f32(acc) * scale + bias), with
    f32 ``scale`` and ``bias`` of shape (1, N), in ``out_dtype``."""
    _check(x_q, w_q, scale, bias, act, out_dtype)
    if x_q.device.type == "cpu":
        return quant_matmul_ref(x_q, w_q, scale, bias, act, out_dtype)
    if x_q.device.type != "cuda":
        raise ValueError(f"quant_matmul runs on cuda or cpu tensors, not "
                         f"{x_q.device}")
    if not all(t.is_contiguous() for t in (x_q, w_q, scale, bias)):
        raise ValueError("quant_matmul: the kernel takes contiguous "
                         "row-major operands")
    M, K = x_q.shape
    N = w_q.shape[1]
    if max(M, K, N) >= 2 ** 31 or -(-N // 64) > 65535:
        raise ValueError(f"quant_matmul: ({M}, {K}) @ ({K}, {N}) exceeds "
                         f"the kernel's grid")
    out = torch.empty((M, N), dtype=out_dtype, device=x_q.device)
    fn = _entry()
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream(x_q.device).cuda_stream
        err = fn(x_q.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                 bias.data_ptr(), out.data_ptr(), M, N, K, ACTS.index(act),
                 int(out_dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: CUDA error "
                           f"{err} at ({M}, {K}) @ ({K}, {N}), act={act}")
    launches[act] += 1
    return out


@functools.cache
def _entry():
    lib = cuda_build.load("quant_matmul")
    fn = lib.quant_matmul_s8
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn

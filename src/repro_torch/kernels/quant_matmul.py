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
there is no fallback.  The kernel runs in the bit-plane kernel's two
regimes, with the epilogue on the whole int32 sum; :func:`plan` (the
bit-plane kernel's, shared) picks one per call: a split-K GEMV for
``M <= 16`` (the int32 partials of a split K go through an ``(M, N)``
scratch before the epilogue), else a K-major pre-pass and the ``wgmma``
tile, with x re-pitched where its rows are not 16-byte aligned.  On a
CPU tensor it takes the plain version, :func:`quant_matmul_ref`, which
is also the oracle the kernel is held against on the card.  A fake
tensor that stands for the card's (``kernels.card_fake``) plans and
allocates without running the kernel and reports the launch, priced
by :func:`work`, to ``kernels.observe``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Tuple

import torch

from repro_torch import kernels
from repro_torch.kernels import bitplane_matmul as bpm
from repro_torch.kernels import cuda_build

# the regime's plan, shared with the bit-plane kernel (lru_cached, pure)
plan = bpm.plan

ACTS = ("none", "relu", "silu", "gelu")
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)

# kernel launches by specialisation, (act, path) -> count: the main
# path's proof it ran here (bpm.PATHS: the GEMV, or the large-M tile with
# x read in place or re-pitched).  The launches_by_* views sum over it.
spec_launches: Dict[Tuple[str, str], int] = {}


def reset_launches() -> None:
    spec_launches.clear()


def launches_by_act() -> Dict[str, int]:
    """Launches per act (every ACTS entry, zeros included)."""
    out = {a: 0 for a in ACTS}
    for (act, _), c in spec_launches.items():
        out[act] += c
    return out


def launches_by_path() -> Dict[str, int]:
    """Launches per path (every bpm.PATHS entry, zeros included)."""
    out = {p: 0 for p in bpm.PATHS}
    for (_, path), c in spec_launches.items():
        out[path] += c
    return out


def gate(y: torch.Tensor, act: str) -> torch.Tensor:
    """The gate c of silu and gelu, ``act(y) = y * c(y)``: the sigmoid, or
    the tanh form's ``0.5 * (1 + tanh(...))``, in the reference's
    operation order."""
    if act == "silu":
        return torch.sigmoid(y)
    return 0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI
                                   * (y + 0.044715 * (y * y * y))))


def activate(y: torch.Tensor, act: str) -> torch.Tensor:
    """The epilogue's activation, in the reference's operation order."""
    if act == "relu":
        return torch.clamp_min(y, 0.0)
    if act in ("silu", "gelu"):
        return y * gate(y, act)
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


def work(M: int, K: int, N: int, out_bytes: int = 4
         ) -> Tuple[float, float]:
    """(operations, bytes) one launch at (M, K, N) must do: 2 M N K
    multiply-adds; x, w and the f32 scale and bias read once, the output
    (``out_bytes`` an element) written once."""
    return 2.0 * M * N * K, float(M * K + K * N + 8 * N + out_bytes * M * N)


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
    fake = kernels.card_fake(x_q)         # the lowering report's launch
    if x_q.device.type == "cpu" and not fake:
        return quant_matmul_ref(x_q, w_q, scale, bias, act, out_dtype)
    if x_q.device.type != "cuda" and not fake:
        raise ValueError(f"quant_matmul runs on cuda or cpu tensors, not "
                         f"{x_q.device}")
    if not all(t.is_contiguous() for t in (x_q, w_q, scale, bias)):
        raise ValueError("quant_matmul: the kernel takes contiguous "
                         "row-major operands")
    dev = x_q.device
    M, K = x_q.shape
    N = w_q.shape[1]
    if max(M, K, N) >= 2 ** 31 or M * N >= 2 ** 40:
        raise ValueError(f"quant_matmul: ({M}, {K}) @ ({K}, {N}) exceeds "
                         f"the kernel's grid")
    if fake:
        p = plan(M, K, N, bpm.H100_SMS, kernels.fake_aligned(x_q))
    else:
        p = plan(M, K, N, bpm.sm_count(dev), x_q.data_ptr() % 16 == 0)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    scratch = bpm.alloc_scratch(p, M, N, dev, partials=True)
    spec = (act, p.path)
    if fake:                # priced, not counted: nothing was launched
        kernels.launched("quant_matmul", spec,
                         *work(M, K, N, out.element_size()), "int8")
        return out
    err = _entry()(x_q.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                   bias.data_ptr(), out.data_ptr(),
                   bpm.ptr_or_none(scratch), M, N, K, ACTS.index(act),
                   int(out_dtype == torch.bfloat16), p.steps, int(p.copy_x),
                   bpm.current_stream(dev))
    if err != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: CUDA error "
                           f"{err} at ({M}, {K}) @ ({K}, {N}), act={act}, "
                           f"plan {p}")
    spec_launches[spec] = spec_launches.get(spec, 0) + 1
    return out


@functools.cache
def _entry():
    lib = cuda_build.load("quant_matmul")
    fn = lib.quant_matmul_s8
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn

"""Bit-fluid quantization — the paper's contribution as PyTorch tensor ops.

The counterpart of ``repro.core.bitfluid`` (DESIGN.md §2): weights live
once at the **container precision** (int8, or packed int4 nibbles), and a
layer's runtime precision is a dyadic re-expression of the stored value
(``requant_shift``), so any per-layer bit vector is ordinary tensor data.

Every function is bit-exact against the reference for bits 1..8, whether
``bits`` arrives as a Python int or as a tensor (bit fluidity as data).
The AP's native layout is here too: two's-complement bit planes
(:func:`bitplanes`, :func:`from_bitplanes`), the interleaved int4 nibble
packing, and the plane-walk oracle :func:`bitplane_matmul_ref`.
Rounding follows the reference: ``torch.round`` rounds half to even, as
``jnp.round`` does, and ``requant_shift`` rounds half away from zero with
integer shifts only.
"""
from __future__ import annotations

import torch

INT_DTYPE = torch.int8
ACC_DTYPE = torch.int32


def _bits_tensor(bits, dtype, device) -> torch.Tensor:
    """``bits`` as a tensor on ``device``.  A Python number is filled on
    the device: ``torch.as_tensor`` would copy it from the host, a sync
    per call on the card."""
    if isinstance(bits, (int, float)):
        return torch.full((), bits, dtype=dtype, device=device)
    return torch.as_tensor(bits, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Scales / quantize (symmetric, mid-rise, power-of-two friendly)
# ---------------------------------------------------------------------------

def qmax(bits, device=None) -> torch.Tensor:
    """Largest magnitude representable at ``bits``: 2^(b-1) - 1 (float32)."""
    if device is None and isinstance(bits, torch.Tensor):
        device = bits.device
    b = _bits_tensor(bits, torch.float32, device)
    return torch.pow(2.0, b - 1.0) - 1.0


def symmetric_scale(x: torch.Tensor, bits, axis=None,
                    eps: float = 1e-8) -> torch.Tensor:
    """Per-tensor (axis=None) or per-channel symmetric scale (float32)."""
    ax = x.abs()
    amax = ax.amax() if axis is None else ax.amax(dim=axis, keepdim=True)
    return amax.clamp_min(eps).float() / qmax(bits, x.device)


def quantize(x: torch.Tensor, scale: torch.Tensor, bits) -> torch.Tensor:
    """Symmetric quantization to a signed ``bits``-bit grid, stored as int8
    (the upper planes of the container are sign extension)."""
    q = torch.round(x / scale)
    lim = qmax(bits, x.device)
    return torch.maximum(torch.minimum(q, lim), -lim).to(INT_DTYPE)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


# ---------------------------------------------------------------------------
# Runtime-fluid dyadic requantization (the bit-fluid switch)
# ---------------------------------------------------------------------------

def requant_shift(q: torch.Tensor, to_bits, from_bits: int = 8
                  ) -> torch.Tensor:
    """Re-express an int ``from_bits`` value on a ``to_bits`` grid.

    q_b = round(q / 2^(from-to)), rounding half away from zero with integer
    shifts and adds; the caller's effective scale becomes
    ``scale * 2^(from-to)`` (:func:`effective_scale`)."""
    to_bits = _bits_tensor(to_bits, ACC_DTYPE, q.device)
    shift = (from_bits - to_bits).clamp_min(0)
    qi = q.to(ACC_DTYPE)
    one = torch.ones_like(shift)
    half = torch.where(shift > 0, one << (shift - 1).clamp_min(0),
                       torch.zeros_like(shift))
    rounded = torch.where(qi >= 0, (qi + half) >> shift,
                          -((-qi + half) >> shift))
    lim = (one << (to_bits - 1)) - 1
    return torch.maximum(torch.minimum(rounded, lim), -lim).to(INT_DTYPE)


def effective_scale(scale: torch.Tensor, to_bits, from_bits: int = 8
                    ) -> torch.Tensor:
    b = _bits_tensor(to_bits, torch.float32, scale.device)
    shift = (from_bits - b).clamp_min(0.0)
    return scale * torch.pow(2.0, shift)


# ---------------------------------------------------------------------------
# Bit planes (two's complement) — the AP's native data layout
# ---------------------------------------------------------------------------

def bitplanes(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Decompose int8 ``q`` into ``bits`` {0,1} int8 planes, LSB first.

    Plane weights are 2^j for j < bits-1 and -2^(bits-1) for the sign
    plane, so the low ``bits`` field of ``q`` is sum_j w_j * plane_j."""
    js = torch.arange(bits, dtype=torch.int32, device=q.device)
    u = q.to(torch.int32) & ((1 << bits) - 1)           # low `bits` field
    return ((u[None] >> js.reshape((bits,) + (1,) * q.ndim)) & 1).to(
        INT_DTYPE)


def plane_weights(bits: int, device=None) -> torch.Tensor:
    w = torch.pow(2.0, torch.arange(bits, dtype=torch.float32,
                                    device=device))
    w[bits - 1] = -(2.0 ** (bits - 1))
    return w


def from_bitplanes(planes: torch.Tensor, bits: int) -> torch.Tensor:
    w = plane_weights(bits, planes.device).reshape(
        (bits,) + (1,) * (planes.ndim - 1))
    return (planes.float() * w).sum(dim=0).to(INT_DTYPE)


# ---------------------------------------------------------------------------
# int4 packing: interleaved (low nibble first) and half-split layouts
# ---------------------------------------------------------------------------

def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 values (last axis even) into uint8 nibbles: column 2i in
    the low nibble, column 2i+1 in the high nibble."""
    if q.shape[-1] % 2:
        raise ValueError("last axis must be even to pack nibbles")
    u = q.to(torch.int32) & 0xF
    return (u[..., 0::2] | (u[..., 1::2] << 4)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Unpack interleaved uint8 nibbles back to signed int8 in [-8, 7]."""
    p = packed.to(torch.int32)
    both = torch.stack([p & 0xF, (p >> 4) & 0xF], dim=-1).reshape(
        packed.shape[:-1] + (-1,))
    return torch.where(both >= 8, both - 16, both).to(INT_DTYPE)


def pack_int4_halves(q: torch.Tensor) -> torch.Tensor:
    """Columns [0, N/2) in the low nibble, columns [N/2, N) in the high
    nibble of each uint8 (the reference's ``pack_int4_halves`` layout)."""
    if q.shape[-1] % 2:
        raise ValueError("last axis must be even to pack nibbles")
    half = q.shape[-1] // 2
    lo = q[..., :half].to(torch.int32) & 0xF
    hi = q[..., half:].to(torch.int32) & 0xF
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_int4_halves(packed: torch.Tensor) -> torch.Tensor:
    p = packed.to(torch.int32)
    both = torch.cat([p & 0xF, (p >> 4) & 0xF], dim=-1)
    return torch.where(both >= 8, both - 16, both).to(INT_DTYPE)


# ---------------------------------------------------------------------------
# Fake quantization with straight-through estimator (the train form)
# ---------------------------------------------------------------------------

def fake_quant(x: torch.Tensor, bits, axis=None,
               reduce=None) -> torch.Tensor:
    """Differentiable b-bit quantization: forward quantizes, the gradient
    passes straight through.  bits >= 16 is the identity (fp sentinel).

    The straight-through sum is taken in float32 and rounded once to
    ``x``'s dtype, so the forward value is exactly the quantized ``q``.
    ``reduce`` maps the local amax (per tensor, or per channel along
    ``axis``) to the whole tensor's, for a tensor split over ranks."""
    if reduce is not None:
        ax = x.detach().abs()
        amax = ax.amax() if axis is None else ax.amax(dim=axis, keepdim=True)
        scale = (reduce(amax).clamp_min(1e-8).float()
                 / qmax(bits, x.device))
    else:
        scale = symmetric_scale(x.detach(), bits, axis=axis)
    lim = qmax(bits, x.device)
    x32 = x.float()     # a 0-d float32 scale would not promote a bf16 x
    q = torch.maximum(torch.minimum(torch.round(x32 / scale), lim), -lim)
    q = torch.where(_bits_tensor(bits, torch.int32, x.device) >= 16, x,
                    (q * scale).to(x.dtype))
    return (x32 + (q.float() - x32).detach()).to(x.dtype)


# ---------------------------------------------------------------------------
# Fluid integer matmul and the plane-walk oracle
# ---------------------------------------------------------------------------

def fluid_int8_matmul(x: torch.Tensor, qw: torch.Tensor,
                      w_scale: torch.Tensor, wbits=8, abits=8
                      ) -> torch.Tensor:
    """y = x @ dequant(qw) at runtime precisions (wbits, abits).

    x        (..., K) float; quantized per tensor to ``abits``.
    qw       (K, N) int8 container (8-bit grid), per-channel ``w_scale``.
    wbits    Python int or tensor: the dyadic shift to the b-bit grid.

    The int8 dot goes through ``ops.int8_accum`` at the container width
    (8 planes): the bit-plane kernel for a CUDA tensor, its exact plain
    product for a CPU one.  The epilogue is the reference's
    ``f32(acc) * x_scale * w_s``."""
    from repro_torch.kernels import ops     # ops imports this module

    w_q = requant_shift(qw, wbits)
    w_s = effective_scale(w_scale, wbits)
    x32 = x.float()
    x_scale = symmetric_scale(x32, abits)
    x_q = quantize(x32, x_scale, abits)
    acc = ops.int8_accum(x_q.reshape(-1, x.shape[-1]), w_q)
    y = acc.float() * x_scale * w_s
    return y.reshape(x.shape[:-1] + (y.shape[-1],))


def bitplane_matmul_ref(x_q: torch.Tensor, qw: torch.Tensor,
                        wbits: int) -> torch.Tensor:
    """Plane-walk oracle: sum_j w_j * (x_q @ plane_j) over the low
    ``wbits`` field of ``qw``, accumulated in float32 as the reference
    does (each plane's product is exact: float64 holds it)."""
    planes = bitplanes(qw, wbits)                       # (wbits, K, N)
    w = plane_weights(wbits, qw.device)
    acc = torch.zeros(x_q.shape[:-1] + (qw.shape[-1],), dtype=torch.float32,
                      device=x_q.device)
    x64 = x_q.to(torch.float64)
    for j in range(wbits):
        d = (x64 @ planes[j].to(torch.float64)).to(torch.int32)
        acc = acc + w[j] * d.float()
    return acc

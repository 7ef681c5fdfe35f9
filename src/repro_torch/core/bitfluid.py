"""Bit-fluid quantization — the paper's contribution as PyTorch tensor ops.

The counterpart of ``repro.core.bitfluid`` (DESIGN.md §2): weights live
once at the **container precision** (int8, or packed int4 nibbles), and a
layer's runtime precision is a dyadic re-expression of the stored value
(``requant_shift``), so any per-layer bit vector is ordinary tensor data.

Every function is bit-exact against the reference for bits 1..8, whether
``bits`` arrives as a Python int or as a tensor (bit fluidity as data).
Rounding follows the reference: ``torch.round`` rounds half to even, as
``jnp.round`` does, and ``requant_shift`` rounds half away from zero with
integer shifts only.
"""
from __future__ import annotations

import torch

INT_DTYPE = torch.int8
ACC_DTYPE = torch.int32


def _bits_tensor(bits, dtype, device) -> torch.Tensor:
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
# int4 packing (half-split nibble layout, the packed-int4 container)
# ---------------------------------------------------------------------------

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

def fake_quant(x: torch.Tensor, bits, axis=None) -> torch.Tensor:
    """Differentiable b-bit quantization: forward quantizes, the gradient
    passes straight through.  bits >= 16 is the identity (fp sentinel).

    The straight-through sum is taken in float32 and rounded once to
    ``x``'s dtype, so the forward value is exactly the quantized ``q``."""
    scale = symmetric_scale(x.detach(), bits, axis=axis)
    lim = qmax(bits, x.device)
    x32 = x.float()     # a 0-d float32 scale would not promote a bf16 x
    q = torch.maximum(torch.minimum(torch.round(x32 / scale), lim), -lim)
    q = torch.where(_bits_tensor(bits, torch.int32, x.device) >= 16, x,
                    (q * scale).to(x.dtype))
    return (x32 + (q.float() - x32).detach()).to(x.dtype)

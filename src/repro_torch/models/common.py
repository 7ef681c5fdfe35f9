"""Shared building blocks: the bit-fluid linear, init helpers, devices.

The counterpart of ``repro.models.common`` for the CNN serve path.  Every
linear is a dict ``{"w": (K, N) [, "b": (N,)]}`` in training form, or
``{"q": int8 (K, N), "s": f32 (1, N) [, "b"]}`` (int8 container) /
``{"q4": uint8 (K, N/2), "s": ...}`` (packed int4 container) in serving
form; :func:`apply_linear` dispatches on the keys.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitfluid as bf
from repro_torch.kernels import ops as kops

DTYPE = torch.bfloat16


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asked for
    another.  A CUDA device with no GPU present raises — entry points never
    carry on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device "
                           f"is available (pass device='cpu' to run on the "
                           f"CPU)")
    return dev


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, device="cpu") -> dict:
    """bf16 Normal(0, d_in^-1/2) weights drawn from ``gen`` (a CPU
    generator, so a seed gives the same weights on every device), zero
    bias."""
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32)
    p = {"w": (w * d_in ** -0.5).to(DTYPE).to(device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=DTYPE, device=device)
    return p


def quantize_linear(p: dict, container: str = "int8") -> dict:
    """Training-form linear -> serving-form (int8 or packed-int4 container).

    Scales are per-out-channel along the reduction axis (``axis=-2``), so a
    stacked ``(G, K, N)`` weight quantizes each slice independently."""
    w = p["w"].float()
    out = {}
    if container == "int4":
        s = bf.symmetric_scale(w, 4, axis=-2)
        out["q4"] = bf.pack_int4_halves(bf.quantize(w, s, 4))
        out["s"] = s
    else:
        s = bf.symmetric_scale(w, 8, axis=-2)
        out["q"] = bf.quantize(w, s, 8)
        out["s"] = s
    if "b" in p:
        out["b"] = p["b"]
    return out


# ---------------------------------------------------------------------------
# The bit-fluid linear
# ---------------------------------------------------------------------------

def apply_linear(p: dict, x: torch.Tensor, wbits=8, abits=8) -> torch.Tensor:
    """y = x @ W (+b) at runtime precisions; dispatches train/serve forms.

    ``wbits``/``abits`` are scalars (shared precision) or ``(B,)`` vectors
    matching ``x``'s leading axis (per-request precision).  Serve-form
    containers go wholesale through :func:`repro_torch.kernels.ops.
    serve_linear`; the train form is the bf16 fake-quant STE below."""
    per_row = (getattr(wbits, "ndim", 0) >= 1
               or getattr(abits, "ndim", 0) >= 1)
    if "w" in p:                                     # train: fake-quant STE
        if per_row:
            B = x.shape[0]
            wb = torch.as_tensor(wbits, dtype=torch.int32).expand(B)
            ab = torch.as_tensor(abits, dtype=torch.int32).expand(B)
            return torch.cat([_train_linear(p, x[i:i + 1], wb[i], ab[i])
                              for i in range(B)])
        return _train_linear(p, x, wbits, abits)
    return kops.serve_linear(p, x, wbits, abits).to(DTYPE)


def _train_linear(p: dict, x: torch.Tensor, wbits, abits) -> torch.Tensor:
    """Scalar-bits fake-quant (STE) linear, bf16 around the product."""
    w = bf.fake_quant(p["w"], wbits, axis=0)
    xq = bf.fake_quant(x.to(DTYPE), abits)
    y = torch.matmul(xq, w).float()
    if "b" in p:
        y = y + p["b"].float()
    return y.to(DTYPE)

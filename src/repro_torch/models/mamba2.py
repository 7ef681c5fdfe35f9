"""Mamba2: SSD (state-space duality) blocks, chunked scan and O(1) decode.

The counterpart of ``repro.models.mamba2`` (arXiv:2405.21060):

  in_proj -> (z, x, B, C, dt);  depthwise causal conv(4) over (x, B, C);
  SSD core: chunked dual form (an intra-chunk "attention-like" quadratic
  term plus an inter-chunk recurrence on the (H, P, N) state); gated
  RMSNorm; out_proj.

Bit fluidity applies to the in and out projections (``common.apply_linear``,
so the serve form reaches the bit-plane kernel, at scalar or per-row
``(B,)`` bits); the scan itself stays in f32 plain PyTorch, as in the
reference, which has no Pallas kernel for it.

The reference runs ``lax.scan`` over the chunks.  Here the intra-chunk
term, the chunks' state contributions and the carried state's read-out
are batched over all chunks at once, and only the ``(B, H, P, N)`` state
recurrence loops over the chunks.

Decode carries ``{"conv": (B, K-1, Cch), "ssm": (B, H, P, N)}`` per layer:
constant-size state.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm


def dims(cfg):
    d_inner = cfg.expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    return d_inner, H, cfg.ssm_state, cfg.ssm_head_dim


def mamba_init(gen: torch.Generator, cfg, *, lead=(), device,
               prefix_dim: Optional[int] = None) -> dict:
    """One layer's train-form parameters; ``lead`` prepends stack dims."""
    d = prefix_dim or cfg.d_model
    d_inner, H, N, P = dims(cfg)
    conv_ch = d_inner + 2 * N                       # x, B, C share the conv
    d_proj = 2 * d_inner + 2 * N + H                # z, x, B, C, dt
    lead = tuple(lead)
    kw = dict(lead=lead, device=device)
    in_proj = cm.dense_init(gen, d, d_proj, **kw)
    conv_w = torch.randn(lead + (cfg.d_conv, conv_ch), generator=gen,
                         dtype=torch.float32, device=gen.device)
    return {
        "ln": cm.norm_init(d, "rms", **kw),
        "in_proj": in_proj,
        "conv_w": (conv_w * cfg.d_conv ** -0.5).to(cm.DTYPE).to(device),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=cm.DTYPE,
                              device=device),
        "A_log": torch.zeros(lead + (H,), dtype=torch.float32,
                             device=device),             # a = -exp(0) = -1
        "D": torch.ones(lead + (H,), dtype=torch.float32, device=device),
        "dt_bias": torch.full(lead + (H,), -2.0, dtype=torch.float32,
                              device=device),
        "gn": cm.norm_init(d_inner, "rms", **kw),
        "out_proj": cm.dense_init(gen, d_inner, d, scale=d_inner ** -0.5,
                                  **kw),
    }


def empty_state(cfg, batch: int, n_layers: int, *, device) -> dict:
    d_inner, H, N, P = dims(cfg)
    conv_ch = d_inner + 2 * N
    return {
        "conv": torch.zeros((n_layers, batch, cfg.d_conv - 1, conv_ch),
                            dtype=cm.DTYPE, device=device),
        "ssm": torch.zeros((n_layers, batch, H, P, N), dtype=torch.float32,
                           device=device),
    }


def _split(p, xz, cfg):
    d_inner, H, N, P = dims(cfg)
    return torch.split(xz, [d_inner, d_inner + 2 * N, H], dim=-1)


def _causal_conv(w, b, xBC):
    """Depthwise causal conv, window K, via K shifted adds. xBC: (B,S,C)."""
    K = w.shape[0]
    S = xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    y = torch.zeros(xBC.shape, dtype=torch.float32, device=xBC.device)
    for i in range(K):
        y = y + pad[:, i:i + S].float() * w[i].float()
    return F.silu(y + b.float()).to(xBC.dtype)


def ssd_chunked(xh, Bm, Cm, dt, a, h0, chunk: int):
    """SSD dual form.  xh (B,S,H,P); Bm/Cm (B,S,N); dt (B,S,H); a (H,)<0.
    h0: (B,H,P,N) initial state.  Returns (y (B,S,H,P) f32, h_final)."""
    Bsz, S, H, Pd = xh.shape
    Sp = -(-S // chunk) * chunk
    if Sp != S:
        # zero-pad: dt=0 -> decay 1 and no input; B=C=0 -> no contribution
        def pad(t):
            return F.pad(t, (0, 0) * (t.ndim - 2) + (0, Sp - S))
        xh, Bm, Cm, dt = pad(xh), pad(Bm), pad(Cm), pad(dt)
    nc = Sp // chunk

    def r(t):
        return t.reshape(Bsz, nc, chunk, *t.shape[2:]).float()

    xh, Bm, Cm, dt = r(xh), r(Bm), r(Cm), r(dt)
    dA = a.float() * dt                                    # (B,nc,Q,H) <= 0
    cs = torch.cumsum(dA, dim=2)                           # within-chunk
    # intra-chunk, every chunk at once:
    # M[q,k] = exp(cs_q - cs_k) * (C_q.B_k) * dt_k  (q >= k)
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]      # (B,nc,Q,Q,H)
    iota = torch.arange(chunk, device=xh.device)
    causal = (iota[:, None] >= iota[None, :])[None, None, :, :, None]
    G = torch.where(causal, torch.exp(seg), 0.0)
    del seg
    CB = torch.einsum("bcqn,bckn->bcqk", Cm, Bm)
    M = G * CB[..., None] * dt[:, :, None, :, :]           # (B,nc,Q,Q,H)
    del G
    y = torch.einsum("bcqkh,bckhp->bcqhp", M, xh)
    del M
    # each chunk's contribution to the state it hands on
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)        # (B,nc,Q,H)
    contrib = torch.einsum("bcqh,bcqn,bcqhp->bchpn", decay_to_end * dt, Bm,
                           xh)                             # (B,nc,H,P,N)
    chunk_decay = torch.exp(cs[:, :, -1])                  # (B,nc,H)
    # the recurrence: the state entering each chunk
    h = h0.float()
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = h * chunk_decay[:, c, :, None, None] + contrib[:, c]
    h_in = torch.stack(h_in, dim=1)                        # (B,nc,H,P,N)
    y = y + torch.einsum("bcqn,bchpn->bcqhp", Cm, h_in) \
        * torch.exp(cs)[..., None]
    return y.reshape(Bsz, Sp, H, Pd)[:, :S], h


def mamba_block(p, x, cfg, wbits=8, abits=8, *, state: Optional[dict] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: (B, S, d).

    * state=None, S>=1 .... chunked full sequence (train); no state out.
    * state given, S>1 .... chunked prefill seeded by the state's ssm (the
      conv window starts from zeros, as in the reference); state out.
    * state given, S==1 ... single-step decode; state out.

    The state out is a new dict; the caller writes it where it keeps it."""
    d_inner, H, N, P = dims(cfg)
    B, S = x.shape[:2]
    res = x
    xz = cm.apply_linear(p["in_proj"],
                         cm.rms_norm(x, p["ln"]["scale"], cfg.norm_eps),
                         wbits, abits)
    z, xBC, dt_raw = _split(p, xz, cfg)
    a = -torch.exp(p["A_log"].float())                     # (H,)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())  # (B,S,H)

    if state is None or S > 1:
        xBC_raw = xBC
        xBC = _causal_conv(p["conv_w"], p["conv_b"], xBC)
        xh = xBC[..., :d_inner].reshape(B, S, H, P)
        Bm = xBC[..., d_inner:d_inner + N]
        Cm = xBC[..., d_inner + N:]
        h0 = (state["ssm"] if state is not None else
              torch.zeros((B, H, P, N), dtype=torch.float32,
                          device=x.device))
        y, h_fin = ssd_chunked(xh, Bm, Cm, dt, a, h0, cfg.ssm_chunk)
        new_state = None
        if state is not None:
            K = cfg.d_conv
            new_state = {"conv": xBC_raw[:, S - (K - 1):, :], "ssm": h_fin}
    else:
        # decode: roll the conv window, one SSM step
        conv_in = torch.cat([state["conv"], xBC.to(state["conv"].dtype)],
                            dim=1)                          # (B,K,C)
        w = p["conv_w"].float()
        acc = torch.zeros((B, conv_in.shape[2]), dtype=torch.float32,
                          device=x.device)                  # (B,C)
        for i in range(w.shape[0]):
            acc = acc + conv_in[:, i].float() * w[i]
        xBC1 = F.silu(acc + p["conv_b"].float())[:, None]   # (B,1,C)
        xh = xBC1[..., :d_inner].reshape(B, 1, H, P)
        Bm = xBC1[..., d_inner:d_inner + N]
        Cm = xBC1[..., d_inner + N:]
        dA = torch.exp(a[None, :] * dt[:, 0])                # (B,H)
        h = state["ssm"] * dA[..., None, None] + torch.einsum(
            "bh,bn,bhp->bhpn", dt[:, 0], Bm[:, 0].float(), xh[:, 0].float())
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), h)[:, None]
        new_state = {"conv": conv_in[:, 1:], "ssm": h}

    y = y + p["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(B, S, d_inner)
    y = y * F.silu(z.float())
    y = cm.rms_norm(y.to(cm.DTYPE), p["gn"]["scale"], cfg.norm_eps)
    out = cm.apply_linear(p["out_proj"], y, wbits, abits)
    return res + out, new_state

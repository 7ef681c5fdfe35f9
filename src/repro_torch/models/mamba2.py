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

On a mesh with a model axis the state keeps this rank's heads and conv
channels (``dist.sharding``'s cache rules).  ``in_proj`` is
column-parallel over ``[z | x B C | dt]``, whose column blocks do not
follow the heads, so its output is gathered whole; each rank runs the
SSD on its heads (every head reads all of ``B`` and ``C``) and the
heads' ``y`` are gathered before the gated RMSNorm, whose f32 sum runs
over all of ``d_inner``; ``out_proj`` is row-parallel, its int32 sums
and activation amax reduced exactly.  Every value EQUALS one device's
where the per-head products do (the f32 einsums at fewer heads may pick
another library kernel on the card).  In the train form each model rank
reads ``z``, ``dt``, the conv output and the replicated per-head
``A_log``, ``dt_bias`` and ``D`` only at its heads, so their gradients
SUM over the model axis (``dist.api.Mesh.enter``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist import api as dist
from repro_torch.dist import sharding as shd
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


def _model_split(p, H: int, C: int):
    """``(mesh, head axes, channel axes)``: the model axes the active
    mesh splits the ``H`` SSM heads and the ``C`` conv channels over, by
    ``dist.sharding``'s rules for the ``ssm`` and ``conv`` cache leaves
    (() where they stay whole, and off a model axis)."""
    mesh = dist.active_mesh()
    if mesh is None or dist.in_manual_mode() or dist.tp_size(mesh) <= 1:
        return None, (), ()
    h, c = (dist.logical_to_mesh(mesh, ("tp",), (n,))[0] for n in (H, C))
    return mesh, dist.entry_axes(h), dist.entry_axes(c)


def mamba_block(p, x, cfg, wbits=8, abits=8, *, state: Optional[dict] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: (B, S, d).

    * state=None, S>=1 .... chunked full sequence (train); no state out.
    * state given, S>1 .... chunked prefill seeded by the state's ssm (the
      conv window starts from zeros, as in the reference); state out.
    * state given, S==1 ... single-step decode; state out.

    The state out is a new dict; the caller writes it where it keeps it.

    On a model axis (module docstring) the rank runs the SSD, ``D`` and
    the gate on its block of the heads and gathers ``y`` before the
    gated RMSNorm; ``in_proj``'s columns are gathered, the conv runs on
    every channel in a full sequence (``conv_w`` gathered) and on this
    rank's channels in a decode step (its output gathered), and the
    state keeps this rank's heads and channels."""
    d_inner, H, N, P = dims(cfg)
    B, S = x.shape[:2]
    res = x
    xz = cm.apply_linear(p["in_proj"],
                         cm.rms_norm(x, p["ln"]["scale"], cfg.norm_eps),
                         wbits, abits)
    z, xBC, dt_raw = _split(p, xz, cfg)
    mesh, h_axes, c_axes = _model_split(p, H, xBC.shape[-1])
    n_h = H // mesh.axis_size(h_axes) if h_axes else H
    h0 = mesh.index(h_axes) * n_h if h_axes else 0
    heads = slice(h0, h0 + n_h)
    A_log, dt_bias, D = p["A_log"], p["dt_bias"], p["D"]
    if h_axes:
        # every model rank reads z, dt and the replicated per-head
        # scalars in part: their gradients SUM (disjoint blocks, zeros
        # elsewhere: exact)
        z, dt_raw = (mesh.enter(t, h_axes) for t in (z, dt_raw))
        A_log, dt_bias, D = (mesh.enter(t, h_axes, kind="grad_heads")
                             for t in (A_log, dt_bias, D))
    a = -torch.exp(A_log.float()[heads])                   # (n_h,)
    dt = F.softplus(dt_raw.float()[..., heads]
                    + dt_bias.float()[heads])              # (B,S,n_h)

    if state is None or S > 1:
        xBC_raw = xBC
        conv_w = (shd.gather_leaf(p, "conv_w") if isinstance(p, shd.Local)
                  else p["conv_w"])
        xBC = _causal_conv(conv_w, p["conv_b"], xBC)
        if h_axes:
            xBC = mesh.enter(xBC, h_axes)
        xh = xBC[..., :d_inner].reshape(B, S, H, P)[:, :, heads]
        Bm = xBC[..., d_inner:d_inner + N]
        Cm = xBC[..., d_inner + N:]
        h_init = (state["ssm"] if state is not None else
                  torch.zeros((B, n_h, P, N), dtype=torch.float32,
                              device=x.device))
        y, h_fin = ssd_chunked(xh, Bm, Cm, dt, a, h_init, cfg.ssm_chunk)
        new_state = None
        if state is not None:
            K = cfg.d_conv
            window = xBC_raw[:, S - (K - 1):, :]
            if c_axes:
                window = mesh.local_block(window, c_axes, -1)
            new_state = {"conv": window, "ssm": h_fin}
    else:
        # decode: roll the conv window, one SSM step
        w, b, new_in = p["conv_w"], p["conv_b"], xBC
        if c_axes:              # this rank's channels of the window
            if not (isinstance(p, shd.Local) and "conv_w" in p.layout):
                w = mesh.local_block(w, c_axes, -1)
            b = mesh.local_block(b, c_axes, -1)
            new_in = mesh.local_block(xBC, c_axes, -1)
        conv_in = torch.cat([state["conv"],
                             new_in.to(state["conv"].dtype)],
                            dim=1)                          # (B,K,C)
        w = w.float()
        acc = torch.zeros((B, conv_in.shape[2]), dtype=torch.float32,
                          device=x.device)                  # (B,C)
        for i in range(w.shape[0]):
            acc = acc + conv_in[:, i].float() * w[i]
        xBC1 = F.silu(acc + b.float())[:, None]             # (B,1,C)
        if c_axes:
            xBC1 = mesh.all_gather(xBC1, c_axes, dim=-1,
                                   kind="gather_conv")
        xh = xBC1[..., :d_inner].reshape(B, 1, H, P)[:, :, heads]
        Bm = xBC1[..., d_inner:d_inner + N]
        Cm = xBC1[..., d_inner + N:]
        dA = torch.exp(a[None, :] * dt[:, 0])                # (B,n_h)
        h = state["ssm"] * dA[..., None, None] + torch.einsum(
            "bh,bn,bhp->bhpn", dt[:, 0], Bm[:, 0].float(), xh[:, 0].float())
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), h)[:, None]
        new_state = {"conv": conv_in[:, 1:], "ssm": h}

    y = y + D.float()[heads][None, None, :, None] * xh.float()
    y = y.reshape(B, S, n_h * P)
    y = y * F.silu(z[..., h0 * P:(h0 + n_h) * P].float())
    y = y.to(cm.DTYPE)
    if h_axes:
        # the norm's f32 sum runs over every head: gather them first
        y = mesh.all_gather(y, h_axes, dim=-1, kind="gather_heads")
    y = cm.rms_norm(y, p["gn"]["scale"], cfg.norm_eps)
    out = cm.apply_linear(p["out_proj"], y, wbits, abits)
    return res + out, new_state

"""Mixture-of-Experts FFN (kimi-k2, moonshot): capacity-based top-k
routing on one device.

The counterpart of ``repro.models.moe``.  Position-in-expert is computed
per *choice* (k one-hot cumsums of (T, E), never (T*k, E)); dispatch is a
scatter into an ``(E, C, d)`` buffer, every expert runs its SwiGLU on its
``C`` slots, and combine gathers each choice back and sums a token's k
gated contributions.

Per-EXPERT precision (DESIGN.md §4): ``wbits`` may be a scalar or an
``(E,)`` vector; expert e's GEMMs run at ``wbits[e]``, and the shared
experts at the max of them.  In the serve form the expert stacks go
through ``ops.serve_linear_stacked(stack_bits=True)``: each expert takes
its own activation scale, so a token's output depends on which other
tokens share its experts (rows of a MoE batch are not numerically
independent).

Ties in the router's top-k: ``jax.lax.top_k`` puts the lower expert
index first; here a stable descending sort does the same (``torch.topk``
promises no order among equal values).  The order of the choices decides
position-in-expert, and so which choices the capacity drops.

Not ported, and raising ``NotImplementedError``: the reference's
expert-parallel ``shard_map`` dispatch under a mesh with a ``model`` axis
(it waits for ``dist/sharding.py``).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import bitfluid as bf
from repro_torch.dist import api as dist_api
from repro_torch.kernels import ops as kops
from repro_torch.models import common as cm


def moe_init(gen: torch.Generator, cfg, *, lead=(), device) -> dict:
    """Router, the (E, d, f) expert stacks and the shared experts, bf16;
    ``lead`` prepends stack dims (``(L,)`` for a layer stack)."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    lead = tuple(lead)

    def w(shape, sc):
        x = torch.randn(lead + shape, generator=gen, dtype=torch.float32,
                        device=gen.device)
        return (x * sc).to(cm.DTYPE).to(device)

    s = d ** -0.5
    p = {"router": {"w": w((d, E), s)},
         "experts": {"wg": w((E, d, f), s), "wu": w((E, d, f), s),
                     "wd": w((E, f, d), f ** -0.5)}}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        kw = dict(lead=lead, device=device)
        p["shared"] = {"wg": cm.dense_init(gen, d, fs, **kw),
                       "wu": cm.dense_init(gen, d, fs, **kw),
                       "wd": cm.dense_init(gen, fs, d, scale=fs ** -0.5,
                                           **kw)}
    return p


def _swiglu(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return (F.silu(g.float()) * u.float()).to(cm.DTYPE)


def _expert_ffn(pe, xin, wbits, abits):
    """xin: (E, C, d); per-expert SwiGLU, expert e at wbits[e]."""
    E = xin.shape[0]
    if not isinstance(pe["wg"], dict):                  # train form
        wb = torch.as_tensor(wbits, dtype=torch.int32).expand(E)

        def stacked(w3, x):
            return torch.stack([
                (bf.fake_quant(x[e].float(), abits)
                 @ bf.fake_quant(w3[e].float(), wb[e], axis=0)).to(cm.DTYPE)
                for e in range(E)])
    else:
        # serve form: {"q": (E, d, f) int8, "s": (E, 1, f)}; one bit-plane
        # launch per expert, expert e at wbits[e]
        def stacked(pq, x):
            return kops.serve_linear_stacked(
                {"q": pq["q"], "s": pq["s"]}, x, wbits, abits,
                stack_bits=True).to(cm.DTYPE)

    h = _swiglu(stacked(pe["wg"], xin), stacked(pe["wu"], xin))
    return stacked(pe["wd"], h)


def _route(p, xf, cfg):
    """Router top-k and the load-balance aux.  xf: (T, d).  Returns
    (topi (T, k) int64, topv (T, k) f32 renormalised, aux f32)."""
    E, k = cfg.n_experts, cfg.experts_per_token
    logits = cm.apply_linear(p["router"], xf, 16, 16).float()
    probs = torch.softmax(logits, dim=-1)                       # (T, E)
    # stable: equal probabilities keep the lower expert index first, as
    # lax.top_k does
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = vals[:, :k], idx[:, :k]
    topv = topv / topv.sum(dim=-1, keepdim=True)
    me = probs.mean(dim=0)
    ce = F.one_hot(topi[:, 0], E).float().mean(dim=0)
    aux = E * (me * ce).sum()
    return topi, topv, aux


def _positions(topi, E: int, C: int):
    """Position-in-expert per choice: k cumsums of (T, E), never (T*k, E).
    Returns (eid, pos, keep) flattened to (T*k,)."""
    T, k = topi.shape
    counts = torch.zeros((E,), dtype=torch.int32, device=topi.device)
    pos_list, keep_list = [], []
    for j in range(k):
        oh = F.one_hot(topi[:, j], E).to(torch.int32)           # (T, E)
        pos_j = torch.cumsum(oh, dim=0, dtype=torch.int32) - 1 + counts[None]
        pos_sel = (oh * pos_j).sum(dim=-1, dtype=torch.int32)   # (T,)
        counts = counts + oh.sum(dim=0, dtype=torch.int32)
        pos_list.append(pos_sel)
        keep_list.append(pos_sel < C)
    pos = torch.stack(pos_list, 1).reshape(-1)                  # (T*k,)
    keep = torch.stack(keep_list, 1).reshape(-1)
    return topi.reshape(-1), pos, keep


def capacity(T: int, cfg) -> int:
    """Slots per expert for T routed tokens (the reference's single-device
    formula, in Python floats): ``max(int(T k / E cf), 1)``, rounded up to
    a multiple of 512 when T >= 4096."""
    C = max(int(T * cfg.experts_per_token / cfg.n_experts
                * cfg.capacity_factor), 1)
    return -(-C // 512) * 512 if T >= 4096 else C


def _dispatch_compute_combine(xf, topi, topv, experts, cfg, wbits, abits, C):
    """Single-device dispatch -> expert FFN -> combine.  xf: (T, d).

    The scatter puts at most one non-zero value in each (expert, slot):
    dropped choices add a zero at slot 0, so the accumulating scatter is
    exact in any order.  Every expert runs, the empty ones on zeros, as
    in the reference.  A token's k gated contributions are summed in
    choice order, one f32 add at a time."""
    T, d = xf.shape
    E, k = experts_E(experts), cfg.experts_per_token
    eid, pos, keep = _positions(topi, E, C)
    gate = (topv.reshape(-1) * keep).float()
    xr = torch.repeat_interleave(xf, k, dim=0)                  # (T*k, d)
    pos_c = torch.where(keep, pos, 0).long()
    buf = torch.zeros((E, C, d), dtype=xf.dtype, device=xf.device)
    buf.index_put_((eid, pos_c), torch.where(keep[:, None], xr, 0),
                   accumulate=True)
    out_buf = _expert_ffn(experts, buf, wbits, abits)           # (E, C, d)
    yk = (out_buf[eid, pos_c].float() * gate[:, None]).reshape(T, k, d)
    y = yk[:, 0]
    for j in range(1, k):
        y = y + yk[:, j]
    return y.to(cm.DTYPE)


def experts_E(experts) -> int:
    wg = experts["wg"]
    return (wg["q"] if isinstance(wg, dict) else wg).shape[0]


def apply_moe(p, x, cfg, wbits=8, abits=8) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss).  Top-k capacity routing on one
    device; a mesh with a ``model`` axis (the reference's expert-parallel
    ``shard_map`` path) raises."""
    B, S, d = x.shape
    E = cfg.n_experts
    mesh = dist_api.active_mesh()
    if (mesh is not None and "model" in mesh.shape
            and E % mesh.shape["model"] == 0):
        raise NotImplementedError(
            "expert-parallel MoE dispatch over a 'model' mesh axis is not "
            "ported: it waits for dist/sharding.py")
    T = B * S
    xf = x.reshape(T, d)
    topi, topv, aux = _route(p, xf, cfg)
    y = _dispatch_compute_combine(xf, topi, topv, p["experts"], cfg, wbits,
                                  abits, capacity(T, cfg))
    if "shared" in p:
        # the shared experts run at the max of the per-expert bits
        wb_s = wbits if getattr(wbits, "ndim", 0) == 0 \
            else torch.as_tensor(wbits).max()
        sh = p["shared"]
        h = _swiglu(cm.apply_linear(sh["wg"], xf, wb_s, abits),
                    cm.apply_linear(sh["wu"], xf, wb_s, abits))
        y = y + cm.apply_linear(sh["wd"], h, wb_s, abits)
    return y.reshape(B, S, d), aux

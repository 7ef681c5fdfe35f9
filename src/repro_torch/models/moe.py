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

Expert parallelism (the reference's ``_apply_moe_shard_map``): on a mesh
with a ``model`` axis of size tp dividing E, whose data axis divides the
tokens, d_model and d_ff, each rank holds E / tp experts (placed by
``dist.sharding``), routes its data rank's tokens to its LOCAL experts
(global ids re-indexed onto local slots, the dummy overflow slot
``E_loc`` for other ranks' experts) at the per-shard capacity
``C_shard = ceil8(max(int(T_loc k / E cf), 4))``, FSDP-gathers its
expert stacks over the data axis, runs the FFN, and one SUM over the
model axis combines each token's contributions.  The per-shard capacity
drops other choices than the single-device path, so EP is held to the
reference's EP semantics, which :func:`ep_reference` states in one
process.  A mesh the eligibility test refuses runs the single-device
path on the whole batch (its tokens gathered over the data axis).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

from repro_torch.core import bitfluid as bf
from repro_torch.dist import api as dist_api
from repro_torch.dist import sharding as shd
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


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n)`` without its range check, which reads the
    index's min and max back to the host off CUDA (a sync per call)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


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
    ce = _one_hot(topi[:, 0], E).float().mean(dim=0)
    rows = kops.rows_split_mesh()
    if rows is not None and probs.requires_grad:
        # the train form on a data rank's rows: the batch's means (equal
        # row blocks), so every data rank holds the batch's aux
        dp = dist_api.dp_size(rows)
        me = rows.all_reduce(me, rows.dp_axes, "sum", kind="moe_aux") / dp
        ce = rows.all_reduce(ce, rows.dp_axes, "sum", kind="moe_aux") / dp
    aux = E * (me * ce).sum()
    return topi, topv, aux


def _positions(topi, E: int, C: int):
    """Position-in-expert per choice: k cumsums of (T, E), never (T*k, E).
    Returns (eid, pos, keep) flattened to (T*k,)."""
    T, k = topi.shape
    counts = torch.zeros((E,), dtype=torch.int32, device=topi.device)
    pos_list, keep_list = [], []
    for j in range(k):
        oh = _one_hot(topi[:, j], E).to(torch.int32)            # (T, E)
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


def shard_capacity(T_loc: int, cfg) -> int:
    """The reference's per-shard expert capacity: ``max(int(T_loc k / E
    cf), 4)`` rounded up to a multiple of 8."""
    c = max(int(T_loc * cfg.experts_per_token / cfg.n_experts
                * cfg.capacity_factor), 4)
    return -(-c // 8) * 8


# dropped choices (kept by capacity, routed to a local expert, but past
# C_shard) counted by each expert-parallel dispatch
ep_dropped = [0]


def _ep_local(xf, topi, topv, experts, cfg, wbits, abits, rank: int,
              E_loc: int, C_shard: int):
    """One shard of the expert-parallel body: this model rank's E_loc
    experts (``experts`` whole in d_model) on one data rank's tokens.
    Returns (the f32 sum of the token's local contributions (T_loc, d),
    the dispatch buffer (E_loc, C_shard, d))."""
    T_loc, d = xf.shape
    k = cfg.experts_per_token
    local_i = topi - rank * E_loc
    mine = (local_i >= 0) & (local_i < E_loc)
    li = torch.where(mine, local_i, E_loc)      # E_loc: the overflow slot
    eid, pos, keep = _positions(li, E_loc + 1, C_shard)
    if not is_fake(mine):       # fake tensors (the lowering report) hold
        ep_dropped[0] += int((mine.reshape(-1) & ~keep).sum())  # no count
    keep = keep & mine.reshape(-1)
    gate = (topv.reshape(-1) * keep).float()
    xr = torch.repeat_interleave(xf, k, dim=0)
    pos_c = torch.where(keep, pos, 0).long()
    eid_c = torch.where(keep, eid, 0).long()
    buf = torch.zeros((E_loc, C_shard, d), dtype=xf.dtype, device=xf.device)
    buf.index_put_((eid_c, pos_c), torch.where(keep[:, None], xr, 0),
                   accumulate=True)
    if getattr(wbits, "ndim", 0) >= 1:         # per-expert bits
        wbits = torch.as_tensor(wbits)[rank * E_loc:(rank + 1) * E_loc]
    out_buf = _expert_ffn(experts, buf, wbits, abits)
    yk = (out_buf[eid_c, pos_c].float() * gate[:, None]).reshape(T_loc, k, d)
    y = yk[:, 0]
    for j in range(1, k):
        y = y + yk[:, j]
    return y, buf


def _gather_dp(tree):
    """The expert stacks whole in every dim but the expert one: each
    FSDP (data-axis) shard all-gathered, the model-axis experts kept."""
    if isinstance(tree, shd.Local):
        out = {}
        for name, t in tree.items():
            if isinstance(t, dict):
                out[name] = _gather_dp(t)
                continue
            _, spec = tree.spec(name)
            for dim, e in enumerate(spec):
                if e is not None and not dist_api.is_tp_entry(e):
                    t = tree.mesh.gather_weight(t, dist_api.entry_axes(e),
                                                dim - len(spec))
            out[name] = t
        return out
    if isinstance(tree, dict):
        return {k: _gather_dp(v) for k, v in tree.items()}
    return tree


def _ep_eligible(mesh, cfg) -> bool:
    """The reference's test (``E % tp``; tokens, d and d_ff divisible by
    dp); the port splits the tokens over dp before the model runs."""
    tp, dp = mesh.shape.get("model", 1), dist_api.dp_size(mesh)
    return (cfg.n_experts % tp == 0 and cfg.d_model % dp == 0
            and cfg.d_ff % dp == 0)


def apply_moe(p, x, cfg, wbits=8, abits=8) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss).  Top-k capacity routing: on one
    device, or on a mesh with a ``model`` axis the expert-parallel
    dispatch (module docstring).  On a mesh ``x`` holds this data rank's
    rows."""
    B, S, d = x.shape
    E = cfg.n_experts
    T = B * S
    xf = x.reshape(T, d)
    topi, topv, aux = _route(p, xf, cfg)
    mesh = dist_api.active_mesh()
    if mesh is None:
        y = _dispatch_compute_combine(xf, topi, topv, p["experts"], cfg,
                                      wbits, abits, capacity(T, cfg))
    elif "model" in mesh.shape and _ep_eligible(mesh, cfg):
        y = _apply_moe_ep(p, xf, topi, topv, cfg, wbits, abits, mesh)
    else:
        y = _whole_batch(p, xf, topi, topv, cfg, wbits, abits, mesh)
    if "shared" in p:
        # the shared experts run at the max of the per-expert bits (on a
        # model axis a Megatron pair)
        wb_s = wbits if getattr(wbits, "ndim", 0) == 0 \
            else torch.as_tensor(wbits).max()
        sh = p["shared"]
        h = _swiglu(cm.local_linear(sh["wg"], xf, wb_s, abits),
                    cm.local_linear(sh["wu"], xf, wb_s, abits))
        y = y + cm.apply_linear(sh["wd"], h, wb_s, abits)
    return y.reshape(B, S, d), aux


def _rows_split(mesh) -> bool:
    """Whether ``x`` is this data rank's block of the batch's rows."""
    if dist_api.dp_size(mesh) <= 1:
        return False
    if kops.rows_split_mesh() is None:
        raise NotImplementedError(
            "MoE on a mesh with a data axis needs the batch's rows split "
            "over it (a generate() batch that the data ranks divide)")
    return True


def _apply_moe_ep(p, xf, topi, topv, cfg, wbits, abits, mesh):
    """This rank's shard of the expert-parallel dispatch; the SUM over
    the model axis gives every model rank the combined (T_loc, d)."""
    if not isinstance(mesh, dist_api.Mesh) or not shd.is_sharded(
            p["experts"]):
        raise NotImplementedError(
            "expert-parallel MoE needs a repro_torch.dist.Mesh and expert "
            "stacks placed on it (dist.sharding.shard_params)")
    _rows_split(mesh)
    tp = mesh.shape["model"]
    E_loc = cfg.n_experts // tp
    C_shard = shard_capacity(xf.shape[0], cfg)
    # every model rank's tokens and gates feed its own experts: their
    # gradients SUM over the model axis (the combine's passes as it is)
    xf = mesh.enter(xf, mesh.tp_axes)
    topv = mesh.enter(topv, mesh.tp_axes)
    # a shard_map body: local activation scales, no data-axis reduction
    with dist_api.manual_mode():
        y, _ = _ep_local(xf, topi, topv, _gather_dp(p["experts"]), cfg,
                         wbits, abits, mesh.tp_index, E_loc, C_shard)
    return mesh.all_reduce(y, mesh.tp_axes, "sum",
                           kind="moe_combine").to(cm.DTYPE)


def _whole_batch(p, xf, topi, topv, cfg, wbits, abits, mesh):
    """The single-device path on a mesh the eligibility test refuses:
    every token and every expert gathered whole, this rank's rows kept."""
    split = _rows_split(mesh)
    if split:
        xf, topi, topv = (mesh.all_gather(t, mesh.dp_axes, dim=0,
                                          kind="moe_tokens")
                          for t in (xf, topi, topv))
    y = _dispatch_compute_combine(xf, topi, topv, shd.full(p["experts"]),
                                  cfg, wbits, abits,
                                  capacity(xf.shape[0], cfg))
    if split:
        y = mesh.local_block(y, mesh.dp_axes, 0)
    return y


def ep_reference(p, x, cfg, wbits=8, abits=8, *, tp: int, dp: int = 1,
                 buffers=None):
    """The reference's expert-parallel semantics stated in one process,
    on whole (unplaced) parameters: for each of ``dp`` token shards and
    each of ``tp`` expert shards, the local dispatch at the per-shard
    capacity, the shards' f32 sums added in model-rank order, then the
    shared experts on every token.  ``buffers`` (a list) collects each
    (data shard, model rank)'s dispatch buffer.  Returns (y, aux)."""
    B, S, d = x.shape
    E = cfg.n_experts
    T = B * S
    xf = x.reshape(T, d)
    topi, topv, aux = _route(p, xf, cfg)
    T_loc, E_loc = T // dp, E // tp
    C_shard = shard_capacity(T_loc, cfg)
    ys = []
    for sh in range(dp):
        rows = slice(sh * T_loc, (sh + 1) * T_loc)
        y = None
        for r in range(tp):
            ex = _expert_slice(p["experts"], r * E_loc, (r + 1) * E_loc)
            y_r, buf = _ep_local(xf[rows], topi[rows], topv[rows], ex, cfg,
                                 wbits, abits, r, E_loc, C_shard)
            if buffers is not None:
                buffers.append(buf)
            y = y_r if y is None else y + y_r
        ys.append(y.to(cm.DTYPE))
    y = torch.cat(ys)
    if "shared" in p:
        wb_s = wbits if getattr(wbits, "ndim", 0) == 0 \
            else torch.as_tensor(wbits).max()
        sh_p = p["shared"]
        h = _swiglu(cm.apply_linear(sh_p["wg"], xf, wb_s, abits),
                    cm.apply_linear(sh_p["wu"], xf, wb_s, abits))
        y = y + cm.apply_linear(sh_p["wd"], h, wb_s, abits)
    return y.reshape(B, S, d), aux


def _expert_slice(tree, lo: int, hi: int):
    if isinstance(tree, dict):
        return {k: _expert_slice(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi]

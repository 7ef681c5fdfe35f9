"""AdamW with large-scale memory options, as functions of nested dicts of
tensors.

The counterpart of ``repro.optim.adamw``.  Moment storage is
configurable as in the reference:

  m_dtype:  float32 | bfloat16 | int8   (int8: the shape-preserving codec
            ``{"q": int8, "s": f32 (..., 1)}``, one absmax scale per
            last-axis row)
  v_mode:   full | factored              (factored: Adafactor's row and
            column second moments ``{"vr", "vc"}`` for every leaf whose
            last two axes are both longer than 1)

The state is ``{"step": int32 0-d, "m": tree, "v": tree}`` with the
parameters' nested key names, so a checkpoint of it reads in either
package.  Leaves are visited in sorted-key order, the order of
``jax.tree.leaves``, so the global norm sums them as the reference does.
Everything stays on the parameters' device: the clip and the bias
corrections are 0-d tensors, and no value goes to the host.

On a mesh the parameters are this rank's blocks
(``dist.sharding.Local`` dicts) and so are their gradients, moments and
codecs, laid out as ``dist.sharding.opt_shardings`` places the state.
The update is elementwise on the blocks, and only its reductions cross
ranks: a leaf's sum of squares is SUMmed over the axes that shard that
leaf (a replicated leaf counts once), a factored moment's mean over a
split dim is the SUM over its axes divided by the whole length, and the
int8 codec's row amax is a MAX over the axes of the last dim.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.dist import api as dist_api
from repro_torch.dist import sharding as shd


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    m_dtype: str = "float32"          # float32 | bfloat16 | int8
    v_mode: str = "full"              # full | factored


def _enc_i8(x: torch.Tensor, row_max=None) -> dict:
    amax = x.abs().amax(dim=-1, keepdim=True)
    s = (amax if row_max is None else row_max(amax)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s.float()}


def _dec_i8(enc: dict) -> torch.Tensor:
    return enc["q"].float() * enc["s"]


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def _is_codec(x) -> bool:
    return isinstance(x, dict) and set(x.keys()) == {"q", "s"}


def _is_fact(x) -> bool:
    return isinstance(x, dict) and set(x.keys()) == {"vr", "vc"}


def tree_leaves(tree, is_leaf=lambda x: False) -> list:
    """Leaves of a nested dict in sorted-key order (``jax.tree.leaves``)."""
    if isinstance(tree, dict) and not is_leaf(tree):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k], is_leaf)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` of every leaf, in a dict of the same nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def leaf_layouts(params) -> list:
    """Per leaf of ``params`` in sorted-key order: ``(mesh, whole shape,
    spec)`` for a block of a mesh-placed leaf, None for a whole one."""
    out = []

    def rec(node):
        for k in sorted(node):
            v = node[k]
            if isinstance(v, dict):
                rec(v)
            elif isinstance(node, shd.Local) and k in node.layout:
                shape, spec = node.layout[k]
                out.append((node.mesh, tuple(shape), tuple(spec)))
            else:
                out.append(None)

    if isinstance(params, dict):
        rec(params)
    else:
        out.append(None)
    return out


def _codec_layout(lay, kind: str):
    """The layout of a moment codec's leaves from its parameter's
    ``(mesh, shape, spec)``: the int8 codec's ``q`` is the parameter's,
    its ``s`` drops the last dim to 1; factored ``vr`` drops the last
    dim, ``vc`` the one before (``dist.sharding.opt_pspec``)."""
    mesh, shape, spec = lay
    if kind == "i8":
        parts = {"q": (shape, spec),
                 "s": (shape[:-1] + (1,), spec[:-1] + (None,))}
    else:
        parts = {"vr": (shape[:-1], spec[:-1]),
                 "vc": (shape[:-2] + shape[-1:], spec[:-2] + spec[-1:])}
    return mesh, {k: v for k, v in parts.items()
                  if any(e is not None for e in v[1])}


def _placed(d: dict, lay, kind: str) -> dict:
    """A codec dict as a mesh-placed dict when its parameter is one."""
    if lay is None:
        return d
    mesh, layout = _codec_layout(lay, kind)
    return shd.Local(d, mesh, layout) if layout else d


def _row_max(lay):
    """The int8 codec's row-amax reduction for a parameter of layout
    ``lay``: a MAX over the axes of its last dim (None: not split)."""
    axes = () if lay is None else lay[0].live_axes(lay[2][-1])
    if not axes:
        return None
    return lambda a: lay[0].all_reduce(a, axes, "max", kind="adam_codec")


def _dim_mean(t: torch.Tensor, dim: int, lay, pdim: int,
              keepdim: bool = False) -> torch.Tensor:
    """``t.mean(dim)``, where ``t``'s ``dim`` is the parameter's dim
    ``pdim``: over a dim the mesh splits, the SUM over its axes divided
    by the whole length."""
    if lay is not None:
        mesh, shape, spec = lay
        axes = mesh.live_axes(spec[pdim])
        if axes:
            tot = mesh.all_reduce(t.sum(dim=dim, keepdim=keepdim), axes,
                                  "sum", kind="adam_v")
            return tot / shape[pdim]
    return t.mean(dim=dim, keepdim=keepdim)


def tree_unflatten(like, leaves: list):
    """A dict nested as ``like`` holding ``leaves`` (in sorted-key order);
    a mesh-placed dict of ``like`` stays one, with the layout of the
    leaves that are still tensors (a moment codec's dict places itself)."""
    it = iter(leaves)

    def rec(node):
        if isinstance(node, dict):
            out = {k: rec(node[k]) for k in sorted(node)}
            out = {k: out[k] for k in node}
            if isinstance(node, shd.Local):
                layout = {k: v for k, v in node.layout.items()
                          if not isinstance(out[k], dict)}
                return shd.Local(out, node.mesh, layout) if layout else out
            return out
        return next(it)

    out = rec(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """Zero moments of the parameters' shapes; on a mesh, of their
    blocks, laid out as the parameters are."""
    p_l = tree_leaves(params)
    lays = leaf_layouts(params)
    # a leaf factors by its whole shape (a block of a longer dim may be 1)
    whole = [p.shape if lay is None else lay[1] for p, lay in zip(p_l, lays)]

    def init_m(p, lay):
        if cfg.m_dtype == "int8":
            return _placed(_enc_i8(torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device)), lay, "i8")
        return torch.zeros(p.shape, dtype=_dtype(cfg.m_dtype),
                           device=p.device)

    def init_v(p, lay, shape):
        if cfg.v_mode == "factored" and _factored(shape):
            return _placed(
                {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                   device=p.device),
                 "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                   dtype=torch.float32, device=p.device)},
                lay, "fact")
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"step": torch.zeros((), dtype=torch.int32,
                                device=p_l[0].device),
            "m": tree_unflatten(params, [init_m(p, lay)
                                         for p, lay in zip(p_l, lays)]),
            "v": tree_unflatten(params, [init_v(p, lay, w) for p, lay, w
                                         in zip(p_l, lays, whole)])}


def global_norm(grads, layouts=None) -> torch.Tensor:
    """sqrt of the sum over leaves (in sorted-key order) of each leaf's
    f32 sum of squares.  ``layouts`` (:func:`leaf_layouts` of the
    parameters) makes each block's sum the whole leaf's: one SUM over
    each set of axes that shards some leaves."""
    sums = [torch.sum(torch.square(g.float())) for g in tree_leaves(grads)]
    groups: dict = {}
    for i, lay in enumerate(layouts or ()):
        if lay is not None:
            mesh, _, spec = lay
            axes = mesh.live_axes(tuple(a for e in spec
                                    for a in dist_api.entry_axes(e)))
            if axes:
                groups.setdefault((id(mesh), axes), (mesh, []))[1].append(i)
    for (_, axes), (mesh, idx) in groups.items():
        red = mesh.all_reduce(torch.stack([sums[i] for i in idx]), axes,
                              "sum", kind="grad_norm")
        for j, i in enumerate(idx):
            sums[i] = red[j]
    total = 0
    for s in sums:
        total = total + s
    return torch.sqrt(total)


def adamw_update(params, grads, state: dict, cfg: AdamWConfig
                 ) -> Tuple[dict, dict, dict]:
    """Returns (new_params, new_state, {"grad_norm", "clip"}): one AdamW
    step of every leaf after the global-norm clip, in the reference's
    arithmetic.  Each leaf's f32 temporaries are freed before the next
    leaf's are made."""
    step = state["step"] + 1
    lays = leaf_layouts(params)
    gnorm = global_norm(grads, lays)
    clip = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
    stepf = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=stepf.device), stepf)

    p_l = tree_leaves(params)
    g_l = tree_leaves(grads)
    m_l = tree_leaves(state["m"], _is_codec)
    v_l = tree_leaves(state["v"], _is_fact)
    if not len(p_l) == len(g_l) == len(m_l) == len(v_l):
        raise ValueError(f"{len(p_l)} parameters, {len(g_l)} gradients, "
                         f"{len(m_l)} and {len(v_l)} moments")

    new_p, new_m, new_v = [], [], []
    for p, g, m, v, lay in zip(p_l, g_l, m_l, v_l, lays):
        g = g.float() * clip
        m_f = _dec_i8(m) if isinstance(m, dict) else m.float()
        m_f = cfg.b1 * m_f + (1 - cfg.b1) * g
        if isinstance(v, dict):                      # factored second moment
            g2 = torch.square(g) + 1e-30
            del g
            vr = cfg.b2 * v["vr"] + (1 - cfg.b2) * _dim_mean(g2, -1, lay, -1)
            vc = cfg.b2 * v["vc"] + (1 - cfg.b2) * _dim_mean(g2, -2, lay, -2)
            del g2
            v_hat = (vr[..., None] * vc[..., None, :]
                     / (_dim_mean(vr, -1, lay, -2, keepdim=True)[..., None]
                        + 1e-30))
            new_v.append(_placed({"vr": vr, "vc": vc}, lay, "fact"))
        else:
            v_hat = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
            del g
            new_v.append(v_hat)
        upd = (m_f / bc1) / (torch.sqrt(v_hat / bc2) + cfg.eps)
        del v_hat
        upd = upd + cfg.weight_decay * p.float()
        new_p.append((p.float() - cfg.lr * upd).to(p.dtype))
        del upd
        if cfg.m_dtype == "int8":
            new_m.append(_placed(_enc_i8(m_f, _row_max(lay)), lay, "i8"))
        else:
            new_m.append(m_f.to(_dtype(cfg.m_dtype)))
        del m_f

    new_state = {"step": step,
                 "m": tree_unflatten(params, new_m),
                 "v": tree_unflatten(params, new_v)}
    return (tree_unflatten(params, new_p), new_state,
            {"grad_norm": gnorm, "clip": clip})

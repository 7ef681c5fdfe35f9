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
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


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


def _enc_i8(x: torch.Tensor) -> dict:
    s = x.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
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


def tree_unflatten(like, leaves: list):
    """A dict nested as ``like`` holding ``leaves`` (in sorted-key order)."""
    it = iter(leaves)

    def rec(node):
        if isinstance(node, dict):
            out = {k: rec(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        return next(it)

    out = rec(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def adamw_init(params, cfg: AdamWConfig) -> dict:
    def init_m(p):
        if cfg.m_dtype == "int8":
            return _enc_i8(torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device))
        return torch.zeros(p.shape, dtype=_dtype(cfg.m_dtype),
                           device=p.device)

    def init_v(p):
        if cfg.v_mode == "factored" and _factored(p.shape):
            return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                      device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=torch.float32, device=p.device)}
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = tree_leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": tree_map(init_m, params),
            "v": tree_map(init_v, params)}


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves (in sorted-key order) of each leaf's
    f32 sum of squares."""
    total = 0
    for g in tree_leaves(grads):
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


def adamw_update(params, grads, state: dict, cfg: AdamWConfig
                 ) -> Tuple[dict, dict, dict]:
    """Returns (new_params, new_state, {"grad_norm", "clip"}): one AdamW
    step of every leaf after the global-norm clip, in the reference's
    arithmetic.  Each leaf's f32 temporaries are freed before the next
    leaf's are made."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
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
    for p, g, m, v in zip(p_l, g_l, m_l, v_l):
        g = g.float() * clip
        m_f = _dec_i8(m) if isinstance(m, dict) else m.float()
        m_f = cfg.b1 * m_f + (1 - cfg.b1) * g
        if isinstance(v, dict):                      # factored second moment
            g2 = torch.square(g) + 1e-30
            del g
            vr = cfg.b2 * v["vr"] + (1 - cfg.b2) * g2.mean(dim=-1)
            vc = cfg.b2 * v["vc"] + (1 - cfg.b2) * g2.mean(dim=-2)
            del g2
            v_hat = (vr[..., None] * vc[..., None, :]
                     / (vr.mean(dim=-1, keepdim=True)[..., None] + 1e-30))
            new_v.append({"vr": vr, "vc": vc})
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
            new_m.append(_enc_i8(m_f))
        else:
            new_m.append(m_f.to(_dtype(cfg.m_dtype)))
        del m_f

    new_state = {"step": step,
                 "m": tree_unflatten(params, new_m),
                 "v": tree_unflatten(params, new_v)}
    return (tree_unflatten(params, new_p), new_state,
            {"grad_norm": gnorm, "clip": clip})

"""Zamba2-style hybrid: a Mamba2 backbone and one *shared* attention block.

The counterpart of ``repro.models.hybrid`` (arXiv:2411.15242, adapted):
the layer stack is grouped into ``n_layers / attn_every`` super-blocks;
each super-block first runs the globally shared attention+MLP block (one
weight set reused at every site, specialised per site by a LoRA pair on
its four attention projections), then ``attn_every`` Mamba2 layers.
Mamba params are stacked ``(n_super * attn_every, ...)`` as
``(n_super, attn_every, ...)``, LoRA params ``(n_super, ...)``.

Because the shared block's base weights are one tensor reused
everywhere, its precision is global: the shared block runs at
``wbits[0]`` / ``abits[0]``, the Mamba layers at their super-block's bits.

In the serve form each site's delta ``A @ B`` (f32, rounded to bf16) is
attached to the quantized base as ``lora_delta``, and
``common.apply_linear`` adds ``x @ lora_delta`` (``common.lora_side``)
to the base's f32 output.  On a mesh each base stays placed and carries
the delta its block needs (:func:`_placed_lora`).  The reference
attaches the same delta and never reads it, so its serve form runs every
site on the bare base (ROADMAP Queue C); with ``b = 0``, as
``lora_init`` draws it, the two agree bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.dist import api as dist
from repro_torch.dist import sharding as shd
from repro_torch.models import common as cm
from repro_torch.models import mamba2
from repro_torch.models import transformer as tf


def n_super(cfg) -> int:
    assert cfg.n_layers % cfg.attn_every == 0
    return cfg.n_layers // cfg.attn_every


def lora_init(gen: torch.Generator, cfg, *, lead=(), device) -> dict:
    """Per-site LoRA on the shared block's four attention projections:
    ``a`` Normal(0, d_in^-1/2), ``b`` zeros, bf16."""
    d, H, hd, r = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.lora_rank
    lead = tuple(lead)

    def pair(d_in, d_out):
        a = torch.randn(lead + (d_in, r), generator=gen, dtype=torch.float32,
                        device=gen.device) * d_in ** -0.5
        return {"a": a.to(cm.DTYPE).to(device),
                "b": torch.zeros(lead + (r, d_out), dtype=cm.DTYPE,
                                 device=device)}

    return {"wq": pair(d, H * hd), "wk": pair(d, cfg.n_kv_heads * hd),
            "wv": pair(d, cfg.n_kv_heads * hd), "wo": pair(H * hd, d)}


def hybrid_init(gen: torch.Generator, cfg, *, device) -> dict:
    ns = n_super(cfg)
    return {"shared": tf.block_init(gen, cfg, device=device),
            "mamba": mamba2.mamba_init(gen, cfg, lead=(ns, cfg.attn_every),
                                       device=device),
            "lora": lora_init(gen, cfg, lead=(ns,), device=device)}


def _lora_attn_params(shared_attn: dict, lora: dict) -> dict:
    """Site-specific attention weights: W + A @ B (train form), or the
    quantized base with the delta attached as ``lora_delta`` (serve
    form, applied by ``common.apply_linear``).  On a mesh each base stays
    placed (:func:`_placed_lora`)."""
    out = dict(shared_attn)
    for name in ("wq", "wk", "wv", "wo"):
        base = shared_attn[name]
        if isinstance(base, shd.Local) or isinstance(lora[name], shd.Local):
            out[name] = _placed_lora(base, lora[name])
            continue
        delta = lora[name]["a"].float() @ lora[name]["b"].float()
        if "w" in base:
            out[name] = dict(base, w=(base["w"].float() + delta
                                      ).to(base["w"].dtype))
        else:
            out[name] = dict(base, lora_delta=delta.to(cm.DTYPE))
    return out


def _placed_lora(base, pair):
    """:func:`_lora_attn_params` of one projection whose base or LoRA pair
    is placed on a mesh (``dist.sharding.Local``), EQUAL in value to the
    whole one's, the base kept placed.

    ``a`` (FSDP on ``d_in``) and ``b`` (split on ``d_out`` over the model
    axis) are gathered whole and the delta is formed as one device forms
    it.  An int8 serve-form base whose columns the model axis splits
    keeps the delta's columns of this rank (its layout says so); any
    other serve-form base keeps the whole delta (``common.apply_linear``
    gathers a row-parallel input for it).  A train-form base takes
    ``W + A @ B`` whole, laid out again on the model axis as ``W`` was
    (whole on the data axis).

    In the train form a model rank's block of ``W + A @ B`` backs only
    its block of the delta's gradient, so ``a`` (every column of ``b``
    reaches the block's rows) and, where the rows are cut (``wo``),
    ``b`` enter the model axis: their partial gradients SUM there."""
    mesh = next(t.mesh for t in (base, pair) if isinstance(t, shd.Local))
    a, b = ((shd.gather_leaf(pair, n) if isinstance(pair, shd.Local)
             else pair[n]) for n in ("a", "b"))
    if not isinstance(base, shd.Local):
        base = shd.Local(base, mesh, {})
    layout = dict(base.layout)
    if "w" in layout:
        ke, ne = layout["w"][1][-2:]
        rows = dist.is_tp_entry(ke)
        cut = ke if rows else ne
        if dist.is_tp_entry(cut):
            a = mesh.enter(a, dist.entry_axes(cut), kind="grad_lora")
            if rows:
                b = mesh.enter(b, dist.entry_axes(cut), kind="grad_lora")
    delta = a.float() @ b.float()
    if "w" in base:
        w = (shd.gather_leaf(base, "w").float() + delta).to(base["w"].dtype)
        if "w" in layout:
            # the model-axis blocks only: a data-axis block of this
            # temporary would be gathered again under a cache keyed by
            # storage, which a later temporary may reuse
            shape, spec = layout["w"]
            spec = tuple(e if dist.is_tp_entry(e) else None for e in spec)
            w = shd.block(mesh, w, spec[-2:])
            layout["w"] = (shape, spec)
            if all(e is None for e in spec):
                del layout["w"]
        return shd.Local({**base, "w": w}, mesh, layout)
    delta = delta.to(cm.DTYPE)
    ne = layout.get("q", ((), (None,)))[1][-1]
    if dist.is_tp_entry(ne):
        layout["lora_delta"] = (tuple(delta.shape), (None, ne))
        delta = mesh.local_block(delta, dist.entry_axes(ne), -1)
    return shd.Local({**base, "lora_delta": delta}, mesh, layout)


def hybrid_forward(p, x, cfg, wbits, abits, *, positions,
                   cache: Optional[dict] = None, t=None
                   ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: (B, S, d).  wbits/abits: (n_super,) vectors (or scalars).
    cache: {"kv": transformer cache stacked (n_super, ...), "conv"/"ssm":
    mamba states stacked (n_layers, ...)}, updated in place and
    returned.  Without a cache each super-block is one remat region
    under ``remat="full"``."""
    ns, every = n_super(cfg), cfg.attn_every
    wb = torch.as_tensor(wbits).expand(ns)
    ab = torch.as_tensor(abits).expand(ns)
    shared = p["shared"]
    loras = cm.unstack(p["lora"], ns)
    mambas = [cm.unstack(m, every) for m in cm.unstack(p["mamba"], ns)]

    def super_block(x, i):
        attn_p = {"ln1": shared["ln1"], "ln2": shared["ln2"],
                  "mlp": shared["mlp"],
                  "attn": _lora_attn_params(shared["attn"], loras[i])}
        kv_c = cm.stack_slice(cache["kv"], i) if cache is not None else None
        x, _, _ = tf.block(attn_p, x, cfg, wb[0], ab[0], positions=positions,
                           cache=kv_c, t=t)
        for j, mp in enumerate(mambas[i]):
            li = i * every + j
            st = ({"conv": cache["conv"][li], "ssm": cache["ssm"][li]}
                  if cache is not None else None)
            x, new_st = mamba2.mamba_block(mp, x, cfg, wb[i], ab[i],
                                           state=st)
            if cache is not None:
                cache["conv"][li] = new_st["conv"]
                cache["ssm"][li] = new_st["ssm"]
        return x

    for i in range(ns):
        x = cm.remat(cfg, super_block, x, i, cache=cache)
    return x, cache


def empty_hybrid_cache(cfg, batch: int, max_len: int, *, device) -> dict:
    kv = tf.empty_cache(cfg, batch, max_len, device=device,
                        n_layers=n_super(cfg))
    ms = mamba2.empty_state(cfg, batch, cfg.n_layers, device=device)
    return {"kv": kv, "conv": ms["conv"], "ssm": ms["ssm"]}

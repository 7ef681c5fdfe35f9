"""Encoder-decoder (the seamless-m4t backbone): a bidirectional encoder
over precomputed audio-frame embeddings (the modality frontend is a
stub), and a causal decoder with per-layer cross-attention.

The counterpart of ``repro.models.encdec``.  Decode caches: the
self-attention KV ring caches (``transformer.empty_cache``) plus per-layer
cross K/V, projected once from the encoder output at prefill.  Layer
stacks keep the reference's ``(L, ...)`` layout; a Python loop runs them.
Without a cache, each encoder and decoder layer is one remat region under
``remat="full"`` (``common.remat``), as the reference checkpoints its
scans.

On a mesh the encoder's self-attention and the decoder's cross-attention
run on each model rank's heads, as the decoder's self-attention does
(``transformer``), and the cross cache holds this rank's block of the
K/V heads; the rows of ``frames`` split over the data ranks with the
tokens' rows.  Where the rows do not split over the data ranks (B=1 on a
data mesh), the cache's spec shards the cross K/V's FRAMES over the data
axis instead (``dist.sharding.cache_shardings``, as the reference lays
them out): every rank projects and attends over every frame at prefill
(each holds the row's encoder output whole), the cache keeps this data
rank's frames (a :class:`FrameSlice`, so a decode step knows it from the
spec, not from a shape), and a decode step's cross-attention combines
the ranks' partial softmaxes over the data axis (a MAX, a SUM of the
denominators, a SUM of P.V, as ``transformer``'s sequence-sharded
cache).  In the train form each decoder layer's cross K/V
projection enters the encoder output (a column-parallel input), so its
gradient SUMs over the model axis to one device's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.dist import api as dist
from repro_torch.dist import sharding as shd
from repro_torch.kernels import ops as kops
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf


class FrameSlice(dict):
    """Cross K/V ``{"k", "v"}`` of shape (L, B, F / dp, KV, hd) that hold
    this data rank's frames ``[lo, lo + F / dp)``: the cache's spec
    shards the frames over the data axis."""


def frames_split(cfg, mesh, batch: int, frames: int) -> bool:
    """Whether the spec of a (L, ``batch``, ``frames``, KV, hd) cross
    cache (the whole batch's) shards its frames over ``mesh``'s data
    axis."""
    if mesh is None or dist.dp_size(mesh) <= 1:
        return False
    whole = torch.empty((cfg.n_layers, batch, frames, cfg.n_kv_heads,
                         cfg.head_dim), device="meta")
    return shd.cache_shardings({"k": whole}, mesh)["k"][2] is not None


def keep_frames(xkv: dict, cfg) -> dict:
    """The cross K/V a cache keeps after prefill: this data rank's frames
    (a :class:`FrameSlice`) where the cache's spec shards them, else
    ``xkv`` as it is."""
    mesh = dist.active_mesh()
    if isinstance(xkv, FrameSlice) or mesh is None:
        return xkv
    B, F = xkv["k"].shape[1:3]
    if kops.rows_split_mesh() is not None:  # this data rank's rows
        B *= dist.dp_size(mesh)
    if not frames_split(cfg, mesh, B, F):
        return xkv
    return FrameSlice({n: mesh.local_block(t, mesh.dp_axes, 2).clone()
                       for n, t in xkv.items()})


def dec_block_init(gen: torch.Generator, cfg, *, lead=(), device) -> dict:
    p = tf.block_init(gen, cfg, lead=lead, device=device)
    p["lnx"] = cm.norm_init(cfg.d_model, cfg.norm_type, lead=lead,
                            device=device)
    p["xattn"] = tf.attn_init(gen, cfg, lead=lead, device=device)
    return p


def encdec_init(gen: torch.Generator, cfg, *, device) -> dict:
    return {"enc": tf.block_init(gen, cfg, lead=(cfg.n_enc_layers,),
                                 device=device),
            "enc_ln_f": cm.norm_init(cfg.d_model, cfg.norm_type,
                                     device=device),
            "dec": dec_block_init(gen, cfg, lead=(cfg.n_layers,),
                                  device=device)}


def encode(p, frames: torch.Tensor, cfg, wvec, avec) -> torch.Tensor:
    """frames: (B, F, d) stub embeddings -> encoder output (B, F, d).
    The encoder runs at the first ``n_enc_layers`` bit slots."""
    B, F, _ = frames.shape
    positions = torch.arange(F, dtype=torch.int32,
                             device=frames.device)[None].expand(B, F)
    x = frames
    for i, lp in enumerate(cm.unstack(p["enc"], cfg.n_enc_layers)):
        x = cm.remat(cfg, lambda x, lp=lp, wb=wvec[i], ab=avec[i]:
                     tf.block(lp, x, cfg, wb, ab, positions=positions,
                              causal=False)[0], x)
    return cm.apply_norm(p["enc_ln_f"], x, cfg.norm_type, cfg.norm_eps)


def cross_kv(p_dec, enc_out: torch.Tensor, cfg, wvec, avec) -> dict:
    """Project the encoder output to per-decoder-layer cross K/V (prefill):
    ``{"k", "v"}`` of shape (L, B, F, KV, hd); ``wvec``/``avec`` are the
    decoder's slots.  On a model axis they hold this rank's block as the
    cache's spec lays it out: its KV heads (``wk``/``wv`` kept local), or
    its slice of the head dim where the heads do not divide the axis."""
    B, F, _ = enc_out.shape
    hd = cfg.head_dim
    use_head = tf.local_heads(cfg)
    lin = cm.local_linear if use_head else cm.apply_linear
    ks, vs = [], []
    for i, xp in enumerate(cm.unstack(p_dec["xattn"], cfg.n_layers)):
        kv = [lin(xp[n], enc_out, wvec[i], avec[i]).reshape(B, F, -1, hd)
              for n in ("wk", "wv")]
        if not use_head:
            kv = [dist.constrain_heads(t, 2, 3, False) for t in kv]
        ks.append(kv[0])
        vs.append(kv[1])
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def decoder_block(p, x, cfg, wb, ab, *, positions, enc_kv,
                  cache: Optional[dict] = None, t=None,
                  kv_frames: bool = False):
    """Self-attn + cross-attn + MLP.  enc_kv: (k, v) for this layer
    (``kv_frames``: this data rank's frames of them)."""
    h, new_cache = tf.attention(
        p["attn"], cm.apply_norm(p["ln1"], x, cfg.norm_type, cfg.norm_eps),
        cfg, wb, ab, positions=positions, causal=True, cache=cache, t=t)
    x = x + h
    hx, _ = tf.attention(
        p["xattn"], cm.apply_norm(p["lnx"], x, cfg.norm_type, cfg.norm_eps),
        cfg, wb, ab, positions=positions, kv=enc_kv,
        kv_frames=kv_frames)
    x = x + hx
    y = tf.mlp(p["mlp"], cm.apply_norm(p["ln2"], x, cfg.norm_type,
                                       cfg.norm_eps), cfg, wb, ab)
    return x + y, new_cache


def decoder_forward(p, x, cfg, wvec, avec, *, positions, enc_kv: dict,
                    cache: Optional[dict] = None, t=None
                    ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: (B, S, d) decoder-side embeddings; enc_kv stacked (L, ...); the
    decoder runs at the last ``n_layers`` bit slots (a
    :class:`FrameSlice` enc_kv: this data rank's frames).  The
    self-attention cache is updated in place and returned."""
    n_dec = cfg.n_layers
    wd, ad = wvec[-n_dec:], avec[-n_dec:]
    sliced = isinstance(enc_kv, FrameSlice)
    for i, lp in enumerate(cm.unstack(p["dec"], n_dec)):
        cl = cm.stack_slice(cache, i) if cache is not None else None

        def body(x, lp=lp, wb=wd[i], ab=ad[i], ek=enc_kv["k"][i],
                 ev=enc_kv["v"][i], cl=cl):
            return decoder_block(lp, x, cfg, wb, ab, positions=positions,
                                 enc_kv=(ek, ev), cache=cl, t=t,
                                 kv_frames=sliced)[0]

        x = cm.remat(cfg, body, x, cache=cache)
    return x, cache

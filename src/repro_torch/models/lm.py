"""LM wiring for the dense family: embeddings, the layer stack, logits,
prefill/decode, and the train/serve parameter forms.

The counterpart of ``repro.models.lm``:
  init_params(cfg, gen, device=)             -> train-form dict (bf16)
  quantize_params(params, cfg, container)    -> serve-form (int8/int4 + scales)
  prefill(params, batch, cfg, wvec, avec, cache)
                                             -> (last_logits, cache)
  decode_step(params, tok, t, cache, cfg, wvec, avec) -> (logits, cache)
  empty_cache(cfg, batch, max_len, device=)  -> stacked KV cache

Parameters keep the reference's stacked layout: every layer leaf has a
leading ``(L, ...)`` axis.  The reference scans the stack with
``lax.scan``; here a Python loop runs it layer by layer.  ``wvec`` /
``avec`` are per-layer bit vectors: ``(n_layers,)`` shared across the
batch, or ``(B, n_layers)`` matrices for per-request precision.

Only the dense family is ported; the others (moe, ssm, hybrid, encdec,
vlm) raise ``NotImplementedError`` naming the family, as do ragged
(per-row ``lengths``) prefill and the continuous-batching cache pool.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models import common as cm
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig

PORTED_FAMILIES = ("dense",)
# Families whose layer stacks accept (B, n_layers) per-request bit
# matrices (the reference's list; only "dense" is ported).
PER_ROW_BIT_FAMILIES = ("dense", "vlm", "ssm")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet; the "
            f"port runs {PORTED_FAMILIES}")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def n_bit_slots(cfg: ModelConfig) -> int:
    """Length of the per-layer bit vectors for this family."""
    _require_ported(cfg)
    return cfg.n_layers


def layer_gemm_dims(cfg: ModelConfig):
    """Per-bit-slot serve GEMV dims: one tuple of (K, N) pairs per slot
    (the AP pricer's input)."""
    _require_ported(cfg)
    d = cfg.d_model
    attn = ((d, cfg.n_heads * cfg.head_dim),
            (d, cfg.n_kv_heads * cfg.head_dim),
            (d, cfg.n_kv_heads * cfg.head_dim),
            (cfg.n_heads * cfg.head_dim, d))
    f = cfg.d_ff
    mlp = ((d, f), (d, f), (f, d)) if cfg.mlp_type == "swiglu" \
        else ((d, f), (f, d))
    return (attn + mlp,) * cfg.n_layers


def head_gemm_dims(cfg: ModelConfig):
    """(K, N) of the per-token logits GEMM (priced at the last slot's
    bits)."""
    return (cfg.d_model, cfg.padded_vocab)


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                device="cuda") -> dict:
    """Train-form parameters drawn from ``gen`` (on its own device; a
    CUDA generator draws full-width stacks on the card), placed on
    ``device`` — CUDA unless the caller passes another."""
    _require_ported(cfg)
    dev = cm.resolve_device(device)
    emb = torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen,
                      dtype=torch.float32, device=gen.device)
    p = {"emb": (emb * 0.02).to(cm.DTYPE).to(dev),
         "ln_f": cm.norm_init(cfg.d_model, cfg.norm_type, device=dev)}
    del emb
    p["layers"] = tf.block_init(gen, cfg, lead=(cfg.n_layers,), device=dev)
    if not cfg.tie_embeddings:
        p["head"] = cm.dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                  scale=cfg.d_model ** -0.5, device=dev)
    return p


# ---------------------------------------------------------------------------
# Serve-form quantization (rule-based traversal)
# ---------------------------------------------------------------------------

_EXPERT_KEYS = ("wg", "wu", "wd")
_FP_SUBTREES = ("router", "lora")        # precision-sensitive: keep bf16


def quantize_params(params: dict, cfg: ModelConfig,
                    container: str = "int8") -> dict:
    """Train-form -> serve-form.  Every linear {"w": (..., K, N)} becomes
    {"q"/"q4", "s"} with per-out-channel scales, stacked dims preserved;
    3-D expert stacks quantize per expert; ``emb`` (a gather table) and
    the norms stay bf16."""
    from repro_torch.core import bitfluid as bf

    def q_expert(w: torch.Tensor) -> dict:
        w = w.float()
        s = bf.symmetric_scale(w, 8, axis=-2)
        return {"q": bf.quantize(w, s, 8), "s": s}

    def rec(node, path):
        if isinstance(node, dict):
            if "w" in node and path[-1] not in _FP_SUBTREES:
                return cm.quantize_linear(node, container)
            out = {}
            for k, v in node.items():
                if k in _FP_SUBTREES:
                    out[k] = v
                elif (k in _EXPERT_KEYS and not isinstance(v, dict)
                        and getattr(v, "ndim", 0) == 3):
                    out[k] = q_expert(v)
                else:
                    out[k] = rec(v, path + (k,))
            return out
        return node

    return rec(params, ("",))


# ---------------------------------------------------------------------------
# Stack
# ---------------------------------------------------------------------------

def _layer(tree, i: int):
    """Layer ``i``'s slice of a stacked (L, ...) parameter or cache dict
    (views: an in-place cache insert updates the stack)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _dense_stack(layers, x, cfg, wvec, avec, positions, cache=None, t=None):
    for i in range(cfg.n_layers):
        cl = _layer(cache, i) if cache is not None else None
        x, _ = tf.block(_layer(layers, i), x, cfg, wvec[i], avec[i],
                        positions=positions, cache=cl, t=t)
    return x, cache


def _layer_major(vec, family: str, device) -> torch.Tensor:
    """A bit table for the layer loop, on ``device``: (L,) stays; a
    per-request (B, L) matrix transposes to (L, B), so each layer sees a
    (B,) per-row bit vector."""
    v = torch.as_tensor(vec, dtype=torch.int32).to(device)
    if v.ndim == 2:
        if family not in PER_ROW_BIT_FAMILIES:
            raise NotImplementedError(
                f"per-request (B, n_layers) bit matrices are not supported "
                f"for family {family!r}")
        return v.T
    return v


def forward_hidden(params, x, cfg: ModelConfig, wvec, avec, *, positions,
                   cache=None, t=None):
    """Embedded inputs -> final hidden states.  Returns (h, cache)."""
    _require_ported(cfg)
    wvec = _layer_major(wvec, cfg.family, x.device)
    avec = _layer_major(avec, cfg.family, x.device)
    return _dense_stack(params["layers"], x, cfg, wvec, avec, positions,
                        cache, t)


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------

def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["emb"][tokens]


def logits_fn(params, h: torch.Tensor, cfg: ModelConfig, wb=8, ab=8
              ) -> torch.Tensor:
    h = cm.apply_norm(params["ln_f"], h, cfg.norm_type, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.einsum("...d,vd->...v", h.float(),
                              params["emb"].float())
    else:
        logits = cm.apply_linear(params["head"], h, wb, ab).float()
    if cfg.padded_vocab != cfg.vocab_size:       # mask padding ids
        pad = torch.arange(cfg.padded_vocab, device=h.device) \
            >= cfg.vocab_size
        logits = torch.where(pad, -1e30, logits)
    return logits


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def empty_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                device="cuda") -> dict:
    _require_ported(cfg)
    return tf.empty_cache(cfg, batch, max_len,
                          device=cm.resolve_device(device))


def _last_layer_bits(vec):
    """Bits for the head GEMM: scalar for (L,) tables, (B,) for (B, L)."""
    return torch.as_tensor(vec)[..., -1]


def prefill(params, batch: dict, cfg: ModelConfig, wvec, avec, cache: dict,
            lengths=None) -> Tuple[torch.Tensor, dict]:
    """Full-context lock-step forward filling ``cache`` (in place);
    returns the last-token logits (B, 1, V) and the cache."""
    if lengths is not None:
        raise NotImplementedError(
            "ragged (per-row lengths) prefill is not ported yet; it comes "
            "with continuous batching")
    tokens = batch["tokens"]
    x = embed(params, tokens)
    S = x.shape[1]
    # (1, S): rows share positions, so attention keeps one (S, S) mask
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    h, new_cache = forward_hidden(params, x, cfg, wvec, avec,
                                  positions=positions, cache=cache)
    return (logits_fn(params, h[:, -1:], cfg, _last_layer_bits(wvec),
                      _last_layer_bits(avec)), new_cache)


def decode_step(params, tok: torch.Tensor, t, cache: dict, cfg: ModelConfig,
                wvec, avec) -> Tuple[torch.Tensor, dict]:
    """One decode step: tok (B, 1) int, t scalar or (B,) positions.
    Returns (logits (B, 1, V), cache) with the cache updated in place."""
    B = tok.shape[0]
    x = embed(params, tok)
    t = torch.as_tensor(t, dtype=torch.int32, device=x.device)
    positions = t.expand(B)[:, None]                      # (B, 1)
    h, new_cache = forward_hidden(params, x, cfg, wvec, avec,
                                  positions=positions, cache=cache, t=t)
    return (logits_fn(params, h, cfg, _last_layer_bits(wvec),
                      _last_layer_bits(avec)), new_cache)

"""LM wiring for every family (dense, moe, vlm, ssm, hybrid, encdec):
embeddings, the per-family stacks, logits, prefill/decode, the slot-based
cache pool, and the train/serve parameter forms.

The counterpart of ``repro.models.lm``:
  init_params(cfg, gen, device=)             -> train-form dict (bf16)
  quantize_params(params, cfg, container)    -> serve-form (int8/int4 + scales)
  init_serve_params(cfg, gen, device=)       -> serve-form, drawn and
                                                quantized layer by layer
  prefill(params, batch, cfg, wvec, avec, cache, lengths=None)
                                             -> (last_logits, cache)
  decode_step(params, tok, t, cache, cfg, wvec, avec) -> (logits, cache)
  decode_chunk(params, toks, t, cache, cfg, wvec, avec) -> (logits, cache)
  empty_cache(cfg, batch, max_len, device=)  -> family-specific cache
  CachePool(cfg, n_slots, max_len, device=)  -> slot-based persistent cache
  train_loss(params, batch, cfg, wvec, avec) -> (loss, metrics)

Parameters keep the reference's stacked layout: every layer leaf has a
leading ``(L, ...)`` axis.  The reference scans the stack with
``lax.scan``; here a Python loop runs it layer by layer.  ``wvec`` /
``avec`` are per-layer bit vectors: ``(n_layers,)`` shared across the
batch, or ``(B, n_layers)`` matrices for per-request precision.  ``t`` in
the decode calls is a scalar (lock-step batch) or ``(B,)`` per-row
positions (continuous batching); ``lengths`` in prefill marks per-row
valid prompt lengths of a right-padded batch.

A vlm batch carries ``batch["prefix"]``, precomputed ``(B,
n_prefix_tokens, d_model)`` patch embeddings that prefill puts in front
of the prompt; an encdec batch carries ``batch["frames"]``, ``(B, F,
d_model)`` audio-frame embeddings that prefill encodes once (the decode
steps read the cross K/V kept in the cache).  Ragged prefill and chunked
decode stay with the attention families, as in the reference.

MoE expert stacks are ``(L, E, d, f)``; :func:`quantize_params`
quantizes them per expert (``{"q": int8 (L, E, d, f), "s": (L, E, 1,
f)}``).  The reference's rule quantizes only ``ndim == 3`` expert
leaves, so its LM stacks stay bf16 and its serve path runs the
fake-quant train form; the port departs from it on purpose (ROADMAP
Queue C).

On a mesh the parameters are placed by ``dist.sharding.shard_params``:
the embedding table's vocab over the model axis is a masked local lookup
whose rows one rank holds (a SUM over the model axis adds zeros to it,
exactly), and the tied head computes this rank's vocab columns and
gathers them (each logit is one row's dot product, whatever the column
count).  ``empty_cache(mesh=)`` allocates one rank's block of the cache
as ``dist.sharding.cache_shardings`` lays it out, and a
:class:`CachePool` on a mesh moves a row across data ranks by broadcast.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.dist import api as dist
from repro_torch.dist import sharding as shd
from repro_torch.kernels import ops as kops
from repro_torch.models import common as cm
from repro_torch.models import encdec, hybrid, mamba2, moe
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig

PORTED_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")
MOE_AUX_COEF = 0.01
# The reference's family lists.  Families whose layer stacks accept
# (B, n_layers) per-request bit matrices (MoE resolves a per-expert axis
# instead; hybrid shares one attention block batch-wide; encdec shares
# the encoder):
PER_ROW_BIT_FAMILIES = ("dense", "vlm", "ssm")
# Families whose prefill takes ragged per-row prompt lengths (attention
# masks the padding; a recurrence would consume the pad tokens):
RAGGED_PREFILL_FAMILIES = ("dense", "vlm")
# Families whose decode takes chunked (multi-position) steps, the
# speculative verify (attention masks future positions exactly):
SPEC_CHUNK_FAMILIES = ("dense", "vlm")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"unknown family {cfg.family!r} ({cfg.name}); the port runs "
            f"{PORTED_FAMILIES}")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def n_bit_slots(cfg: ModelConfig) -> int:
    """Length of the per-layer bit vectors for this family."""
    _require_ported(cfg)
    if cfg.family == "encdec":
        return cfg.n_enc_layers + cfg.n_layers
    if cfg.family == "hybrid":
        return hybrid.n_super(cfg)
    return cfg.n_layers


def layer_gemm_dims(cfg: ModelConfig):
    """Per-bit-slot serve GEMV dims: one tuple of (K, N) pairs per slot
    (the AP pricer's input).  Hybrid and encdec entries are first-order,
    as in the reference: the shared attention block and the
    cross-attention projections are charged at their slot's bits."""
    _require_ported(cfg)
    d = cfg.d_model
    attn = ((d, cfg.n_heads * cfg.head_dim),
            (d, cfg.n_kv_heads * cfg.head_dim),
            (d, cfg.n_kv_heads * cfg.head_dim),
            (cfg.n_heads * cfg.head_dim, d))

    def mlp(f):
        if cfg.mlp_type == "swiglu":
            return ((d, f), (d, f), (f, d))
        return ((d, f), (f, d))

    if cfg.family in ("dense", "vlm"):
        return (attn + mlp(cfg.d_ff),) * cfg.n_layers
    if cfg.family == "moe":
        per = attn + cfg.experts_per_token * mlp(cfg.d_ff)
        if cfg.n_shared_experts:
            per = per + mlp(cfg.d_ff * cfg.n_shared_experts)
        return (per,) * cfg.n_layers
    d_inner, H, N, _ = mamba2.dims(cfg)
    mam = ((d, 2 * d_inner + 2 * N + H), (d_inner, d))    # in/out proj
    if cfg.family == "ssm":
        return (mam,) * cfg.n_layers
    if cfg.family == "hybrid":
        per = attn + mlp(cfg.d_ff) + mam * cfg.attn_every
        return (per,) * hybrid.n_super(cfg)
    enc = attn + mlp(cfg.d_ff)                             # encdec
    dec = attn + attn + mlp(cfg.d_ff)                     # self + cross
    return (enc,) * cfg.n_enc_layers + (dec,) * cfg.n_layers


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
    if cfg.family == "ssm":
        p["layers"] = mamba2.mamba_init(gen, cfg, lead=(cfg.n_layers,),
                                        device=dev)
    elif cfg.family == "hybrid":
        p["layers"] = hybrid.hybrid_init(gen, cfg, device=dev)
    elif cfg.family == "encdec":
        p["layers"] = encdec.encdec_init(gen, cfg, device=dev)
    else:
        p["layers"] = layer_init(gen, cfg, lead=(cfg.n_layers,), device=dev)
    if not cfg.tie_embeddings:
        p["head"] = cm.dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                  scale=cfg.d_model ** -0.5, device=dev)
    return p


def layer_init(gen: torch.Generator, cfg: ModelConfig, *, lead=(),
               device) -> dict:
    """One block's train-form parameters (``lead`` prepends stack dims):
    the dense block, with the MoE FFN as its ``mlp`` for moe."""
    blk = tf.block_init(gen, cfg, lead=lead, device=device)
    if cfg.family == "moe":
        blk["mlp"] = moe.moe_init(gen, cfg, lead=lead, device=device)
    return blk


# ---------------------------------------------------------------------------
# Serve-form quantization (rule-based traversal)
# ---------------------------------------------------------------------------

_EXPERT_KEYS = ("wg", "wu", "wd")
_FP_SUBTREES = ("router", "lora")        # precision-sensitive: keep bf16


@torch.no_grad()
def quantize_params(params: dict, cfg: ModelConfig,
                    container: str = "int8") -> dict:
    """Train-form -> serve-form.  Every linear {"w": (..., K, N)} becomes
    {"q"/"q4", "s"} with per-out-channel scales, stacked dims preserved;
    expert stacks (``(E, d, f)``, or ``(L, E, d, f)`` in a layer stack)
    quantize per expert to int8; the router, a hybrid's LoRA pairs,
    ``emb`` (a gather table), the norms and the Mamba conv and SSM
    parameters stay as they are.  It runs under ``torch.no_grad()``, as
    the engines' entry points do, so trained leaves that require grad
    record no graph."""
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
                        and getattr(v, "ndim", 0) >= 3):
                    out[k] = q_expert(v)
                else:
                    out[k] = rec(v, path + (k,))
            return out
        return node

    return rec(params, ("",))


def init_serve_params(cfg: ModelConfig, gen: torch.Generator, *,
                      device="cuda", container: str = "int8") -> dict:
    """Serve-form parameters drawn and quantized one layer at a time into
    preallocated ``(L, ...)`` stacks, so the train form of only one layer
    is ever resident (a MoE model's bf16 expert stacks may not fit beside
    its serve form).  The same layout and dtypes as
    ``quantize_params(init_params(...))``; the draws come in another
    order, so the values differ.  The recurrent and encoder-decoder
    families (whose train forms fit beside their serve forms) take
    ``quantize_params(init_params(...))``."""
    _require_ported(cfg)
    if cfg.family in ("ssm", "hybrid", "encdec"):
        return quantize_params(init_params(cfg, gen, device=device), cfg,
                               container)
    dev = cm.resolve_device(device)
    L = cfg.n_layers
    stacks = None

    def put(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, i)
            else:
                dst[k][i] = v

    for i in range(L):
        layer = quantize_params(layer_init(gen, cfg, device=dev), cfg,
                                container)
        if stacks is None:
            stacks = _map(lambda t: torch.empty((L,) + tuple(t.shape),
                                                dtype=t.dtype, device=dev),
                          layer)
        put(stacks, layer, i)
        del layer
    emb = torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen,
                      dtype=torch.float32, device=gen.device)
    p = {"emb": (emb * 0.02).to(cm.DTYPE).to(dev),
         "ln_f": cm.norm_init(cfg.d_model, cfg.norm_type, device=dev),
         "layers": stacks}
    del emb
    if not cfg.tie_embeddings:
        p["head"] = cm.quantize_linear(
            cm.dense_init(gen, cfg.d_model, cfg.padded_vocab,
                          scale=cfg.d_model ** -0.5, device=dev), container)
    return p


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# Stack
# ---------------------------------------------------------------------------

_layer = cm.stack_slice


def _dense_stack(layers, x, cfg, wvec, avec, positions, cache=None, t=None,
                 mlp_fn=None):
    """The layer loop, each layer one remat region when there is no cache
    (``common.remat``).  Returns (x, cache, the mean of the layers'
    aux)."""
    aux = []
    for i, lp in enumerate(cm.unstack(layers, cfg.n_layers)):
        cl = _layer(cache, i) if cache is not None else None

        def body(x, lp=lp, wb=wvec[i], ab=avec[i], cl=cl):
            y, _, a = tf.block(lp, x, cfg, wb, ab, positions=positions,
                               cache=cl, t=t, mlp_fn=mlp_fn)
            return y, a

        x, a = cm.remat(cfg, body, x, cache=cache)
        x = dist.constrain(x, ("dp", None, None))
        aux.append(a)
    return x, cache, torch.stack(aux).mean()


def _ssm_stack(layers, x, cfg, wvec, avec, cache=None):
    """The Mamba2 layer loop (each layer one remat region when there is
    no cache); the cache's conv and ssm states are updated in place.
    Returns (x, cache, 0)."""
    for i, lp in enumerate(cm.unstack(layers, cfg.n_layers)):
        if cache is None:
            x = cm.remat(cfg, lambda x, lp=lp, wb=wvec[i], ab=avec[i]:
                         mamba2.mamba_block(lp, x, cfg, wb, ab)[0], x)
            continue
        st = {"conv": cache["conv"][i], "ssm": cache["ssm"][i]}
        x, new_st = mamba2.mamba_block(lp, x, cfg, wvec[i], avec[i],
                                       state=st)
        x = dist.constrain(x, ("dp", None, None))
        cache["conv"][i] = new_st["conv"]
        cache["ssm"][i] = new_st["ssm"]
    return x, cache, torch.zeros((), dtype=torch.float32, device=x.device)


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
                   cache=None, t=None, enc_out=None):
    """Embedded inputs -> final hidden states.  Returns (h, cache, aux),
    aux the MoE load-balance loss averaged over the layers (0 for the
    other stacks).  encdec: the cross K/V come from ``cache["cross"]``
    when the cache holds them, else from ``enc_out``; the returned cache
    then holds them (this data rank's frames where the cache's spec
    shards them: ``encdec.keep_frames``)."""
    _require_ported(cfg)
    fam = cfg.family
    wvec = _layer_major(wvec, fam, x.device)
    avec = _layer_major(avec, fam, x.device)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if fam == "ssm":
        return _ssm_stack(params["layers"], x, cfg, wvec, avec, cache)
    if fam == "hybrid":
        h, new_cache = hybrid.hybrid_forward(
            params["layers"], x, cfg, wvec, avec, positions=positions,
            cache=cache, t=t)
        return h, new_cache, zero
    if fam == "encdec":
        kv_cache = cache["self"] if cache is not None else None
        if cache is not None and "cross" in cache:
            xkv = cache["cross"]
        else:
            xkv = encdec.cross_kv(params["layers"]["dec"], enc_out, cfg,
                                  wvec[-cfg.n_layers:], avec[-cfg.n_layers:])
        h, new_self = encdec.decoder_forward(
            params["layers"], x, cfg, wvec, avec, positions=positions,
            enc_kv=xkv, cache=kv_cache, t=t)
        new_cache = ({"self": new_self,
                      "cross": encdec.keep_frames(xkv, cfg)}
                     if cache is not None else None)
        return h, new_cache, zero
    return _dense_stack(params["layers"], x, cfg, wvec, avec, positions,
                        cache, t, mlp_fn=(moe.apply_moe if fam == "moe"
                                          else None))


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------

def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    if isinstance(params, shd.Local) and "emb" in params.layout:
        return _embed_sharded(params, tokens)
    return params["emb"][tokens]


def _emb_rows(params):
    """This rank's vocab rows of the table whole in ``d_model`` (an FSDP
    ``d_model`` shard is gathered), their first id, and the axes the
    vocab is split over (() when whole)."""
    _, (ve, de) = params.spec("emb")
    emb = params["emb"]
    mesh = params.mesh
    if de is not None:
        emb = mesh.gather_weight(emb, dist.entry_axes(de), -1)
    axes = dist.entry_axes(ve)
    return emb, mesh.index(axes) * emb.shape[0] if axes else 0, axes


def _emb_gathered_once(params):
    """``params`` with a tied table's FSDP (``d_model``) blocks gathered
    once, for the lookup and the head both: one gather, one gradient
    reduce-scatter (the vocab split stays)."""
    if not isinstance(params, shd.Local) or "emb" not in params.layout:
        return params
    shape, (ve, de) = params.layout["emb"]
    if de is None:
        return params
    emb = params.mesh.gather_weight(params["emb"], dist.entry_axes(de), -1)
    layout = {k: v for k, v in params.layout.items() if k != "emb"}
    if ve is not None:
        layout["emb"] = (shape, (ve, None))
    return shd.Local({**params, "emb": emb}, params.mesh, layout)


def _embed_sharded(params, tokens: torch.Tensor) -> torch.Tensor:
    """The lookup on a vocab-sharded table: each rank fills the tokens its
    rows hold and zeros elsewhere, and a SUM over the model axis adds the
    zeros to the one filled value (exact, in f32)."""
    emb, lo, axes = _emb_rows(params)
    if not axes:
        return emb[tokens]
    idx = tokens.long() - lo
    mine = (idx >= 0) & (idx < emb.shape[0])
    x = torch.where(mine[..., None], emb[idx.clamp(0, emb.shape[0] - 1)],
                    torch.zeros((), dtype=emb.dtype, device=emb.device))
    x = x.float()
    return params.mesh.all_reduce(x, axes, "sum",
                                  kind="embed").to(emb.dtype)


def vocab_split(params, cfg: ModelConfig):
    """``(mesh, axes)`` of the model axis the head's vocab columns are
    split over (the tied table's rows or the head's columns), or ``(None,
    ())`` when every rank holds every column."""
    if not isinstance(params, shd.Local):
        return None, ()
    if cfg.tie_embeddings:
        if "emb" not in params.layout:
            return None, ()
        _, (ve, _) = params.spec("emb")
    else:
        head = params["head"]
        if not isinstance(head, shd.Local) or "w" not in head.layout:
            return None, ()
        _, (_, ve) = head.spec("w")
    if ve is None or not dist.is_tp_entry(ve):
        return None, ()
    return params.mesh, dist.entry_axes(ve)


def logits_fn(params, h: torch.Tensor, cfg: ModelConfig, wb=8, ab=8, *,
              rows_alone: bool = True, vocab_local: bool = False
              ) -> torch.Tensor:
    """Final norm and head -> f32 logits, padding ids masked.  A tied head
    takes one token row at a time unless ``rows_alone`` is False (the
    train loss: one matmul, whose gradient reaches ``emb`` once).  With
    ``vocab_local`` a head whose vocab the model axis splits
    (:func:`vocab_split`) returns this rank's columns only."""
    h = cm.apply_norm(params["ln_f"], h, cfg.norm_type, cfg.norm_eps)
    lo = 0
    if cfg.tie_embeddings:
        sharded = isinstance(params, shd.Local) and "emb" in params.layout
        emb, lo, axes = (_emb_rows(params) if sharded
                         else (params["emb"], 0, ()))
        if axes:        # every model rank's h feeds its own columns; its
            # partial gradient stays float32 through the SUM
            h = params.mesh.enter(h.float(), axes)
        emb = emb.float().T
        if not rows_alone:
            logits = h.float() @ emb
        else:
            # one token row at a time: a float matmul sums in an order
            # that may depend on its row count, and a request's logits
            # must not depend on its batch (decode tick, verify chunk,
            # alone)
            rows = h.float().reshape(-1, h.shape[-1])
            logits = torch.cat([rows[i:i + 1] @ emb
                                for i in range(rows.shape[0])])
            logits = logits.reshape(h.shape[:-1] + (emb.shape[1],))
        if axes and not vocab_local:    # this rank's columns -> every one
            logits = dist.constrain(logits, ("dp", None, None),
                                    have=("dp", None, "tp"))
            lo = 0
    else:
        mesh, axes = vocab_split(params, cfg)
        if axes and vocab_local:
            logits = cm.apply_linear(params["head"], h, wb, ab,
                                     local_out=True).float()
            lo = mesh.index(axes) * logits.shape[-1]
        else:
            logits = cm.apply_linear(params["head"], h, wb, ab).float()
    if cfg.padded_vocab != cfg.vocab_size:       # mask padding ids
        pad = torch.arange(lo, lo + logits.shape[-1], device=h.device) \
            >= cfg.vocab_size
        logits = torch.where(pad, -1e30, logits)
    return logits


def _xent(logits: torch.Tensor, targets: torch.Tensor,
          mask: torch.Tensor, mesh=None, axes=()):
    """Masked mean token cross-entropy and the z-loss (the mean squared
    log-partition), both over ``max(sum(mask), 1)``.

    ``axes`` of ``mesh`` split the vocab: ``logits`` are this rank's
    columns, the log-partition is a MAX and a SUM of ``exp`` over them,
    and the gold logit comes from the rank that holds its column.  Under
    ``kops.split_rows`` the rows are this data rank's and the mask count
    is the batch's (a SUM over the data axis), so the returned means are
    this rank's shares of the batch's."""
    if axes:
        V = logits.shape[-1]
        m = mesh.all_reduce(logits.detach().amax(dim=-1), axes, "max",
                            kind="xent_max")
        se = mesh.all_reduce(torch.exp(logits - m[..., None]).sum(dim=-1),
                             axes, "sum", kind="xent_sum")
        logz = torch.log(se) + m
        t = targets.long() - mesh.index(axes) * V
        mine = (t >= 0) & (t < V)
        g = torch.gather(logits, -1, t.clamp(0, V - 1)[..., None])[..., 0]
        gold = mesh.all_reduce(torch.where(mine, g, 0.0), axes, "sum",
                               kind="xent_gold")
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = (logz - gold) * mask
    denom = _mask_count(mask).clamp_min(1.0)
    zloss = ((logz * mask) ** 2).sum() / denom
    return nll.sum() / denom, zloss


def _mask_count(mask: torch.Tensor) -> torch.Tensor:
    """The batch's loss-mask count: under ``kops.split_rows`` a SUM of the
    data ranks' counts."""
    count = mask.sum()
    rows = kops.rows_split_mesh()
    if rows is not None:
        count = rows.all_reduce(count, rows.dp_axes, "sum",
                                kind="mask_count")
    return count


def train_loss(params, batch: dict, cfg: ModelConfig, wvec, avec
               ) -> Tuple[torch.Tensor, dict]:
    """Next-token loss of the train form: ``(total, {"loss", "zloss",
    "moe_aux"})`` with ``total = loss + 1e-4 zloss + MOE_AUX_COEF aux``.

    ``batch["tokens"]`` (B, S+1) gives S inputs and S targets;
    ``batch["loss_mask"]`` (B, S) optionally weights the targets.  A vlm
    batch's ``prefix`` (B, P, d) goes in front of the inputs with zero
    mask and zero targets; an encdec batch's ``frames`` (B, F, d) run
    through the encoder.  Every tensor moves to the parameters' device.
    Sequences longer than ``transformer.FLASH_THRESHOLD`` (with the
    prefix) reach the flash kernel on the card, which has no backward and
    raises under grad mode."""
    _require_ported(cfg)
    dev = params["emb"].device
    if cfg.tie_embeddings:
        params = _emb_gathered_once(params)
    tokens = torch.as_tensor(batch["tokens"]).to(dev)
    B = tokens.shape[0]
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    mask = batch.get("loss_mask")
    mask = (torch.ones(tgt.shape, dtype=torch.float32, device=dev)
            if mask is None else torch.as_tensor(mask).to(dev, torch.float32))
    x = embed(params, inp)
    enc_out = None
    if cfg.family == "vlm":
        prefix = torch.as_tensor(batch["prefix"]).to(dev, cm.DTYPE)
        P = prefix.shape[1]
        x = torch.cat([prefix, x], dim=1)
        mask = torch.cat([torch.zeros((B, P), dtype=torch.float32,
                                      device=dev), mask], dim=1)
        tgt = torch.cat([torch.zeros((B, P), dtype=tgt.dtype, device=dev),
                         tgt], dim=1)
    elif cfg.family == "encdec":
        frames = torch.as_tensor(batch["frames"]).to(dev, cm.DTYPE)
        enc_out = encdec.encode(params["layers"], frames, cfg,
                                _layer_major(wvec, cfg.family, dev),
                                _layer_major(avec, cfg.family, dev))
    x = dist.constrain(x, ("dp", None, None))
    Sx = x.shape[1]
    positions = torch.arange(Sx, dtype=torch.int32,
                             device=dev)[None].expand(B, Sx)
    h, _, aux = forward_hidden(params, x, cfg, wvec, avec,
                               positions=positions, enc_out=enc_out)
    logits = logits_fn(params, h, cfg, _last_layer_bits(wvec),
                       _last_layer_bits(avec), rows_alone=False,
                       vocab_local=True)
    loss, zloss = _xent(logits, tgt, mask, *vocab_split(params, cfg))
    total = loss + 1e-4 * zloss + MOE_AUX_COEF * aux
    return total, {"loss": loss, "zloss": zloss, "moe_aux": aux}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def empty_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                device="cuda", mesh=None, split_rows: bool = True) -> dict:
    """The family's empty cache: the stacked KV ring (attention
    families), the Mamba states (ssm), both (hybrid), or the decoder's KV
    ring and the cross K/V at ``max_len // frames_ratio`` frames
    (encdec; prefill replaces the cross K/V with the encoder's).

    On a ``mesh``: this rank's block of the ``batch``-row cache as
    ``dist.sharding.cache_shardings`` lays it out: rows over the data
    axis (``split_rows=False`` keeps every row, for a row every rank
    computes), KV heads or the head dim over the model axis, or, where
    the rows do not split over the data ranks and the sequence does,
    each data rank's slice of the sequence (``kpos`` whole:
    ``transformer``'s sequence-sharded cache; an encdec cross cache's
    frames, an ``encdec.FrameSlice``); the Mamba states' heads
    and conv channels over the model axis (a row that does not split
    keeps its state whole on every data rank)."""
    _require_ported(cfg)
    dev = cm.resolve_device(device)
    if mesh is not None:
        return _mesh_cache(cfg, batch, max_len, dev, mesh, split_rows)
    if cfg.family == "ssm":
        return mamba2.empty_state(cfg, batch, cfg.n_layers, device=dev)
    if cfg.family == "hybrid":
        return hybrid.empty_hybrid_cache(cfg, batch, max_len, device=dev)
    if cfg.family == "encdec":
        frames = max(max_len // cfg.frames_ratio, 1)
        shape = (cfg.n_layers, batch, frames, cfg.n_kv_heads, cfg.head_dim)
        return {"self": tf.empty_cache(cfg, batch, max_len, device=dev),
                "cross": {"k": torch.zeros(shape, dtype=cm.DTYPE,
                                           device=dev),
                          "v": torch.zeros(shape, dtype=cm.DTYPE,
                                           device=dev)}}
    return tf.empty_cache(cfg, batch, max_len, device=dev)


def _mesh_cache(cfg, batch, max_len, dev, mesh, split_rows) -> dict:
    """This rank's blocks of the family's whole cache (built on the meta
    device) as ``dist.sharding.cache_shardings`` lays them out;
    ``split_rows=False`` drops the data-axis entries (rows and sequence
    every rank keeps whole)."""
    whole = empty_cache(cfg, batch, max_len, device="meta")
    specs = shd.cache_shardings(whole, mesh)

    def rec(node, spec_node):
        out = {}
        for name, t in node.items():
            if isinstance(t, dict):
                out[name] = rec(t, spec_node[name])
                continue
            spec = [e if e is None or split_rows or dist.is_tp_entry(e)
                    else None for e in spec_node[name]]
            shape = dist.local_shape(mesh, spec, t.shape)
            fill = tf.EMPTY_POS if name == "kpos" else 0
            out[name] = torch.full(shape, fill, dtype=t.dtype, device=dev)
        return out
    out = rec(whole, specs)
    if (cfg.family == "encdec" and split_rows
            and specs["cross"]["k"][2] is not None):
        out["cross"] = encdec.FrameSlice(out["cross"])  # frames over dp
    return out


def _last_layer_bits(vec):
    """Bits for the head GEMM: scalar for (L,) tables, (B,) for (B, L)."""
    return torch.as_tensor(vec)[..., -1]


def prefill(params, batch: dict, cfg: ModelConfig, wvec, avec, cache: dict,
            lengths=None) -> Tuple[torch.Tensor, dict]:
    """Full-context forward filling ``cache`` (in place); returns the
    last-token logits (B, 1, V) and the cache.

    ``lengths`` (B,) marks per-row valid prompt lengths of a right-padded
    batch (continuous batching): padded positions take EMPTY_POS (never
    visible to real queries nor in the cache) and zeroed embeddings, and
    each row's logits are gathered at its own last real token.  A vlm
    batch's ``prefix`` (B, P, d) goes in front of the tokens: the cache
    then holds P + S positions, and each row's valid length is P +
    ``lengths``.  An encdec batch's ``frames`` (B, F, d) run through the
    encoder, and the cache's cross K/V are rebuilt from its output."""
    _require_ported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed(params, tokens)
    prefix_len = 0
    enc_out = None
    if cfg.family == "vlm":
        prefix = torch.as_tensor(batch["prefix"]).to(x.device, cm.DTYPE)
        prefix_len = prefix.shape[1]
        x = torch.cat([prefix, x], dim=1)
    elif cfg.family == "encdec":
        frames = torch.as_tensor(batch["frames"]).to(x.device, cm.DTYPE)
        enc_out = encdec.encode(
            params["layers"], frames, cfg,
            _layer_major(wvec, cfg.family, x.device),
            _layer_major(avec, cfg.family, x.device))
        cache = {"self": cache["self"]}        # cross is rebuilt from enc_out
    Sx = x.shape[1]
    if lengths is None:
        # (1, Sx): rows share positions, so attention keeps one (Sx, Sx)
        # mask
        positions = torch.arange(Sx, dtype=torch.int32,
                                 device=x.device)[None]
    else:
        if cfg.family not in RAGGED_PREFILL_FAMILIES:
            raise NotImplementedError(
                f"ragged (per-row lengths) prefill is not supported for "
                f"family {cfg.family!r}")
        if Sx > tf.FLASH_THRESHOLD:
            raise NotImplementedError(
                f"ragged prefill uses the masked-SDPA path; keep the padded "
                f"prompt length <= {tf.FLASH_THRESHOLD}")
        lens = torch.as_tensor(lengths, dtype=torch.int32).to(
            x.device).reshape(B) + prefix_len
        pos = torch.arange(Sx, dtype=torch.int32, device=x.device)[None]
        valid = pos < lens[:, None]                       # (B, Sx)
        positions = torch.where(valid, pos, tf.EMPTY_POS).to(torch.int32)
        # zero pad embeddings so per-row dynamic activation scales see only
        # real tokens
        x = torch.where(valid[..., None], x, 0).to(x.dtype)
    h, new_cache, _ = forward_hidden(params, x, cfg, wvec, avec,
                                     positions=positions, cache=cache,
                                     enc_out=enc_out)
    if lengths is None:
        h_last = h[:, -1:]
    else:
        idx = (lens - 1).clamp_min(0).long()
        h_last = h[torch.arange(B, device=x.device), idx][:, None]
    return (logits_fn(params, h_last, cfg, _last_layer_bits(wvec),
                      _last_layer_bits(avec)), new_cache)


def decode_step(params, tok: torch.Tensor, t, cache: dict, cfg: ModelConfig,
                wvec, avec) -> Tuple[torch.Tensor, dict]:
    """One decode step: tok (B, 1) int, t scalar or (B,) positions.
    Returns (logits (B, 1, V), cache) with the cache updated in place."""
    B = tok.shape[0]
    x = embed(params, tok)
    t = torch.as_tensor(t, dtype=torch.int32).to(x.device)
    positions = t.expand(B)[:, None]                      # (B, 1)
    h, new_cache, _ = forward_hidden(params, x, cfg, wvec, avec,
                                     positions=positions, cache=cache, t=t)
    return (logits_fn(params, h, cfg, _last_layer_bits(wvec),
                      _last_layer_bits(avec)), new_cache)


def decode_chunk(params, toks: torch.Tensor, t, cache: dict,
                 cfg: ModelConfig, wvec, avec) -> Tuple[torch.Tensor, dict]:
    """Decode U consecutive positions per row in one forward.

    ``toks`` (B, U) with ``toks[:, i]`` at position ``t + i`` (``t``
    scalar or (B,)).  This is the speculative verify step: the chunked
    attention branch writes the ring slots sequential decode would, each
    query sees exactly its ``kpos <= pos`` prefix, and activations
    quantize under per-token scales (``ops.token_scale_mode``), so on
    the per-row bit-matrix path the logits are those of U sequential
    :func:`decode_step` calls.  Returns (logits (B, U, V), cache), the
    cache updated in place."""
    _require_ported(cfg)
    if cfg.family not in SPEC_CHUNK_FAMILIES:
        raise NotImplementedError(
            f"chunked decode is implemented for the attention families "
            f"{SPEC_CHUNK_FAMILIES}, not {cfg.family!r}")
    B, U = toks.shape
    x = embed(params, toks)
    t = torch.as_tensor(t, dtype=torch.int32).to(x.device)
    positions = (t.expand(B)[:, None]
                 + torch.arange(U, dtype=torch.int32, device=x.device)[None])
    with kops.token_scale_mode():
        h, new_cache, _ = forward_hidden(params, x, cfg, wvec, avec,
                                         positions=positions, cache=cache,
                                         t=t)
        logits = logits_fn(params, h, cfg, _last_layer_bits(wvec),
                           _last_layer_bits(avec))
    return logits, new_cache


# ---------------------------------------------------------------------------
# Slot-based persistent cache pool (continuous batching)
# ---------------------------------------------------------------------------

class CachePool:
    """A persistent, slot-based KV cache for continuous batching.

    The pool owns ONE cache of batch capacity ``n_slots`` on ``device``
    that lives across requests: :meth:`alloc` hands out a free slot,
    :meth:`write_row` installs a freshly prefilled single-row cache into
    it, :meth:`free` / :meth:`reset_slot` recycle it.  Per-slot valid
    lengths and the free list live on the host.  Visibility inside
    attention is carried by the per-row ``kpos`` columns, so a reset slot
    is invisible by construction (EMPTY_POS) rather than by zeroing data.
    Every install copies the incoming row into the pool; the pool never
    holds a reference to a caller's tensors.

    ``rows=(lo, hi)`` makes this one rank's part of a pool whose rows are
    split across a data mesh: the cache holds only slots ``lo..hi-1``
    (slot ``s`` at cache row ``s - lo``), while the slot bookkeeping (free
    list, lengths) covers all ``n_slots`` and runs identically on every
    rank.  An install into a slot another rank owns records its length
    and copies nothing.  With ``mesh=`` the cache takes
    ``dist.sharding.cache_shardings``' layout (rows over the data axis,
    KV heads or the head dim over the model axis; ``rows`` must then be
    this data rank's block), and :meth:`copy_row` moves a row between
    slots that different data ranks own by a broadcast along the data
    axis.  With ``mesh=`` and no ``rows`` (slots that do not split over
    the data ranks) every rank holds every slot, and the cache takes the
    sequence-sharded layout where the ring divides (``transformer``):
    each data rank keeps its slice of every slot's k/v (int8 values and
    scales alike) and ``kpos`` whole.  The installs then cut a whole
    single-row cache (a prefill's, a prefix-cache entry's) to this
    rank's slice; :meth:`copy_row`, :meth:`reset_slot` and
    :meth:`rollback` act on ``kpos`` whole and the local slice.
    """

    def __init__(self, cfg: ModelConfig, n_slots: int, max_len: int, *,
                 device="cuda", rows: Optional[Tuple[int, int]] = None,
                 mesh=None):
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.device = cm.resolve_device(device)
        self.mesh = mesh
        lo, hi = (0, n_slots) if rows is None else rows
        if not 0 <= lo < hi <= n_slots:
            raise ValueError(f"rows [{lo}, {hi}) not inside the pool's "
                             f"{n_slots} slots")
        self.rows = (lo, hi)
        if mesh is not None:
            self.cache = empty_cache(cfg, n_slots, max_len,
                                     device=self.device, mesh=mesh)
            if self.cache["kpos"].shape[1] != hi - lo:
                raise ValueError(
                    f"rows [{lo}, {hi}) are not the mesh's block of "
                    f"{self.cache['kpos'].shape[1]} rows")
        else:
            self.cache = empty_cache(cfg, hi - lo, max_len,
                                     device=self.device)
        self.lengths = np.zeros((n_slots,), np.int64)
        self._free = list(range(n_slots - 1, -1, -1))

    def owns(self, slot: int) -> bool:
        """Whether ``slot``'s cache row lives in this pool."""
        return self.rows[0] <= slot < self.rows[1]

    @property
    def free_slots(self) -> int:
        return len(self._free)

    def alloc(self) -> Optional[int]:
        """Claim a free slot (None when the pool is full)."""
        return self._free.pop() if self._free else None

    def free(self, slot: int) -> None:
        """Return a slot to the pool and mask its cache row."""
        if slot in self._free:
            raise ValueError(f"slot {slot} double-freed")
        self.reset_slot(slot)
        self._free.append(slot)

    def reset_slot(self, slot: int) -> None:
        """Mask a slot's cache row (kpos -> EMPTY_POS) and zero its length."""
        self.lengths[slot] = 0
        if self.owns(slot):
            self.cache["kpos"][:, slot - self.rows[0]] = tf.EMPTY_POS

    def _check_install(self, slot: int, length: int) -> None:
        """Guard every row install: an out-of-range length poisons the
        host-side length table, and a write into an unallocated slot is
        clobbered by the next ``alloc``."""
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range "
                             f"[0, {self.n_slots})")
        if slot in self._free:
            raise ValueError(f"slot {slot} is free — alloc() it before "
                             f"installing a row")
        if not 0 <= length <= self.max_len:
            raise ValueError(f"row length {length} not in "
                             f"[0, max_len={self.max_len}]")

    def _install(self, row_cache: Optional[dict], slot: int,
                 keep=None) -> None:
        if not self.owns(slot):
            return
        for name, dst in self.cache.items():
            src = row_cache[name]
            if name != "kpos" and tf.seq_sharded(self.cache):
                src = self.mesh.local_block(src, self.mesh.dp_axes, 2)
            if src.shape[0] != dst.shape[0] or src.shape[1] != 1 \
                    or src.shape[2:] != dst.shape[2:]:
                raise ValueError(
                    f"row cache {name!r} {tuple(src.shape)} does not fit "
                    f"the pool's {tuple(dst.shape)} as one row")
            src = src[:, 0].to(dst.device, dst.dtype)
            if keep is not None and name == "kpos":
                src = torch.where(src >= keep, tf.EMPTY_POS, src)
            dst[:, slot - self.rows[0]] = src             # a copy

    def write_row(self, row_cache: Optional[dict], slot: int,
                  length: int) -> None:
        """Install (copy) a prefilled single-row cache into ``slot`` (None
        for a slot another rank owns)."""
        self._check_install(slot, length)
        self.lengths[slot] = length
        self._install(row_cache, slot)

    def install_prefix(self, row_cache: dict, slot: int, keep: int) -> None:
        """Install the first ``keep`` tokens of a cached single-row cache
        into ``slot``: positions >= ``keep`` are masked EMPTY on the way
        in, and the source row is copied, never aliased."""
        self._check_install(slot, keep)
        self.lengths[slot] = keep
        self._install(row_cache, slot, keep)

    def rollback(self, keeps) -> None:
        """Mask every cache entry past ``keeps[slot]`` per slot (the
        speculative-decode rejection path): ``kpos > keep`` becomes
        EMPTY_POS in every layer.  ``keeps`` is an ``(n_slots,)`` vector
        of last-kept absolute positions; a slot passing a value >=
        EMPTY_POS is untouched.  K/V payloads stay in place, masked."""
        kpos = self.cache["kpos"]
        keeps = torch.as_tensor(keeps).to(kpos.device, torch.int64)
        keeps = keeps[self.rows[0]:self.rows[1]]
        kpos.masked_fill_(kpos.long() > keeps[None, :, None], tf.EMPTY_POS)

    def copy_row(self, src: int, dst: int,
                 length: Optional[int] = None) -> None:
        """Duplicate one resident row into another allocated slot."""
        if src in self._free:
            raise ValueError(f"source slot {src} is free — nothing to "
                             f"copy")
        n = int(self.lengths[src] if length is None else length)
        self._check_install(dst, n)
        lo, hi = self.rows
        self.lengths[dst] = n
        if src // (hi - lo) == dst // (hi - lo):
            if src != dst and self.owns(dst):
                for buf in self.cache.values():
                    buf[:, dst - lo] = buf[:, src - lo].clone()
            return
        if self.mesh is None:
            raise NotImplementedError(
                f"slots {src} and {dst} live on different ranks' rows: "
                f"moving a row across ranks needs the pool's mesh")
        # every data rank of the line joins the broadcast from src's owner
        owner = src // (hi - lo)
        for buf in self.cache.values():
            row = buf[:, src - lo] if self.owns(src) else \
                torch.empty_like(buf[:, 0])
            got = self.mesh.broadcast(row, owner, kind="move_row")
            if self.owns(dst):
                buf[:, dst - lo] = got.to(buf.device)

    def move_row(self, row_cache: Optional[dict], holder: int,
                 slot: int) -> Optional[dict]:
        """A single-row cache held by data rank ``holder`` (None on the
        others), broadcast to ``slot``'s owner along the data axis; returns
        it there and None elsewhere.  Every data rank calls it."""
        lo, hi = self.rows
        mine = self.mesh.dp_index == holder
        owner = slot // (hi - lo)
        out = {}
        for name in sorted(self.cache):
            ref = self.cache[name][:, :1]
            src = row_cache[name] if mine else torch.empty_like(ref)
            got = self.mesh.broadcast(src, holder, kind="move_row")
            out[name] = got.to(self.device)
        return out if self.mesh.dp_index == owner else None

"""Shared building blocks: norms, RoPE, masks, the bit-fluid linear, init
helpers, devices.

The counterpart of ``repro.models.common``.  Every
linear is a dict ``{"w": (K, N) [, "b": (N,)]}`` in training form, or
``{"q": int8 (K, N), "s": f32 (1, N) [, "b"]}`` (int8 container) /
``{"q4": uint8 (K, N/2), "s": ...}`` (packed int4 container) in serving
form; :func:`apply_linear` dispatches on the keys.  A serve-form linear
may also carry ``lora_delta`` (K, N) bf16, a hybrid's per-site LoRA,
added as a side branch (:func:`lora_side`).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from repro_torch.core import bitfluid as bf
from repro_torch.dist import api as dist
from repro_torch.dist import sharding as shd
from repro_torch.kernels import ops as kops

DTYPE = torch.bfloat16


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asked for
    another.  A CUDA device with no GPU present raises — entry points never
    carry on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device "
                           f"is available (pass device='cpu' to run on the "
                           f"CPU)")
    return dev


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, scale: Optional[float] = None,
               lead: Tuple[int, ...] = (), device) -> dict:
    """bf16 Normal(0, scale) weights (scale defaults to d_in^-1/2), zero
    bias; ``lead`` prepends stack dims (``(L,)`` for a layer stack).
    ``device`` is required: the entry points resolve it.

    The normals are drawn from ``gen`` on the generator's own device, so
    a CPU generator gives the same weights on every device, and a CUDA
    generator draws full-width stacks on the card."""
    w_scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn(tuple(lead) + (d_in, d_out), generator=gen,
                    dtype=torch.float32, device=gen.device)
    p = {"w": (w * w_scale).to(DTYPE).to(device)}
    if bias:
        p["b"] = torch.zeros(tuple(lead) + (d_out,), dtype=DTYPE,
                             device=device)
    return p


def quantize_linear(p: dict, container: str = "int8") -> dict:
    """Training-form linear -> serving-form (int8 or packed-int4 container).

    Scales are per-out-channel along the reduction axis (``axis=-2``), so a
    stacked ``(G, K, N)`` weight quantizes each slice independently."""
    w = p["w"].float()
    out = {}
    if container == "int4":
        s = bf.symmetric_scale(w, 4, axis=-2)
        out["q4"] = bf.pack_int4_halves(bf.quantize(w, s, 4))
        out["s"] = s
    else:
        s = bf.symmetric_scale(w, 8, axis=-2)
        out["q"] = bf.quantize(w, s, 8)
        out["s"] = s
    if "b" in p:
        out["b"] = p["b"]
    return out


# ---------------------------------------------------------------------------
# The bit-fluid linear
# ---------------------------------------------------------------------------

def apply_linear(p: dict, x: torch.Tensor, wbits=8, abits=8, *,
                 local_out: bool = False) -> torch.Tensor:
    """y = x @ W (+b) at runtime precisions; dispatches train/serve forms.

    ``wbits``/``abits`` are scalars (shared precision) or ``(B,)`` vectors
    matching ``x``'s leading axis (per-request precision).  Serve-form
    containers go wholesale through :func:`repro_torch.kernels.ops.
    serve_linear`; the train form is the bf16 fake-quant STE below.

    A linear placed on a mesh (``dist.sharding.Local``) runs
    :func:`repro_torch.kernels.ops.sharded_linear` in the serve form and
    :func:`_train_linear_local` in the train form: ``local_out`` keeps a
    column-parallel result as this rank's columns (the first half of a
    Megatron pair), and ``x`` may be this rank's slice of a row-parallel
    weight's reduction dim.  A train-form one at per-row bits is gathered
    whole."""
    per_row = (getattr(wbits, "ndim", 0) >= 1
               or getattr(abits, "ndim", 0) >= 1)
    if isinstance(p, shd.Local):
        if "w" in p and not per_row:
            return _train_linear_local(p, x, wbits, abits, local_out)
        if "w" in p:
            p = shd.full(p)
        elif "lora_delta" in p:
            return _lora_linear_local(p, x, wbits, abits, local_out)
        else:
            y = kops.sharded_linear(p, x, wbits, abits, local_out=local_out)
            return y.to(DTYPE)
    K = next(p[k] for k in ("w", "q", "q4") if k in p).shape[-2]
    if x.shape[-1] != K:
        # this model rank's slice of the reduction dim, before a whole
        # weight: every rank's slice, gathered
        lead = (None,) * (x.ndim - 1)
        x = dist.constrain(x, lead + (None,), have=lead + ("tp",))
    if "w" in p:                                     # train: fake-quant STE
        if per_row:
            B = x.shape[0]
            wb = torch.as_tensor(wbits, dtype=torch.int32).expand(B)
            ab = torch.as_tensor(abits, dtype=torch.int32).expand(B)
            return torch.cat([_train_linear(p, x[i:i + 1], wb[i], ab[i])
                              for i in range(B)])
        return _train_linear(p, x, wbits, abits)
    y = kops.serve_linear(p, x, wbits, abits)
    if "lora_delta" in p:
        # a hybrid's per-site LoRA around the shared quantized base: the
        # bf16 (K, N) delta A @ B as a side branch, added in f32 before
        # the bf16 cast (the reference attaches it and never reads it:
        # ROADMAP Queue C)
        y = y + lora_side(x, p["lora_delta"])
    return y.to(DTYPE)


def lora_side(x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """``x @ delta`` of bf16 values, summed in float64 and rounded to
    float32.  The bf16 x bf16 products are exact in float64 and its sums
    carry 29 bits more than float32's, so the rounded result does not
    depend on the order a library's kernel sums in, which on the card
    changes with the rows or the column block beside it: one device, a
    data rank's rows and a model rank's columns give the same values."""
    return (x.double() @ delta.double()).float()


def _lora_linear_local(p, x: torch.Tensor, wbits, abits,
                       local_out: bool) -> torch.Tensor:
    """A placed serve-form linear with a hybrid's ``lora_delta``, EQUAL to
    :func:`apply_linear` of the whole linear: the side branch
    (:func:`lora_side`) is added before the bf16 cast, as one device adds
    it.

    A column-parallel base carries the delta's columns of this model
    rank (``layout`` says so): the side branch is this rank's columns,
    added to the local ones before they are gathered.  Any other base
    (row-parallel, or whole in N) carries the whole delta: its input's
    model-axis slices are gathered whole and the side branch, one
    device's product, is added after the reduced sum."""
    delta = p["lora_delta"]
    base = shd.Local({k: v for k, v in p.items() if k != "lora_delta"},
                     p.mesh, {k: v for k, v in p.layout.items()
                              if k != "lora_delta"})
    _, (_, de) = p.spec("lora_delta")
    if de is not None:                                  # column-parallel
        y = kops.sharded_linear(base, x, wbits, abits, local_out=True)
        y = (y + lora_side(x, delta)).to(DTYPE)
        if local_out:
            return y
        return p.mesh.all_gather(y, dist.entry_axes(de), dim=-1,
                                 kind="gather_cols")
    y = kops.sharded_linear(base, x, wbits, abits, local_out=local_out)
    if x.shape[-1] != delta.shape[-2]:
        lead = (None,) * (x.ndim - 1)
        x = dist.constrain(x, lead + (None,), have=lead + ("tp",))
    return (y + lora_side(x, delta)).to(DTYPE)


def local_linear(p: dict, x: torch.Tensor, wbits=8, abits=8
                 ) -> torch.Tensor:
    """:func:`apply_linear` keeping a column-parallel result as this
    model rank's columns (the first half of a Megatron pair); off a model
    axis, :func:`apply_linear` as it is."""
    if dist.tp_size() > 1:
        return apply_linear(p, x, wbits, abits, local_out=True)
    return apply_linear(p, x, wbits, abits)


class _F32InputGrad(torch.autograd.Function):
    """The identity on a product ``y``; the gradient of its float32 input
    ``x32`` is ``dy @ w^T`` taken in float32 (a column-parallel partial,
    SUMmed over the model axis before it rounds once)."""

    @staticmethod
    def forward(ctx, y, x32, w):
        ctx.save_for_backward(w)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, dy):
        w, = ctx.saved_tensors
        return dy, dy.float() @ w.float().transpose(-1, -2), None


def _train_linear(p: dict, x: torch.Tensor, wbits, abits,
                  grad_f32: bool = False) -> torch.Tensor:
    """Scalar-bits fake-quant (STE) linear, bf16 around the product.

    ``grad_f32`` (a float32 ``x`` holding bf16 values): the same bf16
    product, but ``x``'s gradient leaves it in float32
    (:class:`_F32InputGrad`; the straight-through estimator passes it as
    it is)."""
    w = bf.fake_quant(p["w"], wbits, axis=0)
    xq = bf.fake_quant(x.to(DTYPE), abits, reduce=kops.tensor_amax_reduce())
    if grad_f32:
        y = _F32InputGrad.apply(torch.matmul(xq.detach(), w), x,
                                w.detach()).float()
    else:
        y = torch.matmul(xq, w).float()
    if "b" in p:
        y = y + p["b"].float()
    return y.to(DTYPE)


def column_parallel(p) -> bool:
    """Whether a placed linear keeps model-axis columns: its consumers of
    one input may share one gradient SUM (``dist.api.Mesh.enter``)."""
    if not isinstance(p, shd.Local):
        return False
    leaf = next((k for k in ("w", "q", "q4") if k in p), None)
    return leaf is not None and dist.is_tp_entry(p.spec(leaf)[1][-1])


def _train_linear_local(p, x: torch.Tensor, wbits, abits,
                        local_out: bool) -> torch.Tensor:
    """The fake-quant linear of a train-form weight placed on a mesh,
    equal in value to :func:`_train_linear` of the whole weight.

    FSDP (data-axis) blocks are all-gathered, so their gradients
    reduce-scatter back.  A column-parallel weight keeps its model-axis
    columns: ``x`` enters the region (its gradient SUMs over the model
    axis in float32 and rounds to bf16 once, as one device's whole
    product rounds it), the bias is sliced to the columns, and the
    output columns are gathered unless ``local_out``.  A row-parallel weight keeps its rows:
    ``x`` is (or is sliced to) this rank's part of the reduction dim, the
    activation amax and each column's weight amax are MAX-reduced over the
    model axis in one collective, so both quantize on the whole tensor's
    scales, and the partial products, taken in f32, are SUMmed before the
    bias."""
    mesh = p.mesh
    (K, _), (ke, ne) = p.spec("w")
    w = p["w"]
    if ke is not None and not dist.is_tp_entry(ke):
        w, ke = mesh.gather_weight(w, dist.entry_axes(ke), -2), None
    if ne is not None and not dist.is_tp_entry(ne):
        w, ne = mesh.gather_weight(w, dist.entry_axes(ne), -1), None
    b = shd.gather_leaf(p, "b") if "b" in p else None
    whole = {"w": w} if b is None else {"w": w, "b": b}
    if ke is None and x.shape[-1] != K:
        lead = (None,) * (x.ndim - 1)
        x = dist.constrain(x, lead + (None,), have=lead + ("tp",))
    if ne is not None:                              # column-parallel
        axes = dist.entry_axes(ne)
        # this rank's columns give a partial gradient of x: it stays
        # float32 through the SUM (an x entered in float32 already, by
        # dist.enter_tp, is not entered again)
        f32 = x.requires_grad and torch.is_grad_enabled()
        x = mesh.enter(x.float() if f32 else x, axes)
        if b is not None:
            whole["b"] = mesh.local_block(mesh.enter(b, axes), axes, -1)
        y = _train_linear(whole, x, wbits, abits, grad_f32=f32)
        if local_out:
            return y
        return mesh.all_gather(y, axes, dim=-1, kind="gather_cols")
    if ke is None:                                  # replicated
        return _train_linear(whole, x, wbits, abits)
    axes = dist.entry_axes(ke)                      # row-parallel
    if x.shape[-1] == K:
        x = mesh.local_block(mesh.enter(x, axes), axes, -1)
    x = x.to(DTYPE)
    # the activation's amax and each weight column's, MAX-reduced in one
    # collective over the model axis (and the data axis when the rows are
    # split: the weight's columns are alike there)
    rows = kops.rows_split_mesh()
    red = axes + (rows.dp_axes if rows is mesh else ())
    amax = mesh.all_reduce(torch.cat([
        x.detach().abs().amax().float().reshape(1),
        w.detach().abs().amax(dim=0).float()]), red, "max", kind="amax_tp")
    wq = bf.fake_quant(w, wbits, axis=0,
                       reduce=lambda a: amax[1:].reshape(a.shape))
    xq = bf.fake_quant(x, abits, reduce=lambda a: amax[0])
    # f32 partial products (bf16 x bf16 products are exact in f32): the
    # SUM rounds to bf16 once, as the whole product's accumulator does
    y = mesh.all_reduce(torch.matmul(xq.float(), wq.float()), axes, "sum",
                        kind="sum_tp")
    if b is not None:
        y = y + b.float()
    return y.to(DTYPE)


def unstack(tree, n: int) -> list:
    """The ``n`` layers of a stacked ``(n, ...)`` parameter dict, as a
    list of per-layer dicts of views (``torch.unbind`` of every leaf).
    Gradients of the layers reach the stack through one ``unbind``
    backward, which stacks them once, where indexing layer by layer
    would add one zero-filled stack per layer."""
    if isinstance(tree, dict):
        per = {k: unstack(v, n) for k, v in tree.items()}
        return [_like(tree, {k: v[i] for k, v in per.items()})
                for i in range(n)]
    out = torch.unbind(tree)
    if len(out) != n:
        raise ValueError(f"stack of {len(out)} layers, expected {n}")
    return list(out)


def remat(cfg, fn, *args, cache=None):
    """``fn(*args)``, recomputed in the backward pass (one
    ``torch.utils.checkpoint`` region) when ``cfg.remat == "full"``,
    there is no cache and grad mode is on: the reference's
    ``jax.checkpoint`` around a layer.  Nothing inside draws random
    numbers, so no RNG state is kept.  The recompute runs where the
    backward runs (for CUDA tensors, autograd's device thread), so it
    re-enters the forward's active mesh and manual mode, which are
    thread-local: it issues the forward's collectives on the forward's
    shapes."""
    if cfg.remat == "full" and cache is None and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint
        mesh, manual = dist.active_mesh(), dist.in_manual_mode()

        def run(*a):
            with contextlib.ExitStack() as ctx:
                if mesh is not None:
                    ctx.enter_context(dist.use_mesh(mesh))
                if manual:
                    ctx.enter_context(dist.manual_mode())
                return fn(*a)
        return checkpoint(run, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def stack_slice(tree, i: int):
    """Index ``i`` of every leaf of a stacked ``(L, ...)`` parameter or
    cache dict (views: an in-place cache insert updates the stack)."""
    if isinstance(tree, dict):
        return _like(tree, {k: stack_slice(v, i) for k, v in tree.items()})
    return tree[i]


def _like(tree: dict, items: dict) -> dict:
    """``items`` as a dict of ``tree``'s kind (a mesh-placed dict keeps
    its layout)."""
    return tree.like(items) if isinstance(tree, shd.Local) else items


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (kept, size 1) in a fixed pairwise order
    built from elementwise adds.

    A library reduction may sum a row in an order that depends on how
    many rows share the launch (PyTorch's CUDA reduction picks its
    thread layout from the output count), and under 4-bit activation
    quantizers one ulp grows into a different token.  Elementwise adds
    round each element alone, so each row's sum here depends only on
    that row: a request decodes to the same bits in a batch of 1, 8 or
    72 rows (the reference's row independence)."""
    while x.shape[-1] > 1:
        n = x.shape[-1]
        h = n // 2
        y = x[..., :h] + x[..., h:2 * h]
        x = torch.cat([y, x[..., 2 * h:]], dim=-1) if n % 2 else y
    return x


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    x32 = x.float()
    var = row_sum(x32 * x32) / x.shape[-1]
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    n = x.shape[-1]
    mu = row_sum(x32) / n
    var = row_sum((x32 - mu) * (x32 - mu)) / n
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def apply_norm(p: dict, x: torch.Tensor, kind: str, eps: float = 1e-5
               ) -> torch.Tensor:
    if kind == "layer":
        return layer_norm(x, p["scale"], p["bias"], eps)
    return rms_norm(x, p["scale"], eps)


def norm_init(d: int, kind: str, *, lead: Tuple[int, ...] = (),
              device) -> dict:
    shape = tuple(lead) + (d,)
    p = {"scale": torch.ones(shape, dtype=DTYPE, device=device)}
    if kind == "layer":
        p["bias"] = torch.zeros(shape, dtype=DTYPE, device=device)
    return p


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)            # (hd/2,)
    angles = positions[..., None].float() * freqs            # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x32 = x.float()
    x1, x2 = x32[..., : hd // 2], x32[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Masks
# ---------------------------------------------------------------------------

def causal_mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor,
                     window: int = 0) -> torch.Tensor:
    """Additive attention bias (Sq, Sk): 0 where visible, -inf elsewhere.

    ``window`` > 0 adds the sliding-window band."""
    visible = k_pos[None, :] <= q_pos[:, None]
    if window:
        visible &= k_pos[None, :] > (q_pos[:, None] - window)
    return visibility_bias(visible)


def causal_mask_bias_batched(q_pos: torch.Tensor, k_pos: torch.Tensor,
                             window: int = 0) -> torch.Tensor:
    """Per-row additive bias (B, Sq, Sk) from per-row positions (B, S):
    padded tokens sit at ``EMPTY_POS``, so real queries never see them."""
    visible = k_pos[:, None, :] <= q_pos[:, :, None]
    if window:
        visible &= k_pos[:, None, :] > (q_pos[:, :, None] - window)
    return visibility_bias(visible)


def visibility_bias(visible: torch.Tensor) -> torch.Tensor:
    """0 where ``visible``, -inf elsewhere, in f32."""
    return torch.where(visible, 0.0, float("-inf")).float()

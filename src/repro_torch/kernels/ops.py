"""Serve-form kernel API: the models' quantized compute path.

The counterpart of ``repro.kernels.ops`` for the serve path: every
quantized GEMM in ``models/`` reaches a kernel only through
:func:`serve_linear` (or :func:`serve_linear_stacked` for grouped-conv
and MoE expert stacks, which launches the kernel slice by slice).  An int8 container goes through
:func:`int8_accum` to :func:`repro_torch.kernels.bitplane_matmul.
bitplane_matmul`; a packed-int4 container at a static (Python int) width
of 4 bits or more goes through :func:`int4_linear` to the packed kernel,
:func:`repro_torch.kernels.int4_matmul.int4_matmul`, and otherwise
unpacks onto the bit-plane path.  Each wrapper launches its CUDA kernel
for CUDA tensors and takes its plain version for CPU tensors.
:func:`quant_matmul` and :func:`int4_matmul` are the public entries of
the fused-epilogue and packed kernels, with the reference's shape checks.

Bits arrive as Python ints (static: the GEMM runs at exactly that many
planes), as 0-d tensors (the container path at 8 planes, as traced bits
do in the reference), or as ``(B,)`` per-row vectors.  Per-row bits take
the bit-grouped batch path: the container is requantized once per
*family* in the static family set, one GEMM runs per family at that
family's plane count, and each row gathers its result from its family's
accumulator.  Rows between families snap UP to the next family; rows
above the largest family clamp DOWN to it, so a family set must hold its
policy's widest bit-width (engines derive it from their controller).
Per-row activations quantize with one scale per request, or one per
token position under :func:`token_scale_mode` (the speculative verify).
``set_row_dispatch("vmap")`` (or the :func:`row_dispatch` context)
swaps the grouped path for the reference's per-row baseline: one
:func:`serve_linear` per row at that row's bits (a 0-d tensor, so the
container path at 8 planes), each paying its own weight requant and
launch; the two give EQUAL outputs whenever every row's bits lie in the
family set.

:func:`fluid_linear` is the public bit-fluid matmul: a static ``wbits``
runs the bit-plane kernel at exactly that many planes on the container's
low ``wbits`` field (truncation, not :func:`serve_linear`'s dyadic
requant).

Attention over flat heads reaches the flash kernel only through
:func:`flash_attention`, which launches it for CUDA tensors and takes a
plain version for CPU tensors.

On a mesh, :func:`sharded_linear` runs a linear whose leaves are this
rank's blocks (``dist.sharding.Local``) and keeps every output EQUAL to
the single-device linear's: FSDP-sharded dims are all-gathered before use;
a column-parallel weight computes this rank's output columns (its scale
and bias sliced with them), gathered unless the caller keeps them local;
a row-parallel weight takes this rank's slice of the reduction dim, the
activation's amax is MAX-reduced over the model axis before it quantizes
(a rank-local amax would give another ``x_q``), and the int32 partial
accumulators are SUM-reduced before the f32 epilogue (int32 sums wrap as
the kernel's own accumulator does, so they are exact wherever it is).
Under :func:`split_rows` (an engine's forward on its data rank's block of
rows) every per-tensor activation amax is MAX-reduced over the data axis
too, so a whole-batch scale sees the whole batch.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core import bitfluid as bf
from repro_torch.dist import api as dist_api
from repro_torch.dist import sharding as shd
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import int4_matmul as i4mm
from repro_torch.kernels import quant_matmul as qmm
from repro_torch.kernels.bitplane_matmul import bitplane_matmul

# Distinct weight bit-widths the grouped per-row path specializes for.
BIT_FAMILIES = (2, 3, 4, 6, 8)
_families: Sequence[int] = BIT_FAMILIES
_row_dispatch = "grouped"


def set_bit_families(fams: Sequence[int]) -> None:
    """Set the static family set for grouped per-row dispatch (values
    clamp into [1, 8], the int8 container width)."""
    global _families
    vals = tuple(sorted({min(max(int(f), 1), 8) for f in fams}))
    if not vals:
        raise ValueError("bit family set must be non-empty")
    _families = vals


def get_bit_families():
    return tuple(_families)


@contextlib.contextmanager
def bit_families(fams: Sequence[int]):
    """Scoped family set (the serving engines wrap each forward in it)."""
    global _families
    prev = _families
    set_bit_families(fams)
    try:
        yield
    finally:
        _families = prev


_token_scales = False


@contextlib.contextmanager
def token_scale_mode():
    """Per-token activation scales in the per-row serve path.

    The default per-row path reduces the activation amax over every axis
    past the batch axis: one scale per request, which is what a
    ``(B, 1, K)`` single-token decode step computes.  A speculative
    verify chunk runs ``(B, U, K)`` token positions in one forward, and
    one scale shared across the U tokens would quantize them apart from
    U sequential steps.  Under this context the amax reduces only the
    feature axis, so each token row of the flattened ``(B*U, K)`` grouped
    GEMM carries the scale sequential decode gives it.
    """
    global _token_scales
    prev = _token_scales
    _token_scales = True
    try:
        yield
    finally:
        _token_scales = prev


_rows_mesh = None      # the mesh whose data axis splits the rows
_k_reduce = None       # (mesh, axes) of a row-parallel linear's sums


@contextlib.contextmanager
def split_rows(mesh):
    """The enclosed forwards run on this data rank's block of rows:
    per-tensor activation scales take the whole batch's amax (a MAX over
    the data axis).  No-op for ``mesh=None``."""
    global _rows_mesh
    prev = _rows_mesh
    _rows_mesh = mesh
    try:
        yield
    finally:
        _rows_mesh = prev


def rows_split_mesh():
    """The mesh of the enclosing :func:`split_rows` block, or None."""
    return _rows_mesh


def tensor_amax_reduce():
    """The per-tensor amax reduction in force (``bf.fake_quant``'s
    ``reduce``), or None when nothing splits the tensor."""
    if _rows_mesh is None and _k_reduce is None:
        return None
    return lambda a: _amax(a, True)


def _amax(a: torch.Tensor, per_tensor: bool) -> torch.Tensor:
    """An activation amax reduced over the axes that split its tensor:
    the model axis of a row-parallel linear's K, and, for a per-tensor
    scale under :func:`split_rows`, the data axis.  Local inside a
    ``shard_map`` body (``dist.api.manual_mode``)."""
    if dist_api.in_manual_mode():
        return a
    if _k_reduce is not None:
        a = _k_reduce[0].all_reduce(a, _k_reduce[1], "max",
                                    kind="amax_tp")
    if per_tensor and _rows_mesh is not None:
        a = _rows_mesh.all_reduce(a, _rows_mesh.dp_axes, "max",
                                  kind="amax_dp")
    return a


def _sum_acc(acc: torch.Tensor) -> torch.Tensor:
    """A row-parallel linear's partial accumulators summed over the model
    axis (int32: exact modulo 2^32, as the kernel's accumulator)."""
    if _k_reduce is None or dist_api.in_manual_mode():
        return acc
    if acc.dtype != torch.int32:            # the packed-int4 kernel's f32
        return _k_reduce[0].all_reduce(acc.to(torch.int32), _k_reduce[1],
                                       "sum", kind="acc_tp").to(acc.dtype)
    return _k_reduce[0].all_reduce(acc, _k_reduce[1], "sum", kind="acc_tp")


def _scale_of(x2: torch.Tensor, abits) -> torch.Tensor:
    """The per-tensor activation scale (``bf.symmetric_scale``), its amax
    reduced as :func:`_amax` says."""
    if _k_reduce is None and _rows_mesh is None:
        return bf.symmetric_scale(x2, abits)
    return (_amax(x2.abs().amax(), True).clamp_min(1e-8).float()
            / bf.qmax(abits, x2.device))


def set_row_dispatch(mode: str) -> None:
    """'grouped' (default) or 'vmap' (the per-row baseline, kept for
    benchmarks and parity tests)."""
    global _row_dispatch
    if mode not in ("grouped", "vmap"):
        raise ValueError(f"row dispatch must be 'grouped' or 'vmap', "
                         f"got {mode!r}")
    _row_dispatch = mode


def get_row_dispatch() -> str:
    return _row_dispatch


@contextlib.contextmanager
def row_dispatch(mode: str):
    global _row_dispatch
    prev = _row_dispatch
    set_row_dispatch(mode)
    try:
        yield
    finally:
        _row_dispatch = prev


def quant_matmul(x_q: torch.Tensor, w_q: torch.Tensor, scale,
                 bias=None, *, act: str = "none",
                 out_dtype=torch.float32) -> torch.Tensor:
    """int8 (M,K) @ int8 (K,N) with fused per-channel dequant epilogue:
    ``act(f32(acc) * scale + bias)``; ``scale`` and ``bias`` broadcast to
    (1, N), bias defaults to zeros."""
    N = w_q.shape[1]
    scale = _row_f32(scale, N, x_q.device)
    bias = (torch.zeros((1, N), dtype=torch.float32, device=x_q.device)
            if bias is None else _row_f32(bias, N, x_q.device))
    return qmm.quant_matmul(x_q, w_q, scale, bias, act=act,
                            out_dtype=out_dtype)


def int4_matmul(x_q: torch.Tensor, w_packed: torch.Tensor, scale, *,
                out_dtype=torch.float32) -> torch.Tensor:
    """int8 (M,K) @ halves-packed uint8 (K,N/2) with fused dequant.

    Invalid operand shapes raise ``ValueError``.  Any even N runs on the
    card: the kernel picks the nibble per logical column and masks ragged
    edges itself, so there is no "does not tile" branch."""
    K = x_q.shape[-1]
    if w_packed.ndim != 2 or w_packed.shape[0] != K:
        raise ValueError(
            f"int4_matmul: packed weights {tuple(w_packed.shape)} do not "
            f"match activations {tuple(x_q.shape)} on K={K}")
    N = 2 * w_packed.shape[1]
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x_q.device)
    if scale.numel() not in (1, N):
        raise ValueError(
            f"int4_matmul: scale {tuple(scale.shape)} is not broadcastable "
            f"to (1, {N}) for packed weights {tuple(w_packed.shape)}")
    return i4mm.int4_matmul(x_q, w_packed, _row_f32(scale, N, x_q.device),
                            out_dtype=out_dtype)


def _row_f32(v, N: int, device) -> torch.Tensor:
    """``v`` as a contiguous f32 (1, N) row on ``device``."""
    t = torch.as_tensor(v, dtype=torch.float32, device=device)
    return t.reshape(1, -1).expand(1, N).contiguous()


def _static_bits(b) -> Optional[int]:
    """Python int when ``b`` is a constant, else None (a tensor)."""
    if isinstance(b, (int, np.integer)) and not isinstance(b, bool):
        return int(b)
    return None


def int8_accum(x_q: torch.Tensor, w_q: torch.Tensor, *,
               planes: Optional[int] = None) -> torch.Tensor:
    """int8 (M,K) @ int8 (K,N) -> int32 through the kernel layer.

    Static ``planes`` runs at exactly that many bit planes; None (bits
    given as a tensor upstream) runs at the container width, 8."""
    n = 8 if planes is None else min(max(planes, 1), 8)
    return bitplane_matmul(x_q, w_q, n_planes=n)


def _epilogue(acc2, lead, x_scale, w_s, bias):
    """f32(acc) * x_scale * w_s (+ bias) — the reference's multiply order."""
    y = acc2.float().reshape(*lead, -1) * x_scale * w_s
    if bias is not None:
        y = y + bias.float()
    return y


def _container_linear(x, qw, s, bias, *, from_bits, wbits, abits):
    x2 = x.float()
    x_scale = _scale_of(x2, abits)                    # per-tensor scalar
    x_q = bf.quantize(x2, x_scale, abits)
    w_q = bf.requant_shift(qw, wbits, from_bits=from_bits)
    w_s = bf.effective_scale(s, wbits, from_bits=from_bits)
    acc = _sum_acc(int8_accum(x_q.reshape(-1, x.shape[-1]), w_q,
                              planes=_static_bits(wbits)))
    return _epilogue(acc, x.shape[:-1], x_scale, w_s, bias)


def quant_linear(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *, wbits=8,
                 abits=8) -> torch.Tensor:
    """float (..., K) @ int8-container {q (K,N), s (1,N)} -> f32 (..., N)."""
    return _container_linear(x, q, s, bias, from_bits=8, wbits=wbits,
                             abits=abits)


def int4_linear(x: torch.Tensor, q4: torch.Tensor, s: torch.Tensor,
                bias: Optional[torch.Tensor] = None, *, wbits=8,
                abits=8) -> torch.Tensor:
    """float (..., K) @ packed-int4 container {q4 (K,N/2), s (1,N)}.

    With static ``wbits >= 4`` requantization is the identity, so the
    packed kernel reads the nibbles as they are stored (half the weight
    bytes); the dequant epilogue stays outside the kernel in the
    reference's multiply order, so the result equals the unpacked path
    exactly (an int4 accumulator is f32-exact for any practical K).  The
    tensor's device picks kernel or plain version.  Otherwise the
    container unpacks and takes the shared requant path."""
    wb = _static_bits(wbits)
    if wb is not None and wb >= 4:
        N = 2 * q4.shape[-1]
        x2 = x.float()
        x_scale = _scale_of(x2, abits)
        x_q = bf.quantize(x2, x_scale, abits)
        acc = _sum_acc(int4_matmul(x_q.reshape(-1, x.shape[-1]), q4,
                                   torch.ones((1, N), dtype=torch.float32,
                                              device=x.device),
                                   out_dtype=torch.float32))
        return _epilogue(acc, x.shape[:-1], x_scale, s.float(), bias)
    return _container_linear(x, bf.unpack_int4_halves(q4), s, bias,
                             from_bits=4, wbits=wbits, abits=abits)


def _bits_on(bits, device) -> torch.Tensor:
    return torch.as_tensor(bits, dtype=torch.int32, device=device)


def serve_linear(p: dict, x: torch.Tensor, wbits=8, abits=8) -> torch.Tensor:
    """Serve-form linear dispatch: {"q","s"[,"b"]} or {"q4","s"[,"b"]}.

    Scalar bits take the container path (a packed-int4 container through
    :func:`int4_linear`); ``(B,)`` vectors take the bit-grouped batch
    path.  Returns float32."""
    if getattr(wbits, "ndim", 0) >= 1 or getattr(abits, "ndim", 0) >= 1:
        return _serve_linear_rows(p, x, wbits, abits)
    if torch.is_tensor(wbits):
        wbits = wbits.to(x.device)
    if torch.is_tensor(abits):
        abits = abits.to(x.device)
    bias = p.get("b")
    if "q4" in p:
        return int4_linear(x, p["q4"], p["s"], bias, wbits=wbits,
                           abits=abits)
    return quant_linear(x, p["q"], p["s"], bias, wbits=wbits, abits=abits)


def serve_linear_stacked(p: dict, x: torch.Tensor, wbits=8, abits=8, *,
                         stack_bits: bool = False) -> torch.Tensor:
    """Stacked serve-form linears: containers carry a leading stack axis.

    ``p``: ``{"q": (G, K, N), "s": (G, 1, N)}``, G independent weight
    matrices applied slice-wise to ``x`` ``(G, ..., K)`` (grouped-conv
    group stacks).  Each slice runs :func:`serve_linear` on its own, as
    the reference's ``vmap`` does, so each takes its OWN activation scale
    (per tensor for scalar bits, per row for ``(B,)`` bits): one kernel
    launch per slice and bit family.

    ``stack_bits=False``: ``wbits`` is shared by every slice, a scalar or
    a per-row ``(B,)`` vector when ``x`` is ``(G, B, ..., K)``.
    ``stack_bits=True``: ``wbits`` is a ``(G,)`` vector, one width per
    slice (MoE per-expert precision), each a tensor: the container path
    at 8 planes.  ``abits`` must then be a scalar (MoE batches share one
    activation width): the branch quantizes, requantizes and rescales all
    G slices at once (each step is elementwise or a per-slice max, so
    every slice's numbers are those of its own :func:`serve_linear`) and
    launches the kernel once per slice.  Biases are not stacked: callers
    add a full-width bias after recombining slices.
    """
    G = x.shape[0]
    if stack_bits:
        if getattr(abits, "ndim", 0) != 0:
            raise NotImplementedError(
                "serve_linear_stacked(stack_bits=True) takes a scalar abits")
        return _stacked_container(p, x, _bits_on(wbits, x.device).expand(G),
                                  abits)
    return torch.stack([serve_linear({k: v[g] for k, v in p.items()}, x[g],
                                     wbits, abits) for g in range(G)])


def _stacked_container(p, x, wb, abits):
    """The vectorised ``stack_bits`` branch of :func:`serve_linear_stacked`:
    G int8 or packed-int4 containers, slice g at ``wb[g]`` bits, one
    activation width ``abits`` for all."""
    if torch.is_tensor(abits):
        abits = abits.to(x.device)
    G, K = x.shape[0], x.shape[-1]
    if "q4" in p:
        qw, from_bits = bf.unpack_int4_halves(p["q4"]), 4
    else:
        qw, from_bits = p["q"], 8
    bits = wb.reshape(G, 1, 1)
    x2 = x.float().reshape(G, -1, K)                        # (G, R, K)
    # one per-tensor activation scale per slice
    amax = _amax(x2.abs().amax(dim=(1, 2), keepdim=True), True)
    x_scale = amax.clamp_min(1e-8).float() / bf.qmax(abits, x.device)
    x_q = bf.quantize(x2, x_scale, abits)
    w_q = bf.requant_shift(qw, bits, from_bits=from_bits)   # (G, K, N)
    w_s = bf.effective_scale(p["s"], bits, from_bits=from_bits)
    acc = torch.stack([int8_accum(x_q[g], w_q[g]) for g in range(G)])
    y = acc.float() * x_scale * w_s
    if "b" in p:
        y = y + p["b"].float()[:, None]
    return y.reshape(x.shape[:-1] + (y.shape[-1],))


def _family_index(wb: torch.Tensor, fams) -> torch.Tensor:
    """Index of the smallest family >= wb (clamped into the family range) —
    exact whenever wb is in the set, snap-up otherwise: the count of
    families below it (compared with Python scalars, so no table is
    copied from the host)."""
    clipped = torch.clamp(wb.to(torch.int32), fams[0], fams[-1])
    idx = torch.zeros_like(clipped)
    for f in fams[:-1]:
        idx += (clipped > f).to(torch.int32)
    return idx


def _serve_linear_rows(p, x, wbits, abits):
    """Per-row precision: grouped (one requant and one GEMM per static bit
    family) or the vmap baseline (one :func:`serve_linear` per row)."""
    B = x.shape[0]
    wb = _bits_on(wbits, x.device).expand(B)
    ab = _bits_on(abits, x.device).expand(B)
    if _row_dispatch == "vmap":
        # each row's own per-tensor scale: no data-axis reduction
        with split_rows(None):
            return torch.stack([serve_linear(p, x[r], wb[r], ab[r])
                                for r in range(B)])
    if "q4" in p:
        qw, from_bits = bf.unpack_int4_halves(p["q4"]), 4
    else:
        qw, from_bits = p["q"], 8
    K = x.shape[-1]
    lead = x.shape[:-1]
    x2 = x.float()
    # per-row dynamic activation quantization at per-row abits: one scale
    # per request, over every axis past the batch axis (for a conv, the
    # im2col'd patches — exactly the pixels the GEMM reads);
    # token_scale_mode keeps one scale per token position instead (verify
    # chunks)
    axes = ((x2.ndim - 1,) if _token_scales
            else tuple(range(1, x2.ndim)))
    amax = _amax(x2.abs().amax(dim=axes, keepdim=True), False)
    lim = bf.qmax(ab.reshape((B,) + (1,) * (x2.ndim - 1)))
    x_scale = amax.clamp_min(1e-8) / lim
    x_q = torch.maximum(torch.minimum(torch.round(x2 / x_scale), lim),
                        -lim).to(bf.INT_DTYPE)
    xq2 = x_q.reshape(-1, K)                                # (R, K)
    R = xq2.shape[0]

    # one requant + one GEMM per distinct family — families below the
    # container width collapse (requant 4->6 == 4->4 for a q4 container)
    fams = tuple(_families)
    eff = [min(f, from_bits) for f in fams]
    uniq = sorted(set(eff))
    accs, scales = [], []
    for f in uniq:
        w_f = bf.requant_shift(qw, f, from_bits=from_bits)
        accs.append(int8_accum(xq2, w_f, planes=f))
        scales.append(bf.effective_scale(p["s"], f, from_bits=from_bits)
                      .float().reshape(1, -1).expand(1, accs[-1].shape[-1]))
    acc_stack = torch.stack(accs)                           # (G, R, N)
    ws_stack = torch.cat(scales, dim=0)                     # (G, N)

    # scatter rows back: gather each row's accumulator from its family
    fam_idx = _family_index(wb, fams).long()
    fam_of_row = torch.zeros_like(fam_idx)                  # (B,)
    for j, e in enumerate(eff):
        if uniq.index(e):
            fam_of_row += (fam_idx == j).long() * uniq.index(e)
    idx_r = torch.repeat_interleave(fam_of_row, R // B)     # (R,)
    acc = _sum_acc(acc_stack[idx_r, torch.arange(R, device=x.device)])
    w_s = ws_stack[idx_r]                                   # (R, N)
    xs_flat = x_scale.expand(x2.shape[:-1] + (1,)).reshape(R, 1)
    y = acc.float() * xs_flat * w_s
    if "b" in p:
        y = y + p["b"].float()
    return y.reshape(lead + (y.shape[-1],))


def sharded_linear(p, x: torch.Tensor, wbits=8, abits=8, *,
                   local_out: bool = False) -> torch.Tensor:
    """:func:`serve_linear` of a serve-form linear whose leaves are this
    rank's blocks (``p`` a ``dist.sharding.Local``); the result EQUALS
    the whole linear's (module docstring).

    ``x`` carries the whole reduction dim, or, for a weight whose K is
    sharded over the model axis, this rank's slice of it (the output of
    a column-parallel linear kept local).  A column-parallel result is
    all-gathered unless ``local_out``.  A packed-int4 container whose
    packed columns are sharded is gathered whole (its nibble pairs hold
    columns j and j + N/2, which a column block does not keep together)."""
    global _k_reduce
    mesh = p.mesh
    kq = "q4" if "q4" in p else "q"
    (K, _), (ke, ne) = p.spec(kq)
    q, s, b = p[kq], p["s"], p.get("b")
    if kq == "q4" and dist_api.is_tp_entry(ne):
        q = mesh.gather_weight(q, dist_api.entry_axes(ne), -1)
        s, ne = shd.gather_leaf(p, "s"), None
    if ke is not None and not dist_api.is_tp_entry(ke):        # FSDP
        q = mesh.gather_weight(q, dist_api.entry_axes(ke), -2)
        ke = None
    if ne is not None and not dist_api.is_tp_entry(ne):
        q = mesh.gather_weight(q, dist_api.entry_axes(ne), -1)
        s = shd.gather_leaf(p, "s")
        ne = None
    if ne is not None:                          # column-parallel
        axes = dist_api.entry_axes(ne)
        if "s" not in p.layout:
            s = mesh.local_block(s, axes, -1)
        if b is not None:
            b = mesh.local_block(b, axes, -1)
    red = None
    if ke is not None:                          # row-parallel
        red = (mesh, dist_api.entry_axes(ke))
        if x.shape[-1] == K:
            x = mesh.local_block(x, red[1], -1)
    lin = {kq: q, "s": s}
    if b is not None:
        lin["b"] = b
    prev, _k_reduce = _k_reduce, red
    try:
        y = serve_linear(lin, x, wbits, abits)
    finally:
        _k_reduce = prev
    if ne is not None and not local_out:
        y = mesh.all_gather(y, dist_api.entry_axes(ne), dim=-1,
                            kind="gather_cols")
    return y


def fluid_linear(x: torch.Tensor, w_q: torch.Tensor, w_scale, *,
                 wbits: int = 8, abits: int = 8) -> torch.Tensor:
    """float (..., K) @ int8-container (K, N): the bit-fluid serving matmul.

    ``x`` quantizes per tensor at ``abits``; the bit-plane kernel runs at
    exactly ``wbits`` planes on the container's low ``wbits`` field (its
    high bits are masked, not requantized: truncation semantics), then
    the result dequantizes by ``x_scale * w_scale``.  ``wbits`` is static
    (a Python int); :func:`repro_torch.core.bitfluid.fluid_int8_matmul`
    takes tensor bits."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).float()
    x_scale = bf.symmetric_scale(x2, abits)
    x_q = bf.quantize(x2, x_scale, abits)
    acc = int8_accum(x_q, w_q, planes=int(wbits))
    y = acc.float() * x_scale * torch.as_tensor(
        w_scale, dtype=torch.float32, device=x.device)
    return y.reshape(*lead, -1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Flat-head attention over (BH, S, hd) tensors.

    CUDA tensors launch the flash kernel with the real ``hd ** -0.5``
    scale.  CPU tensors take a plain version, as the reference does off
    the TPU: the blockwise online-softmax lowering when a sequence is
    longer than one chunk, the exact oracle otherwise."""
    if q.device.type == "cuda" or kernels.card_fake(q):
        return fa.flash_attention(q, k, v, causal=causal, window=window,
                                  scale=q.shape[-1] ** -0.5)
    if max(q.shape[1], k.shape[1]) > fa.FLASH_CHUNK:
        return fa.flash_attention_chunked_ref(q, k, v, causal=causal,
                                              window=window)
    return fa.flash_attention_ref(q, k, v, causal, window)

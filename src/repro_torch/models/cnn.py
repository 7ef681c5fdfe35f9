"""The paper's CNN workloads in PyTorch: conv-as-GEMM (im2col) through the
bit-fluid linear.

The counterpart of ``repro.models.cnn``: every convolution lowers to
``im2col`` patches x kernel matrix and runs through the same quantized
linear, so HAWQ-V3's per-layer bit vectors drive the networks exactly as
in the reference.  Two parameter forms: the train form (``init_cnn``,
``{"w", "b"}`` per layer, fake-quant float math — the fidelity oracle)
and the serve form (``quantize_cnn_params``: int8 or packed-int4
containers, every GEMM through ``ops.serve_linear``).  Per-layer bits are
``(n_gemm,)`` vectors shared by the batch or ``(B, n_gemm)`` per-request
rows, routed through the bit-grouped dispatch.

Grouped convolutions (AlexNet's conv2, conv4, conv5) stack per-group
containers ``(g, fk, cout/g)`` and run slice by slice through
``ops.serve_linear_stacked``, each group with its own activation scale,
as the reference's ``vmap`` gives it; the train form runs the same stack
through the fake-quant linear.

Shapes are NHWC, as in the reference.
"""
from __future__ import annotations

import dataclasses as dc
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.apsim.workloads import Layer, NETWORKS, gemm_layers
from repro_torch.dist import sharding as shd
from repro_torch.kernels import ops as kops
from repro_torch.models import common as cm


def im2col(x: torch.Tensor, hk: int, wk: int, stride: int, pad: int
           ) -> torch.Tensor:
    """NHWC -> (N, Ho, Wo, hk*wk*C) patches, tap-major / channel-minor."""
    N, H, W, C = x.shape
    xp = F.pad(x, (0, 0, pad, pad, pad, pad)) if pad else x
    p = xp.unfold(1, hk, stride).unfold(2, wk, stride)   # (N,Ho,Wo,C,hk,wk)
    Ho, Wo = p.shape[1], p.shape[2]
    return p.permute(0, 1, 2, 4, 5, 3).reshape(N, Ho, Wo, hk * wk * C)


def grouped_cols(cols: torch.Tensor, g: int, taps: int) -> torch.Tensor:
    """(N, Ho, Wo, taps*C) im2col patches -> (N, Ho, Wo, g, taps*(C/g)).

    im2col features are tap-major / channel-minor; group ``i`` owns the
    channel slice [i*C/g, (i+1)*C/g) of EVERY tap, so the split slices
    the channel axis, not contiguous feature runs."""
    N, Ho, Wo, F = cols.shape
    cg = F // (taps * g)
    p = cols.reshape(N, Ho, Wo, taps, g, cg)
    return p.movedim(4, 3).reshape(N, Ho, Wo, g, taps * cg)


def stack_grouped_weight(w: torch.Tensor, g: int, cout: int) -> torch.Tensor:
    """Flat (fk, cout) grouped-conv weight -> (g, fk, cout/g) group stack
    (group ``i`` produces the contiguous output-channel run
    [i*cout/g, (i+1)*cout/g)); a contiguous copy."""
    return w.reshape(w.shape[0], g, cout // g).movedim(1, 0).contiguous()


def conv_gemm(p: dict, x: torch.Tensor, layer: Layer, wbits=8, abits=8
              ) -> torch.Tensor:
    """x: (N, H, W, Cin) -> (N, Ho, Wo, Cout) via patches @ W.

    Dispatches on the parameter form: ``{"w"}`` fake-quant float,
    ``{"q"/"q4", "s"}`` through the kernel layer.  Grouped convs run the
    (g, fk, cout/g) stack group by group in both forms, and add the
    full-width bias in f32 after the groups recombine.  On a mesh an
    ungrouped conv is a column-parallel linear (its output channels
    gathered); a grouped stack is gathered whole first."""
    g = layer.groups
    cols = im2col(x, layer.hk, layer.wk, layer.stride, layer.pad)
    if g == 1:
        y = cm.apply_linear(p, cols, wbits, abits)
    else:
        N, Ho, Wo, _ = cols.shape
        if isinstance(p, shd.Local):            # a mesh's blocks: whole
            p = shd.full(p)
        xg = grouped_cols(cols, g, layer.hk * layer.wk).movedim(3, 0)
        xg = xg.contiguous()                   # (g, N, Ho, Wo, taps*C/g)
        if "w" in p:
            w3 = stack_grouped_weight(p["w"], g, layer.cout)
            y = torch.stack([cm.apply_linear({"w": w3[i]}, xg[i], wbits,
                                             abits) for i in range(g)])
        else:
            y = kops.serve_linear_stacked({"q": p["q"], "s": p["s"]}, xg,
                                          wbits, abits)
        y = y.movedim(0, 3).reshape(N, Ho, Wo, layer.cout)
        if "b" in p:
            y = y.float() + p["b"].float()
        y = y.to(cm.DTYPE)
    if layer.relu:
        y = torch.relu(y.float()).to(cm.DTYPE)
    return y


def pool2d(x: torch.Tensor, layer: Layer) -> torch.Tensor:
    """VALID max / average pooling over NHWC (average summed in float32)."""
    k, s = layer.hk, layer.stride
    win = x.unfold(1, k, s).unfold(2, k, s)              # (N,Ho,Wo,C,k,k)
    if layer.kind == "maxpool":
        return win.amax(dim=(-2, -1))
    summed = win.float().sum(dim=(-2, -1))
    return (summed / (k * k)).to(x.dtype)


def init_cnn(network: str, gen: torch.Generator, num_classes: int = 1000,
             image: int = 0, *, device="cuda") -> Tuple[dict, List[Layer]]:
    """Build train-form params for a paper workload table (optionally
    rescaled to a smaller input image), drawn from ``gen`` and placed on
    ``device`` (CUDA unless the caller passes another)."""
    dev = cm.resolve_device(device)
    layers = NETWORKS[network]()
    if image:
        layers = _rescale(layers, image)
    params: dict = {}
    for l in layers:
        if l.kind == "conv":
            fk = l.hk * l.wk * (l.cin // l.groups)
            params[l.name] = cm.dense_init(gen, fk, l.cout, bias=True,
                                           device=dev)
        elif l.kind == "fc":
            params[l.name] = cm.dense_init(gen, l.cin, l.cout, bias=True,
                                           device=dev)
    return params, layers


def _shrink_conv_kernel(l: Layer, h: int) -> Tuple[int, int]:
    """(hk, pad) for a conv squeezed to an ``h``-pixel input: kernels
    larger than the image shrink, staying ODD so stride-1 same-padded
    convs keep their spatial size."""
    hk = min(l.hk, h)
    if hk < l.hk and hk % 2 == 0:
        hk = max(hk - 1, 1)
    return hk, min(l.pad, hk // 2)


def _rescale(layers: List[Layer], image: int) -> List[Layer]:
    """Shrink spatial dims; keeps channel structure.  Residual ``*_down``
    convs read the BLOCK input (the height at the previous ``add``)."""
    out = []
    h = image
    h_block = image
    for l in layers:
        if l.kind == "conv" and l.name.endswith("_down"):
            hk, pad = _shrink_conv_kernel(l, h_block)
            out.append(dc.replace(l, hin=h_block, win=h_block, hk=hk, wk=hk,
                                  pad=pad))
        elif l.kind == "conv":
            hk, pad = _shrink_conv_kernel(l, h)
            nl = dc.replace(l, hin=h, win=h, hk=hk, wk=hk, pad=pad)
            h = nl.hout
            out.append(nl)
        elif l.kind in ("maxpool", "avgpool"):
            hk = min(l.hk, h)
            nl = dc.replace(l, hin=h, win=h, hk=hk, wk=hk, window=hk * hk)
            h = nl.hout
            out.append(nl)
            h_block = h
        elif l.kind == "add":
            out.append(dc.replace(l, hin=h, win=h))
            h_block = h
        elif l.kind == "fc" and out and out[-1].kind in ("conv", "maxpool",
                                                         "avgpool", "add"):
            prev_c = _last_channels(out)
            out.append(dc.replace(l, cin=prev_c * h * h))
            h = 1
        else:
            out.append(l)
    return out


def _last_channels(layers: List[Layer]) -> int:
    for l in reversed(layers):
        if l.kind == "conv":
            return l.cout
        if l.kind in ("maxpool", "avgpool", "add"):
            return l.cin
    raise ValueError


# ---------------------------------------------------------------------------
# Serve-form parameters
# ---------------------------------------------------------------------------

def quantize_cnn_params(params: dict, layers: Sequence[Layer], *,
                        container: str = "int8",
                        int4_names: Sequence[str] = ()) -> dict:
    """Train-form CNN params -> serve-form containers, once at init:
    ``{"q" int8 (K, N), "s" (1, N) [, "b"]}``, or ``{"q4" packed uint8
    (K, N/2), ...}`` for layers named in ``int4_names`` (or every
    ungrouped layer under ``container="int4"``).  Grouped convs stack
    per-group int8 containers ``(g, fk, cout/g)`` with per-group scales,
    whatever the container."""
    qp: dict = {}
    for l in gemm_layers(list(layers)):
        p = params[l.name]
        if l.kind == "conv" and l.groups > 1:
            w3 = stack_grouped_weight(p["w"].float(), l.groups, l.cout)
            q = cm.quantize_linear({"w": w3}, "int8")
            if "b" in p:
                q["b"] = p["b"]
            qp[l.name] = q
        else:
            cont = "int4" if l.name in tuple(int4_names) else container
            qp[l.name] = cm.quantize_linear(p, cont)
    return qp


def int4_eligible(layers: Sequence[Layer], wtab) -> Tuple[str, ...]:
    """GEMM-layer names a serving policy set makes packed-int4 eligible:
    every registered configuration runs the layer at <= 4 bits, it is
    ungrouped, and its output width packs into nibble pairs.  ``wtab``:
    (n_configs, n_gemm) stacked weight-bit tables."""
    gl = gemm_layers(list(layers))
    wmax = np.max(np.asarray(wtab, np.int64).reshape(-1, len(gl)), axis=0)
    return tuple(l.name for i, l in enumerate(gl)
                 if wmax[i] <= 4 and l.groups == 1 and l.cout % 2 == 0)


def _is_serve_form(params: dict, layers: Sequence[Layer]) -> bool:
    for l in layers:
        if l.kind in ("conv", "fc"):
            return "q" in params[l.name] or "q4" in params[l.name]
    return False


def _check_bits(vec, n_gemm: int, which: str):
    if vec is None:
        return None
    v = torch.as_tensor(vec)
    if v.ndim not in (1, 2) or v.shape[-1] != n_gemm:
        raise ValueError(
            f"{which} bit vector has shape {tuple(v.shape)} but the network "
            f"has {n_gemm} GEMM (conv/fc) layers; expand short policy "
            f"tables first (workloads.per_layer_bits or "
            f"PrecisionPolicy.vectors({n_gemm})) — silent clamping would "
            f"misassign per-layer precisions")
    return v


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def cnn_forward(params: dict, x: torch.Tensor, layers: List[Layer],
                wvec=None, avec=None) -> torch.Tensor:
    """End-to-end inference; wvec/avec: per-GEMM-layer bit tensors (the
    HAWQ-V3 Table VII vectors), ``(n_gemm,)`` or ``(B, n_gemm)``, or None
    for fp (train form) / container width (serve form).  Bits clamp to the
    int8 container width in serve form.  Returns float32 logits."""
    n_gemm = sum(1 for l in layers if l.kind in ("conv", "fc"))
    wvec = _check_bits(wvec, n_gemm, "weight")
    avec = _check_bits(avec, n_gemm, "activation")
    serve = _is_serve_form(params, layers)
    if serve:
        # the container holds at most 8 bit planes; >=16 is the fp
        # sentinel, which a quantized container cannot honor
        wvec = wvec.clamp_max(8) if wvec is not None else None
        avec = avec.clamp_max(8) if avec is not None else None
    default = 8 if serve else 16
    gi = 0
    residual: Optional[torch.Tensor] = None
    block_in: Optional[torch.Tensor] = None
    x = x.to(cm.DTYPE)
    for l in layers:
        wb = wvec[..., gi] if wvec is not None else default
        ab = avec[..., gi] if avec is not None else default
        if l.kind == "conv":
            if block_in is None:
                block_in = x
            if l.name.endswith("_down"):
                residual = conv_gemm(params[l.name], block_in, l, wb, ab)
                gi += 1
                continue
            x = conv_gemm(params[l.name], x, l, wb, ab)
            gi += 1
        elif l.kind in ("maxpool", "avgpool"):
            x = pool2d(x, l)
            # a pool ends the residual block: the next conv starts a new
            # block from the POOLED map
            block_in = None
        elif l.kind == "add":
            skip = residual if residual is not None else block_in
            if skip is None or skip.shape != x.shape:
                raise ValueError(
                    f"residual add {l.name!r}: main path {tuple(x.shape)} "
                    f"vs skip "
                    f"{None if skip is None else tuple(skip.shape)} — "
                    f"block wiring is broken (missing/inconsistent "
                    f"downsample projection)")
            x = x + skip
            x = torch.relu(x.float()).to(cm.DTYPE)
            residual, block_in = None, None
        elif l.kind == "fc":
            if x.ndim == 4:
                x = x.reshape(x.shape[0], -1)
            x = cm.apply_linear(params[l.name], x, wb, ab)
            if l.relu:
                x = torch.relu(x.float()).to(cm.DTYPE)
            gi += 1
    return x.float()

"""Flash attention: the hand-written Hopper kernel and its plain versions.

``flash_attention(q, k, v, causal=, window=, k_len=, scale=)`` computes
``softmax(q k^T * scale) v`` per flat head over ``(BH, S, hd)`` tensors.
It is the port of the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention``: f32 running max, sum
and accumulator, masked scores at ``NEG_INF`` with their probabilities
zeroed, P rounded to v's dtype before P.V, the denominator floored at
1e-30 and the output in q's dtype.  The CUDA kernel
(``csrc/flash_attention.cu``) takes bf16 inputs with hd in
:data:`HEAD_DIMS`; the wrapper zero-pads any other hd <= 160 up to the
next of these and slices the output back (zero columns change no score;
the scale stays the real ``hd ** -0.5``).  Each block owns
:data:`QUERY_TILE` query rows (two ``wgmma`` warpgroups of 64) and walks
the keys in tiles of :data:`KEY_TILE`, which TMA copies into a ring of 4
slots at hd 64, 3 at hd 128 and 2 at hd 160; the tensor maps need
16-byte-aligned bases, which the wrapper checks.

Two plain versions sit beside it, as in the reference's ``kernels/ref.py``:

* :func:`flash_attention_ref` — the exact O(Sq*Sk)-memory softmax oracle
  (f32 math); it applies ``window`` whether or not the mask is causal;
* :func:`flash_attention_chunked_ref` — the blockwise online-softmax
  lowering (O(S*chunk) memory), f32 accumulation with tiles in the inputs'
  dtype; it applies ``window`` only when causal.

On a CUDA tensor the wrapper launches the kernel, or raises: there is no
fallback.  On a CPU tensor :func:`repro_torch.kernels.ops.flash_attention`
takes one of the plain versions.  A fake tensor that stands for the
card's (``kernels.card_fake``) pads and allocates without running the
kernel and reports the launch, priced by :func:`work`, to
``kernels.observe``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch import kernels
from repro_torch.kernels import cuda_build

NEG_INF = -1e30
FLASH_CHUNK = 2048
HEAD_DIMS = (64, 128, 160)     # the kernel's template instantiations
QUERY_TILE = 128               # BQ in flash_attention.cu
KEY_TILE = 128                 # BKV in flash_attention.cu

# kernel launches by specialisation, (template head dim, causal, window)
# -> count: the main path's proof that it ran here
spec_launches: Dict[Tuple[int, bool, int], int] = {}


def reset_launches() -> None:
    spec_launches.clear()


def launch_count() -> int:
    """Launches of every specialisation."""
    return sum(spec_launches.values())


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0
                        ) -> torch.Tensor:
    """(BH, Sq, hd) softmax attention oracle (f32 math)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    Sq, Sk = s.shape[1], s.shape[2]
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    vis = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        vis &= kpos <= qpos
    if window:
        vis &= kpos > qpos - window
    s = torch.where(vis[None], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", p, v.float())
    return out.to(q.dtype)


def _pad_axis(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    pad = (-x.shape[axis]) % mult
    if not pad:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def flash_attention_chunked_ref(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, causal: bool = True,
                                window: int = 0, chunk: int = FLASH_CHUNK
                                ) -> torch.Tensor:
    """Blockwise (flash) attention in plain PyTorch: O(S*chunk) memory.

    q: (BH, Sq, hd); k, v: (BH, Sk, hd); positions are 0..S-1.  Scores
    exist only as one (BH, Qc, Kc) tile per step.  Products accumulate in
    f32 from tiles in the inputs' dtype, and P is rounded to v's dtype
    before P.V, as the reference's ``preferred_element_type`` einsums do.
    """
    BH, Sq, hd = q.shape
    Sk = k.shape[1]
    Qc, Kc = min(chunk, Sq), min(chunk, Sk)
    qp = _pad_axis(q, 1, Qc)
    kp = _pad_axis(k, 1, Kc)
    vp = _pad_axis(v, 1, Kc)
    nq, nk = qp.shape[1] // Qc, kp.shape[1] // Kc
    scale = hd ** -0.5
    dev = q.device
    blocks = []
    for i in range(nq):
        qb = qp[:, i * Qc:(i + 1) * Qc].float()
        qpb = torch.arange(i * Qc, (i + 1) * Qc, device=dev)
        m = torch.full((BH, Qc), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((BH, Qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((BH, Qc, hd), dtype=torch.float32, device=dev)
        for j in range(nk):
            kb = kp[:, j * Kc:(j + 1) * Kc]
            vb = vp[:, j * Kc:(j + 1) * Kc]
            kpb = torch.arange(j * Kc, (j + 1) * Kc, device=dev)
            s = torch.einsum("bqd,bkd->bqk", qb, kb.float()) * scale
            vis = (kpb[None, :] < Sk).expand(Qc, Kc)
            if causal:
                vis = vis & (kpb[None, :] <= qpb[:, None])
                if window:
                    vis = vis & (kpb[None, :] > qpb[:, None] - window)
            s = torch.where(vis[None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            p = torch.where(vis[None], p, 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = (acc * corr[..., None]
                   + torch.einsum("bqk,bkd->bqd", p.to(vb.dtype).float(),
                                  vb.float()))
            m = m_new
        blocks.append(acc / l.clamp_min(1e-30)[..., None])
    out = torch.cat(blocks, dim=1)
    return out[:, :Sq].to(q.dtype)


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------

def kernel_head_dim(hd: int) -> int:
    """The template head dim an ``hd``-wide head runs at (zero-padded)."""
    for h in HEAD_DIMS:
        if hd <= h:
            return h
    raise ValueError(f"flash_attention: head dim {hd} exceeds the kernel's "
                     f"largest instantiation, {HEAD_DIMS[-1]}")


def work(BH: int, Sq: int, Sk: int, hd: int, causal: bool,
         window: int = 0) -> Tuple[float, float]:
    """(flops, bytes) one launch must do: 4 hd flops (q.k and p.v) per
    visible (query, key) pair of each flat head, and q, k, v read and
    the output written once in bf16.  The visible pairs are Sq Sk, half
    of that under a causal mask, and exactly those inside the band under
    a causal sliding window (queries at positions Sk - Sq .. Sk - 1)."""
    if causal and window:
        # query i sees min(Sk - Sq + i + 1, window) keys
        first = Sk - Sq + 1
        short = max(0, min(Sq, window - first))     # rows below the band
        pairs = short * (2 * first + short - 1) / 2 + (Sq - short) * window
    else:
        pairs = Sq * Sk / (2 if causal else 1)
    return 4.0 * BH * pairs * hd, float(2 * BH * (Sq + Sk) * hd * 2)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError("flash_attention takes (BH, S, hd) tensors")
    if k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[2] != k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         f"(BH, Sq, hd), (BH, Sk, hd), (BH, Sk, hd)")
    if not (q.device == k.device == v.device):
        raise ValueError(f"operands on {q.device}, {k.device}, {v.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, k_len: int = 0,
                    scale: float = 0.0) -> torch.Tensor:
    """The CUDA kernel: bf16 (BH, Sq, hd) x (BH, Sk, hd)^2 -> (BH, Sq, hd).

    ``k_len`` (default Sk) hides keys at or past it; ``scale`` defaults to
    ``hd ** -0.5`` of the unpadded hd.  CUDA tensors only: the plain
    versions above serve the CPU.  Operands that require grad raise
    under grad mode: nothing here records a graph."""
    _check(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward: the kernel is forward-only, "
            "as the reference's is, and its output would carry no gradient "
            "to q, k or v (the backward kernel is ROADMAP Queue B 3 (a)); "
            "train at sequences of at most transformer.FLASH_THRESHOLD, or "
            "call it under torch.no_grad()")
    fake = kernels.card_fake(q)           # the lowering report's launch
    if q.device.type != "cuda" and not fake:
        raise ValueError(f"flash_attention's kernel runs on cuda tensors, "
                         f"not {q.device} (the plain versions serve the "
                         f"CPU)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention: the kernel takes bf16, got "
                            f"{name} in {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: the kernel takes contiguous "
                             f"(BH, S, hd) tensors; {name} is not")
    BH, Sq, hd = q.shape
    Sk = k.shape[1]
    if BH > 65535 or max(Sq, Sk) >= 2 ** 31:
        raise ValueError(f"flash_attention: (BH, Sq, Sk) = ({BH}, {Sq}, "
                         f"{Sk}) exceeds the kernel's grid")
    hk = kernel_head_dim(hd)
    if hk != hd:                       # zero columns change no score
        pad = (0, hk - hd)
        q, k, v = (torch.nn.functional.pad(t, pad) for t in (q, k, v))
    for name, t in (("q", q), ("k", k), ("v", v)):
        offset = (t.storage_offset() * t.element_size() if fake
                  else t.data_ptr())
        if offset % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             f"aligned")
    out = torch.empty((BH, Sq, hk), dtype=torch.bfloat16, device=q.device)
    spec = (hk, bool(causal), int(window))
    if fake:                # priced, not counted: nothing was launched
        kernels.launched("flash_attention", spec,
                         *work(BH, Sq, Sk, hd, causal, window), "bf16")
        return out if hk == hd else out[..., :hd]
    fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 BH, Sq, Sk, hk, k_len or Sk, int(causal), int(window),
                 float(scale or hd ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err} at BH={BH}, Sq={Sq}, Sk={Sk}, "
                           f"hd={hd}")
    spec_launches[spec] = spec_launches.get(spec, 0) + 1
    return out if hk == hd else out[..., :hd]


@functools.cache
def _entry():
    lib = cuda_build.load("flash_attention")
    fn = lib.flash_attention_bf16
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn

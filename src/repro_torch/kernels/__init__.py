"""repro_torch.kernels — hand-written Hopper kernels and their dispatch.

bitplane_matmul   the bit-plane int8 GEMM (CUDA, csrc/) + plain version
int4_matmul       the packed-int4 GEMM (CUDA, csrc/) + plain version
quant_matmul      the int8 GEMM with a fused dequant/bias/act epilogue
                  (CUDA, csrc/) + plain version
flash_attention   flash attention (CUDA, csrc/) + its two plain versions
cuda_build        nvcc build-at-first-use and ctypes loading
ops               serve-form linears (container, packed-int4, stacked and
                  bit-grouped paths), the public GEMM entries and the
                  flat-head attention dispatch

:func:`launch_keys` is one read-only view of the four wrappers' launch
counters, keyed by kernel specialisation; :func:`launches_since` is what
ran after an earlier snapshot of it.

Fake tensors stand for the card's in the lowering report
(``repro_torch.launch.opcost``): a fake CUDA tensor, or under
:func:`as_card` any fake tensor, takes each wrapper's fake branch,
which plans, allocates the output and scratch on the fake device,
runs nothing, and tells the :func:`observe` callbacks the launch a card
run would make: its :func:`launch_keys` key and its ``work``.  It adds
nothing to the launch counters, which count real launches only.
:func:`as_card` exists because a CPU-only torch cannot index a fake CUDA
tensor from Python.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake

_as_card = False
_observers: List[Callable] = []


@contextlib.contextmanager
def as_card():
    """Fake tensors of any device stand for the card's in the enclosed
    block (the wrappers take their fake branches)."""
    global _as_card
    prev, _as_card = _as_card, True
    try:
        yield
    finally:
        _as_card = prev


def card_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor that stands for the card's: a fake
    CUDA tensor, or under :func:`as_card` any fake tensor."""
    return is_fake(t) and (_as_card or t.device.type == "cuda")


def fake_aligned(t: torch.Tensor) -> bool:
    """A fake tensor's 16-byte alignment as the card would see it: its
    storage offset (the caching allocator's bases are 512-aligned)."""
    return t.storage_offset() * t.element_size() % 16 == 0


@contextlib.contextmanager
def observe(fn: Callable):
    """Call ``fn(kernel, key, ops, nbytes, dtype)`` for every launch a
    wrapper's fake branch stands for in the enclosed block: the kernel's
    name, its :func:`launch_keys` key, and its ``work`` (operations,
    bytes moved, and the operands' type)."""
    _observers.append(fn)
    try:
        yield
    finally:
        _observers.remove(fn)


def launched(kernel: str, key: Tuple, ops: float, nbytes: float,
             dtype: str) -> None:
    """A fake branch's launch, told to the :func:`observe` callbacks."""
    for fn in list(_observers):
        fn(kernel, key, ops, nbytes, dtype)


def launch_keys() -> Dict[Tuple, int]:
    """A snapshot of every launch so far, by kernel specialisation:
    ``("bitplane_matmul", path, n_planes, M, K, N)``,
    ``("flash_attention", head dim, causal, window)``,
    ``("int4_matmul", path)`` and ``("quant_matmul", act, path)`` ->
    launches.  The difference of two snapshots is what ran between
    them; the wrappers count only where they launch a kernel, so it is
    empty on the CPU."""
    from repro_torch.kernels import bitplane_matmul as bpm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int4_matmul as i4mm
    from repro_torch.kernels import quant_matmul as qmm

    out: Dict[Tuple, int] = {}
    for key, n in bpm.spec_launches.items():
        out[("bitplane_matmul",) + key] = n
    for key, n in fa.spec_launches.items():
        out[("flash_attention",) + key] = n
    for path, n in i4mm.path_launches.items():
        if n:
            out[("int4_matmul", path)] = n
    for key, n in qmm.spec_launches.items():
        out[("quant_matmul",) + key] = n
    return out


def launches_since(before: Dict[Tuple, int]) -> Dict[Tuple, int]:
    """The launches by kernel specialisation since ``before``, a
    :func:`launch_keys` snapshot; specialisations that did not run are
    left out."""
    return {k: n - before.get(k, 0) for k, n in launch_keys().items()
            if n != before.get(k, 0)}

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
"""
from __future__ import annotations

from typing import Dict, Tuple


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

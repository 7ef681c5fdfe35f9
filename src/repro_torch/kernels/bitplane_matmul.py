"""Bit-plane int8 GEMM: the hand-written Hopper kernel and its plain version.

``bitplane_matmul(x_q, w_q, n_planes)`` computes int8 ``(M, K)`` times the
low ``n_planes`` two's-complement field of an int8 weight container
``(K, N)``, accumulated exactly in int32 -> ``(M, N)``.  It is the port of
the Pallas TPU kernel ``repro.kernels.bitplane_matmul.bitplane_matmul``:
there the field is walked plane by plane (plane j weighted 2^j, the sign
plane -2^(n-1)); the weighted planes reassemble the sign-extended field,
so the CUDA kernels (``csrc/bitplane_matmul.cu``) sign-extend each weight
once and run one int8 product, in one of two regimes that :func:`plan`
picks from the shape:

* ``small_m`` (M <= :data:`SMALL_M`): a split-K GEMV on ``mma.sync``
  that reads w in 16-byte pieces along N and adds each K slice's int32
  partials into the output with integer atomics (exact);
* ``large_m``: a pre-pass writes the sign-extended field K-major into an
  ``(N, K')`` int8 scratch (``K'`` = K rounded up to 16) that the wrapper
  allocates per call, then a ``wgmma`` GEMM fed by a TMA ring reads it.
  TMA needs x's rows 16-byte aligned; when they are not (K % 16, or an
  unaligned view), the same pre-pass re-pitches x into an ``(M, K')``
  part of the scratch (``copy_x``).

On a CUDA tensor the wrapper launches the kernel, or raises: there is no
fallback.  On a CPU tensor it takes the plain version,
:func:`bitplane_matmul_ref`, which is also the oracle the kernel is held
against on the card.  A fake tensor that stands for the card's
(``kernels.card_fake``) plans and allocates as the card does, runs
nothing and reports the launch, priced by :func:`work`, to
``kernels.observe``; the launch counters count real launches only.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch import kernels
from repro_torch.kernels import cuda_build

# the kernel's paths: the small-M GEMV, or the large-M wgmma GEMM with x
# read in place or re-pitched first (rows not 16-byte aligned)
PATHS = ("small_m", "large_m", "large_m_copy_x")
# kernel launches by specialisation, (path, n_planes, M, K, N) -> count:
# the main path's proof that it ran here.  The launches_by_* views below
# are sums over it.
spec_launches: Dict[Tuple[str, int, int, int, int], int] = {}

SMALL_M = 16          # the GEMV's rows: one m16 tile of mma.sync
GEMV_COLS = 128       # output columns per GEMV block
GEMV_WARPS = 8        # warps per GEMV block, one k32 step each at a time
GEMV_MAX_STEPS = 64   # k32 steps per split (its x slice in shared memory)
K_PAD = 16            # the K-major scratch's row: TMA's 16-byte stride
H100_SMS = 132


def reset_launches() -> None:
    spec_launches.clear()


def launches_by_planes() -> Dict[int, int]:
    """Launches per n_planes (1..8, zeros included)."""
    out = {n: 0 for n in range(1, 9)}
    for (_, n, _, _, _), c in spec_launches.items():
        out[n] += c
    return out


def launches_by_path() -> Dict[str, int]:
    """Launches per path (every PATHS entry, zeros included)."""
    out = {p: 0 for p in PATHS}
    for (path, _, _, _, _), c in spec_launches.items():
        out[path] += c
    return out


def launches_by_shape() -> Dict[Tuple[int, int, int, int], int]:
    """Launches per (M, K, N, n_planes)."""
    out: Dict[Tuple[int, int, int, int], int] = {}
    for (_, n, M, K, N), c in spec_launches.items():
        out[(M, K, N, n)] = out.get((M, K, N, n), 0) + c
    return out


@dataclass(frozen=True)
class Plan:
    """How a kernel runs one ``(M, K) @ (K, N)``: the bit-plane kernel's
    plan, shared by ``quant_matmul`` and ``int4_matmul`` (N in logical
    columns).  ``regime`` is ``"small_m"`` or ``"large_m"``.  A GEMV
    splits K into ``splits`` slices of ``steps`` 32-deep steps, one block
    per slice and 128 output columns; the large-M regime needs an
    ``(N, k_pad)`` int8 scratch, and ``(M, k_pad)`` more when ``copy_x``
    (x's rows are not 16-byte aligned, so TMA reads a re-pitched copy)."""
    regime: str
    splits: int = 1
    steps: int = 0
    k_pad: int = 0
    copy_x: bool = False

    @property
    def path(self) -> str:
        return "large_m_copy_x" if self.copy_x else self.regime

    def scratch_bytes(self, M: int, N: int) -> int:
        return (N + (M if self.copy_x else 0)) * self.k_pad

    @staticmethod
    def slabs(N: int) -> int:
        """GEMV blocks across N: one per :data:`GEMV_COLS` columns."""
        return -(-N // GEMV_COLS)

    def partial_bytes(self, M: int, N: int) -> int:
        """The int32 (M, N) scratch a split GEMV whose output is not its
        int32 sum (``quant_matmul``, ``int4_matmul``) adds its partials
        into before the epilogue; none when K is not split."""
        return 4 * M * N if self.regime == "small_m" and self.splits > 1 \
            else 0


@functools.lru_cache(maxsize=4096)
def plan(M: int, K: int, N: int, sms: int = H100_SMS,
         x_aligned: bool = True) -> Plan:
    """The regime from M; for a GEMV, the split of K that fills one wave
    of two blocks on each of ``sms`` SMs (the most a GEMV block's
    registers let an SM hold: a block more starts a second, mostly idle
    wave), with at least one k32 step per warp and at most
    :data:`GEMV_MAX_STEPS` steps per split; for the large-M
    regime, whether x must be re-pitched (K % 16, or ``x_aligned`` false:
    its base is not 16-byte aligned)."""
    if M <= 0 or K <= 0 or N <= 0:
        raise ValueError(f"bitplane_matmul: empty shape ({M}, {K}) @ "
                         f"({K}, {N})")
    if M > SMALL_M:
        return Plan("large_m", k_pad=-(-K // K_PAD) * K_PAD,
                    copy_x=bool(K % K_PAD) or not x_aligned)
    cols = Plan.slabs(N)
    total = -(-K // 32)
    want = 2 * sms // cols
    splits = max(1, min(want, total // GEMV_WARPS))
    steps = min(-(-total // splits), GEMV_MAX_STEPS)
    splits = -(-total // steps)
    return Plan("small_m", splits=splits, steps=steps)


def alloc_scratch(p: Plan, M: int, N: int, device, partials: bool = False):
    """The plan's scratch for one call (nothing is cached): the large-M
    regime's K-major weight and re-pitched x; with ``partials``, a split
    GEMV's int32 partial and one arrival counter per slab.  None where
    the plan needs none."""
    if p.regime == "large_m":
        nbytes = p.scratch_bytes(M, N)
    elif partials and p.splits > 1:
        nbytes = p.partial_bytes(M, N) + 4 * p.slabs(N)
    else:
        return None
    return torch.empty(nbytes, dtype=torch.int8, device=device)


def sign_extend_field(w_q: torch.Tensor, n_planes: int) -> torch.Tensor:
    """The low ``n_planes`` bits of each int8, read as two's complement."""
    field = w_q.to(torch.int32) & ((1 << n_planes) - 1)
    sign = (field >> (n_planes - 1)) & 1
    return (field - sign * (1 << n_planes)).to(torch.int8)


def bitplane_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor,
                        n_planes: int = 8) -> torch.Tensor:
    """Plain version: mask, sign-extend, one exact integer product.

    The product runs in float64, on any device: every int8 x int8 term and
    every partial sum is an integer below 2^53 for K < 2^38, so the result
    is exact whatever the summation order (an int8 ``torch.mm`` would wrap
    at int8, and CUDA has no integer ``torch.mm``)."""
    w = sign_extend_field(w_q, n_planes)
    return (x_q.to(torch.float64) @ w.to(torch.float64)).to(torch.int32)


def work(M: int, K: int, N: int) -> Tuple[float, float]:
    """(operations, bytes) one launch at (M, K, N) must do: 2 M N K int8
    multiply-adds, each input read once (x, w) and the int32 output
    written once.  The bound of ``chip_smoke.py``'s table and the
    lowering report's price of a launch."""
    return 2.0 * M * N * K, float(M * K + K * N + 4 * M * N)


def _check(x_q: torch.Tensor, w_q: torch.Tensor, n_planes: int) -> None:
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"bitplane_matmul takes int8 operands, got "
                        f"{x_q.dtype} and {w_q.dtype}")
    if x_q.ndim != 2 or w_q.ndim != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"bitplane_matmul: shapes {tuple(x_q.shape)} @ "
                         f"{tuple(w_q.shape)} are not (M, K) @ (K, N)")
    if not 1 <= n_planes <= 8:
        raise ValueError(f"n_planes must be in 1..8, got {n_planes}")
    if x_q.device != w_q.device:
        raise ValueError(f"operands on {x_q.device} and {w_q.device}")


def bitplane_matmul(x_q: torch.Tensor, w_q: torch.Tensor, *,
                    n_planes: int = 8) -> torch.Tensor:
    """int8 (M, K) @ int8-container (K, N) -> int32 (M, N) at ``n_planes``."""
    _check(x_q, w_q, n_planes)
    dev = x_q.device
    fake = kernels.card_fake(x_q)         # the lowering report's launch
    if dev.type == "cpu" and not fake:
        return bitplane_matmul_ref(x_q, w_q, n_planes)
    if dev.type != "cuda" and not fake:
        raise ValueError(f"bitplane_matmul runs on cuda or cpu tensors, "
                         f"not {dev}")
    if not (x_q.is_contiguous() and w_q.is_contiguous()):
        raise ValueError("bitplane_matmul: the kernel takes contiguous "
                         "row-major operands")
    M, K = x_q.shape
    N = w_q.shape[1]
    if max(M, K, N) >= 2 ** 31 or M * N >= 2 ** 40:
        raise ValueError(f"bitplane_matmul: ({M}, {K}) @ ({K}, {N}) exceeds "
                         f"the kernel's grid")
    if fake:
        p = plan(M, K, N, H100_SMS, kernels.fake_aligned(x_q))
    else:
        p = plan(M, K, N, sm_count(dev), x_q.data_ptr() % 16 == 0)
    out = torch.empty((M, N), dtype=torch.int32, device=dev)
    scratch = alloc_scratch(p, M, N, dev)
    spec = (p.path, n_planes, M, K, N)
    if fake:                # priced, not counted: nothing was launched
        kernels.launched("bitplane_matmul", spec, *work(M, K, N), "int8")
        return out
    err = _entry()(x_q.data_ptr(), w_q.data_ptr(), out.data_ptr(),
                   ptr_or_none(scratch), M, N, K, n_planes, p.steps,
                   int(p.copy_x), current_stream(dev))
    if err != 0:
        raise RuntimeError(f"bitplane_matmul kernel launch failed: CUDA "
                           f"error {err} at ({M}, {K}) @ ({K}, {N}), "
                           f"n_planes={n_planes}, plan {p}")
    spec_launches[spec] = spec_launches.get(spec, 0) + 1
    return out


# the current stream's handle without building a Stream object (a CUDA
# build's hook; the slower public call serves where it is missing)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def ptr_or_none(t):
    return t.data_ptr() if t is not None else None


def current_stream(dev: torch.device) -> int:
    """The handle of ``dev``'s current stream, for a launch (the thin
    path of the three int8 GEMM wrappers)."""
    if _raw_stream is not None:
        return _raw_stream(dev.index)
    return torch.cuda.current_stream(dev).cuda_stream


@functools.cache
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _entry():
    lib = cuda_build.load("bitplane_matmul")
    fn = lib.bitplane_matmul_s8
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn

"""Derived metrics + the Table VIII peak-performance model.

Peak throughput: all 19.66M CAP rows hold one MAC each; the bit-serial
multiply + amortized vertical add complete in ``3M^2 + 11M`` cycles at 1 GHz
(counting 2 ops per MAC).  This cycle polynomial reproduces the paper's
published peaks EXACTLY for all three precisions:

    M=1 : 14 cy   -> 2,808,686 GOPS   (paper: 2,808,686)
    M=8 : 280 cy  ->   140,434 GOPS   (paper:   140,434)
    M=16: 944 cy  ->    41,654 GOPS   (paper:    41,654)

i.e. the paper's peak model is cycles(M) = 3M^2 + 11M — consistent with a
LUT walk of 3 compare-dominated passes per bit pair plus ~11 linear-cost
populate/readout passes per bit.  (Reverse-engineered; noted in
EXPERIMENTS.md.)

Peak power uses the same cell-energy accounting as the end-to-end simulator
(multiply-phase compares dominate), so peak GOPS/W is a *prediction* — the
paper does not state its power basis; deltas are reported.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.apsim import costmodel as cmod
from repro_torch.apsim.energy import TechParams, SRAM
from repro_torch.apsim.mapper import BFIMNAConfig, LR_CONFIG, _gemm_layer
from repro_torch.apsim.workloads import Layer, fc, gemm_layers


def peak_cycles(M: int) -> float:
    return 3.0 * M * M + 11.0 * M


def peak_gops(M: int, cfg: BFIMNAConfig = LR_CONFIG) -> float:
    ops = 2.0 * cfg.total_rows
    return ops / peak_cycles(M) * (cfg.freq_hz / 1e9)


def peak_energy_per_mac_j(M: int, tech: TechParams = SRAM) -> float:
    """Paper peak-power basis: ONE compare-energy per bit-pair pass per
    row — e_mac(M) = E_compare * (M^2 + M).

    Reverse-engineered by fitting the paper's three published GOPS/W
    points (22879@1b, 641@8b, 170@16b): the quadratic coefficient of the
    fit, 4.31e-14 J, matches our independently Fig.6/7-calibrated
    E_COMPARE_J = 4.59e-14 J within 6% — i.e. the paper's peak model
    charges the multiply's M^2 bit-pair walk plus an M-linear add at one
    compare-energy each, per resident MAC.  (The end-to-end simulator
    keeps the full cell-level accounting; this basis is used only for the
    Table VIII peaks, like the paper's 'peak values [40]'.)"""
    cell_ops = float(M * M + M)
    return cell_ops * tech.e_compare_j + 2.0 * M * tech.e_write_j


def peak_gops_per_w(M: int, tech: TechParams = SRAM,
                    cfg: BFIMNAConfig = LR_CONFIG) -> float:
    ops_per_j = 2.0 / peak_energy_per_mac_j(M, tech)
    return ops_per_j / 1e9


# ---------------------------------------------------------------------------
# Bit-vector pricing — the serve engine's per-request latency/EDP accounting.
#
# A language model's serve path is, per token, a fixed list of GEMVs whose
# dims come from the model config (lm.layer_gemm_dims); a request's resolved
# per-layer (wbits, abits) vector prices each slot's GEMVs on the AP via the
# same calibrated mapping the paper benchmarks use (mapper._gemm_layer on an
# FC layer — (1, K) @ (K, N) is exactly the paper's FC case).  This is the
# Table 7 accuracy-vs-EDP trade-off made live: every admitted request gets
# AP cycles/energy per token, and RequestStats reports latency/EDP.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BitVectorCost:
    """Per-token AP cost of one resolved per-layer bit vector.

    ``per_layer_*`` align with the bit-slot axis (plus one trailing entry
    for the logits head when it was priced); totals derive from them."""
    per_layer_cycles: Tuple[float, ...]
    per_layer_energy_j: Tuple[float, ...]
    freq_hz: float = 1e9

    @property
    def cycles(self) -> float:
        return sum(self.per_layer_cycles)

    @property
    def energy_j(self) -> float:
        return sum(self.per_layer_energy_j)

    @property
    def latency_s(self) -> float:
        return self.cycles / self.freq_hz

    @property
    def edp(self) -> float:
        """Per-token energy-delay product (J·s)."""
        return self.energy_j * self.latency_s


def _clamp_bits(b) -> int:
    return int(min(max(int(b), 1), 16))


@functools.lru_cache(maxsize=4096)
def gemv_cost(K: int, N: int, Mw: int, Ma: int, *,
              cfg: BFIMNAConfig = LR_CONFIG,
              tech: TechParams = SRAM) -> Tuple[float, float]:
    """(cycles, energy_j) of one serve GEMV (1, K) @ (K, N) at (Mw, Ma),
    under the paper's batch-size-1 CNN mapping (``mapper._gemm_layer``).

    Cached: uniform bit vectors price every layer to the same (K, N, Mw,
    Ma) tuples, so per-request admission pays the analytic mapping once
    per distinct shape/bits pair, not once per layer."""
    rep = _gemm_layer(cfg, tech, fc(f"gemv_{K}x{N}", K, N, relu=False),
                      Mw, Ma)
    return rep.cycles, rep.energy_j


@functools.lru_cache(maxsize=8192)
def serve_gemv_cost(K: int, N: int, Mw: int, Ma: int, u: int = 1, *,
                    cfg: BFIMNAConfig = LR_CONFIG,
                    tech: TechParams = SRAM) -> Tuple[float, float]:
    """(cycles, energy_j) of a serve GEMM (u, K) @ (K, N) at (Mw, Ma)
    under the latency-optimal *decode* mapping.

    The paper mapping (:func:`gemv_cost`) packs ``opc`` output blocks per
    CAP and charges their reductions sequentially — correct when a layer's
    blocks fill every CAP (the Table V-VII CNN regime), but a serve GEMV
    has only N·u output blocks for 4096 CAPs, so almost every CAP is idle
    and each holds a single block.  Two refinements, both only meaningful
    in that underutilized regime (at full occupancy they reduce to the
    paper mapping, which keeps the calibrated CNN tables byte-identical):

    * **occupancy-aware reduction**: a CAP only reduces the blocks it
      actually holds — ``min(opc, ceil(blocks / n_caps))``, not ``opc``;
    * **latency-optimal fold**: with idle CAPs available the mapper may
      split one block's K products over ``f`` CAPs (the existing
      ``j_fold`` mechanism), shrinking the in-CAP chain to ``ceil(K/f)-1``
      adds at the cost of ``ceil(log2 f)`` cross-CAP partial-sum merge
      rounds (charged per round, unlike the paper path's single round,
      i.e. strictly *more* conservative per fold) and ``f``× activation
      streaming energy.  The fold is chosen by exhaustive argmin over
      modeled cycles; energy is reported at the chosen fold.

    Under this mapping decode latency is genuinely bit-dependent (the
    4·Mw·Ma multiply passes dominate once the chain is short) and a
    ``u``-token verify chunk amortizes the pass over u tokens — the two
    properties bit-fluid speculative decoding prices against.
    """
    i, j = N, K
    best: Optional[Tuple[float, float]] = None
    max_f = min(j, 256)
    for f in range(1, max_f + 1):
        j_sub = math.ceil(j / f)
        if j_sub > cfg.cap_rows - 1:
            continue
        opc = max(1, (cfg.cap_rows - 1) // j_sub)
        total_blocks = i * u * f
        steps = math.ceil(total_blocks / (cfg.n_caps * opc))
        occ = min(opc, math.ceil(total_blocks / cfg.n_caps))
        per_step = cmod.Cost()
        per_step.writes += Ma                        # stream activations
        passes = 4 * Mw * Ma                         # bit-serial multiply
        per_step.compares += passes
        per_step.writes += passes
        seq_adds = occ * max(j_sub - 1, 0)           # resident blocks only
        per_step.compares += 4 * seq_adds
        per_step.writes += 4 * seq_adds
        per_step.word_ops += occ
        cycles = steps * per_step.cycles(tech) + Mw * tech.write_cycles
        width = Mw + Ma + math.log2(max(j, 2))
        if f > 1:                                    # cross-CAP merges,
            merge_rounds = math.ceil(math.log2(f))   # charged per round
            cycles += steps * merge_rounds * 8 * width * tech.write_cycles * 0.5
        out_bits_elem = Mw + Ma + math.ceil(math.log2(max(j, 2)))
        out_bits = i * u * out_bits_elem
        cycles += cfg.mesh.transfer_latency_s(out_bits) * cfg.freq_hz
        # ---- energy at this fold (same accounting as _gemm_layer) ------
        comp = cmod.rt_matmat(i, j, u, Mw, Ma, mode="2d",
                              parallel_blocks=cfg.n_caps * opc)
        energy = comp.energy_j(tech)
        in_bits = j * u * Ma * f
        w_bits = i * j * Mw
        move_bits = in_bits + w_bits + out_bits
        energy += cfg.mesh.transfer_energy_j(move_bits)
        energy += 2.0 * i * u * out_bits_elem * (tech.e_write_j
                                                 + tech.e_read_j) / 2.0
        if f > 1:                                    # partial-sum merge adds
            energy += (f - 1) * i * u * cmod.rt_add(
                math.ceil(width), 2, populate=False, readout=False
            ).energy_j(tech)
        if best is None or cycles < best[0]:
            best = (cycles, energy)
    assert best is not None
    return best


@functools.lru_cache(maxsize=4096)
def layer_gemm_cost(layer: Layer, Mw: int, Ma: int, *,
                    cfg: BFIMNAConfig = LR_CONFIG,
                    tech: TechParams = SRAM) -> Tuple[float, float]:
    """(cycles, energy_j) of one full conv/fc GEMM layer at (Mw, Ma) —
    the CNN serve path's per-image pricing unit: the layer's (i, j, u)
    GEMM through the same calibrated mapping the paper benchmarks use
    (``mapper._gemm_layer``, paper batch size 1).  Cached per distinct
    (layer, bits) pair, like :func:`gemv_cost`."""
    rep = _gemm_layer(cfg, tech, layer, Mw, Ma)
    return rep.cycles, rep.energy_j


def network_gemms(layers: Sequence[Layer]) -> Tuple[Tuple[Layer, ...], ...]:
    """Per-bit-slot pricing entries for a CNN workload: one conv/fc
    :class:`Layer` per slot — ``price_bit_vector`` prices Layer items
    through :func:`layer_gemm_cost` (full conv-as-GEMM cost) alongside
    plain (K, N) GEMV pairs (the LM serve path)."""
    return tuple((l,) for l in gemm_layers(list(layers)))


def price_bit_vector(gemms: Sequence[Sequence],
                     wvec: Sequence[int], avec: Sequence[int], *,
                     head: Optional[Tuple[int, int]] = None,
                     units: int = 1,
                     cfg: BFIMNAConfig = LR_CONFIG,
                     tech: TechParams = SRAM) -> BitVectorCost:
    """Price a resolved per-layer bit vector against its model's GEMMs.

    ``gemms``: one sequence of GEMM descriptors per bit slot — (K, N)
    pairs for serve GEMVs (see ``lm.layer_gemm_dims``), priced under the
    latency-optimal decode mapping (:func:`serve_gemv_cost`), or workload
    :class:`Layer` records for full conv/fc GEMMs (see
    :func:`network_gemms`), priced under the paper mapping; ``head``,
    when given, is priced at the last slot's bits (the logits-GEMM rule)
    and appended as a trailing entry.  Bits clamp into [1, 16] (>= 16 is
    the fp sentinel).  ``units`` batches every (K, N) GEMV over u tokens
    (the speculative verify chunk) — Layer items reject units != 1.
    """
    if len(wvec) != len(gemms) or len(avec) != len(gemms):
        raise ValueError(
            f"bit vectors (len {len(wvec)}/{len(avec)}) do not match the "
            f"model's {len(gemms)} bit slots")
    cyc, en = [], []
    for dims, w, a in zip(gemms, wvec, avec):
        c, e = _slot_cost(dims, _clamp_bits(w), _clamp_bits(a), cfg, tech,
                          units)
        cyc.append(c)
        en.append(e)
    if head is not None:
        ci, ei = serve_gemv_cost(head[0], head[1], _clamp_bits(wvec[-1]),
                                 _clamp_bits(avec[-1]), units,
                                 cfg=cfg, tech=tech)
        cyc.append(ci)
        en.append(ei)
    return BitVectorCost(tuple(cyc), tuple(en), cfg.freq_hz)


def _slot_cost(dims: Sequence, Mw: int, Ma: int, cfg: BFIMNAConfig,
               tech: TechParams, units: int = 1) -> Tuple[float, float]:
    """(cycles, energy_j) of one bit slot's GEMM descriptors at (Mw, Ma).

    Single accumulation point for both the per-vector and per-matrix
    pricers, so the two are bit-identical (same item order, same float
    summation order)."""
    c = e = 0.0
    for item in dims:
        if isinstance(item, Layer):
            if units != 1:
                raise ValueError(
                    "chunked pricing (units != 1) only applies to serve "
                    "GEMV slots, not full conv/fc Layer slots")
            ci, ei = layer_gemm_cost(item, Mw, Ma, cfg=cfg, tech=tech)
        else:
            K, N = item
            ci, ei = serve_gemv_cost(K, N, Mw, Ma, units, cfg=cfg,
                                     tech=tech)
        c += ci
        e += ei
    return c, e


def price_bit_matrix(gemms: Sequence[Sequence], wmat, amat, *,
                     head: Optional[Tuple[int, int]] = None,
                     cfg: BFIMNAConfig = LR_CONFIG,
                     tech: TechParams = SRAM) -> List[BitVectorCost]:
    """Price a whole ``(B, n_slots)`` bit matrix in one pass.

    The serving runtime admits batches, not vectors: every admission
    round resolves a ``(B, n_slots)`` bit matrix, and pricing it row by
    row through :func:`price_bit_vector` costs ``B * n_slots`` Python
    loop iterations even when the controller only ever emits a handful
    of distinct configurations.  Here the analytic mapping runs once per
    *distinct clamped (wbits, abits) pair per slot* — the matrix then
    gathers its per-slot costs with numpy, so a B=32 batch over a
    5-config controller pays ~``n_pairs * n_slots`` mapping lookups
    (all LRU-cached) plus one vectorized gather.  Rows with identical
    bit vectors share ONE :class:`BitVectorCost` object (callers rely on
    identity for their own caches).  Row semantics are exactly
    :func:`price_bit_vector`'s, bit-identical per row.
    """
    wmat = np.asarray(wmat, np.int64)
    amat = np.asarray(amat, np.int64)
    if wmat.ndim == 1:
        wmat, amat = wmat[None], amat[None]
    if wmat.shape != amat.shape or wmat.ndim != 2:
        raise ValueError(f"bit matrices must share a (B, n_slots) shape, "
                         f"got {wmat.shape} / {amat.shape}")
    B, L = wmat.shape
    if L != len(gemms):
        raise ValueError(f"bit matrices (n_slots {L}) do not match the "
                         f"model's {len(gemms)} bit slots")
    wc = np.clip(wmat, 1, 16)
    ac = np.clip(amat, 1, 16)
    pairs = np.stack([wc, ac], axis=-1).reshape(-1, 2)
    uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
    inv = inv.reshape(B, L)
    cyc_tab = np.empty((uniq.shape[0], L))
    en_tab = np.empty((uniq.shape[0], L))
    head_tab = np.empty((uniq.shape[0], 2))
    for pi, (Mw, Ma) in enumerate(uniq):
        for s, dims in enumerate(gemms):
            cyc_tab[pi, s], en_tab[pi, s] = _slot_cost(
                dims, int(Mw), int(Ma), cfg, tech)
        if head is not None:
            head_tab[pi] = serve_gemv_cost(head[0], head[1], int(Mw),
                                           int(Ma), cfg=cfg, tech=tech)
    cyc = cyc_tab[inv, np.arange(L)[None, :]]            # (B, L) gathers
    en = en_tab[inv, np.arange(L)[None, :]]
    out: List[BitVectorCost] = []
    shared: Dict[bytes, BitVectorCost] = {}
    for i in range(B):
        key = wc[i].tobytes() + b"|" + ac[i].tobytes()
        hit = shared.get(key)
        if hit is None:
            pc = tuple(float(v) for v in cyc[i])
            pe = tuple(float(v) for v in en[i])
            if head is not None:
                hc, he = head_tab[inv[i, -1]]
                pc, pe = pc + (float(hc),), pe + (float(he),)
            hit = BitVectorCost(pc, pe, cfg.freq_hz)
            shared[key] = hit
        out.append(hit)
    return out


PAPER_TABLE8 = {
    # framework: (tech node, freq GHz, precision, GOPS, GOPS/W)
    "H100 GPU": ("TSMC 4N", 1.83, 8, 1_979_000, 2827),
    "TPUv4": ("7nm", 1.05, 8, 275_000, 1432),
    "Valavi [43]": ("65nm", 0.1, 1, 18_876, 866_000),
    "Sim [37]": ("65nm", 0.125, 16, 64, 1422),
    "DaDianNao": ("32nm", 0.606, 16, 5584, 278),
    "ISAAC": ("32nm-memristive", 1.2, 16, 40_907, 622),
    "PipeLayer": ("50nm-memristive", None, 16, 122_706, 143),
    "IMCA": ("65nm", 1.0, 8, 3, 4630),
    "PUMA": ("32nm-memristive", 1.0, 16, 52_310, 840),
    "BF-IMNA_1b (paper)": ("16nm", 1.0, 1, 2_808_686, 22_879),
    "BF-IMNA_8b (paper)": ("16nm", 1.0, 8, 140_434, 641),
    "BF-IMNA_16b (paper)": ("16nm", 1.0, 16, 41_654, 170),
}

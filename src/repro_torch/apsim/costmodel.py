"""AP runtime/cost models — Eqs. 1-15 and Tables I & II of the BF-IMNA paper.

Every AP operation is a sequence of *compare* / *write* / *read* passes.
Table I counts passes; latency multiplies pass counts by per-pass cycle
costs (technology dependent -- ReRAM writes are slower), and energy
multiplies *cell-level* op counts (how many CAM cells each pass touches)
by per-cell energies from ``energy.TechParams``.

Conventions (paper section III.B):
  * ``M``     operand bitwidth.  Mixed precision multiply uses ``Mw * Ma``.
  * ``L``     number of words stored in the AP (2 words per row).
  * a *pass* = one compare phase + (on average) one write phase applied to a
    pair of columns (horizontal mode) or a pair of rows (vertical mode);
    the LUTs of add/multiply have 4 passes per bit position.
  * bit-sequential column write/read touches all L rows of one column;
    word-sequential read/write of one word costs 2 cycles (paper: "two-cycle
    requirement per writing a row/column").

All ``rt_*`` functions return a :class:`Cost` whose ``ops`` drive latency
and whose ``cells`` drive energy.  ``mode`` selects the AP flavour of
Table I: ``"1d"``, ``"2d"`` (no segmentation -- the BF-IMNA design point),
or ``"2dseg"``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

MODES = ("1d", "2d", "2dseg")


@dataclasses.dataclass
class Cost:
    """Pass-level op counts (latency) + cell-level op counts (energy)."""

    # op-level counts (each op = one array-wide pass)
    compares: float = 0.0
    writes: float = 0.0          # LUT / populate column writes
    reads: float = 0.0           # bit-sequential column reads
    word_ops: float = 0.0        # word-sequential read/write ops (2 cycles each)
    # cell-level counts (for energy).  Data writes (populate / transfers)
    # always pay full write energy; LUT-pass writes mostly re-write the value
    # already stored, so in ReRAM only a *toggle fraction* pays the 21.7 pJ
    # SET/RESET cost (state-dependent write energy).
    cell_compares: float = 0.0
    cell_writes: float = 0.0     # data writes: populate, transfers, reshape
    cell_writes_lut: float = 0.0  # LUT-pass result writes (toggle-weighted)
    cell_reads: float = 0.0

    def __add__(self, other: "Cost") -> "Cost":
        return Cost(*(getattr(self, f.name) + getattr(other, f.name)
                      for f in dataclasses.fields(Cost)))

    def scale(self, k: float) -> "Cost":
        return Cost(*(getattr(self, f.name) * k for f in dataclasses.fields(Cost)))

    # ---- latency ---------------------------------------------------------
    def cycles(self, tech) -> float:
        """Latency in AP cycles for technology ``tech`` (TechParams).

        Word-sequential ops count 1 cycle each, matching Table I's literal
        "+ (L-1)" transfer terms (the two-cycle write of §II.B is absorbed
        into the table's constants)."""
        return (self.compares * tech.compare_cycles
                + self.writes * tech.write_cycles
                + self.reads * tech.read_cycles
                + self.word_ops * tech.write_cycles)

    # ---- energy ----------------------------------------------------------
    def energy_j(self, tech) -> float:
        """Energy in Joules for technology ``tech``."""
        return (self.cell_compares * tech.e_compare_j
                + self.cell_writes * tech.e_write_j
                + self.cell_writes_lut * tech.lut_toggle_frac * tech.e_write_j
                + self.cell_reads * tech.e_read_j)

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def _check(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def _log2(x: float) -> float:
    return math.log2(max(x, 1.0))


# ---------------------------------------------------------------------------
# Micro functions
# ---------------------------------------------------------------------------

def rt_add(M: int, L: int, mode: str = "2d", *, populate: bool = True,
           readout: bool = True) -> Cost:
    """In-place vector addition  A + B -> B  (Eq. 1): 2M + 8M + M + 1.

    Identical on 1D and 2D APs (horizontal mode only).  ``L`` words are
    stored two per row (L/2 rows active).
    """
    _check(mode)
    c = Cost()
    rows = L / 2.0
    if populate:                      # 2M bit-sequential column writes
        c.writes += 2 * M
        c.cell_writes += 2 * M * rows
    # LUT: 4 passes per column pair, M column pairs -> 4M compares + 4M writes
    c.compares += 4 * M
    c.cell_compares += 4 * M * rows * 2            # each compare senses 2 cols x rows
    c.writes += 4 * M
    c.cell_writes_lut += 4 * M * rows * 0.5            # ~half the rows match & get written
    if readout:                       # M+1 column reads (result has carry bit)
        c.reads += M + 1
        c.cell_reads += (M + 1) * rows
    return c


def rt_multiply(Mw: int, Ma: int, L: int, mode: str = "2d", *,
                populate: bool = True, readout: bool = True) -> Cost:
    """Out-of-place multiply A*B -> C (Eq. 2): 2M + 8M^2 + 2M.

    Mixed precision: the LUT walks ``Mw * Ma`` bit pairs (this is the
    bit-serial O(M^2) the paper exploits for bit fluidity).
    """
    _check(mode)
    c = Cost()
    rows = L / 2.0
    if populate:
        c.writes += Mw + Ma
        c.cell_writes += (Mw + Ma) * rows
    passes = 4 * Mw * Ma
    c.compares += passes
    c.cell_compares += passes * rows * 2
    c.writes += passes
    c.cell_writes_lut += passes * rows * 0.5
    if readout:                       # product is Mw+Ma bits wide
        c.reads += Mw + Ma
        c.cell_reads += (Mw + Ma) * rows
    return c


def rt_reduce(M: int, L: int, mode: str = "2d", *, populate: bool = True,
              readout: bool = True) -> Cost:
    """Vector reduction sum(A) (Eqs. 3-5).

    1D:    2M + sum_q 8(M+q-1) over log2(L) rounds + (L-1) word transfers + 1
    2D:    2M + 8M + 8(L/2 - 1) + 1        (vertical row-pair adds, sequential)
    2Dseg: 2M + 8M + 8 log2(L/2) + 1       (row pairs in parallel)
    """
    _check(mode)
    c = Cost()
    rows = L / 2.0
    if populate:
        c.writes += 2 * M
        c.cell_writes += 2 * M * rows
    if mode == "1d":
        for q in range(1, int(_log2(L)) + 1):
            width = M + q - 1
            c.compares += 4 * width
            c.cell_compares += 4 * width * rows * 2
            c.writes += 4 * width
            c.cell_writes_lut += 4 * width * rows * 0.5
        transfers = L / 2.0 - 1
        c.word_ops += 2 * transfers          # each transfer = 1 read + 1 write
        c.cell_reads += transfers * (M + _log2(L))
        c.cell_writes += transfers * (M + _log2(L))
    else:
        # one horizontal in-place add first (pairs within rows)
        c.compares += 4 * M
        c.cell_compares += 4 * M * rows * 2
        c.writes += 4 * M
        c.cell_writes_lut += 4 * M * rows * 0.5
        n_vert = (L / 2.0 - 1) if mode == "2d" else _log2(L / 2.0)
        # a vertical add completes in 4 passes (Eq. 4) regardless of width, so
        # each pass touches a constant ~2x2 cell window (2 rows x carry/flag
        # columns) — ASSUMPTION consistent with the 8-cycles-per-add latency.
        c.compares += 4 * n_vert
        c.cell_compares += 4 * n_vert * 4
        c.writes += 4 * n_vert
        c.cell_writes_lut += 4 * n_vert * 2 * 0.5
    if readout:
        c.word_ops += 1                      # final word-sequential read
        c.cell_reads += M + _log2(L)
    return c


# ---------------------------------------------------------------------------
# Macro functions
# ---------------------------------------------------------------------------

def rt_matmat(i: int, j: int, u: int, Mw: int, Ma: int, mode: str = "2d", *,
              populate: bool = True, readout: bool = True,
              parallel_blocks: int = 1) -> Cost:
    """Matrix-matrix multiply (i x j) @ (j x u)  (Eqs. 6-8).

    The AP stores one product per row: ``i*j*u`` rows (+carry).  After the
    bit-serial multiply (word-parallel over all rows), each of the ``i*u``
    output blocks reduces its ``j`` products with vertical row-pair adds:
      2D no-seg: (i*u)(j-1) sequential adds of 8 cycles (Eq. 7)
      2Dseg    : log2(j) rounds (Eq. 8)
      1D       : log2(j) add rounds + (i*u)(j-1) word transfers (Eq. 6)

    ``parallel_blocks`` models BF-IMNA's spatial parallelism: output blocks
    spread over that many independent APs reduce concurrently, dividing the
    *sequential* reduction count (latency) but not the energy.
    """
    _check(mode)
    c = Cost()
    L = i * j * u                            # one product per row-word
    rows = float(L)
    if populate:
        c.writes += Mw + Ma
        c.cell_writes += (Mw + Ma) * rows
    # multiply phase, all rows word-parallel
    passes = 4 * Mw * Ma
    c.compares += passes
    c.cell_compares += passes * rows * 2
    c.writes += passes
    c.cell_writes_lut += passes * rows * 0.5
    # reduction phase
    width = Mw + Ma + _log2(j)
    n_blocks = i * u
    total_adds = n_blocks * max(j - 1, 0)
    if mode == "1d":
        for q in range(1, int(_log2(j)) + 1):
            w = 2 * max(Mw, Ma) + q - 1
            c.compares += 4 * w
            c.cell_compares += 4 * w * rows * 2
            c.writes += 4 * w
            c.cell_writes_lut += 4 * w * rows * 0.5
        c.word_ops += 2 * total_adds         # transfers
        c.cell_reads += total_adds * width
        c.cell_writes += total_adds * width
    elif mode == "2d":
        seq_adds = total_adds / max(parallel_blocks, 1)
        c.compares += 4 * seq_adds
        c.writes += 4 * seq_adds
        # constant-cell vertical passes (see rt_reduce note)
        c.cell_compares += 4 * total_adds * 4
        c.cell_writes_lut += 4 * total_adds * 2 * 0.5
    else:  # 2dseg: reductions across row pairs in parallel
        n_rounds = _log2(j)
        c.compares += 4 * n_rounds
        c.writes += 4 * n_rounds
        c.cell_compares += 4 * total_adds * 4
        c.cell_writes_lut += 4 * total_adds * 2 * 0.5
    if readout:
        c.reads += Mw + Ma + _log2(j)
        c.cell_reads += (Mw + Ma + _log2(j)) * n_blocks
    return c


# ---------------------------------------------------------------------------
# CNN functions
# ---------------------------------------------------------------------------

def rt_relu(M: int, L: int, mode: str = "2d", *, populate: bool = True,
            readout: bool = True) -> Cost:
    """ReLU via the Table III LUT (Eq. 15): M + 3 + (M-1)*2 + M.

    Words stored vertically; identical for all AP flavours.
    """
    _check(mode)
    c = Cost()
    if populate:
        c.writes += M
        c.cell_writes += M * L
    # stash MSB in flag, reset MSB: 2 writes + 1 read
    c.writes += 2
    c.cell_writes += 2 * L
    c.reads += 1
    c.cell_reads += L
    # LUT pass over remaining M-1 bit/flag pairs
    c.compares += M - 1
    c.cell_compares += (M - 1) * L * 2
    c.writes += M - 1
    c.cell_writes_lut += (M - 1) * L * 0.5
    if readout:
        c.reads += M
        c.cell_reads += M * L
    return c


def rt_maxpool(M: int, S: int, K: int, mode: str = "2d", *, populate: bool = True,
               readout: bool = True, parallel_blocks: int = 1) -> Cost:
    """Max pooling, window S, K windows (Eqs. 12-14) via the Table IV LUT."""
    _check(mode)
    c = Cost()
    L = S * K
    rows = L / 2.0
    if populate:
        c.writes += 2 * M
        c.cell_writes += 2 * M * rows
    # first horizontal max pass: 4M compares/writes + 2 flag-reset writes
    c.compares += 4 * M
    c.cell_compares += 4 * M * rows * 2
    c.writes += 4 * M + 2
    c.cell_writes_lut += 4 * M * rows * 0.5 + 2 * rows
    if mode == "1d":
        n_rounds = max(_log2(S) - 1, 0)
        c.compares += n_rounds * 4 * M
        c.cell_compares += n_rounds * 4 * M * rows * 2
        c.writes += n_rounds * (4 * M + 2)
        c.cell_writes_lut += n_rounds * (4 * M * rows * 0.5 + 2 * rows)
        transfers = K * (S / 2.0 - 1)
        c.word_ops += 2 * transfers
        c.cell_reads += transfers * M
        c.cell_writes += transfers * M
    elif mode == "2d":
        total_vert = K * (S / 2.0 - 1)
        seq_vert = total_vert / max(parallel_blocks, 1)
        c.compares += 4 * seq_vert
        c.writes += (4 + 2) * seq_vert       # Eq. 13: 10K(S/2-1) total ops
        c.cell_compares += 4 * total_vert * M * 2
        c.cell_writes_lut += (4 * 0.5 + 2) * total_vert * M
    else:
        n_rounds = _log2(S / 2.0)
        c.compares += 4 * n_rounds
        c.writes += (4 + 2 * K) * n_rounds
        total_vert = K * (S / 2.0 - 1)
        c.cell_compares += 4 * total_vert * M * 2
        c.cell_writes_lut += (4 * 0.5 + 2) * total_vert * M
    if readout:
        c.reads += M
        c.cell_reads += M * K
    return c


def rt_avgpool(M: int, S: int, K: int, mode: str = "2d", *, populate: bool = True,
               readout: bool = True, parallel_blocks: int = 1) -> Cost:
    """Average pooling, window S, K windows (Eqs. 9-11).

    Division by the window size is a free shifted read (S power of two).
    """
    _check(mode)
    c = Cost()
    L = S * K
    rows = L / 2.0
    if populate:
        c.writes += 2 * M
        c.cell_writes += 2 * M * rows
    if mode == "1d":
        for q in range(1, int(_log2(S)) + 1):
            w = M + q - 1
            c.compares += 4 * w
            c.cell_compares += 4 * w * rows * 2
            c.writes += 4 * w
            c.cell_writes_lut += 4 * w * rows * 0.5
        transfers = K * (S / 2.0 - 1)
        c.word_ops += 2 * transfers
        c.cell_reads += transfers * M
        c.cell_writes += transfers * M
    else:
        c.compares += 4 * M
        c.cell_compares += 4 * M * rows * 2
        c.writes += 4 * M
        c.cell_writes_lut += 4 * M * rows * 0.5
        if mode == "2d":
            total_vert = K * (S / 2.0 - 1)
            seq_vert = total_vert / max(parallel_blocks, 1)
            c.compares += 4 * seq_vert
            c.writes += 4 * seq_vert
        else:
            n_rounds = _log2(S / 2.0)
            c.compares += 4 * n_rounds
            c.writes += 4 * n_rounds
            total_vert = K * (S / 2.0 - 1)
        c.cell_compares += 4 * total_vert * 4
        c.cell_writes_lut += 4 * total_vert * 2 * 0.5
    if readout:
        c.reads += M                          # shifted bit-sequential read
        c.cell_reads += M * K
    return c


# ---------------------------------------------------------------------------
# Table I closed forms (cycle counts, SRAM units) -- used by tests to verify
# the Cost-based accounting matches the paper's published expressions.
# ---------------------------------------------------------------------------

def table1_cycles(fn: str, mode: str, **kw) -> float:
    """Literal Table I expressions (compare=write=read=1 cycle)."""
    M = kw.get("M")
    L = kw.get("L")
    S = kw.get("S")
    K = kw.get("K")
    i, j, u = kw.get("i"), kw.get("j"), kw.get("u")
    if fn == "add":
        return 2 * M + 8 * M + M + 1
    if fn == "multiply":
        return 2 * M + 8 * M * M + 2 * M
    if fn == "reduce":
        if mode == "1d":
            return (2 * M + sum(8 * (M + q - 1) for q in range(1, int(_log2(L)) + 1))
                    + 2 * (L / 2 - 1) + 2)
        if mode == "2d":
            return 2 * M + 8 * M + 8 * (L / 2 - 1) + 2
        return 2 * M + 8 * M + 8 * _log2(L / 2) + 2
    if fn == "matmat":
        M2 = 2 * M
        if mode == "1d":
            return (2 * M + 8 * M * M
                    + sum(8 * (M2 + q - 1) for q in range(1, int(_log2(j)) + 1))
                    + 2 * (i * u) * (j - 1) + M2 + _log2(j))
        if mode == "2d":
            return 2 * M + 8 * M * M + 8 * (i * u) * (j - 1) + M2 + _log2(j)
        return 2 * M + 8 * M * M + 8 * _log2(j) + M2 + _log2(j)
    if fn == "relu":
        return 4 * M + 1
    if fn == "maxpool":
        if mode == "1d":
            return 2 * M + (8 * M + 2) * _log2(S) + 2 * K * (S / 2 - 1) + M
        if mode == "2d":
            return 2 * M + (8 * M + 2) + 10 * K * (S / 2 - 1) + M
        return 2 * M + (8 * M + 2) + (8 + 2 * K) * _log2(S / 2) + M
    if fn == "avgpool":
        if mode == "1d":
            return (2 * M + 2 * K * (S / 2 - 1)
                    + sum(8 * (M + q - 1) for q in range(1, int(_log2(S)) + 1)) + M)
        if mode == "2d":
            return 2 * M + 8 * M + 8 * K * (S / 2 - 1) + M
        return 2 * M + 8 * M + 8 * _log2(S / 2) + M
    raise ValueError(fn)

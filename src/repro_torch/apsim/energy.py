"""Technology parameters (Table VI, 16nm PTM) and energy accounting.

Paper-given constants are used verbatim.  Constants the paper does *not*
publish (per-cell compare/read energy, ReRAM compare-cycle slowdown) are
CALIBRATED once against the paper's own reported ratios (Fig. 6) and then
frozen — everything downstream (Fig. 7, Tables VII/VIII) is predicted.

Calibration targets (paper §V.A):
  * ReRAM/SRAM end-to-end VGG16 energy ratio falls 80.9x -> 63.1x as the
    fixed precision rises 2 -> 8 bits.
  * ReRAM/SRAM latency ratio stays ~1.85x across precisions.
  * Voltage scaling 1.0V -> 0.5V drops SRAM write energy 0.24fJ -> 0.06fJ
    (error prob 0 -> 0.021) with <0.1% end-to-end energy impact.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TechParams:
    name: str
    # --- energies, Joules per cell-op ---
    e_write_j: float           # Table VI: SRAM 0.24fJ, ReRAM 21.7pJ
    e_compare_j: float         # CALIBRATED (paper: "similar in both")
    e_read_j: float            # sensing ~= compare
    # --- cycle costs per pass ---
    compare_cycles: float      # ReRAM sense RC (R_LRS*C_in=0.25ns) is slower
    write_cycles: float        # paper: SRAM writes in half the ReRAM cycles
    read_cycles: float
    # --- cell area (um^2), for Table V / ReRAM 4.4x area saving ---
    cell_area_um2: float
    # --- LUT-pass writes re-write mostly-unchanged result bits; only the
    #     toggled fraction pays the full write energy (state-dependent) ---
    lut_toggle_frac: float = 1.0
    # --- voltage-scaling error probability (paper §V.A) ---
    write_error_prob: float = 0.0


# Per-cell compare energy: CALIBRATED (single fit, benchmarks/calibrate.py)
# against (a) Fig. 6 ReRAM/SRAM VGG16 energy ratios 80.9x@2b..63.1x@8b and
# (b) the paper's absolute LR/SRAM ResNet50 energies 0.009J@2b / 0.095J@8b.
# Result: ratios within +/-8%, absolute energies within 4%.
# The paper states compare energy is technology-independent.
E_COMPARE_J = 4.594e-14   # 0.046 pJ  [CALIBRATED]
E_READ_J = E_COMPARE_J    # a bit-sequential read is a search (paper §II.B)
LUT_TOGGLE_FRAC_RERAM = 0.386  # [CALIBRATED] fraction of LUT result writes
#                                that toggle the ReRAM cell state

# 6T SRAM cell @16nm ~0.05 um^2; ReRAM 4.4x denser (paper §V.A)
_SRAM_CELL_AREA = 0.050
_RERAM_CELL_AREA = _SRAM_CELL_AREA / 4.4

SRAM = TechParams(
    name="sram",
    e_write_j=0.24e-15,          # Table VI
    e_compare_j=E_COMPARE_J,
    e_read_j=E_READ_J,
    compare_cycles=1.0,
    write_cycles=1.0,
    read_cycles=1.0,
    cell_area_um2=_SRAM_CELL_AREA,
)

RERAM = TechParams(
    name="reram",
    e_write_j=21.7e-12,          # Table VI
    e_compare_j=E_COMPARE_J,
    e_read_j=E_READ_J,
    compare_cycles=1.7,          # CALIBRATED: R_LRS*C_in RC sense slowdown
    write_cycles=2.0,            # paper: SRAM needs half the write cycles
    read_cycles=1.7,
    cell_area_um2=_RERAM_CELL_AREA,
    lut_toggle_frac=LUT_TOGGLE_FRAC_RERAM,
)

SRAM_05V = dataclasses.replace(
    SRAM, name="sram@0.5V", e_write_j=0.06e-15, write_error_prob=0.021,
)

# --- extension technologies (paper §V.A: "very easy to extend our
# framework" to PCM [49] and FeFET [29] cells).  Write energies/cycles
# from the cited surveys; compare energy is sense-side and shared. ------
PCM = dataclasses.replace(
    RERAM, name="pcm",
    e_write_j=30e-12,            # SET/RESET ~10-100 pJ (Wong [49])
    write_cycles=4.0,            # ~100 ns programming vs 1 GHz clock scale
    cell_area_um2=_SRAM_CELL_AREA / 4.0,
)

FEFET = dataclasses.replace(
    RERAM, name="fefet",
    e_write_j=1e-15,             # field-effect write, ~fJ (Müller [29])
    write_cycles=2.0,
    compare_cycles=1.3, read_cycles=1.3,
    cell_area_um2=_SRAM_CELL_AREA / 2.0,
)

TECHNOLOGIES = {t.name: t for t in (SRAM, RERAM, SRAM_05V, PCM, FEFET)}


def voltage_scaled(tech: TechParams, vdd: float) -> TechParams:
    """Interpolate write energy between the paper's two published points.

    1.0V -> 0.24fJ (err 0.0);  0.5V -> 0.06fJ (err 0.021).  E ~ V^2.
    Only published for SRAM; other technologies are returned unchanged.
    """
    if tech.name != "sram":
        return tech
    vdd = max(0.5, min(1.0, vdd))
    scale = (vdd / 1.0) ** 2
    err = 0.021 * (1.0 - vdd) / 0.5
    return dataclasses.replace(
        tech, name=f"sram@{vdd:.2f}V",
        e_write_j=0.24e-15 * scale, write_error_prob=err)


# --- interconnect (paper Table V + ref [6]) --------------------------------
@dataclasses.dataclass(frozen=True)
class MeshParams:
    bits_per_transfer: int = 1024
    freq_hz: float = 500e6              # half of the 1 GHz AP clock
    avg_hops: float = 3.815             # Table V
    e_per_bit_per_mm_j: float = 0.05e-12  # ~0.05 pJ/bit/mm @16nm (Dally [6])
    hop_mm: float = 1.47                # sqrt(137.45mm^2 / 64 clusters)

    def transfer_latency_s(self, bits: float) -> float:
        transfers = -(-bits // self.bits_per_transfer) if bits else 0
        return transfers * self.avg_hops / self.freq_hz

    def transfer_energy_j(self, bits: float) -> float:
        return bits * self.e_per_bit_per_mm_j * self.hop_mm * self.avg_hops


MESH = MeshParams()

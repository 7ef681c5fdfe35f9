"""BF-IMNA architecture mapping + end-to-end inference simulation (paper §III-IV).

Two hardware configurations (paper §III.A):

* **IR** (infinite resources / maximum parallelism): one giant cluster with
  enough CAPs to compute the largest layer in one shot; each output block
  (the j products of one output element) lives in its own CAP region, so
  block reductions run fully in parallel.

* **LR** (limited resources, Table V): 8x8 clusters of 8x8 CAPs, each CAP
  4800 rows x 16 columns (two 8-bit words / row).  Weight-stationary GEMM,
  time-folded: each cluster holds a copy of the layer's kernel matrix and
  computes different output columns; output blocks packed into a CAP reduce
  *sequentially* (2D AP without segmentation — the paper's design point).

Mapping assumptions not pinned down by the paper text are marked ASSUMPTION
and reported against the paper's published ratios in EXPERIMENTS.md.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

from repro_torch.apsim import costmodel as cm
from repro_torch.apsim.energy import MESH, SRAM, MeshParams, TechParams
from repro_torch.apsim.workloads import Layer, gemm_layers, per_layer_bits


@dataclasses.dataclass(frozen=True)
class BFIMNAConfig:
    """Hardware configuration (Table V)."""
    name: str
    clusters: int = 64                # 8 x 8
    caps_per_cluster: int = 64        # 8 x 8
    cap_rows: int = 4800
    cap_cols: int = 16                # 2 words x 8 bits
    freq_hz: float = 1e9
    infinite: bool = False            # IR config
    mesh: MeshParams = MESH
    periphery_factor: float = 1.94    # CALIBRATED: area -> Table V 137.45mm^2

    @property
    def n_caps(self) -> int:
        return self.clusters * self.caps_per_cluster

    @property
    def total_rows(self) -> int:
        return self.n_caps * self.cap_rows


LR_CONFIG = BFIMNAConfig(name="LR")
IR_CONFIG = BFIMNAConfig(name="IR", infinite=True)


@dataclasses.dataclass
class LayerReport:
    name: str
    kind: str
    bits: int
    steps: int
    cycles: float
    compute_energy_j: float
    move_energy_j: float
    move_cycles: float
    macs: int

    @property
    def latency_s(self) -> float:
        return self.cycles / 1e9

    @property
    def energy_j(self) -> float:
        return self.compute_energy_j + self.move_energy_j


@dataclasses.dataclass
class NetworkReport:
    network: str
    config: str
    tech: str
    layers: List[LayerReport]
    area_mm2: float

    @property
    def latency_s(self) -> float:
        return sum(l.cycles for l in self.layers) / 1e9

    @property
    def energy_j(self) -> float:
        return sum(l.energy_j for l in self.layers)

    @property
    def macs(self) -> int:
        return sum(l.macs for l in self.layers)

    @property
    def gops(self) -> float:
        return 2.0 * self.macs / self.latency_s / 1e9

    @property
    def gops_per_w(self) -> float:
        return 2.0 * self.macs / self.energy_j / 1e9

    @property
    def gops_per_w_per_mm2(self) -> float:
        return self.gops_per_w / self.area_mm2

    @property
    def edp(self) -> float:
        return self.energy_j * self.latency_s

    def breakdown(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for l in self.layers:
            kind = {"conv": "gemm", "fc": "gemm"}.get(l.kind, l.kind)
            d = out.setdefault(kind, dict(energy_j=0.0, cycles=0.0))
            d["energy_j"] += l.energy_j
            d["cycles"] += l.cycles
        return out


# ---------------------------------------------------------------------------
# GEMM mapping
# ---------------------------------------------------------------------------

def _gemm_mapping(cfg: BFIMNAConfig, i: int, j: int, u: int):
    """Returns (j_fold, j_sub, outputs_per_cap, steps)."""
    # a block (j products of one output) must fit in one CAP (+1 carry row)
    j_fold = max(1, math.ceil(j / (cfg.cap_rows - 1)))
    j_sub = math.ceil(j / j_fold)
    opc = max(1, (cfg.cap_rows - 1) // max(j_sub, 1))   # outputs per CAP
    total_blocks = i * u * j_fold
    if cfg.infinite:
        # IR: enough CAPs for every block of the layer at once
        return j_fold, j_sub, 1, 1
    slots = cfg.n_caps * opc
    steps = math.ceil(total_blocks / slots)
    return j_fold, j_sub, opc, steps


def _gemm_layer(cfg: BFIMNAConfig, tech: TechParams, layer: Layer,
                Mw: int, Ma: int) -> LayerReport:
    i, j, u = layer.gemm_dims()
    groups = layer.groups
    j_fold, j_sub, opc, steps = _gemm_mapping(cfg, i, j, u * groups)

    # ---- energy: whole-GEMM cell accounting (mapping independent) --------
    comp = cm.rt_matmat(i, j, u * groups, Mw, Ma, mode="2d",
                        parallel_blocks=cfg.n_caps * opc)
    compute_energy = comp.energy_j(tech)

    # ---- latency: per-step cost x steps (ASSUMPTION: 3-stage Read/Compute/
    # Write pipeline hides streaming; see paper "latency ... hidden") -------
    per_step = cm.Cost()
    per_step.writes += Ma                                # stream activations
    passes = 4 * Mw * Ma
    per_step.compares += passes
    per_step.writes += passes
    seq_adds = opc * max(j_sub - 1, 0)                   # sequential in-CAP
    per_step.compares += 4 * seq_adds
    per_step.writes += 4 * seq_adds
    per_step.word_ops += opc                             # word-seq readout
    cycles = steps * per_step.cycles(tech)
    # one-time weight load per layer (stationary) + partial-sum combines
    cycles += Mw * tech.write_cycles
    if j_fold > 1:
        width = Mw + Ma + math.log2(max(j, 2))
        cycles += steps * 8 * width * tech.write_cycles * 0.5

    # ---- data movement ----------------------------------------------------
    out_bits_elem = Mw + Ma + math.ceil(math.log2(max(j, 2)))
    in_bits = j * u * groups * Ma * j_fold               # stream P columns
    w_bits = i * j * groups * Mw                         # weights, once
    out_bits = i * u * groups * out_bits_elem            # reshape to MAP
    move_bits = in_bits + w_bits + out_bits
    move_energy = cfg.mesh.transfer_energy_j(move_bits)
    # MAP word-seq write/read energy for the reshape
    map_cells = 2.0 * i * u * groups * out_bits_elem
    move_energy += map_cells * (tech.e_write_j + tech.e_read_j) / 2.0
    move_cycles = cfg.mesh.transfer_latency_s(out_bits) * cfg.freq_hz
    # reshape is NOT hidden (paper: "All reshaping overheads are factored in")
    cycles += move_cycles

    return LayerReport(layer.name, layer.kind, max(Mw, Ma), steps, cycles,
                       compute_energy, move_energy, move_cycles, layer.macs)


def _pool_layer(cfg: BFIMNAConfig, tech: TechParams, layer: Layer,
                M: int) -> LayerReport:
    S = layer.window
    K = layer.hout * layer.wout * layer.cin
    fn = cm.rt_maxpool if layer.kind == "maxpool" else cm.rt_avgpool
    opc = max(1, cfg.cap_rows // max(S, 1))
    steps = 1 if cfg.infinite else math.ceil(K / (cfg.n_caps * opc))
    comp = fn(M, S, K, mode="2d", parallel_blocks=cfg.n_caps * opc)
    energy = comp.energy_j(tech)
    per_step = fn(M, S, min(K, opc), mode="2d", parallel_blocks=1)
    cycles = steps * per_step.cycles(tech)
    move_bits = K * S * M
    move_energy = cfg.mesh.transfer_energy_j(move_bits)
    return LayerReport(layer.name, layer.kind, M, steps, cycles, energy,
                       move_energy, 0.0, 0)


def _relu_layer(cfg: BFIMNAConfig, tech: TechParams, n_elems: int,
                M: int, name: str) -> LayerReport:
    per_cap = cfg.cap_cols * max(1, cfg.cap_rows // (M + 1))
    steps = 1 if cfg.infinite else math.ceil(n_elems / (cfg.n_caps * per_cap))
    comp = cm.rt_relu(M, n_elems, mode="2d")
    energy = comp.energy_j(tech)
    per_step = cm.rt_relu(M, min(n_elems, per_cap), mode="2d")
    cycles = steps * per_step.cycles(tech)
    return LayerReport(name, "relu", M, steps, cycles, energy, 0.0, 0.0, 0)


def _add_layer(cfg: BFIMNAConfig, tech: TechParams, layer: Layer,
               M: int) -> LayerReport:
    n = layer.hin * layer.win * layer.cin          # elementwise residual add
    steps = 1 if cfg.infinite else math.ceil(n / cfg.total_rows)
    comp = cm.rt_add(M, 2 * n, mode="2d")
    energy = comp.energy_j(tech)
    per_step = cm.rt_add(M, min(2 * n, 2 * cfg.cap_rows), mode="2d")
    cycles = steps * per_step.cycles(tech)
    return LayerReport(layer.name, "add", M, steps, cycles, energy, 0.0, 0.0, 0)


# ---------------------------------------------------------------------------

def area_mm2(cfg: BFIMNAConfig, tech: TechParams, weight_bits: float) -> float:
    """Die area: CAP cells + MAP storage for all weights + periphery.

    CALIBRATED: periphery_factor chosen once so the LR/SRAM/VGG16@8b point
    reproduces Table V's 137.45 mm^2.
    """
    cap_cells = cfg.n_caps * cfg.cap_rows * cfg.cap_cols
    map_cells = weight_bits
    return ((cap_cells + map_cells) * tech.cell_area_um2 * 1e-6
            * cfg.periphery_factor)


def simulate_network(layers: Sequence[Layer], cfg: BFIMNAConfig = LR_CONFIG,
                     tech: TechParams = SRAM,
                     bits: "int | Sequence[int]" = 8,
                     act_bits: Optional["int | Sequence[int]"] = None,
                     network: str = "net") -> NetworkReport:
    """End-to-end single-image inference simulation (paper batch size 1).

    ``bits`` — scalar fixed precision, or a per-GEMM-layer vector (bit
    fluidity: the vector is the run-time mixed-precision configuration; no
    hardware parameter changes between configurations).
    """
    gl = gemm_layers(list(layers))
    if isinstance(bits, int):
        wvec = [bits] * len(gl)
    else:
        wvec = per_layer_bits(list(layers), list(bits))
    if act_bits is None:
        avec = list(wvec)
    elif isinstance(act_bits, int):
        avec = [act_bits] * len(gl)
    else:
        avec = per_layer_bits(list(layers), list(act_bits))

    reports: List[LayerReport] = []
    gi = 0
    cur_bits = wvec[0] if wvec else 8
    for layer in layers:
        if layer.kind in ("conv", "fc"):
            Mw, Ma = wvec[gi], avec[gi]
            cur_bits = Ma
            reports.append(_gemm_layer(cfg, tech, layer, Mw, Ma))
            if layer.relu:
                n = layer.cout * layer.hout * layer.wout
                reports.append(_relu_layer(cfg, tech, n, Mw + Ma,
                                           layer.name + "_relu"))
            gi += 1
        elif layer.kind in ("maxpool", "avgpool"):
            reports.append(_pool_layer(cfg, tech, layer, cur_bits))
        elif layer.kind == "add":
            reports.append(_add_layer(cfg, tech, layer, cur_bits))
        else:
            raise ValueError(layer.kind)

    weight_bits = sum(l.macs // max(l.hout * l.wout, 1) if l.kind == "conv"
                      else (l.cin * l.cout if l.kind == "fc" else 0)
                      for l in layers) * (max(wvec) if wvec else 8)
    cfg_for_area = cfg
    if cfg.infinite:
        # IR area: enough rows for the largest layer's products at once
        need = max((l.macs for l in gl), default=1)
        scale = max(1.0, need / cfg.total_rows)
        cfg_for_area = dataclasses.replace(cfg, clusters=int(cfg.clusters * scale))
    return NetworkReport(network, cfg.name, tech.name, reports,
                         area_mm2(cfg_for_area, tech, weight_bits))

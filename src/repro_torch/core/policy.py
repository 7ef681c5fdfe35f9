"""Precision policies — who gets how many bits, statically or at runtime.

The counterpart of ``repro.core.policy``.  A :class:`PrecisionPolicy`
resolves to per-layer integer vectors (weight bits, activation bits) that
flow through the model as tensor data, so switching configurations is a
gather, never a rebuild.

  * ``fixed(b)``, ``per_layer([...])``, ``hawq_v3(constraint)`` — static
    configurations (``hawq_v3`` is the paper's Table VII ResNet18 study).
  * ``BudgetController`` — dynamic, open loop: picks among registered
    configurations from a per-request budget (paper §V.B).
  * ``cnn_budget_controller`` — a controller whose prediction table holds
    the calibrated AP model's per-image cost of each configuration.

The closed-loop ``FluidController`` is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.apsim.workloads import HAWQV3_RESNET18


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Per-layer (weight, activation) bit assignment for an n_layers stack."""
    name: str
    weight_bits: Tuple[int, ...]
    act_bits: Tuple[int, ...]

    def vectors(self, n_layers: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(wbits, abits) int32 CPU tensors of length n_layers; shorter
        tables extend with their last entry (paper Table VII rule)."""
        def expand(tab: Sequence[int]) -> torch.Tensor:
            vals = [tab[i] if i < len(tab) else tab[-1] for i in range(n_layers)]
            return torch.tensor(vals, dtype=torch.int32)
        return expand(self.weight_bits), expand(self.act_bits)


def fixed(bits: int, name: Optional[str] = None) -> PrecisionPolicy:
    return PrecisionPolicy(name or f"int{bits}", (bits,), (bits,))


def per_layer(weight_bits: Sequence[int],
              act_bits: Optional[Sequence[int]] = None,
              name: str = "mixed") -> PrecisionPolicy:
    ab = tuple(act_bits) if act_bits is not None else tuple(weight_bits)
    return PrecisionPolicy(name, tuple(weight_bits), ab)


def hawq_v3(constraint: str) -> PrecisionPolicy:
    """Paper Table VII: HAWQ-V3 ResNet18 mixes; constraint in
    {int4, low, medium, high, int8} (weight and activation share bits)."""
    tab = HAWQV3_RESNET18[constraint]
    return per_layer(tab, name=f"hawqv3-{constraint}")


def cnn_budget_controller(network: str = "resnet18",
                          constraints: Sequence[str] = ("int4", "low",
                                                        "medium", "high",
                                                        "int8"),
                          *, layers=None,
                          configs: Optional[Dict[str, PrecisionPolicy]] = None,
                          metric: str = "edp") -> "BudgetController":
    """A :class:`BudgetController` for a CNN workload, with predicted
    per-image costs from the calibrated AP model
    (``apsim.mapper.simulate_network``).

    ``configs`` defaults to the paper's Table VII HAWQ-V3 ResNet18 mixes
    (``constraints`` picks which); for other networks pass explicit
    policies.  On the AP, latency is nearly flat across precisions, so the
    budget axis defaults to modeled per-image EDP (J*s); ``"energy"`` and
    ``"latency"`` are also accepted and recorded on ``budget_axis``.
    """
    from repro_torch.apsim.energy import SRAM
    from repro_torch.apsim.mapper import LR_CONFIG, simulate_network
    from repro_torch.apsim.workloads import NETWORKS, gemm_layers

    lay = list(layers) if layers is not None else NETWORKS[network]()
    n = len(gemm_layers(lay))
    if metric not in ("edp", "energy", "latency"):
        raise ValueError(f"metric must be edp/energy/latency, got {metric!r}")
    if configs is None:
        configs = {}
        for c in constraints:
            p = hawq_v3(c)
            configs[p.name] = p
    pred = {}
    for name, p in configs.items():
        if len(p.weight_bits) > n:
            raise ValueError(
                f"policy {p.name!r} assigns {len(p.weight_bits)} layers "
                f"but {network!r} has {n} GEMM (conv/fc) layers — the "
                f"HAWQ-V3 defaults are ResNet18 vectors; pass explicit "
                f"``configs`` for this network")
        wv, av = p.vectors(n)
        rep = simulate_network(lay, LR_CONFIG, SRAM,
                               bits=[int(b) for b in wv.tolist()],
                               act_bits=[int(b) for b in av.tolist()],
                               network=network)
        pred[name] = {"edp": rep.edp, "energy": rep.energy_j,
                      "latency": rep.latency_s}[metric]
    return BudgetController(configs, pred, n, budget_axis=metric)


# ---------------------------------------------------------------------------
# Dynamic switching (run-time bit fluidity)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BudgetController:
    """Chooses a registered precision configuration from a runtime budget.

    Selection rule (paper §V.B): the most accurate configuration whose
    predicted cost fits the budget; if none fit, the cheapest.  Tables
    live on the CPU (host-side policy); callers move the resolved bit
    tensors to their compute device.
    """
    configs: Dict[str, PrecisionPolicy]
    predicted_latency_s: Dict[str, float]
    n_layers: int
    # which axis the prediction table (and hence request budgets) lives
    # on: "latency" (s), "energy" (J) or "edp" (J*s)
    budget_axis: str = "latency"
    _order: Optional[Tuple[str, ...]] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    _tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    _lats: Optional[torch.Tensor] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def order(self) -> list:
        if self._order is None:
            self._order = tuple(sorted(
                self.configs, key=lambda k: self.predicted_latency_s[k]))
        return list(self._order)

    def stacked_tables(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(n_configs, n_layers) int32 bit tables, cheapest config first."""
        if self._tables is None:
            ws, as_ = [], []
            for k in self.order():
                w, a = self.configs[k].vectors(self.n_layers)
                ws.append(w)
                as_.append(a)
            self._tables = (torch.stack(ws), torch.stack(as_))
        return self._tables

    def latency_array(self) -> torch.Tensor:
        """Predicted budget-axis costs, cheapest config first, in float32
        (as the reference keeps them: a float64 compare could select
        differently at a budget boundary)."""
        if self._lats is None:
            self._lats = torch.tensor(
                [self.predicted_latency_s[k] for k in self.order()],
                dtype=torch.float32)
        return self._lats

    def select(self, budget_s) -> torch.Tensor:
        """Index into stacked_tables() for a scalar or ``(B,)`` budget."""
        lats = self.latency_array()
        b = torch.as_tensor(budget_s, dtype=torch.float32, device="cpu")
        fits = lats <= b[..., None]                  # (..., n_configs)
        ar = torch.arange(lats.shape[0])
        best = torch.where(fits, ar, torch.full_like(ar, -1)).amax(dim=-1)
        return best.clamp_min(0).to(torch.int32)

    def resolve(self, budget_s) -> Tuple[torch.Tensor, torch.Tensor]:
        """(wbits, abits): ``(n_layers,)`` for a scalar budget, ``(B,
        n_layers)`` for a ``(B,)`` budget vector — a pure gather."""
        wtab, atab = self.stacked_tables()
        idx = self.select(budget_s).long()
        return wtab[idx], atab[idx]

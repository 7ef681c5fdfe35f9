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
  * ``FluidController`` — dynamic, closed loop: charges each admission's
    priced AP cost against a system-level SLO window and resolves
    precision from the REMAINING budget (DESIGN.md §8).
  * ``BudgetController.adopt_plan`` — the placement co-decision: the
    prediction table re-priced under a replication plan
    (``repro_torch.dist.placement``), so the same budget resolves higher
    bits (DESIGN.md §13).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.apsim.workloads import HAWQV3_RESNET18

FP_BITS = 16  # sentinel: >=16 means "leave in bf16/f32" (fake_quant identity)

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

    @property
    def avg_bits(self) -> float:
        return sum(self.weight_bits) / len(self.weight_bits)


def fixed(bits: int, name: Optional[str] = None) -> PrecisionPolicy:
    return PrecisionPolicy(name or f"int{bits}", (bits,), (bits,))


def full_precision() -> PrecisionPolicy:
    return PrecisionPolicy("fp", (FP_BITS,), (FP_BITS,))


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
    # placement co-decision state (adopt_plan): the adopted plan plus the
    # per-config prediction scale it applied
    _plan: Optional[object] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    plan_gain: Optional[Dict[str, float]] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def adopt_plan(self, plan, pricer) -> None:
        """Re-price the prediction table under a placement plan: the
        precision-vs-replication co-decision (DESIGN.md §13).

        Each registered config's predicted budget-axis cost is scaled by
        the ratio its plan-amortized priced cost bears to its base cost
        (``PlacementPlan.price`` divides per-entry latency by replicas;
        energy is unchanged).  Replication makes every config cheaper on
        the latency and EDP axes, so the same budget or SLO headroom now
        resolves HIGHER bits.  ``pricer`` is the runtime's cached
        :class:`~repro_torch.serve.accounting.BitVectorPricer` (the same
        gemms/head the predictions were built from).  The table is
        scaled in place: a controller belongs to one engine.  Adopting
        the same plan again does nothing; a different one raises."""
        if self._plan is plan:
            return
        if self._plan is not None:
            raise ValueError("controller already adopted a different "
                             "placement plan; build a fresh controller "
                             "to re-plan")

        def axis_val(cost) -> float:
            if self.budget_axis == "latency":
                return cost.latency_s
            if self.budget_axis == "energy":
                return cost.energy_j
            return cost.energy_j * cost.latency_s

        gain: Dict[str, float] = {}
        for name, p in self.configs.items():
            wv, av = p.vectors(self.n_layers)
            base = pricer.price(wv.numpy(), av.numpy())
            b = axis_val(base)
            ratio = axis_val(plan.price(base)) / b if b > 0 else 1.0
            gain[name] = ratio
            self.predicted_latency_s[name] *= ratio
        self._plan = plan
        self.plan_gain = gain
        # the predictions moved: drop the cached order and tables
        self._order = None
        self._tables = None
        self._lats = None

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
        # index_select, not wtab[idx]: a 0-d index tensor would be read
        # back as a Python int (a host sync, and an op stream that
        # follows the budget)
        flat = idx.reshape(-1)
        shape = tuple(idx.shape) + tuple(wtab.shape[1:])
        return (wtab.index_select(0, flat).reshape(shape),
                atab.index_select(0, flat).reshape(shape))


@dataclasses.dataclass
class FluidController(BudgetController):
    """Closed-loop bit fluidity: precision from the REMAINING budget.

    :class:`BudgetController` is open-loop — a static prediction table
    maps each request's own budget to a configuration once, with no
    feedback from what the system has actually spent.  The fluid
    controller closes the loop the way the paper's §V.B run describes
    ("switching between the three mixed-precision configurations
    dynamically, as imposed by the changing run-time resource
    requirements"): the serving runtime charges every admission's
    *priced* AP cost (``serve/accounting.py``) against a system-level
    SLO window of ``slo`` budget-axis units per ``window`` admissions,
    and each new admission's effective budget is its share of whatever
    budget remains — so over-spending early requests push later ones
    into cheaper (lower-bit) configurations and under-spending relaxes
    them, Table VII's latency-budget sweep run as a live control loop
    (cf. LRMP's runtime precision re-allocation, arXiv:2312.03146).

    The loop lives entirely host-side: ``admission_budget()`` returns an
    ordinary float and selection stays the inherited gather, so a
    closed-loop config switch changes data, not code.  Window rollover
    expires unused credit but carries debt, keeping the long-run average
    at the SLO.

    Two window shapes (the rollover semantics under bursty arrivals):

      * admission-count (``window_ticks == 0``, the default): ``slo``
        units per ``window`` admissions.  Load-independent — a 10x
        burst spends the window 10x faster and later admissions tighten,
        but an idle hour and a busy hour get the same budget per
        request.
      * tick-based (``window_ticks > 0``): ``slo`` units per
        ``window_ticks`` *scheduler ticks* — a rate SLO.  The serving
        runtime calls :meth:`tick` once per scheduler tick; headroom
        splits the remaining window budget over the admissions known to
        be waiting (``pending``), so a burst that deepens the queue
        tightens every admission's share immediately while a trough
        (empty queue) relaxes back to full precision.  This is the
        window shape the traffic harness's diurnal/spike experiments
        drive (``serve/traffic.py``).
    """
    slo: float = float("inf")      # budget-axis units per window
    window: int = 32               # admissions per SLO window
    window_ticks: int = 0          # >0: roll on scheduler ticks instead
    spent: float = 0.0             # charged so far in this window
    served: int = 0                # admissions charged in this window
    ticks: int = 0                 # scheduler ticks elapsed in this window
    saved: float = 0.0             # cumulative budget-axis cost avoided by
                                   # the prefix-cache tier (hits charge only
                                   # their miss fraction; this tracks the
                                   # difference — introspection, not spend)
    # ---- draft-bit autotuning (DESIGN.md §11 stretch): the closed loop
    # watches an EMA of the speculative accept rate and shifts the DRAFT
    # configuration index — low acceptance means the cheap drafts are
    # being rejected (wasted draft+verify spend), so drafting moves to a
    # higher-bit config; high acceptance means the drafts are already
    # good enough and a cheaper config would do.  Off by default (the
    # speculative baselines stay byte-stable).
    draft_autotune: bool = False
    draft_ema_alpha: float = 0.2   # EMA smoothing of per-round accept rates
    draft_accept_low: float = 0.45     # EMA below this: raise draft bits
    draft_accept_high: float = 0.85    # EMA above this: lower draft bits
    draft_accept_ema: float = -1.0     # -1 = no observation yet (reset
                                       # after each shift: hysteresis)
    draft_shift: int = 0           # config-index offset applied to the
                                   # engine's base draft configuration

    def headroom(self, pending: int = 1) -> float:
        """Per-admission share of the remaining window budget.

        ``pending`` (tick-based windows only) is how many admissions are
        known to be competing for the remainder — the runtime passes its
        queue depth; admission-count windows split over the window's
        remaining admission slots instead."""
        if self.window_ticks:
            left = max(pending, 1)
        else:
            left = max(self.window - self.served, 1)
        return max(self.slo - self.spent, 0.0) / left

    def admission_budget(self, requested: Optional[float] = None,
                         pending: int = 1) -> float:
        """Effective budget for the next admission: the closed-loop
        headroom, tightened by the request's own budget when it has one."""
        h = self.headroom(pending)
        return h if requested is None else min(float(requested), h)

    def charge(self, amount: float) -> None:
        """Record one admission's actual (priced) budget-axis cost."""
        self.spent += float(amount)
        self.served += 1
        if not self.window_ticks and self.served >= self.window:
            self._roll()

    def tick(self) -> None:
        """One scheduler tick (tick-based windows; no-op otherwise)."""
        if not self.window_ticks:
            return
        self.ticks += 1
        if self.ticks >= self.window_ticks:
            self._roll()

    def _roll(self) -> None:
        # roll the window: unused credit expires, debt carries over
        self.spent = max(self.spent - self.slo, 0.0)
        self.served = 0
        self.ticks = 0

    # Draft depths the closed loop can hand out, slowest-headroom first.
    DRAFT_DEPTHS = (0, 2, 4, 8)

    def draft_depth(self) -> int:
        """Speculative draft depth for the next admission, from SLO
        headroom.  Drafting spends extra budget-axis units now (k draft
        tokens + a (k+1)-wide verify per round) to buy latency later, so
        depth scales with the *fraction* of the window budget this
        admission's share represents: a window with plenty of slack
        drafts deep (k=8), a tight one shallow, and a window in debt
        falls back to k=0 — exactly today's non-speculative path, so the
        closed loop degrades gracefully under pressure (DESIGN.md §11).
        """
        if self.slo == float("inf"):
            return self.DRAFT_DEPTHS[-1]
        if self.slo <= 0:
            return 0
        frac = max(self.slo - self.spent, 0.0) / self.slo
        if frac >= 0.5:
            return 8
        if frac >= 0.25:
            return 4
        if frac >= 0.10:
            return 2
        return 0

    def observe_accept(self, rate: float) -> None:
        """Feed one speculative round's accept rate (accepted/drafted)
        into the draft-bit autotuner.  EMA-smoothed; when the average
        leaves the [low, high] deadband the draft config index shifts by
        one (up = more bits on low acceptance, down = fewer on high) and
        the EMA resets so the next decision waits for fresh evidence
        under the new bits (hysteresis).  The engine clamps the final
        index into its config range, so the shift itself only needs a
        loose clamp here."""
        if not self.draft_autotune:
            return
        r = min(max(float(rate), 0.0), 1.0)
        a = self.draft_ema_alpha
        if self.draft_accept_ema < 0.0:
            self.draft_accept_ema = r
        else:
            self.draft_accept_ema = (1.0 - a) * self.draft_accept_ema + a * r
        if self.draft_accept_ema < self.draft_accept_low:
            self.draft_shift = min(self.draft_shift + 1, 8)
            self.draft_accept_ema = -1.0
        elif self.draft_accept_ema > self.draft_accept_high:
            self.draft_shift = max(self.draft_shift - 1, -8)
            self.draft_accept_ema = -1.0

    def record_saved(self, amount: float) -> None:
        """Track budget-axis cost a cache hit avoided charging.  The
        SLO window itself only ever sees the miss fraction (that's the
        point: hits free budget for higher-precision admissions); this
        running total is the controller's own view of how much the
        cache tier is subsidizing the window."""
        self.saved += float(amount)

    def reconcile(self, delta: float) -> None:
        """Adjust the ledger after a request finishes: admissions are
        charged their PLANNED unit count up front (so headroom reacts
        immediately), and an early-terminating request (eos) refunds the
        difference here — the window's spend tracks reality, not plans."""
        self.spent = max(self.spent + float(delta), 0.0)

    @classmethod
    def from_open_loop(cls, ctrl: BudgetController, *, slo: float,
                       window: int = 32,
                       window_ticks: int = 0) -> "FluidController":
        """Wrap an existing controller's configs/predictions in a
        closed-loop SLO window (axis carried over)."""
        return cls(dict(ctrl.configs), dict(ctrl.predicted_latency_s),
                   ctrl.n_layers, budget_axis=ctrl.budget_axis,
                   slo=slo, window=window, window_ticks=window_ticks)

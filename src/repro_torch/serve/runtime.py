"""Workload-agnostic serving runtime (DESIGN.md §8), on one device.

The counterpart of ``repro.serve.runtime``:

  * the request queue and admission scheduler: EDP-aware (the cheapest
    modeled EDP admits first) with FIFO anti-starvation aging after
    ``starvation_ticks`` ticks, deterministic;
  * the closed control loop: when the controller is a
    :class:`~repro_torch.core.policy.FluidController`, every admission's
    effective budget comes from the *remaining* SLO-window budget and its
    priced AP cost is charged back (only the miss fraction of a
    prefix-cache hit); a finished request reconciles what it really ran,
    and tick-windowed controllers advance once per scheduler tick;
  * slot lifecycle state (:class:`SlotTable` for slot-pool workloads,
    :meth:`ServeRuntime.plan_admissions` for batched ones), the
    scheduler clock with deferred :meth:`~ServeRuntime.submit_at`
    arrivals, and the :meth:`~ServeRuntime.run` loop;
  * the stats, the per-request cost records and the cached AP pricer
    (``serve/accounting.py``), with the host-side mirrors of the
    controller's tables;
  * the compute context: the controller's static bit-family set applied
    around every forward;
  * placement (DESIGN.md §13): the mesh (``mesh=``, else the active
    ``dist.use_mesh`` one) and a :class:`~repro_torch.dist.PlacementPlan`
    (``plan=``, or ``"auto"`` to plan one from the mesh's device count).
    Every price goes through :meth:`ServeRuntime._planned`, which
    amortizes latency over the plan's replicas (energy unchanged); a
    FluidController adopts the plan, so its SLO resolves higher bits.
    On a mesh, :meth:`ServeRuntime.place` lays the weights out once by
    ``dist.sharding.param_shardings(params, mesh, plan=self.plan)``
    (Megatron + FSDP; a plan's fully replicated leaves stay whole on
    every rank), :meth:`ServeRuntime._row_split` gives each data rank its
    block of request rows, and :meth:`ServeRuntime.compute_ctx` runs the
    forwards under the mesh, gathering each FSDP weight once a tick.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import dist
from repro_torch.apsim import metrics as apm
from repro_torch.dist import sharding as shd
from repro_torch.core.policy import BudgetController, FluidController
from repro_torch.kernels import ops as kops
from repro_torch.serve.accounting import (BitVectorPricer, CostRecord,
                                          RuntimeStats, axis_cost)

# "no budget": fits every configuration on any axis (most accurate wins)
UNCONSTRAINED_BUDGET = 1e30


@dataclasses.dataclass
class _QueueEntry:
    """One queued admission: workload payload + scheduling metadata."""
    rid: int
    payload: object
    est_edp: float                      # modeled per-unit EDP (ordering)
    age: int = 0                        # scheduler ticks spent waiting


class SlotTable:
    """Host-side per-slot scheduler state for slot-pool workloads.

    The slot -> request ownership array plus named numpy columns (decode
    position, sampling params, countdowns, ...).  The runtime owns the
    occupy/release lifecycle; workload adapters read and write columns.
    """

    def __init__(self, n_slots: int,
                 **columns: Tuple[type, float]) -> None:
        self.n_slots = n_slots
        self.rid = np.full((n_slots,), -1, np.int64)
        self._fill = {name: fill for name, (_, fill) in columns.items()}
        self.cols: Dict[str, np.ndarray] = {
            name: np.full((n_slots,), fill, dtype)
            for name, (dtype, fill) in columns.items()}

    def __getitem__(self, name: str) -> np.ndarray:
        return self.cols[name]

    @property
    def active(self) -> np.ndarray:
        return self.rid >= 0

    def occupy(self, slot: int, rid: int, **values) -> None:
        self.rid[slot] = rid
        for name, v in values.items():
            self.cols[name][slot] = v

    def release(self, slot: int) -> None:
        """Free a slot; columns reset to their fills (a freed row decodes
        masked garbage — its reset budget resolves the cheapest config)."""
        self.rid[slot] = -1
        for name, arr in self.cols.items():
            arr[slot] = self._fill[name]


class ServeRuntime:
    """Shared serving base: queue, scheduler, accounting, bit families."""

    def __init__(self, controller: BudgetController, n_layers: int, *,
                 gemms: Optional[Sequence[Sequence]] = None,
                 head: Optional[Tuple[int, int]] = None,
                 mesh=None, starvation_ticks: int = 8, plan=None,
                 slot_desc: str = "bit-slot layers") -> None:
        if controller.n_layers != n_layers:
            raise ValueError(
                f"controller resolves {controller.n_layers} bit slots but "
                f"this workload has {n_layers} {slot_desc}")
        self.controller = controller
        self.mesh = mesh if mesh is not None else dist.active_mesh()
        self.n_layers = n_layers
        self.starvation_ticks = starvation_ticks
        # grouped per-row dispatch runs one GEMM per *distinct* weight
        # bit-width the controller can emit (kernels/ops.py)
        wtab, _ = controller.stacked_tables()
        self.families = tuple(sorted(
            {min(max(int(v), 1), 8) for v in wtab.flatten().tolist()}))
        self.pricer = (BitVectorPricer(gemms, head=head)
                       if gemms is not None else None)
        # placement plan: "auto" plans from the controller's bit families
        # over this runtime's priced gemms and the mesh's device count
        # (None on one device: nothing to replicate onto)
        if plan == "auto":
            nd = dist.mesh_device_count(self.mesh)
            plan = (dist.plan_for_controller(controller, gemms,
                                             n_devices=nd, head=head)
                    if gemms is not None and nd > 1 else None)
        self.plan = plan
        # plan-amortized costs by base-object identity; each entry holds
        # its base object, so an id() key is never reused
        self._plan_costs: Dict[int, Tuple[apm.BitVectorCost,
                                          apm.BitVectorCost]] = {}
        if self.plan is not None and isinstance(controller, FluidController):
            if self.pricer is None:
                raise ValueError("a placement plan needs priced gemms "
                                 "(pass gemms=) to co-decide precision")
            controller.adopt_plan(self.plan, self.pricer)
        self.stats = RuntimeStats()
        self.requests: Dict[int, CostRecord] = {}
        self._next_rid = 0
        self._pending: List[_QueueEntry] = []
        self._config_costs: Optional[List[apm.BitVectorCost]] = None
        self._lats_np: Optional[np.ndarray] = None
        self._tabs_np: Optional[Tuple[np.ndarray, np.ndarray]] = None
        # scheduler clock + deferred (timestamped) arrivals: submit_at()
        # registers a submit thunk for a future tick; sched_tick() drains
        # the due thunks at the top of each tick
        self._tick = 0
        self._arrivals: Dict[int, List[Callable[[], int]]] = {}

    def _planned(self, cost: apm.BitVectorCost) -> apm.BitVectorCost:
        """Amortize a priced cost under the placement plan (identity
        without one).  Cached per base object, so one distinct bit vector
        keeps one planned cost object (callers rely on identity)."""
        if self.plan is None:
            return cost
        hit = self._plan_costs.get(id(cost))
        if hit is None:
            hit = (cost, self.plan.price(cost))
            self._plan_costs[id(cost)] = hit
        return hit[1]

    def price_bits(self, wv, av) -> apm.BitVectorCost:
        """AP cycles/energy of one resolved bit vector pair (cached;
        plan-amortized under a placement plan)."""
        return self._planned(self.pricer.price(np.asarray(wv),
                                               np.asarray(av)))

    def price_verify_bits(self, wv, av, u: int) -> apm.BitVectorCost:
        """Plan-amortized :meth:`BitVectorPricer.price_verify`: one
        u-token verify chunk at this bit vector."""
        return self._planned(self.pricer.price_verify(
            np.asarray(wv), np.asarray(av), u))

    def price_matrix_bits(self, wmat, amat) -> List[apm.BitVectorCost]:
        """Plan-amortized one-pass batch pricing (rows share cached cost
        objects)."""
        return [self._planned(c)
                for c in self.pricer.price_matrix(wmat, amat)]

    def _row_split(self, n_rows: int, what: str, cache: bool = True
                   ) -> Optional[Tuple[int, int]]:
        """This data rank's block ``[lo, hi)`` of ``n_rows`` request rows,
        or None when nothing splits them (no mesh, or a data axis of 1).
        Rows that do not divide evenly over the data ranks are not split
        either: every rank computes every row.  A batch's rows or a
        pool's slots then take the sequence-sharded cache where its ring
        divides (``dist.sharding._kv_cache_spec``; an encdec cross
        cache's frames), whose collectives need a
        :class:`repro_torch.dist.Mesh`: another mesh object raises
        (``cache=False``, a CNN batch, needs no collective)."""
        if self.mesh is None:
            return None
        dp = dist.dp_size(self.mesh)
        if dp <= 1:
            return None
        if n_rows % dp and (not cache or isinstance(self.mesh, dist.Mesh)):
            return None
        if n_rows % dp:
            raise NotImplementedError(
                f"{n_rows} {what} do not split evenly over the mesh's "
                f"{dp} data ranks; serving them whole on every rank "
                f"shards the cache's sequence, which needs a "
                f"repro_torch.dist.Mesh")
        n = n_rows // dp
        i = getattr(self.mesh, "dp_index", None)
        i = self.mesh.rank if i is None else i
        return i * n, (i + 1) * n

    def place(self, params):
        """``params`` laid out on the mesh by ``dist.sharding.
        param_shardings(params, mesh, plan=self.plan)``: each rank keeps
        its block of every sharded leaf (``dist.sharding.shard_params``);
        a fully replicated plan leaves every weight whole.  Sharded
        weights need a :class:`repro_torch.dist.Mesh` (collectives over a
        gloo group); another mesh object raises."""
        if self.mesh is None:
            return params
        specs = shd.param_shardings(params, self.mesh, plan=self.plan)
        if (not any(e is not None for _, spec in shd.tree_paths(specs)
                    for e in spec) and dist.tp_size(self.mesh) <= 1):
            return params
        if not isinstance(self.mesh, dist.Mesh):
            raise NotImplementedError(
                f"serving without a placement plan, with a partial one, or "
                f"on a 'model' axis (tensor parallelism) shards the weights "
                f"over the mesh, which needs a repro_torch.dist.Mesh "
                f"(collectives over a gloo group), not "
                f"{type(self.mesh).__name__}")
        return shd.shard_params(params, self.mesh, plan=self.plan)

    def collective(self, params) -> bool:
        """Whether every forward is a collective of the whole mesh (the
        weights are sharded, or there is a model axis), so every rank
        runs every forward, a prefill of a row it does not own too."""
        return self.mesh is not None and (
            shd.is_sharded(params) or dist.tp_size(self.mesh) > 1)

    def _host_index(self, budget: float) -> int:
        """Host-side mirror of ``controller.select`` for one budget (the
        prediction array cached as float32 numpy, as the controller
        compares)."""
        if self._lats_np is None:
            self._lats_np = np.asarray(
                [self.controller.predicted_latency_s[k]
                 for k in self.controller.order()], np.float32)
        fits = np.nonzero(self._lats_np <= np.float32(budget))[0]
        return int(fits[-1]) if fits.size else 0

    def host_tables(self) -> Tuple[np.ndarray, np.ndarray]:
        """The controller's stacked (w, a) bit tables as cached host
        numpy, expanded from the raw policy tuples (the same
        last-entry-extends rule as ``PrecisionPolicy.vectors``)."""
        if self._tabs_np is None:
            n = self.n_layers

            def expand(tab):
                return [int(tab[i]) if i < len(tab) else int(tab[-1])
                        for i in range(n)]

            ws, as_ = [], []
            for k in self.controller.order():
                p = self.controller.configs[k]
                ws.append(expand(p.weight_bits))
                as_.append(expand(p.act_bits))
            self._tabs_np = (np.asarray(ws, np.int32),
                             np.asarray(as_, np.int32))
        return self._tabs_np

    def host_bits(self, budget: float) -> Tuple[np.ndarray, np.ndarray]:
        """The (wbits, abits) vectors a budget resolves to, as host numpy."""
        wtab, atab = self.host_tables()
        i = self._host_index(budget)
        return wtab[i], atab[i]

    def _config_cost(self, idx: int) -> apm.BitVectorCost:
        """Priced AP cost of the controller's idx-th stacked config."""
        if self._config_costs is None:
            wtab, atab = self.host_tables()
            self._config_costs = [self.price_bits(wtab[i], atab[i])
                                  for i in range(wtab.shape[0])]
        return self._config_costs[idx]

    def admission_budget(self, requested: Optional[float] = None,
                         pending: Optional[int] = None) -> float:
        """Effective budget for the next admission: closed-loop headroom
        under a FluidController, the request's own budget otherwise.
        ``pending`` (tick-windowed controllers) is how many admissions
        compete for the remaining window budget; it defaults to this
        admission plus everything still queued."""
        if isinstance(self.controller, FluidController):
            if pending is None:
                pending = self.queued + 1
            return self.controller.admission_budget(requested,
                                                    pending=pending)
        return (float(requested) if requested is not None
                else UNCONSTRAINED_BUDGET)

    def charge(self, cost: apm.BitVectorCost, units: int = 1) -> None:
        """Feed one admission's priced cost back into the control loop."""
        if isinstance(self.controller, FluidController):
            self.controller.charge(
                axis_cost(cost, self.controller.budget_axis, units))

    def admit_record(self, record: CostRecord, requested: Optional[float],
                     units: int, *, eff: Optional[float] = None,
                     charge_units: Optional[int] = None,
                     spec: Optional[Tuple] = None):
        """Resolve one admission end to end: effective budget -> bit
        vectors -> AP pricing -> control-loop charge, written into
        ``record``.  ``units`` is the admission's planned AP unit count
        (LM: prompt + max new tokens).  An engine that consulted the
        prefix cache passes the pre-computed ``eff`` (so the gate and the
        charge see the same headroom) and ``charge_units`` = the miss
        fraction: cache-served units are never charged against a
        FluidController's SLO window, and the avoided share is recorded on
        the controller.  ``spec`` = (spec_k, draft_cost, verify_cost,
        planned_rounds, planned_tokens) installs a speculative-decoding
        plan on the record; :meth:`finish_record` reconciles against the
        rounds that ran.  Returns the (wbits, abits) vectors (host
        tensors)."""
        if eff is None:
            eff = self.admission_budget(requested)
        wv, av = self.controller.resolve(
            torch.tensor(eff, dtype=torch.float32))
        # price through the cached host mirrors (host_bits == resolve)
        wv_h, av_h = self.host_bits(eff)
        cost = self.price_bits(wv_h, av_h)
        record.budget_s = eff
        record.ap_cost = cost
        record.mean_wbits = float(np.mean(np.asarray(wv_h, np.float64)))
        if self.plan is not None:
            record.plan_replicas = self.plan.mean_replicas
        record.planned_units = units if charge_units is None \
            else charge_units
        record.admitted_tick = self._tick
        if spec is not None:
            (record.spec_k, record.draft_cost, record.verify_cost,
             record.planned_spec_rounds, record.planned_spec_tokens) = spec
        if isinstance(self.controller, FluidController):
            axis = self.controller.budget_axis
            self.controller.charge(record.axis_planned(axis))
            if charge_units is not None and charge_units != units:
                self.controller.record_saved(
                    axis_cost(cost, axis, units)
                    - axis_cost(cost, axis, charge_units))
        self.stats.admitted += 1
        return wv, av

    def plan_admissions(self, budgets: Sequence[Optional[float]],
                        units: int = 1) -> np.ndarray:
        """Batch admission planning (the batched-forward lifecycle): under
        a FluidController each admission is charged at its selected
        config's priced cost before the next one's headroom is computed,
        so the closed loop adapts within the batch.  Open-loop budgets
        pass through (``None`` is unconstrained).  Returns the effective
        budgets."""
        fluid = isinstance(self.controller, FluidController)
        eff = np.empty((len(budgets),), np.float64)
        for i, b in enumerate(budgets):
            # the rest of this batch competes for the same window budget
            e = self.admission_budget(b, pending=len(budgets) - i)
            if fluid:
                self.charge(self._config_cost(self._host_index(e)), units)
            eff[i] = e
        return eff

    # ------------------------------------------------------------------
    # Queue + admission scheduler
    # ------------------------------------------------------------------

    def new_record(self, record: CostRecord, payload: object,
                   requested: Optional[float], *,
                   est_scale: float = 1.0) -> int:
        """Register a submitted request and enqueue it for admission.
        ``est_scale`` discounts the modeled EDP used for admission
        ordering (the reference's prefix cache passes its predicted miss
        fraction)."""
        record.submitted_tick = self._tick
        self.requests[record.rid] = record
        est = 0.0
        if self.pricer is not None:
            open_budget = (float(requested) if requested is not None
                           else UNCONSTRAINED_BUDGET)
            est = (self._config_cost(self._host_index(open_budget)).edp
                   * float(est_scale))
        self._pending.append(_QueueEntry(record.rid, payload, est))
        return record.rid

    def submit_at(self, tick: int, submit: Callable[[], int]) -> None:
        """Register a deferred arrival: ``submit`` (a thunk that calls the
        adapter's ``submit(...)``) runs at the start of the
        :meth:`sched_tick` that finds the scheduler clock at ``tick``, so
        :meth:`run` and a trace replay both see it."""
        t = int(tick)
        if t < self._tick:
            raise ValueError(f"arrival tick {t} is in the past "
                             f"(scheduler clock is at {self._tick})")
        self._arrivals.setdefault(t, []).append(submit)

    def next_rid(self) -> int:
        rid = self._next_rid
        self._next_rid += 1
        return rid

    @property
    def queued(self) -> int:
        return len(self._pending)

    def age_queue(self) -> None:
        """One scheduler tick of waiting for everything still queued."""
        for e in self._pending:
            e.age += 1

    def next_admission(self) -> Optional[object]:
        """EDP-aware admission pick: the queued request with the lowest
        modeled per-unit EDP admits first, except that any request that
        has waited ``starvation_ticks`` ticks is admitted FIFO first.
        Deterministic (ties break by rid)."""
        if not self._pending:
            return None
        starved = [e for e in self._pending
                   if e.age >= self.starvation_ticks]
        pick = (min(starved, key=lambda e: e.rid) if starved
                else min(self._pending, key=lambda e: (e.est_edp, e.rid)))
        self._pending.remove(pick)
        return pick.payload

    def finish_record(self, rid: int) -> CostRecord:
        record = self.requests[rid]
        record.done = True
        record.finished_s = time.time()
        record.finished_tick = self._tick
        self.stats.completed += 1
        # admissions were charged their PLANNED cost; a request that ended
        # early (eos), or whose speculative rounds diverged from the plan,
        # refunds or charges the difference, so the SLO window tracks the
        # stream's real spend
        if (isinstance(self.controller, FluidController)
                and record.ap_cost is not None):
            axis = self.controller.budget_axis
            actual = record.axis_actual(axis)
            planned = record.axis_planned(axis)
            if actual != planned:
                self.controller.reconcile(actual - planned)
        return record

    # ------------------------------------------------------------------
    # Scheduler loop (slot-pool workloads)
    # ------------------------------------------------------------------

    def step(self) -> List[int]:                # pragma: no cover - abstract
        raise NotImplementedError("workload adapter must implement step()")

    def _has_active(self) -> bool:              # pragma: no cover - abstract
        raise NotImplementedError

    def _active_count(self) -> int:
        """Occupied-slot count for the queue-depth instrumentation."""
        return 0

    def _can_admit(self) -> bool:
        return True

    def sched_tick(self) -> List[int]:
        """One instrumented scheduler tick: submit the :meth:`submit_at`
        arrivals due now, advance a tick-windowed FluidController, run the
        adapter's :meth:`step`, record queue depth, advance the clock.
        Returns the rids that finished during the tick."""
        for submit in self._arrivals.pop(self._tick, ()):
            submit()
        if isinstance(self.controller, FluidController):
            self.controller.tick()
        done = self.step()
        self.stats.record_tick(self.queued, self._active_count())
        self._tick += 1
        return done

    def run(self, max_ticks: int = 10_000, *,
            on_exhaust: str = "raise") -> Dict[int, CostRecord]:
        """Pump the scheduler until every submitted request, deferred
        :meth:`submit_at` arrivals included, completes; returns
        {rid: record}.

        If the queue cannot drain within ``max_ticks``, the leftover
        requests are counted in ``stats.unserved`` (their records stay
        ``done=False``) and the runtime raises, or, with
        ``on_exhaust="report"``, returns the partial result."""
        if on_exhaust not in ("raise", "report"):
            raise ValueError(f"on_exhaust must be 'raise' or 'report', "
                             f"got {on_exhaust!r}")
        for _ in range(max_ticks):
            if (not self._pending and not self._has_active()
                    and not self._arrivals):
                return dict(self.requests)
            if self._pending and not self._can_admit():
                raise RuntimeError("engine has no slots; requests can "
                                   "never be admitted")
            self.sched_tick()
        still = sorted(r.rid for r in self.requests.values() if not r.done)
        late = sum(len(v) for v in self._arrivals.values())
        self.stats.unserved = len(still) + late
        if self.stats.unserved and on_exhaust == "raise":
            raise RuntimeError(
                f"run() exhausted {max_ticks} ticks with {len(still)} "
                f"requests still pending ({late} arrivals never enqueued): "
                f"rids {still}")
        return dict(self.requests)

    @contextlib.contextmanager
    def compute_ctx(self):
        """The controller's static bit-family set around a forward, under
        the runtime's mesh, whose FSDP weights each forward of the block
        gathers once (``Mesh.reuse_gathers``)."""
        reuse = (self.mesh.reuse_gathers()
                 if isinstance(self.mesh, dist.Mesh)
                 else contextlib.nullcontext())
        with kops.bit_families(self.families), dist.use_mesh(self.mesh), \
                reuse:
            yield

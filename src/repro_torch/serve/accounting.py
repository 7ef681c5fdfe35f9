"""Workload-agnostic serving accounting (DESIGN.md §8).

A copy of ``repro.serve.accounting`` (numpy only), so that per-request
costs and ``aggregate()`` dicts are equal to the reference's by
construction.

One cost vocabulary for every serve workload: :class:`RuntimeStats`
counts compiled-program traces (the zero-retrace proof) and engine-wide
totals; :class:`CostRecord` is the single per-request record both the LM
engine (:class:`RequestStats`) and the CNN engine (:class:`ImageStats`)
specialize — each request carries its resolved precision and the AP cost
of that precision priced through the paper's calibrated model, so
latency/energy/EDP read identically across workloads and aggregate with
:func:`aggregate`; :class:`BitVectorPricer` is the shared cached pricer
(vector and one-pass matrix forms) whose charges also drive the
closed-loop :class:`repro_torch.core.policy.FluidController`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.apsim import metrics as apm


class RuntimeStats:
    """Engine-wide serving counters; trace counts prove zero-retrace.

    Compiled programs are counted generically: an engine calls
    ``stats.trace("prefill")`` inside the traced function, and readers
    use the derived ``stats.prefill_traces`` / ``decode_traces`` /
    ``forward_traces`` attributes — any ``<program>_traces`` name reads
    the counter for ``<program>`` (0 if it never traced).

    In the port nothing is compiled: the engines run their programs
    eagerly and never call ``trace``, so every ``<program>_traces`` reads
    0 and there is no zero-retrace property to claim.  The other counters
    mean what they mean in the reference.
    """

    def __init__(self) -> None:
        self.traces: Dict[str, int] = {}
        self.tokens = 0                 # LM: tokens sampled
        self.admitted = 0               # LM: requests admitted into slots
        self.completed = 0              # LM: requests retired
        self.batches = 0                # CNN: serve() calls
        self.images = 0                 # CNN: real (unpadded) images served
        self.unserved = 0               # requests left pending at run() exit
        self.ticks = 0                  # scheduler ticks recorded
        self.queue_depth: List[int] = []   # queued requests after each tick
        self.active_depth: List[int] = []  # occupied slots after each tick

    def trace(self, program: str) -> None:
        self.traces[program] = self.traces.get(program, 0) + 1

    def record_tick(self, queued: int, active: int) -> None:
        """One scheduler tick's queue instrumentation (the traffic
        harness's queue-depth-over-time series reads these)."""
        self.ticks += 1
        self.queue_depth.append(int(queued))
        self.active_depth.append(int(active))

    def __getattr__(self, name: str) -> int:
        if name.endswith("_traces"):
            return self.__dict__.get("traces", {}).get(name[:-7], 0)
        raise AttributeError(name)

    def __repr__(self) -> str:          # pragma: no cover - debug aid
        return (f"RuntimeStats(traces={self.traces}, tokens={self.tokens}, "
                f"admitted={self.admitted}, completed={self.completed}, "
                f"batches={self.batches}, images={self.images})")


@dataclasses.dataclass
class CostRecord:
    """Per-request serving record shared by every workload.

    Besides wall-clock timing, each request carries its *priced* AP
    cost: at admission the resolved per-layer bit vector is pushed
    through ``apsim.metrics`` (the paper's calibrated cycle/energy
    model), so every request reports the latency/energy/EDP it would
    cost on the BF-IMNA hardware at its own precision — the Table VII
    accuracy-vs-EDP trade-off, live per request.  ``ap_cost`` prices ONE
    :meth:`ap_units` unit (LM: one token; CNN: one inference); derived
    totals scale by the units the request actually processed.
    """
    rid: int
    budget_s: float                     # effective budget (axis units)
    mean_wbits: float = 0.0             # realized per-layer weight bits
    ap_cost: Optional[apm.BitVectorCost] = None   # per-layer breakdown
    submitted_s: float = 0.0
    finished_s: float = 0.0
    done: bool = False
    planned_units: int = 1              # units charged at admission (the
                                        # runtime reconciles vs ap_units
                                        # when the request finishes)
    # prefix-cache hit/miss split (DESIGN.md §10): units served from the
    # cross-request cache are NOT recomputed, so they drop out of
    # ap_units (and hence energy/EDP) — the counterfactual saving reads
    # from prefill_edp_saved_js.  Under the ``repriced`` hit policy the
    # cached precision/cost is recorded alongside, keeping the ledger
    # honest about which bits actually produced the cached rows.
    cached_units: int = 0               # prompt units served from cache
    cache_hit: str = ""                 # "" | "full" | "partial"
    cached_cost: Optional[apm.BitVectorCost] = None
    cached_mean_wbits: float = 0.0
    # scheduler-tick timing (deterministic, unlike wall clock): set by the
    # runtime when requests arrive/admit/finish inside a ticked run()/replay
    submitted_tick: int = -1
    admitted_tick: int = -1
    finished_tick: int = -1
    # speculative decoding (DESIGN.md §11): draft tokens run at the
    # request's DRAFT bits (``draft_cost`` prices one), verify rounds run
    # one (spec_k+1)-token chunk at its target bits (``verify_cost``
    # prices one round).  Tokens delivered by spec rounds (spec_tokens)
    # are NOT charged at ap_cost — their compute is the drafts plus the
    # chunks, priced honestly below in ap_latency_s / ap_energy_j.
    spec_k: int = 0                     # draft depth chosen at admission
    draft_cost: Optional[apm.BitVectorCost] = None   # one draft token
    verify_cost: Optional[apm.BitVectorCost] = None  # one verify round
    draft_units: int = 0                # draft tokens generated
    verify_units: int = 0               # token positions verified
    accepted_units: int = 0             # draft tokens accepted by verify
    spec_rounds: int = 0                # draft+verify rounds run
    spec_tokens: int = 0                # tokens delivered by spec rounds
    planned_spec_rounds: int = 0        # rounds charged at admission
    planned_spec_tokens: int = 0        # tokens those rounds were planned
                                        # to deliver (full acceptance)
    # placement (DESIGN.md §13): mean replica count of the plan this
    # request's costs were amortized under (0 = no plan — costs are the
    # base single-copy pricing); draft_wbits is the mean weight bits of
    # the DRAFT config the autotuner had selected when this request's
    # rounds ran (0 when it never drafted)
    plan_replicas: float = 0.0
    draft_wbits: float = 0.0

    @property
    def ap_units(self) -> int:
        """How many ``ap_cost`` units this request processed."""
        return 1

    @property
    def latency_s(self) -> float:
        """Wall-clock submit-to-finish latency (0.0 until done)."""
        return max(self.finished_s - self.submitted_s, 0.0) if self.done \
            else 0.0

    @property
    def latency_ticks(self) -> int:
        """Submit-to-finish latency in scheduler ticks (-1 until done or
        outside a ticked run — the traffic harness's deterministic
        latency axis)."""
        if not self.done or self.submitted_tick < 0 or self.finished_tick < 0:
            return -1
        return self.finished_tick - self.submitted_tick

    def _axis_total(self, axis: str, base_units: float, draft_units: int,
                    rounds: int) -> float:
        """Budget-axis cost of ``base_units`` at ap_cost plus a
        speculative component (``draft_units`` draft tokens +
        ``rounds`` verify chunks).  With zero spec terms this is exactly
        :func:`axis_cost` — same float summation order, so non-spec
        charging is bit-identical to the historical path."""
        lat = base_units * self.ap_cost.latency_s
        en = base_units * self.ap_cost.energy_j
        if self.draft_cost is not None and draft_units:
            lat += draft_units * self.draft_cost.latency_s
            en += draft_units * self.draft_cost.energy_j
        if self.verify_cost is not None and rounds:
            lat += rounds * self.verify_cost.latency_s
            en += rounds * self.verify_cost.energy_j
        if axis == "latency":
            return lat
        if axis == "energy":
            return en
        if axis == "edp":
            return en * lat
        raise ValueError(f"unknown budget axis {axis!r}")

    def axis_planned(self, axis: str) -> float:
        """Budget-axis cost charged at admission: planned units at
        ap_cost, with the decode tokens a spec plan covers re-priced as
        planned draft+verify rounds (full acceptance)."""
        if self.ap_cost is None:
            return 0.0
        return self._axis_total(axis,
                                self.planned_units - self.planned_spec_tokens,
                                self.planned_spec_rounds * self.spec_k,
                                self.planned_spec_rounds)

    def axis_actual(self, axis: str) -> float:
        """Budget-axis cost of what this request actually ran: non-spec
        units at ap_cost plus the real draft/verify round counts —
        the reconciliation side of the ledger."""
        if self.ap_cost is None:
            return 0.0
        return self._axis_total(axis, self.ap_units - self.spec_tokens,
                                self.draft_units, self.spec_rounds)

    @property
    def ap_latency_s(self) -> float:
        """Modeled AP latency of every processed unit at this request's
        precision configuration (spec-round units priced as their drafts
        + verify chunks)."""
        if self.ap_cost is None:
            return 0.0
        return self._axis_total("latency", self.ap_units - self.spec_tokens,
                                self.draft_units, self.spec_rounds)

    @property
    def ap_energy_j(self) -> float:
        if self.ap_cost is None:
            return 0.0
        return self._axis_total("energy", self.ap_units - self.spec_tokens,
                                self.draft_units, self.spec_rounds)

    @property
    def edp(self) -> float:
        """Modeled AP energy-delay product (J·s) of the whole request."""
        return self.ap_energy_j * self.ap_latency_s

    @property
    def prefill_edp_js(self) -> float:
        """Modeled EDP actually spent on prefill (LM records override)."""
        return 0.0

    @property
    def prefill_edp_saved_js(self) -> float:
        """Counterfactual prefill EDP avoided by cache hits (LM records
        override; 0 for workloads without a prefill phase)."""
        return 0.0


@dataclasses.dataclass
class RequestStats(CostRecord):
    """LM request record: token stream + per-token AP pricing."""
    prompt_len: int = 0
    slot: int = -1
    # host clock (time.time()) when the scheduler picked the request and
    # when its first token reached the host: the admission's wall
    admitted_s: float = 0.0
    first_token_s: float = 0.0
    tokens: List[int] = dataclasses.field(default_factory=list)

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)

    @property
    def processed_tokens(self) -> int:
        """Tokens this request pushed through the model (prompt + new)."""
        return self.prompt_len + self.n_tokens

    @property
    def ap_units(self) -> int:
        """Units the AP actually computed: cached prompt tokens were
        installed from the prefix cache, never recomputed."""
        return self.processed_tokens - self.cached_units

    @property
    def prefill_edp_js(self) -> float:
        """Modeled EDP of the prompt tokens this request re-prefilled
        (prompt minus cache-served tokens, at its own resolved cost)."""
        if self.ap_cost is None:
            return 0.0
        u = self.prompt_len - self.cached_units
        return (u * self.ap_cost.energy_j) * (u * self.ap_cost.latency_s)

    @property
    def prefill_edp_saved_js(self) -> float:
        """Counterfactual: the prefill EDP a cache-less serve of the
        full prompt would have cost, minus what this request spent."""
        if self.ap_cost is None or not self.cached_units:
            return 0.0
        s = self.prompt_len
        full = (s * self.ap_cost.energy_j) * (s * self.ap_cost.latency_s)
        return full - self.prefill_edp_js

    @property
    def ap_cycles_per_token(self) -> float:
        return 0.0 if self.ap_cost is None else self.ap_cost.cycles

    @property
    def ap_energy_per_token_j(self) -> float:
        return 0.0 if self.ap_cost is None else self.ap_cost.energy_j


@dataclasses.dataclass
class ImageStats(CostRecord):
    """CNN image record: resolved bit vectors + one-inference pricing."""
    index: int = -1                     # row inside the batch that served it
    wbits: Tuple[int, ...] = ()
    abits: Tuple[int, ...] = ()

    @property
    def budget(self) -> float:
        return self.budget_s


def axis_cost(cost: apm.BitVectorCost, axis: str, units: int = 1) -> float:
    """One admission's cost on a controller's budget axis (the closed
    loop's feedback signal): modeled AP latency (s), energy (J), or EDP
    (J·s) of ``units`` priced units."""
    lat = units * cost.latency_s
    if axis == "latency":
        return lat
    en = units * cost.energy_j
    if axis == "energy":
        return en
    if axis == "edp":
        return en * lat
    raise ValueError(f"unknown budget axis {axis!r}")


def aggregate(records: Iterable[CostRecord]) -> Dict[str, float]:
    """System-level accounting: sums of the per-request records.

    Workload-agnostic (LM and CNN records mix freely), so a deployment
    serving both reads one ledger; tests pin the invariant that engine
    stats totals equal these per-request sums.
    """
    recs = list(records)
    hits = sum(1 for r in recs if r.cached_units > 0)
    draft = sum(r.draft_units for r in recs)
    accepted = sum(r.accepted_units for r in recs)
    spec_tokens = sum(r.spec_tokens for r in recs)
    planned = sum(1 for r in recs if r.plan_replicas > 0)
    edp_total = sum(r.edp for r in recs)
    units = sum(r.ap_units for r in recs)
    return {
        "requests": len(recs),
        "completed": sum(1 for r in recs if r.done),
        "ap_units": units,
        "ap_latency_s": sum(r.ap_latency_s for r in recs),
        "ap_energy_j": sum(r.ap_energy_j for r in recs),
        "edp": edp_total,
        # prefix-cache tier split (0 / 0.0 when no tier is configured)
        "prefix_hits": hits,
        "prefix_hit_rate": round(hits / len(recs), 4) if recs else 0.0,
        "cached_units": sum(r.cached_units for r in recs),
        "prefill_edp_saved_js": sum(r.prefill_edp_saved_js for r in recs),
        # speculative-decoding split (all 0 when no request drafted):
        # accept_rate is accepted drafts over drafts, the net-EDP view is
        # total modeled EDP over units actually delivered — drafting
        # only wins this ledger when the extra draft energy is outrun by
        # the latency the accepted tokens skip (DESIGN.md §11)
        "spec_draft_units": draft,
        "spec_accepted_units": accepted,
        "spec_verify_units": sum(r.verify_units for r in recs),
        "spec_rounds": sum(r.spec_rounds for r in recs),
        "spec_tokens": spec_tokens,
        "spec_accept_rate": round(accepted / draft, 4) if draft else 0.0,
        # draft-bit autotuning: draft-unit-weighted mean weight bits of
        # the draft configs actually used (0.0 when nothing drafted or
        # the engine predates the autotuner)
        "spec_draft_mean_wbits": round(
            sum(r.draft_wbits * r.draft_units for r in recs) / draft, 4)
        if draft else 0.0,
        # placement-plan split: how many requests were priced under a
        # replication plan, and the mean replica count they saw
        "plan_requests": planned,
        "plan_mean_replicas": round(
            sum(r.plan_replicas for r in recs if r.plan_replicas > 0)
            / planned, 4) if planned else 0.0,
        "edp_per_unit_js": edp_total / units if units else 0.0,
    }


def predict_table(gemms: Sequence[Sequence], configs, *, axis: str = "edp",
                  units: int = 1,
                  head: Optional[Tuple[int, int]] = None,
                  optimism: float = 1.0) -> Dict[str, float]:
    """Build a controller prediction table by PRICING each config.

    Each registered :class:`~repro_torch.core.policy.PrecisionPolicy` is
    expanded over the workload's bit slots, priced through the AP model,
    and converted with the exact :func:`axis_cost` math the runtime
    charges at admission — so predictions and charges cannot drift.
    ``units`` is the planned AP units per request (LM: prompt + max new
    tokens); ``optimism`` scales the table (< 1 = optimistic — the
    closed-loop demos use 0.5 to show the loop correcting for it).
    """
    pricer = BitVectorPricer(gemms, head=head)
    table = {}
    for name, p in configs.items():
        wv, av = p.vectors(len(gemms))
        table[name] = optimism * axis_cost(pricer.price(wv, av), axis,
                                           units)
    return table


class BitVectorPricer:
    """Cached AP pricing of resolved bit vectors and matrices.

    Controllers emit a small static set of vectors, so pricing caches by
    the clamped vector bytes and returns ONE shared
    :class:`~repro_torch.apsim.metrics.BitVectorCost` object per distinct
    vector (callers rely on identity).  Batch admissions go through the
    one-pass :func:`repro_torch.apsim.metrics.price_bit_matrix`.
    """

    def __init__(self, gemms: Sequence[Sequence], *,
                 head: Optional[Tuple[int, int]] = None) -> None:
        self.gemms = tuple(gemms)
        self.head = head
        self._cache: Dict[bytes, apm.BitVectorCost] = {}

    @staticmethod
    def _key(wv: np.ndarray, av: np.ndarray) -> bytes:
        # clamp exactly like the pricing itself, so clamp-equivalent
        # vectors share one cached cost object
        wv = np.clip(wv, 1, 16)
        av = np.clip(av, 1, 16)
        return wv.tobytes() + b"|" + av.tobytes()

    def price(self, wv, av) -> apm.BitVectorCost:
        """AP cycles/energy of one resolved (n_slots,) bit vector pair."""
        wv = np.asarray(wv, np.int64)
        av = np.asarray(av, np.int64)
        key = self._key(wv, av)
        hit = self._cache.get(key)
        if hit is None:
            hit = apm.price_bit_vector(self.gemms, wv.tolist(), av.tolist(),
                                       head=self.head)
            self._cache[key] = hit
        return hit

    def price_verify(self, wv, av, u: int) -> apm.BitVectorCost:
        """AP cost of ONE u-token verify chunk at this bit vector: every
        serve GEMV batches over u token rows (the ``(B·(k+1), K)``
        grouped GEMM), priced through the chunked serve mapping
        (``apsim.metrics.serve_gemv_cost``).  Cached per (vector, u)."""
        if u < 1:
            raise ValueError(f"verify chunk width must be >= 1, got {u}")
        wv = np.asarray(wv, np.int64)
        av = np.asarray(av, np.int64)
        key = self._key(wv, av) + b"|u" + str(int(u)).encode()
        hit = self._cache.get(key)
        if hit is None:
            hit = apm.price_bit_vector(self.gemms, wv.tolist(), av.tolist(),
                                       head=self.head, units=int(u))
            self._cache[key] = hit
        return hit

    def price_matrix(self, wmat, amat) -> List[apm.BitVectorCost]:
        """Price a (B, n_slots) bit matrix; rows share cached objects."""
        wmat = np.asarray(wmat, np.int64)
        amat = np.asarray(amat, np.int64)
        keys = [self._key(wmat[i], amat[i]) for i in range(wmat.shape[0])]
        miss = [i for i, k in enumerate(keys) if k not in self._cache]
        if miss:
            costs = apm.price_bit_matrix(self.gemms, wmat[miss], amat[miss],
                                         head=self.head)
            for i, c in zip(miss, costs):
                self._cache.setdefault(keys[i], c)
        return [self._cache[k] for k in keys]

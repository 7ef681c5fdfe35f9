"""Trace-driven traffic: generator, replay driver, metrics collector
(DESIGN.md §9).

The counterpart of ``repro.serve.traffic`` (numpy only, the same logic):
the same arguments give byte-identical traces and payloads, and the
replayer drives the port's two engines.

  * :func:`synth_trace` — a SEEDED workload generator.  A pattern
    (Poisson steady-state, diurnal sinusoid, systematic spike) shapes a
    per-tick arrival-rate series; arrivals are Poisson draws against it;
    each arrival is a :class:`TraceRequest` with a workload kind
    (LM/CNN), an architecture drawn from the registered mix, a
    repetition *key* (same key == same payload — the repetition
    coefficient controls the unique-vs-repeated mix, with a
    rich-get-richer key draw so repeats skew Zipf-like), and per-request
    budget/SLO metadata.  Same seed, same trace — bit for bit.
  * :class:`TraceReplayer` — feeds engines from the schedule: arrivals
    enqueue at their timestamped tick (never all-up-front), every engine
    advances lock-step one ``sched_tick`` per tick, CNN arrivals batch
    per tick (spill past ``max_batch`` queues to the next tick), and
    tick-windowed :class:`~repro_torch.core.policy.FluidController` loops are
    advanced once per tick.  Deterministic end to end: latency is
    measured in scheduler ticks, EDP through the analytic AP model.
  * :func:`summarize` — the metrics collector: SLO attainment, p50/p99
    latency (ticks) and EDP, queue depth over time, unserved/starvation
    counts, and mean resolved bits per arrival window.

A single engine can also replay a trace through ``ServeRuntime.submit_at``
and ``run``, collected by :func:`result_from_runtime`.  Unlike the
reference, the replayer also sees an engine's ``submit_at`` arrivals
(``sched_tick`` submits them) and runs until they have drained too.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.policy import FluidController
from repro_torch.serve.runtime import UNCONSTRAINED_BUDGET

__all__ = [
    "TraceRequest", "Trace", "TraceReplayer", "TrafficResult",
    "pattern_rates", "synth_trace", "dump_trace", "load_trace",
    "payload_tokens", "payload_image", "result_from_runtime", "summarize",
]


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One timestamped arrival in a synthesized trace."""
    t: int                              # arrival tick
    workload: str                       # "lm" | "cnn"
    arch: str                           # config (lm) / network (cnn) name
    key: int                            # repetition group: same key ==
                                        # same deterministic payload
    prompt_len: int = 0                 # lm payload shape
    max_new_tokens: int = 0
    budget: Optional[float] = None      # per-request budget (axis units);
                                        # closed-loop replays may ignore it
    slo_edp: Optional[float] = None     # per-request EDP SLO (attainment
                                        # metadata, J*s)


@dataclasses.dataclass(frozen=True)
class Trace:
    """A seeded, timestamped arrival schedule."""
    pattern: str
    seed: int
    ticks: int
    rates: Tuple[float, ...]            # expected arrivals per tick
    requests: Tuple[TraceRequest, ...]

    @property
    def n_requests(self) -> int:
        return len(self.requests)

    def counts(self) -> np.ndarray:
        """Realized arrivals per tick, (ticks,) int64."""
        c = np.zeros((self.ticks,), np.int64)
        for r in self.requests:
            c[r.t] += 1
        return c

    def arrivals_by_tick(self) -> Dict[int, List[TraceRequest]]:
        by: Dict[int, List[TraceRequest]] = {}
        for r in self.requests:
            by.setdefault(r.t, []).append(r)
        return by


def pattern_rates(pattern: str, ticks: int, rate: float, *,
                  burst_mag: float = 10.0, burst_at: Optional[int] = None,
                  burst_len: int = 4, period: Optional[int] = None,
                  depth: float = 0.9, mmpp_up: float = 0.08,
                  mmpp_down: float = 0.25, seed: int = 0) -> np.ndarray:
    """Expected-arrivals-per-tick series for a traffic pattern.

      * ``poisson`` — flat ``rate``.
      * ``diurnal`` — ``rate * (1 + depth*sin(2*pi*t/period))``: one
        sinusoid cycle per ``period`` ticks (default: one cycle over the
        whole trace), peak at period/4, trough at 3*period/4.
      * ``spike``  — flat ``rate`` except a systematic burst of
        ``burst_mag * rate`` for ``burst_len`` ticks starting at
        ``burst_at`` (default: one third in).
      * ``mmpp``   — two-state Markov-modulated Poisson process: a
        hidden state chain switches between a calm state (rate
        ``rate``) and a bursty state (``burst_mag * rate``) with
        per-tick transition probabilities ``mmpp_up`` (calm→bursty) and
        ``mmpp_down`` (bursty→calm) — bursts arrive at random times and
        last a geometric number of ticks (mean ``1/mmpp_down``), unlike
        ``spike``'s one systematic burst.  The chain draws from its own
        seeded stream, so the series is byte-deterministic per seed and
        independent of the arrival draws layered on top.
    """
    t = np.arange(ticks, dtype=np.float64)
    if pattern == "poisson":
        return np.full((ticks,), float(rate))
    if pattern == "diurnal":
        p = float(period if period is not None else ticks)
        return rate * (1.0 + depth * np.sin(2.0 * math.pi * t / p))
    if pattern == "spike":
        at = ticks // 3 if burst_at is None else int(burst_at)
        r = np.full((ticks,), float(rate))
        r[at:at + burst_len] = rate * burst_mag
        return r
    if pattern == "mmpp":
        rng = np.random.default_rng([int(seed), 0x33])
        flips = rng.random(ticks)       # one draw per tick, state-agnostic
        r = np.empty((ticks,), np.float64)
        state = 0
        for i in range(ticks):
            r[i] = rate * (burst_mag if state else 1.0)
            if state == 0:
                state = 1 if flips[i] < mmpp_up else 0
            else:
                state = 0 if flips[i] < mmpp_down else 1
        return r
    raise ValueError(f"unknown traffic pattern {pattern!r} "
                     f"(poisson | diurnal | spike | mmpp | file)")


def synth_trace(pattern: str = "poisson", *, ticks: int = 64,
                rate: float = 1.0, seed: int = 0, repetition: float = 0.0,
                burst_mag: float = 10.0, burst_at: Optional[int] = None,
                burst_len: int = 4, period: Optional[int] = None,
                depth: float = 0.9, mmpp_up: float = 0.08,
                mmpp_down: float = 0.25, cnn_frac: float = 0.0,
                lm_archs: Sequence[str] = ("qwen3_4b",),
                cnn_archs: Sequence[str] = ("resnet18",),
                prompt_len: int = 8, max_new_tokens: int = 8,
                budget: Optional[Sequence[float]] = None,
                slo_edp: Optional[float] = None,
                path: Optional[str] = None) -> Trace:
    """Synthesize a seeded, timestamped arrival schedule.

    Arrivals per tick are Poisson draws against the pattern's rate
    series; ``repetition`` in [0, 1) is the probability that an arrival
    reuses a previously seen key instead of minting a new one (keys are
    drawn from the *occurrence* history, so popular keys get more
    popular — a Zipf-ish repeated mix); ``cnn_frac`` is the probability
    an arrival is a CNN inference instead of an LM generation; per-kind
    architectures draw uniformly from ``lm_archs`` / ``cnn_archs``.
    ``budget`` (cycled over arrivals) and ``slo_edp`` attach per-request
    budget/SLO metadata.  Same arguments + same seed → identical trace.

    ``pattern="file"`` imports a JSONL trace instead (see
    :func:`load_trace`); ``path`` names the file and the synthesis
    knobs are ignored — payloads stay seeded off (seed, key), so a
    replay of an imported trace is just as byte-deterministic.
    """
    if pattern == "file":
        if path is None:
            raise ValueError('synth_trace(pattern="file") needs path=')
        return load_trace(path, ticks=ticks or None, seed=seed)
    if not 0.0 <= repetition < 1.0:
        raise ValueError(f"repetition must be in [0, 1), got {repetition}")
    rates = pattern_rates(pattern, ticks, rate, burst_mag=burst_mag,
                          burst_at=burst_at, burst_len=burst_len,
                          period=period, depth=depth, mmpp_up=mmpp_up,
                          mmpp_down=mmpp_down, seed=seed)
    rng = np.random.default_rng([int(seed), 0xBF])
    counts = rng.poisson(np.maximum(rates, 0.0))
    occurrences: List[int] = []         # every key occurrence (repeat pool)
    next_key = 0
    requests: List[TraceRequest] = []
    i = 0
    for t, c in enumerate(counts):
        for _ in range(int(c)):
            if occurrences and rng.random() < repetition:
                key = occurrences[int(rng.integers(len(occurrences)))]
            else:
                key = next_key
                next_key += 1
            occurrences.append(key)
            is_cnn = cnn_frac > 0.0 and rng.random() < cnn_frac
            archs = cnn_archs if is_cnn else lm_archs
            arch = archs[int(rng.integers(len(archs)))]
            b = None if budget is None else float(budget[i % len(budget)])
            requests.append(TraceRequest(
                t=t, workload="cnn" if is_cnn else "lm", arch=arch, key=key,
                prompt_len=0 if is_cnn else prompt_len,
                max_new_tokens=0 if is_cnn else max_new_tokens,
                budget=b, slo_edp=slo_edp))
            i += 1
    return Trace(pattern=pattern, seed=int(seed), ticks=int(ticks),
                 rates=tuple(float(r) for r in rates),
                 requests=tuple(requests))


def dump_trace(trace: Trace, path: str) -> None:
    """Write a trace as JSONL: one ``{"meta": ...}`` header line with
    the trace-level fields, then one JSON object per arrival.  The
    format round-trips through :func:`load_trace` bit for bit."""
    with open(path, "w") as f:
        f.write(json.dumps({"meta": {
            "pattern": trace.pattern, "seed": trace.seed,
            "ticks": trace.ticks}}) + "\n")
        for r in trace.requests:
            f.write(json.dumps(dataclasses.asdict(r)) + "\n")


def load_trace(path: str, *, ticks: Optional[int] = None,
               seed: int = 0) -> Trace:
    """Import a JSONL trace file (``synth_trace(pattern="file")``).

    One JSON object per line; blank lines and ``#`` comments are
    skipped.  Each arrival needs at least ``t`` (its tick); the other
    :class:`TraceRequest` fields default like :func:`synth_trace`'s
    (workload "lm", arch "qwen3_4b", prompt_len/max_new_tokens 8) and
    ``key`` defaults to a fresh key per line — so a hand-written trace
    of bare ``{"t": ...}`` lines replays.  An optional ``{"meta": ...}``
    header (written by :func:`dump_trace`) restores pattern/seed/ticks.
    Payload bytes stay a pure function of (seed, key), so an imported
    trace replays byte-identically: same file + same seed → same
    prompts, same schedule.  ``ticks`` is a floor on the trace span
    (reporting windows); the realized per-tick arrival counts stand in
    for the rate series."""
    meta: Dict[str, object] = {}
    requests: List[TraceRequest] = []
    next_key = 0
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            obj = json.loads(line)
            if "meta" in obj and "t" not in obj:
                meta = dict(obj["meta"])
                continue
            if "t" not in obj:
                raise ValueError(f"{path}:{ln}: arrival needs a tick "
                                 f"field 't'")
            t = int(obj["t"])
            if t < 0:
                raise ValueError(f"{path}:{ln}: negative tick {t}")
            key = int(obj.get("key", next_key))
            next_key = max(next_key, key) + 1
            workload = str(obj.get("workload", "lm"))
            requests.append(TraceRequest(
                t=t, workload=workload,
                arch=str(obj.get("arch", "qwen3_4b" if workload == "lm"
                                 else "resnet18")),
                key=key,
                prompt_len=int(obj.get("prompt_len",
                                       0 if workload == "cnn" else 8)),
                max_new_tokens=int(obj.get(
                    "max_new_tokens", 0 if workload == "cnn" else 8)),
                budget=(None if obj.get("budget") is None
                        else float(obj["budget"])),
                slo_edp=(None if obj.get("slo_edp") is None
                         else float(obj["slo_edp"]))))
    requests.sort(key=lambda r: r.t)
    span = max((r.t for r in requests), default=-1) + 1
    n_ticks = max(int(meta.get("ticks", 0)), span, int(ticks or 0))
    counts = np.zeros((max(n_ticks, 1),), np.float64)
    for r in requests:
        counts[r.t] += 1.0
    return Trace(pattern=str(meta.get("pattern", "file")),
                 seed=int(meta.get("seed", seed)),
                 ticks=int(max(n_ticks, 1)),
                 rates=tuple(float(c) for c in counts),
                 requests=tuple(requests))


def payload_tokens(trace: Trace, req: TraceRequest,
                   vocab_size: int) -> np.ndarray:
    """Deterministic prompt for an LM request: a function of (trace
    seed, key) only, so repeated keys replay byte-identical prompts
    (the repetition-aware cache tier's future hit signal).  Length draws
    from [max(1, prompt_len//2), prompt_len], also per key."""
    rng = np.random.default_rng([trace.seed, 0x7A, req.key])
    n = int(rng.integers(max(1, req.prompt_len // 2), req.prompt_len + 1))
    return rng.integers(0, vocab_size, (n,), dtype=np.int32)


def payload_image(trace: Trace, req: TraceRequest,
                  shape: Tuple[int, int, int]) -> np.ndarray:
    """Deterministic (H, W, C) image for a CNN request, keyed like
    :func:`payload_tokens`."""
    rng = np.random.default_rng([trace.seed, 0x1C, req.key])
    return rng.standard_normal(shape).astype(np.float32)


@dataclasses.dataclass
class TrafficResult:
    """One replay's outcome: per-request entries + tick series."""
    entries: List[dict]                 # per-request accounting rows
    queue_depth: List[int]              # summed over engines, per tick
    active_depth: List[int]
    ticks: int
    unserved: int

    def report(self, *, window: int = 8) -> dict:
        return summarize(self, window=window)


class TraceReplayer:
    """Replay a :class:`Trace` against serving engines, lock-step.

    ``engines`` maps LM arch names to
    :class:`~repro_torch.serve.engine.ServeEngine` instances;
    ``cnn_engines`` maps CNN arch names to
    :class:`~repro_torch.serve.cnn.CNNServeEngine` instances (with
    ``image_hw`` giving each network's input height/width).  Every tick:
    due arrivals enqueue (LM requests into the engine's admission queue,
    CNN requests into a per-engine pending list), every LM engine runs
    one ``sched_tick``, and every CNN engine serves up to ``max_batch``
    pending images in one batched forward (the spill queues on).  Replay
    ends when the schedule and every queue drain, or after ``max_ticks``
    — leftovers are reported as unserved, never silently dropped.

    ``use_budgets=False`` ignores per-request budget metadata (closed-
    loop runs: the SLO window picks precision, not requests).
    """

    def __init__(self, trace: Trace, engines: Optional[Dict[str, object]],
                 *, cnn_engines: Optional[Dict[str, object]] = None,
                 image_hw: int = 8, use_budgets: bool = True,
                 max_ticks: int = 10_000) -> None:
        self.trace = trace
        self.engines = dict(engines or {})
        self.cnn_engines = dict(cnn_engines or {})
        self.image_hw = image_hw
        self.use_budgets = use_budgets
        self.max_ticks = max_ticks
        need_lm = {r.arch for r in trace.requests if r.workload == "lm"}
        need_cnn = {r.arch for r in trace.requests if r.workload == "cnn"}
        if need_lm - set(self.engines):
            raise ValueError(f"trace draws LM archs {sorted(need_lm)} but "
                             f"engines only cover {sorted(self.engines)}")
        if need_cnn - set(self.cnn_engines):
            raise ValueError(f"trace draws CNN archs {sorted(need_cnn)} "
                             f"but cnn_engines only cover "
                             f"{sorted(self.cnn_engines)}")

    def _image_shape(self, eng) -> Tuple[int, int, int]:
        first = next(l for l in eng.layers if l.kind == "conv")
        return (self.image_hw, self.image_hw, first.cin)

    def replay(self) -> TrafficResult:
        by_tick = self.trace.arrivals_by_tick()
        last_arrival = max(by_tick) if by_tick else -1
        lm_meta: Dict[Tuple[str, int], TraceRequest] = {}
        cnn_pending: Dict[str, List[TraceRequest]] = {
            a: [] for a in self.cnn_engines}
        entries: List[dict] = []
        queue_depth: List[int] = []
        active_depth: List[int] = []
        t = 0
        while t < self.max_ticks:
            for req in by_tick.get(t, ()):
                if req.workload == "lm":
                    eng = self.engines[req.arch]
                    rid = eng.submit(
                        payload_tokens(self.trace, req, eng.cfg.vocab_size),
                        max_new_tokens=req.max_new_tokens,
                        budget_s=(req.budget if self.use_budgets else None),
                        rep_key=req.key)
                    lm_meta[(req.arch, rid)] = req
                else:
                    cnn_pending[req.arch].append(req)
            q = a = 0
            for arch, eng in self.engines.items():
                eng.sched_tick()
                q += eng.queued
                a += eng._active_count()
            for arch, eng in self.cnn_engines.items():
                entries.extend(self._serve_cnn_tick(arch, eng,
                                                    cnn_pending[arch], t))
                q += len(cnn_pending[arch])
            queue_depth.append(q)
            active_depth.append(a)
            t += 1
            drained = (t > last_arrival
                       and all(not e.queued and not e._has_active()
                               and not e._arrivals
                               for e in self.engines.values())
                       and all(not p for p in cnn_pending.values()))
            if drained:
                break
        unserved = 0
        for (arch, rid), req in lm_meta.items():
            eng = self.engines[arch]
            entries.append(self._entry(eng.requests[rid], req, arch,
                                       eng.starvation_ticks))
            unserved += 0 if eng.requests[rid].done else 1
        # arrivals the max_ticks cutoff never even enqueued, plus CNN
        # spill still pending — reported, never silently dropped
        never = [r for tick, reqs in by_tick.items() if tick >= t
                 for r in reqs]
        for req in never + [r for p in cnn_pending.values() for r in p]:
            unserved += 1
            entries.append({
                "rid": -1, "workload": req.workload, "arch": req.arch,
                "key": req.key, "done": False, "submitted_tick": req.t,
                "latency_ticks": -1, "wait_ticks": 0, "edp": 0.0,
                "energy_j": 0.0, "mean_wbits": 0.0, "slo_edp": req.slo_edp,
                "attained": False, "starved": False})
        for arch, pend in cnn_pending.items():
            self.cnn_engines[arch].stats.unserved += len(pend)
        entries.sort(key=lambda e: (e["submitted_tick"], e["workload"],
                                    e["arch"], e["rid"]))
        return TrafficResult(entries=entries, queue_depth=queue_depth,
                             active_depth=active_depth, ticks=t,
                             unserved=unserved)

    def _serve_cnn_tick(self, arch: str, eng,
                        pending: List[TraceRequest], t: int) -> List[dict]:
        if isinstance(eng.controller, FluidController):
            eng.controller.tick()
        if not pending:
            eng.stats.record_tick(0, 0)
            return []
        batch = pending[:eng.max_batch]
        del pending[:len(batch)]
        shape = self._image_shape(eng)
        images = np.stack([payload_image(self.trace, r, shape)
                           for r in batch])
        budgets = ([UNCONSTRAINED_BUDGET if r.budget is None else r.budget
                    for r in batch] if self.use_budgets else None)
        eng._tick = t                   # stamp finished_tick = serve tick
        _, stats = eng.serve(images, budgets)
        eng.stats.record_tick(len(pending), 0)
        out = []
        for req, rec in zip(batch, stats):
            rec.submitted_tick = req.t  # arrival, not serve, tick
            out.append(self._entry(rec, req, arch))
        return out

    @staticmethod
    def _entry(rec, req: TraceRequest, arch: str,
               starvation_ticks: Optional[int] = None) -> dict:
        attained = (rec.done and req.slo_edp is not None
                    and rec.edp <= req.slo_edp)
        wait = (rec.admitted_tick - rec.submitted_tick
                if rec.admitted_tick >= 0 and rec.submitted_tick >= 0
                else 0)
        return {
            "rid": rec.rid, "workload": req.workload, "arch": arch,
            "key": req.key, "done": bool(rec.done),
            "submitted_tick": rec.submitted_tick,
            "latency_ticks": rec.latency_ticks,
            "wait_ticks": wait,
            "edp": rec.edp, "energy_j": rec.ap_energy_j,
            "mean_wbits": rec.mean_wbits, "slo_edp": req.slo_edp,
            "attained": bool(attained),
            "starved": bool(starvation_ticks is not None
                            and wait >= starvation_ticks)}


def result_from_runtime(runtime,
                        meta: Dict[int, TraceRequest]) -> TrafficResult:
    """Collect a :class:`TrafficResult` from ONE runtime after a
    ``submit_at``-driven ``run()`` (the single-engine replay path —
    ``submit_at`` and ``run``).  ``meta`` maps each submitted rid to
    its originating :class:`TraceRequest`; arrivals ``run()`` never
    enqueued are already counted in ``runtime.stats.unserved``."""
    entries = [TraceReplayer._entry(runtime.requests[rid], req, req.arch,
                                    runtime.starvation_ticks)
               for rid, req in meta.items()]
    entries.sort(key=lambda e: (e["submitted_tick"], e["rid"]))
    return TrafficResult(entries=entries,
                         queue_depth=list(runtime.stats.queue_depth),
                         active_depth=list(runtime.stats.active_depth),
                         ticks=int(runtime.stats.ticks),
                         unserved=int(runtime.stats.unserved))


def summarize(result: TrafficResult, *, window: int = 8,
              starvation_ticks: Optional[int] = None) -> dict:
    """The metrics collector: one JSON-ready report per replay.

    Reports SLO attainment (fraction of finished requests whose modeled
    EDP met their per-request ``slo_edp`` metadata — ``None`` when the
    trace carried none), p50/p99 latency in scheduler ticks, p50/p99 and
    total EDP, queue-depth-over-time (series + peak + mean),
    unserved/starvation counts, the mean resolved weight bits per
    ``window``-tick arrival window (the bits-degradation time series the
    elasticity experiments plot), and per-key repetition stats
    (distinct keys, top-key share, theoretical max hit rate) — the
    yardstick the prefix-cache tier's achieved hit rate is judged
    against."""
    entries = result.entries
    fin = [e for e in entries if e["done"]]
    lat = np.asarray([e["latency_ticks"] for e in fin], np.float64)
    edp = np.asarray([e["edp"] for e in fin], np.float64)
    with_slo = [e for e in fin if e["slo_edp"] is not None]
    if starvation_ticks is not None:
        starved = sum(1 for e in fin
                      if e.get("wait_ticks", 0) >= starvation_ticks)
    else:
        starved = sum(1 for e in fin if e.get("starved"))
    n_windows = (result.ticks + window - 1) // window if result.ticks else 0
    bits_w: List[List[float]] = [[] for _ in range(n_windows)]
    arrivals_w = [0] * n_windows
    for e in entries:
        w = min(max(e["submitted_tick"], 0) // window,
                max(n_windows - 1, 0))
        if n_windows:
            arrivals_w[w] += 1
            if e["done"]:
                bits_w[w].append(e["mean_wbits"])
    qd = np.asarray(result.queue_depth, np.float64) \
        if result.queue_depth else np.zeros((0,))
    pct = (lambda a, p: float(np.percentile(a, p)) if a.size else 0.0)
    # per-key repetition stats: sanity-check a trace's repeated mix
    # against the prefix-cache tier's achieved hit rate — a repeat of
    # an already-seen key is the theoretical best case for a hit, so
    # max_hit_rate = (arrivals - distinct keys) / arrivals
    keys = [e["key"] for e in entries if e.get("key") is not None]
    key_counts: Dict[int, int] = {}
    for k in keys:
        key_counts[k] = key_counts.get(k, 0) + 1
    n_keys = len(keys)
    repetition = {
        "arrivals": n_keys,
        "distinct_keys": len(key_counts),
        "top_key_share": (round(max(key_counts.values()) / n_keys, 4)
                          if n_keys else 0.0),
        "max_hit_rate": (round((n_keys - len(key_counts)) / n_keys, 4)
                         if n_keys else 0.0),
    }
    return {
        "requests": len(entries),
        "completed": len(fin),
        "unserved": int(result.unserved),
        "starved": int(starved),
        "ticks": int(result.ticks),
        "window_ticks": int(window),
        "slo_attainment": (round(sum(e["attained"] for e in with_slo)
                                 / len(with_slo), 4) if with_slo else None),
        "p50_latency_ticks": pct(lat, 50),
        "p99_latency_ticks": pct(lat, 99),
        "p50_edp_js": pct(edp, 50),
        "p99_edp_js": pct(edp, 99),
        "total_edp_js": float(edp.sum()),
        "total_energy_j": float(sum(e["energy_j"] for e in fin)),
        "mean_wbits": (round(float(np.mean([e["mean_wbits"]
                                            for e in fin])), 4)
                       if fin else 0.0),
        "queue_depth": {
            "series": [int(x) for x in result.queue_depth],
            "peak": int(qd.max()) if qd.size else 0,
            "mean": round(float(qd.mean()), 3) if qd.size else 0.0,
        },
        "arrivals_per_window": arrivals_w,
        "mean_wbits_per_window": [
            round(float(np.mean(b)), 3) if b else None for b in bits_w],
        "repetition": repetition,
    }

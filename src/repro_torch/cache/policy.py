"""Repetition-aware, AP-cost-priced cache policy (DESIGN.md §10).

A copy of ``repro.cache.policy`` (numpy only), so that hit decisions,
ledgers and eviction orders are the reference's by construction.

Two orthogonal decisions live here, both deliberately free of any KV
plumbing so the prefix-cache tier can swap them independently:

* **Precision gating** (:func:`hit_allowed`): a cached KV entry was
  prefilled at *some* resolved per-layer bit vector, so a hit must
  respect the requester's resolved bit budget.  Three modes:

    - ``exact``    — serve only when the cached bits equal the
      requester's resolved bits (bit-exact replay of what fresh prefill
      would produce).
    - ``at_least`` — serve when the cached bits dominate elementwise
      (cached precision >= requested everywhere: the requester gets at
      least the fidelity it paid for; the ledger still charges the
      requester's own configuration for the miss fraction).
    - ``repriced`` — always serve on a key match; the engine records
      the *cached* precision/cost on the ``CostRecord`` so the ledger
      stays honest about which bits actually produced the KV rows.

* **Admission/eviction** (:class:`RepetitionAwarePolicy`): cache value
  is *modeled recompute EDP x observed repetition count* — the EDP the
  AP model (``apsim.metrics.price_bit_vector``) says re-prefilling the
  entry's tokens at its bits would cost, weighted by how often the
  key has been seen.  The lowest-value resident entry is evicted, and
  a new entry is admitted into a full cache only when its value meets
  the victim's (repetition counts persist across rejections, so a key
  that keeps arriving eventually earns its slot).  Ties break by
  insertion sequence (oldest first) — fully deterministic.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, Optional, Tuple

import numpy as np

HIT_POLICIES = ("exact", "at_least", "repriced")


def hit_allowed(policy: str, cached_w: np.ndarray, cached_a: np.ndarray,
                want_w: np.ndarray, want_a: np.ndarray) -> bool:
    """May an entry prefilled at (cached_w, cached_a) serve a request
    that resolved to (want_w, want_a)?  See module docstring."""
    if policy == "repriced":
        return True
    cw, ca = np.asarray(cached_w), np.asarray(cached_a)
    ww, wa = np.asarray(want_w), np.asarray(want_a)
    if policy == "exact":
        return bool(np.array_equal(cw, ww) and np.array_equal(ca, wa))
    if policy == "at_least":
        return bool((cw >= ww).all() and (ca >= wa).all())
    raise ValueError(f"unknown hit policy {policy!r} "
                     f"(choose from {HIT_POLICIES})")


@dataclasses.dataclass
class CacheLedger:
    """The tier's hit/miss ledger.  Invariant (tested): every cacheable
    admission is exactly one lookup, and every lookup is exactly one of
    hit / partial hit / miss — ``hits + partial_hits + misses ==
    lookups == cacheable admissions``."""
    hits: int = 0                   # full-prompt hits (prefill skipped)
    partial_hits: int = 0           # chunk-aligned prefix hits (extended)
    misses: int = 0                 # includes precision-gated refreshes
    refreshes: int = 0              # misses that re-prefilled an existing
                                    # key at a new precision
    evictions: int = 0
    rejected: int = 0               # admissions the value policy declined
    hit_tokens: int = 0             # prompt tokens served from cache
    computed_tokens: int = 0        # prompt tokens actually prefilled
    prefill_edp_saved_js: float = 0.0

    @property
    def lookups(self) -> int:
        return self.hits + self.partial_hits + self.misses

    @property
    def hit_rate(self) -> float:
        n = self.lookups
        return (self.hits + self.partial_hits) / n if n else 0.0

    def as_dict(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d["lookups"] = self.lookups
        d["hit_rate"] = round(self.hit_rate, 4)
        d["prefill_edp_saved_js"] = float(self.prefill_edp_saved_js)
        return d


class RepetitionAwarePolicy:
    """AP-cost-priced, repetition-aware admission/eviction.

    ``observe(key)`` counts every arrival of a repetition key (threaded
    from the traffic trace, or derived from prompt content); an entry's
    value is ``recompute_edp * count``.  ``plan(...)`` decides whether
    a new entry enters a full cache and which resident entry makes room.
    """

    def __init__(self, capacity: int = 32) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.counts: Dict[Hashable, int] = {}

    def observe(self, key: Hashable) -> int:
        """Count one arrival of ``key``; returns the running count."""
        c = self.counts.get(key, 0) + 1
        self.counts[key] = c
        return c

    def count(self, key: Hashable) -> int:
        return self.counts.get(key, 0)

    def value(self, key: Hashable, recompute_edp: float) -> float:
        """Cache value of an entry: modeled recompute EDP (J*s, from
        the AP pricing of the entry's bits over its tokens) x observed
        repetition count."""
        return float(recompute_edp) * max(self.count(key), 1)

    def plan(self, new_value: float,
             resident: Dict[Hashable, Tuple[float, int]]
             ) -> Tuple[bool, Optional[Hashable]]:
        """Admission decision for a new entry against the resident set
        (``{entry_key: (value, insertion_seq)}`` with values from
        :meth:`value`).  Returns ``(admit, victim_key)``: room left →
        admit outright; full → admit only when the new value meets the
        lowest resident value (that victim is evicted), deterministic
        tie-break by insertion seq (oldest first)."""
        if len(resident) < self.capacity:
            return True, None
        victim = min(resident,
                     key=lambda k: (resident[k][0], resident[k][1]))
        if float(new_value) >= resident[victim][0]:
            return True, victim
        return False, None

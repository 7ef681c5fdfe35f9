"""Cross-request prefix/KV-cache tier (DESIGN.md §10).

The counterpart of ``repro.serve.prefix_cache``, with the same logic.
Prompts are keyed by TOKEN CONTENT, so a hit is decided by what the model
would see, not by who sent it, and a hit installs the cached single-row
cache into the requester's :class:`repro_torch.models.lm.CachePool` slot
(``install_prefix``) instead of re-prefilling.

Keying is **chunked**: besides the full-prompt key, every
``chunk``-aligned prefix of a stored prompt registers a lookup key
pointing at the same entry, so a new prompt that merely *shares a prefix*
with a cached one still hits partially: the engine installs the shared
``keep`` tokens and extends the rest through the decode path.

Hits are **precision-aware**: each entry records the per-layer bit
vectors it was prefilled at, and ``hit_policy`` (``exact | at_least |
repriced``, ``repro_torch.cache.policy``) decides whether those bits may
serve the requester's resolved budget; a gated lookup is a miss that
refreshes the entry at the new precision.  Admission and eviction are
delegated to a :class:`repro_torch.cache.RepetitionAwarePolicy`: value =
modeled recompute EDP (AP pricing of the entry's bits over its tokens) x
observed repetition count, lowest value evicted.

The tier never touches device state itself: it holds prefilled
single-row cache dicts and last-token logits (torch tensors on the
engine's device, which ``CachePool.write_row``/``install_prefix`` copy and
the engine's partial-hit extension clones, never writes) plus host-side
numpy metadata; the :class:`~repro_torch.serve.engine.ServeEngine` owns
every install.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, List, Optional, Tuple

import numpy as np

from repro_torch.cache.policy import (HIT_POLICIES, CacheLedger,
                                      RepetitionAwarePolicy, hit_allowed)

__all__ = ["PrefixCache", "PrefixEntry", "PrefixHit"]


@dataclasses.dataclass
class PrefixEntry:
    """One cached prompt: its KV row plus the precision that made it."""
    key: bytes                          # full-prompt content key
    tokens: np.ndarray                  # (length,) int32 prompt
    length: int
    row_cache: object                   # (L, 1, Sc, ...) prefilled cache dict
    logits: object                      # last-token prefill logits (1,1,V)
    wbits: np.ndarray                   # (n_layers,) resolved weight bits
    abits: np.ndarray
    cost: object                        # per-token BitVectorCost at bits
    recompute_edp: float                # modeled EDP of re-prefilling
    count_key: Hashable                 # repetition-count key (policy)
    seq: int                            # insertion sequence (tie-break)
    prefix_keys: List[bytes] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class PrefixHit:
    """A lookup outcome: serve ``keep`` tokens of the prompt from
    ``entry``; ``full`` hits also reuse the entry's stored logits."""
    entry: PrefixEntry
    keep: int
    full: bool


class PrefixCache:
    """Content-keyed, chunked, precision-aware prefix/KV cache."""

    def __init__(self, *, chunk: int = 8, capacity: int = 32,
                 hit_policy: str = "at_least",
                 policy: Optional[RepetitionAwarePolicy] = None) -> None:
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if hit_policy not in HIT_POLICIES:
            raise ValueError(f"hit_policy must be one of {HIT_POLICIES}, "
                             f"got {hit_policy!r}")
        self.chunk = chunk
        self.hit_policy = hit_policy
        self.policy = policy or RepetitionAwarePolicy(capacity=capacity)
        self.entries: Dict[bytes, PrefixEntry] = {}
        # chunk-aligned prefix key -> (owning entry key, keep length);
        # first registration wins (deterministic), cleaned on eviction
        self._by_prefix: Dict[bytes, Tuple[bytes, int]] = {}
        self.ledger = CacheLedger()
        self._seq = 0

    @staticmethod
    def content_key(tokens) -> bytes:
        return np.ascontiguousarray(tokens, np.int32).tobytes()

    def __len__(self) -> int:
        return len(self.entries)

    # ------------------------------------------------------------------
    # Candidate search (shared by peek/lookup)
    # ------------------------------------------------------------------

    def _candidates(self, tokens: np.ndarray):
        """Yield (entry, keep, full) matches, longest keep first."""
        S = int(tokens.shape[0])
        hit = self._by_prefix.get(self.content_key(tokens))
        if hit is not None:
            entry = self.entries[hit[0]]
            if entry.length == S:
                yield entry, S, True
            elif S > 1:
                # the prompt is a strict prefix of a longer cached one:
                # its KV rows are all cached but the last-token logits
                # are not — recompute just that token via the extend path
                yield entry, S - 1, False
        top = ((S - 1) // self.chunk) * self.chunk
        for keep in range(top, 0, -self.chunk):
            hit = self._by_prefix.get(self.content_key(tokens[:keep]))
            if hit is not None and hit[1] == keep:
                yield self.entries[hit[0]], keep, False

    def peek(self, tokens) -> int:
        """Predicted cached-prefix length for a prompt (0 = miss) —
        no precision gate, no repetition-count side effects.  The
        admission planner uses this to scale a request's modeled EDP."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        for _, keep, _ in self._candidates(tokens):
            return keep
        return 0

    # ------------------------------------------------------------------
    # Lookup / store
    # ------------------------------------------------------------------

    def lookup(self, tokens, want_w, want_a, *,
               rep_key: Optional[Hashable] = None) -> Optional[PrefixHit]:
        """Resolve a prompt against the cache under the requester's
        resolved bits.  Counts the repetition key, takes the longest
        candidate whose precision passes ``hit_policy``, and keeps the
        ledger: every call is exactly one hit, partial hit, or miss."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        S = int(tokens.shape[0])
        self.policy.observe(self._count_key(tokens, rep_key))
        for entry, keep, full in self._candidates(tokens):
            if not hit_allowed(self.hit_policy, entry.wbits, entry.abits,
                               want_w, want_a):
                continue
            if full:
                self.ledger.hits += 1
            else:
                self.ledger.partial_hits += 1
            self.ledger.hit_tokens += keep
            self.ledger.computed_tokens += S - keep
            return PrefixHit(entry=entry, keep=keep, full=full)
        self.ledger.misses += 1
        self.ledger.computed_tokens += S
        return None

    def store(self, tokens, row_cache, logits, wbits, abits, cost, *,
              rep_key: Optional[Hashable] = None) -> bool:
        """Install/refresh the entry for a freshly prefilled prompt.
        ``cost`` is the per-token AP cost at (wbits, abits); the entry's
        cache value is its modeled recompute EDP x repetition count.
        Returns True when the entry is resident afterwards."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        S = int(tokens.shape[0])
        key = self.content_key(tokens)
        recompute_edp = (S * cost.energy_j) * (S * cost.latency_s)
        count_key = self._count_key(tokens, rep_key)
        old = self.entries.get(key)
        if old is None:
            admit, victim = self.policy.plan(
                self.policy.value(count_key, recompute_edp),
                {k: (self.policy.value(e.count_key, e.recompute_edp),
                     e.seq) for k, e in self.entries.items()})
            if not admit:
                self.ledger.rejected += 1
                return False
            if victim is not None:
                self._evict(victim)
        else:
            self.ledger.refreshes += 1
        entry = PrefixEntry(
            key=key, tokens=tokens, length=S, row_cache=row_cache,
            logits=logits, wbits=np.asarray(wbits, np.int64).copy(),
            abits=np.asarray(abits, np.int64).copy(), cost=cost,
            recompute_edp=float(recompute_edp), count_key=count_key,
            seq=(old.seq if old is not None else self._seq))
        if old is None:
            self._seq += 1
        self.entries[key] = entry
        self._by_prefix[key] = (key, S)
        for keep in range(self.chunk, S, self.chunk):
            pk = self.content_key(tokens[:keep])
            if pk not in self._by_prefix:
                self._by_prefix[pk] = (key, keep)
                entry.prefix_keys.append(pk)
        if old is not None:
            # keep the prefix keys this refresh registered too (ones an
            # evicted entry held when the old entry was stored): the
            # reference drops them from the list, so evicting this entry
            # would leave them pointing at nothing
            entry.prefix_keys = old.prefix_keys + entry.prefix_keys
        return True

    def _count_key(self, tokens: np.ndarray,
                   rep_key: Optional[Hashable]) -> Hashable:
        return rep_key if rep_key is not None else self.content_key(tokens)

    def _evict(self, key: bytes) -> None:
        entry = self.entries.pop(key)
        self._by_prefix.pop(key, None)
        for pk in entry.prefix_keys:
            if self._by_prefix.get(pk, (None,))[0] == key:
                del self._by_prefix[pk]
        self.ledger.evictions += 1

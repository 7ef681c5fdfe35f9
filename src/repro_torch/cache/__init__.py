"""Cross-request caching policies (DESIGN.md §10).

The counterpart of ``repro.cache``.  The serving tier's prefix/KV cache
(``repro_torch.serve.prefix_cache``) is split from its *policy*: this
package owns the questions "is a cached entry allowed to serve this
request?" (precision gating, :data:`HIT_POLICIES`) and "which entry is
worth keeping?" (:class:`RepetitionAwarePolicy`, admission/eviction priced
in AP-cost terms).
"""
from repro_torch.cache.policy import (HIT_POLICIES, CacheLedger,  # noqa: F401
                                      RepetitionAwarePolicy, hit_allowed)

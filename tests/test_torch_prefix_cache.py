"""The prefix cache on the CPU, port vs reference: the cache's ledger,
eviction and hit-policy decisions, and ``ServeEngine(prefix_cache=)``'s
miss, full hit and partial hit.

The cache's host logic is a copy, so every decision and ledger is
asserted EQUAL under the same store/lookup calls.  The engines serve
qwen3_4b SMOKE on weights made by the reference and carried across with
the weight bridge; the reference runs op by op (``jax.disable_jit``;
``tests/test_torch_lm.py`` says why).  Greedy tokens, ledgers and AP
records are EQUAL; a cache entry is bitwise unchanged after a partial hit
extends from it.  Sizes stay small: prompts of at most 8 tokens, 3 new
tokens, 2 slots.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import repro.serve.engine as jengine  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import policy as jpol  # noqa: E402
from repro.launch.serve import default_controller as jdefault  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve.prefix_cache import PrefixCache as JPrefixCache  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.cache import HIT_POLICIES  # noqa: E402
from repro_torch.core import policy as tpol  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.convert import from_numpy_params  # noqa: E402
from repro_torch.models.transformer import EMPTY_POS  # noqa: E402
from repro_torch.serve import PrefixCache  # noqa: E402
from repro_torch.serve.accounting import axis_cost, predict_table  # noqa: E402
from repro_torch.serve.engine import ServeEngine, default_controller  # noqa: E402

ARCH = "qwen3_4b"
ENGINE = dict(max_len=24, n_slots=2, prefill_len=8, decode_block=3)
CACHE = dict(chunk=4, capacity=4, hit_policy="exact")
NEW = 3                 # new tokens per request
LATE_TICK = 2           # the two partial hits arrive through submit_at


@pytest.fixture(scope="module")
def smoke():
    jcfg, tcfg = jconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = from_numpy_params(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    rng = np.random.default_rng(7)
    a = rng.integers(0, tcfg.vocab_size, (8,)).astype(np.int32)
    fresh = rng.integers(0, tcfg.vocab_size, (3,)).astype(np.int32)
    # a miss, its full hit, a chunk-aligned partial hit (keep 4, tail 3)
    # and the strict prefix (keep 3 of 4, tail 1)
    prompts = [a, a.copy(), np.concatenate([a[:4], fresh]), a[:4].copy()]
    return {"jcfg": jcfg, "tcfg": tcfg, "prompts": prompts,
            "jq": jlm.quantize_params(jparams, jcfg),
            "tq": tlm.quantize_params(tparams, tcfg),
            "n": tlm.n_bit_slots(tcfg)}


def _serve(eng, prompts, budget=10.0):
    """The miss and its full hit up front, the partial hits at LATE_TICK;
    returns the rids in request order and logs the admission order in
    ``eng.order``."""
    eng.order = []
    pick = eng.next_admission

    def logged():
        req = pick()
        eng.order.append(req.rid)
        return req

    eng.next_admission = logged
    rids = [eng.submit(p, max_new_tokens=NEW, budget_s=budget, rep_key=0)
            for p in prompts[:2]]
    for p in prompts[2:]:
        eng.submit_at(LATE_TICK, lambda p=p: rids.append(
            eng.submit(p, max_new_tokens=NEW, budget_s=budget)))
    eng.run()
    return rids


def _port_engine(smoke, controller=None, **kw):
    return ServeEngine(smoke["tcfg"], smoke["tq"], device="cpu",
                       controller=controller or default_controller(
                           smoke["n"]),
                       prefix_cache=PrefixCache(**CACHE), **{**ENGINE, **kw})


@pytest.fixture(scope="module")
def served(smoke):
    jeng = jengine.ServeEngine(smoke["jcfg"], smoke["jq"],
                               controller=jdefault(smoke["n"]),
                               prefix_cache=JPrefixCache(**CACHE), **ENGINE)
    with jax.disable_jit():
        jrids = _serve(jeng, smoke["prompts"])
    teng = _port_engine(smoke)
    trids = _serve(teng, smoke["prompts"])
    return {"jeng": jeng, "jrids": jrids, "teng": teng, "trids": trids}


# ---------------------------------------------------------------------------
# The cache's host logic against the reference's
# ---------------------------------------------------------------------------

def _cost(S):
    return types.SimpleNamespace(energy_j=1e-6 * (1 + S % 3),
                                 latency_s=1e-7 * (1 + S % 2))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("policy", HIT_POLICIES)
def test_cache_decisions_equal_reference(policy, seed):
    """A random run of lookups and stores (shared prefixes, three bit
    configurations, repetition keys, capacity 3 so entries evict and
    admissions are rejected): every lookup's outcome, the ledger, the
    resident entries in order, the prefix-key table and the repetition
    counts are EQUAL after every call, and no prefix key of the port's
    points at an evicted entry.  The reference can leave such a key
    behind (see the next test); the comparison runs until it does."""
    rng = np.random.default_rng(seed)
    bases = [rng.integers(0, 50, (12,)).astype(np.int32) for _ in range(4)]
    bits = [np.array([4, 4, 4]), np.array([8, 8, 8]), np.array([8, 4, 8])]
    caches = [JPrefixCache(chunk=4, capacity=3, hit_policy=policy),
              PrefixCache(chunk=4, capacity=3, hit_policy=policy)]

    def outcome(h):
        return None if h is None else (h.entry.key, h.keep, h.full)

    def same():
        j, t = caches
        assert t.ledger.as_dict() == j.ledger.as_dict()
        assert list(t.entries) == list(j.entries)
        assert t._by_prefix == j._by_prefix
        assert t.policy.counts == j.policy.counts
        assert all(k in t.entries for k, _ in t._by_prefix.values())
        for k in t.entries:
            for name in ("length", "recompute_edp", "count_key", "seq"):
                assert getattr(t.entries[k], name) == \
                    getattr(j.entries[k], name), name
            # the port keeps the keys a refresh registers after the old ones
            old = j.entries[k].prefix_keys
            assert t.entries[k].prefix_keys[:len(old)] == old
            np.testing.assert_array_equal(t.entries[k].wbits,
                                          j.entries[k].wbits)

    n_hits = 0
    for step in range(60):
        base = bases[int(rng.integers(4))]
        S = int(rng.integers(1, 13))
        toks = base[:S].copy()
        if rng.random() < 0.3:
            toks[-1] = 50 + step          # a fresh tail on a shared prefix
        w = bits[int(rng.integers(3))]
        key = int(rng.integers(3)) if rng.random() < 0.5 else None
        assert caches[1].peek(toks) == caches[0].peek(toks)
        got = [outcome(c.lookup(toks, w, w, rep_key=key)) for c in caches]
        assert got[1] == got[0], step
        n_hits += got[0] is not None
        if got[0] is None or not got[0][2]:
            stored = [c.store(toks, f"row{step}", f"logits{step}", w, w,
                              _cost(S), rep_key=key) for c in caches]
            assert stored[1] == stored[0]
        if any(k not in caches[0].entries
               for k, _ in caches[0]._by_prefix.values()):
            break                         # the reference's fault showed
        same()
    assert n_hits > 0 and caches[1].ledger.evictions > 0
    assert caches[1].ledger.lookups >= 20


def test_refreshed_entry_leaves_no_dangling_prefix_key():
    """A fault of the reference, fixed in the port: a prefix key that a
    refresh registers (it was held by an entry evicted since the first
    store) is dropped from the entry's list, so evicting the entry leaves
    the key pointing at nothing and the next lookup through it raises
    KeyError.  The port keeps the key on the list and removes it with the
    entry."""
    cost = types.SimpleNamespace(energy_j=1.0, latency_s=1.0)
    w4, w8 = np.array([4]), np.array([8])
    outcome = {}
    for name, cls in (("reference", JPrefixCache), ("port", PrefixCache)):
        pc = cls(chunk=2, capacity=2, hit_policy="exact")
        pc.store([1, 2, 7], "a", None, w8, w8, cost)           # owns [1, 2]
        pc.store([1, 2, 3, 4, 5], "b", None, w8, w8, cost)
        pc.store([9] * 6, "c", None, w8, w8, cost)              # evicts a
        pc.store([1, 2, 3, 4, 5], "b2", None, w4, w4, cost)     # refresh b
        pc.store([8] * 7, "d", None, w8, w8, cost)              # evicts b
        try:
            outcome[name] = pc.lookup([1, 2, 6], w8, w8)
        except KeyError:
            outcome[name] = "KeyError"
        assert pc.ledger.refreshes == 1 and pc.ledger.evictions == 2
    assert outcome == {"reference": "KeyError", "port": None}


# ---------------------------------------------------------------------------
# The engine against the reference's
# ---------------------------------------------------------------------------

def test_cached_stream_equals_reference_engine(served):
    """A miss, its full hit, a chunk-aligned partial hit and the strict
    prefix through both engines: greedy tokens, hit kinds, cached units,
    AP records, the scheduler ticks and the cache ledger are EQUAL; the
    port extended 3 + 1 tail tokens and prefilled once."""
    jeng, teng = served["jeng"], served["teng"]
    assert served["trids"] == served["jrids"]
    assert teng.order == jeng.order
    kinds = []
    for rid in served["trids"]:
        j, t = jeng.requests[rid], teng.requests[rid]
        assert t.tokens == j.tokens and len(t.tokens) == NEW, rid
        for name in ("cache_hit", "cached_units", "cached_mean_wbits",
                     "planned_units", "budget_s", "mean_wbits",
                     "admitted_tick", "finished_tick", "ap_units", "edp",
                     "prefill_edp_saved_js"):
            assert getattr(t, name) == getattr(j, name), (rid, name)
        assert t.ap_cost.per_layer_energy_j == j.ap_cost.per_layer_energy_j
        if j.cached_cost is None:
            assert t.cached_cost is None
        else:
            assert t.cached_cost.per_layer_energy_j == \
                j.cached_cost.per_layer_energy_j
        kinds.append((t.cache_hit, t.cached_units))
    assert kinds == [("", 0), ("full", 8), ("partial", 4), ("partial", 3)]
    assert teng.prefix_cache.ledger.as_dict() == \
        jeng.prefix_cache.ledger.as_dict()
    assert teng.calls["prefill"] == 1 and teng.calls["extend"] == 3 + 1
    assert teng.pool.free_slots == ENGINE["n_slots"]
    assert (teng.pool.cache["kpos"] == EMPTY_POS).all()


def test_partial_hit_leaves_the_entry_unchanged(smoke):
    """The extension runs on a clone: after both partial hits extend from
    the stored prompt's entry, every tensor of the entry is bitwise what
    the miss stored, and the full hit that follows still gives the
    miss's tokens."""
    eng = _port_engine(smoke)
    a = smoke["prompts"][0]
    first = eng.submit(a, max_new_tokens=NEW, budget_s=10.0)
    eng.run()
    (entry,) = eng.prefix_cache.entries.values()
    before = {k: v.clone() for k, v in entry.row_cache.items()}
    logits = entry.logits.clone()
    rids = [eng.submit(p, max_new_tokens=NEW, budget_s=10.0)
            for p in smoke["prompts"][2:]]
    eng.run()
    assert [eng.requests[r].cache_hit for r in rids] == ["partial"] * 2
    assert eng.calls["extend"] == 4
    for k, v in before.items():
        assert torch.equal(entry.row_cache[k], v), k
    assert torch.equal(entry.logits, logits)
    again = eng.submit(a, max_new_tokens=NEW, budget_s=10.0)
    eng.run()
    assert eng.requests[again].cache_hit == "full"
    assert eng.requests[again].tokens == eng.requests[first].tokens


def test_strict_prefix_extends_its_last_token(smoke, served):
    """A prompt that is a strict prefix of a cached one keeps S - 1
    tokens and recomputes the last: its first token is the argmax of one
    ``decode_step`` at position S - 1 on the entry's row masked to S - 1
    tokens."""
    teng = served["teng"]
    rid = served["trids"][3]
    prompt = smoke["prompts"][3]
    S = prompt.shape[0]
    rec = teng.requests[rid]
    assert (rec.cache_hit, rec.cached_units, rec.planned_units) == \
        ("partial", S - 1, 1 + NEW)
    # the miss's entry (the partial hits, precision-pure, stored their own)
    entry = teng.prefix_cache.entries[
        PrefixCache.content_key(smoke["prompts"][0])]
    assert len(teng.prefix_cache) == 3
    row = {k: v.clone() for k, v in entry.row_cache.items()}
    row["kpos"].masked_fill_(row["kpos"] >= S - 1, EMPTY_POS)
    wv, av = teng.controller.resolve(torch.tensor(10.0))
    with tops.bit_families(teng.families):
        logits, _ = tlm.decode_step(teng.qparams,
                                    torch.tensor([[int(prompt[-1])]]),
                                    S - 1, row, smoke["tcfg"], wv, av)
    assert int(logits[0, -1].argmax()) == rec.tokens[0]


def test_fluid_controller_is_charged_only_the_miss_fraction(smoke):
    """Under an EDP-axis FluidController (one window for the whole
    stream), each admission is charged its planned units less the cached
    ones, the avoided share is recorded as ``saved``, and the controller's
    state equals a reference FluidController fed the same admissions."""
    n = smoke["n"]
    base = default_controller(n)
    preds = predict_table(tlm.layer_gemm_dims(smoke["tcfg"]), base.configs,
                          axis="edp", units=ENGINE["prefill_len"] + NEW,
                          head=tlm.head_gemm_dims(smoke["tcfg"]))
    ctrl = tpol.FluidController(base.configs, preds, n, budget_axis="edp",
                                slo=4 * preds["int8"], window=8)
    eng = _port_engine(smoke, controller=ctrl)
    rids = _serve(eng, smoke["prompts"], budget=None)
    recs = [eng.requests[r] for r in rids]
    assert [r.cache_hit for r in recs] == ["", "full", "partial", "partial"]
    want_saved = 0.0
    jctrl = jpol.FluidController(dict(base.configs), dict(preds), n,
                                 budget_axis="edp", slo=4 * preds["int8"],
                                 window=8)
    for r in (eng.requests[rid] for rid in eng.order):
        units = r.prompt_len + NEW
        assert r.planned_units == units - r.cached_units
        assert jctrl.admission_budget(None) == r.budget_s
        jctrl.charge(r.axis_planned("edp"))
        if r.cached_units:
            d = (axis_cost(r.ap_cost, "edp", units)
                 - axis_cost(r.ap_cost, "edp", r.planned_units))
            jctrl.record_saved(d)
            want_saved += d
    assert ctrl.saved == want_saved == jctrl.saved and ctrl.saved > 0
    assert (ctrl.spent, ctrl.served) == (jctrl.spent, jctrl.served)
    assert ctrl.spent == pytest.approx(
        sum(r.axis_planned("edp") for r in recs), rel=1e-12)
    assert eng.prefix_cache.ledger.prefill_edp_saved_js == pytest.approx(
        sum(r.prefill_edp_saved_js for r in recs), rel=1e-12)

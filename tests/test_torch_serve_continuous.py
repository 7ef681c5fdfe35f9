"""Continuous batching on the CPU: ragged prefill, the cache pool, the
slot scheduler and ``ServeEngine.submit``/``step``/``run``, port vs
reference.

qwen3_4b SMOKE (and starcoder2_15b SMOKE for the sliding window), weights
made by the reference and carried across with the weight bridge.  The
reference runs op by op (``jax.disable_jit``; ``tests/test_torch_lm.py``
says why).  Host logic (admission order, slot assignment, scheduler
ticks, AP prices) is asserted EQUAL.  Ragged prefill logits are held to
the prefill tolerance of ``tests/test_torch_lm.py`` (2e-2 x max|logit|),
``kpos`` EQUAL; greedy tokens EQUAL.  Every size is small: prompts of
at most 8 tokens, at most 6 new tokens, 2 or 3 slots.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import repro.serve.engine as jengine  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch.serve import default_controller as jdefault  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import runtime as jruntime  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import policy as tpol  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.convert import from_numpy_params  # noqa: E402
from repro_torch.models.transformer import EMPTY_POS  # noqa: E402
from repro_torch.serve import runtime as truntime  # noqa: E402
from repro_torch.serve.engine import ServeEngine, default_controller  # noqa: E402

ARCH = "qwen3_4b"
LOGIT_TOL = 2e-2        # x max|logit|, the prefill tolerance of test_torch_lm
FAMILIES = (4, 8)
ENGINE = dict(max_len=24, n_slots=2, prefill_len=8, decode_block=3)
# (prompt length, budget -> int4 / int8 / mixed, max new tokens); the last
# arrives through submit_at at tick 2
REQUESTS = [(5, 0.4, 5), (8, 10.0, 4), (3, 0.8, 5), (6, 0.4, 3)]
LATE_TICK = 2


def _np(a):
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _bridge(arch):
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = from_numpy_params(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return {"jcfg": jcfg, "tcfg": tcfg,
            "jq": jlm.quantize_params(jparams, jcfg),
            "tq": tlm.quantize_params(tparams, tcfg)}


@pytest.fixture(scope="module")
def smoke():
    s = _bridge(ARCH)
    n = tlm.n_bit_slots(s["tcfg"])
    s["jctrl"], s["tctrl"] = jdefault(n), default_controller(n)
    prng = np.random.default_rng(11)
    s["prompts"] = [prng.integers(0, s["tcfg"].vocab_size, (S,))
                    for S, _, _ in REQUESTS]
    return s


def _engine(smoke, **kw):
    return ServeEngine(smoke["tcfg"], smoke["tq"],
                       controller=smoke["tctrl"], device="cpu",
                       **{**ENGINE, **kw})


def _serve(eng, prompts):
    """Submit REQUESTS (the last one deferred), log the admission order,
    run; returns ([rid per request], [admitted rid, ...])."""
    order = []
    pick = eng.next_admission

    def logged():
        req = pick()
        order.append(req.rid)
        return req

    eng.next_admission = logged
    rids = [eng.submit(p, max_new_tokens=m, budget_s=b)
            for p, (_, b, m) in zip(prompts[:-1], REQUESTS[:-1])]
    _, b, m = REQUESTS[-1]
    eng.submit_at(LATE_TICK, lambda: rids.append(
        eng.submit(prompts[-1], max_new_tokens=m, budget_s=b)))
    eng.run()
    return rids, order


@pytest.fixture(scope="module")
def served(smoke):
    """The same stream through the reference engine (op by op) and the
    port's."""
    jeng = jengine.ServeEngine(smoke["jcfg"], smoke["jq"],
                               controller=smoke["jctrl"], **ENGINE)
    with jax.disable_jit():
        jrids, jorder = _serve(jeng, smoke["prompts"])
    teng = _engine(smoke)
    trids, torder = _serve(teng, smoke["prompts"])
    return {"jeng": jeng, "jrids": jrids, "jorder": jorder,
            "teng": teng, "trids": trids, "torder": torder}


# ---------------------------------------------------------------------------
# Ragged prefill
# ---------------------------------------------------------------------------

def test_ragged_prefill_matches_reference(smoke):
    """B = 3 rows of lengths 5, 8 and 1 in one right-padded (3, 8) batch
    at per-row bits: logits at each row's own last token within the
    prefill tolerance, kpos EQUAL (pads at EMPTY_POS), the real tokens'
    k/v within the cache tolerance of test_torch_lm."""
    jcfg, tcfg = smoke["jcfg"], smoke["tcfg"]
    lengths = np.array([5, 8, 1], np.int32)
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (3, 8)).astype(np.int32)
    wv = np.array([[4, 4], [8, 4], [8, 8]], np.int32)
    with jax.disable_jit(), jops.bit_families(FAMILIES):
        jlog, jc = jlm.prefill(smoke["jq"], {"tokens": jnp.asarray(toks)},
                               jcfg, jnp.asarray(wv), jnp.asarray(wv),
                               jlm.empty_cache(jcfg, 3, 16),
                               lengths=jnp.asarray(lengths))
    with tops.bit_families(FAMILIES):
        tlog, tc = tlm.prefill(smoke["tq"], {"tokens": torch.from_numpy(toks)},
                               tcfg, torch.from_numpy(wv),
                               torch.from_numpy(wv),
                               tlm.empty_cache(tcfg, 3, 16, device="cpu"),
                               lengths=torch.from_numpy(lengths))
    V = jcfg.vocab_size
    got, want = _np(tlog)[..., :V], _np(jlog)[..., :V]
    assert got.shape == (3, 1, V)
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    kpos = tc["kpos"].numpy()
    np.testing.assert_array_equal(kpos, np.asarray(jc["kpos"]))
    for row, n in enumerate(lengths):
        assert (kpos[:, row, :n] == np.arange(n)).all()
        assert (kpos[:, row, n:] == EMPTY_POS).all()
    real = kpos < EMPTY_POS
    for leaf in ("k", "v"):
        np.testing.assert_allclose(_np(tc[leaf])[real],
                                   _np(jc[leaf])[real], rtol=2e-2, atol=2e-2)


def test_sliding_window_ragged_prefill_keeps_real_tokens():
    """A short prompt padded past the ring capacity keeps its real tokens
    (per-row gather), not the padding tail: the continuous path gives the
    tokens of the exact-length whole-batch path (the reference's
    construction, starcoder2_15b SMOKE, window 8)."""
    s = _bridge("starcoder2_15b")
    cfg, q = s["tcfg"], s["tq"]
    n = tlm.n_bit_slots(cfg)
    ctrl = tpol.BudgetController({"int8": tpol.fixed(8)}, {"int8": 1.0}, n)
    prompt = np.asarray([3, 1, 4, 1], np.int64)
    # prefill_len=16 > ring capacity Sc=8: the padded buffer overflows
    eng = ServeEngine(cfg, q, max_len=64, controller=ctrl, n_slots=1,
                      prefill_len=16, decode_block=4, device="cpu")
    rid = eng.submit(prompt, max_new_tokens=6, budget_s=10.0)
    eng.step()                                      # still in flight
    kpos0 = eng.pool.cache["kpos"][0, 0].numpy()
    assert (kpos0 < EMPTY_POS).sum() >= 4           # real tokens survived
    got = eng.run()[rid].tokens[:4]
    eng2 = ServeEngine(cfg, q, max_len=64, controller=ctrl, device="cpu")
    want = eng2.generate({"tokens": torch.from_numpy(prompt[None])}, 4)[0]
    assert got == want.tolist()
    with pytest.raises(ValueError, match="sliding_window"):
        eng.submit(prompt, max_new_tokens=2, draft_k=2)


# ---------------------------------------------------------------------------
# The cache pool
# ---------------------------------------------------------------------------

def _row(cfg, S, seed, lib):
    """A single-row cache holding positions 0..S-1 with random k/v, in the
    reference's (jnp) or the port's (torch) form."""
    g = np.random.default_rng(seed)
    kv = (cfg.n_layers, 1, 16, cfg.n_kv_heads, cfg.head_dim)
    kpos = np.full((cfg.n_layers, 1, 16), EMPTY_POS, np.int32)
    kpos[:, :, :S] = np.arange(S)
    k = g.standard_normal(kv).astype(np.float32)
    v = g.standard_normal(kv).astype(np.float32)
    if lib == "jax":
        return {"kpos": jnp.asarray(kpos), "k": jnp.asarray(k, jnp.bfloat16),
                "v": jnp.asarray(v, jnp.bfloat16)}
    return {"kpos": torch.from_numpy(kpos),
            "k": torch.from_numpy(k).bfloat16(),
            "v": torch.from_numpy(v).bfloat16()}


def test_cache_pool_matches_reference(smoke):
    """alloc/free/reset, the install guards, write_row, install_prefix,
    copy_row and rollback: the port's pool state equals the reference
    pool's after the same calls, and installs copy rather than alias."""
    jcfg, tcfg = smoke["jcfg"], smoke["tcfg"]
    jp = jlm.CachePool(jcfg, n_slots=3, max_len=16)
    tp = tlm.CachePool(tcfg, n_slots=3, max_len=16, device="cpu")

    def same():
        np.testing.assert_array_equal(tp.lengths, jp.lengths)
        assert tp.free_slots == jp.free_slots
        np.testing.assert_array_equal(tp.cache["kpos"].numpy(),
                                      np.asarray(jp.cache["kpos"]))
        real = tp.cache["kpos"].numpy() < EMPTY_POS
        for leaf in ("k", "v"):
            np.testing.assert_array_equal(_np(tp.cache[leaf])[real],
                                          _np(jp.cache[leaf])[real])

    slots = [(jp.alloc(), tp.alloc()) for _ in range(3)]
    assert all(a == b for a, b in slots) and {a for a, _ in slots} == {0, 1,
                                                                       2}
    assert jp.alloc() is None and tp.alloc() is None
    for pool in (jp, tp):
        with pytest.raises(ValueError, match="out of range"):
            pool.write_row(_row(tcfg, 3, 0, "torch" if pool is tp else
                                "jax"), 5, 3)
        with pytest.raises(ValueError, match="max_len"):
            pool.write_row(_row(tcfg, 3, 0, "torch" if pool is tp else
                                "jax"), 0, 17)
    trow = _row(tcfg, 5, 1, "torch")
    jp.write_row(_row(tcfg, 5, 1, "jax"), 0, 5)
    tp.write_row(trow, 0, 5)
    jp.install_prefix(_row(tcfg, 6, 2, "jax"), 1, 4)
    trow2 = _row(tcfg, 6, 2, "torch")
    tp.install_prefix(trow2, 1, 4)
    same()
    # the pool copied the rows: writing into the sources changes nothing
    before = tp.cache["k"].clone()
    trow["k"].fill_(7)
    trow2["k"].fill_(7)
    trow2["kpos"].fill_(0)
    assert torch.equal(tp.cache["k"], before)
    jp.copy_row(0, 2)
    tp.copy_row(0, 2)
    same()
    tp.cache["k"][:, 0] = 3                         # dst is its own copy
    assert torch.equal(tp.cache["k"][:, 2], before[:, 0])
    tp.write_row(_row(tcfg, 5, 1, "torch"), 0, 5)
    jp.rollback(np.array([2, EMPTY_POS, 3], np.int32))
    tp.rollback(np.array([2, EMPTY_POS, 3], np.int32))
    same()
    kp = tp.cache["kpos"].numpy()
    assert (kp[:, 0, :3] == np.arange(3)).all()
    assert (kp[:, 0, 3:] == EMPTY_POS).all()
    assert (kp[:, 1, :4] == np.arange(4)).all()
    assert (kp[:, 2, :4] == np.arange(4)).all()
    for pool in (jp, tp):
        pool.free(1)
        with pytest.raises(ValueError, match="double-freed"):
            pool.free(1)
        with pytest.raises(ValueError, match="alloc"):
            pool.write_row(_row(tcfg, 3, 0, "torch" if pool is tp else
                                "jax"), 1, 3)
        with pytest.raises(ValueError, match="nothing to copy"):
            pool.copy_row(1, 0)
    same()
    assert tp.alloc() == jp.alloc() == 1            # LIFO recycle


def test_slot_table_lifecycle():
    cols = dict(t=(np.int64, 0), budget=(np.float64, 0.0))
    for mod in (jruntime, truntime):
        st = mod.SlotTable(3, **cols)
        st.occupy(1, rid=7, t=5, budget=0.4)
        assert st.active.tolist() == [False, True, False]
        assert st["t"].tolist() == [0, 5, 0] and st["budget"][1] == 0.4
        st.release(1)
        assert not st.active.any() and st["t"][1] == 0


# ---------------------------------------------------------------------------
# Scheduler and engine against the reference
# ---------------------------------------------------------------------------

def test_continuous_stream_equals_reference_engine(served):
    """The same submits (one deferred through submit_at) through both
    engines: greedy tokens, admission order, slots, scheduler ticks, AP
    records and the queue-depth series are EQUAL."""
    jeng, teng = served["jeng"], served["teng"]
    assert served["trids"] == served["jrids"]
    assert served["torder"] == served["jorder"]
    for rid in served["trids"]:
        j, t = jeng.requests[rid], teng.requests[rid]
        assert t.tokens == j.tokens and t.done and j.done
        assert len(t.tokens) == REQUESTS[rid][2]
        for name in ("slot", "prompt_len", "budget_s", "mean_wbits",
                     "planned_units", "submitted_tick", "admitted_tick",
                     "finished_tick", "ap_units"):
            assert getattr(t, name) == getattr(j, name), name
        assert t.ap_cost.per_layer_cycles == j.ap_cost.per_layer_cycles
        assert t.ap_cost.per_layer_energy_j == j.ap_cost.per_layer_energy_j
        assert t.edp == j.edp
    assert teng.requests[3].submitted_tick == LATE_TICK
    for name in ("tokens", "admitted", "completed", "ticks", "queue_depth",
                 "active_depth", "unserved"):
        assert getattr(teng.stats, name) == getattr(jeng.stats, name), name
    # every slot is free again and every cache entry masked
    assert teng.pool.free_slots == ENGINE["n_slots"]
    assert (teng.pool.cache["kpos"] == EMPTY_POS).all()
    assert teng.calls["prefill"] == len(REQUESTS)


def test_continuous_equals_standalone_prefill_and_decode(smoke, served):
    """Each request's tokens equal its standalone run: ragged prefill at
    batch 1, then a decode_step loop at the same bits."""
    teng = served["teng"]
    cfg = smoke["tcfg"]
    for rid, (S, budget, m) in zip(served["trids"], REQUESTS):
        wv, av = smoke["tctrl"].resolve(torch.tensor(budget))
        toks = torch.zeros((1, ENGINE["prefill_len"]), dtype=torch.int32)
        toks[0, :S] = torch.from_numpy(smoke["prompts"][rid])
        cache = tlm.empty_cache(cfg, 1, ENGINE["max_len"], device="cpu")
        with tops.bit_families(teng.families):
            logits, cache = tlm.prefill(teng.qparams, {"tokens": toks}, cfg,
                                        wv, av, cache,
                                        lengths=torch.tensor([S]))
            want = [int(logits[0, -1].argmax())]
            for t in range(S, S + m - 1):
                logits, cache = tlm.decode_step(
                    teng.qparams, torch.tensor([[want[-1]]]),
                    torch.tensor([t]), cache, cfg, wv, av)
                want.append(int(logits[0, -1].argmax()))
        assert teng.requests[rid].tokens == want, rid


def test_mixed_budget_row_equals_served_alone(smoke, served):
    """Rows are independent: the int4 request served beside int8 and
    mixed rows gives the tokens it gets alone in the pool."""
    eng = _engine(smoke)
    S, budget, m = REQUESTS[0]
    rid = eng.submit(smoke["prompts"][0], max_new_tokens=m, budget_s=budget)
    assert eng.run()[rid].tokens == served["teng"].requests[0].tokens


def test_admission_prefers_cheapest_edp_and_never_starves(smoke):
    """One slot: queued requests admit cheapest modeled EDP first (int4
    before int8) whatever the submission order; under a stream of cheap
    arrivals the expensive one is admitted FIFO after starvation_ticks."""
    prompt = smoke["prompts"][2]
    eng = _engine(smoke, n_slots=1)
    exp = eng.submit(prompt, max_new_tokens=2, budget_s=10.0)
    cheap = [eng.submit(prompt, max_new_tokens=2, budget_s=0.4)
             for _ in range(2)]
    done = []
    while len(done) < 3:
        done.extend(eng.step())
    assert done == cheap + [exp]

    eng = _engine(smoke, n_slots=1)
    exp = eng.submit(prompt, max_new_tokens=2, budget_s=10.0)
    eng.submit(prompt, max_new_tokens=2, budget_s=0.4)
    finished_before = 0
    for tick in range(3 * eng.starvation_ticks):
        eng.submit(prompt, max_new_tokens=2, budget_s=0.4)
        done = eng.step()
        if exp in done:
            break
        finished_before += len(done)
    else:
        pytest.fail("expensive request starved by cheap arrivals")
    assert finished_before >= 1 and tick <= 2 * eng.starvation_ticks
    assert eng.requests[exp].mean_wbits == 8.0


def test_submit_at_and_run_on_exhaust(smoke):
    eng = _engine(smoke)
    prompt = smoke["prompts"][0]
    rid = eng.submit(prompt, max_new_tokens=6, budget_s=0.4)
    eng.submit_at(5, lambda: eng.submit(prompt, max_new_tokens=2))
    with pytest.raises(ValueError, match="on_exhaust"):
        eng.run(on_exhaust="drop")
    res = eng.run(max_ticks=1, on_exhaust="report")
    assert not res[rid].done and eng.stats.unserved == 2   # 1 + 1 late
    with pytest.raises(ValueError, match="past"):
        eng.submit_at(0, lambda: 0)
    with pytest.raises(RuntimeError, match="exhausted"):
        eng.run(max_ticks=1)
    res = eng.run()
    assert all(r.done for r in res.values()) and len(res) == 2


def test_eos_and_sampling(smoke, served):
    """eos ends a request early and frees its slot; top_k = 1 at any
    temperature is the greedy stream; sampled rows stay in the
    vocabulary and repeat from the seed."""
    prompt = smoke["prompts"][0]
    full = served["teng"].requests[0].tokens
    eng = _engine(smoke, eos_id=full[2])
    rid = eng.submit(prompt, max_new_tokens=5, budget_s=0.4)
    assert eng.run()[rid].tokens == full[:3]
    assert eng.pool.free_slots == ENGINE["n_slots"]
    eng = _engine(smoke)
    rid = eng.submit(prompt, max_new_tokens=5, budget_s=0.4,
                     temperature=1.7, top_k=1)
    assert eng.run()[rid].tokens == full
    runs = []
    for _ in range(2):
        eng = _engine(smoke, seed=5)
        rid = eng.submit(prompt, max_new_tokens=5, budget_s=0.4,
                         temperature=1.5, top_k=8)
        runs.append(eng.run()[rid].tokens)
    assert runs[0] == runs[1]
    assert all(0 <= t < smoke["tcfg"].vocab_size for t in runs[0])

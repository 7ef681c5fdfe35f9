"""Trace-driven traffic on the CPU, port vs reference: the seeded trace
generator, its payloads, the JSONL round trip, the replayer and the
metrics collector.

``repro_torch.serve.traffic`` is a numpy copy of the reference, so traces
and payloads are asserted byte-EQUAL for every pattern.  The replayer
drives each package's own engines; its entries are host records
(scheduler ticks, bits, AP prices), so they and the summaries are
asserted EQUAL.  No eos is set, so tokens play no part in them and the
reference engines run jitted.  Sizes stay small: ResNet18 at 32 px and
qwen3_4b SMOKE with prompts of at most 8 tokens.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import repro.serve.engine as jengine  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import policy as jpol  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import traffic as jtr  # noqa: E402
from repro.serve.cnn import CNNServeEngine as JCNNEngine  # noqa: E402
from repro.serve.prefix_cache import PrefixCache as JPrefixCache  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.apsim.workloads import Layer  # noqa: E402
from repro_torch.core import policy as tpol  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.convert import from_numpy_params  # noqa: E402
from repro_torch.serve import PrefixCache  # noqa: E402
from repro_torch.serve import traffic as ttr  # noqa: E402
from repro_torch.serve.cnn import CNNServeEngine  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

PATTERNS = ("poisson", "diurnal", "spike", "mmpp")
TRACE = dict(ticks=12, rate=1.5, seed=3, repetition=0.4, cnn_frac=0.5,
             lm_archs=("qwen3_4b", "stablelm_12b"),
             cnn_archs=("resnet18", "alexnet"), prompt_len=8,
             max_new_tokens=3, budget=(0.4, 10.0, 0.8), slo_edp=1e-8)


def _same_trace(t, j):
    assert (t.pattern, t.seed, t.ticks, t.rates) == \
        (j.pattern, j.seed, j.ticks, j.rates)
    assert [dataclasses.asdict(r) for r in t.requests] == \
        [dataclasses.asdict(r) for r in j.requests]
    np.testing.assert_array_equal(t.counts(), j.counts())


@pytest.mark.parametrize("pattern", PATTERNS)
def test_traces_and_payloads_are_byte_equal(pattern):
    """Every pattern: the rate series, the arrivals (ticks, kinds, archs,
    keys, budgets) and every LM prompt and CNN image are byte-EQUAL; a
    repeated key replays a byte-identical payload."""
    kw = dict(TRACE, burst_at=4) if pattern == "spike" else TRACE
    j = jtr.synth_trace(pattern, **kw)
    t = ttr.synth_trace(pattern, **kw)
    _same_trace(t, j)
    np.testing.assert_array_equal(
        ttr.pattern_rates(pattern, 12, 1.5, seed=3),
        jtr.pattern_rates(pattern, 12, 1.5, seed=3))
    assert t.n_requests > 5
    first = {}
    for r, rj in zip(t.requests, j.requests):
        if r.workload == "lm":
            got = ttr.payload_tokens(t, r, 1000)
            assert got.tobytes() == jtr.payload_tokens(j, rj, 1000).tobytes()
        else:
            got = ttr.payload_image(t, r, (8, 8, 3))
            assert got.tobytes() == \
                jtr.payload_image(j, rj, (8, 8, 3)).tobytes()
        assert first.setdefault((r.workload, r.key), got.tobytes()) == \
            got.tobytes()


def test_jsonl_round_trip_and_file_pattern(tmp_path):
    """dump_trace / load_trace round-trip, a hand-written file of bare
    ticks replays with the default fields, and both packages read the same
    file into the same trace."""
    t = ttr.synth_trace("spike", **TRACE)
    path = tmp_path / "trace.jsonl"
    ttr.dump_trace(t, str(path))
    back = ttr.synth_trace("file", path=str(path), ticks=0)
    _same_trace(back, jtr.synth_trace("file", path=str(path), ticks=0))
    assert [dataclasses.asdict(r) for r in back.requests] == \
        [dataclasses.asdict(r) for r in t.requests]
    bare = tmp_path / "bare.jsonl"
    bare.write_text('# hand-written\n{"t": 2}\n\n{"t": 0, "key": 5}\n'
                    '{"t": 1, "workload": "cnn"}\n')
    _same_trace(ttr.load_trace(str(bare), ticks=4),
                jtr.load_trace(str(bare), ticks=4))
    with pytest.raises(ValueError, match="tick"):
        bad = tmp_path / "bad.jsonl"
        bad.write_text('{"key": 1}\n')
        ttr.load_trace(str(bad))
    with pytest.raises(ValueError, match="repetition"):
        ttr.synth_trace("poisson", repetition=1.0)
    with pytest.raises(ValueError, match="pattern"):
        ttr.pattern_rates("bursty", 4, 1.0)


# ---------------------------------------------------------------------------
# The replayer against the reference's
# ---------------------------------------------------------------------------

def _same_replay(tres, jres):
    assert tres.entries == jres.entries
    assert (tres.queue_depth, tres.active_depth, tres.ticks,
            tres.unserved) == (jres.queue_depth, jres.active_depth,
                               jres.ticks, jres.unserved)
    for window in (4, 8):
        assert ttr.summarize(tres, window=window) == \
            jtr.summarize(jres, window=window)


@pytest.fixture(scope="module")
def net():
    box = {}

    def init(key):
        p, box["layers"] = jcnn.init_cnn("resnet18", key, image=32)
        return p

    params = jax.jit(init)(jax.random.PRNGKey(0))
    tparams = from_numpy_params(jax.tree_util.tree_map(np.asarray, params),
                                device="cpu")
    return {"params": params, "jlayers": box["layers"], "tparams": tparams,
            "layers": [Layer(**dataclasses.asdict(l))
                       for l in box["layers"]]}


@pytest.mark.parametrize("closed", [False, True])
def test_cnn_replay_equals_reference(net, closed):
    """A 32-px ResNet18 spike trace (the burst spills past max_batch into
    later ticks) through each package's CNN engine, open loop on per-image
    budgets or closed loop on a tick-windowed FluidController: the
    entries, the tick series and the summaries are EQUAL."""
    jb = jpol.cnn_budget_controller("resnet18", layers=net["jlayers"])
    tb = tpol.cnn_budget_controller("resnet18", layers=net["layers"])
    med = tb.predicted_latency_s["hawqv3-medium"]
    budgets = tuple(tb.predicted_latency_s[k] * 1.01 for k in tb.order())
    if closed:
        kw = dict(slo=2 * 3 * med, window_ticks=2)
        jb = jpol.FluidController.from_open_loop(jb, **kw)
        tb = tpol.FluidController.from_open_loop(tb, **kw)
    trace = dict(ticks=10, rate=1.5, seed=1, burst_mag=4.0, burst_at=3,
                 burst_len=2, cnn_frac=1.0, budget=budgets, slo_edp=med)
    jt = jtr.synth_trace("spike", **trace)
    tt = ttr.synth_trace("spike", **trace)
    jeng = JCNNEngine(net["params"], net["jlayers"], controller=jb,
                      max_batch=4)
    teng = CNNServeEngine(net["tparams"], net["layers"], controller=tb,
                          max_batch=4, device="cpu")
    jres = jtr.TraceReplayer(jt, {}, cnn_engines={"resnet18": jeng},
                             image_hw=32, use_budgets=not closed).replay()
    tres = ttr.TraceReplayer(tt, {}, cnn_engines={"resnet18": teng},
                             image_hw=32, use_budgets=not closed).replay()
    _same_replay(tres, jres)
    assert max(tres.queue_depth) > 0 and tres.unserved == 0
    assert len({e["mean_wbits"] for e in tres.entries}) > 1
    assert teng.stats.images == tt.n_requests
    if closed:
        assert (tb.spent, tb.served, tb.ticks) == (jb.spent, jb.served,
                                                   jb.ticks)


@pytest.fixture(scope="module")
def smoke():
    jcfg, tcfg = jconfigs.get_smoke("qwen3_4b"), tconfigs.get_smoke(
        "qwen3_4b")
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = from_numpy_params(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return {"jcfg": jcfg, "tcfg": tcfg,
            "jq": jlm.quantize_params(jparams, jcfg),
            "tq": tlm.quantize_params(tparams, tcfg)}


ENGINE = dict(max_len=24, n_slots=2, prefill_len=8, decode_block=3)
LM_TRACE = dict(ticks=8, rate=1.2, seed=0, repetition=0.5, prompt_len=8,
                max_new_tokens=4, budget=(10.0, 0.4))


def _controllers(n):
    def ctrl(mod):
        return mod.BudgetController(
            {"int4": mod.fixed(4),
             "mixed": mod.per_layer([8, 4], name="mixed"),
             "int8": mod.fixed(8)},
            {"int4": 0.5, "mixed": 0.75, "int8": 1.0}, n)
    return ctrl(jpol), ctrl(tpol)


def test_lm_replay_equals_reference(smoke):
    """A SMOKE LM trace with repeated keys through each package's
    ServeEngine with a prefix cache (the replayer threads each arrival's
    key as ``rep_key``): the entries, tick series, summaries and cache
    ledgers are EQUAL, and repeats were served from the cache."""
    n = tlm.n_bit_slots(smoke["tcfg"])
    jc, tc = _controllers(n)
    cache = dict(chunk=4, capacity=4, hit_policy="at_least")
    jeng = jengine.ServeEngine(smoke["jcfg"], smoke["jq"], controller=jc,
                               prefix_cache=JPrefixCache(**cache), **ENGINE)
    teng = ServeEngine(smoke["tcfg"], smoke["tq"], controller=tc,
                       prefix_cache=PrefixCache(**cache), device="cpu",
                       **ENGINE)
    jt = jtr.synth_trace("poisson", **LM_TRACE)
    tt = ttr.synth_trace("poisson", **LM_TRACE)
    jres = jtr.TraceReplayer(jt, {"qwen3_4b": jeng}).replay()
    tres = ttr.TraceReplayer(tt, {"qwen3_4b": teng}).replay()
    _same_replay(tres, jres)
    assert teng.prefix_cache.ledger.as_dict() == \
        jeng.prefix_cache.ledger.as_dict()
    assert teng.prefix_cache.ledger.hits > 0
    assert teng.prefix_cache.policy.counts == jeng.prefix_cache.policy.counts
    assert all(e["done"] for e in tres.entries)


def test_single_runtime_replay_equals_reference(smoke):
    """The single-engine path: each arrival through ``submit_at`` and
    ``run()``, collected by ``result_from_runtime``: EQUAL entries, tick
    series and summaries."""
    n = tlm.n_bit_slots(smoke["tcfg"])
    jc, tc = _controllers(n)
    out = []
    for tr, eng in ((jtr, jengine.ServeEngine(smoke["jcfg"], smoke["jq"],
                                              controller=jc, **ENGINE)),
                    (ttr, ServeEngine(smoke["tcfg"], smoke["tq"],
                                      controller=tc, device="cpu",
                                      **ENGINE))):
        trace = tr.synth_trace("diurnal", **LM_TRACE)
        meta = {}

        def submit(r, eng=eng, trace=trace, tr=tr, meta=meta):
            rid = eng.submit(tr.payload_tokens(trace, r, 500),
                             max_new_tokens=r.max_new_tokens,
                             budget_s=r.budget, rep_key=r.key)
            meta[rid] = r

        for r in trace.requests:
            eng.submit_at(r.t, lambda r=r, submit=submit: submit(r))
        eng.run()
        out.append(tr.result_from_runtime(eng, meta))
    jres, tres = out
    _same_replay(tres, jres)
    assert len(tres.entries) == len(jres.entries) > 3


def test_replay_submits_deferred_arrivals(smoke):
    """The port's one extension of the replayer: an engine's ``submit_at``
    arrivals reach a trace replay (``sched_tick`` submits them), also
    after the trace's last arrival, and the replay runs until they are
    served.  Its records EQUAL the single-runtime path's (every arrival
    through ``submit_at`` and ``run()``), and each record's host clocks
    are ordered: submitted <= admitted <= first token <= finished."""
    n = tlm.n_bit_slots(smoke["tcfg"])
    trace = ttr.synth_trace("poisson", **LM_TRACE)
    late_tick = max(r.t for r in trace.requests) + 2
    extra = [np.arange(1, 7, dtype=np.int32), np.arange(3, 11, dtype=np.int32)]

    def engine():
        return ServeEngine(smoke["tcfg"], smoke["tq"],
                           controller=_controllers(n)[1], device="cpu",
                           **ENGINE)

    def defer(eng, rids):
        for p in extra:
            eng.submit_at(late_tick, lambda p=p: rids.append(
                eng.submit(p, max_new_tokens=3, budget_s=10.0)))

    replayed, late = engine(), []
    defer(replayed, late)
    res = ttr.TraceReplayer(trace, {"qwen3_4b": replayed}).replay()
    assert len(late) == len(extra) and res.unserved == 0
    assert res.ticks > late_tick and not replayed._arrivals
    assert all(replayed.requests[r].done for r in late)

    ran = engine()
    for r in trace.requests:
        ran.submit_at(r.t, lambda r=r: ran.submit(
            ttr.payload_tokens(trace, r, ran.cfg.vocab_size),
            max_new_tokens=r.max_new_tokens, budget_s=r.budget,
            rep_key=r.key))
    defer(ran, [])
    ran.run()
    assert sorted(replayed.requests) == sorted(ran.requests)
    for rid, a in replayed.requests.items():
        b = ran.requests[rid]
        assert (a.tokens, a.budget_s, a.submitted_tick, a.admitted_tick,
                a.finished_tick) == (b.tokens, b.budget_s, b.submitted_tick,
                                     b.admitted_tick, b.finished_tick)
        assert a.submitted_s <= a.admitted_s <= a.first_token_s \
            <= a.finished_s

"""The closed loop on the CPU, port vs reference: ``FluidController``'s
state machine, and the admission sequences it drives through both
engines under both window shapes.

The controller is host arithmetic copied from the reference, so its state
is asserted EQUAL (floats bit for bit) after every call of a seeded
random sequence of charges, ticks, refunds, accept rates and budget
queries.  The engines' admissions are host logic too: effective budgets,
bit vectors, AP records and the controller's end state are asserted
EQUAL.  Tokens play no part in them (no eos), so the reference engines run
jitted here; ``tests/test_torch_prefix_cache.py`` holds the tokens.
Sizes stay small: qwen3_4b SMOKE with prompts of at most 8 tokens, and
ResNet18 at 32 px.
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
from repro.serve import accounting as jacc  # noqa: E402
from repro.serve.cnn import CNNServeEngine as JCNNEngine  # noqa: E402
from repro.serve.prefix_cache import PrefixCache as JPrefixCache  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.apsim.workloads import Layer  # noqa: E402
from repro_torch.core import policy as tpol  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.convert import from_numpy_params  # noqa: E402
from repro_torch.serve import PrefixCache  # noqa: E402
from repro_torch.serve import accounting as tacc  # noqa: E402
from repro_torch.serve.cnn import CNNServeEngine  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ARCH = "qwen3_4b"
ENGINE = dict(max_len=24, n_slots=2, prefill_len=8, decode_block=3)
STATE = ("spent", "served", "ticks", "saved", "draft_accept_ema",
         "draft_shift")
# (prompt index, new tokens, arrival tick): key 0 repeats, so the cache
# serves full hits; two arrivals come later through submit_at
LM_STREAM = [(0, 3, 0), (1, 2, 0), (0, 3, 0), (2, 4, 1), (0, 2, 2),
             (3, 3, 2), (1, 2, 3)]


def _configs(mod):
    return {"int4": mod.fixed(4),
            "mixed": mod.per_layer([8, 4], name="mixed"),
            "int8": mod.fixed(8)}


def _pair(n, preds, **kw):
    """The same FluidController in both packages."""
    return (jpol.FluidController(_configs(jpol), dict(preds), n, **kw),
            tpol.FluidController(_configs(tpol), dict(preds), n, **kw))


@pytest.mark.parametrize("window_ticks", [0, 3])
@pytest.mark.parametrize("seed", range(4))
def test_controller_state_equals_reference(seed, window_ticks):
    """200 random calls (charge, tick, reconcile, observe_accept,
    record_saved, and the budget, depth and selection queries): every
    answer and the whole state are EQUAL after each call."""
    rng = np.random.default_rng(seed)
    preds = {"int4": 1.0, "mixed": 1.7, "int8": 3.1}
    j, t = _pair(5, preds, budget_axis="edp", slo=12.0, window=6,
                 window_ticks=window_ticks, draft_autotune=True)
    for step in range(200):
        op = int(rng.integers(7))
        x = float(rng.normal(1.0, 1.5))
        if op == 0:
            j.charge(abs(x))
            t.charge(abs(x))
        elif op == 1:
            j.tick()
            t.tick()
        elif op == 2:
            j.reconcile(x)
            t.reconcile(x)
        elif op == 3:
            j.observe_accept(x / 2)
            t.observe_accept(x / 2)
        elif op == 4:
            j.record_saved(abs(x))
            t.record_saved(abs(x))
        else:
            req = None if op == 5 else abs(x) * 2
            pending = int(rng.integers(0, 5))
            got = t.admission_budget(req, pending=pending)
            assert got == j.admission_budget(req, pending=pending)
            assert t.headroom(pending) == j.headroom(pending)
            assert t.draft_depth() == j.draft_depth()
            assert int(t.select(got)) == int(j.select(got))
            np.testing.assert_array_equal(t.resolve(got)[0].numpy(),
                                          np.asarray(j.resolve(got)[0]))
        for name in STATE:
            assert getattr(t, name) == getattr(j, name), (step, name)


def test_from_open_loop_and_full_precision():
    n = 4
    preds = {"int4": 0.5, "mixed": 0.75, "int8": 1.0}
    jb = jpol.BudgetController(_configs(jpol), dict(preds), n,
                               budget_axis="energy")
    tb = tpol.BudgetController(_configs(tpol), dict(preds), n,
                               budget_axis="energy")
    j = jpol.FluidController.from_open_loop(jb, slo=2.0, window=3,
                                            window_ticks=2)
    t = tpol.FluidController.from_open_loop(tb, slo=2.0, window=3,
                                            window_ticks=2)
    for name in ("slo", "window", "window_ticks", "budget_axis", "n_layers",
                 "predicted_latency_s"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.order() == j.order()
    assert t.configs is not tb.configs
    assert tpol.full_precision() == tpol.PrecisionPolicy(
        "fp", (tpol.FP_BITS,), (tpol.FP_BITS,))
    assert tpol.FP_BITS == jpol.FP_BITS
    assert tpol.hawq_v3("low").avg_bits == jpol.hawq_v3("low").avg_bits


# ---------------------------------------------------------------------------
# LM admissions through both engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    jcfg, tcfg = jconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = from_numpy_params(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, tcfg.vocab_size, (S,)).astype(np.int32)
               for S in (8, 5, 7, 3)]
    n = tlm.n_bit_slots(tcfg)
    preds = tacc.predict_table(
        tlm.layer_gemm_dims(tcfg), _configs(tpol), axis="edp",
        units=ENGINE["prefill_len"] + 4, head=tlm.head_gemm_dims(tcfg))
    assert preds == jacc.predict_table(
        jlm.layer_gemm_dims(jcfg), _configs(jpol), axis="edp",
        units=ENGINE["prefill_len"] + 4, head=jlm.head_gemm_dims(jcfg))
    return {"jcfg": jcfg, "tcfg": tcfg, "prompts": prompts, "n": n,
            "preds": preds, "jq": jlm.quantize_params(jparams, jcfg),
            "tq": tlm.quantize_params(tparams, tcfg)}


def _lm_stream(eng, prompts):
    """LM_STREAM through ``eng``; returns (rids, admission order)."""
    order, rids = [], []
    pick = eng.next_admission

    def logged():
        req = pick()
        order.append(req.rid)
        return req

    eng.next_admission = logged
    for i, m, tick in LM_STREAM:
        def submit(i=i, m=m):
            rids.append(eng.submit(prompts[i], max_new_tokens=m,
                                   rep_key=i))
        if tick == 0:
            submit()
        else:
            eng.submit_at(tick, submit)
    eng.run()
    return rids, order


@pytest.mark.parametrize("window_ticks", [0, 2])
def test_lm_admissions_equal_reference(smoke, window_ticks):
    """The same stream (repeats served from the prefix cache, late
    arrivals) through both engines under an EDP-axis FluidController of
    either window shape: admission order, each admission's effective
    budget, bits, hit kind, charged units and AP cost, the ticks, and the
    controller's end state are EQUAL; the loop moved the bits."""
    preds, n = smoke["preds"], smoke["n"]
    kw = dict(budget_axis="edp", slo=2.5 * preds["mixed"], window=3,
              window_ticks=window_ticks)
    jc, tc = _pair(n, preds, **kw)
    cache = dict(chunk=4, capacity=4, hit_policy="at_least")
    jeng = jengine.ServeEngine(smoke["jcfg"], smoke["jq"], controller=jc,
                               prefix_cache=JPrefixCache(**cache), **ENGINE)
    teng = ServeEngine(smoke["tcfg"], smoke["tq"], controller=tc,
                       prefix_cache=PrefixCache(**cache), device="cpu",
                       **ENGINE)
    jrids, jorder = _lm_stream(jeng, smoke["prompts"])
    trids, torder = _lm_stream(teng, smoke["prompts"])
    assert (trids, torder) == (jrids, jorder)
    for rid in trids:
        j, t = jeng.requests[rid], teng.requests[rid]
        assert t.done and j.done
        for name in ("budget_s", "mean_wbits", "cache_hit", "cached_units",
                     "planned_units", "admitted_tick", "finished_tick",
                     "edp", "prefill_edp_saved_js"):
            assert getattr(t, name) == getattr(j, name), (rid, name)
        assert t.ap_cost.per_layer_cycles == j.ap_cost.per_layer_cycles
        assert t.ap_cost.per_layer_energy_j == j.ap_cost.per_layer_energy_j
    for name in STATE:
        assert getattr(tc, name) == getattr(jc, name), name
    assert teng.prefix_cache.ledger.as_dict() == \
        jeng.prefix_cache.ledger.as_dict()
    assert len({teng.requests[r].mean_wbits for r in trids}) > 1
    assert tc.saved > 0


def test_generate_refuses_a_fluid_controller(smoke):
    tc = tpol.FluidController(_configs(tpol), dict(smoke["preds"]),
                              smoke["n"], budget_axis="edp", slo=1.0)
    eng = ServeEngine(smoke["tcfg"], smoke["tq"], controller=tc,
                      device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="open-loop"):
        eng.generate({"tokens": torch.zeros((1, 4), dtype=torch.int32)}, 2)
    with pytest.raises(ValueError, match="LATENCY"):
        ServeEngine(smoke["tcfg"], smoke["tq"], device="cpu",
                    controller=tpol.BudgetController(
                        _configs(tpol), dict(smoke["preds"]), smoke["n"],
                        budget_axis="edp"))
    # placement is ported: a plan alone re-prices the fluid controller's
    # table (tests/test_torch_placement.py holds it against the
    # reference); a mesh without a plan still raises
    from repro_torch.dist import plan_for_controller
    fresh = tpol.FluidController(_configs(tpol), dict(smoke["preds"]),
                                 smoke["n"], budget_axis="edp", slo=1.0)
    plan = plan_for_controller(fresh, tlm.layer_gemm_dims(smoke["tcfg"]),
                               n_devices=2,
                               head=tlm.head_gemm_dims(smoke["tcfg"]))
    ServeEngine(smoke["tcfg"], smoke["tq"], device="cpu", controller=fresh,
                plan=plan)
    assert fresh.plan_gain is not None

    class DataOnlyMesh:
        shape, axis_names, rank = {"data": 2}, ("data",), 0

    with pytest.raises(NotImplementedError, match="placement plan"):
        ServeEngine(smoke["tcfg"], smoke["tq"], device="cpu",
                    mesh=DataOnlyMesh())


def test_fluid_speculation_takes_the_controllers_depth_and_autotunes(smoke):
    """With a FluidController a spec-enabled engine drafts at
    ``draft_depth()`` (8 while the window has slack, capped at
    SPEC_K_MAX) and feeds every round's accept rate to
    ``observe_accept``, whose shift moves the draft configuration."""
    preds, n = smoke["preds"], smoke["n"]
    tc = tpol.FluidController(_configs(tpol), dict(preds), n,
                              budget_axis="edp", slo=100 * preds["int8"],
                              window=8, draft_autotune=True,
                              draft_accept_low=0.99, draft_accept_high=1.0)
    eng = ServeEngine(smoke["tcfg"], smoke["tq"], controller=tc,
                      device="cpu", spec_k=2, draft_budget_s=0.0,
                      **{**ENGINE, "max_len": 8 + 6 + 8})
    fed = []
    observe = tc.observe_accept
    tc.observe_accept = lambda r: (fed.append(r), observe(r))
    base = eng._draft_index()
    rid = eng.submit(smoke["prompts"][0], max_new_tokens=6)
    eng.run()
    rec = eng.requests[rid]
    assert rec.spec_k == tc.DRAFT_DEPTHS[-1] and rec.spec_rounds >= 1
    assert len(fed) == rec.spec_rounds
    assert sum(round(r * rec.spec_k) for r in fed) == rec.accepted_units
    # every round below the 0.99 deadband raised the draft bits by one
    assert tc.draft_shift == sum(1 for r in fed if r < 0.99)
    assert eng._draft_index() == min(base + tc.draft_shift, 2)


# ---------------------------------------------------------------------------
# CNN admissions through both engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def net():
    box = {}

    def init(key):
        p, box["layers"] = jcnn.init_cnn("resnet18", key, image=32)
        return p

    params = jax.jit(init)(jax.random.PRNGKey(0))
    tparams = from_numpy_params(jax.tree_util.tree_map(np.asarray, params),
                                device="cpu")
    tlayers = [Layer(**dataclasses.asdict(l)) for l in box["layers"]]
    return {"params": params, "jlayers": box["layers"], "tparams": tparams,
            "layers": tlayers}


@pytest.mark.parametrize("window_ticks", [0, 2])
def test_cnn_admissions_equal_reference(net, window_ticks):
    """Batches of 3, 4, 1 and 4 images (one with explicit budgets)
    through both CNN engines under the HAWQ-V3 EDP controller closed into
    a FluidController, ticked before each batch as the trace replayer
    does: every image's effective budget, bits and EDP, and the
    controller's end state, are EQUAL; the loop moved the bits."""
    jb = jpol.cnn_budget_controller("resnet18", layers=net["jlayers"])
    tb = tpol.cnn_budget_controller("resnet18", layers=net["layers"])
    assert tb.predicted_latency_s == jb.predicted_latency_s
    med = tb.predicted_latency_s["hawqv3-medium"]
    kw = dict(slo=6 * med, window=5, window_ticks=window_ticks)
    jc = jpol.FluidController.from_open_loop(jb, **kw)
    tc = tpol.FluidController.from_open_loop(tb, **kw)
    jeng = JCNNEngine(net["params"], net["jlayers"], controller=jc,
                      max_batch=4)
    teng = CNNServeEngine(net["tparams"], net["layers"], controller=tc,
                          max_batch=4, device="cpu")
    # host logic only: the reference's logits are not compared here
    jeng._fwd = lambda qp, x, wmat, amat: np.zeros((x.shape[0], 10),
                                                   np.float32)
    rng = np.random.default_rng(4)
    got = []
    for B, budgets in ((3, None), (4, None), (1, [2 * med]),
                       (4, None)):
        x = rng.normal(size=(B, 32, 32, 3)).astype(np.float32)
        jc.tick()
        tc.tick()
        _, js = jeng.serve(x, budgets)
        logits, ts = teng.serve(x, budgets)
        assert logits.shape[0] == B and np.isfinite(logits).all()
        for j, t in zip(js, ts):
            assert (t.budget_s, t.wbits, t.abits, t.edp, t.mean_wbits) == \
                (j.budget_s, j.wbits, j.abits, j.edp, j.mean_wbits)
            got.append(t.mean_wbits)
        for name in STATE:
            assert getattr(tc, name) == getattr(jc, name), name
    assert len(set(got)) > 1

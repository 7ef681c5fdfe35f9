"""Placement plans and the co-decision on the CPU, port vs reference.

``repro_torch.dist.placement`` is a copy of ``repro.dist.placement`` on
the port's AP cost model, and ``BudgetController.adopt_plan`` a copy of
the reference's: plans (replicas, shares, dp, ``summary()``), amortized
prices, ``replicates()``, validation errors, ``plan_gain`` and the
scaled prediction tables are asserted EQUAL (floats bit for bit) on the
same inputs, over the synthetic entries of the reference's own placement
test, ResNet18's 21 GEMM layers (with names) and qwen3_4b SMOKE's slots
plus its head.  The plan-priced SMOKE engine runs only the port; its
records are held against the reference's host-only pricing.  No spawn
here: ``tests/test_torch_scaleout.py`` runs the row split.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.apsim import metrics as japm  # noqa: E402
from repro.apsim.workloads import NETWORKS as JNETWORKS  # noqa: E402
from repro.core import policy as jpol  # noqa: E402
from repro.dist import placement as jpl  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import accounting as jacc  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.apsim import metrics as tapm  # noqa: E402
from repro_torch.apsim.workloads import NETWORKS as TNETWORKS  # noqa: E402
from repro_torch.core import policy as tpol  # noqa: E402
from repro_torch.dist import DataMesh  # noqa: E402
from repro_torch.dist import placement as tpl  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serve import accounting as tacc  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.runtime import ServeRuntime  # noqa: E402

# the reference placement test's synthetic entries: slot 2 dominates
GEMMS = ([(64, 64)], [(64, 64), (64, 32)], [(256, 256)])
HEAD = (64, 128)
DEVICES = (1, 2, 4, 8)
BUDGETS = (None, 1.0, 1.5, 2.5)
AXES = ("latency", "energy", "edp")
WORKLOADS = ("synthetic", "resnet18", "qwen3_4b_smoke")


class FakeMesh:
    def __init__(self, shape_map, rank=0):
        self.shape = shape_map
        self.axis_names = tuple(shape_map)
        self.rank = rank


def _lm_configs(mod):
    return ({"int4": mod.fixed(4),
             "mixed": mod.per_layer([8, 4], name="mixed"),
             "int8": mod.fixed(8)},
            {"int4": 0.5, "mixed": 0.75, "int8": 1.0})


def _pair(workload):
    """(reference, port) inputs of one workload: a dict each of
    gemms, head, names and a controller."""
    if workload == "synthetic":
        def side(pol):
            ctrl = pol.BudgetController(
                {"int4": pol.fixed(4), "int8": pol.fixed(8)},
                {"int4": 0.5, "int8": 1.0}, len(GEMMS))
            return dict(gemms=GEMMS, head=HEAD, names=(), ctrl=ctrl)
        return side(jpol), side(tpol)
    if workload == "resnet18":
        out = []
        for apm, nets, pol in ((japm, JNETWORKS, jpol),
                               (tapm, TNETWORKS, tpol)):
            layers = nets["resnet18"]()
            gl = [l for l in layers if l.kind in ("conv", "fc")]
            out.append(dict(gemms=apm.network_gemms(layers), head=None,
                            names=tuple(l.name for l in gl),
                            ctrl=pol.cnn_budget_controller(
                                "resnet18", layers=layers)))
        return tuple(out)
    out = []
    for cfgs, lm, pol in ((jconfigs, jlm, jpol), (tconfigs, tlm, tpol)):
        cfg = cfgs.get_smoke("qwen3_4b")
        configs, pred = _lm_configs(pol)
        out.append(dict(gemms=lm.layer_gemm_dims(cfg),
                        head=lm.head_gemm_dims(cfg), names=(),
                        ctrl=pol.BudgetController(configs, pred,
                                                  lm.n_bit_slots(cfg))))
    return tuple(out)


def _same_plan(t, j):
    assert t.replicas == j.replicas
    assert t.shares == j.shares                 # floats, bit for bit
    assert (t.n_devices, t.dp, t.axis, t.has_head, t.names) \
        == (j.n_devices, j.dp, j.axis, j.has_head, j.names)
    assert t.summary() == j.summary()
    assert t.mean_replicas == j.mean_replicas
    assert t.replicated_entries == j.replicated_entries


def _same_cost(t, j):
    assert t.per_layer_cycles == j.per_layer_cycles
    assert t.per_layer_energy_j == j.per_layer_energy_j
    assert t.freq_hz == j.freq_hz


@pytest.mark.parametrize("n_devices", DEVICES)
@pytest.mark.parametrize("workload", WORKLOADS)
def test_plans_equal_the_reference(workload, n_devices):
    j, t = _pair(workload)
    jw, ja = (np.asarray(x)[-1].tolist() for x in j["ctrl"].stacked_tables())
    for budget in BUDGETS:
        for axis in AXES:
            kw = dict(n_devices=n_devices, memory_budget=budget, axis=axis)
            _same_plan(
                tpl.plan_for_controller(t["ctrl"], t["gemms"], head=t["head"],
                                        names=t["names"], **kw),
                jpl.plan_for_controller(j["ctrl"], j["gemms"], head=j["head"],
                                        names=j["names"], **kw))
            # plan_placement at the cheapest config's bits too
            tw, ta = (x[0].tolist() for x in t["ctrl"].stacked_tables())
            _same_plan(
                tpl.plan_placement(t["gemms"], tw, ta, head=t["head"], **kw),
                jpl.plan_placement(j["gemms"], tw, ta, head=j["head"], **kw))
    # the default axis is the controller's own
    _same_plan(tpl.plan_for_controller(t["ctrl"], t["gemms"], head=t["head"],
                                       n_devices=n_devices),
               jpl.plan_for_controller(j["ctrl"], j["gemms"], head=j["head"],
                                       n_devices=n_devices))
    # a full budget fully replicates; a unit budget replicates nothing
    full = tpl.plan_placement(t["gemms"], jw, ja, head=t["head"],
                              n_devices=n_devices)
    assert full.fully_replicated and full.dp == n_devices
    one = tpl.plan_placement(t["gemms"], jw, ja, head=t["head"],
                             n_devices=n_devices, memory_budget=1.0)
    assert one.replicas == (1,) * len(one.replicas)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_price_and_replicates_equal_the_reference(workload):
    j, t = _pair(workload)
    wtab, atab = (np.asarray(x) for x in j["ctrl"].stacked_tables())
    keys = [("layers", "attn", "wq", "q"), ("emb",), ("head",),
            ("opt_state", "mu"), (), ("ln_f", "scale")]
    keys += [(n, "q") for n in t["names"]] + [("bn1", "scale")]
    for n_devices in DEVICES:
        for budget in BUDGETS:
            kw = dict(n_devices=n_devices, memory_budget=budget)
            tp = tpl.plan_placement(t["gemms"], wtab[-1], atab[-1],
                                    head=t["head"], names=t["names"], **kw)
            jp = jpl.plan_placement(j["gemms"], wtab[-1], atab[-1],
                                    head=j["head"], names=j["names"], **kw)
            for i in range(wtab.shape[0]):
                tc = tapm.price_bit_vector(t["gemms"], wtab[i].tolist(),
                                           atab[i].tolist(), head=t["head"])
                jc = japm.price_bit_vector(j["gemms"], wtab[i].tolist(),
                                           atab[i].tolist(), head=j["head"])
                _same_cost(tp.price(tc), jp.price(jc))
                assert tp.price(tc).energy_j == tc.energy_j
            assert [tp.replicates(k) for k in keys] \
                == [jp.replicates(k) for k in keys]


def test_validation_errors_raise_alike():
    rep8 = [8, 8, 8]
    cases = [
        lambda m: m.plan_placement(GEMMS, rep8, rep8, n_devices=0),
        lambda m: m.plan_placement(GEMMS, rep8, rep8, n_devices=2,
                                   memory_budget=0.5),
        lambda m: m.plan_placement(GEMMS, rep8, rep8, n_devices=2,
                                   axis="bogus"),
        lambda m: m.PlacementPlan(n_devices=0, dp=1, replicas=(),
                                  shares=()),
        lambda m: m.PlacementPlan(n_devices=2, dp=2, replicas=(3,),
                                  shares=(1.0,)),
        lambda m: m.PlacementPlan(n_devices=2, dp=2, replicas=(2, 2),
                                  shares=(1, 0), names=("a",)),
    ]
    for case in cases:
        with pytest.raises(ValueError) as te:
            case(tpl)
        with pytest.raises(ValueError) as je:
            case(jpl)
        assert str(te.value) == str(je.value)
    # a cost with more entries than the plan covers
    short_t = tpl.plan_placement(GEMMS, rep8, rep8, n_devices=4)
    short_j = jpl.plan_placement(GEMMS, rep8, rep8, n_devices=4)
    with pytest.raises(ValueError) as te:
        short_t.price(tapm.price_bit_vector(GEMMS, rep8, rep8, head=HEAD))
    with pytest.raises(ValueError) as je:
        short_j.price(japm.price_bit_vector(GEMMS, rep8, rep8, head=HEAD))
    assert str(te.value) == str(je.value)


def test_mesh_device_count_and_axes():
    assert tpl.mesh_device_count(None) == jpl.mesh_device_count(None) == 1
    for shape in ({"data": 2}, {"data": 2, "model": 4},
                  {"pod": 2, "data": 2, "model": 1}):
        m = FakeMesh(shape)
        assert tpl.mesh_device_count(m) == jpl.mesh_device_count(m) \
            == int(np.prod(list(shape.values())))
    from repro.dist import api as japi
    from repro_torch.dist import api as tapi
    for shape in ({"data": 2}, {"data": 2, "model": 4},
                  {"pod": 2, "data": 3, "model": 2}):
        m = FakeMesh(shape)
        assert tapi.dp_size(m) == japi.dp_size(m)
        assert tapi.tp_size(m) == japi.tp_size(m)
        for logical in ("dp", "tp", "dp+tp", None):
            assert tapi.mesh_axes_for(m, logical) \
                == japi.mesh_axes_for(m, logical)
    assert tapi.active_mesh() is None and tapi.dp_size() == 1
    m = FakeMesh({"data": 4})
    with tapi.use_mesh(m):
        assert tapi.active_mesh() is m and tapi.dp_size() == 4
        with tapi.use_mesh(FakeMesh({"data": 2, "model": 2})):
            assert tapi.tp_size() == 2
        assert tapi.active_mesh() is m
    assert tapi.active_mesh() is None
    with pytest.raises(RuntimeError, match="process group"):
        DataMesh()                      # no torch.distributed group here


@pytest.mark.parametrize("workload", WORKLOADS)
def test_adopt_plan_equals_the_reference(workload):
    j, t = _pair(workload)
    jpricer = jacc.BitVectorPricer(j["gemms"], head=j["head"])
    tpricer = tacc.BitVectorPricer(t["gemms"], head=t["head"])
    for memory_budget in (None, 1.5):
        jc, tc = (jpol.BudgetController(dict(j["ctrl"].configs),
                                        dict(j["ctrl"].predicted_latency_s),
                                        j["ctrl"].n_layers,
                                        budget_axis=j["ctrl"].budget_axis),
                  tpol.BudgetController(dict(t["ctrl"].configs),
                                        dict(t["ctrl"].predicted_latency_s),
                                        t["ctrl"].n_layers,
                                        budget_axis=t["ctrl"].budget_axis))
        jp = jpl.plan_for_controller(jc, j["gemms"], head=j["head"],
                                     n_devices=4, names=j["names"],
                                     memory_budget=memory_budget)
        tp = tpl.plan_for_controller(tc, t["gemms"], head=t["head"],
                                     n_devices=4, names=t["names"],
                                     memory_budget=memory_budget)
        tc.stacked_tables()             # caches that adoption must drop
        tc.latency_array()
        jc.adopt_plan(jp, jpricer)
        tc.adopt_plan(tp, tpricer)
        assert tc.plan_gain == jc.plan_gain
        assert tc.predicted_latency_s == jc.predicted_latency_s
        assert tc.order() == jc.order()
        np.testing.assert_array_equal(
            tc.latency_array().numpy(), np.asarray(jc.latency_array()))
        before = dict(tc.predicted_latency_s)
        tc.adopt_plan(tp, tpricer)      # idempotent
        assert tc.predicted_latency_s == before
        other = tpl.plan_for_controller(tc, t["gemms"], head=t["head"],
                                        n_devices=2, names=t["names"])
        with pytest.raises(ValueError, match="different"):
            tc.adopt_plan(other, tpricer)


def test_adopted_plan_resolves_higher_bits():
    ctrl = tpol.BudgetController({"int4": tpol.fixed(4),
                                  "int8": tpol.fixed(8)},
                                 {"int4": 0.5, "int8": 1.0}, 3,
                                 budget_axis="latency")
    assert int(ctrl.resolve(0.6)[0][0]) == 4    # int8 (1.0) does not fit
    plan = tpl.plan_placement(GEMMS, [8] * 3, [8] * 3, n_devices=4,
                              head=HEAD)
    ctrl.adopt_plan(plan, tacc.BitVectorPricer(GEMMS, head=HEAD))
    assert ctrl.plan_gain == {"int4": 0.25, "int8": 0.25}
    assert int(ctrl.resolve(0.6)[0][0]) == 8    # 0.25 fits the same budget


def test_runtime_adopts_the_plan_for_a_fluid_controller():
    n = len(GEMMS)
    plan = tpl.plan_placement(GEMMS, [8] * n, [8] * n, n_devices=4,
                              head=HEAD)
    fluid = tpol.FluidController({"int4": tpol.fixed(4),
                                  "int8": tpol.fixed(8)},
                                 {"int4": 0.5, "int8": 1.0}, n, slo=1.0)
    rt = ServeRuntime(fluid, n, gemms=GEMMS, head=HEAD, plan=plan)
    assert fluid._plan is plan and fluid.plan_gain["int8"] == 0.25
    base = tacc.BitVectorPricer(GEMMS, head=HEAD).price([8] * n, [8] * n)
    got = rt.price_bits([8] * n, [8] * n)
    _same_cost(got, plan.price(base))
    assert rt.price_bits([8] * n, [8] * n) is got   # cached per vector
    assert rt._config_cost(1) is got
    with pytest.raises(ValueError, match="priced gemms"):
        ServeRuntime(tpol.FluidController.from_open_loop(
            tpol.BudgetController({"int8": tpol.fixed(8)}, {"int8": 1.0}, n),
            slo=1.0), n, plan=plan)
    # "auto" off a mesh (one device) plans nothing
    assert ServeRuntime(tpol.BudgetController({"int8": tpol.fixed(8)},
                                              {"int8": 1.0}, n),
                        n, gemms=GEMMS, head=HEAD, plan="auto").plan is None
    auto = ServeRuntime(tpol.BudgetController({"int8": tpol.fixed(8)},
                                              {"int8": 1.0}, n),
                        n, gemms=GEMMS, head=HEAD, plan="auto",
                        mesh=FakeMesh({"data": 4}))
    assert auto.plan.fully_replicated and auto.plan.dp == 4


PROMPTS = ([3, 1, 4, 1, 5], [2, 7, 1], [6, 2, 8, 1, 8, 2], [9, 9])
PROMPT_BUDGETS = (10.0, 0.5, 10.0, 0.5)         # int8 / int4 mix


def test_plan_priced_engine_matches_reference_pricing():
    """An explicit plan (no mesh) amortizes every record's latency by
    exactly 1/4, leaves energy and tokens alone, and prices each record
    as the reference's PlacementPlan.price(BitVectorPricer.price(bits))."""
    tcfg, jcfg = tconfigs.get_smoke("qwen3_4b"), jconfigs.get_smoke("qwen3_4b")
    n = tlm.n_bit_slots(tcfg)
    q = tlm.quantize_params(tlm.init_params(
        tcfg, torch.Generator().manual_seed(4), device="cpu"), tcfg)

    def ctrl(pol):
        return pol.BudgetController({"int4": pol.fixed(4),
                                     "int8": pol.fixed(8)},
                                    {"int4": 1.0, "int8": 2.0}, n)

    tplan = tpl.plan_for_controller(ctrl(tpol), tlm.layer_gemm_dims(tcfg),
                                    n_devices=4, head=tlm.head_gemm_dims(tcfg),
                                    axis="edp")
    jplan = jpl.plan_for_controller(ctrl(jpol), jlm.layer_gemm_dims(jcfg),
                                    n_devices=4, head=jlm.head_gemm_dims(jcfg),
                                    axis="edp")
    _same_plan(tplan, jplan)
    jpricer = jacc.BitVectorPricer(jlm.layer_gemm_dims(jcfg),
                                   head=jlm.head_gemm_dims(jcfg))
    engines = {}
    for name, plan in (("base", None), ("plan", tplan)):
        eng = ServeEngine(tcfg, q, max_len=64, n_slots=4, prefill_len=8,
                          decode_block=4, seed=0, controller=ctrl(tpol),
                          plan=plan, device="cpu")
        rids = [eng.submit(p, max_new_tokens=5, budget_s=b)
                for p, b in zip(PROMPTS, PROMPT_BUDGETS)]
        eng.run()
        engines[name] = (eng, [eng.requests[r] for r in rids])
    (_, base), (peng, planned) = engines["base"], engines["plan"]
    for b, p, budget in zip(base, planned, PROMPT_BUDGETS):
        assert p.tokens == b.tokens
        assert p.ap_latency_s == pytest.approx(b.ap_latency_s / 4,
                                               rel=1e-12)
        assert p.ap_energy_j == b.ap_energy_j
        assert p.plan_replicas == 4.0 and b.plan_replicas == 0.0
        wv, av = peng.host_bits(budget)
        _same_cost(p.ap_cost, jplan.price(jpricer.price(wv, av)))
    agg = tacc.aggregate(r for r in planned)
    assert agg["plan_requests"] == len(PROMPTS)
    assert agg["plan_mean_replicas"] == 4.0
    base_agg = tacc.aggregate(base)
    assert base_agg["plan_requests"] == 0
    assert agg["edp_per_unit_js"] == pytest.approx(
        base_agg["edp_per_unit_js"] / 4, rel=1e-9)

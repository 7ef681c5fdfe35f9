"""The port's whole-batch LM engine on the CPU against the reference's.

``ServeEngine.generate`` at qwen3_4b SMOKE size with a 2100-token prompt
(so every layer's attention takes the ``_flash`` branch), per-request
budgets that resolve to int8 and int4, greedy decoding.  The reference
engine runs op by op (``jax.disable_jit``; ``tests/test_torch_lm.py``
says why) with its sampler wrapped to record the logits it samples from.
Tokens must be equal at every step where the reference's top-2 logit gap
exceeds the logit tolerance (2e-2 x max|logit|), up to the first step
where it does not: there a rounding difference may legitimately pick the
other token, and the sequences part.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import repro.serve.engine as jengine  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.launch.serve import default_controller as jdefault  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.convert import from_numpy_params  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.serve.engine import ServeEngine, default_controller  # noqa: E402

ARCH = "qwen3_4b"
LOGIT_TOL = 2e-2        # x max|logit|
BUDGETS = [10.0, 0.4]   # -> int8, int4
PRICED = [0.4, 0.8, 10.0, 1e30, 0.75]


@pytest.fixture(scope="module")
def smoke():
    jcfg, tcfg = jconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = from_numpy_params(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    n = tlm.n_bit_slots(tcfg)
    return {"jcfg": jcfg, "tcfg": tcfg,
            "jq": jlm.quantize_params(jparams, jcfg),
            "tq": tlm.quantize_params(tparams, tcfg),
            "jctrl": jdefault(n), "tctrl": default_controller(n)}


def _engine(smoke, max_len=64, **kw):
    return ServeEngine(smoke["tcfg"], smoke["tq"], max_len=max_len,
                       controller=smoke["tctrl"], device="cpu", **kw)


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)
                                                ).astype(np.int32)


def test_generate_matches_reference_engine(smoke, monkeypatch):
    jcfg = smoke["jcfg"]
    S, steps = 2100, 4
    toks = _tokens(3, 2, S, jcfg.vocab_size)
    seen = []
    real = jengine._sample_tokens

    def recording(logits, key, temperature, top_k):
        seen.append(np.asarray(logits, np.float32))
        return real(logits, key, temperature, top_k)

    monkeypatch.setattr(jengine, "_sample_tokens", recording)
    jeng = jengine.ServeEngine(jcfg, smoke["jq"], max_len=S + steps + 2,
                               controller=smoke["jctrl"])
    jeng.set_budget(BUDGETS)
    with jax.disable_jit():
        want = np.asarray(jeng.generate({"tokens": jnp.asarray(toks)},
                                        steps))
    assert len(seen) == steps

    eng = _engine(smoke, max_len=S + steps + 2)
    eng.set_budget(BUDGETS)
    got = eng.generate({"tokens": torch.from_numpy(toks)}, steps)
    assert got.shape == (2, steps) and got.dtype == torch.int32
    got = got.numpy()
    compared = 0
    for row in range(2):
        for i in range(steps):
            lg = seen[i][row, :jcfg.vocab_size]
            top2 = np.sort(lg)[-2:]
            if top2[1] - top2[0] <= LOGIT_TOL * np.abs(lg).max():
                break
            assert got[row, i] == want[row, i], (row, i, got, want)
            compared += 1
    assert compared >= 1
    assert eng.stats.tokens == 2 * steps


def test_mixed_budget_row_equals_uniform_batch(smoke):
    """Rows are numerically independent: the int4 row of a mixed batch
    equals the same row of an all-int4 batch (per-row activation scales,
    one GEMM per bit family, per-row attention)."""
    toks = torch.from_numpy(_tokens(4, 2, 40, smoke["tcfg"].vocab_size))
    mixed, uniform = _engine(smoke), _engine(smoke)
    mixed.set_budget(BUDGETS)
    uniform.set_budget([0.4, 0.4])
    a = mixed.generate({"tokens": toks}, 4)
    b = uniform.generate({"tokens": toks}, 4)
    assert torch.equal(a[1], b[1])
    logits = []
    for eng in (mixed, uniform):
        wv, av = eng._bits()
        cache = tlm.empty_cache(eng.cfg, 2, 64, device="cpu")
        with eng.compute_ctx():
            lg, _ = tlm.prefill(eng.qparams, {"tokens": toks}, eng.cfg, wv,
                                av, cache)
        logits.append(lg)
    assert torch.equal(logits[0][1], logits[1][1])


def test_fused_and_unfused_give_the_same_tokens(smoke):
    toks = torch.from_numpy(_tokens(5, 2, 40, smoke["tcfg"].vocab_size))
    eng = _engine(smoke)
    eng.set_budget(BUDGETS)
    assert torch.equal(eng.generate({"tokens": toks}, 5, fused=True),
                       eng.generate({"tokens": toks}, 5, fused=False))


def test_sampling_draws_from_the_seeded_generator(smoke):
    """Temperature sampling is reproducible from ``seed``; top_k = 1 at
    any temperature is the greedy token."""
    toks = torch.from_numpy(_tokens(6, 2, 40, smoke["tcfg"].vocab_size))
    runs = []
    for _ in range(2):
        eng = _engine(smoke, seed=7)
        eng.set_budget(BUDGETS)
        runs.append(eng.generate({"tokens": toks}, 4, temperature=1.5))
    assert torch.equal(runs[0], runs[1])
    assert bool(((runs[0] >= 0) & (runs[0] < smoke["tcfg"].vocab_size)).all())
    eng = _engine(smoke)
    eng.set_budget(BUDGETS)
    greedy = eng.generate({"tokens": toks}, 4)
    assert torch.equal(eng.generate({"tokens": toks}, 4, temperature=2.0,
                                    top_k=1), greedy)
    with pytest.raises(ValueError, match="TOPK_MAX"):
        eng.generate({"tokens": toks}, 2, top_k=65)


def test_scaled_logits_equal(rng):
    logits = rng.normal(size=(3, 100)).astype(np.float32)
    temp = np.array([0.0, 0.7, 1.3], np.float32)
    topk = np.array([0, 5, 64], np.int32)
    want = np.asarray(jengine._scaled_logits(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(topk)))
    got = tengine._scaled_logits(torch.from_numpy(logits),
                                 torch.from_numpy(temp),
                                 torch.from_numpy(topk)).numpy()
    np.testing.assert_array_equal(got, want)
    assert tengine.TOPK_MAX == jengine.TOPK_MAX


def test_prices_and_host_mirrors_equal_the_reference(smoke):
    jeng = jengine.ServeEngine(smoke["jcfg"], smoke["jq"], max_len=64,
                               controller=smoke["jctrl"])
    eng = _engine(smoke)
    assert eng.families == tuple(jeng._families) == (4, 8)
    for budget in PRICED:
        j, t = jeng.price_budget(budget), eng.price_budget(budget)
        assert t.per_layer_cycles == j.per_layer_cycles
        assert t.per_layer_energy_j == j.per_layer_energy_j
        assert t.edp == j.edp
        assert eng._host_index(budget) == jeng._host_index(budget)
        for a, b in zip(eng.host_bits(budget), jeng.host_bits(budget)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(eng.host_tables(), jeng.host_tables()):
        np.testing.assert_array_equal(a, b)


class FakeMesh:
    """A duck-typed data mesh: axis sizes and this process's rank."""

    def __init__(self, shape_map, rank=0):
        self.shape = shape_map
        self.axis_names = tuple(shape_map)
        self.rank = rank


def test_not_ported_options_raise(smoke):
    # mesh= and plan= are ported: a plan alone prices, a fully replicated
    # plan on a data mesh splits the slots, and sharded weights serve on
    # a repro_torch.dist.Mesh (two gloo ranks run them in
    # tests/test_torch_scaleout.py and tests/test_torch_tp_serve.py).  A
    # mesh object without collectives cannot hold sharded weights, and
    # rows or slots that do not split over the data ranks raise on it:
    # every rank then serves them whole on a sequence-sharded cache,
    # whose collectives need a repro_torch.dist.Mesh (served there in
    # tests/test_torch_seq_kv.py and tests/test_torch_seq_pool.py)
    from repro_torch.dist import plan_for_controller
    mesh = FakeMesh({"data": 2})
    cfg = smoke["tcfg"]
    partial = plan_for_controller(
        smoke["tctrl"], tlm.layer_gemm_dims(cfg), n_devices=2,
        head=tlm.head_gemm_dims(cfg), memory_budget=1.5)
    assert not partial.fully_replicated
    assert _engine(smoke, plan=partial).plan is partial     # pricing only
    for kw, match in (({"mesh": mesh}, "without a placement plan"),
                      ({"mesh": mesh, "plan": partial}, "partial"),
                      ({"mesh": FakeMesh({"data": 2, "model": 2}),
                        "plan": "auto"}, "tensor parallelism"),
                      ({"mesh": mesh, "plan": "auto", "n_slots": 3},
                       "split evenly")):
        with pytest.raises(NotImplementedError, match=match):
            _engine(smoke, **kw)
    # speculation and the prefix cache serve on a data mesh now
    for kw in ({"spec_k": 4}, {"prefix_cache": tengine.PrefixCache(chunk=4)}):
        assert _engine(smoke, mesh=mesh, plan="auto", **kw)._rows == (0, 2)
    eng = _engine(smoke, mesh=mesh, plan="auto")
    assert eng.plan.fully_replicated and eng._rows == (0, 2)
    with pytest.raises(NotImplementedError, match="split evenly"):
        eng.generate({"tokens": np.zeros((1, 4), np.int32)}, 2)
    # every family serves on a mesh (the recurrent and encoder-decoder
    # ones sharded too: tests/test_torch_recurrent_mesh.py)
    eng = tengine.ServeEngine(smoke["tcfg"].with_(family="ssm"), smoke["tq"],
                              device="cpu", mesh=mesh, plan="auto")
    assert eng.mesh is mesh and eng.plan.fully_replicated
    # the prefix cache and vlm prefixes are ported; continuous batching
    # needs a family with ragged prefill that the port runs
    eng = _engine(smoke)
    eng.cfg = smoke["tcfg"].with_(family="moe")
    with pytest.raises(NotImplementedError, match="moe"):
        eng.submit(np.zeros(4, np.int32))
    eng.cfg = smoke["tcfg"].with_(family="ssm")
    with pytest.raises(NotImplementedError, match="ssm"):
        eng.submit(np.zeros(4, np.int32))

"""vlm prefixes on the CPU: internvl2_1b SMOKE (GQA 4/2, qkv bias, tied
embeddings, 8 prefix tokens), port vs reference on the same weights.

A vlm request carries precomputed patch embeddings (the InternViT
frontend is a stub), prefilled in front of its prompt.  The reference
runs op by op (``jax.disable_jit``; ``test_torch_lm.py`` says why).
Prefill logits are held to 2e-2 x max|logit| with equal argmax, kpos
EQUAL; greedy tokens EQUAL.
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
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.convert import from_numpy_params  # noqa: E402
from repro_torch.models.transformer import EMPTY_POS  # noqa: E402
from repro_torch.serve.engine import ServeEngine, default_controller  # noqa: E402
from repro_torch.serve.prefix_cache import PrefixCache  # noqa: E402

ARCH = "internvl2_1b"
LOGIT_TOL = 2e-2         # x max|logit|
FAMILIES = (4, 8)
ENGINE = dict(max_len=40, n_slots=2, prefill_len=8, decode_block=3)
# (prompt length, budget -> int4 / int8 / mixed, max new tokens)
REQUESTS = [(5, 0.4, 4), (8, 10.0, 3), (3, 0.8, 4)]


def _np(a):
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


@pytest.fixture(scope="module")
def smoke():
    jcfg, tcfg = jconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = from_numpy_params(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    n = tlm.n_bit_slots(tcfg)
    g = np.random.default_rng(7)
    P, d = tcfg.n_prefix_tokens, tcfg.d_model
    return {"jcfg": jcfg, "tcfg": tcfg,
            "jq": jlm.quantize_params(jparams, jcfg),
            "tq": tlm.quantize_params(tparams, tcfg),
            "jctrl": jdefault(n), "tctrl": default_controller(n),
            "prompts": [g.integers(0, tcfg.vocab_size, (S,)).astype(np.int32)
                        for S, _, _ in REQUESTS],
            "prefixes": [g.normal(size=(P, d)).astype(np.float32)
                         for _ in REQUESTS]}


def _assert_logits(got, want, vocab):
    got, want = _np(got)[..., :vocab], _np(want)[..., :vocab]
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= LOGIT_TOL * scale
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("ragged", [False, True], ids=["lock-step", "ragged"])
def test_prefill_with_prefix(smoke, ragged):
    """Prefill of (B=2, S=12) prompts behind (2, 8, d) prefixes, lock-step
    and with per-row lengths 12 and 5 (each row's valid length is the
    prefix plus its own): logits and kpos against the reference."""
    jcfg, cfg = smoke["jcfg"], smoke["tcfg"]
    g = np.random.default_rng(3)
    B, S, P = 2, 12, cfg.n_prefix_tokens
    toks = g.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    prefix = g.normal(size=(B, P, cfg.d_model)).astype(np.float32)
    wv = np.array([[8, 8], [4, 4]], np.int32)
    lengths = np.array([12, 5], np.int32) if ragged else None
    jkw = {"lengths": jnp.asarray(lengths)} if ragged else {}
    tkw = {"lengths": torch.from_numpy(lengths)} if ragged else {}
    with jax.disable_jit(), jops.bit_families(FAMILIES):
        jc = jlm.empty_cache(jcfg, B, P + S + 4)
        jlog, jc = jlm.prefill(smoke["jq"], {"tokens": jnp.asarray(toks),
                                             "prefix": jnp.asarray(prefix)},
                               jcfg, jnp.asarray(wv), jnp.asarray(wv), jc,
                               **jkw)
    with tops.bit_families(FAMILIES):
        tc = tlm.empty_cache(cfg, B, P + S + 4, device="cpu")
        tlog, tc = tlm.prefill(smoke["tq"], {"tokens": torch.from_numpy(toks),
                                             "prefix": torch.from_numpy(prefix)},
                               cfg, torch.from_numpy(wv),
                               torch.from_numpy(wv), tc, **tkw)
    _assert_logits(tlog, jlog, cfg.vocab_size)
    np.testing.assert_array_equal(tc["kpos"].numpy(), np.asarray(jc["kpos"]))
    valid = (tc["kpos"][0] < EMPTY_POS).sum(dim=1).tolist()
    assert valid == ([P + 12, P + 5] if ragged else [P + S] * B)


def test_generate_matches_reference_engine(smoke):
    """generate with prefixes at per-row budgets (int4, int8): greedy
    tokens EQUAL the reference engine's, positions counted from P + S."""
    jcfg, cfg = smoke["jcfg"], smoke["tcfg"]
    g = np.random.default_rng(4)
    B, S, P = 2, 10, cfg.n_prefix_tokens
    toks = g.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    prefix = g.normal(size=(B, P, cfg.d_model)).astype(np.float32)
    jeng = jengine.ServeEngine(jcfg, smoke["jq"], max_len=32,
                               controller=smoke["jctrl"])
    jeng.set_budget([0.4, 10.0])
    with jax.disable_jit():
        want = np.asarray(jeng.generate({"tokens": jnp.asarray(toks),
                                         "prefix": jnp.asarray(prefix)}, 4))
    eng = ServeEngine(cfg, smoke["tq"], max_len=32,
                      controller=smoke["tctrl"], device="cpu")
    eng.set_budget([0.4, 10.0])
    got = eng.generate({"tokens": torch.from_numpy(toks),
                        "prefix": torch.from_numpy(prefix)}, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="prefix"):
        eng.generate({"tokens": torch.from_numpy(toks)}, 2)
    with pytest.raises(ValueError, match="prefix shape"):
        eng.generate({"tokens": torch.from_numpy(toks),
                      "prefix": torch.from_numpy(prefix[:, :3])}, 2)


def _serve(eng, smoke, **kw):
    rids = [eng.submit(p, max_new_tokens=m, budget_s=b, prefix=x, **kw)
            for p, x, (_, b, m) in zip(smoke["prompts"], smoke["prefixes"],
                                       REQUESTS)]
    eng.run()
    return [eng.requests[r].tokens for r in rids]


@pytest.fixture(scope="module")
def served(smoke):
    jeng = jengine.ServeEngine(smoke["jcfg"], smoke["jq"],
                               controller=smoke["jctrl"], **ENGINE)
    with jax.disable_jit():
        want = _serve(jeng, smoke)
    eng = ServeEngine(smoke["tcfg"], smoke["tq"], controller=smoke["tctrl"],
                      device="cpu", prefix_cache=PrefixCache(chunk=4),
                      **ENGINE)
    return {"jeng": jeng, "want": want, "eng": eng, "got": _serve(eng, smoke)}


def test_submit_prefix_matches_reference_engine(smoke, served):
    """submit(prefix=) through the continuous scheduler: tokens, slots and
    positions EQUAL the reference engine's; a drained pool is masked."""
    assert served["got"] == served["want"]
    eng, jeng = served["eng"], served["jeng"]
    for rid in range(len(REQUESTS)):
        t, j = eng.requests[rid], jeng.requests[rid]
        assert (t.slot, t.admitted_tick, t.finished_tick) == \
            (j.slot, j.admitted_tick, j.finished_tick)
        assert t.edp == j.edp
    assert eng.pool.free_slots == ENGINE["n_slots"]
    assert (eng.pool.cache["kpos"] == EMPTY_POS).all()


def test_continuous_equals_standalone(smoke, served):
    """Each request's tokens equal its batch-1 run: prefill of its prefix
    and padded prompt, then decode_step from position P + S."""
    eng, cfg = served["eng"], smoke["tcfg"]
    P = cfg.n_prefix_tokens
    for rid, (S, budget, m) in enumerate(REQUESTS):
        wv, av = smoke["tctrl"].resolve(torch.tensor(budget))
        toks = torch.zeros((1, ENGINE["prefill_len"]), dtype=torch.int32)
        toks[0, :S] = torch.from_numpy(smoke["prompts"][rid])
        cache = tlm.empty_cache(cfg, 1, ENGINE["max_len"], device="cpu")
        batch = {"tokens": toks,
                 "prefix": torch.from_numpy(smoke["prefixes"][rid][None])}
        with tops.bit_families(eng.families):
            logits, cache = tlm.prefill(eng.qparams, batch, cfg, wv, av,
                                        cache, lengths=torch.tensor([S]))
            want = [int(logits[0, -1].argmax())]
            for t in range(P + S, P + S + m - 1):
                logits, cache = tlm.decode_step(
                    eng.qparams, torch.tensor([[want[-1]]]),
                    torch.tensor([t]), cache, cfg, wv, av)
                want.append(int(logits[0, -1].argmax()))
        assert served["got"][rid] == want, rid


def test_prefix_cache_bypassed(served):
    """Requests with a prefix never look the prefix cache up nor store."""
    eng = served["eng"]
    ledger = eng.prefix_cache.ledger
    assert ledger.lookups == 0 and ledger.hits == 0
    assert len(eng.prefix_cache) == 0
    assert all(eng.requests[r].cache_hit == "" for r in eng.requests)
    assert eng.calls["prefill"] == len(REQUESTS)


def test_speculation_with_prefix(smoke, served):
    """spec_k = 2 at int4 drafts: the greedy tokens of every request EQUAL
    the vanilla continuous run's."""
    eng = ServeEngine(smoke["tcfg"], smoke["tq"], controller=smoke["tctrl"],
                      device="cpu", spec_k=2, draft_budget_s=0.4,
                      **{**ENGINE, "max_len": 40})
    assert _serve(eng, smoke) == served["got"]
    assert eng.calls["verify"] > 0
    assert (eng.pool.cache["kpos"] == EMPTY_POS).all()


def test_prefix_errors(smoke):
    cfg = smoke["tcfg"]
    eng = ServeEngine(cfg, smoke["tq"], controller=smoke["tctrl"],
                      device="cpu", **ENGINE)
    prompt = smoke["prompts"][0]
    with pytest.raises(ValueError, match="need a prefix"):
        eng.submit(prompt)
    with pytest.raises(ValueError, match="prefix shape"):
        eng.submit(prompt, prefix=np.zeros((cfg.n_prefix_tokens - 1,
                                            cfg.d_model)))
    with pytest.raises(ValueError, match="prefix shape"):
        eng.submit(prompt, prefix=np.zeros((cfg.n_prefix_tokens,
                                            cfg.d_model + 1)))
    # the prefix counts against max_len: 8 + 8 + 17 > 32
    short = ServeEngine(cfg, smoke["tq"], controller=smoke["tctrl"],
                        device="cpu", **{**ENGINE, "max_len": 32})
    with pytest.raises(ValueError, match="exceeds max_len"):
        short.submit(prompt, max_new_tokens=17,
                     prefix=smoke["prefixes"][0])
    short.submit(prompt, max_new_tokens=16, prefix=smoke["prefixes"][0])
    spec = ServeEngine(cfg, smoke["tq"], controller=smoke["tctrl"],
                       device="cpu", spec_k=2, **{**ENGINE, "max_len": 32})
    with pytest.raises(ValueError, match="SPEC_K_MAX"):
        spec.submit(prompt, max_new_tokens=16, prefix=smoke["prefixes"][0])
    # a torch prefix is taken as well
    eng.submit(prompt, prefix=torch.from_numpy(smoke["prefixes"][0]).bfloat16())

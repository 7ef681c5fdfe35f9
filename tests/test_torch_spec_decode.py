"""Speculative decoding on the CPU: per-token activation scales, the
chunked decode, the speculative rounds of ``ServeEngine``, port vs
reference.

qwen3_4b SMOKE, weights made by the reference and carried across with the
weight bridge; the reference runs op by op (``jax.disable_jit``;
``tests/test_torch_lm.py`` says why).  The chunk must equal U sequential
decode steps EXACTLY in the port (same integer GEMMs, per-token scales,
each query masked to its own prefix), and the reference's chunk within
the logit tolerance of ``tests/test_torch_lm.py`` with ``kpos`` EQUAL.
Greedy speculative streams equal the vanilla ones, and the per-request
spec ledger equals the reference's on the same greedy run.  Sizes are
small: prompts of at most 5 tokens, 6 new tokens, 2 slots.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import repro.serve.engine as jengine  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import policy as jpol  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import policy as tpol  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.convert import from_numpy_params  # noqa: E402
from repro_torch.models.transformer import EMPTY_POS  # noqa: E402
from repro_torch.serve.engine import SPEC_K_MAX, ServeEngine  # noqa: E402

ARCH = "qwen3_4b"
LOGIT_TOL = 2e-2        # x max|logit|, the tolerance of test_torch_lm
FAMILIES = (4, 8)
PROMPTS = ([3, 1, 4, 1, 5], [2, 7, 1], [9, 2, 6])
MAX_NEW = 6
ENGINE = dict(max_len=20, n_slots=2, prefill_len=5, decode_block=4)


def _np(a):
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


@pytest.fixture(scope="module")
def smoke():
    jcfg, tcfg = jconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(7))
    tparams = from_numpy_params(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return {"jcfg": jcfg, "tcfg": tcfg,
            "jq": jlm.quantize_params(jparams, jcfg),
            "tq": tlm.quantize_params(tparams, tcfg),
            "n": tlm.n_bit_slots(tcfg)}


def _tctrl(n):
    # int4 drafts (budget 1.0), int8 targets (the default budget)
    return tpol.BudgetController(
        {"int4": tpol.fixed(4), "int8": tpol.fixed(8)},
        {"int4": 1.0, "int8": 2.0}, n)


def _jctrl(n):
    return jpol.BudgetController(
        {"int4": jpol.fixed(4), "int8": jpol.fixed(8)},
        {"int4": 1.0, "int8": 2.0}, n)


def _engine(smoke, **kw):
    return ServeEngine(smoke["tcfg"], smoke["tq"],
                       controller=_tctrl(smoke["n"]), device="cpu",
                       **{**ENGINE, **kw})


def _serve(eng, draft_ks=None, max_new=MAX_NEW, **kw):
    rids = [eng.submit(p, max_new_tokens=max_new,
                       draft_k=None if draft_ks is None else draft_ks[i],
                       **kw)
            for i, p in enumerate(PROMPTS)]
    eng.run()
    return [eng.requests[r].tokens for r in rids]


@pytest.fixture(scope="module")
def vanilla(smoke):
    """The greedy stream of a never-drafting port engine."""
    return _serve(_engine(smoke))


# ---------------------------------------------------------------------------
# Per-token scales and the chunk
# ---------------------------------------------------------------------------

def test_token_scale_mode_quantizes_per_token(rng):
    """Under token_scale_mode a (B, U, K) per-row linear equals the
    reference's under its own token_scale_mode, and each token equals the
    (B, 1, K) call a decode step makes; outside it the scale is per row."""
    K, N, B, U = 24, 16, 2, 3
    q = rng.integers(-127, 128, (K, N)).astype(np.int8)
    s = rng.uniform(0.01, 0.05, (1, N)).astype(np.float32)
    x = rng.standard_normal((B, U, K)).astype(np.float32)
    x[0, 1] *= 9.0                                  # tokens of unlike range
    wb, ab = np.array([8, 4], np.int32), np.array([8, 4], np.int32)
    tp = {"q": torch.from_numpy(q), "s": torch.from_numpy(s)}
    jp = {"q": jnp.asarray(q), "s": jnp.asarray(s)}
    with tops.bit_families(FAMILIES), tops.token_scale_mode():
        got = tops.serve_linear(tp, torch.from_numpy(x),
                                torch.from_numpy(wb), torch.from_numpy(ab))
    with jops.bit_families(FAMILIES), jops.token_scale_mode():
        want = jops.serve_linear(jp, jnp.asarray(x), jnp.asarray(wb),
                                 jnp.asarray(ab))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with tops.bit_families(FAMILIES):
        for u in range(U):
            step = tops.serve_linear(tp, torch.from_numpy(x[:, u:u + 1]),
                                     torch.from_numpy(wb),
                                     torch.from_numpy(ab))
            np.testing.assert_array_equal(got[:, u:u + 1].numpy(),
                                          step.numpy())
        shared = tops.serve_linear(tp, torch.from_numpy(x),
                                   torch.from_numpy(wb), torch.from_numpy(ab))
    assert not torch.equal(shared, got)
    assert not tops._token_scales


def test_decode_chunk_equals_sequential_steps_and_reference(smoke):
    """From one prefilled cache, a verify-wide U = SPEC_K_MAX + 1 chunk at
    per-row bits gives the logits and cache of U sequential decode steps
    EXACTLY, and the reference's chunk within the logit tolerance, kpos
    EQUAL."""
    jcfg, tcfg = smoke["jcfg"], smoke["tcfg"]
    V = jcfg.vocab_size
    g = np.random.default_rng(5)
    prompt = g.integers(0, V, (2, 5)).astype(np.int32)
    U = SPEC_K_MAX + 1
    chunk = g.integers(0, V, (2, U)).astype(np.int32)
    wv = np.array([[8, 8], [4, 4]], np.int32)
    twv = torch.from_numpy(wv)

    def prefilled():
        with tops.bit_families(FAMILIES):
            _, c = tlm.prefill(smoke["tq"],
                               {"tokens": torch.from_numpy(prompt)}, tcfg,
                               twv, twv,
                               tlm.empty_cache(tcfg, 2, ENGINE["max_len"],
                                               device="cpu"))
        return c

    with tops.bit_families(FAMILIES):
        got, tc = tlm.decode_chunk(smoke["tq"], torch.from_numpy(chunk),
                                   torch.tensor([5, 5]), prefilled(), tcfg,
                                   twv, twv)
        seq, sc = [], prefilled()
        for u in range(U):
            lg, sc = tlm.decode_step(smoke["tq"],
                                     torch.from_numpy(chunk[:, u:u + 1]),
                                     torch.tensor([5 + u, 5 + u]), sc, tcfg,
                                     twv, twv)
            seq.append(lg)
    assert got.shape == (2, U, jcfg.padded_vocab)
    assert torch.equal(got, torch.cat(seq, dim=1))
    for leaf in ("kpos", "k", "v"):
        assert torch.equal(tc[leaf], sc[leaf]), leaf

    with jax.disable_jit(), jops.bit_families(FAMILIES):
        _, jc = jlm.prefill(smoke["jq"], {"tokens": jnp.asarray(prompt)},
                            jcfg, jnp.asarray(wv), jnp.asarray(wv),
                            jlm.empty_cache(jcfg, 2, ENGINE["max_len"]))
        want, jc = jlm.decode_chunk(smoke["jq"], jnp.asarray(chunk),
                                    jnp.asarray([5, 5]), jc, jcfg,
                                    jnp.asarray(wv), jnp.asarray(wv))
    g_, w_ = _np(got)[..., :V], _np(want)[..., :V]
    assert np.abs(g_ - w_).max() <= LOGIT_TOL * np.abs(w_).max()
    np.testing.assert_array_equal(g_.argmax(-1), w_.argmax(-1))
    np.testing.assert_array_equal(tc["kpos"].numpy(), np.asarray(jc["kpos"]))


# ---------------------------------------------------------------------------
# The engine's speculative rounds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec_k,draft_ks", [
    (1, None), (4, None), (4, [0, None, 2])],
    ids=["k1", "k4", "k4-override"])
def test_greedy_spec_matches_vanilla(smoke, vanilla, spec_k, draft_ks):
    """Every depth, and a per-request draft_k (0 = vanilla rows riding
    along), emits the vanilla greedy stream; rejected drafts roll back
    invisibly, and the pool ends empty."""
    eng = _engine(smoke, spec_k=spec_k, draft_budget_s=1.0)
    assert _serve(eng, draft_ks) == vanilla
    assert eng.calls["verify"] >= 1
    assert eng.pool.free_slots == ENGINE["n_slots"]
    assert (eng.pool.cache["kpos"] == EMPTY_POS).all()
    for rec in eng.requests.values():
        if rec.spec_k == 0:
            assert rec.spec_rounds == rec.draft_units == 0
            continue
        assert rec.draft_units == rec.spec_k * rec.spec_rounds
        assert rec.verify_units == (rec.spec_k + 1) * rec.spec_rounds
        assert rec.spec_tokens == rec.accepted_units + rec.spec_rounds
        assert rec.spec_tokens <= len(rec.tokens) == MAX_NEW


def test_top1_sampled_spec_is_greedy(smoke, vanilla):
    """Rejection resampling with one-hot densities (top_k = 1 at any
    temperature) accepts exactly the greedy drafts and resamples the
    greedy token: the stream is the vanilla one."""
    eng = _engine(smoke, spec_k=4, draft_budget_s=1.0, seed=3)
    assert _serve(eng, temperature=1.3, top_k=1) == vanilla
    sampled = _engine(smoke, spec_k=4, draft_budget_s=1.0, seed=3)
    again = _engine(smoke, spec_k=4, draft_budget_s=1.0, seed=3)
    a = _serve(sampled, temperature=1.3, top_k=8)
    assert a == _serve(again, temperature=1.3, top_k=8)
    assert all(0 <= t < smoke["tcfg"].vocab_size for row in a for t in row)


def test_spec_ledger_equals_reference(smoke, vanilla):
    """The same greedy speculative stream through the reference engine
    (op by op) and the port's, 4 new tokens a request: tokens, the spec
    plan and the per-round actuals of every request are EQUAL, and the
    ledger adds up to the tokens delivered."""
    jeng = jengine.ServeEngine(smoke["jcfg"], smoke["jq"],
                               controller=_jctrl(smoke["n"]), spec_k=4,
                               draft_budget_s=1.0, **ENGINE)
    with jax.disable_jit():
        want = _serve(jeng, [4, 2, 0], max_new=4)
    teng = _engine(smoke, spec_k=4, draft_budget_s=1.0)
    got = _serve(teng, [4, 2, 0], max_new=4)
    assert got == want == [row[:4] for row in vanilla]
    for rid, j in jeng.requests.items():
        t = teng.requests[rid]
        for name in ("spec_k", "planned_spec_rounds", "planned_spec_tokens",
                     "spec_rounds", "draft_units", "verify_units",
                     "accepted_units", "spec_tokens", "draft_wbits",
                     "planned_units", "mean_wbits"):
            assert getattr(t, name) == getattr(j, name), (rid, name)
        for name in ("ap_cost", "draft_cost", "verify_cost"):
            a, b = getattr(t, name), getattr(j, name)
            assert (a is None) == (b is None), (rid, name)
            if a is not None:
                assert a.per_layer_cycles == b.per_layer_cycles
                assert a.per_layer_energy_j == b.per_layer_energy_j
        assert t.ap_latency_s == j.ap_latency_s
        assert t.edp == j.edp
        # each round delivers its accepted drafts plus one verified token;
        # the first token comes from the prefill, the rest from vanilla
        # ticks (once no row of the batch can draft)
        assert t.spec_tokens == t.accepted_units + t.spec_rounds
        assert 1 + t.spec_tokens <= len(t.tokens) == 4
    assert teng.stats.tokens == jeng.stats.tokens == len(PROMPTS) * 4
    assert teng.calls["draft"] <= SPEC_K_MAX * teng.calls["verify"]


def test_submit_guards(smoke):
    eng = _engine(smoke, spec_k=4, draft_budget_s=1.0)
    with pytest.raises(ValueError, match="draft_k"):
        eng.submit([1, 2], max_new_tokens=4, draft_k=SPEC_K_MAX + 1)
    with pytest.raises(ValueError, match="SPEC_K_MAX"):
        # 5 + 8 + SPEC_K_MAX > max_len = 20: a round could wrap the ring
        eng.submit([1, 2, 3], max_new_tokens=8)
    eng.submit([1, 2, 3], max_new_tokens=8, draft_k=0)   # drafting off
    with pytest.raises(ValueError, match="max_len"):
        eng.submit([1, 2, 3], max_new_tokens=16, draft_k=0)
    with pytest.raises(ValueError, match="prompt length"):
        eng.submit(list(range(6)), max_new_tokens=2)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit([1], max_new_tokens=0)
    with pytest.raises(ValueError, match="TOPK_MAX"):
        eng.submit([1], max_new_tokens=2, top_k=65)
    with pytest.raises(ValueError, match="spec_k"):
        _engine(smoke, spec_k=SPEC_K_MAX + 1)
    with pytest.raises(ValueError, match="sliding_window"):
        ServeEngine(smoke["tcfg"].with_(sliding_window=8), smoke["tq"],
                    device="cpu", spec_k=2)
    assert SPEC_K_MAX == jengine.SPEC_K_MAX


def test_rollback_and_post_rejection_cache(smoke):
    """rollback masks kpos > keep for its slot only (a slot passing
    EMPTY_POS is untouched), as the reference pool does; junk drafted at
    int4 and rolled back leaves the pool bit-exact against a run that
    never drafted, at every visible entry."""
    jcfg, tcfg = smoke["jcfg"], smoke["tcfg"]
    tp = tlm.CachePool(tcfg, 2, 16, device="cpu")
    jp = jlm.CachePool(jcfg, 2, 16)
    kp = np.full(tuple(tp.cache["kpos"].shape), EMPTY_POS, np.int32)
    kp[:, :, :6] = np.arange(6)
    tp.cache["kpos"] = torch.from_numpy(kp.copy())
    jp.cache = dict(jp.cache, kpos=jnp.asarray(kp))
    keeps = np.asarray([3, EMPTY_POS], np.int32)
    tp.rollback(keeps)
    jp.rollback(keeps)
    out = tp.cache["kpos"].numpy()
    np.testing.assert_array_equal(out, np.asarray(jp.cache["kpos"]))
    assert (out[:, 0, :4] == np.arange(4)).all()
    assert (out[:, 0, 4:] == EMPTY_POS).all()
    np.testing.assert_array_equal(out[:, 1], kp[:, 1])

    n = smoke["n"]
    wv = torch.full((n,), 8, dtype=torch.int32)
    dwv = torch.full((n,), 4, dtype=torch.int32)
    prompt = torch.tensor([[3, 1, 4, 1]])

    def prefilled():
        pool = tlm.CachePool(tcfg, 1, 16, device="cpu")
        slot = pool.alloc()
        logits, row = tlm.prefill(smoke["tq"], {"tokens": prompt}, tcfg, wv,
                                  wv, tlm.empty_cache(tcfg, 1, 16,
                                                      device="cpu"))
        pool.write_row(row, slot, 4)
        return pool, int(logits[0, -1].argmax())

    def greedy(pool, tok):
        out = []
        for i in range(3):
            logits, _ = tlm.decode_step(smoke["tq"], torch.tensor([[tok]]),
                                        4 + i, pool.cache, tcfg, wv, wv)
            tok = int(logits[0, -1].argmax())
            out.append(tok)
        return out

    with tops.bit_families(FAMILIES):
        pa, tok = prefilled()
        pb, _ = prefilled()
        for i, junk in enumerate((7, 9, 11)):
            tlm.decode_step(smoke["tq"], torch.tensor([[junk]]), 4 + i,
                            pa.cache, tcfg, dwv, dwv)
        pa.rollback(np.asarray([3]))                # keep only the prompt
        assert greedy(pa, tok) == greedy(pb, tok)
    assert torch.equal(pa.cache["kpos"], pb.cache["kpos"])
    seen = pa.cache["kpos"] != EMPTY_POS
    for leaf in ("k", "v"):
        assert torch.equal(pa.cache[leaf][seen], pb.cache[leaf][seen])

"""The int8 KV cache (``kv_cache_bits=8``) on the CPU, port vs reference.

Keys and values are stored as int8 with a bf16 scale per (token, head);
decode attention quantizes q per (token, head) and the probabilities per
(query, head), and both dots accumulate exactly.  The reference's dots
are int32 einsums; the port's run in float64 (every partial sum of int8
x int8 terms is an integer below 2^53), so the accumulators are EQUAL to
the reference's and to an int64 recomputation.  The quantizers are
EQUAL on the same inputs.  The float steps around them (the scales'
products, softmax) are each library's own, so attention outputs are held
to one int8 step of the probabilities, and LM logits (qwen3_4b and
internvl2_1b SMOKE, reference op by op) to 2e-2 x max|logit| with equal
argmax, the LM slice's tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.convert import from_numpy_params  # noqa: E402
from repro_torch.models.transformer import EMPTY_POS  # noqa: E402
from repro_torch.serve.engine import ServeEngine, default_controller  # noqa: E402
from repro_torch.serve.prefix_cache import PrefixCache  # noqa: E402

LOGIT_TOL = 2e-2         # x max|logit|
FAMILIES = (4, 8)


def _np(a):
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


def _bridge(arch):
    jcfg = jconfigs.get_smoke(arch).with_(kv_cache_bits=8)
    tcfg = tconfigs.get_smoke(arch).with_(kv_cache_bits=8)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = from_numpy_params(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return {"jcfg": jcfg, "tcfg": tcfg,
            "jq": jlm.quantize_params(jparams, jcfg),
            "tq": tlm.quantize_params(tparams, tcfg)}


def _assert_logits(got, want, vocab):
    got, want = _np(got)[..., :vocab], _np(want)[..., :vocab]
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= LOGIT_TOL * scale
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_empty_cache_leaves():
    cfg = tconfigs.get_smoke("qwen3_4b").with_(kv_cache_bits=8)
    c = tlm.empty_cache(cfg, 3, 10, device="cpu")
    j = jlm.empty_cache(jconfigs.get_smoke("qwen3_4b").with_(kv_cache_bits=8),
                        3, 10)
    assert c.keys() == j.keys() == {"k", "v", "ks", "vs", "kpos"}
    for name in c:
        assert tuple(c[name].shape) == j[name].shape, name
        np.testing.assert_array_equal(_np(c[name]), _np(j[name]))
    assert c["k"].dtype == torch.int8 and c["ks"].dtype == torch.bfloat16


def test_quant_heads_equal(rng):
    x = (rng.normal(size=(2, 5, 3, 16)) * rng.uniform(0.01, 10, (2, 5, 3, 1))
         ).astype(np.float32)
    x[0, 1, 2] = 0.0                      # an all-zero head: the 1e-6 floor
    jx = jnp.asarray(x, jnp.bfloat16)
    tq, ts = ttf._quant_heads(_bf16(x))
    jq, js = jtf._quant_heads(jx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), _np(js))


def _int8_operands(rng, B, Sq, H, KV, Sc, hd):
    q = _bf16(rng.normal(size=(B, Sq, H, hd)))
    kq = rng.integers(-127, 128, (B, Sc, KV, hd)).astype(np.int8)
    vq = rng.integers(-127, 128, (B, Sc, KV, hd)).astype(np.int8)
    ks = _bf16(rng.uniform(0.001, 0.05, (B, Sc, KV)))
    vs = _bf16(rng.uniform(0.001, 0.05, (B, Sc, KV)))
    vis = rng.uniform(size=(B, Sq, Sc)) < 0.8
    vis[..., 0] = True
    bias = np.where(vis, 0.0, -np.inf).astype(np.float32)
    return q, kq, vq, ks, vs, bias


@pytest.mark.parametrize("Sq", [1, 3])
def test_sdpa_int8_accumulators_and_output(rng, Sq):
    """GQA 4/2, hd 16, Sc 50: the QK and PV accumulators EQUAL the
    reference's int32 einsums and an int64 recomputation; the output is
    within one int8 step of the probabilities of the reference's."""
    B, H, KV, Sc, hd = 2, 4, 2, 50, 16
    q, kq, vq, ks, vs, bias = _int8_operands(rng, B, Sq, H, KV, Sc, hd)
    qq, _ = ttf._quant_heads(q)
    qg = qq.reshape(B, Sq, KV, H // KV, hd)
    acc = ttf.int8_dot(qg, torch.from_numpy(kq), "bqkgd,bskd->bkgqs")
    want = jnp.einsum("bqkgd,bskd->bkgqs", jnp.asarray(qg.numpy()),
                      jnp.asarray(kq), preferred_element_type=jnp.int32)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        acc.numpy(), np.einsum("bqkgd,bskd->bkgqs", qg.numpy().astype(np.int64),
                               kq.astype(np.int64)))
    p_q = rng.integers(0, 128, (B, KV, H // KV, Sq, Sc)).astype(np.int8)
    pv = ttf.int8_dot(torch.from_numpy(p_q), torch.from_numpy(vq),
                      "bkgqs,bskd->bqkgd")
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jnp.einsum(
        "bkgqs,bskd->bqkgd", jnp.asarray(p_q), jnp.asarray(vq),
        preferred_element_type=jnp.int32)))
    got = ttf._sdpa_int8(q, torch.from_numpy(kq), ks, torch.from_numpy(vq),
                         vs, torch.from_numpy(bias))
    ref = jtf._sdpa_int8(jnp.asarray(q.float().numpy(), jnp.bfloat16),
                         jnp.asarray(kq), jnp.asarray(ks.float().numpy(),
                                                      jnp.bfloat16),
                         jnp.asarray(vq), jnp.asarray(vs.float().numpy(),
                                                      jnp.bfloat16),
                         jnp.asarray(bias), None)
    assert got.shape == (B, Sq, H * hd) and got.dtype == torch.bfloat16
    # one int8 step of p moves the output by (pmax / 127) |v_q| <= pmax,
    # and pmax <= max vs; plus the bf16 output rounding
    step = vs.float().amax().item()
    diff = np.abs(_np(got) - _np(ref))
    assert diff.max() <= step + 2 ** -7 * np.abs(_np(ref)).max()
    assert (diff == 0).mean() > 0.9


def test_int8_dot_exact_past_f32():
    """PV over 4368 keys reaches 127^2 x 4368 = 7.0e7 > 2^24: the
    accumulators stay exact (an f32 product would round them)."""
    Sc, hd = 4368, 8
    p = torch.full((1, 1, 1, 1, Sc), 127, dtype=torch.int8)
    v = torch.full((1, Sc, 1, hd), -127, dtype=torch.int8)
    v[0, ::3] = 125
    got = ttf.int8_dot(p, v, "bkgqs,bskd->bqkgd")
    want = np.einsum("bkgqs,bskd->bqkgd", p.numpy().astype(np.int64),
                     v.numpy().astype(np.int64))
    assert np.abs(want).max() > 2 ** 24
    np.testing.assert_array_equal(got.numpy(), want)


def test_prefill_cache_insert_equal(rng):
    """The same bf16 k/v inserted by both packages, with a ring shorter
    than the prompt for one row: the int8 leaves, scales and kpos EQUAL."""
    B, S, KV, hd, Sc = 2, 9, 2, 16, 6
    k = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    pos[1, 4:] = EMPTY_POS
    jc = {"k": jnp.zeros((B, Sc, KV, hd), jnp.int8),
          "v": jnp.zeros((B, Sc, KV, hd), jnp.int8),
          "ks": jnp.zeros((B, Sc, KV), jnp.bfloat16),
          "vs": jnp.zeros((B, Sc, KV), jnp.bfloat16),
          "kpos": jnp.full((B, Sc), EMPTY_POS, jnp.int32)}
    tc = {n: torch.from_numpy(np.array(_np(a))).to(
        torch.bfloat16 if n in ("ks", "vs") else
        (torch.int32 if n == "kpos" else torch.int8)) for n, a in jc.items()}
    want = jtf.prefill_cache_insert(jc, jnp.asarray(k, jnp.bfloat16),
                                    jnp.asarray(v, jnp.bfloat16),
                                    jnp.asarray(pos))
    got = ttf.prefill_cache_insert(tc, _bf16(k), _bf16(v),
                                   torch.from_numpy(pos))
    for name in want:
        np.testing.assert_array_equal(_np(got[name]), _np(want[name]), name)


@pytest.fixture(scope="module", params=["qwen3_4b", "internvl2_1b"])
def bridged(request):
    return _bridge(request.param)


def test_prefill_decode_chunk_against_reference(bridged):
    """Ragged prefill (rows of 10 and 6 tokens, vlm prefixes for
    internvl2), a decode step at per-row positions, and a 3-token chunk,
    at per-row bits: logits within LOGIT_TOL with equal argmax, kpos
    EQUAL, the int8 leaves within one step of the reference's."""
    jcfg, cfg = bridged["jcfg"], bridged["tcfg"]
    V, B, S = cfg.vocab_size, 2, 10
    P = cfg.n_prefix_tokens if cfg.family == "vlm" else 0
    g = np.random.default_rng(5)
    toks = g.integers(0, V, (B, S)).astype(np.int32)
    lens = np.array([10, 6], np.int32)
    wv = np.array([[8, 8], [4, 4]], np.int32)
    max_len = P + S + 8
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if P:
        prefix = g.normal(size=(B, P, cfg.d_model)).astype(np.float32)
        jb["prefix"], tb["prefix"] = jnp.asarray(prefix), torch.from_numpy(
            prefix)
    J = dict(jcfg=jcfg, wv=jnp.asarray(wv))
    T = dict(tcfg=cfg, wv=torch.from_numpy(wv))
    with jax.disable_jit(), jops.bit_families(FAMILIES):
        jc = jlm.empty_cache(jcfg, B, max_len)
        jlog, jc = jlm.prefill(bridged["jq"], jb, jcfg, J["wv"], J["wv"], jc,
                               lengths=jnp.asarray(lens))
    with tops.bit_families(FAMILIES):
        tc = tlm.empty_cache(cfg, B, max_len, device="cpu")
        tlog, tc = tlm.prefill(bridged["tq"], tb, cfg, T["wv"], T["wv"], tc,
                               lengths=torch.from_numpy(lens))
    _assert_logits(tlog, jlog, V)
    t = lens + P
    for i in range(1):                                # per-row positions
        tok = g.integers(0, V, (B, 1)).astype(np.int32)
        with jax.disable_jit(), jops.bit_families(FAMILIES):
            jlog, jc = jlm.decode_step(bridged["jq"], jnp.asarray(tok),
                                       jnp.asarray(t + i), jc, jcfg,
                                       J["wv"], J["wv"])
        with tops.bit_families(FAMILIES):
            tlog, tc = tlm.decode_step(bridged["tq"], torch.from_numpy(tok),
                                       torch.from_numpy(t + i), tc, cfg,
                                       T["wv"], T["wv"])
        _assert_logits(tlog, jlog, V)
    toks3 = g.integers(0, V, (B, 3)).astype(np.int32)
    with jax.disable_jit(), jops.bit_families(FAMILIES):
        jlog, jc = jlm.decode_chunk(bridged["jq"], jnp.asarray(toks3),
                                    jnp.asarray(t + 1), jc, jcfg, J["wv"],
                                    J["wv"])
    with tops.bit_families(FAMILIES):
        tlog, tc = tlm.decode_chunk(bridged["tq"], torch.from_numpy(toks3),
                                    torch.from_numpy(t + 1), tc, cfg,
                                    T["wv"], T["wv"])
    _assert_logits(tlog, jlog, V)
    np.testing.assert_array_equal(tc["kpos"].numpy(), np.asarray(jc["kpos"]))
    for name in ("k", "v"):
        assert tc[name].dtype == torch.int8
        d = np.abs(tc[name].numpy().astype(np.int32)
                   - np.asarray(jc[name]).astype(np.int32))
        assert d.max() <= 1 and (d == 0).mean() > 0.95, name
    for name in ("ks", "vs"):
        assert tc[name].dtype == torch.bfloat16
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]),
                                   rtol=2 ** -7, atol=0)


def test_continuous_equals_batch1_and_pool_carries_scales(bridged):
    """The continuous scheduler on an int8 cache: each request's tokens
    EQUAL its batch-1 run (ragged prefill + decode_step); the drained
    pool is masked; with the prefix cache (dense), a full hit installs the
    stored row's int8 leaves and scales and gives the miss's tokens."""
    cfg = bridged["tcfg"]
    P = cfg.n_prefix_tokens if cfg.family == "vlm" else 0
    n = tlm.n_bit_slots(cfg)
    ctrl = default_controller(n)
    kw = dict(max_len=P + 16, n_slots=2, prefill_len=8, decode_block=2)
    g = np.random.default_rng(6)
    reqs = [(g.integers(0, cfg.vocab_size, (S,)).astype(np.int32), b, m)
            for S, b, m in ((5, 0.4, 4), (8, 10.0, 3), (3, 0.8, 4))]
    prefixes = [g.normal(size=(P, cfg.d_model)).astype(np.float32)
                if P else None for _ in reqs]
    cache = None if P else PrefixCache(chunk=4)
    eng = ServeEngine(cfg, bridged["tq"], controller=ctrl, device="cpu",
                      prefix_cache=cache, **kw)
    rids = [eng.submit(p, max_new_tokens=m, budget_s=b, prefix=x)
            for (p, b, m), x in zip(reqs, prefixes)]
    if not P:                                    # the same prompt again
        rids.append(eng.submit(reqs[0][0], max_new_tokens=reqs[0][2],
                               budget_s=reqs[0][1]))
    eng.run()
    assert eng.pool.cache.keys() == {"k", "v", "ks", "vs", "kpos"}
    assert (eng.pool.cache["kpos"] == EMPTY_POS).all()
    for rid, ((prompt, b, m), x) in enumerate(zip(reqs, prefixes)):
        S = len(prompt)
        wv, av = ctrl.resolve(torch.tensor(b))
        toks = torch.zeros((1, 8), dtype=torch.int32)
        toks[0, :S] = torch.from_numpy(prompt)
        batch = {"tokens": toks}
        if P:
            batch["prefix"] = torch.from_numpy(x[None])
        c = tlm.empty_cache(cfg, 1, kw["max_len"], device="cpu")
        with tops.bit_families(eng.families):
            logits, c = tlm.prefill(eng.qparams, batch, cfg, wv, av, c,
                                    lengths=torch.tensor([S]))
            want = [int(logits[0, -1].argmax())]
            for t in range(P + S, P + S + m - 1):
                logits, c = tlm.decode_step(eng.qparams,
                                            torch.tensor([[want[-1]]]),
                                            torch.tensor([t]), c, cfg, wv, av)
                want.append(int(logits[0, -1].argmax()))
        assert eng.requests[rids[rid]].tokens == want, rid
    if not P:
        assert eng.requests[rids[3]].cache_hit == "full"
        assert eng.requests[rids[3]].tokens == eng.requests[rids[0]].tokens
        entry = next(iter(eng.prefix_cache.entries.values()))
        assert entry.row_cache.keys() == eng.pool.cache.keys()


def test_cache_pool_ops_carry_int8_leaves():
    """write_row, install_prefix, copy_row, reset_slot and rollback on an
    int8 pool move the k/v payloads and their ks/vs scales together."""
    cfg = tconfigs.get_smoke("qwen3_4b").with_(kv_cache_bits=8)
    pool = tlm.CachePool(cfg, 3, 8, device="cpu")
    row = tlm.empty_cache(cfg, 1, 8, device="cpu")
    g = torch.Generator().manual_seed(0)
    for name in ("k", "v"):
        row[name].copy_(torch.randint(-127, 128, row[name].shape,
                                      generator=g, dtype=torch.int8))
        row[name + "s"].copy_(torch.rand(row[name + "s"].shape,
                                         generator=g).bfloat16())
    row["kpos"][:, 0, :5] = torch.arange(5, dtype=torch.int32)
    a, b = pool.alloc(), pool.alloc()
    pool.write_row(row, a, 5)
    for name in ("k", "v", "ks", "vs", "kpos"):
        assert torch.equal(pool.cache[name][:, a], row[name][:, 0]), name
    pool.copy_row(a, b)
    for name in ("k", "v", "ks", "vs", "kpos"):
        assert torch.equal(pool.cache[name][:, b], row[name][:, 0]), name
    pool.rollback(torch.tensor([2, EMPTY_POS, EMPTY_POS]))
    assert pool.cache["kpos"][0, a].tolist()[:5] == [0, 1, 2] + [EMPTY_POS] * 2
    assert torch.equal(pool.cache["ks"][:, a], row["ks"][:, 0])
    pool.reset_slot(b)
    assert (pool.cache["kpos"][:, b] == EMPTY_POS).all()
    c = pool.alloc()
    pool.install_prefix(row, c, 3)
    assert pool.cache["kpos"][0, c].tolist()[:5] == [0, 1, 2] + [EMPTY_POS] * 2
    assert torch.equal(pool.cache["vs"][:, c], row["vs"][:, 0])
    row["ks"].zero_()                        # the pool holds a copy
    assert not torch.equal(pool.cache["ks"][:, c], row["ks"][:, 0])

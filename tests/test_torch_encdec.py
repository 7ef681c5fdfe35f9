"""The encdec family on the CPU: seamless_m4t_medium SMOKE (2 + 2 layers,
d 64, 4 heads of 16, LayerNorm, GELU), port vs reference on the same
weights.

The reference runs op by op (``jax.disable_jit``; ``test_torch_lm.py``
says why).  Encoder outputs, cross K/V, attention outputs and logits are
held to 2e-2 x max|value| (an f32 ulp of a softmax may move an activation
quantizer a step; on the flash branch both sides sum blockwise in their
own order) with equal argmax; greedy tokens EQUAL; prices EQUAL.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import repro.serve.engine as jengine  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.apsim import metrics as japm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch.serve import default_controller as jdefault  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.apsim import metrics as tapm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import encdec as ted  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.convert import from_numpy_params  # noqa: E402
from repro_torch.serve.engine import ServeEngine, default_controller  # noqa: E402

ARCH = "seamless_m4t_medium"
OUT_TOL = 2e-2           # x max|value|
FAMILIES = (4, 8)


def _np(a):
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _close(got, want, tol=OUT_TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _same_price(got, want):
    """AP records EQUAL: per-slot cycles and energy, latency, energy, EDP."""
    assert got.per_layer_cycles == want.per_layer_cycles
    assert got.per_layer_energy_j == want.per_layer_energy_j
    assert (got.latency_s, got.energy_j, got.edp) == \
        (want.latency_s, want.energy_j, want.edp)


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


def _bits(cfg):
    """Encoder slots at 8 bits, decoder slots alternating 8 and 4."""
    return np.array([8] * cfg.n_enc_layers
                    + [8 if i % 2 == 0 else 4 for i in range(cfg.n_layers)],
                    np.int32)


def test_encode_and_cross_kv(smoke):
    """The encoder over (B=2, F=10) frames, then every decoder layer's
    cross K/V from its output, against the reference."""
    jcfg, cfg = smoke["jcfg"], smoke["tcfg"]
    frames = np.random.default_rng(1).normal(
        size=(2, 10, cfg.d_model)).astype(np.float32)
    w = _bits(cfg)
    with jax.disable_jit(), jops.bit_families(FAMILIES):
        jenc = jed.encode(smoke["jq"]["layers"],
                          jnp.asarray(frames, jnp.bfloat16), jcfg,
                          jnp.asarray(w), jnp.asarray(w))
        jkv = jed.cross_kv(smoke["jq"]["layers"]["dec"], jenc, jcfg,
                           jnp.asarray(w[-jcfg.n_layers:]),
                           jnp.asarray(w[-jcfg.n_layers:]))
    with tops.bit_families(FAMILIES):
        tenc = ted.encode(smoke["tq"]["layers"],
                          torch.from_numpy(frames).bfloat16(), cfg,
                          torch.from_numpy(w), torch.from_numpy(w))
        tkv = ted.cross_kv(smoke["tq"]["layers"]["dec"], tenc, cfg,
                           torch.from_numpy(w[-cfg.n_layers:]),
                           torch.from_numpy(w[-cfg.n_layers:]))
    assert tenc.shape == (2, 10, cfg.d_model) and tenc.dtype == torch.bfloat16
    _close(tenc, jenc)
    assert tkv["k"].shape == (cfg.n_layers, 2, 10, cfg.n_kv_heads,
                              cfg.head_dim)
    # on the reference's own encoder output, the projections agree
    with tops.bit_families(FAMILIES):
        tkv_j = ted.cross_kv(smoke["tq"]["layers"]["dec"],
                             torch.from_numpy(_np(jenc)).bfloat16(), cfg,
                             torch.from_numpy(w[-cfg.n_layers:]),
                             torch.from_numpy(w[-cfg.n_layers:]))
    for name in ("k", "v"):
        _close(tkv[name], jkv[name])
        np.testing.assert_array_equal(_np(tkv_j[name]), _np(jkv[name]))


@pytest.mark.parametrize("Sq,Sk,branch", [(12, 10, "sdpa"),
                                          (2200, 2000, "flash")])
def test_cross_attention_branches(smoke, monkeypatch, Sq, Sk, branch):
    """The kv= branch of attention on layer 0's cross-attention: SDPA with
    a zero bias while Sq * Sk <= 2048^2, the flash dispatch (its plain
    version on the CPU, non-causal, Sq != Sk) above; no RoPE, no cache,
    and only wq and wo run (the reference's discarded wk/wv GEMMs are
    skipped).  At 8-bit activations: at 4 bits one bf16 rounding apart in
    the attention output can move wo's quantizer a whole step (1/7 of its
    range), which no attention tolerance separates from a fault."""
    jcfg, cfg = smoke["jcfg"], smoke["tcfg"]
    g = np.random.default_rng(Sq)
    x = g.normal(size=(2, Sq, cfg.d_model)).astype(np.float32)
    kv = [(g.normal(size=(2, Sk, cfg.n_kv_heads, cfg.head_dim)) * 0.5)
          .astype(np.float32) for _ in range(2)]
    pos = np.arange(Sq)[None]
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                smoke["jq"]["layers"]["dec"]["xattn"])
    tp = tlm._layer(smoke["tq"]["layers"]["dec"]["xattn"], 0)
    with jax.disable_jit(), jops.bit_families(FAMILIES):
        jy, jc = jtf.attention(jp, jnp.asarray(x, jnp.bfloat16), jcfg, 8, 8,
                               positions=jnp.asarray(pos),
                               kv=tuple(jnp.asarray(t, jnp.bfloat16)
                                        for t in kv))
    flash, linears = [], []
    real_fa, real_lin = tops.flash_attention, ttf.cm.apply_linear

    def fa_spy(q, k, v, *, causal, window):
        flash.append((q.shape, k.shape, causal))
        return real_fa(q, k, v, causal=causal, window=window)

    def lin_spy(p, xx, wbits=8, abits=8):
        linears.append(p["q"].shape)
        return real_lin(p, xx, wbits, abits)

    monkeypatch.setattr(tops, "flash_attention", fa_spy)
    monkeypatch.setattr(ttf.cm, "apply_linear", lin_spy)
    with tops.bit_families(FAMILIES):
        ty, tc = ttf.attention(tp, torch.from_numpy(x).bfloat16(), cfg, 8, 8,
                               positions=torch.from_numpy(pos),
                               kv=tuple(torch.from_numpy(t).bfloat16()
                                        for t in kv))
    assert jc is None and tc is None
    assert ty.shape == (2, Sq, cfg.d_model)
    _close(ty, jy)
    H, hd = cfg.n_heads, cfg.head_dim
    assert flash == ([((2 * H, Sq, hd), (2 * H, Sk, hd), False)]
                     if branch == "flash" else [])
    assert linears == [tp["wq"]["q"].shape, tp["wo"]["q"].shape]


def test_prefill_decode_against_reference(smoke):
    """lm.prefill on (B=2, S=12) tokens with F=6 frames, then two decode
    steps: logits, the cross K/V kept in the cache and the self cache's
    kpos against the reference."""
    jcfg, cfg = smoke["jcfg"], smoke["tcfg"]
    g = np.random.default_rng(2)
    B, S, F = 2, 12, 6
    toks = g.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = g.normal(size=(B, F, cfg.d_model)).astype(np.float32)
    nxt = g.integers(0, cfg.vocab_size, (2, B, 1)).astype(np.int32)
    w = _bits(cfg)
    jl, tl = [], []
    with jax.disable_jit(), jops.bit_families(FAMILIES):
        jc = jlm.empty_cache(jcfg, B, 24)
        lg, jc = jlm.prefill(smoke["jq"], {"tokens": jnp.asarray(toks),
                                           "frames": jnp.asarray(frames)},
                             jcfg, jnp.asarray(w), jnp.asarray(w), jc)
        jl.append(lg)
        for i in range(2):
            lg, jc = jlm.decode_step(smoke["jq"], jnp.asarray(nxt[i]),
                                     jnp.asarray(S + i), jc, jcfg,
                                     jnp.asarray(w), jnp.asarray(w))
            jl.append(lg)
    with tops.bit_families(FAMILIES):
        tc = tlm.empty_cache(cfg, B, 24, device="cpu")
        assert tc["cross"]["k"].shape[2] == 24 // cfg.frames_ratio
        lg, tc = tlm.prefill(smoke["tq"], {"tokens": torch.from_numpy(toks),
                                           "frames": torch.from_numpy(frames)},
                             cfg, torch.from_numpy(w), torch.from_numpy(w),
                             tc)
        tl.append(lg)
        for i in range(2):
            lg, tc = tlm.decode_step(smoke["tq"], torch.from_numpy(nxt[i]),
                                     torch.tensor(S + i), tc, cfg,
                                     torch.from_numpy(w),
                                     torch.from_numpy(w))
            tl.append(lg)
    for got, want in zip(tl, jl):
        got, want = _np(got)[..., :cfg.vocab_size], \
            _np(want)[..., :cfg.vocab_size]
        _close(got, want)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert tc["cross"]["k"].shape == (cfg.n_layers, B, F, cfg.n_kv_heads,
                                      cfg.head_dim)
    _close(tc["cross"]["k"], jc["cross"]["k"])
    np.testing.assert_array_equal(tc["self"]["kpos"].numpy(),
                                  np.asarray(jc["self"]["kpos"]))


def test_generate_matches_reference_engine(smoke):
    """generate with frames at a whole-batch budget: greedy tokens EQUAL
    the reference engine's; frames are required and shape-checked;
    per-request budgets and submit() raise the reference's reasons."""
    jcfg, cfg = smoke["jcfg"], smoke["tcfg"]
    g = np.random.default_rng(3)
    toks = g.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    frames = g.normal(size=(2, 4, cfg.d_model)).astype(np.float32)
    jeng = jengine.ServeEngine(jcfg, smoke["jq"], max_len=32,
                               controller=smoke["jctrl"])
    jeng.set_budget(0.8)
    with jax.disable_jit():
        want = np.asarray(jeng.generate({"tokens": jnp.asarray(toks),
                                         "frames": jnp.asarray(frames)}, 4))
    eng = ServeEngine(cfg, smoke["tq"], max_len=32,
                      controller=smoke["tctrl"], device="cpu")
    eng.set_budget(0.8)
    got = eng.generate({"tokens": torch.from_numpy(toks),
                        "frames": torch.from_numpy(frames)}, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    for budget in (0.4, 0.8, 10.0):
        _same_price(eng.price_budget(budget), jeng.price_budget(budget))
    for bad in (None, frames[0], frames[:1], frames[..., :8]):
        batch = {"tokens": torch.from_numpy(toks)}
        if bad is not None:
            batch["frames"] = torch.from_numpy(bad)
        with pytest.raises(ValueError, match="frames"):
            eng.generate(batch, 2)
    eng.set_budget([0.4, 10.0])
    with pytest.raises(NotImplementedError, match="whole-batch budgets"):
        eng.generate({"tokens": torch.from_numpy(toks),
                      "frames": torch.from_numpy(frames)}, 2)
    with pytest.raises(NotImplementedError, match="ragged prefill"):
        eng.submit(toks[0])


def test_bit_slots_gemm_dims_and_prices_full():
    """seamless-m4t-medium FULL: 12 encoder slots (attention + GELU MLP)
    then 12 decoder slots (self + cross attention + MLP); the AP prices
    equal the reference's."""
    full_t, full_j = tconfigs.get(ARCH), jconfigs.get(ARCH)
    assert tlm.n_bit_slots(full_t) == jlm.n_bit_slots(full_j) == 24
    dims = tlm.layer_gemm_dims(full_t)
    assert dims == jlm.layer_gemm_dims(full_j)
    assert [len(s) for s in (dims[0], dims[-1])] == [6, 10]
    n = tlm.n_bit_slots(full_t)
    for budget in (0.4, 0.8, 10.0):
        w, a = default_controller(n).resolve(torch.tensor(budget))
        jw, ja = jdefault(n).resolve(jnp.asarray(budget))
        got = tapm.price_bit_vector(dims, w.tolist(), a.tolist(),
                                    head=tlm.head_gemm_dims(full_t))
        want = japm.price_bit_vector(jlm.layer_gemm_dims(full_j),
                                     np.asarray(jw).tolist(),
                                     np.asarray(ja).tolist(),
                                     head=jlm.head_gemm_dims(full_j))
        _same_price(got, want)

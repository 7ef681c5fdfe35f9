"""The ssm family on the CPU: mamba2_1_3b SMOKE (2 layers, d 64, state
16, chunk 16), port vs reference on the same weights.

The reference runs op by op (``jax.disable_jit``; ``test_torch_lm.py``
says why).  The SSD core is f32 in both packages, but the port batches
the intra-chunk term over all chunks and sums in another order, so it is
held to 1e-4 (relative to the largest value) against the reference and
against a float64 stepwise recurrence.  Through the serve form an f32
ulp may move an 8- or 4-bit activation quantizer a step: block outputs
and logits are held to 2e-2 x max|value| with equal argmax, greedy
tokens EQUAL, prices EQUAL.
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
from repro.models import lm as jlm  # noqa: E402
from repro.models import mamba2 as jm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.apsim import metrics as tapm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import mamba2 as tm  # noqa: E402
from repro_torch.models.convert import from_numpy_params  # noqa: E402
from repro_torch.serve.engine import ServeEngine, default_controller  # noqa: E402

ARCH = "mamba2_1_3b"
SSD_TOL = 1e-4           # x max|value|: f32 sums in another order
OUT_TOL = 2e-2           # x max|value|: a quantizer step through f32 ulps
FAMILIES = (4, 8)


def _np(a):
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


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
    return {"jcfg": jcfg, "tcfg": tcfg, "tparams": tparams,
            "jq": jlm.quantize_params(jparams, jcfg),
            "tq": tlm.quantize_params(tparams, tcfg),
            "jctrl": jdefault(n), "tctrl": default_controller(n)}


def _ssd_inputs(cfg, B, S, seed):
    d_inner, H, N, P = tm.dims(cfg)
    g = np.random.default_rng(seed)
    xh = g.normal(size=(B, S, H, P)).astype(np.float32)
    Bm = (g.normal(size=(B, S, N)) * 0.5).astype(np.float32)
    Cm = (g.normal(size=(B, S, N)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(g.normal(size=(B, S, H)))).astype(np.float32)
    a = -np.exp(g.normal(size=(H,)) * 0.3).astype(np.float32)
    h0 = (g.normal(size=(B, H, P, N)) * 0.3).astype(np.float32)
    return xh, Bm, Cm, dt, a, h0


def _stepwise(xh, Bm, Cm, dt, a, h0):
    """The naive recurrence in float64."""
    xh, Bm, Cm, dt, a, h = (np.asarray(t, np.float64)
                            for t in (xh, Bm, Cm, dt, a, h0))
    ys = []
    for t in range(xh.shape[1]):
        dA = np.exp(a[None, :] * dt[:, t])
        h = h * dA[..., None, None] + np.einsum(
            "bh,bn,bhp->bhpn", dt[:, t], Bm[:, t], xh[:, t])
        ys.append(np.einsum("bn,bhpn->bhp", Cm[:, t], h))
    return np.stack(ys, axis=1), h


@pytest.mark.parametrize("S", [16, 37])
def test_ssd_chunked_matches_reference_and_stepwise(smoke, S):
    """S = 16 (one chunk) and 37 (three, the last padded), a nonzero h0."""
    cfg = smoke["tcfg"]
    ins = _ssd_inputs(cfg, 2, S, S)
    y, h = tm.ssd_chunked(*(torch.from_numpy(t) for t in ins),
                          chunk=cfg.ssm_chunk)
    jy, jh = jm.ssd_chunked(*(jnp.asarray(t) for t in ins),
                            chunk=cfg.ssm_chunk)
    assert y.dtype == h.dtype == torch.float32
    _close(y, jy, SSD_TOL)
    _close(h, jh, SSD_TOL)
    sy, sh = _stepwise(*ins)
    _close(y, sy.astype(np.float32), SSD_TOL)
    _close(h, sh.astype(np.float32), SSD_TOL)


def _layer0(smoke):
    jp = jax.tree_util.tree_map(lambda a: a[0], smoke["jq"]["layers"])
    return jp, tlm._layer(smoke["tq"]["layers"], 0)


@pytest.mark.parametrize("arm", ["full", "prefill", "decode"])
@pytest.mark.parametrize("bits", ["scalar", "per_row"])
def test_mamba_block_arms(smoke, arm, bits):
    """The three arms on layer 0's serve form: the chunked full sequence
    (S = 21, no state), the chunked prefill seeded by a random state (S =
    21), the single-step decode from a random conv window and state.
    Outputs and states against the reference."""
    cfg = smoke["tcfg"]
    d_inner, H, N, P = tm.dims(cfg)
    jp, tp = _layer0(smoke)
    g = np.random.default_rng(11)
    B = 2
    S = 1 if arm == "decode" else 21
    x = g.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    state = None
    if arm != "full":
        state = {"conv": g.normal(size=(B, cfg.d_conv - 1, d_inner + 2 * N))
                 .astype(np.float32),
                 "ssm": (g.normal(size=(B, H, P, N)) * 0.3)
                 .astype(np.float32)}
    wb = np.array([8, 4], np.int32) if bits == "per_row" else 8
    ab = np.array([8, 4], np.int32) if bits == "per_row" else 8
    with jax.disable_jit(), jops.bit_families(FAMILIES):
        jst = None if state is None else {
            "conv": jnp.asarray(state["conv"], jnp.bfloat16),
            "ssm": jnp.asarray(state["ssm"])}
        jy, jnew = jm.mamba_block(jp, jnp.asarray(x, jnp.bfloat16), cfg,
                                  jnp.asarray(wb), jnp.asarray(ab),
                                  state=jst)
    with tops.bit_families(FAMILIES):
        tst = None if state is None else {
            "conv": torch.from_numpy(state["conv"]).bfloat16(),
            "ssm": torch.from_numpy(state["ssm"])}
        ty, tnew = tm.mamba_block(tp, torch.from_numpy(x).bfloat16(), cfg,
                                  torch.as_tensor(wb), torch.as_tensor(ab),
                                  state=tst)
    assert ty.shape == (B, S, cfg.d_model) and ty.dtype == torch.bfloat16
    _close(ty, jy, OUT_TOL)
    if arm == "full":
        assert tnew is None and jnew is None
        return
    assert tnew["conv"].shape == (B, cfg.d_conv - 1, d_inner + 2 * N)
    _close(tnew["conv"], jnew["conv"], OUT_TOL)
    _close(tnew["ssm"], jnew["ssm"], OUT_TOL)


def test_prefill_then_decode_continuity(smoke):
    """Decode continuing from a 16-token prefill's state == the last
    position of a 17-token prefill, at 16 bits (float), as the
    reference's own test holds it (rtol 0.05, atol 0.08)."""
    cfg = smoke["tcfg"]
    p = smoke["tparams"]
    n = tlm.n_bit_slots(cfg)
    w = torch.full((n,), 16, dtype=torch.int32)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, 17)))
    cache = tlm.empty_cache(cfg, 1, 32, device="cpu")
    _, cache = tlm.prefill(p, {"tokens": toks[:, :16]}, cfg, w, w, cache)
    ld, _ = tlm.decode_step(p, toks[:, 16:17], torch.tensor(16), cache, cfg,
                            w, w)
    lfull, _ = tlm.prefill(p, {"tokens": toks}, cfg, w, w,
                           tlm.empty_cache(cfg, 1, 32, device="cpu"))
    np.testing.assert_allclose(_np(ld[:, -1]), _np(lfull[:, -1]), rtol=0.05,
                               atol=0.08)


def test_prefill_decode_per_row_bits_against_reference(smoke):
    """lm.prefill (S = 20, more than one chunk) then two decode steps at
    per-row bits (int8 row, int4 row): logits and states against the
    reference."""
    jcfg, cfg = smoke["jcfg"], smoke["tcfg"]
    g = np.random.default_rng(5)
    B, S = 2, 20
    toks = g.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    nxt = g.integers(0, cfg.vocab_size, (2, B, 1)).astype(np.int32)
    wv = np.array([[8, 8], [4, 4]], np.int32)
    jl, tl = [], []
    with jax.disable_jit(), jops.bit_families(FAMILIES):
        jc = jlm.empty_cache(jcfg, B, 32)
        lg, jc = jlm.prefill(smoke["jq"], {"tokens": jnp.asarray(toks)},
                             jcfg, jnp.asarray(wv), jnp.asarray(wv), jc)
        jl.append(lg)
        for i in range(2):
            lg, jc = jlm.decode_step(smoke["jq"], jnp.asarray(nxt[i]),
                                     jnp.asarray(S + i), jc, jcfg,
                                     jnp.asarray(wv), jnp.asarray(wv))
            jl.append(lg)
    with tops.bit_families(FAMILIES):
        tc = tlm.empty_cache(cfg, B, 32, device="cpu")
        lg, tc = tlm.prefill(smoke["tq"], {"tokens": torch.from_numpy(toks)},
                             cfg, torch.from_numpy(wv), torch.from_numpy(wv),
                             tc)
        tl.append(lg)
        for i in range(2):
            lg, tc = tlm.decode_step(smoke["tq"], torch.from_numpy(nxt[i]),
                                     torch.tensor(S + i), tc, cfg,
                                     torch.from_numpy(wv),
                                     torch.from_numpy(wv))
            tl.append(lg)
    for got, want in zip(tl, jl):
        got, want = _np(got)[..., :cfg.vocab_size], \
            _np(want)[..., :cfg.vocab_size]
        _close(got, want, OUT_TOL)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert set(tc) == {"conv", "ssm"}
    _close(tc["ssm"], jc["ssm"], OUT_TOL)


def test_generate_matches_reference_engine(smoke):
    """generate at per-request budgets (int4, int8): greedy tokens EQUAL
    the reference engine's; per-request budgets are taken (ssm is in
    PER_ROW_BIT_FAMILIES); submit() raises the reference's family
    reason."""
    jcfg, cfg = smoke["jcfg"], smoke["tcfg"]
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 19)
                                             ).astype(np.int32)
    jeng = jengine.ServeEngine(jcfg, smoke["jq"], max_len=32,
                               controller=smoke["jctrl"])
    jeng.set_budget([0.4, 10.0])
    with jax.disable_jit():
        want = np.asarray(jeng.generate({"tokens": jnp.asarray(toks)}, 5))
    eng = ServeEngine(cfg, smoke["tq"], max_len=32,
                      controller=smoke["tctrl"], device="cpu")
    eng.set_budget([0.4, 10.0])
    got = eng.generate({"tokens": torch.from_numpy(toks)}, 5)
    np.testing.assert_array_equal(got.numpy(), want)
    for budget in (0.4, 0.8, 10.0):
        _same_price(eng.price_budget(budget), jeng.price_budget(budget))
    with pytest.raises(NotImplementedError, match="ragged prefill"):
        eng.submit(toks[0])
    with pytest.raises(ValueError, match="chunked verify"):
        ServeEngine(cfg, smoke["tq"], controller=smoke["tctrl"],
                    device="cpu", spec_k=2)
    with pytest.raises(NotImplementedError, match="chunked decode"):
        tlm.decode_chunk(smoke["tq"], torch.from_numpy(toks[:, :2]), 0,
                         tlm.empty_cache(cfg, 2, 32, device="cpu"), cfg, 8, 8)


def test_bit_slots_gemm_dims_and_prices_full():
    """mamba2-1.3b FULL: one slot per layer, the in and out projections
    (2048 -> 2 * 4096 + 2 * 128 + 64, 4096 -> 2048); the AP prices of
    the default controller's budgets equal the reference's."""
    full_t, full_j = tconfigs.get(ARCH), jconfigs.get(ARCH)
    assert tlm.n_bit_slots(full_t) == jlm.n_bit_slots(full_j) == 48
    dims = tlm.layer_gemm_dims(full_t)
    assert dims == jlm.layer_gemm_dims(full_j)
    assert dims[0] == ((2048, 8512), (4096, 2048))
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

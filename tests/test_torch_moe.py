"""The MoE family on the CPU: moonshot_v1_16b_a3b SMOKE, port vs
reference on the same weights.

Weights are made by the reference (``jax.random``) and carried across by
the weight bridge.  The reference's ``quantize_params`` leaves the
``(L, E, d, f)`` expert stacks bf16 (its rule quantizes ``ndim == 3``
leaves only), so its serve path would run the train form; the port
quantizes them per expert.  The comparisons therefore run the reference
on serve parameters whose experts are quantized per expert with
``repro.core.bitfluid``, as its own ``q_expert`` does, and one test
reproduces the reference's behaviour.

The reference runs op by op (``jax.disable_jit``; ``test_torch_lm.py``
says why).  Routing (``topi``) and the integer paths are EQUAL; the
expert path given the same routing is EQUAL (each token's k gated
contributions are summed in choice order, as XLA's CPU reduction sums
them); logits are held to 2e-2 x max|logit| with equal argmax, the LM
slice's tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import repro.serve.engine as jengine  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.apsim import metrics as japm  # noqa: E402
from repro.core import bitfluid as jbf  # noqa: E402
from repro.launch.serve import default_controller as jdefault  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.apsim import metrics as tapm  # noqa: E402
from repro_torch.dist import api as tdist  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.convert import from_numpy_params  # noqa: E402
from repro_torch.serve.engine import ServeEngine, default_controller  # noqa: E402

ARCH = "moonshot_v1_16b_a3b"
LOGIT_TOL = 2e-2         # x max|logit|


def _np(a):
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _q_expert(w):
    """The reference's own per-expert quantization (``q_expert``)."""
    w = w.astype(jnp.float32)
    s = jbf.symmetric_scale(w, 8, axis=-2)
    return {"q": jbf.quantize(w, s, 8), "s": s}


@pytest.fixture(scope="module")
def smoke():
    jcfg, tcfg = jconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = from_numpy_params(np_params, device="cpu")
    jq_ref = jlm.quantize_params(jparams, jcfg)        # experts stay bf16
    jq = dict(jq_ref, layers=dict(jq_ref["layers"]))
    jq["layers"]["mlp"] = dict(jq_ref["layers"]["mlp"])
    jq["layers"]["mlp"]["experts"] = {
        k: _q_expert(v) for k, v in jparams["layers"]["mlp"]["experts"].items()}
    return {"jcfg": jcfg, "tcfg": tcfg, "jparams": jparams,
            "np_params": np_params, "tparams": tparams, "jq_ref": jq_ref,
            "jq": jq, "tq": tlm.quantize_params(tparams, tcfg)}


def _layer0(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree)


def _tlayer0(tree):
    return tlm._layer(tree, 0)


def _assert_logits(got, want, vocab):
    got, want = _np(got)[..., :vocab], _np(want)[..., :vocab]
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= LOGIT_TOL * scale
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


# ---------------------------------------------------------------------------
# Layout, init, quantization
# ---------------------------------------------------------------------------

def test_convert_and_init_layout(smoke):
    """The reference's (L, E, d, f) tree converts leaf for leaf; the
    port's own init_params has the same layout and the reference's
    scales."""
    np_leaves = dict(_leaves(smoke["np_params"]))
    t_leaves = dict(_leaves(smoke["tparams"]))
    assert np_leaves.keys() == t_leaves.keys()
    for k, a in np_leaves.items():
        assert tuple(t_leaves[k].shape) == a.shape
        np.testing.assert_array_equal(_np(t_leaves[k]), a.astype(np.float32))
    cfg = smoke["tcfg"]
    assert t_leaves["/layers/mlp/experts/wg"].shape == (
        cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff)
    own = tlm.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    o_leaves = dict(_leaves(own))
    assert o_leaves.keys() == t_leaves.keys()
    for k, t in o_leaves.items():
        assert (t.shape, t.dtype) == (t_leaves[k].shape, t_leaves[k].dtype)
    wd = own["layers"]["mlp"]["experts"]["wd"].float()
    assert abs(wd.std().item() / cfg.d_ff ** -0.5 - 1) < 0.1
    fs = cfg.d_ff * cfg.n_shared_experts
    wd = own["layers"]["mlp"]["shared"]["wd"]["w"].float()
    assert abs(wd.std().item() / fs ** -0.5 - 1) < 0.1


def test_quantize_params_per_expert(smoke):
    """The port quantizes (L, E, d, f) stacks per expert: q int8 and s
    (L, E, 1, f), EQUAL the reference's per-expert quantization; every
    other leaf EQUALS the reference's quantize_params (the router bf16)."""
    cfg = smoke["tcfg"]
    tq = smoke["tq"]
    j = dict(_leaves(jax.tree_util.tree_map(np.asarray, smoke["jq"])))
    t = dict(_leaves(tq))
    assert j.keys() == t.keys()
    for k in j:
        np.testing.assert_array_equal(_np(t[k]), _np(j[k]), err_msg=k)
    wg = tq["layers"]["mlp"]["experts"]["wg"]
    L, E, d, f = cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff
    assert wg["q"].dtype == torch.int8 and wg["q"].shape == (L, E, d, f)
    assert wg["s"].shape == (L, E, 1, f)
    assert tq["layers"]["mlp"]["router"]["w"].dtype == torch.bfloat16
    # one expert's slice quantizes on its own
    w = smoke["tparams"]["layers"]["mlp"]["experts"]["wg"][1, 3].float()
    s = w.abs().amax(dim=0, keepdim=True).clamp_min(1e-8) / 127
    torch.testing.assert_close(wg["s"][1, 3], s, rtol=0, atol=0)


def test_reference_quantize_params_leaves_lm_experts_bf16(smoke):
    """The reference's fault: its rule quantizes expert leaves with
    ``ndim == 3`` only, so an LM's (L, E, d, f) stacks stay bf16 in the
    serve form and its apply_moe takes the fake-quant train branch."""
    wg = smoke["jq_ref"]["layers"]["mlp"]["experts"]["wg"]
    assert not isinstance(wg, dict)
    assert wg.dtype == jnp.bfloat16 and wg.ndim == 4
    # a single layer's (E, d, f) stack does quantize there
    one = jlm.quantize_params({"mlp": {"experts": {
        "wg": smoke["jparams"]["layers"]["mlp"]["experts"]["wg"][0]}}},
        smoke["jcfg"])
    assert one["mlp"]["experts"]["wg"]["q"].dtype == jnp.int8


# ---------------------------------------------------------------------------
# Routing, positions, dispatch
# ---------------------------------------------------------------------------

def test_route_ties_keep_the_lower_index(smoke, rng):
    """Equal router probabilities: the port's choices equal lax.top_k's,
    which puts the lower expert index first."""
    cfg = smoke["tcfg"]
    E, d = cfg.n_experts, cfg.d_model
    w = rng.normal(size=(d, E)).astype(np.float32) * d ** -0.5
    w[:, 5] = w[:, 2]                     # experts 2 and 5 tie
    w[:, 7] = w[:, 1]                     # 1 and 7 tie
    w[:, 4] = w[:, 3]
    x = rng.normal(size=(12, d)).astype(np.float32)
    x[:3] = 0.0                           # every expert ties
    jp = {"router": {"w": jnp.asarray(w, jnp.bfloat16)}}
    tp = {"router": {"w": torch.from_numpy(w).bfloat16()}}
    with jax.disable_jit():
        jtopi, jtopv, jaux = jmoe._route(
            jp, jnp.asarray(x, jnp.bfloat16), smoke["jcfg"])
    ttopi, ttopv, taux = tmoe._route(tp, torch.from_numpy(x).bfloat16(), cfg)
    np.testing.assert_array_equal(ttopi.numpy(), np.asarray(jtopi))
    np.testing.assert_array_equal(ttopi[:3].numpy(),
                                  np.tile(np.arange(cfg.experts_per_token),
                                          (3, 1)))
    np.testing.assert_allclose(ttopv.numpy(), np.asarray(jtopv), rtol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("T", [1, 7, 64, 4096, 8192])
def test_positions_and_capacity(smoke, T):
    """Position-in-expert per choice EQUAL at several T; the capacity is
    the reference's formula (960 rounds up to 1024 at moonshot FULL's
    prefill of 2 x 4096 tokens; a 2-row decode step gets 1 slot)."""
    cfg = smoke["tcfg"]
    E, k = cfg.n_experts, cfg.experts_per_token
    C = tmoe.capacity(T, cfg)
    want_c = max(int(T * k / E * cfg.capacity_factor), 1)
    assert C == (-(-want_c // 512) * 512 if T >= 4096 else want_c)
    topi = np.random.default_rng(T).integers(0, E, (T, k))
    jeid, jpos, jkeep = jmoe._positions(jnp.asarray(topi, jnp.int32), E, C)
    teid, tpos, tkeep = tmoe._positions(torch.from_numpy(topi), E, C)
    np.testing.assert_array_equal(teid.numpy(), np.asarray(jeid))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    full = tconfigs.get(ARCH)
    assert tmoe.capacity(2 * 4096, full) == 1024
    assert tmoe.capacity(2, full) == 1


def _experts(smoke, layer=0):
    return (_layer0(smoke["jq"]["layers"]["mlp"]) if layer == 0 else None,
            _tlayer0(smoke["tq"]["layers"]["mlp"]))


@pytest.mark.parametrize("wbits", ["scalar", "per-expert"])
def test_dispatch_compute_combine_equal_given_routing(smoke, rng, wbits):
    """Dispatch, the expert FFNs (serve form) and combine on the same
    routing, with capacity dropping choices: EQUAL."""
    jcfg, cfg = smoke["jcfg"], smoke["tcfg"]
    jp, tp = _experts(smoke)
    T, E, k = 24, cfg.n_experts, cfg.experts_per_token
    x = rng.normal(size=(T, cfg.d_model)).astype(np.float32)
    topi = np.stack([rng.choice(E, k, replace=False) for _ in range(T)])
    topv = rng.uniform(0.1, 1.0, (T, k)).astype(np.float32)
    topv /= topv.sum(-1, keepdims=True)
    wb = (np.array(8, np.int32) if wbits == "scalar"
          else np.array([8, 4, 6, 8, 2, 3, 8, 5], np.int32))
    C = 4                                   # fewer slots than choices
    with jax.disable_jit():
        want = jmoe._dispatch_compute_combine(
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(topi, jnp.int32),
            jnp.asarray(topv), jp["experts"], jcfg, jnp.asarray(wb),
            jnp.asarray(8), C)
    got = tmoe._dispatch_compute_combine(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(topi),
        torch.from_numpy(topv), tp["experts"], cfg, torch.from_numpy(wb),
        torch.tensor(8), C)
    assert got.dtype == torch.bfloat16 and got.shape == (T, cfg.d_model)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_apply_moe_per_expert_bits_and_shared_at_max(smoke, rng):
    """apply_moe with (E,) per-expert bits: y and aux against the
    reference; the shared experts run at the max of the per-expert bits
    (here 6: none of the experts is at 8)."""
    jcfg, cfg = smoke["jcfg"], smoke["tcfg"]
    jp, tp = _experts(smoke)
    wb = np.array([2, 4, 6, 4, 3, 5, 6, 4], np.int32)
    x = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    with jax.disable_jit():
        jy, jaux = jmoe.apply_moe(jp, jnp.asarray(x, jnp.bfloat16), jcfg,
                                  jnp.asarray(wb), jnp.asarray(8))
    ty, taux = tmoe.apply_moe(tp, torch.from_numpy(x).bfloat16(), cfg,
                              torch.from_numpy(wb), torch.tensor(8))
    np.testing.assert_array_equal(_np(ty), _np(jy))
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    # the shared part alone: apply_moe minus the routed part, at max bits
    no_shared = {k: v for k, v in tp.items() if k != "shared"}
    routed, _ = tmoe.apply_moe(no_shared, torch.from_numpy(x).bfloat16(),
                               cfg, torch.from_numpy(wb), torch.tensor(8))
    xf = torch.from_numpy(x).bfloat16().reshape(-1, cfg.d_model)
    sh = tp["shared"]
    from repro_torch.models import common as tcm
    for bits, same in ((6, True), (8, False)):
        h = tmoe._swiglu(tcm.apply_linear(sh["wg"], xf, torch.tensor(bits), 8),
                         tcm.apply_linear(sh["wu"], xf, torch.tensor(bits), 8))
        y = routed.reshape(-1, cfg.d_model) + tcm.apply_linear(
            sh["wd"], h, torch.tensor(bits), 8)
        assert torch.equal(y.reshape(ty.shape), ty) == same, bits


def test_train_form_matches_reference(smoke, rng):
    """The bf16 train form (fake-quant experts, f32 products): within
    f32 rounding of the reference, routing EQUAL."""
    jcfg, cfg = smoke["jcfg"], smoke["tcfg"]
    jp = _layer0(smoke["jparams"]["layers"]["mlp"])
    tp = _tlayer0(smoke["tparams"]["layers"]["mlp"])
    x = rng.normal(size=(1, 6, cfg.d_model)).astype(np.float32)
    with jax.disable_jit():
        jy, _ = jmoe.apply_moe(jp, jnp.asarray(x, jnp.bfloat16), jcfg, 4, 8)
    ty, _ = tmoe.apply_moe(tp, torch.from_numpy(x).bfloat16(), cfg, 4, 8)
    want = _np(jy)
    assert np.abs(_np(ty) - want).max() <= 2 ** -7 * np.abs(want).max()


# ---------------------------------------------------------------------------
# The LM on MoE layers
# ---------------------------------------------------------------------------

def _record_topi(monkeypatch):
    seen = {"j": [], "t": []}
    jroute, troute = jmoe._route, tmoe._route

    def jrec(*a):
        out = jroute(*a)
        seen["j"].append(np.asarray(out[0]))
        return out

    def trec(*a):
        out = troute(*a)
        seen["t"].append(out[0].numpy())
        return out

    monkeypatch.setattr(jmoe, "_route", jrec)
    monkeypatch.setattr(tmoe, "_route", trec)
    return seen


def test_prefill_decode_against_reference(smoke, monkeypatch):
    """Prefill (S = 24) and 2 teacher-forced decode steps at a per-layer
    bit vector: logits within LOGIT_TOL with equal argmax, per-layer
    topi EQUAL, kpos EQUAL."""
    jcfg, cfg = smoke["jcfg"], smoke["tcfg"]
    seen = _record_topi(monkeypatch)
    V, B, S = cfg.vocab_size, 2, 24
    g = np.random.default_rng(1)
    toks = g.integers(0, V, (B, S)).astype(np.int32)
    wv = np.array([8, 4], np.int32)
    with jax.disable_jit():
        jc = jlm.empty_cache(jcfg, B, S + 4)
        jlog, jc = jlm.prefill(smoke["jq"], {"tokens": jnp.asarray(toks)},
                               jcfg, jnp.asarray(wv), jnp.asarray(wv), jc)
    tc = tlm.empty_cache(cfg, B, S + 4, device="cpu")
    tlog, tc = tlm.prefill(smoke["tq"], {"tokens": torch.from_numpy(toks)},
                           cfg, torch.from_numpy(wv), torch.from_numpy(wv),
                           tc)
    _assert_logits(tlog, jlog, V)
    for i in range(2):
        tok = g.integers(0, V, (B, 1)).astype(np.int32)
        with jax.disable_jit():
            jlog, jc = jlm.decode_step(smoke["jq"], jnp.asarray(tok),
                                       jnp.asarray(S + i), jc, jcfg,
                                       jnp.asarray(wv), jnp.asarray(wv))
        tlog, tc = tlm.decode_step(smoke["tq"], torch.from_numpy(tok),
                                   torch.tensor(S + i), tc, cfg,
                                   torch.from_numpy(wv),
                                   torch.from_numpy(wv))
        _assert_logits(tlog, jlog, V)
    np.testing.assert_array_equal(tc["kpos"].numpy(), np.asarray(jc["kpos"]))
    assert len(seen["t"]) == len(seen["j"]) == 3 * cfg.n_layers
    for a, b in zip(seen["t"], seen["j"]):
        np.testing.assert_array_equal(a, b)
    # forward_hidden's aux is the mean of the layers' load-balance losses
    x = tlm.embed(smoke["tq"], torch.from_numpy(toks))
    pos = torch.arange(S)[None]
    _, _, aux = tlm.forward_hidden(smoke["tq"], x, cfg, torch.from_numpy(wv),
                                   torch.from_numpy(wv), positions=pos)
    with jax.disable_jit():
        _, _, jaux = jlm.forward_hidden(
            smoke["jq"], jlm.embed(smoke["jq"], jnp.asarray(toks)), jcfg,
            jnp.asarray(wv), jnp.asarray(wv), positions=jnp.asarray(pos))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_generate_matches_reference_engine(smoke, monkeypatch):
    """ServeEngine.generate on MoE with a whole-batch budget (int4):
    greedy tokens EQUAL the reference engine's (op by op)."""
    jcfg, cfg = smoke["jcfg"], smoke["tcfg"]
    n = tlm.n_bit_slots(cfg)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16)
                                             ).astype(np.int32)
    steps = 3
    for budget in (0.4,):
        jeng = jengine.ServeEngine(jcfg, smoke["jq"], max_len=32,
                                   controller=jdefault(n))
        jeng.set_budget(budget)
        with jax.disable_jit():
            want = np.asarray(jeng.generate({"tokens": jnp.asarray(toks)},
                                            steps))
        eng = ServeEngine(cfg, smoke["tq"], max_len=32,
                          controller=default_controller(n), device="cpu")
        eng.set_budget(budget)
        got = eng.generate({"tokens": torch.from_numpy(toks)}, steps)
        np.testing.assert_array_equal(got.numpy(), want)


def test_bit_slots_gemm_dims_and_prices_full():
    """moonshot FULL: one bit slot per layer; a slot's GEMMs are the
    attention's 4, k = 6 routed experts' 3 each and the 2 shared experts'
    3 at twice d_ff; the AP prices equal the reference's."""
    full_t, full_j = tconfigs.get(ARCH), jconfigs.get(ARCH)
    assert tlm.n_bit_slots(full_t) == jlm.n_bit_slots(full_j) == 48
    dims = tlm.layer_gemm_dims(full_t)
    assert dims == jlm.layer_gemm_dims(full_j)
    assert len(dims) == 48 and len(dims[0]) == 4 + 6 * 3 + 3
    assert dims[0][-3:] == ((2048, 2816), (2048, 2816), (2816, 2048))
    assert tlm.head_gemm_dims(full_t) == jlm.head_gemm_dims(full_j)
    n = tlm.n_bit_slots(full_t)
    for budget in (0.4, 0.8, 10.0):
        w, a = default_controller(n).resolve(torch.tensor(budget))
        jw, ja = jdefault(n).resolve(jnp.asarray(budget))
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        got = tapm.price_bit_vector(dims, w.tolist(), a.tolist(),
                                    head=tlm.head_gemm_dims(full_t))
        want = japm.price_bit_vector(jlm.layer_gemm_dims(full_j),
                                     np.asarray(jw).tolist(),
                                     np.asarray(ja).tolist(),
                                     head=jlm.head_gemm_dims(full_j))
        assert got.per_layer_cycles == want.per_layer_cycles
        assert got.per_layer_energy_j == want.per_layer_energy_j
        assert got.edp == want.edp


def test_moe_rejects_what_the_reference_rejects(smoke):
    """Per-request (B, L) bit matrices, ragged prefill, the continuous
    API, speculation, an expert-parallel mesh and per-row activation
    bits on the expert stack raise."""
    cfg, tq = smoke["tcfg"], smoke["tq"]
    toks = torch.zeros((2, 4), dtype=torch.long)
    cache = tlm.empty_cache(cfg, 2, 8, device="cpu")
    wv = torch.full((2, cfg.n_layers), 8)
    with pytest.raises(NotImplementedError, match="per-request"):
        tlm.prefill(tq, {"tokens": toks}, cfg, wv, wv, cache)
    with pytest.raises(NotImplementedError, match="ragged"):
        tlm.prefill(tq, {"tokens": toks}, cfg, wv[0], wv[0], cache,
                    lengths=[3, 4])
    eng = ServeEngine(cfg, tq, max_len=32, device="cpu",
                      controller=default_controller(cfg.n_layers))
    with pytest.raises(NotImplementedError, match="generate"):
        eng.submit(np.zeros(4, np.int32))
    eng.set_budget([0.4, 10.0])
    with pytest.raises(NotImplementedError, match="per-request"):
        eng.generate({"tokens": toks}, 2)
    with pytest.raises(ValueError, match="chunked"):
        ServeEngine(cfg, tq, spec_k=2, device="cpu")

    class Mesh:
        shape = {"data": 1, "model": 2}
        axis_names = ("data", "model")

    x = torch.zeros((1, 2, cfg.d_model), dtype=torch.bfloat16)
    with tdist.use_mesh(Mesh()):
        with pytest.raises(NotImplementedError, match="sharding"):
            tmoe.apply_moe(_tlayer0(tq["layers"]["mlp"]), x, cfg)
    # the per-expert stack takes one activation width for the whole batch
    wg = _tlayer0(tq["layers"]["mlp"]["experts"]["wg"])
    xs = torch.zeros((cfg.n_experts, 2, cfg.d_model))
    with pytest.raises(NotImplementedError, match="scalar abits"):
        tops.serve_linear_stacked(wg, xs, torch.full((cfg.n_experts,), 8),
                                  torch.tensor([8, 4]), stack_bits=True)


@pytest.mark.parametrize("arch", [ARCH, "internvl2_1b"])
def test_init_serve_params_layout(arch):
    """Drawing and quantizing layer by layer gives the layout and dtypes
    of quantize_params(init_params(...)), and every layer its own draws."""
    cfg = tconfigs.get_smoke(arch)
    want = dict(_leaves(tlm.quantize_params(
        tlm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"),
        cfg)))
    got = dict(_leaves(tlm.init_serve_params(
        cfg, torch.Generator().manual_seed(0), device="cpu")))
    assert got.keys() == want.keys()
    for k, t in got.items():
        assert (t.shape, t.dtype) == (want[k].shape, want[k].dtype), k
    q = got["/layers/attn/wq/q"]
    assert not torch.equal(q[0], q[1])

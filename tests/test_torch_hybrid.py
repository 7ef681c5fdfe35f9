"""The hybrid family on the CPU: zamba2_2_7b SMOKE (Mamba2 layers and
one shared attention block with per-site LoRA), port vs reference on the
same weights.

The reference runs op by op (``jax.disable_jit``; ``test_torch_lm.py``
says why).  Hidden states and logits are held to 2e-2 x max|value| (an
f32 ulp of the SSD or the softmax may move an activation quantizer a
step) with equal argmax; greedy tokens EQUAL; prices EQUAL.

The reference's serve form attaches each site's LoRA delta and never
reads it (ROADMAP Queue C); the port adds it.  With ``b = 0``, as
``lora_init`` draws it, the two agree; ``test_lora_side_branch`` shows
both sides of the departure with a nonzero ``b``.
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
from repro.models import hybrid as jhy  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.apsim import metrics as tapm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models import hybrid as thy  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.convert import from_numpy_params  # noqa: E402
from repro_torch.serve.engine import ServeEngine, default_controller  # noqa: E402

ARCH = "zamba2_2_7b"
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


def _models(jcfg, tcfg, b_seed=None):
    """Reference weights from PRNGKey(0), the same weights in the port,
    both serve forms; ``b_seed`` draws every site's LoRA ``b`` (numpy)."""
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    if b_seed is not None:
        g = np.random.default_rng(b_seed)
        lora = jparams["layers"]["lora"]
        for name in lora:
            b = lora[name]["b"]
            lora[name]["b"] = jnp.asarray(
                g.normal(size=b.shape) * 0.5, jnp.bfloat16)
    tparams = from_numpy_params(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return {"jparams": jparams, "tparams": tparams,
            "jq": jlm.quantize_params(jparams, jcfg),
            "tq": tlm.quantize_params(tparams, tcfg)}


def _same_price(got, want):
    """AP records EQUAL: per-slot cycles and energy, latency, energy, EDP."""
    assert got.per_layer_cycles == want.per_layer_cycles
    assert got.per_layer_energy_j == want.per_layer_energy_j
    assert (got.latency_s, got.energy_j, got.edp) == \
        (want.latency_s, want.energy_j, want.edp)


@pytest.fixture(scope="module")
def smoke():
    jcfg, tcfg = jconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)
    n = tlm.n_bit_slots(tcfg)
    return {"jcfg": jcfg, "tcfg": tcfg, **_models(jcfg, tcfg),
            "jctrl": jdefault(n), "tctrl": default_controller(n)}


@pytest.fixture(scope="module")
def deep():
    """SMOKE cut the other way: 4 layers in 2 super-blocks of 2, so the
    Mamba layers' super-block indexing and bits are exercised."""
    kw = dict(n_layers=4, attn_every=2)
    jcfg = jconfigs.get_smoke(ARCH).with_(**kw)
    tcfg = tconfigs.get_smoke(ARCH).with_(**kw)
    return {"jcfg": jcfg, "tcfg": tcfg, **_models(jcfg, tcfg, b_seed=3)}


def _reference(m, form, wb, x):
    jp = m["jparams" if form == "train" else "jq"]["layers"]
    with jax.disable_jit(), jops.bit_families(FAMILIES):
        jh, _ = jhy.hybrid_forward(
            jp, jnp.asarray(x, jnp.bfloat16), m["jcfg"], jnp.asarray(wb),
            jnp.asarray(wb), positions=jnp.arange(x.shape[1])[None])
    return jh


def _port(m, form, wb, x):
    tp = m["tparams" if form == "train" else "tq"]["layers"]
    with tops.bit_families(FAMILIES):
        th, _ = thy.hybrid_forward(
            tp, torch.from_numpy(x).bfloat16(), m["tcfg"],
            torch.as_tensor(wb), torch.as_tensor(wb),
            positions=torch.arange(x.shape[1])[None])
    return th


def test_shared_block_weight_sharing(smoke, deep):
    """The shared attention block is ONE weight set (not stacked per
    site); LoRA pairs are stacked per super-block, Mamba layers per
    (super-block, layer); the shared block's linears quantize, the LoRA
    pairs stay bf16, and every leaf converts EQUAL from the reference."""
    for m in (smoke, deep):
        cfg = m["tcfg"]
        lay = m["tparams"]["layers"]
        ns = thy.n_super(cfg)
        assert lay["shared"]["attn"]["wq"]["w"].ndim == 2
        assert lay["lora"]["wq"]["a"].shape[0] == ns
        assert lay["mamba"]["in_proj"]["w"].shape[:2] == (ns, cfg.attn_every)
        q = m["tq"]["layers"]
        assert q["shared"]["attn"]["wq"]["q"].dtype == torch.int8
        assert q["lora"]["wq"]["a"].dtype == torch.bfloat16
        assert q["mamba"]["conv_w"].dtype == torch.bfloat16
        jq = jax.tree_util.tree_map(np.asarray, m["jq"])
        for path in (("shared", "attn", "wq", "q"), ("shared", "attn", "wq",
                                                     "s"),
                     ("mamba", "out_proj", "q"), ("lora", "wo", "b")):
            got, want = q, jq["layers"]
            for k in path:
                got, want = got[k], want[k]
            np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("form", ["serve", "train"])
def test_hybrid_forward_matches_reference(deep, form):
    """hybrid_forward over (B=2, S=20) at per-super-block bits (8, 4),
    with nonzero LoRA b: the serve form (where the reference drops the
    delta, so b is zeroed for the comparison) and the train form (W + A
    @ B in both)."""
    m = deep
    if form == "serve":
        m = {**deep, "jq": _zero_b(deep["jq"]), "tq": _zero_b(deep["tq"])}
    x = np.random.default_rng(6).normal(
        size=(2, 20, deep["tcfg"].d_model)).astype(np.float32)
    wb = np.array([8, 4], np.int32)
    th, jh = _port(m, form, wb, x), _reference(m, form, wb, x)
    assert th.shape == (2, 20, deep["tcfg"].d_model)
    _close(th, jh)


def _zero_b(q):
    lora = {k: {"a": v["a"], "b": v["b"] * 0} for k, v in
            q["layers"]["lora"].items()}
    return {**q, "layers": {**q["layers"], "lora": lora}}


def test_lora_side_branch(deep, monkeypatch):
    """A nonzero b.  The reference's serve-form output is bitwise the
    same as with b = 0 (its delta is never read).  The port's differs,
    and every shared-block linear at every site gives exactly its
    side branch: bf16(serve_linear(base, x) + x @ bf16(A_i @ B_i)), the
    product summed in float64, with site i's own pair."""
    x = np.random.default_rng(7).normal(
        size=(2, 20, deep["tcfg"].d_model)).astype(np.float32)
    wb = np.array([8, 4], np.int32)
    zero = {**deep, "jq": _zero_b(deep["jq"]), "tq": _zero_b(deep["tq"])}
    np.testing.assert_array_equal(_np(_reference(deep, "serve", wb, x)),
                                  _np(_reference(zero, "serve", wb, x)))

    seen = []
    real = tcm.apply_linear

    def spy(p, xx, wbits=8, abits=8):
        y = real(p, xx, wbits, abits)
        if "lora_delta" in p:
            seen.append((p, xx, wbits, abits, y))
        return y

    t0 = _port(zero, "serve", wb, x)
    monkeypatch.setattr(tcm, "apply_linear", spy)
    th = _port(deep, "serve", wb, x)
    assert float((th.float() - t0.float()).abs().max()) > 0
    lora = deep["tq"]["layers"]["lora"]
    ns = thy.n_super(deep["tcfg"])
    assert len(seen) == 4 * ns
    for j, (p, xx, wbits, abits, y) in enumerate(seen):
        site, name = j // 4, ("wq", "wk", "wv", "wo")[j % 4]
        delta = (lora[name]["a"][site].float() @ lora[name]["b"][site]
                 .float()).bfloat16()
        assert torch.equal(p["lora_delta"], delta)
        base = {k: v for k, v in p.items() if k != "lora_delta"}
        with tops.bit_families(FAMILIES):
            want = (tops.serve_linear(base, xx, wbits, abits)
                    + (xx.double() @ delta.double()).float()).bfloat16()
        assert torch.equal(y, want)
        assert float(delta.abs().max()) > 0


def test_generate_matches_reference_engine(smoke):
    """generate at the tightest and the loosest whole-batch budget:
    greedy tokens EQUAL the reference engine's; per-request budgets,
    submit() and speculation raise the reference's family reasons."""
    jcfg, cfg = smoke["jcfg"], smoke["tcfg"]
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 18)
                                             ).astype(np.int32)
    jeng = jengine.ServeEngine(jcfg, smoke["jq"], max_len=32,
                               controller=smoke["jctrl"])
    eng = ServeEngine(cfg, smoke["tq"], max_len=32,
                      controller=smoke["tctrl"], device="cpu")
    for budget in (0.4, 10.0):
        jeng.set_budget(budget)
        with jax.disable_jit():
            want = np.asarray(jeng.generate({"tokens": jnp.asarray(toks)},
                                            4))
        eng.set_budget(budget)
        got = eng.generate({"tokens": torch.from_numpy(toks)}, 4)
        np.testing.assert_array_equal(got.numpy(), want)
        _same_price(eng.price_budget(budget), jeng.price_budget(budget))
    eng.set_budget([0.4, 10.0])
    with pytest.raises(NotImplementedError, match="whole-batch budgets"):
        eng.generate({"tokens": torch.from_numpy(toks)}, 2)
    with pytest.raises(NotImplementedError, match="ragged prefill"):
        eng.submit(toks[0])
    with pytest.raises(ValueError, match="chunked verify"):
        ServeEngine(cfg, smoke["tq"], controller=smoke["tctrl"],
                    device="cpu", spec_k=2)


def test_bit_slots_gemm_dims_and_prices_full():
    """zamba2-2.7b FULL: one slot per super-block (9); a slot's GEMMs are
    the shared attention's 4, its SwiGLU's 3 and 6 Mamba layers' in and
    out projections; the AP prices equal the reference's."""
    full_t, full_j = tconfigs.get(ARCH), jconfigs.get(ARCH)
    assert tlm.n_bit_slots(full_t) == jlm.n_bit_slots(full_j) == 9
    dims = tlm.layer_gemm_dims(full_t)
    assert dims == jlm.layer_gemm_dims(full_j)
    assert len(dims) == 9 and len(dims[0]) == 4 + 3 + 2 * 6
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

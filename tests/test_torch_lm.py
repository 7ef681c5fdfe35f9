"""The dense LM slice on the CPU: qwen3_4b SMOKE (and starcoder2_15b
SMOKE for the sliding-window shape), port vs reference on the same
weights.

Weights are made by the reference (``jax.random``) and handed to the
port through the weight bridge.  Both packages quantize eagerly, so the
serve-form containers and scales are asserted EQUAL.

The reference forward runs op by op (``jax.disable_jit``).  Under ``jit``
XLA fuses the layer scan, and the fused program rounds some f32 steps
apart from op-by-op execution; one f32 ulp in front of an activation
quantizer can move a value a whole quantization step (1/7 of the range
at 4 bits), so jitted and op-by-op logits of the same reference differ
by tens of percent at this size.  Op by op, the port matches the
reference to f32 rounding on the ``_sdpa`` branch; on the ``_flash``
branch the blockwise attention sums in another order.  Logits are held
to 2e-2 x max|logit| with equal argmax, the slice's stated tolerance,
and the cache's ``kpos`` is asserted EQUAL.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.convert import from_numpy_params  # noqa: E402

ARCH = "qwen3_4b"
LOGIT_TOL = 2e-2         # x max|logit|
FAMILIES = (4, 8)


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


def _smoke(arch):
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = from_numpy_params(np_params, device="cpu")
    return {"jcfg": jcfg, "tcfg": tcfg, "jparams": jparams,
            "np_params": np_params, "tparams": tparams,
            "jq": jlm.quantize_params(jparams, jcfg),      # eager
            "tq": tlm.quantize_params(tparams, tcfg)}


@pytest.fixture(scope="module")
def smoke():
    return _smoke(ARCH)


def _assert_logits(got, want, vocab):
    got, want = _np(got)[..., :vocab], _np(want)[..., :vocab]
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= LOGIT_TOL * scale
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_configs_copy_the_reference():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    for arch in jconfigs.ARCH_IDS:
        for get in ("get", "get_smoke"):
            j = getattr(jconfigs, get)(arch)
            t = getattr(tconfigs, get)(arch)
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
            assert t.padded_vocab == j.padded_vocab
    assert tconfigs.canonical("qwen1.5-110b") == "qwen1_5_110b"
    assert tconfigs.get(ARCH).padded_vocab == 152064
    assert tlm.layer_gemm_dims(tconfigs.get(ARCH)) == \
        jlm.layer_gemm_dims(jconfigs.get(ARCH))
    assert tlm.head_gemm_dims(tconfigs.get(ARCH)) == \
        jlm.head_gemm_dims(jconfigs.get(ARCH))
    assert tlm.n_bit_slots(tconfigs.get(ARCH)) == 36


def test_convert_and_init_layout(smoke):
    """The reference's stacked (L, ...) tree converts leaf for leaf, bf16
    bits intact; the port's own init_params has the same layout."""
    np_leaves = dict(_leaves(smoke["np_params"]))
    t_leaves = dict(_leaves(smoke["tparams"]))
    assert np_leaves.keys() == t_leaves.keys()
    for k, a in np_leaves.items():
        t = t_leaves[k]
        assert t.device.type == "cpu" and tuple(t.shape) == a.shape
        assert t.dtype == torch.bfloat16 and a.dtype.name == "bfloat16"
        np.testing.assert_array_equal(_np(t), a.astype(np.float32))
    own = tlm.init_params(smoke["tcfg"], torch.Generator().manual_seed(0),
                          device="cpu")
    o_leaves = dict(_leaves(own))
    assert o_leaves.keys() == t_leaves.keys()
    for k, t in o_leaves.items():
        assert (t.shape, t.dtype) == (t_leaves[k].shape, t_leaves[k].dtype)
    # the draws follow the reference's scales (Normal(0, d_in^-1/2); wo
    # and wd scaled down as in attn_init / mlp_init)
    cfg = smoke["tcfg"]
    w = own["layers"]["mlp"]["wd"]["w"].float()
    assert abs(w.std().item() / cfg.d_ff ** -0.5 - 1) < 0.1


def test_quantize_params_equal(smoke):
    j = dict(_leaves(jax.tree_util.tree_map(np.asarray, smoke["jq"])))
    t = dict(_leaves(smoke["tq"]))
    assert j.keys() == t.keys()
    assert "/emb" in t and t["/emb"].dtype == torch.bfloat16
    for k in j:
        np.testing.assert_array_equal(_np(t[k]), _np(j[k]), err_msg=k)
        if k.endswith("/q"):
            assert t[k].dtype == torch.int8


def test_norms_rope_masks(rng):
    """Within a few f32 ulps (rsqrt, cos and sin are computed by each
    library's own routines): rtol 1e-6, atol 1e-6, and 1e-5 for RoPE,
    whose angles reach 7 rad; masks EQUAL."""
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    bias = rng.normal(size=(16,)).astype(np.float32)
    tx = torch.from_numpy(x)
    close = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        _np(tcm.rms_norm(tx, torch.from_numpy(scale), 1e-6)),
        _np(jcm.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)), **close)
    np.testing.assert_allclose(
        _np(tcm.layer_norm(tx, torch.from_numpy(scale),
                           torch.from_numpy(bias))),
        _np(jcm.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                           jnp.asarray(bias))), **close)
    pos = np.arange(5, dtype=np.int32)[None] + 3
    np.testing.assert_allclose(
        _np(tcm.rope_frequencies(16, 1e6)),
        _np(jcm.rope_frequencies(16, 1e6)), **close)
    np.testing.assert_allclose(
        _np(tcm.apply_rope(tx, torch.from_numpy(pos), 1e6)),
        _np(jcm.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        rtol=1e-5, atol=1e-5)
    q = np.arange(6, dtype=np.int32)
    for window in (0, 3):
        np.testing.assert_array_equal(
            _np(tcm.causal_mask_bias(torch.from_numpy(q), torch.from_numpy(q),
                                     window)),
            _np(jcm.causal_mask_bias(jnp.asarray(q), jnp.asarray(q), window)))
        pb = np.stack([q, np.where(q < 4, q, jtf.EMPTY_POS)]).astype(np.int32)
        np.testing.assert_array_equal(
            _np(tcm.causal_mask_bias_batched(torch.from_numpy(pb),
                                             torch.from_numpy(pb), window)),
            _np(jcm.causal_mask_bias_batched(jnp.asarray(pb),
                                             jnp.asarray(pb), window)))
    assert ttf.EMPTY_POS == jtf.EMPTY_POS
    assert ttf.FLASH_THRESHOLD == jtf.FLASH_THRESHOLD


def _run_both(smoke, S, wv, decode_steps, seed):
    """Prefill at length S, then ``decode_steps`` teacher-forced steps, on
    both packages; asserts logits and kpos after every call."""
    jcfg, tcfg = smoke["jcfg"], smoke["tcfg"]
    V = jcfg.vocab_size
    g = np.random.default_rng(seed)
    B = wv.shape[0] if wv.ndim == 2 else 2
    toks = g.integers(0, V, (B, S)).astype(np.int32)
    max_len = S + decode_steps + 2
    with jax.disable_jit(), jops.bit_families(FAMILIES):
        jc = jlm.empty_cache(jcfg, B, max_len)
        jlog, jc = jlm.prefill(smoke["jq"], {"tokens": jnp.asarray(toks)},
                               jcfg, jnp.asarray(wv), jnp.asarray(wv), jc)
    with tops.bit_families(FAMILIES):
        tc = tlm.empty_cache(tcfg, B, max_len, device="cpu")
        tlog, tc = tlm.prefill(smoke["tq"], {"tokens": torch.from_numpy(toks)},
                               tcfg, torch.from_numpy(wv),
                               torch.from_numpy(wv), tc)
    assert tlog.shape == (B, 1, jcfg.padded_vocab)
    _assert_logits(tlog, jlog, V)
    np.testing.assert_array_equal(tc["kpos"].numpy(), np.asarray(jc["kpos"]))
    for i in range(decode_steps):
        tok = g.integers(0, V, (B, 1)).astype(np.int32)
        t = np.full((B,), S + i, np.int32)
        with jax.disable_jit(), jops.bit_families(FAMILIES):
            jlog, jc = jlm.decode_step(smoke["jq"], jnp.asarray(tok),
                                       jnp.asarray(t), jc, jcfg,
                                       jnp.asarray(wv), jnp.asarray(wv))
        with tops.bit_families(FAMILIES):
            tlog, tc = tlm.decode_step(smoke["tq"], torch.from_numpy(tok),
                                       torch.from_numpy(t), tc, tcfg,
                                       torch.from_numpy(wv),
                                       torch.from_numpy(wv))
        _assert_logits(tlog, jlog, V)
        np.testing.assert_array_equal(tc["kpos"].numpy(),
                                      np.asarray(jc["kpos"]))
    np.testing.assert_allclose(_np(tc["k"]), _np(jc["k"]), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("wv", [
    np.array([8, 4], np.int32),                   # shared (L,) vector
    np.array([[8, 8], [4, 4]], np.int32),          # per-request rows
], ids=["vector", "per-row"])
def test_prefill_sdpa_branch(smoke, wv):
    """S = 40 <= FLASH_THRESHOLD: the grouped-query ``_sdpa`` branch."""
    _run_both(smoke, 40, wv, decode_steps=0, seed=1)


def test_prefill_flash_branch_then_decode(smoke):
    """S = 2100 > FLASH_THRESHOLD: every layer's attention goes through
    ``_flash`` (the chunked plain version here), then 4 teacher-forced
    decode steps on the bf16 cache, at per-row bits."""
    _run_both(smoke, 2100, np.array([[8, 8], [4, 4]], np.int32),
              decode_steps=4, seed=2)


def test_sliding_window_gelu_layernorm_config():
    """starcoder2-15b SMOKE, the other dense shape: a sliding window of 8
    (the prefill keeps each row's last 8 tokens, decode wraps the ring),
    LayerNorm, GELU MLP, QKV bias and an untied bit-plane logits head."""
    _run_both(_smoke("starcoder2_15b"), 40,
              np.array([[8, 8], [4, 4]], np.int32), decode_steps=2, seed=3)


def test_not_ported_branches_raise(smoke):
    """Every family of the reference is ported; what still raises is the
    reference's own family reasons: per-request bit matrices outside
    PER_ROW_BIT_FAMILIES, ragged prefill and chunked decode outside the
    attention families, a padded length past the masked-SDPA path."""
    tcfg, tq = smoke["tcfg"], smoke["tq"]
    assert set(tlm.PORTED_FAMILIES) == {"dense", "moe", "vlm", "ssm",
                                        "hybrid", "encdec"}
    for fam in ("hybrid", "encdec", "moe"):
        with pytest.raises(NotImplementedError, match=fam):
            tlm._layer_major(torch.full((2, 3), 8), fam, "cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    cache = tlm.empty_cache(tcfg, 1, 8, device="cpu")
    wv = torch.tensor([8, 8])
    # ragged prefill and the chunked decode run for the dense family; a
    # family outside the port, and a padded length past the masked-SDPA
    # path, still raise
    with pytest.raises(NotImplementedError, match="ssm"):
        tlm.prefill(tq, {"tokens": toks}, tcfg.with_(family="ssm"), wv, wv,
                    cache, lengths=[3])
    long = torch.zeros((1, ttf.FLASH_THRESHOLD + 1), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="ragged"):
        tlm.prefill(tq, {"tokens": long}, tcfg, wv, wv, cache, lengths=[3])
    with pytest.raises(NotImplementedError, match="ssm"):
        tlm.decode_chunk(tq, toks, 0, cache, tcfg.with_(family="ssm"), wv,
                         wv)
    lp = tlm._layer(tq["layers"], 0)["attn"]
    x = torch.zeros((1, 3, tcfg.d_model), dtype=tcm.DTYPE)
    pos = torch.arange(3)[None]
    # cross-attention (kv=) is ported: no cache, no RoPE on the given keys
    kv = torch.zeros((1, 5, tcfg.n_kv_heads, tcfg.head_dim), dtype=tcm.DTYPE)
    y, c = ttf.attention(lp, x, tcfg, positions=pos, kv=(kv, kv))
    assert y.shape == x.shape and c is None

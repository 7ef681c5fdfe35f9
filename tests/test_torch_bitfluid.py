"""Bit-fluid ops and the bit-plane GEMM's plain version, port vs reference.

Every integer result is compared bit for bit with ``repro.core.bitfluid``
and ``repro.kernels.ref`` on the same numpy inputs, for bits 1..8 given as
Python ints and as tensors.  On CPU tensors the bit-plane wrapper takes
its plain version and launches nothing."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import bitfluid as jbf  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import bitfluid as tbf  # noqa: E402
from repro_torch.kernels import bitplane_matmul as bpm  # noqa: E402

BITS = list(range(1, 9))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got.numpy()), np.asarray(want))


@pytest.mark.parametrize("as_tensor", [False, True], ids=["int", "tensor"])
@pytest.mark.parametrize("bits", BITS)
def test_quantize_scale_qmax_bit_exact(rng, bits, as_tensor):
    x = (rng.normal(size=(16, 24)) * 3).astype(np.float32)
    tb = torch.tensor(bits, dtype=torch.int32) if as_tensor else bits
    jb = jnp.asarray(bits, jnp.int32) if as_tensor else bits
    _eq(tbf.qmax(tb), jbf.qmax(jb))
    for axis in (None, 0, -2):
        ts = tbf.symmetric_scale(_t(x), tb, axis=axis)
        js = jbf.symmetric_scale(jnp.asarray(x), jb, axis=axis)
        _eq(ts, js)
        _eq(tbf.quantize(_t(x), ts, tb), jbf.quantize(jnp.asarray(x), js, jb))


@pytest.mark.parametrize("from_bits", [8, 4])
@pytest.mark.parametrize("as_tensor", [False, True], ids=["int", "tensor"])
def test_requant_shift_and_effective_scale_bit_exact(rng, from_bits,
                                                     as_tensor):
    lim = 2 ** (from_bits - 1) - 1
    q = np.arange(-lim, lim + 1, dtype=np.int8)           # every value
    q = np.concatenate([q, rng.integers(-lim, lim + 1, 64).astype(np.int8)])
    s = np.abs(rng.normal(size=(1, q.size))).astype(np.float32) + 0.01
    for bits in BITS:
        tb = torch.tensor(bits, dtype=torch.int32) if as_tensor else bits
        jb = jnp.asarray(bits, jnp.int32) if as_tensor else bits
        _eq(tbf.requant_shift(_t(q), tb, from_bits=from_bits),
            jbf.requant_shift(jnp.asarray(q), jb, from_bits=from_bits))
        _eq(tbf.effective_scale(_t(s), tb, from_bits=from_bits),
            jbf.effective_scale(jnp.asarray(s), jb, from_bits=from_bits))


def test_requant_shift_per_row_bits(rng):
    """Bits as a broadcasting tensor (one width per row) match row by row."""
    q = rng.integers(-127, 128, size=(8, 32)).astype(np.int8)
    bits = np.asarray(BITS, np.int32).reshape(8, 1)
    _eq(tbf.requant_shift(_t(q), _t(bits)),
        jbf.requant_shift(jnp.asarray(q), jnp.asarray(bits)))


def test_int4_halves_pack_roundtrip(rng):
    q = rng.integers(-8, 8, size=(6, 10)).astype(np.int8)
    tp = tbf.pack_int4_halves(_t(q))
    jp = jbf.pack_int4_halves(jnp.asarray(q))
    assert tp.dtype == torch.uint8
    _eq(tp, jp)
    _eq(tbf.unpack_int4_halves(tp), jbf.unpack_int4_halves(jp))
    _eq(tbf.unpack_int4_halves(tp), q)
    with pytest.raises(ValueError, match="even"):
        tbf.pack_int4_halves(_t(q[:, :5]))


@pytest.mark.parametrize("bits", [2, 4, 8, 16])
def test_fake_quant_matches_and_passes_gradient(rng, bits):
    x = (rng.normal(size=(8, 12))).astype(np.float32)
    got = tbf.fake_quant(_t(x), bits, axis=0)
    want = jbf.fake_quant(jnp.asarray(x), bits, axis=0)
    _eq(got, want)
    xt = _t(x).requires_grad_(True)
    tbf.fake_quant(xt, bits).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.ones_like(x))


def test_fake_quant_bf16_equals_quantized_value(rng):
    """bf16 input: the forward value is exactly q (rounded once)."""
    x = torch.from_numpy(rng.normal(size=(4, 16)).astype(np.float32)
                         ).to(torch.bfloat16)
    got = tbf.fake_quant(x, 4)
    s = tbf.symmetric_scale(x, 4)
    q = (torch.round(x.float() / s).clamp(-7, 7) * s).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, q)


# ---------------------------------------------------------------------------
# The bit-plane GEMM's plain version
# ---------------------------------------------------------------------------

SHAPES = [(1, 1, 1), (3, 147, 5), (17, 64, 1000 // 8), (5, 33, 7),
          (16, 512, 24)]


@pytest.mark.parametrize("n_planes", BITS)
def test_bitplane_ref_matches_reference(rng, n_planes):
    for M, K, N in SHAPES:
        x = rng.integers(-128, 128, size=(M, K)).astype(np.int8)
        w = rng.integers(-128, 128, size=(K, N)).astype(np.int8)
        got = bpm.bitplane_matmul_ref(_t(x), _t(w), n_planes)
        assert got.dtype == torch.int32
        want = jref.bitplane_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                        n_planes)
        _eq(got, want)
    # the plane-walk identity: sum_j w_j * (x @ plane_j), on the last shape
    walk = jbf.bitplane_matmul_ref(jnp.asarray(x), jnp.asarray(w), n_planes)
    np.testing.assert_array_equal(got.numpy().astype(np.float32),
                                  np.asarray(walk))


def test_bitplane_ref_extreme_accumulator_exact():
    """|acc| reaches K * 128 * 128: exact (an int8 torch.mm would wrap)."""
    K = 4608
    x = torch.full((2, K), -128, dtype=torch.int8)
    w = torch.full((K, 3), -128, dtype=torch.int8)
    got = bpm.bitplane_matmul_ref(x, w, 8)
    assert int(got[0, 0]) == K * 128 * 128


def test_bitplane_wrapper_on_cpu_takes_plain_version(rng):
    bpm.reset_launches()
    x = _t(rng.integers(-128, 128, size=(9, 40)).astype(np.int8))
    w = _t(rng.integers(-128, 128, size=(40, 6)).astype(np.int8))
    for n in BITS:
        assert torch.equal(bpm.bitplane_matmul(x, w, n_planes=n),
                           bpm.bitplane_matmul_ref(x, w, n))
    assert sum(bpm.spec_launches.values()) == 0     # no kernel ran


def test_bitplane_wrapper_rejects_bad_operands():
    x = torch.zeros((4, 8), dtype=torch.int8)
    w = torch.zeros((8, 2), dtype=torch.int8)
    with pytest.raises(TypeError, match="int8"):
        bpm.bitplane_matmul(x.float(), w)
    with pytest.raises(ValueError, match=r"\(M, K\)"):
        bpm.bitplane_matmul(x, w[:7])
    with pytest.raises(ValueError, match="n_planes"):
        bpm.bitplane_matmul(x, w, n_planes=9)
    with pytest.raises(ValueError, match="n_planes"):
        bpm.bitplane_matmul(x, w, n_planes=0)

"""Bit planes, interleaved int4 packing, the fluid int8 matmul and the
plane-walk oracle: ``repro_torch.core.bitfluid`` vs ``repro.core.bitfluid``.

Integers are EQUAL, exhaustively over every int8 value where the domain
is that small.  ``fluid_int8_matmul``'s int32 accumulator (captured
where it leaves ``ops.int8_accum``) EQUALS the reference's dot on the
same quantized operands; its f32 output is within 1 ulp of the
reference's (the same three f32 products, which XLA may contract
differently), and EQUAL between Python-int and 0-d-tensor bits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import bitfluid as jbf  # noqa: E402
from repro_torch.core import bitfluid as bf  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

ALL_INT8 = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("bits", range(1, 9))
def test_bitplanes_round_trip_exhaustive(bits):
    q = _t(ALL_INT8)
    planes = bf.bitplanes(q, bits)
    assert planes.dtype == torch.int8 and tuple(planes.shape) == (bits, 16,
                                                                  16)
    np.testing.assert_array_equal(planes.numpy(),
                                  np.asarray(jbf.bitplanes(ALL_INT8, bits)))
    np.testing.assert_array_equal(bf.plane_weights(bits).numpy(),
                                  np.asarray(jbf.plane_weights(bits)))
    back = bf.from_bitplanes(planes, bits)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jbf.from_bitplanes(jnp.asarray(
            planes.numpy()), bits)))
    # the low `bits` field, sign-extended: q itself when it fits
    field = ALL_INT8.astype(np.int32) & ((1 << bits) - 1)
    want = np.where(field >= 1 << (bits - 1), field - (1 << bits), field)
    np.testing.assert_array_equal(back.numpy(), want.astype(np.int8))


def test_pack_int4_bytes_equal_exhaustive():
    vals = np.arange(-8, 8, dtype=np.int8)
    q = np.stack(np.meshgrid(vals, vals), -1).reshape(16, 32)  # every pair
    packed = bf.pack_int4(_t(q))
    assert packed.dtype == torch.uint8 and tuple(packed.shape) == (16, 16)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jbf.pack_int4(q)))
    np.testing.assert_array_equal(bf.unpack_int4(packed).numpy(), q)
    np.testing.assert_array_equal(
        bf.unpack_int4(packed).numpy(),
        np.asarray(jbf.unpack_int4(jnp.asarray(packed.numpy()))))
    # interleaved, not the half-split container
    assert not torch.equal(packed, bf.pack_int4_halves(_t(q)))
    with pytest.raises(ValueError):
        bf.pack_int4(_t(q[:, :3]))


def test_dequantize_equal():
    q = ALL_INT8
    s = np.float32(0.0137)
    np.testing.assert_array_equal(
        bf.dequantize(_t(q), torch.tensor(s)).numpy(),
        np.asarray(jbf.dequantize(q, s)))


def _operands(seed, lead=(3, 5), K=48, N=20):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(lead + (K,)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    ws = np.asarray(jbf.symmetric_scale(w, 8, axis=0))
    qw = np.asarray(jbf.quantize(w, ws, 8))
    return x, qw, ws


@pytest.mark.parametrize("wbits", range(1, 9))
@pytest.mark.parametrize("abits", [4, 8])
def test_fluid_int8_matmul_equals_reference(monkeypatch, wbits, abits):
    x, qw, ws = _operands(wbits + 10 * abits)
    accs = []
    real = ops.int8_accum

    def spy(x_q, w_q, **kw):
        accs.append(real(x_q, w_q, **kw))
        return accs[-1]

    monkeypatch.setattr(ops, "int8_accum", spy)
    outs = [bf.fluid_int8_matmul(_t(x), _t(qw), _t(ws), wbits=b, abits=a)
            for b, a in ((wbits, abits),
                         (torch.tensor(wbits), torch.tensor(abits)))]
    want = np.asarray(jbf.fluid_int8_matmul(x, qw, ws, wbits=wbits,
                                            abits=abits))
    # the reference's int32 dot on its own quantized operands
    xs = jbf.symmetric_scale(x, abits)
    jacc = jax.lax.dot_general(
        jbf.quantize(x, xs, abits), jbf.requant_shift(qw, wbits),
        dimension_numbers=(((2,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)
    for acc in accs:
        assert acc.dtype == torch.int32
        np.testing.assert_array_equal(acc.numpy().reshape(jacc.shape),
                                      np.asarray(jacc))
    assert torch.equal(outs[0], outs[1])
    assert outs[0].shape == want.shape and outs[0].dtype == torch.float32
    np.testing.assert_array_max_ulp(outs[0].numpy(), want, maxulp=1)


@pytest.mark.parametrize("wbits", range(1, 9))
def test_bitplane_matmul_ref_equals_reference(wbits):
    rng = np.random.default_rng(wbits)
    x_q = rng.integers(-128, 128, (7, 40)).astype(np.int8)
    qw = rng.integers(-128, 128, (40, 9)).astype(np.int8)
    got = bf.bitplane_matmul_ref(_t(x_q), _t(qw), wbits)
    want = np.asarray(jbf.bitplane_matmul_ref(x_q, qw, wbits))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the identity the kernel exploits: x_q @ sign-extended low field
    planes = bf.from_bitplanes(bf.bitplanes(_t(qw), wbits), wbits)
    np.testing.assert_array_equal(
        got.numpy(), x_q.astype(np.int64) @ planes.numpy().astype(np.int64))

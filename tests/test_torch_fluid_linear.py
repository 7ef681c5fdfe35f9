"""``ops.fluid_linear`` and the row-dispatch switch, port vs reference.

``fluid_linear`` at every static wbits 1..8: the int32 accumulator the
port's ``ops.int8_accum`` returns EQUALS the one the reference's
``ops.bitplane_matmul`` returns under ``fluid_linear(interpret=True)``
(the Pallas kernel in interpret mode) on the same inputs; the f32
outputs are within 1 ulp (the same two f32 products, which XLA may
contract differently).  The ``"vmap"`` per-row baseline EQUALS the
grouped path on int8 and packed-int4 containers, and both EQUAL the
reference's (the counterpart of ``test_grouped_dispatch_matches_vmap_
oracle``).  The port's vmap rows reach the GEMM once per row, the
grouped path once per family.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import bitfluid as jbf  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro_torch.core import bitfluid as bf  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models.convert import from_numpy_params  # noqa: E402


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*a, **kw):
        out = real(*a, **kw)
        calls.append((kw, out))
        return out

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("wbits", range(1, 9))
def test_fluid_linear_equals_reference(monkeypatch, rng, wbits):
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 40)) * 0.05).astype(np.float32)
    ws = np.asarray(jbf.symmetric_scale(jnp.asarray(w), 8, axis=0))
    qw = np.asarray(jbf.quantize(jnp.asarray(w), ws, 8))
    jcalls = _spy(monkeypatch, jops, "bitplane_matmul")
    tcalls = _spy(monkeypatch, ops, "int8_accum")
    want = np.asarray(jops.fluid_linear(jnp.asarray(x), qw, ws, wbits=wbits,
                                        interpret=True))
    got = ops.fluid_linear(torch.from_numpy(x), torch.from_numpy(qw),
                           torch.from_numpy(ws), wbits=wbits)
    (jkw, jacc), = jcalls
    (tkw, tacc), = tcalls
    assert jkw["n_planes"] == wbits and tkw["planes"] == wbits
    assert tacc.dtype == torch.int32
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)


def test_fluid_linear_truncates_not_requantizes(rng):
    """The container's high planes are masked: at wbits 4 the product is
    x_q @ (the sign-extended low 4-bit field), not serve_linear's dyadic
    requant."""
    x = torch.from_numpy(rng.normal(size=(5, 32)).astype(np.float32))
    qw = torch.from_numpy(rng.integers(-128, 128, (32, 8)).astype(np.int8))
    ws = torch.full((1, 8), 0.01)
    got = ops.fluid_linear(x, qw, ws, wbits=4)
    xs = bf.symmetric_scale(x, 8)
    x_q = bf.quantize(x, xs, 8)
    field = bf.from_bitplanes(bf.bitplanes(qw, 4), 4)
    acc = x_q.long() @ field.long()
    torch.testing.assert_close(got, acc.float() * xs * ws, rtol=0, atol=0)


def _container(rng, container, K=64, N=48):
    w = (rng.normal(size=(K, N)) * 0.1).astype(np.float32)
    b = rng.normal(size=(N,)).astype(np.float32)
    jp = jcm.quantize_linear({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                             container)
    return jp, from_numpy_params({k: np.asarray(v) for k, v in jp.items()},
                                 device="cpu")


@pytest.mark.parametrize("container", ["int8", "int4"])
@pytest.mark.parametrize("seq", [1, 4])
def test_vmap_equals_grouped_and_reference(monkeypatch, rng, container, seq):
    jp, tp = _container(rng, container)
    x = rng.normal(size=(6, seq, 64)).astype(np.float32)
    wb = [2, 4, 8, 8, 4, 2]
    ab = [8, 8, 4, 8, 2, 8]
    with jops.row_dispatch("vmap"):
        want = np.asarray(jcm.apply_linear(
            jp, jnp.asarray(x), jnp.asarray(wb, jnp.int32),
            jnp.asarray(ab, jnp.int32)), np.float32)
    calls = _spy(monkeypatch, ops, "int8_accum")
    xt = torch.from_numpy(x)
    wt, at = torch.tensor(wb), torch.tensor(ab)
    grouped = cm.apply_linear(tp, xt, wt, at)
    n_grouped = len(calls)
    with ops.row_dispatch("vmap"):
        assert ops.get_row_dispatch() == "vmap"
        vmap = cm.apply_linear(tp, xt, wt, at)
    assert ops.get_row_dispatch() == "grouped"
    assert torch.equal(vmap, grouped)
    np.testing.assert_array_equal(vmap.float().numpy(), want)
    # grouped: one GEMM per distinct family (collapsed at the container
    # width); vmap: one per row, at the container width (tensor bits)
    fams = {min(f, 4 if container == "int4" else 8)
            for f in ops.get_bit_families()}
    assert n_grouped == len(fams)
    assert len(calls) - n_grouped == len(wb)
    assert all(kw.get("planes") is None for kw, _ in calls[n_grouped:])


@pytest.mark.parametrize("container", ["int8", "int4"])
def test_vmap_equals_grouped_scalar_abits(rng, container):
    _, tp = _container(rng, container)
    x = torch.from_numpy(rng.normal(size=(4, 2, 64)).astype(np.float32))
    wb = torch.tensor([3, 4, 6, 8])
    grouped = ops.serve_linear(tp, x, wb, 8)
    with ops.row_dispatch("vmap"):
        vmap = ops.serve_linear(tp, x, wb, 8)
    assert torch.equal(vmap, grouped)


def test_row_dispatch_mode_checks_and_restores():
    assert ops.get_row_dispatch() == "grouped"
    with pytest.raises(ValueError):
        ops.set_row_dispatch("loop")
    assert ops.get_row_dispatch() == "grouped"
    with pytest.raises(RuntimeError):
        with ops.row_dispatch("vmap"):
            assert ops.get_row_dispatch() == "vmap"
            raise RuntimeError("inside")
    assert ops.get_row_dispatch() == "grouped"
    ops.set_row_dispatch("vmap")
    try:
        assert ops.get_row_dispatch() == "vmap"
    finally:
        ops.set_row_dispatch("grouped")

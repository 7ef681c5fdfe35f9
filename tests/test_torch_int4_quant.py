"""The packed-int4 and fused-epilogue GEMMs, port vs reference.

The port's plain versions (what a CPU tensor runs; the oracles the CUDA
kernels are held against on the card) against the JAX package's Pallas
kernels in interpret mode at the shapes of ``tests/test_kernels.py``, and
against its XLA refs at ragged shapes (K = 363, N = 96, N = 1000: the
fixed-INT4 AlexNet forward's conv1 and fc8), where the reference's own
dispatch takes the ref.  Integer products are exact on both sides.

The fused epilogue ``act(f32(acc) * scale + bias)`` rounds the multiply
and the add separately in the port, as the reference's ops do one by one
and as the CUDA kernel does (``__fmul_rn``, ``__fadd_rn``).  XLA on the
CPU contracts the two into one FMA when it compiles the interpret-mode
kernel body, so there the f32 output may sit one rounding apart: within
ulp(|f32(acc) * scale|) + ulp(|out|).  silu and gelu also differ in
exp/tanh by a few ulps between libraries, and which ulps depends on the
host, so each package is held against a float64 evaluation of the same
formula on the same f32 pre-activation, within its own library's error
(``_assert_act_close``).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import bitfluid as jbf  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import bitfluid as bf  # noqa: E402
from repro_torch.kernels import int4_matmul as i4mm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quant_matmul as qmm  # noqa: E402

# silu / gelu, |out - exact| <= TOL * (1 + |y|), y the pre-activation and
# exact the float64 value of the same formula at that f32 y (see
# _assert_act_close): f32 output a few f32 ulps of exp/tanh (the port's
# measured worst 5.8e-8 of 1 + |y|); bf16 output one bf16 ulp (2^-7
# relative, where the last f32 bits decide the rounding)
TOL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -7}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np(a):
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _int4_operands(rng, M, K, N):
    x = rng.integers(-127, 128, (M, K)).astype(np.int8)
    q4 = rng.integers(-8, 8, (K, N)).astype(np.int8)
    packed = np.array(jbf.pack_int4_halves(jnp.asarray(q4)))
    np.testing.assert_array_equal(
        bf.pack_int4_halves(torch.from_numpy(q4)).numpy(), packed)
    s = rng.uniform(0.001, 0.05, (1, N)).astype(np.float32)
    return x, q4, packed, s


@pytest.mark.parametrize("shape", [(128, 128, 256), (128, 256, 512)])
def test_int4_plain_equals_interpret_kernel(rng, shape):
    x, q4, packed, s = _int4_operands(rng, *shape)
    want = jops.int4_matmul(jnp.asarray(x), jnp.asarray(packed),
                            jnp.asarray(s), interpret=True)
    got = ops.int4_matmul(torch.from_numpy(x), torch.from_numpy(packed),
                          torch.from_numpy(s))
    assert got.dtype == torch.float32 and got.shape == (shape[0], shape[2])
    np.testing.assert_array_equal(_np(got), _np(want))
    exact = (x.astype(np.int64) @ q4.astype(np.int64)).astype(np.float32) * s
    np.testing.assert_array_equal(_np(got), exact)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 363, 96), (16, 4096, 1000),
                                   (130, 17, 2), (1, 1, 130)])
def test_int4_ragged_equals_reference(rng, shape, out_dtype):
    """Shapes whose halves' seam falls inside a tile, and K that no
    16-byte load covers: the reference dispatch takes its XLA ref."""
    x, _, packed, s = _int4_operands(rng, *shape)
    want = jops.int4_matmul(jnp.asarray(x), jnp.asarray(packed),
                            jnp.asarray(s), out_dtype=JDT[out_dtype])
    got = ops.int4_matmul(torch.from_numpy(x), torch.from_numpy(packed),
                          torch.from_numpy(s), out_dtype=out_dtype)
    assert got.dtype == out_dtype
    np.testing.assert_array_equal(_np(got), _np(want))


def test_int4_scalar_scale_broadcasts(rng):
    x, _, packed, _ = _int4_operands(rng, 8, 64, 32)
    want = jops.int4_matmul(jnp.asarray(x), jnp.asarray(packed), 0.5)
    got = ops.int4_matmul(torch.from_numpy(x), torch.from_numpy(packed), 0.5)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_int4_bad_shapes_raise(rng):
    x = torch.from_numpy(rng.integers(-10, 10, (8, 64)).astype(np.int8))
    with pytest.raises(ValueError, match="K"):
        ops.int4_matmul(x, torch.zeros((32, 16), dtype=torch.uint8),
                        torch.ones((1, 32)))
    with pytest.raises(ValueError, match="scale"):
        ops.int4_matmul(x, torch.zeros((64, 16), dtype=torch.uint8),
                        torch.ones((1, 7)))
    with pytest.raises(TypeError, match="uint8"):
        i4mm.int4_matmul(x, torch.zeros((64, 16), dtype=torch.int8),
                         torch.ones((1, 32)))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        i4mm.int4_matmul(x, torch.zeros((64, 16), dtype=torch.uint8),
                         torch.ones((1, 32)), out_dtype=torch.float16)


def _quant_operands(rng, M, K, N):
    x = rng.integers(-127, 128, (M, K)).astype(np.int8)
    w = rng.integers(-127, 128, (K, N)).astype(np.int8)
    s = rng.uniform(0.001, 0.05, (1, N)).astype(np.float32)
    b = rng.normal(size=(1, N)).astype(np.float32)
    return x, w, s, b


def _one_rounding_apart(got, want, x, w, s):
    """|got - want| <= ulp(|f32(acc) * s|) + ulp(|want|): an FMA against
    a rounded multiply followed by a rounded add."""
    prod = (x.astype(np.int64) @ w.astype(np.int64)).astype(np.float32) * s
    bound = np.spacing(np.abs(prod)) + np.spacing(np.abs(want))
    assert np.all(np.abs(got - want) <= bound)


def _gate(act, y):
    """The activation's gate c in ``y * c(y)``, by the formula
    ``jax.nn.silu`` / ``jax.nn.gelu`` (tanh form) evaluate; ``y`` a numpy
    or jax array, computed in that array's library and precision."""
    lib = np if isinstance(y, np.ndarray) else jnp
    if act == "silu":
        return 1 / (1 + lib.exp(-y))
    return 0.5 * (1 + lib.tanh(math.sqrt(2 / math.pi)
                               * (y + 0.044715 * y ** 3)))


# XLA's f32 gate (exp for silu, tanh for gelu, with the f32 rounding of
# its argument) against the float64 formula, absolute: a stated bound of
# 8 units of 2^-24.  _xla_gate_error(act, np.zeros(0, np.float32),
# np.linspace(-40, 40, 8_000_001, dtype=np.float32)) gave at worst 1.5
# units for silu and 3.5 for gelu at XLA's default, AVX and SSE4_2 ISAs
# (XLA_FLAGS=--xla_cpu_max_isa=...).  The test checks the bound on the
# host that runs it, and the reference is held to the stated bound, not
# to what one compiled copy of the formula measures.
GATE_ERR = 8 * 2.0 ** -24


def _xla_gate_error(act, y, grid=np.linspace(-12, 12, 1_000_001,
                                               dtype=np.float32)):
    """Max |c_XLA(y) - c(y)| over the test's f32 ``y`` and a dense grid
    (by default y in [-12, 12], past which both gates are 0 or 1 to f32),
    with XLA's c evaluated op by op and compiled, and c(y) in float64;
    asserted within GATE_ERR."""
    ys = np.concatenate([y.ravel(), grid])
    exact = _gate(act, ys.astype(np.float64))
    jy = jnp.asarray(ys)
    with jax.disable_jit():
        eager = np.asarray(_gate(act, jy), np.float64)
    jitted = np.asarray(jax.jit(lambda v: _gate(act, v))(jy), np.float64)
    err = max(np.abs(eager - exact).max(), np.abs(jitted - exact).max())
    assert err <= GATE_ERR, (
        f"XLA's {act} gate is {err!r} from float64 here, past the stated "
        f"{GATE_ERR!r}")
    return err


# ATen's f32 gate, as the port's plain epilogue computes it
# (``qmm.gate``: torch.sigmoid for silu, torch.tanh for gelu), against the
# float64 formula, absolute: the same stated bound as XLA's.  ATen picks
# its exp and tanh kernels by the host's vector ISA, so the port's side
# is held like the reference's: its gate's error is measured on the host
# that runs the test, over the test's own y and a dense grid, asserted
# within ATEN_GATE_ERR, and the bound adds |y| x ATEN_GATE_ERR.
ATEN_GATE_ERR = 8 * 2.0 ** -24


def _aten_gate_error(act, y, grid=np.linspace(-12, 12, 1_000_001,
                                                dtype=np.float32)):
    """Max |c_ATen(y) - c(y)| over the test's f32 ``y`` and the grid, with
    c(y) in float64; asserted within ATEN_GATE_ERR.  On failure the
    message names the worst y, the thread count and the ATen ISA."""
    ys = np.concatenate([y.ravel(), grid])
    err = np.abs(qmm.gate(torch.from_numpy(ys), act).numpy()
                 .astype(np.float64) - _gate(act, ys.astype(np.float64)))
    i = int(np.argmax(err))
    assert err[i] <= ATEN_GATE_ERR, (
        f"ATen's {act} gate is {err[i]!r} from float64 at y {ys[i]!r}, past "
        f"the stated {ATEN_GATE_ERR!r} ({torch.get_num_threads()} threads, "
        f"{torch.backends.cpu.get_cpu_capability()})")
    return float(err[i])


def _assert_act_close(got, y, tol, label, *, gate_err=0.0, acc_s=None,
                      act="gelu"):
    """silu / gelu outputs against float64 within their own library's error.

    Both activations are ``y * c(y)`` with a gate c in [0, 1]: sigmoid for
    silu, ``0.5 * (1 + tanh(u))`` for the tanh-form gelu.  ``exact`` is
    that formula in float64 at the same f32 ``y``.  A library's exp and
    tanh are accurate to a few ulps of numbers of size 1, and which ulps
    depends on the library and the host: XLA's CPU tanh rounds differently
    when it may use fewer vector instructions (``--xla_cpu_max_isa=AVX``)
    and ATen picks its own kernels, so two libraries' outputs were never a
    fixed distance apart.  An error delta in c becomes ``|y| * delta`` in
    the output, and for a negative y of a few units the gate cancels
    (``1 + tanh(u)`` near 0), so the output is tiny while that error is
    not; the bound follows that conditioning, ``tol * (1 + |y|)``, plus
    ``|y| * gate_err`` (the library's stated gate error, checked on this
    host: GATE_ERR by ``_xla_gate_error`` for the reference,
    ATEN_GATE_ERR by ``_aten_gate_error`` for the port) and, for the
    reference,
    ``1.13 * ulp(|acc * s|)`` when XLA contracts ``acc * s + b`` into an
    FMA (``acc_s``; gelu's slope is at most 1.13, silu's 1.1).  On failure
    the worst element is named."""
    y64 = y.astype(np.float64)
    exact = y64 * _gate(act, y64)
    bound = tol * (1 + np.abs(y64)) + np.abs(y64) * gate_err
    if acc_s is not None:
        bound = bound + 1.13 * 2.0 ** -23 * np.abs(acc_s)
    ratio = np.abs(got - exact) / bound
    i = np.unravel_index(int(np.argmax(ratio)), ratio.shape)
    assert ratio[i] <= 1, (
        f"{label}: worst element {i}: y {y[i]!r}, exact {exact[i]!r}, got "
        f"{got[i]!r}, |got - exact| {abs(got[i] - exact[i])!r} > bound "
        f"{bound[i]!r} (tol {tol}, gate error {gate_err!r})")


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", qmm.ACTS)
def test_quant_plain_against_reference(rng, act, out_dtype):
    x, w, s, b = _quant_operands(rng, 128, 256, 128)
    jargs = [jnp.asarray(a) for a in (x, w, s, b)]
    interp = _np(jops.quant_matmul(*jargs, act=act,
                                   out_dtype=JDT[out_dtype], interpret=True))
    with jax.disable_jit():                 # the reference op by op
        eager = _np(jref.quant_matmul_ref(*jargs, act, JDT[out_dtype]))
    got = ops.quant_matmul(*[torch.from_numpy(a) for a in (x, w, s, b)],
                           act=act, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (128, 128)
    got = _np(got)
    if act in ("none", "relu"):
        np.testing.assert_array_equal(got, eager)
        if out_dtype == torch.bfloat16:
            np.testing.assert_array_equal(got, interp)
        else:
            _one_rounding_apart(got, interp, x, w, s)
    else:
        acc = (x.astype(np.int64) @ w.astype(np.int64)).astype(np.float32)
        y = acc * s + b                     # f32, rounded as the port does
        tol = TOL[out_dtype]
        _aten_gate_error(act, y)
        _assert_act_close(got, y, tol, "port", act=act,
                          gate_err=ATEN_GATE_ERR)
        _xla_gate_error(act, y)
        for label, want in (("eager", eager), ("interpret", interp)):
            _assert_act_close(want, y, tol, f"reference {label}", act=act,
                              gate_err=GATE_ERR, acc_s=acc * s)


@pytest.mark.parametrize("shape", [(16, 363, 96), (16, 4096, 1000),
                                   (3, 17, 7)])
def test_quant_ragged_equals_reference(rng, shape):
    x, w, s, b = _quant_operands(rng, *shape)
    for act in ("none", "relu"):
        with jax.disable_jit():
            want = jops.quant_matmul(*[jnp.asarray(a) for a in (x, w, s, b)],
                                     act=act)
        got = ops.quant_matmul(*[torch.from_numpy(a) for a in (x, w, s, b)],
                               act=act)
        np.testing.assert_array_equal(_np(got), _np(want))


def test_quant_defaults_and_bad_arguments(rng):
    x, w, s, _ = _quant_operands(rng, 4, 32, 8)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    with jax.disable_jit():
        want = jops.quant_matmul(jnp.asarray(x), jnp.asarray(w), 0.01)
    np.testing.assert_array_equal(_np(ops.quant_matmul(tx, tw, 0.01)),
                                  _np(want))
    with pytest.raises(ValueError, match="act"):
        ops.quant_matmul(tx, tw, torch.from_numpy(s), act="tanh")
    with pytest.raises(ValueError, match="scale"):
        qmm.quant_matmul(tx, tw, torch.ones((1, 7)), torch.zeros((1, 8)))
    with pytest.raises(ValueError, match=r"\(M, K\) @ \(K, N\)"):
        ops.quant_matmul(tx, tw[:16], torch.from_numpy(s))


def _int4_layer(rng, K, N):
    w = (rng.normal(size=(K, N)) * K ** -0.5).astype(np.float32)
    s = bf.symmetric_scale(torch.from_numpy(w), 4, axis=-2)
    q4 = bf.pack_int4_halves(bf.quantize(torch.from_numpy(w), s, 4))
    b = torch.from_numpy(rng.normal(size=(N,)).astype(np.float32))
    return q4, s, b


@pytest.mark.parametrize("wbits", [4, 8])
def test_int4_linear_packed_branch_equals_unpacked(rng, monkeypatch, wbits):
    """Static wbits >= 4: the packed branch (one int4_matmul call) equals
    the unpacked container path exactly, and the reference's own
    int4_linear on the same container."""
    q4, s, b = _int4_layer(rng, 40, 24)
    x = torch.from_numpy(rng.normal(size=(3, 5, 40)).astype(np.float32))
    calls = []
    real = ops.int4_matmul
    monkeypatch.setattr(ops, "int4_matmul",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = ops.int4_linear(x, q4, s, b, wbits=wbits, abits=8)
    assert len(calls) == 1
    unpacked = ops._container_linear(x, bf.unpack_int4_halves(q4), s, b,
                                     from_bits=4, wbits=wbits, abits=8)
    assert len(calls) == 1
    np.testing.assert_array_equal(got.numpy(), unpacked.numpy())
    want = jops.int4_linear(jnp.asarray(x.numpy()), jnp.asarray(q4.numpy()),
                            jnp.asarray(s.numpy()), jnp.asarray(b.numpy()),
                            wbits=wbits, abits=8, interpret=True)
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("wbits", [2, "tensor"])
def test_int4_linear_other_bits_unpack(rng, monkeypatch, wbits):
    """wbits = 2 (requant below the container) and tensor bits (no static
    width) take the unpacked container path, never the packed kernel."""
    q4, s, b = _int4_layer(rng, 40, 24)
    x = torch.from_numpy(rng.normal(size=(6, 40)).astype(np.float32))
    wb = torch.tensor(4, dtype=torch.int32) if wbits == "tensor" else wbits
    monkeypatch.setattr(ops, "int4_matmul",
                        lambda *a, **k: pytest.fail("packed branch taken"))
    got = ops.serve_linear({"q4": q4, "s": s, "b": b}, x, wb, 8)
    want = jops.serve_linear(
        {"q4": jnp.asarray(q4.numpy()), "s": jnp.asarray(s.numpy()),
         "b": jnp.asarray(b.numpy())}, jnp.asarray(x.numpy()),
        jnp.asarray(4, jnp.int32) if wbits == "tensor" else wbits, 8)
    np.testing.assert_array_equal(got.numpy(), _np(want))


# ---------------------------------------------------------------------------
# The two kernels' host-side plan (the bit-plane kernel's, shared; N in
# logical columns): the regime, the split of K, the scratch
# ---------------------------------------------------------------------------

# AlexNet@227 at B=16: conv1 .. conv5 (grouped convs per group), fc6 .. fc8
ALEX_SHAPES = [(48400, 363, 96), (11664, 1200, 128), (2704, 2304, 384),
               (2704, 1728, 192), (2704, 1728, 128), (16, 9216, 4096),
               (16, 4096, 4096), (16, 4096, 1000)]
PLANS = {"quant": qmm, "int4": i4mm}


@pytest.mark.parametrize("kernel", sorted(PLANS))
@pytest.mark.parametrize("M,K,N", ALEX_SHAPES)
def test_plan_at_the_alexnet_path_shapes(kernel, M, K, N):
    from repro_torch.kernels import bitplane_matmul as bpm
    p = PLANS[kernel].plan(M, K, N)
    if M <= 16:
        assert p.regime == "small_m" and p.path == "small_m"
        assert p.splits * p.steps * 32 >= K > (p.splits - 1) * p.steps * 32
        assert p.scratch_bytes(M, N) == 0
        assert p.partial_bytes(M, N) == (4 * M * N if p.splits > 1 else 0)
        # the wrapper's scratch: the int32 partial, one counter per slab
        s = bpm.alloc_scratch(p, M, N, "cpu", partials=True)
        assert s.numel() == 4 * M * N + 4 * -(-N // 128)
        return
    assert p.regime == "large_m" and p.partial_bytes(M, N) == 0
    k_pad = -(-K // 16) * 16
    assert p.k_pad == k_pad and p.copy_x == (K % 16 != 0)
    assert p.scratch_bytes(M, N) == N * k_pad + (M * k_pad if p.copy_x
                                                 else 0)
    assert bpm.alloc_scratch(p, M, N, "cpu", partials=True).numel() == \
        p.scratch_bytes(M, N)


@pytest.mark.parametrize("kernel", sorted(PLANS))
@pytest.mark.parametrize("M", [1, 16, 17, 64])
def test_plan_regime_threshold(kernel, M):
    p = PLANS[kernel].plan(M, 9216, 4096)
    assert p.regime == ("small_m" if M <= 16 else "large_m")


@pytest.mark.parametrize("kernel", sorted(PLANS))
def test_plan_copy_x_unaligned_and_empty(kernel):
    plan = PLANS[kernel].plan
    assert plan(48400, 363, 96).copy_x              # conv1: K = 363
    aligned, moved = plan(2704, 2304, 384), plan(2704, 2304, 384,
                                                 x_aligned=False)
    assert not aligned.copy_x and moved.copy_x and moved.path == \
        "large_m_copy_x"
    assert moved.scratch_bytes(2704, 384) == (384 + 2704) * 2304
    assert not plan(16, 363, 96, x_aligned=False).copy_x   # the GEMV
    with pytest.raises(ValueError, match="empty"):
        plan(0, 64, 64)


def test_plan_paths_of_the_int4_forward_and_the_gemm_set():
    """The launches by path chip_smoke.py expects: the fixed-INT4 forward
    (b) runs int4_matmul on the five ungrouped layers, (c) quant_matmul on
    all eleven GEMMs (grouped convs per group)."""
    groups = [1, 2, 1, 2, 2, 1, 1, 1]

    def count(plan, shapes):
        out = {"small_m": 0, "large_m": 0, "large_m_copy_x": 0}
        for M, K, N in shapes:
            out[plan(M, K, N).path] += 1
        return out

    ungrouped = [s for s, g in zip(ALEX_SHAPES, groups) if g == 1]
    assert count(i4mm.plan, ungrouped) == {
        "small_m": 3, "large_m": 1, "large_m_copy_x": 1}
    every = [s for s, g in zip(ALEX_SHAPES, groups) for _ in range(g)]
    assert count(qmm.plan, every) == {
        "small_m": 3, "large_m": 7, "large_m_copy_x": 1}

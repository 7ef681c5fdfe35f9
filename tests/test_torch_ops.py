"""The serve-form dispatch, port vs reference, bit for bit.

``serve_linear`` with scalar (Python int and 0-d tensor) and ``(B,)``
per-row bits, int8 and packed-int4 containers, wbits in {2, 4, 8}, and
family snap-up / clamp-down.  Besides the float32 outputs, every GEMM's
int8 activations, requantized weights and int32 accumulators are recorded
on both sides (by wrapping each package's ``int8_accum``, and the port's
``int4_matmul``, which a packed-int4 container at a Python-int width of 4
or more reaches) and compared exactly; so is one conv layer's im2col and
accumulator."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.apsim.workloads import conv  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro_torch.core import bitfluid as bf  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models.convert import from_numpy_params  # noqa: E402


def _np(a):
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


@pytest.fixture
def record(monkeypatch):
    """Wrap both packages' int8_accum; returns the two call logs."""
    logs = {"jax": [], "torch": []}

    def wrap(mod, key):
        real = mod.int8_accum

        def rec(x_q, w_q, **kw):
            acc = real(x_q, w_q, **kw)
            logs[key].append((_np(x_q), _np(w_q), kw.get("planes"),
                              _np(acc)))
            return acc
        monkeypatch.setattr(mod, "int8_accum", rec)

    wrap(jops, "jax")
    wrap(tops, "torch")
    real4 = tops.int4_matmul

    def rec4(x_q, w_packed, scale, **kw):
        out = real4(x_q, w_packed, scale, **kw)
        # the packed branch runs with a ones scale: out is f32(acc)
        logs["torch"].append((_np(x_q), _np(bf.unpack_int4_halves(w_packed)),
                              "packed", _np(out.to(torch.int32))))
        return out
    monkeypatch.setattr(tops, "int4_matmul", rec4)
    return logs


def _same_calls(logs, packed=False):
    """The calls match; ``packed``: the port took int4_linear's packed
    branch where the reference (off the TPU) ran the unpacked container
    path, on the same int8 activations, weights and accumulators."""
    assert len(logs["jax"]) == len(logs["torch"]) > 0
    for (jx, jw, jp, ja), (tx, tw, tp, ta) in zip(logs["jax"],
                                                  logs["torch"]):
        assert tp == ("packed" if packed else jp)
        assert tx.dtype == np.int8 and tw.dtype == np.int8
        assert ta.dtype == np.int32
        np.testing.assert_array_equal(tx, jx)       # int8 activations
        np.testing.assert_array_equal(tw, jw)       # requantized weights
        np.testing.assert_array_equal(ta, ja)       # int32 accumulators


def _params(rng, K, N, container):
    w = (rng.normal(size=(K, N)) * K ** -0.5).astype(np.float32)
    b = rng.normal(size=(N,)).astype(np.float32)
    jp = jcm.quantize_linear({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                             container)
    tp = tcm.quantize_linear({"w": torch.from_numpy(w),
                              "b": torch.from_numpy(b)}, container)
    for k in jp:
        np.testing.assert_array_equal(_np(tp[k]), _np(jp[k]))
    return jp, tp


@pytest.mark.parametrize("container", ["int8", "int4"])
@pytest.mark.parametrize("wbits", [2, 4, 8])
@pytest.mark.parametrize("form", ["int", "tensor"])
def test_serve_linear_scalar_bits(rng, record, container, wbits, form):
    jp, tp = _params(rng, 48, 20, container)
    x = rng.normal(size=(3, 5, 48)).astype(np.float32)
    abits = 8 if form == "int" else 4
    if form == "int":
        jw, ja, tw, ta = wbits, abits, wbits, abits
    else:
        jw, ja = jnp.asarray(wbits, jnp.int32), jnp.asarray(abits, jnp.int32)
        tw, ta = (torch.tensor(wbits, dtype=torch.int32),
                  torch.tensor(abits, dtype=torch.int32))
    got = tops.serve_linear(tp, torch.from_numpy(x), tw, ta)
    want = jops.serve_linear(jp, jnp.asarray(x), jw, ja)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_np(got), _np(want))
    _same_calls(record, packed=container == "int4" and form == "int"
                and wbits >= 4)


@pytest.mark.parametrize("container", ["int8", "int4"])
@pytest.mark.parametrize("fams", [(2, 3, 4, 6, 8), (4, 8)],
                         ids=["default-families", "families-4-8"])
def test_serve_linear_per_row_bits(rng, record, container, fams):
    jp, tp = _params(rng, 40, 12, container)
    x = rng.normal(size=(4, 3, 40)).astype(np.float32)
    wb = np.asarray([2, 4, 8, 4], np.int32)
    ab = np.asarray([8, 4, 8, 6], np.int32)
    with jops.bit_families(fams), tops.bit_families(fams):
        got = tops.serve_linear(tp, torch.from_numpy(x), torch.from_numpy(wb),
                                torch.from_numpy(ab))
        want = jops.serve_linear(jp, jnp.asarray(x), jnp.asarray(wb),
                                 jnp.asarray(ab))
    np.testing.assert_array_equal(_np(got), _np(want))
    _same_calls(record)
    # one GEMM per distinct family (int4 containers collapse 6, 8 -> 4)
    eff = {min(f, 4 if container == "int4" else 8) for f in fams}
    assert [c[2] for c in record["torch"]] == sorted(eff)


def test_serve_linear_snap_up_and_clamp_down(rng, record):
    """Bits between families snap UP; bits above the widest clamp DOWN."""
    jp, tp = _params(rng, 32, 8, "int8")
    x = rng.normal(size=(4, 32)).astype(np.float32)
    for fams, wb in (((4, 8), [3, 5, 1, 8]), ((2, 4), [8, 3, 2, 6])):
        wbn = np.asarray(wb, np.int32)
        with jops.bit_families(fams), tops.bit_families(fams):
            got = tops.serve_linear(tp, torch.from_numpy(x),
                                    torch.from_numpy(wbn), 8)
            want = jops.serve_linear(jp, jnp.asarray(x), jnp.asarray(wbn), 8)
        np.testing.assert_array_equal(_np(got), _np(want))
        # the snapped row equals a scalar run at its family's width
        fam_idx = tops._family_index(torch.from_numpy(wbn), fams)
        np.testing.assert_array_equal(
            fam_idx.numpy(), np.asarray(jops._family_index(jnp.asarray(wbn),
                                                           fams)))
        snapped = fams[int(fam_idx[0])]
        solo = tops.serve_linear(tp, torch.from_numpy(x[:1]), snapped, 8)
        np.testing.assert_array_equal(_np(got[:1]), _np(solo))
        record["torch"].pop()                   # the solo run's GEMM
    _same_calls(record)


def test_bit_families_context_restores():
    before = tops.get_bit_families()
    with tops.bit_families((8, 4, 4, 12)):
        assert tops.get_bit_families() == (4, 8)
    assert tops.get_bit_families() == before
    with pytest.raises(ValueError, match="non-empty"):
        tops.set_bit_families(())


@pytest.mark.parametrize("layer", [
    conv("c3x3s2", 9, 6, 3, 10, stride=2),
    conv("c1x1s2_down", 9, 6, 1, 10, stride=2, pad=0, relu=False),
    conv("c7x7s2", 12, 3, 7, 8, stride=2, pad=3),
], ids=lambda l: l.name)
def test_conv_layer_accumulator_bit_exact(rng, record, layer):
    """One conv: im2col, the per-image int8 activations (amax over exactly
    the pixels the patches cover) and the int32 accumulators are equal."""
    x = rng.normal(size=(2, layer.hin, layer.hin, layer.cin)
                   ).astype(np.float32)
    xj = jnp.asarray(x).astype(jcm.DTYPE)
    xt = torch.from_numpy(x).to(tcm.DTYPE)
    np.testing.assert_array_equal(
        _np(tcnn.im2col(xt, layer.hk, layer.wk, layer.stride, layer.pad)),
        _np(jcnn.im2col(xj, layer.hk, layer.wk, layer.stride, layer.pad)))
    fk = layer.hk * layer.wk * layer.cin
    w = (rng.normal(size=(fk, layer.cout)) * fk ** -0.5).astype(np.float32)
    jtrain = {"w": jnp.asarray(w).astype(jcm.DTYPE),
              "b": jnp.zeros((layer.cout,), jcm.DTYPE)}
    ttrain = from_numpy_params({k: np.asarray(v) for k, v in jtrain.items()},
                               device="cpu")
    jq = jcnn.quantize_cnn_params({layer.name: jtrain}, [layer])
    tq = tcnn.quantize_cnn_params({layer.name: ttrain}, [layer])
    rows = np.asarray([4, 8], np.int32)
    with jops.bit_families((4, 8)), tops.bit_families((4, 8)):
        want = jcnn.conv_gemm(jq[layer.name], xj, layer, jnp.asarray(rows),
                              jnp.asarray(rows))
        got = tcnn.conv_gemm(tq[layer.name], xt, layer, torch.from_numpy(rows),
                             torch.from_numpy(rows))
    np.testing.assert_array_equal(_np(got), _np(want))
    _same_calls(record)


# ---------------------------------------------------------------------------
# The bit-plane kernel's host-side plan (regime, split of K, scratch)
# ---------------------------------------------------------------------------

PLAN_SHAPES = [(1, 1, 1), (4, 2560, 1024), (4, 2560, 9728), (4, 9728, 2560),
               (16, 9216, 4096), (16, 4096, 1000), (16, 512, 1000),
               (15, 33, 7), (16, 200000, 64), (17, 147, 64),
               (784, 4608, 512), (16384, 2560, 9728), (200704, 147, 64)]


@pytest.mark.parametrize("M,K,N", PLAN_SHAPES)
def test_bitplane_plan_covers_the_shape(M, K, N):
    from repro_torch.kernels import bitplane_matmul as bpm
    p = bpm.plan(M, K, N)
    if M > bpm.SMALL_M:
        assert p.regime == "large_m"
        assert p.k_pad % bpm.K_PAD == 0 and K <= p.k_pad < K + bpm.K_PAD
        # TMA reads x in place only with 16-byte rows and base
        assert p.copy_x == bool(K % 16)
        assert bpm.plan(M, K, N, x_aligned=False).copy_x
        assert p.scratch_bytes(M, N) == (N + M * p.copy_x) * p.k_pad
        return
    assert p.regime == "small_m" and p.k_pad == 0 and not p.copy_x
    total = -(-K // 32)                 # k32 steps
    cols = -(-N // bpm.GEMV_COLS)
    # the splits tile K exactly: none empty, none past the end
    assert p.steps * p.splits >= total > p.steps * (p.splits - 1)
    assert 1 <= p.steps <= bpm.GEMV_MAX_STEPS
    # one wave of two blocks (a column slab's K slice each) per SM: never
    # a block more unless the steps per split are at their cap, and filled
    # up to the rounding of the split, unless K is too short to give each
    # warp of a split a step
    blocks, wave = cols * p.splits, 2 * bpm.H100_SMS
    assert p.steps == bpm.GEMV_MAX_STEPS or blocks <= max(cols, wave)
    enough = min(cols * max(1, wave // cols),
                 cols * max(1, total // bpm.GEMV_WARPS))
    assert 9 * blocks >= 8 * enough
    assert p.splits == 1 or p.steps >= min(bpm.GEMV_WARPS, total)


@pytest.mark.parametrize("M", [1, 15, 16, 17, 18, 128])
def test_bitplane_plan_regime_threshold(M):
    from repro_torch.kernels import bitplane_matmul as bpm
    want = "small_m" if M <= bpm.SMALL_M else "large_m"
    assert bpm.plan(M, 512, 1000).regime == want


def test_bitplane_plan_follows_the_sm_count_and_rejects_empty():
    from repro_torch.kernels import bitplane_matmul as bpm
    few, many = bpm.plan(4, 9728, 2560, sms=16), bpm.plan(4, 9728, 2560)
    cols = -(-2560 // bpm.GEMV_COLS)
    assert few.splits < many.splits
    # on 16 SMs the cap on steps per split sets the split, not the wave
    assert few.steps == bpm.GEMV_MAX_STEPS
    mid = bpm.plan(4, 9728, 2560, sms=64)
    assert few.splits <= mid.splits <= many.splits
    assert cols * mid.splits <= 2 * 64 and cols * many.splits <= 2 * 132
    with pytest.raises(ValueError, match="empty"):
        bpm.plan(0, 64, 64)

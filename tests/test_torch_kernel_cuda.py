"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test here needs a CUDA device and the CUDA toolkit
(the kernel is built with nvcc at first use) and skips without one.  Run
them on a GPU machine with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_kernel_cuda.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import bitfluid as bf  # noqa: E402
from repro_torch.kernels import bitplane_matmul as bpm  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import int4_matmul as i4mm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quant_matmul as qmm  # noqa: E402

pytestmark = pytest.mark.cuda

EDGE_SHAPES = [(1, 1, 1), (1, 512, 1000), (16, 512, 1000), (3, 147, 64),
               (130, 147, 65), (129, 64, 128), (257, 576, 63), (64, 33, 7),
               (200, 4608, 24)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _rand(shape, device, seed):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.integers(-128, 128, size=shape)
                            .astype(np.int8)).to(device)


@pytest.mark.parametrize("n_planes", range(1, 9))
def test_kernel_equals_plain_version(cuda, n_planes):
    for i, (M, K, N) in enumerate(EDGE_SHAPES):
        x, w = _rand((M, K), cuda, i), _rand((K, N), cuda, 100 + i)
        before = bpm.launches[n_planes]
        got = bpm.bitplane_matmul(x, w, n_planes=n_planes)
        torch.cuda.synchronize()
        assert bpm.launches[n_planes] == before + 1
        assert got.dtype == torch.int32 and got.shape == (M, N)
        assert torch.equal(got, bpm.bitplane_matmul_ref(x, w, n_planes))


def test_kernel_unaligned_rows_and_offsets(cuda):
    """A contiguous view that starts mid-buffer (no 16-byte alignment)."""
    base = _rand((65, 64), cuda, 7)
    x = base[1:]                                   # data_ptr offset 64 B
    w = _rand((64, 40), cuda, 8)
    assert torch.equal(bpm.bitplane_matmul(x, w, n_planes=5),
                       bpm.bitplane_matmul_ref(x, w, 5))
    flat = _rand((1 + 33 * 48,), cuda, 9)
    x = flat[1:].view(33, 48)                      # odd byte offset
    assert torch.equal(bpm.bitplane_matmul(x, w[:48], n_planes=8),
                       bpm.bitplane_matmul_ref(x, w[:48], 8))


def test_kernel_rejects_what_it_does_not_take(cuda):
    x, w = _rand((32, 64), cuda, 1), _rand((64, 16), cuda, 2)
    with pytest.raises(ValueError, match="contiguous"):
        bpm.bitplane_matmul(x.t().contiguous().t(), w)
    with pytest.raises(ValueError, match="operands on"):
        bpm.bitplane_matmul(x, w.cpu())


def test_serve_linear_per_row_on_card_equals_plain(cuda, monkeypatch):
    g = np.random.default_rng(3)
    p = {"q": _rand((96, 48), cuda, 4),
         "s": torch.from_numpy(np.abs(g.normal(size=(1, 48))).astype(
             np.float32) + 0.01).to(cuda)}
    x = torch.from_numpy(g.normal(size=(4, 7, 96)).astype(np.float32)).to(cuda)
    wb = torch.tensor([4, 8, 4, 8], dtype=torch.int32, device=cuda)
    with ops.bit_families((4, 8)):
        got = ops.serve_linear(p, x, wb, 8)
        monkeypatch.setattr(ops, "bitplane_matmul",
                            lambda a, b, n_planes: bpm.bitplane_matmul_ref(
                                a, b, n_planes))
        want = ops.serve_linear(p, x, wb, 8)
    assert torch.equal(got, want)


# flash kernel vs its f32 oracle on the same bf16 inputs: about two bf16
# ulps at |out| ~ 1 (P is rounded to bf16 before P.V, sums reorder)
FLASH_TOL = 2e-2
FLASH_SHAPES = [(1, 1, 1, 64), (1, 63, 63, 16), (2, 65, 65, 80),
                (1, 2100, 2100, 128), (3, 100, 333, 64), (2, 130, 77, 128)]


def _bf16(shape, device, seed):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.normal(size=shape).astype(np.float32)).to(
        device).bfloat16()


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 64),
                                           (False, 64)])
def test_flash_kernel_matches_oracle(cuda, causal, window):
    for i, (BH, Sq, Sk, hd) in enumerate(FLASH_SHAPES):
        q = _bf16((BH, Sq, hd), cuda, i)
        k, v = _bf16((BH, Sk, hd), cuda, 10 + i), _bf16((BH, Sk, hd), cuda,
                                                        20 + i)
        before = fa.launches
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert fa.launches == before + 1
        assert got.dtype == torch.bfloat16 and got.shape == (BH, Sq, hd)
        want = fa.flash_attention_ref(q.float(), k.float(), v.float(),
                                      causal, window)
        assert float((got.float() - want).abs().max()) <= FLASH_TOL


def test_flash_dispatch_on_card_uses_the_kernel(cuda):
    q = _bf16((4, 3000, 128), cuda, 1)
    before = fa.launches
    got = ops.flash_attention(q, q, q, causal=True)
    assert fa.launches == before + 1
    want = fa.flash_attention_chunked_ref(q, q, q, True)
    assert float((got.float() - want.float()).abs().max()) <= FLASH_TOL


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q = _bf16((1, 64, 64), cuda, 2)
    with pytest.raises(TypeError, match="bf16"):
        fa.flash_attention(q.float(), q.float(), q.float())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           q, q)
    with pytest.raises(ValueError, match="160"):
        big = _bf16((1, 8, 160), cuda, 3)
        fa.flash_attention(big, big, big)


# ---------------------------------------------------------------------------
# Packed-int4 and fused-epilogue GEMMs
# ---------------------------------------------------------------------------

INT4_SHAPES = [(M, K, N) for M in (1, 16, 130) for K in (1, 17, 363)
               for N in (2, 96, 130, 1000)]


def _packed(shape, device, seed):
    g = np.random.default_rng(seed)
    q4 = torch.from_numpy(g.integers(-8, 8, size=shape).astype(np.int8))
    return bf.pack_int4_halves(q4).to(device)


def _scale(n, device, seed):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.uniform(0.001, 0.05, (1, n)).astype(
        np.float32)).to(device)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int4_kernel_equals_plain_version(cuda, out_dtype):
    for i, (M, K, N) in enumerate(INT4_SHAPES):
        x, w = _rand((M, K), cuda, i), _packed((K, N), cuda, 100 + i)
        s = _scale(N, cuda, 200 + i)
        before = i4mm.launches
        got = i4mm.int4_matmul(x, w, s, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert i4mm.launches == before + 1
        assert got.dtype == out_dtype and got.shape == (M, N)
        assert torch.equal(got, i4mm.int4_matmul_ref(x, w, s, out_dtype))


def test_int4_kernel_unaligned_and_rejects(cuda):
    base = _rand((17, 48), cuda, 1)
    x = base[1:]                                   # data_ptr offset 48 B
    w, s = _packed((48, 1000), cuda, 2), _scale(1000, cuda, 3)
    assert torch.equal(i4mm.int4_matmul(x, w, s),
                       i4mm.int4_matmul_ref(x, w, s))
    with pytest.raises(ValueError, match="contiguous"):
        i4mm.int4_matmul(x.t().contiguous().t(), w, s)
    with pytest.raises(ValueError, match="operands on"):
        i4mm.int4_matmul(x, w.cpu(), s)


# silu / gelu: CUDA's expf / tanhf against PyTorch's, a few f32 ulps;
# bf16 output one bf16 ulp (as in tests/test_torch_int4_quant.py)
QUANT_TOL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -7}


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", qmm.ACTS)
def test_quant_kernel_matches_plain_version(cuda, act, out_dtype):
    for i, (M, K, N) in enumerate(EDGE_SHAPES):
        x, w = _rand((M, K), cuda, i), _rand((K, N), cuda, 100 + i)
        s = _scale(N, cuda, 200 + i)
        b = torch.from_numpy(np.random.default_rng(300 + i).normal(
            size=(1, N)).astype(np.float32)).to(cuda)
        before = qmm.launches[act]
        got = qmm.quant_matmul(x, w, s, b, act=act, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert qmm.launches[act] == before + 1
        assert got.dtype == out_dtype and got.shape == (M, N)
        want = qmm.quant_matmul_ref(x, w, s, b, act, out_dtype)
        if act in ("none", "relu"):
            assert torch.equal(got, want)
        else:
            err = (got.float() - want.float()).abs()
            assert bool((err <= QUANT_TOL[out_dtype]
                         * (1 + want.float().abs())).all())


def test_packed_and_stacked_dispatch_on_card(cuda):
    """int4_linear at a static width launches the packed kernel once and
    equals the CPU run; a grouped stack launches once per slice."""
    g = np.random.default_rng(5)
    w = torch.from_numpy((g.normal(size=(363, 96)) * 0.05).astype(
        np.float32))
    s = bf.symmetric_scale(w, 4, axis=-2)
    q4 = bf.pack_int4_halves(bf.quantize(w, s, 4))
    x = torch.from_numpy(g.normal(size=(16, 7, 363)).astype(np.float32))
    want = ops.int4_linear(x, q4, s, wbits=8, abits=8)
    before = i4mm.launches
    got = ops.int4_linear(x.to(cuda), q4.to(cuda), s.to(cuda), wbits=8,
                          abits=8)
    assert i4mm.launches == before + 1
    assert torch.equal(got.cpu(), want)
    p = {"q": _rand((2, 1200, 128), cuda, 6),
         "s": _scale(256, cuda, 7).reshape(2, 1, 128)}
    xs = torch.from_numpy(g.normal(size=(2, 4, 9, 1200)).astype(
        np.float32))
    wb = torch.tensor([4, 8, 8, 4], dtype=torch.int32)
    with ops.bit_families((4, 8)):
        want = ops.serve_linear_stacked({k: v.cpu() for k, v in p.items()},
                                        xs, wb, 8)
        before = dict(bpm.launches)
        got = ops.serve_linear_stacked(p, xs.to(cuda), wb.to(cuda), 8)
    assert {n: bpm.launches[n] - before[n] for n in (4, 8)} == {4: 2, 8: 2}
    assert torch.equal(got.cpu(), want)

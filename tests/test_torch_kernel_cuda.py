"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test here needs a CUDA device and the CUDA toolkit
(the kernel is built with nvcc at first use) and skips without one.  Run
them on a GPU machine with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_kernel_cuda.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import bitplane_matmul as bpm  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

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

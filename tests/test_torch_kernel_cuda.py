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
        before = bpm.launches_by_planes()[n_planes]
        got = bpm.bitplane_matmul(x, w, n_planes=n_planes)
        torch.cuda.synchronize()
        assert bpm.launches_by_planes()[n_planes] == before + 1
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


# both regimes of the kernel: the small-M GEMV (M <= bpm.SMALL_M) and the
# large-M wgmma GEMM, with x read by TMA in place (K % 16 == 0) or from a
# re-pitched copy
REGIME_SHAPES = [
    # (M, K, N): M around the threshold, K tails off 16 and off the split
    (15, 4608, 1000), (16, 4608, 1000), (17, 4608, 1000),
    (1, 9728, 2560), (4, 2560, 9728), (4, 1000, 130), (16, 33, 7),
    (16, 4097, 96), (17, 4097, 96), (17, 4096, 1001), (130, 1000, 65),
    # K = 147 and 363 (conv1 of ResNet18, AlexNet): x rows not 16-aligned
    (16, 147, 64), (17, 147, 64), (300, 147, 64), (260, 363, 96),
    (257, 576, 63), (784, 4608, 512)]


@pytest.mark.parametrize("n_planes", range(1, 9))
def test_kernel_regimes_equal_plain_version(cuda, n_planes):
    for i, (M, K, N) in enumerate(REGIME_SHAPES):
        x, w = _rand((M, K), cuda, 40 + i), _rand((K, N), cuda, 140 + i)
        before = bpm.launches_by_path()
        got = bpm.bitplane_matmul(x, w, n_planes=n_planes)
        torch.cuda.synchronize()
        ran = [p for p in bpm.PATHS if bpm.launches_by_path()[p] != before[p]]
        want_path = ("small_m" if M <= bpm.SMALL_M else
                     "large_m" if K % 16 == 0 else "large_m_copy_x")
        assert ran == [want_path], (M, K, N)
        assert torch.equal(got, bpm.bitplane_matmul_ref(x, w, n_planes)), \
            (M, K, N)


@pytest.mark.parametrize("M", [4, 16, 17, 300])
def test_kernel_unaligned_rows_in_both_regimes(cuda, M):
    """x and w as views at odd byte offsets: the large-M regime re-pitches
    x and the GEMV's weight loads fall back to single bytes."""
    xf, wf = _rand((1 + M * 64,), cuda, 50 + M), _rand((3 + 64 * 48,), cuda, 9)
    x, w = xf[1:].view(M, 64), wf[3:].view(64, 48)
    for n in (3, 8):
        assert torch.equal(bpm.bitplane_matmul(x, w, n_planes=n),
                           bpm.bitplane_matmul_ref(x, w, n))


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
        before = fa.launch_count()
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert fa.launch_count() == before + 1
        assert got.dtype == torch.bfloat16 and got.shape == (BH, Sq, hd)
        want = fa.flash_attention_ref(q.float(), k.float(), v.float(),
                                      causal, window)
        assert float((got.float() - want).abs().max()) <= FLASH_TOL


# (BH, Sq, Sk, hd, causal, window, k_len): Sq != Sk, k_len < Sk, the
# window with and without causal, hd 64 / 80 / 96 / 128 / 144 / 160, S off
# the 128-row query and key tiles, BH = 1
FLASH_EDGE = [(1, 129, 129, 128, True, 0, 0), (2, 200, 300, 64, True, 0, 0),
              (2, 300, 300, 160, True, 0, 0), (2, 300, 300, 160, False, 0, 0),
              (2, 200, 333, 160, False, 0, 0), (2, 333, 200, 160, True, 0, 0),
              (1, 257, 257, 144, True, 0, 0), (1, 130, 390, 144, False, 0, 0),
              (1, 1000, 1000, 160, True, 257, 0),
              (3, 100, 333, 160, False, 0, 250),
              (2, 300, 200, 128, False, 0, 0), (1, 257, 257, 96, True, 100, 0),
              (1, 257, 257, 80, False, 100, 0), (3, 100, 333, 64, False, 0, 250),
              (2, 256, 256, 128, True, 0, 130), (1, 1000, 1000, 128, True, 257, 0),
              (1, 130, 390, 96, False, 64, 389), (1, 1, 5, 80, True, 0, 0)]


@pytest.mark.parametrize("case", FLASH_EDGE, ids=str)
def test_flash_kernel_edges_match_oracle(cuda, case):
    BH, Sq, Sk, hd, causal, window, k_len = case
    q = _bf16((BH, Sq, hd), cuda, Sq)
    k, v = _bf16((BH, Sk, hd), cuda, Sk + 1), _bf16((BH, Sk, hd), cuda, Sk + 2)
    got = fa.flash_attention(q, k, v, causal=causal, window=window,
                             k_len=k_len)
    torch.cuda.synchronize()
    kl = k_len or Sk                     # keys at or past k_len: invisible
    want = fa.flash_attention_ref(q.float(), k[:, :kl].float(),
                                  v[:, :kl].float(), causal, window)
    assert got.shape == (BH, Sq, hd)
    assert float((got.float() - want).abs().max()) <= FLASH_TOL


def test_flash_dispatch_on_card_uses_the_kernel(cuda):
    q = _bf16((4, 3000, 128), cuda, 1)
    before = fa.launch_count()
    got = ops.flash_attention(q, q, q, causal=True)
    assert fa.launch_count() == before + 1
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
        big = _bf16((1, 8, 192), cuda, 3)
        fa.flash_attention(big, big, big)


def test_flash_refuses_operands_that_require_grad(cuda):
    """The kernel has no backward: under grad mode, operands that require
    grad raise (no fallback to SDPA or a plain version); the same call
    under no_grad launches and matches the plain version."""
    q = _bf16((8, 4096, 128), cuda, 4)
    k, v = _bf16((8, 4096, 128), cuda, 5), _bf16((8, 4096, 128), cuda, 6)
    before = fa.launch_count()
    for leaf in (q, k, v):
        leaf.requires_grad_(True)
        with pytest.raises(NotImplementedError, match="no backward"):
            ops.flash_attention(q, k, v, causal=True)
        with pytest.raises(NotImplementedError, match="no backward"):
            fa.flash_attention(q, k, v, causal=True)
        leaf.requires_grad_(False)
    assert fa.launch_count() == before
    q.requires_grad_(True)
    with torch.no_grad():
        got = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.launch_count() == before + 1 and not got.requires_grad
    want = fa.flash_attention_chunked_ref(q.detach(), k, v, True)
    assert float((got.float() - want.float()).abs().max()) <= FLASH_TOL


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
        before = qmm.launches_by_act()[act]
        got = qmm.quant_matmul(x, w, s, b, act=act, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert qmm.launches_by_act()[act] == before + 1
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
        before = bpm.launches_by_planes()
        got = ops.serve_linear_stacked(p, xs.to(cuda), wb.to(cuda), 8)
    after = bpm.launches_by_planes()
    assert {n: after[n] - before[n] for n in (4, 8)} == {4: 2, 8: 2}
    assert torch.equal(got.cpu(), want)


# both regimes of int4_matmul and quant_matmul: the split-K GEMV (M <= 16,
# K split where it is long enough) and the large-M wgmma tile with x read
# in place (K % 16 == 0) or re-pitched; odd and ragged N, K = 1, 17, 363
REGIME_MK = [(M, K) for M in (1, 16, 17, 130) for K in (1, 17, 363, 512,
                                                         1500)]


def _path(mod, M, K, N, x):
    return mod.plan(M, K, N, x_aligned=x.data_ptr() % 16 == 0).path


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [2, 96, 130, 1000, 4098])
def test_int4_kernel_regimes_equal_plain_version(cuda, N, out_dtype):
    for i, (M, K) in enumerate(REGIME_MK):
        x, w = _rand((M, K), cuda, 60 + i), _packed((K, N), cuda, 160 + i)
        s = _scale(N, cuda, 260 + i)
        before = dict(i4mm.path_launches)
        got = i4mm.int4_matmul(x, w, s, out_dtype=out_dtype)
        torch.cuda.synchronize()
        ran = [p for p in bpm.PATHS if i4mm.path_launches[p] != before[p]]
        assert ran == [_path(i4mm, M, K, N, x)], (M, K, N)
        assert torch.equal(got, i4mm.int4_matmul_ref(x, w, s, out_dtype)), \
            (M, K, N)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", qmm.ACTS)
@pytest.mark.parametrize("N", [1, 7, 65, 1000, 4096])
def test_quant_kernel_regimes_match_plain_version(cuda, N, act, out_dtype):
    for i, (M, K) in enumerate(REGIME_MK):
        x, w = _rand((M, K), cuda, 70 + i), _rand((K, N), cuda, 170 + i)
        s = _scale(N, cuda, 270 + i)
        b = torch.from_numpy(np.random.default_rng(370 + i).normal(
            size=(1, N)).astype(np.float32)).to(cuda)
        before = qmm.launches_by_path()
        got = qmm.quant_matmul(x, w, s, b, act=act, out_dtype=out_dtype)
        torch.cuda.synchronize()
        ran = [p for p in bpm.PATHS if qmm.launches_by_path()[p] != before[p]]
        assert ran == [_path(qmm, M, K, N, x)], (M, K, N)
        want = qmm.quant_matmul_ref(x, w, s, b, act, out_dtype)
        if act in ("none", "relu"):
            assert torch.equal(got, want), (M, K, N)
        else:
            err = (got.float() - want.float()).abs()
            assert bool((err <= QUANT_TOL[out_dtype]
                         * (1 + want.float().abs())).all()), (M, K, N)


@pytest.mark.parametrize("M", [4, 16, 17, 300])
def test_int4_and_quant_unaligned_views_in_both_regimes(cuda, M):
    """x and w as views at odd byte offsets: the large-M regime re-pitches
    x, and the GEMVs' weight loads fall back to narrower pieces."""
    xf = _rand((1 + M * 640,), cuda, 80 + M)
    x = xf[1:].view(M, 640)
    wf = _rand((3 + 640 * 96,), cuda, 81)
    w = wf[3:].view(640, 96)
    s, b = _scale(96, cuda, 82), _scale(96, cuda, 83)
    for od in (torch.float32, torch.bfloat16):
        assert torch.equal(qmm.quant_matmul(x, w, s, b, act="relu",
                                            out_dtype=od),
                           qmm.quant_matmul_ref(x, w, s, b, "relu", od))
    pf = _packed((640 * 97 + 1, 2), cuda, 84).view(-1)
    wp = pf[1:1 + 640 * 97].view(640, 97)              # rows of 97 bytes
    s4 = _scale(194, cuda, 85)
    for od in (torch.float32, torch.bfloat16):
        assert torch.equal(i4mm.int4_matmul(x, wp, s4, out_dtype=od),
                           i4mm.int4_matmul_ref(x, wp, s4, od))


@pytest.mark.parametrize("M", [1, 40])
def test_stacked_expert_dispatch_on_card(cuda, M):
    """``serve_linear_stacked(stack_bits=True)`` on the card (the MoE
    expert stacks: one launch per slice, per-slice scales and bits): each
    slice equals ``serve_linear`` on that slice alone, and the whole stack
    equals the same call on the CPU (plain versions there)."""
    G, K, N = 6, 256, 96
    g = torch.Generator().manual_seed(M)
    w = torch.randn((G, K, N), generator=g) * K ** -0.5
    s = bf.symmetric_scale(w, 8, axis=-2)
    p = {"q": bf.quantize(w, s, 8), "s": s}
    x = torch.randn((G, M, K), generator=g) * torch.linspace(0.1, 4, G)[
        :, None, None]
    bits = torch.tensor([8, 4, 6, 2, 3, 8], dtype=torch.int32)
    pc = {k: v.to(cuda) for k, v in p.items()}
    before = bpm.launches_by_planes()
    got = ops.serve_linear_stacked(pc, x.to(cuda), bits.to(cuda), 8,
                                   stack_bits=True)
    torch.cuda.synchronize()
    assert bpm.launches_by_planes()[8] == before[8] + G
    for k in range(G):
        solo = ops.serve_linear({n: v[k] for n, v in pc.items()},
                                x[k].to(cuda), bits[k].to(cuda), 8)
        assert torch.equal(got[k], solo)
    cpu = ops.serve_linear_stacked(p, x, bits, 8, stack_bits=True)
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize("n_planes", range(1, 9))
def test_fluid_linear_launches_at_its_planes(cuda, n_planes):
    """``ops.fluid_linear`` launches the bit-plane kernel once, at exactly
    ``wbits`` planes; its f32 output EQUALS the same epilogue on the
    plain version's int32 accumulator."""
    g = torch.Generator(device=cuda).manual_seed(n_planes)
    x = torch.randn((16, 2560), generator=g, device=cuda)
    w = _rand((2560, 512), cuda, n_planes)
    ws = torch.rand((1, 512), generator=g, device=cuda) * 0.01
    bpm.reset_launches()
    got = ops.fluid_linear(x, w, ws, wbits=n_planes)
    torch.cuda.synchronize()
    by_planes = bpm.launches_by_planes()
    assert by_planes[n_planes] == 1 and sum(by_planes.values()) == 1
    xs = bf.symmetric_scale(x, 8)
    acc = bpm.bitplane_matmul_ref(bf.quantize(x, xs, 8), w, n_planes)
    assert torch.equal(got, acc.float() * xs * ws)


def test_vmap_rows_equal_grouped_on_card(cuda):
    """Rows at distinct bits {3, 4, 6, 8}: the vmap baseline launches once
    per row (at the container width), the grouped path once per family;
    the outputs are EQUAL."""
    g = torch.Generator(device=cuda).manual_seed(0)
    p = {"q": _rand((256, 384), cuda, 1),
         "s": torch.rand((1, 384), generator=g, device=cuda) * 0.01}
    x = torch.randn((4, 3, 256), generator=g, device=cuda)
    wb = torch.tensor([3, 4, 6, 8], device=cuda)
    bpm.reset_launches()
    grouped = ops.serve_linear(p, x, wb, 8)
    n_grouped = sum(bpm.spec_launches.values())
    with ops.row_dispatch("vmap"):
        vmap = ops.serve_linear(p, x, wb, 8)
    torch.cuda.synchronize()
    assert n_grouped == len(ops.get_bit_families())
    assert sum(bpm.spec_launches.values()) - n_grouped == 4
    assert torch.equal(vmap, grouped)


# the shard shapes of tensor-parallel serving over two model ranks:
# Qwen3-4B column-parallel (wq, wk/wv, gate/up), the vocab-sharded
# 2560 x 75968 GEMV (N not a multiple of 128), row-parallel (wo, wd), and
# Moonshot-v1-16B-A3B's (expert 2048 x 1408 and 1408 x 2048, its vocab
# half 2048 x 81920)
SHARD_SHAPES = [(1, 2560, 2048), (4, 2560, 512), (8, 2560, 4864),
                (1, 2560, 75968), (4, 2048, 2560), (8, 4864, 2560),
                (120, 2048, 1408), (120, 1408, 2048), (2, 2048, 81920)]


@pytest.mark.parametrize("n_planes", [4, 8])
def test_kernel_at_shard_shapes_equals_plain(cuda, n_planes):
    for i, (M, K, N) in enumerate(SHARD_SHAPES):
        x, w = _rand((M, K), cuda, 300 + i), _rand((K, N), cuda, 400 + i)
        got = bpm.bitplane_matmul(x, w, n_planes=n_planes)
        torch.cuda.synchronize()
        assert torch.equal(got, bpm.bitplane_matmul_ref(x, w, n_planes)), \
            (M, K, N)

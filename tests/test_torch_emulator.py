"""The AP emulator, port vs reference: values and pass counts.

``repro_torch.core.emulator`` runs every LUT pass as a tensor op over all
rows (here on the CPU).  On the same numpy data each ``ap_*`` op's values
and all three ``PassCounter`` fields (compares, writes, reads) must EQUAL
``repro.core.emulator``'s: the counts are the emulator's output, since
they are what cross-checks Table I.  The Table I and Table III relations
of ``tests/test_emulator.py`` are held on the port's counters too.
Exact integers throughout: no tolerance.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import emulator as jem  # noqa: E402
from repro_torch.apsim import costmodel as cm  # noqa: E402
from repro_torch.core import emulator as em  # noqa: E402

DEV = "cpu"


def _counts(c):
    return dataclasses.astuple(c)


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got.cpu() if torch.is_tensor(got)
                                             else got), np.asarray(want))


@pytest.mark.parametrize("M", [2, 4, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_word_ops_equal_reference(M, seed):
    rng = np.random.default_rng(seed)
    L = 37
    a = rng.integers(0, 1 << M, (L,))
    b = rng.integers(0, 1 << M, (L,))
    v = rng.integers(-(1 << (M - 1)), 1 << (M - 1), (L,))
    for name, arg, exact in (("ap_add", (a, b, M), a + b),
                             ("ap_multiply", (a, b, M), a * b),
                             ("ap_relu", (v, M), np.maximum(v, 0)),
                             ("ap_max", (a, b, M), np.maximum(a, b))):
        got, gc = getattr(em, name)(*arg, device=DEV)
        want, wc = getattr(jem, name)(*arg)
        _same(got, want)
        _same(got, exact)
        assert _counts(gc) == _counts(wc), name


@pytest.mark.parametrize("M", [2, 4, 8])
@pytest.mark.parametrize("L", [1, 2, 13, 64])
def test_reduce_equals_reference(M, L):
    """Pairwise tree adds, odd rows carried: the value and every count
    (each level's pairs run as one add, charged pair by pair)."""
    a = np.random.default_rng(L).integers(0, 1 << M, (L,))
    got, gc = em.ap_reduce(a, M, device=DEV)
    want, wc = jem.ap_reduce(a, M)
    assert got == want == int(a.sum())
    assert _counts(gc) == _counts(wc)


@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_matmul_equals_reference(M, seed):
    rng = np.random.default_rng(seed)
    X = rng.integers(0, 1 << M, (3, 5))
    W = rng.integers(0, 1 << M, (5, 4))
    got, gc = em.ap_matmul(X, W, M, device=DEV)
    want, wc = jem.ap_matmul(X, W, M)
    _same(got, want)
    _same(got, X @ W)
    assert _counts(gc) == _counts(wc)


def test_tensor_inputs_equal_numpy_inputs():
    rng = np.random.default_rng(3)
    a, b = rng.integers(0, 16, (9,)), rng.integers(0, 16, (9,))
    got, gc = em.ap_max(torch.from_numpy(a), torch.from_numpy(b), 4,
                        device=DEV)
    want, wc = em.ap_max(a, b, 4, device=DEV)
    assert torch.equal(got, want) and gc == wc


def test_max_marks_decided_rows_after_second_pass():
    """Rows decided for A on a bit must not be seen by that bit's second
    pass (B=1 there would flag B the winner): the first differing bit
    decides, whatever the bits below."""
    a = np.array([0b1000, 0b0111, 0b1010, 0b0101, 0b1111])
    b = np.array([0b0111, 0b1000, 0b1001, 0b0110, 0b1111])
    got, _ = em.ap_max(a, b, 4, device=DEV)
    _same(got, np.maximum(a, b))


def test_bit_round_trip_signed_and_unsigned():
    v = np.arange(-8, 8)
    bits = em.to_bits(v, 4, device=DEV)
    assert bits.dtype == torch.uint8 and tuple(bits.shape) == (16, 4)
    _same(em.from_bits(bits), v)
    _same(em.from_bits(bits, signed=False), v & 0xF)
    _same(bits, jem.to_bits(v, 4))


# ---------------------------------------------------------------------------
# Table I / Table III relations on the port's counters
# (tests/test_emulator.py's pass-count locks)
# ---------------------------------------------------------------------------

def test_add_pass_count_matches_table1(rng):
    a = rng.integers(0, 255, (16,))
    b = rng.integers(0, 255, (16,))
    _, c = em.ap_add(a, b, 8, device=DEV)
    assert c.compares == 4 * 9 and c.writes == 4 * 9
    table = cm.table1_cycles("add", "2d", M=8) - (2 * 8 + 8 + 1)
    assert abs((c.compares + c.writes) - table) <= 8


def test_multiply_pass_scaling(rng):
    a = rng.integers(0, 255, (8,))
    b = rng.integers(0, 255, (8,))
    cycles = {}
    for M in (2, 4, 8):
        _, c = em.ap_multiply(a % (1 << M), b % (1 << M), M, device=DEV)
        cycles[M] = c.cycles()
    assert 2.5 < cycles[4] / cycles[2] < 5.0
    assert 2.5 < cycles[8] / cycles[4] < 5.0


def test_mixed_precision_cost_drops(rng):
    a = rng.integers(0, 15, (16,))
    b = rng.integers(0, 15, (16,))
    _, c4 = em.ap_multiply(a, b, 4, device=DEV)
    _, c8 = em.ap_multiply(a, b, 8, device=DEV)
    assert c4.cycles() < 0.45 * c8.cycles()


@pytest.mark.parametrize("M", [4, 8])
def test_relu_pass_count_matches_table3(rng, M):
    v = rng.integers(-(1 << (M - 1)), (1 << (M - 1)) - 1, (32,))
    out, c = em.ap_relu(v, M, device=DEV)
    _same(out, np.maximum(v, 0))
    assert (c.reads, c.compares, c.writes) == (1, M - 1, M)
    assert c.cycles() == 2 * M
    assert c.cycles() == cm.table1_cycles("relu", "2d", M=M) - (2 * M + 1)


def test_pass_counts_independent_of_data(rng):
    counts = set()
    for _ in range(4):
        v = rng.integers(-128, 127, (16,))
        a, b = rng.integers(0, 255, (16,)), rng.integers(0, 255, (16,))
        counts.add((_counts(em.ap_relu(v, 8, device=DEV)[1]),
                    _counts(em.ap_max(a, b, 8, device=DEV)[1]),
                    _counts(em.ap_reduce(a, 8, device=DEV)[1])))
    assert len(counts) == 1


def test_add_max_pass_components(rng):
    a = rng.integers(0, 255, (8,))
    b = rng.integers(0, 255, (8,))
    _, c = em.ap_add(a, b, 8, device=DEV)
    assert _counts(c) == (4 * 9, 4 * 9, 0)
    _, c = em.ap_max(a, b, 8, device=DEV)
    assert c.compares == c.writes == 4 * 8


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        em.ap_add(np.arange(4), np.arange(4), 4)

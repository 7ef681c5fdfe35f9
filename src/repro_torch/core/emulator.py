"""Functional AP emulator: word-parallel compare/write LUT passes on bits.

The counterpart of ``repro.core.emulator``, the paper's §IV emulation of
the Associative Processor.  Data lives as {0,1} bit planes (``uint8``
tensors of shape (L, M), two's-complement columns, LSB first), and every
operation is a sequence of *compare* (pattern match -> tag) and *write*
(masked update of the tagged rows) passes following the operation's LUT.
A pass is one elementwise tensor op over all L rows, on the device the
bit matrices live on, so results are bit-exact by construction and the
pass counts cross-check Table I's cycle models.

LUTs, pass order and loop structure are the reference's, so every
:class:`PassCounter` equals the reference's on the same data:
  * in-place addition (4 passes/bit + carry column, Yantir [50] ordering
    chosen so written patterns never re-match later passes)
  * out-of-place multiplication (bit-serial shift-add: Mw x Ma pass walk)
  * ReLU (Table III: one pass/bit against the sign flag)
  * max (Table IV flags F1/F2: MSB-first winner resolution)
  * reduction / average pooling (vertical-mode pairwise adds)

One difference of execution, none of counting: ``reduce_sum`` runs the
pairwise adds of one tree level as one add over all of the level's pairs
(each pair a row; the AP's vertical mode adds them all at once) and
charges the counter every pair's passes, as the reference's pair-by-pair
loop does.  A level of P pairs is then 4 x M_out tensor passes, not P
times as many, which is what lets a reduction over thousands of rows run
on the card.

The ``ap_*`` wrappers take numpy arrays or tensors and a ``device``:
CUDA unless the caller passes another.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass
class PassCounter:
    compares: int = 0
    writes: int = 0
    reads: int = 0

    def cycles(self) -> int:
        return self.compares + self.writes + self.reads


def _device(device) -> torch.device:
    from repro_torch.models.common import resolve_device
    return resolve_device(device)


def to_bits(x, M: int, device="cuda") -> torch.Tensor:
    """(L,) ints -> (L, M) two's-complement uint8 bit matrix, LSB first."""
    x = torch.as_tensor(x, dtype=torch.int64).to(_device(device))
    u = x & ((1 << M) - 1)
    js = torch.arange(M, dtype=torch.int64, device=x.device)
    return ((u[:, None] >> js[None, :]) & 1).to(torch.uint8)


def from_bits(b: torch.Tensor, signed: bool = True) -> torch.Tensor:
    M = b.shape[1]
    w = torch.ones(M, dtype=torch.int64, device=b.device) << torch.arange(
        M, dtype=torch.int64, device=b.device)
    v = (b.to(torch.int64) * w[None, :]).sum(1)
    if signed:
        v = torch.where(b[:, -1] == 1, v - (1 << M), v)
    return v


# ---------------------------------------------------------------------------
# Compare / write primitives (word-parallel across rows).  ``reps`` is the
# number of reference passes one call stands for (reduce_sum's batched
# tree levels); every other caller runs one pass per call.
# ---------------------------------------------------------------------------

def _compare(cols, pattern, counter: PassCounter, select=None,
             reps: int = 1) -> torch.Tensor:
    """Tag rows whose selected column bits equal `pattern`."""
    counter.compares += reps
    tag = torch.ones(cols[0].shape[0], dtype=torch.bool,
                     device=cols[0].device)
    for c, p in zip(cols, pattern):
        tag &= c == p
    if select is not None:
        tag &= select
    return tag


def _write(cols, values, tag, counter: PassCounter, reps: int = 1) -> None:
    counter.writes += reps
    for c, v in zip(cols, values):
        c.masked_fill_(tag, v)


# ---------------------------------------------------------------------------
# Addition LUT (in-place A + B -> B, carry column Cr)
# Pass order guarantees no written row re-matches a later pass.
# ---------------------------------------------------------------------------

_ADD_LUT = (  # (A, B, Cr) pattern  ->  (B', Cr')
    ((0, 0, 1), (1, 0)),
    ((0, 1, 1), (0, 1)),
    ((1, 1, 0), (0, 1)),
    ((1, 0, 0), (1, 0)),
)


def _add(A, B, counter, select=None, reps: int = 1):
    L, Ma = A.shape
    Cr = torch.zeros(L, dtype=torch.uint8, device=A.device)
    zero = torch.zeros(L, dtype=torch.uint8, device=A.device)
    for i in range(B.shape[1]):
        a_col = A[:, i] if i < Ma else zero
        b_col = B[:, i]                     # a view: writes land in B
        for pattern, (b_new, c_new) in _ADD_LUT:
            tag = _compare((a_col, b_col, Cr), pattern, counter, select,
                           reps)
            _write((b_col, Cr), (b_new, c_new), tag, counter, reps)
    return B


def add_inplace(A: torch.Tensor, B: torch.Tensor, counter: PassCounter,
                select=None) -> torch.Tensor:
    """B := A + B, bit-serial LSB->MSB.  A: (L, Ma), B: (L, Mb >= Ma+1)."""
    return _add(A, B, counter, select)


def multiply(A: torch.Tensor, B: torch.Tensor, counter: PassCounter
             ) -> torch.Tensor:
    """C := A * B (unsigned), out of place; (L,Ma) x (L,Mb) -> (L,Ma+Mb).

    Bit-serial shift-add: for each multiplier bit j, rows with B_j == 1
    add (A << j) into C — the Mw x Ma LUT walk of Eq. 2."""
    L, Ma = A.shape
    Mb = B.shape[1]
    C = torch.zeros((L, Ma + Mb), dtype=torch.uint8, device=A.device)
    for j in range(Mb):
        sel = _compare((B[:, j],), (1,), counter)
        add_inplace(A, C[:, j:], counter, select=sel)   # a view of C
    return C


def relu(V: torch.Tensor, counter: PassCounter) -> torch.Tensor:
    """Table III: stash MSB in flag, reset it, zero bits where flag set.

    The flag stash is one read, the MSB reset one write, and each of the
    M-1 remaining bits one compare + one write: 2M passes, Table I's 4M+1
    ReLU cycles minus the 2M populate and 1 read-out I/O passes."""
    L, M = V.shape
    F = V[:, -1].clone()
    counter.reads += 1
    _write((V[:, -1],), (0,), torch.ones(L, dtype=torch.bool,
                                         device=V.device), counter)
    for i in range(M - 1):
        col = V[:, i]
        tag = _compare((col, F), (1, 1), counter)
        _write((col,), (0,), tag, counter)
    return V


def maximum_inplace(A: torch.Tensor, B: torch.Tensor, counter: PassCounter
                    ) -> torch.Tensor:
    """B := max(A, B) (unsigned), MSB-first with Table IV's F1/F2 flags.

    F2 = comparison decided; F1 = B is the winner.  Per bit (4 LUT
    passes): undecided rows resolve on the first differing bit; rows
    decided for A copy A's remaining bits into B."""
    L, M = A.shape
    F1 = torch.zeros(L, dtype=torch.uint8, device=A.device)   # B wins
    F2 = torch.zeros(L, dtype=torch.uint8, device=A.device)   # decided
    for i in range(M - 1, -1, -1):
        a_col, b_col = A[:, i], B[:, i].clone()
        # 1st pass: A=1,B=0, undecided -> A wins, copy bit
        tag = _compare((a_col, b_col, F2), (1, 0, 0), counter)
        _write((b_col, F2), (1, 0), tag, counter)
        decided_a = tag
        # 2nd pass: A=0,B=1, undecided -> B wins
        tag = _compare((a_col, b_col, F2), (0, 1, 0), counter)
        _write((F1, F2), (1, 1), tag, counter)
        # mark rows decided for A (F2=1, F1=0) — after pass 2 so the
        # pass-2 compare can't see them
        F2.masked_fill_(decided_a, 1)
        # 3rd/4th passes: decided-for-A rows copy A's bit into B
        sel = (F2 == 1) & (F1 == 0) & ~decided_a
        tag = _compare((a_col,), (1,), counter, select=sel)
        _write((b_col,), (1,), tag, counter)
        tag = _compare((a_col,), (0,), counter, select=sel)
        _write((b_col,), (0,), tag, counter)
        B[:, i] = b_col
    return B


def _pad(v: torch.Tensor, M_out: int) -> torch.Tensor:
    return torch.nn.functional.pad(v, (0, M_out - v.shape[1]))


def reduce_sum(A: torch.Tensor, M_out: int, counter: PassCounter) -> int:
    """Vertical-mode reduction: pairwise in-place adds (Eq. 4 structure).

    Each level pairs rows (0, 1), (2, 3), ... as the reference does, pads
    both operands of every pair to ``M_out`` bits, adds all of the
    level's pairs at once and charges each pair's passes; an odd last row
    is padded and carried to the next level."""
    vals = A
    while vals.shape[0] > 1:
        P = vals.shape[0] // 2
        a = _pad(vals[0:2 * P:2], M_out)
        b = _pad(vals[1:2 * P:2], M_out)
        nxt = _add(a, b, counter, reps=P)
        if vals.shape[0] % 2:
            nxt = torch.cat([nxt, _pad(vals[-1:], M_out)])
        vals = nxt
    counter.reads += 1
    return int(from_bits(vals, signed=False)[0])


# ---------------------------------------------------------------------------
# Word-level convenience wrappers (the emulator's public API)
# ---------------------------------------------------------------------------

def ap_add(a, b, M: int, device="cuda"):
    """Returns (a + b mod 2^(M+1), PassCounter)."""
    c = PassCounter()
    A = to_bits(a, M, device)
    B = _pad(to_bits(b, M, device), M + 1)
    out = add_inplace(A, B, c)
    return from_bits(out, signed=False), c


def ap_multiply(a, b, M: int, device="cuda"):
    c = PassCounter()
    out = multiply(to_bits(a, M, device), to_bits(b, M, device), c)
    return from_bits(out, signed=False), c


def ap_relu(v, M: int, device="cuda"):
    c = PassCounter()
    out = relu(to_bits(v, M, device), c)
    return from_bits(out, signed=False), c


def ap_max(a, b, M: int, device="cuda"):
    c = PassCounter()
    out = maximum_inplace(to_bits(a, M, device), to_bits(b, M, device), c)
    return from_bits(out, signed=False), c


def _out_bits(M: int, L: int) -> int:
    return M + max(int(math.ceil(math.log2(max(L, 2)))), 1)


def ap_reduce(a, M: int, device="cuda"):
    c = PassCounter()
    A = to_bits(a, M, device)
    return reduce_sum(A, _out_bits(M, A.shape[0]), c), c


def ap_matmul(X, W, M: int, device="cuda"):
    """Full GEMM on the emulator: X (i,j) @ W (j,u), unsigned M-bit inputs;
    one multiply and one reduction per (row, col) product, as in the
    reference."""
    c = PassCounter()
    dev = _device(device)
    X = torch.as_tensor(X, dtype=torch.int64).to(dev)
    W = torch.as_tensor(W, dtype=torch.int64).to(dev)
    i, j = X.shape
    _, u = W.shape
    out = torch.zeros((i, u), dtype=torch.int64, device=dev)
    for r in range(i):
        for col in range(u):
            prod = multiply(to_bits(X[r], M, dev), to_bits(W[:, col], M, dev),
                            c)
            out[r, col] = reduce_sum(prod, _out_bits(2 * M, j), c)
    return out, c

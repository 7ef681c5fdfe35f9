"""The port's flash attention dispatch and plain versions against the
reference's, on the CPU.

The same numpy inputs go through ``repro.kernels.ref.flash_attention_ref``
(the oracle), the reference's dispatcher ``ops.flash_attention`` with the
Pallas kernel in interpret mode (as ``tests/test_kernels.py`` runs it),
and the port's ``ops.flash_attention`` and plain versions.  Everything is
f32, and the tolerance is the reference tests' own, 2e-3: the softmax and
the products sum in another order in each implementation.  The CUDA
kernel itself is held against the oracle on the card
(``tests/test_torch_kernel_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = 2e-3


def _inputs(seed, BH, Sq, Sk, hd, dtype=np.float32):
    g = np.random.default_rng(seed)
    return tuple(g.normal(size=(BH, S, hd)).astype(dtype)
                 for S in (Sq, Sk, Sk))


def _close(got, want, tol=TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 64),
                                           (False, 64)])
@pytest.mark.parametrize("shape", [(4, 128, 64), (2, 256, 128), (3, 100, 48)])
def test_dispatch_matches_reference(causal, window, shape):
    BH, S, hd = shape
    q, k, v = _inputs(sum(shape), BH, S, S, hd)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal, window)
    interp = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  window=window, interpret=True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == (BH, S, hd)
    _close(got, want)
    _close(got, interp)
    # the blockwise lowering, cut into several chunks, agrees where it
    # applies the same mask (it drops the window when not causal)
    chunked = fa.flash_attention_chunked_ref(tq, tk, tv, causal, window,
                                             chunk=48)
    _close(chunked, want if causal else jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), False, 0))


def test_cross_lengths():
    """Sq != Sk (the cross-attention shape)."""
    q, k, v = _inputs(5, 2, 64, 200, 32)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=False)
    interp = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=False,
                                  interpret=True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=False)
    _close(got, want)
    _close(got, interp)
    _close(fa.flash_attention_chunked_ref(tq, tk, tv, False, chunk=64), want)


@pytest.mark.parametrize("causal", [True, False])
def test_long_sequence_takes_the_chunked_branch(causal, monkeypatch):
    """S = 2100 > FLASH_CHUNK: the port's CPU dispatch takes the blockwise
    lowering, as the reference's does off the TPU; both agree with the
    oracle."""
    q, k, v = _inputs(7, 1, 2100, 2100, 16)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = jref.flash_attention_ref(jq, jk, jv, causal)
    jgot = jops.flash_attention(jq, jk, jv, causal=causal)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    taken = []
    real = fa.flash_attention_chunked_ref

    def spy(*args, **kw):
        taken.append(True)
        return real(*args, **kw)

    monkeypatch.setattr(fa, "flash_attention_chunked_ref", spy)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert taken == [True]
    _close(got, want)
    _close(got, jgot)


def test_bf16_chunked_matches_reference_chunked():
    """bf16 inputs, as the serve path passes them: the port's blockwise
    lowering against the reference's.  Both round P to bf16 before P.V and
    round the output to bf16; the sums run in another order, so the
    outputs may sit one bf16 ulp apart (2^-7 at |out| < 2): 1.6e-2."""
    q, k, v = _inputs(9, 2, 2100, 2100, 16)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jref.flash_attention_chunked_ref(jq, jk, jv, causal=True)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32), tol=1.6e-2)


def test_kernel_wrapper_refuses_what_it_does_not_take():
    """The CUDA wrapper takes CUDA tensors only (no fallback), and head
    dims up to its largest instantiation, 160 (stablelm-12b's)."""
    q = torch.zeros((1, 8, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="cuda"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="are not"):
        fa.flash_attention(q, q[:, :, :32], q)
    assert [fa.kernel_head_dim(h) for h in (16, 48, 64, 80, 128)] == \
        [64, 64, 64, 128, 128]
    with pytest.raises(ValueError, match="160"):
        fa.kernel_head_dim(161)
    assert fa.FLASH_CHUNK == jref.FLASH_CHUNK
    assert fa.NEG_INF == jref.NEG_INF


def test_kernel_head_dim_pads_up_to_160():
    """hd 129..160 run at the 160-wide instantiation: 144 pads to 160,
    160 (stablelm-12b's head dim) runs as it is."""
    assert fa.HEAD_DIMS == (64, 128, 160)
    assert [fa.kernel_head_dim(h) for h in (129, 144, 159, 160)] == [160] * 4


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 96, 96, 160), (2, 130, 77, 144),
                                   (1, 40, 200, 160)])
def test_wide_heads_match_reference(causal, shape):
    """hd 160 and 144, Sq = Sk and Sq != Sk: the port's dispatch and both
    plain versions (the blockwise one cut into 32-row chunks) against the
    reference's oracle and its interpret-mode Pallas kernel, in f32."""
    BH, Sq, Sk, hd = shape
    q, k, v = _inputs(hd + Sq, BH, Sq, Sk, hd)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = jref.flash_attention_ref(jq, jk, jv, causal)
    interp = jops.flash_attention(jq, jk, jv, causal=causal, interpret=True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.shape == (BH, Sq, hd)
    _close(got, want)
    _close(got, interp)
    _close(fa.flash_attention_ref(tq, tk, tv, causal), want)
    _close(fa.flash_attention_chunked_ref(tq, tk, tv, causal, chunk=32),
           want)

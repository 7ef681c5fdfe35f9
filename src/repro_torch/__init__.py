"""BF-IMNA reproduction on PyTorch and CUDA: the port of ``repro``.

A second package beside the JAX reference, with the same subpackage and
module names: apsim (a copy of the analytic AP cost model), configs (a
copy of the architecture registry), core (bit-fluid quantization,
precision policies, the AP emulator), kernels (hand-written Hopper
kernels, their plain PyTorch versions, the serve-form and attention
dispatch, ``fluid_linear`` and the row-dispatch switch), models (the
CNN workloads and the six LM families, train and serve forms), serve
(batched bit-fluid CNN serving and LM generation), cache, dist, optim
(AdamW, compressed all-reduce), train (the train step, checkpoints, the
straggler watchdog), data (the synthetic pipeline) and launch (the
training and serving CLIs).

It imports torch and numpy, never jax and never any module of ``repro``.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
import torch as _torch

__version__ = "0.1.0"


def _settle_vector_math() -> None:
    """Set MKL's vector math library up on one thread, once.

    ATen computes ``tanh``, ``exp`` and ``log`` of a float CPU tensor
    through MKL's VML, which sets itself up on its first call.  When that
    first call is long enough for MKL to split it over its own threads,
    the set-up races with the threads' work: a few elements of that one
    call come back about 1e-5 off (0.955489 for tanh(1.891949), whose
    float value is 0.955543) and every later call is exact to a few
    ulps.  The plain versions of the port's kernels (the fused GEMM's
    gelu gate, the cross-entropy's exp and log) are oracles, so the port
    makes one short call of each first: short calls run on one thread."""
    if _torch.backends.mkl.is_available():
        x = _torch.zeros(8)
        _torch.tanh(x)
        _torch.exp(x)
        _torch.log(x + 1)


_settle_vector_math()

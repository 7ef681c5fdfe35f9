"""BF-IMNA reproduction on PyTorch and CUDA: the port of ``repro``.

A second package beside the JAX reference, with the same subpackage and
module names: apsim (a copy of the analytic AP cost model), core
(bit-fluid quantization, precision policies), kernels (hand-written
Hopper kernels, their plain PyTorch versions, the serve-form dispatch),
models (the CNN workloads), serve (batched bit-fluid CNN serving).

It imports torch and numpy, never jax and never any module of ``repro``.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
__version__ = "0.1.0"

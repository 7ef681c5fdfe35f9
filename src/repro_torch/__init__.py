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
__version__ = "0.1.0"

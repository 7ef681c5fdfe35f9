"""repro_torch.core — bit-fluid quantization, precision policies and the
AP emulator.

bitfluid   quant/dequant, dyadic runtime requantization, bit planes, int4
           packing (interleaved and half-split), the fluid int8 matmul
           and the plane-walk oracle
policy     per-layer precision policies, the open-loop budget controller
           and the closed-loop FluidController
emulator   the paper's functional AP emulation: word-parallel compare and
           write LUT passes on bit planes, with pass counters
"""
from repro_torch.core import bitfluid, emulator, policy  # noqa: F401

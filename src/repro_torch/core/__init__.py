"""repro_torch.core — bit-fluid quantization and precision policies.

bitfluid   quant/dequant, dyadic runtime requantization, int4 packing
policy     per-layer precision policies, the open-loop budget controller
           and the closed-loop FluidController
"""
from repro_torch.core import bitfluid, policy  # noqa: F401

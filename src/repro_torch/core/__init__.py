"""repro_torch.core — bit-fluid quantization and precision policies.

bitfluid   quant/dequant, dyadic runtime requantization, int4 packing
policy     per-layer precision policies and the budget controller
"""

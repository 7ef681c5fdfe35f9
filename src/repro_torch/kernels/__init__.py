"""repro_torch.kernels — hand-written Hopper kernels and their dispatch.

bitplane_matmul   the bit-plane int8 GEMM (CUDA, csrc/) + plain version
int4_matmul       the packed-int4 GEMM (CUDA, csrc/) + plain version
quant_matmul      the int8 GEMM with a fused dequant/bias/act epilogue
                  (CUDA, csrc/) + plain version
flash_attention   flash attention (CUDA, csrc/) + its two plain versions
cuda_build        nvcc build-at-first-use and ctypes loading
ops               serve-form linears (container, packed-int4, stacked and
                  bit-grouped paths), the public GEMM entries and the
                  flat-head attention dispatch
"""

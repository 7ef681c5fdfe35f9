"""repro_torch.kernels — hand-written Hopper kernels and their dispatch.

bitplane_matmul   the bit-plane int8 GEMM (CUDA, csrc/) + plain version
flash_attention   flash attention (CUDA, csrc/) + its two plain versions
cuda_build        nvcc build-at-first-use and ctypes loading
ops               serve-form linears (container and bit-grouped paths)
                  and the flat-head attention dispatch
"""

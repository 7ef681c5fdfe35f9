"""repro_torch.kernels — hand-written Hopper kernels and their dispatch.

bitplane_matmul   the bit-plane int8 GEMM (CUDA, csrc/) + plain version
cuda_build        nvcc build-at-first-use and ctypes loading
ops               serve-form linears: container and bit-grouped paths
"""

"""repro_torch.models — the paper's CNN workloads and the weight bridge.

common    the bit-fluid linear, init helpers, device resolution
cnn       conv-as-GEMM (im2col) ResNet/VGG/AlexNet forward
convert   the reference's numpy parameters -> torch tensors
"""

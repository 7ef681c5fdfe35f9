"""repro_torch.models — the paper's CNN workloads, the dense LM, and the
weight bridge.

common       norms, RoPE, masks, the bit-fluid linear, init helpers,
             device resolution
cnn          conv-as-GEMM (im2col) ResNet/VGG/AlexNet forward
config       ModelConfig (a copy; the registry is repro_torch.configs)
transformer  dense GQA attention, MLP and block; bf16 KV cache
lm           the dense LM stack, logits, prefill and decode
convert      the reference's numpy parameters -> torch tensors
"""

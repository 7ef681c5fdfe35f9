"""qwen1.5-110b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064, QKV bias.  [hf:Qwen/Qwen1.5-110B family]"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=49152,
    vocab_size=152064, head_dim=128, qkv_bias=True, rope_theta=1e6,
    mlp_type="swiglu", norm_type="rms", norm_eps=1e-6,
)

SMOKE = FULL.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, head_dim=16, remat="none",
)

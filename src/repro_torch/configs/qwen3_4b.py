"""qwen3-4b [dense] — 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936, qk_norm.  [hf:Qwen/Qwen3-4B family]"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, d_ff=9728,
    vocab_size=151936, head_dim=128, qk_norm=True, rope_theta=1e6,
    mlp_type="swiglu", norm_type="rms", norm_eps=1e-6, tie_embeddings=True,
)

SMOKE = FULL.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, head_dim=16, remat="none",
)

"""internvl2-1b [vlm] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655; InternViT frontend is a STUB (precomputed patch embeddings
via input_specs, per the brief).  [arXiv:2404.16821]"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab_size=151655, head_dim=64, qkv_bias=True, rope_theta=1e6,
    mlp_type="swiglu", norm_type="rms", norm_eps=1e-6, tie_embeddings=True,
    frontend="vision", n_prefix_tokens=256,
)

SMOKE = FULL.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, head_dim=16, n_prefix_tokens=8, remat="none",
)

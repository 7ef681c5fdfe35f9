"""starcoder2-15b [dense] — 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152, GQA + RoPE, sliding-window 4096, LayerNorm + GELU MLP.
[arXiv:2402.19173]"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, d_ff=24576,
    vocab_size=49152, head_dim=128, qkv_bias=True, rope_theta=1e5,
    sliding_window=4096, mlp_type="gelu", norm_type="layer", norm_eps=1e-5,
)

SMOKE = FULL.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, head_dim=16, sliding_window=8, remat="none",
)

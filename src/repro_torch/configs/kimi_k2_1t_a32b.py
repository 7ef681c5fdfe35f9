"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048
(per expert) vocab=163840, MoE 384 experts top-8 (+1 shared).  Trillion-
parameter paper-table config.  [arXiv:2501 Kimi K2]"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab_size=163840, head_dim=128, rope_theta=5e4,
    mlp_type="swiglu", norm_type="rms", norm_eps=1e-6,
    n_experts=384, experts_per_token=8, n_shared_experts=1,
    capacity_factor=1.25, accum_dtype="bfloat16",
)

SMOKE = FULL.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
    vocab_size=512, head_dim=16, n_experts=8, experts_per_token=2,
    n_shared_experts=1, remat="none",
)

"""moonshot-v1-16b-a3b [moe] — 48L d_model=2048 16H (GQA kv=16) d_ff=1408
(per expert) vocab=163840, MoE 64 experts top-6 (+2 shared).
[hf:moonshotai/Moonlight-16B-A3B family]"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=163840, head_dim=128, rope_theta=5e4,
    mlp_type="swiglu", norm_type="rms", norm_eps=1e-6,
    n_experts=64, experts_per_token=6, n_shared_experts=2,
    capacity_factor=1.25,
)

SMOKE = FULL.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
    vocab_size=512, head_dim=16, n_experts=8, experts_per_token=2,
    n_shared_experts=2, remat="none",
)

"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64; Mamba2 backbone + one globally-shared attention
block invoked every 6 layers with per-site LoRA.  [arXiv:2411.15242]"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab_size=32000, head_dim=80, rope_theta=1e4,
    mlp_type="swiglu", norm_type="rms", norm_eps=1e-5,
    ssm_state=64, ssm_head_dim=64, expand=2, d_conv=4, ssm_chunk=128,
    attn_every=6, lora_rank=64,
)

SMOKE = FULL.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=512, head_dim=16, ssm_state=16, ssm_head_dim=16,
    ssm_chunk=16, attn_every=1, lora_rank=4, remat="none",
)

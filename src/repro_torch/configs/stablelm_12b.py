"""stablelm-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352.  [hf:stabilityai/stablelm-2-12b family]"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=13824,
    vocab_size=100352, head_dim=160, rope_theta=1e4,
    mlp_type="swiglu", norm_type="layer", norm_eps=1e-5,
)

SMOKE = FULL.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, head_dim=16, remat="none",
)

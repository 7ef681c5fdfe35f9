"""seamless-m4t-medium [audio] — enc-dec, 12L(enc) + 12L(dec) d_model=1024
16H (kv=16) d_ff=4096 vocab=256206; the audio frontend is a STUB
(precomputed frame embeddings via input_specs).  [arXiv:2308.11596]"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, n_enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=256206, head_dim=64, rope_theta=1e4,
    mlp_type="gelu", norm_type="layer", norm_eps=1e-5,
    frontend="audio", frames_ratio=4,
)

SMOKE = FULL.with_(
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512, head_dim=16, remat="none",
)

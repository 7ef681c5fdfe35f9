"""mamba2-1.3b [ssm] — 48L d_model=2048 (attention-free) vocab=50280,
ssm_state=128, SSD (state-space duality).  [arXiv:2405.21060]"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, expand=2, d_conv=4, ssm_chunk=128,
    norm_type="rms", norm_eps=1e-5, tie_embeddings=True,
)

SMOKE = FULL.with_(
    n_layers=2, d_model=64, vocab_size=512, ssm_state=16, ssm_head_dim=16,
    ssm_chunk=16, remat="none",
)

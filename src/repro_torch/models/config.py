"""ModelConfig — one dataclass describing every supported architecture.

A copy of ``repro.models.config`` (data only): the port keeps its own."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    vocab_size: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    head_dim: int = 0            # 0 -> d_model // n_heads
    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4      # 0 disables RoPE
    sliding_window: int = 0      # 0 = full attention
    mlp_type: str = "swiglu"     # swiglu | gelu
    norm_type: str = "rms"       # rms | layer
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    ssm_chunk: int = 128
    # hybrid (zamba2): one shared attn+mlp block every `attn_every` layers
    attn_every: int = 0
    lora_rank: int = 0
    # enc-dec (seamless)
    n_enc_layers: int = 0
    frames_ratio: int = 4        # decoder tokens per encoder frame (stub)
    # modality frontend stub: prepended precomputed embeddings
    frontend: str = ""           # "" | "vision" | "audio"
    n_prefix_tokens: int = 0
    # training details
    remat: str = "full"          # none | full
    accum_dtype: str = "float32"  # gradient accumulation dtype
    # serving details
    kv_cache_bits: int = 0       # 0 = bf16 cache; 8 = int8 cache with
    #                              int8 QK/PV attention (beyond-paper:
    #                              the bit-fluid insight applied to the
    #                              decode bandwidth bottleneck)

    def __post_init__(self):
        if self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Embedding/head rows padded to a 512 multiple so the vocab dim
        shards over any mesh axis (oddball vocabs — 50280, 151655, 256206
        — would otherwise replicate the logits tensor).  Logits at padded
        ids are masked to -inf in logits_fn; real vocab ids are unchanged.
        """
        if self.vocab_size % 512 == 0:
            return self.vocab_size
        return -(-self.vocab_size // 512) * 512

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (bounded decode state)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)
SHAPES_BY_NAME = {s.name: s for s in SHAPES}

"""Fake-tensor stand-ins for every model input and state: nothing is
allocated.

The counterpart of ``repro.launch.specs``: where the reference builds
``jax.ShapeDtypeStruct`` trees with ``jax.eval_shape``, the port runs its
own constructors (``lm.init_params``, ``lm.quantize_params``,
``lm.empty_cache``, ``optim.adamw.adamw_init``) on the CPU under one
shared :class:`~torch._subclasses.fake_tensor.FakeTensorMode`, so every
leaf is a fake tensor that carries a shape, a dtype and a device and no
storage.  The 1T-parameter config builds in well under a second.
``input_specs(cfg, shape)`` returns the batch tree of one (architecture
x input shape) cell.  These feed the sharding checker and the lowering
report.

Every tree built here belongs to :func:`fake_mode`; an operation that
mixes them with real tensors must run inside ``with fake_mode():``.
"""
from __future__ import annotations

import functools

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_init


@functools.cache
def fake_mode() -> FakeTensorMode:
    """The one mode every abstract tree of this module is built under."""
    return FakeTensorMode()


def fake_tensor(shape, dtype) -> torch.Tensor:
    """One fake tensor of :func:`fake_mode`."""
    with fake_mode():
        return torch.empty(shape, dtype=dtype)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        # the model trains on exactly S tokens of S + 1
        n = S + 1 if shape.kind == "train" else S
        out = {"tokens": fake_tensor((B, n), torch.int32)}
        if cfg.family == "vlm":
            npre = cfg.n_prefix_tokens
            out["tokens"] = fake_tensor((B, n - npre), torch.int32)
            out["prefix"] = fake_tensor((B, npre, cfg.d_model),
                                        torch.bfloat16)
        elif cfg.family == "encdec":
            out["frames"] = fake_tensor(
                (B, S // cfg.frames_ratio, cfg.d_model), torch.bfloat16)
        return out
    # decode: one new token against an S-deep cache
    return {"tok": fake_tensor((B, 1), torch.int32),
            "t": fake_tensor((), torch.int32)}


def abstract_params(cfg: ModelConfig) -> dict:
    """Train-form parameters, drawn from a CPU generator onto the CPU."""
    with fake_mode():
        return lm.init_params(cfg, torch.Generator("cpu"), device="cpu")


def abstract_qparams(cfg: ModelConfig, container: str = "int8") -> dict:
    p = abstract_params(cfg)
    with fake_mode():
        return lm.quantize_params(p, cfg, container)


def abstract_opt(cfg: ModelConfig, ocfg: AdamWConfig) -> dict:
    p = abstract_params(cfg)
    with fake_mode():
        return adamw_init(p, ocfg)


def abstract_cache(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    with fake_mode():
        return lm.empty_cache(cfg, shape.global_batch, shape.seq_len,
                              device="cpu")


def bit_vectors(cfg: ModelConfig, bits: int = 8):
    n = lm.n_bit_slots(cfg)
    v = torch.full((n,), bits, dtype=torch.int32)
    return v, v


def optimizer_for(cfg: ModelConfig) -> AdamWConfig:
    """Memory posture scales with model size: the 1T MoE uses int8 first
    moments and factored second moments."""
    if cfg.n_experts >= 256 or cfg.d_model >= 8192:
        return AdamWConfig(m_dtype="int8", v_mode="factored")
    return AdamWConfig(m_dtype="float32", v_mode="full")

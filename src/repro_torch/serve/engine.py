"""Bit-fluid LM serving, whole-batch API, on one device.

The counterpart of ``repro.serve.engine.ServeEngine`` for the lock-step
path: ``set_budget(scalar | (B,) vector)`` + ``generate(batch, steps)``.
Each request's budget resolves through a
:class:`~repro_torch.core.policy.BudgetController` into a per-layer bit
vector; the batch's ``(B, n_layers)`` bit matrix runs through the
bit-grouped dispatch (one bit-plane kernel launch per linear and bit
family); a prompt longer than ``transformer.FLASH_THRESHOLD`` sends every
layer's self-attention through the flash kernel; decode runs on the bf16
KV cache.  ``price_budget`` prices a budget's bit vector through the
copied AP cost model.

The reference jit-compiles prefill and a scan-fused decode block; here
both run eagerly, so ``fused=True`` and ``fused=False`` run the same
per-token loop and give the same tokens.  Sampling draws from an explicit
``torch.Generator`` seeded from ``seed``: greedy (temperature 0) rows
equal the reference's tokens, sampled rows match it in distribution only.

Not ported yet, and raising ``NotImplementedError``: continuous batching
(``submit``/``run``), meshes and placement plans, the prefix cache and
speculative decoding.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import policy as pol
from repro_torch.core.policy import BudgetController, PrecisionPolicy
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.serve.runtime import ServeRuntime

TOPK_MAX = 64          # top-k sort width; per-row k <= TOPK_MAX


def default_controller(n: int) -> BudgetController:
    """int4 / mixed (8 then 4) / int8 at predicted 0.5 / 0.75 / 1.0 s."""
    return pol.BudgetController(
        {"int4": pol.fixed(4), "mixed": pol.per_layer([8, 4], name="mixed"),
         "int8": pol.fixed(8)},
        {"int4": 0.5, "mixed": 0.75, "int8": 1.0}, n)


def _default_policy() -> PrecisionPolicy:
    return pol.fixed(8)


def _scaled_logits(logits: torch.Tensor, temperature: torch.Tensor,
                   top_k: torch.Tensor) -> torch.Tensor:
    """Per-row masked + temperature-scaled logits: logits (B, V);
    temperature/top_k (B,).  top_k > 0 masks all but the row's k best
    logits.  Sampling draws from softmax of this."""
    V = logits.shape[-1]
    logits = logits.float()
    K = min(TOPK_MAX, V)
    vals = torch.topk(logits, K, dim=-1).values                # (B, K)
    kth = torch.gather(vals, 1, top_k.clamp(1, K)[:, None].long() - 1)
    masked = torch.where((top_k[:, None] > 0) & (logits < kth),
                         float("-inf"), logits)
    return masked / temperature.clamp_min(1e-6)[:, None]


def _sample_tokens(logits: torch.Tensor, gen: torch.Generator,
                   temperature: torch.Tensor, top_k: torch.Tensor
                   ) -> torch.Tensor:
    """Per-row sampling: logits (B, V); temperature/top_k (B,).
    temperature == 0 -> greedy.  Sampled rows take the Gumbel-max draw
    argmax(scaled + Gumbel noise), the categorical the reference samples
    (``jax.random.categorical`` is the same construction)."""
    logits = logits.float()
    greedy = logits.argmax(dim=-1).to(torch.int32)
    scaled = _scaled_logits(logits, temperature, top_k)
    u = torch.rand(scaled.shape, generator=gen, device=gen.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    sampled = (scaled - torch.log(-torch.log(u))).argmax(dim=-1)
    return torch.where(temperature > 0, sampled.to(torch.int32), greedy)


class ServeEngine(ServeRuntime):
    """Bit-fluid LM serving engine (whole-batch API, one device).

    ``qparams`` are serve-form parameters (``lm.quantize_params``); they
    are placed on ``device`` — CUDA unless the caller passes another.
    """

    def __init__(self, cfg, qparams, *, max_len: int = 256,
                 controller: Optional[BudgetController] = None,
                 policy: Optional[PrecisionPolicy] = None,
                 mesh=None, seed: int = 0, prefix_cache=None,
                 spec_k: Optional[int] = None,
                 draft_budget_s: Optional[float] = None, plan=None,
                 device="cuda"):
        for name, val in (("mesh", mesh), ("plan", plan),
                          ("prefix_cache", prefix_cache),
                          ("spec_k", spec_k),
                          ("draft_budget_s", draft_budget_s)):
            if val is not None:
                raise NotImplementedError(
                    f"ServeEngine({name}=...) is not ported yet: the port "
                    f"serves on one device without a prefix cache or "
                    f"speculative decoding")
        self.cfg = cfg
        self.device = cm.resolve_device(device)
        self.max_len = max_len
        n = lm.n_bit_slots(cfg)
        if controller is None:
            p = policy or _default_policy()
            controller = BudgetController({p.name: p}, {p.name: 0.0}, n)
        if controller.budget_axis != "latency":
            raise ValueError(
                f"ServeEngine budgets are LATENCY budgets (seconds) but the "
                f"controller's prediction table lives on the "
                f"{controller.budget_axis!r} axis — its budgets would "
                f"always- or never-fit; build the controller with latency "
                f"predictions")
        super().__init__(controller, n, gemms=lm.layer_gemm_dims(cfg),
                         head=lm.head_gemm_dims(cfg))
        self.qparams = _to(qparams, self.device)
        self.budget_s = torch.tensor(1e9, dtype=torch.float32)
        self.row_bits = cfg.family in lm.PER_ROW_BIT_FAMILIES
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------------------
    # Shared plumbing
    # ------------------------------------------------------------------

    def set_budget(self, seconds) -> None:
        """A scalar batch budget, or a (B,) per-request budget vector."""
        self.budget_s = torch.as_tensor(seconds, dtype=torch.float32)

    def _bits(self):
        wv, av = self.controller.resolve(self.budget_s)
        if wv.ndim == 2 and not self.row_bits:
            raise NotImplementedError(
                f"per-request budgets need per-row bit support; family "
                f"{self.cfg.family!r} serves whole-batch budgets only "
                f"(supported: {lm.PER_ROW_BIT_FAMILIES})")
        return wv.to(self.device), av.to(self.device)

    def price_budget(self, budget_s: float):
        """Per-token AP cost of the configuration a scalar budget selects."""
        return self.price_bits(*self.controller.resolve(
            torch.tensor(budget_s, dtype=torch.float32)))

    # ------------------------------------------------------------------
    # Whole-batch API
    # ------------------------------------------------------------------

    def generate(self, batch: Dict[str, torch.Tensor], steps: int, *,
                 temperature=None, top_k=None, fused: bool = True
                 ) -> torch.Tensor:
        """Generate ``steps`` tokens for one synchronous batch; returns
        (B, steps) int32 ids on the engine's device.  Greedy unless
        per-row temperature/top_k are given."""
        with self.compute_ctx():
            return self._generate(batch, steps, temperature, top_k, fused)

    def _generate(self, batch, steps, temperature, top_k, fused):
        # eager execution: fused=True and fused=False run the same loop
        del fused
        dev = self.device
        tokens = torch.as_tensor(batch["tokens"]).to(dev)
        B, S = tokens.shape
        temp = torch.zeros((B,), dtype=torch.float32, device=dev) \
            if temperature is None else torch.as_tensor(
                temperature, dtype=torch.float32).to(dev).expand(B)
        if top_k is not None and int(np.max(np.asarray(top_k))) > TOPK_MAX:
            raise ValueError(f"top_k exceeds TOPK_MAX={TOPK_MAX}")
        topk = torch.zeros((B,), dtype=torch.int32, device=dev) \
            if top_k is None else torch.as_tensor(
                top_k, dtype=torch.int32).to(dev).expand(B)
        wv, av = self._bits()
        cache = lm.empty_cache(self.cfg, B, self.max_len, device=dev)
        logits, cache = lm.prefill(self.qparams, {"tokens": tokens},
                                   self.cfg, wv, av, cache)
        tok = self._sample_first(logits, temp, topk)[:, None]
        t = torch.full((B,), S, dtype=torch.int32, device=dev)
        out = [tok]
        for _ in range(steps - 1):
            logits, cache = lm.decode_step(self.qparams, tok, t, cache,
                                           self.cfg, wv, av)
            tok = _sample_tokens(logits[:, -1], self.gen, temp,
                                 topk)[:, None]
            t = t + 1
            out.append(tok)
        self.stats.tokens += B * steps
        return torch.cat(out, dim=1)

    def _sample_first(self, logits, temp, topk):
        return _sample_tokens(logits[:, -1], self.gen, temp, topk)

    # ------------------------------------------------------------------
    # Continuous batching: not ported yet
    # ------------------------------------------------------------------

    def submit(self, *args, **kwargs):
        raise NotImplementedError(
            "continuous batching (submit/run) is not ported yet; use "
            "generate()")

    def run(self, *args, **kwargs):
        raise NotImplementedError(
            "continuous batching (submit/run) is not ported yet; use "
            "generate()")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)

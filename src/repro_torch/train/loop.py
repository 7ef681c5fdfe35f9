"""The train step: microbatched gradient accumulation, AdamW and metrics.

The counterpart of ``repro.train.loop``.  ``make_train_step(tcfg, cfg)``
returns ``step(params, opt_state, batch) -> (params, opt_state,
metrics)`` and the per-slot bit vectors ``(wvec, avec)`` it trains at.
Each of ``n_accum`` microbatches (rows ``i*B/n .. (i+1)*B/n`` of the
batch) runs one forward and one ``torch.autograd.grad`` over the
parameter leaves; the gradients accumulate as ``a + g / n`` in
``cfg.accum_dtype``.  The step neither mutates nor records a graph on
the caller's tensors: it differentiates detached aliases of them, and
returns new parameters.  The reference's ``pin`` (a sharding
constraint) is the identity off a mesh and has no counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.optim.adamw import (AdamWConfig, adamw_update, tree_leaves,
                                     tree_unflatten)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    n_accum: int = 1                    # microbatches per step
    wbits: Tuple[int, ...] = (8,)       # per-layer precision policy tables
    abits: Tuple[int, ...] = (8,)


def make_train_step(tcfg: TrainConfig, cfg, *, device="cuda"):
    """``(step, (wvec, avec))``; the bit vectors live on ``device``, where
    the step's parameters and batches are expected."""
    dev = cm.resolve_device(device)
    n = lm.n_bit_slots(cfg)
    # slot i takes entry i of a table, its last entry repeating
    wvec, avec = (torch.tensor([t[min(i, len(t) - 1)] for i in range(n)],
                               dtype=torch.int32, device=dev)
                  for t in (tcfg.wbits, tcfg.abits))
    acc_dtype = {"float32": torch.float32,
                 "bfloat16": torch.bfloat16}[cfg.accum_dtype]

    def train_step(params, opt_state, batch):
        n = tcfg.n_accum
        live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        tree = tree_unflatten(params, live)
        acc = [torch.zeros(p.shape, dtype=acc_dtype, device=p.device)
               for p in live]
        metrics = []
        for i in range(n):
            mb = {k: _split(v, n, i) for k, v in batch.items()}
            total, mets = lm.train_loss(tree, mb, cfg, wvec, avec)
            grads = torch.autograd.grad(total, live, allow_unused=True)
            for a, g in zip(acc, grads):
                if g is not None:             # an unused leaf's grad is 0
                    a.add_(g.to(acc_dtype) / n)
            del total, grads
            metrics.append({k: v.detach() for k, v in mets.items()})
        del tree, live
        new_params, new_opt, opt_metrics = adamw_update(
            params, tree_unflatten(params, acc), opt_state, tcfg.optimizer)
        # the reference builds {"loss": the mean total, **metrics, ...}, in
        # which the metrics' own "loss" (the cross-entropy averaged over
        # the microbatches) replaces the total
        out = {**{k: torch.stack([m[k] for m in metrics]).mean()
                  for k in metrics[0]},
               **opt_metrics}
        return new_params, new_opt, out

    return train_step, (wvec, avec)


def _split(x, n: int, i: int):
    """Microbatch ``i`` of ``n``: rows ``i*B/n .. (i+1)*B/n``."""
    x = torch.as_tensor(x)
    if x.shape[0] % n:
        raise ValueError(f"batch of {x.shape[0]} rows does not split into "
                         f"{n} microbatches")
    per = x.shape[0] // n
    return x[i * per:(i + 1) * per]

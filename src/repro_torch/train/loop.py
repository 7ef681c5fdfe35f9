"""The train step: microbatched gradient accumulation, AdamW and metrics.

The counterpart of ``repro.train.loop``.  ``make_train_step(tcfg, cfg)``
returns ``step(params, opt_state, batch) -> (params, opt_state,
metrics)`` and the per-slot bit vectors ``(wvec, avec)`` it trains at.
Each of ``n_accum`` microbatches (rows ``i*B/n .. (i+1)*B/n`` of the
batch) runs one forward and one ``torch.autograd.grad`` over the
parameter leaves; the gradients accumulate as ``a + g / n`` in
``cfg.accum_dtype``.  The step neither mutates nor records a graph on
the caller's tensors: it differentiates detached aliases of them, and
returns new parameters.

On a mesh (parameters placed by ``dist.sharding.shard_params``, the
optimizer state by ``adamw_init`` of them or a resharding restore) the
step runs SPMD on every rank.  ``batch`` is this rank's rows
(``dist.sharding.shard_batch``); with more than one data rank and more
than one microbatch the rows are gathered and each microbatch's
re-split, so microbatch i is the batch's rows ``i*B/n .. (i+1)*B/n``
as on one device.  Every gradient is a local block of its leaf's
layout, which is the reference's ``pin``: a weight's FSDP gather backs a
reduce-scatter, the model axis's collectives back theirs
(``dist.api``), and the leaves the data axis does not shard SUM their
accumulated gradients over it once a step.  The metrics are the
batch's: the loss and z-loss SUMmed over the data ranks' shares.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Tuple

import torch

from repro_torch.dist import api as dist
from repro_torch.dist import sharding as shd
from repro_torch.kernels import ops as kops
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.optim.adamw import (AdamWConfig, adamw_update, leaf_layouts,
                                     tree_leaves, tree_unflatten)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    n_accum: int = 1                    # microbatches per step
    wbits: Tuple[int, ...] = (8,)       # per-layer precision policy tables
    abits: Tuple[int, ...] = (8,)


def make_train_step(tcfg: TrainConfig, cfg, *, device="cuda",
                    param_shardings=None):
    """``(step, (wvec, avec))``; the bit vectors live on ``device``, where
    the step's parameters and batches are expected.  ``param_shardings``
    (``dist.sharding.param_shardings`` on the mesh) states the layout
    the step's parameters hold; a step given parameters placed otherwise
    raises."""
    dev = cm.resolve_device(device)
    n = lm.n_bit_slots(cfg)
    # slot i takes entry i of a table, its last entry repeating
    wvec, avec = (torch.tensor([t[min(i, len(t) - 1)] for i in range(n)],
                               dtype=torch.int32, device=dev)
                  for t in (tcfg.wbits, tcfg.abits))
    acc_dtype = {"float32": torch.float32,
                 "bfloat16": torch.bfloat16}[cfg.accum_dtype]
    want = (None if param_shardings is None
            else [tuple(s) for s in tree_leaves(param_shardings)])

    def train_step(params, opt_state, batch):
        lays = leaf_layouts(params)
        if want is not None:
            _check_layout(lays, want)
        mesh = next((lay[0] for lay in lays if lay is not None), None)
        dp = dist.dp_size(mesh) if mesh is not None else 1
        with contextlib.ExitStack() as ctx:
            if mesh is not None:
                ctx.enter_context(dist.use_mesh(mesh))
                ctx.enter_context(kops.split_rows(mesh if dp > 1 else None))
            grads, metrics = _accumulate(params, batch, mesh, dp)
        new_params, new_opt, opt_metrics = adamw_update(
            params, tree_unflatten(params, grads), opt_state,
            tcfg.optimizer)
        # the reference builds {"loss": the mean total, **metrics, ...}, in
        # which the metrics' own "loss" (the cross-entropy averaged over
        # the microbatches) replaces the total
        return new_params, new_opt, {**metrics, **opt_metrics}

    def _accumulate(params, batch, mesh, dp):
        n = tcfg.n_accum
        live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        tree = tree_unflatten(params, live)
        acc = [torch.zeros(p.shape, dtype=acc_dtype, device=p.device)
               for p in live]
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        if dp > 1 and n > 1:        # each microbatch split over the data
            batch = {k: mesh.all_gather(v, mesh.dp_axes, kind="gather_batch")
                     for k, v in batch.items()}
        metrics = []
        for i in range(n):
            mb = {k: _split(v, n, i) for k, v in batch.items()}
            if dp > 1 and n > 1:
                mb = shd.shard_batch(mb, mesh)
            total, mets = lm.train_loss(tree, mb, cfg, wvec, avec)
            grads = torch.autograd.grad(total, live, allow_unused=True)
            for a, g in zip(acc, grads):
                if g is not None:             # an unused leaf's grad is 0
                    a.add_(g.to(acc_dtype) / n)
            del total, grads
            metrics.append({k: v.detach() for k, v in mets.items()})
        del tree, live
        out = {k: torch.stack([m[k] for m in metrics]).mean()
               for k in metrics[0]}
        if dp > 1:
            # leaves the data axis does not shard hold this rank's rows'
            # share of their gradient; the losses are shares too
            for j, lay in enumerate(leaf_layouts(params)):
                held = () if lay is None else tuple(
                    a for e in lay[2] for a in dist.entry_axes(e))
                axes = tuple(a for a in mesh.dp_axes if a not in held)
                acc[j] = mesh.sum_grad(acc[j], axes, kind="grad_dp")
            shares = torch.stack([out["loss"], out["zloss"]])
            shares = mesh.all_reduce(shares, mesh.dp_axes, "sum",
                                     kind="metrics")
            out["loss"], out["zloss"] = shares[0], shares[1]
        return acc, out

    return train_step, (wvec, avec)


def _check_layout(lays, want) -> None:
    got = [(None,) * len(w) if lay is None else lay[2]
           for lay, w in zip(lays, want)]
    if len(lays) != len(want) or got != [tuple(w) for w in want]:
        raise ValueError("the step's parameters are not placed by its "
                         "param_shardings (dist.sharding.shard_params)")


def _split(x, n: int, i: int):
    """Microbatch ``i`` of ``n``: rows ``i*B/n .. (i+1)*B/n``."""
    x = torch.as_tensor(x)
    if x.shape[0] % n:
        raise ValueError(f"batch of {x.shape[0]} rows does not split into "
                         f"{n} microbatches")
    per = x.shape[0] // n
    return x[i * per:(i + 1) * per]

"""Deterministic synthetic data pipeline with per-rank rows and prefetch.

The counterpart of ``repro.data.pipeline``.  ``batch = f(seed, step)`` is
a pure function of numpy draws, the reference's own, so both packages
give the same bytes: restarting after a crash or re-issuing a
straggler's rows replays identical data with no iterator state to
checkpoint.  Each rank of a mesh takes only its data index's rows
(:func:`host_slice`, ``dist.sharding.shard_batch``), so the model ranks
of one data index share theirs; a background thread keeps a small
prefetch queue ahead of the training loop.

The synthetic stream is a mixture of Zipf-distributed tokens and short
repeated motifs, so models show a real (falling) loss curve without any
dataset.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.dist import api as dist_api
from repro_torch.dist import sharding as shd
from repro_torch.models.common import resolve_device


def make_batch(seed: int, step: int, batch: int, seq_len: int,
               vocab: int, cfg=None) -> dict:
    """Pure (seed, step) -> batch of CPU tensors: ``tokens`` int32 (batch,
    seq_len), and per family the modality stubs in bf16, a vlm's
    ``prefix`` (batch, n_prefix_tokens, d_model) and an encdec's
    ``frames`` (batch, max(seq_len // frames_ratio, 1), d_model)."""
    rng = np.random.default_rng(np.uint64(seed) + np.uint64(step) * 1000003)
    # Zipf body + motif repetitions (gives n-gram structure to learn)
    body = rng.zipf(1.3, size=(batch, seq_len)).astype(np.int64) % vocab
    motif_len = 16
    motif = rng.integers(0, vocab, (batch, motif_len))
    reps = seq_len // (4 * motif_len)
    for r in range(reps):
        at = (r * 4 + 1) * motif_len
        body[:, at:at + motif_len] = motif
    out = {"tokens": torch.from_numpy(body.astype(np.int32))}
    if cfg is not None and cfg.family == "vlm":
        out["prefix"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.n_prefix_tokens, cfg.d_model))).to(torch.bfloat16)
    if cfg is not None and cfg.family == "encdec":
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (batch, max(seq_len // cfg.frames_ratio, 1),
             cfg.d_model))).to(torch.bfloat16)
    return out


def host_slice(global_batch: int, mesh=None) -> slice:
    """This rank's batch rows on the active (or given) mesh: its data
    index's block over the data ranks (``dist.sharding.row_block``), and
    all rows with no mesh."""
    mesh = mesh if mesh is not None else dist_api.active_mesh()
    return shd.row_block(mesh, global_batch)


def shard_batch(batch: dict, device, mesh=None) -> dict:
    """The batch on ``device``: this rank's rows on a mesh
    (``dist.sharding.shard_batch``), every row off a mesh."""
    return {k: v.to(device) for k, v in shd.shard_batch(batch, mesh).items()}


class SyntheticLM:
    """Prefetching iterator over ``make_batch(seed, step)``: yields
    ``(step, batch)``.  With ``shard`` each batch goes through
    :func:`shard_batch` onto ``device`` (the step's device; CUDA unless
    the caller passes another) when it is taken."""

    def __init__(self, seed: int, batch: int, seq_len: int, vocab: int,
                 cfg=None, start_step: int = 0, prefetch: int = 2,
                 shard: bool = True, device="cuda"):
        self.seed, self.batch, self.seq_len, self.vocab = seed, batch, seq_len, vocab
        self.cfg = cfg
        self.shard = shard
        self.device = resolve_device(device)
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self) -> None:
        s = self.step
        while not self._stop.is_set():
            b = make_batch(self.seed, s, self.batch, self.seq_len,
                           self.vocab, self.cfg)
            try:
                self._q.put((s, b), timeout=1.0)
                s += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        s, b = self._q.get()
        self.step = s + 1
        if self.shard:
            b = shard_batch(b, self.device)
        return s, b

    def close(self) -> None:
        """Stop the prefetch thread and wait for it."""
        self._stop.set()
        self._thread.join(timeout=5.0)

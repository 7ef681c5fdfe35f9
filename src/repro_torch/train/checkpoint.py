"""Fault-tolerant checkpointing: atomic save, restore onto any device.

The counterpart of ``repro.train.checkpoint``, in its byte format, so a
checkpoint written by either package restores in the other:
``<dir>/step_%08d/arrays.npz`` holds every leaf under its nested keys
joined with ``/``; ``manifest.json`` holds the step, the sorted keys,
each key's dtype, the process index and count and ``extra``.  bfloat16
leaves are stored as their raw ``uint16`` bits with ``"bfloat16"`` in
the manifest, and come back through ``torch.int16`` -> ``torch.bfloat16``
(no ``ml_dtypes``).  A save writes into a ``.tmp_`` directory renamed
into place (atomic on POSIX), so a crash mid-save never corrupts the
latest checkpoint; the ``LATEST`` file names the newest step.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as tdist

from repro_torch.models.common import resolve_device


def _flatten(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _to_numpy(t) -> np.ndarray:
    t = torch.as_tensor(t).detach().to("cpu")
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    extra: Optional[dict] = None) -> str:
    """Atomic save of a nested dict of tensors (params, optimizer state).
    Returns the step's directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays, dtypes = {}, {}
    for k, v in _flatten(tree).items():
        dtypes[k] = str(v.dtype).replace("torch.", "")
        arrays[k] = _to_numpy(v)
    dist = tdist.is_available() and tdist.is_initialized()
    manifest = {
        "step": int(step),
        "keys": sorted(arrays.keys()),
        "dtypes": dtypes,
        "process_index": tdist.get_rank() if dist else 0,
        "process_count": tdist.get_world_size() if dist else 1,
        "extra": extra or {},
    }
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _update_latest(ckpt_dir, step)
    return final


def _update_latest(ckpt_dir: str, step: int) -> None:
    tmp = os.path.join(ckpt_dir, ".latest_tmp")
    with open(tmp, "w") as f:
        f.write(str(step))
    os.replace(tmp, os.path.join(ckpt_dir, "LATEST"))


def latest_step(ckpt_dir: str) -> Optional[int]:
    path = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return int(f.read().strip())


def _leaf(arr: np.ndarray, saved_dtype: Optional[str]) -> torch.Tensor:
    if saved_dtype == "bfloat16" and arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    if saved_dtype not in (None, str(arr.dtype)):
        raise ValueError(f"a {saved_dtype} leaf stored as {arr.dtype}: "
                         f"only bfloat16 travels as raw bits")
    return torch.from_numpy(np.array(arr, copy=True))


def restore_checkpoint(ckpt_dir: str, target: Any, *, device="cuda",
                       step: Optional[int] = None):
    """Restore into the structure of ``target`` (a nested dict of tensors,
    meta tensors included: only shapes and dtypes are read), each leaf
    cast to its target's dtype and placed on ``device``.  Returns (tree,
    step); a missing checkpoint raises ``FileNotFoundError``, a shape
    mismatch ``ValueError``."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        dtypes = json.load(f).get("dtypes", {})
    with np.load(os.path.join(d, "arrays.npz")) as data:
        flat = {}
        for key, leaf in _flatten(target).items():
            arr = _leaf(np.asarray(data[key]), dtypes.get(key))
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{tuple(arr.shape)} vs {tuple(leaf.shape)}")
            flat[key] = arr.to(leaf.dtype).to(dev)

    def rebuild(node, prefix=""):
        if isinstance(node, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in node.items()}
        return flat[prefix[:-1]]

    return rebuild(target), step

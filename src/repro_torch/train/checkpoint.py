"""Fault-tolerant checkpointing: atomic save, resharding restore onto any
device or mesh.

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

A checkpoint holds every leaf whole, whatever mesh wrote it.  On a mesh
each rank calls :func:`save_checkpoint` with its placed trees
(``dist.sharding.Local`` dicts): every placed leaf is gathered whole on
rank 0 (``Mesh.gather_whole``), rank 0 writes, and ``LATEST`` moves
only after a barrier, once the step's directory is in place.  :func:`restore_checkpoint` reads
every leaf whole and keeps this rank's block of those its target lays
out on a mesh (``shardings``, or the target's own placed dicts), so a
checkpoint written on one mesh restores onto another or onto one device.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import tempfile
import zipfile
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as tdist

from repro_torch.dist import api as dist_api
from repro_torch.dist import sharding as shd
from repro_torch.models.common import resolve_device


def _flatten(tree, prefix: str = "", lay=None) -> dict:
    """``{key: (leaf, (mesh, spec) or None)}`` in sorted-key order; the
    layout of a block of a mesh-placed leaf beside it."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            sub = None
            if isinstance(tree, shd.Local) and k in tree.layout:
                sub = (tree.mesh, tree.layout[k][1])
            out.update(_flatten(tree[k], f"{prefix}{k}/", sub))
        return out
    return {prefix[:-1]: (tree, lay)}


class _Arrays:
    """The members of an ``arrays.npz`` by key.  ``np.savez`` stores them
    uncompressed, so each is read through a read-only memory map of the
    file: a block of a leaf reads only its own bytes.  A compressed
    member is read whole."""

    def __init__(self, path: str):
        self.path = path
        self._zip = zipfile.ZipFile(path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._zip.close()

    def __getitem__(self, key: str) -> np.ndarray:
        info = self._zip.getinfo(f"{key}.npy")
        if info.compress_type != zipfile.ZIP_STORED:
            with self._zip.open(info) as f:
                return np.lib.format.read_array(f)
        with open(self.path, "rb") as f:
            f.seek(info.header_offset)
            head = f.read(30)                 # the member's local header
            name_len, extra_len = struct.unpack("<HH", head[26:30])
            f.seek(info.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                    else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read(f)
            offset = f.tell()
        if not shape or 0 in shape:
            with self._zip.open(info) as f:
                return np.lib.format.read_array(f)
        return np.memmap(self.path, dtype=dtype, mode="r", offset=offset,
                         shape=shape, order="F" if fortran else "C")


def _np_block(mesh, arr: np.ndarray, spec) -> np.ndarray:
    """This rank's block of ``arr`` laid out as ``spec`` (a view)."""
    index = []
    for d, e in zip(arr.shape, spec):
        axes = dist_api.entry_axes(e)
        n = mesh.axis_size(axes) if axes else 1
        size = d // n
        i = mesh.index(axes) if axes else 0
        index.append(slice(i * size, (i + 1) * size))
    return arr[tuple(index)]


def _group():
    """(rank, world) of the initialised process group, (0, 1) without."""
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank(), tdist.get_world_size()
    return 0, 1


def _to_numpy(t) -> np.ndarray:
    t = torch.as_tensor(t).detach().to("cpu")
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    extra: Optional[dict] = None) -> str:
    """Atomic save of a nested dict of tensors (params, optimizer state).
    Returns the step's directory.  Under a process group every rank
    calls it (SPMD): placed leaves are gathered whole, rank 0 writes."""
    rank, world = _group()
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays, dtypes = {}, {}
    for k, (v, lay) in _flatten(tree).items():
        if lay is not None:         # whole on rank 0, which writes
            mesh, spec = lay
            v = mesh.gather_whole(v, spec, kind="checkpoint")
        if rank == 0:
            dtypes[k] = str(v.dtype).replace("torch.", "")
            arrays[k] = _to_numpy(v)
        del v
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if rank == 0:
        _write(ckpt_dir, final, arrays, {
            "step": int(step),
            "keys": sorted(arrays.keys()),
            "dtypes": dtypes,
            "process_index": rank,
            "process_count": world,
            "extra": extra or {},
        })
    if world > 1:
        tdist.barrier()                 # the step is in place on disk
    if rank == 0:
        _update_latest(ckpt_dir, step)
    if world > 1:
        tdist.barrier()
    return final


def _write(ckpt_dir: str, final: str, arrays: dict, manifest: dict) -> None:
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
    """A tensor of its own memory holding ``arr`` (one copy)."""
    if saved_dtype == "bfloat16" and arr.dtype == np.uint16:
        return torch.from_numpy(np.array(arr, copy=True).view(
            np.int16)).view(torch.bfloat16)
    if saved_dtype not in (None, str(arr.dtype)):
        raise ValueError(f"a {saved_dtype} leaf stored as {arr.dtype}: "
                         f"only bfloat16 travels as raw bits")
    return torch.from_numpy(np.array(arr, copy=True))


def restore_checkpoint(ckpt_dir: str, target: Any, shardings: Any = None,
                       *, mesh=None, device="cuda",
                       step: Optional[int] = None):
    """Restore into the structure of ``target`` (a nested dict of tensors,
    meta tensors included: only shapes and dtypes are read), each leaf
    cast to its target's dtype and placed on ``device``.  Returns (tree,
    step); a missing checkpoint raises ``FileNotFoundError``, a shape
    mismatch ``ValueError``.

    ``shardings`` (a tree of ``dist.api.P`` specs mirroring ``target``,
    as ``dist.sharding.param_shardings`` / ``opt_shardings`` give them,
    on ``mesh`` or the active mesh) reshards: each leaf keeps this rank's
    block, and each dict holding blocks comes back as a
    ``dist.sharding.Local``.  A target of placed dicts (whole shapes and
    specs in their layouts) restores onto its own layout."""
    dev = resolve_device(device)
    if shardings is not None:
        mesh = mesh if mesh is not None else dist_api.active_mesh()
        if mesh is None:
            raise ValueError("restoring onto shardings needs their mesh")
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        dtypes = json.load(f).get("dtypes", {})
    with _Arrays(os.path.join(d, "arrays.npz")) as data:
        def load(key, leaf, shape, spec, mesh):
            arr = data[key]
            if tuple(arr.shape) != tuple(shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{tuple(arr.shape)} vs {tuple(shape)}")
            if any(e is not None for e in spec):
                arr = _np_block(mesh, arr, spec)
            return _leaf(arr, dtypes.get(key)).to(leaf.dtype).to(dev)

        def rebuild(node, specs, prefix=""):
            if not isinstance(node, dict):
                spec = (tuple(specs) if specs is not None
                        else (None,) * node.ndim)
                return load(prefix[:-1], node, node.shape, spec, mesh)
            at = node.mesh if isinstance(node, shd.Local) else mesh
            items, layout = {}, {}
            for k, v in node.items():
                sub = specs[k] if isinstance(specs, dict) else None
                if isinstance(v, dict):
                    items[k] = rebuild(v, sub, f"{prefix}{k}/")
                    continue
                shape, spec = tuple(v.shape), (
                    tuple(sub) if sub is not None else (None,) * v.ndim)
                if isinstance(node, shd.Local) and k in node.layout:
                    shape, spec = node.layout[k]
                items[k] = load(f"{prefix}{k}", v, shape, spec, at)
                if any(e is not None for e in spec):
                    layout[k] = (tuple(shape), tuple(spec))
            return shd.Local(items, at, layout) if layout else items

        return rebuild(target, shardings), step

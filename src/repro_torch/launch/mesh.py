"""Meshes over the initialised process group, and the card's datasheet
constants (roofline denominators).

The counterpart of ``repro.launch.mesh``.  Defined as FUNCTIONS, so
importing this module touches no process group.  The caller initialises
the gloo group first (``torch.distributed.init_process_group("gloo",
init_method="tcp://localhost:<port>", rank=r, world_size=n)``); every
rank then builds the same mesh (SPMD).

Production layouts, as the reference's: single pod ``(data=16,
model=16)``, multi-pod ``(pod=2, data=16, model=16)``, whose ``pod`` axis
is an outer data-parallel axis.  Here they are laid over whatever world
the group has: ``model`` takes min(16, world), ``pod`` 2 when the rest
splits in two; :func:`recording_production_mesh` gives one rank of the
whole 256- or 512-rank layout without a group (the lowering report).
"""
from __future__ import annotations

import torch.distributed as tdist

from repro_torch.dist.api import Mesh, RecordingMesh


def _world() -> int:
    if not tdist.is_initialized():
        raise RuntimeError("no torch.distributed process group is "
                           "initialised: call init_process_group('gloo', "
                           "...) on every rank first")
    return tdist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's axis layout over the world: ``("data", "model")``,
    or ``("pod", "data", "model")`` with ``multi_pod``."""
    n = _world()
    model = 16 if n % 16 == 0 else 1
    rest = n // model
    if multi_pod:
        if rest % 2:
            raise ValueError(f"a multi-pod mesh needs an even number of "
                             f"data ranks; the world of {n} has {rest}")
        return Mesh((2, rest // 2, model), ("pod", "data", "model"))
    return Mesh((rest, model), ("data", "model"))


# the reference's production layouts (256 and 512 chips)
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def recording_production_mesh(*, multi_pod: bool = False,
                              rank: int = 0) -> RecordingMesh:
    """One rank of the production layout with no process group (the
    lowering report's mesh: its collectives are recorded, not run)."""
    shape, names = PRODUCTION[multi_pod]
    return RecordingMesh(shape, names, rank=rank)


def make_host_mesh(model: int = 1) -> Mesh:
    """``(world // model, model)`` over ``("data", "model")``: the small
    mesh of tests and examples."""
    n = _world()
    if model < 1 or n % model:
        raise ValueError(f"model={model} must divide the {n} ranks of the "
                         f"process group")
    return Mesh((n // model, model), ("data", "model"))


# NVIDIA H100 SXM datasheet constants (roofline denominators), per card
PEAK_FLOPS_BF16 = 989e12        # dense bf16 tensor-core flop/s
PEAK_FLOPS_F32 = 67e12          # FP32 flop/s (the port leaves TF32 off)
PEAK_OPS_INT8 = 1979e12         # dense int8 tensor-core op/s
HBM_BW = 3.35e12                # device memory bytes/s
HBM_PER_CARD = 80 * 2 ** 30     # 80 GiB
# The links a collective crosses (DGX H100 datasheet): NVLink 4 within
# one 8-GPU node, 900 GB/s in all, 450e9 bytes/s each way per GPU; one
# 400 Gb/s NIC per GPU between nodes.  The lowering report prices a
# collective on NVLink when its axis group lies within one node, on the
# NIC otherwise.
NVLINK_BW = 450e9               # bytes/s per direction per GPU
NODE_GPUS = 8                   # GPUs of one NVLink node
NIC_BW = 50e9                   # bytes/s per GPU between nodes

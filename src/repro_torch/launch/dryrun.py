"""The lowering report: per-device FLOPs, bytes, memory, collectives and
a roofline of every (architecture x input shape) cell on the production
mesh, without a card or a process group.

The counterpart of ``repro.launch.dryrun``.  The reference lowers each
cell on a fake 256- or 512-device TPU mesh, compiles it and walks the
HLO.  The port's programs are eager, so :func:`report_cell` RUNS one
rank's program once, on fake tensors (``launch/specs.py``: nothing is
allocated or computed), under:

* a :class:`repro_torch.dist.RecordingMesh` at rank 0 of the production
  layout (``launch/mesh.py``), so every layout rule, local block and
  collective is that rank's, and each collective is recorded with its
  axes and the bytes of its result;
* :class:`repro_torch.launch.opcost.Cost`, which counts every aten op
  (FLOPs by type, bytes, live storages) and every kernel launch;
* ``kernels.as_card()`` for the serve cells, so the four wrappers take
  their fake branches: the launches the card would make are recorded
  under their ``launch_keys()`` keys and priced by each kernel's
  ``work``, and no plain version runs.

Serve cells run ``lm.prefill`` (``prefill_32k``) or one
``lm.decode_step`` (``decode_32k``, ``long_500k``) on the cell's local
blocks (``dist.sharding``): int8 weights (or ``--container int4``),
every bit slot at 8, the cache as ``lm.empty_cache(mesh=)`` lays it out
(the sequence over the data axis for a B=1 row; ``--kv-bits 8`` the int8
cache, sequence-sharded too).  They run on fake CUDA tensors where torch
is built with CUDA and on fake CPU tensors standing for the card's
otherwise (a CPU-only torch cannot index a fake CUDA tensor).  Train cells run the
``train/loop.make_train_step`` step with 8 microbatches (``accum_for``)
on fake CPU tensors, as the reference's lowering runs off the TPU: the
train form reaches no int8 kernel, and attention past 2048 tokens has
no backward kernel, so it takes the chunked plain version (a train
cell's ``"attention"`` says which it priced).  Every family trains and
serves on a mesh, so every planned cell runs; a cell that raises is a
failure.

Roofline denominators are the H100 SXM datasheet's (``launch/mesh.py``):
bf16, f32 and int8 peaks, HBM bandwidth, and per collective NVLink when
its axis group lies within one 8-GPU node, else the node's NIC.
Collective bytes follow the reference's convention: the bytes of each
result, all-reduce traffic counted twice.

    python -m repro_torch.launch.dryrun --arch qwen3_4b --shape decode_32k
    python -m repro_torch.launch.dryrun --all --both-meshes --out DIR
    python -m repro_torch.launch.dryrun --all --both-meshes --kv-bits 8
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import torch

from repro_torch import configs, kernels
from repro_torch.dist import api as dist
from repro_torch.dist import sharding as shd
from repro_torch.kernels import ops as kops
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import opcost
from repro_torch.launch import specs as sp
from repro_torch.models import lm
from repro_torch.models.config import SHAPES_BY_NAME
from repro_torch.train.loop import TrainConfig, make_train_step

TRAIN_ATTENTION = ("plain chunked: the card has no flash backward "
                   "(ROADMAP Queue B 3 (a))")
NO_ATTENTION = "none: the family has no attention layer"


# ---------------------------------------------------------------------------
# Cell planning
# ---------------------------------------------------------------------------

def planned_cells():
    """All (arch, shape) cells; long_500k only for sub-quadratic archs."""
    cells = []
    for arch in configs.ARCH_IDS:
        cfg = configs.get(arch)
        for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            if s == "long_500k" and not cfg.subquadratic:
                continue
            cells.append((arch, s))
    return cells


def accum_for(cfg, shape) -> int:
    """Microbatches of a train cell (8, the reference's choice); 1 for
    serving."""
    if shape.kind != "train":
        return 1
    return 8


def mesh_label(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


# ---------------------------------------------------------------------------
# Analytic FLOPs (the roofline numerator's sanity check)
# ---------------------------------------------------------------------------

def param_counts(cfg) -> dict:
    """Total, embedding (the table and the head) and active parameters
    (experts at ``experts_per_token / n_experts``)."""
    total = emb = expert = 0
    for path, leaf in shd.tree_paths(sp.abstract_params(cfg)):
        keys = shd._keys(path)
        n = leaf.numel()
        total += n
        if keys[-1] == "emb" or "head" in keys:
            emb += n
        if "experts" in keys:
            expert += n
    active = total - expert
    if cfg.n_experts:
        active += expert * cfg.experts_per_token / cfg.n_experts
    return {"total": total, "embedding": emb, "active": active}


def model_flops(cfg, shape, counts) -> float:
    """6 N_active D to train; 2 N_active D forward (prefill, decode)."""
    n = counts["active"] - counts["embedding"]
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch            # decode: one token


# ---------------------------------------------------------------------------
# Links and collectives
# ---------------------------------------------------------------------------

def link(mesh, axes) -> str:
    """``"nvlink"`` when this rank's group along ``axes`` lies within one
    node of ``NODE_GPUS`` (ranks row-major, as ``launch/mesh.py`` lays
    them), else ``"nic"``."""
    live = mesh.live_axes(axes)
    if not live:
        return "none"
    line = next(ln for ln in mesh._lines(live) if mesh.rank in ln)
    return ("nvlink" if len({r // lmesh.NODE_GPUS for r in line}) == 1
            else "nic")


def link_bw(kind: str) -> float:
    return lmesh.NVLINK_BW if kind == "nvlink" else lmesh.NIC_BW


def collective_report(mesh) -> dict:
    """The mesh's records in the reference's convention: calls and
    result bytes per collective, per axis combination with its link, the
    traffic (all-reduce twice its bytes) and its time on those links."""
    kinds: Dict[str, dict] = {}
    by_axes = []
    traffic = seconds = 0.0
    for (coll, axes), (calls, nbytes) in sorted(mesh.records.items()):
        k = kinds.setdefault(coll, {"count": 0, "bytes": 0})
        k["count"] += calls
        k["bytes"] += nbytes
        t = nbytes * (2.0 if coll == "all-reduce" else 1.0)
        lk = link(mesh, axes)
        traffic += t
        seconds += t / link_bw(lk)
        by_axes.append({"collective": coll, "axes": list(axes), "link": lk,
                        "count": calls, "bytes": nbytes})
    return {"kinds": kinds, "by_axes": by_axes, "traffic": traffic,
            "seconds": seconds,
            "by_port_kind": {k: list(v) for k, v in mesh.counts.items()}}


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

def serve_device() -> str:
    """The fake device serve cells run on: the card's where torch can
    index fake CUDA tensors (a CUDA build), else the CPU standing for
    it under ``kernels.as_card()``."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _fake_qparams(cfg, container: str, device: str):
    """The whole serve-form tree on the fake ``device``."""
    q = sp.abstract_qparams(cfg, container)
    if device == "cpu":
        return q
    with sp.fake_mode():
        return _to(q, device)


@contextlib.contextmanager
def _on(mesh, split: bool, card: bool):
    with contextlib.ExitStack() as st:
        st.enter_context(sp.fake_mode())
        if card:
            st.enter_context(kernels.as_card())
        if mesh is not None:
            st.enter_context(dist.use_mesh(mesh))
        st.enter_context(kops.split_rows(mesh if split else None))
        yield


def run_serve(cfg, shape, mesh, container: str = "int8"):
    """``(logits, Cost, argument bytes, cache bytes)`` of one serve
    cell's call on this rank's blocks, as fake tensors on
    :func:`serve_device`: the rows split over the data ranks where they
    divide (the engines' split), every bit slot at 8."""
    device = serve_device()
    B, S = shape.global_batch, shape.seq_len
    dp = dist.dp_size(mesh)
    split = dp > 1 and B % dp == 0
    rows = B // dp if split else B
    q = _fake_qparams(cfg, container, device)
    with sp.fake_mode():
        q = shd.shard_params(q, mesh)
        cache = lm.empty_cache(cfg, B, S, device=device, mesh=mesh)
        bits = torch.full((lm.n_bit_slots(cfg),), 8, dtype=torch.int32,
                          device=device)
        P = cfg.n_prefix_tokens if cfg.family == "vlm" else 0
        inputs = {"tokens": torch.empty(
            (rows, S - P if shape.kind == "prefill" else 1),
            dtype=torch.int32, device=device)}
        if P and shape.kind == "prefill":
            inputs["prefix"] = torch.empty((rows, P, cfg.d_model),
                                           dtype=torch.bfloat16,
                                           device=device)
        if cfg.family == "encdec" and shape.kind == "prefill":
            inputs["frames"] = torch.empty(
                (rows, S // cfg.frames_ratio, cfg.d_model),
                dtype=torch.bfloat16, device=device)
    args = opcost.tree_bytes(q, inputs, cache)
    cache_bytes = opcost.tree_bytes(cache)
    with _on(mesh, split, True), opcost.Cost() as cost:
        if shape.kind == "prefill":
            logits, _ = lm.prefill(q, inputs, cfg, bits, bits, cache)
        else:
            logits, _ = lm.decode_step(q, inputs["tokens"], S - 1, cache,
                                       cfg, bits, bits)
    return logits, cost, args, cache_bytes


def run_train(cfg, shape, mesh):
    """``(new state, Cost, argument bytes)`` of one train cell's step on
    fake CPU tensors."""
    ocfg = sp.optimizer_for(cfg)
    tcfg = TrainConfig(optimizer=ocfg, n_accum=accum_for(cfg, shape))
    whole = sp.abstract_params(cfg)
    from repro_torch.optim.adamw import adamw_init
    with sp.fake_mode():
        params = shd.shard_params(whole, mesh)
        opt = adamw_init(params, ocfg)
        batch = shd.shard_batch(sp.input_specs(cfg, shape), mesh)
        step, _ = make_train_step(tcfg, cfg, device="cpu",
                                  param_shardings=shd.param_shardings(
                                      whole, mesh))
    args = opcost.tree_bytes(params, opt, batch)
    with sp.fake_mode(), opcost.Cost() as cost:
        out = step(params, opt, batch)
    return out, cost, args


def report_cell(arch: str, shape_name: str, multi_pod: bool = False,
                container: str = "int8", kv_bits: int = 0) -> dict:
    """One cell's report (the reference's ``lower_cell`` sections, named
    for what the port measures).  ``kv_bits=8`` serves a serve cell on
    the int8 KV cache (``cfg.with_(kv_cache_bits=8)``, as the
    reference's ``--kv-bits``); a train cell has no cache."""
    cfg = configs.get(arch)
    shape = SHAPES_BY_NAME[shape_name]
    if kv_bits and shape.kind != "train":
        cfg = cfg.with_(kv_cache_bits=kv_bits)
    label = mesh_label(multi_pod)
    head = {"arch": arch, "shape": shape_name, "mesh": label,
            "chips": 512 if multi_pod else 256, "kind": shape.kind,
            "kv_cache_bits": cfg.kv_cache_bits}
    mesh = lmesh.recording_production_mesh(multi_pod=multi_pod)
    t0 = time.perf_counter()
    cache_bytes = None
    if shape.kind == "train":
        out, cost, args = run_train(cfg, shape, mesh)
        outs = opcost.tree_bytes(out[0], out[1])
    else:
        out, cost, args, cache_bytes = run_serve(cfg, shape, mesh,
                                                 container)
        outs = opcost.tree_bytes(out)
    t_run = time.perf_counter() - t0
    coll = collective_report(mesh)
    counts = param_counts(cfg)
    mf = model_flops(cfg, shape, counts)
    fl = dict(cost.flops)
    bf16, f32, i8 = fl.pop("bf16", 0.0), fl.pop("f32", 0.0), \
        fl.pop("int8", 0.0)
    other = sum(fl.values())
    floor = cost.bytes_floor + coll["traffic"]
    peak = args + cost.peak_bytes
    res = {
        **head, "time_s": t_run, "aten_ops": cost.ops,
        "memory": {"argument_bytes": args, "cache_bytes": cache_bytes,
                   "output_bytes": outs,
                   "transient_peak_bytes": cost.peak_bytes,
                   "peak_bytes_per_device": peak,
                   "fits_hbm_80g": bool(peak <= lmesh.HBM_PER_CARD)},
        "cost": {"flops_bf16_per_device": bf16,
                 "flops_f32_per_device": f32,
                 "ops_int8_per_device": i8,
                 "flops_other_per_device": {k: v for k, v in fl.items()},
                 "bytes_per_device": cost.bytes + coll["traffic"],
                 "bytes_floor_per_device": floor},
        "kernels": {"launches": [list(k) + [n] for k, n in
                                 sorted(cost.kernels.items(), key=str)],
                    "work": {k: {"ops": w[0], "bytes": w[1],
                                 "bound_s": w[2]}
                             for k, w in cost.kernel_work.items()}},
        "collectives": coll["kinds"],
        "collectives_by_axes": coll["by_axes"],
        "collective_kinds_port": coll["by_port_kind"],
        "links": {a: link(mesh, (a,)) for a in mesh.axis_names},
        "collective_bytes_per_device": coll["traffic"],
        "model_flops_global": mf,
        "params": counts,
        "roofline": {
            "compute_s": (bf16 / lmesh.PEAK_FLOPS_BF16
                          + (f32 + other) / lmesh.PEAK_FLOPS_F32
                          + i8 / lmesh.PEAK_OPS_INT8),
            "memory_s": floor / lmesh.HBM_BW,
            "collective_s": coll["seconds"],
            "model_flops_ratio": ((mf / head["chips"])
                                  / max(bf16 + f32 + i8 + other, 1.0)),
        },
    }
    if shape.kind == "train":
        res["attention"] = (NO_ATTENTION if cfg.family == "ssm"
                            else TRAIN_ATTENTION)
    terms = res["roofline"]
    dom = max(("compute_s", "memory_s", "collective_s"),
              key=lambda k: terms[k])
    terms["dominant"] = dom.replace("_s", "")
    return res


def one_device_calls(cfg, batch: int, seq: int, *, max_len: int,
                     device: Optional[str] = None,
                     container: str = "int8") -> dict:
    """``lm.prefill`` of ``batch`` x ``seq`` tokens, then one
    ``lm.decode_step``, on one device (no mesh), on fake tensors standing
    for the card's, every bit slot at 8: ``{"args": argument bytes
    (qparams, cache, tokens), "peak": the high-water mark of what the two
    calls allocate (their outputs kept), "prefill"/"decode": each call's
    Cost, "kernels": their launches by key}``."""
    device = device or serve_device()
    q = _fake_qparams(cfg, container, device)
    with sp.fake_mode():
        cache = lm.empty_cache(cfg, batch, max_len, device=device)
        tokens = torch.empty((batch, seq), dtype=torch.int32, device=device)
        tok = torch.empty((batch, 1), dtype=torch.int32, device=device)
        bits = torch.full((lm.n_bit_slots(cfg),), 8, dtype=torch.int32,
                          device=device)
    args = opcost.tree_bytes(q, cache, tokens)
    with _on(None, False, True), opcost.Cost() as both:
        with opcost.Cost() as pre:
            logits, cache = lm.prefill(q, {"tokens": tokens}, cfg, bits,
                                       bits, cache)
        with opcost.Cost() as dec:
            step, cache = lm.decode_step(q, tok, seq, cache, cfg, bits, bits)
    return {"args": args, "peak": both.peak_bytes, "prefill": pre,
            "decode": dec, "kernels": dict(both.kernels)}


def roofline_s(cost: opcost.Cost) -> float:
    """One device's roofline time of a call: the larger of its compute
    and memory terms (datasheet peaks by type, HBM over its byte
    floor)."""
    fl = dict(cost.flops)
    compute = (fl.pop("bf16", 0.0) / lmesh.PEAK_FLOPS_BF16
               + fl.pop("int8", 0.0) / lmesh.PEAK_OPS_INT8
               + sum(fl.values()) / lmesh.PEAK_FLOPS_F32)
    return max(compute, cost.bytes_floor / lmesh.HBM_BW)


def serve_run(cfg, mesh, q, tokens: torch.Tensor, *, steps: int,
              max_len: int, reuse: bool = False,
              frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``lm.prefill`` of ``tokens`` (B, S) then ``steps`` decode steps
    (each feeding the prompt's last token) with every bit slot at 8, on
    ``mesh`` (None: one device): the whole serve-form ``q`` placed by
    ``dist.sharding.shard_params``, the rows split over the data ranks
    where they divide, the cache as ``lm.empty_cache(mesh=)`` lays it out.
    ``reuse`` gathers each FSDP weight once for the whole run, as
    ``ServeEngine.generate`` does.  Real or fake tensors alike: the
    program :func:`predict_counts` records.  An encdec batch's
    ``frames`` (B, F, d) split with the rows.  Returns the last logits."""
    dev = tokens.device
    B, S = tokens.shape
    dp = dist.dp_size(mesh) if mesh is not None else 1
    split = mesh is not None and dp > 1 and B % dp == 0
    rows = (slice(mesh.dp_index * (B // dp), (mesh.dp_index + 1) * (B // dp))
            if split else slice(None))
    if mesh is not None:
        q = shd.shard_params(q, mesh)
    n = lm.n_bit_slots(cfg)
    bits = torch.full((n,), 8, dtype=torch.int32, device=dev)
    cache = lm.empty_cache(cfg, B, max_len, device=dev, mesh=mesh)
    with contextlib.ExitStack() as st:
        if mesh is not None:
            st.enter_context(dist.use_mesh(mesh))
            if reuse:
                st.enter_context(mesh.reuse_gathers())
        st.enter_context(kops.split_rows(mesh if split else None))
        inputs = {"tokens": tokens[rows]}
        if frames is not None:
            inputs["frames"] = frames[rows]
        logits, cache = lm.prefill(q, inputs, cfg, bits, bits, cache)
        tok = tokens[rows, -1:]
        for i in range(steps):
            logits, cache = lm.decode_step(q, tok, S + i, cache, cfg, bits,
                                           bits)
    return logits


def predict_counts(cfg, mesh_shape, *, batch: int, prompt: int,
                   steps: int, max_len: int, reuse: bool = False,
                   frames: int = 0) -> Dict[str, list]:
    """The ``Mesh.counts`` one rank of a ``mesh_shape`` mesh makes for
    :func:`serve_run` of ``batch`` x ``prompt`` tokens (behind ``frames``
    encoder frames for encdec) and ``steps`` decode steps, recorded by a
    :class:`RecordingMesh` on fake CPU tensors.
    ``ServeEngine.generate`` of ``new`` tokens is ``steps=new - 1,
    reuse=True``."""
    mesh = dist.RecordingMesh(mesh_shape)
    q = sp.abstract_qparams(cfg)
    with sp.fake_mode():
        tokens = torch.empty((batch, prompt), dtype=torch.int32)
        fr = (torch.empty((batch, frames, cfg.d_model), dtype=torch.bfloat16)
              if frames else None)
        serve_run(cfg, mesh, q, tokens, steps=steps, max_len=max_len,
                  reuse=reuse, frames=fr)
    return {k: list(v) for k, v in mesh.counts.items()}


# ---------------------------------------------------------------------------

def _summary(res: dict, tag: str) -> str:
    r, m = res["roofline"], res["memory"]
    return (f"[ok  ] {tag}: run={res['time_s']:.1f}s "
            f"peak={m['peak_bytes_per_device'] / 2 ** 30:.2f}GiB "
            f"fits={m['fits_hbm_80g']} compute={r['compute_s']:.4g}s "
            f"memory={r['memory_s']:.4g}s "
            f"collective={r['collective_s']:.4g}s dom={r['dominant']}")


def _run_all(args) -> int:
    meshes = [False, True] if args.both_meshes else [bool(args.multi_pod)]
    failed, ok = [], 0
    todo = [(arch, shape, mp, f"{arch}.{shape}.{mesh_label(mp)}")
            for arch, shape in planned_cells() for mp in meshes]
    env = dict(os.environ, OMP_NUM_THREADS="1")

    def run(cell):
        arch, shape, mp, tag = cell
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", args.out, "--container",
               args.container, "--kv-bits", str(args.kv_bits)] + (
                   ["--multi-pod"] if mp else [])
        return tag, subprocess.run(cmd, capture_output=True, text=True,
                                   env=env)

    # one single-threaded subprocess a core this process may run on
    with ThreadPoolExecutor(len(os.sched_getaffinity(0))) as pool:
        for tag, r in pool.map(run, todo):
            if r.returncode != 0:
                failed.append(tag)
                print(f"[FAIL] {tag}\n{r.stdout[-2000:]}\n"
                      f"{r.stderr[-4000:]}", flush=True)
            else:
                ok += 1
                print(r.stdout.strip().splitlines()[-1], flush=True)
    print(f"\n{ok} ok, {len(failed)} failed: {failed}")
    return 1 if failed else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="report every planned cell, each in a subprocess")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--container", default="int8", choices=("int8", "int4"))
    ap.add_argument("--kv-bits", type=int, default=0, choices=(0, 8),
                    help="the int8 KV cache for serve cells")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.all:
        return _run_all(args)
    if not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    arch = configs.canonical(args.arch)
    res = report_cell(arch, args.shape, args.multi_pod, args.container,
                      args.kv_bits)
    tag = f"{arch}.{args.shape}.{res['mesh']}"
    with open(os.path.join(args.out, tag + ".json"), "w") as f:
        json.dump(res, f, indent=1)
    print(_summary(res, tag))
    return 0


if __name__ == "__main__":
    sys.exit(main())

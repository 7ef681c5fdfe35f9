"""Training driver: data pipeline -> train step -> checkpoint/restart ->
straggler watchdog.

The counterpart of ``repro.launch.train``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_4b --smoke \\
      --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--device cpu] \\
      [--tp 2] [--ranks 2]

Runs on CUDA unless ``--device`` names another device.  A restart with the
same ``--ckpt-dir`` resumes from the latest atomic checkpoint, and the
data pipeline replays the steps after it.

On more than one rank it trains on ``launch.mesh.make_host_mesh(model=
--tp)``, a ``(world // tp, tp)`` mesh: FSDP over the data axis, Megatron
tensor parallelism (and MoE expert parallelism) over the model axis.  The
gloo process group is the caller's when one is initialised, else the one
``torchrun`` describes (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``), else the launcher spawns ``max(--ranks, --tp)`` ranks
itself on a local port.  Every rank places the parameters and the
optimizer state by ``dist.sharding.param_shardings`` /
``opt_shardings``, takes its data index's rows, restores a checkpoint
onto those shardings (whatever mesh wrote it) and trains SPMD; rank 0
prints.  A CUDA rank trains on card ``rank % device_count``.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import queue
import socket
import time

import torch
import torch.distributed as tdist

from repro_torch import configs
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.dist import api as dist
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamWConfig, adamw_init, tree_map
from repro_torch.train.checkpoint import (latest_step, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.loop import TrainConfig, make_train_step
from repro_torch.train.watchdog import StragglerWatchdog


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3_4b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--wbits", type=int, nargs="+", default=[8])
    ap.add_argument("--abits", type=int, nargs="+", default=[8])
    ap.add_argument("--tp", type=int, default=1,
                    help="model-parallel ways of the host mesh")
    ap.add_argument("--ranks", type=int, default=1,
                    help="ranks to spawn when no process group is given "
                         "(at least --tp)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if tdist.is_available() and tdist.is_initialized():
        return _train(args)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:      # torchrun
        tdist.init_process_group("gloo", init_method="env://",
                                 timeout=datetime.timedelta(minutes=10))
        try:
            return _train(args)
        finally:
            tdist.destroy_process_group()
    world = max(args.ranks, args.tp)
    if world > 1:
        return _spawn(argv, world)
    return _train(args)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank: int, world: int, port: int, argv, results) -> None:
    """One spawned rank: join the group, train, report rank 0's result."""
    try:
        if torch.get_num_threads() > 1:
            torch.set_num_threads(max(1, torch.get_num_threads() // world))
        tdist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(minutes=10))
        try:
            out = _train(parse_args(argv))
        finally:
            tdist.destroy_process_group()
        results.put((rank, out, None))
    except BaseException as e:          # the parent names the failed rank
        results.put((rank, None, f"{type(e).__name__}: {e}"))
        raise


def _spawn(argv, world: int) -> dict:
    """Train on ``world`` spawned gloo ranks; returns rank 0's result."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, world, port, argv, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out, errors, pending = None, [], world
    try:
        while pending:
            try:
                rank, res, err = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    errors.append(f"a rank exited with code {dead[0]}")
                    break
                continue
            pending -= 1
            if err is not None:
                errors.append(f"rank {rank}: {err}")
                break
            if rank == 0:
                out = res
    finally:
        for p in procs:
            if errors:
                p.terminate()
            p.join()
    if errors or any(p.exitcode != 0 for p in procs):
        raise RuntimeError("training ranks failed: " + "; ".join(
            errors or [f"exit codes {[p.exitcode for p in procs]}"]))
    return out


def _device(name: str) -> torch.device:
    """The rank's device: ``cuda`` means card ``rank % device_count``."""
    dev = cm.resolve_device(name)
    if (dev.type == "cuda" and dev.index is None and tdist.is_available()
            and tdist.is_initialized()):
        dev = torch.device("cuda", tdist.get_rank()
                           % torch.cuda.device_count())
    return dev


def _train(args) -> dict:
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=args.lr),
                       n_accum=args.accum,
                       wbits=tuple(args.wbits), abits=tuple(args.abits))
    dev = _device(args.device)
    mesh = None
    world = tdist.get_world_size() if tdist.is_initialized() else 1
    if args.tp > 1 or world > 1:
        mesh = make_host_mesh(model=args.tp)
        if mesh.rank == 0:
            print(f"[train] mesh {dict(mesh.shape)}")
        rows = dist.dp_size(mesh) * args.accum
        if args.batch % rows:
            raise ValueError(f"--batch {args.batch} does not split over "
                             f"{dist.dp_size(mesh)} data ranks x "
                             f"{args.accum} microbatches")
        with dist.use_mesh(mesh):
            return run(args, cfg, tcfg, dev, mesh)
    return run(args, cfg, tcfg, dev)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args, cfg, tcfg: TrainConfig, dev: torch.device, mesh=None) -> dict:
    """Train ``args.steps`` steps (on ``mesh``'s ranks, each calling it)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init_params(cfg, gen, device=dev)
    p_shd = o_shd = None
    if mesh is not None:
        whole = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                               device="meta"), params)
        p_shd = shd.param_shardings(whole, mesh)
        params = shd.shard_params(params, mesh)
    opt = adamw_init(params, tcfg.optimizer)
    step_fn, _ = make_train_step(tcfg, cfg, device=dev,
                                 param_shardings=p_shd)
    lead = mesh is None or mesh.rank == 0
    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        if mesh is None:
            restored, start = restore_checkpoint(
                args.ckpt_dir, {"params": params, "opt": opt}, device=dev)
        else:
            # the whole shapes, resharded onto this mesh's shardings
            whole_opt = adamw_init(whole, tcfg.optimizer)
            o_shd = shd.opt_shardings(whole_opt, mesh)
            restored, start = restore_checkpoint(
                args.ckpt_dir, {"params": whole, "opt": whole_opt},
                {"params": p_shd, "opt": o_shd}, mesh=mesh, device=dev)
        params, opt = restored["params"], restored["opt"]
        if lead:
            print(f"[train] resumed from step {start}")

    data = SyntheticLM(seed=0, batch=args.batch, seq_len=args.seq + 1,
                       vocab=cfg.vocab_size, cfg=cfg, start_step=start,
                       device=dev)
    wd = StragglerWatchdog()
    t_start = time.time()
    step, loss = start - 1, float("nan")
    try:
        for _ in range(args.steps):
            step, batch = next(data)
            wd.start()
            params, opt, metrics = step_fn(params, opt, batch)
            _sync(dev)                   # a step's time is the device's
            dt = wd.stop(step)
            loss = float(metrics["loss"])
            if lead and (step % args.log_every == 0 or step == start):
                print(f"[train] step={step} loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} {dt:.2f}s",
                      flush=True)
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                save_checkpoint(args.ckpt_dir, step + 1,
                                {"params": params, "opt": opt})
                if lead:
                    print(f"[train] checkpoint @ {step + 1}", flush=True)
    finally:
        data.close()
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, step + 1,
                        {"params": params, "opt": opt})
    out = {"final_loss": loss, "steps": args.steps, "start": start,
           "device": str(dev),
           "mesh": None if mesh is None else dict(mesh.shape)}
    if lead:
        print(f"[train] done: {args.steps} steps in "
              f"{time.time() - t_start:.1f}s; stragglers flagged: "
              f"{len(wd.events)}")
        print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

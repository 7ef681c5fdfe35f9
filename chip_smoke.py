#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and hold its
hand-written kernels against their plain PyTorch versions.

    python3 chip_smoke.py            # from the root of a checkout

The main path is bit-fluid ResNet18 serving at full width (224x224x3
images, 1000 classes, random weights from a seed): each image's EDP
budget resolves through the HAWQ-V3 budget controller into a per-layer
bit vector, every conv/fc GEMM runs through the bit-plane CUDA kernel once
per bit family, and the AP cost model prices each image.

Phases, in order; any failure ends the run with a nonzero exit and no
result line:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the kernel from the checkout's sources (nvcc), timed;
  3. the kernel equals its plain version (torch.equal) for n_planes 1..8
     on edge shapes and at every GEMM shape of the main path;
  4. serve batches through CNNServeEngine with budgets spanning all five
     HAWQ-V3 configurations; check logits, bits, per-image EDP, the
     kernel's launch count, logits equal to the same forward with its
     GEMMs routed through the plain version, and a small-input run that
     agrees with the port on the CPU;
  5. timings, each beside the card's name and power limit: ms per served
     batch and images/s, and per GEMM shape the kernel's ms, the plain
     version's, torch._int_mm's (the library yardstick) and the bound;
  6. a torch.profiler trace of one served batch: the device's busy time
     and idle share, and device time by kernel name.

The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

BATCH = 16            # images per served batch (the engine's max_batch)
IMAGE = 224
SERVED = 5            # batches on the main path; the first one warms up
REPS = 20             # timed launches per kernel shape
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8 tensor-core peak
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/bitplane_matmul.cu"
REPLACES = "src/repro/kernels/bitplane_matmul.py:71"
EDGE_SHAPES = [(1, 1, 1), (1, 512, 1000), (3, 147, 64), (130, 147, 65),
               (129, 64, 128), (257, 576, 63), (64, 33, 7), (200, 4608, 24)]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(res.returncode == 0 and res.stdout.strip() != "",
          f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def path_gemms(layers, batch: int, image: int):
    """(layer, M, K, N) of every GEMM the serve forward runs, in order,
    from the real spatial sizes (the forward follows these, not the
    table's: at 224 the maxpool leaves 55x55, not 56x56)."""
    out, h, h_block = [], image, None
    for l in layers:
        if l.kind == "conv":
            if h_block is None:
                h_block = h
            down = l.name.endswith("_down")
            ho = ((h_block if down else h) - l.hk + 2 * l.pad) // l.stride + 1
            out.append((l.name, batch * ho * ho, l.hk * l.wk * l.cin, l.cout))
            if not down:
                h = ho
        elif l.kind in ("maxpool", "avgpool"):
            h, h_block = (h - l.hk) // l.stride + 1, None
        elif l.kind == "add":
            h_block = None
        elif l.kind == "fc":
            out.append((l.name, batch, l.cin, l.cout))
    return out


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script measures the "
             "port on a GPU")
    from repro_torch.apsim import metrics as apm
    from repro_torch.core.policy import cnn_budget_controller
    from repro_torch.kernels import bitplane_matmul as bpm
    from repro_torch.kernels import cuda_build, ops
    from repro_torch.models import cnn
    from repro_torch.serve.cnn import CNNServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 1. the card
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")
    tag = f"[{card}]"

    # ---- 2. build
    t0 = time.perf_counter()
    cuda_build.load("bitplane_matmul")
    print(f"build: bitplane_matmul.cu -> "
          f"{cuda_build.library_path('bitplane_matmul').relative_to(ROOT)} "
          f"in {time.perf_counter() - t0:.3f} s (nvcc "
          f"{cuda_build.build_seconds.get('bitplane_matmul', 0.0):.3f} s)")

    # ---- 3. kernel == plain version
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand_i8(shape):
        return torch.randint(-128, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    max_err = 0

    def hold(x, w, n):
        nonlocal max_err
        got = bpm.bitplane_matmul(x, w, n_planes=n)
        want = bpm.bitplane_matmul_ref(x, w, n)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max()) if got.numel() \
            else 0
        max_err = max(max_err, err)
        check(torch.equal(got, want), f"kernel != plain version at "
              f"{tuple(x.shape)} @ {tuple(w.shape)}, n_planes={n}, "
              f"max |err| {err}")

    for n in range(1, 9):
        for M, K, N in EDGE_SHAPES:
            hold(rand_i8((M, K)), rand_i8((K, N)), n)
    print(f"kernel == plain: n_planes 1..8 on {len(EDGE_SHAPES)} edge shapes")

    gen_cpu = torch.Generator().manual_seed(0)
    params, layers = cnn.init_cnn("resnet18", gen_cpu, device=dev)
    gemms = path_gemms(layers, BATCH, IMAGE)
    check(len(gemms) == 21, f"expected 21 GEMM layers, got {len(gemms)}")
    ctrl = cnn_budget_controller("resnet18", layers=layers)
    engine = CNNServeEngine(params, layers, controller=ctrl,
                            max_batch=BATCH, device=dev)
    fams = engine.families
    check(fams == (4, 8), f"bit families {fams}, expected (4, 8)")
    shapes = sorted({(M, K, N) for _, M, K, N in gemms})
    for M, K, N in shapes:
        for n in fams:
            hold(rand_i8((M, K)), rand_i8((K, N)), n)
    print(f"kernel == plain: {len(shapes)} ResNet18@{IMAGE} GEMM shapes at "
          f"B={BATCH} x n_planes {fams}: "
          + ", ".join(f"({M},{K},{N})" for M, K, N in shapes))

    # ---- 4. serve the main path
    preds = [ctrl.predicted_latency_s[k] for k in ctrl.order()]
    tight, loose = 0.0, 1e30
    cycle = [tight] + [p * 1.01 for p in preds] + [loose]
    budgets = [cycle[i % len(cycle)] for i in range(BATCH)]
    img_gen = torch.Generator(device=dev).manual_seed(1)
    images = torch.randn((BATCH, IMAGE, IMAGE, 3), generator=img_gen,
                         device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bpm.reset_launches()
    batch_s, outs = [], []
    for _ in range(SERVED):
        t0 = time.perf_counter()
        logits, stats = engine.serve(images, budgets)   # ends in a sync
        batch_s.append(time.perf_counter() - t0)
        outs.append((logits, stats))
    launches = dict(bpm.launches)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20

    per_batch = len(gemms) * len(fams)
    check(sum(launches.values()) == per_batch * SERVED,
          f"kernel launches {launches}, expected {per_batch} per batch x "
          f"{SERVED} batches")
    check({n for n, c in launches.items() if c} == set(fams),
          f"launches at n_planes outside the families {fams}: {launches}")
    check(all(launches[n] == len(gemms) * SERVED for n in fams),
          f"launches per family {launches}")
    logits, stats = outs[-1]
    check(logits.shape == (BATCH, 1000), f"logits shape {logits.shape}")
    check(bool(np.isfinite(logits).all()), "non-finite logits")
    for lg, _ in outs[1:]:
        check(np.array_equal(lg, logits), "batches of the same input differ")
    for b, s in zip(budgets, stats):
        if b == tight:
            check(s.mean_wbits == 4.0, f"tightest budget -> {s.mean_wbits}")
        if b == loose:
            check(s.mean_wbits == 8.0, f"unconstrained -> {s.mean_wbits}")
    check(len({s.wbits for s in stats}) == 5,
          "budgets did not span the five HAWQ-V3 configurations")
    costs = apm.price_bit_matrix(apm.network_gemms(layers),
                                 [s.wbits for s in stats],
                                 [s.abits for s in stats])
    check([c.edp for c in costs] == [s.edp for s in stats],
          "per-image EDP differs from the AP model's price of its bits")

    seen = []

    def plain_gemm(x_q, w_q, *, n_planes):
        seen.append((tuple(x_q.shape), w_q.shape[1], n_planes))
        return bpm.bitplane_matmul_ref(x_q, w_q, n_planes)

    with mock.patch.object(ops, "bitplane_matmul", plain_gemm):
        plain_logits, _ = engine.serve(images, budgets)
    want_seen = [((M, K), N, n) for _, M, K, N in gemms for n in fams]
    check(seen == want_seen, "the forward's GEMM shapes differ from the "
          "ones the kernel was held at")
    check(np.array_equal(plain_logits, logits),
          f"kernel logits != plain-version logits, max |diff| "
          f"{np.abs(plain_logits - logits).max()}")
    print(f"served {SERVED} batches of {BATCH} x {IMAGE}x{IMAGE}x3 -> "
          f"(B, 1000) logits: finite; mean wbits "
          f"{sorted({s.mean_wbits for s in stats})}; kernel launches "
          f"{ {n: c for n, c in launches.items() if c} } = {per_batch} per "
          f"batch; per-image EDP == price_bit_matrix; logits == plain-version "
          f"forward on the card; peak memory {peak_mb:.1f} MiB")

    # small input: the engine on the card agrees with the port on the CPU
    # (integer GEMMs are exact and the float math rounds identically, so
    # equality is expected; held to 1e-3 of the largest logit, equal argmax)
    g32 = torch.Generator().manual_seed(2)
    p32, l32 = cnn.init_cnn("resnet18", g32, image=32, device="cpu")
    c32 = cnn_budget_controller("resnet18", layers=l32)
    x32 = torch.randn((4, 32, 32, 3), generator=g32)
    b32 = [tight, preds[1] * 1.01, preds[3] * 1.01, loose]
    gpu32, s_gpu = CNNServeEngine(p32, l32, controller=c32, max_batch=4,
                                  device=dev).serve(x32, b32)
    cpu32, s_cpu = CNNServeEngine(p32, l32, controller=c32, max_batch=4,
                                  device="cpu").serve(x32, b32)
    diff = float(np.abs(gpu32 - cpu32).max())
    check(diff <= 1e-3 * float(np.abs(cpu32).max())
          and np.array_equal(gpu32.argmax(-1), cpu32.argmax(-1)),
          f"card vs CPU at 32 px: max |diff| {diff}")
    check([s.edp for s in s_gpu] == [s.edp for s in s_cpu],
          "card vs CPU per-image EDP")
    print(f"small input (ResNet18@32, B=4): card vs CPU max |logit diff| "
          f"{diff}, argmax equal")

    # ---- 5. timings
    med = statistics.median(batch_s[1:])
    print(f"{tag} serve: median {med * 1e3:.3f} ms per batch of {BATCH} "
          f"({BATCH / med:.1f} images/s) over {SERVED - 1} batches after "
          f"one warm-up; all batch ms "
          f"{[round(t * 1e3, 3) for t in batch_s]}")

    def time_ms(fn) -> float:
        for _ in range(3):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / REPS

    def pad_to(t, rows, cols):
        return torch.nn.functional.pad(t, (0, cols - t.shape[1],
                                           0, rows - t.shape[0]))

    per_shape = {}
    for M, K, N in shapes:
        for n in fams:
            x, w = rand_i8((M, K)), rand_i8((K, N))
            k_ms = time_ms(lambda: bpm.bitplane_matmul(x, w, n_planes=n))
            p_ms = time_ms(lambda: bpm.bitplane_matmul_ref(x, w, n))
            # library yardstick: one torch._int_mm on the sign-extended
            # weights, zero-padded where its shape rules need it (M > 16,
            # K and N multiples of 8); the padding is not timed
            Mp, Kp, Np = max(M, 17), -(-K // 8) * 8, -(-N // 8) * 8
            xl = pad_to(x, Mp, Kp)
            wl = pad_to(bpm.sign_extend_field(w, n), Kp, Np)
            l_ms = time_ms(lambda: torch._int_mm(xl, wl))
            nbytes = M * K + K * N + 4 * M * N
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = 2.0 * M * N * K / INT8_OPS_PER_S * 1e3
            per_shape[(M, K, N, n)] = (k_ms, p_ms, l_ms, t_bytes, t_ops)
            print(f"{tag} bitplane_matmul ({M},{K},{N}) n_planes={n}: "
                  f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                  f"torch._int_mm {l_ms:.4f} ms"
                  f"{' (padded)' if (Mp, Kp, Np) != (M, K, N) else ''}, "
                  f"bound {max(t_bytes, t_ops):.4f} ms "
                  f"({'bytes' if t_bytes >= t_ops else 'operations'}), "
                  f"{max(t_bytes, t_ops) / k_ms:.3f} of bound")

    # one served batch's 42 launches, summed over the path's layers
    k_ms = p_ms = l_ms = t_bytes = t_ops = bound_ms = 0.0
    for _, M, K, N in gemms:
        for n in fams:
            k, p, lib, tb, to = per_shape[(M, K, N, n)]
            k_ms, p_ms, l_ms = k_ms + k, p_ms + p, l_ms + lib
            t_bytes, t_ops = t_bytes + tb, t_ops + to
            bound_ms += max(tb, to)
    print(f"{tag} bitplane_matmul per served batch ({per_batch} launches): "
          f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, torch._int_mm "
          f"{l_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_ms / k_ms:.3f} of bound); batch wall {med * 1e3:.3f} ms")

    # ---- 6. where one served batch's time goes (torch.profiler trace)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.serve(images, budgets)
        traced_s = time.perf_counter() - t0
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    check(dev_events != [], "the profiler recorded no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev_events)
    busy_us, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy_us, cur_s = busy_us + cur_e - cur_s, s
        cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    by_name: dict = {}
    for e in dev_events:
        key = e.name.replace("(anonymous namespace)::", "")
        key = key.removeprefix("void ").split("(")[0][:90]
        by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us()
    dev_total = sum(by_name.values())
    bp_us = sum(us for k, us in by_name.items() if "bitplane_matmul" in k)
    print(f"{tag} trace of one served batch: wall {traced_s * 1e3:.3f} ms "
          f"(profiler on), device busy {busy_us / 1e3:.3f} ms, idle share "
          f"{1 - busy_us / 1e3 / (traced_s * 1e3):.3f}; {len(dev_events)} "
          f"device ops, {dev_total / 1e3:.3f} ms summed, bit-plane kernel "
          f"{bp_us / 1e3:.3f} ms ({bp_us / dev_total:.3f} of device time)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"{tag}   {us / 1e3:8.3f} ms  {us / dev_total:6.3f}  {name}")

    summary = {"kernels": [{
        "name": "bitplane_matmul", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": sum(launches.values()),
        "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": l_ms}]}
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

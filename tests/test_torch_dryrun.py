"""The lowering report (``repro_torch.launch.dryrun``) against the
reference's planning and analytic counts, its CLI, and its recording
mesh against real gloo meshes.

* The reference's ``planned_cells()``, ``param_counts`` and
  ``model_flops`` are read for all ten configs in one subprocess
  (importing ``repro.launch.dryrun`` rewrites ``XLA_FLAGS`` to 512
  devices, which must not reach this process's JAX); the port's are
  EQUAL.
* No planned cell is refused: the report's train step runs the ssm,
  hybrid and encdec families on a recording mesh (SMOKE widths, one
  microbatch), with their model-axis gradient SUMs.
* Two FULL cells through the CLI (``--all`` over qwen3_4b
  ``decode_32k`` and mamba2_1_3b ``decode_32k`` on 256 chips, each in
  its subprocess): int8 operations counted, it fits 80 GB, a dominant
  roofline term; mamba2's cache bytes are its spec's.  qwen3_4b
  ``decode_32k`` again with ``--kv-bits 8``: priced on the int8 KV
  cache, its cache bytes its spec's (0.63 of the bf16 cell's).  mamba2_1_3b
  ``train_4k`` priced through the CLI's one-cell mode at SMOKE widths
  (a FULL train cell runs minutes).
* Two spawned CPU ranks (gloo, a file rendezvous under ``tmp_path``) run
  ``dryrun.serve_run`` at SMOKE size on real tensors: qwen3_4b
  tensor-parallel on ``(1, 2)``, FSDP on ``(2, 1)`` with the rows split,
  and Moonshot expert-parallel on ``(1, 2)``; each rank's ``Mesh.counts``
  EQUAL a ``RecordingMesh``'s for the same run on fake tensors (the
  sequence-sharded decode's are in ``tests/test_torch_seq_kv.py``).
"""
import contextlib
import datetime
import io
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as tdist  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.dist import api as dapi  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.config import SHAPES_BY_NAME, ShapeConfig  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
# (label, arch, mesh (data, model), batch, prompt)
MESH_RUNS = (("tp", "qwen3_4b", (1, 2), 2, 10),
             ("fsdp", "qwen3_4b", (2, 1), 2, 10),
             ("ep", "moonshot_v1_16b_a3b", (1, 2), 2, 10))
STEPS, MAX_LEN = 2, 16

_REFERENCE = r"""
import json
from repro import configs
from repro.launch import dryrun as d
from repro.models.config import SHAPES_BY_NAME
out = {"cells": d.planned_cells(), "params": {}, "flops": {},
       "accum": {}}
for arch in configs.ARCH_IDS:
    cfg = configs.get(arch)
    c = d.param_counts(cfg)
    out["params"][arch] = c
    out["flops"][arch] = {s: d.model_flops(cfg, sh, c)
                          for s, sh in SHAPES_BY_NAME.items()}
    out["accum"][arch] = {s: d.accum_for(cfg, sh)
                          for s, sh in SHAPES_BY_NAME.items()}
print(json.dumps(out))
"""


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
                PYTHONPATH=os.pathsep.join(
                    [os.path.join(ROOT, "src")]
                    + [p for p in [os.environ.get("PYTHONPATH")] if p]))


def test_planning_and_counts_equal_the_reference():
    r = subprocess.run([sys.executable, "-c", _REFERENCE], env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = json.loads(r.stdout.strip().splitlines()[-1])
    assert [list(c) for c in dryrun.planned_cells()] == ref["cells"]
    for arch in configs.ARCH_IDS:
        cfg = configs.get(arch)
        counts = dryrun.param_counts(cfg)
        assert counts == ref["params"][arch], arch
        for s, shape in SHAPES_BY_NAME.items():
            assert dryrun.model_flops(cfg, shape, counts) == \
                ref["flops"][arch][s], (arch, s)
            assert dryrun.accum_for(cfg, shape) == ref["accum"][arch][s]


@contextlib.contextmanager
def _one_microbatch():
    """Train cells at one microbatch (the report's 8 repeat the same ops)."""
    prev = dryrun.accum_for
    dryrun.accum_for = lambda cfg, shape: 1
    try:
        yield
    finally:
        dryrun.accum_for = prev


def test_refused_cells_are_the_recurrent_and_encdec_families():
    """No planned cell is refused: the train cells of the ssm, hybrid and
    encdec families run the report's train step on a recording (2, 2)
    mesh (SMOKE widths, one microbatch), where their gradients SUM over
    the model axis (the Mamba scalars' ``grad_heads``, the LoRA pairs'
    ``grad_lora``, the column-parallel inputs' ``grad_tp``) and FSDP
    weights reduce-scatter."""
    assert not hasattr(dryrun, "refusal")
    train = {configs.get(a).family for a, s in dryrun.planned_cells()
             if s == "train_4k"}
    assert {"ssm", "hybrid", "encdec"} <= train
    shape = ShapeConfig("train_4k", 16, 16, "train")
    want = {"mamba2_1_3b": ("grad_heads",),
            "zamba2_2_7b": ("grad_heads", "grad_lora"),
            "seamless_m4t_medium": ()}
    with _one_microbatch():
        for arch, kinds in want.items():
            mesh = dapi.RecordingMesh((2, 2), ("data", "model"))
            (params, opt, metrics), cost, args = dryrun.run_train(
                configs.get_smoke(arch), shape, mesh)
            assert cost.ops > 0 and args > 0 and "grad_norm" in metrics
            for kind in kinds + ("grad_tp", "grad_rs", "gather_weight"):
                assert kind in mesh.counts, (arch, kind)


@pytest.fixture(scope="module")
def cli_cells(tmp_path_factory):
    """``--all`` over qwen3_4b decode_32k and mamba2_1_3b decode_32k (256
    chips, each in its subprocess), qwen3_4b decode_32k on the int8 KV
    cache (``--kv-bits 8``, in process, into ``kv8/``), then mamba2_1_3b
    train_4k through the one-cell mode in process at SMOKE widths and
    one microbatch: the printed output and the directory of the cells'
    JSON."""
    out = tmp_path_factory.mktemp("dryrun_cli")
    prev_cells, prev_path = dryrun.planned_cells, os.environ.get(
        "PYTHONPATH")
    dryrun.planned_cells = lambda: [
        ("qwen3_4b", "decode_32k"), ("mamba2_1_3b", "decode_32k")]
    os.environ["PYTHONPATH"] = _env()["PYTHONPATH"]
    prev_get = configs.get
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = dryrun.main(["--all", "--out", str(out)])
            rc |= dryrun.main(["--arch", "qwen3_4b", "--shape",
                               "decode_32k", "--kv-bits", "8", "--out",
                               str(out / "kv8")])
            configs.get = configs.get_smoke
            with _one_microbatch():
                rc |= dryrun.main(["--arch", "mamba2_1_3b", "--shape",
                                   "train_4k", "--out", str(out)])
    finally:
        configs.get = prev_get
        dryrun.planned_cells = prev_cells
        if prev_path is None:
            os.environ.pop("PYTHONPATH")
        else:
            os.environ["PYTHONPATH"] = prev_path
    return rc, buf.getvalue(), out


def test_a_full_cell_through_the_cli(cli_cells):
    """The qwen3_4b decode_32k cell's JSON has the report's sections."""
    rc, printed, tmp_path = cli_cells
    assert rc == 0
    assert "2 ok, 0 failed" in printed
    res = json.loads((tmp_path / "qwen3_4b.decode_32k.16x16.json")
                     .read_text())
    assert res["chips"] == 256 and res["kind"] == "decode"
    assert res["cost"]["ops_int8_per_device"] > 0
    assert res["memory"]["fits_hbm_80g"]
    assert res["memory"]["peak_bytes_per_device"] > \
        res["memory"]["argument_bytes"] > 0
    assert res["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
    # 128 rows over 16 data ranks: the GEMVs run at M = 8
    keys = {tuple(k[:-1]) for k in res["kernels"]["launches"]}
    assert keys and all(k[0] == "bitplane_matmul" and k[3] == 8
                        for k in keys)
    assert res["links"] == {"data": "nic", "model": "nic"}
    assert res["params"] == dryrun.param_counts(configs.get("qwen3_4b"))
    train = json.loads((tmp_path / "mamba2_1_3b.train_4k.16x16.json")
                       .read_text())
    assert "refused" not in train and train["kind"] == "train"
    assert train["attention"] == dryrun.NO_ATTENTION
    assert train["roofline"]["dominant"] in ("compute", "memory",
                                             "collective")
    assert train["memory"]["peak_bytes_per_device"] > 0
    assert "grad_rs" in train["collective_kinds_port"]


def test_an_int8_kv_cell_through_the_cli(cli_cells):
    """``--kv-bits 8``: the qwen3_4b decode_32k cell priced on the int8
    KV cache.  Its cache bytes a device are its spec's local blocks of
    int8 values and bf16 per-(token, head) scales: 0.63 of the bf16
    cell's, not half, since the 16-way model axis splits the head dim
    (8 KV heads do not divide it), so a rank's k/v keep 8 of hd's 128
    features while the scales keep every head, and ``kpos`` stays
    int32."""
    rc, _, tmp_path = cli_cells
    assert rc == 0
    bf16 = json.loads((tmp_path / "qwen3_4b.decode_32k.16x16.json")
                      .read_text())
    int8 = json.loads((tmp_path / "kv8" / "qwen3_4b.decode_32k.16x16.json")
                      .read_text())
    assert bf16["kv_cache_bits"] == 0 and int8["kv_cache_bits"] == 8
    cfg = configs.get("qwen3_4b").with_(kv_cache_bits=8)
    mesh = dryrun.lmesh.recording_production_mesh(multi_pod=False)
    whole = lm.empty_cache(cfg, 128, 32768, device="meta")
    specs = dryrun.shd.cache_shardings(whole, mesh)
    want = sum(math.prod(dapi.local_shape(mesh, specs[k], t.shape))
               * t.element_size() for k, t in whole.items())
    assert int8["memory"]["cache_bytes"] == want
    ratio = int8["memory"]["cache_bytes"] / bf16["memory"]["cache_bytes"]
    hd, kv = cfg.head_dim // 16, cfg.n_kv_heads
    assert ratio == pytest.approx((2 * kv * hd + 2 * kv * 2 + 4)
                                  / (2 * kv * hd * 2 + 4), rel=1e-6)
    assert int8["roofline"]["dominant"] in ("compute", "memory",
                                            "collective")
    assert int8["cost"]["ops_int8_per_device"] > 0


def test_a_mamba2_cell_holds_the_spec_cache(cli_cells):
    """mamba2_1_3b decode_32k, newly admitted: its cache bytes per device
    are the spec's local blocks (the state's heads and the conv's
    channels over the 16 model ranks, the 128 rows over the 16 data
    ranks), its SSD step priced in f32, its serve linears on the
    bit-plane kernel at M = 8."""
    _, _, tmp_path = cli_cells
    res = json.loads((tmp_path / "mamba2_1_3b.decode_32k.16x16.json")
                     .read_text())
    cfg = configs.get("mamba2_1_3b")
    mesh = dryrun.lmesh.recording_production_mesh(multi_pod=False)
    whole = lm.empty_cache(cfg, 128, 32768, device="meta")
    specs = dryrun.shd.cache_shardings(whole, mesh)
    want = sum(math.prod(dapi.local_shape(mesh, specs[k], t.shape))
               * t.element_size() for k, t in whole.items())
    assert res["memory"]["cache_bytes"] == want
    d_inner, H, N, P = cfg.expand * cfg.d_model, 64, cfg.ssm_state, 64
    assert want == cfg.n_layers * 8 * (
        H // 16 * P * N * 4 + (cfg.d_conv - 1) * (d_inner + 2 * N) // 16 * 2)
    assert res["cost"]["flops_f32_per_device"] > 0
    assert res["memory"]["fits_hbm_80g"]
    keys = {tuple(k[:-1]) for k in res["kernels"]["launches"]}
    assert keys and all(k[0] == "bitplane_matmul" and k[3] == 8
                        for k in keys)
    assert {"gather_heads", "gather_conv", "acc_tp"} <= set(
        res["collective_kinds_port"])


def _smoke_q(arch):
    cfg = configs.get_smoke(arch)
    return cfg, lm.quantize_params(lm.init_params(
        cfg, torch.Generator().manual_seed(6), device="cpu"), cfg)


def _rank(rank, init_file, out_dir):
    torch.set_num_threads(1)
    tdist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    out = {}
    try:
        meshes = {(1, 2): make_host_mesh(model=2),
                  (2, 1): make_host_mesh(model=1)}
        for label, arch, shape, B, S in MESH_RUNS:
            cfg, q = _smoke_q(arch)
            tokens = torch.from_numpy(np.random.default_rng(1).integers(
                0, cfg.vocab_size, (B, S)).astype(np.int32))
            mesh = meshes[shape]
            mesh.reset_counts()
            dryrun.serve_run(cfg, mesh, q, tokens, steps=STEPS,
                             max_len=MAX_LEN)
            out[label] = {k: list(v) for k, v in mesh.counts.items()}
    finally:
        tdist.destroy_process_group()
    torch.save(out, f"{out_dir}/rank{rank}.pt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_mesh")
    tmp.start_processes(_rank, args=(str(d / "rendezvous"), str(d)),
                        nprocs=WORLD, join=True, start_method="spawn")
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.mark.parametrize("run", MESH_RUNS, ids=[r[0] for r in MESH_RUNS])
def test_mesh_counts_equal_the_recording_mesh(ranks, run):
    label, arch, shape, B, S = run
    want = dryrun.predict_counts(configs.get_smoke(arch), shape, batch=B,
                                 prompt=S, steps=STEPS, max_len=MAX_LEN)
    assert want
    for out in ranks:
        assert out[label] == want
    if label == "tp":
        assert "acc_tp" in want and "gather_weight" not in want
    if label == "fsdp":
        assert "gather_weight" in want and "amax_dp" in want

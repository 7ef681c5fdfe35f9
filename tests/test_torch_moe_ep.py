"""Expert-parallel MoE on gloo meshes: moonshot_v1_16b_a3b SMOKE layer 0,
the port's ``apply_moe`` on ``(1, 2)`` and ``(2, 1)`` meshes of two CPU
ranks, in serve and train form.  Every check is EQUAL.

The weights and inputs come from the reference (``jax.random``), in a
subprocess that runs the reference's ``apply_moe`` under a 2-device host
mesh (``XLA_FLAGS=--xla_force_host_platform_device_count=2``,
``JAX_PLATFORMS=cpu``) op by op: its ``shard_map`` expert-parallel path,
whose per-shard capacity drops other choices than one device does.  Run
op by op on a CPU that path takes about 25 s a call, so the reference runs
two of the eight cases (serve form on ``(1, 2)`` at 128 tokens, where EP
drops choices; train form on ``(2, 1)`` at 16 tokens, where ``C_shard``
= 8 and the single-device ``C`` = 5).  Every case is held against
``moe.ep_reference``, the port's one-process statement of the same
semantics, which the two reference cases hold in turn.  The subprocess
writes the weights first, so the two ranks start while it runs.
"""
import datetime
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as tdist  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402

from repro_torch import configs, dist  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402

ARCH = "moonshot_v1_16b_a3b"
ROOT = pathlib.Path(__file__).resolve().parents[1]
SIZES = (8, 64)                  # S of a (2, S) batch: T = 16 and 128
MESHES = ((1, 2), (2, 1))
FORMS = ("train", "serve")
# the cases the reference runs op by op: (form, mesh, S)
REF_CASES = (("serve", (1, 2), 64), ("train", (2, 1), 8))

_REFERENCE = r"""
import sys, numpy as np, jax, jax.numpy as jnp
from repro import configs
from repro.core import bitfluid as bf
from repro.dist import api
from repro.models import lm, moe
out_dir = sys.argv[1]
cfg = configs.get_smoke("moonshot_v1_16b_a3b")
params = lm.init_params(cfg, jax.random.PRNGKey(0))
l0 = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a[0]), t)
pt = l0(params["layers"]["mlp"])
flat = {}
def walk(t, pre):
    for k, v in t.items():
        if isinstance(v, dict):
            walk(v, pre + k + "/")
        else:
            flat[pre + k] = np.asarray(v.astype(jnp.float32))
walk(pt, "")
rng = np.random.default_rng(0)
for S in (8, 64):
    flat[f"x_{S}"] = rng.standard_normal((2, S, cfg.d_model)).astype(
        np.float32)
np.savez(out_dir + "/weights.npz", **flat)
open(out_dir + "/weights.done", "w").close()
def q_expert(w):
    w = w.astype(jnp.float32)
    s = bf.symmetric_scale(w, 8, axis=-2)
    return {"q": bf.quantize(w, s, 8), "s": s}
pj = jax.tree_util.tree_map(lambda a: a[0], params["layers"]["mlp"])
jq = jax.tree_util.tree_map(lambda a: a[0],
                            lm.quantize_params(params, cfg)["layers"]["mlp"])
forms = {"train": pj,
         "serve": dict(jq, experts={k: q_expert(v)
                                    for k, v in pj["experts"].items()})}
res = {}
for form, shape, S in %s:
    x = jnp.asarray(flat[f"x_{S}"]).astype(jnp.bfloat16)
    mesh = jax.make_mesh(shape, ("data", "model"))
    with api.use_mesh(mesh):
        y, _ = moe.apply_moe(forms[form], x, cfg, jnp.int32(8), jnp.int32(8))
    res[f"{form}_{shape[0]}{shape[1]}_{S}"] = np.asarray(
        y.astype(jnp.float32))
np.savez(out_dir + "/reference.npz", **res)
""" % (REF_CASES,)


def _params(weights):
    """Layer 0's MoE FFN in train and serve form, stacked as a one-layer
    model tree (the sharding rules read the ``layers/mlp`` key path)."""
    tree = {}
    for key, a in weights.items():
        if key.startswith("x_"):
            continue
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        # the reference's bf16 leaves, carried as f32 (exact)
        node[leaf] = torch.from_numpy(a[None]).to(torch.bfloat16)
    cfg = configs.get_smoke(ARCH)
    train = {"layers": {"mlp": tree}}
    # the serve form: experts per expert, shared experts as containers,
    # the router kept bf16 (lm.quantize_params' rules)
    serve = lm.quantize_params(train, cfg)
    return cfg, {"train": train, "serve": serve}


def _case(mesh, cfg, params, form, S, x):
    placed = dist.shard_params(params[form], mesh)
    p = cm.stack_slice(placed["layers"]["mlp"], 0)
    dp = dist.dp_size(mesh)
    rows = slice(mesh.dp_index * 2 // dp, (mesh.dp_index + 1) * 2 // dp)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    before = moe.ep_dropped[0]
    with dist.use_mesh(mesh), kops.split_rows(mesh if dp > 1 else None), \
            mesh.reuse_gathers():
        y, _ = moe.apply_moe(p, xb[rows], cfg, torch.tensor(8),
                             torch.tensor(8))
    dropped = moe.ep_dropped[0] - before
    y = mesh.gather_rows(y.float()) if dp > 1 else y.float()
    return y.numpy(), dropped


def _rank(rank, init_file, out_dir):
    torch.set_num_threads(1)
    while not os.path.exists(f"{out_dir}/weights.done"):
        time.sleep(0.1)
    weights = dict(np.load(f"{out_dir}/weights.npz"))
    cfg, params = _params(weights)
    tdist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=2, timeout=datetime.timedelta(seconds=120))
    out = {}
    try:
        meshes = {(1, 2): make_host_mesh(model=2),
                  (2, 1): make_host_mesh(model=1)}
        for form in FORMS:
            for shape, mesh in meshes.items():
                for S in SIZES:
                    out[(form, shape, S)] = _case(mesh, cfg, params, form,
                                                  S, weights[f"x_{S}"])
    finally:
        tdist.destroy_process_group()
    if rank == 0:                       # the one-process statements
        for form in FORMS:
            p = cm.stack_slice(params[form]["layers"]["mlp"], 0)
            for (dp, tp) in MESHES:
                for S in SIZES:
                    x = torch.from_numpy(weights[f"x_{S}"]).to(torch.bfloat16)
                    before = moe.ep_dropped[0]
                    y, _ = moe.ep_reference(p, x, cfg, torch.tensor(8),
                                            torch.tensor(8), tp=tp, dp=dp)
                    out[("statement", form, (dp, tp), S)] = (
                        y.float().numpy(), moe.ep_dropped[0] - before)
                    y1, _ = moe.apply_moe(p, x, cfg, torch.tensor(8),
                                          torch.tensor(8))
                    out[("single", form, S)] = y1.float().numpy()
    torch.save(out, f"{out_dir}/rank{rank}.pt")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_ep")
    # one thread: the op-by-op reference is dispatch-bound, and the test
    # workers share the host's cores
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=2 "
                         "--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE, str(d)],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        tmp.start_processes(_rank, args=(str(d / "rendezvous"), str(d)),
                            nprocs=2, join=True, start_method="spawn")
        _, err = ref.communicate(timeout=600)
    finally:
        ref.kill()
    assert ref.returncode == 0, err[-4000:]
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    return ranks, dict(np.load(d / "reference.npz"))


def test_capacities_differ_from_one_device():
    cfg = configs.get_smoke(ARCH)
    assert moe.capacity(16, cfg) == 5 and moe.shard_capacity(16, cfg) == 8
    assert moe.shard_capacity(64, cfg) == 24        # (2, 1): T_loc = 64


@pytest.mark.parametrize("form, shape, S", REF_CASES)
def test_mesh_ep_equals_the_reference(runs, form, shape, S):
    ranks, ref = runs
    want = ref[f"{form}_{shape[0]}{shape[1]}_{S}"]
    for out in ranks:
        np.testing.assert_array_equal(out[(form, shape, S)][0], want)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("S", SIZES)
def test_mesh_ep_equals_the_statement(runs, form, shape, S):
    ranks, _ = runs
    want, dropped = ranks[0][("statement", form, shape, S)]
    for out in ranks:
        np.testing.assert_array_equal(out[(form, shape, S)][0], want)
    # the ranks' drops add up to the statement's
    assert sum(out[(form, shape, S)][1] for out in ranks) == dropped


def test_ep_capacity_decides_the_drops(runs):
    """At 128 tokens on (1, 2), C_shard = C = 40: EP drops choices, the
    same ones one device drops, and with k = 2 the two ranks' sums add the
    same two terms, so the outputs equal the single-device path's.  On
    (2, 1) each data shard routes its 64 tokens at C_shard = 24, which
    keeps other choices than C = 40 over all 128 does."""
    ranks, _ = runs
    for form in FORMS:
        y, dropped = ranks[0][("statement", form, (1, 2), 64)]
        assert dropped > 0
        np.testing.assert_array_equal(y, ranks[0][("single", form, 64)])
        assert not np.array_equal(
            ranks[0][("statement", form, (2, 1), 64)][0],
            ranks[0][("single", form, 64)])

"""Shared body of the mesh-training tests of the recurrent and
encoder-decoder families (``tests/test_torch_sharded_train_ssm.py``,
``_hybrid.py``, ``_encdec.py``): two gloo CPU ranks train one family's
SMOKE config against one process, against the reference's jitted sharded
step, and across checkpoints.

Each test file calls :func:`install` with its family, which puts the
module-scoped fixture and the tests below into the file.  The fixture
spawns two ranks once (``torch.multiprocessing``, a file rendezvous under
``tmp_path``) that build a ``(1, 2)`` ``("data", "model")`` mesh (tensor
parallelism: a Mamba layer's SSD on each rank's heads, the hybrid's
shared block on local heads, encoder, decoder and cross-attention on
local heads) and a ``(2, 1)`` one (FSDP weights, each data rank two of
the batch's four rows).  On each mesh they take:

* the first microbatch's gradient (B=4 x 17, every bit slot at 8), every
  leaf gathered whole after the data-axis SUM the train step makes;
* the same with the model-axis SUMs of the replicated per-head Mamba
  scalars (``grad_heads``) and of the hybrid's LoRA pairs
  (``grad_lora``) skipped: the faults those SUMs repair, which the
  gradient bound must catch;
* 2 steps of ``n_accum=2`` with AdamW's int8 m and factored v
  (``remat="full"``, wbits 8 then 4);
* checkpoints: each mesh's state restored onto the other mesh and onto
  one device, and a reference-written one onto both meshes.

Rank 0 then runs the gradient and the steps in one process, under the
same thread settings.  A subprocess runs the reference's jitted
``make_train_step`` on two fake CPU devices over a ``(1, 2)`` mesh from
the same weights and batch.  The weights are the reference's
``init_params(PRNGKey(0))``, with zamba2's LoRA ``b`` drawn N(0, 0.5)
(``lora_init`` draws zeros, under which a wrong ``a`` gradient is zero
on both sides and does not show).

Tolerances (measured on this suite, stated once; the worst family and
mesh in brackets):

* GRAD_TOL — each leaf of the first gradient, max |mesh - one process|
  over the leaf's max |one process|.  A gradient that enters a
  column-parallel region or reduce-scatters sums per-rank bf16 partials
  where one process rounds one product once.  Measured: 1.7e-2 (zamba2
  ``lora/wk/b`` on ``(1, 2)``; mamba2 9.8e-3, seamless 9.1e-3).  From
  the port's own seed-0 weights seamless reached 2.4e-2 on ``(1, 2)``:
  its layer-0 row-parallel self-attention output rounds one element of
  4096 one bf16 step apart, which moves layer 1's per-tensor activation
  scale (with float32 activations, mamba2 and zamba2 agree to 1e-7 and
  that gap falls to 4.8e-3).  A leaf whose gradient misses a model
  rank's block is wrong by 0.33-1.0 (FAULT_MIN).
* MESH_LOSS_TOL — a step's loss and z-loss, relative, mesh against one
  process; GNORM_FACTOR times it for the grad norm.  The first forward
  is one process's (loss EQUAL or within 1.5e-7); the second step's
  4-bit layers round some weights to other bins (measured: loss within
  1.24e-3, zamba2 on ``(2, 1)``; grad norm within 4.8e-3).
* MESH_PARAM_TOL, MESH_PARAM_MEAN — each parameter after 2 steps within
  MESH_PARAM_TOL LR plus one bf16 step of the value (Adam's update is
  about ``lr g / |g|``, so an element whose gradient sits near 0 may
  move up to 2 LR a step the other way), and the mean |difference|
  within MESH_PARAM_MEAN LR (measured: 1.40 LR, mean 0.032 LR, zamba2
  on ``(1, 2)``).
* REF_* — the same against the reference's jitted step, whose XLA
  fusions round other f32 intermediates again; one process of the port
  sits as far from it (measured: loss within 2.7e-3 and grad norm
  within 2.7e-2, zamba2's second step; parameters 2.34 LR, mean 0.086
  LR).
* OPT_TOL — each optimizer moment within OPT_TOL of its leaf's largest
  magnitude.

EQUAL, with no tolerance: both ranks' gathered gradients and states, and
every checkpoint restore, across meshes, one device and the reference.
"""
import contextlib
import datetime
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as tdist
import torch.multiprocessing as tmp

from repro_torch import configs
from repro_torch.data.pipeline import make_batch
from repro_torch.dist import api as dapi
from repro_torch.dist import sharding as shd
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lm
from repro_torch.models.convert import from_numpy_params
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, leaf_layouts,
                                     tree_leaves, tree_unflatten)
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.loop import TrainConfig, make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
LR = 1e-3
STEPS, ACCUM, BATCH, SEQ = 2, 2, 4, 17
WBITS, ABITS = (8, 4), (8,)
GRAD_BITS = 8
ARCHS = {"ssm": "mamba2_1_3b", "hybrid": "zamba2_2_7b",
         "encdec": "seamless_m4t_medium"}
OVERRIDES = {"remat": "full"}
LORA_B = 0.5
# the model-axis gradient SUMs a skipped one of which is a fault
FAULT_KINDS = ("grad_heads", "grad_lora")
FAULTY = {"ssm": {"/layers/A_log", "/layers/D", "/layers/dt_bias"},
          "hybrid": {"/layers/mamba/A_log", "/layers/mamba/D",
                     "/layers/mamba/dt_bias", "/layers/lora/wq/a",
                     "/layers/lora/wk/a", "/layers/lora/wv/a",
                     "/layers/lora/wo/a", "/layers/lora/wo/b"},
          "encdec": set()}
# the collectives only a (1, 2) step makes, by family
TP_KINDS = {"ssm": ("sum_tp", "grad_tp", "grad_heads", "gather_heads",
                    "amax_tp"),
            "hybrid": ("sum_tp", "grad_tp", "grad_heads", "gather_heads",
                       "grad_lora", "amax_tp"),
            "encdec": ("sum_tp", "grad_tp", "amax_tp")}
GRAD_TOL = 3e-2
FAULT_MIN = 0.3
MESH_LOSS_TOL = 2e-3
GNORM_FACTOR = 20
MESH_PARAM_TOL = 2.0 * STEPS
MESH_PARAM_MEAN = 0.2
REF_LOSS_TOL = 4e-3
REF_PARAM_TOL = 2.0 * STEPS
REF_PARAM_MEAN = 0.2
OPT_TOL = 0.3


def tcfg():
    return TrainConfig(optimizer=AdamWConfig(lr=LR, m_dtype="int8",
                                             v_mode="factored"),
                       n_accum=ACCUM, wbits=WBITS, abits=ABITS)


def port_cfg(family):
    return configs.get_smoke(ARCHS[family]).with_(**OVERRIDES)


def batch_of(cfg):
    """BATCH rows of SEQ tokens (and an encdec's frames), seed 0 step 0:
    the reference's bytes."""
    return make_batch(0, 0, BATCH, SEQ, cfg.vocab_size, cfg)


def np_tree(tree):
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    t = tree.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree, np.float32)}


# ---------------------------------------------------------------------------
# The ranks (no jax here: a spawned rank imports this module)
# ---------------------------------------------------------------------------

def first_grads(cfg, np_params, batch, mesh, faults=False):
    """The first microbatch's gradient of every leaf, whole (the data-axis
    SUM the train step makes included), and the loss; ``faults`` skips
    the FAULT_KINDS SUMs."""
    params = from_numpy_params(np_params, device="cpu")
    if mesh is not None:
        params = shd.shard_params(params, mesh)
        batch = shd.shard_batch(batch, mesh)
    bits = torch.full((lm.n_bit_slots(cfg),), GRAD_BITS, dtype=torch.int32)
    live = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    enter = dapi.Mesh.enter

    def skipping(self, t, axes, *, kind="grad_tp"):
        return t if kind in FAULT_KINDS else enter(self, t, axes, kind=kind)

    if faults:
        dapi.Mesh.enter = skipping
    try:
        with contextlib.ExitStack() as ctx:
            if mesh is not None:
                # the backward recomputes remat regions: as in the train
                # step, it runs inside the mesh's and the rows' blocks
                ctx.enter_context(dapi.use_mesh(mesh))
                ctx.enter_context(kops.split_rows(
                    mesh if dapi.dp_size(mesh) > 1 else None))
            total, _ = lm.train_loss(tree_unflatten(params, live), batch,
                                     cfg, bits, bits)
            grads = list(torch.autograd.grad(total, live,
                                             allow_unused=True))
    finally:
        dapi.Mesh.enter = enter
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, live)]
    if mesh is not None and dapi.dp_size(mesh) > 1:
        for j, lay in enumerate(leaf_layouts(params)):
            held = () if lay is None else tuple(
                a for e in lay[2] for a in dapi.entry_axes(e))
            axes = tuple(a for a in mesh.dp_axes if a not in held)
            grads[j] = mesh.sum_grad(grads[j], axes, kind="grad_dp")
        total = mesh.all_reduce(total.detach(), mesh.dp_axes, "sum")
    tree = tree_unflatten(params, grads)
    return {"grads": np_tree(shd.full(tree) if mesh is not None else tree),
            "loss": float(total)}


def train(mesh, cfg, np_params, batch):
    """STEPS steps from the bridged weights: the gathered state, the
    metrics and the collectives."""
    params = from_numpy_params(np_params, device="cpu")
    p_shd = None
    if mesh is not None:
        p_shd = shd.param_shardings(params, mesh)
        params = shd.shard_params(params, mesh)
        mesh.reset_counts()
    opt = adamw_init(params, tcfg().optimizer)
    step, _ = make_train_step(tcfg(), cfg, device="cpu",
                              param_shardings=p_shd)
    local = batch if mesh is None else shd.shard_batch(batch, mesh)
    metrics = []
    for _ in range(STEPS):
        params, opt, m = step(params, opt, local)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"params": np_tree(shd.full(params)),
            "opt": np_tree(shd.full(opt)), "metrics": metrics,
            "collectives": {} if mesh is None else dict(mesh.counts),
            "placed": (params, opt)}


def checkpoints(meshes, out, out_dir, np_params):
    """Each mesh's trained state saved and restored onto the other mesh,
    onto one device and onto its own placed layout; the reference-written
    checkpoint restored onto both meshes."""
    res = {}
    whole_p = from_numpy_params(np_params, device="meta")
    whole_o = adamw_init(whole_p, tcfg().optimizer)
    target = {"params": whole_p, "opt": whole_o}

    def specs(mesh):
        return {"params": shd.param_shardings(whole_p, mesh),
                "opt": shd.opt_shardings(whole_o, mesh)}

    for src, dst in (("12", "21"), ("21", "12")):
        params, opt = out[("train", src)]["placed"]
        d = f"{out_dir}/ck{src}"
        tckpt.save_checkpoint(d, STEPS, {"params": params, "opt": opt})
        onto, step = tckpt.restore_checkpoint(d, target, specs(meshes[dst]),
                                              mesh=meshes[dst], device="cpu")
        one, _ = tckpt.restore_checkpoint(d, target, device="cpu")
        placed, _ = tckpt.restore_checkpoint(
            d, {"params": params, "opt": opt}, device="cpu")
        res[(src, dst)] = {"step": step, "onto": np_tree(shd.full(onto)),
                           "one": np_tree(one),
                           "placed": np_tree(shd.full(placed))}
    for m in ("12", "21"):
        got, _ = tckpt.restore_checkpoint(f"{out_dir}/ckref", target,
                                          specs(meshes[m]), mesh=meshes[m],
                                          device="cpu")
        res[("ref", m)] = np_tree(shd.full(got))
    return res


def rank_main(rank, family, init_file, out_dir):
    torch.set_num_threads(1)
    np_params = np.load(f"{out_dir}/inputs.npz",
                        allow_pickle=True)["params"].item()
    cfg = port_cfg(family)
    batch = batch_of(cfg)
    tdist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    out = {}
    try:
        meshes = {"12": make_host_mesh(model=2),
                  "21": make_host_mesh(model=1)}
        for m, mesh in meshes.items():
            out[("grad", m)] = first_grads(cfg, np_params, batch, mesh)
            out[("fault", m)] = first_grads(cfg, np_params, batch, mesh,
                                            faults=True)
            out[("train", m)] = train(mesh, cfg, np_params, batch)
        out["ckpt"] = checkpoints(meshes, out, out_dir, np_params)
    finally:
        tdist.destroy_process_group()
    if rank == 0:
        out[("grad", None)] = first_grads(cfg, np_params, batch, None)
        out[("train", None)] = train(None, cfg, np_params, batch)
    for v in out.values():
        if isinstance(v, dict):
            v.pop("placed", None)
    torch.save(out, f"{out_dir}/rank{rank}.pt")


# ---------------------------------------------------------------------------
# The parent: the reference's weights, steps and checkpoint
# ---------------------------------------------------------------------------

REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, numpy as np
from jax.sharding import Mesh
from repro import configs, dist
from repro.data.pipeline import make_batch
from repro.dist import sharding as shd
from repro.optim.adamw import AdamWConfig, adamw_init
from repro.train.loop import TrainConfig, make_train_step
out_dir, arch, lr = sys.argv[1], sys.argv[2], float(sys.argv[3])
steps, accum, batch_rows, seq = map(int, sys.argv[4:8])
np_params = np.load(f"{out_dir}/inputs.npz",
                    allow_pickle=True)["params"].item()
cfg = configs.get_smoke(arch).with_(remat="full")
batch = make_batch(0, 0, batch_rows, seq, cfg.vocab_size, cfg)
# make_host_mesh(model=2)'s layout, with the Auto axes the reference's
# sharding constraints take (this JAX's make_mesh defaults to Explicit)
mesh = Mesh(np.array(jax.devices()).reshape(1, 2), ("data", "model"))
tcfg = TrainConfig(optimizer=AdamWConfig(lr=lr, m_dtype="int8",
                                         v_mode="factored"),
                   n_accum=accum, wbits=(8, 4), abits=(8,))
with dist.use_mesh(mesh):
    params = jax.tree_util.tree_map(jax.numpy.asarray, np_params)
    opt = adamw_init(params, tcfg.optimizer)
    p_shd = shd.param_shardings(params, mesh)
    params = jax.device_put(params, p_shd)
    opt = jax.device_put(opt, shd.opt_shardings(opt, mesh))
    step, _ = make_train_step(tcfg, cfg, param_shardings=p_shd)
    step = jax.jit(step)
    mets = []
    for _ in range(steps):
        params, opt, m = step(params, opt, batch)
        mets.append({k: float(v) for k, v in m.items()})
flat = {}
def rec(node, pre):
    if isinstance(node, dict):
        for k, v in node.items():
            rec(v, pre + "/" + k)
    else:
        flat[pre] = np.asarray(node, np.float32)
rec(params, "")
np.savez(f"{out_dir}/ref.npz", metrics=np.array(mets, dtype=object), **flat)
"""


def reference_weights(family):
    """The reference's ``init_params(PRNGKey(0))`` as numpy, zamba2's LoRA
    ``b`` drawn N(0, LORA_B) in bf16."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import lm as jlm
    jcfg = jconfigs.get_smoke(ARCHS[family]).with_(**OVERRIDES)
    params = jax.tree_util.tree_map(np.asarray, jlm.init_params(
        jcfg, jax.random.PRNGKey(0)))
    if family == "hybrid":
        rng = np.random.default_rng(18)
        for pair in params["layers"]["lora"].values():
            pair["b"] = np.asarray(jnp.asarray(
                rng.standard_normal(pair["b"].shape) * LORA_B, jnp.bfloat16))
    return params


def spawn_runs(family, tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from repro.optim import adamw as jadamw
    from repro.train import checkpoint as jckpt
    d = tmp_path_factory.mktemp(f"mesh_train_{family}")
    params = reference_weights(family)
    np.savez(d / "inputs.npz", params=np.array(params, dtype=object))
    # the reference writes a checkpoint of its int8/factored state
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jopt = jadamw.adamw_init(jparams, jadamw.AdamWConfig(
        m_dtype="int8", v_mode="factored"))
    jopt["step"] = jnp.asarray(3, jnp.int32)
    jckpt.save_checkpoint(str(d / "ckref"), 3, {"params": jparams,
                                                "opt": jopt})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(d), ARCHS[family], str(LR),
         str(STEPS), str(ACCUM), str(BATCH), str(SEQ)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        tmp.start_processes(rank_main, args=(family, str(d / "rendezvous"),
                                             str(d)),
                            nprocs=WORLD, join=True, start_method="spawn")
    finally:
        _, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-3000:]
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    refz = np.load(d / "ref.npz", allow_pickle=True)
    want = {}
    for k in refz.files:
        if k == "metrics":
            continue
        node, parts = want, k.strip("/").split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = refz[k]
    return {"ranks": ranks, "dir": d, "jparams": params,
            "jopt": jax.tree_util.tree_map(np.asarray, jopt),
            "ref": {"metrics": list(refz["metrics"]), "params": want}}


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------

def grad_gaps(got, want):
    """Each leaf's max |got - want| over its max |want|."""
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys()
    return {k: float(np.abs(got[k] - w).max()) / max(float(np.abs(w).max()),
                                                      1e-30)
            for k, w in want.items()}


def params_close(got, want, tol, mean_tol, label):
    """Each element within ``tol`` LR plus one bf16 step of the value, and
    the mean |difference| over every element within ``mean_tol`` LR."""
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys()
    n, tot = 0, 0.0
    for k, w in want.items():
        g = got[k]
        step = np.spacing(np.maximum(np.abs(g), np.abs(w)).astype(
            np.float32)) * 2.0 ** 16           # one bf16 step (8 bits)
        err = np.abs(g - w)
        bad = err > tol * LR + step
        assert not bad.any(), (
            f"{label} {k}: {int(bad.sum())} elements past {tol} LR, worst "
            f"{float(err.max())!r}")
        n, tot = n + w.size, tot + float(err.sum())
    assert tot / n <= mean_tol * LR, (
        f"{label}: mean |difference| {tot / n / LR:.3g} LR")


def moments_close(got, want, label):
    """Each moment leaf (the int8 m dequantized) within OPT_TOL of its
    largest magnitude; the step counts EQUAL."""
    def moments(opt):
        f = flat(opt)
        out = {}
        for k, v in f.items():
            if k.endswith("/s") and k[:-2] + "/q" in f:
                continue
            if k.endswith("/q"):
                v, k = v * f[k[:-2] + "/s"], k[:-2]
            out[k] = v
        return out
    got, want = moments(got), moments(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        if k == "/step":
            np.testing.assert_array_equal(got[k], w)
            continue
        scale = float(np.abs(w).max()) or 1.0
        err = float(np.abs(got[k] - w).max()) / scale
        assert err <= OPT_TOL, f"{label} {k}: {err:.3g} of max |moment|"


def metrics_close(got, want, tol, label):
    for s, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "zloss", "grad_norm"):
            t = tol * (GNORM_FACTOR if k == "grad_norm" else 1)
            assert abs(g[k] - w[k]) <= t * abs(w[k]), (
                f"{label} step {s} {k}: {g[k]!r} vs {w[k]!r}")


def install(ns: dict, family: str) -> None:
    """Put the module-scoped ``runs`` fixture and the family's tests into
    a test module's namespace ``ns``."""

    @pytest.fixture(scope="module")
    def runs(tmp_path_factory):
        return spawn_runs(family, tmp_path_factory)

    @pytest.mark.parametrize("mesh", ["12", "21"])
    def test_first_gradient_holds_against_one_process(runs, mesh):
        """Every leaf's first gradient within GRAD_TOL of one process's
        (the replicated per-head Mamba scalars and the LoRA pairs
        included); both ranks hold the same gathered gradient."""
        r0, r1 = runs["ranks"]
        got, one = r0[("grad", mesh)], r0[("grad", None)]
        gaps = grad_gaps(got["grads"], one["grads"])
        bad = {k: round(v, 4) for k, v in gaps.items() if v > GRAD_TOL}
        assert not bad, f"{family} on {mesh}: {bad}"
        for k, v in flat(r1[("grad", mesh)]["grads"]).items():
            np.testing.assert_array_equal(flat(got["grads"])[k], v,
                                          err_msg=k)
        assert got["loss"] == pytest.approx(one["loss"], rel=MESH_LOSS_TOL)

    def test_gradient_bound_catches_an_unsummed_leaf(runs):
        """With the model-axis SUMs of the per-head scalars and the LoRA
        pairs skipped, exactly the leaves that need them fail GRAD_TOL on
        (1, 2) (a model rank then holds its block of the gradient only),
        and nothing changes on (2, 1), which has no model axis."""
        r0 = runs["ranks"][0]
        one = r0[("grad", None)]["grads"]
        gaps = grad_gaps(r0[("fault", "12")]["grads"], one)
        assert {k for k, v in gaps.items() if v > GRAD_TOL} == FAULTY[family]
        assert all(gaps[k] >= FAULT_MIN for k in FAULTY[family]), gaps
        for k, v in flat(r0[("grad", "21")]["grads"]).items():
            np.testing.assert_array_equal(
                flat(r0[("fault", "21")]["grads"])[k], v, err_msg=k)

    @pytest.mark.parametrize("mesh", ["12", "21"])
    def test_mesh_steps_hold_against_one_process(runs, mesh):
        """Each step's metrics, the gathered parameters and optimizer
        state after 2 steps, mesh against one process; both ranks hold
        the same gathered state."""
        r0, r1 = runs["ranks"]
        one, got = r0[("train", None)], r0[("train", mesh)]
        metrics_close(got["metrics"], one["metrics"], MESH_LOSS_TOL, family)
        params_close(got["params"], one["params"], MESH_PARAM_TOL,
                     MESH_PARAM_MEAN, f"{family} on {mesh}")
        moments_close(got["opt"], one["opt"], f"{family} on {mesh}")
        for a, b in zip(flat(got["params"]).values(),
                        flat(r1[("train", mesh)]["params"]).values()):
            np.testing.assert_array_equal(a, b)
        assert got["metrics"] == r1[("train", mesh)]["metrics"]

    def test_tensor_parallel_steps_hold_against_reference_jit(runs):
        """The port's (1, 2) steps against the reference's jitted sharded
        train step on two fake CPU devices, from the same weights."""
        got = runs["ranks"][0][("train", "12")]
        metrics_close(got["metrics"], runs["ref"]["metrics"], REF_LOSS_TOL,
                      "ref")
        params_close(got["params"], runs["ref"]["params"], REF_PARAM_TOL,
                     REF_PARAM_MEAN, "against the reference")

    def test_collectives_by_mesh(runs):
        """Tensor parallelism moves activations and their gradients (the
        family's model-axis kinds, no data-axis reduction); FSDP gathers
        weights and reduce-scatters their gradients (no model-axis
        collective)."""
        tp = runs["ranks"][0][("train", "12")]["collectives"]
        dp = runs["ranks"][0][("train", "21")]["collectives"]
        for kind in TP_KINDS[family]:
            assert kind in tp and kind not in dp, kind
        for kind in ("grad_rs", "grad_dp", "mask_count", "gather_batch"):
            assert kind in dp and kind not in tp, kind
        assert "gather_weight" in dp
        assert tp["grad_norm"][0] == dp["grad_norm"][0] == STEPS

    @pytest.mark.parametrize("src,dst", [("12", "21"), ("21", "12")])
    def test_checkpoint_reshards_across_meshes(runs, src, dst):
        """A state saved on one mesh restores EQUAL onto the other, onto
        one device and onto its own placed layout."""
        for r in runs["ranks"]:
            res = r["ckpt"][(src, dst)]
            want = r[("train", src)]
            saved = flat({"params": want["params"], "opt": want["opt"]})
            assert res["step"] == STEPS
            for key in ("onto", "one", "placed"):
                got = flat(res[key])
                assert got.keys() == saved.keys()
                for k, v in saved.items():
                    np.testing.assert_array_equal(got[k], v, err_msg=k)

    @pytest.mark.parametrize("mesh", ["12", "21"])
    def test_reference_checkpoint_restores_on_port_meshes(runs, mesh):
        want = flat({"params": runs["jparams"], "opt": runs["jopt"]})
        for r in runs["ranks"]:
            got = flat(r["ckpt"][("ref", mesh)])
            assert got.keys() == want.keys()
            for k, v in want.items():
                np.testing.assert_array_equal(got[k], v, err_msg=k)

    @pytest.mark.parametrize("src", ["12", "21"])
    def test_port_mesh_checkpoint_restores_in_reference(runs, src):
        """The reference restores a checkpoint the port's mesh wrote:
        every leaf EQUAL to the ranks' gathered state."""
        import jax
        from repro.train import checkpoint as jckpt
        target = jax.tree_util.tree_map(
            lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
            {"params": runs["jparams"], "opt": runs["jopt"]})
        got, step = jckpt.restore_checkpoint(str(runs["dir"] / f"ck{src}"),
                                             target)
        assert step == STEPS
        state = runs["ranks"][0][("train", src)]
        want = flat({"params": state["params"], "opt": state["opt"]})
        got = flat(jax.tree_util.tree_map(np.asarray, got))
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)

    for name, obj in list(locals().items()):
        if name == "runs" or name.startswith("test_"):
            ns[name] = obj

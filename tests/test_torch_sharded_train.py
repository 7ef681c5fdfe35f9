"""Sharded training on gloo meshes: two CPU ranks against one process,
against the reference's jitted sharded step, and across checkpoints.

One module-scoped spawn of two ranks (``torch.multiprocessing``, a file
rendezvous under ``tmp_path``) builds a ``(1, 2)`` ``("data", "model")``
mesh (tensor parallelism: Megatron pairs, head-sharded attention, the
vocab-split tied embedding and cross-entropy) and a ``(2, 1)`` one (FSDP
weights, each data rank two of the batch's four rows), and trains on
both, 2 steps of ``n_accum=2`` with AdamW's int8 m and factored v:

* qwen3_4b SMOKE with ``remat="full"`` on both meshes, and with
  ``n_kv_heads=1`` (heads the model axis does not divide: gathered) on
  ``(1, 2)``;
* internvl2_1b SMOKE (vlm: a zero-mask prefix, QKV biases) on both.

Rank 0 runs the same steps in one process, under the same thread
settings.  Alongside, a subprocess runs the reference's jitted
``make_train_step`` on two fake CPU devices over a ``(1, 2)`` mesh from
the same weights and batch, and the reference writes and reads
checkpoints beside the ranks'.

Tolerances (measured on this suite, stated once):

* MESH_LOSS_TOL — a step's loss and z-loss, relative, mesh against one
  process; GNORM_FACTOR times it for the grad norm.  The first forward
  is one process's to f32 rounding (measured: loss within 1e-7), but a
  gradient that enters a column-parallel region or reduce-scatters sums
  per-rank bf16 partial gradients where one process rounds one product
  once, so gradients sit bf16 steps apart (measured: grad norm within
  4.9e-3), and so do the second step's weights, whose 4-bit layers may
  round to other bins (measured: loss within 8.7e-5).
* MESH_PARAM_TOL — each parameter after 2 steps, in units of LR (plus
  one bf16 step of the value): Adam's update is about ``lr g / |g|``, so
  an element whose gradient sits near 0 may move up to 2 LR a step the
  other way; MESH_PARAM_SHARE of all elements may differ at all.
* REF_* — the same against the reference's jitted step, whose XLA
  fusions round other f32 intermediates again.

EQUAL, with no tolerance: the loss-mask counts (a SUM over the data
axis), the first forward's activation amaxes (MAX-reduced over the axes
that split the tensor), and every checkpoint restore, across meshes and
across packages.
"""
import datetime
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as tdist  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import bitfluid as bf  # noqa: E402
from repro_torch.data.pipeline import make_batch  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import from_numpy_params  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train.loop import TrainConfig, make_train_step  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
LR = 1e-3
STEPS, ACCUM, BATCH, SEQ = 2, 2, 4, 17
WBITS, ABITS = (8, 4), (8,)
MESH_LOSS_TOL = 1e-3
GNORM_FACTOR = 20
MESH_PARAM_TOL = 2.0 * STEPS
MESH_PARAM_MEAN = 0.2
REF_LOSS_TOL = 1e-3
REF_PARAM_TOL = 2.0 * STEPS
REF_PARAM_MEAN = 0.2
OPT_TOL = 0.3
# (name, arch, config overrides, meshes)
CASES = (("dense", "qwen3_4b", {"remat": "full"}, ("12", "21")),
         ("kv1", "qwen3_4b", {"n_kv_heads": 1}, ("12",)),
         ("vlm", "internvl2_1b", {}, ("12", "21")))
MESHES = [(name, m) for name, _, _, on in CASES for m in on]


def _tcfg():
    return TrainConfig(optimizer=AdamWConfig(lr=LR, m_dtype="int8",
                                             v_mode="factored"),
                       n_accum=ACCUM, wbits=WBITS, abits=ABITS)


def _cfg(arch, over):
    return configs.get_smoke(arch).with_(**over)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    t = tree.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


class _Recorder:
    """The first forward's per-tensor activation amaxes (as the fake
    quantizer scales them) and every loss-mask count."""

    def __init__(self, monkey):
        self.amax, self.counts, self.on = [], [], True
        fq, mc = bf.fake_quant, lm._mask_count

        def fake_quant(x, bits, axis=None, reduce=None):
            if self.on and axis is None:
                a = x.detach().abs().amax()
                self.amax.append(float(reduce(a) if reduce else a))
            return fq(x, bits, axis, reduce)

        def mask_count(mask):
            c = mc(mask)
            self.counts.append(float(c))
            return c
        monkey.append((bf, "fake_quant", fq))
        monkey.append((lm, "_mask_count", mc))
        bf.fake_quant, lm._mask_count = fake_quant, mask_count


def _train(mesh, cfg, np_params, batch):
    """STEPS steps from the bridged weights; the gathered state, the
    metrics, the amaxes of the first forward and the mask counts."""
    undo = []
    rec = _Recorder(undo)
    try:
        params = from_numpy_params(np_params, device="cpu")
        p_shd = None
        if mesh is not None:
            p_shd = shd.param_shardings(params, mesh)
            params = shd.shard_params(params, mesh)
        opt = adamw_init(params, _tcfg().optimizer)
        step, _ = make_train_step(_tcfg(), cfg, device="cpu",
                                  param_shardings=p_shd)
        local = batch if mesh is None else shd.shard_batch(batch, mesh)
        metrics = []
        for _ in range(STEPS):
            params, opt, m = step(params, opt, local)
            metrics.append({k: float(v) for k, v in m.items()})
            rec.on = False
    finally:
        for mod, name, fn in undo:
            setattr(mod, name, fn)
    counts = {} if mesh is None else dict(mesh.counts)
    return {"params": _np_tree(shd.full(params)), "opt": _np_tree(
        shd.full(opt)), "metrics": metrics, "amax": rec.amax,
        "counts": rec.counts, "collectives": counts,
        "placed": (params, opt)}


def _rank(rank, init_file, out_dir):
    torch.set_num_threads(1)
    data = np.load(f"{out_dir}/inputs.npz", allow_pickle=True)
    inputs = data["inputs"].item()
    tdist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    out = {}
    try:
        meshes = {"12": make_host_mesh(model=2), "21": make_host_mesh(model=1)}
        for name, arch, over, on in CASES:
            cfg = _cfg(arch, over)
            np_params, batch = inputs[name], _batch(arch)
            for m in on:
                meshes[m].reset_counts()
                out[(name, m)] = _train(meshes[m], cfg, np_params, batch)
        out["ckpt"] = _checkpoints(meshes, out, out_dir, inputs)
    finally:
        tdist.destroy_process_group()
    if rank == 0:
        for name, arch, over, _ in CASES:
            np_params, batch = inputs[name], _batch(arch)
            out[(name, None)] = _train(None, _cfg(arch, over), np_params,
                                       batch)
    for v in out.values():
        if isinstance(v, dict):
            v.pop("placed", None)
    torch.save(out, f"{out_dir}/rank{rank}.pt")


def _checkpoints(meshes, out, out_dir, inputs):
    """Save the dense (1, 2) and (2, 1) states, restore each onto the
    other mesh and onto one device; restore the reference-written
    checkpoint onto both meshes."""
    res = {}
    whole_p = from_numpy_params(inputs["dense"], device="meta")
    whole_o = adamw_init(whole_p, _tcfg().optimizer)
    target = {"params": whole_p, "opt": whole_o}
    for src, dst in (("12", "21"), ("21", "12")):
        params, opt = out[("dense", src)]["placed"]
        d = f"{out_dir}/ck{src}"
        tckpt.save_checkpoint(d, STEPS, {"params": params, "opt": opt})
        specs = {"params": shd.param_shardings(whole_p, meshes[dst]),
                 "opt": shd.opt_shardings(whole_o, meshes[dst])}
        onto, step = tckpt.restore_checkpoint(d, target, specs,
                                              mesh=meshes[dst], device="cpu")
        one, _ = tckpt.restore_checkpoint(d, target, device="cpu")
        placed, _ = tckpt.restore_checkpoint(
            d, {"params": params, "opt": opt}, device="cpu")
        # the layout a fresh placement on dst gives (shard_params, then
        # adamw_init of the blocks) is the restore's (opt_shardings)
        fresh = shd.shard_params(from_numpy_params(inputs["dense"],
                                                   device="cpu"), meshes[dst])
        fresh = {"params": fresh, "opt": adamw_init(fresh,
                                                    _tcfg().optimizer)}
        res[(src, dst)] = {"step": step, "onto": _np_tree(shd.full(onto)),
                           "one": _np_tree(one),
                           "placed": _np_tree(shd.full(placed)),
                           "layouts_equal": _same_layout(onto, fresh)}
    ref = f"{out_dir}/ckref"
    for m in ("12", "21"):
        specs = {"params": shd.param_shardings(whole_p, meshes[m]),
                 "opt": shd.opt_shardings(whole_o, meshes[m])}
        got, _ = tckpt.restore_checkpoint(ref, target, specs, mesh=meshes[m],
                                          device="cpu")
        res[("ref", m)] = _np_tree(shd.full(got))
    return res


def _same_layout(a, b):
    """Whether two placed trees hold the same blocks and layouts."""
    if isinstance(a, dict) != isinstance(b, dict):
        return False
    if not isinstance(a, dict):
        return a.shape == b.shape
    if (getattr(a, "layout", {}) != getattr(b, "layout", {})
            or a.keys() != b.keys()):
        return False
    return all(_same_layout(a[k], b[k]) for k in a)


REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, numpy as np
from jax.sharding import Mesh
from repro import configs, dist
from repro.dist import sharding as shd
from repro.models import lm
from repro.optim.adamw import AdamWConfig, adamw_init
from repro.train.loop import TrainConfig, make_train_step
out_dir, lr = sys.argv[1], float(sys.argv[2])
steps, accum = int(sys.argv[3]), int(sys.argv[4])
data = np.load(f"{out_dir}/inputs.npz", allow_pickle=True)["inputs"].item()
from repro.data.pipeline import make_batch
np_params = data["dense"]
cfg = configs.get_smoke("qwen3_4b").with_(remat="full")
batch = make_batch(0, 0, 4, 17, cfg.vocab_size, cfg)
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


def _batch(arch):
    """BATCH rows of SEQ tokens (and a vlm's prefix), seed 0 step 0: the
    reference's bytes."""
    cfg = configs.get_smoke(arch)
    return make_batch(0, 0, BATCH, SEQ, cfg.vocab_size, cfg)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_train")
    inputs = {}
    for name, arch, over, _ in CASES:              # the reference's weights
        jcfg = jconfigs.get_smoke(arch).with_(**over)
        inputs[name] = jax.tree_util.tree_map(np.asarray, jlm.init_params(
            jcfg, jax.random.PRNGKey(0)))
    np.savez(d / "inputs.npz", inputs=np.array(inputs, dtype=object))
    # the reference writes a checkpoint of its int8/factored state
    jparams = jax.tree_util.tree_map(jnp.asarray, inputs["dense"])
    jopt = jadamw.adamw_init(jparams, jadamw.AdamWConfig(
        m_dtype="int8", v_mode="factored"))
    jopt["step"] = jnp.asarray(3, jnp.int32)
    jckpt.save_checkpoint(str(d / "ckref"), 3, {"params": jparams,
                                                "opt": jopt})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(d), str(LR), str(STEPS),
         str(ACCUM)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        tmp.start_processes(_rank, args=(str(d / "rendezvous"), str(d)),
                            nprocs=WORLD, join=True, start_method="spawn")
    finally:
        _, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-3000:]
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    refz = np.load(d / "ref.npz", allow_pickle=True)
    ref = {"metrics": list(refz["metrics"]),
           "params": {k: refz[k] for k in refz.files if k != "metrics"}}
    return {"ranks": ranks, "ref": ref, "dir": d,
            "jopt": jax.tree_util.tree_map(np.asarray, jopt),
            "jparams": inputs["dense"]}



def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree, np.float32)}


def _params_close(got, want, tol, mean_tol, label):
    """Each element within ``tol`` LR plus one bf16 step of the value, and
    the mean |difference| over every element within ``mean_tol`` LR."""
    got, want = _flat(got), _flat(want)
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


def _moments(opt):
    """Each moment leaf as floats: the int8 m codec dequantized."""
    out = {}
    for k, v in _flat(opt).items():
        if k.endswith("/s") and k[:-2] + "/q" in _flat(opt):
            continue
        if k.endswith("/q"):
            v = v * _flat(opt)[k[:-2] + "/s"]
            k = k[:-2]
        out[k] = v
    return out


def _moments_close(got, want, label):
    """Each moment leaf within OPT_TOL of its largest magnitude; the step
    counts EQUAL."""
    got, want = _moments(got), _moments(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        if k == "/step":
            np.testing.assert_array_equal(got[k], w)
            continue
        scale = float(np.abs(w).max()) or 1.0
        err = float(np.abs(got[k] - w).max()) / scale
        assert err <= OPT_TOL, f"{label} {k}: {err:.3g} of max |moment|"


def _metrics_close(got, want, tol, label):
    for s, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "zloss", "grad_norm"):
            t = tol * (GNORM_FACTOR if k == "grad_norm" else 1)
            assert abs(g[k] - w[k]) <= t * abs(w[k]), (
                f"{label} step {s} {k}: {g[k]!r} vs {w[k]!r}")


@pytest.mark.parametrize("name,mesh", MESHES)
def test_mesh_step_holds_against_one_process(runs, name, mesh):
    """The gathered parameters and optimizer state after 2 steps and each
    step's metrics, mesh against one process; both ranks hold the same
    gathered state."""
    r0, r1 = runs["ranks"]
    one, got = r0[(name, None)], r0[(name, mesh)]
    _metrics_close(got["metrics"], one["metrics"], MESH_LOSS_TOL, name)
    _params_close(got["params"], one["params"], MESH_PARAM_TOL,
                  MESH_PARAM_MEAN, f"{name} on {mesh}")
    _moments_close(got["opt"], one["opt"], f"{name} on {mesh}")
    for a, b in zip(_flat(got["params"]).values(),
                    _flat(r1[(name, mesh)]["params"]).values()):
        np.testing.assert_array_equal(a, b)
    assert got["metrics"] == r1[(name, mesh)]["metrics"]


@pytest.mark.parametrize("name,mesh", MESHES)
def test_mask_counts_and_amaxes_equal(runs, name, mesh):
    """The loss-mask counts are the batch's on every rank, and every
    per-tensor activation amax of the first forward is the whole
    tensor's (a MAX over the axes that split it): both EQUAL to one
    process's.  The forward computes what one process computes: FSDP
    gathers whole weights for each row, and a row-parallel linear sums
    f32 partial products that round to bf16 once."""
    one = runs["ranks"][0][(name, None)]
    for got in (r[(name, mesh)] for r in runs["ranks"]):
        assert got["counts"] == one["counts"]
        assert got["amax"] == one["amax"]
        assert got["metrics"][0]["loss"] == pytest.approx(
            one["metrics"][0]["loss"], rel=1e-6)


def test_tensor_parallel_step_holds_against_reference_jit(runs):
    """The port's (1, 2) steps against the reference's jitted sharded
    train step on two fake CPU devices, from the same weights."""
    got = runs["ranks"][0][("dense", "12")]
    ref = runs["ref"]
    _metrics_close(got["metrics"], ref["metrics"], REF_LOSS_TOL, "ref")
    want = {}
    for k, v in ref["params"].items():
        node = want
        parts = k.strip("/").split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    _params_close(got["params"], want, REF_PARAM_TOL, REF_PARAM_MEAN,
                  "against the reference")


def test_collectives_by_mesh(runs):
    """Tensor parallelism moves activations and gradients of activations
    (no weight gathers, no data-axis reductions); FSDP gathers weights
    and reduce-scatters their gradients (no model-axis sums)."""
    tp = runs["ranks"][0][("dense", "12")]["collectives"]
    dp = runs["ranks"][0][("dense", "21")]["collectives"]
    for kind in ("sum_tp", "grad_tp", "amax_tp", "embed", "xent_sum",
                 "xent_gold"):
        assert kind in tp and kind not in dp, kind
    for kind in ("gather_weight", "grad_rs", "grad_dp", "amax_dp",
                 "mask_count", "gather_batch"):
        assert kind in dp and kind not in tp, kind
    assert tp["grad_norm"][0] == dp["grad_norm"][0] == STEPS


@pytest.mark.parametrize("src,dst", [("12", "21"), ("21", "12")])
def test_checkpoint_reshards_across_meshes(runs, src, dst):
    """A state saved on one mesh restores EQUAL onto the other, onto one
    device and onto its own placed layout."""
    for r in runs["ranks"]:
        res = r["ckpt"][(src, dst)]
        want = r[("dense", src)]
        saved = _flat({"params": want["params"], "opt": want["opt"]})
        assert res["step"] == STEPS and res["layouts_equal"]
        for key in ("onto", "one", "placed"):
            got = _flat(res[key])
            assert got.keys() == saved.keys()
            for k, v in saved.items():
                np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("mesh", ["12", "21"])
def test_reference_checkpoint_restores_on_port_meshes(runs, mesh):
    want = _flat({"params": runs["jparams"], "opt": runs["jopt"]})
    for r in runs["ranks"]:
        got = _flat(r["ckpt"][("ref", mesh)])
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("src", ["12", "21"])
def test_port_mesh_checkpoint_restores_in_reference(runs, src):
    """The reference restores a checkpoint the port's mesh wrote: every
    leaf EQUAL to the ranks' gathered state."""
    target = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
        {"params": runs["jparams"], "opt": runs["jopt"]})
    got, step = jckpt.restore_checkpoint(str(runs["dir"] / f"ck{src}"),
                                         target)
    assert step == STEPS
    state = runs["ranks"][0][("dense", src)]
    want = _flat({"params": state["params"], "opt": state["opt"]})
    got = _flat(jax.tree_util.tree_map(np.asarray, got))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


"""Sharded training's pieces on gloo meshes: expert-parallel MoE training,
the sharded AdamW and the train-form linear, two CPU ranks against one
process.

One module-scoped spawn of two ranks builds a ``(1, 2)`` and a ``(2, 1)``
``("data", "model")`` mesh and runs:

* moonshot_v1_16b_a3b SMOKE, 2 steps of AdamW on ``(1, 2)``: every layer
  expert-parallel (each model rank 4 of the 8 experts, the combine a SUM
  over the model axis), the router column-parallel, the shared experts a
  Megatron pair, the untied head vocab-parallel.  Rank 0 runs each step
  again in one process from the mesh's starting state, with
  ``moe.apply_moe`` replaced by ``moe.ep_reference(tp=2)``, the
  reference's expert-parallel semantics stated in one process (per-shard
  capacity, local activation scales);
* ``adamw_update`` on placed blocks against the whole tensors: column-
  and row-parallel, FSDP, vocab-split, stacked, replicated and 1-d
  leaves, int8 m and factored v, clip 1 never reached;
* ``common.apply_linear`` of a placed train-form linear (column- and
  row-parallel, FSDP) against the whole weight: output, gradients, and
  every scale the fake quantizer takes.

Tolerances: MOE_* as ``test_torch_sharded_train``'s mesh tolerances
(stated there), for one step; ADAM_TOL, f32 rounding of a SUM over
ranks against one sum (relative); LINEAR_TOL, in bf16 steps at the
largest magnitude: a gradient that enters a column-parallel region
SUMs bf16 partial gradients, where one process rounds one product
once.  EQUAL: the expert-parallel forward (loss, z-loss, aux), the
codec's q and s, the fake quantizer's amaxes (MAX-reduced over the
axes that split the tensor), the dispatch's token drops.
"""
import contextlib
import datetime

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as tdist  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core import bitfluid as bf  # noqa: E402
from repro_torch.data.pipeline import make_batch  # noqa: E402
from repro_torch.dist import api as dist  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.loop import TrainConfig, make_train_step  # noqa: E402

WORLD = 2
LR = 1e-3
STEPS = 2
MOE_GNORM_TOL = 2e-2
MOE_PARAM_TOL = 2.0
MOE_PARAM_MEAN = 0.2
ADAM_TOL = 1e-5
LINEAR_TOL = 1
COLPAR_APART = 1e-3
# leaves of every layout the rules give (paths decide the rule)
ADAM_SHAPES = {"emb": (16, 8), "ln_f": {"scale": (8,)},
               "layers": {"attn": {"wq": {"w": (2, 8, 12)},
                                   "wo": {"w": (2, 12, 8)}},
                          "ln1": {"scale": (2, 8)}},
               "head": {"w": (8, 16), "b": (16,)}}


def _ocfg():
    return adamw.AdamWConfig(lr=LR, m_dtype="int8", v_mode="factored",
                             grad_clip=1e6)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    t = tree.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def _moe_setup():
    cfg = configs.get_smoke("moonshot_v1_16b_a3b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    tcfg = TrainConfig(optimizer=adamw.AdamWConfig(lr=LR), n_accum=1,
                       wbits=(8, 4), abits=(8,))
    batch = make_batch(0, 0, 2, 17, cfg.vocab_size, cfg)
    step, _ = make_train_step(tcfg, cfg, device="cpu")
    return cfg, params, tcfg, batch, step


def _moe_train(mesh):
    """STEPS expert-parallel steps; each step's starting state gathered
    whole, its metrics, token drops and updated parameters."""
    cfg, params, tcfg, batch, step = _moe_setup()
    params = shd.shard_params(params, mesh)
    batch = shd.shard_batch(batch, mesh)
    opt = adamw.adamw_init(params, tcfg.optimizer)
    out = []
    mesh.reset_counts()
    for _ in range(STEPS):
        start = (shd.full(params), shd.full(opt))
        before = moe.ep_dropped[0]
        params, opt, m = step(params, opt, batch)
        out.append({"start": start, "dropped": moe.ep_dropped[0] - before,
                    "metrics": {k: float(v) for k, v in m.items()},
                    "params": _np_tree(shd.full(params))})
    return out, dict(mesh.counts)


def _xent_split_order(logits, targets, mask, mesh=None, axes=()):
    """``lm._xent`` of one process with the log-partition summed in the
    vocab-split mesh's f32 order, the reference's SPMD partition of the
    same softmax: a MAX of the WORLD vocab blocks' maxima, then a SUM of
    their ``exp`` sums.  ``torch.logsumexp`` over the whole row sums in
    another order, so its z-loss may stand one f32 ulp apart."""
    blocks = logits.chunk(WORLD, dim=-1)
    m = torch.stack([b.detach().amax(dim=-1) for b in blocks]).amax(dim=0)
    se = torch.exp(blocks[0] - m[..., None]).sum(dim=-1)
    for b in blocks[1:]:
        se = se + torch.exp(b - m[..., None]).sum(dim=-1)
    logz = torch.log(se) + m
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = (logz - gold) * mask
    denom = mask.sum().clamp_min(1.0)
    zloss = ((logz * mask) ** 2).sum() / denom
    return nll.sum() / denom, zloss


def _moe_one(steps):
    """Each step again in one process from the mesh's starting state,
    ``moe.apply_moe`` replaced by ``moe.ep_reference(tp=2)`` and the
    cross-entropy's log-partition summed in the mesh's order
    (:func:`_xent_split_order`)."""
    cfg, _, _, batch, step = _moe_setup()
    apply, xent = moe.apply_moe, lm._xent
    moe.apply_moe = lambda p, x, c, wb=8, ab=8: moe.ep_reference(
        p, x, c, wb, ab, tp=2)
    lm._xent = _xent_split_order
    out = []
    try:
        for st in steps:
            before = moe.ep_dropped[0]
            params, _, m = step(*st["start"], batch)
            out.append({"dropped": moe.ep_dropped[0] - before,
                        "metrics": {k: float(v) for k, v in m.items()},
                        "params": _np_tree(params)})
    finally:
        moe.apply_moe, lm._xent = apply, xent
    return out


def _place(tree, specs, mesh):
    """This rank's blocks of a whole tree laid out by ``specs``, each dict
    holding blocks a ``Local`` (as a resharding restore gives them)."""
    items, layout = {}, {}
    for k, v in tree.items():
        if isinstance(v, dict):
            items[k] = _place(v, specs[k], mesh)
            continue
        items[k] = shd.block(mesh, v, specs[k]).clone()
        if any(e is not None for e in specs[k]):
            layout[k] = (tuple(v.shape), tuple(specs[k]))
    return shd.Local(items, mesh, layout) if layout else items


def _adam_case(mesh):
    """One update of whole tensors and of this rank's blocks."""
    gen = torch.Generator().manual_seed(3)

    def draw(shape):
        if isinstance(shape, dict):
            return {k: draw(v) for k, v in shape.items()}
        return torch.randn(shape, generator=gen).to(torch.bfloat16)
    params, grads, m0 = draw(ADAM_SHAPES), draw(ADAM_SHAPES), \
        draw(ADAM_SHAPES)
    grads = adamw.tree_map(lambda g: g.float(), grads)
    cfg = _ocfg()
    whole = adamw.adamw_init(params, cfg)
    # a non-zero first moment, so the codec's scales are not all eps
    whole["m"] = adamw.tree_map(lambda t: adamw._enc_i8(t.float()), m0)
    pb, gb = shd.shard_params(params, mesh), shd.shard_params(grads, mesh)
    opt = _place(whole, shd.opt_shardings(whole, mesh), mesh)
    out = {"whole": adamw.adamw_update(params, grads, whole, cfg)}
    out["mesh"] = adamw.adamw_update(pb, gb, opt, cfg)
    norms = (adamw.global_norm(grads),
             adamw.global_norm(gb, adamw.leaf_layouts(pb)))
    res = {}
    for key, (p, o, m) in out.items():
        res[key] = {"params": _np_tree(shd.full(p)),
                    "opt": _np_tree(shd.full(o)),
                    "metrics": {k: float(v) for k, v in m.items()}}
    res["norms"] = tuple(float(n) for n in norms)
    return res


class _Scales:
    """Every amax the fake quantizer takes (after its reduce)."""

    def __init__(self):
        self.seen, self._fq = [], bf.fake_quant

    def __enter__(self):
        def fq(x, bits, axis=None, reduce=None):
            ax = x.detach().abs()
            a = ax.amax() if axis is None else ax.amax(dim=axis, keepdim=True)
            self.seen.append((reduce(a) if reduce else a).float().numpy())
            return self._fq(x, bits, axis, reduce)
        bf.fake_quant = fq
        return self

    def __exit__(self, *exc):
        bf.fake_quant = self._fq


def _linear_case(mesh):
    """A column-parallel wq and a row-parallel wo (a Megatron pair) of a
    placed dict, against the whole weights: output, gradients, scales."""
    gen = torch.Generator().manual_seed(4)
    whole = {"wq": {"w": (torch.randn((8, 12), generator=gen) * 0.3).to(
        torch.bfloat16), "b": torch.randn((12,), generator=gen).to(
            torch.bfloat16)},
        "wo": {"w": (torch.randn((12, 8), generator=gen) * 0.3).to(
            torch.bfloat16)}}
    x = torch.randn((4, 3, 8), generator=gen).to(torch.bfloat16)
    res = {}
    for key, p, xs, m in (("whole", whole, x, None),
                          ("mesh", shd.shard_params(whole, mesh),
                           shd.shard_batch({"x": x}, mesh)["x"], mesh)):
        live = [t.detach().requires_grad_(True)
                for t in adamw.tree_leaves(p)]
        tree = adamw.tree_unflatten(p, live)
        xin = xs.detach().requires_grad_(True)
        with _Scales() as sc, contextlib.ExitStack() as ctx:
            if m is not None:
                ctx.enter_context(dist.use_mesh(m))
                if dist.dp_size(m) > 1:
                    ctx.enter_context(kops.split_rows(m))
            h = cm.local_linear(tree["wq"], xin, 4, 8)
            y = cm.apply_linear(tree["wo"], h, 8, 4)
            loss = (y.float() ** 2).sum()
            grads = torch.autograd.grad(loss, live + [xin])
        if m is not None:       # the rows' shares: SUM over the data axis
            grads = [g if lay is not None and any(
                a in m.dp_axes for e in lay[2]
                for a in dist.entry_axes(e)) else m.sum_grad(
                    g, m.dp_axes, kind="test") for g, lay in zip(
                grads[:-1], adamw.leaf_layouts(p))] + [grads[-1]]
            y = m.gather_rows(y) if dist.dp_size(m) > 1 else y
            xg = m.gather_rows(grads[-1]) if dist.dp_size(m) > 1 \
                else grads[-1]
            gt = adamw.tree_unflatten(p, grads[:-1])
        else:
            xg, gt = grads[-1], adamw.tree_unflatten(p, grads[:-1])
        res[key] = {"y": _np_tree(y), "x_grad": _np_tree(xg),
                    "grads": _np_tree(shd.full(gt)), "scales": sc.seen}
    return res


def _colpar_grad_case(mesh):
    """The input gradient of a column-parallel linear (no quantization:
    bits 16) on ``mesh`` and of the whole weight in one process."""
    gen = torch.Generator().manual_seed(5)
    w = (torch.randn((512, 1024), generator=gen) * 0.05).to(torch.bfloat16)
    x = torch.randn((64, 512), generator=gen).to(torch.bfloat16)
    dy = torch.randn((64, 1024), generator=gen).to(torch.bfloat16)
    out = {}
    for key, p, m in (("whole", {"wq": {"w": w}}, None),
                      ("mesh", shd.shard_params({"wq": {"w": w}}, mesh),
                       mesh)):
        xin = x.clone().requires_grad_(True)
        with contextlib.ExitStack() as ctx:
            if m is not None:
                ctx.enter_context(dist.use_mesh(m))
            y = cm.apply_linear(p["wq"], xin, 16, 16)
            y.backward(dy)
        out[key] = xin.grad.float().numpy()
    return out


def _remat_case(mesh):
    """qwen3_4b SMOKE with ``remat="full"`` on ``mesh``: the gradients of
    one loss with the backward (and so each layer's recompute) run on
    another thread, where no mesh is active (a CUDA backward runs on
    autograd's device thread), against the backward on this thread."""
    import threading
    cfg = configs.get_smoke("qwen3_4b").with_(remat="full")
    params = shd.shard_params(lm.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"), mesh)
    batch = shd.shard_batch(make_batch(0, 0, 2, 17, cfg.vocab_size, cfg),
                            mesh)
    wv = torch.tensor([8, 4], dtype=torch.int32)
    av = torch.tensor([8, 8], dtype=torch.int32)
    out = []
    for where in ("here", "thread"):
        live = [t.detach().requires_grad_(True)
                for t in adamw.tree_leaves(params)]
        with dist.use_mesh(mesh):
            total, _ = lm.train_loss(adamw.tree_unflatten(params, live),
                                     batch, cfg, wv, av)
        if where == "here":
            with dist.use_mesh(mesh):
                grads = torch.autograd.grad(total, live)
        else:
            box = []
            t = threading.Thread(target=lambda: box.append(
                torch.autograd.grad(total, live)))
            t.start()
            t.join()
            grads = box[0]
        out.append([g.float().numpy() for g in grads])
    return out


def _rank(rank, init_file, out_dir):
    torch.set_num_threads(1)
    tdist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    out = {"rank": rank}
    try:
        meshes = {"12": make_host_mesh(model=2), "21": make_host_mesh(model=1)}
        out["moe"], out["moe_counts"] = _moe_train(meshes["12"])
        out["colpar_grad"] = _colpar_grad_case(meshes["12"])
        for name, mesh in meshes.items():
            out[("remat", name)] = _remat_case(mesh)
            out[("adam", name)] = _adam_case(mesh)
            out[("linear", name)] = _linear_case(mesh)
    finally:
        tdist.destroy_process_group()
    if rank == 0:               # the reference's EP semantics in one process
        out["moe_one"] = _moe_one(out["moe"])
    for st in out["moe"]:
        st.pop("start")
    torch.save(out, f"{out_dir}/rank{rank}.pt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_pieces")
    tmp.start_processes(_rank, args=(str(d / "rendezvous"), str(d)),
                        nprocs=WORLD, join=True, start_method="spawn")
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _bf16_step(a):
    """One bf16 step at the largest magnitude of ``a``."""
    return float(np.spacing(np.float32(np.abs(a).max()))) * 2.0 ** 16


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree, np.float32)}


def test_expert_parallel_training_holds_against_ep_reference(ranks):
    """Each expert-parallel step against the same step in one process
    from the same state: the forward is EQUAL (the same routing, drops,
    loss and aux), the gradients and updates within the mesh tolerances.
    Steps start from one state because a routing decision is discrete: a
    later step's weights, a rounding apart, may send a token whose top-k
    scores nearly tie to another expert."""
    for s, one in enumerate(ranks[0]["moe_one"]):
        # each model rank drops its own experts' overflow
        assert sum(r["moe"][s]["dropped"] for r in ranks) == one["dropped"]
    for r in ranks:
        for s, (got, one) in enumerate(zip(r["moe"], ranks[0]["moe_one"])):
            g, w = got["metrics"], one["metrics"]
            for k in ("loss", "zloss", "moe_aux"):
                assert g[k] == w[k], (s, k, g[k], w[k])
            assert abs(g["grad_norm"] - w["grad_norm"]) <= \
                MOE_GNORM_TOL * w["grad_norm"], (s, g, w)
            n, tot = 0, 0.0
            for k, w in _flat(one["params"]).items():
                g = _flat(got["params"])[k]
                step = np.spacing(np.maximum(np.abs(g), np.abs(w))) * 2.0 ** 16
                err = np.abs(g - w)
                assert (err <= MOE_PARAM_TOL * LR + step).all(), (s, k)
                n, tot = n + w.size, tot + float(err.sum())
            assert tot / n <= MOE_PARAM_MEAN * LR, (s, tot / n / LR)
    counts = ranks[0]["moe_counts"]
    assert counts["moe_combine"][0] > 0 and "grad_rs" not in counts


@pytest.mark.parametrize("mesh", ["12", "21"])
def test_sharded_adamw_against_whole_tensors(ranks, mesh):
    """The global norm counts each leaf once (replicated leaves are not
    multiplied by the ranks that hold them), factored v's means over
    split dims and the codec's row maxima are the whole tensor's."""
    for r in ranks:
        res = r[("adam", mesh)]
        whole, got = res["whole"], res["mesh"]
        n_whole, n_mesh = res["norms"]
        assert abs(n_mesh - n_whole) <= ADAM_TOL * n_whole
        assert abs(got["metrics"]["grad_norm"] - n_whole) <= ADAM_TOL * n_whole
        assert got["metrics"]["clip"] == whole["metrics"]["clip"] == 1.0
        w_opt, g_opt = _flat(whole["opt"]), _flat(got["opt"])
        assert w_opt.keys() == g_opt.keys()
        for k, w in w_opt.items():
            if k.endswith(("/q", "/s", "/step")):       # the int8 codec
                np.testing.assert_array_equal(g_opt[k], w, err_msg=k)
            else:                                       # factored v
                scale = float(np.abs(w).max()) or 1.0
                assert np.abs(g_opt[k] - w).max() <= ADAM_TOL * scale, k
        for k, w in _flat(whole["params"]).items():
            g = _flat(got["params"])[k]
            step = np.spacing(np.abs(w)) * 2.0 ** 16
            assert (np.abs(g - w) <= step).all(), k


@pytest.mark.parametrize("mesh", ["12", "21"])
def test_train_linear_on_a_mesh_against_whole(ranks, mesh):
    for r in ranks:
        res = r[("linear", mesh)]
        whole, got = res["whole"], res["mesh"]
        for key in ("y", "x_grad"):
            err = np.abs(got[key] - whole[key]).max()
            assert err <= LINEAR_TOL * _bf16_step(whole[key]), key
        for k, w in _flat(whole["grads"]).items():
            err = np.abs(_flat(got["grads"])[k] - w).max()
            assert err <= LINEAR_TOL * _bf16_step(w), k
        # every scale EQUAL: the local amaxes MAX-reduced to the whole's;
        # a column-parallel weight's per-column amax is its own columns'
        assert len(got["scales"]) == len(whole["scales"])
        for g, w in zip(got["scales"], whole["scales"]):
            if g.shape != w.shape:
                n = g.shape[-1]
                w = w[..., r["rank"] * n:(r["rank"] + 1) * n]
            np.testing.assert_array_equal(g, w)


def test_column_parallel_input_gradient_rounds_once(ranks):
    """A column-parallel linear's input gradient on (1, 2) against one
    process's: each rank's partial ``dy @ w^T`` over its columns stays
    float32 through the SUM over the model axis and rounds to bf16 once,
    as one process rounds its whole product once.  Only the order of
    the f32 sum differs, so an element may round to the neighbouring
    bf16 value: at most one bf16 step at its own magnitude (plus one f32
    step at the largest, the sum's own rounding where its terms cancel),
    in at most COLPAR_APART of the elements (partials rounded to bf16
    before the SUM left 12,217 of these 32,768 elements apart)."""
    for r in ranks:
        got, whole = r["colpar_grad"]["mesh"], r["colpar_grad"]["whole"]
        step = (np.spacing(np.maximum(np.abs(got), np.abs(whole))) * 2.0 ** 16
                + np.spacing(np.abs(whole).max()))
        assert (np.abs(got - whole) <= step).all()
        apart = int((got != whole).sum())
        assert apart <= COLPAR_APART * whole.size, apart


@pytest.mark.parametrize("mesh", ["12", "21"])
def test_remat_recompute_on_another_thread(ranks, mesh):
    """A layer's recompute re-enters the forward's mesh wherever the
    backward runs: the gradients EQUAL the same-thread backward's."""
    for r in ranks:
        here, thread = r[("remat", mesh)]
        assert len(here) == len(thread)
        for a, b in zip(here, thread):
            np.testing.assert_array_equal(a, b)

"""Sharded serving on gloo meshes: two CPU ranks against the port's
single-process engines.  Every check here is EQUAL (tokens, logits,
records); there is no tolerance.

One module-scoped spawn of two ranks (``torch.multiprocessing``, a file
rendezvous under ``tmp_path``) builds the same world as a ``(1, 2)``
``("data", "model")`` mesh (tensor parallelism) and a ``(2, 1)`` one
(data parallelism, FSDP weights), and serves on them:

* qwen3_4b SMOKE on ``(1, 2)`` with no plan: ``generate`` (per-request
  and whole-batch budgets; the latter quantizes each activation per
  tensor, so a row-parallel linear's amax is MAX-reduced), the prefill's
  last logits, ``generate`` past a lowered flash threshold (attention on
  the local heads through the flash path), and continuous serving;
* ``(2, 1)`` with no plan (FSDP, rows split) and with a partial plan:
  continuous serving and ``generate`` (its batch split over the data
  ranks), the records carrying the plan's replicas;
* speculation (``spec_k=4``) and the prefix cache on ``(2, 1)`` under
  ``plan="auto"``, where a hit's row lives on another rank and is
  broadcast to the slot's owner, and speculation with FSDP weights;
* a config whose KV heads the model axis does not divide
  (``n_kv_heads=1``) on ``(1, 2)``: heads gathered, the cache's head dim
  sharded;
* ResNet18 at 32 px on both meshes;
* the mesh's own pieces: ``constrain``, ``shard_map_compat``, a
  ``CachePool.copy_row`` across ranks and the collective counts.

Rank 0 also runs the single-process engines after the mesh runs, so both
sides run under the same thread settings.
"""
import datetime

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as tdist  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402

from repro_torch import configs, dist  # noqa: E402
from repro_torch.core import policy as pol  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import cnn, lm  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve.cnn import CNNServeEngine  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.prefix_cache import PrefixCache  # noqa: E402

WORLD = 2
PROMPTS = ([3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8], [6, 2, 8, 1, 8, 2],
           [9, 9, 8, 7, 6])
BUDGETS = (2.0, 0.75, 0.5, 2.0)                 # int8 / mixed / int4
GEN_TOKENS = np.array([[5, 3, 7, 1, 2, 8, 9, 4, 4, 6],
                       [1, 1, 2, 3, 5, 8, 13, 21, 34, 55]], np.int32)
# prompts that share 4-token chunks: later ones hit earlier entries
PC_PROMPTS = ([11, 12, 13, 14, 15, 16], [21, 22, 23, 24, 25],
              [11, 12, 13, 14, 15, 16], [21, 22, 23, 24, 25, 26, 27],
              [11, 12, 13, 14, 17], [21, 22, 23, 24, 25])
CNN_IMAGE, CNN_BATCH = 32, 4


def _qwen(kv=None):
    cfg = configs.get_smoke("qwen3_4b")
    if kv is not None:
        cfg = cfg.with_(n_kv_heads=kv)
    q = lm.quantize_params(lm.init_params(
        cfg, torch.Generator().manual_seed(4), device="cpu"), cfg)
    return cfg, q


def _ctrl(cfg):
    return pol.BudgetController(
        {"int4": pol.fixed(4), "mixed": pol.per_layer([8, 4], name="mixed"),
         "int8": pol.fixed(8)},
        {"int4": 0.5, "mixed": 0.75, "int8": 1.0}, lm.n_bit_slots(cfg))


def _engine(cfg, q, mesh, **kw):
    kw.setdefault("n_slots", 4)
    return ServeEngine(cfg, q, max_len=64, controller=_ctrl(cfg),
                       prefill_len=8, decode_block=4, seed=0, device="cpu",
                       mesh=mesh, **kw)


def _continuous(eng, prompts=PROMPTS, budgets=BUDGETS, **kw):
    rids = [eng.submit(p, max_new_tokens=5, budget_s=b, **kw)
            for p, b in zip(prompts, budgets)]
    eng.run()
    recs = [eng.requests[r] for r in rids]
    return {"tokens": [r.tokens for r in recs],
            "replicas": [r.plan_replicas for r in recs],
            "hits": [r.cache_hit for r in recs],
            "spec": [r.spec_rounds for r in recs]}


def _counts(mesh):
    return {k: list(v) for k, v in mesh.counts.items()}


def _generate(eng, budget, flash=False):
    eng.set_budget(budget)
    prev = tf.FLASH_THRESHOLD
    if flash:
        tf.FLASH_THRESHOLD = 4          # 10-token prompts take _flash
    try:
        return eng.generate({"tokens": GEN_TOKENS}, 4).cpu().numpy()
    finally:
        tf.FLASH_THRESHOLD = prev


def _prefill_logits(eng, budget):
    """The whole batch's last-position prefill logits at one budget."""
    cfg = eng.cfg
    wv, av = eng.controller.resolve(torch.tensor(budget))
    with eng.compute_ctx():
        cache = lm.empty_cache(cfg, GEN_TOKENS.shape[0], 64, device="cpu",
                               mesh=eng.mesh)
        logits, _ = lm.prefill(eng.qparams,
                               {"tokens": torch.from_numpy(GEN_TOKENS)},
                               cfg, wv, av, cache)
    return logits.numpy()


def _lm_runs(mesh12, mesh21, partial):
    out = {}
    cfg, q = _qwen()
    if mesh12 is not None or mesh21 is None:
        e = _engine(cfg, q, mesh12)
        if mesh12 is not None:
            mesh12.reset_counts()
        out["tp_gen_rows"] = _generate(e, [2.0, 0.5])
        out["tp_counts"] = _counts(mesh12) if mesh12 else {}
        out["tp_gen_scalar"] = _generate(e, 0.5)
        out["tp_gen_flash"] = _generate(e, [0.75, 2.0], flash=True)
        out["tp_logits"] = _prefill_logits(e, 0.5)
        out["tp_cont"] = _continuous(_engine(cfg, q, mesh12))
        kcfg, kq = _qwen(kv=1)
        e = _engine(kcfg, kq, mesh12)
        out["kv1_gen"] = _generate(e, [2.0, 0.5])
        out["kv1_gen_flash"] = _generate(e, 0.75, flash=True)
        out["kv1_cont"] = _continuous(_engine(kcfg, kq, mesh12))
    if mesh21 is not None or mesh12 is None:
        e = _engine(cfg, q, mesh21)
        out["dp_cont"] = _continuous(e)
        out["dp_gen_rows"] = _generate(_engine(cfg, q, mesh21), [2.0, 0.5])
        out["dp_gen_scalar"] = _generate(_engine(cfg, q, mesh21), 0.5)
        out["dp_sharded"] = mesh21 is not None and dist.sharding.is_sharded(
            e.qparams)
        e = _engine(cfg, q, mesh21, plan=partial)
        out["partial_cont"] = _continuous(e)
        out["partial_plan"] = None if e.plan is None else (
            e.plan.summary(), e.plan.mean_replicas,
            mesh21 is not None and dist.sharding.is_sharded(e.qparams))
        e = _engine(cfg, q, mesh21, plan="auto" if mesh21 else None,
                    spec_k=4, draft_budget_s=0.5)
        out["spec_auto"] = _continuous(e)
        out["spec_fsdp"] = _continuous(_engine(cfg, q, mesh21, spec_k=4,
                                               draft_budget_s=0.5))
        e = _engine(cfg, q, mesh21, plan="auto" if mesh21 else None,
                    prefix_cache=PrefixCache(chunk=4, capacity=8))
        if mesh21 is not None:
            mesh21.reset_counts()
        out["pc"] = _continuous(e, PC_PROMPTS, (2.0,) * len(PC_PROMPTS))
        out["pc_counts"] = _counts(mesh21) if mesh21 else {}
        out["pc_ledger"] = dict(vars(e.prefix_cache.ledger))
        out["pc_slots"] = [r.slot for r in e.requests.values()]
    return out


def _partial_plan(cfg):
    return dist.plan_for_controller(
        _ctrl(cfg), lm.layer_gemm_dims(cfg), n_devices=2,
        head=lm.head_gemm_dims(cfg), memory_budget=1.5)


def _cnn_run(mesh):
    gen = torch.Generator().manual_seed(2)
    params, layers = cnn.init_cnn("resnet18", gen, image=CNN_IMAGE,
                                  device="cpu")
    images = torch.randn((CNN_BATCH, CNN_IMAGE, CNN_IMAGE, 3), generator=gen)
    ctrl = pol.cnn_budget_controller("resnet18", layers=layers)
    preds = [ctrl.predicted_latency_s[k] for k in ctrl.order()]
    budgets = [0.0, preds[1] * 1.01, preds[3] * 1.01, 1e30]
    eng = CNNServeEngine(params, layers, controller=ctrl,
                         max_batch=CNN_BATCH, device="cpu", mesh=mesh)
    return eng.serve(images, budgets)[0]


def _pieces(mesh12, mesh21):
    """constrain, shard_map_compat, copy_row across ranks, counts."""
    out = {}
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    with dist.use_mesh(mesh12):
        loc = dist.constrain(x, ("dp", None, "tp"))
        back = dist.constrain(loc, ("dp", None, None),
                              have=("dp", None, "tp"))
        with dist.manual_mode():
            same = dist.constrain(x, ("dp", None, "tp"))
    out["constrain"] = (loc.numpy(), back.numpy(), same.numpy())
    # each rank's block times (the model axis's size / 2): the block
    f = dist.shard_map_compat(
        lambda a: a * mesh12.all_reduce(torch.ones(()), mesh12.tp_axes,
                                        "sum") / 2,
        mesh=mesh12, in_specs=(dist.P(None, None, "model"),),
        out_specs=dist.P(None, None, "model"))
    out["shard_map"] = f(x).numpy()
    # packed-int4 and int8 containers, column- and row-parallel, at static
    # bits (the packed kernel's path), tensor bits and per-row bits
    g = torch.Generator().manual_seed(7)
    x = torch.randn((2, 3, 64), generator=g).to(torch.bfloat16)
    lins = {}
    for cont in ("int4", "int8"):
        w = {"w": (torch.randn((64, 96), generator=g) * 0.1).to(
            torch.bfloat16), "b": torch.randn((96,), generator=g).to(
            torch.bfloat16)}
        q = cm.quantize_linear(w, cont)
        for name in ("wg", "wd"):
            tree = {"layers": {"mlp": {name: {k: v[None] for k, v in
                                              q.items()}}}}
            for mname, mesh in (("12", mesh12), ("21", mesh21)):
                lin = cm.stack_slice(dist.shard_params(tree, mesh)[
                    "layers"]["mlp"][name], 0)
                with dist.use_mesh(mesh):
                    got = [cm.apply_linear(lin, x, wb, 8) for wb in
                           (4, torch.tensor(6), torch.tensor([8, 3]))]
                want = [cm.apply_linear(q, x, wb, 8) for wb in
                        (4, torch.tensor(6), torch.tensor([8, 3]))]
                lins[(cont, name, mname)] = all(
                    torch.equal(a, b) for a, b in zip(got, want))
    out["linears"] = lins
    cfg = configs.get_smoke("qwen3_4b")
    pool = lm.CachePool(cfg, 4, 16, device="cpu", rows=(
        2 * mesh21.dp_index, 2 * mesh21.dp_index + 2), mesh=mesh21)
    for s in range(4):
        assert pool.alloc() == s
        row = None
        if pool.owns(s):
            row = lm.empty_cache(cfg, 1, 16, device="cpu")
            row["kpos"][:, 0, :3] = torch.arange(3) + 10 * s
            row["k"][:, 0, :3] = float(s + 1)
        pool.write_row(row, s, 3)
    mesh21.reset_counts()
    pool.copy_row(0, 3)                 # rank 0's slot -> rank 1's
    pool.copy_row(2, 1)                 # and back
    out["pool"] = {k: v.clone() for k, v in pool.cache.items()}
    out["pool_counts"] = _counts(mesh21)
    return out


def _rank(rank, init_file, out_dir):
    torch.set_num_threads(1)
    tdist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    try:
        mesh12 = make_host_mesh(model=2)
        mesh21 = make_host_mesh(model=1)
        out = {"coords": (mesh12.shape, mesh21.shape, mesh12.tp_index,
                          mesh21.dp_index)}
        partial = _partial_plan(configs.get_smoke("qwen3_4b"))
        out["lm12"] = _lm_runs(mesh12, None, partial)
        out["lm21"] = _lm_runs(None, mesh21, partial)
        mesh12.reset_counts()
        out["cnn12"] = _cnn_run(mesh12)
        out["cnn12_counts"] = _counts(mesh12)
        out["cnn21"] = _cnn_run(mesh21)
        out["pieces"] = _pieces(mesh12, mesh21)
    finally:
        tdist.destroy_process_group()
    if rank == 0:                       # the single-process engines
        out["single"] = _lm_runs(None, None, _partial_plan(
            configs.get_smoke("qwen3_4b")))
        out["cnn_single"] = _cnn_run(None)
    torch.save(out, f"{out_dir}/rank{rank}.pt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_serve")
    tmp.start_processes(_rank, args=(str(d / "rendezvous"), str(d)),
                        nprocs=WORLD, join=True, start_method="spawn")
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def test_meshes_over_the_world(ranks):
    for r, out in enumerate(ranks):
        assert out["coords"] == ({"data": 1, "model": 2},
                                 {"data": 2, "model": 1}, r, r)


@pytest.mark.parametrize("key", ["tp_gen_rows", "tp_gen_scalar",
                                 "tp_gen_flash", "tp_logits", "kv1_gen",
                                 "kv1_gen_flash"])
def test_tensor_parallel_generate_equals_one_process(ranks, key):
    want = ranks[0]["single"][key]
    for out in ranks:
        np.testing.assert_array_equal(out["lm12"][key], want)


def test_tensor_parallel_collectives(ranks):
    """One generate call's collectives on (1, 2): the Megatron pairs'
    amax MAX and int32 SUM, the embedding's SUM and the vocab gather of
    the tied head; nothing gathers a weight (no data axis)."""
    cfg = configs.get_smoke("qwen3_4b")
    counts = ranks[0]["lm12"]["tp_counts"]
    steps = 4                                   # prefill + 3 decode steps
    assert counts["acc_tp"][0] == counts["amax_tp"][0] \
        == 2 * cfg.n_layers * steps             # wo and wd a layer
    assert counts["embed"][0] == counts["constrain"][0] == steps
    assert "gather_weight" not in counts and "gather_cols" not in counts


@pytest.mark.parametrize("key", ["tp_cont", "kv1_cont"])
def test_tensor_parallel_continuous_equals_one_process(ranks, key):
    want = ranks[0]["single"][key]
    for out in ranks:
        assert out["lm12"][key]["tokens"] == want["tokens"]


@pytest.mark.parametrize("key", ["dp_cont", "partial_cont", "spec_auto",
                                 "spec_fsdp", "pc"])
def test_data_mesh_continuous_equals_one_process(ranks, key):
    want = ranks[0]["single"][key]
    for out in ranks:
        got = out["lm21"][key]
        assert got["tokens"] == want["tokens"]
        assert got["hits"] == want["hits"] and got["spec"] == want["spec"]


@pytest.mark.parametrize("key", ["dp_gen_rows", "dp_gen_scalar"])
def test_data_mesh_generate_equals_one_process(ranks, key):
    want = ranks[0]["single"][key]
    for out in ranks:
        np.testing.assert_array_equal(out["lm21"][key], want)


def test_placement_and_records(ranks):
    for out in ranks:
        lm21 = out["lm21"]
        assert lm21["dp_sharded"]                 # FSDP weights, no plan
        assert lm21["dp_cont"]["replicas"] == [0.0] * len(PROMPTS)
        summary, mean, sharded = lm21["partial_plan"]
        assert not summary["fully_replicated"] and sharded
        assert lm21["partial_cont"]["replicas"] == [mean] * len(PROMPTS)
        assert ranks[0]["single"]["partial_cont"]["replicas"] == \
            [mean] * len(PROMPTS)
        assert lm21["spec_auto"]["spec"] == ranks[0]["single"][
            "spec_auto"]["spec"] and max(lm21["spec_auto"]["spec"]) > 0


def test_prefix_cache_hits_cross_ranks(ranks):
    got = ranks[0]["lm21"]
    want = ranks[0]["single"]
    saved = "prefill_edp_saved_js"          # priced under the plan: its
    assert {k: v for k, v in got["pc_ledger"].items() if k != saved} == \
        {k: v for k, v in want["pc_ledger"].items() if k != saved}
    # latency amortized over the plan's 2 replicas, energy unchanged
    assert got["pc_ledger"][saved] == pytest.approx(
        want["pc_ledger"][saved] / 2, rel=1e-12)
    assert {"full", "partial"} <= set(got["pc"]["hits"])
    # a hit whose slot another rank owns than the entry's holder: the
    # first two prompts landed on slots 0 and 1 (rank 0), and their hits
    # on slots 2 and 3 (rank 1)
    assert got["pc_slots"][:2] == [0, 1] and 2 in got["pc_slots"][2:4]
    assert got["pc_counts"]["move_row"][0] > 0     # rows did cross


@pytest.mark.parametrize("key", ["cnn12", "cnn21"])
def test_cnn_on_both_meshes_equals_one_process(ranks, key):
    for out in ranks:
        np.testing.assert_array_equal(out[key], ranks[0]["cnn_single"])
    counts = ranks[0]["cnn12_counts"]
    assert counts["gather_cols"][0] > 0


def test_sharded_linears_equal_whole(ranks):
    """int4 and int8 containers, column- and row-parallel, on both meshes:
    EQUAL to the whole linear at static, tensor and per-row bits."""
    for out in ranks:
        assert len(out["pieces"]["linears"]) == 8
        assert all(out["pieces"]["linears"].values()), \
            out["pieces"]["linears"]


def test_constrain_shard_map_and_copy_row(ranks):
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    for r, out in enumerate(ranks):
        loc, back, same = out["pieces"]["constrain"]
        np.testing.assert_array_equal(loc, x[..., 2 * r:2 * r + 2])
        np.testing.assert_array_equal(back, x)
        np.testing.assert_array_equal(same, x)       # manual mode
        np.testing.assert_array_equal(out["pieces"]["shard_map"], x)
    # slot 0 (rank 0) copied into slot 3 (rank 1) and slot 2 into slot 1
    p0, p1 = (out["pieces"]["pool"] for out in ranks)
    np.testing.assert_array_equal(p1["kpos"][:, 1, :3],
                                  np.broadcast_to([10 * 0 + i for i in
                                                   range(3)], (2, 3)))
    np.testing.assert_array_equal(p0["kpos"][:, 1, :3],
                                  np.broadcast_to([20 + i for i in
                                                   range(3)], (2, 3)))
    assert float(p1["k"][0, 1, 0, 0, 0]) == 1.0
    assert float(p0["k"][0, 1, 0, 0, 0]) == 3.0
    assert ranks[0]["pieces"]["pool_counts"]["move_row"][0] == 2 * 3

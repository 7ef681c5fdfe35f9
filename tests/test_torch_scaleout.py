"""Row scale-out on a data mesh: two gloo ranks on the CPU against the
port's single-process engines.

One module-scoped spawn of two ranks (``torch.multiprocessing``, a file
rendezvous under ``tmp_path``) serves, on a ``DataMesh`` with
``plan="auto"`` (fully replicated, dp = 2):

* the qwen3_4b SMOKE continuous engine with the reference placement
  test's prompts and budgets (4 slots, so 2 rows a rank), greedy and at
  temperature 0.8: every request's tokens EQUAL the single-process
  engine's (a sampled stream too: each rank draws the whole batch's
  noise and takes its rows);
* ResNet18 at 32 px, ``max_batch=4``: logits EQUAL; and a batch of 3
  (``max_batch=3``), which does not split over two data ranks, so every
  rank computes every image: logits EQUAL too.

Rank 0 also runs the single-process engines (no mesh) after the mesh
runs, so both sides run under the same thread settings.  Each rank
writes its results to a file that the tests read.
"""
import datetime

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as tdist  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core import policy as pol  # noqa: E402
from repro_torch.dist import DataMesh  # noqa: E402
from repro_torch.models import cnn, lm  # noqa: E402
from repro_torch.models.transformer import EMPTY_POS  # noqa: E402
from repro_torch.serve.cnn import CNNServeEngine  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

WORLD = 2
PROMPTS = ([3, 1, 4, 1, 5], [2, 7, 1], [6, 2, 8, 1, 8, 2], [9, 9])
BUDGETS = (10.0, 0.5, 10.0, 0.5)                # int8 / int4 mix
TEMPS = (0.0, 0.8)                              # greedy, sampled
CNN_IMAGE, CNN_BATCH = 32, 4


def _lm_run(mesh, temp):
    cfg = configs.get_smoke("qwen3_4b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(4),
                            device="cpu")
    n = lm.n_bit_slots(cfg)
    ctrl = pol.BudgetController({"int4": pol.fixed(4), "int8": pol.fixed(8)},
                                {"int4": 1.0, "int8": 2.0}, n)
    eng = ServeEngine(cfg, lm.quantize_params(params, cfg), max_len=64,
                      controller=ctrl, n_slots=4, prefill_len=8,
                      decode_block=4, seed=0, device="cpu", mesh=mesh,
                      plan="auto" if mesh is not None else None)
    rids = [eng.submit(p, max_new_tokens=5, budget_s=b, temperature=temp)
            for p, b in zip(PROMPTS, BUDGETS)]
    eng.run()
    recs = [eng.requests[r] for r in rids]
    return {"tokens": [r.tokens for r in recs],
            "slots": [r.slot for r in recs],
            "latency": [r.ap_latency_s for r in recs],
            "energy": [r.ap_energy_j for r in recs],
            "replicas": [r.plan_replicas for r in recs],
            "plan": None if eng.plan is None else eng.plan.summary(),
            "rows": eng._rows, "pool_rows": eng.pool.cache["kpos"].shape[1],
            "drained": bool((eng.pool.cache["kpos"] == EMPTY_POS).all())
            and eng.pool.free_slots == 4,
            "prefills": eng.calls["prefill"]}


def _cnn_run(mesh, batch=CNN_BATCH):
    gen = torch.Generator().manual_seed(2)
    params, layers = cnn.init_cnn("resnet18", gen, image=CNN_IMAGE,
                                  device="cpu")
    images = torch.randn((CNN_BATCH, CNN_IMAGE, CNN_IMAGE, 3),
                         generator=gen)[:batch]
    ctrl = pol.cnn_budget_controller("resnet18", layers=layers)
    preds = [ctrl.predicted_latency_s[k] for k in ctrl.order()]
    budgets = [0.0, preds[1] * 1.01, preds[3] * 1.01, 1e30][:batch]
    eng = CNNServeEngine(params, layers, controller=ctrl,
                         max_batch=batch, device="cpu", mesh=mesh,
                         plan="auto" if mesh is not None else None)
    logits, stats = eng.serve(images, budgets)
    return {"logits": logits, "wbits": [s.wbits for s in stats],
            "latency": [s.ap_latency_s for s in stats],
            "energy": [s.ap_energy_j for s in stats],
            "replicas": [s.plan_replicas for s in stats],
            "names": None if eng.plan is None else eng.plan.names,
            "full": None if eng.plan is None else eng.plan.fully_replicated,
            "rows": eng._rows}


def _rank(rank, init_file, out_dir):
    torch.set_num_threads(1)
    tdist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = DataMesh()
        out = {("lm", t): _lm_run(mesh, t) for t in TEMPS}
        out["cnn"] = _cnn_run(mesh)
        out["cnn3"] = _cnn_run(mesh, 3)
    finally:
        tdist.destroy_process_group()
    if rank == 0:                       # the single-process engines
        out.update({("lm_single", t): _lm_run(None, t) for t in TEMPS})
        out["cnn_single"] = _cnn_run(None)
        out["cnn3_single"] = _cnn_run(None, 3)
    torch.save(out, f"{out_dir}/rank{rank}.pt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("scaleout")
    tmp.start_processes(_rank, args=(str(d / "rendezvous"), str(d)),
                        nprocs=WORLD, join=True, start_method="spawn")
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.mark.parametrize("temp", TEMPS)
def test_lm_row_split_equals_one_process(ranks, temp):
    single = ranks[0][("lm_single", temp)]
    for r, out in enumerate(ranks):
        got = out[("lm", temp)]
        assert got["tokens"] == single["tokens"]
        assert got["slots"] == single["slots"]
        assert got["rows"] == (2 * r, 2 * r + 2)
        assert got["pool_rows"] == 2            # each rank holds its rows
        assert got["drained"] and single["drained"]
        assert got["plan"]["fully_replicated"] and got["plan"]["dp"] == 2
        assert got["replicas"] == [2.0] * len(PROMPTS)
        assert single["replicas"] == [0.0] * len(PROMPTS)
        for a, b in zip(got["latency"], single["latency"]):
            assert a == pytest.approx(b / 2, rel=1e-12)
        assert got["energy"] == single["energy"]
    # the slot owners prefilled: each rank ran its own slots' rows
    assert sum(out[("lm", temp)]["prefills"] for out in ranks) \
        == single["prefills"] == len(PROMPTS)
    if temp > 0:                        # the sampled streams are sampled
        greedy = ranks[0][("lm_single", 0.0)]["tokens"]
        assert single["tokens"] != greedy


def test_ranks_hold_identical_records(ranks):
    for key in [("lm", t) for t in TEMPS]:
        a, b = ranks[0][key], ranks[1][key]
        assert {k: v for k, v in a.items() if k not in ("rows", "prefills")} \
            == {k: v for k, v in b.items() if k not in ("rows", "prefills")}
    a, b = ranks[0]["cnn"], ranks[1]["cnn"]
    np.testing.assert_array_equal(a["logits"], b["logits"])
    assert a["wbits"] == b["wbits"] and a["latency"] == b["latency"]


def test_cnn_row_split_equals_one_process(ranks):
    single = ranks[0]["cnn_single"]
    for r, out in enumerate(ranks):
        got = out["cnn"]
        np.testing.assert_array_equal(got["logits"], single["logits"])
        assert got["rows"] == (2 * r, 2 * r + 2)
        assert got["full"] and len(got["names"]) == 21
        assert got["wbits"] == single["wbits"]
        assert len(set(got["wbits"])) == 4      # the budgets span configs
        for a, b in zip(got["latency"], single["latency"]):
            assert a == pytest.approx(b / 2, rel=1e-12)
        assert got["energy"] == single["energy"]
        assert got["replicas"] == [2.0] * CNN_BATCH


def test_cnn_batch_that_does_not_split_equals_one_process(ranks):
    """3 images on two data ranks: no split, every rank computes every
    image, logits EQUAL one process's."""
    single = ranks[0]["cnn3_single"]
    for out in ranks:
        got = out["cnn3"]
        assert got["rows"] is None
        np.testing.assert_array_equal(got["logits"], single["logits"])
        assert got["wbits"] == single["wbits"]


def test_cache_pool_holds_only_its_rows():
    """A rank's pool part: slots 2..3 of 4.  Bookkeeping covers every
    slot; installs, resets and rollbacks touch only the owned rows."""
    cfg = configs.get_smoke("qwen3_4b")
    whole = lm.CachePool(cfg, 4, 16, device="cpu")
    part = lm.CachePool(cfg, 4, 16, device="cpu", rows=(2, 4))
    assert part.cache["kpos"].shape[1] == 2
    assert [part.owns(s) for s in range(4)] == [False, False, True, True]
    row = lm.empty_cache(cfg, 1, 16, device="cpu")
    row["kpos"][:, 0, :5] = torch.arange(5, dtype=row["kpos"].dtype)
    for pool in (whole, part):
        for s in range(4):
            assert pool.alloc() == s
            pool.write_row(row if pool.owns(s) else None, s, 5)
        np.testing.assert_array_equal(pool.lengths, [5] * 4)
        pool.rollback(torch.tensor([9, 9, 2, 9]))
        pool.free(3)
    torch.testing.assert_close(part.cache["kpos"],
                               whole.cache["kpos"][:, 2:], rtol=0, atol=0)
    assert part.free_slots == whole.free_slots == 1
    with pytest.raises(NotImplementedError, match="across ranks"):
        part.copy_row(0, 2)
    with pytest.raises(ValueError, match="rows"):
        lm.CachePool(cfg, 4, 16, device="cpu", rows=(3, 5))


def test_cnn_mesh_without_a_full_plan_raises():
    class FakeMesh:
        shape, axis_names, rank = {"data": 2}, ("data",), 0

    gen = torch.Generator().manual_seed(2)
    params, layers = cnn.init_cnn("resnet18", gen, image=CNN_IMAGE,
                                  device="cpu")
    with pytest.raises(NotImplementedError, match="without a placement"):
        CNNServeEngine(params, layers, max_batch=4, device="cpu",
                       mesh=FakeMesh())
    # a batch that does not split over the data ranks is served whole
    # on every rank (no collective needed: the plan replicates every
    # weight), as the reference replicates a dim its mesh does not divide
    eng = CNNServeEngine(params, layers, max_batch=3, device="cpu",
                         mesh=FakeMesh(), plan="auto")
    assert eng.plan.fully_replicated and eng._rows is None
    eng = CNNServeEngine(params, layers, max_batch=4, device="cpu",
                         mesh=FakeMesh(), plan="auto")
    assert eng.plan.fully_replicated and eng._rows == (0, 2)

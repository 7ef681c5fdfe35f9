"""Continuous batching on a sequence-sharded slot pool: 3 slots on a
``(2, 1)`` gloo mesh, against the single-process engine.

Three slots do not split over two data ranks, so every rank holds and
computes every slot, and ``CachePool`` takes the sequence-sharded layout
(each data rank its slice of every slot's ring, ``kpos`` whole), as the
reference's pool does (``dist.sharding._kv_cache_spec``).  One spawn of
two CPU ranks (``torch.multiprocessing``, a file rendezvous under
``tmp_path``) serves qwen3_4b SMOKE through ``ServeEngine(n_slots=3,
mesh=)`` with FSDP weights, once on the bf16 and once on the int8 KV
cache: five requests at two budgets, two of them speculative
(``draft_k=4``: the draft steps and the U=9 verify chunk run on the
sharded pool), a prefix cache that gets one full and one partial hit
(the cached rows are whole; each install keeps this rank's slice, and a
partial hit extends its row whole), and one request arriving late
(``submit_at``).  Rank 0 then serves the same requests on one device.

* Every request's tokens, cache-hit kind and slot are EQUAL to one
  device's (the partial softmaxes combine over the data axis in another
  f32 order, which could turn a near-tie; these requests have none).
* The pool after the run is EQUAL to one device's, block by block.
* Both ranks hold the same tokens and the same host state.
"""
import datetime

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as tdist  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve.engine import ServeEngine, default_controller  # noqa: E402
from repro_torch.serve.prefix_cache import PrefixCache  # noqa: E402

WORLD = 2
KV_BITS = (0, 8)
N_SLOTS, PREFILL, MAX_LEN, NEW = 3, 16, 32, 4


def _prompts(cfg):
    g = np.random.default_rng(11)
    V = cfg.vocab_size
    a = g.integers(0, V, 12)
    return {"a": a, "b": g.integers(0, V, 7), "full": a.copy(),
            "partial": np.concatenate([a[:8], g.integers(0, V, 5)]),
            "late": g.integers(0, V, 10)}


def _serve(cfg, q, mesh):
    eng = ServeEngine(cfg, q, max_len=MAX_LEN, n_slots=N_SLOTS,
                      prefill_len=PREFILL, decode_block=2,
                      controller=default_controller(lm.n_bit_slots(cfg)),
                      prefix_cache=PrefixCache(chunk=4, capacity=4),
                      device="cpu", mesh=mesh)
    p = _prompts(cfg)
    rids = {"a": eng.submit(p["a"], max_new_tokens=NEW, budget_s=1.0),
            "b": eng.submit(p["b"], max_new_tokens=NEW, budget_s=0.5,
                            draft_k=4),
            "full": eng.submit(p["full"], max_new_tokens=NEW, budget_s=1.0),
            "partial": eng.submit(p["partial"], max_new_tokens=NEW,
                                  budget_s=1.0, draft_k=4)}
    eng.submit_at(2, lambda: rids.__setitem__("late", eng.submit(
        p["late"], max_new_tokens=NEW, budget_s=0.5)))
    if mesh is not None:
        mesh.reset_counts()
    eng.run()
    recs = {k: eng.requests[r] for k, r in rids.items()}
    return {"tokens": {k: list(r.tokens) for k, r in recs.items()},
            "hits": {k: r.cache_hit for k, r in recs.items()},
            "slots": {k: r.slot for k, r in recs.items()},
            "spec_rounds": {k: r.spec_rounds for k, r in recs.items()},
            "pool": {k: v.clone() for k, v in eng.pool.cache.items()},
            "rows": eng._rows, "calls": dict(eng.calls),
            "counts": ({k: list(v) for k, v in mesh.counts.items()}
                       if mesh is not None else {})}


def _rank(rank, init_file, out_dir, params):
    torch.set_num_threads(1)
    tdist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    out = {}
    try:
        mesh = make_host_mesh(model=1)
        for kv in KV_BITS:
            out[kv] = _serve(_cfg(kv), params[kv], mesh)
    finally:
        tdist.destroy_process_group()
    if rank == 0:
        for kv in KV_BITS:
            out[("single", kv)] = _serve(_cfg(kv), params[kv], None)
    torch.save(out, f"{out_dir}/rank{rank}.pt")


def _cfg(kv):
    cfg = configs.get_smoke("qwen3_4b")
    return cfg.with_(kv_cache_bits=8) if kv else cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("seq_pool")
    params = {kv: lm.quantize_params(lm.init_params(
        _cfg(kv), torch.Generator().manual_seed(4), device="cpu"), _cfg(kv))
        for kv in KV_BITS}
    tmp.start_processes(_rank, args=(str(d / "rendezvous"), str(d), params),
                        nprocs=WORLD, join=True, start_method="spawn")
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.mark.parametrize("kv", KV_BITS)
def test_streams_equal_one_device(runs, kv):
    one = runs[0][("single", kv)]
    for out in runs:
        got = out[kv]
        assert got["rows"] is None
        assert got["tokens"] == one["tokens"]
        assert got["hits"] == one["hits"]
        assert got["slots"] == one["slots"]
        assert got["spec_rounds"] == one["spec_rounds"]
        assert got["calls"] == one["calls"]
    assert one["hits"] == {"a": "", "b": "", "full": "full",
                           "partial": "partial", "late": ""}
    assert one["spec_rounds"]["b"] > 0 and one["spec_rounds"]["partial"] > 0
    assert all(len(t) == NEW for t in one["tokens"].values())
    assert one["calls"]["verify"] > 0 and one["calls"]["extend"] > 0


@pytest.mark.parametrize("kv", KV_BITS)
def test_pool_equals_one_device_blocks(runs, kv):
    whole = runs[0][("single", kv)]["pool"]
    Sc = whole["kpos"].shape[-1]
    n = Sc // WORLD
    for r, out in enumerate(runs):
        got = out[kv]["pool"]
        assert tf.seq_sharded(got) and set(got) == set(whole)
        assert torch.equal(got["kpos"], whole["kpos"])
        for name in set(whole) - {"kpos"}:
            assert got[name].shape[1:3] == (N_SLOTS, n), name
            assert torch.equal(got[name],
                               whole[name][:, :, r * n:(r + 1) * n]), name
    if kv:
        assert whole["k"].dtype == torch.int8 and "ks" in whole


@pytest.mark.parametrize("kv", KV_BITS)
def test_ranks_combine_over_the_data_axis(runs, kv):
    """Every decode call on the pool combines over the data axis (a MAX
    and two SUMs a layer, one more MAX on the int8 cache), and both
    ranks made the same collectives."""
    c0, c1 = runs[0][kv]["counts"], runs[1][kv]["counts"]
    assert c0 == c1
    calls = runs[0][kv]["calls"]
    L = configs.get_smoke("qwen3_4b").n_layers
    pool_calls = calls["decode"] + calls["draft"] + calls["verify"]
    assert c0["seq_max"][0] == c0["seq_sum"][0] == c0["seq_pv"][0] \
        == L * pool_calls
    assert c0.get("seq_pmax", [0])[0] == (L * pool_calls if kv else 0)

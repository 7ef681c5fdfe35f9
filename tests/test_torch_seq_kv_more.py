"""The sequence-sharded KV cache's other branches on a ``(2, 1)`` gloo
mesh: the int8 cache, chunked decode and ragged prefill.

One spawn of two CPU ranks (``torch.multiprocessing``, a file rendezvous
under ``tmp_path``) runs qwen3_4b SMOKE and starcoder2_15b SMOKE
(sliding window 8: its 8-slot ring wraps, and a ragged row of 12 or 9
tokens keeps its own last 8) on the bf16 and the int8 cache, each
through one program: a B=1 ``lm.prefill``, two ``lm.decode_step``s, one
U=3 ``lm.decode_chunk`` (the speculative verify), then a B=3 ragged
``lm.prefill`` of lengths (5, 12, 9).  Neither B splits over two data
ranks, so every cache shards its sequence (``kpos`` whole).  Rank 0 then
runs the same program on one device, and qwen3_4b's chunk again as three
sequential decode steps.  The weights are the reference's, drawn by JAX
and bridged, so the reference's ``lm.prefill`` / ``decode_step`` /
``decode_chunk`` run op by op (a process an arch, beside the ranks) give
the third side.

* Each cache after a prefill (the int8 values and scales too, and the
  ragged rows' per-row shift on the wrapped ring) is EQUAL to one
  device's, block by block; prefill logits are EQUAL (every rank
  computes the rows whole).
* Decode and chunk logits combine the ranks' partial softmaxes (a MAX,
  a SUM of the denominators, on the int8 cache a MAX of the
  probabilities' amax, then a SUM of P.V); only f32 sums reorder, so
  they are within LOGIT_TOL x max|logit| of one device's, of the
  reference's and (qwen3_4b, whose ring does not wrap) of sequential
  steps, which one device's chunk EQUALS at the per-row bits (``(B, L)``
  bit matrices, as the engine serves) that every call here takes.
* Each rank's ``Mesh.counts`` EQUAL a ``RecordingMesh``'s for the same
  program: one MAX and two SUMs a layer and a decode call (one more MAX
  on the int8 cache), whatever U is.
"""
import datetime
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as tdist  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402

from repro_torch import configs, dist  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

WORLD = 2
ARCHS = ("qwen3_4b", "starcoder2_15b")
KV_BITS = (0, 8)
PROMPT, STEPS, U = 12, 2, 3
LENS = (5, 12, 9)
MAX_LEN = 32
LOGIT_TOL = 2e-2      # x max|logit|: f32 sums in another order, one
#                       bf16 probability or int8 step apart
RUNS = [(a, b) for a in ARCHS for b in KV_BITS]
IDS = [f"{a}-kv{b}" for a, b in RUNS]


def _cfg(arch, kv_bits):
    cfg = configs.get_smoke(arch)
    return cfg.with_(kv_cache_bits=8) if kv_bits else cfg


def _inputs(cfg):
    g = np.random.default_rng(7)
    V = cfg.vocab_size
    return {"prompt": g.integers(0, V, (1, PROMPT)).astype(np.int32),
            "steps": g.integers(0, V, (STEPS,)).astype(np.int32),
            "chunk": g.integers(0, V, (1, U)).astype(np.int32),
            "ragged": g.integers(0, V, (len(LENS), max(LENS))
                                 ).astype(np.int32)}


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


def _program(cfg, q, mesh, sequential=False):
    """The module docstring's program on ``mesh`` (None: one device);
    ``sequential`` runs the chunk as U decode steps instead."""
    inp = _inputs(cfg)
    bits = torch.full((1, lm.n_bit_slots(cfg)), 8, dtype=torch.int32)
    bits3 = bits.expand(len(LENS), -1)
    out = {}
    ctx = dist.use_mesh(mesh) if mesh is not None else None
    if ctx is not None:
        ctx.__enter__()
    try:
        cache = lm.empty_cache(cfg, 1, MAX_LEN, device="cpu", mesh=mesh)
        logits, cache = lm.prefill(q, {"tokens": torch.from_numpy(
            inp["prompt"])}, cfg, bits, bits, cache)
        out["cache"] = _clone(cache)
        steps = [logits[:, -1].clone()]
        for i, tok in enumerate(inp["steps"]):
            logits, cache = lm.decode_step(
                q, torch.tensor([[tok]], dtype=torch.int32), PROMPT + i,
                cache, cfg, bits, bits)
            steps.append(logits[:, -1].clone())
        out["steps"] = torch.cat(steps).float().numpy()
        t0 = PROMPT + STEPS
        if sequential:
            chunk = []
            for i in range(U):
                logits, cache = lm.decode_step(
                    q, torch.from_numpy(inp["chunk"][:, i:i + 1]), t0 + i,
                    cache, cfg, bits, bits)
                chunk.append(logits)
            out["chunk"] = torch.cat(chunk, dim=1).float().numpy()
            return out
        logits, cache = lm.decode_chunk(q, torch.from_numpy(inp["chunk"]),
                                        t0, cache, cfg, bits, bits)
        out["chunk"] = logits.float().numpy()
        out["after_chunk"] = _clone(cache)
        rcache = lm.empty_cache(cfg, len(LENS), MAX_LEN, device="cpu",
                                mesh=mesh)
        logits, rcache = lm.prefill(
            q, {"tokens": torch.from_numpy(inp["ragged"])}, cfg, bits3,
            bits3, rcache, lengths=torch.tensor(LENS, dtype=torch.int32))
        out["ragged"] = logits.float().numpy()
        out["ragged_cache"] = _clone(rcache)
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)
    return out


def _rank(rank, init_file, out_dir, params):
    torch.set_num_threads(1)
    tdist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    out = {}
    try:
        mesh = make_host_mesh(model=1)
        for arch, kv in RUNS:
            q = dist.shard_params(params[arch], mesh)
            mesh.reset_counts()
            out[(arch, kv)] = _program(_cfg(arch, kv), q, mesh)
            out[(arch, kv)]["counts"] = {k: list(v) for k, v in
                                         mesh.counts.items()}
    finally:
        tdist.destroy_process_group()
    if rank == 0:
        for arch, kv in RUNS:
            cfg = _cfg(arch, kv)
            out[("single", arch, kv)] = _program(cfg, params[arch], None)
            if arch == "qwen3_4b":
                out[("sequential", kv)] = _program(cfg, params[arch], None,
                                                   sequential=True)
            # the same program's collectives on a recording mesh (its
            # collectives return no values: only the counts are read)
            rec = dist.RecordingMesh((WORLD, 1))
            _program(cfg, dist.shard_params(params[arch], rec), rec)
            out[("recorded", arch, kv)] = {k: list(v) for k, v in
                                           rec.counts.items()}
    torch.save(out, f"{out_dir}/rank{rank}.pt")


def _bridged(arch):
    """(reference qparams, port qparams) from one JAX draw."""
    import jax
    from repro import configs as jconfigs
    from repro.models import lm as jlm
    from repro_torch.models.convert import from_numpy_params

    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(5))
    tp = from_numpy_params(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jlm.quantize_params(jp, jcfg), lm.quantize_params(tp, cfg)


def _reference(arch, kv, jq):
    """The reference's program op by op: (step logits, chunk logits,
    ragged logits)."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import lm as jlm

    jcfg = jconfigs.get_smoke(arch)
    if kv:
        jcfg = jcfg.with_(kv_cache_bits=8)
    inp = _inputs(jcfg)
    bits = jnp.full((1, jlm.n_bit_slots(jcfg)), 8, jnp.int32)
    bits3 = jnp.broadcast_to(bits, (len(LENS), bits.shape[1]))
    with jax.disable_jit():
        cache = jlm.empty_cache(jcfg, 1, MAX_LEN)
        logits, cache = jlm.prefill(jq, {"tokens": jnp.asarray(
            inp["prompt"])}, jcfg, bits, bits, cache)
        steps = [np.asarray(logits[:, -1], np.float32)]
        for i, tok in enumerate(inp["steps"]):
            logits, cache = jlm.decode_step(
                jq, jnp.asarray([[tok]], jnp.int32), jnp.int32(PROMPT + i),
                cache, jcfg, bits, bits)
            steps.append(np.asarray(logits[:, -1], np.float32))
        chunk, _ = jlm.decode_chunk(jq, jnp.asarray(inp["chunk"]),
                                    jnp.int32(PROMPT + STEPS), cache, jcfg,
                                    bits, bits)
        rcache = jlm.empty_cache(jcfg, len(LENS), MAX_LEN)
        ragged, _ = jlm.prefill(jq, {"tokens": jnp.asarray(inp["ragged"])},
                                jcfg, bits3, bits3, rcache,
                                lengths=jnp.asarray(LENS, jnp.int32))
    return (np.concatenate(steps), np.asarray(chunk, np.float32),
            np.asarray(ragged, np.float32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("seq_kv_more")
    # the reference op by op, one process an arch, beside the ranks
    pool = ProcessPoolExecutor(len(ARCHS),
                               mp_context=tmp.get_context("spawn"))
    with pool:
        futs = {arch: pool.submit(_reference_arch, arch) for arch in ARCHS}
        params = {arch: _bridged(arch)[1] for arch in ARCHS}
        ctx = tmp.start_processes(_rank, args=(str(d / "rendezvous"),
                                               str(d), params),
                                  nprocs=WORLD, join=False,
                                  start_method="spawn")
        while not ctx.join():
            pass
        refs = {(a, kv): r for a, f in futs.items()
                for kv, r in f.result().items()}
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return {"ranks": ranks, "refs": refs}


def _reference_arch(arch):
    """Both caches' reference programs for ``arch`` in a process of its
    own (the two archs run side by side): the reference's weights drawn
    again from the same key."""
    jq = _bridged(arch)[0]
    return {kv: _reference(arch, kv, jq) for kv in KV_BITS}


def _ref(runs, arch, kv):
    return runs["refs"][(arch, kv)]


def _blocks_equal(got, whole, r):
    """A rank's sequence-sharded cache is its block of one device's:
    k/v (and ks/vs) the slice ``[r n, (r + 1) n)``, kpos whole."""
    Sc = whole["kpos"].shape[-1]
    n = Sc // WORLD
    assert set(got) == set(whole)
    assert torch.equal(got["kpos"], whole["kpos"])
    for name in set(whole) - {"kpos"}:
        assert got[name].shape[2] == n, name
        assert got[name].dtype == whole[name].dtype
        assert torch.equal(got[name], whole[name][:, :, r * n:(r + 1) * n]), \
            name


def _close(got, want, vocab):
    got, want = got[..., :vocab], want[..., :vocab]
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()


@pytest.mark.parametrize("arch,kv", RUNS, ids=IDS)
def test_cache_after_prefill_equals_one_device_blocks(runs, arch, kv):
    single = runs["ranks"][0][("single", arch, kv)]
    for r, out in enumerate(runs["ranks"]):
        _blocks_equal(out[(arch, kv)]["cache"], single["cache"], r)
        _blocks_equal(out[(arch, kv)]["ragged_cache"],
                      single["ragged_cache"], r)
    if kv:
        assert single["cache"]["k"].dtype == torch.int8
        assert "ks" in single["cache"]


@pytest.mark.parametrize("arch,kv", RUNS, ids=IDS)
def test_decode_and_chunk_within_tolerance(runs, arch, kv):
    """Prefill logits EQUAL; decode steps and the U=3 chunk within
    LOGIT_TOL of one device's and of the reference's; every rank holds
    the same logits."""
    single = runs["ranks"][0][("single", arch, kv)]
    ref_steps, ref_chunk, _ = _ref(runs, arch, kv)
    V = configs.get_smoke(arch).vocab_size
    for out in runs["ranks"]:
        got = out[(arch, kv)]
        np.testing.assert_array_equal(got["steps"][0], single["steps"][0])
        _close(got["steps"], single["steps"], V)
        _close(got["steps"], ref_steps, V)
        _close(got["chunk"], single["chunk"], V)
        _close(got["chunk"], ref_chunk, V)
        np.testing.assert_array_equal(
            got["chunk"], runs["ranks"][0][(arch, kv)]["chunk"])
    assert single["chunk"].shape[:2] == (1, U)


@pytest.mark.parametrize("kv", KV_BITS)
def test_chunk_equals_sequential_steps(runs, kv):
    """On a ring that does not wrap (qwen3_4b), at per-row bits, one
    device's chunk gives U sequential one-device steps' logits EXACTLY;
    each rank's is within LOGIT_TOL of them, its kpos EQUAL."""
    seq = runs["ranks"][0][("sequential", kv)]
    V = configs.get_smoke("qwen3_4b").vocab_size
    np.testing.assert_array_equal(
        runs["ranks"][0][("single", "qwen3_4b", kv)]["chunk"], seq["chunk"])
    for out in runs["ranks"]:
        _close(out[("qwen3_4b", kv)]["chunk"], seq["chunk"], V)
        whole = runs["ranks"][0][("single", "qwen3_4b", kv)]["after_chunk"]
        assert torch.equal(out[("qwen3_4b", kv)]["after_chunk"]["kpos"],
                           whole["kpos"])


@pytest.mark.parametrize("arch,kv", RUNS, ids=IDS)
def test_ragged_prefill_equals_one_device(runs, arch, kv):
    """Ragged B=3 prefill: logits EQUAL one device's (attention runs on
    the whole k_new every rank computes) and within LOGIT_TOL of the
    reference's ``lm.prefill(lengths=)``."""
    single = runs["ranks"][0][("single", arch, kv)]
    _, _, ref = _ref(runs, arch, kv)
    V = configs.get_smoke(arch).vocab_size
    for out in runs["ranks"]:
        np.testing.assert_array_equal(out[(arch, kv)]["ragged"],
                                      single["ragged"])
    _close(single["ragged"], ref, V)
    if arch == "starcoder2_15b":       # rows past the 8-slot ring keep
        kpos = single["ragged_cache"]["kpos"][0]    # their last 8
        assert sorted(kpos[1].tolist()) == list(range(4, 12))
        assert sorted(kpos[2].tolist()) == list(range(1, 9))


@pytest.mark.parametrize("arch,kv", RUNS, ids=IDS)
def test_counts_equal_a_recording_mesh(runs, arch, kv):
    want = runs["ranks"][0][("recorded", arch, kv)]
    for out in runs["ranks"]:
        assert out[(arch, kv)]["counts"] == want
    L = configs.get_smoke(arch).n_layers
    calls = STEPS + 1                   # the decode steps and the chunk
    assert want["seq_max"][0] == want["seq_sum"][0] == want["seq_pv"][0] \
        == L * calls
    assert want.get("seq_pmax", [0])[0] == (L * calls if kv else 0)


def test_int8_cache_layout_on_a_recording_mesh():
    """A seq-sharded int8 layer cache keeps this rank's slots of the
    values and of the per-(token, head) scales, laid out by the cache's
    spec."""
    cfg = configs.get_smoke("qwen3_4b").with_(kv_cache_bits=8)
    mesh = dist.RecordingMesh((2, 1), rank=1)
    cache = lm.empty_cache(cfg, 1, 8, device="cpu", mesh=mesh)
    assert cache["k"].shape[2] == cache["ks"].shape[2] == 4
    assert cache["kpos"].shape[-1] == 8 and tf.seq_sharded(cache)

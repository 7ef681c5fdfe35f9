"""The sequence-sharded KV cache: a B=1 decode on a ``(2, 1)`` gloo mesh.

One B=1 row does not split over two data ranks, so the cache's sequence
does (``dist.sharding._kv_cache_spec``, as the reference shards it).
Two spawned CPU ranks (``torch.multiprocessing``, a file rendezvous
under ``tmp_path``) run qwen3_4b SMOKE and starcoder2_15b SMOKE (sliding
window 8, so the 8-slot ring wraps while it decodes) through
``lm.prefill`` and ``lm.decode_step`` on that cache, and qwen3_4b through
``ServeEngine.generate``; rank 0 then runs the same calls on one device.
The weights are the reference's, drawn by JAX and bridged, so the
reference's own ``lm.prefill`` / ``lm.decode_step`` (run op by op) give
the third side.

* The cache after prefill is EQUAL to one device's, block by block (each
  rank's k/v slice of the ring; ``kpos`` whole).
* A decode step combines the ranks' partial softmaxes by log-sum-exp (a
  MAX, a SUM of the denominators, a SUM of P.V over the data axis); only
  f32 sums run in another order, so its logits are within LOGIT_TOL x
  max|logit| of one device's and of the reference's (they came out
  EQUAL to one device's here), and greedy tokens agree but where the
  one-device top-2 gap is under that tolerance (a near-tie).
* Each rank's ``Mesh.counts`` EQUAL a ``RecordingMesh``'s for the same
  calls on fake tensors (``repro_torch.launch.dryrun``).
"""
import datetime

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
PROMPT = 12           # starcoder2's 8-slot ring keeps the last 8
STEPS = 6
MAX_LEN = 32
LOGIT_TOL = 2e-2      # x max|logit|: f32 sums in another order, one
#                       bf16 probability or int8 activation step apart


def _tokens(cfg, n, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, n)).astype(np.int32)


def _run(cfg, q, mesh):
    """Prefill a B=1 prompt, then STEPS decode steps of fixed tokens
    (so every side's step i sees the same history); returns the cache
    after prefill and each step's logits."""
    bits = torch.full((lm.n_bit_slots(cfg),), 8, dtype=torch.int32)
    toks = torch.from_numpy(_tokens(cfg, PROMPT, 1))
    ctx = dist.use_mesh(mesh) if mesh is not None else None
    if ctx is not None:
        ctx.__enter__()
    try:
        cache = lm.empty_cache(cfg, 1, MAX_LEN, device="cpu", mesh=mesh)
        logits, cache = lm.prefill(q, {"tokens": toks}, cfg, bits, bits,
                                   cache)
        after = {k: v.clone() for k, v in cache.items()}
        out = [logits[:, -1].clone()]
        for i, tok in enumerate(_tokens(cfg, STEPS, 3)[0]):
            logits, cache = lm.decode_step(
                q, torch.tensor([[tok]], dtype=torch.int32), PROMPT + i,
                cache, cfg, bits, bits)
            out.append(logits[:, -1].clone())
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)
    return {"cache": after, "logits": torch.cat(out).numpy()}


def _generate(cfg, q, mesh):
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(cfg, q, max_len=MAX_LEN, device="cpu", mesh=mesh)
    eng.set_budget(1e30)
    return eng.generate({"tokens": _tokens(cfg, PROMPT, 2)},
                        STEPS).numpy()


def _rank(rank, init_file, out_dir, params):
    torch.set_num_threads(1)
    tdist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    out = {}
    try:
        mesh = make_host_mesh(model=1)
        for arch in ARCHS:
            cfg = configs.get_smoke(arch)
            q = dist.shard_params(params[arch], mesh)
            mesh.reset_counts()
            out[arch] = _run(cfg, q, mesh)
            out[arch]["counts"] = {k: list(v) for k, v in
                                   mesh.counts.items()}
        cfg = configs.get_smoke("qwen3_4b")
        out["generate"] = _generate(cfg, params["qwen3_4b"], mesh)
    finally:
        tdist.destroy_process_group()
    if rank == 0:
        out["single"] = {arch: _run(configs.get_smoke(arch),
                                    params[arch], None) for arch in ARCHS}
        out["single_generate"] = _generate(configs.get_smoke("qwen3_4b"),
                                           params["qwen3_4b"], None)
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("seq_kv")
    pairs = {arch: _bridged(arch) for arch in ARCHS}
    params = {arch: p[1] for arch, p in pairs.items()}
    tmp.start_processes(_rank, args=(str(d / "rendezvous"), str(d), params),
                        nprocs=WORLD, join=True, start_method="spawn")
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return {"ranks": ranks, "ref": {a: p[0] for a, p in pairs.items()}}


def _reference_logits(arch, jq):
    """The reference's prefill and decode steps op by op, fed the same
    tokens."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import lm as jlm

    jcfg = jconfigs.get_smoke(arch)
    bits = jnp.full((jlm.n_bit_slots(jcfg),), 8, jnp.int32)
    with jax.disable_jit():
        cache = jlm.empty_cache(jcfg, 1, MAX_LEN)
        logits, cache = jlm.prefill(
            jq, {"tokens": jnp.asarray(_tokens(jcfg, PROMPT, 1))}, jcfg,
            bits, bits, cache)
        out = [np.asarray(logits[:, -1], np.float32)]
        for i, tok in enumerate(_tokens(jcfg, STEPS, 3)[0]):
            logits, cache = jlm.decode_step(
                jq, jnp.asarray([[tok]], jnp.int32), jnp.int32(PROMPT + i),
                cache, jcfg, bits, bits)
            out.append(np.asarray(logits[:, -1], np.float32))
    return np.concatenate(out)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_after_prefill_equals_one_device_blocks(runs, arch):
    single = runs["ranks"][0]["single"][arch]["cache"]
    Sc = single["kpos"].shape[-1]
    for r, out in enumerate(runs["ranks"]):
        got = out[arch]["cache"]
        n = Sc // WORLD
        assert got["k"].shape[2] == got["v"].shape[2] == n
        assert torch.equal(got["kpos"], single["kpos"])
        for name in ("k", "v"):
            assert torch.equal(got[name], single[name][:, :, r * n:(r + 1)
                                                       * n])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_logits_within_tolerance(runs, arch):
    """Prefill logits EQUAL (every rank computes the row whole); decode
    logits within LOGIT_TOL of one device's and of the reference's."""
    single = runs["ranks"][0]["single"][arch]["logits"]
    ref = _reference_logits(arch, runs["ref"][arch])
    V = configs.get_smoke(arch).vocab_size
    scale = np.abs(single[:, :V]).max()
    for out in runs["ranks"]:
        got = out[arch]["logits"]
        np.testing.assert_array_equal(got[0], single[0])
        assert np.abs(got - single).max() <= LOGIT_TOL * scale
        assert np.abs(got[:, :V] - ref[:, :V]).max() <= LOGIT_TOL * scale
        assert np.array_equal(got, runs["ranks"][0][arch]["logits"])


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_agree_apart_from_near_ties(runs, arch):
    """Each step's greedy token is one device's, except where one
    device's top-2 gap is under LOGIT_TOL x max|logit| (a near-tie, which
    a rounding difference may turn)."""
    single = runs["ranks"][0]["single"][arch]["logits"]
    V = configs.get_smoke(arch).vocab_size
    compared = 0
    for out in runs["ranks"]:
        got = out[arch]["logits"]
        for i in range(len(single)):
            top2 = np.sort(single[i, :V])[-2:]
            if top2[1] - top2[0] <= LOGIT_TOL * np.abs(single[i, :V]).max():
                continue
            assert got[i, :V].argmax() == single[i, :V].argmax(), i
            compared += 1
    assert compared >= 2


def test_generate_serves_b1_on_a_data_mesh(runs):
    want = runs["ranks"][0]["single_generate"]
    for out in runs["ranks"]:
        assert out["generate"].shape == (1, STEPS)
        assert np.array_equal(out["generate"], runs["ranks"][0]["generate"])
    # near-ties aside the tokens are one device's; these prompts have none
    assert np.array_equal(runs["ranks"][0]["generate"], want)


@pytest.mark.parametrize("arch", ARCHS)
def test_counts_equal_a_recording_mesh(runs, arch):
    """The collectives a rank made EQUAL what a RecordingMesh records for
    the same calls on fake tensors: per layer a MAX and two SUMs a
    decode step, and the FSDP weight gathers."""
    from repro_torch.launch import dryrun

    cfg = configs.get_smoke(arch)
    want = dryrun.predict_counts(cfg, (2, 1), batch=1, prompt=PROMPT,
                                 steps=STEPS, max_len=MAX_LEN)
    for out in runs["ranks"]:
        assert out[arch]["counts"] == want
    assert want["seq_max"][0] == want["seq_sum"][0] == want["seq_pv"][0] \
        == cfg.n_layers * STEPS


def test_int8_cache_is_not_served_sequence_sharded():
    """Restated since the int8 cache is served sequence-sharded: a
    prefill into a data rank's slice keeps the int8 values and the
    per-(token, head) scales of its slots, EQUAL to that block of one
    device's insert, with ``kpos`` whole (the decode, chunk and engine
    pool: ``tests/test_torch_seq_kv_more.py``,
    ``tests/test_torch_seq_pool.py``)."""
    cfg = configs.get_smoke("qwen3_4b").with_(kv_cache_bits=8)
    whole = {k: v[0] for k, v in tf.empty_cache(cfg, 1, 8,
                                                  device="cpu").items()}
    g = torch.Generator().manual_seed(0)
    k, v = (torch.randn(1, 8, 2, 16, generator=g) for _ in range(2))
    tf.prefill_cache_insert(whole, k, v, torch.arange(8)[None])
    for rank in range(2):
        part = {name: t.clone() for name, t in whole.items()}
        for name in ("k", "v", "ks", "vs"):
            part[name] = torch.zeros_like(whole[name][:, :4])
        part["kpos"].fill_(tf.EMPTY_POS)
        with dist.use_mesh(dist.RecordingMesh((2, 1), rank=rank)):
            tf.prefill_cache_insert(part, k, v, torch.arange(8)[None])
        assert torch.equal(part["kpos"], whole["kpos"])
        for name in ("k", "v", "ks", "vs"):
            assert torch.equal(part[name],
                               whole[name][:, 4 * rank:4 * rank + 4]), name

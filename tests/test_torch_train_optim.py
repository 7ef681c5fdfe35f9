"""AdamW, int8 compressed all-reduce and checkpoints on the CPU, port
against reference.

* ``adamw_update``: the same numpy gradients into both packages for m in
  f32, bf16 and int8 x v full and factored, three steps, each step from
  the reference's previous state carried across the weight bridge.  f32
  state leaves agree within ADAM_ULPS units in the last place of the
  leaf's largest magnitude (the two libraries' pow, sqrt, means and the
  global norm's sums round apart, and the moments' ``b1 m + (1 - b1) g``
  cancels, so an element's own ulp is no bound); bf16 leaves (parameters,
  bf16 m) within one bf16 step; the int8 codec's ``q`` is EQUAL except
  where ``|m/s|`` lies within TIE of a .5 tie, where it may be one step
  apart.  The clip and ``step`` are checked too.
* ``compress_psum``: two spawned gloo ranks against the reference under
  ``jax.vmap(..., axis_name=...)`` over the same two gradient sets, two
  rounds (the second with the error buffers of the first): the averaged
  gradients and the new error buffers are EQUAL.
* Checkpoints: a reference checkpoint of SMOKE parameters and int8 /
  factored optimizer state restores in the port bit for bit, and the
  reverse; an atomic overwrite, ``latest_step`` and a shape mismatch.
"""
import datetime
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as tdist  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compress as jcompress  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.dist import DataMesh  # noqa: E402
from repro_torch.models.convert import from_numpy_params  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim.compress import compress_psum  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402

ADAM_ULPS = 8
TIE = 1e-4
MODES = [(m, v) for m in ("float32", "bfloat16", "int8")
         for v in ("full", "factored")]
SHAPES = {"blk": {"w": (3, 8, 16), "b": (16,)}, "row": (1, 12),
          "col": (12, 1), "A_log": (4,)}


def _np(a):
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _tree(fn, shapes, path=""):
    if isinstance(shapes, dict):
        return {k: _tree(fn, v, f"{path}/{k}") for k, v in shapes.items()}
    return fn(path, shapes)


def _params(rng):
    """bf16 weights, an f32 leaf (as the Mamba A_log), shapes that factor
    and shapes that do not (a last or second-to-last axis of 1)."""
    def leaf(path, shape):
        a = rng.standard_normal(shape).astype(np.float32) * 0.1
        return a if path.endswith("A_log") else np.asarray(
            jnp.asarray(a, jnp.bfloat16))
    return _tree(leaf, SHAPES)


def _grads(rng, params, scale):
    return jax.tree_util.tree_map(
        lambda p: np.asarray(jnp.asarray(
            rng.standard_normal(p.shape) * scale, p.dtype)), params)


def _assert_state_close(got, want, where):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys(), where
    for k, wv in w.items():
        gv = g[k]
        wv = np.asarray(wv)
        if wv.dtype == np.int8:                       # codec q, step below
            continue
        if wv.dtype.name == "bfloat16":
            assert gv.dtype == torch.bfloat16, (where, k)
            step = np.spacing(np.abs(_np(wv))) * 2.0 ** 16
            assert (np.abs(_np(gv) - _np(wv)) <= step).all(), (where, k)
        elif wv.dtype == np.int32:
            assert gv.dtype == torch.int32 and int(gv) == int(wv), (where, k)
        else:
            assert gv.dtype == torch.float32, (where, k)
            bound = ADAM_ULPS * np.spacing(np.abs(wv).max())
            bad = np.abs(_np(gv) - wv) > bound
            assert not bad.any(), (where, k, np.argwhere(bad)[:3])


def _assert_codec_close(got_m, want_m, m_f, where):
    """q EQUAL but within TIE of a .5 tie of |m_f / s| (then one step);
    s within ADAM_ULPS."""
    for (k, gq), (_, wq) in zip(_leaves(got_m), _leaves(want_m)):
        if not k.endswith("/q"):
            continue
        s = np.asarray(dict(_leaves(want_m))[k[:-2] + "/s"])
        ratio = np.abs(m_f[k[:-2]] / s)
        near_tie = np.abs(ratio - np.floor(ratio) - 0.5) < TIE
        diff = np.abs(_np(gq).astype(np.int32) - np.asarray(wq, np.int32))
        assert (diff[~near_tie] == 0).all(), (where, k)
        assert (diff <= 1).all(), (where, k)


@pytest.mark.parametrize("m_dtype,v_mode", MODES)
def test_adamw_update_matches_reference(m_dtype, v_mode):
    rng = np.random.default_rng(0)
    params = _params(rng)
    jcfg = jadamw.AdamWConfig(lr=1e-2, m_dtype=m_dtype, v_mode=v_mode)
    tcfg = tadamw.AdamWConfig(lr=1e-2, m_dtype=m_dtype, v_mode=v_mode)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jadamw.adamw_init(jp, jcfg)
    tstate = tadamw.adamw_init(from_numpy_params(params, device="cpu"), tcfg)
    _assert_state_close(tstate, jstate, "init")
    for step, scale in enumerate((0.01, 3.0, 0.02), start=1):
        grads = _grads(rng, params, scale)
        with jax.disable_jit():
            jnew, jstate_new, jm = jadamw.adamw_update(
                jp, jax.tree_util.tree_map(jnp.asarray, grads), jstate, jcfg)
        # the port starts from the reference's state, across the bridge
        tp_ = from_numpy_params(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
        tstate = from_numpy_params(jax.tree_util.tree_map(np.asarray,
                                                          jstate),
                                   device="cpu")
        tnew, tstate_new, tm = tadamw.adamw_update(
            tp_, from_numpy_params(grads, device="cpu"), tstate, tcfg)
        where = f"step {step}"
        assert int(tstate_new["step"]) == step, where
        gn = float(jm["grad_norm"])
        assert abs(float(tm["grad_norm"]) - gn) <= ADAM_ULPS * np.spacing(
            np.float32(gn)), where
        clip = min(1.0, 1.0 / (gn + 1e-9))
        assert float(tm["clip"]) == pytest.approx(clip, rel=1e-6), where
        assert (float(jm["clip"]) < 1.0) == (scale == 3.0), where
        _assert_state_close(tnew, jnew, where)
        _assert_state_close(tstate_new, jstate_new, where)
        if m_dtype == "int8":
            m_f = _m_float(jstate, grads, float(jm["clip"]), jcfg)
            _assert_codec_close(tstate_new["m"], jstate_new["m"], m_f, where)
        jp, jstate = jnew, jstate_new


def _m_float(state, grads, clip, cfg):
    """The reference's pre-codec first moment, in float64."""
    out = {}
    for (k, g), (_, q), (_, s) in zip(
            _leaves(grads),
            [(p[:-2], v) for p, v in _leaves(state["m"]) if p.endswith("/q")],
            [(p[:-2], v) for p, v in _leaves(state["m"]) if p.endswith("/s")]):
        m = np.asarray(q, np.float64) * np.asarray(s, np.float64)
        out[k] = cfg.b1 * m + (1 - cfg.b1) * _np(g).astype(np.float64) * clip
    return out


def test_optimizer_state_crosses_the_weight_bridge():
    """A reference int8 / factored state (after one update) converts leaf
    for leaf: int8 codecs, f32 scales and factored moments, the int32
    step; the port's update then runs on it."""
    jcfg = jconfigs.get_smoke("qwen3_4b")
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    ocfg = jadamw.AdamWConfig(m_dtype="int8", v_mode="factored")
    grads = jax.tree_util.tree_map(lambda p: jnp.ones_like(p) * 0.01,
                                   jparams)
    _, state, _ = jax.jit(jadamw.adamw_update, static_argnums=3)(
        jparams, grads, jadamw.adamw_init(jparams, ocfg), ocfg)
    np_state = jax.tree_util.tree_map(np.asarray, state)
    t_state = from_numpy_params(np_state, device="cpu")
    src, dst = dict(_leaves(np_state)), dict(_leaves(t_state))
    assert src.keys() == dst.keys()
    kinds = set()
    for k, a in src.items():
        t = dst[k]
        kinds.add(str(t.dtype))
        assert tuple(t.shape) == a.shape, k
        np.testing.assert_array_equal(_np(t), _np(a))
    assert {"torch.int8", "torch.float32", "torch.int32"} <= kinds
    assert dst["/step"].dtype == torch.int32 and int(dst["/step"]) == 1
    assert "/v/layers/mlp/wg/w/vr" in dst and "/m/emb/q" in dst
    tparams = from_numpy_params(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    tcfg = tadamw.AdamWConfig(m_dtype="int8", v_mode="factored")
    _, nxt, _ = tadamw.adamw_update(
        tparams, tadamw.tree_map(lambda p: torch.full_like(p, 0.01), tparams),
        t_state, tcfg)
    assert int(nxt["step"]) == 2


def test_int8_factored_state_is_small():
    """The reference's test_int8_moment_state_is_small, on the port."""
    cfg = configs.get_smoke("qwen3_4b")
    from repro_torch.models import lm
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    full = tadamw.adamw_init(params, tadamw.AdamWConfig())
    small = tadamw.adamw_init(params, tadamw.AdamWConfig(
        m_dtype="int8", v_mode="factored"))

    def nbytes(t):
        return sum(x.numel() * x.element_size()
                   for x in tadamw.tree_leaves(t))

    assert nbytes(small["m"]) < 0.30 * nbytes(full["m"])
    assert nbytes(small["v"]) < 0.10 * nbytes(full["v"])


# ---------------------------------------------------------------------------
# compress_psum over two gloo ranks
# ---------------------------------------------------------------------------

WORLD = 2
CP_SHAPES = {"w": (6, 10), "b": (10,), "e": {"x": (3, 4, 5)}}


def _cp_grads(rank):
    rng = np.random.default_rng(100 + rank)

    def leaf(path, shape):
        a = rng.standard_normal(shape).astype(np.float32) * (1 + rank)
        return a if path == "/b" else np.asarray(jnp.asarray(a, jnp.bfloat16))
    return [_tree(leaf, CP_SHAPES) for _ in range(2)]       # two rounds


def _cp_rank(rank, init_file, out_dir):
    torch.set_num_threads(1)
    tdist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=60))
    try:
        rounds = _cp_grads(rank)
        err = tadamw.tree_map(
            lambda t: torch.zeros(t.shape, dtype=torch.float32),
            from_numpy_params(rounds[0], device="cpu"))
        out = []
        for i, g in enumerate(rounds):
            # round 0 over the default group, round 1 over a DataMesh
            group = None if i == 0 else DataMesh()
            avg, err = compress_psum(from_numpy_params(g, device="cpu"), err,
                                     group)
            out.append((avg, err))
    finally:
        tdist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def cp_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("compress")
    tmp.start_processes(_cp_rank, args=(str(d / "rendezvous"), str(d)),
                        nprocs=WORLD, join=True, start_method="spawn")
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def test_compress_psum_equals_reference(cp_ranks):
    per_rank = [_cp_grads(r) for r in range(WORLD)]
    stack = lambda *xs: jnp.stack([jnp.asarray(x) for x in xs])  # noqa: E731
    err = jax.tree_util.tree_map(
        lambda a: jnp.zeros((WORLD,) + a.shape, jnp.float32), per_rank[0][0])
    fn = jax.vmap(lambda g, e: jcompress.compress_psum(g, e, "data"),
                  axis_name="data")
    for i in range(2):
        g = jax.tree_util.tree_map(stack, *[r[i] for r in per_rank])
        avg, err = fn(g, err)
        for r in range(WORLD):
            got_avg, got_err = cp_ranks[r][i]
            for (k, a), (_, w) in zip(_leaves(got_avg), _leaves(avg)):
                w = np.asarray(w)[r]
                assert str(a.dtype).endswith(w.dtype.name), k
                np.testing.assert_array_equal(_np(a), _np(w), err_msg=k)
            for (k, a), (_, w) in zip(_leaves(got_err), _leaves(err)):
                np.testing.assert_array_equal(_np(a), np.asarray(w)[r],
                                              err_msg=k)
    # every rank holds the same average
    for (k, a), (_, b) in zip(_leaves(cp_ranks[0][1][0]),
                              _leaves(cp_ranks[1][1][0])):
        assert torch.equal(a, b), k


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt_tree():
    """SMOKE qwen3_4b parameters and an int8 / factored optimizer state
    after one update, as the reference makes them."""
    jcfg = jconfigs.get_smoke("qwen3_4b")
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    ocfg = jadamw.AdamWConfig(m_dtype="int8", v_mode="factored")
    grads = jax.tree_util.tree_map(
        lambda p: jax.random.normal(jax.random.PRNGKey(1), p.shape,
                                    p.dtype), jparams)
    new, opt, _ = jax.jit(jadamw.adamw_update, static_argnums=3)(
        jparams, grads, jadamw.adamw_init(jparams, ocfg), ocfg)
    return {"params": new, "opt": opt}


def test_reference_checkpoint_restores_in_port(ckpt_tree, tmp_path):
    d = str(tmp_path / "ref")
    jckpt.save_checkpoint(d, 7, ckpt_tree, extra={"who": "reference"})
    target = from_numpy_params(jax.tree_util.tree_map(np.asarray,
                                                      ckpt_tree),
                               device="cpu")
    target = tadamw.tree_map(torch.zeros_like, target)
    got, step = tckpt.restore_checkpoint(d, target, device="cpu")
    assert step == 7
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, ckpt_tree)))
    seen = set()
    for k, t in _leaves(got):
        w = want[k]
        assert tuple(t.shape) == w.shape, k
        seen.add(str(t.dtype))
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy(), w.view(np.int16), err_msg=k)
        else:
            np.testing.assert_array_equal(t.numpy(), w, err_msg=k)
    assert {"torch.bfloat16", "torch.int8", "torch.float32",
            "torch.int32"} <= seen


def test_port_checkpoint_restores_in_reference(ckpt_tree, tmp_path):
    d = str(tmp_path / "port")
    src = from_numpy_params(jax.tree_util.tree_map(np.asarray, ckpt_tree),
                            device="cpu")
    path = tckpt.save_checkpoint(d, 3, src)
    assert path.endswith("step_00000003") and tckpt.latest_step(d) == 3
    target = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), ckpt_tree)
    got, step = jckpt.restore_checkpoint(d, target)
    assert step == 3
    for (k, a), (_, b) in zip(_leaves(jax.tree_util.tree_map(np.asarray,
                                                             got)),
                              _leaves(jax.tree_util.tree_map(np.asarray,
                                                             ckpt_tree))):
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                      b.reshape(-1).view(np.uint8),
                                      err_msg=k)


def test_checkpoint_overwrite_latest_and_mismatch(tmp_path):
    d = str(tmp_path / "ckpt")
    assert tckpt.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(d, {"x": torch.zeros(4)}, device="cpu")
    tckpt.save_checkpoint(d, 1, {"x": torch.ones(4)})
    tckpt.save_checkpoint(d, 2, {"x": torch.ones(4) * 2})
    tckpt.save_checkpoint(d, 2, {"x": torch.ones(4) * 3})      # overwrite
    got, s = tckpt.restore_checkpoint(d, {"x": torch.zeros(4)}, device="cpu")
    assert s == 2 and float(got["x"][0]) == 3.0
    got, s = tckpt.restore_checkpoint(d, {"x": torch.zeros(4)}, device="cpu",
                                      step=1)
    assert s == 1 and float(got["x"][0]) == 1.0
    assert tckpt.latest_step(d) == 2
    assert not [p for p in os.listdir(d) if p.startswith(".tmp_")]
    with pytest.raises(ValueError, match="shape mismatch for x"):
        tckpt.restore_checkpoint(d, {"x": torch.zeros(5)}, device="cpu")
    # a meta target gives shapes and dtypes only; the dtype is the target's
    got, _ = tckpt.restore_checkpoint(
        d, {"x": torch.empty(4, dtype=torch.bfloat16, device="meta")},
        device="cpu")
    assert got["x"].dtype == torch.bfloat16 and got["x"].device.type == "cpu"

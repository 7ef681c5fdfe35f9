"""The recurrent and encoder-decoder families served on gloo meshes: two
CPU ranks against the port's single-process engine.  Every check is
EQUAL (tokens, logits, shapes, counts); there is no tolerance.

One module-scoped spawn of two ranks (``torch.multiprocessing``, a file
rendezvous under ``tmp_path``) builds a ``(1, 2)`` ``("data", "model")``
mesh (tensor parallelism) and a ``(2, 1)`` one (FSDP weights, rows split
over the data ranks) and serves SMOKE configs through
``ServeEngine(mesh=).generate`` on both:

* mamba2_1_3b at per-request ``(B, L)`` budgets (the SSD on each model
  rank's heads, ``y`` gathered before the gated RMSNorm);
* zamba2_2_7b at two whole-batch budgets with every LoRA ``b`` drawn
  NON-ZERO, so a dropped or misaligned delta shows (``b = 0``, as
  ``lora_init`` draws it, hides both), and past a lowered flash
  threshold (the shared block on local heads through the flash path),
  and in its train form (each LoRA base ``W + A @ B``, laid out again);
* seamless_m4t_medium with its frames split with the rows, past a
  lowered flash threshold too (encoder, decoder and cross-attention);
* B=1 rows of mamba2, zamba2 and seamless on ``(2, 1)``: the Mamba
  state whole on both data ranks, the shared block's KV ring
  sequence-sharded, and the encdec cross cache's frames split over the
  data ranks (each keeps 2 of the 4 frames; a decode step's
  cross-attention combines the ranks' partial softmaxes, in another
  f32 order than one device's sum: its tokens came out EQUAL).

The prefill's last logits are EQUAL too, every cache leaf's local shape
is ``dist.local_shape`` of its spec, and each rank's ``Mesh.counts`` of
a ``generate`` EQUAL the lowering report's prediction
(``dryrun.predict_counts``).  The weights and inputs are drawn as
``tests/test_torch_mamba2.py``, ``test_torch_hybrid.py`` and
``test_torch_encdec.py`` draw them (the reference's ``PRNGKey(0)``
weights bridged), where the one-process port is held against the
reference on the same inputs.  Rank 0 runs the single-process engines
after the mesh runs, so both sides run under the same thread settings.
"""
import datetime
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as tdist  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.dist import api as dapi  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve.engine import ServeEngine, default_controller  # noqa: E402

WORLD = 2
MAX_LEN = 32
MESHES = ((1, 2), (2, 1))
# (case, arch, budgets, new tokens, flash threshold or None, rows)
CASES = (("mamba2", "mamba2_1_3b", [0.4, 10.0], 5, None, 2),
         ("zamba2", "zamba2_2_7b", 0.4, 4, None, 2),
         ("zamba2_flash", "zamba2_2_7b", 10.0, 4, 4, 2),
         ("seamless", "seamless_m4t_medium", 0.8, 4, None, 2),
         ("seamless_flash", "seamless_m4t_medium", 0.8, 4, 3, 2),
         ("mamba2_b1", "mamba2_1_3b", [0.4], 5, None, 1),
         ("zamba2_b1", "zamba2_2_7b", 10.0, 4, None, 1),
         ("seamless_b1", "seamless_m4t_medium", 0.8, 4, None, 1),
         ("zamba2_train", "zamba2_2_7b", 10.0, 3, None, 2))
RUNS = [(c, m) for c in CASES for m in MESHES
        if c[5] == 2 or m == (2, 1)]
IDS = [f"{c[0]}-{m[0]}x{m[1]}" for c, m in RUNS]
# the report prices the serve form at whole-batch bits and the default
# flash threshold
PRICED = [(c, m) for c, m in RUNS if c[4] is None and np.ndim(c[2]) == 0
          and not c[0].endswith("_train")]


def _inputs(cfg, rows):
    """The family test's inputs, the first ``rows`` rows."""
    if cfg.family == "ssm":
        toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 19))
        batch = {"tokens": toks}
    elif cfg.family == "hybrid":
        toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 18))
        batch = {"tokens": toks}
    else:
        g = np.random.default_rng(3)
        batch = {"tokens": g.integers(0, cfg.vocab_size, (2, 16)),
                 "frames": g.normal(size=(2, 4, cfg.d_model))}
    return {k: torch.from_numpy(np.asarray(v[:rows], np.float32
                                           if k == "frames" else np.int32))
            for k, v in batch.items()}


def _serve(cfg, q, mesh, case):
    """generate, the prefill's last logits and its cache's leaf shapes,
    and the mesh's collective counts of the generate."""
    _, _, budgets, new, flash, rows = case
    batch = _inputs(cfg, rows)
    eng = ServeEngine(cfg, q, max_len=MAX_LEN, device="cpu", mesh=mesh,
                      controller=default_controller(lm.n_bit_slots(cfg)))
    eng.set_budget(budgets)
    prev = tf.FLASH_THRESHOLD
    if flash:
        tf.FLASH_THRESHOLD = flash
    try:
        if mesh is not None:
            mesh.reset_counts()
        toks = eng.generate(batch, new).numpy()
        counts = ({k: list(v) for k, v in mesh.counts.items()}
                  if mesh is not None else {})
        B = batch["tokens"].shape[0]
        split = eng._row_split(B, "rows")
        sl = slice(*split) if split else slice(None)
        with eng.compute_ctx():
            wv, av = eng._bits()
            if wv.ndim == 2:
                wv, av = wv[sl], av[sl]
            cache = lm.empty_cache(cfg, B, MAX_LEN, device="cpu", mesh=mesh)
            with kops.split_rows(mesh if split else None):
                logits, cache = lm.prefill(
                    eng.qparams, {k: v[sl] for k, v in batch.items()}, cfg,
                    wv, av, cache)
        if split:
            logits = mesh.gather_rows(logits)
    finally:
        tf.FLASH_THRESHOLD = prev
    shapes = {"/".join(map(str, p)): tuple(t.shape)
              for p, t in shd.tree_paths(cache)}
    return {"tokens": toks, "logits": logits.numpy(), "shapes": shapes,
            "counts": counts, "sharded": shd.is_sharded(eng.qparams)}


def _rank(rank, init_file, out_dir, params):
    torch.set_num_threads(1)
    tdist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    out = {}
    try:
        meshes = {(1, 2): make_host_mesh(model=2),
                  (2, 1): make_host_mesh(model=1)}
        for case, shape in RUNS:
            cfg = configs.get_smoke(case[1])
            out[(case[0], shape)] = _serve(cfg, _params(params, case),
                                           meshes[shape], case)
    finally:
        tdist.destroy_process_group()
    if rank == 0:
        for case in CASES:
            cfg = configs.get_smoke(case[1])
            out[(case[0], None)] = _serve(cfg, _params(params, case), None,
                                          case)
    torch.save(out, f"{out_dir}/rank{rank}.pt")


def _params(params, case):
    """A case's weights: the serve form, or for ``*_train`` the train
    form (a train-form LoRA base takes ``W + A @ B`` on a mesh too)."""
    return params[case[1] + ("/train" if case[0].endswith("_train")
                             else "")]


def _bridged(arch, b_seed=None, train=False):
    """The port's serve form (``train``: the train form) of the
    reference's PRNGKey(0) weights, as the family tests draw them;
    ``b_seed`` draws every LoRA ``b``."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import lm as jlm
    from repro_torch.models.convert import from_numpy_params

    jparams = jlm.init_params(jconfigs.get_smoke(arch),
                              jax.random.PRNGKey(0))
    if b_seed is not None:
        g = np.random.default_rng(b_seed)
        lora = jparams["layers"]["lora"]
        for name in lora:
            b = lora[name]["b"]
            lora[name]["b"] = jnp.asarray(g.normal(size=b.shape) * 0.5,
                                          jnp.bfloat16)
    tparams = from_numpy_params(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    if train:
        return tparams
    return lm.quantize_params(tparams, configs.get_smoke(arch))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("recurrent_mesh")
    params = {"mamba2_1_3b": _bridged("mamba2_1_3b"),
              "zamba2_2_7b": _bridged("zamba2_2_7b", b_seed=3),
              "zamba2_2_7b/train": _bridged("zamba2_2_7b", b_seed=3,
                                            train=True),
              "seamless_m4t_medium": _bridged("seamless_m4t_medium")}
    assert float(params["zamba2_2_7b"]["layers"]["lora"]["wo"]["b"]
                 .float().abs().max()) > 0
    tmp.start_processes(_rank, args=(str(d / "rendezvous"), str(d), params),
                        nprocs=WORLD, join=True, start_method="spawn")
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _case(name):
    return next(c for c in CASES if c[0] == name)


@pytest.mark.parametrize("case,shape", RUNS, ids=IDS)
def test_tokens_and_logits_equal_one_device(runs, case, shape):
    one = runs[0][(case[0], None)]
    for out in runs:
        got = out[(case[0], shape)]
        np.testing.assert_array_equal(got["tokens"], one["tokens"])
        np.testing.assert_array_equal(got["logits"], one["logits"])
        assert got["sharded"]
    assert one["tokens"].shape == (case[5], case[3])


@pytest.mark.parametrize("case,shape", RUNS, ids=IDS)
def test_cache_leaves_are_their_specs_blocks(runs, case, shape):
    """Each leaf of a rank's prefilled cache has the local shape of its
    spec (``cache_shardings`` of the one-device cache's shapes)."""
    mesh = types.SimpleNamespace(shape=dict(zip(("data", "model"), shape)),
                                 axis_names=("data", "model"))
    whole = runs[0][(case[0], None)]["shapes"]
    tree = {}
    for path, s in whole.items():
        node = tree
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = torch.empty(s, device="meta")
    specs = dict((("/".join(map(str, p)), spec) for p, spec in
                  shd.tree_paths(shd.cache_shardings(tree, mesh))))
    for out in runs:
        got = out[(case[0], shape)]["shapes"]
        assert set(got) == set(whole)
        for path, s in whole.items():
            assert got[path] == dapi.local_shape(mesh, specs[path], s), path


@pytest.mark.parametrize("case,shape", PRICED,
                         ids=[f"{c[0]}-{m[0]}x{m[1]}" for c, m in PRICED])
def test_mesh_counts_equal_the_lowering_report(runs, case, shape):
    name, arch, _, new, _, rows = case
    cfg = configs.get_smoke(arch)
    inp = _inputs(cfg, rows)
    want = dryrun.predict_counts(
        cfg, shape, batch=rows, prompt=inp["tokens"].shape[1],
        steps=new - 1, max_len=MAX_LEN, reuse=True,
        frames=inp["frames"].shape[1] if "frames" in inp else 0)
    assert want
    if rows % shape[0] == 0 and shape[0] > 1:
        # generate gathers its rows' tokens (int32) once at the end
        want["gather_rows"] = [1, rows // shape[0] * new * 4]
    for out in runs:
        assert out[(name, shape)]["counts"] == want


def test_b1_layouts(runs):
    """A B=1 row on (2, 1): mamba2's state whole on both data ranks,
    zamba2's shared-attention ring sequence-sharded (fewer k/v slots
    than kpos positions), its Mamba state whole."""
    for out in runs:
        m = out[("mamba2_b1", (2, 1))]["shapes"]
        cfg = configs.get_smoke("mamba2_1_3b")
        assert m["ssm"][1:3] == (1, cfg.expand * cfg.d_model
                                 // cfg.ssm_head_dim)
        z = out[("zamba2_b1", (2, 1))]["shapes"]
        assert z["kv/k"][2] * WORLD == z["kv/kpos"][2] == MAX_LEN
        assert z["ssm"][1] == 1


def test_an_encdec_b1_row_on_a_data_mesh_raises():
    """Restated since the frame-split cross cache is served: one encdec
    row does not split over two data ranks, so the cache's spec shards
    the cross K/V's frames (each rank its half, an ``encdec.FrameSlice``
    that a decode step reads as a slice); two rows split instead and
    keep their frames whole; on one device nothing is a slice."""
    from repro_torch.models import encdec

    cfg = configs.get_smoke("seamless_m4t_medium")
    mesh = dapi.RecordingMesh((2, 1))
    F = MAX_LEN // cfg.frames_ratio
    cache = lm.empty_cache(cfg, 1, MAX_LEN, device="cpu", mesh=mesh)
    assert isinstance(cache["cross"], encdec.FrameSlice)
    assert cache["cross"]["k"].shape[1:3] == (1, F // 2)
    cache = lm.empty_cache(cfg, 2, MAX_LEN, device="cpu", mesh=mesh)
    assert cache["cross"]["k"].shape[1:3] == (1, F)
    assert not isinstance(cache["cross"], encdec.FrameSlice)
    assert encdec.frames_split(cfg, mesh, 1, F)
    assert not encdec.frames_split(cfg, mesh, 2, F)
    assert not encdec.frames_split(cfg, None, 1, F)


def test_b1_frames_split_on_the_data_mesh(runs):
    """seamless at B=1 on (2, 1): each rank's prefilled cross cache holds
    2 of the 4 frames, and a decode step made one MAX and two SUMs a
    decoder layer for its cross-attention and as many for its
    self-attention (the B=1 ring is sequence-sharded too)."""
    cfg = configs.get_smoke("seamless_m4t_medium")
    case = _case("seamless_b1")
    for out in runs:
        got = out[("seamless_b1", (2, 1))]
        assert got["shapes"]["cross/k"][2] * WORLD == 4
        c = got["counts"]
        steps = case[3] - 1
        assert c["seq_max"][0] == c["seq_sum"][0] == c["seq_pv"][0] \
            == 2 * cfg.n_layers * steps

"""The port's sharding rules against the reference's, as pure specs.

Every check is EQUAL: on every leaf of all ten configs' FULL trees (the
reference's ``launch.specs.abstract_params``), ``param_pspec``,
``opt_pspec`` (the int8 and the factored codecs) and ``logical_to_mesh``
give the reference's specs on the reference tests' fake ``(16, 16)`` and
``(2, 16, 16)`` meshes; so do the cache specs (the long-context
sequence-over-dp case among them), ``bits_pspec`` and
``budgets_pspec``, and the plan override.  The port's own SMOKE
serve-form trees name their leaves as jax names the same trees' paths
(the key-path trap: a list index is ``"[i]"``, not ``"i"``).  The
divisibility warning fires once, an unknown axis raises, a mesh axis is
used once per spec, and ``constrain`` is the identity off-mesh and under
``manual_mode``.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.dist import api as japi  # noqa: E402
from repro.dist import placement as jpl  # noqa: E402
from repro.dist import sharding as jshd  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models.config import SHAPES  # noqa: E402
from repro.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.dist import api as tapi  # noqa: E402
from repro_torch.dist import placement as tpl  # noqa: E402
from repro_torch.dist import sharding as tshd  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402


class FakeMesh:
    def __init__(self, shape_map):
        self.shape = shape_map
        self.axis_names = tuple(shape_map)


MESHES = (FakeMesh({"data": 16, "model": 16}),
          FakeMesh({"pod": 2, "data": 16, "model": 16}))
ARCHS = jconfigs.ARCH_IDS


def _port_path(path):
    """A jax key path as the port walks it: dict keys, int indices."""
    return tuple(getattr(p, "key", getattr(p, "idx", p)) for p in path)


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.fixture(scope="module")
def trees():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return {a: jspecs.abstract_params(jconfigs.get(a)) for a in ARCHS}


def _same(mesh, logical_ref, logical_port, shape):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        ref = japi.logical_to_mesh(mesh, logical_ref, shape)
        got = tapi.logical_to_mesh(mesh, logical_port, shape)
    return tuple(got) == tuple(ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_on_every_leaf(trees, arch):
    leaves = _flat(trees[arch])
    assert leaves
    for path, leaf in leaves:
        ref = jshd.param_pspec(path, leaf)
        got = tshd.param_pspec(_port_path(path), leaf)
        assert got == ref, (path, got, ref)
        for mesh in MESHES:
            assert _same(mesh, ref, got, leaf.shape), (path, leaf.shape)


@pytest.mark.parametrize("codec", [("int8", "factored"),
                                   ("float32", "full")])
@pytest.mark.parametrize("arch", ["qwen3_4b", "kimi_k2_1t_a32b",
                                  "zamba2_2_7b", "mamba2_1_3b"])
def test_opt_specs_equal_on_every_leaf(trees, arch, codec):
    ocfg = AdamWConfig(m_dtype=codec[0], v_mode=codec[1])
    opt = jax.eval_shape(lambda p: adamw_init(p, ocfg), trees[arch])
    for path, leaf in _flat(opt):
        ref = jshd.opt_pspec(path, leaf)
        got = tshd.opt_pspec(_port_path(path), leaf)
        assert got == ref, (path, got, ref)
        for mesh in MESHES:
            assert _same(mesh, ref, got, leaf.shape), (path, leaf.shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_serve_tree_key_paths_and_specs(arch):
    """The port's own SMOKE serve-form tree: its walk names every leaf as
    jax names the same tree's path, and every leaf's spec (plain and
    resolved) is the reference rule's on those keys."""
    cfg = tconfigs.get_smoke(arch)
    q = tlm.quantize_params(tlm.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"), cfg)
    shapes = jax.tree_util.tree_map(
        lambda t: jax.ShapeDtypeStruct(tuple(t.shape), np.float32), q)
    jax_keys = [tuple(str(getattr(p, "key", p)) for p in path)
                for path, _ in _flat(shapes)]
    port = list(tshd.tree_paths(q))
    assert sorted(tshd._keys(p) for p, _ in port) == sorted(jax_keys)
    for path, leaf in port:
        keys = tshd._keys(path)
        assert tshd.param_pspec(path, leaf) == jshd._logical_spec(
            keys, leaf.ndim)
    for mesh in MESHES:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            specs = dict((tshd._keys(p), s) for p, s in
                         tshd.tree_paths(tshd.param_shardings(q, mesh)))
        for path, leaf in port:
            keys = tshd._keys(path)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                ref = japi.logical_to_mesh(
                    mesh, jshd._logical_spec(keys, leaf.ndim),
                    tuple(leaf.shape))
            assert tuple(specs[keys]) == tuple(ref), keys


def test_list_index_keys():
    """A list index is named as a jax SequenceKey prints: "[i]"."""
    tree = {"a": [np.zeros(2), {"b": np.zeros((3, 4))}]}
    jax_keys = [tuple(str(getattr(p, "key", p)) for p in path)
                for path, _ in _flat(tree)]
    assert [tshd._keys(p) for p, _ in tshd.tree_paths(tree)] == jax_keys \
        == [("a", "[0]"), ("a", "[1]", "b")]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: s.name)
@pytest.mark.parametrize("arch", ["qwen3_4b", "qwen1_5_110b", "mamba2_1_3b",
                                  "zamba2_2_7b", "seamless_m4t_medium"])
def test_cache_specs_equal(arch, shape):
    cfg = jconfigs.get(arch)
    cache = jspecs.abstract_cache(cfg, shape)
    for mesh in MESHES:
        for path, leaf in _flat(cache):
            keys = tuple(str(getattr(p, "key", p)) for p in path)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                ref = jshd._cache_leaf_spec(mesh, keys, leaf)
                got = tshd._cache_leaf_spec(mesh, keys, leaf)
            assert tuple(got) == tuple(ref), (keys, leaf.shape)


def test_kv_cache_spec_long_context():
    mesh = MESHES[0]
    for shape in ((48, 1, 524288, 8, 128), (48, 128, 32768, 16, 128),
                  (24, 1, 524288, 1, 64), (24, 3, 1000, 2, 64)):
        assert tuple(tshd._kv_cache_spec(mesh, shape)) == tuple(
            jshd._kv_cache_spec(mesh, shape))
    assert tuple(tshd._kv_cache_spec(mesh, (48, 1, 524288, 8, 128))) == \
        (None, None, "data", None, "model")


@pytest.mark.parametrize("shape", [(32, 4), (30, 4), (4,), (32,), (30,),
                                   (8, 2, 3)])
def test_bits_and_budgets_specs_equal(shape):
    leaf = np.zeros(shape)
    assert tshd.bits_pspec(leaf) == jshd.bits_pspec(leaf)
    assert tshd.budgets_pspec(leaf) == jshd.budgets_pspec(leaf)
    assert tshd.batch_pspec(leaf) == jshd.batch_pspec(leaf)
    for mesh in MESHES:
        for fn in ("bits_pspec", "budgets_pspec", "batch_pspec"):
            spec = getattr(tshd, fn)(leaf)
            assert _same(mesh, spec, spec, shape)
    bits = np.zeros((4,), np.int32)
    assert tshd.shard_bits(bits) is bits and tshd.shard_budgets(bits) is bits


def test_plan_override_equal():
    """A plan that replicates the head entry but not the layer slots: the
    head and the embedding replicate, the layers keep the base rule."""
    kw = dict(n_devices=4, dp=4, replicas=(1, 2, 4),
              shares=(0.3, 0.3, 0.4), has_head=True)
    jplan, tplan = jpl.PlacementPlan(**kw), tpl.PlacementPlan(**kw)
    for keys, nd in ((("emb",), 2), (("head", "q"), 2),
                     (("layers", "attn", "wq", "q"), 3),
                     (("layers", "mlp", "wd", "q"), 3), (("ln_f", "scale"), 1),
                     (("layers", "mlp", "experts", "wg"), 4)):
        assert tshd._logical_spec(keys, nd, tplan) == jshd._logical_spec(
            keys, nd, jplan)
    assert tshd._logical_spec(("emb",), 2, tplan) == (None, None)
    assert tshd._logical_spec(("layers", "attn", "wq", "q"), 3, tplan) == \
        (None, "dp", "tp")


def test_logical_to_mesh_rules():
    mesh, mesh3 = MESHES
    cases = [(mesh, ("dp", "tp"), (100, 96)), (mesh, ("dp", "tp"), (128, 96)),
             (mesh3, ("dp", None), (64, 7)),
             (mesh3, ("dp+tp", None), (512, 7)), (mesh3, ("dp+tp",), (100,)),
             (mesh, ("tp", "tp"), (32, 32)), (mesh, ("dp", "dp"), (32, 32)),
             (mesh3, ("tp", "dp", None), (64, 64, 3))]
    for m, logical, shape in cases:
        assert _same(m, logical, logical, shape), (logical, shape)
    # a mesh axis is used once per spec: the second "tp" replicates
    assert tuple(tapi.logical_to_mesh(mesh, ("tp", "tp"), (32, 32))) == \
        ("model", None)
    assert tapi.logical_to_mesh(mesh3, ("dp", None), (64, 7)) == \
        tapi.P(("pod", "data"), None)
    with pytest.raises(ValueError, match="unknown logical axis"):
        tapi.logical_to_mesh(mesh, ("xp",), (16,))


def test_fallback_warns_once():
    mesh = FakeMesh({"data": 16, "model": 16})
    shape = (100, 96, 1)               # a shape no other test resolves
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        for _ in range(3):
            tapi.logical_to_mesh(mesh, ("dp", "tp", None), shape)
        tapi.logical_to_mesh(mesh, ("tp", None, "dp"), (96, 7, 1))
    msgs = [str(w.message) for w in got
            if issubclass(w.category, RuntimeWarning)]
    assert len(msgs) == 1 and "does not divide dim 100" in msgs[0]


def test_constrain_is_identity_off_mesh_and_in_manual_mode():
    x = torch.arange(12.0).reshape(3, 4)
    assert tapi.constrain(x, ("dp", "tp")) is x
    assert tapi.constrain_heads(x[None, None], 2, 3, True).shape == \
        (1, 1, 3, 4)

    class Mesh2:                        # no collectives: never called
        shape = {"data": 1, "model": 2}
        axis_names = ("data", "model")

    with tapi.use_mesh(Mesh2()):
        with tapi.manual_mode():
            assert tapi.in_manual_mode()
            assert tapi.constrain(x, ("dp", "tp")) is x
        assert not tapi.in_manual_mode()

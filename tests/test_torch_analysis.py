"""The port's analysis suite (``repro_torch.analysis``) on the CPU.

Every port rule is pinned twice: a fixture that MUST fire and a near
miss that must NOT.  Against the reference (``repro.analysis``, which
needs no jax for its lint, ledger and baseline parts): ND201, the numpy
and stdlib parts of RNG301, ``Baseline`` and ``qualname_index`` give the
same findings on the same sources; the ledger pass finds the same
written, consumed and waived fields, but for the two the port adds; the
sharding checker resolves every leaf of qwen3_4b and starcoder2_15b on
every fake mesh to the reference's spec.  The retrace auditor is held to
its own fixtures (RT501, RT502) and audits qwen3_4b SMOKE and the
HAWQ-V3 ResNet18 matrix single-signature; the port's own tree audits
clean through ``run_suite`` and the CLI.
"""
import ast
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import (ALL_PASSES, common,  # noqa: E402
                                  ledger, lint, registry, retrace,
                                  run_suite, sharding)
from repro_torch.launch import analyze, specs  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
KERNEL = "src/repro_torch/kernels/fixture.py"   # whole-module hot ("*")
ENGINE = "src/repro_torch/serve/engine.py"      # hot in registered scopes
PLAIN = "src/repro_torch/apsim/fixture.py"      # no hot scope


def _mod(src: str, relpath: str = KERNEL, cm=common) -> common.ParsedModule:
    src = textwrap.dedent(src)
    return cm.ParsedModule(relpath=relpath, source=src, tree=ast.parse(src),
                           lines=src.splitlines())


def _rules(src: str, relpath: str = KERNEL):
    return [f.rule for f in lint.lint_modules([_mod(src, relpath)])]


# ---------------------------------------------------------------------------
# Lint rules: a fixture that fires, a near miss that does not
# ---------------------------------------------------------------------------

LINT_CASES = [
    # (rule, relpath, firing source, near-miss source)
    ("HS101", KERNEL, """
        import torch
        def f():
            x = torch.zeros(3)
            return x.item()
     """, """
        import numpy as np
        def f():
            a = np.zeros(3)
            return a.item()
     """),
    ("HS102", KERNEL, """
        import torch
        def f(x):
            return float(torch.sum(x))
     """, """
        import numpy as np
        def f():
            return float(np.mean(np.arange(4)))
     """),
    ("HS102", KERNEL, """
        import torch
        def f(x):
            y = torch.exp(x)
            return y.numpy()
     """, """
        import torch
        def f(x):
            y = torch.exp(x)
            h = y.cpu().numpy()
            return float(h[0])
     """),
    ("HS102", ENGINE, """
        class ServeEngine:
            def _decode_tick(self):
                wv, av = self._batch_bits()
                return self.price_bits(wv, av)
     """, """
        class ServeEngine:
            def _decode_tick(self, budgets):
                wv, av = self.controller.resolve(budgets)
                return self.price_bits(wv, av)
     """),
    ("HS102", ENGINE, """
        class ServeEngine:
            def _step(self):
                wv, _ = self._batch_bits()
                return f"{wv}"
     """, """
        class ServeEngine:
            def build_tables(self):
                wv, _ = self._batch_bits()
                return f"{wv}"
     """),
    ("HS103", KERNEL, """
        import torch
        def f(x):
            if torch.any(x > 0):
                return 1
            return 0
     """, """
        import torch
        def f(x, flag):
            y = torch.exp(x)
            for t in (y, x):
                t.add_(1)
            if flag and y.shape[0] > 1 and len(y) > 1:
                return 1
            return 0
     """),
    ("ND201", PLAIN, """
        def f():
            return [k for k in {2, 1, 3}]
     """, """
        def f(vals):
            return [k for k in sorted({v for v in vals})]
     """),
    ("RNG301", PLAIN, """
        import numpy as np
        def f():
            return np.random.default_rng().normal()
     """, """
        import numpy as np
        def f(seed):
            return np.random.default_rng(seed).normal()
     """),
    ("RNG301", PLAIN, """
        import torch
        def f():
            return torch.rand(3)
     """, """
        import torch
        def f(seed):
            g = torch.Generator().manual_seed(seed)
            return torch.rand(3, generator=g)
     """),
    ("RNG301", PLAIN, """
        import torch
        def f():
            torch.manual_seed(0)
     """, """
        import torch
        def f():
            return torch.randperm(4, generator=torch.Generator())
     """),
    ("STAT401", KERNEL, """
        def f(ops, x_q, w_q, wbits):
            n = int(wbits)
            return ops.int8_accum(x_q, w_q, planes=n)
     """, """
        BIT_FAMILIES = (2, 4, 8)
        def f(ops, x_q, w_q, wbits):
            return [ops.int8_accum(x_q, w_q, planes=fam)
                    for fam in BIT_FAMILIES]
     """),
    ("STAT401", KERNEL, """
        import functools
        @functools.lru_cache(maxsize=None)
        def kernel_for(n):
            return n
        def f(wv):
            return kernel_for(wv[0].item())
     """, """
        import functools
        @functools.lru_cache(maxsize=None)
        def kernel_for(n):
            return n
        def f(x, wv):
            return kernel_for(x.shape[0])
     """),
    ("STAT401", KERNEL, """
        import torch
        def build(wv):
            def fwd(x):
                return x * wv
            return torch.compile(fwd)
     """, """
        import torch
        def build(bm):
            def fwd(x):
                return x * bm
            return torch.compile(fwd)
     """),
    ("STAT401", KERNEL, """
        def f(ops, x, q, s, wbits, abits):
            return ops.fluid_linear(x, q, s, wbits=round(float(wbits)))
     """, """
        def f(ops, x, q, s, wbits: int, abits: int = 8):
            return ops.fluid_linear(x, q, s, wbits=int(wbits))
     """),
]


@pytest.mark.parametrize("rule,relpath,fires,near", LINT_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(LINT_CASES)])
def test_rule_fires_and_near_miss_does_not(rule, relpath, fires, near):
    assert rule in _rules(fires, relpath)
    assert _rules(near, relpath) == []


def test_host_sync_rules_fire_only_in_hot_scopes():
    # the same sync in an unregistered method: setup-time syncs are fine
    src = """
    import torch
    class ServeEngine:
        def __init__(self):
            self.n = torch.zeros(3).sum().item()
    """
    assert _rules(src, ENGINE) == []
    assert registry.is_hot(ENGINE, "ServeEngine._decode_block")
    assert registry.is_hot("src/repro_torch/kernels/ops.py", "anything")
    assert not registry.is_hot(ENGINE, "ServeEngine.__init__")


# ---------------------------------------------------------------------------
# Against the reference: the framework-free parts
# ---------------------------------------------------------------------------

REF_SOURCE = """
import random
import numpy as np

class Pool:
    def fill(self, vals):
        out = []
        for k in {3, 1, 2}:
            out.append(k)
        keys = tuple(set(vals))
        rng = np.random.default_rng()
        np.random.shuffle(out)
        def inner():
            return random.choice(out)
        return [v for v in set(keys)], rng, inner

def seeded(seed):
    return np.random.default_rng(seed), sorted({1, 2})
"""


def test_nd201_rng301_and_qualnames_match_the_reference():
    from repro.analysis import common as jcommon
    from repro.analysis import lint as jlint

    path = "src/pkg/fixture.py"
    tmod = _mod(REF_SOURCE, path)
    jmod = _mod(REF_SOURCE, path, jcommon)
    for tcheck, jcheck in ((lint._check_set_order, jlint._check_set_order),
                           (lint._check_rng, jlint._check_rng)):
        got = [(f.rule, f.line, f.scope, f.message, f.snippet)
               for f in tcheck(tmod)]
        want = [(f.rule, f.line, f.scope, f.message, f.snippet)
                for f in jcheck(jmod)]
        assert got == want and got
    assert {f.rule for f in lint._check_set_order(tmod)} == {"ND201"}
    assert sorted(common.qualname_index(tmod.tree).values()) == \
        sorted(jcommon.qualname_index(jmod.tree).values())
    assert "Pool.fill.<locals>.inner" in \
        common.qualname_index(tmod.tree).values()


def test_baseline_suppresses_and_goes_stale_as_the_reference():
    from repro.analysis import common as jcommon

    entries = [{"rule": "HS102", "file": "src/x.py", "match": "float(y)",
                "why": "justified"},
               {"rule": "HS101", "file": "gone.py", "match": "x.item()",
                "why": "old"}]
    finding = dict(rule="HS102", file="src/x.py", line=3, scope="f",
                   message="sync", snippet="float(y)")
    out = []
    for cm in (common, jcommon):
        bl = cm.Baseline([dict(e) for e in entries])
        fresh, supp = cm.apply_baseline([cm.Finding(**finding)], bl)
        out.append((len(fresh), len(supp), bl.stale()))
    assert out[0] == out[1] == (0, 1, [entries[1]])
    for cm in (common, jcommon):
        with pytest.raises(ValueError):
            cm.Baseline([{"rule": "HS102", "file": "x.py", "match": "y"}])


def test_checked_in_baseline_is_small_and_justified():
    with open(common.BASELINE_PATH) as f:
        entries = json.load(f)["entries"]
    assert len(entries) <= 5
    assert all(e.get("why") for e in entries)
    assert common.repo_root() == str(ROOT)


def test_ledger_fields_match_the_reference():
    """The port's records carry two fields the reference's do not
    (``admitted_s`` and ``first_token_s``, its host clocks of an
    admission), each waived with its consumer; everything else is the
    reference's: the same fields written, the same 14 consumed by
    ``aggregate()``, the same waivers."""
    from repro.analysis import ledger as jledger
    from repro.analysis import registry as jregistry

    tf, tdet = ledger.run_ledger()
    jf, jdet = jledger.run_ledger()
    assert tf == [] and jf == []
    extra = {"admitted_s", "first_token_s"}
    assert tdet["written"] == jdet["written"] | extra
    assert tdet["fields"] == jdet["fields"] | extra
    assert tdet["consumed"] == jdet["consumed"] and len(tdet["consumed"]) == 14
    assert set(registry.LEDGER_WAIVED) == set(jregistry.LEDGER_WAIVED) | extra
    assert tdet["written"] <= tdet["consumed"] | set(registry.LEDGER_WAIVED)


FAKE_ACCT = """
import dataclasses

@dataclasses.dataclass
class CostRecord:
    rid: int
    used: float = 0.0
    orphan: float = 0.0
    base: float = 0.0

    @property
    def derived(self):
        return self.base * 2

def aggregate(records):
    return {"used": sum(r.used for r in records),
            "derived": sum(r.derived for r in records)}
"""

FAKE_SERVE = """
def admit(record, CostRecord):
    record.used = 1.0
    record.orphan = 2.0
    r = CostRecord(rid=0, base=3.0)
    return r
"""


def test_ledger_transitive_consumption_and_orphan():
    acct = _mod(FAKE_ACCT, ledger.ACCOUNTING)
    fields, members = ledger.record_schema(acct)
    assert fields == {"rid", "used", "orphan", "base"}
    assert ledger.consumed_fields(acct, fields, members) == {"used", "base"}
    writes = ledger.written_fields(
        [_mod(FAKE_SERVE, "src/repro_torch/serve/fake.py")], fields)
    assert set(writes) == {"used", "orphan", "rid", "base"}


def test_ledger_lg701_and_lg702_fire(tmp_path, monkeypatch):
    serve = tmp_path / "src" / "repro_torch" / "serve"
    serve.mkdir(parents=True)
    (serve / "accounting.py").write_text(textwrap.dedent(FAKE_ACCT))
    (serve / "engine.py").write_text(textwrap.dedent(FAKE_SERVE))
    monkeypatch.setattr(registry, "LEDGER_WAIVED",
                        {"rid": "identity", "gone": "code removed"})
    found, _ = ledger.run_ledger(str(tmp_path))
    assert sorted((f.rule, f.message.split("'")[1]) for f in found) == [
        ("LG701", "orphan"), ("LG702", "gone")]
    monkeypatch.setattr(registry, "LEDGER_WAIVED",
                        {"rid": "identity", "orphan": "read elsewhere"})
    assert ledger.run_ledger(str(tmp_path))[0] == []


# ---------------------------------------------------------------------------
# Sharding checker
# ---------------------------------------------------------------------------

def _reference_specs(name, meshes):
    """The reference checker's resolved spec of every leaf (its own
    jax.eval_shape trees and rules), keyed like the port's."""
    import jax
    from repro import configs as jconfigs
    from repro.analysis import sharding as jsh
    from repro.dist import api as jdapi
    from repro.dist import placement as jdpl
    from repro.dist import sharding as jdsh
    from repro.models import lm as jlm

    from repro.launch import specs as jsp
    from repro.models.config import ShapeConfig as JShape

    cfg = jconfigs.get(name)
    params, qparams, cache, bits, budgets, batch = jsh._abstract_state(cfg)
    cache_b1 = jsp.abstract_cache(cfg, JShape("audit_b1", sharding.CACHE_LEN,
                                              1, "decode"))
    gd = jlm.layer_gemm_dims(cfg)
    rep = [8] * len(gd)
    head = jlm.head_gemm_dims(cfg)
    plans = {"qparams+plan_full": jdpl.plan_placement(
                 gd, rep, rep, n_devices=8, head=head),
             "qparams+plan_partial": jdpl.plan_placement(
                 gd, rep, rep, n_devices=8, head=head, memory_budget=1.5)}

    class L:
        def __init__(self, shape):
            self.shape, self.ndim = tuple(shape), len(shape)

    def keyed(tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return [(jdsh._keys(p), tuple(leaf.shape)) for p, leaf in flat]

    out = {}
    for mesh in meshes:
        m = jsh.FakeMesh(mesh.axis_sizes)
        label = sharding.mesh_label(mesh)
        for tag, tree, plan in (("params", params, None),
                                ("qparams", qparams, None),
                                ("qparams+plan_full", qparams,
                                 plans["qparams+plan_full"]),
                                ("qparams+plan_partial", qparams,
                                 plans["qparams+plan_partial"])):
            for keys, shape in keyed(tree):
                spec = jdapi.logical_to_mesh(
                    m, jdsh._logical_spec(keys, len(shape), plan=plan), shape)
                out[(tag, ".".join(keys), label)] = tuple(spec)
        for keys, shape in keyed(cache):
            out[("cache", ".".join(keys), label)] = tuple(
                jdsh._cache_leaf_spec(m, keys, L(shape)))
        if mesh in sharding.dp_meshes(meshes):      # B=1 on the dp meshes
            for keys, shape in keyed(cache_b1):
                out[("cache_b1", ".".join(keys), label)] = tuple(
                    jdsh._cache_leaf_spec(m, keys, L(shape)))
        for tag, leaf, fn in (("bits", bits, jdsh.bits_pspec),
                              ("budgets", budgets, jdsh.budgets_pspec)):
            out[(tag, tag, label)] = tuple(jdapi.logical_to_mesh(
                m, fn(L(leaf.shape)), tuple(leaf.shape)))
        for keys, shape in keyed(batch):
            out[("batch", ".".join(keys), label)] = tuple(
                jdapi.logical_to_mesh(m, jdsh.batch_pspec(L(shape)), shape))
    return out


@pytest.mark.parametrize("name", ["qwen3_4b", "starcoder2_15b"])
def test_sharding_resolves_the_reference_specs(name):
    """Every leaf of the dense trees on every fake mesh resolves to the
    reference's spec.  The trees agree leaf for leaf here; they differ
    for the moe family (the port quantizes every expert stack to int8
    containers, the reference leaves them bf16), and the optimizer
    family is the port's own (the reference does not audit it)."""
    import warnings

    meshes = sharding.fake_meshes()
    got = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        found, stats = sharding.audit_config_sharding(name, meshes, got)
        want = _reference_specs(name, meshes)
    assert found == [], [f.render() for f in found]
    assert stats["sharded"] > 0
    ours = {k: v for k, v in got.items() if k[0] != "opt"}
    assert set(ours) == set(want)
    assert {k for k in ours if ours[k] != want[k]} == set()
    assert any(k[0] == "opt" for k in got)


def test_sharding_audits_the_b1_sequence_sharded_cache(monkeypatch):
    """Every config with a KV cache is audited at B=1 on the data meshes,
    where its k/v sequence goes on ``data``; a rule that stops doing so
    is SH603 on the 2x2 mesh."""
    from repro_torch.dist import sharding as dsh

    got = {}
    found, _ = sharding.audit_config_sharding(
        "starcoder2_15b", sharding.fake_meshes(), got)
    assert found == []
    b1 = {k: v for k, v in got.items() if k[0] == "cache_b1"}
    assert {k[2] for k in b1} == {sharding.mesh_label(m) for m in
                                  sharding.dp_meshes(sharding.fake_meshes())}
    assert b1[("cache_b1", "k", "data2")] == (None, None, "data", None, None)
    assert b1[("cache_b1", "kpos", "data2")] == (None, None, None)
    got = {}
    sharding.audit_config_sharding("mamba2_1_3b", sharding.fake_meshes(), got)
    assert not any(k[0] == "cache_b1" for k in got)   # no KV cache

    real = dsh._kv_cache_spec

    def rows_only(mesh, shape):
        spec = list(real(mesh, shape))
        spec[2] = None
        return dsh.P(*spec)

    monkeypatch.setattr(dsh, "_kv_cache_spec", rows_only)
    net = [sharding.FakeMesh((("data", 2), ("model", 2)))]
    found, _ = sharding.audit_config_sharding("qwen3_4b", net)
    assert [(f.rule, f.scope) for f in found] == [
        ("SH603", "qwen3_4b/cache_b1@data2xmodel2")]


def test_sharding_checks_catch_synthetic_violations():
    from repro_torch.dist.api import P

    mesh = sharding.FakeMesh((("data", 2), ("model", 2)))
    bad = sharding.check_resolved(P("model"), (5,), mesh, "w")
    assert [f.rule for f in bad] == ["SH601"]
    dup = sharding.check_resolved(P("data", "data"), (4, 4), mesh, "w")
    assert any("two dims" in f.message for f in dup)
    unk = sharding.check_resolved(P("pod"), (4,), mesh, "w")
    assert any("not in mesh" in f.message for f in unk)
    assert sharding.check_resolved(P("data", "model"), (4, 6), mesh,
                                   "w") == []
    assert sharding.dropped_axes(mesh, ("tp", "dp"), (5, 4)) == [
        (0, "tp", 2)]
    assert sharding.dropped_axes(mesh, ("tp", "dp"), (1, 4)) == []


def test_sharding_sh602_and_sh603_fire(monkeypatch):
    """A rule that asks a non-dividing dim for the model axis is SH602;
    rules that replicate everything are SH603."""
    from repro_torch.dist import sharding as dsh

    real = dsh._logical_spec

    def vocab_rows_on_tp(keys, nd, plan=None):
        if keys[-1] == "scale" and nd == 2:       # (L, d) norm scales
            return ("tp", None)
        return real(keys, nd, plan=plan)

    monkeypatch.setattr(dsh, "_logical_spec", vocab_rows_on_tp)
    mesh = [sharding.FakeMesh((("model", 8),))]
    found, _ = sharding.audit_config_sharding("qwen3_4b", mesh)
    assert found and {f.rule for f in found} == {"SH602"}
    assert all("36 % 8" in f.message for f in found)

    monkeypatch.setattr(dsh, "_logical_spec",
                        lambda keys, nd, plan=None: (None,) * nd)
    net = [sharding.FakeMesh((("data", 2), ("model", 2)))]
    found, _ = sharding.audit_config_sharding("qwen3_4b", net)
    assert sorted(f.message.split("sharded on ")[1].split(" ")[0]
                  for f in found if f.rule == "SH603") == ["'data'", "'model'"]
    assert all(f.scope.startswith("qwen3_4b/qparams@") for f in found
               if f.rule == "SH603")


def test_specs_build_the_1t_config_unallocated():
    from torch._subclasses.fake_tensor import FakeTensor
    from repro_torch import configs
    from repro_torch.dist.sharding import tree_paths
    from repro_torch.models.config import ShapeConfig

    cfg = configs.get("kimi_k2_1t_a32b")
    params = specs.abstract_params(cfg)
    opt = specs.abstract_opt(cfg, specs.optimizer_for(cfg))
    cache = specs.abstract_cache(cfg, ShapeConfig("d", 4096, 8, "decode"))
    leaves = [leaf for tree in (params, specs.abstract_qparams(cfg), opt,
                                cache)
              for _, leaf in tree_paths(tree)]
    assert all(isinstance(leaf, FakeTensor) for leaf in leaves)
    n = sum(leaf.numel() for _, leaf in tree_paths(params))
    assert 1.0e12 < n < 1.1e12
    assert specs.optimizer_for(cfg).m_dtype == "int8"
    batch = specs.input_specs(cfg, ShapeConfig("p", 128, 4, "prefill"))
    assert tuple(batch["tokens"].shape) == (4, 128)


# ---------------------------------------------------------------------------
# Retrace auditor
# ---------------------------------------------------------------------------

def test_signature_is_deterministic_and_shape_sensitive():
    def fn(x):
        return (x * 2).sum()

    a = torch.zeros(4)
    assert retrace.signature(fn, a) == retrace.signature(fn, a)
    assert retrace.signature(fn, a) != retrace.signature(fn, torch.zeros(8))
    assert retrace.signature(fn, a) == retrace.signature(fn, torch.ones(4))


def test_rt501_catches_a_bit_tensor_turned_into_a_python_int():
    from repro_torch.kernels import ops

    x = torch.ones((2, 8), dtype=torch.int8)
    w = torch.ones((8, 4), dtype=torch.int8)

    def fluid(wbits):
        return ops.int8_accum(x, w)                   # container width

    def leaky(wbits):
        n = wbits.tolist()                            # host int, no sync op
        return ops.int8_accum(x, w, planes=n)

    variants = [(f"w={b}", lambda b=b: (torch.tensor(b),)) for b in (4, 8)]
    assert retrace.audit_entrypoint("fix", "fluid", variants, fluid).ok
    rep = retrace.audit_entrypoint("fix", "leaky", variants, leaky)
    assert len(rep.signatures) == 2
    assert [f.rule for f in rep.findings()] == ["RT501"]
    # a Python-int axis taken by design is a group: one signature each
    grouped = retrace.audit_entrypoint(
        "fix", "leaky", [(v[0], v[0], v[1]) for v in variants], leaky)
    assert grouped.ok and grouped.captures == 2


def test_rt502_catches_an_item_on_the_budget_path():
    def buggy(budget):
        return torch.full((2,), budget.item())        # host round trip

    rep = retrace.audit_entrypoint(
        "fix", "buggy", [("v0", lambda: (torch.tensor(0.5),))], buggy)
    assert not rep.ok
    (f,) = rep.findings()
    assert f.rule == "RT502" and "tests/" not in f.message


def test_qwen3_4b_smoke_and_hawq_resnet18_audit_single_signature():
    reports = retrace.audit_config("qwen3_4b", "cpu")
    assert [r.entrypoint for r in reports] == [
        "prefill_row", "decode_scan", "sample_first", "extend_row",
        "draft_scan", "verify_chunk"]
    for r in reports:
        assert r.ok, (r.entrypoint, r.groups, r.errors, r.syncs)
        assert r.launches and all(v == {} for v in r.launches.values())
    captures = {r.entrypoint: r.captures for r in reports}
    assert captures == {"prefill_row": 1, "decode_scan": 1,
                        "sample_first": 1, "extend_row": 2,
                        "draft_scan": 2, "verify_chunk": 1}
    cnn = retrace.audit_cnn("cpu")
    assert cnn.ok and cnn.captures == 1
    assert len(cnn.signatures[next(iter(cnn.signatures))]) == 5


def test_retrace_refuses_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        retrace.run_retrace(["qwen3_4b"], include_cnn=False, device="cuda")


# ---------------------------------------------------------------------------
# The port's own tree, the suite and the CLI
# ---------------------------------------------------------------------------

def test_cli_retrace_asks_for_the_card_by_default(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        analyze.main(["--retrace", "--configs", "qwen3_4b"])
    assert e.value.code == 2
    assert "--device cpu" in capsys.readouterr().err


def test_repo_lint_is_clean():
    assert lint.run_lint(common.repo_root()) == []


def test_run_suite_fast_passes_ok():
    res = run_suite(passes=("lint", "ledger"))
    assert res.ok
    d = res.to_dict()
    assert d["ok"] and set(d["passes"]) == {"lint", "ledger"}
    assert set(ALL_PASSES) == {"lint", "retrace", "sharding", "ledger"}


def test_cli_exit_codes_and_json(tmp_path):
    out = tmp_path / "status.json"
    assert analyze.main(["--lint", "--ledger", "--device", "cpu",
                         "--json", str(out)]) == 0
    payload = json.loads(out.read_text())
    assert payload["ok"] is True and payload["device"] == "cpu"
    assert set(payload["passes"]) == {"lint", "ledger"}
    # the host passes need no GPU under the default --device cuda
    assert analyze.main(["--lint", "--ledger", "--json", str(out)]) == 0
    assert json.loads(out.read_text())["device"] == "cuda"
    # a stale baseline entry fails the whole suite
    stale = tmp_path / "baseline.json"
    stale.write_text(json.dumps({"entries": [
        {"rule": "HS101", "file": "gone.py", "match": "x.item()",
         "why": "the code is gone"}]}))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.analyze", "--all",
         "--configs", "qwen3_4b", "--baseline", str(stale), "--json",
         str(out), "--device", "cpu"], capture_output=True, text=True,
        env=env, timeout=300, cwd=str(ROOT))
    assert res.returncode == 1, res.stdout + res.stderr
    assert "STALE entry HS101" in res.stdout
    assert "kernel specialisations not audited" in res.stdout
    payload = json.loads(out.read_text())
    assert payload["ok"] is False and payload["stale_baseline"]
    assert all(p["ok"] for p in payload["passes"].values())
    assert np.isfinite(payload["elapsed_s"])

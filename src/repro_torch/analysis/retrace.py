"""Retrace auditor (pass 2 of 4): one program across every precision.

The counterpart of the reference's retrace pass.  The reference hashes
each jitted entrypoint's jaxpr across a variant matrix; eager PyTorch
has no trace to hash, so this pass records what a call really runs
instead.  A :class:`OpRecorder` (a ``TorchDispatchMode``) logs the call's
aten op stream (each op's name, its tensor inputs' shapes, dtypes and
device types, and its non-tensor arguments), and
``repro_torch.kernels.launch_keys()`` before and after gives the kernel
specialisations the call launched (ctypes launches, which no dispatch
mode sees; empty on the CPU, where the wrappers take their plain
versions, whose ops the stream holds).  A call's signature is the
sha256 of both.  Every entrypoint is reached through a real
:class:`~repro_torch.serve.engine.ServeEngine` (SMOKE weights from a
seed), with ``controller.resolve`` inside the recorded call, across the
reference's matrix of budgets x draft depth k x (start, length).

* **RT501**: an entrypoint gives more than one signature across the
  variants of one group: some variant-dependent value reached the
  program as a Python value or a shape.  The budget and bit axes must
  give one signature always.  Where the port takes an axis as a Python
  int by design (``_extend_row``'s start and tail length, the draft
  depth of ``_draft_scan``, which drafts only as deep as a round can
  accept), the op stream follows it by construction: variants are
  grouped by that axis, and the distinct signatures across the groups
  are the captures a CUDA graph of the entrypoint would need
  (:attr:`TraceReport.captures`, in the pass's notes).  Every other
  axis is fatal, as in the reference.
* **RT502**: an ``aten._local_scalar_dense`` inside an entrypoint (an
  ``.item()``, ``int(t)``, ``bool(t)`` or ``if t`` on a tensor): a host
  sync hiding inside the program on the budget -> bits -> program
  path, named by the innermost frame of the port; or a variant that
  raised.  On the CPU a dispatch mode does not see ``.tolist()``,
  ``.cpu()`` or ``.numpy()``; the AST lint covers those, and on the card
  ``torch.cuda.set_sync_debug_mode`` sees every sync (chip_smoke.py's
  path 13 holds the three against each other).

``run_retrace(device=)`` runs on ``cuda`` by default (the kernels
launch, and their specialisations enter the signature; without a GPU it
raises) or, where the caller asks, on the CPU (the tests), where the
kernels' plain versions run and no specialisation is recorded.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.common import Finding

# budget values spanning the default controller's config table
BUDGETS = (0.0, 0.6, 0.8, 2.0)
BUDGET_MIXES = ((0.0, 2.0), (0.6, 0.8), (2.0, 2.0), (0.8, 0.0))

# audit-engine geometry (smoke configs: L=2, d=64, V=512)
N_SLOTS = 2
PREFILL_LEN = 8
MAX_LEN = 48
DECODE_BLOCK = 4
CNN_IMAGE = 16
CNN_BATCH = 2

ENTRYPOINT_FILES: Dict[str, str] = {
    "prefill": "src/repro_torch/models/lm.py",
    "decode_step": "src/repro_torch/models/lm.py",
    "prefill_row": "src/repro_torch/serve/engine.py",
    "decode_scan": "src/repro_torch/serve/engine.py",
    "draft_scan": "src/repro_torch/serve/engine.py",
    "verify_chunk": "src/repro_torch/serve/engine.py",
    "extend_row": "src/repro_torch/serve/engine.py",
    "sample_first": "src/repro_torch/serve/engine.py",
    "generate": "src/repro_torch/serve/engine.py",
    "cnn_forward": "src/repro_torch/models/cnn.py",
}

_SYNC_OP = torch.ops.aten._local_scalar_dense.default
_PKG = os.sep + "repro_torch" + os.sep
_ANALYSIS = os.sep + "repro_torch" + os.sep + "analysis" + os.sep


# ---------------------------------------------------------------------------
# Signatures
# ---------------------------------------------------------------------------

_PLAIN = (bool, int, float, str, torch.dtype, torch.layout,
          torch.memory_format)


def _describe(x):
    """One argument of an op, with no value that is not part of the
    program: a tensor is its shape, dtype and device type."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return tuple(map(_describe, x))
    if x is None or isinstance(x, _PLAIN):
        return x
    if isinstance(x, torch.device):
        return x.type
    return type(x).__name__


def _port_frame() -> str:
    """``file:line`` (repo-relative) of the innermost frame of the port
    outside the analyzers, or ''."""
    for fr in reversed(traceback.extract_stack()):
        if _PKG in fr.filename and _ANALYSIS not in fr.filename:
            path = fr.filename
            return path[path.rindex(os.sep + "src" + os.sep) + 1:] \
                .replace(os.sep, "/") + f":{fr.lineno}"
    return ""


class OpRecorder(TorchDispatchMode):
    """Records every aten op a block runs; ``syncs`` holds the port
    frame of each ``aten._local_scalar_dense`` (a host sync)."""

    def __init__(self) -> None:
        super().__init__()
        self.ops: List[str] = []
        self.syncs: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops.append((func, _describe(args),
                         tuple((k, _describe(v)) for k, v in kwargs.items())
                         if kwargs else ()))
        if func is _SYNC_OP:
            self.syncs.append(_port_frame())
        return func(*args, **kwargs)


@dataclasses.dataclass
class Call:
    """What one recorded call ran."""
    signature: str
    launches: Dict[Tuple, int]          # kernel specialisation -> count
    syncs: List[str]                    # port frames of host syncs


def record(fn: Callable, *args, **kwargs) -> Tuple[object, Call]:
    """Run ``fn(*args, **kwargs)`` under an :class:`OpRecorder`;
    returns (its result, the :class:`Call`)."""
    from repro_torch.kernels import launch_keys, launches_since

    before = launch_keys()
    rec = OpRecorder()
    with rec:
        out = fn(*args, **kwargs)
    launches = launches_since(before)
    spec = sorted(launches.items(), key=repr)
    text = repr([(str(f), a, k) for f, a, k in rec.ops]) + "\n#" + repr(spec)
    sig = hashlib.sha256(text.encode()).hexdigest()[:16]
    return out, Call(sig, launches, rec.syncs)


def signature(fn: Callable, *args) -> str:
    """sha256 of the op stream and the kernel specialisations one call
    of ``fn(*args)`` runs."""
    return record(fn, *args)[1].signature


# ---------------------------------------------------------------------------
# Reports
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TraceReport:
    """One (config, entrypoint) audit: variant labels per signature,
    grouped by the Python-int axes the port takes by design."""
    config: str
    entrypoint: str
    signatures: Dict[str, List[str]]     # sig hash -> variant labels
    errors: Dict[str, str]               # variant label -> error text
    groups: Dict[str, Dict[str, List[str]]] = dataclasses.field(
        default_factory=dict)            # group -> sig -> labels
    syncs: Dict[str, List[str]] = dataclasses.field(
        default_factory=dict)            # variant label -> sync frames
    launches: Dict[str, Dict[Tuple, int]] = dataclasses.field(
        default_factory=dict)            # sig -> specialisations

    @property
    def ok(self) -> bool:
        return (all(len(s) == 1 for s in self.groups.values())
                and not self.errors and not self.syncs)

    @property
    def captures(self) -> int:
        """Distinct signatures: the CUDA graph captures the entrypoint
        would need (1 unless it takes a Python-int axis)."""
        return len(self.signatures)

    def spec_sets(self) -> List[frozenset]:
        """The distinct sets of kernel specialisation keys launched."""
        return sorted({frozenset(v) for v in self.launches.values()},
                      key=repr)

    def findings(self) -> List[Finding]:
        file = ENTRYPOINT_FILES.get(self.entrypoint, "")
        out: List[Finding] = []
        for group, sigs in sorted(self.groups.items()):
            if len(sigs) <= 1:
                continue
            parts = "; ".join(
                f"{sig}: {', '.join(labels)}"
                for sig, labels in sorted(sigs.items()))
            where = f" within {group}" if group else ""
            out.append(Finding(
                rule="RT501", file=file, line=0,
                scope=f"{self.config}.{self.entrypoint}",
                message=f"{len(sigs)} signatures{where} across "
                        f"{sum(map(len, sigs.values()))} variants "
                        f"({parts}) — the op stream or the kernel "
                        f"specialisations follow a budget or bit value",
                hint="a variant-dependent value is reaching the program "
                     "as a Python value or a shape; keep budgets and "
                     "bits tensors end to end"))
        for label, frames in sorted(self.syncs.items()):
            where = ", ".join(sorted(set(frames)))
            out.append(Finding(
                rule="RT502", file=file, line=0,
                scope=f"{self.config}.{self.entrypoint}",
                message=f"variant {label!r} ran {len(frames)} host "
                        f"sync(s) (aten._local_scalar_dense) at {where}",
                hint="an .item()/int()/bool()/if on a tensor sits on the "
                     "budget->bits->program path; keep it on the device"))
        for label, err in sorted(self.errors.items()):
            out.append(Finding(
                rule="RT502", file=file, line=0,
                scope=f"{self.config}.{self.entrypoint}",
                message=f"variant {label!r} failed: {err}",
                hint="the entrypoint must run at every variant of the "
                     "matrix"))
        return out


def audit_entrypoint(config: str, entrypoint: str,
                     variants: Sequence, fn: Callable) -> TraceReport:
    """Record ``fn`` once per variant (each thunk builds the argument
    tuple through the construction code the engine uses) and bucket the
    signatures.  A variant is ``(label, thunk)`` or ``(label, group,
    thunk)``: signatures must agree within a group."""
    rep = TraceReport(config=config, entrypoint=entrypoint, signatures={},
                      errors={})
    for v in variants:
        label, group, thunk = v if len(v) == 3 else (v[0], "", v[1])
        try:
            _, call = record(fn, *thunk())
        except Exception as e:                  # noqa: BLE001 - reported
            rep.errors[label] = \
                f"{type(e).__name__}: {e}".splitlines()[0][:200]
            continue
        rep.signatures.setdefault(call.signature, []).append(label)
        rep.groups.setdefault(group, {}).setdefault(
            call.signature, []).append(label)
        rep.launches[call.signature] = call.launches
        if call.syncs:
            rep.syncs[label] = call.syncs
    return rep


# ---------------------------------------------------------------------------
# Engine state (SMOKE weights from a seed)
# ---------------------------------------------------------------------------

def smoke_qparams(cfg, device, seed: int = 0) -> dict:
    from repro_torch.models import lm

    gen = torch.Generator(device=device).manual_seed(seed)
    return lm.quantize_params(lm.init_params(cfg, gen, device=device), cfg)


def build_engine(cfg, qparams, device, *, n_slots: int = N_SLOTS,
                 prefill_len: int = PREFILL_LEN, max_len: int = MAX_LEN,
                 decode_block: int = DECODE_BLOCK):
    """The audit engine: the default controller under an 8-device fully
    replicated placement plan (a plan prices admissions; it must never
    change a program), speculative where the family allows it."""
    from repro_torch import dist
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine, default_controller

    spec_ok = (cfg.family in lm.SPEC_CHUNK_FAMILIES
               and not cfg.sliding_window)
    controller = default_controller(lm.n_bit_slots(cfg))
    plan = dist.plan_for_controller(
        controller, lm.layer_gemm_dims(cfg), n_devices=8,
        head=lm.head_gemm_dims(cfg))
    return ServeEngine(
        cfg, qparams, max_len=max_len, controller=controller, plan=plan,
        n_slots=n_slots, prefill_len=prefill_len, decode_block=decode_block,
        spec_k=2 if spec_ok else None,
        draft_budget_s=0.0 if spec_ok else None, device=device)


def _f32(vals, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(vals, np.float32)).to(device)


def _seeded(shape, device, seed: int = 0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g).to(device)


# ---------------------------------------------------------------------------
# Per-config audits
# ---------------------------------------------------------------------------

def audit_engine(name: str, eng, budgets=BUDGETS, mixes=BUDGET_MIXES,
                 only: Optional[Sequence[str]] = None) -> List[TraceReport]:
    """Engine-level audit for the continuous-batching families: the
    engine's programs, reached through its own argument construction,
    with ``controller.resolve`` inside the recorded call.  ``only``
    picks some of the entrypoints (default: all)."""
    from repro_torch.models import lm
    from repro_torch.serve.engine import SPEC_K_MAX

    cfg, dev = eng.cfg, eng.device
    B, V, P = eng.n_slots, cfg.padded_vocab, eng.prefill_len
    npre = cfg.n_prefix_tokens if cfg.family == "vlm" else 0
    reports: List[TraceReport] = []

    def want(entrypoint: str) -> bool:
        return only is None or entrypoint in only

    def run(fn):
        def call(*args):
            with torch.no_grad(), eng.compute_ctx():
                return fn(*args)
        return call

    def bits(budget):
        wv, av = eng.controller.resolve(budget)
        return wv.to(dev), av.to(dev)

    # the controller caches its latency table at the first resolve: fill
    # it before recording, as the engine's first admission does
    bits(torch.tensor(0.0))

    def cache(rows: int):
        return lm.empty_cache(cfg, rows, eng.max_len, device=dev)

    def ints(shape, fill=0):
        return torch.full(shape, fill, dtype=torch.int32, device=dev)

    # ---- prefill_row: per-admission ragged prefill -------------------
    def prefill_row_fn(budget, tokens, length, *prefix):
        wv, av = bits(budget)
        return eng._prefill_row(tokens, length, wv, av, *prefix)

    def prefill_row_args(budget: float, S: int):
        extra = (() if npre == 0
                 else (_seeded((1, npre, cfg.d_model), dev),))
        return (torch.tensor(budget, dtype=torch.float32), ints((1, P), 1),
                torch.tensor([S], dtype=torch.int32).to(dev)) + extra

    if want("prefill_row"):
        reports.append(audit_entrypoint(
            name, "prefill_row",
            [(f"budget={b}/S={s}", lambda b=b, s=s: prefill_row_args(b, s))
             for b in budgets[:3] for s in (1, P)],
            run(prefill_row_fn)))

    # ---- decode_scan: the per-tick decode block ----------------------
    def decode_fn(budgets_, tok, t, cache_, temp, topk):
        wv, av = bits(budgets_)
        return eng._decode_block(tok, t, cache_, wv, av, temp, topk,
                                 eng.decode_block)

    def decode_args(mix):
        return (torch.as_tensor(np.asarray(mix, np.float32)),
                ints((B, 1)), ints((B,), P), cache(B),
                _f32(np.zeros(B), dev), ints((B,)))

    if want("decode_scan"):
        reports.append(audit_entrypoint(
            name, "decode_scan",
            [(f"mix={mix}", lambda mix=mix: decode_args(mix))
             for mix in mixes],
            run(decode_fn)))

    # ---- sample_first: per-admission first-token sampling ------------
    if want("sample_first"):
        reports.append(audit_entrypoint(
            name, "sample_first",
            [(f"temp={temp}", lambda temp=temp: (
                _seeded((1, 1, V), dev), _f32([temp], dev), ints((1,))))
             for temp in (0.0, 0.7)],
            run(eng._sample_first)))

    # ---- extend_row: partial prefix-cache hits -----------------------
    # start and the tail length are Python ints in the port: the group
    def extend_fn(budget, tokens, row, start, r):
        wv, av = bits(budget)
        return eng._extend_row(tokens, row, start, r, wv, av)

    def extend_args(budget: float, start: int, r: int):
        return (torch.tensor(budget, dtype=torch.float32), ints((1, P), 1),
                cache(1), start, r)

    if want("extend_row"):
        reports.append(audit_entrypoint(
            name, "extend_row",
            [(f"budget={b}/start={s}/r={r}", f"start={s}/r={r}",
              lambda b=b, s=s, r=r: extend_args(b, s, r))
             for b in budgets[:2] for (s, r) in ((1, P - 1), (P - 1, 1))],
            run(extend_fn)))

    if eng.spec_k is None or not (want("draft_scan")
                                  or want("verify_chunk")):
        return reports

    # ---- draft_scan: the low-bit self-draft --------------------------
    # the draft bits are cached per config index: fill the cache first,
    # as the first speculative round does
    eng._draft_bits()
    # the depth is a Python int (a round drafts only as deep as its
    # deepest row can accept): the group
    def draft_fn(tok, t, cache_, temp, topk, steps):
        dwv, dav = eng._draft_bits()
        return eng._draft_scan(tok, t, cache_, dwv, dav, temp, topk, steps)

    def draft_args(t0: int, steps: int):
        return (ints((B, 1)), ints((B,), t0), cache(B),
                _f32(np.zeros(B), dev), ints((B,)), steps)

    if want("draft_scan"):
        reports.append(audit_entrypoint(
            name, "draft_scan",
            [(f"t={t0}/k={k}", f"k={k}",
              lambda t0=t0, k=k: draft_args(t0, k))
             for t0 in (4, 9) for k in (1, SPEC_K_MAX)],
            run(draft_fn)))

    # ---- verify_chunk: one (SPEC_K_MAX + 1)-wide verify --------------
    def verify_fn(budgets_, tok, dt, dp, t, cache_, k_eff, temp, topk):
        wv, av = bits(budgets_)
        return eng._spec_verify(tok, dt, dp, t, cache_, wv, av, k_eff,
                                temp, topk)

    def verify_args(mix, k: int):
        probs = torch.softmax(_seeded((B, SPEC_K_MAX, V), dev), dim=-1)
        return (torch.as_tensor(np.asarray(mix, np.float32)), ints((B, 1)),
                ints((B, SPEC_K_MAX)), probs, ints((B,), P), cache(B),
                torch.as_tensor(np.minimum(k, np.arange(1, B + 1))).to(dev),
                _f32(np.zeros(B), dev), ints((B,)))

    if want("verify_chunk"):
        reports.append(audit_entrypoint(
            name, "verify_chunk",
            [(f"mix={mix}/k={k}", lambda mix=mix, k=k: verify_args(mix, k))
             for mix in mixes[:2] for k in (0, 1, SPEC_K_MAX)],
            run(verify_fn)))
    return reports


def audit_model(name: str, cfg, qparams, device) -> List[TraceReport]:
    """Model-level audit for the whole-batch families (ssm/moe/hybrid/
    encdec): prefill and decode_step as ``generate()`` builds them."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models import lm
    from repro_torch.serve.engine import default_controller

    B, S = 2, PREFILL_LEN
    ctrl = default_controller(lm.n_bit_slots(cfg))
    fams = (4, 8)
    reports: List[TraceReport] = []

    def bits(budget):
        wv, av = ctrl.resolve(budget)
        return wv.to(device), av.to(device)

    bits(torch.tensor(0.0))               # the latency table's cache

    def prefill_fn(budget, tokens, cache, *extra):
        wv, av = bits(budget)
        batch = {"tokens": tokens}
        if cfg.family == "encdec":
            batch["frames"] = extra[0]
        with torch.no_grad(), kops.bit_families(fams):
            return lm.prefill(qparams, batch, cfg, wv, av, cache)

    def prefill_args(budget: float):
        extra = ()
        if cfg.family == "encdec":
            F = max(MAX_LEN // cfg.frames_ratio, 1)
            extra = (_seeded((B, F, cfg.d_model), device),)
        return (torch.tensor(budget, dtype=torch.float32),
                torch.ones((B, S), dtype=torch.int32, device=device),
                lm.empty_cache(cfg, B, MAX_LEN, device=device)) + extra

    reports.append(audit_entrypoint(
        name, "prefill",
        [(f"budget={b}", lambda b=b: prefill_args(b)) for b in BUDGETS],
        prefill_fn))

    def decode_fn(budget, tok, t, cache):
        wv, av = bits(budget)
        with torch.no_grad(), kops.bit_families(fams):
            return lm.decode_step(qparams, tok, t, cache, cfg, wv, av)

    def decode_args(budget: float, t0: int):
        return (torch.tensor(budget, dtype=torch.float32),
                torch.zeros((B, 1), dtype=torch.int32, device=device),
                torch.full((B,), t0, dtype=torch.int32, device=device),
                lm.empty_cache(cfg, B, MAX_LEN, device=device))

    reports.append(audit_entrypoint(
        name, "decode_step",
        [(f"budget={b}/t={t0}", lambda b=b, t0=t0: decode_args(b, t0))
         for b in BUDGETS[:3] for t0 in (S,)],
        decode_fn))
    return reports


def audit_cnn(device, image: int = CNN_IMAGE, batch: int = CNN_BATCH,
              seed: int = 0) -> TraceReport:
    """The CNN's conv-GEMM forward: one signature across every HAWQ-V3
    ResNet18 configuration (the paper's config-switching claim)."""
    from repro_torch.apsim.workloads import HAWQV3_RESNET18, per_layer_bits
    from repro_torch.kernels import ops as kops
    from repro_torch.models import cnn

    gen = torch.Generator(device=device).manual_seed(seed)
    params, layers = cnn.init_cnn("resnet18", gen, image=image,
                                  device=device)
    qp = cnn.quantize_cnn_params(params, layers)
    del params
    x = _seeded((batch, image, image, 3), device, seed)

    def fwd(wv, av):
        with torch.no_grad(), kops.bit_families((4, 8)):
            return cnn.cnn_forward(qp, x, layers, wv, av)

    def args(vec):
        bits = torch.tensor(per_layer_bits(layers, vec),
                            dtype=torch.int32).to(device)
        return bits, bits

    return audit_entrypoint(
        f"resnet18_hawq@{image}", "cnn_forward",
        [(cfg_name, lambda vec=vec: args(vec))
         for cfg_name, vec in HAWQV3_RESNET18.items()],
        fwd)


def audit_config(name: str, device="cuda") -> List[TraceReport]:
    from repro_torch import configs
    from repro_torch.models import common as cm
    from repro_torch.models import lm

    dev = cm.resolve_device(device)
    cfg = configs.get_smoke(name)
    qparams = smoke_qparams(cfg, dev)
    if cfg.family in lm.RAGGED_PREFILL_FAMILIES:
        return audit_engine(name, build_engine(cfg, qparams, dev))
    return audit_model(name, cfg, qparams, dev)


def run_retrace(arch_ids: Optional[Sequence[str]] = None,
                include_cnn: bool = True, device="cuda"
                ) -> Tuple[List[Finding], List[TraceReport]]:
    """Audit every config (default: all ten) and the CNN path on
    ``device``.  Returns (findings, reports); no finding is the proof
    that no budget or bit configuration changes a program."""
    from repro_torch import configs
    from repro_torch.models import common as cm

    dev = cm.resolve_device(device)
    reports: List[TraceReport] = []
    for name in (arch_ids if arch_ids is not None else configs.ARCH_IDS):
        reports.extend(audit_config(name, dev))
    if include_cnn:
        reports.append(audit_cnn(dev))
    findings = [f for r in reports for f in r.findings()]
    return findings, reports

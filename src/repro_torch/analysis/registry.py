"""Project knowledge shared by the port's analysis passes.

The counterpart of ``repro.analysis.registry``, rebuilt for eager
PyTorch.  Three kinds of knowledge live here, out of the generic pass
machinery, so growing the code means editing data, not analyzers:

* **Hot scopes**: the per-tick and per-admission serving paths where a
  host sync is a real throughput bug.  The reference's program bodies
  are jitted closures; the port's are eager methods of the engine that
  run every tick (``_prefill_row``, ``_decode_block``, ``_draft_scan``,
  ``_spec_verify``, ``_sample_first``, ``_extend_row``), so they are
  registered hot too.  One-time setup (``__init__``, pool construction)
  and the cached host helpers (``host_bits``, ``_host_index``,
  ``_config_cost``, the per-admission ``_first_token``) are not.
* **Taint vocabulary**: which callees produce device values, which
  return host values, and which force a sync on whatever they are given.
  The linter's dataflow is intraprocedural; these sets are its
  interprocedural knowledge.
* **Ledger waivers**: ``CostRecord`` fields written by the serve layer
  that ``accounting.aggregate()`` intentionally does not read, each
  naming its consumer in the port.
"""
from __future__ import annotations

import fnmatch
from typing import Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Hot scopes for the host-sync rules (HS101/HS102/HS103)
# ---------------------------------------------------------------------------
# file pattern (repo-relative, fnmatch) -> qualname patterns.  "*" marks
# a whole module hot (the kernel wrappers run inside every forward).
HOT_SCOPES: Dict[str, Tuple[str, ...]] = {
    "src/repro_torch/serve/engine.py": (
        # the tick and admission paths
        "ServeEngine._admit",
        "ServeEngine._step",
        "ServeEngine._decode_tick",
        "ServeEngine._spec_round",
        "ServeEngine._batch_bits",
        "ServeEngine._generate",
        "ServeEngine._finish",
        # the program bodies, run eagerly every tick
        "ServeEngine._prefill_row",
        "ServeEngine._decode_block",
        "ServeEngine._draft_scan",
        "ServeEngine._spec_verify",
        "ServeEngine._sample_first",
        "ServeEngine._extend_row",
    ),
    "src/repro_torch/serve/runtime.py": (
        "ServeRuntime.admit_record",
        "ServeRuntime.plan_admissions",
        "ServeRuntime.charge",
        "ServeRuntime.new_record",
        "ServeRuntime.next_admission",
        "ServeRuntime.finish_record",
        "ServeRuntime.sched_tick",
        "ServeRuntime.age_queue",
    ),
    "src/repro_torch/serve/cnn.py": (
        "CNNServeEngine.serve",
    ),
    "src/repro_torch/kernels/*.py": ("*",),
}

# The engine's program bodies: a sync the card sees under one of these
# frames is inside a program (chip_smoke.py's sync audit, RT502).
PROGRAM_BODIES: Tuple[str, ...] = (
    "_prefill_row", "_decode_block", "_draft_scan", "_spec_verify",
    "_sample_first", "_extend_row",
)


def hot_patterns(relpath: str) -> Tuple[str, ...]:
    """Qualname patterns registered hot for one file ('' when none)."""
    out: Tuple[str, ...] = ()
    for pat, quals in HOT_SCOPES.items():
        if fnmatch.fnmatch(relpath, pat):
            out += quals
    return out


def is_hot(relpath: str, qualname: str) -> bool:
    for pat in hot_patterns(relpath):
        if pat == "*" or fnmatch.fnmatch(qualname, pat):
            return True
        # nested defs inherit their enclosing scope's hotness
        if qualname.startswith(pat + ".") or qualname.startswith(
                pat + ".<locals>."):
            return True
    return False


# ---------------------------------------------------------------------------
# Taint vocabulary for the host-sync dataflow
# ---------------------------------------------------------------------------

# method/attribute names whose call RETURNS device tensors: seeds of the
# taint besides torch.* calls and methods of a tainted tensor.  Matched
# on the final attribute of the callee.
DEVICE_METHODS = frozenset({
    # sharding
    "shard_bits", "shard_budgets", "shard_batch",
    # ServeEngine programs and their device-side helpers
    "_prefill_row", "_decode_block", "_draft_scan", "_spec_verify",
    "_sample_first", "_extend_row", "_bits", "_batch_bits", "_draft_bits",
    "_slot_inputs", "admit_record",
    # the models' forwards
    "prefill", "decode_step", "decode_chunk", "cnn_forward",
})

# names whose call returns HOST values even when fed device state: the
# cached per-admission helpers, the controller's gather from its CPU
# tables (``resolve``: the callers move its bits to the device), the
# per-admission first-token sample and the mesh's coalesced row gather
# (a CPU tensor).
HOST_METHODS = frozenset({
    "host_bits", "host_tables", "_host_index", "_config_cost", "resolve",
    "_first_token", "gather_rows",
})

# tensor methods that return host values without a sync (metadata), and
# the sanctioned coalesced device-to-host transfer (one ``.cpu()`` of a
# stacked tensor per tick, then ``.numpy()`` of the host copy)
SHAPE_METHODS = frozenset({
    "size", "dim", "numel", "element_size", "data_ptr", "is_contiguous",
    "stride", "get_device", "nelement", "storage_offset",
})
TRANSFER_METHODS = frozenset({"cpu"})

# callees that force a host sync of their *arguments*: calling them on a
# device value is itself the finding (they np.asarray internally).
SYNC_ARG_METHODS = frozenset({
    "price_bits", "price", "price_verify", "price_matrix",
    "price_verify_bits", "price_matrix_bits",
})

# torch.* callees that do NOT produce device values (metadata, modes,
# generators, the CUDA runtime's and the process group's own calls)
TORCH_HOST_CALLS = frozenset({
    "torch.is_tensor", "torch.no_grad", "torch.inference_mode",
    "torch.finfo", "torch.iinfo", "torch.device", "torch.Generator",
    "torch.get_default_dtype", "torch.is_grad_enabled", "torch.Size",
    "torch.is_floating_point", "torch.enable_grad",
})
TORCH_HOST_PREFIXES = ("torch.cuda.", "torch.backends.", "torch.distributed.")

# builtins that read only host metadata of a tensor (no sync)
HOST_BUILTINS = frozenset({
    "len", "isinstance", "getattr", "hasattr", "type", "id", "callable",
    "issubclass", "repr",
})


# ---------------------------------------------------------------------------
# Static bit audit (STAT401)
# ---------------------------------------------------------------------------
# A runtime bit value is a bit-named tensor.  Turned into a Python number
# and handed to a kernel's static parameter, a cached function or
# torch.compile, it specialises the program on one precision: the
# paper's run-time claim (one program across all precisions) dies
# exactly this way.
BIT_NAMES = frozenset({"wv", "av", "wb", "ab", "wmat", "amat", "dwv", "dav",
                       "swv", "sav"})

# the kernel entries whose arguments select a kernel specialisation
KERNEL_ENTRIES = frozenset({
    "bitplane_matmul", "int8_accum", "fluid_linear", "serve_linear",
    "serve_linear_stacked", "quant_linear", "int4_linear", "int4_matmul",
    "quant_matmul", "flash_attention",
})
# keyword parameters that are a kernel's static plane count
STATIC_PLANE_PARAMS = frozenset({"n_planes", "planes"})
# modules whose bit-named parameters carry runtime bits (tensors): the
# models' forwards, the kernel layer and the serving engines.  Host
# pricing (apsim/, accounting) takes host bit tables by design.
RUNTIME_BIT_MODULES = ("src/repro_torch/kernels/", "src/repro_torch/models/",
                       "src/repro_torch/serve/engine.py",
                       "src/repro_torch/serve/cnn.py")


def is_bit_name(name: str) -> bool:
    return name in BIT_NAMES or "bit" in name.lower()


# ---------------------------------------------------------------------------
# Ledger waivers (ledger auditor)
# ---------------------------------------------------------------------------
# CostRecord fields written in serve/ that aggregate() intentionally
# does not consume, each naming its consumer in the port.  An
# aggregate()-side pickup makes the waiver STALE (the auditor flags it
# for removal).
LEDGER_WAIVED: Dict[str, str] = {
    "rid": "request identity joining the runtime queue, engine slots, "
           "serve/traffic.py's replay records and "
           "repro_torch.launch.serve's per-request table",
    "submitted_s": "wall-clock latency in repro_torch.launch.serve's "
                   "per-request table (finished_s - submitted_s)",
    "budget_s": "per-request budget in repro_torch.launch.serve's table "
                "and tests/test_torch_traffic.py",
    "mean_wbits": "serve/traffic.py's per-request bits and "
                  "repro_torch.launch.serve's per-request table",
    "cached_mean_wbits": "prefix-cache precision, held against the "
                         "reference by tests/test_torch_prefix_cache.py",
    "cached_cost": "hit repricing vs miss pricing, held against the "
                   "reference by tests/test_torch_prefix_cache.py",
    "cache_hit": "hit-kind split, read by tests/test_torch_prefix_cache.py",
    # port-only fields (the reference's records carry neither)
    "admitted_s": "host clock of the admission: time to first token in "
                  "chip_smoke.py's continuous paths, ordered by "
                  "tests/test_torch_traffic.py",
    "first_token_s": "host clock of the first token: time to first token "
                     "in chip_smoke.py's continuous paths, ordered by "
                     "tests/test_torch_traffic.py",
    "planned_units": "axis_planned() admission charge, reconciled in "
                     "ServeRuntime.finish_record",
    "slot": "slot lifecycle bookkeeping in ServeEngine._admit/_finish and "
            "repro_torch.launch.serve's per-request table",
    "submitted_tick": "queue-delay series in serve/traffic.py's records",
    "admitted_tick": "queue-delay series in serve/traffic.py's records",
    "finished_tick": "latency_ticks property -> tick-domain latency, "
                     "read by tests/test_torch_traffic.py",
    "finished_s": "wall-clock latency in repro_torch.launch.serve's "
                  "per-request table",
    "spec_k": "per-request draft depth, read by "
              "tests/test_torch_spec_decode.py",
    "planned_spec_rounds": "axis_planned() speculative charge, "
                           "reconciled in finish_record",
    "planned_spec_tokens": "axis_planned() speculative charge, "
                           "reconciled in finish_record",
    # ImageStats-only fields (CNN serve writes them through the same
    # record type family)
    "index": "batch position, printed by "
             "examples/mixed_precision_resnet18_torch.py",
    "wbits": "per-image configuration, held against the reference by "
             "tests/test_torch_cnn_serve.py",
    "abits": "per-image configuration, held against the reference by "
             "tests/test_torch_cnn_serve.py",
}


def waiver_for(field: str) -> Optional[str]:
    return LEDGER_WAIVED.get(field)

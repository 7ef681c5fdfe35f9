"""Bit-fluid LM serving: continuous batching, speculative decoding and
the whole-batch API, on one device or row-split across a data mesh.

The counterpart of ``repro.serve.engine.ServeEngine``.  Each request
carries its own latency budget, resolved by a
:class:`~repro_torch.core.policy.BudgetController` (or the closed-loop
:class:`~repro_torch.core.policy.FluidController`, which picks precision
from what is left of a system-level SLO window) into a per-layer bit
vector; a batch's ``(B, n_layers)`` bit matrix runs through the
bit-grouped dispatch (one bit-plane kernel launch per linear and bit
family).  The queue, the EDP-aware admission scheduler, the slot table
and the pricing live in :class:`~repro_torch.serve.runtime.ServeRuntime`;
this module owns what is LM-shaped.

  * continuous: ``submit(prompt, budget_s=, ...) -> rid`` and ``run()``
    (or ``step()``, or ``submit_at(tick, thunk)`` for deferred arrivals).
    An admitted request's prompt prefills alone on a right-padded
    ``(1, prefill_len)`` row (``lm.prefill(lengths=)``) whose cache is
    copied into a persistent :class:`~repro_torch.models.lm.CachePool`
    slot; each tick then decodes ``decode_block`` tokens for every slot
    together, each row at its own bits, position and sampling params.
  * speculative (``spec_k``): a round drafts up to ``SPEC_K_MAX`` tokens
    per row at the draft bits (``draft_budget_s``), verifies the current
    token and the drafts in one ``(SPEC_K_MAX + 1)``-wide
    ``lm.decode_chunk`` at each row's own bits, delivers the longest
    accepted prefix plus one token (greedy: exact match; sampled:
    rejection resampling against the draft densities), and rolls the
    rejected cache entries back (``CachePool.rollback``).
  * prefix cache (``prefix_cache=PrefixCache(...)``): each admission
    looks its prompt up first.  A full hit installs the cached row and
    reuses its stored logits (no prefill); a partial hit installs the
    shared prefix and extends the rest token by token through
    ``lm.decode_step`` (``_extend_row``); a miss prefills and stores the
    row.  Only the miss fraction is charged to a FluidController.
  * whole-batch: ``set_budget(scalar | (B,) vector)`` + ``generate(batch,
    steps)``; a prompt longer than ``transformer.FLASH_THRESHOLD`` sends
    every layer's self-attention through the flash kernel.  It is open
    loop, so it refuses a FluidController.  It is the only API of the
    moe family (whole-batch budgets: a MoE batch shares its experts'
    capacity and activation scales, so its rows are not independent) and
    of the recurrent and encoder-decoder families (ssm takes per-request
    budgets; hybrid and encdec share one attention block or the encoder
    batch-wide and take whole-batch budgets).

A vlm request carries its image as a stub: precomputed patch embeddings,
``(n_prefix_tokens, d_model)`` (``submit(prefix=)``, or ``batch["prefix"]``
of shape (B, n_prefix_tokens, d_model) for ``generate``), prefilled in
front of the prompt.  Such a request bypasses the prefix cache: its
embeddings are not content-keyed.
An encdec batch carries its audio as a stub too: ``batch["frames"]`` of
shape (B, F, d_model), which the prefill encodes once.

The reference jit-compiles each program (a scan-fused decode block, one
draft and one verify program for every depth); here each runs eagerly as
a method, so ``generate(fused=)`` changes nothing.  Two consequences:
the draft runs only as deep as the deepest row of the round can accept
(the reference always drafts ``SPEC_K_MAX``; tokens past a row's depth
are never accepted, so no output changes), and ``stats`` (the copied
``RuntimeStats``) counts no traces: nothing is compiled.  The
counterpart of the reference's zero-retrace property is
:mod:`repro_torch.analysis.retrace`: one aten op stream and one set of
kernel specialisations per program across every budget.  ``calls`` counts
the model forwards the continuous API runs instead (``"extend"`` counts
the decode steps of partial-hit extensions, the counterpart of the
reference's ``extend`` program).  A partial hit extends exactly its ``r``
tail tokens; the reference's one compiled program runs ``prefill_len``
steps with the tail clamped, recomputing the last token with identical
inputs, so the logits and the cache are the same.  The port's decode
writes the cache in place, so the extension clones the entry's row
first: a cache entry is never written.  Rows that hold no
request still decode in every tick (the batch is always ``n_slots``
wide, as in the reference); the port masks their cache entries again
after the tick, so a free slot's ``kpos`` stays EMPTY_POS (the
reference leaves them visible in the free row until the next install
overwrites it).

Randomness comes from one ``torch.Generator`` seeded from ``seed``:
greedy (temperature 0) rows equal the reference's tokens, sampled rows
match it in distribution only.  The pool and every forward stay on the
engine's device; a CUDA tensor reaches the kernels or raises.

Placement (``mesh=``, ``plan=``, DESIGN.md §13): a plan without a mesh
prices every admission under it (latency amortized over the replicas,
energy unchanged) and, for a FluidController, re-prices its SLO table.
On a mesh (a :class:`repro_torch.dist.Mesh` over a gloo group; the
caller is SPMD and submits the same requests on every rank) the weights
are placed once by ``dist.sharding.param_shardings(qparams, mesh,
plan=self.plan)``: Megatron column- and row-parallel linears over the
``model`` axis, FSDP over the data axis, and every leaf a plan fully
replicates whole.  Every sharded configuration serves logits and tokens
EQUAL to the single-device engine's on the same weights (the moe
family's expert-parallel dispatch is held to the reference's own EP
semantics instead).

  * rows: the continuous path's slots split over the data axis (slot
    ``s`` belongs to data rank ``s // (n_slots / dp)``, whose
    :class:`~repro_torch.models.lm.CachePool` holds only its rows), and
    ``generate`` splits its batch the same way.  The host program
    (``submit``, admission, the scheduler, the controller, pricing, the
    records) runs identically on every rank.  Each sampling step draws
    its noise for the whole batch and each rank takes its rows, so
    sampled streams equal the single-device engine's too.
  * forwards: with every weight whole on every rank (a fully replicated
    plan on a data mesh) only a slot's owner prefills its row and
    broadcasts the first token; otherwise every forward is a collective
    of the mesh and every rank runs it (an admission's prefill too,
    whose row only the owner keeps).  FSDP weights are gathered once a
    scheduler tick (``Mesh.reuse_gathers``).
  * speculation: each rank drafts and verifies its own rows; a round's
    tokens and rollback watermarks are all-gathered.
  * the prefix cache: an entry's row lives on the data rank that
    prefilled it; a hit for a slot another rank owns broadcasts the row
    (and a full hit's logits) to the owner (``CachePool.move_row``).
  * slots that do not split evenly over the data ranks (a
    :class:`repro_torch.dist.Mesh`): every rank holds and computes every
    slot, and the pool takes the sequence-sharded layout (each data
    rank its slice of every slot's ring, ``kpos`` whole; the int8 cache
    too).  Prefills, prefix-cache rows and partial-hit extensions run
    whole on every rank and each install keeps this rank's slice; the
    decode block and the speculative verify combine the ranks' partial
    softmaxes over the data axis; sampling draws the same noise on
    every rank, so every rank holds the same tokens.

The recurrent and encoder-decoder families serve on a mesh through
``generate`` (their only API): the Mamba states keep each model rank's
heads and conv channels, an encdec batch's ``frames`` split with its
rows, and a row that does not split over the data ranks keeps its Mamba
state whole on every data rank while a hybrid's shared-attention ring
takes the sequence-sharded layout and an encdec cross cache keeps each
data rank's frames (``encdec.FrameSlice``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import policy as pol
from repro_torch.core.policy import (BudgetController, FluidController,
                                     PrecisionPolicy)
from repro_torch.kernels import ops as kops
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.models.transformer import EMPTY_POS
from repro_torch.serve.accounting import RequestStats
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.runtime import (ServeRuntime, SlotTable,
                                       UNCONSTRAINED_BUDGET)

TOPK_MAX = 64          # top-k sort width; per-row k <= TOPK_MAX
SPEC_K_MAX = 8         # draft depth ceiling: a speculative round verifies
                       # one (SPEC_K_MAX + 1)-wide chunk per row


@dataclasses.dataclass
class Request:
    """A queued generation request with its own budget + sampling params."""
    rid: int
    prompt: np.ndarray                  # (S,) int32
    max_new_tokens: int
    budget_s: Optional[float]
    temperature: float = 0.0
    top_k: int = 0
    prefix: Optional[np.ndarray] = None  # vlm: (n_prefix_tokens, d) stub
    rep_key: Optional[int] = None       # traffic repetition key (the
                                        # prefix-cache count signal)
    draft_k: Optional[int] = None       # speculative draft depth override
                                        # (None: the engine/controller
                                        # decides)


def default_controller(n: int) -> BudgetController:
    """int4 / mixed (8 then 4) / int8 at predicted 0.5 / 0.75 / 1.0 s."""
    return pol.BudgetController(
        {"int4": pol.fixed(4), "mixed": pol.per_layer([8, 4], name="mixed"),
         "int8": pol.fixed(8)},
        {"int4": 0.5, "mixed": 0.75, "int8": 1.0}, n)


def _default_policy() -> PrecisionPolicy:
    return pol.fixed(8)


def _scaled_logits(logits: torch.Tensor, temperature: torch.Tensor,
                   top_k: torch.Tensor) -> torch.Tensor:
    """Per-row masked + temperature-scaled logits: logits (B, V);
    temperature/top_k (B,).  top_k > 0 masks all but the row's k best
    logits.  Sampling draws from softmax of this."""
    V = logits.shape[-1]
    logits = logits.float()
    K = min(TOPK_MAX, V)
    vals = torch.topk(logits, K, dim=-1).values                # (B, K)
    kth = torch.gather(vals, 1, top_k.clamp(1, K)[:, None].long() - 1)
    masked = torch.where((top_k[:, None] > 0) & (logits < kth),
                         float("-inf"), logits)
    return masked / temperature.clamp_min(1e-6)[:, None]


def _sample_tokens(logits: torch.Tensor, gen: torch.Generator,
                   temperature: torch.Tensor, top_k: torch.Tensor,
                   rows=None) -> torch.Tensor:
    """Per-row sampling: logits (B, V); temperature/top_k (B,).
    temperature == 0 -> greedy.  Sampled rows take the Gumbel-max draw
    argmax(scaled + Gumbel noise), the categorical the reference samples
    (``jax.random.categorical`` is the same construction).  ``rows`` as
    in :func:`_categorical`."""
    logits = logits.float()
    greedy = logits.argmax(dim=-1).to(torch.int32)
    sampled = _categorical(_scaled_logits(logits, temperature, top_k), gen,
                           rows)
    return torch.where(temperature > 0, sampled, greedy)


def _uniform(gen: torch.Generator, shape) -> torch.Tensor:
    """The sampling noise: uniform draws on the generator's device."""
    return torch.rand(shape, generator=gen, device=gen.device)


def _categorical(logits: torch.Tensor, gen: torch.Generator,
                 rows=None) -> torch.Tensor:
    """One draw per row from softmax(logits) (B, V): the Gumbel-max
    argmax(logits + Gumbel noise), int32.  ``rows=(lo, hi, n)`` says the
    logits are rows ``lo..hi-1`` of an ``n``-row batch: the noise is drawn
    for all ``n`` rows and sliced, so a rank's draws equal the ones its
    rows get on one device."""
    if rows is None:
        u = _uniform(gen, logits.shape)
    else:
        lo, hi, n = rows
        u = _uniform(gen, (n,) + tuple(logits.shape[1:]))[lo:hi]
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return (logits - torch.log(-torch.log(u))).argmax(dim=-1).to(torch.int32)


class ServeEngine(ServeRuntime):
    """Bit-fluid LM serving engine.

    ``qparams`` are serve-form parameters (``lm.quantize_params``); they
    are placed on ``device``, CUDA unless the caller passes another, and
    so is the cache pool.  ``mesh`` and ``plan`` place the engine (module
    docstring).
    """

    @torch.no_grad()
    def __init__(self, cfg, qparams, *, max_len: int = 256,
                 controller: Optional[BudgetController] = None,
                 policy: Optional[PrecisionPolicy] = None,
                 mesh=None, n_slots: int = 4, prefill_len: int = 32,
                 decode_block: int = 8, eos_id: Optional[int] = None,
                 seed: int = 0, prefix_cache: Optional[PrefixCache] = None,
                 spec_k: Optional[int] = None,
                 draft_budget_s: Optional[float] = None, plan=None,
                 device="cuda"):
        self.cfg = cfg
        # speculative decoding: spec_k=None disables it; an int enables
        # self-drafting at that default depth (a FluidController overrides
        # it per admission through draft_depth()).  draft_budget_s picks the
        # draft bit configuration through the same controller tables
        # (None -> 0.0 -> the cheapest config).
        if spec_k is not None:
            if not 0 <= spec_k <= SPEC_K_MAX:
                raise ValueError(
                    f"spec_k={spec_k} not in [0, {SPEC_K_MAX}]")
            if cfg.sliding_window:
                raise ValueError(
                    "speculative decoding needs a non-wrapping KV ring; "
                    "sliding_window models must serve with spec_k=None")
            if cfg.family not in lm.SPEC_CHUNK_FAMILIES:
                raise ValueError(
                    f"speculative decoding needs the chunked verify path; "
                    f"family {cfg.family!r} is unsupported "
                    f"(supported: {lm.SPEC_CHUNK_FAMILIES})")
        self.spec_k = spec_k
        self._draft_budget_f = (0.0 if draft_budget_s is None
                                else float(draft_budget_s))
        self._draft_bits_c = None
        self._draft_price = None
        self._draft_idx = -1            # config index the draft caches hold
        self._draft_price_idx = -1
        self._draft_wbits_f = 0.0       # mean weight bits of that config
        self.device = cm.resolve_device(device)
        self.max_len = max_len
        self.n_slots = n_slots
        self.prefill_len = prefill_len
        self.decode_block = decode_block
        self.eos_id = eos_id
        n = lm.n_bit_slots(cfg)
        if controller is None:
            p = policy or _default_policy()
            controller = BudgetController({p.name: p}, {p.name: 0.0}, n)
        if (controller.budget_axis != "latency"
                and not isinstance(controller, FluidController)):
            # a FluidController may run its SLO loop on the energy or EDP
            # axis (request budgets then live on that axis too); an
            # open-loop controller there is a wiring fault
            raise ValueError(
                f"ServeEngine budgets are LATENCY budgets (seconds) but the "
                f"controller's prediction table lives on the "
                f"{controller.budget_axis!r} axis — its budgets would "
                f"always- or never-fit; build the controller with latency "
                f"predictions, or use a FluidController for an energy/EDP "
                f"SLO loop")
        super().__init__(controller, n, gemms=lm.layer_gemm_dims(cfg),
                         head=lm.head_gemm_dims(cfg), mesh=mesh, plan=plan)
        # this rank's block of slots under the row split (None off a mesh)
        self._rows = self._row_split(n_slots, "slots")
        self._sl = slice(*self._rows) if self._rows else slice(None)
        self._noise_rows = (self._rows + (n_slots,) if self._rows
                            else None)
        self.qparams = self.place(_to(qparams, self.device))
        self._collective = self.collective(self.qparams)
        # prefix-cache entry key -> the data rank holding its row (None:
        # every rank holds it)
        self._holder: Dict[bytes, Optional[int]] = {}
        self.budget_s = torch.tensor(1e9, dtype=torch.float32)
        self.row_bits = cfg.family in lm.PER_ROW_BIT_FAMILIES
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        # cross-request prefix cache: only prompts that fit the cache ring
        # entirely are cacheable (a wrapped prefix would install an
        # incomplete row)
        self.prefix_cache = prefix_cache
        self._cache_sc = (min(max_len, cfg.sliding_window)
                          if cfg.sliding_window else max_len)

        # continuous-batching state (the pool is built on first admission)
        self.pool: Optional[lm.CachePool] = None
        self.slots = SlotTable(
            n_slots,
            tok=(np.int64, 0), t=(np.int64, 0),
            budget=(np.float64, 0.0),           # freed rows: cheapest bits
            temp=(np.float64, 0.0), topk=(np.int64, 0),
            remaining=(np.int64, 0),
            k=(np.int64, 0))                    # speculative draft depth
        self._just_finished: List[int] = []
        # model forwards run by the continuous API: request prefills,
        # decode and draft steps, verify chunks, partial-hit extension
        # steps
        self.calls = {"prefill": 0, "decode": 0, "draft": 0, "verify": 0,
                      "extend": 0}

    # ------------------------------------------------------------------
    # Shared plumbing
    # ------------------------------------------------------------------

    def set_budget(self, seconds) -> None:
        """A scalar batch budget, or a (B,) per-request budget vector."""
        self.budget_s = torch.as_tensor(seconds, dtype=torch.float32)

    def _bits(self):
        wv, av = self.controller.resolve(self.budget_s)
        if wv.ndim == 2 and not self.row_bits:
            raise NotImplementedError(
                f"per-request budgets need per-row bit support; family "
                f"{self.cfg.family!r} serves whole-batch budgets only "
                f"(supported: {lm.PER_ROW_BIT_FAMILIES})")
        return wv.to(self.device), av.to(self.device)

    def price_budget(self, budget_s: float):
        """Per-token AP cost of the configuration a scalar budget selects."""
        return self.price_bits(*self.controller.resolve(
            torch.tensor(budget_s, dtype=torch.float32)))

    def _draft_index(self) -> int:
        """Stacked-config index the drafts run at: the draft budget's base
        config, offset by a FluidController's autotuner shift
        (``observe_accept``), clamped into the config range."""
        base = self._host_index(self._draft_budget_f)
        shift = int(getattr(self.controller, "draft_shift", 0) or 0)
        n = self.host_tables()[0].shape[0]
        return min(max(base + shift, 0), n - 1)

    def _draft_bits(self):
        """Device-side draft bit matrix (n_slots, L): the draft config
        broadcast across rows, cached per config index."""
        idx = self._draft_index()
        if self._draft_bits_c is None or idx != self._draft_idx:
            wtab, atab = self.controller.stacked_tables()
            wv = wtab[idx].expand(self.n_slots, -1)[self._sl].to(self.device)
            av = atab[idx].expand(self.n_slots, -1)[self._sl].to(self.device)
            self._draft_bits_c = (wv, av)
            self._draft_idx = idx
            self._draft_wbits_f = float(np.mean(self.host_tables()[0][idx]))
            self._draft_price = None
        return self._draft_bits_c

    def _draft_pricing(self):
        """Per-token AP cost of one draft step at the draft bits (cached
        per config index)."""
        idx = self._draft_index()
        if self._draft_price is None or idx != self._draft_price_idx:
            wtab, atab = self.host_tables()
            self._draft_price = self.price_bits(wtab[idx], atab[idx])
            self._draft_price_idx = idx
            self._draft_wbits_f = float(np.mean(wtab[idx]))
        return self._draft_price

    def _resolve_draft_k(self, req: Request) -> int:
        """Draft depth for one admission: the request's explicit
        ``draft_k``, else the FluidController's headroom-scaled depth,
        else the engine default (spec_k=None disables)."""
        if req.draft_k is not None:
            return int(req.draft_k)
        if self.spec_k is None:
            return 0
        if isinstance(self.controller, FluidController):
            return min(self.controller.draft_depth(), SPEC_K_MAX)
        return self.spec_k

    # ------------------------------------------------------------------
    # The engine's programs, run eagerly
    # ------------------------------------------------------------------

    def _prefill_row(self, tokens, length, wv, av, prefix=None):
        """One request's right-padded (1, prefill_len) prefill into a
        fresh single-row cache, behind its vlm ``prefix`` (1, P, d) if it
        has one; returns (logits (1, 1, V), row cache)."""
        self.calls["prefill"] += 1
        cache = lm.empty_cache(self.cfg, 1, self.max_len, device=self.device,
                               mesh=self.mesh, split_rows=False)
        batch = {"tokens": tokens}
        if prefix is not None:
            batch["prefix"] = prefix
        return lm.prefill(self.qparams, batch, self.cfg, wv, av, cache,
                          lengths=length)

    def _decode_block(self, tok, t, cache, wv, av, temp, topk, steps):
        """``steps`` decode steps with per-row sampling; returns the last
        token (B, 1), the next positions and the tokens (B, steps)."""
        out = []
        for _ in range(steps):
            logits, cache = lm.decode_step(self.qparams, tok, t, cache,
                                           self.cfg, wv, av)
            nxt = _sample_tokens(logits[:, -1], self.gen, temp, topk,
                                 self._noise_rows)
            tok, t = nxt[:, None], t + 1
            out.append(nxt)
        self.calls["decode"] += steps
        return tok, t, torch.stack(out, dim=1)

    def _draft_scan(self, tok, t, cache, wv, av, temp, topk, steps):
        """Speculative self-draft: ``steps`` decode steps at the draft
        bits.  Returns the drafts (B, SPEC_K_MAX) and each draft's
        sampling density (B, SPEC_K_MAX, V), the rejection test's q;
        positions past ``steps`` repeat the last draft with density 0
        (no row can accept them)."""
        toks, probs = [], []
        for _ in range(steps):
            logits, cache = lm.decode_step(self.qparams, tok, t, cache,
                                           self.cfg, wv, av)
            flat = logits[:, -1].float()
            nxt = _sample_tokens(flat, self.gen, temp, topk, self._noise_rows)
            probs.append(torch.softmax(_scaled_logits(flat, temp, topk),
                                       dim=-1))
            toks.append(nxt)
            tok, t = nxt[:, None], t + 1
        self.calls["draft"] += steps
        pad = SPEC_K_MAX - steps
        toks += [toks[-1]] * pad
        probs += [torch.zeros_like(probs[-1])] * pad
        return torch.stack(toks, dim=1), torch.stack(probs, dim=1)

    def _spec_verify(self, tok, draft_toks, draft_probs, t, cache, wv, av,
                     k_eff, temp, topk):
        """The verify: one (SPEC_K_MAX + 1)-wide chunk scores the current
        token and every draft at each row's own bits, overwriting the
        draft-bit cache entries.  Greedy rows accept the longest
        exact-argmax prefix; sampled rows run rejection resampling against
        the draft densities (accept u < p/q, resample the first rejection
        from normalize(max(p - q, 0)), a bonus draw from p on full
        accept).  ``k_eff`` (B,) clamps each row's acceptance.  Returns
        (next token (B,), next positions, emitted (B, U), count a + 1,
        keep watermark t + a)."""
        self.calls["verify"] += 1
        B, K = draft_toks.shape
        U = K + 1
        dev = tok.device
        toks = torch.cat([tok, draft_toks], dim=1)               # (B, U)
        logits, _ = lm.decode_chunk(self.qparams, toks, t, cache, self.cfg,
                                    wv, av)
        logits = logits.float()
        ver = logits.argmax(dim=-1).to(torch.int32)              # (B, U)
        p = torch.softmax(_scaled_logits(
            logits.reshape(B * U, -1), temp.repeat_interleave(U),
            topk.repeat_interleave(U)), dim=-1).reshape(B, U, -1)
        idx = draft_toks.long()[..., None]
        p_g = torch.gather(p[:, :K], 2, idx)[..., 0]             # (B, K)
        q_g = torch.gather(draft_probs, 2, idx)[..., 0]
        u = _uniform(self.gen, (self.n_slots, K))[self._sl]
        ok = torch.where(temp[:, None] > 0,
                         u * q_g.clamp_min(1e-20) < p_g,         # u < p/q
                         draft_toks == ver[:, :K])
        ok &= torch.arange(K, device=dev)[None] < k_eff[:, None]
        a = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)  # (B,)
        rows = torch.arange(B, device=dev)
        p_a = p[rows, a]
        q_pad = torch.cat([draft_probs, torch.zeros_like(draft_probs[:, :1])],
                          dim=1)
        q_a = q_pad[rows, a]
        resid = torch.where((a < k_eff)[:, None],
                            (p_a - q_a).clamp_min(0.0), p_a)
        tot = resid.sum(dim=-1, keepdim=True)
        rdist = torch.where(tot > 0, resid / tot.clamp_min(1e-30), p_a)
        extra = torch.where(temp > 0,
                            _categorical(torch.log(rdist + 1e-30), self.gen,
                                         self._noise_rows),
                            ver[rows, a])
        emitted = torch.where(
            torch.arange(U, device=dev)[None] < a[:, None],
            torch.cat([draft_toks, draft_toks[:, -1:]], dim=1),
            extra[:, None])                                      # (B, U)
        # extra is the round's last delivered token, the next round's
        # input; t + a is the rollback watermark
        return extra, t + a + 1, emitted, a + 1, t + a

    def _sample_first(self, logits, temp, topk, rows=None):
        return _sample_tokens(logits[:, -1], self.gen, temp, topk, rows)

    def _extend_row(self, tokens, row, start: int, r: int, wv, av):
        """Partial prefix-cache hit: ``row`` (an entry's single-row cache)
        holds a longer or equal prompt.  A clone of it is masked down to
        its first ``start`` tokens, then the remaining ``r`` prompt tokens
        run through ``lm.decode_step`` at positions start..start+r-1.
        Returns (the last step's logits (1, 1, V), the extended row).  The
        entry itself is never written: decode writes its cache in
        place."""
        self.calls["extend"] += r
        row = {name: buf.clone() for name, buf in row.items()}
        row["kpos"].masked_fill_(row["kpos"] >= start, EMPTY_POS)
        for pos in range(start, start + r):
            logits, row = lm.decode_step(self.qparams,
                                         tokens[:, pos:pos + 1], pos, row,
                                         self.cfg, wv, av)
        return logits, row

    # ------------------------------------------------------------------
    # Whole-batch API
    # ------------------------------------------------------------------

    @torch.no_grad()
    def generate(self, batch: Dict[str, torch.Tensor], steps: int, *,
                 temperature=None, top_k=None, fused: bool = True
                 ) -> torch.Tensor:
        """Generate ``steps`` tokens for one synchronous batch; returns
        (B, steps) int32 ids on the engine's device.  Greedy unless
        per-row temperature/top_k are given.  A vlm batch carries
        ``batch["prefix"]`` (B, n_prefix_tokens, d_model), an encdec batch
        ``batch["frames"]`` (B, F, d_model)."""
        if isinstance(self.controller, FluidController):
            # the whole-batch path has no admissions to charge: it would
            # silently run the fluid controller open-loop
            raise ValueError(
                "the whole-batch generate() API is open-loop; a "
                "FluidController's SLO window is only charged by the "
                "continuous scheduler — use submit()/run()")
        with self.compute_ctx():
            return self._generate(batch, steps, temperature, top_k, fused)

    def _generate(self, batch, steps, temperature, top_k, fused):
        # eager execution: fused=True and fused=False run the same loop
        del fused
        dev = self.device
        tokens = torch.as_tensor(batch["tokens"]).to(dev)
        B, S = tokens.shape
        # this data rank's block of the batch's rows (None: every row)
        split = self._row_split(B, "rows")
        sl = slice(*split) if split else slice(None)
        noise = split + (B,) if split else None
        inputs = {"tokens": tokens[sl]}
        prefix = 0
        if self.cfg.family == "vlm":
            prefix = self.cfg.n_prefix_tokens
            self._check_prefix(batch.get("prefix"), (B, prefix,
                                                     self.cfg.d_model))
            inputs["prefix"] = torch.as_tensor(batch["prefix"]).to(dev)[sl]
        elif self.cfg.family == "encdec":
            frames = batch.get("frames")
            shape = None if frames is None else tuple(frames.shape)
            if shape is None or len(shape) != 3 or shape[0] != B \
                    or shape[1] < 1 or shape[2] != self.cfg.d_model:
                raise ValueError(f"encdec batches need frames of shape "
                                 f"(B={B}, F, d_model={self.cfg.d_model}), "
                                 f"got {shape}")
            inputs["frames"] = torch.as_tensor(frames).to(dev)[sl]
        temp = torch.zeros((B,), dtype=torch.float32, device=dev) \
            if temperature is None else torch.as_tensor(
                temperature, dtype=torch.float32).to(dev).expand(B)
        if top_k is not None and int(np.max(np.asarray(top_k))) > TOPK_MAX:
            raise ValueError(f"top_k exceeds TOPK_MAX={TOPK_MAX}")
        topk = torch.zeros((B,), dtype=torch.int32, device=dev) \
            if top_k is None else torch.as_tensor(
                top_k, dtype=torch.int32).to(dev).expand(B)
        temp, topk = temp[sl], topk[sl]
        wv, av = self._bits()
        if wv.ndim == 2:                        # shard_bits: (B, L) rows
            wv, av = wv[sl], av[sl]
        cache = lm.empty_cache(self.cfg, B, self.max_len, device=dev,
                               mesh=self.mesh)
        with kops.split_rows(self.mesh if split else None):
            logits, cache = lm.prefill(self.qparams, inputs, self.cfg, wv,
                                       av, cache)
            tok = self._sample_first(logits, temp, topk, noise)[:, None]
            t = torch.full((tok.shape[0],), S + prefix, dtype=torch.int32,
                           device=dev)
            out = [tok]
            for _ in range(steps - 1):
                logits, cache = lm.decode_step(self.qparams, tok, t, cache,
                                               self.cfg, wv, av)
                tok = _sample_tokens(logits[:, -1], self.gen, temp,
                                     topk, noise)[:, None]
                t = t + 1
                out.append(tok)
        self.stats.tokens += B * steps
        out = torch.cat(out, dim=1)
        return self.mesh.gather_rows(out).to(dev) if split else out

    @staticmethod
    def _check_prefix(prefix, shape) -> None:
        if prefix is None:
            raise ValueError(f"vlm requests need a prefix {shape[1:]} "
                             f"(n_prefix_tokens, d_model)")
        if tuple(prefix.shape) != tuple(shape):
            raise ValueError(f"prefix shape {tuple(prefix.shape)} != "
                             f"{tuple(shape)}")

    # ------------------------------------------------------------------
    # Continuous-batching API
    # ------------------------------------------------------------------

    @torch.no_grad()
    def submit(self, prompt, *, max_new_tokens: int = 16,
               budget_s: Optional[float] = None, temperature: float = 0.0,
               top_k: int = 0, prefix=None,
               rep_key: Optional[int] = None,
               draft_k: Optional[int] = None) -> int:
        """Enqueue a request; returns its id.  ``budget_s`` caps this
        request's precision configuration (None = loosest, most accurate;
        under a FluidController the closed loop may tighten it further).
        vlm models require ``prefix`` (n_prefix_tokens, d_model).
        ``rep_key`` threads a traffic repetition key to the prefix cache
        (hits are content-keyed either way; the key feeds the
        repetition-aware eviction value).  ``draft_k`` overrides the
        speculative draft depth for this request (0 = vanilla decode;
        None = the engine/controller decides)."""
        if self.cfg.family not in lm.RAGGED_PREFILL_FAMILIES:
            raise NotImplementedError(
                f"the continuous-batching API needs ragged prefill; family "
                f"{self.cfg.family!r} serves via generate() only "
                f"(supported: {lm.RAGGED_PREFILL_FAMILIES})")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if not 1 <= prompt.shape[0] <= self.prefill_len:
            raise ValueError(f"prompt length {prompt.shape[0]} not in "
                             f"[1, {self.prefill_len}]")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens={max_new_tokens} must be >= 1")
        prefix_len = (self.cfg.n_prefix_tokens
                      if self.cfg.family == "vlm" else 0)
        if (prefix_len + self.prefill_len + max_new_tokens > self.max_len
                and not self.cfg.sliding_window):
            raise ValueError("prefix + prefill_len + max_new_tokens "
                             "exceeds max_len (KV ring would wrap)")
        if top_k > TOPK_MAX:
            raise ValueError(f"top_k={top_k} exceeds TOPK_MAX={TOPK_MAX}")
        if draft_k is not None and not 0 <= draft_k <= SPEC_K_MAX:
            raise ValueError(f"draft_k={draft_k} not in [0, {SPEC_K_MAX}]")
        # speculative rounds write up to SPEC_K_MAX positions past the
        # accepted point before rollback: the KV ring must never wrap
        # under them (wrapped slots would expose stale-lap entries to the
        # chunked verify), whenever this request could draft
        spec_possible = (draft_k or 0) > 0 or (
            draft_k is None and self.spec_k is not None
            and (self.spec_k > 0
                 or isinstance(self.controller, FluidController)))
        if spec_possible:
            if self.cfg.sliding_window:
                raise ValueError(
                    "speculative decoding needs a non-wrapping KV ring; "
                    "sliding_window requests must submit draft_k=0")
            if self.cfg.family not in lm.SPEC_CHUNK_FAMILIES:
                raise ValueError(
                    f"speculative decoding unsupported for family "
                    f"{self.cfg.family!r} "
                    f"(supported: {lm.SPEC_CHUNK_FAMILIES})")
            if (prefix_len + self.prefill_len + max_new_tokens
                    + SPEC_K_MAX > self.max_len):
                raise ValueError(
                    "prefix + prefill_len + max_new_tokens + SPEC_K_MAX "
                    "exceeds max_len (a speculative round could wrap the "
                    "KV ring); submit draft_k=0 or shrink the request")
        if self.cfg.family == "vlm":
            if torch.is_tensor(prefix):
                prefix = prefix.float().cpu().numpy()
            elif prefix is not None:
                prefix = np.asarray(prefix, np.float32)
            self._check_prefix(prefix, (prefix_len, self.cfg.d_model))
        rid = self.next_rid()
        req = Request(rid, prompt, max_new_tokens,
                      None if budget_s is None else float(budget_s),
                      float(temperature), int(top_k), prefix=prefix,
                      rep_key=rep_key, draft_k=draft_k)
        record = RequestStats(
            rid=rid,
            budget_s=(float(budget_s) if budget_s is not None
                      else UNCONSTRAINED_BUDGET),
            prompt_len=int(prompt.shape[0]), submitted_s=time.time())
        est_scale = 1.0
        if self._cacheable(req):
            # the admission planner sees the predicted hit: the modeled EDP
            # is discounted by the predicted cached fraction, so likely hits
            # admit earlier (they really are cheaper to serve)
            total = prompt.shape[0] + max_new_tokens
            est_scale = max(total - self.prefix_cache.peek(prompt),
                            1) / total
        return self.new_record(record, req, budget_s, est_scale=est_scale)

    def _ensure_pool(self) -> lm.CachePool:
        if self.pool is None:
            self.pool = lm.CachePool(self.cfg, self.n_slots, self.max_len,
                                     device=self.device, rows=self._rows,
                                     mesh=self.mesh)
        return self.pool

    def _cacheable(self, req: Request) -> bool:
        return (self.prefix_cache is not None and req.prefix is None
                and req.prompt.shape[0] <= self._cache_sc)

    def _admit(self) -> List[int]:
        """Move queued requests into free pool slots, in the runtime's
        EDP-aware, starvation-free admission order.  With a prefix cache,
        each admission consults it before prefilling: a full hit installs
        the cached row and reuses its stored logits (no prefill), a
        partial hit installs the shared prefix and extends the rest
        through the decode path, and a miss prefills its own padded row
        and stores or refreshes the entry.  Only the miss fraction is
        charged to a FluidController.  Sampling the first token is the
        one host sync per admission.  Under the row split only the slot's
        owner prefills (:meth:`_first_token`)."""
        pool = self._ensure_pool()
        dev = self.device
        admitted = []
        while self.queued and pool.free_slots:
            req: Request = self.next_admission()
            record = self.requests[req.rid]
            record.admitted_s = time.time()
            slot = pool.alloc()
            S = req.prompt.shape[0]
            # a vlm request's prefix sits in front of its prompt (a request
            # with a prefix never hits the prefix cache)
            vlm = self.cfg.family == "vlm"
            prefix_len = self.cfg.n_prefix_tokens if vlm else 0
            planned = S + req.max_new_tokens
            hit = wv_np = av_np = None
            # the effective budget first: the prefix cache's precision gate
            # and the speculative plan's pricing both need the bits before
            # anything is charged
            eff = self.admission_budget(req.budget_s)
            if self._cacheable(req):
                wv_np, av_np = self.host_bits(eff)
                hit = self.prefix_cache.lookup(
                    req.prompt, wv_np, av_np, rep_key=req.rep_key)
            cached = hit.keep if hit is not None else 0
            # speculative plan: draft + verify pricing for the planned
            # rounds (full acceptance; finish_record reconciles)
            k_req = self._resolve_draft_k(req)
            spec = None
            if k_req > 0 and req.max_new_tokens > 1:
                swv, sav = self.host_bits(eff)
                spec = (k_req, self._draft_pricing(),
                        self.price_verify_bits(swv, sav, k_req + 1),
                        -(-(req.max_new_tokens - 1) // (k_req + 1)),
                        req.max_new_tokens - 1)
            else:
                k_req = 0
            wv, av = self.admit_record(record, req.budget_s, planned,
                                       eff=eff,
                                       charge_units=planned - cached,
                                       spec=spec)
            wv, av = wv.to(dev), av.to(dev)
            if hit is not None:
                record.cached_units = cached
                record.cache_hit = "full" if hit.full else "partial"
                record.cached_cost = self.price_bits(hit.entry.wbits,
                                                     hit.entry.abits)
                record.cached_mean_wbits = float(np.mean(hit.entry.wbits))
                self.prefix_cache.ledger.prefill_edp_saved_js += \
                    record.prefill_edp_saved_js
            tokens = np.zeros((1, self.prefill_len), np.int32)
            tokens[0, :S] = req.prompt
            tokens = torch.from_numpy(tokens).to(dev)
            # a forward runs on the slot's owner, or on every rank when
            # forwards are collectives of the mesh
            runs = pool.owns(slot) or self._collective
            if hit is not None:
                row, logits = self._entry_row(hit.entry, slot)
            if hit is not None and hit.full:
                # full hit: the cached row IS the prefill output at the
                # entry's bits; install it and reuse its stored logits
                pool.install_prefix(row, slot, S)
            elif hit is not None:
                # partial hit: extend a clone of the entry's row by the
                # uncached tail, then install it
                logits = row_cache = None
                if runs:
                    logits, row_cache = self._extend_row(
                        tokens, row, cached, S - cached, wv, av)
                pool.write_row(row_cache, slot, S)
                # refresh only when precision-pure: the extended row mixes
                # the entry's bits (prefix) with the resolved bits (tail)
                # unless they match
                if (np.array_equal(hit.entry.wbits, wv_np)
                        and np.array_equal(hit.entry.abits, av_np)):
                    self._store(req, row_cache, logits, wv_np, av_np,
                                record, slot)
            else:
                logits = row_cache = None
                if runs:
                    logits, row_cache = self._prefill_row(
                        tokens, torch.tensor([S], dtype=torch.int32).to(dev),
                        wv, av, torch.from_numpy(req.prefix[None]).to(dev)
                        if vlm else None)
                pool.write_row(row_cache, slot, S + prefix_len)
                if wv_np is not None:   # cacheable miss: store or refresh
                    self._store(req, row_cache, logits, wv_np, av_np,
                                record, slot)
            first0 = self._first_token(logits, slot, req)
            record.first_token_s = time.time()
            record.slot = slot
            record.tokens.append(first0)
            self.stats.tokens += 1
            self.slots.occupy(slot, req.rid, tok=first0, t=S + prefix_len,
                              budget=record.budget_s, temp=req.temperature,
                              topk=req.top_k,
                              remaining=req.max_new_tokens - 1, k=k_req)
            admitted.append(req.rid)
            if self.slots["remaining"][slot] <= 0 or (
                    self.eos_id is not None and first0 == self.eos_id):
                self._finish(slot)
        return admitted

    def _store(self, req: Request, row_cache, logits, wv_np, av_np,
               record, slot: int) -> None:
        """Store or refresh a prefix-cache entry, noting which data rank
        holds its row (None: every rank does)."""
        self.prefix_cache.store(req.prompt, row_cache, logits, wv_np, av_np,
                                record.ap_cost, rep_key=req.rep_key)
        holder = (None if self._rows is None or self._collective
                  else slot // (self._rows[1] - self._rows[0]))
        self._holder[self.prefix_cache.content_key(req.prompt)] = holder

    def _entry_row(self, entry, slot: int):
        """(row cache, logits) of a prefix-cache entry on ``slot``'s owner
        (None on the other data ranks): a row that another data rank
        holds is broadcast to the owner, its logits with it."""
        holder = self._holder.get(entry.key)
        n = (self._rows[1] - self._rows[0]) if self._rows else 0
        if holder is None or holder == slot // n:
            return entry.row_cache, entry.logits
        pool = self.pool
        row = pool.move_row(entry.row_cache, holder, slot)
        mine = self.mesh.dp_index == holder
        shape = (1, 1, self.cfg.padded_vocab)
        logits = self.mesh.broadcast(
            entry.logits if mine else torch.empty(shape), holder,
            kind="move_row")
        owner = self.mesh.dp_index == slot // n
        return row, (logits.to(self.device) if owner else None)

    def _first_token(self, logits, slot: int, req: Request) -> int:
        """Sample an admission's first token (the per-admission host
        sync).  Under the row split a rank that does not own ``slot`` has
        no logits (unless forwards are collectives, when every rank has
        them): it draws the same noise, so the generator stays in
        lockstep on every rank, and takes the owner's token."""
        dev = self.device
        if logits is None:
            _uniform(self.gen, (1, self.cfg.padded_vocab))
            first = torch.zeros((1,), dtype=torch.int32)
        else:
            first = self._sample_first(
                logits, torch.tensor([req.temperature],
                                     dtype=torch.float32).to(dev),
                torch.tensor([req.top_k], dtype=torch.int32).to(dev))
        if self._rows is not None and not self._collective:
            n = self._rows[1] - self._rows[0]
            first = self.mesh.broadcast(first, src=slot // n)
        return int(first[0])

    def _finish(self, slot: int) -> None:
        rid = int(self.slots.rid[slot])
        self.finish_record(rid)
        self.slots.release(slot)
        self.pool.free(slot)
        self._just_finished.append(rid)

    def _has_active(self) -> bool:
        return bool(self.slots.active.any())

    def _active_count(self) -> int:
        return int(self.slots.active.sum())

    def _can_admit(self) -> bool:
        return self.n_slots >= 1

    @torch.no_grad()
    def step(self) -> List[int]:
        """One scheduler tick: admit into free slots, decode one block (or
        run one speculative round), harvest tokens, retire finished
        requests.  Returns the rids that completed during this tick."""
        with self.compute_ctx():
            return self._step()

    def _step(self) -> List[int]:
        self.age_queue()
        self._admit()
        slots = self.slots
        active = slots.active
        if active.any():
            # a round can accept at most remaining - 1 drafts (the +1
            # verified token must not overshoot max_new_tokens), so a
            # batch whose every row is clamped to 0 takes the vanilla block
            k_eff = np.where(
                active, np.minimum(slots["k"], slots["remaining"] - 1),
                0).astype(np.int64)
            if k_eff.max() > 0:
                self._spec_round(active, k_eff)
            else:
                self._decode_tick(active)
        done = self._just_finished
        self._just_finished = []
        return done

    def _batch_bits(self):
        """Per-slot budgets (frozen at admission) resolved to a bit matrix
        on the device: (n_slots, L), this rank's rows under the split."""
        wv, av = self.controller.resolve(
            torch.as_tensor(self.slots["budget"], dtype=torch.float32))
        return wv[self._sl].to(self.device), av[self._sl].to(self.device)

    def _slot_inputs(self):
        """Each slot's token, position and sampling params on the device
        (this rank's rows under the split)."""
        dev, slots, sl = self.device, self.slots, self._sl
        return (torch.as_tensor(slots["tok"][sl, None],
                                dtype=torch.int32).to(dev),
                torch.as_tensor(slots["t"][sl], dtype=torch.int32).to(dev),
                torch.as_tensor(slots["temp"][sl],
                                dtype=torch.float32).to(dev),
                torch.as_tensor(slots["topk"][sl],
                                dtype=torch.int32).to(dev))

    def _mask_idle_rows(self, active, keep=None) -> None:
        """Roll back every cache entry of the rows that held no request
        during this tick (they decoded masked garbage), and, for the rest,
        past ``keep`` (the speculative watermark; None keeps all)."""
        if keep is None:
            if active.all():
                return
            keep = torch.full((self.n_slots,), EMPTY_POS, dtype=torch.int64,
                              device=self.device)
        idle = torch.as_tensor(~active).to(self.device)
        self.pool.rollback(torch.where(idle, -1, keep.long()))

    def _decode_tick(self, active) -> None:
        """Vanilla tick: one decode block for every slot, per-row bits."""
        pool = self.pool
        slots = self.slots
        wv, av = self._batch_bits()
        tok, t, temp, topk = self._slot_inputs()
        _, _, toks = self._decode_block(tok, t, pool.cache, wv, av, temp,
                                        topk, self.decode_block)
        self._mask_idle_rows(active)
        # one device-to-host copy a tick (every rank's rows under the
        # split, so the host state stays identical)
        toks_h = (self.mesh.gather_rows(toks) if self._rows is not None
                  else toks.cpu()).numpy()
        slots["tok"][:] = toks_h[:, -1].astype(np.int64)
        slots["t"][:] += self.decode_block
        for slot in np.nonzero(active)[0]:
            rid = int(slots.rid[slot])
            st = self.requests[rid]
            take = int(min(slots["remaining"][slot], self.decode_block))
            new = toks_h[slot, :take].tolist()
            if self.eos_id is not None and self.eos_id in new:
                new = new[:new.index(self.eos_id) + 1]
            st.tokens.extend(int(x) for x in new)
            self.stats.tokens += len(new)
            slots["remaining"][slot] -= take
            hit_eos = (self.eos_id is not None and new
                       and new[-1] == self.eos_id)
            if slots["remaining"][slot] <= 0 or hit_eos:
                self._finish(slot)

    def _spec_round(self, active, k_eff_h) -> None:
        """One speculative round for the whole batch: draft at the draft
        bits, verify the current token and the drafts in one chunk at
        each row's own bits, deliver the longest accepted prefix plus
        one token, and roll the rejected cache entries back.  Rows with
        k_eff == 0 ride along and deliver their one verified token."""
        pool = self.pool
        slots = self.slots
        wv, av = self._batch_bits()
        dwv, dav = self._draft_bits()
        tok, t, temp, topk = self._slot_inputs()
        k_eff = torch.as_tensor(k_eff_h[self._sl],
                                dtype=torch.int64).to(self.device)
        draft_toks, draft_probs = self._draft_scan(
            tok, t, pool.cache, dwv, dav, temp, topk, int(k_eff_h.max()))
        nxt, t_next, emitted, count, keep = self._spec_verify(
            tok, draft_toks, draft_probs, t, pool.cache, wv, av, k_eff,
            temp, topk)
        # one device-to-host copy a round (every rank's rows under the
        # split, so the host state stays identical)
        out = torch.cat([nxt[:, None].long(), t_next[:, None].long(),
                         count[:, None].long(), keep[:, None].long(),
                         emitted.long()], dim=1)
        out = (self.mesh.gather_rows(out) if self._rows is not None
               else out.cpu()).numpy()
        self._mask_idle_rows(active, torch.from_numpy(out[:, 3]).to(
            self.device))
        slots["tok"][:] = out[:, 0]
        slots["t"][:] = out[:, 1]
        for slot in np.nonzero(active)[0]:
            rid = int(slots.rid[slot])
            st = self.requests[rid]
            take = int(out[slot, 2])            # a + 1 <= remaining
            new = out[slot, 4:4 + take].tolist()
            if self.eos_id is not None and self.eos_id in new:
                new = new[:new.index(self.eos_id) + 1]
            st.tokens.extend(int(x) for x in new)
            self.stats.tokens += len(new)
            slots["remaining"][slot] -= take
            k_req = int(slots["k"][slot])
            if k_req > 0:
                # per-round actuals at the request's chosen depth
                st.spec_rounds += 1
                st.draft_units += k_req
                st.verify_units += k_req + 1
                st.accepted_units += take - 1
                st.spec_tokens += len(new)
                st.draft_wbits = self._draft_wbits_f
                if isinstance(self.controller, FluidController):
                    # close the draft-bit loop: this round's accept rate
                    # feeds the EMA that may shift the next round's draft
                    # config
                    self.controller.observe_accept((take - 1) / k_req)
            hit_eos = (self.eos_id is not None and new
                       and new[-1] == self.eos_id)
            if slots["remaining"][slot] <= 0 or hit_eos:
                self._finish(slot)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)

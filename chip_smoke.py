#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and hold its
hand-written kernels against their plain PyTorch versions.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --paths 8  # some paths only, no result lines

Sixteen paths, each at full width with random weights from a seed:

* bit-fluid ResNet18 serving (224x224x3 images, 1000 classes): each
  image's EDP budget resolves through the HAWQ-V3 budget controller into a
  per-layer bit vector, every conv/fc GEMM runs through the bit-plane
  kernel once per bit family, and the AP cost model prices each image;
* AlexNet (227x227x3, 1000 classes, three grouped convs), B=16:
  (a) bit-fluid serving on the energy-axis int4/int8 controller, every
  GEMM on the bit-grouped path and each grouped conv group by group
  through the bit-plane kernel; (b) the fixed-INT4 container-width
  forward (int4 containers, no bit vectors): the five ungrouped layers
  through the packed-int4 kernel, the grouped int8 stacks through the
  bit-plane kernel; (c) the forward's int8 GEMMs through the
  fused-epilogue entry ``ops.quant_matmul``;
* bit-fluid Qwen3-4B serving through ``ServeEngine.generate`` (36 layers,
  d_model 2560, GQA 32/8, d_ff 9728, vocab 151936): four 4096-token
  prompts whose latency budgets resolve to int4, mixed, int8 and int8;
  prefill runs every layer's self-attention through the flash kernel and
  every linear through the bit-plane kernel, then 1 token decodes on
  the bf16 KV cache;
* the same Qwen3-4B by continuous batching (``ServeEngine.submit`` /
  ``submit_at`` / ``run``): (a) 9 requests (prompts of 64 to 1024
  tokens, 4 to 6 new tokens, budgets cycling int4, mixed, int8) through
  8 slots, each prompt prefilled alone on a (1, 1024) row and every tick
  decoding 8 tokens for all slots at once; (b) 4 of them again, each to
  its first 4 new tokens, with speculative decoding (4 int4 drafts a
  round, verified in one chunk of
  9 positions per row; one request at draft_k=0).  The bit-plane kernel
  runs at M = 1024, 8 and 72;
* the prefix cache and the closed loop, replayed from seeded traces
  through ``serve.traffic.TraceReplayer``: (a) the same Qwen3-4B engine
  shape, cut to its first layer, with ``PrefixCache(chunk=64)`` on a Poisson trace with repeated
  keys (512-1024-token prompts, int8), plus four late prompts that
  share the first two keys' prefixes, so misses, full hits and partial
  hits (extended token by token through ``decode_step``, the bit-plane
  kernel at M = 1) all occur, and the same replay without the cache;
  (b) the cached replay under an EDP-axis ``FluidController`` whose SLO
  is 0.6 of what the uncached run charges; (c) ResNet18@224 under a
  traffic spike, open loop and through a tick-windowed FluidController;
* placement and row scale-out: two data ranks, spawned processes that
  share the card in one gloo group (``repro_torch.dist.DataMesh``),
  serve with ``plan="auto"`` (fully replicated: every rank holds every
  weight): (a) path 4 (a)'s Qwen3-4B requests, each rank decoding its 4
  of the 8 slots (the bit-plane GEMV at M = 4); (b) path 1's ResNet18
  batch, 8 rows a rank; and on one rank, (c) partial plans (4 devices,
  1.5 model copies) for both models, and path 5 (c)'s spike through a
  tick-windowed FluidController with the ResNet18 plan and without it,
  at one SLO;
* the MoE family, vlm prefixes and the int8 KV cache: (a)
  Moonshot-v1-16B-A3B (48 layers, d_model 2048, 16 heads of 128, 64
  experts top-6 plus 2 shared, d_ff 1408, vocab 163840), its int8 serve
  form drawn and quantized layer by layer (``lm.init_serve_params``),
  through ``ServeEngine.generate``: B=2 prompts of 4096 tokens, 2 new,
  at the tightest (int4) and the loosest (int8) whole-batch budget;
  every expert stack through the bit-plane kernel, one launch per
  expert (9553 a forward), flash at hd 128; (b) InternVL2-1B (24 layers,
  d_model 896, GQA 14/2 of hd 64, qkv bias, tied embeddings, 256 prefix
  tokens as seeded patch embeddings): ``generate`` on B=4 prompts of
  4096 tokens behind their prefixes, 2 new (flash at hd 64, budgets
  int4, mixed, int8, int8), 6 requests of 4 new tokens with prefixes by
  continuous batching
  (4 slots, ``prefill_len=1024``, a prefix cache the prefixes bypass),
  and 4 of them with ``spec_k=4``; (c) the same with the int8 KV cache
  (``kv_cache_bits=8``);
* the recurrent families, encoder-decoder cross-attention and flash at
  head dim 160, each through ``ServeEngine.generate`` at full width and
  depth with 2 new tokens: (a) mamba2-1.3b (48 layers, d_model 2048,
  state 128, chunk 128; the SSD in f32 PyTorch, the in and out
  projections through the bit-plane kernel), B=4 prompts of 4096 tokens
  at per-request budgets int4, mixed, int8, int8; (b) zamba2-2.7b (54
  Mamba2 layers in 9 super-blocks, each behind the shared attention
  block, 32 heads of 80, with its per-site LoRA), B=2 x 4096 at one
  whole-batch budget, flash at hd 80 padded to 128; (c)
  seamless-m4t-medium (12 + 12 layers, d_model 1024, 16 heads of 64,
  vocab 256206), B=2 x 8192 decoder tokens behind 2048 seeded frame
  embeddings: the encoder on SDPA, the decoder's self-attention on flash
  (causal) and its cross-attention on flash (not causal, 8192 queries
  over 2048 keys); (d) stablelm-12b (40 layers, d_model 5120, GQA 32/8
  at hd 160, LayerNorm), B=2 x 4096 at int4 and int8 rows, flash at the
  kernel's 160-wide instantiation;
* training: (a) Qwen3-4B at full width and depth (``remat="full"``)
  through ``make_train_step``: AdamW with int8 first moments and
  factored second moments, wbits (8, 4) and abits (8,), 3 steps on one
  batch of 4 x 2049 tokens in two microbatches (every sequence at most
  FLASH_THRESHOLD, since the flash kernel has no backward); (b) one
  SMOKE train step of each of the six families on the card against the
  CPU, and a checkpoint round trip; (c) the flash refusal; (d) the
  trained weights quantized and served through ``generate`` (2 prompts
  of 256 tokens at int4 and int8, 4 new), the bit-plane kernel on
  weights that training produced;
* the serving entry points and the rest of the bit-fluid core: (a)
  ``python -m repro_torch.launch.serve`` on Qwen3-4B FULL, called in
  process through ``main(argv)``: 6 continuous requests (256-token
  prompts, 4 new, 4 slots) and ``--batch`` (2 x 2304-token prompts, so
  the lock-step prefill takes flash, 4 new); (b) its ``--slo-edp``,
  ``--kv-bits 8``, ``--batch`` and continuous modes at SMOKE size on a
  checkpoint ``repro_torch.launch.train`` writes, card vs CPU; (c)
  ``launch/serve_torch.py`` (a spike trace; a Poisson trace through the
  prefix cache), card vs CPU; (d) the AP emulator at 4096 rows, and its
  ``ap_matmul`` against the bit-plane kernel; (e) ``ops.fluid_linear`` at
  wbits 1..8 and the vmap row dispatch against the grouped one; (f) the
  three examples, card vs CPU.
* sharded serving: two ranks on ``cuda:0`` in one gloo group, the same
  world as a ("data", "model") = (1, 2) and a (2, 1) mesh
  (``repro_torch.launch.mesh.make_host_mesh``): (a) Qwen3-4B FULL with
  no plan (tensor parallelism: Megatron linears, attention and flash on
  each rank's heads, the vocab-sharded embedding and tied head),
  ``generate`` at 2 x 2304 tokens at budget 0.5, and 3
  continuous requests of 256-token prompts; (b) the same requests on
  (2, 1) with FSDP weights and with a partial plan; (c)
  Moonshot-v1-16B-A3B at full width, its first 4 layers, expert-parallel
  on (1, 2) (32 experts a rank), ``generate`` at 2 x 512 tokens; (d)
  ResNet18@224 on both meshes; (e) SMOKE speculation and prefix hits
  whose rows cross ranks on (2, 1), and n_kv_heads=1 on (1, 2); (f)
  Qwen3-4B FULL at B=1 on (2, 1): one row does not split over two data
  ranks, so the cache's sequence does (the sequence-sharded KV cache),
  ``generate`` of a 2304-token prompt and 4 new tokens;
* sharded training: two ranks on ``cuda:0`` in one gloo group, the same
  world as a (1, 2) and a (2, 1) mesh, each through ``make_train_step``
  with parameters and AdamW state placed by ``dist.sharding`` and
  gradients through the collectives: (a) Qwen3-4B FULL, all 36 layers,
  tensor-parallel on (1, 2), path 9's optimizer and bits, 2 steps on one
  batch of 4 x 513 tokens in two microbatches; (b) its first 2 layers,
  FSDP on (2, 1), the same steps; (c) (a)'s trained state saved from
  (1, 2) and restored onto one device and onto (2, 1); (d) the restored
  weights quantized and served on (1, 2), ``generate`` 2 x 256, 4 new;
  (e) Moonshot-v1-16B-A3B at full width, its first layer,
  expert-parallel training on (1, 2), 2 steps of 2 x 257 tokens; (f)
  SMOKE mesh steps card vs CPU (dense, vlm, MoE), and
  ``python -m repro_torch.launch.train --smoke --tp 2`` killed after a
  checkpoint and resumed on two ranks.
* the analysis suite on the card: (a) ``python -m
  repro_torch.launch.analyze --all --device cuda`` in a subprocess,
  which a whole run starts beside paths 1-6 (lint,
  ledger and the sharding checker of all ten FULL configs, fake, on the
  host; the retrace audit of every SMOKE config and the HAWQ-V3 ResNet18
  matrix on ``cuda:0``, its signatures holding the kernels'
  specialisations); (b) Qwen3-4B FULL on path 3's weights: ``generate``
  of 2 x 2304 tokens and 1 new (flash) at each of path 3's budgets, and
  a prefill row and a decode block at every budget and budget mix on
  path 4's slots and prefill length (a block of 1 step), each call's
  aten op stream and kernel specialisations recorded;
  (c) ResNet18@224, B=16, at every HAWQ-V3 configuration of Table VII;
  (d) one continuous ``step()`` and one speculative round of (b)'s
  engine under ``torch.cuda.set_sync_debug_mode("warn")``, every sync
  the card reports counted by where it ran.
* the lowering report (``repro_torch.launch.dryrun``) held against the
  card, on path 3's weights: (a) ``lm.prefill`` of 2 x 4096 tokens and
  one ``lm.decode_step`` on one card, predicted first by the same two
  calls on fake CUDA tensors (launches by key, argument bytes, peak
  memory, FLOPs and bytes by kernel); (b) path 11 (f)'s collectives
  predicted on a ``RecordingMesh`` (2, 1).
* the recurrent and encoder-decoder families on a mesh: two ranks on
  ``cuda:0`` in one gloo group, as a (1, 2) and a (2, 1) mesh, serve
  mamba2-1.3b (its first 2 layers), zamba2-2.7b (its first
  super-block, every LoRA ``b`` drawn non-zero) and
  seamless-m4t-medium (1 + 1 layers) at published widths through
  ``ServeEngine(mesh=).generate``: (a) tensor-parallel, 2 x 2304 tokens
  (seamless behind 2304 frames), 2 new, flash on each rank's heads; (b)
  FSDP with the rows split, and a B=1 row each of mamba2 (its state
  whole on both ranks) and zamba2 (the shared block's ring
  sequence-sharded).
* the same three families trained on a mesh: two ranks on ``cuda:0`` in
  one gloo group, as a (1, 2) and a (2, 1) mesh, train mamba2-1.3b (its
  first 4 layers), zamba2-2.7b (its first 2 super-blocks, every LoRA
  ``b`` drawn non-zero) and seamless-m4t-medium (2 + 2 layers) at
  published widths with ``remat="full"`` through ``make_train_step``:
  (a) tensor-parallel and (b) FSDP (mamba2's first 2 layers and
  zamba2's first super-block), each the first microbatch's gradient at
  16 bits, held block by block, and 2 steps of 4 x 513 tokens in two
  microbatches (path 9's optimizer and bits); (c) zamba2's (a) state saved from (1, 2) and
  restored onto (2, 1) and one device; (d) the trained weights quantized
  and served on (1, 2), ``generate`` 2 x 2304, 2 new (flash on each
  rank's heads for zamba2 and seamless); (e) ``python -m
  repro_torch.launch.train --arch mamba2_1_3b --smoke --tp 2`` beside
  the rest.
* the last cache layouts on a data mesh: two ranks on ``cuda:0`` in one
  gloo group as a (2, 1) mesh: (a) Qwen3-4B at published widths (its
  first 4 layers) by continuous batching on 3 slots, which do not split
  over two data ranks, so the pool shards its ring's sequence, with
  speculation and prefix-cache hits, on the bf16 and the int8 cache;
  then a ragged prefill and a U = 4 chunk on that layout; (b)
  seamless-m4t-medium at B = 1, its cross cache's frames split over the
  ranks; (c) ResNet18@224 at a batch of 3, every image on every rank.

Phases, in order; any failure ends the run with a nonzero exit and no
result line:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the four kernels from the checkout's sources (one nvcc each,
     run together), timed;
  3. the bit-plane kernel equals its plain version (torch.equal) for
     n_planes 1..8 on edge shapes; the flash kernel is within FLASH_TOL of
     its f32 oracle on edge shapes and at the LM path's shape; the int4
     kernel equals its plain version on edge shapes; the quant kernel
     equals its plain version for none and relu and is within QUANT_TOL
     for silu and gelu, at f32 and bf16 output; the three int8 GEMMs'
     edge shapes run both regimes (M = 16 and 17 at a split K);
  4. ResNet18: hold the kernel at every GEMM shape of the path, serve
     batches through CNNServeEngine (launch counts, logits equal to the
     plain-version forward, EDP equal to the AP model, a 32-px card-vs-CPU
     run), time the batch and every GEMM shape, trace one batch;
  5. AlexNet: hold every kernel at every GEMM shape of the path, run (a),
     (b) and (c) with launch counts per kernel and, for int4_matmul and
     quant_matmul, per regime (INT4_PATHS, QUANT_PATHS), logits equal to the
     plain-version forwards on the card, EDP equal to the AP model, 32-px
     card-vs-CPU runs equal; time the batch, the forward and every GEMM
     shape against its bound, plain version and torch._int_mm (int4 and
     quant on both clocks, with the regime each shape takes, and both
     sides of the regime threshold at fc6's width); trace one batch of (a)
     and one forward of (b);
  6. Qwen3-4B: hold the bit-plane kernel at the LM GEMM shapes, serve
     ``generate`` calls (launch counts per call, repeatable tokens), hold
     one prefill against the kernels' plain versions on the card (the
     bit-plane path exactly, flash on every layer's own q/k/v, and the
     logits as ``gate_logits`` says), check prices against the AP model
     and a SMOKE-size card-vs-CPU prefill, time prefill, decode, the
     flash kernel and the GEMM shapes against their bounds and library
     yardsticks, and trace one prefill and one decode step;
  7. continuous batching: the decode path's float reductions give a row
     the same bits among 1, 8 and 72 rows; hold the bit-plane kernel at
     the path's shapes, run (a) and (b), and gate: each request's tokens
     in (a) EQUAL the request run alone (batch-1 prefill + decode_step
     loop), and (b)'s EQUAL the first 4 of (a)'s; a free pool with every
     kpos at EMPTY_POS after run(); AP records equal to the AP model's price of
     each budget's bits; the spec ledger adding up to the tokens
     delivered; the bit-plane launches by M and regime as ``plan()``
     gives them; a SMOKE-size card-vs-CPU run of both (equal up to the
     first step whose top-2 logit gap is under LOGIT_TOL x max|logit|:
     the two devices' float libraries round apart).
     Then time to first token, tokens/s per tick, the accept rate, run
     walls and the bit-plane device sum per run();
  8. prefix cache and closed loop: hold the bit-plane kernel at the
     extension's M = 1 shapes; replay (a) cached and uncached and gate:
     the ledger as the trace implies, full hits' tokens EQUAL the
     uncached run's, each partial hit's logits and tokens EQUAL a replay
     with the plain version patched in, the cache entries bitwise
     unchanged after extensions, launches by M equal to the engine's
     calls (a full hit adds no prefill row), a drained pool; (b) spend
     within 1.1 x the SLO, saved > 0, budgets and bits EQUAL a host-only
     FluidController replay; (c) nothing unserved, the closed loop's
     burst arrivals at fewer bits than its calm ones (the open loop's
     equal), launches per batch per family, one batch's logits EQUAL the
     plain version's; AP records equal the AP model everywhere; SMOKE
     card-vs-CPU runs of all three.  Then admission walls and time to
     first token by hit kind, the bit-plane device sum per replay, the
     spike replays' images/s and a trace of one partial-hit extension;
  9. placement and scale-out: hold the bit-plane kernel at the per-rank
     shapes (M = 4 at Qwen3-4B's widths, ResNet18's GEMMs at B = 8); run
     (a) and (b) on the two ranks and gate: the plans fully replicated
     (ResNet18's with its layer names), the row split engaged, each
     rank's pool holding only its rows and drained after run(); (a)'s
     tokens EQUAL path 4 (a)'s, the ranks' records identical, each
     priced at PlacementPlan.price of the AP model's price of its bits
     (latency / 2, energy unchanged), launches by M equal to each rank's
     calls; (b)'s logits EQUAL path 1's, each rank's rows alone EQUAL
     the same rows of the whole batch's forward, latency / 2; (c)
     plan_gain EQUAL a host-only recomputation, every image priced at
     plan.price(...), the mean bits higher with the plan, launches per
     family per batch.  A rank that fails, or misses the rendezvous,
     fails the run.  Then the path's wall, each rank's tick wall (two
     ranks sharing one card: not a scale-out speed) and bit-plane device
     sum;
 10. MoE, vlm and the int8 cache: (a) hold the bit-plane kernel at the
     expert, shared, attention and head shapes and flash at (32, 4096,
     128); two generate budgets after a warm-up, gated: launches per
     forward (48 x (4 + 3 x 64 + 3) + 1) and by path as ``plan()``
     gives them, flash 48 a prefill, two identical calls give the same
     tokens and every layer's routing, each layer's MoE block on its
     own captured input EQUAL to the block with the plain bit-plane
     version, prices equal the AP model under moe's ``layer_gemm_dims``,
     a SMOKE card-vs-CPU run (every routed call, fed the card's own
     input, EQUAL but for tokens within MOE_ROUTE_TOL of a router tie);
     then prefill and
     decode ms, choices dropped by capacity, the bit-plane device sum
     per forward (experts and the rest), traces of a prefill and a
     decode step; (b) flash at (56, 4352, 64) and on every layer's own
     q/k/v, launches per generate, continuous streams EQUAL each request
     alone, speculative streams EQUAL their first 4 tokens, no prefix
     cache lookups, drained pools, AP records, SMOKE card-vs-CPU runs;
     (c) the same on the int8 cache, and one layer's decode-step QK and
     PV int32 accumulators EQUAL an int64 recomputation on the card;
     cache bytes and decode ms against (b);
 11. the recurrent families, cross-attention and hd 160, for each of (a)
     to (d): hold the bit-plane kernel at every (M, K, N, planes) of its
     prefill and decode step and flash at its attention shapes; a 2-token
     warm-up whose every flash launch is held within FLASH_TOL of the f32
     oracle on its own q/k/v (and, for (a), layer 0's SSD on the card
     within SSM_TOL of the float64 stepwise recurrence over SSM_STEPWISE
     positions); one counted and timed ``generate``: bit-plane launches
     by (M, K, N, planes) and by path as ``plan()`` gives them, flash
     launches (9, 24 of them cross-attention's 12, and 40), tokens
     repeating the warm-up's; prices equal the AP model; prefill and
     decode ms, peak memory, the bit-plane sum against its bound, flash
     (at hd 160 and the non-causal cross shape) against its bound and
     SDPA, traces of a prefill and a decode step; then a SMOKE
     card-vs-CPU prefill of each family (as ``gate_logits`` says; the
     encdec one behind 2000 frames, so its cross-attention takes flash);
 12. training: (a) every loss and grad norm finite, the last loss
     TRAIN_MARGIN below the first, no kernel launched while training;
     the step's median ms, tokens/s, peak memory, the loss curve and a
     trace of one step (GEMMs, elementwise and reduction kernels, idle
     share); (b) each family's SMOKE step card vs CPU within the TRAIN_*
     tolerances, the card's int8 / factored state through a checkpoint
     EQUAL; (c) operands that require grad at (64, 4096, 128) raise in
     the flash wrapper, and ``train_loss`` past FLASH_THRESHOLD raises,
     while the same call under no_grad launches once within FLASH_TOL of
     the oracle; (d) bit-plane launches by path as ``plan()`` gives them,
     each shape held EQUAL to the plain version and timed against its
     bound;
 13. serving entry points: (a) both CLI runs, gated: every request served
     with its new tokens, mean wbits as ``default_controller`` resolves
     its budget, AP latency, energy and EDP (or the batch's cycles and
     energy per token) EQUAL the AP model's price of its bits, the
     continuous streams EQUAL a ServeEngine built directly on the CLI's
     weights, bit-plane launches by path as ``plan()`` gives them, flash
     36 a ``--batch`` call and none in the continuous run; (b) restored
     step, mean wbits, AP prices and spend against the SLO EQUAL card vs
     CPU, greedy tokens as ``tokens_agree`` says against the CPU's
     standalone (or whole-batch) replay; (c) the reports EQUAL; (d)
     values and pass counts EQUAL the CPU's and integer arithmetic, and
     ``ap_matmul`` EQUALS the kernel at n_planes = M; (e) one launch at
     exactly wbits planes, int32 and f32 EQUAL the plain version's, vmap
     rows EQUAL grouped (one launch a row against one a family); (f) host
     numbers EQUAL card vs CPU.  Then (a)'s bit-plane shapes held and
     timed, and flash at the ``--batch`` prefill's shape.
 14. sharded serving: the single-device streams first (the parent's
     weights freed before the ranks); (a) logits and tokens EQUAL, flash
     36 a ``generate`` call on a rank, the int32 partial sums reduced
     and no weight gathered; (b) tokens EQUAL, weights sharded, records
     carrying the plan's replicas; (c) every MoE layer's output EQUAL to
     ``moe.ep_reference`` on its input, the ranks' dispatch buffers
     EQUAL to one device's (C_shard = C), tokens EQUAL a one-card run of
     the statement; (d) logits EQUAL path 1's; (e) tokens, hits and
     speculative rounds EQUAL one device's; then (a)'s and (c)'s
     bit-plane shapes held EQUAL and timed, flash at a rank's heads, each
     rank's wall, peak memory and collectives by kind and bytes; (f) the
     cache after prefill EQUAL one device's blocks (each rank's slice of
     the ring, ``kpos`` whole, by SHA-256), tokens as ``tokens_agree``
     says against one device's, and each rank's ``Mesh.counts`` EQUAL
     the lowering report's prediction on a ``RecordingMesh``; then
     (f)'s bit-plane shapes held EQUAL and timed, flash at its prefill.
 15. sharded training: (a) and (b) on one device first (the card freed
     before the ranks); then the ranks, gated: every rank's metrics
     EQUAL; each step's loss and z-loss within P12_LOSS_TOL and grad norm
     within P12_NORM_TOL of one device's, the trained parameters (the
     checkpoint the ranks wrote; (a)'s cut to P12_CKPT_LAYERS layers)
     within P12_FLIPS x U a step beyond a
     bf16 step and P12_PARAM_MEAN lr on average; no kernel launched while
     training; (c) every leaf EQUAL after both restores (the state cut to
     P12_CKPT_LAYERS layers); (d) tokens and
     last-position logits EQUAL one device's serve of the same weights,
     bit-plane launches by path as ``plan()`` gives them; (e) each step
     against ``moe.ep_reference``'s train form on one device from the
     same state (loss, z-loss, aux, grad norm, parameters as above,
     choices dropped EQUAL); (f) the TRAIN_* card-vs-CPU tolerances, and
     the launcher resuming from its last checkpoint on (2, 1).  Then
     (d)'s shard shapes held EQUAL and timed, each rank's step walls,
     peak memory and collectives by kind and bytes a step.
 16. the analysis suite (run after phase 9, on path 3's weights): (a)
     the CLI exits 0 with every pass ok; (b) and (c) one signature and
     one set of kernel specialisations per entrypoint, each holding the
     bit-plane kernel (and flash for ``generate``), flash launched 36
     times a ``generate`` call, tokens in range; (d) the first step one
     vanilla tick, the second one speculative round, and every sync
     inside a program body one the lint or RT502 reports.  Then (b)'s
     and (c)'s bit-plane shapes timed, flash at (b)'s prefill shape.
 17. the lowering report against the card (after phase 16): the
     launches by key EQUAL the prediction's, the argument bytes EQUAL
     the card's storages, the predicted peak within P14_PEAK_TOL of
     ``max_memory_allocated()``'s rise after a warm-up, and no kernel
     family's traced device time below P14_BOUND_FLOOR of the report's
     bound for its launches; the prefill's measured time over its
     roofline.  Then the path's bit-plane shapes held EQUAL and timed,
     flash at the prefill's shape held against its oracle and timed.
 18. the recurrent and encoder-decoder families on a mesh: one device's
     ``generate`` of each phase first (the card freed before the ranks);
     then, phase by phase, tokens EQUAL one device's, the prefill's
     last-position logits and the cache after prefill (the ranks'
     blocks put together) EQUAL, or, for a Mamba model on (1, 2) only,
     within P15_SSD_TOL with the first layer apart printed; every cache
     leaf its spec's local block; bit-plane and flash launches on every
     phase that reaches them and no int4 or quant launch.  Then every
     bit-plane shape the ranks launched held EQUAL and timed, every flash
     shape held against its oracle and timed.
 19. the same families trained on a mesh: each family's one-device
     gradient and steps first (the card freed before the ranks); then
     (a) and (b) gated: every rank's metrics EQUAL; each leaf of the
     first microbatch's gradient within P16_GRAD_TOL of its max from one
     device's at 16 bits; each step's loss and z-loss within
     P12_LOSS_TOL and grad norm within P12_NORM_TOL of one device's; the
     trained parameters within P12_FLIPS x U a step beyond a bf16 step and
     P12_PARAM_MEAN lr on average; no kernel launched while training; (c)
     zamba2's state: every leaf EQUAL after both restores; (d) tokens and last-position logits EQUAL one
     device's serve of the same weights, bit-plane launches by path as
     ``plan()`` gives them, flash on zamba2 and seamless, no int4 or
     quant launch; (e) the launcher exits 0 on (1, 2) and its loss falls.
     Then (d)'s bit-plane shapes held EQUAL and timed, its flash shapes
     held against the oracle and timed; each rank's step walls, peak
     memory and collectives by kind and bytes a step.
 20. the last cache layouts on a mesh: rank 0's one-device side after
     the group, then (a) every request's tokens EQUAL one device's (or
     as ``tokens_agree`` says), hits and calls EQUAL, the pool's kpos
     EQUAL and its held values (int8 codes times scales) EQUAL at layer
     0 and within P17_POOL_TOL at the later layers, block by block; the
     ragged prefill's logits and cache EQUAL, the U = 4 chunk's greedy
     tokens EQUAL but at near-ties; an int8 prefill and decode step's
     collectives EQUAL a RecordingMesh's; (b) tokens, prefill logits and
     the cache after prefill EQUAL one device's, the cross cache 1024 of
     2048 frames a rank; (c) logits EQUAL.  Then every bit-plane and
     flash shape rank 0 launched held and timed.

Kernel times are given two ways: per launch over back-to-back launches
timed with CUDA events (host time included where it exceeds the
device's, as in earlier runs), and device time, the same launches queued
behind a sleeping kernel so that the card runs them back to back.  The
bit-plane kernel's launches are also counted by the path it took (the
small-M GEMV; the large-M GEMM with x read by TMA in place, or from a
copy the pre-pass re-pitched with plain loads), and so are the int4 and
quant kernels', which run the same two regimes; the line before the
card's is the end-to-end summary.  The line before the last is the
kernels' JSON summary; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

BATCH = 16            # images per served batch (the engine's max_batch)
IMAGE = 224
SERVED = 5            # batches on the main path; the first one warms up
REPS = 20             # timed launches per kernel shape
PLAIN_REPS = 5        # timed calls of a GEMM's plain version (20 until path
#                       16 was added: 449 timed shapes spent 26 s on them)
# the sleeping kernel that holds the stream while the host queues REPS
# launches for device_ms: ~12 ms at the H100's clocks, several times what
# queueing 20 launches takes (100_000_000, ~50 ms, until path 16 was
# added: 45 s of sleeps over a run's 900 device timings)
SLEEP_CYCLES = 25_000_000
# the H100 SXM datasheet's rates (repro_torch.launch.mesh), set by
# hardware() once the checkout's src is on the path
HBM_BYTES_PER_S = INT8_OPS_PER_S = BF16_FLOPS_PER_S = None
# the device-side kernel names of each wrapper (for the traces' shares)
DEVICE_NAMES = {"bitplane_matmul": ("bitplane_",), "int4_matmul": ("int4_",),
                "quant_matmul": ("quant_",),
                # the library's kernels in a train step's trace: cuBLAS
                # GEMMs and ATen's elementwise and reduction kernels
                "gemm": ("gemm", "nvjet", "cutlass", "xmma"),
                "elementwise": ("elementwise",), "reduce": ("reduce_",)}
KERNELS = ("bitplane_matmul", "flash_attention", "int4_matmul",
           "quant_matmul")
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/bitplane_matmul.cu"
REPLACES = "src/repro/kernels/bitplane_matmul.py:71"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:78"
INT4_SOURCE = "src/repro_torch/kernels/csrc/int4_matmul.cu"
INT4_REPLACES = "src/repro/kernels/int4_matmul.py:51"
QUANT_SOURCE = "src/repro_torch/kernels/csrc/quant_matmul.cu"
QUANT_REPLACES = "src/repro/kernels/quant_matmul.py:50"
# both regimes of the three int8 GEMMs: M = 16 and 17 at split K (4608,
# 1500), K = 147 / 363 (x re-pitched), ragged and odd N
EDGE_SHAPES = [(1, 1, 1), (1, 512, 1000), (3, 147, 64), (130, 147, 65),
               (129, 64, 128), (257, 576, 63), (64, 33, 7), (200, 4608, 24),
               (16, 4608, 24), (17, 4608, 24), (17, 147, 1000),
               (16, 363, 65), (16, 1500, 130), (17, 1500, 130)]
INT4_EDGE = [(M, K, N) for M in (1, 16, 17, 130)
             for K in (1, 17, 363, 512, 1500) for N in (2, 96, 130, 1000)]
# launches by path per fixed-INT4 forward (b) and per (c) GEMM set: fc6-8
# take the GEMV, conv1 (K = 363) the large-M tile with x re-pitched
INT4_PATHS = {"small_m": 3, "large_m": 1, "large_m_copy_x": 1}
QUANT_PATHS = {"small_m": 3, "large_m": 7, "large_m_copy_x": 1}
# quant_matmul's silu / gelu against the plain version, |err| <= TOL x
# (1 + |plain|): CUDA's expf / tanhf against PyTorch's, a few f32 ulps;
# bf16 output one bf16 ulp (none and relu must be equal)
QUANT_TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -7}
ALEX_IMAGE = 227
ALEX_WIDTHS = [("conv1", 363, 96, 1), ("conv2", 1200, 128, 2),
               ("conv3", 2304, 384, 1), ("conv4", 1728, 192, 2),
               ("conv5", 1728, 128, 2), ("fc6", 9216, 4096, 1),
               ("fc7", 4096, 4096, 1), ("fc8", 4096, 1000, 1)]
# flash against its oracle, in f32 on the same bf16 inputs: about two
# bf16 ulps at |out| ~ 1 (P is rounded to bf16 before P.V, and the sums
# run in another order)
FLASH_TOL = 2e-2
FLASH_PATH = (128, 4096, 128)   # (B*H, S, hd) of a Qwen3-4B prefill
LM_ARCH = "qwen3_4b"
# (n_layers, d_model, n_heads, n_kv_heads, d_ff, vocab, head_dim) published
LM_WIDTHS = (36, 2560, 32, 8, 9728, 151936, 128)
# 2 new tokens (cut from 16 to 8 when path 10 was added, to 4 when path
# 11 was, to 2 when path 13 was; PERF.md §4)
LM_B, LM_S, LM_STEPS, LM_MAX_LEN = 4, 4096, 2, 4100
LM_BUDGETS = [0.4, 0.8, 10.0, 1e30]      # -> int4, mixed, int8, int8
LM_CALLS = 1          # timed generate calls after one warm-up
LM_SMOKE_S = 2100     # > FLASH_THRESHOLD, so the SMOKE prefill runs flash
LOGIT_TOL = 2e-2      # x max|logit|: bf16 attention + quantizer steps
# path 4: continuous batching (a) and speculative decoding (b) on Qwen3-4B
CB_SLOTS, CB_PREFILL, CB_BLOCK = 8, 1024, 8
# 9 requests: 8 fill the slots, 1 arrives late (a depth cut that keeps
# the whole script inside its time limit; PERF.md §4)
CB_REQUESTS, CB_UPFRONT, CB_LATE_TICK = 9, 8, 2
# 4 to 6 new tokens (depth cuts: 16-32 to 8-16 when path 8 was added,
# to 8-12 when path 11 was, to 4-8 when path 12 was, to 4-6 when path 16
# was; PERF.md §4)
CB_PROMPT, CB_NEW = (64, 1024), (4, 6)
CB_SPEC_K, CB_DRAFT_BUDGET = 4, 0.4          # int4 drafts
# (b)'s requests (8 until path 12 was added); the one at draft_k=0
CB_SPEC_REQUESTS, CB_DRAFT0 = 4, 3
CB_SPEC_NEW = 4         # (b) runs each request's first 4 new tokens (8
#                         until path 12 was added)
CB_SMOKE_PREFILL = 24
# path 5: the prefix cache and the closed loop, on path 4's engine shape
PC_SEED = 0
PC_TRACE = dict(ticks=8, rate=2.0, repetition=0.5, prompt_len=1024,
                max_new_tokens=8, budget=(10.0,))
PC_INT8_BUDGET = 10.0                    # default_controller: -> int8
PC_CHUNK, PC_CAPACITY, PC_MAX_LEN = 64, 8, 1040
PC_LATE_TICK, PC_KEEP, PC_FRESH, PC_PREFIX = 6, 512, 8, 256
PC_SOURCES = 2          # keys whose prompts the late prompts extend
PC_SLO_FRACTION = 0.6
PC_SMOKE_PREFILL = 24
# path 5 runs the first layer of Qwen3-4B's 36 at full width (depth cuts
# that keep the whole script inside its time limit: 18 when path 7 was
# added, 9 when path 8 was, 6 when path 9 was, 3 when path 11 was, 2
# when path 14 was, 1 when path 15 was; PERF.md §4)
PC_LAYERS = 1
SPIKE = dict(ticks=24, rate=4.0, burst_mag=10, burst_at=8, burst_len=4,
             cnn_frac=1.0, cnn_archs=("resnet18",))
SPIKE_WINDOW = 4                         # the closed loop's window, ticks
# path 6: placement and row scale-out
SO_RANKS = 2            # data ranks, all on cuda:0 (a gloo group)
SO_TIMEOUT_S = 300      # rendezvous and collective timeout
SO_PARTIAL = dict(n_devices=4, memory_budget=1.5)    # (c)'s partial plan
# path 7: the MoE family (Moonshot-v1-16B-A3B), vlm prefixes and the int8
# KV cache (InternVL2-1B), at their published widths
MOE_ARCH = "moonshot_v1_16b_a3b"
# (n_layers, d_model, n_heads, n_kv_heads, d_ff, vocab, head_dim, experts,
# top-k, shared experts) published
MOE_WIDTHS = (48, 2048, 16, 16, 1408, 163840, 128, 64, 6, 2)
# 2 new tokens (cut from 8 when path 11 was added, to 2 when path 13
# was; PERF.md §4)
MOE_B, MOE_S, MOE_STEPS = 2, 4096, 2
MOE_BUDGETS = (0.4, 10.0)  # default_controller's tightest and loosest
# router margin under which the card and the CPU may route apart: two
# neighbours among a token's k + 1 largest router probabilities within
# 2^-6 of each other (relative), a few bf16 ulps of a logit of size 1
MOE_ROUTE_TOL = 2.0 ** -6
VLM_ARCH = "internvl2_1b"
# (n_layers, d_model, n_heads, n_kv_heads, d_ff, vocab, head_dim, prefix
# tokens) published
VLM_WIDTHS = (24, 896, 14, 2, 4864, 151655, 64, 256)
# 2 new tokens in generate (cut from 16 to 8 when path 10 was added, to 4
# when path 11 was, to 2 when path 16 was) and 4 in the continuous run
# (PERF.md §4)
VLM_B, VLM_S, VLM_STEPS = 4, 4096, 2
# 6 continuous requests (8 until path 12 was added)
VLM_REQUESTS, VLM_SLOTS, VLM_NEW = 6, 4, 4
VLM_SPEC, VLM_SPEC_NEW = 4, 4
# path 8: the recurrent families, encoder-decoder cross-attention and flash
# at head dim 160, each through ServeEngine.generate at its published
# widths and depth; every model takes P8_STEPS new tokens after a
# P8_WARM-token warm-up
P8_STEPS, P8_WARM = 2, 1      # 2 new (cut from 16 and 4 when paths 11
#                               and 13 were added), a 1-token warm-up (2
#                               until path 13)
SSM_ARCH = "mamba2_1_3b"
# (n_layers, d_model, ssm_state, ssm_head_dim, expand, ssm_chunk, vocab)
SSM_WIDTHS = (48, 2048, 128, 64, 2, 128, 50280)
SSM_B, SSM_S = 4, 4096
SSM_STEPWISE = 384      # positions of layer 0's SSD inputs held stepwise
# the chunked SSD against the f64 stepwise recurrence, both on the card:
# f32 sums over up to SSM_STEPWISE decayed terms, in another order
SSM_TOL = 1e-3          # x max|value|
HYB_ARCH = "zamba2_2_7b"
# (n_layers, d_model, n_heads, n_kv_heads, head_dim, d_ff, vocab,
# attn_every, lora_rank, ssm_state)
HYB_WIDTHS = (54, 2560, 32, 32, 80, 10240, 32000, 6, 64, 64)
HYB_B, HYB_S, HYB_BUDGET = 2, 4096, 0.8
ED_ARCH = "seamless_m4t_medium"
# (n_enc_layers, n_layers, d_model, n_heads, n_kv_heads, head_dim, d_ff,
# vocab, frames_ratio)
ED_WIDTHS = (12, 12, 1024, 16, 16, 64, 4096, 256206, 4)
ED_B, ED_S, ED_BUDGET = 2, 8192, 0.8     # F = S / frames_ratio = 2048
D160_ARCH = "stablelm_12b"
# (n_layers, d_model, n_heads, n_kv_heads, head_dim, d_ff, vocab)
D160_WIDTHS = (40, 5120, 32, 8, 160, 13824, 100352)
D160_B, D160_S, D160_BUDGETS = 2, 4096, [0.4, 10.0]   # int4, int8 rows
# path 9: training.  (a) Qwen3-4B at its published widths and depth
# (LM_WIDTHS, remat="full"): AdamW with int8 first moments and factored
# second moments, wbits (8, 4) / abits (8,), TRAIN_STEPS steps on one
# fixed batch of TRAIN_B rows of TRAIN_S + 1 tokens in TRAIN_ACCUM
# microbatches (every sequence at most FLASH_THRESHOLD: the flash kernel
# has no backward), the last loss at least TRAIN_MARGIN nats below the
# first
TRAIN_B, TRAIN_S, TRAIN_ACCUM = 4, 2048, 2
# 3 steps (cut from 6 when path 11 was added, from 4 when path 12 was)
TRAIN_STEPS, TRAIN_LR, TRAIN_MARGIN = 3, 1e-5, 1.0
TRAIN_WBITS, TRAIN_ABITS = (8, 4), (8,)
# (b) one SMOKE step of each family on the card against the CPU, from
# the same weights and batch (AdamW f32/full at TRAIN_SMOKE_LR): the
# loss within TRAIN_LOSS_TOL and grad_norm within TRAIN_NORM_TOL
# (relative); each new parameter within 2 x TRAIN_SMOKE_LR plus one bf16
# step (at the larger of the two values) of the CPU's (Adam's first
# update is about g / |g| an element, so a gradient the two devices'
# float libraries put on either side of 0 moves 2 lr the other way), and
# at most TRAIN_STEP_SHARE of the elements differ at all
TRAIN_SMOKE_LR, TRAIN_SMOKE_B, TRAIN_SMOKE_S = 1e-3, 4, 65
TRAIN_LOSS_TOL, TRAIN_NORM_TOL, TRAIN_STEP_SHARE = 1e-2, 5e-2, 0.05
TRAIN_FAMILIES = {"dense": LM_ARCH, "moe": MOE_ARCH, "vlm": VLM_ARCH,
                  "ssm": SSM_ARCH, "hybrid": HYB_ARCH, "encdec": ED_ARCH}
# (c) the flash refusal: operands that require grad at (B*H, REFUSE_S, hd)
REFUSE_S = 4096
# (d) the trained weights served: prompts of SERVE_S tokens, budgets
# int4 and int8, SERVE_NEW new tokens
SERVE_S, SERVE_NEW, SERVE_BUDGETS = 256, 4, [0.4, 10.0]
# path 10: the serving entry points and the rest of the bit-fluid core.
# (a) ``python -m repro_torch.launch.serve`` on Qwen3-4B FULL, in process
# through main(argv): continuous, and --batch at prompts past
# FLASH_THRESHOLD (lock-step prefill through flash, 36 launches a call);
# the continuous run's 4 new tokens were cut from 8 when path 11 was added
P10_CONT = ["--requests", "6", "--prompt-len", "256", "--steps", "4",
            "--n-slots", "4", "--decode-block", "4", "--max-len", "512",
            "--budgets", "2.0", "0.75", "0.5"]
P10_BATCH = ["--batch", "--requests", "2", "--prompt-len", "2304",
             "--steps", "4", "--max-len", "2312", "--budgets", "2.0", "0.5"]
# (b) the other CLI modes at SMOKE size, card vs CPU, on a SMOKE
# checkpoint that repro_torch.launch.train writes; the closed loop's SLO
# is P10_SLO_FRACTION of the stream's priced int8 cost
P10_SMOKE = ["--smoke", "--requests", "3", "--prompt-len", "8", "--steps",
             "4", "--max-len", "32", "--n-slots", "2", "--decode-block", "2"]
P10_SLO_FRACTION = 0.3
# (c) launch/serve_torch.py, card vs CPU
P10_TRACES = (["--trace", "spike"],
              ["--trace", "poisson", "--prefix-cache", "--repetition", "0.6"])
# (d) the AP emulator: EMU_L rows at M in EMU_MS; ap_matmul at EMU_X @
# EMU_W against the bit-plane kernel at n_planes = M
EMU_L, EMU_MS, EMU_X, EMU_W = 4096, (4, 8), (4, 64), (64, 4)
# (e) ops.fluid_linear at wbits 1..8 on a Qwen3-4B up-projection at 16
# rows and ResNet18's s4b1_c2 conv GEMM at B=16, 224 px; vmap against
# grouped rows at VMAP_BITS
FL_QWEN = (16, 2560, 9728)
FL_RESNET = "s4b1_c2"
VMAP_BITS = [3, 4, 6, 8]
# (f) the three examples, card vs CPU
P10_EXAMPLES = ("quickstart", "bitfluid_serving", "mixed_precision_resnet18")
# path 11: sharded serving on two gloo ranks sharing cuda:0
P11_RANKS = 2
P11_GEN = (2, 2304, 2)             # (a) generate: B, prompt tokens, new
#                                    (4 new until path 13 was added)
P11_BUDGETS = (0.5,)               # (2.0, 0.5) until path 12 was added
P11_CONT = (3, 256, 2)             # (a) continuous: requests, prompt, new
#                                    (4 requests until path 16 was added;
#                                    3 still take every P11_CONT_BUDGETS)
#                                    (4 new until path 13 was added)
#                                    (8 new until path 12 was added)
# a decode tick runs its whole block: a request of 2 new tokens needs 1
# step, and on (2, 1) each step gathers every FSDP weight (8 until path
# 16 was added; PERF.md §4)
P11_SLOTS, P11_BLOCK = 4, 2
P11_CONT_BUDGETS = (2.0, 0.75, 0.5)
P11_MOE_LAYERS = 4                 # (c) Moonshot's first 4 of 48 layers
P11_MOE_GEN = (2, 512, 2)          # (c) generate: B, prompt tokens, new
#                                    (4 new until path 13 was added)
P11_MOE_BUDGET = 10.0              # default_controller: int8
P11_PC_CHUNK = 4
# path 12: sharded training on two gloo ranks sharing cuda:0.  (a) Qwen3-4B
# FULL, all layers, tensor-parallel on (1, 2); (b) its first
# P12_FSDP_LAYERS layers, FSDP on (2, 1): P12_STEPS steps each on one batch
# of P12_B rows of P12_S + 1 tokens in P12_ACCUM microbatches, path 9's
# AdamW (int8 m, factored v, TRAIN_LR), wbits and abits; (c) (a)'s state
# cut to its first P12_CKPT_LAYERS layers through a checkpoint; (d) the
# restored weights served on (1, 2): P12_SERVE = (B, prompt tokens, new); (e)
# Moonshot-v1-16B-A3B at full width, its first P12_MOE_LAYERS layers,
# expert-parallel on (1, 2), P12_STEPS steps of P12_MOE_B x P12_MOE_S + 1
P12_RANKS = 2
P12_B, P12_S, P12_ACCUM, P12_STEPS = 4, 512, 2, 2
P12_FSDP_LAYERS = 2          # 4 until path 13 was added (PERF.md §4)
P12_SERVE = (2, 256, 4)
# (c) and (d) at 4 of 36 layers (all 36, an 11 GiB checkpoint, until path
# 17 was added; PERF.md §4): the save, both restores and the serve run
# the same code on every leaf whatever the depth
P12_CKPT_LAYERS = 4
# (e) at 1 layer (2 until path 16 was added; PERF.md §4)
P12_MOE_LAYERS, P12_MOE_B, P12_MOE_S = 1, 2, 256
# the gates, as tests/test_torch_sharded_train*.py state and measure them
# on the CPU: a step's loss and z-loss within P12_LOSS_TOL and its grad
# norm within P12_NORM_TOL of one device's (relative); the mean |gap| of
# the trained parameters within P12_PARAM_MEAN lr; each element within
# P12_FLIPS x U a step beyond one bf16 step of one device's, U the
# largest change one device's step made to any element (a gradient that
# rounds to the other side of 0 flips that element's Adam update)
P12_LOSS_TOL, P12_NORM_TOL = 1e-3, 2e-2
P12_FLIPS, P12_PARAM_MEAN = 2.0, 0.2
# (e): the choices the capacity drops, ranks against the one-device
# statement, within P12_DROP_TOL of all choices.  On the CPU they are
# EQUAL (the forward computes what one process computes); on the card a
# tensor-parallel product rounds apart from one device's (P12_LOSS_TOL),
# and a token whose top-k router scores tie within that rounding may
# choose another expert
P12_DROP_TOL = 1e-3
# path 13: the analysis suite on the card
P13_GEN = (2, 2304, 1)   # (b) generate: B, prompt tokens (> FLASH_THRESHOLD),
#                          new tokens (the decode step is decode_scan's)
# (b) budget mixes of path 4's 8 slots (default_controller: int4, mixed,
# int8, int8)
P13_MIXES = ((0.4, 0.8, 10.0, 1e30) * 2, (0.4,) * 8, (10.0,) * 8,
             (0.8, 0.4, 1e30, 0.4, 0.8, 10.0, 0.4, 1e30))
P13_BLOCK = 1            # (b)/(d) decode block (path 4's slots and
#                          prefill length, 1 step a block: recording an op
#                          stream costs about 30 us an op, and a full-width
#                          decode step runs about 33,000)
P13_CNN = (224, 16)      # (c) ResNet18: image, batch
# (d) prompt lengths: two vanilla requests, then one that drafts
P13_SYNC_PROMPTS, P13_SYNC_NEW = (300, 700, 500), 8
# path 14: the lowering report against the card.  (a) lm.prefill B x S on
# path 3's weights, then one lm.decode_step; (b) in path 11's ranks, B=1
# on (2, 1) with the sequence-sharded cache: B, prompt (> FLASH_THRESHOLD),
# new tokens
P14_A = (2, 4096)
P14_SEQ = (1, 2304, 4)
P14_PEAK_TOL = 0.10      # predicted peak against the card's, relative
P14_BOUND_FLOOR = 0.95   # a kernel family's device time over its bound
# path 15: the recurrent and encoder-decoder families on two gloo ranks
# sharing cuda:0, at their published widths, depth cut: mamba2-1.3b's
# first P15_SSM_LAYERS of 48 layers, zamba2-2.7b's first P15_HYB_SUPER of
# 9 super-blocks (6 Mamba layers each), seamless-m4t-medium's first
# P15_ED_LAYERS (encoder, decoder) of 12 + 12.  (a) (1, 2) tensor-parallel
# generate of P15_GEN = (B, prompt tokens (> FLASH_THRESHOLD), new),
# seamless behind as many frames; (b) (2, 1) with FSDP weights and the
# rows split, and P15_B1 rows of mamba2 and zamba2 (the Mamba state whole
# on both data ranks, the shared block's ring sequence-sharded)
P15_RANKS = 2
P15_GEN = (2, 2304, 2)
P15_B1 = (1, 2304, 2)
# (8, 2, (2, 2) until path 16 was added, whose (d) serves the same three
# families on (1, 2) at (4, 2, (2, 2)); PERF.md §4)
P15_SSM_LAYERS, P15_HYB_SUPER, P15_ED_LAYERS = 2, 1, (1, 1)
# default_controller: mamba2 per-request int4 and int8 rows; zamba2 int8;
# seamless mixed
P15_BUDGETS = {"ssm": (0.4, 10.0), "hybrid": 10.0, "encdec": 0.8}
P15_LORA_B = 0.5         # zamba2's LoRA b ~ N(0, 0.5) (lora_init: zeros)
# the one permitted gap: a Mamba-bearing model on (1, 2), whose f32 SSD
# einsums at H/tp heads may pick other library kernels than one device's;
# its prefill logits within P15_SSD_TOL x max|logit| (path 8's card-vs-CPU
# gate), tokens EQUAL.  Everything else is EQUAL
P15_SSD_TOL = 2e-2
P15_SMOKE_FLASH = 16     # a CPU rehearsal's flash threshold (prompts of 40)
# path 16: the recurrent and encoder-decoder families trained on two gloo
# ranks sharing cuda:0, at their published widths, depth cut as path 15
# cuts it: mamba2-1.3b's first P16_SSM_LAYERS of 48 layers, zamba2-2.7b's
# first P16_HYB_SUPER of 9 super-blocks (every LoRA b drawn N(0,
# P15_LORA_B)), seamless-m4t-medium's first P16_ED_LAYERS of 12 + 12, each
# with remat="full".  (a) (1, 2) tensor-parallel and (b) (2, 1) FSDP:
# path 12's P12_STEPS steps of P12_ACCUM microbatches on one batch of
# P16_B rows of P16_S + 1 tokens (seamless behind make_batch's frames),
# path 9's optimizer and bits; (c) (a)'s state through a checkpoint onto
# (2, 1) and one device; (d) the trained weights quantized and served on
# (1, 2): generate P16_SERVE = (B, prompt tokens (> FLASH_THRESHOLD), new)
P16_RANKS = 2
P16_SSM_LAYERS, P16_HYB_SUPER, P16_ED_LAYERS = 4, 2, (2, 2)
# (b) runs mamba2 and zamba2 at a shallower cut, as path 12 (b) does: FSDP
# gathers every weight whole through host memory at each use (the forward
# and remat's recompute) and SUMs its gradient whole, 6.5 GB a step a rank
# for zamba2's 2 super-blocks, 21-24 s a step on an H100 (PERF.md §6):
# mamba2's first P16_FSDP[0] layers, zamba2's first P16_FSDP[1]
# super-block.  seamless's FSDP step (30 s a run, most of it its two
# 256206 x 1024 tables) is the attention families' FSDP path, which path
# 12 (b) runs on the card; tests/test_torch_sharded_train_encdec.py holds
# it on the CPU (it left the card when the whole script ran 1126.7 s)
P16_FSDP = (2, 1)
P16_B, P16_S = 4, 512
P16_SERVE = (2, 2304, 2)
# (c) the checkpoint of zamba2's state (mamba, shared-block and LoRA
# leaves); the other two serve (d) from their state gathered whole
P16_CKPT_FAMILY = "hybrid"
# the gates against one device: the first microbatch's gradient at 16
# bits (the fake quantizer's identity), leaf by leaf, max |mesh - one
# device| within P16_GRAD_TOL x the leaf's max |one device| (measured: at
# most 0.084, zamba2's emb on (1, 2); a leaf that misses a model rank's
# block of its gradient sits 0.33-1.0 apart: tests/torch_mesh_train.py;
# at the step's 8 and 4 bits the rounding of the ranks' GEMMs moves whole
# quantizer steps through zamba2's 14 blocks, 0.44 apart); each step's
# loss, z-loss and grad norm by path 12's P12_LOSS_TOL and P12_NORM_TOL
# (measured: loss within 1.6e-4, grad norm within 2.3e-3); the
# parameters by P12_FLIPS and P12_PARAM_MEAN (measured: 1 U, mean 0.085
# lr); on an H100, PERF.md §6
P16_GRAD_TOL = 0.2

# Path 17 (the last cache layouts the reference serves, on a data mesh):
# two ranks on cuda:0 in one gloo group as a (2, 1) mesh, FSDP weights
# drawn once.  (a) Qwen3-4B at published widths cut to its first
# P17_LAYERS of 36 layers (each layer runs the same attention and cache
# code; depth only repeats it, and path 3 runs all 36): continuous
# batching on P17_SLOTS slots, which do not split over two data ranks,
# so the pool shards its ring's sequence; five requests (prompts of
# P17_PROMPTS: the first, 64, the partial hit's 4-chunk prefix and
# tail, and a late one), P17_NEW new tokens, two speculative, one full
# and one partial prefix-cache hit, on the bf16 and the int8 cache; then
# lm.prefill of 3 ragged rows (P17_RAGGED) and one U = P17_CHUNK_U
# decode_chunk on the sequence-sharded cache, and an int8 prefill and
# decode step's collectives against a RecordingMesh.  (b) path 15's
# seamless cut at B = 1: P17_ED = (B, frames, prompt tokens, new), its
# cross cache's frames split over the ranks.  (c) ResNet18@224, a batch
# of P17_CNN images.
P17_RANKS = 2
P17_LAYERS = 4
P17_SLOTS = 3
P17_PREFILL = 512
P17_MAX_LEN = 528       # >= prefill + new + SPEC_K_MAX, even: the ring splits
P17_NEW = 4
P17_PC_CHUNK = 64
P17_PROMPTS = (320, 64, 24, 512)
P17_RAGGED, P17_RAGGED_LEN = (2048, 1536, 700), 2048
P17_CHUNK_U = 4
P17_ED = (1, 2048, 2304, 2)
P17_CNN = 3
# the pool after (a)'s run against one device's, on the values it holds
# (int8 codes times their scales).  Layer 0's k/v depend on the tokens
# alone: EQUAL.  A later layer's may not: a decode step's softmax combined
# over the ranks in another f32 order can round a probability apart (a
# bf16 step, or one of the int8 cache's 127 levels, twice as coarse), and
# the next layers' k/v with it; the bound, x the leaf's max |value|, by
# kv_cache_bits
P17_POOL_TOL = {0: 2e-2, 8: 5e-2}


def hardware() -> None:
    """The roofline denominators from ``repro_torch.launch.mesh``."""
    global HBM_BYTES_PER_S, INT8_OPS_PER_S, BF16_FLOPS_PER_S
    from repro_torch.launch import mesh
    HBM_BYTES_PER_S = mesh.HBM_BW
    INT8_OPS_PER_S = mesh.PEAK_OPS_INT8
    BF16_FLOPS_PER_S = mesh.PEAK_FLOPS_BF16


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(res.returncode == 0 and res.stdout.strip() != "",
          f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def path_gemms(layers, batch: int, image: int):
    """(layer, M, K, N, G) of every GEMM layer the serve forward runs, in
    order, from the real spatial sizes (the forward follows these, not the
    table's: at 224 the maxpool leaves 55x55, not 56x56).  A grouped conv
    runs G GEMMs of (M, K, N) each, one per group."""
    out, h, h_block = [], image, None
    for l in layers:
        if l.kind == "conv":
            if h_block is None:
                h_block = h
            down = l.name.endswith("_down")
            ho = ((h_block if down else h) - l.hk + 2 * l.pad) // l.stride + 1
            g = l.groups
            out.append((l.name, batch * ho * ho, l.hk * l.wk * l.cin // g,
                        l.cout // g, g))
            if not down:
                h = ho
        elif l.kind in ("maxpool", "avgpool"):
            h, h_block = (h - l.hk) // l.stride + 1, None
        elif l.kind == "add":
            h_block = None
        elif l.kind == "fc":
            out.append((l.name, batch, l.cin, l.cout, 1))
    return out


class Bench:
    """Shared state of one run: the card, its tag, the seeded generator
    for kernel operands, and the timing helpers."""

    def __init__(self, torch, dev, tag):
        self.torch = torch
        self.dev = dev
        self.tag = tag
        self.gen = torch.Generator(device=dev).manual_seed(0)
        self.bp_err = 0           # bit-plane kernel vs plain: max |err|
        self.fa_err = 0.0         # flash kernel vs oracle: max |err|
        self.i4_err = 0.0         # int4 kernel vs plain: max |err|
        self.q_err = 0.0          # quant kernel vs plain: max |err|

    def rand_i8(self, shape):
        return self.torch.randint(-128, 128, shape, generator=self.gen,
                                  device=self.dev, dtype=self.torch.int8)

    def time_ms(self, fn, reps: int = REPS) -> float:
        torch = self.torch
        for _ in range(min(3, reps)):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def device_ms(self, fn, reps: int = REPS) -> float:
        """Device time per call of ``fn`` without the host's: the stream
        is first held by a sleeping kernel while the host queues the
        timed launches behind it, so the card runs them back to back."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def rand_u8(self, shape):
        return self.torch.randint(0, 256, shape, generator=self.gen,
                                  device=self.dev, dtype=self.torch.uint8)

    def rand_scale(self, n):
        return 0.001 + 0.05 * self.torch.rand((1, n), generator=self.gen,
                                              device=self.dev)

    def hold_int4(self, x, w, s, out_dtype):
        from repro_torch.kernels import int4_matmul as i4mm
        got = i4mm.int4_matmul(x, w, s, out_dtype=out_dtype)
        want = i4mm.int4_matmul_ref(x, w, s, out_dtype)
        self.torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max()) \
            if got.numel() else 0.0
        self.i4_err = max(self.i4_err, err)
        check(self.torch.equal(got, want), f"int4 kernel != plain version "
              f"at {tuple(x.shape)} @ {tuple(w.shape)} packed, "
              f"{out_dtype}: max |err| {err}")

    def hold_quant(self, x, w, s, bias, act, out_dtype):
        from repro_torch.kernels import quant_matmul as qmm
        got = qmm.quant_matmul(x, w, s, bias, act=act, out_dtype=out_dtype)
        want = qmm.quant_matmul_ref(x, w, s, bias, act, out_dtype)
        self.torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = float(diff.max()) if got.numel() else 0.0
        self.q_err = max(self.q_err, err)
        where = (f"at {tuple(x.shape)} @ {tuple(w.shape)}, act={act}, "
                 f"{out_dtype}: max |err| {err}")
        if act in ("none", "relu"):
            check(self.torch.equal(got, want),
                  f"quant kernel != plain version {where}")
        else:
            tol = QUANT_TOL[str(out_dtype).split(".")[-1]]
            check(bool((diff <= tol * (1 + want.float().abs())).all()),
                  f"quant kernel vs plain version beyond tolerance {where}")

    def library_int_mm(self, x, w_i8):
        """torch._int_mm on copies zero-padded where its shape rules need
        it (M > 16, K and N multiples of 8), timed with the weight
        row-major (K, N) and K-major (``w.t().contiguous().t()``, the
        layout cuBLAS's int8 GEMM prefers); neither copy is timed.  A
        layout cuBLAS refuses at this shape (CUBLAS_STATUS_NOT_SUPPORTED,
        e.g. row-major at (2352, 64, 128)) counts as infinitely slow.
        Returns (faster ms, padded?, row-major ms, K-major ms, the faster
        layout's device ms)."""
        torch = self.torch
        M, K = x.shape
        N = w_i8.shape[1]
        Mp, Kp, Np = max(M, 17), -(-K // 8) * 8, -(-N // 8) * 8
        pad = torch.nn.functional.pad
        xl = pad(x, (0, Kp - K, 0, Mp - M))
        wl = pad(w_i8, (0, Np - N, 0, Kp - K))
        wk = wl.t().contiguous().t()

        def timed(w):
            try:
                return self.time_ms(lambda: torch._int_mm(xl, w))
            except RuntimeError as e:
                if "CUBLAS_STATUS_NOT_SUPPORTED" not in str(e):
                    raise
                return float("inf")

        row_ms, kmaj_ms = timed(wl), timed(wk)
        check(min(row_ms, kmaj_ms) < float("inf"), f"torch._int_mm refuses "
              f"({Mp}, {Kp}) @ ({Kp}, {Np}) in both layouts")
        wf = wl if row_ms < kmaj_ms else wk
        dev_ms = self.device_ms(lambda: torch._int_mm(xl, wf))
        return (min(row_ms, kmaj_ms), (Mp, Kp, Np) != (M, K, N), row_ms,
                kmaj_ms, dev_ms)

    @staticmethod
    def lib_note(padded, row_ms, kmaj_ms):
        return (f"{' (padded)' if padded else ''} (w row-major "
                f"{row_ms:.4f}, K-major {kmaj_ms:.4f})")

    def row_note(self, name, regime, k_ms, d_ms, p_ms, l_ms, ld_ms, padded,
                 l_row, l_kmaj, t_bytes, t_ops, lib_what=""):
        bound = max(t_bytes, t_ops)
        print(f"{self.tag} {name}: {regime} regime, kernel {k_ms:.4f} ms "
              f"(device {d_ms:.4f}), plain {p_ms:.4f} ms, torch._int_mm"
              f"{lib_what} {l_ms:.4f} ms (device {ld_ms:.4f})"
              f"{self.lib_note(padded, l_row, l_kmaj)} (no epilogue), bound "
              f"{bound:.4f} ms "
              f"({'bytes' if t_bytes >= t_ops else 'operations'}), "
              f"{bound / k_ms:.3f} of bound ({bound / d_ms:.3f} on the "
              f"device clock); kernel / library on the device clock "
              f"{d_ms / ld_ms:.3f}")

    def int4_row(self, M, K, N):
        """(kernel ms, plain ms, torch._int_mm ms, bytes bound ms, ops
        bound ms, kernel device ms, torch._int_mm device ms) of one
        int4_matmul launch at (M, K, N), f32 output."""
        from repro_torch.core import bitfluid as bf
        from repro_torch.kernels import int4_matmul as i4mm
        x, w, s = self.rand_i8((M, K)), self.rand_u8((K, N // 2)), \
            self.rand_scale(N)
        k_ms = self.time_ms(lambda: i4mm.int4_matmul(x, w, s))
        d_ms = self.device_ms(lambda: i4mm.int4_matmul(x, w, s))
        p_ms = self.time_ms(lambda: i4mm.int4_matmul_ref(x, w, s),
                            reps=PLAIN_REPS)
        l_ms, padded, l_row, l_kmaj, ld_ms = self.library_int_mm(
            x, bf.unpack_int4_halves(w))
        ops, nbytes = i4mm.work(M, K, N)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / INT8_OPS_PER_S * 1e3
        self.row_note(f"int4_matmul ({M},{K},{N}) f32 out",
                      i4mm.plan(M, K, N).path, k_ms, d_ms, p_ms, l_ms, ld_ms,
                      padded, l_row, l_kmaj, t_bytes, t_ops,
                      " on the unpacked int8 weight")
        return k_ms, p_ms, l_ms, t_bytes, t_ops, d_ms, ld_ms

    def quant_row(self, M, K, N, act, out_dtype):
        """The same seven numbers for one quant_matmul launch."""
        from repro_torch.kernels import quant_matmul as qmm
        x, w, s = self.rand_i8((M, K)), self.rand_i8((K, N)), \
            self.rand_scale(N)
        bias = self.rand_scale(N)
        k_ms = self.time_ms(lambda: qmm.quant_matmul(
            x, w, s, bias, act=act, out_dtype=out_dtype))
        d_ms = self.device_ms(lambda: qmm.quant_matmul(
            x, w, s, bias, act=act, out_dtype=out_dtype))
        p_ms = self.time_ms(lambda: qmm.quant_matmul_ref(
            x, w, s, bias, act, out_dtype), reps=PLAIN_REPS)
        l_ms, padded, l_row, l_kmaj, ld_ms = self.library_int_mm(x, w)
        ops, nbytes = qmm.work(M, K, N,
                               2 if out_dtype == self.torch.bfloat16 else 4)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / INT8_OPS_PER_S * 1e3
        self.row_note(f"quant_matmul ({M},{K},{N}) act={act} "
                      f"{str(out_dtype).split('.')[-1]} out",
                      qmm.plan(M, K, N).path, k_ms, d_ms, p_ms, l_ms, ld_ms,
                      padded, l_row, l_kmaj, t_bytes, t_ops)
        return k_ms, p_ms, l_ms, t_bytes, t_ops, d_ms, ld_ms

    def hold_bitplane(self, x, w, n):
        from repro_torch.kernels import bitplane_matmul as bpm
        got = bpm.bitplane_matmul(x, w, n_planes=n)
        want = bpm.bitplane_matmul_ref(x, w, n)
        self.torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max()) if got.numel() \
            else 0
        self.bp_err = max(self.bp_err, err)
        check(self.torch.equal(got, want), f"kernel != plain version at "
              f"{tuple(x.shape)} @ {tuple(w.shape)}, n_planes={n}, "
              f"max |err| {err}")

    def gemm_row(self, M, K, N, n):
        """(kernel ms, plain ms, torch._int_mm ms, bytes bound ms, ops
        bound ms, kernel device ms, torch._int_mm device ms) of one
        bit-plane launch at (M, K, N), n planes.  Kernel ms is per launch
        over back-to-back launches (host time included where it exceeds
        the device's); device ms is the same launches run back to back on
        the card (see device_ms), the pre-pass or memset included."""
        from repro_torch.kernels import bitplane_matmul as bpm
        x, w = self.rand_i8((M, K)), self.rand_i8((K, N))
        k_ms = self.time_ms(lambda: bpm.bitplane_matmul(x, w, n_planes=n))
        d_ms = self.device_ms(lambda: bpm.bitplane_matmul(x, w, n_planes=n))
        p_ms = self.time_ms(lambda: bpm.bitplane_matmul_ref(x, w, n),
                            reps=PLAIN_REPS)
        # library yardstick: one torch._int_mm on the sign-extended weights
        l_ms, padded, l_row, l_kmaj, ld_ms = self.library_int_mm(
            x, bpm.sign_extend_field(w, n))
        ops, nbytes = bpm.work(M, K, N)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / INT8_OPS_PER_S * 1e3
        print(f"{self.tag} bitplane_matmul ({M},{K},{N}) n_planes={n}: "
              f"kernel {k_ms:.4f} ms (device {d_ms:.4f}), plain {p_ms:.4f} ms, "
              f"torch._int_mm {l_ms:.4f} ms (device {ld_ms:.4f})"
              f"{self.lib_note(padded, l_row, l_kmaj)}, "
              f"{bpm.plan(M, K, N).regime} regime, bound "
              f"{max(t_bytes, t_ops):.4f} ms "
              f"({'bytes' if t_bytes >= t_ops else 'operations'}), "
              f"{max(t_bytes, t_ops) / k_ms:.3f} of bound")
        return k_ms, p_ms, l_ms, t_bytes, t_ops, d_ms, ld_ms


def trace(torch, tag, label, fn, match):
    """torch.profiler over one call of ``fn``: the device's busy time and
    idle share, and device time by kernel name; returns the summary.  It
    reads the profiler's raw events: building ``prof.events()``' tree
    over a decode tick's quarter million events took minutes of host
    time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    dev_events = [e for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA]
    check(dev_events != [], f"the profiler recorded no device activity "
          f"in {label}")
    spans = sorted((e.start_ns() / 1e3, e.end_ns() / 1e3)
                   for e in dev_events)
    busy_us, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy_us, cur_s = busy_us + cur_e - cur_s, s
        cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    by_name: dict = {}
    for e in dev_events:
        key = e.name().replace("(anonymous namespace)::", "")
        key = key.removeprefix("void ").split("(")[0][:90]
        by_name[key] = by_name.get(key, 0.0) + e.duration_ns() / 1e3
    dev_total = sum(by_name.values())
    shares = {m: sum(us for k, us in by_name.items()
                     if any(d in k for d in DEVICE_NAMES.get(m, (m,))))
              / dev_total for m in match}
    idle = 1 - busy_us / 1e3 / (traced_s * 1e3)
    print(f"{tag} trace of {label}: wall {traced_s * 1e3:.3f} ms "
          f"(profiler on), device busy {busy_us / 1e3:.3f} ms, idle share "
          f"{idle:.3f}; {len(dev_events)} device ops, "
          f"{dev_total / 1e3:.3f} ms summed; share of device time "
          + ", ".join(f"{m} {v:.3f}" for m, v in shares.items()))
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"{tag}   {us / 1e3:8.3f} ms  {us / dev_total:6.3f}  {name}")
    return {"wall_ms": traced_s * 1e3, "busy_ms": busy_us / 1e3,
            "idle_share": idle, "device_ops": len(dev_events),
            "kernel_ms": {m: v * dev_total / 1e3 for m, v in shares.items()}}


# ---------------------------------------------------------------------------
# Flash attention against its oracle
# ---------------------------------------------------------------------------

def flash_cases():
    """(BH, Sq, Sk, hd, causal, window) edge cases: causal and not,
    window 0 and 64, BH = 1 at S in {1, 63, 65, 2100}, hd in {16, 64, 80,
    128, 144, 160}, and Sq != Sk with Sk not a multiple of 64."""
    cases = []
    for causal in (True, False):
        for window in (0, 64):
            for S in (1, 63, 65, 2100):
                for hd in (16, 64, 80, 128, 144, 160):
                    cases.append((1, S, S, hd, causal, window))
            for hd in (64, 80, 128, 144, 160):
                cases.append((3, 100, 333, hd, causal, window))
                cases.append((2, 130, 77, hd, causal, window))
    return cases


def oracle_f32(q, k, v, causal, window):
    """The flash oracle in f32 over flat heads, a few heads at a time (its
    scores are (heads, Sq, Sk) f32)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    step = max(1, 2 ** 28 // (q.shape[1] * k.shape[1]))
    return torch.cat([fa.flash_attention_ref(q[i:i + step].float(),
                                             k[i:i + step].float(),
                                             v[i:i + step].float(), causal,
                                             window)
                      for i in range(0, q.shape[0], step)])


def hold_flash(b: Bench, BH, Sq, Sk, hd, causal, window) -> float:
    torch = b.torch
    from repro_torch.kernels import flash_attention as fa
    q = torch.randn((BH, Sq, hd), generator=b.gen, device=b.dev).bfloat16()
    k = torch.randn((BH, Sk, hd), generator=b.gen, device=b.dev).bfloat16()
    v = torch.randn((BH, Sk, hd), generator=b.gen, device=b.dev).bfloat16()
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    check(got.shape == (BH, Sq, hd) and got.dtype == torch.bfloat16,
          f"flash output {tuple(got.shape)} {got.dtype}")
    err = float((got.float() - oracle_f32(q, k, v, causal, window))
                .abs().max())
    b.fa_err = max(b.fa_err, err)
    check(err <= FLASH_TOL, f"flash kernel vs oracle at BH={BH}, Sq={Sq}, "
          f"Sk={Sk}, hd={hd}, causal={causal}, window={window}: max |err| "
          f"{err} > {FLASH_TOL}")
    return err


# ---------------------------------------------------------------------------
# Path 1: ResNet18 serving
# ---------------------------------------------------------------------------

def cnn_inputs(torch, dev, ctrl, batch: int = BATCH, image: int = IMAGE):
    """Path 1's batch: BATCH images drawn on the card from seed 1, and
    budgets cycling the tightest, each configuration's prediction x 1.01,
    and unconstrained."""
    preds = [ctrl.predicted_latency_s[k] for k in ctrl.order()]
    cycle = [0.0] + [p * 1.01 for p in preds] + [1e30]
    budgets = [cycle[i % len(cycle)] for i in range(batch)]
    img_gen = torch.Generator(device=dev).manual_seed(1)
    images = torch.randn((batch, image, image, 3), generator=img_gen,
                         device=dev)
    return images, budgets


def cnn_path(b: Bench) -> dict:
    torch, dev, tag = b.torch, b.dev, b.tag
    import numpy as np
    from repro_torch.apsim import metrics as apm
    from repro_torch.core.policy import cnn_budget_controller
    from repro_torch.kernels import bitplane_matmul as bpm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int4_matmul as i4mm
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_matmul as qmm
    from repro_torch.models import cnn
    from repro_torch.serve.cnn import CNNServeEngine

    gen_cpu = torch.Generator().manual_seed(0)
    params, layers = cnn.init_cnn("resnet18", gen_cpu, device=dev)
    gemms = path_gemms(layers, BATCH, IMAGE)
    check(len(gemms) == 21, f"expected 21 GEMM layers, got {len(gemms)}")
    ctrl = cnn_budget_controller("resnet18", layers=layers)
    engine = CNNServeEngine(params, layers, controller=ctrl,
                            max_batch=BATCH, device=dev)
    fams = engine.families
    check(fams == (4, 8), f"bit families {fams}, expected (4, 8)")
    shapes = sorted({(M, K, N) for _, M, K, N, _ in gemms})
    for M, K, N in shapes:
        for n in fams:
            b.hold_bitplane(b.rand_i8((M, K)), b.rand_i8((K, N)), n)
    print(f"kernel == plain: {len(shapes)} ResNet18@{IMAGE} GEMM shapes at "
          f"B={BATCH} x n_planes {fams}: "
          + ", ".join(f"({M},{K},{N})" for M, K, N in shapes))

    # ---- serve the path
    preds = [ctrl.predicted_latency_s[k] for k in ctrl.order()]
    tight, loose = 0.0, 1e30
    images, budgets = cnn_inputs(torch, dev, ctrl)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_gemm_launches()
    batch_s, outs = [], []
    for _ in range(SERVED):
        t0 = time.perf_counter()
        logits, stats = engine.serve(images, budgets)   # ends in a sync
        batch_s.append(time.perf_counter() - t0)
        outs.append((logits, stats))
    launches = bpm.launches_by_planes()
    paths = bpm.launches_by_path()
    check(fa.launch_count() == 0 and i4mm.launches == 0
          and sum(qmm.spec_launches.values()) == 0,
          "the ResNet18 path launched a kernel off its path")
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20

    per_batch = len(gemms) * len(fams)
    check(sum(launches.values()) == per_batch * SERVED,
          f"kernel launches {launches}, expected {per_batch} per batch x "
          f"{SERVED} batches")
    check({n for n, c in launches.items() if c} == set(fams),
          f"launches at n_planes outside the families {fams}: {launches}")
    check(all(launches[n] == len(gemms) * SERVED for n in fams),
          f"launches per family {launches}")
    logits, stats = outs[-1]
    check(logits.shape == (BATCH, 1000), f"logits shape {logits.shape}")
    check(bool(np.isfinite(logits).all()), "non-finite logits")
    for lg, _ in outs[1:]:
        check(np.array_equal(lg, logits), "batches of the same input differ")
    for bud, s in zip(budgets, stats):
        if bud == tight:
            check(s.mean_wbits == 4.0, f"tightest budget -> {s.mean_wbits}")
        if bud == loose:
            check(s.mean_wbits == 8.0, f"unconstrained -> {s.mean_wbits}")
    check(len({s.wbits for s in stats}) == 5,
          "budgets did not span the five HAWQ-V3 configurations")
    costs = apm.price_bit_matrix(apm.network_gemms(layers),
                                 [s.wbits for s in stats],
                                 [s.abits for s in stats])
    check([c.edp for c in costs] == [s.edp for s in stats],
          "per-image EDP differs from the AP model's price of its bits")

    seen = []

    def plain_gemm(x_q, w_q, *, n_planes):
        seen.append((tuple(x_q.shape), w_q.shape[1], n_planes))
        return bpm.bitplane_matmul_ref(x_q, w_q, n_planes)

    with mock.patch.object(ops, "bitplane_matmul", plain_gemm):
        plain_logits, _ = engine.serve(images, budgets)
    want_seen = [((M, K), N, n) for _, M, K, N, _ in gemms for n in fams]
    check(seen == want_seen, "the forward's GEMM shapes differ from the "
          "ones the kernel was held at")
    check(np.array_equal(plain_logits, logits),
          f"kernel logits != plain-version logits, max |diff| "
          f"{np.abs(plain_logits - logits).max()}")
    print(f"served {SERVED} batches of {BATCH} x {IMAGE}x{IMAGE}x3 -> "
          f"(B, 1000) logits: finite; mean wbits "
          f"{sorted({s.mean_wbits for s in stats})}; kernel launches "
          f"{ {n: c for n, c in launches.items() if c} } = {per_batch} per "
          f"batch (by path {paths}); per-image EDP == price_bit_matrix; "
          f"logits == plain-version "
          f"forward on the card; peak memory {peak_mb:.1f} MiB")

    # small input: the engine on the card agrees with the port on the CPU
    # (integer GEMMs are exact and the float math rounds identically, so
    # equality is expected; held to 1e-3 of the largest logit, equal argmax)
    g32 = torch.Generator().manual_seed(2)
    p32, l32 = cnn.init_cnn("resnet18", g32, image=32, device="cpu")
    c32 = cnn_budget_controller("resnet18", layers=l32)
    x32 = torch.randn((4, 32, 32, 3), generator=g32)
    b32 = [tight, preds[1] * 1.01, preds[3] * 1.01, loose]
    gpu32, s_gpu = CNNServeEngine(p32, l32, controller=c32, max_batch=4,
                                  device=dev).serve(x32, b32)
    cpu32, s_cpu = CNNServeEngine(p32, l32, controller=c32, max_batch=4,
                                  device="cpu").serve(x32, b32)
    diff = float(np.abs(gpu32 - cpu32).max())
    check(diff <= 1e-3 * float(np.abs(cpu32).max())
          and np.array_equal(gpu32.argmax(-1), cpu32.argmax(-1)),
          f"card vs CPU at 32 px: max |diff| {diff}")
    check([s.edp for s in s_gpu] == [s.edp for s in s_cpu],
          "card vs CPU per-image EDP")
    print(f"small input (ResNet18@32, B=4): card vs CPU max |logit diff| "
          f"{diff}, argmax equal")

    # ---- timings
    med = statistics.median(batch_s[1:])
    print(f"{tag} serve: median {med * 1e3:.3f} ms per batch of {BATCH} "
          f"({BATCH / med:.1f} images/s) over {SERVED - 1} batches after "
          f"one warm-up; all batch ms "
          f"{[round(t * 1e3, 3) for t in batch_s]}")
    per_shape = {(M, K, N, n): b.gemm_row(M, K, N, n)
                 for M, K, N in shapes for n in fams}
    # one served batch's 42 launches, summed over the path's layers
    tot = [0.0] * 7
    bound_ms = 0.0
    for _, M, K, N, _ in gemms:
        for n in fams:
            row = per_shape[(M, K, N, n)]
            tot = [a + r for a, r in zip(tot, row)]
            bound_ms += max(row[3], row[4])
    k_ms, p_ms, l_ms, t_bytes, t_ops, d_ms, ld_ms = tot
    print(f"{tag} bitplane_matmul per served batch ({per_batch} launches): "
          f"kernel {k_ms:.4f} ms (device {d_ms:.4f}), plain {p_ms:.4f} ms, "
          f"torch._int_mm "
          f"{l_ms:.4f} ms (device {ld_ms:.4f}), bound {bound_ms:.4f} ms "
          f"({bound_ms / k_ms:.3f} of bound); batch wall {med * 1e3:.3f} ms")

    # ---- where one served batch's time goes
    trace(torch, tag, "one served batch",
          lambda: engine.serve(images, budgets), ("bitplane_matmul",))
    del engine, params
    torch.cuda.empty_cache()
    return {"launches": sum(launches.values()), "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound_ms, "t_bytes": t_bytes, "t_ops": t_ops,
            "library_ms": l_ms, "device_ms": d_ms, "library_device_ms": ld_ms,
            "paths": paths, "wall_ms": med * 1e3, "logits": logits,
            "per_shape": per_shape}


# ---------------------------------------------------------------------------
# Path 2: AlexNet at full width, (a) bit-fluid serving, (b) fixed INT4
# ---------------------------------------------------------------------------

def alexnet_configs():
    from repro_torch.core.policy import fixed
    return {"int4": fixed(4), "int8": fixed(8)}


def check_paths(label, got, per_unit, units, plan, shapes):
    """Launches by path against the expectation per unit of work, and
    against what the kernel's plan says for the path's shapes (x at an
    aligned base): on a mismatch, print why."""
    want = {p: n * units for p, n in per_unit.items()}
    planned: dict = {}
    for M, K, N in shapes:
        path = plan(M, K, N).path
        planned[path] = planned.get(path, 0) + units
    check(got == want, f"{label} launches by path {got}, expected {want}; "
          f"the plans of the path's shapes give {planned} with x at "
          f"16-byte aligned bases, so an x that arrived unaligned moves "
          f"large_m launches to large_m_copy_x")


def reset_gemm_launches():
    from repro_torch.kernels import bitplane_matmul as bpm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int4_matmul as i4mm
    from repro_torch.kernels import quant_matmul as qmm
    for mod in (bpm, fa, i4mm, qmm):
        mod.reset_launches()


def on_device(qparams, dev):
    return {k: {n: t.to(dev) for n, t in v.items()}
            for k, v in qparams.items()}


def alexnet_path(b: Bench) -> dict:
    """AlexNet@227, B=16, random weights from seed 0, both forms:
    (a) CNNServeEngine.serve on the energy-axis int4/int8 controller:
        every GEMM on the bit-grouped path, the grouped convs slice by
        slice, the bit-plane kernel at n_planes 4 and 8;
    (b) the fixed-INT4 container-width forward, cnn_forward(qp, x,
        layers) with no bit vectors: the five ungrouped layers through
        int4_matmul, the grouped int8 stacks through the bit-plane kernel
        at 8 planes;
    and (c) the fixed-precision int8 GEMMs of one forward through the
    fused-epilogue entry ops.quant_matmul (each layer's own act, bf16
    out), the only way either package reaches that kernel."""
    torch, dev, tag = b.torch, b.dev, b.tag
    import numpy as np
    from repro_torch.apsim import metrics as apm
    from repro_torch.core.policy import cnn_budget_controller
    from repro_torch.kernels import bitplane_matmul as bpm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int4_matmul as i4mm
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_matmul as qmm
    from repro_torch.models import cnn
    from repro_torch.serve.cnn import CNNServeEngine

    gen_cpu = torch.Generator().manual_seed(0)
    params, layers = cnn.init_cnn("alexnet", gen_cpu, image=ALEX_IMAGE,
                                  device=dev)
    gemms = path_gemms(layers, BATCH, ALEX_IMAGE)
    check([(n, K, N, G) for n, _, K, N, G in gemms] == ALEX_WIDTHS,
          f"AlexNet GEMMs {gemms} are not the published widths")
    acts = {l.name: "relu" if l.relu else "none" for l in layers}
    ungrouped = [(M, K, N) for _, M, K, N, G in gemms if G == 1]
    slices = sum(G for *_, G in gemms)            # GEMMs per bit family
    grouped_slices = sum(G for *_, G in gemms if G > 1)
    ctrl = cnn_budget_controller("alexnet", layers=layers,
                                 configs=alexnet_configs(), metric="energy")
    engine = CNNServeEngine(params, layers, controller=ctrl,
                            max_batch=BATCH, device=dev)
    fams = engine.families
    check(fams == (4, 8) and engine.int4_names == (),
          f"families {fams}, int4 layers {engine.int4_names}")
    qp4 = cnn.quantize_cnn_params(params, layers, container="int4")
    check(all(("q4" in qp4[n]) == (G == 1) for n, *_, G in gemms),
          "the int4 container did not pack exactly the ungrouped layers")

    # ---- every kernel at every GEMM shape of the path
    shapes = sorted({(M, K, N) for _, M, K, N, _ in gemms})
    for M, K, N in shapes:
        for n in fams:
            b.hold_bitplane(b.rand_i8((M, K)), b.rand_i8((K, N)), n)
    for M, K, N in ungrouped:
        for od in (torch.float32, torch.bfloat16):
            b.hold_int4(b.rand_i8((M, K)), b.rand_u8((K, N // 2)),
                        b.rand_scale(N), od)
    for name, M, K, N, _ in gemms:
        for od in (torch.float32, torch.bfloat16):
            b.hold_quant(b.rand_i8((M, K)), b.rand_i8((K, N)),
                         b.rand_scale(N), b.rand_scale(N), acts[name], od)
    print(f"kernel == plain: {len(shapes)} AlexNet@{ALEX_IMAGE} GEMM shapes "
          f"at B={BATCH} (grouped convs per group): bit-plane at n_planes "
          f"{fams}, int4_matmul at the {len(ungrouped)} ungrouped ones, "
          f"quant_matmul with each layer's act; "
          + ", ".join(f"({M},{K},{N})" for M, K, N in shapes))

    # ---- (a) bit-fluid serving on the energy controller
    e4, e8 = (ctrl.predicted_latency_s[k] for k in ("int4", "int8"))
    cycle = [e4 * 1.01, e8 * 1.01, 0.0, 1e30]      # int4, int8, int4, int8
    want_w = [4.0, 8.0, 4.0, 8.0]
    budgets = [cycle[i % 4] for i in range(BATCH)]
    img_gen = torch.Generator(device=dev).manual_seed(1)
    images = torch.randn((BATCH, ALEX_IMAGE, ALEX_IMAGE, 3),
                         generator=img_gen, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_gemm_launches()
    batch_s, outs = [], []
    for _ in range(SERVED):
        t0 = time.perf_counter()
        logits, stats = engine.serve(images, budgets)   # ends in a sync
        batch_s.append(time.perf_counter() - t0)
        outs.append((logits, stats))
    a_launches = bpm.launches_by_planes()
    a_paths = bpm.launches_by_path()
    check(i4mm.launches == 0 and sum(qmm.spec_launches.values()) == 0
          and fa.launch_count() == 0, "(a) launched a kernel off its path")
    peak_a = torch.cuda.max_memory_allocated() / 2 ** 20
    per_batch = slices * len(fams)
    check(sum(a_launches.values()) == per_batch * SERVED
          and all(a_launches[n] == slices * SERVED for n in fams),
          f"(a) bit-plane launches {a_launches}, expected {slices} per "
          f"family per batch x {SERVED} batches")
    logits, stats = outs[-1]
    check(logits.shape == (BATCH, 1000) and bool(np.isfinite(logits).all()),
          f"(a) logits {logits.shape}, finite {np.isfinite(logits).all()}")
    for lg, _ in outs[1:]:
        check(np.array_equal(lg, logits), "(a) batches of one input differ")
    check([s.mean_wbits for s in stats] == [want_w[i % 4]
                                            for i in range(BATCH)],
          f"(a) budgets resolved to {[s.mean_wbits for s in stats]}")
    costs = apm.price_bit_matrix(apm.network_gemms(layers),
                                 [s.wbits for s in stats],
                                 [s.abits for s in stats])
    check([c.edp for c in costs] == [s.edp for s in stats],
          "(a) per-image EDP differs from the AP model's price of its bits")
    seen = []

    def plain_gemm(x_q, w_q, *, n_planes):
        seen.append((tuple(x_q.shape), w_q.shape[1], n_planes))
        return bpm.bitplane_matmul_ref(x_q, w_q, n_planes)

    with mock.patch.object(ops, "bitplane_matmul", plain_gemm):
        plain_logits, _ = engine.serve(images, budgets)
    check(seen == [((M, K), N, n) for _, M, K, N, G in gemms
                   for _ in range(G) for n in fams],
          "(a) the forward's GEMM shapes differ from the held ones")
    check(np.array_equal(plain_logits, logits),
          f"(a) kernel logits != plain-version logits, max |diff| "
          f"{np.abs(plain_logits - logits).max()}")
    print(f"(a) served {SERVED} batches of {BATCH} x {ALEX_IMAGE}x"
          f"{ALEX_IMAGE}x3 -> (B, 1000) logits: finite; mean wbits per image "
          f"{[s.mean_wbits for s in stats[:4]]}...; bit-plane launches "
          f"{ {n: c for n, c in a_launches.items() if c} } = {per_batch} per "
          f"batch ({slices} GEMMs x {len(fams)} families; by path "
          f"{a_paths}); EDP == "
          f"price_bit_matrix (int4 {stats[0].edp:.6g}, int8 "
          f"{stats[1].edp:.6g} J*s); logits == plain-version forward on the "
          f"card; peak memory {peak_a:.1f} MiB")

    # ---- (b) the fixed-INT4 container-width forward
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_gemm_launches()
    fwd_s, fouts = [], []
    for _ in range(SERVED):
        t0 = time.perf_counter()
        out = cnn.cnn_forward(qp4, images, layers)
        torch.cuda.synchronize()
        fwd_s.append(time.perf_counter() - t0)
        fouts.append(out)
    b_i4, b_bp = i4mm.launches, bpm.launches_by_planes()
    b_paths, b_i4_paths = bpm.launches_by_path(), dict(i4mm.path_launches)
    peak_b = torch.cuda.max_memory_allocated() / 2 ** 20
    check(b_i4 == len(ungrouped) * SERVED,
          f"(b) int4_matmul launches {b_i4}, expected {len(ungrouped)} per "
          f"forward x {SERVED}")
    check_paths("(b) int4_matmul", b_i4_paths, INT4_PATHS, SERVED,
                i4mm.plan, ungrouped)
    check(sum(b_bp.values()) == b_bp[8] == grouped_slices * SERVED
          and sum(qmm.spec_launches.values()) == 0 and fa.launch_count() == 0,
          f"(b) bit-plane launches {b_bp}, expected {grouped_slices} per "
          f"forward at 8 planes")
    out4 = fouts[-1]
    check(out4.shape == (BATCH, 1000) and bool(torch.isfinite(out4).all()),
          "(b) logits shape or finiteness")
    for o in fouts[1:]:
        check(torch.equal(o, out4), "(b) forwards of one input differ")
    seen4 = []

    def plain_int4(x_q, w_packed, scale, *, out_dtype):
        seen4.append((tuple(x_q.shape), 2 * w_packed.shape[1]))
        return i4mm.int4_matmul_ref(x_q, w_packed, scale, out_dtype)

    with mock.patch.object(i4mm, "int4_matmul", plain_int4), \
            mock.patch.object(ops, "bitplane_matmul",
                              lambda x, w, *, n_planes:
                              bpm.bitplane_matmul_ref(x, w, n_planes)):
        plain4 = cnn.cnn_forward(qp4, images, layers)
    check(seen4 == [((M, K), N) for M, K, N in ungrouped],
          "(b) the int4 GEMM shapes differ from the held ones")
    check(torch.equal(plain4, out4), f"(b) kernel logits != plain-version "
          f"logits, max |diff| {float((plain4 - out4).abs().max())}")
    print(f"(b) fixed-INT4 forward x {SERVED} (B={BATCH}): logits finite, "
          f"identical across forwards, == plain-version forward on the card; "
          f"int4_matmul launches {len(ungrouped)} per forward (by path "
          f"{b_i4_paths}), bit-plane "
          f"{grouped_slices} per forward at n_planes 8 (by path {b_paths}); "
          f"peak memory "
          f"{peak_b:.1f} MiB")

    # ---- (c) one forward's int8 GEMMs through the fused-epilogue entry
    qp8 = engine.qparams
    drive = []
    for name, M, K, N, G in gemms:
        p = qp8[name]
        for g in range(G):
            q, s = (p["q"][g], p["s"][g]) if G > 1 else (p["q"], p["s"])
            drive.append((b.rand_i8((M, K)), q, 0.02 * s.float(),
                          p["b"].float()[g * N:(g + 1) * N], acts[name]))
    reset_gemm_launches()
    c_out = [ops.quant_matmul(x, q, s, bias, act=act,
                              out_dtype=torch.bfloat16)
             for x, q, s, bias, act in drive]
    torch.cuda.synchronize()
    c_launches, c_paths = qmm.launches_by_act(), qmm.launches_by_path()
    check(sum(c_launches.values()) == slices
          and sum(bpm.spec_launches.values()) == 0 and i4mm.launches == 0,
          f"(c) quant_matmul launches {c_launches}, expected {slices}")
    check_paths("(c) quant_matmul", c_paths, QUANT_PATHS, 1, qmm.plan,
                [(M, K, N) for _, M, K, N, G in gemms for _ in range(G)])
    for got, (x, q, s, bias, act) in zip(c_out, drive):
        check(torch.equal(got, qmm.quant_matmul_ref(x, q, s, bias, act,
                                                    torch.bfloat16)),
              f"(c) quant_matmul != plain version at {tuple(x.shape)} @ "
              f"{tuple(q.shape)}")
    print(f"(c) ops.quant_matmul over one forward's {slices} int8 GEMMs "
          f"(the layer's own weights, act relu / none, bf16 out): launches "
          f"{ {a: c for a, c in c_launches.items() if c} } (by path "
          f"{c_paths}), each == plain version")
    del drive, c_out

    # ---- small input: the card agrees with the port on the CPU
    g32 = torch.Generator().manual_seed(2)
    p32, l32 = cnn.init_cnn("alexnet", g32, image=32, device="cpu")
    c32 = cnn_budget_controller("alexnet", layers=l32,
                                configs=alexnet_configs(), metric="energy")
    x32 = torch.randn((4, 32, 32, 3), generator=g32)
    f4, f8 = (c32.predicted_latency_s[k] for k in ("int4", "int8"))
    b32 = [f4 * 1.01, f8 * 1.01, 0.0, 1e30]
    gpu32, s_gpu = CNNServeEngine(p32, l32, controller=c32, max_batch=4,
                                  device=dev).serve(x32, b32)
    cpu32, s_cpu = CNNServeEngine(p32, l32, controller=c32, max_batch=4,
                                  device="cpu").serve(x32, b32)
    check(np.array_equal(gpu32, cpu32), f"(a) card vs CPU at 32 px: max "
          f"|diff| {np.abs(gpu32 - cpu32).max()}")
    check([s.edp for s in s_gpu] == [s.edp for s in s_cpu],
          "(a) card vs CPU per-image EDP at 32 px")
    q32 = cnn.quantize_cnn_params(p32, l32, container="int4")
    i4_before = i4mm.launches
    g4 = cnn.cnn_forward(on_device(q32, dev), x32.to(dev), l32).cpu()
    check(i4mm.launches == i4_before + len(ungrouped),
          "(b) at 32 px did not run int4_matmul on every ungrouped layer")
    check(torch.equal(g4, cnn.cnn_forward(q32, x32, l32)),
          "(b) card vs CPU at 32 px")
    print("small input (AlexNet@32, B=4): (a) served logits and EDP and (b) "
          "fixed-INT4 logits on the card == the port on the CPU")

    # ---- timings
    med_a = statistics.median(batch_s[1:])
    med_b = statistics.median(fwd_s[1:])
    print(f"{tag} (a) serve: median {med_a * 1e3:.3f} ms per batch of {BATCH} "
          f"({BATCH / med_a:.1f} images/s) over {SERVED - 1} batches after "
          f"one warm-up; all batch ms {[round(t * 1e3, 3) for t in batch_s]}")
    print(f"{tag} (b) fixed-INT4 forward: median {med_b * 1e3:.3f} ms per "
          f"batch of {BATCH} ({BATCH / med_b:.1f} images/s); all ms "
          f"{[round(t * 1e3, 3) for t in fwd_s]}")
    bp_rows = {(M, K, N, n): b.gemm_row(M, K, N, n)
               for M, K, N in shapes for n in fams}
    i4_rows = {(M, K, N): b.int4_row(M, K, N) for M, K, N in ungrouped}
    q_rows = {(M, K, N, acts[name]): b.quant_row(M, K, N, acts[name],
                                                 torch.bfloat16)
              for name, M, K, N, _ in gemms}
    # the regime threshold at fc6's width: one row more takes the large-M
    # tile
    for M in (bpm.SMALL_M, bpm.SMALL_M + 1):
        b.int4_row(M, 9216, 4096)
        b.quant_row(M, 9216, 4096, "relu", torch.bfloat16)

    def total(rows, keys):
        tot = [0.0] * len(rows[keys[0]])
        bound = 0.0
        for key in keys:
            r = rows[key]
            tot = [a + x for a, x in zip(tot, r)]
            bound += max(r[3], r[4])
        out = {"ms": tot[0], "plain_ms": tot[1], "library_ms": tot[2],
               "t_bytes": tot[3], "t_ops": tot[4], "bound_ms": bound}
        if len(tot) > 5:
            out["device_ms"] = tot[5]
        if len(tot) > 6:
            out["library_device_ms"] = tot[6]
        return out

    bp_a = total(bp_rows, [(M, K, N, n) for _, M, K, N, G in gemms
                           for _ in range(G) for n in fams])
    bp_b = total(bp_rows, [(M, K, N, 8) for _, M, K, N, G in gemms if G > 1
                           for _ in range(G)])
    i4 = total(i4_rows, ungrouped)
    qm = total(q_rows, [(M, K, N, acts[name]) for name, M, K, N, G in gemms
                        for _ in range(G)])
    for label, t, wall in (("(a) bitplane_matmul per served batch", bp_a,
                            med_a),
                           ("(b) bitplane_matmul per INT4 forward", bp_b,
                            med_b),
                           ("(b) int4_matmul per INT4 forward", i4, med_b),
                           ("(c) quant_matmul per forward's GEMMs", qm,
                            None)):
        dev_note = (f" (device {t['device_ms']:.4f})" if "device_ms" in t
                    else "")
        lib_note = (f" (device {t['library_device_ms']:.4f})"
                    if "library_device_ms" in t else "")
        print(f"{tag} {label}: kernel {t['ms']:.4f} ms{dev_note}, plain "
              f"{t['plain_ms']:.4f} ms, torch._int_mm {t['library_ms']:.4f} "
              f"ms{lib_note}, bound {t['bound_ms']:.4f} ms "
              f"({'bytes' if t['t_bytes'] >= t['t_ops'] else 'operations'}; "
              f"{t['t_bytes'] / 1e3 * HBM_BYTES_PER_S / 1e6:.1f} MB), "
              f"{t['bound_ms'] / t['ms']:.3f} of bound"
              + (f"; wall {wall * 1e3:.3f} ms" if wall else ""))

    # ---- where the time goes
    trace(torch, tag, "(a) one served AlexNet batch",
          lambda: engine.serve(images, budgets), ("bitplane_matmul",))
    trace(torch, tag, "(b) one fixed-INT4 AlexNet forward",
          lambda: cnn.cnn_forward(qp4, images, layers),
          ("int4_matmul", "bitplane_matmul"))
    del engine, params, qp4
    torch.cuda.empty_cache()
    bp_a["launches"] = sum(a_launches.values())
    bp_a["paths"], bp_a["wall_ms"] = a_paths, med_a * 1e3
    bp_b["launches"] = sum(b_bp.values())
    bp_b["paths"], bp_b["wall_ms"] = b_paths, med_b * 1e3
    i4["launches"], i4["paths"] = b_i4, b_i4_paths
    qm["launches"], qm["paths"] = sum(c_launches.values()), c_paths
    return {"bitplane_served_batch": bp_a, "bitplane_int4_forward": bp_b,
            "int4": i4, "quant": qm}


# ---------------------------------------------------------------------------
# Path 3: Qwen3-4B long-prompt generate
# ---------------------------------------------------------------------------

def flash_tile() -> int:
    """The flash kernel's key tile (BKV in flash_attention.cu): the
    chunk at which the plain version rounds as the kernel does."""
    from repro_torch.kernels import flash_attention as fa
    return fa.KEY_TILE


def gate_logits(label, got, plain, other_plain):
    """``got`` against ``plain`` (the plain version at the kernel's key
    tile): within LOGIT_TOL x max|logit|, or no further than twice the
    distance from ``plain`` to ``other_plain`` (the same plain version at
    its default tile), the spread the contract's open tile allows."""
    diff = float((got - plain).abs().max())
    floor = float((plain - other_plain).abs().max())
    scale = float(plain.abs().max())
    same = (got.argmax(-1) == plain.argmax(-1)).tolist()
    same_plain = (other_plain.argmax(-1) == plain.argmax(-1)).tolist()
    print(f"{label}: max |diff| {diff:.6g} = {diff / scale:.4g} x "
          f"max|logit| {scale:.6g} (within {LOGIT_TOL}: "
          f"{diff <= LOGIT_TOL * scale}); the plain version at tile "
          f"{flash_tile()} and at its default tile apart by {floor:.6g} = "
          f"{floor / scale:.4g} x; argmax equal per row {same} (tile vs "
          f"tile {same_plain})")
    check(diff <= max(LOGIT_TOL * scale, 2 * floor),
          f"{label}: max |diff| {diff} > max({LOGIT_TOL} x {scale}, 2 x "
          f"{floor})")


def draw_lm_weights(torch, dev):
    """Qwen3-4B FULL's train-form weights drawn on the card from seed 0,
    quantized to the int8 serve form (the train form freed).  Returns
    (cfg, qparams); the same on every call on one card."""
    from repro_torch import configs
    from repro_torch.models import lm

    cfg = configs.get(LM_ARCH)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init_params(cfg, gen, device=dev)
    qparams = lm.quantize_params(params, cfg)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return cfg, qparams


def lm_weights(b: Bench):
    """Qwen3-4B FULL at its published widths (``draw_lm_weights``).
    Returns (cfg, qparams), shared by paths 3 to 6."""
    torch, dev = b.torch, b.dev
    t0 = time.perf_counter()
    cfg, qparams = draw_lm_weights(torch, dev)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.d_ff, cfg.vocab_size, cfg.head_dim) == LM_WIDTHS,
          f"{LM_ARCH} FULL is not the published width: {cfg}")
    print(f"{LM_ARCH} FULL: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size} (padded {cfg.padded_vocab}); weights drawn and "
          f"quantized on the card in {time.perf_counter() - t0:.3f} s; "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB resident")
    return cfg, qparams


def lm_cut(cfg, qparams, n_layers: int):
    """The model cut to its first ``n_layers`` layers at full width: the
    config, and the serve parameters with every layer stack sliced (views,
    nothing copied)."""
    def first(t):
        return {k: first(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[:n_layers]
    return (cfg.with_(n_layers=n_layers),
            {**qparams, "layers": first(qparams["layers"])})


def lm_linears(cfg):
    """(K, N) of a layer's seven serve linears, in order."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return [(d, H * hd), (d, KV * hd), (d, KV * hd), (H * hd, d),
            (d, cfg.d_ff), (d, cfg.d_ff), (cfg.d_ff, d)]


def flash_row(b: Bench, shape, label: str = "", Sk: int = 0,
              causal: bool = True) -> dict:
    """The flash kernel at ``shape`` (BH, S, hd) bf16, causal (or with
    ``Sk`` keys, not causal): its time, device time, the chunked plain
    version's and one scaled_dot_product_attention call's, and the bound
    (4*BH*Sq*Sk*hd flop, half of it causal; q, k, v read and out written
    once), each in ms per call."""
    torch = b.torch
    from repro_torch.kernels import flash_attention as fa
    BH, S, hd = shape
    Sk = Sk or S
    q = torch.randn(shape, generator=b.gen, device=b.dev).bfloat16()
    k = torch.randn((BH, Sk, hd), generator=b.gen, device=b.dev).bfloat16()
    v = torch.randn_like(k)
    flops, nbytes = fa.work(BH, S, Sk, hd, causal)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row = {"ms": b.time_ms(lambda: fa.flash_attention(q, k, v,
                                                      causal=causal)),
           "device_ms": b.device_ms(
               lambda: fa.flash_attention(q, k, v, causal=causal)),
           "plain_ms": b.time_ms(
               lambda: fa.flash_attention_chunked_ref(q, k, v, causal),
               reps=3),
           "library_ms": b.time_ms(lambda: sdpa(q[None], k[None], v[None],
                                                is_causal=causal)),
           "t_ops": flops / BF16_FLOPS_PER_S * 1e3,
           "t_bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    row["bound_ms"] = bound = max(row["t_ops"], row["t_bytes"])
    shape_s = tuple(shape) if Sk == S else (BH, S, Sk, hd)
    print(f"{b.tag} flash_attention {shape_s} "
          f"{'causal' if causal else 'not causal'} bf16{label}: kernel "
          f"{row['ms']:.4f} ms (device {row['device_ms']:.4f}), chunked "
          f"plain {row['plain_ms']:.4f} ms, scaled_dot_product_attention "
          f"{row['library_ms']:.4f} ms, bound {bound:.4f} ms "
          f"({'operations' if row['t_ops'] >= row['t_bytes'] else 'bytes'}: "
          f"{flops:.3e} flop, {nbytes / 1e6:.1f} MB), "
          f"{bound / row['ms']:.3f} of bound; "
          f"{flops / row['ms'] / 1e9:.1f} TFLOP/s")
    return row


def flash_entry(launches: int, row: dict, calls: int) -> dict:
    """The JSON line's flash entry: ``row`` (ms per call) times ``calls``."""
    return {"launches": launches, **{k: calls * v for k, v in row.items()}}


def lm_path(b: Bench, cfg, qparams) -> dict:
    torch, dev, tag = b.torch, b.dev, b.tag
    from repro_torch.apsim import metrics as apm
    from repro_torch.kernels import bitplane_matmul as bpm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine, default_controller

    L = cfg.n_layers
    d = cfg.d_model
    linears = lm_linears(cfg)
    fams = (4, 8)
    M_pre, M_dec = LM_B * LM_S, LM_B

    # ---- hold the bit-plane kernel at the LM GEMM shapes
    kn = sorted(set(linears))
    for M in (M_pre, M_dec):
        for K, N in kn:
            for n in fams:
                b.hold_bitplane(b.rand_i8((M, K)), b.rand_i8((K, N)), n)
    print(f"kernel == plain: {len(kn)} Qwen3-4B (K, N) shapes at M = "
          f"{M_pre} (prefill) and M = {M_dec} (decode) x n_planes {fams}")

    ctrl = default_controller(lm.n_bit_slots(cfg))
    engine = ServeEngine(cfg, qparams, max_len=LM_MAX_LEN, controller=ctrl,
                         device=dev)
    check(engine.families == fams, f"bit families {engine.families}")
    tok_gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (LM_B, LM_S),
                           generator=tok_gen, device=dev)
    batch = {"tokens": tokens}
    engine.set_budget(LM_BUDGETS)
    wmat, amat = ctrl.resolve(torch.tensor(LM_BUDGETS))
    mean_w = [float(r) for r in wmat.double().mean(dim=1)]
    want_w = [4.0, (8 + 4 * (L - 1)) / L, 8.0, 8.0][:len(mean_w)]
    check(all(abs(m - w) < 1e-9 for m, w in zip(mean_w, want_w)),
          f"budgets resolved to mean wbits {mean_w}, expected {want_w}")

    # ---- generate: one warm-up, then LM_CALLS counted and timed calls
    first = engine.generate(batch, LM_STEPS).cpu()
    per_call_bp = L * len(linears) * len(fams) * LM_STEPS
    per_call_pre = L * len(linears) * len(fams)       # the prefill's
    gen_s, bp_total, fa_total, peak = [], 0, 0, 0.0
    for _ in range(LM_CALLS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        bpm.reset_launches()
        fa.reset_launches()
        t0 = time.perf_counter()
        toks = engine.generate(batch, LM_STEPS).cpu()      # ends in a sync
        gen_s.append(time.perf_counter() - t0)
        bp, fl = bpm.launches_by_planes(), fa.launch_count()
        bp_paths = bpm.launches_by_path()
        peak = max(peak, torch.cuda.max_memory_allocated() / 2 ** 30)
        check(fl == L, f"flash launches per generate {fl}, expected {L}")
        check(sum(bp.values()) == per_call_bp,
              f"bit-plane launches per generate {bp}, expected "
              f"{per_call_bp}")
        check({n for n, c in bp.items() if c} == set(fams)
              and all(bp[n] == per_call_bp // 2 for n in fams),
              f"bit-plane launches outside the families {fams}: {bp}")
        check(bp_paths == {"small_m": per_call_bp - per_call_pre,
                           "large_m": per_call_pre, "large_m_copy_x": 0},
              f"bit-plane launches by path per generate {bp_paths}: the "
              f"prefill's {per_call_pre} should take the large-M regime "
              f"with x read in place, the decode steps the small-M one")
        check(toks.shape == (LM_B, LM_STEPS), f"tokens {tuple(toks.shape)}")
        check(torch.equal(toks, first), "repeated generate calls differ")
        bp_total += sum(bp.values())
        fa_total += fl
    check(bool(((first >= 0) & (first < cfg.vocab_size)).all()),
          "token ids outside the vocabulary")
    print(f"generate x {LM_CALLS} (B={LM_B}, S={LM_S}, {LM_STEPS} tokens): "
          f"tokens {tuple(first.shape)}, identical across calls; per call "
          f"flash launches {L}, bit-plane launches {per_call_bp} at "
          f"n_planes {fams} (by path {bp_paths}); mean wbits per row "
          f"{mean_w}; first row "
          f"{first[0].tolist()}")

    # ---- one prefill through the kernels against the plain versions.
    # The contract rounds P to bf16 before P.V but leaves the key tile
    # open, and a 36-layer random-weight stack is chaotic: one bf16 ulp in
    # attention flips activation quantizer steps that grow layer by layer,
    # so the chunked plain version at the kernel's tile and at its default
    # tile already give end logits tens of percent apart.  Hence:
    #  (a) bit-plane: with flash's chunked plain version in both runs, the
    #      kernel's prefill EQUALS the all-plain prefill;
    #  (b) flash: every layer's launch, on the path's own q/k/v, is within
    #      FLASH_TOL of the f32 oracle;
    #  (c) logits: against the plain version at the kernel's tile, within
    #      LOGIT_TOL x max|logit| or no further than twice the distance
    #      the tile alone makes (see gate_logits).
    wv, av = engine._bits()

    def run_prefill():
        cache = lm.empty_cache(cfg, LM_B, LM_MAX_LEN, device=dev)
        with engine.compute_ctx():
            logits, cache = lm.prefill(engine.qparams, batch, cfg, wv, av,
                                       cache)
        return logits[:, -1, :cfg.vocab_size].float(), cache

    def plain_gemm(x_q, w_q, *, n_planes):
        return bpm.bitplane_matmul_ref(x_q, w_q, n_planes)

    def chunked_flash(q, k, v, *, causal, window, scale=0.0, k_len=0):
        return fa.flash_attention_chunked_ref(q, k, v, causal, window)

    def tiled_flash(q, k, v, *, causal, window, scale=0.0, k_len=0):
        return fa.flash_attention_chunked_ref(q, k, v, causal, window,
                                              chunk=flash_tile())

    kernel_flash = fa.flash_attention
    layer_err = []

    def held_flash(q, k, v, *, causal, window, scale=0.0, k_len=0):
        out = kernel_flash(q, k, v, causal=causal, window=window, scale=scale)
        want = oracle_f32(q, k, v, causal, window)
        layer_err.append(float((out.float() - want).abs().max()))
        return out

    def prefill_with(**patches):
        mods = {"gemm": (ops, "bitplane_matmul"),
                "flash": (fa, "flash_attention")}
        ctx = [mock.patch.object(*mods[k], fn) for k, fn in patches.items()]
        for c in ctx:
            c.start()
        try:
            return run_prefill()[0]
        finally:
            for c in ctx:
                c.stop()

    bpm.reset_launches()
    l_chunked = prefill_with(flash=chunked_flash)
    check(sum(bpm.spec_launches.values()) == L * len(linears) * len(fams),
          f"bit-plane launches in one prefill: {bpm.launches_by_planes()}")
    bpm.reset_launches()
    fa.reset_launches()
    l_plain = prefill_with(gemm=plain_gemm, flash=chunked_flash)
    check(sum(bpm.spec_launches.values()) == 0 and fa.launch_count() == 0,
          "the plain-version prefill launched a kernel")
    check(torch.equal(l_chunked, l_plain), f"(a) prefill with the bit-plane "
          f"kernel != with its plain version: max |diff| "
          f"{float((l_chunked - l_plain).abs().max())}")
    l_kernels = prefill_with(flash=held_flash)
    check(len(layer_err) == L and max(layer_err) <= FLASH_TOL,
          f"(b) flash on the path's q/k/v vs the f32 oracle, per layer: "
          f"{layer_err}")
    l_tiled = prefill_with(flash=tiled_flash)
    check(bool(torch.isfinite(l_kernels).all()), "non-finite prefill logits")
    gate_logits("(c) prefill logits, kernels vs plain versions", l_kernels,
                l_tiled, l_chunked)
    print(f"(a) prefill with the bit-plane kernel == with its plain version "
          f"(flash plain in both); (b) flash on the path's own q/k/v vs "
          f"the f32 oracle: max |err| per layer {max(layer_err):.6g} "
          f"(min {min(layer_err):.6g}) over {L} layers")
    b.fa_err = max(b.fa_err, max(layer_err))

    # ---- prices against the AP model
    for budget in LM_BUDGETS:
        w, a = ctrl.resolve(torch.tensor(budget))
        want = apm.price_bit_vector(lm.layer_gemm_dims(cfg), w.tolist(),
                                    a.tolist(), head=lm.head_gemm_dims(cfg))
        got = engine.price_budget(budget)
        check(got == want, f"price_budget({budget}) differs from the AP "
              f"model's price of its bits")
    print("price_budget == apsim.price_bit_vector for every budget: EDP "
          + ", ".join(f"{bud:g} -> {engine.price_budget(bud).edp:.4g} J*s"
                      for bud in LM_BUDGETS))

    smoke_card_vs_cpu(b)

    # ---- timings
    med_gen = statistics.median(gen_s)
    pre_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits_pre, cache = run_prefill()
        torch.cuda.synchronize()
        pre_s.append(time.perf_counter() - t0)
    tok = logits_pre.argmax(-1)[:, None]
    dec_s = []
    t = torch.full((LM_B,), LM_S, dtype=torch.int32, device=dev)
    for _ in range(LM_STEPS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with engine.compute_ctx():
            logits, cache = lm.decode_step(engine.qparams, tok, t, cache,
                                           cfg, wv, av)
        torch.cuda.synchronize()
        dec_s.append(time.perf_counter() - t0)
        tok = logits[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
        t = t + 1
    pre, dec = statistics.median(pre_s), statistics.median(dec_s)
    print(f"{tag} generate: median {med_gen * 1e3:.3f} ms per call of "
          f"B={LM_B} x ({LM_S} prompt + {LM_STEPS} new) tokens "
          f"({LM_B * LM_STEPS / med_gen:.3f} new tokens/s); all call ms "
          f"{[round(s * 1e3, 3) for s in gen_s]}; peak memory {peak:.3f} GiB")
    print(f"{tag} prefill (time to first token): median {pre * 1e3:.3f} ms "
          f"({LM_B * LM_S / pre:.1f} prompt tokens/s); all "
          f"{[round(s * 1e3, 3) for s in pre_s]}")
    print(f"{tag} decode: median {dec * 1e3:.3f} ms per step "
          f"({LM_B / dec:.3f} tokens/s at B={LM_B}); all "
          f"{[round(s * 1e3, 3) for s in dec_s]}")

    fr = flash_row(b, FLASH_PATH)

    # the bit-plane GEMM shapes, and their sums over one generate call
    per_shape = {(M, K, N, n): b.gemm_row(M, K, N, n)
                 for M in (M_pre, M_dec) for K, N in kn for n in fams}
    tot = [0.0] * 7
    bound_ms = 0.0
    for K, N in linears:
        for n in fams:
            for M, reps in ((M_pre, 1), (M_dec, LM_STEPS - 1)):
                row = per_shape[(M, K, N, n)]
                tot = [a + reps * L * r for a, r in zip(tot, row)]
                bound_ms += reps * L * max(row[3], row[4])
    bk_ms, bp_ms, bl_ms, bt_bytes, bt_ops, bd_ms, bld_ms = tot
    print(f"{tag} bitplane_matmul per generate call ({per_call_bp} "
          f"launches): kernel {bk_ms:.4f} ms (device {bd_ms:.4f}), plain "
          f"{bp_ms:.4f} ms, "
          f"torch._int_mm {bl_ms:.4f} ms (device {bld_ms:.4f}), bound "
          f"{bound_ms:.4f} ms "
          f"({bound_ms / bk_ms:.3f} of bound); flash per generate call "
          f"({L} launches): kernel {L * fr['ms']:.4f} ms, bound "
          f"{L * fr['bound_ms']:.4f} ms; generate wall {med_gen * 1e3:.3f} ms")

    # the regime threshold: both sides of bpm.SMALL_M at a decode shape
    for M in (bpm.SMALL_M, bpm.SMALL_M + 1, 4 * bpm.SMALL_M):
        b.gemm_row(M, d, cfg.d_ff, 8)

    # ---- where one prefill's and one decode step's time goes
    trace(torch, tag, "one prefill", run_prefill,
          ("bitplane_matmul", "flash_attention"))
    _, cache = run_prefill()
    tok = torch.zeros((LM_B, 1), dtype=torch.long, device=dev)
    t = torch.full((LM_B,), LM_S, dtype=torch.int32, device=dev)

    def one_step():
        with engine.compute_ctx():
            lm.decode_step(engine.qparams, tok, t, cache, cfg, wv, av)

    trace(torch, tag, "one decode step", one_step, ("bitplane_matmul",))
    return {
        "bitplane": {"launches": bp_total, "ms": bk_ms, "plain_ms": bp_ms,
                     "bound_ms": bound_ms, "t_bytes": bt_bytes,
                     "t_ops": bt_ops, "library_ms": bl_ms,
                     "device_ms": bd_ms, "library_device_ms": bld_ms,
                     "paths": bp_paths},
        "e2e": {"prefill_ms": pre * 1e3, "decode_ms": dec * 1e3,
                "generate_ms": med_gen * 1e3},
        "flash": flash_entry(fa_total, fr, L)}


# ---------------------------------------------------------------------------
# Path 4: Qwen3-4B continuous batching and speculative decoding
# ---------------------------------------------------------------------------

def cb_requests(vocab: int, n: int, prompt_range, new_range, seed: int):
    """``n`` requests drawn from ``seed``: (prompt, max_new_tokens,
    budget), budgets cycling LM_BUDGETS (int4, mixed, int8, int8)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt_range[0], prompt_range[1] + 1, n)
    news = rng.integers(new_range[0], new_range[1] + 1, n)
    return [(rng.integers(0, vocab, (int(S),)).astype(np.int32), int(m),
             LM_BUDGETS[i % len(LM_BUDGETS)])
            for i, (S, m) in enumerate(zip(lens, news))]


def cb_serve(engine, reqs, upfront: int, late_tick: int, draft_ks=None,
             prefixes=None):
    """Submit ``reqs[:upfront]`` now and the rest through ``submit_at`` at
    ``late_tick`` (each with its vlm prefix from ``prefixes``), then
    ``run()``.  Returns (rids in request order, run
    seconds, {rid: time of the first token}, per-tick (seconds, tokens,
    rows) of vanilla ticks and of speculative rounds, {rid: tokens
    delivered by vanilla ticks}, {rid: tokens delivered by rounds})."""
    import numpy as np
    ticks, rounds = [], []
    by_tick: dict = {}
    by_round: dict = {}
    tick, rnd = engine._decode_tick, engine._spec_round

    def timed(fn, log, where):
        def call(active, *args):
            rids = [int(engine.slots.rid[s]) for s in np.nonzero(active)[0]]
            before = {r: len(engine.requests[r].tokens) for r in rids}
            t0 = time.perf_counter()
            fn(active, *args)                   # ends in a host copy
            dt = time.perf_counter() - t0
            got = {r: len(engine.requests[r].tokens) - n
                   for r, n in before.items()}
            for r, n in got.items():
                where[r] = where.get(r, 0) + n
            log.append((dt, sum(got.values()), len(rids)))
        return call

    engine._decode_tick = timed(tick, ticks, by_tick)
    engine._spec_round = timed(rnd, rounds, by_round)
    rids = []

    def submit(i):
        prompt, m, budget = reqs[i]
        kw = {} if draft_ks is None or draft_ks[i] is None \
            else {"draft_k": draft_ks[i]}
        if prefixes is not None:
            kw["prefix"] = prefixes[i]
        rids.append(engine.submit(prompt, max_new_tokens=m, budget_s=budget,
                                  **kw))

    try:
        for i in range(upfront):
            submit(i)
        for i in range(upfront, len(reqs)):
            engine.submit_at(late_tick, lambda i=i: submit(i))
        t0 = time.perf_counter()
        engine.run()
        wall = time.perf_counter() - t0
    finally:
        del engine._decode_tick, engine._spec_round
    first_at = {r: engine.requests[r].first_token_s for r in rids}
    return rids, wall, first_at, ticks, rounds, by_tick, by_round


def cb_standalone(engine, prompt, max_new: int, budget, prefill_len: int,
                  prefix=None):
    """One request alone: ``lm.prefill(lengths=)`` at batch 1 on the
    engine's padded row (behind its vlm ``prefix``), then a
    ``decode_step`` loop at the same bits, greedy.  Returns (tokens, the
    top-2 logit gap of each step over max|logit|)."""
    import torch
    from repro_torch.models import lm
    dev, cfg = engine.device, engine.cfg
    V = cfg.vocab_size
    wv, av = engine.controller.resolve(torch.tensor(budget))
    wv, av = wv.to(dev), av.to(dev)
    S = len(prompt)
    toks = torch.zeros((1, prefill_len), dtype=torch.int32)
    toks[0, :S] = torch.from_numpy(prompt)
    batch = {"tokens": toks.to(dev)}
    P = 0
    if prefix is not None:
        batch["prefix"] = torch.as_tensor(prefix)[None].to(dev)
        P = batch["prefix"].shape[1]
    cache = lm.empty_cache(cfg, 1, engine.max_len, device=dev)
    out, gaps = [], []

    def take(logits):
        lg = logits[0, -1, :V].float()
        top2 = lg.topk(2).values
        gaps.append((top2[0] - top2[1]) / lg.abs().max())
        out.append(lg.argmax().to(torch.int32))
        return out[-1].reshape(1, 1)

    with engine.compute_ctx():
        logits, cache = lm.prefill(engine.qparams, batch, cfg, wv, av, cache,
                                   lengths=torch.tensor([S]).to(dev))
        tok = take(logits)
        for i in range(max_new - 1):
            logits, cache = lm.decode_step(engine.qparams, tok,
                                           torch.tensor([P + S + i]).to(dev),
                                           cache, cfg, wv, av)
            tok = take(logits)
    return (torch.stack(out).cpu().tolist(),
            torch.stack(gaps).cpu().tolist())


def tokens_agree(label, got, want, gaps):
    """``got`` against ``want`` (greedy streams of one request): EQUAL, or
    equal up to the first step whose top-2 logit gap (in ``gaps``, the
    run that gave ``want``) is under LOGIT_TOL x max|logit|: the rule for
    a float-order difference, where a near-tie may legitimately go the
    other way.  Returns (tokens compared, exact?)."""
    if got == want:
        return len(want), True
    close = [i for i, g in enumerate(gaps) if g < LOGIT_TOL]
    n = close[0] if close else len(want)
    first = next(i for i, (a, c) in enumerate(zip(got, want)) if a != c) \
        if len(got) == len(want) else min(len(got), len(want))
    check(len(got) == len(want) and first >= n,
          f"{label}: tokens part at step {first} (gap {gaps[first]:.4g} of "
          f"max|logit|), before the first step with a gap under "
          f"{LOGIT_TOL} (step {n}): got {got}, want {want}")
    return n, False


def row_independence(b: Bench, cfg) -> None:
    """The decode path's float reductions give a row the same bits among
    1, 8 and 72 rows (a decode tick's and a verify chunk's row counts):
    ``rms_norm`` and the decode attention (``_sdpa_rows``), both summed
    by ``common.row_sum``.  Printed beside them, what the library's own
    reductions do at the same widths."""
    torch, dev = b.torch, b.dev
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tf
    H, KV, hd, Sc = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 1064
    x = torch.randn((72, 1, cfg.d_model), generator=b.gen,
                    device=dev).to(cm.DTYPE)
    scale = torch.randn((cfg.d_model,), generator=b.gen, device=dev)
    q = torch.randn((72, 1, H, hd), generator=b.gen, device=dev).to(cm.DTYPE)
    kv = torch.randn((72, Sc, KV, hd), generator=b.gen,
                     device=dev).to(cm.DTYPE)
    bias = torch.zeros((72, 1, Sc), device=dev)
    rows = (1, 8, 72)
    norm = [cm.rms_norm(x[:m], scale, cfg.norm_eps)[0] for m in rows]
    attn = [tf._sdpa_rows(q[:m], kv[:m], kv[:m], bias[:m])[0] for m in rows]
    lib_norm = [(x[:m].float() ** 2).mean(-1)[0] for m in rows]
    lib_attn = [tf._sdpa(q[:m], kv[:m], kv[:m], bias[:m], cfg)[0]
                for m in rows]

    def same(v):
        return [torch.equal(v[0], v[1]), torch.equal(v[1], v[2])]

    check(same(norm) == [True, True] and same(attn) == [True, True],
          f"a row's rms_norm / decode attention depends on the rows beside "
          f"it: 1 vs 8, 8 vs 72 rows {same(norm)} / {same(attn)}")
    print(f"row independence on the card: rms_norm and _sdpa_rows give "
          f"row 0 the same bits among 1, 8 and 72 rows; the library's "
          f"mean and batched-matmul attention (1 vs 8, 8 vs 72 rows): "
          f"{same(lib_norm)}, {same(lib_attn)}")


def cb_smoke_card_vs_cpu(b: Bench) -> None:
    """Path 4 at SMOKE size: the same continuous and speculative streams
    on the card and on the CPU (plain versions there) give the same
    tokens, up to the float-order rule against the CPU's standalone gaps
    (the two devices' float libraries round apart)."""
    torch = b.torch
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serve.engine import (SPEC_K_MAX, ServeEngine,
                                          default_controller)
    scfg = configs.get_smoke(LM_ARCH)
    sg = torch.Generator().manual_seed(3)
    sqp = lm.quantize_params(lm.init_params(scfg, sg, device="cpu"), scfg)
    reqs = cb_requests(scfg.vocab_size, 6, (3, CB_SMOKE_PREFILL),
                       (6, 12), seed=5)
    kw = dict(max_len=CB_SMOKE_PREFILL + 12 + SPEC_K_MAX, n_slots=3,
              prefill_len=CB_SMOKE_PREFILL, decode_block=4)
    toks = {}
    for where, on in (("card", b.dev), ("cpu", torch.device("cpu"))):
        for spec in (None, CB_SPEC_K):
            eng = ServeEngine(scfg, sqp, controller=default_controller(
                lm.n_bit_slots(scfg)), device=on, spec_k=spec,
                draft_budget_s=CB_DRAFT_BUDGET, **kw)
            rids = cb_serve(eng, reqs, 4, 1)[0]
            toks[where, spec] = [eng.requests[r].tokens for r in rids]
    ref = ServeEngine(scfg, sqp, controller=default_controller(
        lm.n_bit_slots(scfg)), device="cpu", **kw)
    compared, exact = 0, 0
    for i, (prompt, m, budget) in enumerate(reqs):
        want, gaps = cb_standalone(ref, prompt, m, budget, CB_SMOKE_PREFILL)
        check(toks["cpu", None][i] == want and toks["cpu", CB_SPEC_K][i]
              == want, f"SMOKE request {i} on the CPU: continuous "
              f"{toks['cpu', None][i]}, speculative "
              f"{toks['cpu', CB_SPEC_K][i]}, standalone {want}")
        for spec in (None, CB_SPEC_K):
            n, same = tokens_agree(f"SMOKE request {i} (spec_k={spec}) card "
                                   f"vs CPU", toks["card", spec][i], want,
                                   gaps)
            compared += n
            exact += same
    print(f"SMOKE {LM_ARCH} continuous + speculative (6 requests, 3 slots, "
          f"spec_k={CB_SPEC_K}): card vs CPU tokens exact in {exact} of 12 "
          f"streams, {compared} tokens compared; on the CPU continuous == "
          f"speculative == standalone")


def cb_path(b: Bench, cfg, qparams) -> dict:
    torch, dev, tag = b.torch, b.dev, b.tag
    import numpy as np
    from repro_torch.apsim import metrics as apm
    from repro_torch.kernels import bitplane_matmul as bpm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int4_matmul as i4mm
    from repro_torch.kernels import quant_matmul as qmm
    from repro_torch.models import lm
    from repro_torch.models.transformer import EMPTY_POS
    from repro_torch.serve.engine import (SPEC_K_MAX, ServeEngine,
                                          default_controller)

    L, V = cfg.n_layers, cfg.vocab_size
    linears = lm_linears(cfg)
    kn = sorted(set(linears))
    fams = (4, 8)
    M_pre, M_dec, M_ver = CB_PREFILL, CB_SLOTS, CB_SLOTS * (SPEC_K_MAX + 1)
    max_len = CB_PREFILL + CB_NEW[1] + SPEC_K_MAX
    reqs = cb_requests(V, CB_REQUESTS, CB_PROMPT, CB_NEW, seed=4)

    row_independence(b, cfg)

    # ---- hold the bit-plane kernel at the path's shapes: the prefill row
    # at the container width, the tick and the verify chunk per family
    for K, N in kn:
        b.hold_bitplane(b.rand_i8((M_pre, K)), b.rand_i8((K, N)), 8)
        for M in (M_dec, M_ver):
            for n in fams:
                b.hold_bitplane(b.rand_i8((M, K)), b.rand_i8((K, N)), n)
    print(f"kernel == plain: {len(kn)} Qwen3-4B (K, N) shapes at M = "
          f"{M_pre} (prefill row, n_planes 8), M = {M_dec} (decode tick) "
          f"and M = {M_ver} (verify chunk) x n_planes {fams}")

    ctrl = default_controller(lm.n_bit_slots(cfg))
    common = dict(max_len=max_len, controller=ctrl, n_slots=CB_SLOTS,
                  prefill_len=CB_PREFILL, decode_block=CB_BLOCK, device=dev)

    def reset():
        torch.cuda.synchronize()
        bpm.reset_launches()
        fa.reset_launches()
        i4mm.reset_launches()
        qmm.reset_launches()

    def launches():
        return (bpm.launches_by_shape(), bpm.launches_by_path(),
                fa.launch_count(), i4mm.launches,
                sum(qmm.spec_launches.values()))

    # ---- (a) vanilla continuous batching
    eng_a = ServeEngine(cfg, qparams, **common)
    check(eng_a.families == fams, f"bit families {eng_a.families}")
    reset()
    rids_a, wall_a, first_a, ticks_a, _, _, _ = cb_serve(
        eng_a, reqs, CB_UPFRONT, CB_LATE_TICK)
    shapes_a, paths_a, fl, i4, qm = launches()
    check(fl == 0 and i4 == 0 and qm == 0, f"(a) launched flash {fl}, "
          f"int4 {i4}, quant {qm} times: not on this path")
    recs_a = [eng_a.requests[r] for r in rids_a]
    tok_a = [r.tokens for r in recs_a]
    check(all(r.done for r in recs_a) and eng_a.stats.unserved == 0,
          "(a) left requests unserved")
    check(all(len(t) == m for t, (_, m, _) in zip(tok_a, reqs)),
          "(a) delivered the wrong number of tokens")
    check(all(0 <= x < V for t in tok_a for x in t),
          "(a) token ids outside the vocabulary")
    check(eng_a.pool.free_slots == CB_SLOTS
          and bool((eng_a.pool.cache["kpos"] == EMPTY_POS).all()),
          "(a) after run(): a slot is still held or a kpos is not EMPTY_POS")
    check(sorted(r.slot for r in recs_a[:CB_SLOTS]) == list(range(CB_SLOTS))
          and recs_a[-1].submitted_tick == CB_LATE_TICK,
          "(a) the slots did not recycle as submitted")
    for r, (_, m, budget) in zip(recs_a, reqs):
        wv, av = eng_a.host_bits(budget)
        want = apm.price_bit_vector(lm.layer_gemm_dims(cfg), wv.tolist(),
                                    av.tolist(), head=lm.head_gemm_dims(cfg))
        check(r.ap_cost == eng_a.price_bits(wv, av) == want,
              f"(a) request {r.rid}: ap_cost differs from the AP model's "
              f"price of its bits")
    print(f"(a) continuous: {CB_REQUESTS} requests ({CB_UPFRONT} up front, "
          f"{CB_REQUESTS - CB_UPFRONT} at tick {CB_LATE_TICK}), prompts "
          f"{[len(p) for p, _, _ in reqs]}, new tokens "
          f"{[m for _, m, _ in reqs]}; {eng_a.stats.ticks} ticks, calls "
          f"{eng_a.calls}; all slots free and every kpos EMPTY_POS after "
          f"run(); ap_cost == price_bits(host_bits(budget)) per request")

    # ---- each request alone: batch-1 prefill + decode_step loop
    t0 = time.perf_counter()
    alone = [cb_standalone(eng_a, p, m, bud, CB_PREFILL)
             for p, m, bud in reqs]
    alone_s = time.perf_counter() - t0
    for i, (got, (want, _)) in enumerate(zip(tok_a, alone)):
        check(got == want, f"(a) request {i} != the request alone: got "
              f"{got}, want {want}")
    print(f"(a) == each request alone (batch-1 prefill + decode_step loop, "
          f"{alone_s:.3f} s): all {CB_REQUESTS} requests, "
          f"{sum(len(t) for t in tok_a)} tokens EQUAL")

    # ---- (b) speculative decoding on 8 of the requests, each to its
    # first CB_SPEC_NEW tokens (a greedy stream's prefix)
    eng_b = ServeEngine(cfg, qparams, spec_k=CB_SPEC_K,
                        draft_budget_s=CB_DRAFT_BUDGET, **common)
    reqs_b = [(p, min(m, CB_SPEC_NEW), bud)
              for p, m, bud in reqs[:CB_SPEC_REQUESTS]]
    draft_ks = [0 if i == CB_DRAFT0 else None for i in range(len(reqs_b))]
    reset()
    rids_b, wall_b, first_b, ticks_b, rounds_b, by_tick, by_round = \
        cb_serve(eng_b, reqs_b, len(reqs_b), 0, draft_ks)
    shapes_b, paths_b, fl, i4, qm = launches()
    check(fl == 0 and i4 == 0 and qm == 0, f"(b) launched flash {fl}, "
          f"int4 {i4}, quant {qm} times")
    recs_b = [eng_b.requests[r] for r in rids_b]
    check(all(r.done for r in recs_b) and eng_b.pool.free_slots == CB_SLOTS
          and bool((eng_b.pool.cache["kpos"] == EMPTY_POS).all()),
          "(b) after run(): a request unserved, a slot held or a kpos set")
    for i, r in enumerate(recs_b):
        want = tok_a[i][:reqs_b[i][1]]
        check(r.tokens == want, f"(b) request {i} != (a)'s first "
              f"{len(want)}: got {r.tokens}, want {want}")
        rid = r.rid
        if r.spec_k:
            check(r.draft_units == r.spec_k * r.spec_rounds
                  and r.verify_units == (r.spec_k + 1) * r.spec_rounds
                  and r.spec_tokens == r.accepted_units + r.spec_rounds
                  and r.spec_tokens == by_round.get(rid, 0),
                  f"(b) request {i}: spec ledger {r.spec_rounds} rounds, "
                  f"{r.draft_units} drafted, {r.verify_units} verified, "
                  f"{r.accepted_units} accepted, {r.spec_tokens} delivered "
                  f"by rounds ({by_round.get(rid, 0)} counted)")
        else:
            check(r.spec_rounds == r.draft_units == 0,
                  f"(b) request {i} (draft_k=0) drafted")
        check(1 + by_round.get(rid, 0) + by_tick.get(rid, 0)
              == len(r.tokens) == reqs_b[i][1],
              f"(b) request {i}: 1 + {by_round.get(rid, 0)} (rounds) + "
              f"{by_tick.get(rid, 0)} (ticks) != {len(r.tokens)} delivered")
        _, m, budget = reqs_b[i]
        check(r.ap_cost == eng_b.price_bits(*eng_b.host_bits(budget)),
              f"(b) request {i}: ap_cost")
    drafted = sum(r.draft_units for r in recs_b)
    accepted = sum(r.accepted_units for r in recs_b)
    n_rounds = sum(r.spec_rounds for r in recs_b)
    spec_toks = sum(r.spec_tokens for r in recs_b)
    print(f"(b) speculative (spec_k={CB_SPEC_K}, int4 drafts, request "
          f"{CB_DRAFT0} at draft_k=0, the first {CB_SPEC_NEW} new tokens "
          f"each): tokens == (a)'s for all {len(recs_b)} requests; "
          f"{len(rounds_b)} "
          f"rounds, {len(ticks_b)} vanilla ticks, calls {eng_b.calls}; "
          f"accept rate {accepted / max(drafted, 1):.4f} ({accepted} of "
          f"{drafted} drafts); {spec_toks / max(n_rounds, 1):.4f} tokens "
          f"delivered per request-round; the ledger adds up to the tokens "
          f"delivered")

    # ---- launches by regime and by M against plan()
    shapes = dict(shapes_a)
    for k, v in shapes_b.items():
        shapes[k] = shapes.get(k, 0) + v
    calls = {k: eng_a.calls[k] + eng_b.calls[k] for k in eng_a.calls}
    per_fwd = {M_pre: (calls["prefill"], (8,)),
               M_dec: (calls["decode"] + calls["draft"], fams),
               M_ver: (calls["verify"], fams)}
    want_shapes: dict = {}
    want_paths = {p: 0 for p in bpm.PATHS}
    for M, (n_fwd, nps) in per_fwd.items():
        for _ in range(L):
            for K, N in linears:
                for n in nps:
                    key = (M, K, N, n)
                    want_shapes[key] = want_shapes.get(key, 0) + n_fwd
                    want_paths[bpm.plan(M, K, N).path] += n_fwd
    want_shapes = {k: v for k, v in want_shapes.items() if v}
    paths = {p: paths_a[p] + paths_b[p] for p in bpm.PATHS}
    by_m = {M: sum(v for k, v in shapes.items() if k[0] == M)
            for M in per_fwd}
    check(shapes == want_shapes, f"bit-plane launches by shape "
          f"{sorted(shapes.items())} != {sorted(want_shapes.items())}")
    check(paths == want_paths, f"bit-plane launches by regime {paths} != "
          f"plan()'s {want_paths}")
    check(all(by_m[M] > 0 for M in per_fwd),
          f"a regime of the path never launched: {by_m}")
    print(f"bit-plane launches on path 4: by M {by_m} ((a) "
          f"{sum(shapes_a.values())}, (b) {sum(shapes_b.values())}); by "
          f"regime {paths}, as plan() gives for M = {M_pre}, {M_dec}, "
          f"{M_ver}: " + ", ".join(f"{M} -> {bpm.plan(M, *kn[0]).path}"
                                    for M in per_fwd))

    cb_smoke_card_vs_cpu(b)

    # ---- timings
    ttft = sorted(first_a[r] - eng_a.requests[r].submitted_s
                  for r in rids_a)
    tps = sorted(n / s for s, n, _ in ticks_a)
    print(f"{tag} (a) run(): {wall_a:.3f} s wall for {CB_REQUESTS} requests, "
          f"{sum(len(t) for t in tok_a)} tokens; time to first token median "
          f"{statistics.median(ttft) * 1e3:.3f} ms, max {ttft[-1] * 1e3:.3f} "
          f"ms (all {[round(x * 1e3, 3) for x in ttft]}); decode tokens/s "
          f"per tick median {statistics.median(tps):.3f} (all "
          f"{[round(x, 3) for x in tps]}; {CB_BLOCK} steps a tick, "
          f"{[n for _, _, n in ticks_a]} rows)")
    rps = sorted(n / s for s, n, _ in rounds_b)
    ttft_b = sorted(first_b[r] - eng_b.requests[r].submitted_s
                    for r in rids_b)
    print(f"{tag} (b) run(): {wall_b:.3f} s wall for {len(recs_b)} requests; "
          f"time to first token median {statistics.median(ttft_b) * 1e3:.3f} "
          f"ms, max {ttft_b[-1] * 1e3:.3f} ms; per round median "
          f"{statistics.median([s for s, _, _ in rounds_b]) * 1e3:.3f} ms, "
          f"tokens/s per round median {statistics.median(rps):.3f}; tokens "
          f"per round (all rows) {[n for _, n, _ in rounds_b]}")
    per_shape = {k: b.gemm_row(*k) for k in sorted(shapes)}
    parts = {}
    for label, sh in (("a", shapes_a), ("b", shapes_b)):
        dev_sum = sum(n * per_shape[k][5] for k, n in sh.items())
        parts[label] = dev_sum
        by = {M: sum(n * per_shape[k][5] for k, n in sh.items()
                     if k[0] == M) for M in per_fwd}
        print(f"{tag} bitplane_matmul device-clock sum per run() ({label}): "
              f"{dev_sum:.4f} ms over {sum(sh.values())} launches; by M "
              + ", ".join(f"{M}: {v:.4f} ms" for M, v in by.items()))
    tot = [sum(n * per_shape[k][j] for k, n in shapes.items())
           for j in range(7)]
    bound_ms = sum(n * max(per_shape[k][3], per_shape[k][4])
                   for k, n in shapes.items())

    # (the profiler traces of a prefill row, a decode tick and a spec
    # round that stood here left to pay for path 17: PERF.md section 4)
    bk_ms, bp_ms, bl_ms, bt_bytes, bt_ops, bd_ms, bld_ms = tot
    return {
        "bitplane": {"launches": sum(shapes.values()), "ms": bk_ms,
                     "plain_ms": bp_ms, "bound_ms": bound_ms,
                     "t_bytes": bt_bytes, "t_ops": bt_ops,
                     "library_ms": bl_ms, "device_ms": bd_ms,
                     "library_device_ms": bld_ms, "paths": paths},
        "e2e": {"run_a_s": wall_a, "run_b_s": wall_b,
                "ttft_median_ms": statistics.median(ttft) * 1e3},
        "tokens": tok_a, "per_shape": per_shape}


# ---------------------------------------------------------------------------
# Path 5: the prefix cache and the closed loop
# ---------------------------------------------------------------------------

def pc_stream(engine, trace, late, budget, use_budgets=True, order=None):
    """Replay ``trace`` through ``engine`` with ``TraceReplayer``, plus the
    ``late`` prompts, submitted through ``submit_at`` at PC_LATE_TICK
    (``sched_tick`` submits them when its clock gets there).  Just before
    they arrive, every prefix-cache entry's row and logits are cloned.
    ``admit_record`` is wrapped to log each admission in order with the
    bits it resolved; the walls and first-token times are the records'
    own clocks.  Returns a dict: the replay's result and wall, the rids of
    the trace's arrivals and of the late ones, the admission order
    (``order``, or the list given), each admission's (wbits, abits) by
    rid, and the entries' clones by content key."""
    import torch
    from repro_torch.serve.traffic import TraceReplayer
    out = {"order": [] if order is None else order, "bits": {},
           "late": [], "entries_before": {}}
    admit = engine.admit_record

    def logged(record, *args, **kw):
        wv, av = admit(record, *args, **kw)
        out["order"].append(record.rid)
        out["bits"][record.rid] = (wv.clone(), av.clone())
        return wv, av

    def snapshot():
        if engine.prefix_cache is not None:
            out["entries_before"] = {
                key: ({k: v.clone() for k, v in e.row_cache.items()},
                      e.logits.clone())
                for key, e in engine.prefix_cache.entries.items()}

    engine.submit_at(PC_LATE_TICK, snapshot)
    for p in late:
        engine.submit_at(PC_LATE_TICK, lambda p=p: out["late"].append(
            engine.submit(p, max_new_tokens=PC_TRACE["max_new_tokens"],
                          budget_s=budget if use_budgets else None)))
    engine.admit_record = logged
    try:
        t0 = time.perf_counter()
        out["result"] = TraceReplayer(trace, {LM_ARCH: engine},
                                      use_budgets=use_budgets).replay()
        if engine.device.type == "cuda":
            torch.cuda.synchronize()
        out["wall"] = time.perf_counter() - t0
    finally:
        del engine.admit_record
    check(not engine._arrivals and len(out["late"]) == len(late),
          "a deferred arrival was never submitted")
    out["trace_rids"] = [r for r in sorted(engine.requests)
                         if r not in out["late"]]
    return out


def pc_trace(vocab: int, *, prompt_len: int, keep: int, prefix: int,
             fresh: int):
    """The path's trace (PC_TRACE at ``prompt_len``, seed PC_SEED) and its
    late prompts: for each of the first PC_SOURCES keys of the trace, the
    key's prompt's first ``keep`` tokens plus ``fresh`` fresh ones (a
    chunk-aligned partial hit, tail ``fresh``) and its first ``prefix``
    tokens exactly (the strict prefix: keep ``prefix`` - 1, tail 1).
    Returns (trace, the late prompts, the keep each should hit with, the
    prompt each extends)."""
    import numpy as np
    from repro_torch.serve.traffic import payload_tokens, synth_trace
    tr = synth_trace("poisson", seed=PC_SEED,
                     **dict(PC_TRACE, prompt_len=prompt_len))
    first: dict = {}
    for r in tr.requests:
        first.setdefault(r.key, r)
    check(len(first) >= PC_SOURCES, f"the trace holds {len(first)} keys, "
          f"fewer than the {PC_SOURCES} the late prompts extend")
    rng = np.random.default_rng(PC_SEED + 100)
    late, keeps, sources = [], [], []
    for r in list(first.values())[:PC_SOURCES]:
        src = payload_tokens(tr, r, vocab)
        check(r.t < PC_LATE_TICK and src.shape[0] > keep,
              f"key {r.key} first arrives at tick {r.t} with "
              f"{src.shape[0]} tokens: not stored before tick "
              f"{PC_LATE_TICK}, or not past {keep} tokens")
        new = rng.integers(0, vocab, (fresh,)).astype(np.int32)
        late += [np.concatenate([src[:keep], new]), src[:prefix].copy()]
        keeps += [keep, prefix - 1]
        sources += [src, src]
    return tr, late, keeps, sources


def pc_expect(trace, late, keeps, vocab):
    """The cache ledger the trace implies when nothing is evicted: a
    key's first arrival misses, each repeat is a full hit, every late
    prompt is a partial hit at its keep, and each miss and partial hit
    stores a new entry."""
    from repro_torch.serve.traffic import payload_tokens
    seen, hits, hit_tok, comp = set(), 0, 0, 0
    for r in trace.requests:
        S = payload_tokens(trace, r, vocab).shape[0]
        if r.key in seen:
            hits, hit_tok = hits + 1, hit_tok + S
        else:
            seen.add(r.key)
            comp += S
    hit_tok += sum(keeps)
    comp += sum(len(p) - k for p, k in zip(late, keeps))
    return {"hits": hits, "partial_hits": len(late), "misses": len(seen),
            "lookups": trace.n_requests + len(late), "hit_tokens": hit_tok,
            "computed_tokens": comp, "refreshes": 0, "evictions": 0,
            "rejected": 0, "entries": len(seen) + len(late)}


class LogitGaps:
    """Records, per request, each sampled step's top-2 logit gap over
    max|logit| (the near-tie measure of ``tokens_agree``) while an engine
    runs: the first token from ``_sample_first`` (the request being
    admitted is the last one picked) and every decode step's rows."""

    def __init__(self, engine, order):
        import repro_torch.serve.engine as emod
        self.emod, self.engine, self.order = emod, engine, order
        self.gaps: dict = {}
        self.sample = emod._sample_tokens
        emod._sample_tokens = self.wrapped

    def wrapped(self, logits, gen, temp, topk, rows=None):
        V = self.engine.cfg.vocab_size
        lg = logits[..., :V].float()
        top2 = lg.topk(2, dim=-1).values
        gap = ((top2[:, 0] - top2[:, 1]) / lg.abs().amax(-1)).cpu().tolist()
        if logits.shape[0] == 1 and self.order:
            rids = [self.order[-1]]
        else:
            rids = self.engine.slots.rid.tolist()
        for rid, g in zip(rids, gap):
            if rid >= 0:
                self.gaps.setdefault(rid, []).append(g)
        return self.sample(logits, gen, temp, topk, rows)

    def close(self):
        self.emod._sample_tokens = self.sample


def pc_smoke_card_vs_cpu(b: Bench) -> None:
    """Path 5 (a) and (b) at Qwen3-4B SMOKE and (c) at 32 px, on the card
    and on the CPU (plain versions there): the LM streams equal up to the
    float-order rule of ``tokens_agree`` (against the CPU run's own
    gaps), the cache ledgers, the admissions' budgets and bits and the AP
    records EQUAL; the CNN replay's entries and every batch's logits
    EQUAL."""
    torch = b.torch
    import numpy as np
    from repro_torch import configs
    from repro_torch.core.policy import (FluidController,
                                         cnn_budget_controller)
    from repro_torch.models import cnn, lm
    from repro_torch.serve.cnn import CNNServeEngine
    from repro_torch.serve.engine import ServeEngine, default_controller
    from repro_torch.serve.prefix_cache import PrefixCache
    from repro_torch.serve.traffic import TraceReplayer, synth_trace

    scfg = configs.get_smoke(LM_ARCH)
    sg = torch.Generator().manual_seed(6)
    sqp = lm.quantize_params(lm.init_params(scfg, sg, device="cpu"), scfg)
    n = lm.n_bit_slots(scfg)
    tr, late, _, _ = pc_trace(scfg.vocab_size, prompt_len=PC_SMOKE_PREFILL,
                              keep=8, prefix=4, fresh=4)
    slo = PC_SLO_FRACTION * int8_charge(scfg, tr, late, PC_SMOKE_PREFILL)
    kw = dict(max_len=PC_SMOKE_PREFILL + PC_TRACE["max_new_tokens"],
              n_slots=3, prefill_len=PC_SMOKE_PREFILL, decode_block=4)
    runs = {}
    for where, on in (("card", b.dev), ("cpu", torch.device("cpu"))):
        for loop in ("a", "b"):
            if loop == "a":
                ctrl = default_controller(n)
            else:
                ctrl = FluidController.from_open_loop(
                    edp_controller(scfg, n, PC_SMOKE_PREFILL), slo=slo,
                    window=tr.n_requests + 2)
            eng = ServeEngine(scfg, sqp, controller=ctrl, device=on,
                              prefix_cache=PrefixCache(
                                  chunk=4, capacity=PC_CAPACITY,
                                  hit_policy="exact"), **kw)
            order: list = []
            gaps = LogitGaps(eng, order)
            try:
                out = pc_stream(eng, tr, late, PC_INT8_BUDGET,
                                use_budgets=loop == "a", order=order)
            finally:
                gaps.close()
            runs[where, loop] = (eng, out, gaps.gaps)
    compared = exact = 0
    for loop in ("a", "b"):
        (ce, co, _), (pe, po, pgaps) = runs["card", loop], runs["cpu", loop]
        check(co["order"] == po["order"] and
              ce.prefix_cache.ledger.as_dict()
              == pe.prefix_cache.ledger.as_dict(),
              f"SMOKE ({loop}) card vs CPU: admission order or ledger")
        for rid in po["order"]:
            c, p = ce.requests[rid], pe.requests[rid]
            check((c.budget_s, c.mean_wbits, c.cache_hit, c.cached_units,
                   c.planned_units, c.edp) == (p.budget_s, p.mean_wbits,
                                               p.cache_hit, p.cached_units,
                                               p.planned_units, p.edp),
                  f"SMOKE ({loop}) request {rid}: card vs CPU records")
            got, same = tokens_agree(
                f"SMOKE ({loop}) request {rid} card vs CPU", c.tokens,
                p.tokens, pgaps[rid][:len(p.tokens)])
            compared += got
            exact += same
        if loop == "b":
            check((ce.controller.spent, ce.controller.saved)
                  == (pe.controller.spent, pe.controller.saved),
                  "SMOKE (b) card vs CPU: controller state")
    n_streams = sum(len(runs["cpu", lp][1]["order"]) for lp in ("a", "b"))
    kinds = [runs["cpu", "a"][0].requests[r].cache_hit or "miss"
             for r in runs["cpu", "a"][1]["order"]]
    print(f"SMOKE {LM_ARCH} prefix cache (a) and closed loop (b), "
          f"{tr.n_requests} + {len(late)} arrivals, hit kinds {kinds}: card "
          f"vs CPU tokens exact in {exact} of {n_streams} streams "
          f"({compared} tokens compared); ledgers, budgets, bits and AP "
          f"records EQUAL")

    # (c) at 32 px: a spike trace through the closed loop
    g32 = torch.Generator().manual_seed(7)
    p32, l32 = cnn.init_cnn("resnet18", g32, image=32, device="cpu")
    base = cnn_budget_controller("resnet18", layers=l32)
    med = base.predicted_latency_s["hawqv3-medium"]
    spike = dict(SPIKE, ticks=10, burst_at=3, burst_len=2, rate=2.0)
    got = {}
    for where, on in (("card", b.dev), ("cpu", "cpu")):
        ctrl = FluidController.from_open_loop(
            base, slo=SPIKE_WINDOW * 2 * med, window_ticks=SPIKE_WINDOW)
        eng = CNNServeEngine(p32, l32, controller=ctrl, max_batch=4,
                             device=on)
        logits = []
        serve = eng.serve
        eng.serve = lambda x, bud: logits.append(serve(x, bud)) or logits[-1]
        res = TraceReplayer(synth_trace("spike", **spike), {},
                            cnn_engines={"resnet18": eng}, image_hw=32,
                            use_budgets=False).replay()
        got[where] = (res, [lg for lg, _ in logits])
    (cres, clog), (pres, plog) = got["card"], got["cpu"]
    check(cres.entries == pres.entries and len(clog) == len(plog)
          and all(np.array_equal(x, y) for x, y in zip(clog, plog)),
          "SMOKE (c) ResNet18@32 spike replay: card vs CPU entries or "
          "logits differ")
    print(f"ResNet18@32 spike replay (closed loop, {len(cres.entries)} "
          f"images in {len(clog)} batches, mean wbits "
          f"{sorted({e['mean_wbits'] for e in cres.entries})}): card vs "
          f"CPU entries and logits EQUAL")


def int8_charge(cfg, tr, late, prompt_len):
    """The EDP an open-loop int8 engine without a cache charges for the
    trace and the late prompts: each request's prompt plus its new tokens
    at the int8 price (the closed loop's SLO is a fraction of it)."""
    import numpy as np
    from repro_torch.models import lm
    from repro_torch.serve.accounting import BitVectorPricer, axis_cost
    from repro_torch.serve.traffic import payload_tokens
    n = lm.n_bit_slots(cfg)
    cost = BitVectorPricer(lm.layer_gemm_dims(cfg),
                           head=lm.head_gemm_dims(cfg)).price(
        np.full((n,), 8), np.full((n,), 8))
    lens = [len(payload_tokens(tr, r, cfg.vocab_size)) for r in tr.requests]
    return sum(axis_cost(cost, "edp", S + PC_TRACE["max_new_tokens"])
               for S in lens + [len(p) for p in late])


def edp_controller(cfg, n, prompt_len):
    """The default controller's three configurations priced on the EDP
    axis for a request of ``prompt_len`` + PC_TRACE's new tokens: the
    closed loop's prediction table."""
    from repro_torch.core.policy import BudgetController
    from repro_torch.models import lm
    from repro_torch.serve.accounting import predict_table
    from repro_torch.serve.engine import default_controller
    base = default_controller(n)
    preds = predict_table(
        lm.layer_gemm_dims(cfg), base.configs, axis="edp",
        units=prompt_len + PC_TRACE["max_new_tokens"],
        head=lm.head_gemm_dims(cfg))
    return BudgetController(dict(base.configs), preds, n, budget_axis="edp")


def pc_path(b: Bench, cfg, qparams) -> dict:
    torch, dev, tag = b.torch, b.dev, b.tag
    from repro_torch.apsim import metrics as apm
    from repro_torch.core.policy import FluidController
    from repro_torch.kernels import bitplane_matmul as bpm
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.models.transformer import EMPTY_POS
    from repro_torch.serve.accounting import axis_cost
    from repro_torch.serve.engine import ServeEngine, default_controller
    from repro_torch.serve.prefix_cache import PrefixCache
    from repro_torch.serve.traffic import payload_tokens

    L, V = cfg.n_layers, cfg.vocab_size
    n = lm.n_bit_slots(cfg)
    linears = lm_linears(cfg)
    kn = sorted(set(linears))
    fams = (4, 8)
    per_row = L * len(linears)          # launches of one forward at 8 planes
    gemms, head = lm.layer_gemm_dims(cfg), lm.head_gemm_dims(cfg)
    NEW = PC_TRACE["max_new_tokens"]
    key_of = PrefixCache.content_key

    tr, late, keeps, sources = pc_trace(
        V, prompt_len=PC_TRACE["prompt_len"], keep=PC_KEEP, prefix=PC_PREFIX,
        fresh=PC_FRESH)
    keys = [r.key for r in tr.requests]
    repeats = len(keys) - len(set(keys))
    print(f"path 5 trace (poisson, {PC_TRACE['ticks']} ticks, rate "
          f"{PC_TRACE['rate']}, repetition {PC_TRACE['repetition']}, seed "
          f"{PC_SEED}): {tr.n_requests} arrivals at ticks "
          f"{[r.t for r in tr.requests]}, keys {keys} ({repeats} "
          f"repeats), prompts "
          f"{[len(payload_tokens(tr, r, V)) for r in tr.requests]}; "
          f"{len(late)} late at tick {PC_LATE_TICK}: "
          f"{[len(p) for p in late]} tokens (of the first {PC_SOURCES} "
          f"keys' prompts: the first {PC_KEEP} + {PC_FRESH} fresh, and the "
          f"first {PC_PREFIX})")
    check(repeats >= 3, f"the trace holds {repeats} repeated keys: too few "
          f"full hits to time")

    # ---- hold the bit-plane kernel at the extension's GEMV shape (M = 1,
    # 8 planes: its bits arrive per layer); M = 1024 and 8 are path 4's
    for K, N in kn:
        b.hold_bitplane(b.rand_i8((1, K)), b.rand_i8((K, N)), 8)
    print(f"kernel == plain: {len(kn)} Qwen3-4B (K, N) shapes at M = 1 "
          f"(partial-hit extension, n_planes 8)")

    common = dict(max_len=PC_MAX_LEN, n_slots=CB_SLOTS, prefill_len=CB_PREFILL,
                  decode_block=CB_BLOCK, device=dev)

    def cache():
        return PrefixCache(chunk=PC_CHUNK, capacity=PC_CAPACITY,
                           hit_policy="exact")

    def counted(fn):
        torch.cuda.synchronize()
        reset_gemm_launches()
        out = fn()
        return out, bpm.launches_by_shape()

    def by_m(shapes):
        out: dict = {}
        for (M, _, _, _), c in shapes.items():
            out[M] = out.get(M, 0) + c
        return out

    def want_shapes(calls):
        want: dict = {}
        for M, n_fwd, nps in ((CB_PREFILL, calls["prefill"], (8,)),
                              (1, calls["extend"], (8,)),
                              (CB_SLOTS, calls["decode"], fams)):
            for K, N in linears:
                for npl in nps:
                    if n_fwd:
                        key = (M, K, N, npl)
                        want[key] = want.get(key, 0) + n_fwd * L
        return want

    def drained(eng, label):
        check(eng.pool.free_slots == CB_SLOTS
              and bool((eng.pool.cache["kpos"] == EMPTY_POS).all()),
              f"{label}: after the replay a slot is held or a kpos is not "
              f"EMPTY_POS")

    # ---- (a) open loop, fixed int8: with the cache, then without
    eng_c = ServeEngine(cfg, qparams, controller=default_controller(n),
                        prefix_cache=cache(), **common)
    run_c, shapes_c = counted(lambda: pc_stream(eng_c, tr, late,
                                                PC_INT8_BUDGET))
    eng_u = ServeEngine(cfg, qparams, controller=default_controller(n),
                        **common)
    run_u, shapes_u = counted(lambda: pc_stream(eng_u, tr, late,
                                                PC_INT8_BUDGET))
    for label, eng, run in (("(a) cached", eng_c, run_c),
                            ("(a) uncached", eng_u, run_u)):
        recs = [eng.requests[r] for r in sorted(eng.requests)]
        check(run["result"].unserved == 0 and all(
            r.done and len(r.tokens) == NEW for r in recs),
              f"{label}: a request unserved or short")
        check(all(0 <= x < V for r in recs for x in r.tokens),
              f"{label}: token ids outside the vocabulary")
        check(all(r.mean_wbits == 8.0 for r in recs),
              f"{label}: a request left int8")
        drained(eng, label)
        for r in recs:
            wv, av = eng.host_bits(r.budget_s)
            want = apm.price_bit_vector(gemms, wv.tolist(), av.tolist(),
                                        head=head)
            u = r.ap_units
            check(r.ap_cost == want and r.edp == (u * want.energy_j)
                  * (u * want.latency_s),
                  f"{label} request {r.rid}: AP record differs from the AP "
                  f"model's price of its bits")
    check(run_c["trace_rids"] == run_u["trace_rids"]
          and run_c["late"] == run_u["late"],
          "(a) the two replays numbered their requests differently")
    led = eng_c.prefix_cache.ledger
    want_led = pc_expect(tr, late, keeps, V)
    got_led = dict(led.as_dict(), entries=len(eng_c.prefix_cache))
    check({k: got_led[k] for k in want_led} == want_led,
          f"(a) cache ledger {got_led} != the trace's {want_led}")
    kinds = {r: eng_c.requests[r].cache_hit or "miss"
             for r in sorted(eng_c.requests)}
    full = [r for r, k in kinds.items() if k == "full"]
    miss = [r for r, k in kinds.items() if k == "miss"]
    partial = [r for r, k in kinds.items() if k == "partial"]
    check(partial == run_c["late"] and len(full) == want_led["hits"]
          and [eng_c.requests[r].cached_units for r in partial] == keeps,
          f"(a) hit kinds {kinds}, partial keeps "
          f"{[eng_c.requests[r].cached_units for r in partial]} != {keeps}")
    for r in full:
        check(eng_c.requests[r].tokens == eng_u.requests[r].tokens,
              f"(a) full hit {r}: tokens {eng_c.requests[r].tokens} != the "
              f"uncached run's {eng_u.requests[r].tokens}")

    # the entries as they stood when the late prompts arrived are bitwise
    # unchanged after every extension from them
    before = run_c["entries_before"]
    check(set(map(key_of, sources)) <= set(before),
          "(a) a late prompt's source entry was not resident when it came")
    for key, (row, logits) in before.items():
        e = eng_c.prefix_cache.entries[key]
        check(torch.equal(e.logits, logits)
              and all(torch.equal(e.row_cache[k], v) for k, v in row.items()),
              f"(a) the entry of a {len(e.tokens)}-token prompt changed "
              f"while partial hits extended from it")

    # each partial hit against a replay with the plain version patched in:
    # the source entry's row cloned and masked to keep, decode_step per
    # tail token (logits and row EQUAL the refreshed entry the extension
    # stored), then a batch-1 greedy decode_step loop
    seen = []

    def plain_gemm(x_q, w_q, *, n_planes):
        seen.append(x_q.shape[0])
        return bpm.bitplane_matmul_ref(x_q, w_q, n_planes)

    part_lines = []
    for rid, prompt, keep, src in zip(partial, late, keeps, sources):
        rec = eng_c.requests[rid]
        wv, av = (t.to(dev) for t in run_c["bits"][rid])
        stored = eng_c.prefix_cache.entries.get(key_of(prompt))
        check(stored is not None, f"(a) partial hit {rid} stored no entry")
        row = {k: v.clone() for k, v in before[key_of(src)][0].items()}
        row["kpos"].masked_fill_(row["kpos"] >= keep, EMPTY_POS)
        tokens = torch.from_numpy(prompt)[None].to(dev)
        toks, gaps = [], []
        with mock.patch.object(ops, "bitplane_matmul", plain_gemm), \
                eng_c.compute_ctx():
            for pos in range(keep, len(prompt)):
                logits, row = lm.decode_step(
                    eng_c.qparams, tokens[:, pos:pos + 1], pos, row, cfg,
                    wv, av)
            check(torch.equal(logits, stored.logits) and all(
                torch.equal(row[k], v) for k, v in stored.row_cache.items()),
                  f"(a) partial hit {rid}: the extension's logits or row != "
                  f"the plain-version replay's (max |logit diff| "
                  f"{(logits - stored.logits).abs().max().item()})")
            for i in range(NEW):
                lg = logits[0, -1, :V].float()
                top2 = lg.topk(2).values
                gaps.append(float((top2[0] - top2[1]) / lg.abs().max()))
                toks.append(int(lg.argmax()))
                if i + 1 < NEW:
                    logits, row = lm.decode_step(
                        eng_c.qparams, torch.tensor([[toks[-1]]], device=dev),
                        rec.prompt_len + i, row, cfg, wv, av)
        check(toks == rec.tokens, f"(a) partial hit {rid}: tokens "
              f"{rec.tokens} != the plain-version replay's {toks}")
        fresh = eng_u.requests[rid].tokens
        r = len(prompt) - keep
        if fresh == toks:
            part_lines.append(f"{rid} (keep {keep}, tail {r}): equals the "
                              f"uncached stream")
        else:
            d = next(i for i, (x, y) in enumerate(zip(toks, fresh)) if x != y)
            part_lines.append(f"{rid} (keep {keep}, tail {r}): parts from "
                              f"the uncached stream at step {d}, top-2 gap "
                              f"{gaps[d]:.4g} of max|logit| there")
    check(set(seen) == {1}, f"plain replay GEMM rows {set(seen)}")
    print(f"(a) partial hits == the plain-version replay (logits, extended "
          f"row and {NEW} tokens each; the entries bitwise unchanged): "
          + "; ".join(part_lines))

    # launches by M against the engine's calls and plan(); the full hits
    # add no prefill row
    for label, eng, sh in (("cached", eng_c, shapes_c),
                           ("uncached", eng_u, shapes_u)):
        check(eng.calls["decode"] % CB_BLOCK == 0, f"(a) {label} decode "
              f"steps {eng.calls['decode']} not whole ticks")
        check(sh == want_shapes(eng.calls), f"(a) {label} bit-plane launches "
              f"by shape {sorted(sh.items())} != the calls' "
              f"{eng.calls} x {per_row} per forward")
    m_c, m_u = by_m(shapes_c), by_m(shapes_u)
    tail = sum(len(p) - k for p, k in zip(late, keeps))
    check(m_c.get(CB_PREFILL, 0) == led.misses * per_row
          and m_c.get(1, 0) == tail * per_row
          and eng_c.calls["extend"] == tail
          and m_u.get(CB_PREFILL, 0) == want_led["lookups"] * per_row
          and 1 not in m_u,
          f"(a) launches by M: cached {m_c}, uncached {m_u}; misses "
          f"{led.misses}, {tail} tail tokens, {per_row} launches per forward")
    avoided = m_u[CB_PREFILL] - m_c[CB_PREFILL]
    print(f"(a) prefix cache, open loop, int8: ledger {led.as_dict()} == the "
          f"trace's; full hits {full} tokens == the uncached run's; "
          f"bit-plane launches by M: cached {m_c}, uncached {m_u} (calls "
          f"{eng_c.calls} / {eng_u.calls}); M = {CB_PREFILL} launches the "
          f"hits avoided: {avoided} ({avoided // per_row} prefill rows); "
          f"all slots free and every kpos EMPTY_POS after each replay; AP "
          f"records == the AP model")

    # ---- (b) closed loop with the cache
    base = edp_controller(cfg, n, PC_TRACE["prompt_len"])
    charged_u = sum(eng_u.requests[r].axis_planned("edp")
                    for r in eng_u.requests)
    check(charged_u == int8_charge(cfg, tr, late, PC_TRACE["prompt_len"]),
          "(a) the uncached run's EDP charge")
    slo = PC_SLO_FRACTION * charged_u
    window = tr.n_requests + len(late)
    fluid = FluidController.from_open_loop(base, slo=slo, window=window)
    eng_b = ServeEngine(cfg, qparams, controller=fluid, prefix_cache=cache(),
                        **common)
    run_b, shapes_b = counted(lambda: pc_stream(eng_b, tr, late, None,
                                                use_budgets=False))
    recs_b = [eng_b.requests[r] for r in run_b["order"]]
    check(run_b["result"].unserved == 0 and len(recs_b) == window
          and all(r.done for r in recs_b), "(b) a request unserved")
    drained(eng_b, "(b)")
    check(shapes_b == want_shapes(eng_b.calls),
          f"(b) bit-plane launches by shape != the calls' {eng_b.calls}")
    spend = sum(r.axis_planned("edp") for r in recs_b)
    # a fresh controller fed each admission's charge, computed here from
    # the AP model's price of its bits over its miss units: a full hit
    # charges the new tokens only, a partial hit its tail and new tokens
    late_keep = dict(zip(run_b["late"], keeps))
    fresh_c = FluidController.from_open_loop(base, slo=slo, window=window)
    for r in recs_b:
        wv, av = (t.tolist() for t in run_b["bits"][r.rid])
        eff = fresh_c.admission_budget(None)
        fw, fa_ = fresh_c.resolve(eff)
        check(eff == r.budget_s and (fw.tolist(), fa_.tolist()) == (wv, av),
              f"(b) request {r.rid}: effective budget {r.budget_s} / bits "
              f"!= the host-only replay's {eff}")
        S = r.prompt_len
        cached = {"full": S, "partial": late_keep.get(r.rid, -1),
                  "": 0}[r.cache_hit]
        units = S + NEW - cached
        cost = apm.price_bit_vector(gemms, wv, av, head=head)
        check(r.cached_units == cached and r.planned_units == units,
              f"(b) request {r.rid} ({r.cache_hit or 'miss'}): charged "
              f"{r.planned_units} units with {r.cached_units} cached, want "
              f"{units} with {cached}")
        fresh_c.charge(axis_cost(cost, "edp", units))
        if cached:
            fresh_c.record_saved(axis_cost(cost, "edp", S + NEW)
                                 - axis_cost(cost, "edp", units))
        u = r.ap_units
        check(r.ap_cost == cost and r.edp == (u * cost.energy_j)
              * (u * cost.latency_s),
              f"(b) request {r.rid}: AP record != the AP model's price")
    check((fluid.spent, fluid.served, fluid.saved)
          == (fresh_c.spent, fresh_c.served, fresh_c.saved),
          f"(b) controller state {(fluid.spent, fluid.served, fluid.saved)} "
          f"!= the host-only replay's "
          f"{(fresh_c.spent, fresh_c.served, fresh_c.saved)}")
    check(spend <= 1.1 * slo, f"(b) spent {spend} > 1.1 x the SLO {slo}")
    check(fluid.saved > 0, "(b) the cache saved the window nothing")
    kinds_b = [r.cache_hit or "miss" for r in recs_b]
    print(f"(b) closed loop (EDP SLO {slo:.6g} J*s = {PC_SLO_FRACTION} x the "
          f"{charged_u:.6g} the uncached run would charge, window {window}): "
          f"spent {spend:.6g} ({spend / slo:.4f} x the SLO), saved "
          f"{fluid.saved:.6g}; mean wbits by admission "
          f"{[r.mean_wbits for r in recs_b]}, hit kinds {kinds_b}; budgets, "
          f"bits and charges (the AP price of each admission's miss units) "
          f"== a host-only FluidController replay; AP records == the AP "
          f"model; launches by M {by_m(shapes_b)}")

    # ---- (c) ResNet18 under a traffic spike, open and closed loop
    cnn_r = pc_cnn(b)

    pc_smoke_card_vs_cpu(b)

    # ---- timings by hit kind, from the records' clocks
    def ms(xs):
        return (f"median {statistics.median(xs) * 1e3:.3f} ms (n = "
                f"{len(xs)}, all {[round(x * 1e3, 3) for x in xs]})")

    def wall(eng, r):
        rec = eng.requests[r]
        return rec.first_token_s - rec.admitted_s

    def ttft(eng, r):
        rec = eng.requests[r]
        return rec.first_token_s - rec.submitted_s

    by_tail: dict = {}
    for r, p, k in zip(partial, late, keeps):
        by_tail.setdefault(len(p) - k, []).append(r)
    kind_rids = [("miss", miss), ("full hit", full)] + [
        (f"partial hit, tail {t}", rs) for t, rs in sorted(by_tail.items())]
    print(f"{tag} (a) admission wall by hit kind (picked to first token on "
          f"the host): " + "; ".join(
              f"{k} {ms([wall(eng_c, r) for r in rs])}"
              for k, rs in kind_rids)
          + "; per tail token: " + "; ".join(
              f"tail {t} {ms([wall(eng_c, r) / t for r in rs])}"
              for t, rs in sorted(by_tail.items()))
          + f"; uncached (every admission a fresh prefill row): all "
          f"{ms([wall(eng_u, r) for r in eng_u.requests])}, the partial "
          f"hits' prompts {ms([wall(eng_u, r) for r in partial])}")
    print(f"{tag} (a) time to first token by hit kind: " + "; ".join(
        f"{k} {ms([ttft(eng_c, r) for r in rs])}" for k, rs in kind_rids)
          + f"; uncached {ms([ttft(eng_u, r) for r in eng_u.requests])}; "
          f"replay walls: cached {run_c['wall']:.3f} s, uncached "
          f"{run_u['wall']:.3f} s, closed loop {run_b['wall']:.3f} s")
    shapes = {}
    for sh in (shapes_c, shapes_u, shapes_b):
        for k, v in sh.items():
            shapes[k] = shapes.get(k, 0) + v
    per_shape = {k: b.gemm_row(*k) for k in sorted(shapes)}
    for label, sh in (("(a) cached", shapes_c), ("(a) uncached", shapes_u),
                      ("(b)", shapes_b)):
        dev_sum = sum(c * per_shape[k][5] for k, c in sh.items())
        by = {M: sum(c * per_shape[k][5] for k, c in sh.items()
                     if k[0] == M) for M in sorted(by_m(sh))}
        print(f"{tag} bitplane_matmul device-clock sum per replay "
              f"({label}): {dev_sum:.4f} ms over {sum(sh.values())} "
              f"launches; by M " + ", ".join(f"{M}: {v:.4f} ms"
                                             for M, v in by.items()))
    tot = [sum(c * per_shape[k][j] for k, c in shapes.items())
           for j in range(7)]
    bound_ms = sum(c * max(per_shape[k][3], per_shape[k][4])
                   for k, c in shapes.items())

    # ---- one partial-hit admission's extension and first token, traced
    rid0, p0, k0, s0 = partial[0], late[0], keeps[0], sources[0]
    src_row = before[key_of(s0)][0]
    tok0 = torch.from_numpy(p0)[None].to(dev)
    wv0, av0 = (t.to(dev) for t in run_c["bits"][rid0])

    def partial_admission():
        with eng_c.compute_ctx():
            logits, _ = eng_c._extend_row(tok0, src_row, k0, len(p0) - k0,
                                          wv0, av0)
            z = torch.zeros((1,), device=dev)
            int(eng_c._sample_first(logits, z, z.to(torch.int32))[0])

    trace(torch, tag, f"one partial-hit admission's extension "
          f"({len(p0) - k0} tail tokens through decode_step, M = 1) and "
          f"first token", partial_admission, ("bitplane_matmul",))
    bk_ms, bp_ms, bl_ms, bt_bytes, bt_ops, bd_ms, bld_ms = tot
    paths = {p: 0 for p in bpm.PATHS}
    for (M, K, N, _), c in shapes.items():
        paths[bpm.plan(M, K, N).path] += c
    tail8 = by_tail[PC_FRESH]
    return {
        "bitplane": {"launches": sum(shapes.values()), "ms": bk_ms,
                     "plain_ms": bp_ms, "bound_ms": bound_ms,
                     "t_bytes": bt_bytes, "t_ops": bt_ops,
                     "library_ms": bl_ms, "device_ms": bd_ms,
                     "library_device_ms": bld_ms, "paths": paths},
        "cnn": cnn_r,
        "e2e": {"cached_s": run_c["wall"], "uncached_s": run_u["wall"],
                "closed_s": run_b["wall"],
                "partial_ms_per_tail": statistics.median(
                    wall(eng_c, r) / PC_FRESH for r in tail8) * 1e3,
                "miss_ms": statistics.median(
                    wall(eng_c, r) for r in miss) * 1e3,
                "images_per_s": cnn_r["images_per_s"]}}


def pc_cnn(b: Bench) -> dict:
    """Path 5 (c): ResNet18@224 under a traffic spike through the HAWQ-V3
    EDP controller, open loop (no budgets: the highest bits) and closed
    (tick-windowed FluidController)."""
    torch, dev, tag = b.torch, b.dev, b.tag
    import numpy as np
    from repro_torch.apsim import metrics as apm
    from repro_torch.core.policy import (FluidController,
                                         cnn_budget_controller)
    from repro_torch.kernels import bitplane_matmul as bpm
    from repro_torch.kernels import ops
    from repro_torch.models import cnn
    from repro_torch.serve.cnn import CNNServeEngine
    from repro_torch.serve.traffic import (TraceReplayer, payload_image,
                                           synth_trace)

    gen_cpu = torch.Generator().manual_seed(0)
    params, layers = cnn.init_cnn("resnet18", gen_cpu, image=IMAGE,
                                  device=dev)
    base = cnn_budget_controller("resnet18", layers=layers)
    med = base.predicted_latency_s["hawqv3-medium"]
    slo = SPIKE_WINDOW * 4 * med
    spike = synth_trace("spike", **SPIKE)
    burst = range(SPIKE["burst_at"], SPIKE["burst_at"] + SPIKE["burst_len"])
    gemms = apm.network_gemms(layers)
    n_gemm = len(path_gemms(layers, BATCH, IMAGE))
    out = {}
    for loop in ("open", "closed"):
        ctrl = base if loop == "open" else FluidController.from_open_loop(
            base, slo=slo, window_ticks=SPIKE_WINDOW)
        eng = CNNServeEngine(params, layers, controller=ctrl, max_batch=BATCH,
                             device=dev)
        torch.cuda.synchronize()
        reset_gemm_launches()
        t0 = time.perf_counter()
        res = TraceReplayer(spike, {}, cnn_engines={"resnet18": eng},
                            image_hw=IMAGE,
                            use_budgets=loop == "open").replay()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = bpm.launches_by_planes()
        paths = bpm.launches_by_path()
        check(res.unserved == 0 and all(e["done"] for e in res.entries)
              and len(res.entries) == spike.n_requests,
              f"(c) {loop}: images left unserved")
        nb = eng.stats.batches
        check({k: v for k, v in launches.items() if v}
              == {f: n_gemm * nb for f in eng.families},
              f"(c) {loop}: launches by n_planes {launches}, expected "
              f"{n_gemm} per family per batch x {nb} batches")
        recs = [eng.requests[r] for r in sorted(eng.requests)]
        costs = apm.price_bit_matrix(gemms, [r.wbits for r in recs],
                                     [r.abits for r in recs])
        check([c.edp for c in costs] == [r.edp for r in recs],
              f"(c) {loop}: per-image EDP != the AP model's price")
        mb = [e["mean_wbits"] for e in res.entries if e["submitted_tick"]
              in burst]
        mc = [e["mean_wbits"] for e in res.entries if e["submitted_tick"]
              not in burst]
        out[loop] = {"eng": eng, "res": res, "wall": wall, "burst":
                     float(np.mean(mb)), "calm": float(np.mean(mc)),
                     "batches": nb, "recs": recs,
                     "launches": sum(launches.values()), "paths": paths}
    o, c = out["open"], out["closed"]
    check(o["burst"] == o["calm"] == 8.0, f"(c) open loop: mean wbits burst "
          f"{o['burst']}, calm {o['calm']}, expected 8 and 8")
    check(c["burst"] < c["calm"], f"(c) closed loop: mean wbits over burst "
          f"arrivals {c['burst']} not below calm {c['calm']}")

    # one batch of the closed loop (mixed bits) against the plain version
    eng = c["eng"]
    recs = c["recs"][:BATCH]
    images = torch.from_numpy(np.stack([
        payload_image(spike, r, (IMAGE, IMAGE, 3))
        for r in spike.requests[:BATCH]])).to(dev)
    wmat = torch.tensor([r.wbits for r in recs], dtype=torch.int32,
                        device=dev)
    amat = torch.tensor([r.abits for r in recs], dtype=torch.int32,
                        device=dev)
    with eng.compute_ctx():
        got = cnn.cnn_forward(eng.qparams, images, layers, wmat, amat)
        with mock.patch.object(ops, "bitplane_matmul",
                               lambda x, w, *, n_planes:
                               bpm.bitplane_matmul_ref(x, w, n_planes)):
            plain = cnn.cnn_forward(eng.qparams, images, layers, wmat, amat)
    check(torch.equal(got, plain), f"(c) one batch's logits != the "
          f"plain-version forward's, max |diff| "
          f"{(got - plain).abs().max().item()}")
    n_img = spike.n_requests
    print(f"(c) ResNet18@{IMAGE} spike (rate {SPIKE['rate']}, x"
          f"{SPIKE['burst_mag']} at ticks {SPIKE['burst_at']}.."
          f"{SPIKE['burst_at'] + SPIKE['burst_len'] - 1}): {n_img} images; "
          f"open loop {o['batches']} batches, mean wbits burst "
          f"{o['burst']:.4f} == calm {o['calm']:.4f}; closed loop (SLO "
          f"{slo:.6g} J*s per {SPIKE_WINDOW} ticks) {c['batches']} batches, "
          f"mean wbits burst {c['burst']:.4f} < calm {c['calm']:.4f}; "
          f"queue peak open {max(o['res'].queue_depth)}, closed "
          f"{max(c['res'].queue_depth)}; EDP == the AP model; launches per "
          f"batch {n_gemm} per family; one batch's logits == the "
          f"plain-version forward")
    ips = {k: n_img / v["wall"] for k, v in out.items()}
    ret = {"images_per_s": ips["closed"],
           "batches": o["batches"] + c["batches"],
           "launches": o["launches"] + c["launches"],
           "paths": {p: o["paths"][p] + c["paths"][p] for p in o["paths"]}}
    print(f"{tag} (c) replay: open loop {o['wall']:.3f} s "
          f"({ips['open']:.3f} images/s), closed loop {c['wall']:.3f} s "
          f"({ips['closed']:.3f} images/s), {out['open']['res'].ticks} and "
          f"{c['res'].ticks} ticks")
    del params, out, eng
    torch.cuda.empty_cache()
    return ret


# ---------------------------------------------------------------------------
# Path 6: placement and row scale-out
# ---------------------------------------------------------------------------

def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def reset_all_launches() -> None:
    from repro_torch.kernels import bitplane_matmul as bpm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int4_matmul as i4mm
    from repro_torch.kernels import quant_matmul as qmm
    bpm.reset_launches()
    fa.reset_launches()
    i4mm.reset_launches()
    qmm.reset_launches()


def off_path_launches() -> tuple:
    """Launches of the kernels path 6 must not reach: flash, int4, quant."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int4_matmul as i4mm
    from repro_torch.kernels import quant_matmul as qmm
    return fa.launch_count(), i4mm.launches, sum(qmm.spec_launches.values())


def record_view(r) -> dict:
    """A record's deterministic fields (its wall clocks left out): what
    every rank must hold identically."""
    return {"rid": r.rid, "tokens": list(r.tokens), "slot": r.slot,
            "budget_s": r.budget_s, "mean_wbits": r.mean_wbits,
            "cycles": r.ap_cost.per_layer_cycles,
            "energy": r.ap_cost.per_layer_energy_j,
            "plan_replicas": r.plan_replicas, "done": r.done,
            "planned_units": r.planned_units,
            "ticks": (r.submitted_tick, r.admitted_tick, r.finished_tick)}


def so_rank_lm(torch, dev, mesh, reqs) -> dict:
    """Path 6 (a) on one rank: path 4 (a)'s requests through a Qwen3-4B
    engine on the mesh with plan="auto"."""
    from repro_torch.kernels import bitplane_matmul as bpm
    from repro_torch.models import lm
    from repro_torch.models.transformer import EMPTY_POS
    from repro_torch.serve.engine import (SPEC_K_MAX, ServeEngine,
                                          default_controller)
    t0 = time.perf_counter()
    cfg, qparams = draw_lm_weights(torch, dev)
    weights_s = time.perf_counter() - t0
    eng = ServeEngine(cfg, qparams, controller=default_controller(
        lm.n_bit_slots(cfg)), max_len=CB_PREFILL + CB_NEW[1] + SPEC_K_MAX,
        n_slots=CB_SLOTS, prefill_len=CB_PREFILL, decode_block=CB_BLOCK,
        device=dev, mesh=mesh, plan="auto")
    torch.cuda.synchronize()
    reset_all_launches()
    rids, wall, first_at, ticks, _, _, _ = cb_serve(
        eng, reqs, CB_UPFRONT, CB_LATE_TICK)
    torch.cuda.synchronize()
    recs = [eng.requests[r] for r in rids]
    out = {"plan": eng.plan, "rows": eng._rows, "calls": dict(eng.calls),
           "shapes": bpm.launches_by_shape(),
           "paths": bpm.launches_by_path(), "off_path": off_path_launches(),
           "records": [record_view(r) for r in recs],
           "ttft": [first_at[r] - eng.requests[r].submitted_s for r in rids],
           "pool_rows": int(eng.pool.cache["kpos"].shape[1]),
           "drained": eng.pool.free_slots == CB_SLOTS and bool(
               (eng.pool.cache["kpos"] == EMPTY_POS).all()),
           "unserved": eng.stats.unserved, "wall": wall, "ticks": ticks,
           "weights_s": weights_s}
    del eng, qparams
    torch.cuda.empty_cache()
    return out


def so_rank_cnn(torch, dev, mesh) -> dict:
    """Path 6 (b) on one rank: path 1's batch through a ResNet18 engine on
    the mesh with plan="auto", one warm-up serve, then the counted one."""
    import numpy as np
    from repro_torch.core.policy import cnn_budget_controller
    from repro_torch.kernels import bitplane_matmul as bpm
    from repro_torch.models import cnn
    from repro_torch.serve.cnn import CNNServeEngine
    params, layers = cnn.init_cnn("resnet18", torch.Generator().manual_seed(0),
                                  device=dev)
    ctrl = cnn_budget_controller("resnet18", layers=layers)
    images, budgets = cnn_inputs(torch, dev, ctrl)
    eng = CNNServeEngine(params, layers, controller=ctrl, max_batch=BATCH,
                         device=dev, mesh=mesh, plan="auto")
    eng.serve(images, budgets)
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    logits, stats = eng.serve(images, budgets)          # ends in a gather
    wall = time.perf_counter() - t0
    out = {"plan": eng.plan, "rows": eng._rows, "logits": logits,
           "shapes": bpm.launches_by_shape(),
           "paths": bpm.launches_by_path(), "off_path": off_path_launches(),
           "wbits": [s.wbits for s in stats], "abits": [s.abits for s in stats],
           "cycles": [s.ap_cost.per_layer_cycles for s in stats],
           "energy": [s.ap_cost.per_layer_energy_j for s in stats],
           "plan_replicas": [s.plan_replicas for s in stats], "wall": wall}
    # this rank's rows alone against the same rows in the whole batch's
    # forward on this card: every float op of the forward is row-wise
    lo, hi = eng._rows
    wmat, amat = (t.to(dev) for t in ctrl.resolve(
        torch.tensor(budgets, dtype=torch.float32)))
    with eng.compute_ctx():
        whole = cnn.cnn_forward(eng.qparams, images, layers, wmat, amat)
        part = cnn.cnn_forward(eng.qparams, images[lo:hi], layers,
                               wmat[lo:hi], amat[lo:hi])
        out["rows_alone_max_diff"] = float(
            (whole[lo:hi] - part).abs().max())
        out["rows_alone_equal"] = bool(torch.equal(whole[lo:hi], part))
    out["logits_equal_whole"] = bool(np.array_equal(
        logits[lo:hi], whole[lo:hi].cpu().numpy()))
    del eng, params
    torch.cuda.empty_cache()
    return out


def so_rank(rank: int, init_method: str, out_dir: str, reqs,
            device: str) -> None:
    """One data rank of path 6, in its own process on ``device`` (the
    parent's card): join the gloo group (a missed rendezvous raises after
    SO_TIMEOUT_S), run (a) and (b) on a ``DataMesh``, and save what the
    parent gates.  Any failure raises, and the parent's spawn fails with
    it."""
    import datetime
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as tdist
    from repro_torch.dist import DataMesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tdist.init_process_group(
        "gloo", init_method=init_method, rank=rank, world_size=SO_RANKS,
        timeout=datetime.timedelta(seconds=SO_TIMEOUT_S))
    try:
        mesh = DataMesh()
        out = {"lm": so_rank_lm(torch, dev, mesh, reqs),
               "cnn": so_rank_cnn(torch, dev, mesh)}
    finally:
        tdist.destroy_process_group()
    torch.save(out, f"{out_dir}/rank{rank}.pt")


def shape_rows(b: Bench, shapes, known) -> dict:
    """gemm_row of each (M, K, N, n_planes) in ``shapes``, taken from
    ``known`` (an earlier path's rows) where it has it."""
    return {k: known[k] if k in known else b.gemm_row(*k)
            for k in sorted(shapes)}


def held_rows(b: Bench, shapes, paths, cuda: bool = True) -> dict:
    """The bit-plane kernel at each (M, K, N, n_planes) of ``shapes``
    (launches a shape): held EQUAL to its plain version on random
    operands, timed by ``gemm_row``, and summed over the launches into
    the JSON line's entry (``paths``: launches by path).  Off the card
    (a SMOKE run) the times are zero."""
    tot = [0.0] * 8
    for (M, K, N, n_pl), c in sorted(shapes.items()) if cuda else ():
        b.hold_bitplane(b.rand_i8((M, K)), b.rand_i8((K, N)), n_pl)
        row = b.gemm_row(M, K, N, n_pl)
        tot = [x + c * v for x, v in zip(tot, list(row)
                                         + [max(row[3], row[4])])]
    kms, pms, lms, tb, to, dms, ldms, bms = tot
    return {"launches": sum(shapes.values()), "ms": kms, "plain_ms": pms,
            "library_ms": lms, "t_bytes": tb, "t_ops": to,
            "device_ms": dms, "library_device_ms": ldms, "bound_ms": bms,
            "paths": paths}


def held_flash_rows(b: Bench, fl_shapes, label: str, cuda: bool = True
                    ) -> dict:
    """The flash kernel at each (q shape, keys, causal) of ``fl_shapes``
    (launches a shape): held against the f32 oracle, timed by
    ``flash_row`` and summed over the launches into the JSON line's
    entry.  Off the card (a SMOKE run) the times are zero."""
    fl = {"launches": sum(fl_shapes.values())}
    for (qs, Sk, causal), c in sorted(fl_shapes.items()) if cuda else ():
        BH, Sq, hd = qs
        err = hold_flash(b, BH, Sq, Sk, hd, causal, 0)
        row = flash_row(b, qs, f" ({label}, one rank's heads; max |err| "
                        f"{err:.6g})", Sk=0 if Sk == Sq and causal else Sk,
                        causal=causal)
        for k, v in row.items():
            fl[k] = fl.get(k, 0.0) + c * v
    for k in ("ms", "device_ms", "plain_ms", "library_ms", "t_ops",
              "t_bytes", "bound_ms"):
        fl.setdefault(k, 0.0)
    return fl


def so_path(b: Bench, cfg, qparams, cnn_ref=None, cb_ref=None) -> dict:
    """Path 6: (a) Qwen3-4B and (b) ResNet18 served on SO_RANKS data ranks
    sharing the card, each rank computing its block of rows with every
    weight resident (plan="auto", fully replicated); (c) a partial plan's
    co-decision at full width on one rank.  ``cnn_ref``/``cb_ref`` are
    paths 1 and 4's results (logits, tokens, per-shape timings); a run
    without them recomputes what it needs."""
    torch, dev, tag = b.torch, b.dev, b.tag
    import tempfile

    import numpy as np
    import torch.multiprocessing as tmp
    from repro_torch.apsim import metrics as apm
    from repro_torch.apsim.workloads import NETWORKS, gemm_layers
    from repro_torch.core.policy import cnn_budget_controller
    from repro_torch.kernels import bitplane_matmul as bpm
    from repro_torch.models import cnn, lm
    from repro_torch.serve.cnn import CNNServeEngine
    from repro_torch.serve.engine import (SPEC_K_MAX, ServeEngine,
                                          default_controller)

    t_path = time.perf_counter()
    L, V = cfg.n_layers, cfg.vocab_size
    linears = lm_linears(cfg)
    kn = sorted(set(linears))
    fams = (4, 8)
    M_pre, M_dec = CB_PREFILL, CB_SLOTS // SO_RANKS
    B_rank = BATCH // SO_RANKS
    layers = NETWORKS["resnet18"]()
    gl = gemm_layers(layers)
    cnn_rank = path_gemms(layers, B_rank, IMAGE)
    reqs = cb_requests(V, CB_REQUESTS, CB_PROMPT, CB_NEW, seed=4)

    # ---- the bit-plane kernel at the per-rank shapes
    for K, N in kn:
        for n in fams:
            b.hold_bitplane(b.rand_i8((M_dec, K)), b.rand_i8((K, N)), n)
    conv_rank = sorted({(M, K, N) for _, M, K, N, _ in cnn_rank})
    for M, K, N in conv_rank:
        for n in fams:
            b.hold_bitplane(b.rand_i8((M, K)), b.rand_i8((K, N)), n)
    same_regime = all(bpm.plan(M_dec, K, N).path == bpm.plan(CB_SLOTS, K, N).path
                      for K, N in kn)
    print(f"kernel == plain at the per-rank shapes: {len(kn)} Qwen3-4B (K, "
          f"N) at M = {M_dec} (a decode tick's rows a rank) and "
          f"{len(conv_rank)} ResNet18@{IMAGE} GEMM shapes at B = {B_rank}, x "
          f"n_planes {fams}; plan() at M = {M_dec}: "
          + ", ".join(f"({K},{N}) {bpm.plan(M_dec, K, N).path}"
                      for K, N in kn)
          + f"; the same regime as at M = {CB_SLOTS}: {same_regime}")

    # ---- what the ranks must equal: path 4 (a)'s tokens, path 1's logits
    if cb_ref is None:
        eng = ServeEngine(cfg, qparams, controller=default_controller(
            lm.n_bit_slots(cfg)), max_len=CB_PREFILL + CB_NEW[1] + SPEC_K_MAX,
            n_slots=CB_SLOTS, prefill_len=CB_PREFILL, decode_block=CB_BLOCK,
            device=dev)
        rids = cb_serve(eng, reqs, CB_UPFRONT, CB_LATE_TICK)[0]
        want_tokens = [eng.requests[r].tokens for r in rids]
        del eng
        print("path 4 (a)'s tokens recomputed on one device (path 4 did not "
              "run)")
    else:
        want_tokens = cb_ref["tokens"]
    if cnn_ref is None:
        params, clayers = cnn.init_cnn("resnet18",
                                       torch.Generator().manual_seed(0),
                                       device=dev)
        ctrl = cnn_budget_controller("resnet18", layers=clayers)
        images, budgets = cnn_inputs(torch, dev, ctrl)
        want_logits = CNNServeEngine(params, clayers, controller=ctrl,
                                     max_batch=BATCH, device=dev).serve(
            images, budgets)[0]
        del params
        print("path 1's logits recomputed on one device (path 1 did not "
              "run)")
    else:
        want_logits = cnn_ref["logits"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- (a) and (b) on SO_RANKS ranks sharing the card
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        tmp.start_processes(so_rank, args=(
            f"tcp://127.0.0.1:{free_port()}", d, reqs, str(dev)),
            nprocs=SO_RANKS,
            join=True, start_method="spawn")
        ranks = [torch.load(f"{d}/rank{r}.pt", weights_only=False)
                 for r in range(SO_RANKS)]
    ranks_s = time.perf_counter() - t0
    n_loc = CB_SLOTS // SO_RANKS
    gemms, head = lm.layer_gemm_dims(cfg), lm.head_gemm_dims(cfg)
    host_ctrl = default_controller(lm.n_bit_slots(cfg))
    for r, out in enumerate(ranks):
        a = out["lm"]
        plan = a["plan"]
        check(plan is not None and plan.fully_replicated
              and plan.dp == SO_RANKS and plan.has_head,
              f"(a) rank {r}: plan {plan and plan.summary()}")
        check(a["rows"] == (r * n_loc, (r + 1) * n_loc)
              and a["pool_rows"] == n_loc,
              f"(a) rank {r}: rows {a['rows']}, pool rows {a['pool_rows']}: "
              f"the row split did not engage")
        check(a["unserved"] == 0 and all(x["done"] for x in a["records"]),
              f"(a) rank {r}: requests unserved")
        check(a["drained"], f"(a) rank {r}: after run() a slot is held or "
              f"a kpos is not EMPTY_POS")
        check(a["off_path"] == (0, 0, 0), f"(a) rank {r}: flash, int4, "
              f"quant launched {a['off_path']} times")
        for i, x in enumerate(a["records"]):
            check(x["tokens"] == want_tokens[i], f"(a) rank {r}, request "
                  f"{i}: tokens {x['tokens']} != path 4 (a)'s "
                  f"{want_tokens[i]}")
            check(x["plan_replicas"] == float(SO_RANKS),
                  f"(a) request {i}: plan_replicas {x['plan_replicas']}")
            wv, av = host_ctrl.resolve(torch.tensor(reqs[i][2]))
            base = apm.price_bit_vector(gemms, wv.tolist(), av.tolist(),
                                        head=head)
            want = plan.price(base)
            check(x["cycles"] == want.per_layer_cycles
                  and x["energy"] == base.per_layer_energy_j
                  and sum(x["cycles"]) / want.freq_hz
                  == base.latency_s / SO_RANKS,
                  f"(a) request {i}: AP cost != PlacementPlan.price of the "
                  f"AP model's price of its bits (latency base / "
                  f"{SO_RANKS}, energy unchanged)")
        # launches by M against this rank's calls, by regime against plan()
        want_shapes: dict = {}
        want_paths = {p: 0 for p in bpm.PATHS}
        for M, n_fwd, nps in ((M_pre, a["calls"]["prefill"], (8,)),
                              (M_dec, a["calls"]["decode"], fams)):
            for _ in range(L):
                for K, N in linears:
                    for n in nps:
                        want_shapes[(M, K, N, n)] = \
                            want_shapes.get((M, K, N, n), 0) + n_fwd
                        want_paths[bpm.plan(M, K, N).path] += n_fwd
        want_shapes = {k: v for k, v in want_shapes.items() if v}
        check(a["shapes"] == want_shapes and a["paths"] == want_paths,
              f"(a) rank {r}: bit-plane launches by shape "
              f"{sorted(a['shapes'].items())} / regime {a['paths']} != the "
              f"calls' {sorted(want_shapes.items())} / {want_paths}")
        check(a["calls"]["prefill"] > 0 and a["calls"]["decode"] > 0,
              f"(a) rank {r}: calls {a['calls']}")
    recs0 = ranks[0]["lm"]["records"]
    check(all(out["lm"]["records"] == recs0 for out in ranks),
          "(a) the ranks' records differ")
    check(sum(out["lm"]["calls"]["prefill"] for out in ranks)
          == CB_REQUESTS, "(a) the slot owners did not prefill every "
          "request exactly once")
    plan_a = ranks[0]["lm"]["plan"]
    print(f"(a) Qwen3-4B FULL continuous on {SO_RANKS} ranks (cuda:0 each, "
          f"gloo): plan {plan_a.summary()}; rows "
          f"{[out['lm']['rows'] for out in ranks]}, each pool {n_loc} rows; "
          f"all {CB_REQUESTS} requests' tokens EQUAL path 4 (a)'s "
          f"({sum(len(t) for t in want_tokens)} tokens); the ranks' records "
          f"identical; plan_replicas {SO_RANKS}.0 and ap_cost == "
          f"plan.price(price_bit_vector(bits)): latency / {SO_RANKS}, energy "
          f"unchanged; prefill rows by rank "
          f"{[out['lm']['calls']['prefill'] for out in ranks]}; launches by "
          f"M as the calls give them, by regime as plan() gives them "
          f"({ranks[0]['lm']['paths']}); pools drained")

    # ---- (b) ResNet18@224 on the same ranks
    cnn_gemms = apm.network_gemms(layers)
    names = tuple(l.name for l in gl)
    want_cnn_shapes: dict = {}
    for _, M, K, N, _ in cnn_rank:
        for n in fams:
            want_cnn_shapes[(M, K, N, n)] = \
                want_cnn_shapes.get((M, K, N, n), 0) + 1
    for r, out in enumerate(ranks):
        c = out["cnn"]
        check(c["plan"].fully_replicated and c["plan"].names == names
              and c["plan"].dp == SO_RANKS,
              f"(b) rank {r}: plan {c['plan'].summary()}, names "
              f"{c['plan'].names}")
        check(c["rows"] == (r * B_rank, (r + 1) * B_rank),
              f"(b) rank {r}: rows {c['rows']}")
        check(c["rows_alone_equal"], f"(b) rank {r}: its rows alone compute "
              f"apart from the same rows in the whole batch, max |diff| "
              f"{c['rows_alone_max_diff']}")
        check(np.array_equal(c["logits"], want_logits),
              f"(b) rank {r}: logits != the single-rank engine's, max |diff| "
              f"{np.abs(c['logits'] - want_logits).max()}")
        check(c["shapes"] == want_cnn_shapes and c["off_path"] == (0, 0, 0),
              f"(b) rank {r}: launches {sorted(c['shapes'].items())} != one "
              f"per layer and family at B = {B_rank}; off path "
              f"{c['off_path']}")
        base = apm.price_bit_matrix(cnn_gemms, c["wbits"], c["abits"])
        for i, bc in enumerate(base):
            check(sum(c["cycles"][i]) / bc.freq_hz == bc.latency_s / SO_RANKS
                  and c["energy"][i] == bc.per_layer_energy_j
                  and c["plan_replicas"][i] == float(SO_RANKS),
                  f"(b) image {i}: latency not halved or energy changed")
    check(all(np.array_equal(out["cnn"]["logits"], ranks[0]["cnn"]["logits"])
              for out in ranks), "(b) the ranks' logits differ")
    print(f"(b) ResNet18@{IMAGE}, B = {BATCH} on {SO_RANKS} ranks ({B_rank} "
          f"rows each): plan fully replicated over {len(names)} named "
          f"layers; logits EQUAL the single-rank engine's on path 1's images "
          f"and budgets; each rank's rows alone EQUAL the same rows of the "
          f"whole batch's forward; latency / {SO_RANKS}, energy unchanged; "
          f"{sum(want_cnn_shapes.values())} launches a rank per batch")

    # ---- (c) the co-decision at full width: one rank, no mesh
    cdc = so_codecision(b, cfg)

    # ---- timings
    tick_s = {r: sorted(t for t, _, _ in out["lm"]["ticks"])
              for r, out in enumerate(ranks)}
    known = dict(cb_ref["per_shape"]) if cb_ref else {}
    known.update(cnn_ref["per_shape"] if cnn_ref else {})
    rank_shapes = [dict(out["lm"]["shapes"]) for out in ranks]
    for rs, out in zip(rank_shapes, ranks):
        for k, v in out["cnn"]["shapes"].items():
            rs[k] = rs.get(k, 0) + v
    shapes: dict = {}
    for sh in rank_shapes + [cdc["shapes"]]:
        for k, v in sh.items():
            shapes[k] = shapes.get(k, 0) + v
    per_shape = shape_rows(b, shapes, known)
    dev_rank = [sum(n * per_shape[k][5] for k, n in out["lm"]["shapes"].items())
                for out in ranks]
    dev_m4 = [sum(n * per_shape[k][5] for k, n in out["lm"]["shapes"].items()
                  if k[0] == M_dec) for out in ranks]
    dev_cnn = [sum(n * per_shape[k][5] for k, n in out["cnn"]["shapes"].items())
               for out in ranks]
    print(f"{tag} (a) on {SO_RANKS} ranks sharing one card (not a scale-out "
          f"speed): run() " + ", ".join(
              f"rank {r} {out['lm']['wall']:.3f} s" for r, out in
              enumerate(ranks))
          + (f" (path 4 (a) on one rank: {cb_ref['e2e']['run_a_s']:.3f} s)"
             if cb_ref else ""))
    print(f"{tag} (a) tick wall, two ranks sharing one card, {CB_BLOCK} steps "
          f"at {M_dec} rows a rank: median " + ", ".join(
              f"rank {r} {statistics.median(t) * 1e3:.3f} ms (n = {len(t)}, "
              f"all {[round(x * 1e3, 3) for x in t]})"
              for r, t in tick_s.items())
          + "; time to first token median " + ", ".join(
              f"rank {r} {statistics.median(out['lm']['ttft']) * 1e3:.3f} ms"
              for r, out in enumerate(ranks)))
    print(f"{tag} bitplane_matmul device-clock sum a rank, (a): "
          + ", ".join(f"rank {r} {v:.4f} ms (M = {M_dec}: {m:.4f} ms)"
                      for r, (v, m) in enumerate(zip(dev_rank, dev_m4)))
          + f"; (b) a batch: " + ", ".join(
              f"rank {r} {v:.4f} ms" for r, v in enumerate(dev_cnn))
          + (f" (path 1's whole batch on one rank: "
             f"{cnn_ref['device_ms']:.4f} ms)" if cnn_ref else ""))
    print(f"{tag} (b) serve wall, two ranks sharing one card: " + ", ".join(
        f"rank {r} {out['cnn']['wall'] * 1e3:.3f} ms" for r, out in
        enumerate(ranks)) + f"; weights drawn a rank in " + ", ".join(
        f"{out['lm']['weights_s']:.3f} s" for out in ranks)
        + f"; the ranks' processes {ranks_s:.3f} s")
    paths = {p: sum(out["lm"]["paths"][p] + out["cnn"]["paths"][p]
                    for out in ranks) + cdc["paths"][p] for p in bpm.PATHS}
    tot = [sum(n * per_shape[k][j] for k, n in shapes.items())
           for j in range(7)]
    bound_ms = sum(n * max(per_shape[k][3], per_shape[k][4])
                   for k, n in shapes.items())
    k_ms, p_ms, l_ms, t_bytes, t_ops, d_ms, ld_ms = tot
    wall = time.perf_counter() - t_path
    print(f"{tag} path 6 wall {wall:.3f} s (the ranks {ranks_s:.3f} s)")
    return {"bitplane": {"launches": sum(shapes.values()), "ms": k_ms,
                         "plain_ms": p_ms, "bound_ms": bound_ms,
                         "t_bytes": t_bytes, "t_ops": t_ops,
                         "library_ms": l_ms, "device_ms": d_ms,
                         "library_device_ms": ld_ms, "paths": paths},
            "e2e": {"wall_s": wall, "tick_median_ms": statistics.median(
                tick_s[0]) * 1e3, "wbits": cdc["wbits"]}}


def so_codecision(b: Bench, cfg) -> dict:
    """Path 6 (c): partial plans (SO_PARTIAL) for ResNet18 (named layers)
    and Qwen3-4B (with the head), and path 5 (c)'s spike replayed through
    a tick-windowed FluidController with the ResNet18 plan and without
    it, at one SLO."""
    torch, dev, tag = b.torch, b.dev, b.tag
    import numpy as np
    from repro_torch.apsim import metrics as apm
    from repro_torch.apsim.workloads import gemm_layers
    from repro_torch.core.policy import (FluidController,
                                         cnn_budget_controller)
    from repro_torch.dist import plan_for_controller
    from repro_torch.kernels import bitplane_matmul as bpm
    from repro_torch.models import cnn, lm
    from repro_torch.serve.cnn import CNNServeEngine
    from repro_torch.serve.engine import default_controller
    from repro_torch.serve.traffic import TraceReplayer, synth_trace

    params, layers = cnn.init_cnn("resnet18", torch.Generator().manual_seed(0),
                                  image=IMAGE, device=dev)
    gemms = apm.network_gemms(layers)
    names = tuple(l.name for l in gemm_layers(layers))
    base = cnn_budget_controller("resnet18", layers=layers)
    plan_c = plan_for_controller(base, gemms, names=names, **SO_PARTIAL)
    plan_l = plan_for_controller(
        default_controller(lm.n_bit_slots(cfg)), lm.layer_gemm_dims(cfg),
        head=lm.head_gemm_dims(cfg), **SO_PARTIAL)
    for label, p in (("ResNet18", plan_c), ("Qwen3-4B", plan_l)):
        check(not p.fully_replicated and p.replicated_entries,
              f"(c) {label}: the plan {p.summary()} is not partial")
        print(f"(c) {label} partial plan ({SO_PARTIAL}): replicas "
              f"{list(p.replicas)}, replicated entries "
              f"{list(p.replicated_entries)}, mean replicas "
              f"{p.mean_replicas:.4f}, axis {p.axis}")
    slo = SPIKE_WINDOW * 4 * base.predicted_latency_s["hawqv3-medium"]
    spike = synth_trace("spike", **SPIKE)
    n_gemm = len(names)
    out = {}
    shapes: dict = {}
    paths = {p: 0 for p in bpm.PATHS}
    for label, plan in (("no plan", None), ("plan", plan_c)):
        ctrl = FluidController.from_open_loop(base, slo=slo,
                                              window_ticks=SPIKE_WINDOW)
        eng = CNNServeEngine(params, layers, controller=ctrl,
                             max_batch=BATCH, device=dev, plan=plan)
        torch.cuda.synchronize()
        reset_all_launches()
        t0 = time.perf_counter()
        res = TraceReplayer(spike, {}, cnn_engines={"resnet18": eng},
                            image_hw=IMAGE, use_budgets=False).replay()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        nb = eng.stats.batches
        check(res.unserved == 0 and len(res.entries) == spike.n_requests,
              f"(c) {label}: images left unserved")
        check({k: v for k, v in bpm.launches_by_planes().items() if v}
              == {f: n_gemm * nb for f in eng.families}
              and off_path_launches() == (0, 0, 0),
              f"(c) {label}: launches by n_planes {bpm.launches_by_planes()}, expected "
              f"{n_gemm} per family per batch x {nb} batches")
        for k, v in bpm.launches_by_shape().items():
            shapes[k] = shapes.get(k, 0) + v
        for p in bpm.PATHS:
            paths[p] += bpm.launches_by_path()[p]
        recs = [eng.requests[r] for r in sorted(eng.requests)]
        check({w for r in recs for w in r.wbits} <= set(eng.families),
              f"(c) {label}: resolved bits outside the families")
        costs = apm.price_bit_matrix(gemms, [r.wbits for r in recs],
                                     [r.abits for r in recs])
        for r, c in zip(recs, costs):
            want = plan.price(c) if plan is not None else c
            check(r.ap_cost.per_layer_cycles == want.per_layer_cycles
                  and r.ap_cost.per_layer_energy_j == want.per_layer_energy_j,
                  f"(c) {label}: image {r.rid}'s ap_cost != "
                  f"plan.price(price_bit_vector(bits))")
        if plan is not None:
            # plan_gain against a host-only recomputation
            for name, pol_ in base.configs.items():
                wv, av = pol_.vectors(base.n_layers)
                c0 = apm.price_bit_vector(gemms, wv.tolist(), av.tolist())
                c1 = plan.price(c0)
                ratio = (c1.energy_j * c1.latency_s) / (c0.energy_j
                                                        * c0.latency_s)
                check(ctrl.plan_gain[name] == ratio
                      and ctrl.predicted_latency_s[name]
                      == base.predicted_latency_s[name] * ratio,
                      f"(c) plan_gain[{name}] {ctrl.plan_gain[name]} != "
                      f"{ratio}")
        out[label] = {"wbits": float(np.mean([r.mean_wbits for r in recs])),
                      "wall": wall, "batches": nb,
                      "gain": dict(ctrl.plan_gain or {})}
        del eng
    u, p = out["no plan"], out["plan"]
    check(p["wbits"] > u["wbits"], f"(c) mean wbits with the plan "
          f"{p['wbits']} not above without it {u['wbits']}")
    print(f"(c) ResNet18@{IMAGE} spike ({spike.n_requests} images) through a "
          f"tick-windowed FluidController at one SLO ({slo:.6g} J*s per "
          f"{SPIKE_WINDOW} ticks): mean wbits {u['wbits']:.4f} without the "
          f"plan, {p['wbits']:.4f} with it; plan_gain "
          f"{ {k: round(v, 6) for k, v in p['gain'].items()} } == the "
          f"host-only recomputation; ap_cost == plan.price(...) per image; "
          f"launches {n_gemm} per family per batch ({u['batches']} and "
          f"{p['batches']} batches)")
    print(f"{tag} (c) replay wall: no plan {u['wall']:.3f} s, plan "
          f"{p['wall']:.3f} s")
    del params
    torch.cuda.empty_cache()
    return {"shapes": shapes, "paths": paths,
            "wbits": (u["wbits"], p["wbits"])}


# ---------------------------------------------------------------------------
# Path 7: the MoE family, vlm prefixes and the int8 KV cache
# ---------------------------------------------------------------------------

def p7_configs():
    """(Moonshot-v1-16B-A3B FULL, InternVL2-1B FULL), held to their
    published widths."""
    from repro_torch import configs
    moe, vlm = configs.get(MOE_ARCH), configs.get(VLM_ARCH)
    check((moe.n_layers, moe.d_model, moe.n_heads, moe.n_kv_heads,
           moe.d_ff, moe.vocab_size, moe.head_dim, moe.n_experts,
           moe.experts_per_token, moe.n_shared_experts) == MOE_WIDTHS,
          f"{MOE_ARCH} FULL is not the published width: {moe}")
    check((vlm.n_layers, vlm.d_model, vlm.n_heads, vlm.n_kv_heads,
           vlm.d_ff, vlm.vocab_size, vlm.head_dim, vlm.n_prefix_tokens)
          == VLM_WIDTHS, f"{VLM_ARCH} FULL is not the published width: "
          f"{vlm}")
    return moe, vlm


def moe_forward_shapes(cfg, B: int, S: int):
    """Bit-plane launches of one MoE forward over B rows of S tokens at
    whole-batch bits (8 planes), by (M, K, N): (experts, the rest).  The
    attention and the shared experts run at M = B S, each of the E
    experts' three GEMMs at M = its capacity, the head at M = B."""
    from repro_torch.models import moe
    d, f, E, L = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.n_layers
    T = B * S
    C = moe.capacity(T, cfg)
    hq, hkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    fs = f * cfg.n_shared_experts
    experts, rest = {}, {}

    def add(where, key, n):
        where[key] = where.get(key, 0) + n

    add(experts, (C, d, f), 2 * E * L)
    add(experts, (C, f, d), E * L)
    for K, N in ((d, hq), (d, hkv), (d, hkv), (hq, d), (d, fs), (d, fs),
                 (fs, d)):
        add(rest, (T, K, N), L)
    add(rest, (B, d, cfg.padded_vocab), 1)
    return experts, rest


def tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def forward_timer(lm):
    """Patches for ``lm.prefill`` / ``lm.decode_step`` that record each
    call's wall (synchronized before and after) into the returned dict."""
    import torch
    walls = {"prefill": [], "decode": []}

    def timed(name, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
            return out
        return call

    patches = [mock.patch.object(lm, "prefill", timed("prefill", lm.prefill)),
               mock.patch.object(lm, "decode_step",
                                 timed("decode", lm.decode_step))]
    return walls, patches


def shapes_timing(b: Bench, per_fwd: dict, n: int = 8) -> list:
    """gemm_row at every (M, K, N) of ``per_fwd`` (launches per forward),
    summed with those multiplicities: [kernel ms, plain ms, _int_mm ms,
    bytes ms, ops ms, device ms, _int_mm device ms, bound ms]."""
    tot = [0.0] * 8
    for (M, K, N), c in sorted(per_fwd.items()):
        row = b.gemm_row(M, K, N, n)
        tot = [a + c * r for a, r in zip(tot, list(row) + [max(row[3],
                                                               row[4])])]
    return tot


def moe_smoke_card_vs_cpu(b: Bench) -> None:
    """Moonshot SMOKE (2 layers, 8 experts top-2): a greedy prefill of
    S > FLASH_THRESHOLD and decode steps at int8 on the card and on the
    CPU (plain versions there, flash's at the kernel's key tile).  Every
    routed call of the card's run is routed again by the CPU on the
    card's own input, so a split in one layer never reaches the next:
    each token's choices are EQUAL unless its router margin is under
    MOE_ROUTE_TOL (cuBLAS and ATen round the bf16 router apart).  The
    margin is the smallest relative gap between neighbours among its
    k + 1 largest router probabilities: the k-th against the (k+1)-th
    decides the set, the others the order of the choices, which decides
    capacity.  The two runs' tokens are equal up to the first step whose
    top-2 logit gap is under LOGIT_TOL or whose forwards routed apart."""
    torch = b.torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import common as cm
    from repro_torch.models import lm, moe
    from repro_torch.serve.engine import default_controller

    scfg = configs.get_smoke(MOE_ARCH)
    sg = torch.Generator().manual_seed(4)
    sqp = lm.quantize_params(lm.init_params(scfg, sg, device="cpu"), scfg)
    toks = torch.randint(0, scfg.vocab_size, (2, LM_SMOKE_S), generator=sg)
    wv, av = default_controller(scfg.n_layers).resolve(torch.tensor(10.0))
    k, L = scfg.experts_per_token, scfg.n_layers
    real = moe._route
    chunked = fa.flash_attention_chunked_ref
    cpu_dev = torch.device("cpu")

    def tiled(q, k_, v, causal, window):
        return chunked(q, k_, v, causal, window, chunk=flash_tile())

    def run(where):
        """(tokens, top-2 gaps, per routed call (router, input, topi))."""
        seen = []

        def route(p, xf, c):
            out = real(p, xf, c)
            seen.append((p["router"], xf.cpu(), out[0].cpu()))
            return out

        q = tree_to(sqp, where)
        cache = lm.empty_cache(scfg, 2, LM_SMOKE_S + 8, device=where)
        out, gaps = [], []
        with mock.patch.object(moe, "_route", route), \
                mock.patch.object(fa, "flash_attention_chunked_ref", tiled):
            logits, cache = lm.prefill(q, {"tokens": toks.to(where)}, scfg,
                                       wv.to(where), av.to(where), cache)
            for i in range(4):
                lg = logits[:, -1, :scfg.vocab_size].float().cpu()
                top2 = lg.topk(2, dim=-1).values
                gaps.append(float(((top2[:, 0] - top2[:, 1])
                                   / lg.abs().amax(-1)).min()))
                out.append(lg.argmax(-1))
                logits, cache = lm.decode_step(
                    q, out[-1][:, None].to(where),
                    torch.tensor(LM_SMOKE_S + i).to(where), cache, scfg,
                    wv.to(where), av.to(where))
        return torch.stack(out, 1), gaps, seen

    card, _, seen_c = run(b.dev)
    cpu, gaps, seen_p = run(cpu_dev)
    n_calls = 5 * L                     # prefill + 4 decode steps, per layer
    check(len(seen_c) == len(seen_p) == n_calls,
          f"SMOKE {MOE_ARCH}: {len(seen_c)} / {len(seen_p)} routed calls, "
          f"want {n_calls}")
    equal = near = apart_n = n_tok = 0
    for j, (router, xf, tc) in enumerate(seen_c):
        p = {"router": tree_to(router, cpu_dev)}
        tp = real(p, xf, scfg)[0]
        probs = torch.softmax(cm.apply_linear(p["router"], xf, 16, 16)
                              .float(), dim=-1)
        top = probs.sort(dim=-1, descending=True).values[:, :k + 1]
        margin = ((top[:, :-1] - top[:, 1:]) / top[:, :-1]).amin(-1)
        apart = (tc != tp).any(dim=-1)
        tie = margin < MOE_ROUTE_TOL
        check(not bool((apart & ~tie).any()), f"SMOKE {MOE_ARCH} card vs "
              f"CPU: routed call {j} (forward {j // L}, layer {j % L}) "
              f"routes a token apart whose router margin is >= "
              f"{MOE_ROUTE_TOL}: margins {margin[apart].tolist()}")
        n_tok += xf.shape[0]
        near += int(tie.sum())
        apart_n += int(apart.sum())
        equal += not bool(apart.any())
    # the chained runs: token s comes from forwards 0..s
    parted = [j // L for j, (c, p_) in enumerate(zip(seen_c, seen_p))
              if not torch.equal(c[2], p_[2])]
    first_part = parted[0] if parted else card.shape[1]
    steps = 0
    for s in range(min(first_part, card.shape[1])):
        if gaps[s] < LOGIT_TOL:
            break
        check(torch.equal(card[:, s], cpu[:, s]),
              f"SMOKE {MOE_ARCH} card vs CPU: tokens differ at step {s} "
              f"(top-2 gap {gaps[s]:.4g})")
        steps += 1
    print(f"SMOKE {MOE_ARCH} prefill (B=2, S={LM_SMOKE_S}) + 4 steps at "
          f"int8, card vs CPU: the CPU router on the card's input routes "
          f"EQUAL in {equal} of {n_calls} routed calls, {n_tok - apart_n} "
          f"of {n_tok} token-calls ({near} within the router margin "
          f"{MOE_ROUTE_TOL}, {apart_n} of them routed apart); the chained runs route apart first in forward "
          f"{first_part if parted else 'none'}; tokens held EQUAL over "
          f"{steps} of {card.shape[1]} steps, equal in all: "
          f"{torch.equal(card, cpu)} (card {card.tolist()}, CPU "
          f"{cpu.tolist()})")


def moe_path(b: Bench) -> dict:
    torch, dev, tag = b.torch, b.dev, b.tag
    from repro_torch.apsim import metrics as apm
    from repro_torch.kernels import bitplane_matmul as bpm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import lm, moe
    from repro_torch.serve.engine import ServeEngine, default_controller

    cfg = p7_configs()[0]
    L, E, k = cfg.n_layers, cfg.n_experts, cfg.experts_per_token
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    qparams = lm.init_serve_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    w_gib = (torch.cuda.memory_allocated() - base) / 2 ** 30
    print(f"{MOE_ARCH} FULL: {L} layers, d {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.head_dim}, {E} experts top-{k} "
          f"+ {cfg.n_shared_experts} shared, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}; the int8 serve form drawn and quantized layer "
          f"by layer on the card in {time.perf_counter() - t0:.3f} s: "
          f"{w_gib:.3f} GiB resident, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")

    ex_pre, rest_pre = moe_forward_shapes(cfg, MOE_B, MOE_S)
    ex_dec, rest_dec = moe_forward_shapes(cfg, MOE_B, 1)
    per_fwd = sum(ex_pre.values()) + sum(rest_pre.values())
    check(per_fwd == sum(ex_dec.values()) + sum(rest_dec.values())
          == L * (4 + 3 * E + 3) + 1, f"launches per forward {per_fwd}")

    # ---- the kernels at the path's shapes
    for shapes in (ex_pre, rest_pre, ex_dec, rest_dec):
        for M, K, N in shapes:
            b.hold_bitplane(b.rand_i8((M, K)), b.rand_i8((K, N)), 8)
    fl_shape = (MOE_B * cfg.n_heads, MOE_S, cfg.head_dim)
    f_err = hold_flash(b, fl_shape[0], MOE_S, MOE_S, cfg.head_dim, True, 0)
    print(f"kernel == plain: bit-plane at the expert, shared, attention "
          f"and head shapes of prefill and decode "
          f"{sorted({**ex_pre, **rest_pre, **ex_dec, **rest_dec})} "
          f"(n_planes 8); flash at {fl_shape} causal within FLASH_TOL: "
          f"max |err| {f_err:.6g}")

    ctrl = default_controller(lm.n_bit_slots(cfg))
    engine = ServeEngine(cfg, qparams, max_len=MOE_S + MOE_STEPS,
                         controller=ctrl, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (MOE_B, MOE_S),
                           generator=torch.Generator(device=dev)
                           .manual_seed(1), device=dev)
    batch = {"tokens": tokens}
    rec = {"topi": [], "drop": []}
    real_route, real_pos = moe._route, moe._positions

    def route(*a):
        out = real_route(*a)
        rec["topi"].append(out[0])
        return out

    def positions(*a):
        out = real_pos(*a)
        rec["drop"].append((~out[2]).sum())
        return out

    def call(budget):
        """One generate call with counts reset just before it: (tokens,
        its routing, dropped choices per forward, launches, paths, flash
        launches, walls, peak GiB)."""
        engine.set_budget(budget)
        rec["topi"], rec["drop"] = [], []
        walls, timers = forward_timer(lm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        bpm.reset_launches()
        fa.reset_launches()
        with mock.patch.object(moe, "_route", route), \
                mock.patch.object(moe, "_positions", positions), \
                timers[0], timers[1]:
            t0 = time.perf_counter()
            toks = engine.generate(batch, MOE_STEPS).cpu()
            wall = time.perf_counter() - t0
        drop = torch.stack(rec["drop"]).reshape(-1, L).sum(1).tolist()
        return {"tokens": toks, "topi": rec["topi"], "drop": drop,
                "launches": bpm.launches_by_planes(),
                "paths": bpm.launches_by_path(), "flash": fa.launch_count(),
                "walls": walls, "wall": wall,
                "peak": torch.cuda.max_memory_allocated() / 2 ** 30}

    warm = call(MOE_BUDGETS[0])
    runs = [call(bud) for bud in MOE_BUDGETS]
    n_fwd = MOE_STEPS
    want_paths = {p: 0 for p in bpm.PATHS}
    for shapes, reps in ((ex_pre, 1), (rest_pre, 1), (ex_dec, n_fwd - 1),
                         (rest_dec, n_fwd - 1)):
        for (M, K, N), c in shapes.items():
            want_paths[bpm.plan(M, K, N).path] += c * reps
    for bud, r in zip(MOE_BUDGETS, runs):
        got = sum(r["launches"].values())
        check(got == n_fwd * per_fwd and r["launches"][8] == got,
              f"budget {bud}: bit-plane launches per generate "
              f"{r['launches']}, expected {n_fwd} x {per_fwd} at 8 planes")
        check(r["paths"] == want_paths, f"budget {bud}: launches by path "
              f"{r['paths']} != plan()'s {want_paths}")
        check(r["flash"] == L, f"budget {bud}: flash launches {r['flash']}")
        check(r["tokens"].shape == (MOE_B, MOE_STEPS) and bool(
            ((r["tokens"] >= 0) & (r["tokens"] < cfg.vocab_size)).all()),
              f"budget {bud}: tokens {r['tokens']}")
        check(len(r["topi"]) == n_fwd * L and len(r["drop"]) == n_fwd,
              f"budget {bud}: {len(r['topi'])} routed calls")
    check(torch.equal(warm["tokens"], runs[0]["tokens"])
          and all(torch.equal(a, c) for a, c in zip(warm["topi"],
                                                     runs[0]["topi"])),
          "two identical generate calls gave different tokens or routing")
    mean_w = [float(ctrl.resolve(torch.tensor(bud))[0].double().mean())
              for bud in MOE_BUDGETS]
    check(mean_w == [4.0, 8.0], f"budgets {MOE_BUDGETS} -> mean wbits "
          f"{mean_w}")
    print(f"generate (B={MOE_B}, S={MOE_S}, {MOE_STEPS} tokens) at budgets "
          f"{list(MOE_BUDGETS)} (mean wbits {mean_w}): per call bit-plane "
          f"launches {n_fwd} x {per_fwd} = {n_fwd * per_fwd} (48 x (4 "
          f"attention + 3 x 64 experts + 3 shared) + the head, per forward; "
          f"all at 8 planes: whole-batch bits are tensors), by path "
          f"{runs[0]['paths']}; flash {L} per prefill, 0 per decode step; "
          f"two identical calls: the same tokens and the same routing in "
          f"all {n_fwd * L} routed calls; tokens "
          + "; ".join(f"{bud}: {r['tokens'][0].tolist()}"
                      for bud, r in zip(MOE_BUDGETS, runs)))
    for bud, r in zip(MOE_BUDGETS, runs):
        print(f"budget {bud}: choices dropped by capacity per forward "
              f"(prefill of {MOE_B * MOE_S * k} choices, then decode steps "
              f"of {MOE_B * k}; summed over {L} layers): {r['drop']}")

    # ---- each layer's MoE block, on its own captured input, EQUALS the
    # same block with the bit-plane kernel's plain version patched in
    engine.set_budget(MOE_BUDGETS[1])
    wv, av = engine._bits()
    real_moe = moe.apply_moe
    captured = []

    def capture(p, x, c, wb, ab):
        y = real_moe(p, x, c, wb, ab)
        captured.append((p, x, wb, ab, y[0]))
        return y

    def run_prefill():
        cache = lm.empty_cache(cfg, MOE_B, MOE_S + MOE_STEPS, device=dev)
        with engine.compute_ctx():
            return lm.prefill(engine.qparams, batch, cfg, wv, av, cache)

    with mock.patch.object(moe, "apply_moe", capture):
        run_prefill()
    check(len(captured) == L, f"captured {len(captured)} MoE blocks")

    def plain_gemm(x_q, w_q, *, n_planes):
        return bpm.bitplane_matmul_ref(x_q, w_q, n_planes)

    bpm.reset_launches()
    with mock.patch.object(ops, "bitplane_matmul", plain_gemm):
        for i, (p, x, wb, ab, y) in enumerate(captured):
            y_plain, _ = moe.apply_moe(p, x, cfg, wb, ab)
            check(torch.equal(y_plain, y), f"layer {i}: the MoE block with "
                  f"the bit-plane kernel != with its plain version: max "
                  f"|diff| {float((y_plain.float() - y.float()).abs().max())}")
    check(sum(bpm.spec_launches.values()) == 0, "the plain MoE blocks launched "
          "the kernel")
    del captured
    print(f"each of the {L} MoE blocks of an int8 prefill, on its own "
          f"captured input: kernel == plain version (routing, dispatch, "
          f"the {3 * E} expert GEMMs, combine and the shared experts)")

    # ---- prices against the AP model
    for bud in MOE_BUDGETS:
        w, a = ctrl.resolve(torch.tensor(bud))
        want = apm.price_bit_vector(lm.layer_gemm_dims(cfg), w.tolist(),
                                    a.tolist(), head=lm.head_gemm_dims(cfg))
        check(engine.price_budget(bud) == want, f"price_budget({bud}) "
              f"differs from the AP model's price of its bits")
    print("price_budget == apsim.price_bit_vector under moe's layer_gemm_dims"
          " (4 attention + 6 x 3 routed + 3 shared GEMMs a layer): EDP "
          + ", ".join(f"{bud:g} -> {engine.price_budget(bud).edp:.4g} J*s"
                      for bud in MOE_BUDGETS))

    moe_smoke_card_vs_cpu(b)

    # ---- timings
    for bud, r in zip(MOE_BUDGETS, runs):
        pre, dec = r["walls"]["prefill"], r["walls"]["decode"]
        print(f"{tag} {MOE_ARCH} budget {bud}: generate {r['wall'] * 1e3:.3f}"
              f" ms; prefill {pre[0] * 1e3:.3f} ms ({MOE_B * MOE_S / pre[0]:.1f}"
              f" prompt tokens/s); decode median "
              f"{statistics.median(dec) * 1e3:.3f} ms per step "
              f"({MOE_B / statistics.median(dec):.3f} tokens/s), all "
              f"{[round(x * 1e3, 3) for x in dec]}; peak memory "
              f"{r['peak']:.3f} GiB")
    sums = {}
    for name, shapes in (("prefill experts", ex_pre), ("prefill rest",
                                                       rest_pre),
                         ("decode experts", ex_dec),
                         ("decode rest", rest_dec)):
        sums[name] = shapes_timing(b, shapes)
    for fwd in ("prefill", "decode"):
        e, r_ = sums[f"{fwd} experts"], sums[f"{fwd} rest"]
        print(f"{tag} bitplane_matmul per {fwd} forward: experts "
              f"{sum(ex_pre.values() if fwd == 'prefill' else ex_dec.values())}"
              f" launches, device {e[5]:.4f} ms (kernel {e[0]:.4f}, bound "
              f"{e[7]:.4f}, _int_mm device {e[6]:.4f}); the rest "
              f"{sum(rest_pre.values() if fwd == 'prefill' else rest_dec.values())}"
              f" launches, device {r_[5]:.4f} ms (kernel {r_[0]:.4f}, bound "
              f"{r_[7]:.4f}, _int_mm device {r_[6]:.4f})")
    per_call = [sums["prefill experts"][i] + sums["prefill rest"][i]
                + (n_fwd - 1) * (sums["decode experts"][i]
                                 + sums["decode rest"][i]) for i in range(8)]
    fr = flash_row(b, fl_shape)

    # ---- where one prefill's and one decode step's time goes
    trace(torch, tag, f"one {MOE_ARCH} prefill", run_prefill,
          ("bitplane_matmul", "flash_attention"))
    _, cache = run_prefill()
    tok = torch.zeros((MOE_B, 1), dtype=torch.long, device=dev)
    t = torch.full((MOE_B,), MOE_S, dtype=torch.int32, device=dev)

    def one_step():
        with engine.compute_ctx():
            lm.decode_step(engine.qparams, tok, t, cache, cfg, wv, av)

    trace(torch, tag, f"one {MOE_ARCH} decode step", one_step,
          ("bitplane_matmul",))
    del cache, engine, qparams
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ncalls = len(MOE_BUDGETS)
    kms, pms, lms, tb, to, dms, ldms, bms = per_call
    return {
        "bitplane": {"launches": sum(sum(r["launches"].values())
                                     for r in runs),
                     "ms": ncalls * kms, "plain_ms": ncalls * pms,
                     "library_ms": ncalls * lms, "t_bytes": ncalls * tb,
                     "t_ops": ncalls * to, "device_ms": ncalls * dms,
                     "library_device_ms": ncalls * ldms,
                     "bound_ms": ncalls * bms,
                     "paths": {p: sum(r["paths"][p] for r in runs)
                               for p in bpm.PATHS}},
        "flash": flash_entry(sum(r["flash"] for r in runs), fr, ncalls * L),
        "e2e": {"prefill_ms": runs[1]["walls"]["prefill"][0] * 1e3,
                "decode_ms": statistics.median(runs[1]["walls"]["decode"])
                * 1e3, "peak_gib": max(r["peak"] for r in runs),
                "weights_gib": w_gib}}


def vlm_smoke_card_vs_cpu(b: Bench) -> None:
    """InternVL2 SMOKE on the card against the CPU (plain versions there):
    a prefill behind prefixes with S + P > FLASH_THRESHOLD (logits as
    ``gate_logits`` says), and continuous streams with prefixes on the bf16
    and the int8 cache (tokens equal up to the float-order rule against
    the CPU's standalone gaps)."""
    torch = b.torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine, default_controller

    scfg = configs.get_smoke(VLM_ARCH)
    sg = torch.Generator().manual_seed(6)
    sqp = lm.quantize_params(lm.init_params(scfg, sg, device="cpu"), scfg)
    P, d = scfg.n_prefix_tokens, scfg.d_model
    ctrl = default_controller(lm.n_bit_slots(scfg))
    S = LM_SMOKE_S - P + 8                      # S + P > FLASH_THRESHOLD
    toks = torch.randint(0, scfg.vocab_size, (2, S), generator=sg)
    pre = (torch.randn((2, P, d), generator=sg) * 0.02).bfloat16()

    def prefill(where):
        eng = ServeEngine(scfg, sqp, max_len=S + P + 8, controller=ctrl,
                          device=where)
        eng.set_budget([10.0, 0.4])
        swv, sav = eng._bits()
        cache = lm.empty_cache(scfg, 2, S + P + 8, device=where)
        fa.reset_launches()
        with eng.compute_ctx():
            out, _ = lm.prefill(eng.qparams, {"tokens": toks.to(where),
                                              "prefix": pre.to(where)},
                                scfg, swv, sav, cache)
        check(fa.launch_count() == (scfg.n_layers if where.type == "cuda" else 0),
              f"SMOKE vlm prefill on {where}: {fa.launch_count()} flash launches")
        return out[:, -1, :scfg.vocab_size].float().cpu()

    card = prefill(b.dev)
    cpu = prefill(torch.device("cpu"))
    chunked = fa.flash_attention_chunked_ref
    with mock.patch.object(fa, "flash_attention_chunked_ref",
                           lambda q, k, v, causal, window:
                           chunked(q, k, v, causal, window,
                                   chunk=flash_tile())):
        cpu_tiled = prefill(torch.device("cpu"))
    gate_logits(f"SMOKE {VLM_ARCH} prefill behind prefixes (B=2, S={S}, "
                f"P={P}, budgets [10.0, 0.4]), card vs CPU", card,
                cpu_tiled, cpu)

    reqs = cb_requests(scfg.vocab_size, 4, (3, CB_SMOKE_PREFILL), (4, 8),
                       seed=8)
    pfx = [(torch.randn((P, d), generator=sg) * 0.02).bfloat16()
           for _ in reqs]
    kw = dict(max_len=P + CB_SMOKE_PREFILL + 8, n_slots=2,
              prefill_len=CB_SMOKE_PREFILL, decode_block=3)
    exact = compared = 0
    for kvb in (0, 8):
        c = scfg.with_(kv_cache_bits=kvb)
        toks_on = {}
        for where, on in (("card", b.dev), ("cpu", torch.device("cpu"))):
            eng = ServeEngine(c, sqp, controller=ctrl, device=on, **kw)
            rids = cb_serve(eng, reqs, 3, 1, prefixes=pfx)[0]
            toks_on[where] = [eng.requests[r].tokens for r in rids]
        ref = ServeEngine(c, sqp, controller=ctrl, device="cpu", **kw)
        for i, (prompt, m, budget) in enumerate(reqs):
            want, gaps = cb_standalone(ref, prompt, m, budget,
                                       CB_SMOKE_PREFILL, pfx[i])
            check(toks_on["cpu"][i] == want, f"SMOKE vlm request {i} "
                  f"(kv bits {kvb}) on the CPU: continuous "
                  f"{toks_on['cpu'][i]} != standalone {want}")
            n, same = tokens_agree(f"SMOKE vlm request {i} (kv bits {kvb})"
                                   f" card vs CPU", toks_on["card"][i], want,
                                   gaps)
            compared += n
            exact += same
    print(f"SMOKE {VLM_ARCH} continuous with prefixes (4 requests, 2 slots; "
          f"bf16 and int8 caches): card vs CPU tokens exact in {exact} of 8 "
          f"streams, {compared} tokens compared; on the CPU continuous == "
          f"standalone")


def int64_dot(a, b_, spec: str):
    """``transformer.int8_dot``'s two contractions recomputed in int64 by
    elementwise products and sums (no matmul), on the operands' device."""
    if spec == "bqkgd,bskd->bkgqs":        # a (B,Sq,KV,G,hd), b (B,Sc,KV,hd)
        prod = (a.long().permute(0, 2, 3, 1, 4)[:, :, :, :, None, :]
                * b_.long().permute(0, 2, 1, 3)[:, :, None, None])
        return prod.sum(-1)
    check(spec == "bkgqs,bskd->bqkgd", f"int8_dot spec {spec}")
    prod = (a.long()[..., None]                 # (B,KV,G,Sq,Sc,1)
            * b_.long().permute(0, 2, 1, 3)[:, :, None, None])
    return prod.sum(-2).permute(0, 3, 1, 2, 4)


def vlm_path(b: Bench) -> dict:
    torch, dev, tag = b.torch, b.dev, b.tag
    import numpy as np
    from repro_torch.apsim import metrics as apm
    from repro_torch.kernels import bitplane_matmul as bpm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm
    from repro_torch.models import transformer as tf
    from repro_torch.models.transformer import EMPTY_POS
    from repro_torch.serve.engine import (SPEC_K_MAX, ServeEngine,
                                          default_controller)
    from repro_torch.serve.prefix_cache import PrefixCache

    cfg = p7_configs()[1]
    cfg8 = cfg.with_(kv_cache_bits=8)
    L, V, P, d = cfg.n_layers, cfg.vocab_size, cfg.n_prefix_tokens, \
        cfg.d_model
    fams = (4, 8)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    qparams = lm.quantize_params(params, cfg)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"{VLM_ARCH} FULL: {L} layers, d {d}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.head_dim}, qkv bias, d_ff "
          f"{cfg.d_ff}, vocab {V} (padded {cfg.padded_vocab}), tied "
          f"embeddings, {P} prefix tokens; weights drawn and quantized on "
          f"the card in {time.perf_counter() - t0:.3f} s")
    pg = torch.Generator(device=dev).manual_seed(5)

    def prefixes(n):
        """Seeded patch embeddings at the token embeddings' scale."""
        return (torch.randn((n, P, d), generator=pg, device=dev) * 0.02
                ).to(torch.bfloat16)

    hq, hkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    linears = [(d, hq), (d, hkv), (d, hkv), (hq, d), (d, cfg.d_ff),
               (d, cfg.d_ff), (cfg.d_ff, d)]
    kn = sorted(set(linears))
    Sx = P + VLM_S
    M_pre, M_dec = VLM_B * Sx, VLM_B
    M_row, M_tick, M_ver = P + CB_PREFILL, VLM_SLOTS, VLM_SLOTS * (
        SPEC_K_MAX + 1)
    for K, N in kn:
        for M, nps in ((M_pre, fams), (M_dec, fams), (M_row, (8,)),
                       (M_tick, fams), (M_ver, fams)):
            for n in nps:
                b.hold_bitplane(b.rand_i8((M, K)), b.rand_i8((K, N)), n)
    fl_shape = (VLM_B * cfg.n_heads, Sx, cfg.head_dim)
    f_err = hold_flash(b, fl_shape[0], Sx, Sx, cfg.head_dim, True, 0)
    print(f"kernel == plain: bit-plane at {len(kn)} InternVL2 (K, N) shapes "
          f"at M = {M_pre}, {M_dec} (generate), {M_row} (a prefill row, 8 "
          f"planes), {M_tick} and {M_ver} (tick, verify chunk) x n_planes "
          f"{fams}; flash at {fl_shape} (hd 64, GQA {cfg.n_heads // cfg.n_kv_heads}"
          f" expanded) causal within FLASH_TOL: max |err| {f_err:.6g}")

    ctrl = default_controller(lm.n_bit_slots(cfg))
    tokens = torch.randint(0, V, (VLM_B, VLM_S), generator=torch.Generator(
        device=dev).manual_seed(2), device=dev)
    batch = {"tokens": tokens, "prefix": prefixes(VLM_B)}
    per_call = L * len(linears) * len(fams) * VLM_STEPS
    # the timed generate calls' launches (the JSON line's), and the
    # continuous and speculative runs'
    out = {"launches": 0, "flash": 0, "paths": {p: 0 for p in bpm.PATHS},
           "cb": 0}

    def generate(c):
        """(b)1 / (c)1: one warm-up, one counted and timed call."""
        eng = ServeEngine(c, qparams, max_len=Sx + VLM_STEPS,
                          controller=ctrl, device=dev)
        check(eng.families == fams, f"bit families {eng.families}")
        eng.set_budget(LM_BUDGETS)
        first = eng.generate(batch, VLM_STEPS).cpu()
        walls, timers = forward_timer(lm)
        bpm.reset_launches()
        fa.reset_launches()
        with timers[0], timers[1]:
            t0 = time.perf_counter()
            toks = eng.generate(batch, VLM_STEPS).cpu()
            wall = time.perf_counter() - t0
        bp, fl = sum(bpm.spec_launches.values()), fa.launch_count()
        check(fl == L and bp == per_call, f"kv bits {c.kv_cache_bits}: "
              f"flash {fl} (want {L}), bit-plane {bp} (want {per_call}) "
              f"launches per generate")
        check(bpm.launches_by_path() == {"small_m": per_call - per_call
                                    // VLM_STEPS, "large_m": per_call
                                    // VLM_STEPS, "large_m_copy_x": 0},
              f"launches by path {bpm.launches_by_path()}")
        check(torch.equal(toks, first) and bool(((toks >= 0)
                                                 & (toks < V)).all()),
              f"kv bits {c.kv_cache_bits}: repeated generate calls differ")
        out["launches"] += bp
        out["flash"] += fl
        for p_ in bpm.PATHS:
            out["paths"][p_] += bpm.launches_by_path()[p_]
        return eng, toks, walls, wall

    eng_g, toks_g, walls_g, wall_g = generate(cfg)
    # flash on every layer's own q/k/v against the f32 oracle
    wv, av = eng_g._bits()
    layer_err = []
    kernel_flash = fa.flash_attention

    def held_flash(q, k, v, *, causal, window, scale=0.0, k_len=0):
        o = kernel_flash(q, k, v, causal=causal, window=window, scale=scale)
        layer_err.append(float((o.float() - oracle_f32(q, k, v, causal,
                                                       window)).abs().max()))
        return o

    cache = lm.empty_cache(cfg, VLM_B, Sx + VLM_STEPS, device=dev)
    with mock.patch.object(fa, "flash_attention", held_flash), \
            eng_g.compute_ctx():
        lm.prefill(eng_g.qparams, batch, cfg, wv, av, cache)
    del cache
    check(len(layer_err) == L and max(layer_err) <= FLASH_TOL,
          f"flash on the path's q/k/v vs the oracle per layer: {layer_err}")
    print(f"(b)1 generate (B={VLM_B}, {P} prefix + {VLM_S} prompt tokens, "
          f"{VLM_STEPS} new, budgets {LM_BUDGETS}): per call flash {L} at "
          f"{fl_shape}, bit-plane {per_call} at n_planes {fams}; identical "
          f"across calls; flash on every layer's own q/k/v vs the oracle: "
          f"max |err| {max(layer_err):.6g}; first row {toks_g[0].tolist()}")

    def continuous(c, reqs, pfx, **kw):
        eng = ServeEngine(c, qparams, controller=ctrl, device=dev,
                          max_len=P + CB_PREFILL + VLM_NEW + SPEC_K_MAX,
                          n_slots=VLM_SLOTS, prefill_len=CB_PREFILL,
                          decode_block=CB_BLOCK,
                          prefix_cache=PrefixCache(chunk=PC_CHUNK,
                                                   capacity=PC_CAPACITY),
                          **kw)
        bpm.reset_launches()
        res = cb_serve(eng, reqs, VLM_SLOTS + 2, 1, prefixes=pfx)
        out["cb"] += sum(bpm.spec_launches.values())
        rids, wall, first_at, ticks = res[:4]
        recs = [eng.requests[r] for r in rids]
        check(all(r.done for r in recs) and eng.stats.unserved == 0,
              "requests left unserved")
        check(eng.pool.free_slots == VLM_SLOTS and bool(
            (eng.pool.cache["kpos"] == EMPTY_POS).all()),
              "after run(): a slot is held or a kpos is not EMPTY_POS")
        led = eng.prefix_cache.ledger
        check(led.lookups == 0 and len(eng.prefix_cache) == 0,
              f"requests with a prefix reached the prefix cache: {led}")
        for r, (_, m, budget) in zip(recs, reqs):
            w_, a_ = eng.host_bits(budget)
            want = apm.price_bit_vector(lm.layer_gemm_dims(c), w_.tolist(),
                                        a_.tolist(),
                                        head=lm.head_gemm_dims(c))
            check(r.ap_cost == eng.price_bits(w_, a_) == want,
                  f"request {r.rid}: ap_cost differs from the AP model")
        ttft = sorted(first_at[r] - eng.requests[r].submitted_s
                      for r in rids)
        ntok = sum(len(r.tokens) for r in recs)
        return eng, [r.tokens for r in recs], {
            "wall": wall, "ttft_median_ms": statistics.median(ttft) * 1e3,
            "tokens_per_s": ntok / wall, "ticks": len(ticks)}

    reqs = cb_requests(V, VLM_REQUESTS, CB_PROMPT, (VLM_NEW, VLM_NEW),
                       seed=9)
    pfx = list(prefixes(VLM_REQUESTS))

    def alone_gate(label, eng, toks):
        for i, (prompt, m, budget) in enumerate(reqs):
            want, _ = cb_standalone(eng, prompt, m, budget, CB_PREFILL,
                                    pfx[i])
            check(toks[i] == want, f"{label} request {i} != the request "
                  f"alone: got {toks[i]}, want {want}")

    eng_c, toks_c, e2e_c = continuous(cfg, reqs, pfx)
    alone_gate("(b)2", eng_c, toks_c)
    print(f"(b)2 continuous: {VLM_REQUESTS} requests with {P}-token prefixes"
          f" ({VLM_SLOTS + 2} up front, the rest at tick 1), prompts "
          f"{[len(p) for p, _, _ in reqs]}, {VLM_NEW} new tokens, "
          f"{VLM_SLOTS} slots, prefill_len {CB_PREFILL}: every request "
          f"EQUAL to it alone (batch-1 prefill behind its prefix + "
          f"decode_step loop); the prefix cache saw no lookups; drained "
          f"pool all EMPTY_POS; ap_cost == the AP model per request")

    sreqs = [(p, VLM_SPEC_NEW, bud) for p, _, bud in reqs[:VLM_SPEC]]
    eng_s = ServeEngine(cfg, qparams, controller=ctrl, device=dev,
                        max_len=P + CB_PREFILL + VLM_NEW + SPEC_K_MAX,
                        n_slots=VLM_SLOTS, prefill_len=CB_PREFILL,
                        decode_block=CB_BLOCK, spec_k=CB_SPEC_K,
                        draft_budget_s=CB_DRAFT_BUDGET)
    bpm.reset_launches()
    rids_s = cb_serve(eng_s, sreqs, VLM_SPEC, 1, prefixes=pfx)[0]
    out["cb"] += sum(bpm.spec_launches.values())
    for i, r in enumerate(rids_s):
        got = eng_s.requests[r].tokens
        check(got == toks_c[i][:VLM_SPEC_NEW], f"(b)3 speculative request "
              f"{i}: {got} != the first {VLM_SPEC_NEW} of (b)2's "
              f"{toks_c[i]}")
    check(eng_s.calls["verify"] > 0, "(b)3 ran no verify chunk")
    print(f"(b)3 speculative (spec_k={CB_SPEC_K}, int4 drafts): {VLM_SPEC} "
          f"requests with prefixes, each EQUAL to the first {VLM_SPEC_NEW} "
          f"tokens of (b)2's; calls {eng_s.calls}")

    # ---- (c) the int8 KV cache on the same weights
    eng_g8, toks_g8, walls_g8, wall_g8 = generate(cfg8)
    seen = []
    real_dot = tf.int8_dot

    def dot(a, b_, spec):
        r = real_dot(a, b_, spec)
        if len(seen) < 2:
            seen.append((a, b_, spec, r))
        return r

    cache = lm.empty_cache(cfg8, VLM_B, Sx + VLM_STEPS, device=dev)
    with eng_g8.compute_ctx():
        logits, cache = lm.prefill(eng_g8.qparams, batch, cfg8, wv, av,
                                   cache)
        check(cache["k"].dtype == torch.int8 and cache["v"].dtype
              == torch.int8 and cache["ks"].dtype == torch.bfloat16
              and cache["vs"].dtype == torch.bfloat16,
              f"int8 cache leaves {[(n, t.dtype) for n, t in cache.items()]}")
        with mock.patch.object(tf, "int8_dot", dot):
            lm.decode_step(eng_g8.qparams, logits[:, -1].argmax(-1)[:, None],
                           torch.full((VLM_B,), Sx, device=dev), cache,
                           cfg8, wv, av)
    check(len(seen) == 2, f"{len(seen)} int8 dots captured")
    for a, b_, spec, r in seen:
        want = int64_dot(a, b_, spec)
        check(r.dtype == torch.int32 and torch.equal(r.long(), want),
              f"int8 decode accumulators ({spec}) != int64 recomputation: "
              f"max |diff| {int((r.long() - want).abs().max())}")
    qk_max = int(seen[0][3].abs().max())
    pv_max = int(seen[1][3].abs().max())
    cache_bytes = {n: t.numel() * t.element_size() for n, t in cache.items()}
    bf16_bytes = sum(t.numel() * t.element_size() for t in lm.empty_cache(
        cfg, VLM_B, Sx + VLM_STEPS, device="meta").values())
    del cache
    eng_c8, toks_c8, e2e_c8 = continuous(cfg8, reqs, pfx)
    check(eng_c8.pool.cache["k"].dtype == torch.int8
          and eng_c8.pool.cache["ks"].dtype == torch.bfloat16,
          "the int8 engine's pool is not int8")
    alone_gate("(c)2", eng_c8, toks_c8)
    print(f"(c) int8 KV cache: generate as (b)1 ({toks_g8[0].tolist()} "
          f"first row); layer 0's decode-step QK and PV int32 accumulators "
          f"(max |acc| {qk_max} and {pv_max} over {Sx + 1} keys) EQUAL an "
          f"int64 recomputation on the card; leaves k/v int8, ks/vs bf16: "
          f"{sum(cache_bytes.values())} bytes against {bf16_bytes} for the "
          f"bf16 cache ({VLM_B} rows of {Sx + VLM_STEPS}); continuous as "
          f"(b)2, every request EQUAL to it alone")

    check(out["cb"] > 0, "the continuous runs launched no bit-plane kernel")
    print(f"bit-plane launches: {out['launches']} in the two timed generate "
          f"calls (by path {out['paths']}), {out['cb']} in the continuous "
          f"and speculative runs")

    vlm_smoke_card_vs_cpu(b)

    # ---- timings
    e2e = {}
    for label, walls, wall, e2e_cb in (("bf16", walls_g, wall_g, e2e_c),
                                       ("int8", walls_g8, wall_g8, e2e_c8)):
        pre, dec = walls["prefill"][0], statistics.median(walls["decode"])
        e2e[label] = {"prefill_ms": pre * 1e3, "decode_ms": dec * 1e3,
                      "generate_ms": wall * 1e3, **e2e_cb}
        print(f"{tag} {VLM_ARCH} {label} KV cache: generate {wall * 1e3:.3f}"
              f" ms; prefill (time to first token) {pre * 1e3:.3f} ms "
              f"({VLM_B * Sx / pre:.1f} prompt tokens/s); decode median "
              f"{dec * 1e3:.3f} ms per step ({VLM_B / dec:.3f} tokens/s at "
              f"B={VLM_B}), all {[round(x * 1e3, 3) for x in walls['decode']]}"
              f"; continuous run() {e2e_cb['wall']:.3f} s, time to first "
              f"token median {e2e_cb['ttft_median_ms']:.3f} ms, "
              f"{e2e_cb['tokens_per_s']:.3f} tokens/s over "
              f"{e2e_cb['ticks']} ticks")
    gen_shapes = {}
    for K, N in linears:
        for M, reps in ((M_pre, 1), (M_dec, VLM_STEPS - 1)):
            gen_shapes[(M, K, N)] = gen_shapes.get((M, K, N), 0) + reps * L
    tot = [0.0] * 8
    for n in fams:
        tot = [a + c for a, c in zip(tot, shapes_timing(b, gen_shapes, n))]
    print(f"{tag} bitplane_matmul per {VLM_ARCH} generate call ({per_call} "
          f"launches): kernel {tot[0]:.4f} ms (device {tot[5]:.4f}), plain "
          f"{tot[1]:.4f} ms, torch._int_mm {tot[2]:.4f} ms (device "
          f"{tot[6]:.4f}), bound {tot[7]:.4f} ms")
    fr = flash_row(b, fl_shape, " (hd 64)")
    del eng_g, eng_g8, eng_c, eng_c8, eng_s, qparams
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # the timed generate calls (bf16 and int8) carry the kernels' times;
    # the continuous runs' launches are counted, not timed
    return {
        "bitplane": {"launches": out["launches"], "ms": 2 * tot[0],
                     "plain_ms": 2 * tot[1], "library_ms": 2 * tot[2],
                     "t_bytes": 2 * tot[3], "t_ops": 2 * tot[4],
                     "device_ms": 2 * tot[5],
                     "library_device_ms": 2 * tot[6],
                     "bound_ms": 2 * tot[7], "paths": out["paths"]},
        "flash": flash_entry(out["flash"], fr, 2 * L),
        "e2e": e2e}


# ---------------------------------------------------------------------------
# Path 8: the recurrent families, encoder-decoder cross-attention and flash
# at head dim 160 (mamba2-1.3b, zamba2-2.7b, seamless-m4t-medium,
# stablelm-12b)
# ---------------------------------------------------------------------------

def p8_configs():
    """The four FULL configs, held to their published widths."""
    from repro_torch import configs
    ssm, hyb, ed, d160 = (configs.get(a) for a in (SSM_ARCH, HYB_ARCH,
                                                   ED_ARCH, D160_ARCH))
    check((ssm.n_layers, ssm.d_model, ssm.ssm_state, ssm.ssm_head_dim,
           ssm.expand, ssm.ssm_chunk, ssm.vocab_size) == SSM_WIDTHS,
          f"{SSM_ARCH} FULL is not the published width: {ssm}")
    check((hyb.n_layers, hyb.d_model, hyb.n_heads, hyb.n_kv_heads,
           hyb.head_dim, hyb.d_ff, hyb.vocab_size, hyb.attn_every,
           hyb.lora_rank, hyb.ssm_state) == HYB_WIDTHS,
          f"{HYB_ARCH} FULL is not the published width: {hyb}")
    check((ed.n_enc_layers, ed.n_layers, ed.d_model, ed.n_heads,
           ed.n_kv_heads, ed.head_dim, ed.d_ff, ed.vocab_size,
           ed.frames_ratio) == ED_WIDTHS,
          f"{ED_ARCH} FULL is not the published width: {ed}")
    check((d160.n_layers, d160.d_model, d160.n_heads, d160.n_kv_heads,
           d160.head_dim, d160.d_ff, d160.vocab_size) == D160_WIDTHS,
          f"{D160_ARCH} FULL is not the published width: {d160}")
    return {"ssm": ssm, "hybrid": hyb, "encdec": ed, "dense": d160}


def p8_shapes(cfg, B: int, S: int, F: int, fams) -> dict:
    """Bit-plane launches of one forward over B rows of S tokens (F
    encoder frames, prefill only), by (M, K, N, n_planes): every linear at
    each family of ``fams`` (per-row bits) or at 8 planes (whole-batch
    bits, ``fams`` = (8,))."""
    from repro_torch.models import hybrid, mamba2
    d, M = cfg.d_model, B * S
    hq, hkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    out: dict = {}

    def add(M_, K, N, n=1):
        for f in fams:
            out[(M_, K, N, f)] = out.get((M_, K, N, f), 0) + n

    def attn(M_, n, kv=True):
        add(M_, d, hq, n)
        if kv:
            add(M_, d, hkv, 2 * n)
        add(M_, hq, d, n)

    def mlp(M_, n):
        if cfg.mlp_type == "swiglu":
            add(M_, d, cfg.d_ff, 2 * n)
        else:
            add(M_, d, cfg.d_ff, n)
        add(M_, cfg.d_ff, d, n)

    if cfg.family in ("ssm", "hybrid"):
        d_inner, H, N, _ = mamba2.dims(cfg)
        add(M, d, 2 * d_inner + 2 * N + H, cfg.n_layers)
        add(M, d_inner, d, cfg.n_layers)
    if cfg.family == "hybrid":
        ns = hybrid.n_super(cfg)
        attn(M, ns)
        mlp(M, ns)
    if cfg.family == "dense":
        attn(M, cfg.n_layers)
        mlp(M, cfg.n_layers)
    if cfg.family == "encdec":
        L = cfg.n_layers
        if S > 1:                              # the encoder and cross K/V
            attn(B * F, cfg.n_enc_layers)
            mlp(B * F, cfg.n_enc_layers)
            add(B * F, d, hkv, 2 * L)
        attn(M, L)                             # self
        attn(M, L, kv=False)                   # cross: q and o only
        mlp(M, L)
    if not cfg.tie_embeddings:
        add(B, d, cfg.padded_vocab)
    return out


def smoke_card_vs_cpu(b: Bench, arch: str = LM_ARCH, budget=(10.0, 0.4),
                      F: int = 0, seed: int = 2) -> None:
    """A SMOKE prefill of (B=2, S=LM_SMOKE_S > FLASH_THRESHOLD) on the card
    against the CPU (plain versions there), logits as ``gate_logits``
    says; encdec behind F frames (F * S > FLASH_THRESHOLD^2, so its
    cross-attention takes flash too).  The flash launches on the card are
    counted.  A tuple ``budget`` is one budget per row."""
    torch = b.torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import hybrid, lm
    from repro_torch.serve.engine import ServeEngine, default_controller

    scfg = configs.get_smoke(arch)
    budget = list(budget) if isinstance(budget, tuple) else budget
    sg = torch.Generator().manual_seed(seed)
    sqp = lm.quantize_params(lm.init_params(scfg, sg, device="cpu"), scfg)
    toks = torch.randint(0, scfg.vocab_size, (2, LM_SMOKE_S), generator=sg)
    batch = {"tokens": toks}
    if F:
        batch["frames"] = (torch.randn((2, F, scfg.d_model), generator=sg)
                           * 0.5).bfloat16()
    ctrl = default_controller(lm.n_bit_slots(scfg))
    want_fa = {"ssm": 0, "hybrid": hybrid.n_super(scfg) if
               scfg.family == "hybrid" else 0, "encdec": 2 * scfg.n_layers,
               "dense": scfg.n_layers}[scfg.family]

    def prefill(where):
        eng = ServeEngine(scfg, sqp, max_len=LM_SMOKE_S + 8, controller=ctrl,
                          device=where)
        eng.set_budget(budget)
        swv, sav = eng._bits()
        cache = lm.empty_cache(scfg, 2, LM_SMOKE_S + 8, device=where)
        fa.reset_launches()
        with eng.compute_ctx():
            out, _ = lm.prefill(eng.qparams, {k: v.to(where) for k, v in
                                              batch.items()},
                                scfg, swv, sav, cache)
        check(fa.launch_count() == (want_fa if where.type == "cuda" else 0),
              f"SMOKE {arch} prefill on {where}: {fa.launch_count()} flash "
              f"launches, want {want_fa}")
        return out[:, -1, :scfg.vocab_size].float().cpu()

    card = prefill(b.dev)
    cpu = prefill(torch.device("cpu"))
    chunked = fa.flash_attention_chunked_ref
    with mock.patch.object(fa, "flash_attention_chunked_ref",
                           lambda q, k, v, causal, window:
                           chunked(q, k, v, causal, window,
                                   chunk=flash_tile())):
        cpu_tiled = prefill(torch.device("cpu"))
    gate_logits(f"SMOKE {arch} prefill (B=2, S={LM_SMOKE_S}"
                + (f", F={F}" if F else "") + f", budget {budget}; "
                f"{want_fa} flash launches on the card), card vs CPU", card,
                cpu_tiled, cpu)


def ssd_stepwise_gate(b: Bench, args) -> float:
    """Layer 0's captured SSD inputs, cut to their first SSM_STEPWISE
    positions: ``mamba2.ssd_chunked`` on the card against the stepwise
    recurrence in float64 on the card.  Returns the max |err| over max
    |value| of y and of the final state."""
    torch = b.torch
    from repro_torch.models import mamba2
    xh, Bm, Cm, dt, a, h0, chunk = args
    T = SSM_STEPWISE
    xh, Bm, Cm, dt = (t[:, :T] for t in (xh, Bm, Cm, dt))
    y, h_fin = mamba2.ssd_chunked(xh, Bm, Cm, dt, a, h0, chunk)
    x64, B64, C64, d64 = (t.double() for t in (xh, Bm, Cm, dt))
    a64, h = a.double(), h0.double()
    ys = []
    for t in range(T):
        dA = torch.exp(a64[None, :] * d64[:, t])
        h = h * dA[..., None, None] + torch.einsum(
            "bh,bn,bhp->bhpn", d64[:, t], B64[:, t], x64[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", C64[:, t], h))
    y_step = torch.stack(ys, dim=1)
    errs = []
    for got, want, name in ((y, y_step, "y"), (h_fin, h, "state")):
        rel = float((got.double() - want).abs().max()
                    / want.abs().max().clamp_min(1e-30))
        check(got.dtype == torch.float32 and rel <= SSM_TOL,
              f"{SSM_ARCH} layer 0 SSD ({name}) vs the stepwise recurrence "
              f"over {T} positions: max |err| {rel:.3g} x max|value| > "
              f"{SSM_TOL}")
        errs.append(rel)
    return max(errs)


def p8_model(b: Bench, name: str, cfg, batch, budget, fams,
             n_flash: int) -> dict:
    """One model of path 8 through ``ServeEngine.generate`` at full width:
    weights drawn from seed 0 on the card, the bit-plane kernel and flash
    held at the model's shapes, a P8_WARM-token warm-up whose flash
    launches are each held against the f32 oracle on their own q/k/v (and,
    for ssm, layer 0's SSD against the stepwise recurrence), then one
    counted and timed call of P8_STEPS tokens: launches by planes, regime
    and shape as ``p8_shapes`` and ``plan()`` give them, flash launches,
    tokens repeatable and in the vocabulary; prices against the AP model;
    bit-plane and flash times against their bounds; traces of a prefill
    and a decode step."""
    torch, dev, tag = b.torch, b.dev, b.tag
    from repro_torch.apsim import metrics as apm
    from repro_torch.kernels import bitplane_matmul as bpm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm, mamba2
    from repro_torch.serve.engine import ServeEngine, default_controller

    B, S = batch["tokens"].shape
    F = batch["frames"].shape[1] if "frames" in batch else 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    qparams = lm.init_serve_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    w_gib = (torch.cuda.memory_allocated() - base) / 2 ** 30
    print(f"{name} FULL ({cfg.family}): {cfg.n_layers} layers"
          + (f" + {cfg.n_enc_layers} encoder" if F else "")
          + f", d {cfg.d_model}, vocab {cfg.vocab_size}; the int8 serve form "
          f"drawn on the card in {time.perf_counter() - t0:.3f} s: "
          f"{w_gib:.3f} GiB resident, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")

    pre = p8_shapes(cfg, B, S, F, fams)
    dec = p8_shapes(cfg, B, 1, F, fams)
    for M, K, N, n in sorted(set(pre) | set(dec)):
        b.hold_bitplane(b.rand_i8((M, K)), b.rand_i8((K, N)), n)
    fl_shapes = []
    if cfg.family != "ssm":
        H, hd = cfg.n_heads, cfg.head_dim
        fl_shapes.append(((B * H, S, S, hd), True))
        if cfg.family == "encdec":
            fl_shapes.append(((B * H, S, F, hd), False))
    f_err = [hold_flash(b, *shp, causal, 0) for shp, causal in fl_shapes]
    print(f"kernel == plain: bit-plane at the {len(set(pre) | set(dec))} "
          f"(M, K, N, n_planes) of a prefill and a decode step "
          f"{sorted(set(pre) | set(dec))}"
          + "".join(f"; flash at {shp} {'causal' if c else 'not causal'}"
                    f" within FLASH_TOL: max |err| {e:.6g}"
                    for (shp, c), e in zip(fl_shapes, f_err)))

    ctrl = default_controller(lm.n_bit_slots(cfg))
    engine = ServeEngine(cfg, qparams, max_len=S + P8_STEPS,
                         controller=ctrl, device=dev)
    check(engine.families == (4, 8), f"bit families {engine.families}")
    engine.set_budget(budget)

    # ---- the warm-up: flash held per launch, the SSD captured
    kernel_flash, real_ssd = fa.flash_attention, mamba2.ssd_chunked
    layer_err, ssd_args = [], []

    def held_flash(q, k, v, *, causal, window, scale=0.0, k_len=0):
        o = kernel_flash(q, k, v, causal=causal, window=window, scale=scale)
        layer_err.append((causal, q.shape[1], k.shape[1], float(
            (o.float() - oracle_f32(q, k, v, causal, window)).abs().max())))
        return o

    def capture_ssd(*args):
        if not ssd_args:
            ssd_args.extend(args)
        return real_ssd(*args)

    with mock.patch.object(fa, "flash_attention", held_flash), \
            mock.patch.object(mamba2, "ssd_chunked", capture_ssd):
        warm = engine.generate(batch, P8_WARM).cpu()
    check(len(layer_err) == n_flash and all(
        e <= FLASH_TOL for *_, e in layer_err), f"{name}: flash on the "
          f"path's own q/k/v vs the oracle per launch: {layer_err}")
    if layer_err:
        b.fa_err = max(b.fa_err, max(e for *_, e in layer_err))
    ssd_err = ssd_stepwise_gate(b, ssd_args) if ssd_args else None
    del ssd_args[:]

    # ---- one counted and timed call
    walls, timers = forward_timer(lm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bpm.reset_launches()
    fa.reset_launches()
    with timers[0], timers[1]:
        t0 = time.perf_counter()
        toks = engine.generate(batch, P8_STEPS).cpu()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    got, paths = bpm.launches_by_shape(), bpm.launches_by_path()
    want = {k: c for k, c in pre.items()}
    for k, c in dec.items():
        want[k] = want.get(k, 0) + c * (P8_STEPS - 1)
    want_paths = {p: 0 for p in bpm.PATHS}
    for (M, K, N, _), c in want.items():
        want_paths[bpm.plan(M, K, N).path] += c
    check(got == want, f"{name}: bit-plane launches by (M, K, N, planes) "
          f"{got} != {want}")
    check(paths == want_paths, f"{name}: launches by path {paths} != "
          f"plan()'s {want_paths}")
    check(fa.launch_count() == n_flash, f"{name}: {fa.launch_count()} flash launches "
          f"per generate, want {n_flash}")
    check(toks.shape == (B, P8_STEPS) and torch.equal(toks[:, :P8_WARM], warm)
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"{name}: tokens {toks.tolist()} (warm-up {warm.tolist()})")
    by_planes = {n: c for n, c in bpm.launches_by_planes().items() if c}
    print(f"{name} generate (B={B}, S={S}" + (f", F={F} frames" if F else "")
          + f", {P8_STEPS} new, budget {budget}): bit-plane launches "
          f"{sum(got.values())} (by planes {by_planes}, by path {paths}), "
          f"flash {fa.launch_count()}; the warm-up's "
          f"{P8_WARM} tokens repeat; flash on every launch's own q/k/v vs the"
          f" oracle: max |err| "
          f"{max((e for *_, e in layer_err), default=0.0):.6g} over "
          f"{len(layer_err)} launches "
          f"{sorted({(c, sq, sk) for c, sq, sk, _ in layer_err})}"
          + (f"; layer 0's SSD vs the stepwise recurrence over "
             f"{SSM_STEPWISE} positions: {ssd_err:.3g} x max|value| "
             f"(tolerance {SSM_TOL})" if ssd_err is not None else "")
          + f"; first row {toks[0].tolist()}")

    for bud in (budget if isinstance(budget, list) else [budget]):
        w, a = ctrl.resolve(torch.tensor(bud))
        price = apm.price_bit_vector(lm.layer_gemm_dims(cfg), w.tolist(),
                                     a.tolist(), head=lm.head_gemm_dims(cfg))
        check(engine.price_budget(bud) == price, f"{name}: price_budget"
              f"({bud}) differs from the AP model's price of its bits")

    # ---- timings
    pre_ms = walls["prefill"][0] * 1e3
    dec_ms = statistics.median(walls["decode"]) * 1e3
    print(f"{tag} {name}: generate {wall * 1e3:.3f} ms; prefill {pre_ms:.3f} "
          f"ms ({B * S / pre_ms * 1e3:.1f} prompt tokens/s); decode median "
          f"{dec_ms:.3f} ms per step ({B / dec_ms * 1e3:.3f} tokens/s), all "
          f"{[round(x * 1e3, 3) for x in walls['decode']]}; peak memory "
          f"{peak:.3f} GiB (weights {w_gib:.3f})")
    tot = [0.0] * 8
    for (M, K, N, n), c in sorted(want.items()):
        row = b.gemm_row(M, K, N, n)
        tot = [x + c * r for x, r in zip(tot, list(row)
                                         + [max(row[3], row[4])])]
    kms, pms, lms, tb, to, dms, ldms, bms = tot
    print(f"{tag} bitplane_matmul per {name} generate call "
          f"({sum(want.values())} launches): kernel {kms:.4f} ms (device "
          f"{dms:.4f}), plain {pms:.4f} ms, torch._int_mm {lms:.4f} ms "
          f"(device {ldms:.4f}), bound {bms:.4f} ms")
    flash = None
    for (BH, Sq, Sk, hd), causal in fl_shapes:
        n = sum(1 for c, *_ in layer_err if c == causal)
        row = flash_row(b, (BH, Sq, hd), f" ({name}, hd {hd})", Sk=Sk,
                        causal=causal)
        e = flash_entry(n, row, n)
        flash = e if flash is None else {k: flash[k] + e[k] for k in e}

    wv, av = engine._bits()
    dbatch = {k: v.to(dev) for k, v in batch.items()}

    def run_prefill():
        cache = lm.empty_cache(cfg, B, S + P8_STEPS, device=dev)
        with engine.compute_ctx():
            return lm.prefill(engine.qparams, dbatch, cfg, wv, av, cache)

    tr_pre = trace(torch, tag, f"one {name} prefill", run_prefill,
                   ("bitplane_matmul", "flash_attention"))
    logits, cache = run_prefill()
    tok = logits[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
    t = torch.full((B,), S, dtype=torch.int32, device=dev)

    def one_step():
        with engine.compute_ctx():
            lm.decode_step(engine.qparams, tok, t, cache, cfg, wv, av)

    tr_dec = trace(torch, tag, f"one {name} decode step", one_step,
                   ("bitplane_matmul",))
    del cache, logits, engine, qparams
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"bitplane": {"launches": sum(got.values()), "ms": kms,
                         "plain_ms": pms, "library_ms": lms, "t_bytes": tb,
                         "t_ops": to, "device_ms": dms,
                         "library_device_ms": ldms, "bound_ms": bms,
                         "paths": paths},
            "flash": flash,
            "e2e": {"prefill_ms": pre_ms, "decode_ms": dec_ms,
                    "generate_ms": wall * 1e3, "peak_gib": peak,
                    "weights_gib": w_gib,
                    "idle": (tr_pre["idle_share"], tr_dec["idle_share"])}}


def p8_path(b: Bench) -> dict:
    """Path 8: mamba2-1.3b (per-request budgets), zamba2-2.7b and
    seamless-m4t-medium (whole-batch), stablelm-12b (per-request, flash
    at hd 160), each at full width and depth, then each family's SMOKE
    card-vs-CPU prefill."""
    torch, dev = b.torch, b.dev
    cfgs = p8_configs()
    g = torch.Generator(device=dev).manual_seed(3)

    def tokens(cfg, B, S):
        return torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                             device=dev)

    out = {}
    c = cfgs["ssm"]
    out["ssm"] = p8_model(b, SSM_ARCH, c, {"tokens": tokens(c, SSM_B, SSM_S)},
                          LM_BUDGETS, (4, 8), 0)
    c = cfgs["hybrid"]
    out["hybrid"] = p8_model(b, HYB_ARCH, c,
                             {"tokens": tokens(c, HYB_B, HYB_S)}, HYB_BUDGET,
                             (8,), c.n_layers // c.attn_every)
    c = cfgs["encdec"]
    F = ED_S // c.frames_ratio
    frames = (torch.randn((ED_B, F, c.d_model), generator=g, device=dev)
              * 0.5).bfloat16()
    out["encdec"] = p8_model(b, ED_ARCH, c, {"tokens": tokens(c, ED_B, ED_S),
                                             "frames": frames},
                             ED_BUDGET, (8,), 2 * c.n_layers)
    c = cfgs["dense"]
    out["dense"] = p8_model(b, D160_ARCH, c,
                            {"tokens": tokens(c, D160_B, D160_S)},
                            D160_BUDGETS, (4, 8), c.n_layers)
    for arch, budget, F in ((SSM_ARCH, (10.0, 0.4), 0), (HYB_ARCH, 10.0, 0),
                            (ED_ARCH, 10.0, 2000),
                            (D160_ARCH, (10.0, 0.4), 0)):
        smoke_card_vs_cpu(b, arch, budget, F, seed=7)
    return out


# ---------------------------------------------------------------------------
# Path 9: training
# ---------------------------------------------------------------------------

def kernel_launches() -> int:
    """Every kernel's launches since the last ``reset_all_launches``."""
    from repro_torch.kernels import bitplane_matmul as bpm
    return sum(bpm.spec_launches.values()) + sum(off_path_launches())


def train_smoke_card_vs_cpu(b: Bench, ckpt_dir: str) -> dict:
    """(b): one SMOKE ``make_train_step`` step (n_accum 2) of every
    family on the card and on the CPU from the same weights (the CPU's
    draws copied over) and batch, gated as TRAIN_* say; then the card's
    int8 / factored optimizer state after a step, through a checkpoint
    and back, bit for bit."""
    torch, dev = b.torch, b.dev
    from repro_torch import configs
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, tree_leaves
    from repro_torch.train.checkpoint import (restore_checkpoint,
                                              save_checkpoint)
    from repro_torch.train.loop import TrainConfig, make_train_step

    out = {}
    for fam, arch in TRAIN_FAMILIES.items():
        cfg = configs.get_smoke(arch)
        params = lm.init_params(cfg, torch.Generator().manual_seed(11),
                                device="cpu")
        batch = make_batch(1, 0, TRAIN_SMOKE_B, TRAIN_SMOKE_S, cfg.vocab_size,
                           cfg)
        tcfg = TrainConfig(optimizer=AdamWConfig(lr=TRAIN_SMOKE_LR),
                           n_accum=2, wbits=TRAIN_WBITS, abits=TRAIN_ABITS)
        res = []
        for where in (dev, torch.device("cpu")):
            p = tree_to(params, where)
            step, _ = make_train_step(tcfg, cfg, device=where)
            new, opt, m = step(p, adamw_init(p, tcfg.optimizer),
                               tree_to(batch, where))
            res.append(([t.cpu() for t in tree_leaves(new)],
                        {k: float(v) for k, v in m.items()},
                        int(opt["step"])))
        (card, cm_, cs), (cpu, pm, ps) = res
        loss_err = abs(cm_["loss"] - pm["loss"]) / pm["loss"]
        norm_err = abs(cm_["grad_norm"] - pm["grad_norm"]) / pm["grad_norm"]
        n_diff = n_all = 0
        worst = 0.0
        for a, w in zip(card, cpu):
            bf16 = w.dtype == torch.bfloat16
            a, w = a.float(), w.float()
            d = (a - w).abs()
            # one step of the dtype at the larger of |a| and |w| (the f32
            # spacing x 2^16 in bf16): each side rounds by half a step of
            # its own binade
            top = torch.maximum(a.abs(), w.abs())
            one = (torch.nextafter(top, torch.tensor(float("inf"))) - top) \
                * (2.0 ** 16 if bf16 else 1.0)
            worst = max(worst, float((d / (2 * TRAIN_SMOKE_LR + one)).max()))
            n_diff += int((d > 0).sum())
            n_all += d.numel()
        check(math.isfinite(cm_["loss"]) and loss_err <= TRAIN_LOSS_TOL
              and norm_err <= TRAIN_NORM_TOL and worst <= 1.0
              and n_diff <= TRAIN_STEP_SHARE * n_all and cs == ps == 1,
              f"SMOKE {arch} train step, card vs CPU: loss "
              f"{cm_['loss']!r} vs {pm['loss']!r}, grad_norm "
              f"{cm_['grad_norm']!r} vs {pm['grad_norm']!r}, worst parameter"
              f" {worst:.3g} of its bound, {n_diff} of {n_all} differ")
        out[fam] = {"loss_err": loss_err, "norm_err": norm_err,
                    "share": n_diff / n_all}
        print(f"SMOKE {arch} ({fam}) train step (B={TRAIN_SMOKE_B}, "
              f"S={TRAIN_SMOKE_S - 1}, n_accum 2), card vs CPU: loss "
              f"{cm_['loss']:.6f} vs {pm['loss']:.6f} (rel {loss_err:.3g}), "
              f"grad_norm rel {norm_err:.3g}, {n_diff} of {n_all} new "
              f"parameter elements differ (worst {worst:.3g} of "
              f"2 lr + one bf16 step)")

    # the checkpoint round trip of a card state (int8 codecs, factored v,
    # bf16 parameters, the int32 step)
    cfg = configs.get_smoke(LM_ARCH)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(12),
                            device=dev)
    tcfg = TrainConfig(optimizer=AdamWConfig(
        lr=TRAIN_SMOKE_LR, m_dtype="int8", v_mode="factored"))
    step, _ = make_train_step(tcfg, cfg, device=dev)
    batch = tree_to(make_batch(1, 1, 2, 33, cfg.vocab_size), dev)
    new, opt, _ = step(params, adamw_init(params, tcfg.optimizer), batch)
    tree = {"params": new, "opt": opt}
    save_checkpoint(ckpt_dir, 1, tree)
    target = {"params": params, "opt": adamw_init(params, tcfg.optimizer)}
    back, s_no = restore_checkpoint(ckpt_dir, target, device=dev)
    leaves_a, leaves_b = tree_leaves(tree), tree_leaves(back)
    dtypes = sorted({str(t.dtype) for t in leaves_a})
    check(s_no == 1 and len(leaves_a) == len(leaves_b) and all(
        a.dtype == c.dtype and a.device == c.device and torch.equal(a, c)
        for a, c in zip(leaves_a, leaves_b)),
          "SMOKE checkpoint round trip on the card is not bit for bit")
    print(f"SMOKE {LM_ARCH} checkpoint round trip on the card: "
          f"{len(leaves_a)} leaves ({', '.join(dtypes)}) EQUAL")
    return out


def flash_refusal(b: Bench) -> float:
    """(c): flash operands that require grad at (B*H, REFUSE_S, hd)
    raise under grad mode, and through ``lm.train_loss`` past
    FLASH_THRESHOLD; the same call under no_grad launches and is within
    FLASH_TOL of the plain version."""
    torch, dev = b.torch, b.dev
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import lm

    shape = (TRAIN_B // TRAIN_ACCUM * LM_WIDTHS[2], REFUSE_S, LM_WIDTHS[6])
    q, k, v = (torch.randn(shape, generator=b.gen, device=dev).bfloat16()
               for _ in range(3))
    for t in (q, k, v):
        t.requires_grad_(True)
    fa.reset_launches()
    try:
        ops.flash_attention(q, k, v, causal=True)
        fail("flash_attention took operands that require grad")
    except NotImplementedError as e:
        check("no backward" in str(e), f"flash refusal says {e}")
    cfg = configs.get_smoke(LM_ARCH)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(13),
                            device=dev)
    for t in params["layers"]["attn"]["wq"].values():
        t.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab_size, (1, REFUSE_S + 1),
                         generator=b.gen, device=dev)
    n = lm.n_bit_slots(cfg)
    try:
        lm.train_loss(params, {"tokens": toks}, cfg, [8] * n, [8] * n)
        fail(f"train_loss at S={REFUSE_S} ran through flash with grad")
    except NotImplementedError as e:
        check("no backward" in str(e), f"flash refusal says {e}")
    check(fa.launch_count() == 0, f"{fa.launch_count()} flash launches while refusing")
    with torch.no_grad():
        got = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = float((got.float() - oracle_f32(q.detach(), k.detach(), v.detach(),
                                          True, 0)).abs().max())
    check(fa.launch_count() == 1 and not got.requires_grad and err <= FLASH_TOL,
          f"flash under no_grad: {fa.launch_count()} launches, max |err| {err}")
    b.fa_err = max(b.fa_err, err)
    print(f"flash refusal: operands that require grad at {shape} and "
          f"train_loss at S={REFUSE_S} raise; under no_grad the kernel "
          f"launches once, max |err| {err:.6g} vs the f32 oracle "
          f"(tolerance {FLASH_TOL})")
    return err


def train_path(b: Bench, ckpt_dir: str) -> dict:
    """Path 9: (a) Qwen3-4B trained at full width, (b) SMOKE steps card
    vs CPU and a checkpoint round trip, (c) the flash refusal, (d) the
    trained weights quantized and served through the bit-plane kernel."""
    torch, dev, tag = b.torch, b.dev, b.tag
    from repro_torch import configs
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels import bitplane_matmul as bpm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, tree_leaves
    from repro_torch.serve.engine import ServeEngine, default_controller
    from repro_torch.train.loop import TrainConfig, make_train_step

    # ---- (a) Qwen3-4B at full width
    cfg = configs.get(LM_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.d_ff, cfg.vocab_size, cfg.head_dim) == LM_WIDTHS
          and cfg.remat == "full", f"{LM_ARCH} FULL: {cfg}")
    check(TRAIN_S <= tf.FLASH_THRESHOLD and TRAIN_B % TRAIN_ACCUM == 0,
          "path 9's sequences must stay at or below FLASH_THRESHOLD")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=TRAIN_LR, m_dtype="int8",
                                             v_mode="factored"),
                       n_accum=TRAIN_ACCUM, wbits=TRAIN_WBITS,
                       abits=TRAIN_ABITS)
    opt = adamw_init(params, tcfg.optimizer)
    step, _ = make_train_step(tcfg, cfg, device=dev)
    batch = tree_to(make_batch(0, 0, TRAIN_B, TRAIN_S + 1, cfg.vocab_size,
                               cfg), dev)
    torch.cuda.synchronize()

    def gib(tree):
        return sum(t.numel() * t.element_size()
                   for t in tree_leaves(tree)) / 2 ** 30

    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"{LM_ARCH} FULL train form: {n_params} parameters, "
          f"{gib(params):.3f} GiB bf16; optimizer state (int8 m, factored v) "
          f"{gib(opt):.3f} GiB; drawn on the card in "
          f"{time.perf_counter() - t0:.3f} s; batch {TRAIN_B} x "
          f"{TRAIN_S + 1} tokens in {TRAIN_ACCUM} microbatches")
    losses, norms, walls = [], [], []
    state = {}

    def one_step():
        state["out"] = step(params, opt, batch)

    reset_all_launches()
    for i in range(TRAIN_STEPS):
        if i < TRAIN_STEPS - 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one_step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        else:                                  # the last step, traced
            tr = trace(torch, tag, f"one {LM_ARCH} train step", one_step,
                       ("gemm", "elementwise", "reduce"))
        params, opt, m = state.pop("out")
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    launched = kernel_launches()
    check(all(math.isfinite(x) for x in losses + norms),
          f"{LM_ARCH} training: losses {losses}, grad norms {norms}")
    check(losses[-1] < losses[0] - TRAIN_MARGIN,
          f"{LM_ARCH} training: the loss fell from {losses[0]!r} to "
          f"{losses[-1]!r}, not by {TRAIN_MARGIN} nats")
    check(launched == 0 and int(opt["step"]) == TRAIN_STEPS,
          f"{launched} kernel launches while training (the train form "
          f"reaches none); optimizer step {int(opt['step'])}")
    step_ms = statistics.median(walls[1:]) * 1e3
    tokens = TRAIN_B * TRAIN_S
    print(f"{tag} {LM_ARCH} training (lr {TRAIN_LR}, wbits {TRAIN_WBITS}, "
          f"abits {TRAIN_ABITS}): loss {[round(x, 4) for x in losses]}, "
          f"grad_norm {[round(x, 4) for x in norms]}; step median "
          f"{step_ms:.3f} ms over steps 2-{TRAIN_STEPS - 1} (all untraced "
          f"{[round(w * 1e3, 3) for w in walls]}; the last step traced), "
          f"{tokens / step_ms * 1e3:.1f} tokens/s; peak "
          f"{peak:.3f} GiB above the {base / 2 ** 30:.3f} GiB resident "
          f"before; no kernel launched")
    del opt, batch, step, m

    # ---- (b) SMOKE steps card vs CPU, (c) the flash refusal
    smoke = train_smoke_card_vs_cpu(b, ckpt_dir)
    flash_refusal(b)

    # ---- (d) serve the trained weights
    qparams = lm.quantize_params(params, cfg)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    n = lm.n_bit_slots(cfg)
    engine = ServeEngine(cfg, qparams, max_len=SERVE_S + SERVE_NEW,
                         controller=default_controller(n), device=dev)
    engine.set_budget(SERVE_BUDGETS)
    prompts = {"tokens": torch.randint(0, cfg.vocab_size,
                                       (len(SERVE_BUDGETS), SERVE_S),
                                       generator=b.gen, device=dev)}
    reset_all_launches()
    t0 = time.perf_counter()
    toks = engine.generate(prompts, SERVE_NEW).cpu()
    wall = time.perf_counter() - t0
    got, paths = bpm.launches_by_shape(), bpm.launches_by_path()
    want_paths = {p: 0 for p in bpm.PATHS}
    for (M, K, N, _), c in got.items():
        want_paths[bpm.plan(M, K, N).path] += c
    check(sum(got.values()) > 0 and paths == want_paths
          and fa.launch_count() == 0
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"serving the trained weights: bit-plane launches {got}, by path "
          f"{paths} (plan() gives {want_paths}), flash {fa.launch_count()}, "
          f"tokens {toks.tolist()}")
    for M, K, N, n_pl in sorted(got):
        b.hold_bitplane(b.rand_i8((M, K)), b.rand_i8((K, N)), n_pl)
    print(f"{LM_ARCH} trained weights served (B={len(SERVE_BUDGETS)}, "
          f"S={SERVE_S}, {SERVE_NEW} new, budgets {SERVE_BUDGETS}): generate "
          f"{wall * 1e3:.3f} ms, bit-plane launches {sum(got.values())} "
          f"(by path {paths}) at {len(got)} (M, K, N, planes) each held "
          f"EQUAL to the plain version; tokens {toks.tolist()}")
    tot = [0.0] * 8
    for (M, K, N, n_pl), c in sorted(got.items()):
        row = b.gemm_row(M, K, N, n_pl)
        tot = [x + c * r for x, r in zip(tot, list(row)
                                         + [max(row[3], row[4])])]
    kms, pms, lms, tb, to, dms, ldms, bms = tot
    del engine, qparams
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"bitplane": {"launches": sum(got.values()), "ms": kms,
                         "plain_ms": pms, "library_ms": lms, "t_bytes": tb,
                         "t_ops": to, "device_ms": dms,
                         "library_device_ms": ldms, "bound_ms": bms,
                         "paths": paths},
            "smoke": smoke,
            "e2e": {"step_ms": step_ms, "tokens_per_s": tokens / step_ms
                    * 1e3, "peak_gib": peak, "losses": losses,
                    "idle": tr["idle_share"], "serve_ms": wall * 1e3}}


def p10_drive(torch, cli, argv):
    """``cli.main(argv)`` with the engine it builds recorded; every
    kernel count is set to 0 just before and read just after.  Returns
    (what main returned, the engine, the counts, wall s)."""
    from repro_torch.kernels import bitplane_matmul as bpm
    from repro_torch.serve import engine as eng_mod

    built = []

    class Recorded(eng_mod.ServeEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    cuda = torch.cuda.is_available()
    with mock.patch.object(cli, "ServeEngine", Recorded):
        if cuda:
            torch.cuda.synchronize()
        reset_all_launches()
        t0 = time.perf_counter()
        out = cli.main(argv)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fl, i4, qm = off_path_launches()
    counts = {"shapes": bpm.launches_by_shape(),
              "paths": bpm.launches_by_path(), "flash": fl, "int4": i4,
              "quant": qm}
    check(len(built) == 1, f"{argv}: built {len(built)} engines")
    return out, built[0], counts, wall


def load_script(rel: str):
    """A script of the checkout (examples/, launch/) as a module."""
    import importlib.util
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(
        "p10_" + path.stem, str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def p10_want_paths(shapes) -> dict:
    from repro_torch.kernels import bitplane_matmul as bpm
    want = {p: 0 for p in bpm.PATHS}
    for (M, K, N, _), c in shapes.items():
        want[bpm.plan(M, K, N).path] += c
    return want


def p10_record_prices(label, cfg, reqs, units, bits_of) -> None:
    """Each request's AP latency, energy and EDP EQUAL the AP model's
    price of its bits over its units (prompt + new tokens)."""
    import numpy as np
    from repro_torch.apsim import metrics as apm
    from repro_torch.models import lm
    gemms, head = lm.layer_gemm_dims(cfg), lm.head_gemm_dims(cfg)
    for r in reqs:
        wv, av = bits_of(r)
        c = apm.price_bit_vector(gemms, wv.tolist(), av.tolist(), head=head)
        lat, en = units * c.latency_s, units * c.energy_j
        check(r["mean_wbits"] == float(np.mean(np.asarray(wv, np.float64)))
              and (r["ap_latency_s"], r["ap_energy_j"], r["edp"])
              == (lat, en, en * lat),
              f"{label} request {r['rid']}: mean wbits {r['mean_wbits']}, "
              f"AP ({r['ap_latency_s']}, {r['ap_energy_j']}, {r['edp']}) "
              f"!= the AP model's ({lat}, {en}, {en * lat}) for bits "
              f"{wv.tolist()}")


def p10_full(b: Bench) -> dict:
    """(a): the serving CLI at Qwen3-4B's full width, continuous then
    --batch, gated against the controller, the AP model and a ServeEngine
    built directly on the CLI's weights; returns the launches of both
    runs."""
    import numpy as np
    torch, dev, tag = b.torch, b.dev, b.tag
    from repro_torch import configs
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import lm
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import ServeEngine, default_controller

    cfg = configs.get(LM_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.d_ff, cfg.vocab_size, cfg.head_dim) == LM_WIDTHS,
          f"{LM_ARCH} FULL is not the published width: {cfg}")
    n = lm.n_bit_slots(cfg)
    ctrl = default_controller(n)
    V = cfg.vocab_size

    def arg(argv, flag, conv=int):
        return conv(argv[argv.index(flag) + 1])

    def budgets(argv):
        i = argv.index("--budgets") + 1
        return [float(x) for x in argv[i:] if not x.startswith("--")]

    # ---- continuous
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out, eng, cnt, wall = p10_drive(torch, serve_cli, ["--arch", LM_ARCH]
                                    + P10_CONT)
    peak_c = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    n_req, S = arg(P10_CONT, "--requests"), arg(P10_CONT, "--prompt-len")
    new, bud = arg(P10_CONT, "--steps"), budgets(P10_CONT)
    reqs = out["requests"]
    check(out["mode"] == "continuous" and len(reqs) == n_req
          and all(r["n_tokens"] == new and r["budget_s"] == bud[i % len(bud)]
                  and all(0 <= t < V for t in r["tokens"])
                  for i, r in enumerate(reqs))
          and eng.stats.unserved == 0 and out["stats"]["admitted"] == n_req,
          f"(a) continuous: (budget, tokens) "
          f"{[(r['budget_s'], r['n_tokens']) for r in reqs]}")
    p10_record_prices("(a) continuous", cfg, reqs, S + new,
                      lambda r: ctrl.resolve(torch.tensor(r["budget_s"])))
    check(sum(cnt["shapes"].values()) > 0
          and cnt["paths"] == p10_want_paths(cnt["shapes"])
          and (cnt["flash"], cnt["int4"], cnt["quant"]) == (0, 0, 0),
          f"(a) continuous launches: bit-plane {cnt['paths']}, flash "
          f"{cnt['flash']}, int4 {cnt['int4']}, quant {cnt['quant']}")
    # the same weights and stream through a ServeEngine built directly
    direct = ServeEngine(cfg, eng.qparams, max_len=arg(P10_CONT, "--max-len"),
                         controller=default_controller(n),
                         n_slots=arg(P10_CONT, "--n-slots"), prefill_len=S,
                         decode_block=arg(P10_CONT, "--decode-block"),
                         device=dev)
    t0 = time.perf_counter()
    rids = [direct.submit(np.asarray(make_batch(7, i, 1, S, V)["tokens"][0]),
                          max_new_tokens=new, budget_s=bud[i % len(bud)])
            for i in range(n_req)]
    res = direct.run()
    direct_s = time.perf_counter() - t0
    check([res[r].tokens for r in rids] == [r["tokens"] for r in reqs],
          "(a) the CLI's token streams differ from a ServeEngine built "
          "directly on its weights and stream")
    print(f"(a) repro_torch.launch.serve {' '.join(P10_CONT)} on {LM_ARCH} "
          f"FULL: {n_req} requests served, {new} tokens each, mean wbits "
          f"{[round(r['mean_wbits'], 4) for r in reqs]} as default_controller"
          f" resolves their budgets, AP latency/energy/EDP equal to the AP "
          f"model's price of their bits; forwards {out['calls']}; bit-plane"
          f" launches {sum(cnt['shapes'].values())} (by path "
          f"{cnt['paths']}); token streams EQUAL a ServeEngine built "
          f"directly on the CLI's weights")
    del direct, eng, res
    torch.cuda.empty_cache()

    # ---- --batch: lock-step prefill past FLASH_THRESHOLD through flash
    Sb = arg(P10_BATCH, "--prompt-len")
    check(Sb > tf.FLASH_THRESHOLD, "(a) --batch prompts must reach flash")
    torch.cuda.reset_peak_memory_stats()
    out_b, eng_b, cnt_b, wall_b = p10_drive(
        torch, serve_cli, ["--arch", LM_ARCH] + P10_BATCH)
    peak_b = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    bud_b, Bb = budgets(P10_BATCH), arg(P10_BATCH, "--requests")
    steps_b = arg(P10_BATCH, "--steps")
    check(out_b["mode"] == "batch" and len(out_b["batches"]) == len(bud_b)
          and all(len(x["tokens"]) == Bb and all(
              len(t) == steps_b and all(0 <= v < V for v in t)
              for t in x["tokens"]) for x in out_b["batches"]),
          "(a) --batch: wrong number or range of tokens")
    from repro_torch.apsim import metrics as apm
    for x, budget in zip(out_b["batches"], bud_b):
        wv, av = ctrl.resolve(torch.tensor(budget))
        c = apm.price_bit_vector(lm.layer_gemm_dims(cfg), wv.tolist(),
                                 av.tolist(), head=lm.head_gemm_dims(cfg))
        check(x["mean_wbits"] == float(np.mean(wv.numpy()))
              and (x["ap_cycles"], x["ap_energy_j"]) == (c.cycles,
                                                         c.energy_j),
              f"(a) --batch at budget {budget}: mean wbits "
              f"{x['mean_wbits']}, AP ({x['ap_cycles']}, "
              f"{x['ap_energy_j']}) != ({c.cycles}, {c.energy_j})")
    check(cnt_b["flash"] == cfg.n_layers * len(bud_b)
          and sum(cnt_b["shapes"].values()) > 0
          and cnt_b["paths"] == p10_want_paths(cnt_b["shapes"])
          and (cnt_b["int4"], cnt_b["quant"]) == (0, 0),
          f"(a) --batch launches: flash {cnt_b['flash']} (want "
          f"{cfg.n_layers} a call), bit-plane {cnt_b['paths']}")
    print(f"(a) repro_torch.launch.serve {' '.join(P10_BATCH)}: "
          f"{len(bud_b)} generate calls, mean wbits "
          f"{[x['mean_wbits'] for x in out_b['batches']]}, AP cycles and "
          f"energy per token equal to the AP model's; flash launches "
          f"{cnt_b['flash']} ({cfg.n_layers} a call), bit-plane "
          f"{sum(cnt_b['shapes'].values())} (by path {cnt_b['paths']})")
    del eng_b
    torch.cuda.empty_cache()
    print(f"{tag} (a) walls (weights drawn and quantized on the card "
          f"included): continuous {wall:.3f} s (its run() {out['wall_s']:.3f}"
          f" s; the direct engine's {direct_s:.3f} s), --batch "
          f"{wall_b:.3f} s (generate "
          f"{[round(x['wall_s'], 3) for x in out_b['batches']]} s); peak {peak_c:.3f} / {peak_b:.3f} GiB above the "
          f"{base / 2 ** 30:.3f} GiB resident before")
    return {"cont": cnt, "batch": cnt_b, "flash_shape": (
        Bb * cfg.n_heads, Sb, cfg.head_dim),
            "e2e": {"cont_s": wall, "run_s": out["wall_s"],
                    "batch_s": wall_b, "peak_gib": max(peak_c, peak_b)}}


def p10_batch_gaps(eng, tokens, steps, budget):
    """The whole-batch greedy run ``generate`` makes, with each row's
    top-2 logit gap per step over max|logit|: (tokens, gaps) per row."""
    import torch
    from repro_torch.models import lm
    dev, cfg, V = eng.device, eng.cfg, eng.cfg.vocab_size
    wv, av = eng.controller.resolve(torch.tensor(budget, dtype=torch.float32))
    wv, av = wv.to(dev), av.to(dev)
    toks = torch.as_tensor(tokens).to(dev)
    B, S = toks.shape
    cache = lm.empty_cache(cfg, B, eng.max_len, device=dev)
    out, gaps = [], []

    def take(logits):
        lg = logits[:, -1, :V].float()
        top2 = lg.topk(2, dim=-1).values
        gaps.append((top2[:, 0] - top2[:, 1]) / lg.abs().amax(-1))
        out.append(lg.argmax(-1).to(torch.int32))
        return out[-1][:, None]

    with eng.compute_ctx():
        logits, cache = lm.prefill(eng.qparams, {"tokens": toks}, cfg, wv,
                                   av, cache)
        tok = take(logits)
        t = torch.full((B,), S, dtype=torch.int32, device=dev)
        for _ in range(steps - 1):
            logits, cache = lm.decode_step(eng.qparams, tok, t, cache, cfg,
                                           wv, av)
            tok = take(logits)
            t = t + 1
    o, g = torch.stack(out, 1).cpu(), torch.stack(gaps, 1).cpu()
    return [(o[i].tolist(), g[i].tolist()) for i in range(B)]


def p10_smoke_modes(b: Bench, ckpt_dir: str) -> None:
    """(b): continuous, --slo-edp, --kv-bits 8 and --batch at SMOKE size on
    a SMOKE checkpoint, card vs CPU: host results EQUAL, greedy tokens as
    ``tokens_agree`` says against the CPU's own gaps."""
    torch, dev = b.torch, b.dev
    from repro_torch import configs
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.models import lm
    from repro_torch.serve.accounting import predict_table
    from repro_torch.serve.engine import default_controller

    train_cli.main(["--arch", LM_ARCH, "--smoke", "--device", "cpu",
                    "--steps", "2", "--batch", "2", "--seq", "16",
                    "--ckpt-dir", ckpt_dir, "--log-every", "1"])
    scfg = configs.get_smoke(LM_ARCH)
    n_req = int(P10_SMOKE[P10_SMOKE.index("--requests") + 1])
    S = int(P10_SMOKE[P10_SMOKE.index("--prompt-len") + 1])
    new = int(P10_SMOKE[P10_SMOKE.index("--steps") + 1])
    preds = predict_table(lm.layer_gemm_dims(scfg),
                          default_controller(lm.n_bit_slots(scfg)).configs,
                          axis="edp", units=S + new,
                          head=lm.head_gemm_dims(scfg))
    slo = P10_SLO_FRACTION * n_req * preds["int8"]
    modes = {"continuous": ["--budgets", "2.0", "0.5", "0.75"],
             "--slo-edp": ["--slo-edp", repr(slo)],
             "--kv-bits 8": ["--kv-bits", "8"],
             "--batch": ["--batch", "--requests", "2", "--budgets", "2.0",
                         "0.5"]}
    host = ("budget_s", "mean_wbits", "n_tokens", "slot", "ap_latency_s",
            "ap_energy_j", "edp")
    compared = exact = streams = 0
    for mode, extra in modes.items():
        runs = {}
        for where in ("cuda", "cpu"):
            argv = (["--arch", LM_ARCH] + P10_SMOKE + extra
                    + ["--ckpt-dir", ckpt_dir, "--device", where])
            runs[where] = p10_drive(torch, serve_cli, argv)[:2]
        (card, _), (cpu, cpu_eng) = runs["cuda"], runs["cpu"]
        check(card["restored_step"] == cpu["restored_step"] == 2,
              f"(b) {mode}: restored steps {card['restored_step']} / "
              f"{cpu['restored_step']}")
        if mode == "--batch":
            bud = [float(x) for x in extra[-2:]]
            for i, (xc, xh) in enumerate(zip(card["batches"],
                                             cpu["batches"])):
                check({k: xc[k] for k in ("budget_s", "mean_wbits",
                                          "ap_cycles", "ap_energy_j")}
                      == {k: xh[k] for k in ("budget_s", "mean_wbits",
                                             "ap_cycles", "ap_energy_j")},
                      f"(b) --batch {i}: host results differ card vs CPU")
                toks = make_batch(7, i, 2, S, scfg.vocab_size)["tokens"]
                rows = p10_batch_gaps(cpu_eng, toks, new, bud[i])
                for r, (want, gaps) in enumerate(rows):
                    check(xh["tokens"][r] == want,
                          f"(b) --batch {i} row {r} on the CPU: "
                          f"{xh['tokens'][r]} != its replay {want}")
                    c, e = tokens_agree(f"(b) --batch {i} row {r} card vs "
                                        f"CPU", xc["tokens"][r], want, gaps)
                    compared, exact, streams = (compared + c, exact + e,
                                                streams + 1)
            continue
        check([{k: r[k] for k in host} for r in card["requests"]]
              == [{k: r[k] for k in host} for r in cpu["requests"]]
              and card["closed_loop"] == cpu["closed_loop"],
              f"(b) {mode}: host results differ card vs CPU: "
              f"{card['requests']} / {cpu['requests']}, closed loop "
              f"{card['closed_loop']} / {cpu['closed_loop']}")
        if mode == "--slo-edp":
            loop = cpu["closed_loop"]
            check(loop["spent_edp"] <= loop["slo_edp"]
                  and len({r["mean_wbits"] for r in cpu["requests"]}) > 1,
                  f"(b) --slo-edp: spent {loop}, bits "
                  f"{[r['mean_wbits'] for r in cpu['requests']]}")
        for i, (rc, rh) in enumerate(zip(card["requests"], cpu["requests"])):
            prompt = make_batch(7, i, 1, S, scfg.vocab_size)["tokens"][0]
            want, gaps = cb_standalone(cpu_eng, prompt.numpy(), new,
                                       rh["budget_s"], S)
            check(rh["tokens"] == want, f"(b) {mode} request {i} on the "
                  f"CPU: {rh['tokens']} != standalone {want}")
            c, e = tokens_agree(f"(b) {mode} request {i} card vs CPU",
                                rc["tokens"], want, gaps)
            compared, exact, streams = compared + c, exact + e, streams + 1
    print(f"(b) SMOKE {LM_ARCH} through repro_torch.launch.serve on a "
          f"checkpoint of repro_torch.launch.train (step 2), card vs CPU, "
          f"in {', '.join(modes)}: restored step, mean wbits, AP prices, "
          f"spend against the SLO ({P10_SLO_FRACTION} x the int8 price) "
          f"EQUAL; greedy tokens exact in {exact} of {streams} streams, "
          f"{compared} tokens compared; on the CPU each stream equals its "
          f"standalone (or whole-batch) replay")


def p10_traces() -> None:
    """(c): launch/serve_torch.py on the card and with --device cpu: the
    reports EQUAL (no field of the report is a wall time)."""
    cli = load_script("launch/serve_torch.py")
    for argv in P10_TRACES:
        reps = {}
        for where in ("cuda", "cpu"):
            t0 = time.perf_counter()
            reps[where] = (cli.main(argv + ["--device", where]),
                           time.perf_counter() - t0)
        (card, s_card), (cpu, s_cpu) = reps["cuda"], reps["cpu"]
        check(card == cpu and card["unserved"] == 0
              and card["completed"] == card["requests"]
              and ("prefix_cache" in card) == ("--prefix-cache" in argv),
              f"(c) {' '.join(argv)}: reports differ card vs CPU:\n{card}\n"
              f"{cpu}")
        extra = (f", prefix cache {card['prefix_cache']['hits']} full hits "
                 f"of {card['prefix_cache']['lookups']} lookups"
                 if "prefix_cache" in card else "")
        print(f"(c) launch/serve_torch.py {' '.join(argv)}: "
              f"{card['completed']}/{card['requests']} served, mean wbits "
              f"{card['mean_wbits']}, total EDP {card['total_edp_js']:.6e}"
              f"{extra}; reports EQUAL card vs CPU ({s_card:.3f} s / "
              f"{s_cpu:.3f} s)")


def p10_emulator(b: Bench) -> None:
    """(d): the AP emulator's word ops at EMU_L rows on the card EQUAL the
    CPU run and torch integer arithmetic, values and pass counts; its
    ap_matmul EQUALS the bit-plane kernel at n_planes = M."""
    import numpy as np
    torch, dev = b.torch, b.dev
    from repro_torch.core import emulator as em
    from repro_torch.kernels import bitplane_matmul as bpm
    g = np.random.default_rng(10)
    t0 = time.perf_counter()
    lines = []
    for M in EMU_MS:
        a = g.integers(0, 1 << M, EMU_L)
        c_ = g.integers(0, 1 << M, EMU_L)
        v = g.integers(-(1 << (M - 1)), 1 << (M - 1), EMU_L)
        for name, args, exact in (("ap_add", (a, c_), a + c_),
                                  ("ap_multiply", (a, c_), a * c_),
                                  ("ap_relu", (v,), np.maximum(v, 0)),
                                  ("ap_max", (a, c_), np.maximum(a, c_))):
            got, cc = getattr(em, name)(*args, M, device=dev)
            want, ch = getattr(em, name)(*args, M, device="cpu")
            check(got.device == dev and torch.equal(got.cpu(), want)
                  and np.array_equal(want.numpy(), exact) and cc == ch,
                  f"(d) {name} at M={M}, L={EMU_L}: card vs CPU vs integers "
                  f"differ, or counts {cc} / {ch}")
            lines.append(f"{name}@{M} {cc.compares}/{cc.writes}/{cc.reads}")
        got, cc = em.ap_reduce(a, M, device=dev)
        want, ch = em.ap_reduce(a, M, device="cpu")
        check(got == want == int(a.sum()) and cc == ch,
              f"(d) ap_reduce at M={M}: {got} / {want} / {int(a.sum())}, "
              f"counts {cc} / {ch}")
        lines.append(f"ap_reduce@{M} {cc.compares}/{cc.writes}/{cc.reads}")
        X = g.integers(0, 1 << (M - 1), EMU_X)
        W = g.integers(0, 1 << (M - 1), EMU_W)
        got, cc = em.ap_matmul(X, W, M, device=dev)
        want, ch = em.ap_matmul(X, W, M, device="cpu")
        kern = bpm.bitplane_matmul(
            torch.from_numpy(X.astype(np.int8)).to(dev),
            torch.from_numpy(W.astype(np.int8)).to(dev), n_planes=M)
        check(torch.equal(got.to(torch.int32), kern)
              and torch.equal(got.cpu(), want) and cc == ch
              and np.array_equal(want.numpy(), X @ W),
              f"(d) ap_matmul at M={M}: emulator, CPU, kernel and X @ W "
              f"differ, or counts {cc} / {ch}")
        lines.append(f"ap_matmul@{M} {cc.compares}/{cc.writes}/{cc.reads}")
    print(f"(d) AP emulator on the card at L={EMU_L} rows, M in {EMU_MS}: "
          f"values and pass counts EQUAL the CPU run's and torch integer "
          f"arithmetic (compares/writes/reads: {', '.join(lines)}); "
          f"ap_matmul {EMU_X} @ {EMU_W} EQUALS the bit-plane kernel at "
          f"n_planes = M ({time.perf_counter() - t0:.3f} s)")


def p10_fluid_linear(b: Bench) -> None:
    """(e): ops.fluid_linear at wbits 1..8 on a Qwen3-4B and a ResNet18
    GEMM, one launch at exactly wbits planes, the kernel's int32 EQUAL to
    the plain version's and the f32 outputs EQUAL; then vmap against
    grouped rows."""
    torch, dev = b.torch, b.dev
    from repro_torch.apsim.workloads import resnet18
    from repro_torch.core import bitfluid as bf
    from repro_torch.kernels import bitplane_matmul as bpm
    from repro_torch.kernels import ops
    res = next((M, K, N) for name, M, K, N, _ in path_gemms(
        resnet18(), BATCH, IMAGE) if name == FL_RESNET)
    for (M, K, N), label in ((FL_QWEN, f"{LM_ARCH} up-projection"),
                             (res, f"resnet18 {FL_RESNET}")):
        x = torch.randn((M, K), generator=b.gen, device=dev)
        w, ws = b.rand_i8((K, N)), b.rand_scale(N)
        xs = bf.symmetric_scale(x, 8)
        x_q = bf.quantize(x, xs, 8)
        for n in range(1, 9):
            bpm.reset_launches()
            y = ops.fluid_linear(x, w, ws, wbits=n)
            acc = ops.int8_accum(x_q, w, planes=n)
            plain = bpm.bitplane_matmul_ref(x_q, w, n)
            torch.cuda.synchronize()
            by_planes = bpm.launches_by_planes()
            check(by_planes[n] == 2 and sum(by_planes.values()) == 2
                  and torch.equal(acc, plain)
                  and torch.equal(y, plain.float() * xs * ws),
                  f"(e) fluid_linear {label} ({M},{K},{N}) at wbits {n}: "
                  f"launches {by_planes}, int32 or f32 differs from the "
                  f"plain version")
        print(f"(e) ops.fluid_linear on {label} ({M},{K},{N}) at wbits "
              f"1..8: one launch at exactly wbits planes each, int32 EQUAL "
              f"to the plain version, f32 outputs EQUAL")
    d, f = LM_WIDTHS[1], LM_WIDTHS[4]
    p = {"q": b.rand_i8((d, f)), "s": b.rand_scale(f)}
    x = torch.randn((len(VMAP_BITS), 1, d), generator=b.gen, device=dev)
    wb = torch.tensor(VMAP_BITS, device=dev)
    bpm.reset_launches()
    grouped = ops.serve_linear(p, x, wb, 8)
    n_g, by_g = sum(bpm.spec_launches.values()), bpm.launches_by_planes()
    bpm.reset_launches()
    with ops.row_dispatch("vmap"):
        vm = ops.serve_linear(p, x, wb, 8)
    torch.cuda.synchronize()
    n_v, by_v = sum(bpm.spec_launches.values()), bpm.launches_by_planes()
    check(torch.equal(vm, grouped) and n_v == len(VMAP_BITS)
          and n_g == len(ops.get_bit_families()),
          f"(e) vmap vs grouped: EQUAL {torch.equal(vm, grouped)}, "
          f"launches {n_v} / {n_g}")
    print(f"(e) rows at wbits {VMAP_BITS} ({len(VMAP_BITS)} x 1 x {d} @ "
          f"({d}, {f})): vmap EQUALS grouped; launches by planes vmap "
          f"{ {k: v for k, v in by_v.items() if v} } (one a row, at the "
          f"container width), grouped { {k: v for k, v in by_g.items() if v} }"
          f" (one a family of {ops.get_bit_families()})")


def p10_examples(b: Bench) -> None:
    """(f): the three examples in process on the card and with --device
    cpu; their host numbers EQUAL."""
    host = {
        "quickstart": lambda o: {k: v["mean_wbits"]
                                 for k, v in o["served"].items()},
        "bitfluid_serving": lambda o: (
            [{k: r[k] for k in ("budget_s", "mean_wbits", "slot", "edp")}
             for r in o["open_loop"]], o["closed_loop"], o["slo"],
            o["spent"]),
        "mixed_precision_resnet18": lambda o: (
            {k: (v["avg_bits"], v["edp"], v["norm_energy"])
             for k, v in o["hawq"].items()}, o["mixed"], o["closed_loop"],
            o["slo"], o["spent"])}
    for name in P10_EXAMPLES:
        mod = load_script(f"examples/{name}_torch.py")
        t0 = time.perf_counter()
        card = mod.main([])
        s_card = time.perf_counter() - t0
        cpu = mod.main(["--device", "cpu"])
        check(host[name](card) == host[name](cpu),
              f"(f) {name}: host numbers differ card vs CPU:\n"
              f"{host[name](card)}\n{host[name](cpu)}")
        if name == "quickstart":
            check(all(math.isfinite(x) for x in card["losses"])
                  and card["losses"][-1] < card["losses"][0],
                  f"(f) quickstart losses {card['losses']}")
        if name == "mixed_precision_resnet18":
            check(card["logits_finite"] and card["launches"] != {},
                  f"(f) {name}: launches {card['launches']}")
        print(f"(f) examples/{name}_torch.py on the card ({s_card:.3f} s) "
              f"and on the CPU: host numbers EQUAL {host[name](card)}")


def p10_path(b: Bench) -> dict:
    """Path 10: (a) the serving CLI at full width, (b) its other modes at
    SMOKE size card vs CPU, (c) the trace-replay CLI, (d) the emulator,
    (e) fluid_linear and row dispatch, (f) the three examples; then the
    kernel rows of (a)'s launches."""
    torch, tag = b.torch, b.tag
    full = p10_full(b)
    with tempfile.TemporaryDirectory(prefix="serve_ckpt_") as ckpt_dir:
        p10_smoke_modes(b, ckpt_dir)
    p10_traces()
    p10_emulator(b)
    p10_fluid_linear(b)
    p10_examples(b)

    # the kernel rows: (a)'s bit-plane launches at each (M, K, N, planes),
    # each shape held EQUAL to the plain version and timed; flash at the
    # --batch prefill's shape
    shapes: dict = {}
    paths = {p: 0 for p in full["cont"]["paths"]}
    for cnt in (full["cont"], full["batch"]):
        for k, c in cnt["shapes"].items():
            shapes[k] = shapes.get(k, 0) + c
        for k, c in cnt["paths"].items():
            paths[k] += c
    tot = [0.0] * 8
    for (M, K, N, n_pl), c in sorted(shapes.items()):
        b.hold_bitplane(b.rand_i8((M, K)), b.rand_i8((K, N)), n_pl)
        row = b.gemm_row(M, K, N, n_pl)
        tot = [x + c * r for x, r in zip(tot, list(row)
                                         + [max(row[3], row[4])])]
    kms, pms, lms, tb, to, dms, ldms, bms = tot
    fl = flash_row(b, full["flash_shape"], " (path 10 --batch prefill)")
    n_fl = full["batch"]["flash"]
    print(f"{tag} path 10 kernels: bit-plane {sum(shapes.values())} "
          f"launches at {len(shapes)} (M, K, N, planes) (by path {paths}), "
          f"kernel {kms:.3f} ms (device {dms:.3f}), bound {bms:.3f} ms, "
          f"plain {pms:.3f} ms, torch._int_mm {lms:.3f} ms; flash {n_fl} "
          f"launches at {full['flash_shape']}, {n_fl * fl['ms']:.3f} ms")
    torch.cuda.empty_cache()
    return {"bitplane": {"launches": sum(shapes.values()), "ms": kms,
                         "plain_ms": pms, "library_ms": lms, "t_bytes": tb,
                         "t_ops": to, "device_ms": dms,
                         "library_device_ms": ldms, "bound_ms": bms,
                         "paths": paths},
            "flash": flash_entry(n_fl, fl, n_fl), "e2e": full["e2e"]}


def p11_qwen(torch, dev, smoke: bool):
    """(cfg, serve params) of path 11's dense model: Qwen3-4B FULL (SMOKE
    for a CPU rehearsal), drawn and quantized layer by layer from seed 0
    (``lm.init_serve_params``: one layer's train form resident at a time,
    so two ranks drawing at once stay small)."""
    from repro_torch import configs
    from repro_torch.models import lm
    cfg = configs.get_smoke(LM_ARCH) if smoke else configs.get(LM_ARCH)
    check(smoke or (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.d_ff, cfg.vocab_size, cfg.head_dim) == LM_WIDTHS,
          f"{LM_ARCH} FULL is not the published width: {cfg}")
    gen = torch.Generator(device=dev).manual_seed(0)
    return cfg, lm.init_serve_params(cfg, gen, device=dev)


def p11_moe(torch, dev, smoke: bool):
    """(cfg, serve params) of path 11 (c): Moonshot-v1-16B-A3B at full
    width cut to its first P11_MOE_LAYERS layers (SMOKE for a CPU
    rehearsal), drawn and quantized layer by layer from seed 0."""
    from repro_torch import configs
    from repro_torch.models import lm
    cfg = (configs.get_smoke(MOE_ARCH) if smoke else
           configs.get(MOE_ARCH).with_(n_layers=P11_MOE_LAYERS))
    gen = torch.Generator(device=dev).manual_seed(0)
    return cfg, lm.init_serve_params(cfg, gen, device=dev)


def p11_sizes(smoke: bool) -> dict:
    """Path 11's request shapes (a CPU rehearsal shrinks them)."""
    if smoke:
        return {"gen": (2, 40, 3), "cont": (4, 16, 4), "moe": (2, 24, 3),
                "image": 32, "init_image": 32, "batch": 4}
    return {"gen": P11_GEN, "cont": P11_CONT, "moe": P11_MOE_GEN,
            "image": IMAGE, "init_image": 0, "batch": BATCH}


def p11_inputs(cfg, sizes: dict):
    """The seeded prompts: (a)'s generate batch and continuous requests."""
    import numpy as np
    rng = np.random.default_rng(11)
    B, S, _ = sizes["gen"]
    n, Sc, _ = sizes["cont"]
    gen = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    reqs = [rng.integers(0, cfg.vocab_size, (Sc,)).astype(np.int32)
            for _ in range(n)]
    return gen, reqs


def p11_serve_qwen(torch, dev, cfg, qparams, sizes, gen, reqs, mesh,
                   plan=None, batch=True) -> dict:
    """(a)'s traffic on one engine placement: ``generate`` at each of
    P11_BUDGETS (the prefill's last-position logits kept) and the
    continuous requests; tokens, logits and records."""
    from repro_torch.dist import sharding as shd
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine, default_controller
    n = lm.n_bit_slots(cfg)
    out = {}
    if batch:
        B, S, new = sizes["gen"]
        eng = ServeEngine(cfg, qparams, controller=default_controller(n),
                          max_len=S + new, device=dev, mesh=mesh)
        firsts = []
        orig = eng._sample_first

        def keep(logits, temp, topk, rows=None):
            firsts.append(logits[:, -1].float().cpu())
            return orig(logits, temp, topk, rows)

        eng._sample_first = keep
        out["gen"] = []
        for budget in P11_BUDGETS:
            eng.set_budget(budget)
            out["gen"].append(eng.generate({"tokens": gen},
                                           new).cpu().numpy())
        out["logits"] = [f.numpy() for f in firsts]
        del eng
    nreq, Sc, new = sizes["cont"]
    eng = ServeEngine(cfg, qparams, controller=default_controller(n),
                      max_len=Sc + new, n_slots=P11_SLOTS, prefill_len=Sc,
                      decode_block=P11_BLOCK, device=dev, mesh=mesh, plan=plan)
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=new,
                       budget_s=P11_CONT_BUDGETS[i % len(P11_CONT_BUDGETS)])
            for i, p in enumerate(reqs)]
    eng.run()
    out["cont_s"] = time.perf_counter() - t0
    recs = [eng.requests[r] for r in rids]
    out["cont"] = [list(r.tokens) for r in recs]
    out["replicas"] = [r.plan_replicas for r in recs]
    out["plan"] = None if eng.plan is None else eng.plan.summary()
    out["mean_replicas"] = None if eng.plan is None else eng.plan.mean_replicas
    out["sharded"] = mesh is not None and shd.is_sharded(eng.qparams)
    out["calls"] = dict(eng.calls)
    del eng
    return out


def p11_phase(torch, dev, mesh, fn, *args):
    """Run one phase of a rank: its result, wall, peak memory above what
    was resident, collectives by kind and bytes, and kernel launches."""
    from repro_torch.kernels import bitplane_matmul as bpm
    from repro_torch.kernels import flash_attention as fa
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    for m in mesh:
        m.reset_counts()
    reset_all_launches()
    t0 = time.perf_counter()
    res = fn(*args)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res["wall_s"] = wall
    res["peak_gib"] = ((torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
                       if cuda else 0.0)
    res["collectives"] = {}
    for m in mesh:
        for k, (c, nb) in m.counts.items():
            got = res["collectives"].setdefault(k, [0, 0])
            got[0] += c
            got[1] += nb
    res["shapes"] = bpm.launches_by_shape()
    res["paths"] = bpm.launches_by_path()
    res["flash"] = fa.launch_count()
    res["off_path"] = off_path_launches()[1:]
    return res


def p11_rank_moe(torch, dev, mesh, smoke: bool) -> dict:
    """(c) on one rank: Moonshot cut to P11_MOE_LAYERS layers on the
    (1, 2) mesh, ``generate`` at int8; each MoE layer's prefill input and
    output kept for the parent's statement of the EP semantics."""
    import numpy as np
    from repro_torch.models import lm, moe
    from repro_torch.serve.engine import ServeEngine, default_controller
    cfg, q = p11_moe(torch, dev, smoke)
    B, S, new = p11_sizes(smoke)["moe"]
    tokens = np.random.default_rng(12).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    eng = ServeEngine(cfg, q, controller=default_controller(
        lm.n_bit_slots(cfg)), max_len=S + new, device=dev, mesh=mesh)
    del q
    eng.set_budget(P11_MOE_BUDGET)
    layers = []
    orig = moe.apply_moe

    def kept(p, x, cfg_, wb, ab):
        y, aux = orig(p, x, cfg_, wb, ab)
        if x.shape[1] == S:                     # the prefill's layers
            layers.append((x.cpu(), y.cpu()))
        return y, aux

    moe.apply_moe = kept
    moe.ep_dropped[0] = 0
    try:
        toks = eng.generate({"tokens": tokens}, new).cpu().numpy()
    finally:
        moe.apply_moe = orig
    out = {"tokens": toks, "prompt": tokens, "layers": layers,
           "dropped": moe.ep_dropped[0], "local_experts": {
               k: tuple(v["q"].shape) for k, v in
               eng.qparams["layers"]["mlp"]["experts"].items()}}
    del eng
    return out


def p11_rank_cnn(torch, dev, mesh, smoke: bool) -> dict:
    """(d) on one rank: path 1's ResNet18 batch, no plan."""
    from repro_torch.core.policy import cnn_budget_controller
    from repro_torch.dist import sharding as shd
    from repro_torch.models import cnn
    from repro_torch.serve.cnn import CNNServeEngine
    sz = p11_sizes(smoke)
    params, layers = cnn.init_cnn("resnet18", torch.Generator().manual_seed(0),
                                  image=sz["init_image"], device=dev)
    ctrl = cnn_budget_controller("resnet18", layers=layers)
    images, budgets = cnn_inputs(torch, dev, ctrl, sz["batch"], sz["image"])
    eng = CNNServeEngine(params, layers, controller=ctrl,
                         max_batch=sz["batch"], device=dev, mesh=mesh)
    logits = eng.serve(images, budgets)[0]
    out = {"logits": logits, "rows": eng._rows,
           "sharded": shd.is_sharded(eng.qparams)}
    del eng, params
    return out


def p11_smoke(torch, dev, mesh21, mesh12) -> dict:
    """(e): qwen3_4b SMOKE with spec_k=4 and a prefix cache whose hits
    land on other ranks' slots (a fully replicated plan on (2, 1), and
    FSDP weights with no plan), and a config whose KV heads the model
    axis does not divide on (1, 2).  Meshes None: one device."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine, default_controller
    from repro_torch.serve.prefix_cache import PrefixCache
    out = {}
    for label, kv, mesh, plan, kw in (
            ("spec_auto", None, mesh21, "auto", {"spec_k": 4}),
            ("spec_fsdp", None, mesh21, None, {"spec_k": 4}),
            ("pc_auto", None, mesh21, "auto",
             {"prefix_cache": PrefixCache(chunk=P11_PC_CHUNK, capacity=8)}),
            ("kv1", 1, mesh12, None, {})):
        cfg = configs.get_smoke(LM_ARCH)
        if kv is not None:
            cfg = cfg.with_(n_kv_heads=kv)
        gen = torch.Generator(device=dev).manual_seed(3)
        q = lm.quantize_params(lm.init_params(cfg, gen, device=dev), cfg)
        eng = ServeEngine(cfg, q, controller=default_controller(
            lm.n_bit_slots(cfg)), max_len=48, n_slots=4, prefill_len=16,
            decode_block=4, device=dev, draft_budget_s=0.5,
            mesh=mesh, plan=plan if mesh is not None else None, **kw)
        rng = np.random.default_rng(5)
        base = [rng.integers(0, cfg.vocab_size, (12,)).astype(np.int32)
                for _ in range(2)]
        prompts = [base[0], base[1], base[0], np.concatenate([base[1][:8],
                   base[0][:6]]), base[0][:10], base[1]]
        rids = [eng.submit(p, max_new_tokens=6,
                           budget_s=(2.0, 0.5)[i % 2])
                for i, p in enumerate(prompts)]
        eng.run()
        recs = [eng.requests[r] for r in rids]
        out[label] = {"tokens": [list(r.tokens) for r in recs],
                      "hits": [r.cache_hit for r in recs],
                      "slots": [r.slot for r in recs],
                      "spec": [r.spec_rounds for r in recs],
                      "moved": (mesh.counts.get("move_row", [0])[0]
                                if mesh is not None else 0)}
        del eng
    return out


def p11_rank(rank: int, init_method: str, out_dir: str, device: str,
             smoke: bool) -> None:
    """One rank of path 11, in its own process on ``device``: the same
    world as a (1, 2) and a (2, 1) mesh; (a) and (b) Qwen3-4B, (c)
    Moonshot, (d) ResNet18 and (e) SMOKE; saves what the parent gates.
    Rank 0 then runs (e)'s single-device engines."""
    import datetime
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as tdist
    from repro_torch import dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.serve.engine import default_controller

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tdist.init_process_group(
        "gloo", init_method=init_method, rank=rank, world_size=P11_RANKS,
        timeout=datetime.timedelta(seconds=SO_TIMEOUT_S))
    out = {}
    try:
        m12, m21 = make_host_mesh(model=2), make_host_mesh(model=1)
        both = (m12, m21)
        t0 = time.perf_counter()
        cfg, qparams = p11_qwen(torch, dev, smoke)
        out["weights_s"] = time.perf_counter() - t0
        sizes = p11_sizes(smoke)
        gen, reqs = p11_inputs(cfg, sizes)
        out["a"] = p11_phase(torch, dev, both, p11_serve_qwen, torch, dev,
                             cfg, qparams, sizes, gen, reqs, m12)
        out["b_fsdp"] = p11_phase(torch, dev, both, p11_serve_qwen, torch,
                                  dev, cfg, qparams, sizes, gen, reqs, m21,
                                  None, False)
        partial = dist.plan_for_controller(
            default_controller(lm.n_bit_slots(cfg)), lm.layer_gemm_dims(cfg),
            head=lm.head_gemm_dims(cfg), **SO_PARTIAL)
        out["b_partial"] = p11_phase(torch, dev, both, p11_serve_qwen, torch,
                                     dev, cfg, qparams, sizes, gen, reqs,
                                     m21, partial, False)
        out["f"] = p11_phase(torch, dev, both, p14_seq_rank, torch, dev,
                             cfg, qparams, m21, smoke)
        del qparams
        out["c"] = p11_phase(torch, dev, both, p11_rank_moe, torch, dev, m12,
                             smoke)
        out["d21"] = p11_phase(torch, dev, both, p11_rank_cnn, torch, dev,
                               m21, smoke)
        out["d12"] = p11_phase(torch, dev, both, p11_rank_cnn, torch, dev,
                               m12, smoke)
        out["e"] = p11_phase(torch, dev, both, p11_smoke, torch, dev, m21,
                             m12)
        out["coords"] = (m12.tp_index, m21.dp_index)
    finally:
        tdist.destroy_process_group()
    if rank == 0:
        out["e_single"] = p11_smoke(torch, dev, None, None)
    torch.save(out, f"{out_dir}/rank{rank}.pt")


def p11_moe_gate(b: Bench, ranks, smoke: bool) -> dict:
    """(c)'s gates, on one card after the ranks: every MoE layer's output
    EQUALS ``moe.ep_reference`` (the reference's EP semantics in one
    process, tp = 2) on the layer's input; the dispatch buffers of that
    statement, concatenated over the ranks, EQUAL the single-device
    path's at C_shard = C; the mesh's tokens EQUAL a one-card generate
    whose MoE layers run the statement.  The single-device path's layer
    outputs and tokens are reported beside them."""
    torch, dev = b.torch, b.dev
    from repro_torch.models import common as cm
    from repro_torch.models import lm, moe
    from repro_torch.serve.engine import ServeEngine, default_controller
    cfg, q = p11_moe(torch, dev, smoke)
    c0 = ranks[0]["c"]
    B, S, new = p11_sizes(smoke)["moe"]
    ctrl = default_controller(lm.n_bit_slots(cfg))
    wv, av = (t.to(dev, torch.int32)
              for t in ctrl.resolve(torch.tensor(P11_MOE_BUDGET)))
    T = B * S
    check(moe.shard_capacity(T, cfg) == moe.capacity(T, cfg) or smoke,
          f"(c) C_shard {moe.shard_capacity(T, cfg)} != C "
          f"{moe.capacity(T, cfg)} at T = {T}")
    check(len(c0["layers"]) == cfg.n_layers,
          f"(c) {len(c0['layers'])} MoE layer inputs kept, want "
          f"{cfg.n_layers}")
    single_diff, dropped = [], 0
    with torch.no_grad():
        for i, (x, y) in enumerate(c0["layers"]):
            p = cm.stack_slice(q["layers"], i)["mlp"]
            x = x.to(dev)
            bufs: list = []
            before = moe.ep_dropped[0]
            want, _ = moe.ep_reference(p, x, cfg, wv[i], av[i], tp=P11_RANKS,
                                       buffers=bufs)
            dropped += moe.ep_dropped[0] - before
            got = y.to(dev)
            check(torch.equal(got, want),
                  f"(c) MoE layer {i}: the mesh's output != the EP "
                  f"statement's, max |diff| "
                  f"{(got.float() - want.float()).abs().max()}")
            for r, out in enumerate(ranks[1:], 1):
                check(torch.equal(out["c"]["layers"][i][1], y),
                      f"(c) MoE layer {i}: rank {r}'s output != rank 0's")
            # the single-device path on the same input; its buffer at C
            kept = []
            orig = moe._expert_ffn

            def grab(pe, xin, wb, ab):
                kept.append(xin)
                return orig(pe, xin, wb, ab)

            moe._expert_ffn = grab
            try:
                one, _ = moe.apply_moe(p, x, cfg, wv[i], av[i])
            finally:
                moe._expert_ffn = orig
            if moe.shard_capacity(T, cfg) == moe.capacity(T, cfg):
                check(torch.equal(torch.cat(bufs), kept[0]),
                      f"(c) MoE layer {i}: the ranks' dispatch buffers "
                      f"!= the single-device buffer at C_shard = C (the "
                      f"local-slot re-indexing)")
            single_diff.append(float((one.float() - want.float()).abs().max()))
    check(dropped == sum(out["c"]["dropped"] for out in ranks),
          f"(c) dropped choices: the statement's {dropped} != the ranks' "
          f"{[out['c']['dropped'] for out in ranks]}")
    # tokens: a one-card generate with the statement in every MoE layer
    eng = ServeEngine(cfg, q, controller=default_controller(
        lm.n_bit_slots(cfg)), max_len=S + new, device=dev)
    eng.set_budget(P11_MOE_BUDGET)
    orig = moe.apply_moe
    moe.apply_moe = lambda p, x, cfg_, wb, ab: moe.ep_reference(
        p, x, cfg_, wb, ab, tp=P11_RANKS)
    try:
        ep_toks = eng.generate({"tokens": c0["prompt"]}, new).cpu().numpy()
    finally:
        moe.apply_moe = orig
    one_toks = eng.generate({"tokens": c0["prompt"]}, new).cpu().numpy()
    import numpy as np
    for r, out in enumerate(ranks):
        check(np.array_equal(out["c"]["tokens"], ep_toks),
              f"(c) rank {r}: tokens {out['c']['tokens'].tolist()} != the "
              f"one-card EP statement's {ep_toks.tolist()}")
    del eng, q
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    return {"dropped": dropped, "single_diff": single_diff,
            "single_tokens_equal": bool(np.array_equal(one_toks, ep_toks))}


def p11_path(b: Bench, cnn_ref=None, smoke: bool = False) -> dict:
    """Path 11: sharded serving on P11_RANKS gloo ranks sharing the card
    (module docstring); returns the kernel rows of (a) and (c)."""
    torch, dev, tag = b.torch, b.dev, b.tag
    import tempfile
    import numpy as np
    import torch.multiprocessing as tmp
    from repro_torch.core.policy import cnn_budget_controller
    from repro_torch.kernels import bitplane_matmul as bpm
    from repro_torch.models import cnn
    from repro_torch.serve.cnn import CNNServeEngine

    t_path = time.perf_counter()
    sizes = p11_sizes(smoke)
    # ---- what the ranks must equal, on one device: (a)'s streams, and
    # path 1's logits
    cfg, qparams = p11_qwen(torch, dev, smoke)
    gen, reqs = p11_inputs(cfg, sizes)
    t0 = time.perf_counter()
    want = p11_serve_qwen(torch, dev, cfg, qparams, sizes, gen, reqs, None)
    single_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    seq_want = p14_seq_single(torch, dev, cfg, qparams, smoke)
    seq_single_s = time.perf_counter() - t0
    del qparams
    if cnn_ref is not None and not smoke:
        want_logits = cnn_ref["logits"]
    else:
        params, layers = cnn.init_cnn(
            "resnet18", torch.Generator().manual_seed(0),
            image=sizes["init_image"], device=dev)
        ctrl = cnn_budget_controller("resnet18", layers=layers)
        images, budgets = cnn_inputs(torch, dev, ctrl, sizes["batch"],
                                     sizes["image"])
        want_logits = CNNServeEngine(params, layers, controller=ctrl,
                                     max_batch=sizes["batch"],
                                     device=dev).serve(images, budgets)[0]
        del params
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    print(f"path 11 single-device streams: {cfg.name} generate "
          f"{sizes['gen']} at budgets {P11_BUDGETS} and {len(reqs)} "
          f"continuous requests in {single_s:.3f} s; the parent's weights "
          f"freed before the ranks")

    # ---- the ranks; beside them, the lowering report's prediction of
    # (f)'s collectives on a RecordingMesh (host only)
    from repro_torch.launch import dryrun
    Bq, Sq, newq = p14_sizes(smoke)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        ctx = tmp.start_processes(p11_rank, args=(
            f"tcp://127.0.0.1:{free_port()}", d, str(dev), smoke),
            nprocs=P11_RANKS, join=False, start_method="spawn")
        t1 = time.perf_counter()
        seq_pred = dryrun.predict_counts(cfg, (P11_RANKS, 1), batch=Bq,
                                         prompt=Sq, steps=newq - 1,
                                         max_len=Sq + newq, reuse=True)
        pred_s = time.perf_counter() - t1
        while not ctx.join():
            pass
        ranks = [torch.load(f"{d}/rank{r}.pt", weights_only=False)
                 for r in range(P11_RANKS)]
    ranks_s = time.perf_counter() - t0
    cuda = dev.type == "cuda"

    # ---- (a) tensor parallelism, no plan
    for r, out in enumerate(ranks):
        a = out["a"]
        check(out["coords"] == (r, r), f"rank {r}: mesh coords "
              f"{out['coords']}")
        for i, budget in enumerate(P11_BUDGETS):
            check(np.array_equal(a["gen"][i], want["gen"][i]),
                  f"(a) rank {r}, generate at {budget}: tokens "
                  f"{a['gen'][i].tolist()} != one device's "
                  f"{want['gen'][i].tolist()}")
            check(np.array_equal(a["logits"][i], want["logits"][i]),
                  f"(a) rank {r}, generate at {budget}: last-position "
                  f"logits != one device's, max |diff| "
                  f"{np.abs(a['logits'][i] - want['logits'][i]).max()}")
        check(a["cont"] == want["cont"], f"(a) rank {r}: continuous tokens "
              f"{a['cont']} != one device's {want['cont']}")
        check(not cuda or (a["flash"] == cfg.n_layers * len(P11_BUDGETS)
                           and sum(a["shapes"].values()) > 0
                           and a["off_path"] == (0, 0)),
              f"(a) rank {r}: flash {a['flash']} launches (want "
              f"{cfg.n_layers} a generate call on the local heads), "
              f"bit-plane {sum(a['shapes'].values())}, int4/quant "
              f"{a['off_path']}")
        check(a["collectives"].get("acc_tp", [0])[0] > 0
              and "gather_weight" not in a["collectives"],
              f"(a) rank {r}: collectives {a['collectives']}")
    B, S, new = sizes["gen"]
    print(f"(a) {cfg.name} on (data, model) = (1, {P11_RANKS}), no plan: "
          f"generate B = {B} x {S} tokens (flash on "
          f"{cfg.n_heads // P11_RANKS} local q heads and "
          f"{cfg.n_kv_heads // P11_RANKS} KV heads a rank) at budgets "
          f"{P11_BUDGETS}, {new} new: tokens and last-position logits EQUAL "
          f"one device's; {len(reqs)} continuous requests "
          f"({sizes['cont'][1]}-token prompts, {sizes['cont'][2]} new, "
          f"{P11_SLOTS} slots, budgets {P11_CONT_BUDGETS}): tokens EQUAL; "
          f"launches a rank: flash {ranks[0]['a']['flash']}, bit-plane "
          f"{sum(ranks[0]['a']['shapes'].values())} (by path "
          f"{ranks[0]['a']['paths']})")

    # ---- (b) data parallelism: FSDP weights, and a partial plan
    for key, label in (("b_fsdp", "no plan (FSDP)"),
                       ("b_partial", f"partial plan {SO_PARTIAL}")):
        for r, out in enumerate(ranks):
            x = out[key]
            check(x["cont"] == want["cont"], f"(b) {label}, rank {r}: tokens "
                  f"{x['cont']} != one device's {want['cont']}")
            check(x["sharded"], f"(b) {label}, rank {r}: no weight sharded")
            rep = 0.0 if x["mean_replicas"] is None else x["mean_replicas"]
            check(x["replicas"] == [rep] * len(reqs),
                  f"(b) {label}, rank {r}: records' replicas "
                  f"{x['replicas']} != the plan's {rep}")
        print(f"(b) {cfg.name} on (data, model) = ({P11_RANKS}, 1), {label}: "
              f"plan {ranks[0][key]['plan']}; {len(reqs)} continuous "
              f"requests, tokens EQUAL one device's; records carry "
              f"replicas {ranks[0][key]['replicas'][0]}; collectives a rank "
              f"{ranks[0][key]['collectives']}")

    # ---- (c) expert parallelism
    moe_gate = p11_moe_gate(b, ranks, smoke)
    c0 = ranks[0]["c"]
    print(f"(c) {MOE_ARCH} ({len(c0['layers'])} layers at full width) on "
          f"(1, {P11_RANKS}): local expert stacks {c0['local_experts']}; "
          f"generate {sizes['moe']} at int8: every MoE layer's output EQUALS "
          f"the one-process EP statement's on its input, the ranks' "
          f"dispatch buffers EQUAL the single-device buffer (C_shard = C), "
          f"tokens EQUAL a one-card run of the statement; dropped choices "
          f"{moe_gate['dropped']}; the single-device path's layer outputs "
          f"apart from EP by max |diff| {moe_gate['single_diff']} (the "
          f"ranks' f32 sums add in another order), its tokens equal "
          f"{moe_gate['single_tokens_equal']}")

    # ---- (d) ResNet18 on both meshes
    for key, mesh_s in (("d21", f"({P11_RANKS}, 1) no plan"),
                        ("d12", f"(1, {P11_RANKS})")):
        for r, out in enumerate(ranks):
            check(np.array_equal(out[key]["logits"], want_logits),
                  f"(d) ResNet18 on {mesh_s}, rank {r}: logits != path 1's, "
                  f"max |diff| {np.abs(out[key]['logits'] - want_logits).max()}")
            check(out[key]["sharded"], f"(d) {mesh_s}: no weight sharded")
        print(f"(d) ResNet18@{sizes['image']} B = {sizes['batch']} on "
              f"{mesh_s}: logits EQUAL path 1's; rows "
              f"{[out[key]['rows'] for out in ranks]}; collectives a rank "
              f"{ranks[0][key]['collectives']}")

    # ---- (e) SMOKE: speculation, the prefix cache, KV heads not dividing
    single = ranks[0]["e_single"]
    for r, out in enumerate(ranks):
        e = out["e"]
        for label in single:
            check(e[label]["tokens"] == single[label]["tokens"]
                  and e[label]["hits"] == single[label]["hits"]
                  and e[label]["spec"] == single[label]["spec"],
                  f"(e) {label}, rank {r}: tokens {e[label]['tokens']} != "
                  f"one device's {single[label]['tokens']}")
    e0 = ranks[0]["e"]
    check(max(e0["spec_auto"]["spec"]) > 0 and max(e0["spec_fsdp"]["spec"]) > 0
          and {"full", "partial"} <= set(e0["pc_auto"]["hits"])
          and e0["pc_auto"]["moved"] > 0,
          f"(e) speculation rounds {e0['spec_auto']['spec']}, prefix hits "
          f"{e0['pc_auto']['hits']}, rows moved {e0['pc_auto']['moved']}")
    print(f"(e) {LM_ARCH} SMOKE, card against one device: spec_k=4 on "
          f"({P11_RANKS}, 1) (a replicated plan and FSDP; rounds "
          f"{e0['spec_auto']['spec']}), PrefixCache(chunk={P11_PC_CHUNK}) "
          f"hits {e0['pc_auto']['hits']} on slots {e0['pc_auto']['slots']} "
          f"({e0['pc_auto']['moved']} row broadcasts across ranks), and "
          f"n_kv_heads=1 on (1, {P11_RANKS}): tokens EQUAL")

    # ---- (f) B=1 on (2, 1): the sequence-sharded KV cache
    check(seq_want["stepwise"] == seq_want["tokens"][0].tolist(),
          f"(f) one device: generate {seq_want['tokens'][0].tolist()} != "
          f"its calls step by step {seq_want['stepwise']}")
    n_cmp = []
    for r, out in enumerate(ranks):
        f = out["f"]
        n_slot = (Sq + newq) // P11_RANKS
        check(f["cache_shapes"]["k"][2] == n_slot
              and f["cache_shapes"]["kpos"][2] == Sq + newq,
              f"(f) rank {r}: cache shapes {f['cache_shapes']} are not the "
              f"sequence-sharded layout ({n_slot} of {Sq + newq} slots)")
        check(f["digests"] == seq_want["blocks"][r],
              f"(f) rank {r}: the cache after prefill is not one device's "
              f"blocks: "
              f"{[k for k in f['digests'] if f['digests'][k] != seq_want['blocks'][r][k]]}")
        n_cmp.append(tokens_agree(f"(f) rank {r}", f["tokens"][0].tolist(),
                                  seq_want["tokens"][0].tolist(),
                                  seq_want["gaps"]))
        check(f["counts"] == seq_pred, f"(f) rank {r}: collectives "
              f"{f['counts']} != the report's prediction {seq_pred}")
    print(f"(f) {cfg.name} B={Bq} on ({P11_RANKS}, 1), FSDP weights: "
          f"generate of a {Sq}-token prompt, {newq} new: the cache's "
          f"sequence over the data axis ({(Sq + newq) // P11_RANKS} of "
          f"{Sq + newq} slots a rank), EQUAL to one device's blocks after "
          f"prefill (SHA-256 of k, v and kpos); tokens "
          f"{ranks[0]['f']['tokens'][0].tolist()} against one device's "
          f"{seq_want['tokens'][0].tolist()} (compared, exact: {n_cmp}; "
          f"top-2 gaps {[round(g, 5) for g in seq_want['gaps']]}); "
          f"collectives a rank EQUAL the report's RecordingMesh "
          f"prediction {seq_pred} (predicted on the host beside the "
          f"ranks in {pred_s:.3f} s; one device's side "
          f"{seq_single_s:.3f} s)")

    # ---- the kernel at (a)'s and (c)'s shapes: held EQUAL, timed
    shapes: dict = {}
    paths = {p: 0 for p in bpm.PATHS}
    for key in ("a", "c"):
        for k, n in ranks[0][key]["shapes"].items():
            shapes[k] = shapes.get(k, 0) + n
        for k, n in ranks[0][key]["paths"].items():
            paths[k] += n
    check(not cuda or sum(shapes.values()) > 0,
          "path 11 launched no bit-plane kernel")
    bp = held_rows(b, shapes, paths, cuda)
    fl_shape = (B * cfg.n_heads // P11_RANKS, S, cfg.head_dim)
    n_fl = ranks[0]["a"]["flash"]
    fl = (flash_row(b, fl_shape, " (path 11 (a), one rank's heads)")
          if cuda else {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
                        "library_ms": 0.0, "t_ops": 0.0, "t_bytes": 0.0,
                        "bound_ms": 0.0})
    # (f)'s shapes: whole weights (FSDP gathers them), B=1 rows
    f_out = ranks[0]["f"]
    f_bp = held_rows(b, f_out["shapes"], f_out["paths"], cuda)
    f_fl_shape = (Bq * cfg.n_heads, Sq, cfg.head_dim)
    n_fl_f = f_out["flash"]
    f_fl_err = (hold_flash(b, *f_fl_shape[:2], Sq, cfg.head_dim, True, 0)
                if cuda else 0.0)
    f_fl = (flash_row(b, f_fl_shape, " (path 11 (f), B=1 on (2, 1))")
            if cuda else fl)
    for key in ("a", "b_fsdp", "b_partial", "f", "c", "d21", "d12", "e"):
        print(f"{tag} path 11 ({key}) a rank: wall " + ", ".join(
            f"{out[key]['wall_s']:.3f} s" for out in ranks)
            + "; peak above resident " + ", ".join(
                f"{out[key]['peak_gib']:.3f} GiB" for out in ranks)
            + f"; collectives (calls, bytes) "
            f"{ {k: tuple(v) for k, v in ranks[0][key]['collectives'].items()} }")
    wall = time.perf_counter() - t_path
    print(f"{tag} path 11 kernels (rank 0's (a) and (c)): bit-plane "
          f"{bp['launches']} launches at {len(shapes)} (M, K, N, planes) "
          f"(by path {paths}), kernel {bp['ms']:.3f} ms (device "
          f"{bp['device_ms']:.3f}), bound {bp['bound_ms']:.3f} ms, plain "
          f"{bp['plain_ms']:.3f} ms, torch._int_mm {bp['library_ms']:.3f} "
          f"ms; flash {n_fl} launches at {fl_shape}, "
          f"{n_fl * fl['ms']:.3f} ms")
    print(f"{tag} path 11 kernels (rank 0's (f)): bit-plane "
          f"{f_bp['launches']} launches at {len(f_out['shapes'])} (M, K, "
          f"N, planes) (by path {f_out['paths']}), EQUAL to the plain "
          f"version, "
          f"kernel {f_bp['ms']:.3f} ms (device {f_bp['device_ms']:.3f}), "
          f"bound {f_bp['bound_ms']:.3f} ms, plain {f_bp['plain_ms']:.3f} "
          f"ms, torch._int_mm {f_bp['library_ms']:.3f} ms; flash {n_fl_f} "
          f"launches at {f_fl_shape} (max |err| {f_fl_err:.6g} against the "
          f"f32 oracle), {n_fl_f * f_fl['ms']:.3f} ms")
    print(f"{tag} path 11 wall {wall:.3f} s (the ranks {ranks_s:.3f} s; "
          f"weights drawn a rank in " + ", ".join(
              f"{out['weights_s']:.3f} s" for out in ranks) + ")")
    return {"bitplane": bp, "flash": flash_entry(n_fl, fl, n_fl),
            "bitplane_f": f_bp, "flash_f": flash_entry(n_fl_f, f_fl, n_fl_f),
            "e2e": {"wall_s": wall, "ranks_s": ranks_s}}


def p12_cfg(which: str, smoke: bool):
    """Path 12's configs: (a) Qwen3-4B FULL, all layers; (b) the same
    widths cut to P12_FSDP_LAYERS layers; (e) Moonshot-v1-16B-A3B at full
    width cut to P12_MOE_LAYERS.  SMOKE for a CPU rehearsal."""
    from repro_torch import configs
    arch = MOE_ARCH if which == "e" else LM_ARCH
    if smoke:
        return configs.get_smoke(arch)
    cfg = configs.get(arch)
    if which == "a":
        check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
               cfg.d_ff, cfg.vocab_size, cfg.head_dim) == LM_WIDTHS
              and cfg.remat == "full", f"{LM_ARCH} FULL: {cfg}")
        return cfg
    return cfg.with_(n_layers=P12_FSDP_LAYERS if which == "b"
                     else P12_MOE_LAYERS)


def p12_tcfg(n_accum: int):
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import TrainConfig
    return TrainConfig(optimizer=AdamWConfig(lr=TRAIN_LR, m_dtype="int8",
                                             v_mode="factored"),
                       n_accum=n_accum, wbits=TRAIN_WBITS, abits=TRAIN_ABITS)


def p12_sizes(smoke: bool) -> dict:
    """(rows, tokens a row) of the train batches and the serve prompts."""
    if smoke:
        return {"batch": (4, 32), "moe": (2, 16), "serve": (2, 12, 3)}
    return {"batch": (P12_B, P12_S), "moe": (P12_MOE_B, P12_MOE_S),
            "serve": P12_SERVE}


def p12_batch(torch, dev, cfg, which: str, smoke: bool):
    from repro_torch.data.pipeline import make_batch
    B, S = p12_sizes(smoke)["moe" if which == "e" else "batch"]
    return tree_to(make_batch(0, 0, B, S + 1, cfg.vocab_size, cfg), dev)


def p12_one_device(torch, dev, which: str, smoke: bool) -> dict:
    """(a) or (b)'s P12_STEPS steps on one device from the ranks' weights
    (seed 0 on the same device): metrics, walls and the trained
    parameters on the host (page-locked)."""
    from repro_torch.models import lm
    from repro_torch.optim.adamw import adamw_init, tree_map
    from repro_torch.train.loop import make_train_step
    cfg = p12_cfg(which, smoke)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    tcfg = p12_tcfg(P12_ACCUM)
    opt = adamw_init(params, tcfg.optimizer)
    step, _ = make_train_step(tcfg, cfg, device=dev)
    batch = p12_batch(torch, dev, cfg, which, smoke)
    mets, walls, upd = [], [], 0.0
    for _ in range(P12_STEPS):
        sync(torch, dev)
        t0 = time.perf_counter()
        new, opt, m = step(params, opt, batch)
        sync(torch, dev)
        walls.append(time.perf_counter() - t0)
        mets.append({k: float(v) for k, v in m.items()})
        upd = max(upd, p12_largest_update(new, params))
        params = new
    pin = dev.type == "cuda"
    host = tree_map(lambda t: t.to("cpu").pin_memory() if pin
                    else t.to("cpu"), params)
    del params, new, opt
    return {"metrics": mets, "walls": walls, "params": host,
            "update": upd}


def p12_largest_update(new, old) -> float:
    """The largest |change| of one element over a step's parameters."""
    from repro_torch.optim.adamw import tree_leaves
    return max(float((a.float() - b.float()).abs().max())
               for a, b in zip(tree_leaves(new), tree_leaves(old)))


def p12_gap(torch, got, want) -> tuple:
    """(the largest |got - want| beyond one bf16 step of the larger
    value, the mean |got - want|) over every element of two parameter
    trees."""
    from repro_torch.optim.adamw import tree_leaves
    worst = tot = n = 0.0
    for a, w in zip(tree_leaves(got), tree_leaves(want)):
        a, w = a.float(), w.to(a.device).float()
        err = (a - w).abs()
        top = torch.maximum(a.abs(), w.abs())
        one = (torch.nextafter(top, torch.tensor(
            float("inf"), device=top.device)) - top) * 2.0 ** 16
        worst = max(worst, float((err - one).clamp_min(0).max()))
        tot += float(err.sum())
        n += err.numel()
    return worst, tot / n


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def p12_whole_meta(torch, tree):
    """Meta tensors of every leaf's whole shape (a placed dict's layout
    gives it): the target a resharding restore fills."""
    from repro_torch.dist import sharding as shd
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = p12_whole_meta(torch, v)
            continue
        shape = (tree.layout[k][0] if isinstance(tree, shd.Local)
                 and k in tree.layout else tuple(v.shape))
        out[k] = torch.empty(shape, dtype=v.dtype, device="meta")
    return out


def p12_equal_blocks(torch, whole, placed, mesh) -> int:
    """Every leaf of ``placed`` EQUALS this rank's block of the same leaf
    of ``whole`` (by the placed dict's layout); returns the leaves."""
    from repro_torch.dist import sharding as shd
    n = 0
    for k, v in placed.items():
        if isinstance(v, dict):
            n += p12_equal_blocks(torch, whole[k], v, mesh)
            continue
        want = whole[k]
        if isinstance(placed, shd.Local) and k in placed.layout:
            want = shd.block(mesh, want, placed.layout[k][1])
        check(want.dtype == v.dtype and torch.equal(want, v),
              f"(c) leaf {k}: this rank's block != the restored leaf's")
        n += 1
    return n


def p12_train(torch, dev, mesh, which: str, smoke: bool, holder: dict,
              out_dir: str) -> dict:
    """(a), (b) or (e) on one rank: the weights drawn whole from seed 0
    and placed on ``mesh``, P12_STEPS steps through ``make_train_step``
    on this rank's rows; metrics, walls and the last step's collectives.
    (a) keeps its trained state for (c); (b) writes its parameters for
    the parent's gate; (e) keeps each step's starting state and result
    gathered whole (rank 0 runs them again on one device)."""
    from repro_torch.dist import sharding as shd
    from repro_torch.models import lm, moe
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.checkpoint import save_checkpoint
    from repro_torch.train.loop import make_train_step
    cfg = p12_cfg(which, smoke)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    p_shd = shd.param_shardings(params, mesh)
    params = shd.shard_params(params, mesh)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    tcfg = p12_tcfg(1 if which == "e" else P12_ACCUM)
    opt = adamw_init(params, tcfg.optimizer)
    step, _ = make_train_step(tcfg, cfg, device=dev, param_shardings=p_shd)
    batch = shd.shard_batch(p12_batch(torch, dev, cfg, which, smoke), mesh)
    mets, walls, states, dropped = [], [], [], []
    counts = {}
    # (e): rank 0 keeps each step's starting state and result whole (the
    # first step starts from the weights it draws again; a later one
    # from the last step's result and optimizer state, gathered)
    keep = which == "e"
    for i in range(P12_STEPS):
        if keep:
            start = None if i == 0 else (
                states[-1].get("params"), shd.full(opt))
            states.append({"start": start} if mesh.rank == 0 else {})
        before = {k: list(v) for k, v in mesh.counts.items()}
        d0 = moe.ep_dropped[0]
        sync(torch, dev)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        sync(torch, dev)
        walls.append(time.perf_counter() - t0)
        dropped.append(moe.ep_dropped[0] - d0)
        mets.append({k: float(v) for k, v in m.items()})
        counts = {k: [v[0] - before.get(k, [0, 0])[0],
                      v[1] - before.get(k, [0, 0])[1]]
                  for k, v in mesh.counts.items()}
        if keep:
            whole = shd.full(params)
            if mesh.rank == 0:
                states[-1]["params"] = whole
            del whole
    out = {"metrics": mets, "walls": walls, "step_counts": counts,
           "dropped": dropped}
    if which == "a":
        holder["a"] = (params, opt)
    elif which == "b":
        save_checkpoint(f"{out_dir}/ckpt_b", P12_STEPS, {"params": params})
    else:
        holder["e"] = states
    return out


def p12_depth_cut(tree, n: int, L: int, under: bool = False):
    """``tree`` with every leaf under a ``layers`` key that stacks ``L``
    layers cut to its first ``n`` (placed dicts keep their class, their
    layouts' whole shapes cut alike)."""
    from repro_torch.dist import sharding as shd
    items = {}
    layout = dict(tree.layout) if isinstance(tree, shd.Local) else None
    for k, v in tree.items():
        inside = under or k == "layers"
        if isinstance(v, dict):
            items[k] = p12_depth_cut(v, n, L, inside)
            continue
        if inside and v.ndim and v.shape[0] == L:
            v = v[:n].clone()
            if layout is not None and k in layout:
                shape, spec = layout[k]
                if len(shape) == v.ndim:
                    layout[k] = ((n,) + tuple(shape[1:]), spec)
        items[k] = v
    if layout is not None:
        return shd.Local(items, tree.mesh, layout)
    return type(tree)(items) if type(tree) is not dict else items


def p12_ckpt(torch, dev, m12, m21, holder: dict, out_dir: str,
             name: str = "ckpt_a", layers=None) -> dict:
    """(c): save (a)'s trained state from (1, 2) under ``out_dir/name``
    (cut to its first ``layers`` layers when given); restore it onto one
    device (each rank's (1, 2) block of every leaf EQUAL to the trained
    one) and onto (2, 1) (each block EQUAL to the whole leaf's)."""
    import os
    from repro_torch.dist import sharding as shd
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.checkpoint import (restore_checkpoint,
                                              save_checkpoint)
    state = dict(zip(("params", "opt"), holder.pop("a")))
    if layers is not None:
        L = tree_leaves(state["params"]["layers"])[0].shape[0]
        state = p12_depth_cut(state, min(layers, L), L)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    d = f"{out_dir}/{name}"
    t0 = time.perf_counter()
    save_checkpoint(d, P12_STEPS, state)
    save_s = time.perf_counter() - t0
    target = p12_whole_meta(torch, state)
    t0 = time.perf_counter()
    whole, step = restore_checkpoint(d, target, device=dev)
    one_s = time.perf_counter() - t0
    check(step == P12_STEPS, f"(c) restored step {step}")
    n12 = p12_equal_blocks(torch, whole, state, m12)
    del state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    specs = {"params": shd.param_shardings(target["params"], m21),
             "opt": shd.opt_shardings(target["opt"], m21)}
    t0 = time.perf_counter()
    r21, _ = restore_checkpoint(d, target, specs, mesh=m21, device=dev)
    r21_s = time.perf_counter() - t0
    n21 = p12_equal_blocks(torch, whole, r21, m21)
    del r21
    holder["whole"] = whole["params"]
    del whole
    size = os.path.getsize(f"{d}/step_{P12_STEPS:08d}/arrays.npz")
    return {"leaves": (n12, n21), "save_s": save_s, "one_s": one_s,
            "r21_s": r21_s, "bytes": size}


def p12_serve(torch, dev, mesh, holder: dict, smoke: bool) -> dict:
    """(d): the restored weights quantized and served on ``mesh`` (one
    device for ``mesh=None``) through ``generate``; tokens and the
    prefill's last-position logits."""
    import numpy as np
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine, default_controller
    cfg = p12_cfg("a", smoke)
    cfg = cfg.with_(n_layers=min(P12_CKPT_LAYERS, cfg.n_layers))
    if "q" not in holder:
        holder["q"] = lm.quantize_params(holder.pop("whole"), cfg)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    B, S, new = p12_sizes(smoke)["serve"]
    prompts = np.random.default_rng(12).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    eng = ServeEngine(cfg, holder["q"], controller=default_controller(
        lm.n_bit_slots(cfg)), max_len=S + new, device=dev, mesh=mesh)
    eng.set_budget(SERVE_BUDGETS)
    firsts = []
    orig = eng._sample_first

    def keep(logits, temp, topk, rows=None):
        firsts.append(logits[:, -1].float().cpu())
        return orig(logits, temp, topk, rows)

    eng._sample_first = keep
    toks = eng.generate({"tokens": prompts}, new).cpu().numpy()
    del eng
    return {"tokens": toks, "logits": firsts[0].numpy()}


def p12_moe_one(torch, dev, states: list, smoke: bool) -> dict:
    """(e)'s gate material on one device (rank 0, after the group): each
    step again from the mesh's starting state with ``moe.apply_moe``
    replaced by ``moe.ep_reference(tp=P12_RANKS)``; per step the metrics,
    the choices dropped, and the new parameters' gap to the mesh's: the
    largest beyond one bf16 step of the value in units of the step's
    largest update U, and the mean in units of lr."""
    from repro_torch.models import lm, moe
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.loop import make_train_step
    cfg = p12_cfg("e", smoke)
    step, _ = make_train_step(p12_tcfg(1), cfg, device=dev)
    batch = p12_batch(torch, dev, cfg, "e", smoke)
    apply = moe.apply_moe
    moe.apply_moe = lambda p, x, c, wb=8, ab=8: moe.ep_reference(
        p, x, c, wb, ab, tp=P12_RANKS)
    out = []
    try:
        for st in states:
            if st["start"] is None:             # the first step: seed 0
                p0 = lm.init_params(cfg, torch.Generator(
                    device=dev).manual_seed(0), device=dev)
                st["start"] = (p0, adamw_init(p0, p12_tcfg(1).optimizer))
            d0 = moe.ep_dropped[0]
            new, _, m = step(*st["start"], batch)
            upd = p12_largest_update(new, st["start"][0])
            worst, mean = p12_gap(torch, st["params"], new)
            out.append({"metrics": {k: float(v) for k, v in m.items()},
                        "dropped": moe.ep_dropped[0] - d0,
                        "worst_u": worst / upd, "update": upd,
                        "mean_lr": mean / TRAIN_LR})
            del new
    finally:
        moe.apply_moe = apply
    return out


def p12_smoke(torch, dev, mesh) -> dict:
    """(f): one SMOKE mesh step (n_accum 2) of the dense, vlm and MoE
    families on the card and on the CPU, on the same mesh, from the same
    weights and rows; each side's metrics and gathered parameters."""
    from repro_torch import configs
    from repro_torch.data.pipeline import make_batch
    from repro_torch.dist import sharding as shd
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, tree_leaves
    from repro_torch.train.loop import TrainConfig, make_train_step
    out = {}
    for fam, arch in (("dense", LM_ARCH), ("vlm", VLM_ARCH),
                      ("moe", MOE_ARCH)):
        cfg = configs.get_smoke(arch)
        params = lm.init_params(cfg, torch.Generator().manual_seed(11),
                                device="cpu")
        batch = make_batch(1, 0, TRAIN_SMOKE_B, TRAIN_SMOKE_S,
                           cfg.vocab_size, cfg)
        tcfg = TrainConfig(optimizer=AdamWConfig(lr=TRAIN_SMOKE_LR),
                           n_accum=2, wbits=TRAIN_WBITS, abits=TRAIN_ABITS)
        res = []
        for where in (dev, torch.device("cpu")):
            p = shd.shard_params(tree_to(params, where), mesh)
            step, _ = make_train_step(tcfg, cfg, device=where)
            new, _, m = step(p, adamw_init(p, tcfg.optimizer),
                             shd.shard_batch(tree_to(batch, where), mesh))
            res.append(([t.cpu() for t in tree_leaves(shd.full(new))],
                        {k: float(v) for k, v in m.items()}))
        out[fam] = res
    return out


def p12_warm(torch, dev, mesh, smoke: bool) -> float:
    """One tensor-parallel microbatch (forward and backward) of (a)'s
    widths cut to one layer, on ``mesh``; its wall."""
    from repro_torch.dist import api as dist
    from repro_torch.dist import sharding as shd
    from repro_torch.models import lm
    from repro_torch.optim.adamw import tree_leaves, tree_unflatten
    t0 = time.perf_counter()
    cfg = p12_cfg("a", smoke).with_(n_layers=1)
    params = shd.shard_params(lm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(1), device=dev), mesh)
    live = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    batch = shd.shard_batch(p12_batch(torch, dev, cfg, "a", smoke), mesh)
    batch = {k: v[:v.shape[0] // P12_ACCUM] for k, v in batch.items()}
    bits = torch.tensor([8], dtype=torch.int32, device=dev)
    with dist.use_mesh(mesh):
        total, _ = lm.train_loss(tree_unflatten(params, live), batch, cfg,
                                 bits, bits)
        torch.autograd.grad(total, live, allow_unused=True)
    del params, live, total
    sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return time.perf_counter() - t0


def p12_rank(rank: int, init_method: str, out_dir: str, device: str,
             smoke: bool) -> None:
    """One rank of path 12, in its own process on ``device``: the same
    world as a (1, 2) and a (2, 1) mesh; (f) while the parent trains on
    one device, then (a)-(e) once it has freed the card, then on rank 0
    (d)'s and (e)'s one-device runs.  Saves what the parent gates."""
    import datetime
    import os
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as tdist
    from repro_torch.launch.mesh import make_host_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tdist.init_process_group(
        "gloo", init_method=init_method, rank=rank, world_size=P12_RANKS,
        timeout=datetime.timedelta(seconds=SO_TIMEOUT_S))
    out, holder = {}, {}
    try:
        m12, m21 = make_host_mesh(model=2), make_host_mesh(model=1)
        both = (m12, m21)
        # beside the parent's one-device steps, in little memory: (f),
        # then one microbatch of (a)'s widths on one layer, which loads
        # the train step's kernels and sizes this process's buffers
        out["f"] = p11_phase(torch, dev, both, p12_smoke, torch, dev, m12)
        out["warm_s"] = p12_warm(torch, dev, m12, smoke)
        while not os.path.exists(f"{out_dir}/card_free"):
            time.sleep(0.1)
        out["a"] = p11_phase(torch, dev, both, p12_train, torch, dev, m12,
                             "a", smoke, holder, out_dir)
        out["b"] = p11_phase(torch, dev, both, p12_train, torch, dev, m21,
                             "b", smoke, holder, out_dir)
        out["c"] = p11_phase(torch, dev, both, p12_ckpt, torch, dev, m12,
                             m21, holder, out_dir, "ckpt_a",
                             P12_CKPT_LAYERS)
        out["d"] = p11_phase(torch, dev, both, p12_serve, torch, dev, m12,
                             holder, smoke)
        out["e"] = p11_phase(torch, dev, both, p12_train, torch, dev, m12,
                             "e", smoke, holder, out_dir)
    finally:
        tdist.destroy_process_group()
    if rank == 0:
        out["d_single"] = p12_serve(torch, dev, None, holder, smoke)
        out["e_single"] = p12_moe_one(torch, dev, holder.pop("e"), smoke)
    torch.save(out, f"{out_dir}/rank{rank}.pt")


def p12_params_gate(torch, dev, label: str, ckpt_dir: str, one: dict,
                    steps: int = P12_STEPS, layers=None) -> tuple:
    """The parameters a mesh trained (the checkpoint its ranks wrote, cut
    to its first ``layers`` layers when given) against one device's:
    every element within P12_FLIPS x ``steps`` x U
    beyond one bf16 step of the value, U the largest change one device's
    step made to any element (each step's update may round to the other
    sign where a gradient sits within its rounding of 0), and the mean
    |gap| within P12_PARAM_MEAN lr.  Returns (worst / U, mean / lr)."""
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.train.checkpoint import restore_checkpoint
    want = one["params"]
    if layers is not None:
        L = tree_leaves(want["layers"])[0].shape[0]
        want = p12_depth_cut(want, min(layers, L), L)
    meta = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), want)
    got, _ = restore_checkpoint(ckpt_dir, {"params": meta}, device=dev)
    worst, mean = p12_gap(torch, got["params"], want)
    del got
    worst, mean = worst / one["update"], mean / TRAIN_LR
    check(worst <= P12_FLIPS * steps and mean <= P12_PARAM_MEAN,
          f"{label}: the mesh's parameters after {steps} steps sit "
          f"{worst:.3g} U beyond a bf16 step from one device's (bound "
          f"{P12_FLIPS * steps}; U = {one['update']!r}), mean {mean:.3g} lr "
          f"(bound {P12_PARAM_MEAN})")
    return worst, mean


def p12_metrics_gate(label: str, got: list, want: list) -> list:
    """Each step's loss and z-loss within P12_LOSS_TOL and grad norm
    within P12_NORM_TOL (relative) of the reference's; the gaps."""
    gaps = []
    for s, (g, w) in enumerate(zip(got, want)):
        gap = {k: abs(g[k] - w[k]) / abs(w[k])
               for k in ("loss", "zloss", "grad_norm")}
        check(all(math.isfinite(g[k]) for k in gap)
              and gap["loss"] <= P12_LOSS_TOL
              and gap["zloss"] <= P12_LOSS_TOL
              and gap["grad_norm"] <= P12_NORM_TOL,
              f"{label} step {s}: {g} against {w}")
        gaps.append(gap)
    return gaps


def p12_launcher(dev) -> dict:
    """(f)'s launcher, run beside the rest of the path (a thread that
    drives two subprocesses): ``python -m repro_torch.launch.train --smoke
    --tp 2`` on ``dev`` (two spawned gloo ranks), killed with its process
    group once it has checkpointed step 4, then resumed from the
    checkpoint on two ranks of a (2, 1) mesh.  Returns ``(join, stop)``:
    ``join()`` returns what it saw (a problem is in its "error"),
    ``stop()`` kills what still runs."""
    import json
    import os
    import signal
    import threading
    from repro_torch.train.checkpoint import latest_step
    res: dict = {}
    d = tempfile.mkdtemp(prefix="p12_launch_")
    ckpt = f"{d}/ckpt"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            LM_ARCH, "--smoke", "--device", dev.type, "--batch", "4",
            "--seq", "32", "--ckpt-dir", ckpt, "--log-every", "1"]

    procs = []

    def start(args):
        procs.append(subprocess.Popen(
            base + args, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env, cwd=str(ROOT), start_new_session=True))
        return procs[-1]

    def drive():
        t0 = time.perf_counter()
        run = start(["--steps", "100000", "--tp", "2", "--ckpt-every", "2"])
        try:
            while (latest_step(ckpt) or 0) < 4:
                if run.poll() is not None or time.perf_counter() - t0 > 300:
                    res["error"] = ("the launcher ended or did not "
                                    "checkpoint within 300 s")
                    return
                time.sleep(0.1)
        finally:
            os.killpg(run.pid, signal.SIGKILL)
            first, err = run.communicate()
        res["killed_at"] = killed_at = latest_step(ckpt)
        res["killed_s"] = time.perf_counter() - t0
        again = start(["--steps", "2", "--tp", "1", "--ranks", "2"])
        out, err = again.communicate(timeout=300)
        res["wall_s"] = time.perf_counter() - t0
        lines = out.splitlines()
        try:
            last = json.loads(lines[-1])
        except (IndexError, ValueError):
            res["error"] = f"resume failed: {err[-2000:]}"
            return
        res["resumed"] = last
        if not ("[train] mesh {'data': 1, 'model': 2}" in first
                and f"[train] resumed from step {killed_at}" in lines
                and last["start"] == killed_at
                and last["mesh"] == {"data": 2, "model": 1}
                and math.isfinite(last["final_loss"])
                and latest_step(ckpt) == killed_at + 2):
            res["error"] = (f"killed at step {killed_at} ({first[-500:]} "
                            f"{err[-500:]}); resumed {lines[-4:]}")

    thread = threading.Thread(target=drive, daemon=True)
    thread.start()

    def join() -> dict:
        thread.join()
        import shutil
        shutil.rmtree(d, ignore_errors=True)
        return res

    def stop() -> None:
        """End whatever is still running (the path failed)."""
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)

    return join, stop


def p12_path(b: Bench, smoke: bool = False) -> dict:
    """Path 12: sharded training on P12_RANKS gloo ranks sharing the card
    (module docstring); returns the bit-plane row of (d)."""
    torch, dev, tag = b.torch, b.dev, b.tag
    import shutil
    import numpy as np
    import torch.multiprocessing as tmp
    from repro_torch.kernels import bitplane_matmul as bpm
    cuda = dev.type == "cuda"
    t_path = time.perf_counter()
    launcher, stop = p12_launcher(dev)      # (f)'s, beside the rest
    d = tempfile.mkdtemp(prefix="p12_")
    # the ranks start now: they import, join the group and run (f) while
    # this process trains on one device, and wait for the card after it
    ranks_ctx = tmp.start_processes(p12_rank, args=(
        f"tcp://127.0.0.1:{free_port()}", d, str(dev), smoke),
        nprocs=P12_RANKS, join=False, start_method="spawn")
    try:
        return p12_gates(b, smoke, t_path, launcher, d, ranks_ctx)
    finally:        # a failed gate leaves nothing running
        stop()
        for p in ranks_ctx.processes:
            if p.is_alive():
                p.terminate()
        shutil.rmtree(d, ignore_errors=True)


def p12_gates(b: Bench, smoke: bool, t_path: float, launcher, d: str,
              ranks_ctx) -> dict:
    """The body of :func:`p12_path`: one device's steps, then the ranks'
    results gated, printed and timed."""
    torch, dev, tag = b.torch, b.dev, b.tag
    import numpy as np
    from repro_torch.kernels import bitplane_matmul as bpm
    cuda = dev.type == "cuda"

    # ---- one device first: (a)'s and (b)'s steps, then the card freed
    one = {}
    for which in ("a", "b"):
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        one[which] = p12_one_device(torch, dev, which, smoke)
        one[which]["peak_gib"] = (torch.cuda.max_memory_allocated(dev)
                                  / 2 ** 30 if cuda else 0.0)
        if cuda:
            torch.cuda.empty_cache()
    single_s = time.perf_counter() - t_path
    print(f"path 12 one device: (a) {p12_cfg('a', smoke).name} "
          f"{p12_cfg('a', smoke).n_layers} layers and (b) its first "
          f"{p12_cfg('b', smoke).n_layers}, {P12_STEPS} steps each of "
          f"{p12_sizes(smoke)['batch']} tokens in {P12_ACCUM} microbatches: "
          f"losses {[round(m['loss'], 4) for m in one['a']['metrics']]} and "
          f"{[round(m['loss'], 4) for m in one['b']['metrics']]}, step walls "
          f"{[round(w, 3) for w in one['a']['walls']]} s and "
          f"{[round(w, 3) for w in one['b']['walls']]} s, peak "
          f"{one['a']['peak_gib']:.3f} / {one['b']['peak_gib']:.3f} GiB; "
          f"{single_s:.3f} s, the card freed before the ranks")

    # ---- the ranks
    t0 = time.perf_counter()
    open(f"{d}/card_free", "w").close()
    while not ranks_ctx.join():
        pass
    ranks = [torch.load(f"{d}/rank{r}.pt", weights_only=False)
             for r in range(P12_RANKS)]
    ranks_s = time.perf_counter() - t0
    # ---- (a), (b): every rank's metrics against one device's, and the
    # trained parameters (the checkpoints the ranks wrote)
    gaps = {}
    for which, label in (("a", "(a) (1, 2)"), ("b", "(b) (2, 1)")):
        for r, out in enumerate(ranks):
            check(out[which]["metrics"] == ranks[0][which]["metrics"],
                  f"{label}: rank {r}'s metrics != rank 0's")
        gaps[which] = p12_metrics_gate(label, ranks[0][which]["metrics"],
                                       one[which]["metrics"])
        gaps[which + "_params"] = p12_params_gate(
            torch, dev, label, f"{d}/ckpt_{which}", one[which],
            layers=P12_CKPT_LAYERS if which == "a" else None)
        del one[which]["params"]
    for which, key, mesh in (("a", "sum_tp", "(1, 2)"),
                             ("b", "grad_rs", "(2, 1)")):
        x = ranks[0][which]
        check(key in x["step_counts"] and x["off_path"] == (0, 0)
              and sum(x["shapes"].values()) == 0 and x["flash"] == 0,
              f"({which}) collectives {x['step_counts']}, kernels "
              f"{x['shapes']} / flash {x['flash']} / {x['off_path']}")
        cfg = p12_cfg(which, smoke)
        print(f"({which}) {cfg.name} {cfg.n_layers} layers on (data, model) "
              f"= {mesh}: loss per step "
              f"{[round(m['loss'], 6) for m in x['metrics']]} against one "
              f"device's {[round(m['loss'], 6) for m in one[which]['metrics']]}"
              f" (gaps {[{k: float(f'{v:.3g}') for k, v in g.items()} for g in gaps[which]]}"
              f"), parameters within {gaps[which + '_params'][0]:.3g} U "
              f"beyond a bf16 step (U = {one[which]['update']!r}, the "
              f"largest change of a one-device step; mean "
              f"{gaps[which + '_params'][1]:.3g} lr); step walls a rank "
              + ", ".join(str([round(w, 3) for w in out[which]["walls"]])
                          for out in ranks)
              + f" s against one device's "
              f"{[round(w, 3) for w in one[which]['walls']]} s; phase wall "
              + ", ".join(f"{out[which]['wall_s']:.3f} s" for out in ranks)
              + "; peak above resident " + ", ".join(
                  f"{out[which]['peak_gib']:.3f} GiB" for out in ranks)
              + f" (one device {one[which]['peak_gib']:.3f} GiB); "
              f"collectives a step a rank (calls, bytes) "
              f"{ {k: tuple(v) for k, v in x['step_counts'].items()} }")

    # ---- (c) the checkpoint across meshes
    for r, out in enumerate(ranks):
        c = out["c"]
        check(c["leaves"][0] > 0 and c["leaves"][0] == c["leaves"][1],
              f"(c) rank {r}: leaves {c['leaves']}")
    c = ranks[0]["c"]
    print(f"(c) (a)'s state cut to its first "
          f"{min(P12_CKPT_LAYERS, p12_cfg('a', smoke).n_layers)} layers "
          f"({c['bytes'] / 2 ** 30:.3f} GiB, "
          f"{c['leaves'][0]} leaves) saved from (1, 2) in "
          f"{c['save_s']:.3f} s, restored onto one device in "
          f"{c['one_s']:.3f} s and onto (2, 1) in {c['r21_s']:.3f} s: every "
          f"leaf EQUAL on both ranks")

    # ---- (d) the restored weights served on (1, 2)
    want = ranks[0]["d_single"]
    for r, out in enumerate(ranks):
        x = out["d"]
        check(np.array_equal(x["tokens"], want["tokens"])
              and np.array_equal(x["logits"], want["logits"]),
              f"(d) rank {r}: tokens {x['tokens'].tolist()} against one "
              f"device's {want['tokens'].tolist()}, last-position logits "
              f"max |diff| {np.abs(x['logits'] - want['logits']).max()}")
    dx = ranks[0]["d"]
    shapes, paths = dx["shapes"], dx["paths"]
    want_paths = {p: 0 for p in bpm.PATHS}
    for (M, K, N, _), n_ in shapes.items():
        want_paths[bpm.plan(M, K, N).path] += n_
    check(not cuda or (sum(shapes.values()) > 0 and paths == want_paths
                       and dx["flash"] == 0 and dx["off_path"] == (0, 0)),
          f"(d) bit-plane launches {shapes} by path {paths} (plan() gives "
          f"{want_paths}), flash {dx['flash']}, int4/quant {dx['off_path']}")
    B, S, new = p12_sizes(smoke)["serve"]
    print(f"(d) the restored weights ({P12_CKPT_LAYERS} layers) quantized "
          f"and served on (1, 2): "
          f"generate {B} x {S} tokens, {new} new, budgets {SERVE_BUDGETS}: "
          f"tokens and last-position logits EQUAL one device's; bit-plane "
          f"launches a rank {sum(shapes.values())} at {len(shapes)} shard "
          f"shapes (by path {paths}); collectives (calls, bytes) "
          f"{ {k: tuple(v) for k, v in dx['collectives'].items()} }")

    # ---- (e) expert-parallel training
    ecfg = p12_cfg("e", smoke)
    for s, ref in enumerate(ranks[0]["e_single"]):
        for r, out in enumerate(ranks):
            check(out["e"]["metrics"][s] == ranks[0]["e"]["metrics"][s],
                  f"(e) rank {r}'s step {s} metrics != rank 0's")
        got = ranks[0]["e"]["metrics"][s]
        drops = sum(out["e"]["dropped"][s] for out in ranks)
        B, S = p12_sizes(smoke)["moe"]
        choices = B * S * ecfg.experts_per_token * ecfg.n_layers
        check(abs(drops - ref["dropped"]) <= P12_DROP_TOL * choices,
              f"(e) step {s}: the ranks dropped {drops} choices, the "
              f"one-device statement {ref['dropped']} (of {choices})")
        p12_metrics_gate(f"(e) step {s}", [got], [ref["metrics"]])
        check(abs(got["moe_aux"] - ref["metrics"]["moe_aux"])
              <= P12_LOSS_TOL * abs(ref["metrics"]["moe_aux"])
              and ref["worst_u"] <= P12_FLIPS
              and ref["mean_lr"] <= P12_PARAM_MEAN,
              f"(e) step {s}: aux {got['moe_aux']} against "
              f"{ref['metrics']['moe_aux']}, parameters {ref['worst_u']:.3g}"
              f" U beyond a bf16 step (U = {ref['update']!r}; mean "
              f"{ref['mean_lr']:.3g} lr)")
    ex = ranks[0]["e"]
    check("moe_combine" in ex["step_counts"] and "grad_rs" not in
          ex["step_counts"], f"(e) collectives {ex['step_counts']}")
    print(f"(e) {ecfg.name} {ecfg.n_layers} layers expert-parallel on (1, 2) "
          f"({ecfg.n_experts // P12_RANKS} experts a rank), "
          f"{p12_sizes(smoke)['moe']} tokens a step: each step against "
          f"moe.ep_reference's train form on one device from the same "
          f"state: loss " + ", ".join(
              f"{m['loss']:.6f} / {r_['metrics']['loss']:.6f}"
              for m, r_ in zip(ex["metrics"], ranks[0]["e_single"]))
          + ", parameters within " + ", ".join(
              f"{r_['worst_u']:.3g} U (mean {r_['mean_lr']:.3g} lr)"
              for r_ in ranks[0]["e_single"])
          + f", choices dropped {[r_['dropped'] for r_ in ranks[0]['e_single']]}"
          f"; step walls {[round(w, 3) for w in ex['walls']]} s, peak "
          f"{ex['peak_gib']:.3f} GiB; collectives a step (calls, bytes) "
          f"{ {k: tuple(v) for k, v in ex['step_counts'].items()} }")

    # ---- (f) SMOKE card vs CPU on the mesh, then the launcher
    for fam in ("dense", "vlm", "moe"):
        (card, cm_), (cpu, pm) = ranks[0]["f"][fam]
        loss_err = abs(cm_["loss"] - pm["loss"]) / pm["loss"]
        norm_err = abs(cm_["grad_norm"] - pm["grad_norm"]) / pm["grad_norm"]
        worst, n_diff, n_all = 0.0, 0, 0
        for a, w in zip(card, cpu):
            a, w = a.float(), w.float()
            dd = (a - w).abs()
            top = torch.maximum(a.abs(), w.abs())
            one_ = (torch.nextafter(top, torch.tensor(float("inf"))) - top) \
                * 2.0 ** 16
            worst = max(worst, float((dd / (2 * TRAIN_SMOKE_LR + one_)).max()))
            n_diff += int((dd > 0).sum())
            n_all += dd.numel()
        check(loss_err <= TRAIN_LOSS_TOL and norm_err <= TRAIN_NORM_TOL
              and worst <= 1.0 and n_diff <= TRAIN_STEP_SHARE * n_all,
              f"(f) SMOKE {fam} mesh step, card vs CPU: loss {cm_['loss']} "
              f"vs {pm['loss']}, grad norm {cm_['grad_norm']} vs "
              f"{pm['grad_norm']}, worst {worst:.3g}, {n_diff} of {n_all}")
        print(f"(f) SMOKE {fam} step on (1, 2), card vs CPU: loss rel "
              f"{loss_err:.3g}, grad norm rel {norm_err:.3g}, {n_diff} of "
              f"{n_all} parameter elements differ (worst {worst:.3g} of 2 lr"
              f" + one bf16 step)")
    la = launcher()
    check("error" not in la, f"(f) repro_torch.launch.train: "
          f"{la.get('error')}")
    print(f"(f) repro_torch.launch.train --smoke --tp 2 on the "
          f"{dev.type}, beside the path: killed {la['killed_s']:.3f} s in, "
          f"at its step-{la['killed_at']} checkpoint, resumed on two ranks "
          f"of (2, 1) to loss {la['resumed']['final_loss']:.4f}; "
          f"{la['wall_s']:.3f} s in all")

    # ---- (d)'s shard shapes held and timed
    tot = [0.0] * 8
    for (M, K, N, n_pl), c_ in sorted(shapes.items()):
        if cuda:
            b.hold_bitplane(b.rand_i8((M, K)), b.rand_i8((K, N)), n_pl)
        row = b.gemm_row(M, K, N, n_pl)
        tot = [x + c_ * r_ for x, r_ in zip(tot, list(row)
                                            + [max(row[3], row[4])])]
    kms, pms, lms, tb, to, dms, ldms, bms = tot
    wall = time.perf_counter() - t_path
    print(f"{tag} path 12 kernels (rank 0's (d)): bit-plane "
          f"{sum(shapes.values())} launches at {len(shapes)} (M, K, N, "
          f"planes), each held EQUAL to the plain version: kernel "
          f"{kms:.3f} ms (device {dms:.3f}), bound {bms:.3f} ms, plain "
          f"{pms:.3f} ms, torch._int_mm {lms:.3f} ms; no flash launch "
          f"(training stays at or below FLASH_THRESHOLD, the prompts at "
          f"{S} tokens)")
    print(f"{tag} path 12 wall {wall:.3f} s (one device {single_s:.3f} s, "
          f"the ranks after it {ranks_s:.3f} s: " + ", ".join(
              f"({k}) {ranks[0][k]['wall_s']:.3f} s" for k in "abcde")
          + f"; beside the one-device steps the ranks' (f) "
          f"{ranks[0]['f']['wall_s']:.3f} s and one-layer warm-up "
          f"{ranks[0]['warm_s']:.3f} s, and the launcher "
          f"{la['wall_s']:.3f} s)")
    return {"bitplane": {"launches": sum(shapes.values()), "ms": kms,
                         "plain_ms": pms, "library_ms": lms, "t_bytes": tb,
                         "t_ops": to, "device_ms": dms,
                         "library_device_ms": ldms, "bound_ms": bms,
                         "paths": paths},
            "e2e": {"wall_s": wall, "ranks_s": ranks_s,
                    "step_s": ranks[0]["a"]["walls"][-1]}}


# ---------------------------------------------------------------------------
# Path 13: the analysis suite on the card
# ---------------------------------------------------------------------------

def p13_specs(rep) -> list:
    """The distinct sets of kernel specialisations a report's calls
    launched, printable."""
    return [sorted(map(str, s)) for s in rep.spec_sets()]


def p13_gate(label, rep, kernels) -> None:
    """One signature across every variant, no host sync or error, and
    each of ``kernels`` among the kernel specialisations it launched (the
    signature hashes the launch set: one signature is one set)."""
    check(rep.ok and len(rep.signatures) == 1
          and all(any(k[0] == name for k in rep.spec_sets()[0])
                  for name in kernels),
          f"(b/c) {label}: signatures by group "
          f"{ {g: len(v) for g, v in rep.groups.items()} }, errors "
          f"{rep.errors}, syncs {rep.syncs}, specialisation sets "
          f"{p13_specs(rep)} (want one holding {kernels})")


def p13_syncs(torch, fn) -> list:
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("warn")``; each
    sync the card reports, as (the innermost frame of the port, whether
    it ran inside one of the engine's program bodies).  Other warnings
    are shown as usual."""
    import traceback
    import warnings
    from repro_torch.analysis import registry

    events = []
    show = warnings.showwarning

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            show(message, category, filename, lineno, file, line)
            return
        port = [f for f in traceback.extract_stack()
                if "/src/repro_torch/" in f.filename
                and "/analysis/" not in f.filename]
        where = (port[-1].filename.split("/src/", 1)[1] + f":"
                 f"{port[-1].lineno}") if port else "?"
        inside = any(f.name in registry.PROGRAM_BODIES
                     and f.filename.endswith("serve/engine.py")
                     for f in port)
        events.append((where, inside))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return events


def p13_analysis(dev) -> dict:
    """(a)'s ``python -m repro_torch.launch.analyze --all --device ...``
    started in a subprocess on ``dev``: a whole run starts it after the
    build, so its host work runs beside paths 1-4, and :func:`p13_path`
    waits for it; it is killed if the script ends first."""
    import atexit
    import os
    d = tempfile.mkdtemp(prefix="analysis_")
    log = open(f"{d}/stdout.txt", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.analyze", "--all",
         "--device", dev.type, "--json", f"{d}/analysis.json"],
        stdout=log, stderr=subprocess.STDOUT, text=True, cwd=str(ROOT),
        env=dict(os.environ, PYTHONPATH=str(SRC)))
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return {"proc": proc, "dir": d, "log": log, "t0": time.perf_counter()}


def p13_path(b: Bench, cfg, qparams, known=None, analysis=None) -> dict:
    """Path 13: (a) the analysis CLI on the card (``analysis``, a
    :func:`p13_analysis` started earlier, or started now), (b) Qwen3-4B
    FULL's entrypoints across budgets, (c) ResNet18@224 across the
    HAWQ-V3 configurations, (d) the syncs the card sees in a tick and a
    speculative round; then (b)'s and (c)'s kernel rows."""
    import collections
    import numpy as np
    torch, dev, tag = b.torch, b.dev, b.tag
    from repro_torch.analysis import lint, retrace
    from repro_torch.kernels import bitplane_matmul as bpm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import ServeEngine, default_controller

    t_path = time.perf_counter()
    # ---- (a) python -m repro_torch.launch.analyze --all --device cuda
    import shutil
    t0 = time.perf_counter()
    analysis = analysis or p13_analysis(dev)
    rc = analysis["proc"].wait()
    analysis["log"].close()
    wait_s = time.perf_counter() - t0
    a_s = time.perf_counter() - analysis["t0"]
    out = Path(analysis["dir"]) / "analysis.json"
    check(out.exists(), f"(a) the analysis suite wrote no report (exit "
          f"{rc}): {(Path(analysis['dir']) / 'stdout.txt').read_text()[-3000:]}")
    payload = json.loads(out.read_text())
    shutil.rmtree(analysis["dir"], ignore_errors=True)
    check(rc == 0 and payload["ok"] and payload["device"] == dev.type,
          f"(a) the analysis suite on the card: exit {rc}, fresh "
          f"{ {n: p['fresh'] for n, p in payload['passes'].items()} }, "
          f"stale baseline {payload['stale_baseline']}")
    for name, res in payload["passes"].items():
        print(f"(a) [{name}] ok, {res['suppressed']} baselined: "
              + "; ".join(res["notes"]))
    print(f"{tag} (a) repro_torch.launch.analyze --all --device cuda: "
          f"PASS in {a_s:.3f} s ({wait_s:.3f} s of it waited for here)")

    # ---- (b) Qwen3-4B FULL: generate across budgets, path 4's engine
    # shape's prefill row and decode block across budgets and mixes
    n = lm.n_bit_slots(cfg)
    B, S, new = P13_GEN
    check(S > tf.FLASH_THRESHOLD, "(b) the prompts must reach flash")
    reset_all_launches()
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, qparams, max_len=S + new,
                      controller=default_controller(n), device=dev)
    tokens = torch.randint(1, cfg.vocab_size, (B, S), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(13))
    outs = {}

    def gen(budget):
        eng.set_budget(budget)
        outs[budget] = eng.generate({"tokens": tokens}, new)
        return outs[budget]

    eng.set_budget(LM_BUDGETS[0])
    eng._bits()                          # fills the controller's table
    gen_rep = retrace.audit_entrypoint(
        LM_ARCH, "generate",
        [(f"budget={bud}", lambda bud=bud: (bud,)) for bud in LM_BUDGETS],
        gen)
    check(all(tuple(o.shape) == (B, new) and bool(((o >= 0)
              & (o < cfg.vocab_size)).all()) for o in outs.values()),
          f"(b) generate: shapes {[tuple(o.shape) for o in outs.values()]}")
    p13_gate("generate", gen_rep, ("bitplane_matmul", "flash_attention"))
    del eng
    cb = ServeEngine(cfg, qparams, max_len=CB_PREFILL + 64,
                     controller=default_controller(n), n_slots=CB_SLOTS,
                     prefill_len=CB_PREFILL, decode_block=P13_BLOCK,
                     spec_k=CB_SPEC_K, draft_budget_s=CB_DRAFT_BUDGET,
                     device=dev)
    cb_reps = retrace.audit_engine(
        LM_ARCH, cb, budgets=LM_BUDGETS, mixes=P13_MIXES,
        only=("prefill_row", "decode_scan"))
    for rep in cb_reps:
        p13_gate(rep.entrypoint, rep, ("bitplane_matmul",))
    b_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    b_shapes = bpm.launches_by_shape()
    b_paths = bpm.launches_by_path()
    b_flash = fa.launch_count()
    b_flash_specs = dict(fa.spec_launches)
    check(sum(b_shapes.values()) > 0
          and b_flash == cfg.n_layers * len(LM_BUDGETS),
          f"(b) launches: bit-plane {sum(b_shapes.values())}, flash "
          f"{b_flash} (want {cfg.n_layers} a generate call)")
    for rep in [gen_rep] + cb_reps:
        (sig, labels), = [(s_, l_) for s_, l_ in rep.signatures.items()]
        print(f"(b) {LM_ARCH} FULL {rep.entrypoint}: {len(labels)} "
              f"variants ({', '.join(labels)}), one signature {sig}, "
              f"{len(rep.spec_sets()[0])} kernel specialisations: "
              f"{', '.join(p13_specs(rep)[0])}")

    # ---- (c) ResNet18@224 across the HAWQ-V3 configurations
    reset_all_launches()
    t0 = time.perf_counter()
    image, batch = P13_CNN
    cnn_rep = retrace.audit_cnn(dev, image=image, batch=batch)
    torch.cuda.synchronize()
    c_s = time.perf_counter() - t0
    p13_gate("ResNet18 cnn_forward", cnn_rep, ("bitplane_matmul",))
    c_shapes = bpm.launches_by_shape()
    c_paths = bpm.launches_by_path()
    check(sum(c_shapes.values()) > 0 and fa.launch_count() == 0,
          f"(c) launches: bit-plane {sum(c_shapes.values())}, flash "
          f"{fa.launch_count()}")
    (sig, labels), = list(cnn_rep.signatures.items())
    print(f"(c) ResNet18@{image} B={batch}: {len(labels)} HAWQ-V3 "
          f"configurations ({', '.join(labels)}), one signature {sig}, "
          f"{len(cnn_rep.spec_sets()[0])} kernel specialisations, "
          f"{sum(c_shapes.values())} bit-plane launches")

    # ---- (d) the syncs the card sees: a tick, then a speculative round
    t0 = time.perf_counter()
    gen_h = np.random.default_rng(13)

    def prompt(L):
        return gen_h.integers(1, cfg.vocab_size, size=L).astype(np.int32)

    for L in P13_SYNC_PROMPTS[:2]:
        cb.submit(prompt(L), max_new_tokens=P13_SYNC_NEW, budget_s=0.8,
                  draft_k=0)
    cb.calls = dict.fromkeys(cb.calls, 0)
    tick = p13_syncs(torch, cb.step)
    check(cb.calls["decode"] == P13_BLOCK and cb.calls["verify"] == 0,
          f"(d) the first step is not one vanilla tick: {cb.calls}")
    cb.submit(prompt(P13_SYNC_PROMPTS[2]), max_new_tokens=P13_SYNC_NEW,
              budget_s=10.0, draft_k=CB_SPEC_K)
    spec = p13_syncs(torch, cb.step)
    check(cb.calls["verify"] == 1,
          f"(d) the second step is not one speculative round: {cb.calls}")
    d_s = time.perf_counter() - t0
    # what the static passes report: the lint's raw findings (fresh or
    # baselined) and the host syncs (RT502) (b)'s and (c)'s recordings saw
    reported = {f"{f.file.split('src/', 1)[1]}:{f.line}"
                for f in lint.run_lint()}
    for rep in [gen_rep, cnn_rep] + cb_reps:
        for frames in rep.syncs.values():
            reported |= {w.split("src/", 1)[-1] for w in frames}
    missed = []
    for label, events in (("tick", tick), ("speculative round", spec)):
        by = collections.Counter(w for w, _ in events)
        inside = [w for w, i in events if i]
        print(f"(d) {label}: {len(events)} syncs the card reports, "
              f"{len(inside)} inside a program body; by place: "
              + ", ".join(f"{w} x{c}" for w, c in sorted(by.items())))
        missed += [w for w in inside if w not in reported]
    check(not missed, f"(d) syncs inside a program body that neither the "
                      f"lint nor RT502 reports: {sorted(set(missed))}")
    del cb
    torch.cuda.empty_cache()

    # ---- kernel rows: (b)'s and (c)'s launches
    rows = {}
    for name, shapes, paths in (("b", b_shapes, b_paths),
                                ("c", c_shapes, c_paths)):
        per_shape = shape_rows(b, shapes, known or {})
        tot = [sum(c * per_shape[k][j] for k, c in shapes.items())
               for j in range(7)]
        k_ms, p_ms, l_ms, t_bytes, t_ops, d_ms, ld_ms = tot
        rows[name] = {"launches": sum(shapes.values()), "ms": k_ms,
                      "plain_ms": p_ms, "library_ms": l_ms,
                      "t_bytes": t_bytes, "t_ops": t_ops,
                      "device_ms": d_ms, "library_device_ms": ld_ms,
                      "bound_ms": sum(c * max(per_shape[k][3],
                                              per_shape[k][4])
                                      for k, c in shapes.items()),
                      "paths": paths}
    fl = flash_row(b, (B * cfg.n_heads, S, cfg.head_dim),
                   " (path 13 (b) generate prefill)")
    wall = time.perf_counter() - t_path
    print(f"{tag} path 13: (a) {a_s:.3f} s, (b) {b_s:.3f} s "
          f"({len(LM_BUDGETS)} generate calls of {B} x {S}, "
          f"{sum(len(v) for r in cb_reps for v in r.signatures.values())} "
          f"prefill rows and decode blocks), (c) {c_s:.3f} s, (d) "
          f"{d_s:.3f} s; bit-plane launches (b) {rows['b']['launches']} "
          f"(by path {b_paths}), (c) {rows['c']['launches']} (by path "
          f"{c_paths}); flash (b) {b_flash} at {sorted(b_flash_specs)}; "
          f"path 13 wall {wall:.3f} s")
    return {"bitplane_b": rows["b"], "bitplane_c": rows["c"],
            "flash": flash_entry(b_flash, fl, b_flash),
            "e2e": {"wall_s": wall, "analyze_s": a_s,
                    "syncs": (len(tick), len(spec))}}


def digest(t) -> str:
    """SHA-256 of a tensor's bytes (on the host)."""
    import hashlib
    import torch
    raw = t.detach().cpu().contiguous().view(-1).view(torch.uint8)
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()


def p14_path(b: Bench, cfg, qparams) -> dict:
    """Path 14 (a): the lowering report's prediction for ``lm.prefill``
    of P14_A and one ``lm.decode_step`` on one card (fake CUDA tensors,
    ``dryrun.one_device_calls``), then the same two calls on path 3's
    weights, gated (module docstring, phase 17)."""
    torch, dev, tag = b.torch, b.dev, b.tag
    from repro_torch import kernels
    from repro_torch.launch import dryrun, opcost
    from repro_torch.models import lm

    t_path = time.perf_counter()
    B, S = P14_A
    t0 = time.perf_counter()
    pred = dryrun.one_device_calls(cfg, B, S, max_len=S + 1, device="cuda")
    pred_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(14)
    n = lm.n_bit_slots(cfg)
    bits = torch.full((n,), 8, dtype=torch.int32, device=dev)
    base = torch.cuda.memory_allocated()
    cache = lm.empty_cache(cfg, B, S + 1, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev, dtype=torch.int32)
    tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                        device=dev, dtype=torch.int32)
    torch.cuda.synchronize()
    args = opcost.tree_bytes(qparams, cache, tokens)
    check(args == pred["args"], f"(a) argument bytes on the card {args} "
          f"!= the report's {pred['args']}")
    print(f"{tag} (a) argument bytes (qparams, cache, tokens) "
          f"{args / 2 ** 30:.4f} GiB EQUAL the report's; the cache and "
          f"tokens raised torch.cuda.memory_allocated() by "
          f"{(torch.cuda.memory_allocated() - base) / 2 ** 30:.4f} GiB")

    def calls():
        logits, _ = lm.prefill(qparams, {"tokens": tokens}, cfg, bits, bits,
                               cache)
        step, _ = lm.decode_step(qparams, tok, S, cache, cfg, bits, bits)
        return logits, step

    out = calls()                               # warm-up
    del out
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = kernels.launch_keys()
    t0 = time.perf_counter()
    logits, _ = lm.prefill(qparams, {"tokens": tokens}, cfg, bits, bits,
                           cache)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    step, _ = lm.decode_step(qparams, tok, S, cache, cfg, bits, bits)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    got = kernels.launches_since(before)
    check(got == pred["kernels"], f"(a) launches by key on the card "
          f"{sorted(got.items(), key=str)} != the report's "
          f"{sorted(pred['kernels'].items(), key=str)}")
    check(bool(torch.isfinite(logits).all() and torch.isfinite(step).all())
          and tuple(logits.shape) == (B, 1, cfg.padded_vocab),
          f"(a) logits {tuple(logits.shape)} not finite")
    gap = abs(pred["peak"] - peak) / peak
    check(gap <= P14_PEAK_TOL, f"(a) predicted peak {pred['peak']} bytes "
          f"is {gap:.3f} off the card's {peak}")
    print(f"{tag} (a) launches by key EQUAL the report's: "
          f"{sum(got.values())} over {len(got)} keys; peak above the "
          f"arguments: predicted {pred['peak'] / 2 ** 30:.4f} GiB, "
          f"max_memory_allocated() rise {peak / 2 ** 30:.4f} GiB "
          f"({gap:.4f} apart, tolerance {P14_PEAK_TOL})")
    del logits, step
    tr = trace(torch, tag, "path 14 (a) prefill + decode step",
               calls, ("bitplane_matmul", "flash_attention"))
    work = {}
    for cost in (pred["prefill"], pred["decode"]):
        for k, w in cost.kernel_work.items():
            work[k] = [a + c for a, c in zip(work.get(k, [0.0] * 3), w)]
    for k, (ops, nbytes, bound_s) in sorted(work.items()):
        ms = tr["kernel_ms"][k]
        check(ms >= P14_BOUND_FLOOR * bound_s * 1e3,
              f"(a) {k}: traced device time {ms:.3f} ms under "
              f"{P14_BOUND_FLOOR} of the report's bound "
              f"{bound_s * 1e3:.3f} ms for its launches")
        print(f"{tag} (a) {k}: traced device {ms:.3f} ms, the report's "
              f"bound {bound_s * 1e3:.3f} ms ({ops:.4g} ops, "
              f"{nbytes / 1e9:.3f} GB), {bound_s * 1e3 / ms:.3f} of bound")
    roof = dryrun.roofline_s(pred["prefill"])
    # ---- the kernels at the path's shapes: held, timed
    from repro_torch.kernels import bitplane_matmul as bpm
    shapes, paths = {}, {p: 0 for p in bpm.PATHS}
    for key, c in got.items():
        if key[0] == "bitplane_matmul":
            _, path, n_pl, M, K, N = key
            shapes[(M, K, N, n_pl)] = shapes.get((M, K, N, n_pl), 0) + c
            paths[path] += c
    bp = held_rows(b, shapes, paths)
    n_fl = sum(c for key, c in got.items() if key[0] == "flash_attention")
    fl_shape = (B * cfg.n_heads, S, cfg.head_dim)
    fl_err = hold_flash(b, *fl_shape[:2], S, cfg.head_dim, True, 0)
    fl = flash_row(b, fl_shape, " (path 14 (a) prefill)")
    print(f"{tag} (a) kernels at the path's shapes: bit-plane "
          f"{bp['launches']} launches at {len(shapes)} (M, K, N, planes), "
          f"EQUAL to the plain version, kernel {bp['ms']:.3f} ms (device "
          f"{bp['device_ms']:.3f}), bound {bp['bound_ms']:.3f} ms, plain "
          f"{bp['plain_ms']:.3f} ms, torch._int_mm {bp['library_ms']:.3f} "
          f"ms; flash {n_fl} launches at {fl_shape} causal (max |err| "
          f"{fl_err:.6g} against the f32 oracle), {n_fl * fl['ms']:.3f} ms")
    wall = time.perf_counter() - t_path
    print(f"{tag} (a) prefill {B} x {S}: measured {pre_s * 1e3:.3f} ms, "
          f"roofline {roof * 1e3:.3f} ms (compute and memory terms of "
          f"the report's FLOPs and byte floor), measured / roofline "
          f"{pre_s / roof:.3f}; the prediction took {pred_s:.3f} s on the "
          f"host; path 14 (a) wall {wall:.3f} s")
    del cache, tokens
    torch.cuda.empty_cache()
    return {"wall_s": wall, "pred_s": pred_s, "peak": (pred["peak"], peak),
            "prefill_ms": pre_s * 1e3, "roofline_ms": roof * 1e3,
            "launches": sum(got.values()), "bitplane": bp,
            "flash": flash_entry(n_fl, fl, n_fl)}


def p14_seq_rank(torch, dev, cfg, qparams, mesh, smoke: bool) -> dict:
    """Path 11 (f), on a rank: ``generate`` of P14_SEQ at B=1 on the
    (2, 1) mesh (FSDP weights, the sequence-sharded cache), its
    collectives; then the same prompt's prefill on a fresh cache, whose
    blocks it digests."""
    import numpy as np
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine, default_controller
    B, S, new = p14_sizes(smoke)
    prompt = p14_prompt(cfg, B, S)
    eng = ServeEngine(cfg, qparams, max_len=S + new, mesh=mesh,
                      controller=default_controller(lm.n_bit_slots(cfg)),
                      device=dev)
    eng.set_budget(10.0)
    mesh.reset_counts()
    with mesh.reuse_gathers():      # the prefill below gathers no weight
        toks = eng.generate({"tokens": prompt}, new).cpu().numpy()
        counts = {k: list(v) for k, v in mesh.counts.items()}
        with eng.compute_ctx():
            wv, av = eng._bits()
            cache = lm.empty_cache(cfg, B, S + new, device=dev, mesh=mesh)
            lm.prefill(eng.qparams,
                       {"tokens": torch.as_tensor(prompt).to(dev)}, cfg, wv,
                       av, cache)
    shapes = {k: tuple(v.shape) for k, v in cache.items()}
    digests = {k: digest(v) for k, v in cache.items()}
    del eng, cache
    return {"tokens": np.asarray(toks), "counts": counts,
            "cache_shapes": shapes, "digests": digests}


def p14_sizes(smoke: bool):
    return (1, 40, 4) if smoke else P14_SEQ


def p14_prompt(cfg, B, S):
    import numpy as np
    return np.random.default_rng(14).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def p14_seq_single(torch, dev, cfg, qparams, smoke: bool) -> dict:
    """Path 11 (f)'s one-device side: ``generate`` of the same prompt, the
    same calls step by step (greedy, keeping each step's top-2 logit gap
    for ``tokens_agree``), and each rank's block of the cache after
    prefill, digested."""
    import numpy as np
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine, default_controller
    B, S, new = p14_sizes(smoke)
    prompt = p14_prompt(cfg, B, S)
    eng = ServeEngine(cfg, qparams, max_len=S + new,
                      controller=default_controller(lm.n_bit_slots(cfg)),
                      device=dev)
    eng.set_budget(10.0)
    toks = eng.generate({"tokens": prompt}, new).cpu().numpy()
    gaps, stepwise = [], []
    with eng.compute_ctx():
        wv, av = eng._bits()
        cache = lm.empty_cache(cfg, B, S + new, device=dev)
        logits, _ = lm.prefill(eng.qparams,
                               {"tokens": torch.as_tensor(prompt).to(dev)},
                               cfg, wv, av, cache)
        n = cache["kpos"].shape[-1] // P11_RANKS
        blocks = [{k: digest(v if k == "kpos" else v[:, :, r * n:(r + 1) * n])
                   for k, v in cache.items()} for r in range(P11_RANKS)]
        for i in range(new):
            lg = logits[0, -1, :cfg.vocab_size].float()
            top2 = torch.topk(lg, 2).values
            gaps.append(float((top2[0] - top2[1]) / lg.abs().max()))
            tok = int(lg.argmax())
            stepwise.append(tok)
            if i + 1 < new:
                logits, _ = lm.decode_step(
                    eng.qparams, torch.tensor([[tok]], dtype=torch.int32,
                                              device=dev),
                    S + i, cache, cfg, wv, av)
    del eng, cache
    return {"tokens": toks, "stepwise": stepwise, "gaps": gaps,
            "blocks": blocks}


# ---------------------------------------------------------------------------
# Path 15: the recurrent and encoder-decoder families on a mesh
# ---------------------------------------------------------------------------

def p15_configs(smoke: bool) -> dict:
    """Path 15's three configs: the published widths (path 8's, held
    there) cut in depth, or SMOKE for a CPU rehearsal."""
    from repro_torch import configs
    if smoke:
        return {"ssm": configs.get_smoke(SSM_ARCH),
                "hybrid": configs.get_smoke(HYB_ARCH),
                "encdec": configs.get_smoke(ED_ARCH)}
    full = p8_configs()
    hyb = full["hybrid"]
    return {"ssm": full["ssm"].with_(n_layers=P15_SSM_LAYERS),
            "hybrid": hyb.with_(n_layers=P15_HYB_SUPER * hyb.attn_every),
            "encdec": full["encdec"].with_(n_enc_layers=P15_ED_LAYERS[0],
                                           n_layers=P15_ED_LAYERS[1])}


def p15_params(torch, dev, cfg, seed: int):
    """Train-form weights drawn from ``seed`` on ``dev`` (every process
    draws the same); zamba2's LoRA ``b`` drawn N(0, P15_LORA_B), so the
    side branch adds what a misaligned delta would get wrong."""
    from repro_torch.models import lm
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = lm.init_params(cfg, gen, device=dev)
    if cfg.family == "hybrid":
        for pair in params["layers"]["lora"].values():
            pair["b"] = (torch.randn(pair["b"].shape, generator=gen,
                                     device=dev) * P15_LORA_B
                         ).to(pair["b"].dtype)
    return params


def p15_weights(torch, dev, cfg):
    """Path 15's serve-form weights: :func:`p15_params` of seed 15,
    quantized."""
    from repro_torch.models import lm
    return lm.quantize_params(p15_params(torch, dev, cfg, 15), cfg)


def p15_sizes(smoke: bool) -> dict:
    return ({"gen": (2, 40, 2), "b1": (1, 40, 2)} if smoke else
            {"gen": P15_GEN, "b1": P15_B1})


def p15_batch(cfg, sizes: dict, key: str) -> dict:
    """The seeded batch of ``key`` ("gen" or "b1", the first row of
    "gen's"): tokens, and for encdec as many frame embeddings as
    tokens."""
    import numpy as np
    B, S, _ = sizes["gen"]
    rng = np.random.default_rng(15)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))
             .astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    return {k: v[:sizes[key][0]] for k, v in batch.items()}


def p15_budget(cfg, rows: int):
    b = P15_BUDGETS[cfg.family]
    return list(b[:rows]) if isinstance(b, tuple) else b


def p15_host(tree):
    """A host copy of a cache tree (the serve loop writes the card's in
    place)."""
    if isinstance(tree, dict):
        return {k: p15_host(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True)


def p15_serve(torch, dev, cfg, qparams, batch, new: int, mesh) -> dict:
    """One ``generate`` on ``mesh`` (None: one device) at the family's
    budget: its tokens, this rank's rows of the prefill's last-position
    logits and a host copy of the cache after prefill, the flash
    launches by (q shape, keys, causal), and the rows this rank ran."""
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import ops as kops
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine, default_controller
    B, S = batch["tokens"].shape
    eng = ServeEngine(cfg, qparams, max_len=S + new, device=dev, mesh=mesh,
                      controller=default_controller(lm.n_bit_slots(cfg)))
    eng.set_budget(p15_budget(cfg, B))
    firsts, caches, flash = [], [], {}
    first, prefill, fa = eng._sample_first, lm.prefill, kops.flash_attention

    def keep_first(logits, temp, topk, rows=None):
        firsts.append(logits[:, -1].float().cpu())
        return first(logits, temp, topk, rows)

    def keep_cache(*args, **kw):
        out = prefill(*args, **kw)
        caches.append(p15_host(out[1]))
        return out

    def count_flash(q, k, v, **kw):
        key = (tuple(q.shape), k.shape[1], bool(kw.get("causal", True)))
        flash[key] = flash.get(key, 0) + 1
        return fa(q, k, v, **kw)

    eng._sample_first = keep_first
    lm.prefill, kops.flash_attention = keep_cache, count_flash
    try:
        toks = eng.generate(batch, new).cpu().numpy()
    finally:
        lm.prefill, kops.flash_attention = prefill, fa
    out = {"tokens": toks, "logits": firsts[0].numpy(), "cache": caches[0],
           "flash_shapes": flash, "rows": eng._row_split(B, "rows"),
           "sharded": mesh is not None and shd.is_sharded(eng.qparams)}
    del eng
    return out


P15_PHASES = (("ssm", "a", "gen"), ("ssm", "b", "gen"), ("ssm", "b1", "b1"),
              ("hybrid", "a", "gen"), ("hybrid", "b", "gen"),
              ("hybrid", "b1", "b1"), ("encdec", "a", "gen"),
              ("encdec", "b", "gen"))


def p15_rank(rank: int, init_method: str, out_dir: str, device: str,
             smoke: bool) -> None:
    """One rank of path 15 on ``device``: the same world as a (1, 2) and a
    (2, 1) mesh; each family's weights drawn, then (a) on (1, 2), (b)
    and its B=1 row on (2, 1), each a phase (``p11_phase``)."""
    import datetime
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as tdist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if smoke:
        tf.FLASH_THRESHOLD = P15_SMOKE_FLASH
    tdist.init_process_group(
        "gloo", init_method=init_method, rank=rank, world_size=P15_RANKS,
        timeout=datetime.timedelta(seconds=SO_TIMEOUT_S))
    out = {}
    sizes = p15_sizes(smoke)
    try:
        m12, m21 = make_host_mesh(model=2), make_host_mesh(model=1)
        both = (m12, m21)
        for fam, cfg in p15_configs(smoke).items():
            q = p15_weights(torch, dev, cfg)
            for f, key, size in P15_PHASES:
                if f == fam:
                    out[(fam, key)] = p11_phase(
                        torch, dev, both, p15_serve, torch, dev, cfg, q,
                        p15_batch(cfg, sizes, size), sizes[size][2],
                        m12 if key == "a" else m21)
            del q
        out["coords"] = (m12.tp_index, m21.dp_index)
    finally:
        tdist.destroy_process_group()
    torch.save(out, f"{out_dir}/rank{rank}.pt")


def p15_whole(torch, ranks_cache: list, shape):
    """The whole leaf of one device's ``shape`` from the ranks' blocks:
    rank 0's where it holds it whole, else the blocks concatenated in
    rank order along the one dim that splits them (the heads or channels
    on (1, 2), the rows or the ring on (2, 1))."""
    blocks = ranks_cache
    if tuple(blocks[0].shape) == tuple(shape):
        return blocks[0], all(torch.equal(x, blocks[0]) for x in blocks)
    dims = [i for i, (a, b) in enumerate(zip(blocks[0].shape, shape))
            if a != b]
    check(len(dims) == 1, f"path 15: blocks {tuple(blocks[0].shape)} of "
          f"{tuple(shape)} split on {len(dims)} dims")
    return torch.cat(blocks, dim=dims[0]), True


def p15_first_gap(torch, cfg, got: dict, want: dict):
    """(layer, leaves) of the first layer, in forward order, whose cache
    after prefill differs from one device's, or None.  A hybrid runs
    super-block i's shared block (``kv[i]``) before its Mamba layers."""
    from repro_torch.dist import sharding as shd
    order = []
    flat_w = {"/".join(map(str, p)): t for p, t in shd.tree_paths(want)}
    flat_g = {"/".join(map(str, p)): t for p, t in shd.tree_paths(got)}
    for name, t in flat_w.items():
        for layer in range(t.shape[0]):
            pos = layer
            if cfg.family == "hybrid":
                pos = (layer * (cfg.attn_every + 1) if name.startswith("kv")
                       else layer + layer // cfg.attn_every + 1)
            elif cfg.family == "encdec" and name.startswith("cross"):
                pos = -1                        # the encoder's output
            order.append((pos, layer, name))
    for pos, layer, name in sorted(order):
        if not torch.equal(flat_g[name][layer], flat_w[name][layer]):
            return layer, name
    return None


def p15_gate(torch, cfg, fam, key, ranks, want) -> dict:
    """One phase's gates: tokens EQUAL one device's; the prefill's
    last-position logits (the ranks' rows in order) and the cache after
    prefill (the ranks' blocks put together) EQUAL, except for a
    Mamba-bearing model on (1, 2), where the card's f32 SSD einsums at
    H/tp heads may pick other library kernels: its logits within
    P15_SSD_TOL x max|logit|, the largest gap and the first layer that
    differs printed; every cache leaf's shape its spec's local block;
    weights sharded; launches on the card."""
    import types
    import numpy as np
    from repro_torch.dist import api as dapi
    from repro_torch.dist import sharding as shd
    shape = (1, P15_RANKS) if key == "a" else (P15_RANKS, 1)
    mesh = types.SimpleNamespace(shape=dict(zip(("data", "model"), shape)),
                                 axis_names=("data", "model"))
    res = [out[(fam, key)] for out in ranks]
    for r, x in enumerate(res):
        check(np.array_equal(x["tokens"], want["tokens"]),
              f"path 15 {cfg.name} ({key}) rank {r}: tokens "
              f"{x['tokens'].tolist()} != one device's "
              f"{want['tokens'].tolist()}")
        check(x["sharded"], f"path 15 {cfg.name} ({key}) rank {r}: no "
              f"weight sharded")
    split = res[0]["rows"] is not None
    logits = (np.concatenate([x["logits"] for x in res]) if split
              else res[0]["logits"])
    if not split:
        for r, x in enumerate(res[1:], 1):
            check(np.array_equal(x["logits"], logits), f"path 15 "
                  f"{cfg.name} ({key}): rank {r}'s logits != rank 0's")
    V = cfg.vocab_size                  # past it: the masked padding ids
    gap = float(np.abs(logits[..., :V] - want["logits"][..., :V]).max())
    tree_w = want["cache"]
    specs = shd.cache_shardings(tree_w, mesh)
    got, same = {}, True

    def build(node_w, node_s, path):
        nonlocal same
        out = {}
        for k, t in node_w.items():
            if isinstance(t, dict):
                out[k] = build(t, node_s[k], path + (k,))
                continue
            blocks = [x["cache"] for x in res]
            for p_ in path + (k,):
                blocks = [b_[p_] for b_ in blocks]
            want_local = dapi.local_shape(mesh, node_s[k], t.shape)
            for r, b_ in enumerate(blocks):
                check(tuple(b_.shape) == tuple(want_local),
                      f"path 15 {cfg.name} ({key}) rank {r}: cache leaf "
                      f"{'/'.join(path + (k,))} {tuple(b_.shape)} is not "
                      f"its spec's block {want_local} of {tuple(t.shape)}")
            out[k], agree = p15_whole(torch, blocks, t.shape)
            same &= agree
        return out

    got = build(tree_w, specs, ())
    check(same, f"path 15 {cfg.name} ({key}): ranks hold a replicated "
          f"cache leaf apart")
    first = p15_first_gap(torch, cfg, got, tree_w)
    exact = gap == 0.0 and first is None
    allowed = key == "a" and cfg.family in ("ssm", "hybrid")
    limit = P15_SSD_TOL * float(np.abs(want["logits"][..., :V]).max())
    check(exact or (allowed and gap <= limit),
          f"path 15 {cfg.name} ({key}): prefill logits max |diff| {gap} "
          f"(limit {limit if allowed else 0.0}), first cache layer apart "
          f"{first}")
    if not exact:
        heads = cfg.expand * cfg.d_model // cfg.ssm_head_dim
        print(f"path 15 {cfg.name} ({key}): the SSD einsums at "
              f"{heads // P15_RANKS} heads a rank: prefill "
              f"logits max |diff| {gap:.6g} (gate {limit:.6g} = "
              f"{P15_SSD_TOL} x max|logit|), first layer apart {first}; "
              f"tokens EQUAL")
    return {"gap": gap, "first": first, "exact": exact}


def p15_path(b: Bench, smoke: bool = False) -> dict:
    """Path 15: mamba2, zamba2 and seamless served on P15_RANKS gloo
    ranks sharing the card (module docstring); returns the kernel rows
    of the ranks' launches."""
    torch, dev, tag = b.torch, b.dev, b.tag
    import tempfile
    import torch.multiprocessing as tmp
    from repro_torch.kernels import bitplane_matmul as bpm
    from repro_torch.models import transformer as tf
    t_path = time.perf_counter()
    cuda = dev.type == "cuda"
    sizes = p15_sizes(smoke)
    cfgs = p15_configs(smoke)
    prev = tf.FLASH_THRESHOLD
    if smoke:
        tf.FLASH_THRESHOLD = P15_SMOKE_FLASH
    # ---- one device first (the card freed before the ranks)
    want, t0 = {}, time.perf_counter()
    try:
        for fam, cfg in cfgs.items():
            q = p15_weights(torch, dev, cfg)
            for size in ("gen", "b1") if fam != "encdec" else ("gen",):
                want[(fam, size)] = p15_serve(
                    torch, dev, cfg, q, p15_batch(cfg, sizes, size),
                    sizes[size][2], None)
            del q
    finally:
        tf.FLASH_THRESHOLD = prev
    single_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        tmp.start_processes(p15_rank, args=(
            f"tcp://127.0.0.1:{free_port()}", d, str(dev), smoke),
            nprocs=P15_RANKS, join=True, start_method="spawn")
        ranks = [torch.load(f"{d}/rank{r}.pt", weights_only=False)
                 for r in range(P15_RANKS)]
    ranks_s = time.perf_counter() - t0
    for r, out in enumerate(ranks):
        check(out["coords"] == (r, r), f"path 15 rank {r}: mesh coords "
              f"{out['coords']}")
    # ---- the gates, phase by phase
    gates = {}
    for fam, key, size in P15_PHASES:
        cfg = cfgs[fam]
        gates[(fam, key)] = g = p15_gate(torch, cfg, fam, key, ranks,
                                         want[(fam, size)])
        for r, out in enumerate(ranks):
            x = out[(fam, key)]
            needs_flash = fam != "ssm" and sizes[size][1] > (
                P15_SMOKE_FLASH if smoke else tf.FLASH_THRESHOLD)
            check(not cuda or (sum(x["shapes"].values()) > 0
                               and x["off_path"] == (0, 0)
                               and (x["flash"] > 0) == needs_flash),
                  f"path 15 {cfg.name} ({key}) rank {r}: bit-plane "
                  f"{sum(x['shapes'].values())}, flash {x['flash']}, "
                  f"int4/quant {x['off_path']}")
        x0 = ranks[0][(fam, key)]
        B, S, new = sizes[size]
        mesh_s = (f"(1, {P15_RANKS}) tensor-parallel" if key == "a" else
                  f"({P15_RANKS}, 1) FSDP" + (", the row whole on every "
                                               "rank" if B == 1 else
                                               ", rows split"))
        print(f"(15 {key}) {cfg.name} ({cfg.n_layers} layers"
              + (f" + {cfg.n_enc_layers} encoder" if fam == "encdec" else "")
              + f") on {mesh_s}: generate B = {B} x {S}"
              + (f" behind {S} frames" if fam == "encdec" else "")
              + f", {new} new, budget {p15_budget(cfg, B)}: tokens EQUAL, "
              f"prefill logits and cache "
              + ("EQUAL" if g["exact"] else
                 f"{g['gap']:.6g} apart (first layer {g['first']})")
              + f"; launches rank 0 / rank 1: bit-plane "
              + " / ".join(str(sum(out[(fam, key)]["shapes"].values()))
                           for out in ranks)
              + ", flash " + " / ".join(str(out[(fam, key)]["flash"])
                                        for out in ranks)
              + f" at {sorted(x0['flash_shapes'])}; wall "
              + " / ".join(f"{out[(fam, key)]['wall_s']:.3f} s"
                           for out in ranks)
              + f"; collectives rank 0 "
              f"{ {k: tuple(v) for k, v in x0['collectives'].items()} }")
    # ---- every shape the ranks launched: held and timed
    shapes, paths, fl_shapes = {}, {p: 0 for p in bpm.PATHS}, {}
    for fam, key, _ in P15_PHASES:
        x = ranks[0][(fam, key)]
        for k, n in x["shapes"].items():
            shapes[k] = shapes.get(k, 0) + n
        for k, n in x["paths"].items():
            paths[k] += n
        for k, n in x["flash_shapes"].items():
            fl_shapes[k] = fl_shapes.get(k, 0) + n
    check(not cuda or (sum(shapes.values()) > 0 and fl_shapes),
          "path 15 launched no bit-plane or no flash kernel")
    bp = held_rows(b, shapes, paths, cuda)
    fl = held_flash_rows(b, fl_shapes, "path 15", cuda)
    n_fl = fl["launches"]
    wall = time.perf_counter() - t_path
    print(f"{tag} path 15 kernels (rank 0's phases): bit-plane "
          f"{bp['launches']} launches at {len(shapes)} (M, K, N, planes) "
          f"(by path {paths}), each held EQUAL to the plain version, kernel "
          f"{bp['ms']:.3f} ms (device {bp['device_ms']:.3f}), bound "
          f"{bp['bound_ms']:.3f} ms, plain {bp['plain_ms']:.3f} ms, "
          f"torch._int_mm {bp['library_ms']:.3f} ms; flash {n_fl} launches "
          f"at {dict(sorted(fl_shapes.items()))}, each shape held against "
          f"the f32 oracle, {fl['ms']:.3f} ms (device "
          f"{fl['device_ms']:.3f}), bound {fl['bound_ms']:.3f} ms, plain "
          f"{fl['plain_ms']:.3f} ms, scaled_dot_product_attention "
          f"{fl['library_ms']:.3f} ms")
    print(f"{tag} path 15 wall {wall:.3f} s (one device {single_s:.3f} s, "
          f"the ranks {ranks_s:.3f} s)")
    return {"bitplane": bp, "flash": fl, "gates": gates,
            "e2e": {"wall_s": wall, "ranks_s": ranks_s}}


# ---------------------------------------------------------------------------
# Path 16: the recurrent and encoder-decoder families trained on a mesh
# ---------------------------------------------------------------------------

def p16_configs(smoke: bool, key: str = "a") -> dict:
    """Path 16's configs with ``remat="full"``: the published widths
    (path 8's, held there) cut in depth, (a)'s three or (b)'s two
    (P16_FSDP), or SMOKE for a CPU rehearsal."""
    from repro_torch import configs
    if smoke:
        cfgs = {"ssm": configs.get_smoke(SSM_ARCH),
                "hybrid": configs.get_smoke(HYB_ARCH),
                "encdec": configs.get_smoke(ED_ARCH)}
    else:
        full = p8_configs()
        hyb = full["hybrid"]
        ssm, sup = ((P16_SSM_LAYERS, P16_HYB_SUPER) if key == "a"
                    else P16_FSDP)
        cfgs = {"ssm": full["ssm"].with_(n_layers=ssm),
                "hybrid": hyb.with_(n_layers=sup * hyb.attn_every),
                "encdec": full["encdec"].with_(
                    n_enc_layers=P16_ED_LAYERS[0],
                    n_layers=P16_ED_LAYERS[1])}
    if key == "b":
        del cfgs["encdec"]
    return {k: c.with_(remat="full") for k, c in cfgs.items()}


def p16_sizes(smoke: bool) -> dict:
    """(rows, tokens a row) of the train batch; (B, prompt, new) of (d)."""
    return ({"batch": (4, 32), "serve": (2, 40, 2)} if smoke else
            {"batch": (P16_B, P16_S), "serve": P16_SERVE})


def p16_batch(torch, dev, cfg, smoke: bool) -> dict:
    from repro_torch.data.pipeline import make_batch
    B, S = p16_sizes(smoke)["batch"]
    return tree_to(make_batch(0, 0, B, S + 1, cfg.vocab_size, cfg), dev)


def p16_grads(torch, cfg, params, batch, bits, mesh):
    """The gradient of every leaf on the step's first microbatch (rows 0
    .. B/P12_ACCUM) at ``bits``, and the microbatch's loss: on one
    device a host tree; on a mesh each rank's rows, the leaves the data
    axis does not shard SUMmed over it (as a step does), each leaf this
    rank's block of its layout (``p16_block_gaps`` compares blocks)."""
    import contextlib
    from repro_torch.dist import api as dist
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import ops as kops
    from repro_torch.models import lm
    from repro_torch.optim.adamw import (leaf_layouts, tree_leaves, tree_map,
                                         tree_unflatten)
    mb = {k: v[:v.shape[0] // P12_ACCUM] for k, v in batch.items()}
    live = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    with contextlib.ExitStack() as ctx:
        if mesh is not None:
            mb = shd.shard_batch(mb, mesh)
            ctx.enter_context(dist.use_mesh(mesh))
            ctx.enter_context(kops.split_rows(
                mesh if dist.dp_size(mesh) > 1 else None))
        total, mets = lm.train_loss(tree_unflatten(params, live), mb, cfg,
                                    *bits)
        grads = list(torch.autograd.grad(total, live, allow_unused=True))
    loss = mets["loss"].detach()
    del total, mets
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, live)]
    del live
    if mesh is not None and dist.dp_size(mesh) > 1:
        for j, lay in enumerate(leaf_layouts(params)):
            held = () if lay is None else tuple(
                a for e in lay[2] for a in dist.entry_axes(e))
            grads[j] = mesh.sum_grad(grads[j], tuple(
                a for a in mesh.dp_axes if a not in held), kind="grad_dp")
        loss = mesh.all_reduce(loss, mesh.dp_axes, "sum", kind="metrics")
    tree = tree_unflatten(params, grads)
    if mesh is None:
        tree = tree_map(lambda t: t.detach().to("cpu"), tree)
    return tree, float(loss)


def p16_block_gaps(torch, dev, mesh, placed, whole):
    """Each rank's blocks of a placed tree (``dist.sharding`` layouts)
    against the same blocks of ``whole`` (a host tree of every leaf
    whole), reduced over the mesh without gathering a leaf: ``(by leaf
    path: max |placed - whole| over max |whole|, the largest |placed -
    whole| beyond one bf16 step of the larger value, the mean |placed -
    whole|)``, every element counted once."""
    import math as m_
    from repro_torch.dist import sharding as shd
    axes = mesh.axis_names
    world = m_.prod(mesh.shape[a] for a in axes)
    names, maxes, sums = [], [], []

    def walk(node, want, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, want[k], path + (k,))
                continue
            spec = (node.spec(k)[1] if isinstance(node, shd.Local)
                    else (None,) * v.ndim)
            a = v.detach().float()
            w = shd.block(mesh, want[k].to(dev), spec).float()
            d = (a - w).abs()
            top = torch.maximum(a.abs(), w.abs())
            one = (torch.nextafter(top, torch.full_like(top, float("inf")))
                   - top) * 2.0 ** 16
            copies = world / m_.prod(mesh.axis_size(e) for e in spec if e)
            names.append("/".join(map(str, path + (k,))))
            maxes.append(torch.stack([d.max(), w.abs().max(),
                                      (d - one).clamp_min(0).max()]))
            sums.append(torch.stack([d.sum() / copies,
                                     torch.tensor(d.numel() / copies,
                                                  device=d.device)]))

    walk(placed, whole, ())
    mx = mesh.all_reduce(torch.stack(maxes), axes, "max", kind="gate")
    sm = mesh.all_reduce(torch.stack(sums).double(), axes, "sum",
                         kind="gate").sum(0)
    gaps = {n: float(mx[i, 0]) / max(float(mx[i, 1]), 1e-30)
            for i, n in enumerate(names)}
    return gaps, float(mx[:, 2].max()), float(sm[0] / sm[1])


def p16_one_device(torch, dev, fam: str, key: str, cfg, smoke: bool,
                   d: str) -> dict:
    """One device's first-microbatch gradient (at 16 bits) and P12_STEPS
    steps of one family from the ranks' weights (seed 16 on the same
    device); the gradient and the trained parameters saved under ``d``
    for rank 0's gates, the metrics, walls and largest update
    returned."""
    from repro_torch.optim.adamw import adamw_init, tree_map
    from repro_torch.train.loop import make_train_step
    params = p15_params(torch, dev, cfg, 16)
    tcfg = p12_tcfg(P12_ACCUM)
    step, bits = make_train_step(tcfg, cfg, device=dev)
    batch = p16_batch(torch, dev, cfg, smoke)
    grads, loss = p16_grads(torch, cfg, params, batch, p16_exact(bits), None)
    opt = adamw_init(params, tcfg.optimizer)
    mets, walls, upd = [], [], 0.0
    for _ in range(P12_STEPS):
        sync(torch, dev)
        t0 = time.perf_counter()
        new, opt, m = step(params, opt, batch)
        sync(torch, dev)
        walls.append(time.perf_counter() - t0)
        mets.append({k: float(v) for k, v in m.items()})
        upd = max(upd, p12_largest_update(new, params))
        params = new
    torch.save({"grads": grads, "params": tree_map(
        lambda t: t.to("cpu"), params)}, f"{d}/one_{fam}_{key}.pt")
    return {"metrics": mets, "walls": walls, "update": upd,
            "grad_loss": loss}


def p16_exact(bits):
    """The step's bit vectors at 16 bits, where the fake quantizer is the
    identity (``bitfluid.fake_quant``'s fp sentinel)."""
    return tuple(b.new_full(b.shape, 16) for b in bits)


def p16_train(torch, dev, fam: str, key: str, cfg, mesh, smoke: bool,
              holder: dict, d: str) -> dict:
    """(a) or (b) of one family on one rank: the weights drawn whole and
    placed on ``mesh``, the first microbatch's gradient (at 16 bits),
    then P12_STEPS steps through ``make_train_step`` on this rank's rows,
    each timed, the last one's collectives counted.  The ranks hold the
    gradient leaf by leaf and the trained parameters against one
    device's (saved under ``d``), block by block; a tensor-parallel rank
    keeps its trained state for (c) and (d)."""
    from repro_torch.dist import api as dist
    from repro_torch.dist import sharding as shd
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.loop import make_train_step
    tcfg = p12_tcfg(P12_ACCUM)
    whole = p15_params(torch, dev, cfg, 16)
    p_shd = shd.param_shardings(whole, mesh)
    params = shd.shard_params(whole, mesh)
    del whole
    step, bits = make_train_step(tcfg, cfg, device=dev, param_shardings=p_shd)
    batch = p16_batch(torch, dev, cfg, smoke)
    t0 = time.perf_counter()
    grads, grad_loss = p16_grads(torch, cfg, params, batch, p16_exact(bits),
                                 mesh)
    grad_s = time.perf_counter() - t0
    opt = adamw_init(params, tcfg.optimizer)
    local = shd.shard_batch(batch, mesh)
    mets, walls, counts = [], [], {}
    for _ in range(P12_STEPS):
        before = {k: list(v) for k, v in mesh.counts.items()}
        sync(torch, dev)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, local)
        sync(torch, dev)
        walls.append(time.perf_counter() - t0)
        mets.append({k: float(v) for k, v in m.items()})
        counts = {k: [v[0] - before.get(k, [0, 0])[0],
                      v[1] - before.get(k, [0, 0])[1]]
                  for k, v in mesh.counts.items()}
    out = {"metrics": mets, "walls": walls, "grad_s": grad_s,
           "grad_loss": grad_loss, "step_counts": counts}
    one = torch.load(f"{d}/one_{fam}_{key}.pt", weights_only=False)
    out["grad_gaps"] = p16_block_gaps(torch, dev, mesh, grads,
                                      one["grads"])[0]
    out["param_gap"] = p16_block_gaps(torch, dev, mesh, params,
                                      one["params"])[1:]
    del one, grads
    if dist.tp_size(mesh) > 1:
        holder["a"] = (params, opt)
    return out


def p16_serve(torch, dev, cfg, holder: dict, mesh, smoke: bool) -> dict:
    """(d): (a)'s trained weights whole (restored by (c), or gathered),
    quantized (kept in ``holder["q"]``) and served on ``mesh`` (None: one
    device) through ``generate`` as path 15 serves them."""
    from repro_torch.models import lm
    from repro_torch.models import transformer as tf
    if "whole" in holder:
        holder["q"] = lm.quantize_params(holder.pop("whole"), cfg)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    B, S, new = p16_sizes(smoke)["serve"]
    prev = tf.FLASH_THRESHOLD
    if smoke:
        tf.FLASH_THRESHOLD = P15_SMOKE_FLASH
    try:
        return p15_serve(torch, dev, cfg, holder["q"],
                         p15_batch(cfg, {"gen": (B, S, new)}, "gen"), new,
                         mesh)
    finally:
        tf.FLASH_THRESHOLD = prev


def p16_warm(torch, dev, mesh) -> float:
    """One SMOKE zamba2 microbatch (forward and backward, ``remat``) on
    ``mesh``, beside the parent's one-device steps in little memory: it
    loads the train step's kernels and opens the group's paths; its
    wall."""
    from repro_torch import configs
    from repro_torch.dist import sharding as shd
    t0 = time.perf_counter()
    cfg = configs.get_smoke(HYB_ARCH).with_(remat="full")
    whole = p15_params(torch, dev, cfg, 1)
    bits = (torch.full((2,), 8, dtype=torch.int32, device=dev),) * 2
    p16_grads(torch, cfg, shd.shard_params(whole, mesh),
              p16_batch(torch, dev, cfg, True), bits, mesh)
    sync(torch, dev)
    return time.perf_counter() - t0


def p16_rank(rank: int, init_method: str, out_dir: str, device: str,
             smoke: bool) -> None:
    """One rank of path 16 on ``device``: the same world as a (1, 2) and a
    (2, 1) mesh; a SMOKE warm-up beside the parent's one-device steps,
    then once the card is free, for each family: (a) on (1, 2), (c) (a)'s
    state across meshes, (d) its weights served on (1, 2) and (b) on (2,
    1), each a phase (``p11_phase``); then on rank 0 (d)'s one-device
    serves."""
    import datetime
    import os
    import shutil
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as tdist
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tdist.init_process_group(
        "gloo", init_method=init_method, rank=rank, world_size=P16_RANKS,
        timeout=datetime.timedelta(seconds=SO_TIMEOUT_S))
    out, served = {}, {}
    cfgs = {k: p16_configs(smoke, k) for k in "ab"}
    try:
        m12, m21 = make_host_mesh(model=2), make_host_mesh(model=1)
        both = (m12, m21)
        out["warm_s"] = p16_warm(torch, dev, m12)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        while not os.path.exists(f"{out_dir}/card_free"):
            time.sleep(0.1)
        for fam, cfg in cfgs["a"].items():
            holder = {}
            out[(fam, "a")] = p11_phase(torch, dev, both, p16_train, torch,
                                        dev, fam, "a", cfg, m12, smoke,
                                        holder, out_dir)
            if fam == P16_CKPT_FAMILY:
                out["c"] = p11_phase(torch, dev, both, p12_ckpt, torch, dev,
                                     m12, m21, holder, out_dir, "ckpt")
            else:
                holder["whole"] = shd.full(holder.pop("a")[0])
            out[(fam, "d")] = p11_phase(torch, dev, both, p16_serve, torch,
                                        dev, cfg, holder, m12, smoke)
            if rank == 0:       # (d)'s collectives: both ranks restored
                shutil.rmtree(f"{out_dir}/ckpt", ignore_errors=True)
                served[fam] = holder["q"]
            del holder
            if fam in cfgs["b"]:
                out[(fam, "b")] = p11_phase(torch, dev, both, p16_train,
                                            torch, dev, fam, "b",
                                            cfgs["b"][fam], m21, smoke, {},
                                            out_dir)
        out["coords"] = (m12.tp_index, m21.dp_index)
    finally:
        tdist.destroy_process_group()
    if rank == 0:
        for fam, cfg in cfgs["a"].items():
            out[(fam, "d_single")] = p16_serve(torch, dev, cfg,
                                               {"q": served.pop(fam)}, None,
                                               smoke)
    torch.save(out, f"{out_dir}/rank{rank}.pt")


def p16_launcher(dev) -> tuple:
    """(e): ``python -m repro_torch.launch.train --arch SSM_ARCH --smoke
    --tp 2`` on ``dev`` (two spawned gloo ranks) in a thread beside the
    path.  Returns ``(join, stop)``: ``join()`` returns what it saw (a
    problem is in its "error"), ``stop()`` kills it if it still runs."""
    import os
    import signal
    import threading
    res: dict = {}
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           SSM_ARCH, "--smoke", "--tp", "2", "--device", dev.type,
           "--steps", "6", "--batch", "4", "--seq", "32", "--log-every", "1"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=str(SRC)),
                            cwd=str(ROOT), start_new_session=True)

    def drive():
        t0 = time.perf_counter()
        out, err = proc.communicate()
        res["wall_s"] = time.perf_counter() - t0
        lines = out.splitlines()
        losses = [float(ln.split("loss=")[1].split()[0]) for ln in lines
                  if ln.startswith("[train] step=")]
        try:
            last = json.loads(lines[-1])
        except (IndexError, ValueError):
            res["error"] = f"rc {proc.returncode}: {err[-2000:]}"
            return
        res.update(losses=losses, final=last)
        if not (proc.returncode == 0 and len(losses) == 6
                and "[train] mesh {'data': 1, 'model': 2}" in lines
                and last["mesh"] == {"data": 1, "model": 2}
                and all(math.isfinite(x) for x in losses)
                and last["final_loss"] < losses[0]):
            res["error"] = f"rc {proc.returncode}: {lines[-8:]}"

    thread = threading.Thread(target=drive, daemon=True)
    thread.start()

    def join() -> dict:
        thread.join()
        return res

    def stop() -> None:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)

    return join, stop


def p16_path(b: Bench, smoke: bool = False) -> dict:
    """Path 16: mamba2, zamba2 and seamless trained on P16_RANKS gloo
    ranks sharing the card (module docstring); returns the kernel rows of
    (d)'s launches on a rank."""
    import shutil
    import torch.multiprocessing as tmp
    t_path = time.perf_counter()
    launcher, stop = p16_launcher(b.dev)     # (e), beside the rest
    d = tempfile.mkdtemp(prefix="p16_")
    # the ranks start now: they import, join the group and warm up while
    # this process trains on one device, and wait for the card after it
    ranks_ctx = tmp.start_processes(p16_rank, args=(
        f"tcp://127.0.0.1:{free_port()}", d, str(b.dev), smoke),
        nprocs=P16_RANKS, join=False, start_method="spawn")
    try:
        return p16_gates(b, smoke, t_path, launcher, d, ranks_ctx)
    finally:        # a failed gate leaves nothing running
        stop()
        for p in ranks_ctx.processes:
            if p.is_alive():
                p.terminate()
        shutil.rmtree(d, ignore_errors=True)


def p16_gates(b: Bench, smoke: bool, t_path: float, launcher, d: str,
              ranks_ctx) -> dict:
    """The body of :func:`p16_path`: one device's gradients and steps,
    the card freed, the ranks, then their results gated, printed, held
    and timed."""
    import numpy as np
    from repro_torch.kernels import bitplane_matmul as bpm
    torch, dev, tag = b.torch, b.dev, b.tag
    cuda = dev.type == "cuda"
    cfgs = {k: p16_configs(smoke, k) for k in "ab"}
    B, S = p16_sizes(smoke)["batch"]

    # ---- one device first, each family at (a)'s and (b)'s depth, then
    # the card freed
    one = {}
    for key in "ab":
        for fam, cfg in cfgs[key].items():
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
            one[(fam, key)] = x = p16_one_device(torch, dev, fam, key, cfg,
                                                 smoke, d)
            x["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                             if cuda else 0.0)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    single_s = time.perf_counter() - t_path

    # ---- the ranks
    t0 = time.perf_counter()
    open(f"{d}/card_free", "w").close()
    while not ranks_ctx.join():
        pass
    ranks = [torch.load(f"{d}/rank{r}.pt", weights_only=False)
             for r in range(P16_RANKS)]
    ranks_s = time.perf_counter() - t0
    for r, out in enumerate(ranks):
        check(out["coords"] == (r, r), f"path 16 rank {r}: mesh coords "
              f"{out['coords']}")

    # ---- (a), (b): gradients, metrics and parameters against one device
    gaps = {}
    for fam in cfgs["a"]:
        for key, mesh_s in (("a", f"(1, {P16_RANKS}) tensor-parallel"),
                            ("b", f"({P16_RANKS}, 1) FSDP")):
            if fam not in cfgs[key]:
                continue
            cfg, ref = cfgs[key][fam], one[(fam, key)]
            label = f"path 16 ({key}) {cfg.name}"
            for r, out in enumerate(ranks):
                check(out[(fam, key)]["metrics"]
                      == ranks[0][(fam, key)]["metrics"],
                      f"{label}: rank {r}'s metrics != rank 0's")
            x = ranks[0][(fam, key)]
            worst = max(x["grad_gaps"], key=x["grad_gaps"].get)
            check(x["grad_gaps"][worst] <= P16_GRAD_TOL,
                  f"{label}: the first microbatch's gradient of {worst} "
                  f"sits {x['grad_gaps'][worst]:.4g} of its max from one "
                  f"device's (bound {P16_GRAD_TOL}; its loss "
                  f"{x['grad_loss']!r} against {ref['grad_loss']!r}); "
                  f"every leaf past it: "
                  + str({k: round(v, 4) for k, v in x["grad_gaps"].items()
                         if v > P16_GRAD_TOL}))
            mg = p12_metrics_gate(label, x["metrics"], ref["metrics"])
            pw, pm = x["param_gap"]
            pw /= ref["update"]
            pm /= TRAIN_LR
            check(pw <= P12_FLIPS * P12_STEPS and pm <= P12_PARAM_MEAN,
                  f"{label}: parameters after {P12_STEPS} steps {pw:.3g} U "
                  f"beyond a bf16 step from one device's (bound "
                  f"{P12_FLIPS * P12_STEPS}; U = {ref['update']!r}), "
                  f"mean {pm:.3g} lr (bound {P12_PARAM_MEAN})")
            for r, out in enumerate(ranks):
                y = out[(fam, key)]
                check(sum(y["shapes"].values()) == 0 and y["flash"] == 0
                      and y["off_path"] == (0, 0),
                      f"{label} rank {r}: kernels launched while training: "
                      f"{y['shapes']}, flash {y['flash']}, {y['off_path']}")
            gaps[(fam, key)] = {"grad": (worst, x["grad_gaps"][worst]),
                                "metrics": mg, "params": (pw, pm)}
            depth = (f"{cfg.n_layers} layers" + (
                f" + {cfg.n_enc_layers} encoder" if fam == "encdec" else ""))
            print(f"(16 {key}) {cfg.name} ({depth}) on {mesh_s}: "
                  f"{P12_STEPS} steps of {B} x {S + 1} tokens in "
                  f"{P12_ACCUM} microbatches: loss per step "
                  f"{[round(m['loss'], 6) for m in x['metrics']]} against "
                  f"one device's "
                  f"{[round(m['loss'], 6) for m in ref['metrics']]} "
                  f"(gaps {[{k: float(f'{v:.3g}') for k, v in g.items()} for g in mg]}"
                  f"); first gradient at 16 bits within "
                  f"{x['grad_gaps'][worst]:.4g} of a leaf's max ({worst}; "
                  f"its loss {x['grad_loss']:.6f} against "
                  f"{ref['grad_loss']:.6f}); parameters within {pw:.3g} U"
                  f" beyond a bf16 step (mean {pm:.3g} lr); step walls a "
                  f"rank " + ", ".join(
                      str([round(w, 3) for w in out[(fam, key)]["walls"]])
                      for out in ranks)
                  + f" s against one device's "
                  f"{[round(w, 3) for w in ref['walls']]} s (first "
                  f"gradient {x['grad_s']:.3f} s); peak above resident "
                  + ", ".join(f"{out[(fam, key)]['peak_gib']:.3f} GiB"
                              for out in ranks)
                  + f" (one device {ref['peak_gib']:.3f} GiB); "
                  f"collectives a step a rank (calls, bytes) "
                  f"{ {k: tuple(v) for k, v in x['step_counts'].items()} }")

    # ---- (c) the checkpoint across meshes
    ccfg = cfgs["a"][P16_CKPT_FAMILY]
    for r, out in enumerate(ranks):
        c = out["c"]
        check(c["leaves"][0] > 0 and c["leaves"][0] == c["leaves"][1],
              f"path 16 (c) {ccfg.name} rank {r}: leaves {c['leaves']}")
    c = ranks[0]["c"]
    print(f"(16 c) {ccfg.name}: (a)'s state ({c['bytes'] / 2 ** 30:.3f} "
          f"GiB, {c['leaves'][0]} leaves) saved from (1, 2) in "
          f"{c['save_s']:.3f} s, restored onto one device in "
          f"{c['one_s']:.3f} s and onto (2, 1) in {c['r21_s']:.3f} s: every "
          f"leaf EQUAL on both ranks")

    # ---- (d) the trained weights served on (1, 2)
    shapes, paths, fl_shapes = {}, {p: 0 for p in bpm.PATHS}, {}
    Bs, Ss, new = p16_sizes(smoke)["serve"]
    for fam, cfg in cfgs["a"].items():
        want = ranks[0][(fam, "d_single")]
        for r, out in enumerate(ranks):
            x = out[(fam, "d")]
            check(np.array_equal(x["tokens"], want["tokens"])
                  and np.array_equal(x["logits"], want["logits"]),
                  f"path 16 (d) {cfg.name} rank {r}: tokens "
                  f"{x['tokens'].tolist()} against one device's "
                  f"{want['tokens'].tolist()}, last-position logits max "
                  f"|diff| {np.abs(x['logits'] - want['logits']).max()}")
            needs_flash = fam != "ssm"
            want_paths = {p: 0 for p in bpm.PATHS}
            for (M, K, N, _), n_ in x["shapes"].items():
                want_paths[bpm.plan(M, K, N).path] += n_
            check(not cuda or (sum(x["shapes"].values()) > 0
                               and x["paths"] == want_paths
                               and (x["flash"] > 0) == needs_flash
                               and x["off_path"] == (0, 0)),
                  f"path 16 (d) {cfg.name} rank {r}: bit-plane "
                  f"{x['shapes']} by path {x['paths']} (plan() gives "
                  f"{want_paths}), flash {x['flash']}, int4/quant "
                  f"{x['off_path']}")
        x = ranks[0][(fam, "d")]
        for k, n_ in x["shapes"].items():
            shapes[k] = shapes.get(k, 0) + n_
        for k, n_ in x["paths"].items():
            paths[k] += n_
        for k, n_ in x["flash_shapes"].items():
            fl_shapes[k] = fl_shapes.get(k, 0) + n_
        print(f"(16 d) {cfg.name}, (a)'s trained weights quantized and "
              f"served on (1, 2): generate {Bs} x {Ss}"
              + (f" behind {Ss} frames" if fam == "encdec" else "")
              + f", {new} new, budget {p15_budget(cfg, Bs)}: tokens and "
              f"last-position logits EQUAL one device's; launches a rank: "
              f"bit-plane {sum(x['shapes'].values())}, flash {x['flash']} "
              f"at {sorted(x['flash_shapes'])}; wall "
              + " / ".join(f"{out[(fam, 'd')]['wall_s']:.3f} s"
                           for out in ranks)
              + f"; collectives rank 0 "
              f"{ {k: tuple(v) for k, v in x['collectives'].items()} }")
    check(not cuda or (sum(shapes.values()) > 0 and fl_shapes),
          "path 16 (d) launched no bit-plane or no flash kernel")

    # ---- (e) the training CLI on a tensor-parallel mesh
    la = launcher()
    check("error" not in la, f"path 16 (e) repro_torch.launch.train "
          f"--arch {SSM_ARCH} --smoke --tp 2: {la.get('error')}")
    print(f"(16 e) repro_torch.launch.train --arch {SSM_ARCH} --smoke --tp "
          f"2 on the {dev.type}, beside the path: loss "
          f"{la['losses'][0]:.4f} -> {la['final']['final_loss']:.4f} in "
          f"{len(la['losses'])} steps on {la['final']['mesh']}, "
          f"{la['wall_s']:.3f} s")

    # ---- (d)'s shapes held and timed
    bp = held_rows(b, shapes, paths, cuda)
    fl = held_flash_rows(b, fl_shapes, "path 16 (d)", cuda)
    wall = time.perf_counter() - t_path
    print(f"{tag} path 16 kernels (rank 0's (d)): bit-plane "
          f"{bp['launches']} launches at {len(shapes)} (M, K, N, planes) "
          f"(by path {paths}), each held EQUAL to the plain version, kernel "
          f"{bp['ms']:.3f} ms (device {bp['device_ms']:.3f}), bound "
          f"{bp['bound_ms']:.3f} ms, plain {bp['plain_ms']:.3f} ms, "
          f"torch._int_mm {bp['library_ms']:.3f} ms; flash "
          f"{fl['launches']} launches at {dict(sorted(fl_shapes.items()))}, "
          f"each shape held against the f32 oracle, {fl['ms']:.3f} ms "
          f"(device {fl['device_ms']:.3f}), bound {fl['bound_ms']:.3f} ms, "
          f"plain {fl['plain_ms']:.3f} ms, scaled_dot_product_attention "
          f"{fl['library_ms']:.3f} ms; no kernel launched while training")
    print(f"{tag} path 16 wall {wall:.3f} s (one device {single_s:.3f} s, "
          f"the ranks {ranks_s:.3f} s: " + ", ".join(
              f"{cfgs['a'][f].name} " + "/".join(
                  f"{ranks[0][(f, k)]['wall_s']:.1f}" if (f, k) in ranks[0]
                  else "-" for k in "abd")
              for f in cfgs["a"])
          + f" s by phase (a)/(b)/(d), (c) {c['wall_s']:.1f} s; beside the "
          f"one-device steps the "
          f"ranks' warm-up {ranks[0]['warm_s']:.3f} s and the launcher "
          f"{la['wall_s']:.3f} s)")
    return {"bitplane": bp, "flash": fl, "gaps": gaps,
            "e2e": {"wall_s": wall, "ranks_s": ranks_s,
                    "single_s": single_s}}


# ---------------------------------------------------------------------------
# Path 17: the last cache layouts on a data mesh
# ---------------------------------------------------------------------------

def p17_configs(smoke: bool) -> dict:
    """Path 17's configs: Qwen3-4B (path 3's widths, held there) cut to
    its first P17_LAYERS layers and path 15's seamless cut; SMOKE for a
    CPU rehearsal."""
    from repro_torch import configs
    if smoke:
        return {"lm": configs.get_smoke(LM_ARCH),
                "encdec": configs.get_smoke(ED_ARCH)}
    return {"lm": configs.get(LM_ARCH).with_(n_layers=P17_LAYERS),
            "encdec": p15_configs(False)["encdec"]}


def p17_sizes(smoke: bool) -> dict:
    if smoke:
        return {"prefill": 16, "max_len": 32, "chunk": 4,
                "prompts": (12, 7, 4, 10), "ragged": (12, 9, 5),
                "ragged_len": 16, "ed": (1, 8, 40, 2), "image": 32,
                "init_image": 32}
    return {"prefill": P17_PREFILL, "max_len": P17_MAX_LEN,
            "chunk": P17_PC_CHUNK, "prompts": P17_PROMPTS,
            "ragged": P17_RAGGED, "ragged_len": P17_RAGGED_LEN,
            "ed": P17_ED, "image": IMAGE, "init_image": IMAGE}


def p17_requests(cfg, sizes: dict) -> list:
    """(name, prompt, budget, draft_k, late) of (a)'s five requests: a
    miss that the prefix cache stores, a speculative one, a full hit on
    the first, a speculative partial hit (the first's first 4 chunks and
    a tail of its own), and one arriving at tick 2."""
    import numpy as np
    rng = np.random.default_rng(17)
    n_a, n_b, n_tail, n_late = sizes["prompts"]
    keep = 4 * sizes["chunk"]
    a = rng.integers(0, cfg.vocab_size, n_a).astype(np.int32)
    return [("a", a, 10.0, None, False),
            ("b", rng.integers(0, cfg.vocab_size, n_b).astype(np.int32),
             0.4, 4, False),
            ("full", a.copy(), 10.0, None, False),
            ("partial", np.concatenate(
                [a[:keep], rng.integers(0, cfg.vocab_size, n_tail)]
            ).astype(np.int32), 10.0, 4, False),
            ("late", rng.integers(0, cfg.vocab_size, n_late).astype(
                np.int32), 0.8, None, True)]


def p17_engine(torch, dev, cfg, qparams, mesh, sizes: dict) -> dict:
    """(a) on ``mesh`` (None: one device): P17_SLOTS slots, a prefix
    cache, the five requests of :func:`p17_requests`; each request's
    tokens, hit and speculative rounds, and a host copy of the pool."""
    from repro_torch.models import lm
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import ServeEngine, default_controller
    from repro_torch.serve.prefix_cache import PrefixCache
    eng = ServeEngine(cfg, qparams, max_len=sizes["max_len"],
                      n_slots=P17_SLOTS, prefill_len=sizes["prefill"],
                      decode_block=2, device=dev, mesh=mesh,
                      controller=default_controller(lm.n_bit_slots(cfg)),
                      prefix_cache=PrefixCache(chunk=sizes["chunk"],
                                               capacity=4))
    rids = {}

    def submit(name, prompt, budget, k):
        rids[name] = eng.submit(prompt, max_new_tokens=P17_NEW,
                                budget_s=budget, draft_k=k)

    for name, prompt, budget, k, late in p17_requests(cfg, sizes):
        if late:
            eng.submit_at(2, lambda a=(name, prompt, budget, k): submit(*a))
        else:
            submit(name, prompt, budget, k)
    eng.run()
    recs = {n: eng.requests[r] for n, r in rids.items()}
    out = {"tokens": {n: list(r.tokens) for n, r in recs.items()},
           "hits": {n: r.cache_hit for n, r in recs.items()},
           "rounds": {n: r.spec_rounds for n, r in recs.items()},
           "pool": p15_host(eng.pool.cache), "rows": eng._rows,
           "seq": tf.seq_sharded(eng.pool.cache), "calls": dict(eng.calls)}
    del eng
    return out


def p17_gaps(torch, dev, cfg, qparams, sizes: dict, names) -> dict:
    """The requests of (a) named in ``names`` (those whose mesh tokens
    differ from one device's) each alone on one device
    (``cb_standalone``): the top-2 logit gap of each of its steps, for
    ``tokens_agree``."""
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine, default_controller
    reqs = [r for r in p17_requests(cfg, sizes) if r[0] in names]
    if not reqs:
        return {}
    eng = ServeEngine(cfg, qparams, max_len=sizes["max_len"], device=dev,
                      controller=default_controller(lm.n_bit_slots(cfg)))
    out = {n: cb_standalone(eng, p, P17_NEW, budget, sizes["prefill"])
           for n, p, budget, _, _ in reqs}
    del eng
    return out


def p17_direct(torch, dev, cfg, qparams, mesh, sizes: dict) -> dict:
    """(a)'s direct calls on ``mesh`` (None: one device), every row's
    bits 8: ``lm.prefill`` of B = 3 ragged rows (lengths P17_RAGGED) into
    a fresh cache (sequence-sharded on the mesh), then one U =
    P17_CHUNK_U ``lm.decode_chunk`` at each row's next positions; both
    calls' logits, and a host copy of the cache after prefill."""
    import numpy as np
    from repro_torch.dist import api as dapi
    from repro_torch.models import lm
    lens = sizes["ragged"]
    B, S = len(lens), sizes["ragged_len"]
    rng = np.random.default_rng(170)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)).to(dev)
    chunk = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, P17_CHUNK_U)).astype(np.int32)).to(dev)
    bits = torch.full((B, lm.n_bit_slots(cfg)), 8, dtype=torch.int32,
                      device=dev)
    ctx = dapi.use_mesh(mesh) if mesh is not None else None
    if ctx is not None:
        ctx.__enter__()
    try:
        cache = lm.empty_cache(cfg, B, S + P17_CHUNK_U, device=dev,
                               mesh=mesh)
        pre, cache = lm.prefill(qparams, {"tokens": toks}, cfg, bits, bits,
                                cache, lengths=torch.tensor(lens).to(dev))
        after = p15_host(cache)
        ver, _ = lm.decode_chunk(qparams, chunk, torch.tensor(lens).to(dev),
                                 cache, cfg, bits, bits)
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)
    return {"prefill": pre.float().cpu().numpy(),
            "chunk": ver.float().cpu().numpy(), "cache": after}


def p17_counts(torch, dev, cfg, qparams, mesh, sizes: dict) -> dict:
    """(a)'s int8 collectives: ``dryrun.serve_run`` of one B = 1 prompt of
    P17_PREFILL tokens and one decode step on the int8 cache
    (sequence-sharded), whose ``Mesh.counts`` ``p11_phase`` records."""
    from repro_torch.launch import dryrun
    toks = torch.zeros((1, sizes["prefill"]), dtype=torch.int32, device=dev)
    dryrun.serve_run(cfg, mesh, qparams, toks, steps=1,
                     max_len=sizes["max_len"])
    return {}


def p17_ed_batch(cfg, sizes: dict) -> dict:
    import numpy as np
    B, F, S, _ = sizes["ed"]
    rng = np.random.default_rng(171)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                np.int32),
            "frames": rng.standard_normal((B, F, cfg.d_model)).astype(
                np.float32)}


def p17_cnn(torch, dev, mesh, sizes: dict) -> dict:
    """(c): ResNet18, a batch of P17_CNN images (path 1's first ones) on
    ``mesh`` (None: one device), FSDP weights, no plan."""
    from repro_torch.core.policy import cnn_budget_controller
    from repro_torch.models import cnn
    from repro_torch.serve.cnn import CNNServeEngine
    params, layers = cnn.init_cnn("resnet18", torch.Generator().manual_seed(0),
                                  image=sizes["init_image"], device=dev)
    ctrl = cnn_budget_controller("resnet18", layers=layers)
    images, budgets = cnn_inputs(torch, dev, ctrl, P17_CNN, sizes["image"])
    eng = CNNServeEngine(params, layers, controller=ctrl, max_batch=P17_CNN,
                         device=dev, mesh=mesh)
    logits = eng.serve(images, budgets)[0]
    out = {"logits": logits, "rows": eng._rows}
    del eng, params
    return out


def p17_rank(rank: int, init_method: str, out_dir: str, device: str,
             smoke: bool) -> None:
    """One rank of path 17 on ``device``: a (2, 1) mesh; the weights drawn
    once; (a) the engine on the bf16 and the int8 cache, the direct calls
    on both, the int8 collectives, (b) seamless at B = 1, (c) ResNet18 at
    an odd batch, each a phase (``p11_phase``); then on rank 0 the same
    on one device."""
    import datetime
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as tdist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.models import transformer as tf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if smoke:
        tf.FLASH_THRESHOLD = P15_SMOKE_FLASH
    sizes = p17_sizes(smoke)
    cfgs = p17_configs(smoke)
    cfg = cfgs["lm"]
    kv8 = cfg.with_(kv_cache_bits=8)
    q = lm.init_serve_params(cfg, torch.Generator(device=dev).manual_seed(
        17), device=dev)
    q_ed = p15_weights(torch, dev, cfgs["encdec"])
    ed_batch = p17_ed_batch(cfgs["encdec"], sizes)
    new_ed = sizes["ed"][3]
    tdist.init_process_group(
        "gloo", init_method=init_method, rank=rank, world_size=P17_RANKS,
        timeout=datetime.timedelta(seconds=SO_TIMEOUT_S))
    out = {}
    try:
        m21 = make_host_mesh(model=1)
        both = (m21,)
        for kv, c in ((0, cfg), (8, kv8)):
            out[("engine", kv)] = p11_phase(torch, dev, both, p17_engine,
                                            torch, dev, c, q, m21, sizes)
            out[("direct", kv)] = p11_phase(torch, dev, both, p17_direct,
                                            torch, dev, c, q, m21, sizes)
        out["counts"] = p11_phase(torch, dev, both, p17_counts, torch, dev,
                                  kv8, q, m21, sizes)
        out["ed"] = p11_phase(torch, dev, both, p15_serve, torch, dev,
                              cfgs["encdec"], q_ed, ed_batch, new_ed, m21)
        out["cnn"] = p11_phase(torch, dev, both, p17_cnn, torch, dev, m21,
                               sizes)
        out["dp_index"] = m21.dp_index
    finally:
        tdist.destroy_process_group()
    if rank == 0:                      # one device, the same weights
        t0 = time.perf_counter()
        for kv, c in ((0, cfg), (8, kv8)):
            out[("engine_one", kv)] = p17_engine(torch, dev, c, q, None,
                                                 sizes)
            out[("direct_one", kv)] = p17_direct(torch, dev, c, q, None,
                                                 sizes)
            mine = out[("engine", kv)]["tokens"]
            out[("gaps", kv)] = p17_gaps(
                torch, dev, c, q, sizes,
                [n for n, t in out[("engine_one", kv)]["tokens"].items()
                 if mine[n] != t])
        out["ed_one"] = p15_serve(torch, dev, cfgs["encdec"], q_ed, ed_batch,
                                  new_ed, None)
        out["cnn_one"] = p17_cnn(torch, dev, None, sizes)
        out["one_s"] = time.perf_counter() - t0
    torch.save(out, f"{out_dir}/rank{rank}.pt")


def p17_blocks(torch, label: str, got: dict, whole: dict, r: int) -> int:
    """A rank's sequence-sharded cache (a tree) against its block of one
    device's: every leaf whose length differs is the rank's slice of dim 2
    (the ring, the cross cache's frames), EQUAL; the rest (``kpos``)
    EQUAL whole.  Returns the leaves held."""
    n = 0
    for k, w in whole.items():
        g = got[k]
        if isinstance(w, dict):
            n += p17_blocks(torch, f"{label}/{k}", g, w, r)
            continue
        if g.shape != w.shape:
            m = g.shape[2]
            check(m * P17_RANKS == w.shape[2], f"{label}/{k}: {tuple(g.shape)}"
                  f" is not a {P17_RANKS}-way slice of {tuple(w.shape)}")
            w = w[:, :, r * m:(r + 1) * m]
        check(torch.equal(g, w), f"{label}/{k} rank {r}: not one device's "
              f"block (max |diff| "
              f"{(g.float() - w.float()).abs().max().item():.6g})")
        n += 1
    return n


def p17_pool_gate(torch, label: str, got: dict, whole: dict, r: int,
                  kv: int) -> dict:
    """(a)'s pool after the run against its block of one device's: kpos
    EQUAL; the k/v values the pool holds (on the int8 cache its codes
    times their per-(token, head) scales) EQUAL at layer 0, and at a
    later layer EQUAL or within P17_POOL_TOL[kv] x the leaf's max |value|
    (a decode step's softmax combined in another f32 order).  Returns
    each leaf's elements apart and its largest gap per layer over the
    leaf's max |value|."""
    check(torch.equal(got["kpos"], whole["kpos"]),
          f"{label} rank {r}: pool kpos != one device's")
    mine = {}
    for k, w in whole.items():
        if k == "kpos":
            continue
        m = got[k].shape[2]
        check(m * P17_RANKS == w.shape[2], f"{label}: pool {k} "
              f"{tuple(got[k].shape)} is not a slice of {tuple(w.shape)}")
        mine[k] = w[:, :, r * m:(r + 1) * m]

    def held(c, k):
        t = c[k].float()
        return t * c[k + "s"].float()[..., None] if k + "s" in c else t

    apart = {}
    for k in ("k", "v"):
        g, w = held(got, k), held(mine, k)
        d = (g - w).abs()
        top = w.abs().max().item()
        per_layer = [round(x / top, 6) for x in
                     d.flatten(1).amax(dim=1).tolist()]
        check(per_layer[0] == 0 and max(per_layer) <= P17_POOL_TOL[kv],
              f"{label} rank {r}: pool {k} gaps by layer over max|value| "
              f"{per_layer} (layer 0 must be 0, the rest at most "
              f"{P17_POOL_TOL[kv]})")
        if max(per_layer) > 0:
            apart[k] = (int((d > 0).sum()), per_layer)
    return apart


def p17_path(b: Bench, smoke: bool = False) -> dict:
    """Path 17: the sequence-sharded slot pool (bf16 and int8), its
    direct calls, seamless's frame-split cross cache and an odd ResNet18
    batch on P17_RANKS gloo ranks sharing the card (module docstring);
    returns the kernel rows of rank 0's launches."""
    torch, dev, tag = b.torch, b.dev, b.tag
    import tempfile
    import numpy as np
    import torch.multiprocessing as tmp
    from repro_torch.kernels import bitplane_matmul as bpm
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as tf
    t_path = time.perf_counter()
    cuda = dev.type == "cuda"
    sizes = p17_sizes(smoke)
    cfgs = p17_configs(smoke)
    cfg, ed = cfgs["lm"], cfgs["encdec"]
    prev = tf.FLASH_THRESHOLD
    if smoke:
        tf.FLASH_THRESHOLD = P15_SMOKE_FLASH
    try:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            ctx = tmp.start_processes(p17_rank, args=(
                f"tcp://127.0.0.1:{free_port()}", d, str(dev), smoke),
                nprocs=P17_RANKS, join=False, start_method="spawn")
            # beside the ranks: the int8 phase's collectives on a
            # RecordingMesh (host only, fake tensors)
            t1 = time.perf_counter()
            pred = dryrun.predict_counts(
                cfg.with_(kv_cache_bits=8), (P17_RANKS, 1), batch=1,
                prompt=sizes["prefill"], steps=1, max_len=sizes["max_len"])
            pred_s = time.perf_counter() - t1
            while not ctx.join():
                pass
            ranks = [torch.load(f"{d}/rank{r}.pt", weights_only=False)
                     for r in range(P17_RANKS)]
        ranks_s = time.perf_counter() - t0
    finally:
        tf.FLASH_THRESHOLD = prev
    one = ranks[0]
    for r, out in enumerate(ranks):
        check(out["dp_index"] == r, f"path 17 rank {r}: data index "
              f"{out['dp_index']}")
    V = cfg.vocab_size

    # ---- (a) the continuous engine on the sequence-sharded pool
    summary = {}
    for kv in (0, 8):
        want = one[("engine_one", kv)]
        gaps = one[("gaps", kv)]
        label = f"(17 a) {'int8' if kv else 'bf16'} cache"
        check(want["hits"] == {"a": "", "b": "", "full": "full",
                               "partial": "partial", "late": ""}
              and want["rounds"]["b"] > 0 and want["rounds"]["partial"] > 0,
              f"{label}: one device's hits {want['hits']}, rounds "
              f"{want['rounds']}")
        exact, apart = True, {}
        for r, out in enumerate(ranks):
            got = out[("engine", kv)]
            check(got["rows"] is None and got["seq"],
                  f"{label} rank {r}: rows {got['rows']}, sequence-sharded "
                  f"{got['seq']}")
            check(got["hits"] == want["hits"]
                  and got["calls"] == want["calls"],
                  f"{label} rank {r}: hits {got['hits']} calls "
                  f"{got['calls']} != one device's {want['hits']} "
                  f"{want['calls']}")
            check(got["tokens"] == ranks[0][("engine", kv)]["tokens"],
                  f"{label}: rank {r}'s tokens != rank 0's")
            for n, toks in want["tokens"].items():
                _, ok = tokens_agree(f"{label} rank {r} {n}",
                                     got["tokens"][n], toks,
                                     gaps.get(n, (None, []))[1])
                exact &= ok
            if exact:
                apart[r] = p17_pool_gate(torch, label, got["pool"],
                                         want["pool"], r, kv)
        x0 = ranks[0][("engine", kv)]
        check(not cuda or (sum(x0["shapes"].values()) > 0
                           and x0["off_path"] == (0, 0)),
              f"{label}: bit-plane {sum(x0['shapes'].values())}, "
              f"int4/quant {x0['off_path']}")
        summary[kv] = (exact, apart)
        print(f"{label}: {cfg.name} ({cfg.n_layers} layers) on "
              f"({P17_RANKS}, 1), FSDP weights, {P17_SLOTS} slots (no row "
              f"split: every rank holds every slot, "
              f"{sizes['max_len'] // P17_RANKS} of {sizes['max_len']} "
              f"ring slots each), prefill_len {sizes['prefill']}, "
              f"{len(want['tokens'])} requests of "
              f"{[len(p[1]) for p in p17_requests(cfg, sizes)]} tokens, "
              f"{P17_NEW} new: hits {want['hits']}, speculative rounds "
              f"{want['rounds']}, calls {want['calls']}; tokens "
              + ("EQUAL one device's" if exact else "agree up to a near-tie")
              + f"; pool after the run "
              + ("EQUAL one device's blocks" if exact and not any(
                  apart.values()) else f"(elements apart, the largest "
                  f"gap a layer over the leaf's max |value|) by rank "
                  f"{apart}")
              + f"; launches rank 0: bit-plane "
              f"{sum(x0['shapes'].values())}; wall "
              + " / ".join(f"{o[('engine', kv)]['wall_s']:.3f} s"
                           for o in ranks)
              + f"; collectives rank 0 "
              f"{ {k: tuple(v) for k, v in x0['collectives'].items()} }")

    # ---- (a) the direct calls: ragged prefill and a U-token chunk
    for kv in (0, 8):
        want = one[("direct_one", kv)]
        label = f"(17 a) direct, {'int8' if kv else 'bf16'} cache"
        w = want["chunk"][..., :V]
        top = float(np.abs(w).max())
        w2 = np.sort(w, axis=-1)[..., -2:]
        near = (w2[..., 1] - w2[..., 0]) / top < LOGIT_TOL   # (B, U)
        gap, parted = 0.0, 0
        for r, out in enumerate(ranks):
            got = out[("direct", kv)]
            check(np.array_equal(got["prefill"], want["prefill"]),
                  f"{label} rank {r}: ragged prefill logits max |diff| "
                  f"{np.abs(got['prefill'] - want['prefill']).max()}")
            p17_blocks(torch, f"{label} cache", got["cache"], want["cache"],
                       r)
            g = got["chunk"][..., :V]
            apart = g.argmax(-1) != w.argmax(-1)
            check(not (apart & ~near).any(),
                  f"{label} rank {r}: the chunk's greedy tokens "
                  f"{g.argmax(-1).tolist()} part from one device's "
                  f"{w.argmax(-1).tolist()} where its top-2 gap is not "
                  f"under {LOGIT_TOL} x max|logit|")
            gap = max(gap, float(np.abs(g - w).max()) / top)
            parted = max(parted, int(apart.sum()))
        print(f"{label}: lm.prefill of B = {len(sizes['ragged'])} rows of "
              f"lengths {sizes['ragged']} on the sequence-sharded cache: "
              f"logits EQUAL one device's, the cache after it EQUAL its "
              f"blocks; lm.decode_chunk U = {P17_CHUNK_U} at each row's "
              f"next positions: greedy tokens as one device's "
              f"({parted} of {near.size} part, at near-ties only: "
              f"{int(near.sum())} near-ties), logits max |diff| {gap:.6g} "
              f"x max|logit| ({top:.6g}); wall "
              + " / ".join(f"{o[('direct', kv)]['wall_s']:.3f} s"
                           for o in ranks))

    # ---- (a) one int8 prefill and decode step's collectives
    for r, out in enumerate(ranks):
        got = {k: list(v) for k, v in out["counts"]["collectives"].items()}
        check(got == pred, f"(17 a) rank {r}: int8 collectives {got} != "
              f"the RecordingMesh's {pred}")
        check(got.get("seq_pmax", [0])[0] == cfg.n_layers,
              f"(17 a) rank {r}: seq_pmax {got.get('seq_pmax')}")
    print(f"(17 a) int8 cache, B = 1: a {sizes['prefill']}-token prefill "
          f"and one decode step (dryrun.serve_run): each rank's collectives "
          f"EQUAL a RecordingMesh's {pred} (predicted beside the ranks in "
          f"{pred_s:.3f} s)")

    # ---- (b) seamless at B = 1: the cross cache's frames split
    want = one["ed_one"]
    B, F, S, new = sizes["ed"]
    for r, out in enumerate(ranks):
        got = out["ed"]
        check(np.array_equal(got["tokens"], want["tokens"])
              and np.array_equal(got["logits"], want["logits"]),
              f"(17 b) rank {r}: tokens {got['tokens'].tolist()} against "
              f"{want['tokens'].tolist()}, prefill logits max |diff| "
              f"{np.abs(got['logits'] - want['logits']).max()}")
        check(got["rows"] is None and got["cache"]["cross"]["k"].shape[2]
              * P17_RANKS == F, f"(17 b) rank {r}: rows {got['rows']}, "
              f"cross cache {tuple(got['cache']['cross']['k'].shape)}")
        p17_blocks(torch, "(17 b) cache", got["cache"], want["cache"], r)
        check(not cuda or (got["flash"] > 0 and got["off_path"] == (0, 0)),
              f"(17 b) rank {r}: flash {got['flash']}, int4/quant "
              f"{got['off_path']}")
    x0 = ranks[0]["ed"]
    print(f"(17 b) {ed.name} ({ed.n_enc_layers} + {ed.n_layers} layers) "
          f"on ({P17_RANKS}, 1), B = {B}: generate {S} tokens behind {F} "
          f"frames, {new} new: the cross cache keeps "
          f"{F // P17_RANKS} of {F} frames a rank, tokens and prefill "
          f"logits EQUAL one device's, the cache after prefill EQUAL its "
          f"blocks; launches rank 0: bit-plane "
          f"{sum(x0['shapes'].values())}, flash {x0['flash']} at "
          f"{sorted(x0['flash_shapes'])}; wall "
          + " / ".join(f"{o['ed']['wall_s']:.3f} s" for o in ranks))

    # ---- (c) an odd ResNet18 batch
    want = one["cnn_one"]
    for r, out in enumerate(ranks):
        got = out["cnn"]
        check(got["rows"] is None and np.array_equal(got["logits"],
                                                     want["logits"]),
              f"(17 c) rank {r}: rows {got['rows']}, logits max |diff| "
              f"{np.abs(got['logits'] - want['logits']).max()}")
    print(f"(17 c) ResNet18@{sizes['image']}, a batch of {P17_CNN} on "
          f"({P17_RANKS}, 1): every rank computes every image, logits "
          f"EQUAL one device's; wall "
          + " / ".join(f"{o['cnn']['wall_s']:.3f} s" for o in ranks))

    # ---- every shape rank 0 launched: held and timed
    shapes, paths, fl_shapes = {}, {p: 0 for p in bpm.PATHS}, {}
    keys = [("engine", 0), ("direct", 0), ("engine", 8), ("direct", 8),
            "counts", "ed", "cnn"]
    for key in keys:
        x = one[key]
        for k, n in x["shapes"].items():
            shapes[k] = shapes.get(k, 0) + n
        for k, n in x["paths"].items():
            paths[k] += n
    for k, n in one["ed"]["flash_shapes"].items():
        fl_shapes[k] = fl_shapes.get(k, 0) + n
    check(not cuda or (sum(shapes.values()) > 0 and fl_shapes),
          "path 17 launched no bit-plane or no flash kernel")
    check(not cuda or sum(fl_shapes.values()) == one["ed"]["flash"],
          f"path 17: flash launches {one['ed']['flash']} against the "
          f"shapes counted {fl_shapes}")
    bp = held_rows(b, shapes, paths, cuda)
    fl = held_flash_rows(b, fl_shapes, "path 17", cuda)
    wall = time.perf_counter() - t_path
    print(f"{tag} path 17 kernels (rank 0's phases): bit-plane "
          f"{bp['launches']} launches at {len(shapes)} (M, K, N, planes) "
          f"(by path {paths}), each held EQUAL to the plain version, kernel "
          f"{bp['ms']:.3f} ms (device {bp['device_ms']:.3f}), bound "
          f"{bp['bound_ms']:.3f} ms, plain {bp['plain_ms']:.3f} ms, "
          f"torch._int_mm {bp['library_ms']:.3f} ms (device "
          f"{bp['library_device_ms']:.3f}); flash "
          f"{fl['launches']} launches at {dict(sorted(fl_shapes.items()))}, "
          f"each shape held against the f32 oracle, {fl['ms']:.3f} ms "
          f"(device {fl['device_ms']:.3f}), bound {fl['bound_ms']:.3f} ms, "
          f"plain {fl['plain_ms']:.3f} ms, scaled_dot_product_attention "
          f"{fl['library_ms']:.3f} ms")
    walls = {k if isinstance(k, str) else f"{k[0]} {k[1]}":
             round(one[k]["wall_s"], 3) for k in keys}
    print(f"{tag} path 17 wall {wall:.3f} s (the ranks {ranks_s:.3f} s, "
          f"rank 0's phases {walls}, its one-device side "
          f"{one['one_s']:.3f} s)")
    return {"bitplane": bp, "flash": fl, "summary": summary,
            "e2e": {"wall_s": wall, "ranks_s": ranks_s}}


def ptxas_summary(log: str):
    """One line per kernel entry of an ``nvcc -Xptxas -v`` report (its
    registers, static shared memory and spills), and any warning."""
    import re

    def kernel_name(mangled):
        # the shortest <length><name> ending in _kernel, then its template
        # arguments (ints, f32 "f", bf16)
        for m in re.finditer(r"_kernel", mangled):
            end = m.end()
            for start in range(m.start() - 1, 0, -1):
                digits = str(end - start)
                if mangled[start].isalpha() and \
                        mangled[start - len(digits):start] == digits:
                    name = mangled[start:end]
                    args = re.match(r"I((?:Li-?\d+E|f|13__nv_bfloat16)+)E",
                                    mangled[end:])
                    if not args:
                        return name
                    toks = re.findall(r"Li(-?\d+)E|(f)|13__nv_(bfloat16)",
                                      args.group(1))
                    vals = [i or ("f32" if f else "bf16") for i, f, _ in toks]
                    return f"{name}<{','.join(vals)}>"
        return mangled

    entry, spill = None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = kernel_name(m.group(1))
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and entry:
            used = line.split("Used", 1)[1].strip()
            yield f"{entry}: used {used}; {spill}"
            entry = None
        elif "warning" in line:
            yield line.strip()


ROW_KEYS = ("launches", "ms", "plain_ms", "bound_ms", "library_ms")


def kernel_row(name, source, replaces, err, parts) -> dict:
    """One kernel's entry of the JSON line, summed over its paths' units
    of work (``parts``: path name -> that path's numbers)."""
    tot = {k: sum(p[k] for p in parts.values()) for k in ROW_KEYS}
    dev = ([p["device_ms"] for p in parts.values() if "device_ms" in p]
           if all("device_ms" in p for p in parts.values()) else [])
    t_bytes = sum(p["t_bytes"] for p in parts.values())
    t_ops = sum(p["t_ops"] for p in parts.values())
    out = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": tot["launches"],
           "max_abs_err": err, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
           "bound_ms": tot["bound_ms"],
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": tot["library_ms"]}
    if dev:
        out["device_ms"] = sum(dev)
    if all("library_device_ms" in p for p in parts.values()):
        out["library_device_ms"] = sum(p["library_device_ms"]
                                        for p in parts.values())
    if len(parts) == 1 and "paths" in next(iter(parts.values())):
        out["paths"] = next(iter(parts.values()))["paths"]
    if len(parts) > 1:
        out["per_path"] = {n: {k: p[k] for k in ROW_KEYS
                               + ("device_ms", "library_device_ms", "paths")
                               if k in p}
                           for n, p in parts.items()}
    return out


def main() -> None:
    t_start = time.perf_counter()
    sys.stdout.reconfigure(line_buffering=True)   # progress survives a cut
    if not (SRC / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script measures the "
             "port on a GPU")
    hardware()
    from repro_torch.kernels import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 1. the card
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")
    b = Bench(torch, dev, f"[{card}]")

    # ---- 2. build the kernels, one nvcc each, together
    t0 = time.perf_counter()
    cuda_build.build(KERNELS)
    for name in KERNELS:
        cuda_build.load(name)
    print(f"build: {', '.join(KERNELS)} in {time.perf_counter() - t0:.3f} s "
          f"(nvcc " + ", ".join(
              f"{n} {cuda_build.build_seconds.get(n, 0.0):.3f} s"
              for n in KERNELS) + ")")
    for name in KERNELS:        # registers, shared memory and spills
        seen: dict = {}          # one line per entry and report
        for line in ptxas_summary(cuda_build.ptxas_log.get(name, "")):
            entry, _, report = line.partition(": ")
            base, _, args = entry.partition("<")
            seen.setdefault((base, report), []).append(args.rstrip(">"))
        for (base, report), args in seen.items():
            inst = [a for a in args if a]
            print(f"ptxas {name}: {base}"
                  + (f" <{' | '.join(inst)}>" if inst else "")
                  + f": {report}")

    # ---- 3. kernels against their plain versions on edge shapes
    for n in range(1, 9):
        for M, K, N in EDGE_SHAPES:
            b.hold_bitplane(b.rand_i8((M, K)), b.rand_i8((K, N)), n)
    print(f"kernel == plain: n_planes 1..8 on {len(EDGE_SHAPES)} edge shapes")
    cases = flash_cases()
    for case in cases:
        hold_flash(b, *case)
    path_err = hold_flash(b, *FLASH_PATH[:2], FLASH_PATH[1], FLASH_PATH[2],
                          True, 0)
    print(f"flash kernel vs f32 oracle: {len(cases)} edge cases and the "
          f"path shape {FLASH_PATH} causal; max |err| {b.fa_err:.6g} "
          f"(path shape {path_err:.6g}), tolerance {FLASH_TOL}")
    for M, K, N in INT4_EDGE:
        for od in (torch.float32, torch.bfloat16):
            b.hold_int4(b.rand_i8((M, K)), b.rand_u8((K, N // 2)),
                        b.rand_scale(N), od)
    print(f"int4 kernel == plain: {len(INT4_EDGE)} edge shapes (M in "
          f"{{1, 16, 130}}, K in {{1, 17, 363}}, N in {{2, 96, 130, 1000}}) "
          f"x f32 and bf16 out")
    for M, K, N in EDGE_SHAPES:
        for act in ("none", "relu", "silu", "gelu"):
            for od in (torch.float32, torch.bfloat16):
                b.hold_quant(b.rand_i8((M, K)), b.rand_i8((K, N)),
                             b.rand_scale(N), b.rand_scale(N) - 0.02, act,
                             od)
    print(f"quant kernel vs plain: {len(EDGE_SHAPES)} edge shapes x 4 acts "
          f"x f32 and bf16 out; none and relu equal, silu and gelu max "
          f"|err| {b.q_err:.6g} within {QUANT_TOL} x (1 + |plain|)")

    # ---- 4.-20. the seventeen paths (a development run may pick some
    # with --paths 1,4; only a run of all seventeen prints the result
    # lines)
    every = set(range(1, 18))
    picked = every
    if "--paths" in sys.argv:
        picked = {int(x) for x in
                  sys.argv[sys.argv.index("--paths") + 1].split(",")}
    if picked != every:
        t_paths = time.perf_counter()
        if 1 in picked:
            cnn_path(b)
        if 2 in picked:
            alexnet_path(b)
        if picked & {3, 4, 5, 6, 13, 14}:
            cfg, qparams = lm_weights(b)
            if 3 in picked:
                lm_path(b, cfg, qparams)
            cbr = cb_path(b, cfg, qparams) if 4 in picked else None
            if 5 in picked:
                pc_path(b, *lm_cut(cfg, qparams, PC_LAYERS))
            if 6 in picked:
                so_path(b, cfg, qparams, cb_ref=cbr)
            if 13 in picked:
                p13_path(b, cfg, qparams,
                         known=cbr["per_shape"] if cbr else None)
            if 14 in picked:
                p14_path(b, cfg, qparams)
            del qparams
            torch.cuda.empty_cache()
        if 7 in picked:
            moe_path(b)
            vlm_path(b)
        if 8 in picked:
            p8_path(b)
        if 9 in picked:
            with tempfile.TemporaryDirectory(prefix="train_ckpt_") \
                    as ckpt_dir:
                train_path(b, ckpt_dir)
        if 10 in picked:
            t0 = time.perf_counter()
            p10_path(b)
            print(f"{b.tag} path 10 wall {time.perf_counter() - t0:.3f} s")
        if 11 in picked:
            p11_path(b)
        if 12 in picked:
            p12_path(b)
        if 15 in picked:
            p15_path(b)
        if 16 in picked:
            p16_path(b)
        if 17 in picked:
            p17_path(b)
        print(card)
        print(f"paths {sorted(picked)} passed in "
              f"{time.perf_counter() - t_paths:.3f} s; no result line for "
              f"a partial run")
        return
    walls = {"before the paths": time.perf_counter() - t_start}
    analysis = p13_analysis(dev)        # path 13 (a), beside paths 1-6

    def timed(label, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        walls[label] = time.perf_counter() - t0
        return out

    cnn = timed("1", cnn_path, b)
    alex = timed("2", alexnet_path, b)
    cfg, qparams = lm_weights(b)
    lmr = timed("3", lm_path, b, cfg, qparams)
    cbr = timed("4", cb_path, b, cfg, qparams)
    pcr = timed("5", pc_path, b, *lm_cut(cfg, qparams, PC_LAYERS))
    sor = timed("6", so_path, b, cfg, qparams, cnn_ref=cnn, cb_ref=cbr)
    p13r = timed("13", p13_path, b, cfg, qparams,
                 known={**cbr["per_shape"], **cnn["per_shape"]},
                 analysis=analysis)
    p14r = timed("14 (a)", p14_path, b, cfg, qparams)
    del qparams                 # path 7 needs the card's memory
    torch.cuda.empty_cache()
    moer = timed("7 (a)", moe_path, b)
    vlmr = timed("7 (b, c)", vlm_path, b)
    p8r = timed("8", p8_path, b)
    with tempfile.TemporaryDirectory(prefix="train_ckpt_") as ckpt_dir:
        p9r = timed("9", train_path, b, ckpt_dir)
    p10r = timed("10", p10_path, b)
    p11r = timed("11", p11_path, b, cnn_ref=cnn)
    p12r = timed("12", p12_path, b)
    p15r = timed("15", p15_path, b)
    p16r = timed("16", p16_path, b)
    p17r = timed("17", p17_path, b)
    print(f"{b.tag} walls: " + ", ".join(
        f"{k if not k[0].isdigit() else 'path ' + k} {v:.3f} s"
        for k, v in walls.items())
        + f"; the script so far {time.perf_counter() - t_start:.3f} s")
    # the spike replays pad every batch to BATCH images: path 1's shapes
    nb = pcr["cnn"]["batches"]
    spike = {k: cnn[k] * nb for k in ("ms", "plain_ms", "bound_ms",
                                      "library_ms", "t_bytes", "t_ops",
                                      "device_ms", "library_device_ms")}
    spike.update(launches=pcr["cnn"]["launches"], paths=pcr["cnn"]["paths"])

    bp_paths = {"resnet18_served_batch": cnn,
                "alexnet_served_batch": alex["bitplane_served_batch"],
                "alexnet_int4_forward": alex["bitplane_int4_forward"],
                "qwen3_4b_generate_call": lmr["bitplane"],
                "qwen3_4b_continuous_and_speculative_runs": cbr["bitplane"],
                "qwen3_4b_prefix_cache_and_closed_loop": pcr["bitplane"],
                "resnet18_spike_replays": spike,
                "two_ranks_and_co_decision": sor["bitplane"],
                "moonshot_generate_calls": moer["bitplane"],
                "internvl2_generate_calls": vlmr["bitplane"],
                "mamba2_generate_call": p8r["ssm"]["bitplane"],
                "zamba2_generate_call": p8r["hybrid"]["bitplane"],
                "seamless_generate_call": p8r["encdec"]["bitplane"],
                "stablelm_generate_call": p8r["dense"]["bitplane"],
                "qwen3_4b_trained_generate_call": p9r["bitplane"],
                "qwen3_4b_serve_cli_runs": p10r["bitplane"],
                "tensor_and_expert_parallel_rank": p11r["bitplane"],
                "sequence_sharded_rank": p11r["bitplane_f"],
                "trained_tensor_parallel_serve_rank": p12r["bitplane"],
                "qwen3_4b_analysis_audit": p13r["bitplane_b"],
                "resnet18_hawq_analysis_audit": p13r["bitplane_c"],
                "qwen3_4b_lowering_report_calls": p14r["bitplane"],
                "recurrent_and_encdec_mesh_rank": p15r["bitplane"],
                "recurrent_and_encdec_trained_serve_rank":
                    p16r["bitplane"],
                "sequence_sharded_pool_and_frames_rank": p17r["bitplane"]}
    fl_paths = {"qwen3_4b_generate_call": lmr["flash"],
                "moonshot_generate_calls": moer["flash"],
                "internvl2_generate_calls": vlmr["flash"],
                "zamba2_generate_call": p8r["hybrid"]["flash"],
                "seamless_generate_call": p8r["encdec"]["flash"],
                "stablelm_generate_call": p8r["dense"]["flash"],
                "qwen3_4b_serve_cli_batch_run": p10r["flash"],
                "qwen3_4b_tensor_parallel_rank": p11r["flash"],
                "qwen3_4b_analysis_generate": p13r["flash"],
                "qwen3_4b_sequence_sharded_rank": p11r["flash_f"],
                "qwen3_4b_lowering_report_prefill": p14r["flash"],
                "zamba2_and_seamless_mesh_rank": p15r["flash"],
                "zamba2_and_seamless_trained_serve_rank": p16r["flash"],
                "seamless_frame_split_rank": p17r["flash"]}
    summary = {"kernels": [
        kernel_row("bitplane_matmul", KERNEL_SOURCE, REPLACES, b.bp_err, bp_paths),
        kernel_row("flash_attention", FLASH_SOURCE, FLASH_REPLACES, b.fa_err,
                   fl_paths),
        kernel_row("int4_matmul", INT4_SOURCE, INT4_REPLACES, b.i4_err,
            {"alexnet_int4_forward": alex["int4"]}),
        kernel_row("quant_matmul", QUANT_SOURCE, QUANT_REPLACES, b.q_err,
            {"alexnet_forward_gemms": alex["quant"]})]}
    e2e = lmr["e2e"]
    print(f"{b.tag} end to end (no gain claimed): ResNet18 "
          f"{cnn['wall_ms']:.3f} ms per served batch of {BATCH}; AlexNet (a) "
          f"{alex['bitplane_served_batch']['wall_ms']:.3f} ms per served "
          f"batch, (b) {alex['bitplane_int4_forward']['wall_ms']:.3f} ms per "
          f"fixed-INT4 forward; Qwen3-4B prefill {e2e['prefill_ms']:.3f} ms, "
          f"decode {e2e['decode_ms']:.3f} ms per step, generate "
          f"{e2e['generate_ms']:.3f} ms per call; continuous run() "
          f"{cbr['e2e']['run_a_s']:.3f} s (time to first token median "
          f"{cbr['e2e']['ttft_median_ms']:.3f} ms), speculative run() "
          f"{cbr['e2e']['run_b_s']:.3f} s; prefix-cache replay "
          f"{pcr['e2e']['cached_s']:.3f} s against {pcr['e2e']['uncached_s']:.3f}"
          f" s uncached, closed loop {pcr['e2e']['closed_s']:.3f} s, a "
          f"partial hit {pcr['e2e']['partial_ms_per_tail']:.3f} ms per tail "
          f"token against a miss {pcr['e2e']['miss_ms']:.3f} ms; ResNet18 "
          f"spike {pcr['e2e']['images_per_s']:.3f} images/s closed loop; "
          f"path 6 {sor['e2e']['wall_s']:.3f} s, its tick "
          f"{sor['e2e']['tick_median_ms']:.3f} ms median with two ranks on "
          f"one card, mean wbits of the spike {sor['e2e']['wbits'][0]:.4f} "
          f"without a plan and {sor['e2e']['wbits'][1]:.4f} with the partial "
          f"one; {MOE_ARCH} prefill {moer['e2e']['prefill_ms']:.3f} ms, decode "
          f"{moer['e2e']['decode_ms']:.3f} ms per step (int8, B={MOE_B}), "
          f"peak {moer['e2e']['peak_gib']:.3f} GiB; {VLM_ARCH} prefill "
          f"{vlmr['e2e']['bf16']['prefill_ms']:.3f} ms, decode "
          f"{vlmr['e2e']['bf16']['decode_ms']:.3f} ms per step with the bf16 "
          f"cache and {vlmr['e2e']['int8']['decode_ms']:.3f} with the int8 "
          f"one, continuous time to first token median "
          f"{vlmr['e2e']['bf16']['ttft_median_ms']:.3f} ms; "
          + "; ".join(f"{n} prefill {p8r[k]['e2e']['prefill_ms']:.3f} ms, "
                      f"decode {p8r[k]['e2e']['decode_ms']:.3f} ms per step,"
                      f" peak {p8r[k]['e2e']['peak_gib']:.3f} GiB"
                      for k, n in (("ssm", SSM_ARCH), ("hybrid", HYB_ARCH),
                                   ("encdec", ED_ARCH),
                                   ("dense", D160_ARCH)))
          + f"; {LM_ARCH} training {p9r['e2e']['step_ms']:.3f} ms a step "
          f"({p9r['e2e']['tokens_per_s']:.1f} tokens/s, peak "
          f"{p9r['e2e']['peak_gib']:.3f} GiB, loss "
          f"{p9r['e2e']['losses'][0]:.4f} -> {p9r['e2e']['losses'][-1]:.4f});"
          f" {LM_ARCH} through repro_torch.launch.serve: continuous "
          f"{p10r['e2e']['cont_s']:.3f} s (run() {p10r['e2e']['run_s']:.3f} "
          f"s), --batch {p10r['e2e']['batch_s']:.3f} s, peak "
          f"{p10r['e2e']['peak_gib']:.3f} GiB; path 11 (sharded serving on "
          f"{P11_RANKS} gloo ranks sharing the card) "
          f"{p11r['e2e']['wall_s']:.3f} s, its ranks "
          f"{p11r['e2e']['ranks_s']:.3f} s; path 12 (sharded training on "
          f"{P12_RANKS} gloo ranks sharing the card) "
          f"{p12r['e2e']['wall_s']:.3f} s, its ranks "
          f"{p12r['e2e']['ranks_s']:.3f} s, a tensor-parallel {LM_ARCH} "
          f"step {p12r['e2e']['step_s']:.3f} s a rank; path 13 (the "
          f"analysis suite on the card) {p13r['e2e']['wall_s']:.3f} s, "
          f"its analyze --all {p13r['e2e']['analyze_s']:.3f} s, syncs the "
          f"card reported in a tick and a speculative round "
          f"{p13r['e2e']['syncs']}; path 14 (a) (the lowering report "
          f"against the card) {p14r['wall_s']:.3f} s, a {P14_A[0]} x "
          f"{P14_A[1]} prefill {p14r['prefill_ms']:.3f} ms against its "
          f"roofline {p14r['roofline_ms']:.3f} ms; path 15 (the recurrent "
          f"and encoder-decoder families on {P15_RANKS} gloo ranks sharing "
          f"the card) {p15r['e2e']['wall_s']:.3f} s, its ranks "
          f"{p15r['e2e']['ranks_s']:.3f} s; path 16 (the same families "
          f"trained on {P16_RANKS} gloo ranks sharing the card) "
          f"{p16r['e2e']['wall_s']:.3f} s, its ranks "
          f"{p16r['e2e']['ranks_s']:.3f} s; path 17 (the sequence-sharded "
          f"pool, the frame-split cross cache and an odd CNN batch on "
          f"{P17_RANKS} gloo ranks sharing the card) "
          f"{p17r['e2e']['wall_s']:.3f} s, its ranks "
          f"{p17r['e2e']['ranks_s']:.3f} s")
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

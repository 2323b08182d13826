#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA Hopper card (H100): M³ViT
serving through the kernels and through the fused MoE kernel, and
Llama-3.2-1B prefill + decode serving, each also through the
continuous-batching scheduler; the recurrent families (xLSTM-350M and
RecurrentGemma-9B) serving; the remaining configurations (MusicGen-Large,
Phi-4-mini, Qwen1.5-4B, Qwen2-VL-72B, DeepSeek-67B, Llama-4-Scout,
M³ViT-many) serving; then training M³ViT and Llama-3.2-1B through the
kernels; then mesh serving (sharding rules, expert parallelism, the
sharded expert cache, the tile table's overrides) and training over a
mesh; last the four examples (``repro_torch.examples``).

    python3 chip_smoke.py

Phases, each printing its lines, run in the order 1, 2, 3, 4, 7, 5, 8, 6,
9, 10 (a), 11 (a), 10 (b) with 11 (b), 12 (phase 5 checks and times the
launches of 3, 4 and 7, and of phase 8's Qwen2-VL-72B and Llama-4-Scout
units while each model lives; phases 10 and 11 share one NCCL world of
one and then one pair of processes):

1. The card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the build of every ``src/repro_torch/csrc/*.cu`` kernel
   with ``nvcc`` for ``sm_90a`` (into ``build/``), with ptxas' register and
   spill report per entry function, and a ``cuobjdump -sass`` count of
   ``HGMMA`` in each instance of the two tensor-core GEMM kernels, of the
   tensor-core (``tc``) attention kernel and of the ``tc`` fused MoE
   kernel, whose build log must show no C7518 (ptxas serializing a
   ``wgmma``).
2. Each of the six kernels against its plain PyTorch version on the card,
   on made-up inputs: at the main paths' shapes (M³ViT at B = 8; the
   Llama-3.2-1B projections at M = 8 and M = 1024 and its causal GQA
   prefill attention; decode at B = 8, Smax 512, lengths spread over
   [0, 512], window unset and set) in bf16 and in float32, and at ragged
   cases (odd sizes, empty queues, dropped slots, a zero cache length);
   the max error beside the stated tolerance
   (``repro_torch.kernels.compare``).  The GEMMs add ``unified_linear`` at
   M = 1, 16, 72 against the LM widths, K off the 64-wide k-tile, two
   split-K launches that must be bit-identical, and ``moe_gemm`` with NaN
   in every queue tail, a whole group and an expert empty; every GEMM
   launch must move exactly the variant counter its planner names
   (``repro_torch.kernels.gemm_plan``).  ``flash_attention`` adds the
   transposed views the models hand over, Sq = 1 over a live cache prefix
   (the ``attention_decode``/``cuda`` route), head_dim 48 (``tc``), 40
   (``simt``) and 128, fully masked rows, float32 on ``simt``, head_dim
   256 (RecurrentGemma-9B's MQA 16:1 on ``tc``'s four atoms: causal at B =
   8 × 128, causal and windowed at 2 × 2304 tokens with window 2048, GQA
   16:4 at ragged lengths; float32 on ``simt``), and every
   launch must move exactly the variant counter its planner names
   (``repro_torch.kernels.attn_plan``); ``decode_fused`` adds cache lengths
   on and around its 64-key split boundaries (63, 64, 65, Smax), windows
   that leave whole splits unread, head_dim 256 with MQA 16:1 (two chunks
   of 8 heads) at mixed lengths up to a 2048-slot ring, and a second
   launch that must be bit-identical; ``moe_fused`` adds every queue at
   capacity, all tokens routed to one expert (tiles spanning every group), an empty expert,
   top-1 and top-8, two routing groups,
   d = f = 768, d = 128, NaN in x rows that no queue reads, exact GELU,
   SwiGLU at M³ViT's widths and at ragged ones on ``tc`` and ``simt``,
   float32 on ``simt``,
   and a second launch that must be bit-identical; every launch
   must move exactly the variant counter its planner names
   (``gemm_plan.plan_moe_fused``).  Then ``unified_linear`` at every
   projection shape of both models: the rows of launches of M = 1, 16, 70,
   80, 128 and 1024 rows must equal the M = 1024 launch's bit for bit (a
   row's sum runs over the same K ranges in the same order at every M).
3. The main path: an ``M3ViTServer`` at the full 12-layer ``CONFIG`` in
   bf16 under the ``cuda`` policy, with seeded random weights, answers 16
   requests (8 semseg, 8 depth) in batches of 8.  Output shapes and
   finiteness are checked, and each task's outputs are held to cosine
   >= 0.999 against the same forward under the plain eager/blocked/lut
   policy on the card.  Every kernel's launch count over the 16 requests
   must be > 0 and the dispatch report must show the kernels hit on the
   card.  Then each task's batch is timed: the median host wall time of 5
   calls (``repro_torch.serve.profile.wall_per_batch``).  The same 16
   requests are then served under ``cuda`` with ``moe_ffn="cuda_fused"``:
   cosine >= 0.999 against the plain policy, ``moe_fused`` launched 6 times
   per forward, every launch on ``tc``, ``moe_gemm`` and ``gelu_lut`` not
   at all; timed the same way.  After each of the two runs, frame 0 of
   each task served at batch 1, 2 and 4 must equal its row at batch 8 bit
   for bit (the reduction order of every kernel on these paths depends on
   the layer's widths, not on the batch).  Then the same 16 requests are
   served with expert paging under ``cuda``: 8 of each MoE layer's 16
   experts resident (``resident_fraction=0.5``), synchronously, then
   through the copy-stream ``TransferEngine`` (``async_paging=True``),
   then under a budget of four experts' bytes.  Each output must be
   ``np.array_equal`` to the all-resident ``cuda`` run's, ``moe_gemm``
   (every launch on ``tc``) and ``gelu_lut`` must launch and the dispatch
   report show the kernels hit on the card; the cache counters (hits,
   misses, evictions, bytes paged per batch, hit rate), the waves per
   layer, the transfers' stall and hidden time and overlap ratio, and ms
   per batch are printed.  These paged runs' launches are checked here
   and stay out of phase 5 (they run the same kernels at the same
   per-queue shapes as the ``cuda`` run).  Then the 16 requests, all due
   at once, through the continuous-batching ``Scheduler`` over
   ``VisionBackend``'s per-task buckets of 4 (``total_slots`` 8), under
   ``cuda`` and under ``moe_ffn="cuda_fused"``, all resident (counted, with
   recorded twins for phase 5) and at ``resident_fraction`` 0.5 (checked
   only): every result ``np.array_equal`` to its server's ``infer`` of the
   same frames at batch 8; img/s and latency p50/p99 printed.  Then the
   packed expert formats (checked and printed only; their launches stay
   out of phase 5): the 16 requests with int8 and int4 weights
   (``quant.quantize_tree``), rank-8 factored experts with float32 deltas
   and butterfly ones with int8 deltas (``M3ViTServer(factor=...)``),
   under ``cuda`` with ``linear``/``moe_grouped_gemm`` on ``eager_int8``
   (or ``moe_grouped_gemm`` on ``eager_factored``), as
   ``launch/serve.py --quant``/``--factor`` serve them: each task held to
   cosine >= 0.999 against the same packed parameters under the plain
   ``eager_int8``/``eager_factored`` preset, its cosine against the
   unquantized ``cuda`` run printed beside the reference's int8 bar;
   ``flash_attention`` and ``gelu_lut`` (and, factored,
   ``unified_linear``) launched as hits on the card, the packed impls hits
   with no fallback; paged at 0.5 (synchronous and through the
   ``TransferEngine``) and under a four-bf16-expert budget (at least 7
   int8 and 12 int4 experts), each ``np.array_equal`` to the format's own
   all-resident run; ms per batch, bytes per expert, pinned bytes, hit
   rate, bytes paged and frame 0's differing elements at batch 1, 2, 4
   printed.
4. The LM path: a ``ServingEngine`` at the full Llama-3.2-1B ``CONFIG``
   (16 layers, bf16, seeded random weights, ``max_len`` 512) under ``cuda``
   with ``attention_decode="cuda_fused"`` generates 32 greedy tokens for
   8 prompts of 128 tokens.  ``unified_linear`` and ``flash_attention``
   must launch and ``decode_fused`` 16 times per decode step, all hits on
   the card; then the prefill and every decode step are replayed,
   teacher-forced on the generated tokens, under the kernel policy (whose
   argmax must give back the generated tokens) and under the plain
   ``eager`` policy on the card, with cosine >= 0.999 between the two
   logits at every step.  Prefill ms, ms per decode step and tokens/s.
   Then the same model through the continuous-batching ``Scheduler``
   (``LMBackend``, 8 slots): (a) the 8 prompts of 128 tokens, whose
   tokens must equal the static run's bit for bit; (b) 32 requests with
   prompts of 16..128 tokens (16, 64, 70, 80 among them) and 8..32 new
   tokens, each equal to the static engine serving its prompt alone and
   in a batch of 8 copies (which must agree), with decode steps whose
   slots' cache lengths differ; (c) a bursty multi-tenant
   ``TraceGenerator`` trace under ``SLOPolicy(preemption=True)``,
   ``prefill_chunk`` 64 and a 32-entry prefix cache, on a tick clock:
   every request equal to the engine serving it alone, at least one
   preemption, restore and prefix hit.  tok/s, TTFT and TPOT p50/p99, slot
   utilization, host syncs per decode step (must be 1) and the
   ``decode_fused`` launches with non-uniform lengths are printed.  (a)
   and (b) are counted, their admissions and decode steps recorded apart
   for phase 5; (c) is checked and printed only.  Then, checked and
   printed only, int8 weights with an int8 KV cache under ``cuda`` with
   the ``eager_int8`` overrides: 32 tokens for the 8 prompts,
   ``flash_attention`` and ``gelu_lut`` launched, ``attention_decode`` a
   hit on ``eager_int8``; the teacher-forced replay at cosine >= 0.999
   against the plain ``eager_int8`` preset at every step; a 64-token-chunk
   prefill giving the same tokens; the bursty trace through the scheduler
   with int8 parking under preemption, every request equal to its run
   without preemption; int8 parking of a bf16 cache under 0.75x the
   bytes; tokens/s, ms per decode step and cache bytes against bf16.
5. The kernels at the main paths' own inputs.  Beside each counted run of
   phases 3 and 4 an uncounted twin (one more forward of each task; the
   teacher-forced replay of the prefill and the 32 decode steps) records
   the arguments of every kernel launch (the schedulers' runs are
   repeated for it).  Each distinct recorded launch
   (by shape and data) is held against its plain version and timed alone
   (a CUDA graph of 10 calls on the same operands, which stay warm in L2;
   CUDA events, median of 20 replays after warm-up).  Then each recorded
   run's launches are replayed in their recorded order, as one CUDA graph,
   so every launch meets its own operands as in the path: the kernels,
   the plain versions, and one library call for each (``torch.matmul``,
   SDPA, ``torch.bmm``; yardsticks only) — ``moe_fused`` has no single
   library call, and beside it the staged ``cuda`` path (dispatch, 2 ×
   ``moe_gemm``, ``gelu_lut``, combine) is replayed on the same routing.
   The least time the card could take is the larger of the bytes moved
   (each input read once, each output written once) at 3.35 TB/s and the
   operations at the peak rate for the type (989 TFLOP/s bf16, 67 TFLOP/s
   float32), counting the work this run's data needs (live queue rows,
   visible keys), summed over the launches.

6. Training.  (a) M³ViT at the full ``CONFIG`` (bf16, seed 0, batch 8
   frames from ``SyntheticM3ViTStream``, loss semseg + depth on one batch
   through ``vit.multitask_loss``, AdamW lr 3e-3, warmup 2 of 40, no
   weight decay): the forward with gradients on must equal the
   ``inference_mode`` forward bit for bit under ``cuda``; at step 0 the
   loss and every gradient leaf under ``cuda`` (the kernels forward, their
   ``torch.autograd`` backward) are held against the default policy (the
   reference's training policy) to ``kernels/compare.py``'s training
   bounds (the same model's float32 gradients the yardstick where bf16
   noise alone exceeds the all-leaves target), the worst leaf printed; 20 ``TrainLoop`` steps under each
   policy, both tasks' losses at step 19 below step 0; under ``cuda`` the
   dispatch report must show ``linear``, ``attention``, ``activation`` and
   ``moe_grouped_gemm`` as hits on the card with no fallback and all four
   kernels launched (counted); a checkpoint at step 10 restored into
   seed-1 weights must replay steps 10–19 within ``rel=1e-6`` (bit
   equality printed); a batch with a NaN pixel must leave parameters and
   optimizer state bit-identical with ``skipped == 1``; ``accum_steps=2``
   against 1 within loss ``rel=1e-5`` and parameters 2e-3 (the reference's
   accumulation test, with its optimizer: lr 1e-3, warmup 3).  (b)
   Llama-3.2-1B at the full ``CONFIG`` through ``repro_torch.launch.train``'s
   step (batch 4 × 128 tokens): the step-0 loss and gradients against the
   default policy to the same bounds, the training forward's distinct
   kernel launches against their plain versions, and 5 steps under each
   policy with every loss finite (counted under ``cuda``).  Printed: ms a
   step (median host wall), frames/s or tokens/s, peak memory, and from
   ``torch.profiler`` (``train/profile.py``) the forward, backward and
   optimizer device ms, the idle share, and each kernel's forward and
   backward device ms a step.

7. The recurrent families at full width, cut in depth for the time
   limit (``RC_LAYERS``; random weights drawn on the card from seed 0;
   the seconds are printed), each under ``cuda`` with
   ``attention_decode="cuda_fused"``: (a) xLSTM-350M (8 of 24 layers,
   7 mLSTM : 1 sLSTM) and RecurrentGemma-9B (14 of 38 layers, RG-LRU,
   RG-LRU, local attention over 2048 tokens, MQA at head_dim 256) each
   generate 32 greedy tokens for 8 prompts of 128 tokens (``max_len``
   512, so every local-attention cache is a 512-slot ring), counted:
   ``unified_linear`` launches, and for RecurrentGemma ``flash_attention``
   and ``decode_fused`` once a local-attention layer and decode step,
   all hits on the card with no fallback; xLSTM's sLSTM
   projections (rows of 1365 bf16, 2730 bytes) are the SIMT launches
   allowed by name, exactly their count; then the prefill and every
   decode step replayed teacher-forced under the kernel policy (whose
   argmax must give back the tokens) and the plain ``eager`` policy:
   cosine >= 0.999 at every step, or, where bf16 noise alone exceeds it,
   the kernels' distance (1 − cosine) from the same model in float32 at
   most 1.25 times the plain policy's + 1e-3
   (``compare.serving_agrees``); (b) RecurrentGemma with 2 prompts of 2304
   tokens (past the window), ``max_len`` 4096 (a
   2048-slot ring taking the rolled write), the same checks; (c) both
   models through the ``Scheduler`` (``LMBackend``, 8 slots, no prompt
   padding, no prefix cache): 16 requests of 16..128-token prompts, each
   equal bit for bit to the static engine serving it alone and in a batch
   of 8 copies; (d) xLSTM preemption: a parked and restored request
   (``compress="none"``) equals its uninterrupted run; (e) xLSTM chunked
   prefill, 8 prompts of 150 tokens in chunks of 64 (the last one 22,
   unpadded), gives the one-shot tokens with the weights in float32 (in
   bf16 the stack amplifies the chunks' other roundings until the greedy
   streams part; their agreement is printed as a reading).  Prefill ms,
   ms a decode step, tokens/s, peak memory and the phase's wall time are printed; (a) and
   (b) are counted and recorded for phase 5, (c)–(e) checked only.
8. The remaining configurations at full width in bf16 under ``cuda`` with
   ``attention_decode="cuda_fused"``, weights drawn on the card from seed
   0, one model at a time, each freed before the next: MusicGen-Large
   (48 layers), Phi-4-mini (32), Qwen1.5-4B (40), and cut in depth only,
   Qwen2-VL-72B (16 of 80), DeepSeek-67B (16 of 95) and Llama-4-Scout (6
   of 48, all 16 experts); each line gives the depth, ``param_count`` of
   the run config, the bytes and the cut.  For each: ``generate`` of 8
   prompts of 128 (token ids, or (128, d) embeddings for MusicGen and
   Qwen2-VL, whose sampled tokens come back as rows of the stub table),
   32 greedy tokens, ``max_len`` 512, counted: every launch as planned
   (``unified_linear`` per projection and head, ``flash_attention`` and
   ``decode_fused`` per layer, Llama-4-Scout's three expert projections
   on ``moe_gemm`` and its SiLU on ``gelu_lut`` per layer and forward, at
   top-1 with the shared expert on ``unified_linear``), no SIMT route,
   every kernel op in mode ``cuda`` and the one fallback allowed
   (Llama-4-Scout's ``moe_ffn``, which has no ``cuda`` impl) printed with
   its reason; with ``moe_ffn="cuda_fused"`` Scout's layer is refused on
   the card with the reference's reason (``onehot``), no ``moe_fused``
   launch; (a) the prefill logits against the plain ``eager`` policy
   at cosine >= 0.999, or past bf16 noise within the float32 yardstick
   (``compare.serving_agrees``; the same model in float32, its bf16
   weights widened one op at a time, so it fits beside every config);
   the teacher-forced replay gives back the tokens; (c) MusicGen and
   Qwen2-VL through the ``Scheduler``: 16 requests of 16..128 positions
   in 8 slots, padded, each equal to the static engine's tokens bit for
   bit; then Qwen2-VL's and Llama-4-Scout's ``generate(prompts, 1)``
   (a prefill and a decode step) counted, recorded and checked and timed
   as phase 5 does, added to the kernels' entries.  (e) M³ViT-many (256
   experts, 8 tasks) through ``M3ViTServer`` at batch 8 under ``cuda``
   and ``moe_ffn="cuda_fused"`` (every ``moe_fused`` launch on ``tc``):
   cosine >= 0.999 of the plain policy or within the float32 yardstick,
   beside the count of routed rows whose top-4 expert set the bf16
   policies and float32 disagree on; frame 0 at batch 1, 2, 4 equal to
   its batch-8 bits; then the launcher's example ``--arch m3vit_many
   --smoke --scheduler --factor rank:8 --expert-budget-bytes 2000000`` to
   its end.  Prefill ms, ms a decode step, tokens/s and peak memory per
   config and the phase's wall time are printed; the configs but the two
   units are checked and printed only.

9. The roofline of the main paths (``repro_torch.roofline``), at full
   width: the M³ViT semseg forward at batch 8 under ``cuda`` and under
   ``moe_ffn="cuda_fused"``, a Llama-3.2-1B prefill of 8 × 128 and a
   decode step at batch 8 (128 cached, ``attention_decode="cuda_fused"``;
   weights drawn on the card from seed 0).  For each: (a) the cost
   counter (``roofline/op_cost.py``) under the kernel policy and under
   ``eager`` on the card — FLOPs, bytes and FLOPs by scope must be equal
   (a registry op counts analytically, whichever impl serves it) and the
   unit's kernels must have launched; (b) the counter's ``linear`` FLOPs
   must equal phase 5's 2·m·n·k over the same recorded ``unified_linear``
   launches, its expert-product FLOPs (E × C capacity rows) must be >=
   phase 5's over the live rows of ``moe_gemm`` / ``moe_fused``, and its
   attention FLOPs (the whole rectangle, the reference's count) print
   beside phase 5's visible pairs; (d) the roofline time (the larger of
   counted bytes at 3.35 TB/s and FLOPs at 989 TFLOP/s), its bound term,
   the device's busy time and the device ms by scope from a
   ``torch.profiler`` run (each launch to the innermost scope open when
   it was made), the median host wall of 5 calls, and bound/busy and
   bound/wall, beside the card's name and power limit.  (c) The Llama
   prefill under ``eager``: the dry-run's peak of live bytes (the same
   call on ``meta``) against ``torch.cuda.max_memory_allocated`` after
   ``reset_peak_memory_stats``, less what was allocated before, within 10
   % or 64 MiB, whichever is larger; its argument bytes (weights, cache,
   tokens) against what ``memory_allocated`` grew by when they were
   built, within 1 %.  Any miss fails the run.
10. Mesh serving.  (a) A world of one: NCCL with an in-memory store, a
   (1, 1) ``DeviceMesh`` (``"data"``, ``"model"``) on the card and its
   sharding rules (``fsdp=False``).  Each check is bit for bit against
   the same run with no mesh: the full M³ViT ``M3ViTServer(rules=)`` at
   batch 8 for both tasks, the same server paged through
   ``ShardedExpertCache`` at resident fraction 0.5,
   ``apply_moe_ep_local`` on an M³ViT MoE layer against ``grouped``
   (output and aux), full-width Llama-3.2-1B ``ServingEngine(rules=)``
   over 8 × 128 prompts and 32 greedy tokens (tokens and prefill logits;
   weights drawn on the card), and one ``Scheduler(rules=)`` run of 8
   requests; each such run is counted (launches by kernel, the
   collectives), fails on any recorded fallback or kernel impl off the
   card, and its host wall is printed beside the unmeshed one.  Then a
   ``with_tiles`` override of ``linear.cuda`` must raise (the tile table
   has no ``cuda`` knob: the planners pick each launch's tile).  (b) Two
   processes on the one card, gloo over CUDA tensors (NCCL refuses two
   ranks on one device).  A probe first: gloo starts and all-reduces a
   CUDA tensor.  Every fault, the probe's too, fails the run:
   ``apply_moe_ep_local`` at M³ViT's width, 8 of 16 experts a rank on
   ``moe_gemm``, against single-device ``grouped`` at the bf16
   tolerance; a grouped MoE on each rank's half of a data-split batch
   (``spmd.batch_split``, M³ViT's 128-token groups and one group over the
   whole batch) bit for bit against the layer on the whole batch; then
   tensor parallelism over (1, 2): ``unified_linear``'s column blocks of
   Llama-3.2-1B's projections (N/2, summed in the whole weight's order)
   bit-equal to the whole product's columns at 8 and 1024 rows, its row
   blocks (K/2, float32 out), ``flash_attention`` at 16 q over 4 KV heads
   and ``decode_fused`` at 4 KV heads each against its plain version;
   full-width Llama-3.2-1B with each rank's blocks drawn on the card
   (bit-equal to the narrowed whole draw) serving 8 × 128 prompts and 32
   greedy tokens, its prefill's and 8 teacher-forced steps' logits at
   cosine >= SERVE_COSINE of no mesh, the collectives by ``where`` (an
   ``attn_out`` and an ``mlp_down`` all-reduce a layer, an ``embed``
   all-reduce and a ``logits`` all-gather a forward), no SIMT launch;
   then RecurrentGemma-9B at full width and ``TP_RG_LAYERS`` (3) layers
   over (1, 2), its RG-LRU mixers split too (2048 of 4096 channels, 8 of
   16 gate heads a rank): on rank 0 the kernels at its shapes against
   their plain versions (``_tp_rg_kernels``: the column blocks of
   ``w_up``, ``w_up2`` + GELU, ``wg`` + GELU, ``wu``, ``wq`` bit-equal to
   the whole product's columns, the float32 row blocks of ``w_down``,
   ``wd``, ``wo``, ``flash_attention`` at 8 q heads over one KV head at
   head_dim 256, ``decode_fused`` over its ring), 8 × 128 prompts and 32
   greedy tokens held as Llama, an ``rglru_down`` all-reduce an RG-LRU
   layer besides; then xLSTM-350M at full width and ``TP_XL_LAYERS`` (8)
   layers, its mLSTM and sLSTM heads split (2 of 4 a rank): on rank 0
   ``unified_linear`` at its rank's shapes (``_tp_xl_kernels``: column
   blocks of ``w_up``, ``w_gates``, ``w_qkv`` bit-equal, ``w_down``'s
   float32 row block, at the decode step's 4 rows and the prefill's
   256), 4 × 64 prompts and 16 greedy tokens, the logits at
   SERVE_COSINE or the float32 yardstick, a uc and a qkv all-gather and
   a ``mlstm_down`` all-reduce an mLSTM block and an hn all-gather an
   sLSTM block, SIMT only for the sLSTM's 1365-wide projections — each
   model one ``_tp_serve`` run (``_tp_serving``), its weight, part and
   state bytes a rank every narrowed leaf exactly half, its collectives
   over ``model`` as counted from the config (``_tp_serve_expect``) and
   nothing else; then FSDP of serving's weights over (2, 1)
   (``_fsdp_serve``: Llama-3.2-1B at full width and ``MESH_LM_LAYERS``
   (4) layers under the default rules, ``place_params`` holding every
   matrix's half over data and each layer's leaves gathered just before
   it runs), each rank drawing its blocks (bit-equal to the narrowed
   whole draw), its weight bytes at rest the table's blocks exactly and
   at most ``FSDP_HELD_SHARE`` of ``fsdp=False``'s, 8 × 128 prompts and
   ``TP_FORCED_STEPS`` greedy tokens under ``cuda`` + ``cuda_fused``
   decode, the prefill's logits and the tokens bit for bit against the
   same mesh under ``fsdp=False``, the ``fsdp gather`` all-gathers over
   data as counted from the config and every other collective as
   ``fsdp=False``'s, its peak memory and wall beside ``fsdp=False``'s;
   and tiered preemption over a 4-lane bucket split over (2, 1) (4
   layers of Llama-3.2-1B), every request's tokens bit-equal to no mesh;
   each counted and checked for fallbacks as in (a).
11. Training over a mesh (``make_train_step(rules=)``: each rank's
   blocks of the parameters and AdamW state, its rows of the batch, the
   weights gathered over the batch axes — over ``model`` too for a leaf
   every rank holds whole — the dense blocks tensor-parallel over
   ``model`` with a vocab-parallel loss, the gradients reduced to the
   blocks once a step).  (a) Phase 10's world of one, rules
   ``for_mesh((1, 1))`` with ``fsdp=True``, bit for bit against no rules
   in every loss, parameter and AdamW leaf: M³ViT at the full CONFIG,
   batch 8, 3 steps (its expert layer staged: ``cuda`` names no ``moe_ffn`` impl) and
   Llama-3.2-1B at full width and depth, 4 × 128 tokens, 2 steps, each
   counted as in phase 10; then ``compressed_psum`` of Llama's gradients
   equal to their dequantized payload and its carry to ``gf - deq``.  (b)
   On phase 10 (b)'s two ranks after its work (any fault fails the run),
   AdamW with eps 1 (a step proportional to the gradient): M³ViT at 2×1
   (batch 8 split 4 + 4) and Llama-3.2-1B at full width and 4 of its 16
   layers, 2 steps each against one process on the whole batch (its
   steps on rank 0 alone, rank 1 waiting; rank 0 sends its numbers) — loss
   and grad norm within ``compare.TRAIN_LOSS_RTOL``, the parameters
   within one step of ``compare.py``'s tolerance a step, the ranks'
   re-gathered parameters bit-equal; the same two models at 1×2,
   tensor-parallel (Llama: 16 of 32 q heads, 4 of 8 KV heads, half of
   the MLP's columns and of the vocabulary a rank; M³ViT: its MLPs'
   columns, its three-head attention and routed experts whole), held the
   same way, with the collectives by ``where`` as counted from the
   config (``_tp_train_expect``: an ``attn_out`` and an ``mlp_down``
   all-reduce a split layer and forward and their inputs' all-reduces in
   the backward, the embedding's all-reduce, the head's and the loss's
   three (B, S) reduces a forward; no logits all-gather; a gather over
   ``model`` only of the leaves held whole) and no SIMT launch, phase
   11 (b)'s own wall printed; before them, on rank 0, the kernels at
   those runs' shapes against their plain versions
   (``_tp_train_kernels``: ``unified_linear`` on M³ViT's MLP at M = 1024
   — ``w1``'s column blocks with ``b1`` and the GELU LUT, ``w2``'s
   float32 row blocks — and on Llama's projections at M = 512, column
   blocks bit-equal to the whole product's columns, row blocks and the
   backward of each block within tolerance; ``flash_attention`` at
   Llama's 16 q heads over 4 KV heads, forward and backward); M³ViT at
   1×2 under ``ep_local``
   (8 of 16 experts a rank), each expert's gradient against
   single-device ``grouped`` (cosine); RecurrentGemma-9B at full width
   and 3 layers at 1×2, batch 2 × 128, 2 steps, its RG-LRU mixers split
   (every ``rglru`` leaf kept local, never gathered over ``model``; an
   ``rglru_down`` all-reduce and its input's in the backward a mixer),
   AdamW with bf16 momentum and the factored second moment, held as
   Llama (on rank 0 its
   projections at M = 256 and ``flash_attention`` at 8 q heads over one
   KV head, head_dim 256, in ``_tp_train_kernels``); xLSTM-350M at full
   width and 8 layers at 1×2, 2 × 64 tokens, its mLSTM and sLSTM heads
   split, held as Llama (on rank 0 the mLSTM's projections at M = 128 in
   ``_tp_train_kernels``), and the gradients of the whole leaves a rank
   reads for its heads alone against one process (``_xl_partly_read``:
   float32 at GRAD_COSINE_LEAF, bf16 beside its noise); ``compressed_psum``
   over the ranks bit for bit; ``launch/train.py --mesh local`` for 3
   steps with a checkpoint, which the parent restores without a mesh and
   trains on, against the same runs with no mesh.  The four kernels of the training
   path must launch (``mesh_train_launches`` in the JSON line).
12. The examples: each one's ``main`` in-process on the card under its
   default ``--policy cuda``, counted (launches by kernel and variant,
   every SIMT launch named with its planner's reason, the dispatch
   report with every kernel impl on the card and no fallback, the kernels
   of its path launched, its host wall).  (a) ``quickstart``: ①–③ within
   ``compare.py``'s float32 rule of the same run on the CPU (integers
   equal), ⑤'s queue sizes equal, ④'s float32 GEMM (the one SIMT launch
   allowed) within the float32 tolerance of the CPU's, both M³ViT task
   outputs finite and at cosine >= 0.999 to the same forward under
   ``eager`` on the card.  (b) ``multitask_vit --steps 30 --frames 12``
   at the paper config: every loss finite, the last semseg CE below the
   first, no SIMT launch, and the per-frame task switch moving no
   weight (every parameter's ``data_ptr`` and ``memory_allocated``
   unchanged).  (c) ``serve_lm``: each family's tokens replayed
   teacher-forced under the kernels and under ``eager`` on the card,
   held by ``compare.serving_agrees``, and its decode state's bytes equal
   to the CPU's.  (d) ``train_lm --steps 20`` at 8 × 128 from no
   checkpoint: finite losses, the last below the first, the parameter
   count ``lm_100m``'s.  These launches stay out of phase 5 and of
   ``launches`` (``example_launches`` in the JSON line).

Each main-path run sets every launch count to 0 just before it and reads
them just after; a kernel's ``launches`` in the JSON line is the sum over
those runs, training's, phase 10 (a)'s and phase 11's mesh runs
included (also given apart as ``training_launches``, with
``training_ms``: the kernel's
forward and backward device ms a training step by model,
``mesh_launches`` and ``mesh_train_launches``, and the tensor-parallel
runs of phases 10 (b) and 11 (b) inside them as ``tp_launches`` and
``tp_train_launches``).  The variant counters
(the GEMMs', ``flash_attention``'s,
``moe_fused``'s) are read with them: no main path may take the SIMT
route (but for xLSTM's sLSTM projections, whose 2730-byte rows no TMA
map can address: exactly their number, named with the reason), and the
variants the recorded launches were planned on must equal the counted
ones (``variants`` in the JSON line and per unit).
The recorded launches must match the counted ones kernel by kernel, and
a kernel's times and bound in the JSON line cover exactly those launches
(in-order replays; ``alone_ms`` sums the launches timed alone), with a
breakdown (``units``) per recorded twin.

The plain versions run in full float32: TF32 is switched off for matmuls
and for cuDNN before anything runs.  Each phase's host wall is printed
before the card's line.  Any failed check raises; the last two lines are
the kernels' JSON record and the result line.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.launch.mesh import HW  # noqa: E402  (after the path)

HBM_BYTES_PER_S = HW.HBM_BW                      # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: HW.PEAK_FLOPS_BF16,   # dense tensor-core bf16
              torch.float32: HW.PEAK_FLOPS_F32}     # float32, no tensor cores
BATCH = 8
TOKENS = 128 * BATCH

REPLACES = {
    "unified_linear": "src/repro/kernels/unified_linear.py:49",
    "flash_attention": "src/repro/kernels/flash_attention.py:40",
    "gelu_lut": "src/repro/kernels/gelu_lut.py:28",
    "moe_gemm": "src/repro/kernels/moe_gemm.py:33",
    "moe_fused": "src/repro/kernels/moe_fused.py:60",
    "decode_fused": "src/repro/kernels/decode_fused.py:43",
}
SOURCES = {name: f"src/repro_torch/csrc/{name}.cu" for name in REPLACES}
CUDA_PATH_KERNELS = ("unified_linear", "flash_attention", "gelu_lut",
                     "moe_gemm")
LM_BATCH, LM_PROMPT, LM_NEW, LM_MAX_LEN = 8, 128, 32, 512
RG_WINDOW, RG_LONG = 2048, 2304      # RecurrentGemma's window; prompts past it


def time_ms(fn, reps: int = 20, calls: int = 10) -> float:
    """Device time of one call: ``calls`` calls are captured in a CUDA graph
    (so no host gap sits between them), the graph is replayed ``reps``
    times between CUDA events after a warm-up, and the median replay time
    over ``calls`` is returned."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm-up outside the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, float]:
    """(ms to move the bytes at the HBM rate, ms to do the operations at
    the peak rate for ``dtype``); the bound is the larger."""
    return (nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3)


def randn(shape, dtype, scale=1.0, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


def _dt(t) -> str:
    return str(t.dtype)[6:]


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check(name, label, got, want, dtype, **kw) -> float:
    """Hold a kernel's output against its plain version's under the stated
    tolerance; raises on disagreement, returns the max abs error."""
    from repro_torch.kernels.compare import max_abs_err, within_tolerance

    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    ok = within_tolerance(got, want, dtype, **kw)
    rule = ("float32 1e-5+1e-5|ref|" if dtype == torch.float32
            else "1 bf16 ulp + float32 tol")
    if kw.get("lut_pre") is not None:
        rule += " (+1 table step at LUT index ties)"
    if kw.get("extra") is not None:
        rule += " (+ LUT index ties carried through w2)"
    print(f"  {name} {label}: max_abs_err {err:.3e} tolerance {rule}: "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {label}: kernel disagrees with its "
                             f"plain version (max err {err})")
    return err


def check_exact(name, label, got, want) -> float:
    torch.cuda.synchronize()
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    if not bool(same.all()):
        raise AssertionError(f"{name} {label}: not bit-exact")
    print(f"  {name} {label}: max_abs_err 0.000e+00 tolerance bit-exact: ok")
    return 0.0


# ------------------------------------------------------------ phase 2


def planned(name, wrapper, plan, call):
    """Run ``call`` (one launch of a GEMM wrapper) and check that exactly
    the variant its planner chose counted it; returns the output."""
    before = dict(wrapper.variants)
    out = call()
    moved = {v: wrapper.variants[v] - before[v] for v in before}
    want = {v: int(v == plan.variant) for v in before}
    if moved != want:
        raise AssertionError(f"{name}: planned {plan.variant} "
                             f"({plan.reason}), counters moved {moved}")
    return out


def _plan_label(plan) -> str:
    if plan.variant == "simt":
        return "simt"
    return (f"{plan.variant} {64 * plan.nwg}x{plan.bt} tiles, "
            f"{plan.splits} split(s), {plan.stages} stages, "
            f"{plan.blocks} blocks")


def check_unified_linear() -> None:
    from repro_torch.kernels import unified_linear as kul

    def one(label, x, w, b=None, act=None, lut=False):
        plan = kul.plan_for(x, w)
        got = planned("unified_linear", kul.unified_linear, plan,
                      lambda: kul.unified_linear(x, w, b, activation=act,
                                                 use_lut=lut))
        want = kul.unified_linear_plain(x, w, b, activation=act, use_lut=lut)
        # the LUT rule reads the float32 pre-activation (compare.py)
        pre = kul.unified_linear_plain(x.float(), w.float(), b) if lut \
            else None
        m, k = x.shape
        check("unified_linear", f"{label} M={m} K={k} N={w.shape[1]} "
              f"{_dt(x)} [{_plan_label(plan)}]", got, want, x.dtype,
              lut_pre=pre, kind=act or "gelu")
        return got

    # (label, M, K, N, bias, activation, LUT): M3ViT at B = 8, then the
    # Llama-3.2-1B projections at decode (M = 8) and prefill (M = 1024)
    shapes = [("patch_embed", TOKENS, 768, 192, True, None, False),
              ("qkvo", TOKENS, 192, 192, False, None, False),
              ("mlp_up_gelu_lut", TOKENS, 192, 768, True, "gelu", True),
              ("mlp_down", TOKENS, 768, 192, True, None, False),
              ("semseg_head", TOKENS, 192, 4864, True, None, False),
              ("depth_head", TOKENS, 192, 256, True, None, False)]
    lm = [("lm_q_o", 2048, 2048, False, None, False),
          ("lm_k_v", 2048, 512, False, None, False),
          ("lm_gate_silu_lut", 2048, 8192, False, "silu", True),
          ("lm_up", 2048, 8192, False, None, False),
          ("lm_down", 8192, 2048, False, None, False)]
    for m in (LM_BATCH, LM_BATCH * LM_PROMPT):
        shapes += [(label, m, k, n, b, act, lut)
                   for label, k, n, b, act, lut in lm]
    for dtype in (torch.bfloat16, torch.float32):
        for i, (label, m, k, n, has_b, act, lut) in enumerate(shapes):
            x = randn((m, k), dtype, seed=100 + i)
            w = randn((k, n), dtype, 1.0 / math.sqrt(k), seed=200 + i)
            b = randn((n,), torch.float32, 0.1, seed=300 + i) if has_b \
                else None
            one(label, x, w, b, act, lut)
    # the tensor-core path at the other small M against the LM widths
    for m in (1, 16, 72):
        for i, (label, k, n, has_b, act, lut) in enumerate(lm):
            x = randn((m, k), torch.bfloat16, seed=110 + i)
            w = randn((k, n), torch.bfloat16, 1.0 / math.sqrt(k),
                      seed=210 + i)
            one(label, x, w, None, act, lut)
    # K not a multiple of the 64-wide k-tile (the map zero-fills past K)
    for m, k, n in ((LM_BATCH, 2056, 512), (TOKENS, 200, 192),
                    (72, 1000, 264)):
        x = randn((m, k), torch.bfloat16, seed=45)
        w = randn((k, n), torch.bfloat16, 1.0 / math.sqrt(k), seed=46)
        b = randn((n,), torch.float32, 0.1, seed=47)
        one("K off the k-tile", x, w, b, "gelu")
    # split-K is deterministic: two launches on the same inputs, bit-equal
    x = randn((LM_BATCH, 8192), torch.bfloat16, seed=48)
    w = randn((8192, 2048), torch.bfloat16, 8192 ** -0.5, seed=49)
    first = one("split-K run 1", x, w)
    check_exact("unified_linear", f"split-K run 2 against run 1 "
                f"[{_plan_label(kul.plan_for(x, w))}]",
                kul.unified_linear(x, w), first)
    # why the kernel promotes its wgmma sums into a float32 register tile
    # every few k-tiles: one library bf16 product, which accumulates on the
    # tensor cores throughout, at the longest K of the main paths (a
    # reading, not a check)
    from repro_torch.kernels.compare import kernel_tolerance

    x = randn((TOKENS, 8192), torch.bfloat16, seed=50)
    w = randn((8192, 2048), torch.bfloat16, 8192 ** -0.5, seed=51)
    want = kul.unified_linear_plain(x, w)
    for label, got in (("torch.matmul", torch.matmul(x, w)),
                       ("unified_linear", kul.unified_linear(x, w))):
        out = int(((got.float() - want.float()).abs()
                   > kernel_tolerance(got, want, torch.bfloat16)).sum())
        print(f"  {label} bf16 M={TOKENS} K=8192 N=2048: {out} of "
              f"{want.numel()} outputs outside the bf16 tolerance")
    # ragged: odd M, K, N; SiLU through the LUT epilogue; float32
    x = randn((1000, 190), torch.float32, seed=40)
    w = randn((190, 770), torch.float32, 0.07, seed=41)
    b = randn((770,), torch.float32, 0.1, seed=42)
    one("ragged silu-lut", x, w, b, "silu", True)
    # bf16 rows of 66 bytes: TMA cannot address them, the SIMT route does
    x16 = randn((77, 33), torch.bfloat16, seed=43)
    w16 = randn((33, 129), torch.bfloat16, 0.2, seed=44)
    if kul.plan_for(x16, w16).variant != "simt":
        raise AssertionError("K=33 bf16 must be planned on the SIMT route")
    one("ragged erf-gelu", x16, w16, b[:129], "gelu")


#: (label, K, N, bias, activation, LUT) of every projection of the two
#: models: M3ViT's and Llama-3.2-1B's
PROJECTIONS = [("patch_embed", 768, 192, True, None, False),
               ("qkvo", 192, 192, False, None, False),
               ("mlp_up_gelu_lut", 192, 768, True, "gelu", True),
               ("mlp_down", 768, 192, True, None, False),
               ("semseg_head", 192, 4864, True, None, False),
               ("depth_head", 192, 256, True, None, False),
               ("lm_q_o", 2048, 2048, False, None, False),
               ("lm_k_v", 2048, 512, False, None, False),
               ("lm_gate_silu_lut", 2048, 8192, False, "silu", True),
               ("lm_up", 2048, 8192, False, None, False),
               ("lm_down", 8192, 2048, False, None, False)]
ROW_MS = (1, 16, 70, 80, 128, 1024)


def check_unified_linear_rows() -> None:
    """A row's output must not depend on how many rows share the launch:
    rows of M = 1, 16, 70, 80, 128 and 1024 against the M = 1024 launch,
    bit for bit, at every projection shape of both models (split-K at
    M <= 72 and whole K above sum the same K ranges in the same order)."""
    from repro_torch.kernels import unified_linear as kul

    for i, (label, k, n, has_b, act, lut) in enumerate(PROJECTIONS):
        x = randn((ROW_MS[-1], k), torch.bfloat16, seed=500 + i)
        w = randn((k, n), torch.bfloat16, 1.0 / math.sqrt(k), seed=600 + i)
        b = randn((n,), torch.float32, 0.1, seed=700 + i) if has_b else None
        outs = {}
        for m in ROW_MS:
            xm = x[:m].contiguous()
            plan = kul.plan_for(xm, w)
            outs[m] = (planned("unified_linear", kul.unified_linear, plan,
                               lambda: kul.unified_linear(
                                   xm, w, b, activation=act, use_lut=lut)),
                       plan)
        full = outs[ROW_MS[-1]][0]
        torch.cuda.synchronize()
        bad = {m: int((y != full[:m]).sum()) for m, (y, _) in outs.items()}
        plans = ", ".join(f"M={m} {p.variant} {64 * p.nwg}x{p.bt}"
                          for m, (_, p) in outs.items())
        ranges, promote = outs[1][1].ranges, outs[1][1].promote
        print(f"  unified_linear {label} K={k} N={n}: rows at M = "
              f"{', '.join(map(str, ROW_MS))} bit-identical to M=1024 "
              f"({ranges} K ranges, groups of {promote} k-tiles; {plans}): "
              f"{'ok' if not any(bad.values()) else 'FAIL'}")
        if any(bad.values()):
            raise AssertionError(f"unified_linear {label}: a row's output "
                                 f"depends on M: differing outputs {bad}")


def _attn_label(plan) -> str:
    if plan.variant == "simt":
        return f"simt, {plan.blocks} blocks of {plan.rows} rows"
    return (f"tc, {plan.blocks} blocks of {plan.rows} rows, {plan.atoms} "
            f"head-dim atom(s)")


def _split_heads_view(b, s, h, d, dtype, seed):
    """(B, H, S, D) as ``models/layers.py:_split_heads`` hands it over: a
    transposed view of (B, S, H, D)."""
    return randn((b, s, h, d), dtype, seed=seed).transpose(1, 2)


def check_flash_attention() -> None:
    from repro_torch.kernels import flash_attention as kfa

    def one(label, q, k, v, **kw):
        plan = kfa.plan_for(q)
        got = planned("flash_attention", kfa.flash_attention, plan,
                      lambda: kfa.flash_attention(q, k, v, **kw))
        check("flash_attention", f"{label} q {tuple(q.shape)} k/v "
              f"{tuple(k.shape)} {kw} {_dt(q)} [{_attn_label(plan)}]", got,
              kfa.flash_attention_plain(q, k, v, **kw), q.dtype)
        return got

    # M3ViT self-attention, then the Llama-3.2-1B prefill — causal GQA
    # 32/8 against the whole cache; q (and M3ViT's k, v) as the transposed
    # views the model hands over, which the tc kernel reads as they lie
    for dtype in (torch.bfloat16, torch.float32):
        one("M3ViT", *(_split_heads_view(BATCH, 128, 3, 64, dtype, seed)
                       for seed in (1, 2, 3)), causal=False)
        one("Llama-3.2-1B prefill",
            _split_heads_view(LM_BATCH, LM_PROMPT, 32, 64, dtype, 1),
            randn((LM_BATCH, 8, LM_MAX_LEN, 64), dtype, seed=2),
            randn((LM_BATCH, 8, LM_MAX_LEN, 64), dtype, seed=3),
            causal=True, q_offset=0)
    # the same inputs contiguous
    one("M3ViT contiguous", *(randn((BATCH, 3, 128, 64), torch.bfloat16,
                                    seed=seed) for seed in (1, 2, 3)),
        causal=False)
    # Sq = 1 over a live prefix of the cache: the attention_decode/cuda
    # route (ops/impls.py:_decode_cuda)
    kc = randn((LM_BATCH, 8, LM_MAX_LEN, 64), torch.bfloat16, seed=7)
    vc = randn((LM_BATCH, 8, LM_MAX_LEN, 64), torch.bfloat16, seed=8)
    for length in (1, 150, LM_MAX_LEN):
        one(f"Sq=1 over the live prefix {length}",
            randn((LM_BATCH, 32, 1, 64), torch.bfloat16, seed=9),
            kc[:, :, :length], vc[:, :, :length], causal=True,
            q_offset=length - 1)
    # ragged: GQA 6/2, Sq 77 vs Skv 100, causal + window + q_offset, at
    # head_dim 48 (tc: one atom, 16 zero columns) and 40 (simt)
    for d in (48, 40):
        one(f"ragged GQA 6/2 D={d}",
            randn((2, 6, 77, d), torch.bfloat16, seed=4),
            randn((2, 2, 100, d), torch.bfloat16, seed=5),
            randn((2, 2, 100, d), torch.bfloat16, seed=6),
            causal=True, window=24, q_offset=23)
    # head_dim 128 (two atoms), K tail off the 64-key tile
    one("D=128", randn((2, 4, 130, 128), torch.bfloat16, seed=10),
        randn((2, 2, 200, 128), torch.bfloat16, seed=11),
        randn((2, 2, 200, 128), torch.bfloat16, seed=12), causal=True,
        q_offset=70)
    # fully masked rows: queries at positions -4.. see no key (causal),
    # the window leaves each later one two
    for dtype in (torch.bfloat16, torch.float32):
        got = one("fully masked rows", randn((1, 2, 70, 64), dtype, seed=13),
                  randn((1, 2, 20, 64), dtype, seed=14),
                  randn((1, 2, 20, 64), dtype, seed=15), causal=True,
                  window=2, q_offset=-4)
        if bool((got[:, :, :4] != 0).any()):
            raise AssertionError("flash_attention: a fully masked row is "
                                 "not exactly zero")
    # head_dim 256 (RecurrentGemma-9B's local attention, MQA 16:1): tc with
    # four head-dim atoms (float32 on simt); causal, then the 2048-key
    # window over a 2304-token query block so the mask bites; GQA 16:4 at
    # ragged lengths (Sq 77 against Skv 100 with a q_offset, a K tail off
    # the 64-key tile)
    for dtype in (torch.bfloat16, torch.float32):
        one("D=256 MQA 16:1 causal",
            _split_heads_view(LM_BATCH, LM_PROMPT, 16, 256, dtype, 81),
            _split_heads_view(LM_BATCH, LM_PROMPT, 1, 256, dtype, 82),
            _split_heads_view(LM_BATCH, LM_PROMPT, 1, 256, dtype, 83),
            causal=True)
    for window in (None, RG_WINDOW):
        one(f"D=256 MQA 16:1 past the window",
            *(_split_heads_view(2, RG_LONG, h, 256, torch.bfloat16, seed)
              for h, seed in ((16, 84), (1, 85), (1, 86))), causal=True,
            window=window)
    one("D=256 ragged GQA 16:4", randn((2, 16, 77, 256), torch.bfloat16,
                                       seed=87),
        randn((2, 4, 100, 256), torch.bfloat16, seed=88),
        randn((2, 4, 100, 256), torch.bfloat16, seed=89), causal=True,
        window=40, q_offset=23)


def check_gelu_lut() -> None:
    from repro_torch.kernels import gelu_lut as kgl

    shape = (BATCH, 16, 68, 768)     # MoE hidden after + b1
    for dtype in (torch.float32, torch.bfloat16):
        x = randn(shape, dtype, 3.0, seed=7)
        check_exact("gelu_lut", f"G={BATCH} E=16 C=68 F=768 {_dt(x)}",
                    kgl.lut_activation(x), kgl.lut_activation_plain(x))
    # ragged: odd length with ±inf, NaN, values past the table, exact
    # index half-steps (half-to-even rounding)
    x = randn((1_000_003,), torch.float32, 4.0, seed=8)
    special = torch.tensor(
        [math.inf, -math.inf, math.nan, 0.0, -0.0, 8.0, -8.0, 9.5, 1e30,
         -1e30] + [(i + 0.5) / 256 for i in range(64)], device="cuda")
    x[:special.numel()] = special
    check_exact("gelu_lut", "ragged n=1000003 silu float32 with inf/nan/"
                "past-table/half-steps", kgl.lut_activation(x, "silu"),
                kgl.lut_activation_plain(x, "silu"))


def _zero_tails(name, got, sizes):
    keep = torch.arange(got.shape[-2], device=got.device)[None, None, :,
                                                          None] \
        < sizes[:, :, None, None]
    if bool((got.masked_select(~keep) != 0).any()):
        raise AssertionError(f"{name}: rows past a queue not zero")


def check_moe_gemm() -> None:
    from repro_torch.core import routing as R
    from repro_torch.kernels import moe_gemm as kmg

    def one(label, buf, w, sizes):
        plan = kmg.plan_for(buf, w)
        got = planned("moe_gemm", kmg.moe_gemm, plan,
                      lambda: kmg.moe_gemm(buf, w, sizes))
        g, e, c, d = buf.shape
        check("moe_gemm", f"{label} G={g} E={e} C={c} D={d} "
              f"F={w.shape[2]} {_dt(buf)} ({int(sizes.sum())} rows live) "
              f"[{_plan_label(plan)}]", got,
              kmg.moe_gemm_plain(buf, w, sizes), buf.dtype)
        _zero_tails(f"moe_gemm {label}", got, sizes)

    # queue lengths from top-4 routing of random logits, 8 groups x 128
    logits = randn((BATCH, 128, 16), torch.float32, seed=9)
    sizes = R.dispatch_counts(R.route(logits, 4, 68), 16)
    for dtype in (torch.bfloat16, torch.float32):
        for label, d, f in (("w1", 192, 768), ("w2", 768, 192)):
            buf = randn((BATCH, 16, 68, d), dtype, seed=11)
            w = randn((16, d, f), dtype, 1.0 / math.sqrt(d), seed=12)
            one(label, buf, w, sizes)
    # NaN in every queue tail, a whole group empty, one expert empty in
    # every group, one queue full
    tails = sizes.clone()
    tails[0] = 0
    tails[:, 5] = 0
    tails[1, 3] = 68
    for label, d, f in (("w1", 192, 768), ("w2", 768, 192)):
        buf = randn((BATCH, 16, 68, d), torch.bfloat16, seed=15)
        rows = torch.arange(68, device="cuda")[None, None, :, None]
        buf = torch.where(rows < tails[:, :, None, None], buf,
                          torch.full((), math.nan, dtype=torch.bfloat16,
                                     device="cuda"))
        w = randn((16, d, f), torch.bfloat16, 1.0 / math.sqrt(d), seed=16)
        one(f"{label} NaN tails, group 0 and expert 5 empty", buf, w, tails)
    # ragged: 3 groups x 5 experts, C=13, D=37, F=29, empty and partial
    # queues, garbage in the queue tails
    rs = torch.tensor([[0, 13, 7, 0, 1], [5, 0, 0, 13, 2], [0, 0, 0, 0, 0]],
                      dtype=torch.int32, device="cuda")
    one("ragged", randn((3, 5, 13, 37), torch.float32, seed=13),
        randn((5, 37, 29), torch.float32, 0.2, seed=14), rs)
    # ragged on the tensor cores: C=13 (a 16-row tile), D=40 (one partial
    # k-tile), F=72 (a partial 64-column tile)
    one("ragged", randn((3, 5, 13, 40), torch.bfloat16, seed=17),
        randn((5, 40, 72), torch.bfloat16, 0.2, seed=18), rs)


def _fused_label(plan) -> str:
    if plan.variant == "simt":
        return "simt"
    return (f"tc {64 * plan.ny}-column slices, F whole, "
            f"{plan.stages} stages, {plan.blocks} blocks")


def _fused_params(kind, e, d, f, dtype, seed):
    if kind == "swiglu":
        return {"wg": randn((e, d, f), dtype, d ** -0.5, seed=seed),
                "wu": randn((e, d, f), dtype, d ** -0.5, seed=seed + 1),
                "wd": randn((e, f, d), dtype, f ** -0.5, seed=seed + 2)}
    return {"w1": randn((e, d, f), dtype, d ** -0.5, seed=seed),
            "b1": randn((e, f), torch.float32, 0.1, seed=seed + 1),
            "w2": randn((e, f, d), dtype, f ** -0.5, seed=seed + 2),
            "b2": randn((e, d), torch.float32, 0.1, seed=seed + 3)}


def check_moe_fused() -> None:
    from repro_torch.core import routing as R
    from repro_torch.core.gelu import device_table
    from repro_torch.kernels import moe_fused as kmf
    from repro_torch.kernels.compare import moe_lut_allowance

    def run(label, x, p, r, c, kind="gelu", use_lut=True):
        """One launch, which must move exactly its planned variant counter,
        held against the plain version; returns the output and a second
        launch on the same inputs."""
        e = p["wg" if kind == "swiglu" else "w1"].shape[0]
        sizes = R.dispatch_counts(r, e)
        args = (x, p, r.expert, r.gate, r.position, r.valid, sizes)
        kw = dict(kind=kind, capacity=c, use_lut=use_lut)
        table = device_table("silu" if kind == "swiglu" else "gelu", -8, 8.0,
                             x.device) if use_lut else None
        plan = kmf.plan_for(x, p, kind, c, table)
        got = planned("moe_fused", kmf.fused_moe_ffn, plan,
                      lambda: kmf.fused_moe_ffn(*args, **kw))
        g, t, d = x.shape
        check("moe_fused", f"{label}: G={g} T={t} E={e} "
              f"top-{r.expert.shape[-1]} C={c} d={d} {kind}"
              f"{'-lut' if use_lut else ' exact'} {_dt(x)}, "
              f"{int(sizes.sum())} of {r.valid.numel()} slots live "
              f"[{_fused_label(plan)}]", got,
              kmf.fused_moe_ffn_plain(*args, **kw), x.dtype,
              extra=moe_lut_allowance(x, p, r.expert, r.gate, r.valid,
                                      kind=kind) if use_lut else None)
        return got, lambda: planned("moe_fused", kmf.fused_moe_ffn, plan,
                                    lambda: kmf.fused_moe_ffn(*args, **kw))

    def routed(g, t, e, k, c, seed, hot=None, cold=None):
        logits = randn((g, t, e), torch.float32, seed=seed)
        if hot is not None:
            logits[..., hot] = 30.0
        if cold is not None:
            logits[..., cold] = -30.0
        return R.route(logits, k, c)

    g, t, e, k, d, f, c = BATCH, 128, 16, 4, 192, 768, 68
    r = routed(g, t, e, k, c, seed=50)
    for dtype in (torch.float32, torch.bfloat16):   # simt, then tc
        x = randn((g, t, d), dtype, seed=51)
        p = _fused_params("gelu", e, d, f, dtype, seed=52)
        first, again = run("M3ViT layer", x, p, r, c)
    # x, p: the bf16 layer; a second launch on the same inputs is
    # bit-identical to the first
    check_exact("moe_fused", "second launch on the same inputs", again(),
                first)
    run("exact GELU", x, p, r, c, use_lut=False)
    run("SwiGLU, SiLU through the LUT", x,
        _fused_params("swiglu", e, d, f, torch.bfloat16, seed=76), r, c,
        kind="swiglu")
    # every queue at capacity: 272 tokens a group, token t's slots to
    # experts 4t..4t+3 (mod 16), 68 slots each
    tf = 272
    dev = r.expert.device
    expert = ((4 * torch.arange(tf, device=dev)[:, None]
               + torch.arange(k, device=dev)) % e).int().expand(
                   g, tf, k).contiguous()
    position, valid = R.build_dispatch(expert, e, c)
    gate = torch.softmax(randn((g, tf, k), torch.float32, seed=60), -1)
    full = R.Routing(expert=expert, gate=gate,
                     position=position, valid=valid, probs=None)
    if not bool((R.dispatch_counts(full, e) == c).all()):
        raise AssertionError("moe_fused: expected every queue at capacity")
    run("every queue at capacity", randn((g, tf, d), torch.bfloat16,
                                         seed=61), p, full, c)
    # every token's one slot to expert 3: 60 rows a group, so each 64-row
    # tile spans two groups and the expert's tiles span all eight
    run("all tokens to one expert", randn((g, 60, d), torch.bfloat16,
                                          seed=62), p,
        routed(g, 60, e, 1, c, seed=63, hot=3), c)
    one_empty = routed(g, t, e, k, c, seed=64, cold=7)
    if bool((R.dispatch_counts(one_empty, e)[:, 7] != 0).any()):
        raise AssertionError("moe_fused: expected expert 7 empty")
    run("one empty expert", x, p, one_empty, c)
    run("top-1", x, p, routed(g, t, e, 1, c, seed=65), c)
    # two routing groups: a grid of 48 blocks for 132 SMs, f whole
    run("batch 2", x[:2].contiguous(), p, routed(2, t, e, k, c, seed=73), c)
    run("top-8 (capacity drops)", x, p, routed(g, t, e, 8, c, seed=66), c)
    # top-1 at capacity 4 drops most tokens; their x rows hold NaN, which no
    # queue reads and which must not reach any output
    sparse = routed(g, t, e, 1, 4, seed=67)
    dropped = ~sparse.valid.any(dim=-1)
    xn = x.clone()
    xn[dropped] = float("nan")
    got, _ = run("NaN in the x rows no queue reads", xn, p, sparse, 4)
    if not bool(dropped.any()) or not bool(torch.isfinite(got).all()) \
            or bool((got[dropped] != 0).any()):
        raise AssertionError("moe_fused: NaN rows of dropped tokens leaked "
                             "or dropped tokens were not exact zeros")
    # d = f = 768: four 192-column d-slices, a one-stage ring; d = 128:
    # one slice of two 64-column atoms
    run("d = f = 768", randn((g, t, 768), torch.bfloat16, seed=68),
        _fused_params("gelu", e, 768, 768, torch.bfloat16, seed=69), r, c)
    run("d = 128, f = 256", randn((g, t, 128), torch.bfloat16, seed=74),
        _fused_params("gelu", e, 128, 256, torch.bfloat16, seed=75), r, c)
    # ragged: 3 groups of 37 tokens, 5 SwiGLU experts with one never
    # chosen, top-2 at a capacity that drops slots, exact SiLU — on the
    # tensor cores at d = 24, f = 40 (partial atoms and chunks), then at
    # d = 36 (72-byte rows: simt) and in float32 (simt)
    ragged = routed(3, 37, 5, 2, 12, seed=70, cold=3)
    for dtype, dr in ((torch.bfloat16, 24), (torch.bfloat16, 36),
                      (torch.float32, 24)):
        got, _ = run("ragged (one empty expert)",
                     randn((3, 37, dr), dtype, seed=71),
                     _fused_params("swiglu", 5, dr, 40, dtype, seed=72),
                     ragged, 12, kind="swiglu", use_lut=False)
        dropped = ~ragged.valid.any(dim=-1)
        if not bool(dropped.any()) or bool((got[dropped] != 0).any()) \
                or bool((R.dispatch_counts(ragged, 5)[:, 3] != 0).any()):
            raise AssertionError("moe_fused ragged: expected an empty "
                                 "expert and dropped tokens with exact "
                                 "zeros")


def check_decode_fused() -> None:
    from repro_torch.kernels import attn_plan
    from repro_torch.kernels import decode_fused as kdf

    b, hq, hkv, smax, d = LM_BATCH, 32, 8, LM_MAX_LEN, 64
    # a zero length, Smax, and lengths on and around the 64-key split
    # boundaries
    cl = torch.tensor([0, 512, 1, 63, 64, 65, 300, 129], dtype=torch.int32,
                      device="cuda")
    plan = attn_plan.plan_decode(b, hq, hkv, smax)
    splits = f"{plan.splits} splits of {plan.split} keys, {plan.blocks} blocks"
    for dtype in (torch.bfloat16, torch.float32):
        # window 100 leaves the splits wholly behind the frontier unread
        for window in (None, 100, 5):
            q = randn((b, hq, 1, d), dtype, seed=61)
            k = randn((b, hkv, smax, d), dtype, seed=62)
            v = randn((b, hkv, smax, d), dtype, seed=63)
            got = kdf.fused_decode_attention(q, k, v, cl, window=window)
            label = (f"B={b} Hq={hq} Hkv={hkv} Smax={smax} D={d} cache_len "
                     f"{cl.tolist()} window={window} {_dt(q)} [{splits}]")
            check("decode_fused", label, got,
                  kdf.fused_decode_attention_plain(q, k, v, cl,
                                                   window=window), dtype)
            if bool((got[0] != 0).any()):
                raise AssertionError("decode_fused: cache_len 0 not zero")
            # the splits merge in a fixed order: a second launch is
            # bit-identical
            check_exact("decode_fused", f"{label} run 2 against run 1",
                        kdf.fused_decode_attention(q, k, v, cl,
                                                   window=window), got)
    # ragged: GQA 6/2 (group 3), head_dim 128, odd Smax, a zero length
    q = randn((3, 6, 1, 128), torch.float32, seed=64)
    k = randn((3, 2, 70, 128), torch.float32, seed=65)
    v = randn((3, 2, 70, 128), torch.float32, seed=66)
    cl3 = torch.tensor([70, 0, 9], dtype=torch.int32, device="cuda")
    check("decode_fused", "ragged B=3 Hq=6 Hkv=2 Smax=70 D=128 cache_len "
          "[70, 0, 9] window=5 float32",
          kdf.fused_decode_attention(q, k, v, cl3, window=5),
          kdf.fused_decode_attention_plain(q, k, v, cl3, window=5),
          torch.float32)
    # head_dim 256, MQA 16:1 (two chunks of 8 query heads), mixed lengths
    # across the split boundaries and past a ring's 2048 slots, window unset
    # (the ring decode) and set
    cl4 = torch.tensor([1, 63, 64, 65, 500, 2047, 2048, 0], dtype=torch.int32,
                       device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        for window in (None, 100):
            q = randn((8, 16, 1, 256), dtype, seed=70)
            k = randn((8, 1, RG_WINDOW, 256), dtype, seed=71)
            v = randn((8, 1, RG_WINDOW, 256), dtype, seed=72)
            plan = attn_plan.plan_decode(8, 16, 1, RG_WINDOW)
            label = (f"D=256 MQA B=8 Hq=16 Hkv=1 Smax={RG_WINDOW} cache_len "
                     f"{cl4.tolist()} window={window} {_dt(q)} "
                     f"[{plan.splits} splits, {plan.heads} heads a block in "
                     f"{plan.grid[2]} chunks]")
            got = kdf.fused_decode_attention(q, k, v, cl4, window=window)
            check("decode_fused", label, got,
                  kdf.fused_decode_attention_plain(q, k, v, cl4,
                                                   window=window), dtype)
            check_exact("decode_fused", f"{label} run 2 against run 1",
                        kdf.fused_decode_attention(q, k, v, cl4,
                                                   window=window), got)
    # ragged: a group of 12 in two chunks of heads, at head_dim 40 (rows of
    # 80 bytes: 16-byte copies) and 36 (72 bytes: element copies)
    cl2 = torch.tensor([130, 65], dtype=torch.int32, device="cuda")
    for d in (40, 36):
        q = randn((2, 24, 1, d), torch.bfloat16, seed=67)
        k = randn((2, 2, 130, d), torch.bfloat16, seed=68)
        v = randn((2, 2, 130, d), torch.bfloat16, seed=69)
        check("decode_fused", f"ragged B=2 Hq=24 Hkv=2 Smax=130 D={d} "
              f"cache_len [130, 65] bf16",
              kdf.fused_decode_attention(q, k, v, cl2),
              kdf.fused_decode_attention_plain(q, k, v, cl2), torch.bfloat16)


# ------------------------------------------------------- launch records


class Unit(NamedTuple):
    """The kernel launches of one uncounted twin of a counted run."""

    label: str      # what one run is
    runs: int       # forwards or decode steps recorded
    calls: dict     # kernel name -> [launch arguments, in launch order]


@contextlib.contextmanager
def recorded_launches(calls):
    """Record the arguments of every kernel launch made inside the block
    into ``calls`` (kernel name -> list; or a function returning the dict
    to record each launch into), at each kernel module's ``_launch`` — the
    one place its wrapper launches and counts.  The launches run and count
    as they would."""
    from repro_torch import kernels

    pick = calls if callable(calls) else (lambda: calls)
    saved = []
    for name, wrapper in kernels.KERNELS.items():
        mod = sys.modules[wrapper.__module__]

        def record(*args, _launch=mod._launch, _name=name):
            pick().setdefault(_name, []).append(args)
            return _launch(*args)

        saved.append((mod, mod._launch))
        mod._launch = record
    try:
        yield calls
    finally:
        for mod, launch in saved:
            mod._launch = launch


#: kernel -> variant -> launches, summed over the counted main-path runs
#: (the variant counters of the GEMM, flash_attention and moe_fused
#: wrappers)
COUNTED_VARIANTS: dict = {}


def read_variants(label, simt_ok=None, tally=True) -> dict:
    """The variant counters of the GEMM, flash_attention and moe_fused
    wrappers after a counted run: printed, added to COUNTED_VARIANTS, and
    none may be the SIMT route (every main path runs bf16 at 16-byte
    aligned shapes and a head_dim of 64, 128 or 256) — except, where
    ``simt_ok`` names a kernel, exactly the stated number of launches
    whose rows no TMA map can address, with the reason printed (xLSTM's
    sLSTM projections, ``_slstm_simt``).  ``tally=False``: a run checked
    only, kept out of COUNTED_VARIANTS."""
    from repro_torch.kernels import variant_counts

    counts = variant_counts()
    print(f"  kernel variants over {label}: {json.dumps(counts)}")
    for name, by in counts.items():
        allowed, why = (simt_ok or {}).get(name, (0, None))
        if by.get("simt", 0) != allowed:
            raise AssertionError(f"{name}: {by.get('simt', 0)} SIMT "
                                 f"launches on a main path ({allowed} "
                                 f"allowed)")
        if allowed:
            print(f"  {name}: the {allowed} SIMT launches allowed by name: "
                  f"{why}")
        if not tally:
            continue
        total = COUNTED_VARIANTS.setdefault(name, {})
        for v, k in by.items():
            total[v] = total.get(v, 0) + k
    return counts


# ------------------------------------------------------------ phase 3


def _m3vit_twins(server, batches, policy_label, units):
    """One more (uncounted) forward of each task, its launches recorded."""
    for task, imgs in batches:
        with recorded_launches({}) as calls:
            server.infer(imgs, task)
        units.append(Unit(f"M3ViT {task} forward, B={BATCH}, "
                          f"{policy_label}", 1, calls))


def main_path(units):
    from repro_torch import ops
    from repro_torch.configs import m3vit as MV
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.compare import cosine
    from repro_torch.models.vit import init_params
    from repro_torch.serve.vision import M3ViTServer

    cfg = replace(MV.CONFIG, policy=ops.policy_named("cuda"))
    plain_cfg = replace(MV.CONFIG, policy=ops.policy_named("blocked"))
    params = init_params(0, cfg)
    server = M3ViTServer(cfg, params)
    plain = M3ViTServer(plain_cfg, params)
    rng = np.random.default_rng(0)
    requests = [(MV.TASKS[i // 8],
                 rng.normal(size=(MV.IMAGE_H, MV.IMAGE_W, 3))
                 .astype(np.float32)) for i in range(16)]
    batches = [(task, np.stack([img for t, img in requests if t == task]))
               for task in MV.TASKS]
    print(f"  M3ViT {cfg.num_layers} layers d={cfg.d_model} "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} "
          f"{cfg.dtype}: 16 requests (8 semseg, 8 depth) in batches of 8")
    for task, imgs in batches * 3:          # warm-up, not counted
        server.infer(imgs, task)
    _m3vit_twins(server, batches, "policy cuda", units)
    torch.cuda.synchronize()

    reset_launch_counts()
    ops.reset_dispatch_report()
    outs = {task: server.infer(imgs, task)      # returns on the host
            for task, imgs in batches}
    counts = launch_counts()
    report = ops.dispatch_report()
    read_variants("the 16 requests")

    expected = {"semseg": (BATCH, MV.IMAGE_H, MV.IMAGE_W,
                           MV.NUM_SEG_CLASSES),
                "depth": (BATCH, MV.IMAGE_H, MV.IMAGE_W)}
    for task, imgs in batches:
        y = outs[task]
        if y.shape != expected[task] or not np.isfinite(y).all():
            raise AssertionError(f"{task}: output {y.shape} not finite of "
                                 f"shape {expected[task]}")
        ref = plain.infer(imgs, task)
        cos = cosine(torch.from_numpy(y), torch.from_numpy(ref))
        print(f"  {task}: output {tuple(y.shape)} finite; cosine vs plain "
              f"eager/blocked/lut policy on the card {cos:.6f} "
              f"(>= 0.999: {'ok' if cos >= 0.999 else 'FAIL'})")
        if cos < 0.999:
            raise AssertionError(f"{task}: cosine {cos} < 0.999")
    print(f"  launches over the 16 requests: {json.dumps(counts)}")
    if not all(counts[n] > 0 for n in CUDA_PATH_KERNELS):
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{counts}")
    for op in ("linear", "attention", "moe_grouped_gemm", "activation"):
        entry = report.get(op, {})
        if entry.get("fallbacks") or entry.get("modes", {}).get("cuda") \
                != {"cuda": entry.get("hits", {}).get("cuda", -1)}:
            raise AssertionError(f"dispatch report for {op}: {entry}")
    print(f"  dispatch report: {json.dumps(report)}")
    _time_batches(server, batches)
    batch_independence(server, batches, "policy cuda")
    return counts, {"params": params, "batches": batches, "plain": plain,
                    "outs": outs}


def _time_batches(server, batches):
    from repro_torch.serve.profile import wall_per_batch

    for task, imgs in batches:
        wall = statistics.median(wall_per_batch(server, imgs, task, reps=5,
                                                warmup=0))
        print(f"  {task}: {wall * 1e3:.3f} ms per batch of {BATCH} (median "
              f"of 5, host wall to the result on the host), "
              f"{BATCH / wall:.1f} img/s")


def fused_path(ctx, units):
    """The 16 requests again, the routed expert layers through moe_fused."""
    from repro_torch import ops
    from repro_torch.configs import m3vit as MV
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.compare import cosine
    from repro_torch.serve.vision import M3ViTServer

    policy = ops.policy_named("cuda").with_impls(moe_ffn="cuda_fused")
    server = M3ViTServer(replace(MV.CONFIG, policy=policy), ctx["params"])
    batches = ctx["batches"]
    print("  policy cuda with moe_ffn=cuda_fused: the same 16 requests")
    for task, imgs in batches * 3:          # warm-up, not counted
        server.infer(imgs, task)
    _m3vit_twins(server, batches, "policy cuda + moe_ffn=cuda_fused", units)
    torch.cuda.synchronize()

    reset_launch_counts()
    ops.reset_dispatch_report()
    outs = {task: server.infer(imgs, task) for task, imgs in batches}
    counts = launch_counts()
    report = ops.dispatch_report()
    variants = read_variants("the 16 requests (fused)")

    for task, imgs in batches:
        y = outs[task]
        if not np.isfinite(y).all():
            raise AssertionError(f"{task}: fused output not finite")
        cos = cosine(torch.from_numpy(y),
                     torch.from_numpy(ctx["plain"].infer(imgs, task)))
        print(f"  {task}: cosine vs plain eager/blocked/lut policy on the "
              f"card {cos:.6f} (>= 0.999: {'ok' if cos >= 0.999 else 'FAIL'})")
        if cos < 0.999:
            raise AssertionError(f"{task}: fused cosine {cos} < 0.999")
    print(f"  launches over the 16 requests: {json.dumps(counts)}")
    n_moe = 2 * (MV.CONFIG.num_layers // 2)        # two forwards
    if variants["moe_fused"] != {"tc": n_moe, "simt": 0}:
        raise AssertionError(f"moe_fused variants {variants['moe_fused']}: "
                             f"all {n_moe} launches must take tc")
    if counts["moe_fused"] != n_moe or counts["moe_gemm"] \
            or counts["gelu_lut"] or not counts["unified_linear"] \
            or not counts["flash_attention"]:
        raise AssertionError(f"fused path launches: {counts} (moe_fused "
                             f"must be {n_moe}, moe_gemm and gelu_lut 0)")
    entry = report.get("moe_ffn", {})
    if entry.get("hits") != {"cuda_fused": n_moe} or entry.get("fallbacks") \
            or entry.get("modes") != {"cuda_fused": {"cuda": n_moe}}:
        raise AssertionError(f"dispatch report for moe_ffn: {entry}")
    print(f"  dispatch report moe_ffn: {json.dumps(entry)}")
    _time_batches(server, batches)
    batch_independence(server, batches, "policy cuda + moe_ffn=cuda_fused")
    return counts


def batch_independence(server, batches, label):
    """Frame 0 of each task served alone and at batch 2 and 4 must give
    the bits it gets at batch 8 (the other frames of a batch are other
    images)."""
    for task, imgs in batches:
        full = server.infer(imgs, task)[0]
        diffs = {b: float(np.abs(server.infer(imgs[:b], task)[0]
                                 - full).max()) for b in (1, 2, 4)}
        print(f"  {label}, {task}: frame 0 at batch 1, 2, 4 against batch "
              f"{len(imgs)}: max abs diff {json.dumps(diffs)}")
        if any(diffs.values()):
            raise AssertionError(f"{label}, {task}: frame 0 depends on its "
                                 f"batch: {diffs}")


def paged_path(ctx):
    """The 16 requests through expert paging under ``cuda``: 8 of the 16
    experts of each MoE layer resident, synchronous, then through the
    copy-stream TransferEngine, then under a budget of four experts'
    bytes.  Every output must equal the all-resident ``cuda`` run's bit
    for bit; the waves run moe_gemm (all on tc) and gelu_lut.  These runs'
    launches are checked and printed here and stay out of phase 5, which
    times the same kernels at the same per-queue shapes."""
    from repro_torch import ops
    from repro_torch.configs import m3vit as MV
    from repro_torch.kernels import (launch_counts, reset_launch_counts,
                                     variant_counts)
    from repro_torch.serve.vision import M3ViTServer

    cfg = replace(MV.CONFIG, policy=ops.policy_named("cuda"))
    batches, want = ctx["batches"], ctx["outs"]
    # each run's arguments from the bytes of one expert, which the first
    # run's cache reports
    runs = (("synchronous, resident_fraction 0.5",
             lambda _: dict(resident_fraction=0.5)),
            ("asynchronous (TransferEngine), resident_fraction 0.5",
             lambda _: dict(resident_fraction=0.5, async_paging=True)),
            ("asynchronous, budget of four experts' bytes",
             lambda nbytes: dict(async_paging=True,
                                 expert_budget_bytes=4 * nbytes)))
    n_moe = MV.CONFIG.num_layers // 2
    per_expert = 0
    for label, make in runs:
        server = M3ViTServer(cfg, ctx["params"], **make(per_expert))
        layer = next(iter(server.paged.values()))
        per_expert = layer.cache.stats()["paged_expert_bytes"]
        for task, imgs in batches:          # warm-up, not counted
            server.infer(imgs, task)
        torch.cuda.synchronize()
        server.reset_stats()
        reset_launch_counts()
        ops.reset_dispatch_report()
        outs = {task: server.infer(imgs, task) for task, imgs in batches}
        counts = launch_counts()
        variants = variant_counts()
        report = ops.dispatch_report()
        stats = server.cache_stats()
        waves = [len(p.last_timeline) for p in server.paged.values()]
        print(f"  paged, {label}: {layer.cache.max_resident} of "
              f"{MV.CONFIG.moe.num_experts} experts resident per layer, "
              f"{per_expert} bytes an expert")
        for task, _ in batches:
            if not np.array_equal(outs[task], want[task]):
                raise AssertionError(
                    f"paged {label}, {task}: output differs from the "
                    f"all-resident cuda run (max abs diff "
                    f"{float(np.abs(outs[task] - want[task]).max())})")
        print(f"    outputs of both tasks bit-identical to the all-resident "
              f"cuda run")
        print(f"    launches over the 16 requests: {json.dumps(counts)}; "
              f"moe_gemm variants {json.dumps(variants['moe_gemm'])}")
        if not (counts["moe_gemm"] and counts["gelu_lut"]
                and counts["unified_linear"] and counts["flash_attention"]) \
                or counts["moe_fused"] or variants["moe_gemm"]["simt"] \
                or variants["moe_gemm"]["tc"] != counts["moe_gemm"]:
            raise AssertionError(f"paged {label}: launches {counts}, "
                                 f"moe_gemm variants {variants['moe_gemm']}")
        for op in ("linear", "attention", "moe_grouped_gemm", "activation"):
            entry = report.get(op, {})
            if entry.get("fallbacks") or entry.get("modes", {}).get(
                    "cuda") != {"cuda": entry.get("hits", {}).get("cuda", -1)}:
                raise AssertionError(f"paged dispatch report for {op}: "
                                     f"{entry}")
        print(f"    dispatch report: every linear, attention, "
              f"moe_grouped_gemm and activation on the card's kernels "
              f"({json.dumps({op: report[op]['hits'] for op in report})})")
        print(f"    waves per MoE layer (last forward): {waves}; cache over "
              f"the 2 batches: hits {stats['hits']}, misses "
              f"{stats['misses']}, evictions {stats['evictions']}, hit rate "
              f"{stats['hit_rate']:.4f}, {stats['bytes_paged'] / 2:.0f} "
              f"bytes paged per batch")
        if server.engine is not None:
            if not stats["hidden_s"] > 0:
                raise AssertionError(f"paged {label}: no copy time hidden "
                                     f"behind compute: {stats}")
            print(f"    transfers: stall {stats['stall_s'] * 1e3:.3f} ms, "
                  f"hidden {stats['hidden_s'] * 1e3:.3f} ms, overlap ratio "
                  f"{stats['overlap_ratio']:.4f} over the 2 batches")
        if len(waves) != n_moe:
            raise AssertionError(f"paged {label}: {len(waves)} paged layers")
        server.reset_stats()
        _time_batches(server, batches)
        if server.engine is not None:
            stats = server.cache_stats()
            print(f"    over the timed batches: stall "
                  f"{stats['stall_s'] * 1e3:.3f} ms, hidden "
                  f"{stats['hidden_s'] * 1e3:.3f} ms, overlap ratio "
                  f"{stats['overlap_ratio']:.4f}, hit rate "
                  f"{stats['hit_rate']:.4f}")


def _pct_ms(values, p) -> float:
    return float(np.percentile(values, p)) * 1e3 if len(values) else 0.0


def scheduler_vision(ctx, units):
    """The 16 requests (8 of each task, all due at once) through the
    continuous-batching scheduler's per-task buckets of 4 (``total_slots``
    8), all resident and paged at ``resident_fraction`` 0.5, under ``cuda``
    and under ``moe_ffn="cuda_fused"``: every result equal to its server's
    ``infer`` of the same frames at batch 8, bit for bit.  The all-resident
    runs are counted (and their launches recorded by an uncounted twin for
    phase 5); the paged ones are checked and printed only."""
    from repro_torch import ops
    from repro_torch.configs import m3vit as MV
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import Request, Scheduler, VisionBackend

    cuda = ops.policy_named("cuda")
    fused = cuda.with_impls(moe_ffn="cuda_fused")
    total = {}
    batches = ctx["batches"]
    for label, policy, frac in (("cuda", cuda, 1.0),
                                ("cuda + moe_ffn=cuda_fused", fused, 1.0),
                                ("cuda", cuda, 0.5),
                                ("cuda + moe_ffn=cuda_fused", fused, 0.5)):
        backend = VisionBackend(replace(MV.CONFIG, policy=policy),
                                ctx["params"], resident_fraction=frac)
        want = {task: backend.server.infer(imgs, task)
                for task, imgs in batches}

        def serve():
            sched = Scheduler(backend, total_slots=2 * 4, quantum=1,
                              num_tasks=len(MV.TASKS))
            done = sched.run([
                Request(rid=t * BATCH + j, task_id=t, prompt=imgs[j])
                for t, (_, imgs) in enumerate(batches)
                for j in range(len(imgs))])
            return sched, done

        serve()                                 # warm-up, not counted
        torch.cuda.synchronize()
        counted = frac == 1.0
        reset_launch_counts()
        sched, done = serve()
        counts = launch_counts()
        m = sched.metrics()
        lat = [r.latency for r in done]
        print(f"  scheduler, {label}, resident_fraction {frac}: 16 requests "
              f"in buckets of {sched.slots_per_bucket}: {m['items_per_s']:.1f}"
              f" img/s, latency p50 {_pct_ms(lat, 50):.3f} ms p99 "
              f"{_pct_ms(lat, 99):.3f} ms (host wall, all due at once)")
        if len(done) != 2 * BATCH:
            raise AssertionError(f"scheduler {label}: {len(done)} done")
        for r in done:
            task, j = MV.TASKS[r.task_id], r.rid % BATCH
            if not np.array_equal(r.result, want[task][j]):
                raise AssertionError(
                    f"scheduler {label} at {frac}: request {r.rid} differs "
                    f"from infer at batch {BATCH} (max abs diff "
                    f"{float(np.abs(r.result - want[task][j]).max())})")
        print(f"    every result bit-identical to infer of the same frames "
              f"at batch {BATCH}; launches {json.dumps(counts)}")
        need = ("unified_linear", "flash_attention") + (
            ("moe_fused",) if policy is fused and frac == 1.0
            else ("moe_gemm", "gelu_lut"))
        if not all(counts[n] for n in need):
            raise AssertionError(f"scheduler {label}: a kernel of the path "
                                 f"never launched: {counts}")
        if not counted:
            continue
        read_variants(f"the scheduler's 16 requests ({label})")
        for n, c in counts.items():
            total[n] = total.get(n, 0) + c
        with recorded_launches({}) as calls:
            serve()
        units.append(Unit(f"M3ViT scheduler forward, bucket of 4, policy "
                          f"{label}", sched.buckets[0].steps
                          + sched.buckets[1].steps, calls))
    return total


def _packed_policies(factored: bool):
    """(kernel policy, plain preset's name) of a packed run: ``cuda`` with
    the packed ops overridden as ``launch/serve.py`` does, and the
    reference's preset in the port's names."""
    from repro_torch import ops
    from repro_torch.launch.serve import INT8_OPS

    if factored:
        return (ops.policy_named("cuda").with_impls(
            moe_grouped_gemm="eager_factored"), "eager_factored")
    return (ops.policy_named("cuda").with_impls(
        **{op: "eager_int8" for op in INT8_OPS}), "eager_int8")


def _diff_counts(server, batches, label):
    """Frame 0 at batch 1, 2 and 4 against its row at batch 8: the number
    of differing elements, printed (float32 cuBLAS products pick their
    algorithm from the row count, so the packed impls make no claim)."""
    for task, imgs in batches:
        full = server.infer(imgs, task)[0]
        counts = {b: int((server.infer(imgs[:b], task)[0] != full).sum())
                  for b in (1, 2, 4)}
        print(f"    {label}, {task}: frame 0 at batch 1, 2, 4 against "
              f"batch {len(imgs)}: {json.dumps(counts)} of {full.size} "
              f"elements differ (printed, not gated)")


def packed_path(ctx):
    """The 16 requests with packed expert formats (checked and printed
    only; their launches stay out of phase 5): int8 and int4 weights
    (``quant.quantize_tree``), rank-8 factored experts with float32 deltas
    and butterfly ones with int8 deltas (``M3ViTServer(factor=...)``),
    under ``cuda`` with the packed ops overridden.  Each task held to
    cosine >= 0.999 against the same packed parameters under the plain
    preset; the cosine against the unquantized ``cuda`` run printed
    beside the reference's int8 bar; ``flash_attention`` and ``gelu_lut``
    (and, factored, ``unified_linear``) launched as dispatch hits; the
    packed impls hits with no fallback; paged at 0.5, synchronously and
    through the TransferEngine, ``np.array_equal`` to the format's own
    all-resident run; the slots of a four-bf16-expert budget."""
    from repro_torch import ops
    from repro_torch.configs import m3vit as MV
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.compare import cosine
    from repro_torch.quant import quantize_tree
    from repro_torch.serve.vision import M3ViTServer

    batches, base = ctx["batches"], ctx["outs"]
    experts = [n for n in ctx["params"] if n.startswith("layers.b1.moe.")
               and n.rsplit(".", 1)[1] in ("w1", "b1", "w2", "b2")]
    bf16_expert = sum(ctx["params"][n][0, 0].nbytes for n in experts)
    budget = 4 * bf16_expert
    print(f"  packed formats: one bf16 expert {bf16_expert} bytes, the "
          f"four-expert budget {budget} bytes a layer")
    formats = (("int8", 8, None, 7), ("int4", 4, None, 12),
               ("rank:8, float32 deltas", None, ("rank", 8, None), None),
               ("butterfly, int8 deltas", None, ("butterfly", 0, 8), None))
    for label, bits, factor, want_slots in formats:
        kernel_pol, preset = _packed_policies(factor is not None)
        params = ctx["params"] if bits is None else quantize_tree(
            ctx["params"], bits=bits)

        def server(policy, **kw):
            return M3ViTServer(replace(MV.CONFIG, policy=policy), params,
                               factor=factor, **kw)

        resident = server(kernel_pol)
        for task, imgs in batches:             # warm-up, not counted
            resident.infer(imgs, task)
        torch.cuda.synchronize()
        reset_launch_counts()
        ops.reset_dispatch_report()
        outs = {task: resident.infer(imgs, task) for task, imgs in batches}
        counts = launch_counts()
        report = ops.dispatch_report()
        plain = server(ops.policy_named(preset))
        print(f"  packed {label}: launches over the 16 requests "
              f"{json.dumps(counts)}")
        for task, imgs in batches:
            y = outs[task]
            if not np.isfinite(y).all():
                raise AssertionError(f"packed {label}, {task}: not finite")
            cos = cosine(torch.from_numpy(y),
                         torch.from_numpy(plain.infer(imgs, task)))
            vs_base = cosine(torch.from_numpy(y),
                             torch.from_numpy(base[task]))
            print(f"    {task}: cosine vs the plain {preset} preset on "
                  f"the card {cos:.6f} (>= 0.999: "
                  f"{'ok' if cos >= 0.999 else 'FAIL'}); vs the unquantized "
                  f"cuda run {vs_base:.6f} (reference int8 bar 0.999, set "
                  f"on a float32 smoke model: a reading)")
            if cos < 0.999:
                raise AssertionError(f"packed {label}, {task}: cosine {cos}")
        need = ("flash_attention", "gelu_lut") + (
            ("unified_linear",) if factor is not None else ())
        if not all(counts[n] for n in need) or counts["moe_fused"] \
                or counts["moe_gemm"]:
            raise AssertionError(f"packed {label}: launches {counts}")
        hits = {"moe_grouped_gemm": preset,
                "linear": "cuda" if factor is not None else preset,
                "attention": "cuda", "activation": "cuda"}
        for op, name in hits.items():
            entry = report.get(op, {})
            n = entry.get("hits", {}).get(name, 0)
            modes = entry.get("modes", {})
            if not n or entry.get("fallbacks") or set(entry["hits"]) != {
                    name} or (name == "cuda" and modes != {
                        "cuda": {"cuda": n}}):
                raise AssertionError(f"packed {label}: dispatch report for "
                                     f"{op}: {entry}")
        print(f"    dispatch report: "
              f"{json.dumps({op: report[op]['hits'] for op in hits})}, no "
              f"fallbacks; the kernels on the card")
        _time_batches(resident, batches)
        _diff_counts(resident, batches, f"packed {label}")
        runs = (("paged 0.5, synchronous", dict(resident_fraction=0.5)),
                ("paged 0.5, TransferEngine",
                 dict(resident_fraction=0.5, async_paging=True)),
                ("four-bf16-expert budget",
                 dict(expert_budget_bytes=budget)))
        for run_label, kw in runs:
            paged = server(kernel_pol, **kw)
            cache = next(iter(paged.paged.values())).cache
            for task, imgs in batches:         # warm-up, not counted
                paged.infer(imgs, task)
            torch.cuda.synchronize()
            paged.reset_stats()
            got = {task: paged.infer(imgs, task) for task, imgs in batches}
            for task, _ in batches:
                if not np.array_equal(got[task], outs[task]):
                    raise AssertionError(
                        f"packed {label}, {run_label}, {task}: differs from "
                        f"its all-resident run (max abs diff "
                        f"{float(np.abs(got[task] - outs[task]).max())})")
            st = paged.cache_stats()
            print(f"    {run_label}: {cache.max_resident} of "
                  f"{MV.CONFIG.moe.num_experts} experts resident a layer, "
                  f"{cache.stats()['paged_expert_bytes']} bytes an expert, "
                  f"{cache.pinned_bytes} pinned bytes a layer; outputs "
                  f"bit-identical to the all-resident run; hit rate "
                  f"{st['hit_rate']:.4f}, {st['bytes_paged'] / 2:.0f} bytes "
                  f"paged per batch")
            if want_slots is not None and "budget" in run_label \
                    and cache.max_resident < min(
                        want_slots, MV.CONFIG.moe.num_experts):
                raise AssertionError(f"packed {label}: the budget holds "
                                     f"{cache.max_resident} experts, fewer "
                                     f"than {want_slots}")
            if "budget" not in run_label:
                _time_batches(paged, batches)


# ------------------------------------------------------------ phase 4


def lm_path(units):
    """Llama-3.2-1B at full width and depth: prefill + 32 decode steps."""
    import time

    from repro_torch import ops
    from repro_torch.configs import llama3_2_1b as LL
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.compare import cosine
    from repro_torch.models import model as LM
    from repro_torch.serve.engine import ServeConfig, ServingEngine
    from repro_torch.train.step import make_serve_step

    policy = ops.policy_named("cuda").with_impls(attention_decode="cuda_fused")
    cfg = LL.CONFIG
    t0 = time.perf_counter()
    params = LM.init_params(0, cfg)
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in params.values())
    print(f"  Llama-3.2-1B {cfg.num_layers} layers d={cfg.d_model} "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.hd} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} {cfg.dtype}: "
          f"{n_params / 1e9:.3f} B parameters from seed 0 in "
          f"{time.perf_counter() - t0:.1f} s")
    engine = ServingEngine(cfg, params, ServeConfig(max_len=LM_MAX_LEN,
                                                    policy=policy))
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(LM_BATCH, LM_PROMPT))).cuda()
    engine.generate(prompts, 2)               # warm-up, not counted
    torch.cuda.synchronize()

    reset_launch_counts()
    ops.reset_dispatch_report()
    t0 = time.perf_counter()
    tokens = engine.generate(prompts, LM_NEW)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    report = ops.dispatch_report()
    read_variants("the generate call")
    print(f"  {LM_BATCH} prompts of {LM_PROMPT} tokens, {LM_NEW} greedy "
          f"tokens each: {wall * 1e3:.1f} ms host wall, "
          f"{LM_BATCH * LM_NEW / wall:.1f} tokens/s")
    print(f"  launches over the generate call: {json.dumps(counts)}")
    if tokens.shape != (LM_BATCH, LM_NEW) or not (
            (tokens >= 0) & (tokens < cfg.vocab_size)).all():
        raise AssertionError(f"generated tokens {tokens.shape} out of range")
    if counts["decode_fused"] != cfg.num_layers * LM_NEW \
            or not counts["unified_linear"] or not counts["flash_attention"]:
        raise AssertionError(f"LM path launches: {counts} (decode_fused must "
                             f"be {cfg.num_layers * LM_NEW})")
    hits = {"linear": "cuda", "attention": "cuda",
            "attention_decode": "cuda_fused"}
    for op, impl in hits.items():
        entry = report.get(op, {})
        n = entry.get("hits", {}).get(impl, -1)
        if entry.get("fallbacks") or entry.get("modes") != {impl: {"cuda": n}}:
            raise AssertionError(f"dispatch report for {op}: {entry}")
    print(f"  dispatch report: {json.dumps(report)}")

    # the prefill and every decode step again, teacher-forced on the
    # generated tokens, under the kernel policy and the plain one; the
    # first prefill and the kernel policy's decode steps are the counted
    # generate call's uncounted twin, their launches recorded
    plain_prefill, plain_decode = make_serve_step(
        replace(cfg, policy=ops.policy_named("eager")))
    prefill, decode = engine.steps()
    toks = torch.from_numpy(tokens).long().cuda()
    prefill_calls, decode_calls = {}, {}
    cosines, step_ms, prefill_ms = [], [], []
    with torch.inference_mode():
        for rep in range(3):
            state = LM.init_state(cfg, LM_BATCH, LM_MAX_LEN)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with recorded_launches(prefill_calls if rep == 0 else {}):
                logits, state = prefill(engine.params, prompts, state)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
        pstate = LM.init_state(cfg, LM_BATCH, LM_MAX_LEN)
        plain, pstate = plain_prefill(engine.params, prompts, pstate)
        for i in range(LM_NEW):
            if not torch.equal(torch.argmax(logits, -1), toks[:, i]):
                raise AssertionError(f"step {i}: the replayed logits do not "
                                     "give back the generated tokens")
            cosines.append(cosine(logits, plain))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with recorded_launches(decode_calls):
                logits, state = decode(engine.params, toks[:, i:i + 1],
                                       state, LM_PROMPT + i)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            plain, pstate = plain_decode(engine.params, toks[:, i:i + 1],
                                         pstate, LM_PROMPT + i)
        cosines.append(cosine(logits, plain))
    print(f"  logits vs the plain eager policy on the card, teacher-forced: "
          f"prefill cosine {cosines[0]:.6f}, decode steps min "
          f"{min(cosines[1:]):.6f} (>= 0.999: "
          f"{'ok' if min(cosines) >= 0.999 else 'FAIL'})")
    if min(cosines) < 0.999:
        raise AssertionError(f"LM logits cosine {min(cosines)} < 0.999")
    print(f"  prefill {statistics.median(prefill_ms):.3f} ms (median of 3, "
          f"B={LM_BATCH} x {LM_PROMPT} tokens); decode "
          f"{statistics.median(step_ms):.3f} ms per step (median of "
          f"{LM_NEW}, B={LM_BATCH}, host wall to a synchronized card)")
    units.append(Unit(f"Llama-3.2-1B prefill, B={LM_BATCH} x {LM_PROMPT} "
                      f"tokens", 1, prefill_calls))
    units.append(Unit(f"Llama-3.2-1B decode step, B={LM_BATCH}, cache "
                      f"{LM_PROMPT + 1}-{LM_PROMPT + LM_NEW} keys", LM_NEW,
                      decode_calls))
    return counts, {"cfg": cfg, "params": params, "policy": policy,
                    "engine": engine, "prompts": prompts.cpu().numpy(),
                    "tokens": tokens}


@contextlib.contextmanager
def recorded_by_phase(backend):
    """Record a scheduler run's kernel launches (``recorded_launches``)
    into two dicts: the decode steps' and the admissions' (prefills,
    chunks), by wrapping the LM backend's decode step."""
    rec = {"admit": {}, "decode": {}}
    cur = [rec["admit"]]
    make = backend.decode_step

    def decode_step():
        fn = make()

        def step(*args):
            cur[0] = rec["decode"]
            try:
                return fn(*args)
            finally:
                cur[0] = rec["admit"]
        return step

    backend.decode_step = decode_step
    try:
        with recorded_launches(lambda: cur[0]):
            yield rec
    finally:
        del backend.decode_step


def _scheduler_report(label, sched, done):
    """Print a scheduler run's end-to-end metrics; returns them."""
    m = sched.metrics()
    bucket = sched.buckets[None]
    tpot = [r.tpot for r in done if np.isfinite(r.tpot)]
    ttft = [r.ttft for r in done]
    per_step = (bucket.host_syncs - bucket.admissions) / max(bucket.steps, 1)
    print(f"  {label}: {len(done)} requests, {m['tokens']} tokens in "
          f"{m['span_s'] * 1e3:.1f} ms: {m['tok_per_s']:.1f} tok/s, TTFT p50 "
          f"{_pct_ms(ttft, 50):.3f} ms p99 {_pct_ms(ttft, 99):.3f} ms, TPOT "
          f"p50 {_pct_ms(tpot, 50):.3f} ms p99 {_pct_ms(tpot, 99):.3f} ms, "
          f"slot utilization {m.get('slot_utilization', 0.0):.4f}, "
          f"{bucket.steps} decode steps, {per_step:.2f} host syncs a decode "
          f"step, {bucket.admissions} admissions (one sync each)")
    if per_step != 1.0:
        raise AssertionError(f"{label}: {per_step} host syncs a decode step")
    return m


def _nonuniform(decode_calls) -> int:
    """decode_fused launches whose slots' cache lengths differ."""
    return sum(int(args[3].min()) != int(args[3].max())
               for args in decode_calls.get("decode_fused", ()))


def scheduler_lm(ctx, units):
    """Llama-3.2-1B at full width through the continuous-batching
    scheduler (8 slots, ``max_len`` 512, ``cuda`` with
    ``attention_decode="cuda_fused"``): (a) the 8 prompts of 128 tokens
    of the static run, whose tokens must come back bit for bit; (b) 32
    requests of 16..128-token prompts (16, 64, 70 and 80 among them) and
    8..32 new tokens, each equal to the static engine serving its prompt
    alone and in a batch of 8 copies; (c) a bursty multi-tenant trace
    under SLO tiers with preemption, chunked admission (64-token chunks)
    and a 32-entry prefix cache, on a tick clock, each request equal to
    the engine serving it alone, with at least one preemption, restore and
    prefix hit.  (a) and (b) are counted and recorded (phase 5); (c) is
    checked and printed only."""
    import time

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import LMBackend, Request, Scheduler, ServeConfig
    from repro_torch.serve.slo import (SLOPolicy, TickClock, TraceConfig,
                                       TraceGenerator)

    cfg, engine = ctx["cfg"], ctx["engine"]
    scfg = ServeConfig(max_len=LM_MAX_LEN, policy=ctx["policy"])
    backend = LMBackend(cfg, ctx["params"], scfg)
    rng = np.random.default_rng(1)
    lengths = [16, 64, 70, 80] + rng.integers(16, 129, 28).tolist()
    news = rng.integers(8, 33, 32).tolist()
    runs = {
        "a": [dict(rid=i, task_id=0, prompt=ctx["prompts"][i],
                   max_new_tokens=LM_NEW) for i in range(LM_BATCH)],
        "b": [dict(rid=i, task_id=0, prompt=rng.integers(
            0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=m)
              for i, (n, m) in enumerate(zip(lengths, news))]}
    want = {"a": {i: ctx["tokens"][i].tolist() for i in range(LM_BATCH)}}
    t0 = time.perf_counter()
    want["b"] = {}
    for spec in runs["b"]:
        p, m = spec["prompt"][None], spec["max_new_tokens"]
        alone = engine.generate(p, m)
        copies = engine.generate(np.repeat(p, LM_BATCH, 0), m)
        if not (copies == alone).all():
            raise AssertionError(f"request {spec['rid']} ({p.shape[1]} "
                                 f"tokens): the static engine's tokens "
                                 f"depend on its batch")
        want["b"][spec["rid"]] = alone[0].tolist()
    print(f"  static engine, each of the 32 prompts alone and in a batch of "
          f"{LM_BATCH} copies: the same tokens "
          f"({time.perf_counter() - t0:.1f} s)")

    def serve(specs):
        sched = Scheduler(backend, total_slots=LM_BATCH, quantum=4,
                          num_tasks=1)
        return sched, sched.run([Request(**s) for s in specs])

    total = {}
    for key, label in (("a", f"scheduler (a), the {LM_BATCH} prompts of "
                              f"{LM_PROMPT} tokens"),
                       ("b", "scheduler (b), 32 prompts of 16..128 tokens, "
                             "8..32 new")):
        torch.cuda.synchronize()
        reset_launch_counts()
        sched, done = serve(runs[key])
        counts = launch_counts()
        _scheduler_report(label, sched, done)
        read_variants(label)
        for r in done:
            if r.tokens != want[key][r.rid]:
                raise AssertionError(f"{label}: request {r.rid} (prompt "
                                     f"{len(r.prompt)}) differs from the "
                                     f"static engine's tokens")
        print(f"    every request's tokens equal the static engine's bit for "
              f"bit; launches {json.dumps(counts)}")
        if counts["decode_fused"] != cfg.num_layers * sched.buckets[
                None].steps or not counts["unified_linear"] \
                or not counts["flash_attention"]:
            raise AssertionError(f"{label}: launches {counts}")
        for n, c in counts.items():
            total[n] = total.get(n, 0) + c
        with recorded_by_phase(backend) as rec:
            twin, _ = serve(runs[key])
        bucket = twin.buckets[None]
        mixed = _nonuniform(rec["decode"])
        print(f"    decode_fused launches with non-uniform per-slot lengths: "
              f"{mixed} of {counts['decode_fused']}")
        if key == "b" and not mixed:
            raise AssertionError("scheduler (b): no decode step mixed "
                                 "cache lengths")
        units.append(Unit(f"Llama-3.2-1B scheduler {key} admission "
                          f"(batch-1 prefill)", bucket.admissions,
                          rec["admit"]))
        units.append(Unit(f"Llama-3.2-1B scheduler {key} decode step, "
                          f"{LM_BATCH} slots", bucket.steps, rec["decode"]))

    # (c): tiers, preemption, chunked admission and the prefix cache
    trace = TraceGenerator(TraceConfig(
        n=24, seed=1, vocab=cfg.vocab_size, num_tasks=1,
        shared_prefix_len=16, burst_factor=8.0)).generate()
    slo_backend = LMBackend(cfg, ctx["params"], replace(
        scfg, prefix_cache=32, prefill_chunk=64))
    sched = Scheduler(slo_backend, total_slots=LM_BATCH, quantum=4,
                      num_tasks=1, clock=TickClock(0.001),
                      slo=SLOPolicy(preemption=True))
    t0 = time.perf_counter()
    done = sched.run(trace)
    wall = time.perf_counter() - t0
    m = sched.metrics()
    pc = m["prefix_cache"]
    print(f"  scheduler (c), a bursty trace of {len(trace)} requests "
          f"({', '.join(f'{t}: {v['requests']}' for t, v in m['tiers'].items())}"
          f") on a tick clock: {wall * 1e3:.1f} ms host wall, "
          f"{m['tokens']} tokens; preemptions {m['preemptions']}, restores "
          f"{m['restores']}, prefill chunks {m.get('prefill_chunks', 0)}, "
          f"prefix cache hits {pc['hits']} of {pc['lookups']} "
          f"({pc['hit_tokens']} prompt tokens skipped)")
    if len(done) != len(trace) or not (m["preemptions"] and m["restores"]
                                       and pc["hits"]):
        raise AssertionError(f"scheduler (c): {len(done)} done, {m}")
    for r in done:
        alone = engine.generate(np.asarray(r.prompt)[None], r.max_new_tokens)
        if r.tokens != alone[0].tolist():
            raise AssertionError(f"scheduler (c): request {r.rid} ({r.tier}, "
                                 f"prompt {len(r.prompt)}, preempted "
                                 f"{r.preemptions}, prefix hit "
                                 f"{r.prefix_hit_tokens}) differs from the "
                                 f"static engine serving it alone")
    print("    every request's tokens equal the static engine serving it "
          "alone")
    return total


def packed_lm(ctx):
    """Llama-3.2-1B with int8 weights (``quant.quantize_tree``) and an int8
    KV cache under ``cuda`` with the ``eager_int8`` overrides (checked and
    printed only; its launches stay out of phase 5): 32 greedy tokens for
    the 8 prompts of 128 tokens, ``flash_attention`` and ``gelu_lut``
    launched, ``attention_decode`` a hit on ``eager_int8``; the
    teacher-forced replay held to cosine >= 0.999 against the plain
    ``eager_int8`` preset at every step; a 64-token-chunk prefill giving
    the same tokens; the scheduler with int8 parking under preemption
    giving every request the tokens of its uninterrupted run; int8 parking
    of a bf16 cache in under 0.75x the bytes."""
    import time

    from repro_torch import ops
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.compare import cosine
    from repro_torch.models import model as LM
    from repro_torch.quant import quantize_tree, tree_bytes
    from repro_torch.serve import LMBackend, Request, Scheduler
    from repro_torch.serve.engine import ServeConfig, ServingEngine
    from repro_torch.serve.slo import (SLOPolicy, TickClock, TraceConfig,
                                       TraceGenerator)
    from repro_torch.train.step import make_serve_step
    from repro_torch.tree import flatten

    cfg, prompts = ctx["cfg"], torch.from_numpy(ctx["prompts"]).cuda()
    policy, preset = _packed_policies(False)
    t0 = time.perf_counter()
    params = quantize_tree(ctx["params"])
    torch.cuda.synchronize()
    print(f"  Llama-3.2-1B int8 weights: {tree_bytes(ctx['params']) / 1e9:.3f}"
          f" -> {tree_bytes(params) / 1e9:.3f} GB "
          f"({time.perf_counter() - t0:.1f} s), int8 KV cache")
    scfg = ServeConfig(max_len=LM_MAX_LEN, policy=policy, kv_quant="int8")
    engine = ServingEngine(cfg, params, scfg)
    engine.generate(prompts, 2)               # warm-up, not counted
    torch.cuda.synchronize()
    reset_launch_counts()
    ops.reset_dispatch_report()
    t0 = time.perf_counter()
    tokens = engine.generate(prompts, LM_NEW)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    report = ops.dispatch_report()
    print(f"    {LM_BATCH} prompts of {LM_PROMPT} tokens, {LM_NEW} greedy "
          f"tokens each: {wall * 1e3:.1f} ms host wall, "
          f"{LM_BATCH * LM_NEW / wall:.1f} tokens/s; launches "
          f"{json.dumps(counts)}")
    if not (counts["flash_attention"] and counts["gelu_lut"]) \
            or counts["decode_fused"] or counts["unified_linear"]:
        raise AssertionError(f"packed LM launches: {counts}")
    hits = {"linear": preset, "attention_decode": preset,
            "attention": "cuda", "activation": "cuda"}
    for op, name in hits.items():
        entry = report.get(op, {})
        n = entry.get("hits", {}).get(name, 0)
        if not n or entry.get("fallbacks") or set(entry["hits"]) != {name} \
                or (name == "cuda" and entry.get("modes") != {
                    "cuda": {"cuda": n}}):
            raise AssertionError(f"packed LM: dispatch report for {op}: "
                                 f"{entry}")
    print(f"    dispatch report: "
          f"{json.dumps({op: report[op]['hits'] for op in hits})}, no "
          f"fallbacks")

    # teacher-forced replay: the kernel policy (whose argmax must give
    # back the tokens) against the plain preset, both on int8 caches
    ecfg = engine.cfg
    plain_prefill, plain_decode = make_serve_step(
        replace(ecfg, policy=ops.policy_named(preset)))
    prefill, decode = engine.steps()
    toks = torch.from_numpy(tokens).long().cuda()
    cosines, step_ms = [], []
    with torch.inference_mode():
        state = LM.init_state(ecfg, LM_BATCH, LM_MAX_LEN)
        logits, state = prefill(engine.params, prompts, state)
        pstate = LM.init_state(ecfg, LM_BATCH, LM_MAX_LEN)
        plain, pstate = plain_prefill(engine.params, prompts, pstate)
        for i in range(LM_NEW):
            if not torch.equal(torch.argmax(logits, -1), toks[:, i]):
                raise AssertionError(f"packed LM step {i}: the replayed "
                                     "logits do not give back the tokens")
            cosines.append(cosine(logits, plain))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, state = decode(engine.params, toks[:, i:i + 1], state,
                                   LM_PROMPT + i)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            plain, pstate = plain_decode(engine.params, toks[:, i:i + 1],
                                         pstate, LM_PROMPT + i)
        cosines.append(cosine(logits, plain))
    bf16_cache = sum(t.numel() * t.element_size() for t in flatten(
        LM.init_state(cfg, LM_BATCH, LM_MAX_LEN, device="meta")).values())
    int8_cache = sum(t.numel() * t.element_size() for t in flatten(
        state).values())
    print(f"    logits vs the plain {preset} preset, teacher-forced: prefill"
          f" cosine {cosines[0]:.6f}, decode steps min "
          f"{min(cosines[1:]):.6f} (>= 0.999: "
          f"{'ok' if min(cosines) >= 0.999 else 'FAIL'}); decode "
          f"{statistics.median(step_ms):.3f} ms per step (median of "
          f"{LM_NEW}); cache {int8_cache} bytes against {bf16_cache} in "
          f"bf16 ({int8_cache / bf16_cache:.4f}x)")
    if min(cosines) < 0.999:
        raise AssertionError(f"packed LM cosine {min(cosines)} < 0.999")
    chunked = ServingEngine(cfg, params, replace(scfg, prefill_chunk=64))
    got = chunked.generate(prompts, LM_NEW)
    print(f"    prefill in 64-token chunks: {int((got != tokens).sum())} of "
          f"{tokens.size} tokens differ from the one-shot run")
    if not np.array_equal(got, tokens):
        raise AssertionError("packed LM: the chunked prefill's tokens "
                             "differ from the one-shot run's")

    # the scheduler: int8 cache, int8 parking, preemption; every request
    # against the same scheduler run without SLO tiers (no preemption)
    backend = LMBackend(cfg, params, scfg)
    trace = TraceGenerator(TraceConfig(
        n=24, seed=1, vocab=cfg.vocab_size, num_tasks=1,
        shared_prefix_len=16, burst_factor=8.0)).generate()

    def serve(slo):
        sched = Scheduler(backend, total_slots=LM_BATCH, quantum=4,
                          num_tasks=1, clock=TickClock(0.001), slo=slo)
        t0 = time.perf_counter()
        done = sched.run([replace(r, tokens=[]) for r in trace])
        return sched, {r.rid: r for r in done}, time.perf_counter() - t0

    plain_sched, alone, _ = serve(None)
    sched, done, wall = serve(SLOPolicy(preemption=True,
                                        park_compress="int8"))
    m = sched.metrics()
    preempted = [r for r in done.values() if r.preemptions]
    print(f"    scheduler, int8 cache and int8 parking, the bursty trace of "
          f"{len(trace)}: {wall * 1e3:.1f} ms host wall, preemptions "
          f"{m['preemptions']}, restores {m['restores']}, parked peak "
          f"{m['parked_bytes_peak']} bytes")
    if len(done) != len(trace) or not (m["preemptions"] and m["restores"]):
        raise AssertionError(f"packed scheduler: {len(done)} done, {m}")
    for rid, r in done.items():
        if r.tokens != alone[rid].tokens:
            raise AssertionError(f"packed scheduler: request {rid} "
                                 f"(preempted {r.preemptions}) differs from "
                                 f"its uninterrupted run")
    print(f"    every request's tokens ({len(preempted)} preempted) equal "
          f"its run without preemption")

    # int8 parking of a bf16 cache
    fp_backend = LMBackend(cfg, params, replace(
        scfg, kv_quant=None, policy=policy.with_impls(
            attention_decode="cuda_fused")))
    bucket = fp_backend.make_bucket(None, 2)
    bucket.admit(Request(rid=0, task_id=0, prompt=ctx["prompts"][0],
                         max_new_tokens=8, tier="batch"), 0.0)
    bucket.run_quantum(3, lambda: 0.0)
    nbytes = {c: fp_backend.parker(c).park(bucket.state, 0).nbytes
              for c in ("none", "int8")}
    ratio = nbytes["int8"] / nbytes["none"]
    print(f"    parking a slot of a bf16 cache: {nbytes['int8']} bytes int8 "
          f"against {nbytes['none']} verbatim ({ratio:.4f}x, < 0.75: "
          f"{'ok' if ratio < 0.75 else 'FAIL'})")
    if ratio >= 0.75:
        raise AssertionError(f"int8 parking ratio {ratio}")


# ------------------------------------------------------------ phase 6

TRAIN_STEPS, RESUME_AT, PROFILED_STEPS = 20, 10, 3
LM_TRAIN = ["--arch", "llama3_2_1b", "--steps", "5", "--batch", "4",
            "--seq-len", "128", "--policy", "cuda"]
#: kernel -> device ms per training step (forward launches, backward) by
#: model, from the profiled steps
TRAIN_KERNEL_MS: dict = {}


def _train_gates(label, losses, grads) -> None:
    """The step-0 loss and gradients under the kernels against the
    default policy, to ``kernels/compare.py``'s training bounds (with the
    float32 model's gradients as the yardstick where bf16 noise alone
    exceeds the all-leaves target)."""
    from repro_torch.kernels import compare

    ok, r = compare.training_agrees(losses["cuda"], losses["default"],
                                    grads["cuda"], grads["default"],
                                    grads["float32"])
    print(f"  {label}: loss under cuda {losses['cuda']:.6f}, default policy "
          f"{losses['default']:.6f}, float32 {losses['float32']:.6f} "
          f"(relative {r['loss_rel']:.3e} <= {compare.TRAIN_LOSS_RTOL}); "
          f"gradient cosine over all {len(grads['default'])} leaves "
          f"{r['cosine']:.6f} (target {compare.GRAD_COSINE_ALL}); against "
          f"the float32 gradients: cuda {r['cosine_f32_kernels']:.6f}, "
          f"default {r['cosine_f32_default']:.6f} (cuda >= default - "
          f"{compare.GRAD_FLOAT32_MARGIN} where the target is missed); "
          f"worst leaf above {compare.GRAD_LEAF_FLOOR} of the largest norm "
          f"{r['worst_leaf']} {r['worst_leaf_cosine']:.6f} (>= "
          f"{compare.GRAD_COSINE_LEAF}): {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: kernel training disagrees with the "
                             f"default policy")


def _timed(step, walls):
    """``step`` with its host wall recorded: from an idle card to the loss
    on the host."""
    import time

    def run(params, opt_state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(params, opt_state, batch)
        float(out[2]["loss"])
        walls.append(time.perf_counter() - t0)
        return out
    return run


def _check_no_fallback(label, report, counts, op_names,
                       kernels=CUDA_PATH_KERNELS) -> None:
    """Every op of ``op_names`` a ``cuda`` hit on the card with no
    fallback, and every kernel of ``kernels`` launched."""
    for op in op_names:
        entry = report.get(op, {})
        n = entry.get("hits", {}).get("cuda", -1)
        if entry.get("fallbacks") or entry.get("modes") != {"cuda": {
                "cuda": n}}:
            raise AssertionError(f"{label}: dispatch report for {op}: "
                                 f"{entry}")
    if not all(counts[k] > 0 for k in kernels):
        raise AssertionError(f"{label}: a kernel never launched: {counts}")
    print(f"  {label}: {', '.join(op_names)} all cuda hits on the card, no "
          f"fallback; training launches {json.dumps(counts)}")


def _same_state(a, b) -> bool:
    from repro_torch.tree import flatten

    fa, fb = flatten(a), flatten(b)
    return fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k])
                                          for k in fa)


def _profile(label, step, params, opt_state, batch, walls, key) -> dict:
    """Profile PROFILED_STEPS more steps on the same state and batch; the
    idle share against the median wall of the timed steps."""
    from repro_torch.train.profile import profile_steps

    wall = statistics.median(walls)
    prof = profile_steps(
        lambda: float(step(params, opt_state, batch)[2]["loss"]),
        PROFILED_STEPS, wall)
    print(f"  {label} profile (torch.profiler, {PROFILED_STEPS} steps): "
          f"busy {prof['busy_ms']:.3f} ms a step, idle share "
          f"{prof['idle_share']:.3f} of the {prof['wall_ms']:.3f} ms wall; "
          f"forward {prof['forward_ms']:.3f} ms, backward "
          f"{prof['backward_ms']:.3f} ms, optimizer "
          f"{prof['optimizer_ms']:.3f} ms device time; "
          f"{prof['device_events']:.0f} device events a step")
    for name in prof["kernel_forward_ms"]:
        fwd, bwd = prof["kernel_forward_ms"][name], \
            prof["kernel_backward_ms"][name]
        TRAIN_KERNEL_MS.setdefault(name, {})[key] = {
            "forward_ms": fwd, "backward_ms": bwd}
        print(f"    {name}: forward launches {fwd:.4f} ms, its backward "
              f"{bwd:.4f} ms a step")
    for name, ms in prof["top"]:
        print(f"    {ms:9.4f} ms/step  {name}")
    return prof


def _m3vit_loss(cfg, parts=None):
    """semseg + depth on one batch (the reference's test_vit loss); each
    task's loss appended to ``parts`` without a host read."""
    from repro_torch.models import vit

    def loss_fn(p, b):
        l0, (s0, _) = vit.multitask_loss(p, b["image"], b["semseg"], cfg,
                                         "semseg")
        l1, (s1, _) = vit.multitask_loss(p, b["image"], b["depth"], cfg,
                                         "depth")
        if parts is not None:
            parts.append(torch.stack([s0.detach(), s1.detach()]))
        return l0 + l1, None
    return loss_fn


def train_m3vit() -> dict:
    """M³ViT at the full CONFIG: 20 TrainLoop steps under cuda and under
    the default policy, with the slice's gates."""
    import tempfile

    from repro_torch import ops
    from repro_torch.configs import m3vit as MV
    from repro_torch.data import DataConfig, device_transform, make_stream
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import vit
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.train import (LoopConfig, TrainConfig, TrainLoop,
                                   make_train_step)
    from repro_torch.train.step import loss_and_grads

    cfgs = {"cuda": replace(MV.CONFIG, policy=ops.policy_named("cuda")),
            "default": replace(MV.CONFIG, policy=None)}
    params0 = vit.init_params(0, MV.CONFIG)
    n_params = sum(v.numel() for v in params0.values())
    stream = make_stream(DataConfig(batch=BATCH, seq_len=0, kind="m3vit",
                                    seed=0))
    put = device_transform("cuda")
    ocfg = OptConfig(lr=3e-3, warmup_steps=2, total_steps=40,
                     weight_decay=0.0)
    tcfg = TrainConfig(opt=ocfg)
    b0 = put(stream.batch(0))
    print(f"  M3ViT {MV.CONFIG.num_layers} layers, {n_params / 1e6:.3f} M "
          f"parameters, {MV.CONFIG.dtype}, batch {BATCH} frames, loss "
          f"semseg + depth, AdamW lr 3e-3 warmup 2 of 40")

    # the training forward gives the serving bits
    for task in MV.TASKS:
        with torch.inference_mode():
            y_serve, aux_serve = vit.forward(params0, b0["image"],
                                             cfgs["cuda"], task)
        leaves = {k: v.detach().requires_grad_() for k, v in params0.items()}
        y_train, aux_train = vit.forward(leaves, b0["image"], cfgs["cuda"],
                                         task)
        same = torch.equal(y_train.detach(), y_serve) and \
            torch.equal(aux_train.detach(), aux_serve)
        print(f"  {task}: the forward with gradients on equals the "
              f"inference_mode forward bit for bit: "
              f"{'ok' if same else 'FAIL'} (output has grad_fn "
              f"{type(y_train.grad_fn).__name__})")
        if not same or y_train.grad_fn is None:
            raise AssertionError(f"{task}: training forward != serving")
        del leaves, y_train, aux_train

    losses, grads = {}, {}
    f32 = {k: v.float() for k, v in params0.items()}
    for name, cfg, p in (
            ("cuda", cfgs["cuda"], params0),
            ("default", cfgs["default"], params0),
            ("float32", replace(cfgs["default"], dtype="float32"), f32)):
        loss, grads[name] = loss_and_grads(_m3vit_loss(cfg), p, b0)
        losses[name] = float(loss)
    _train_gates("M3ViT step 0", losses, grads)
    del grads, f32

    runs = {}
    for name, cfg in cfgs.items():
        parts, walls = [], []
        step = make_train_step(cfg, tcfg, loss_fn=_m3vit_loss(cfg, parts))
        loop = TrainLoop(LoopConfig(total_steps=TRAIN_STEPS, log_every=1000),
                         _timed(step, walls), stream, params0,
                         adamw_init(params0, ocfg), log=lambda s: None,
                         batch_transform=put)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        ops.reset_dispatch_report()
        st = loop.run()
        counts, report = launch_counts(), ops.dispatch_report()
        peak = torch.cuda.max_memory_allocated()
        tasks = torch.stack(parts).cpu()
        wall = statistics.median(walls[5:])
        print(f"  policy {name}: {TRAIN_STEPS} steps, loss "
              f"{st.history[0][1]:.4f} -> {st.history[-1][1]:.4f}; semseg "
              f"{float(tasks[0, 0]):.4f} -> {float(tasks[-1, 0]):.4f}, depth "
              f"{float(tasks[0, 1]):.4f} -> {float(tasks[-1, 1]):.4f}; "
              f"{wall * 1e3:.3f} ms a step (median host wall of steps "
              f"5-19), {BATCH / wall:.1f} frames/s; peak memory "
              f"{peak / 2**20:.1f} MiB")
        if not (len(st.history) == TRAIN_STEPS and bool(
                (tasks[-1] < tasks[0]).all())):
            raise AssertionError(f"M3ViT under {name}: a task did not learn "
                                 f"({tasks[0].tolist()} -> "
                                 f"{tasks[-1].tolist()})")
        if name == "cuda":
            _check_no_fallback("M3ViT training under cuda", report, counts,
                               ("linear", "attention", "activation",
                                "moe_grouped_gemm"))
            train_counts = counts
            read_variants("the M3ViT training run")
            _profile("M3ViT cuda", step, loop.params, loop.opt_state, b0,
                     walls[5:], "m3vit")
        runs[name] = (st, loop, step)

    # resume: checkpoint at step 10, restore into other weights, run on
    st_a, loop_a, step_k = runs["cuda"]
    with tempfile.TemporaryDirectory() as d:
        def make(total, params):
            return TrainLoop(LoopConfig(total_steps=total, ckpt_dir=d,
                                        ckpt_every=RESUME_AT,
                                        log_every=1000),
                             make_train_step(cfgs["cuda"], tcfg,
                                             loss_fn=_m3vit_loss(
                                                 cfgs["cuda"])),
                             stream, params, adamw_init(params, ocfg),
                             log=lambda s: None, batch_transform=put)

        make(RESUME_AT, params0).run()
        resumed = make(TRAIN_STEPS, vit.init_params(1, MV.CONFIG))
        if not (resumed.try_restore() and resumed.state.step == RESUME_AT):
            raise AssertionError("resume: no checkpoint at step 10")
        st_b = resumed.run()
    tail_a, tail_b = dict(st_a.history[RESUME_AT:]), dict(st_b.history)
    rel = max(abs(tail_b[s] - tail_a[s]) / abs(tail_a[s]) for s in tail_a)
    bits = all(tail_b[s] == tail_a[s] for s in tail_a) and all(
        torch.equal(loop_a.params[k], resumed.params[k])
        for k in loop_a.params)
    print(f"  resume: checkpoint at step {RESUME_AT}, restored into seed-1 "
          f"weights, steps {RESUME_AT}-{TRAIN_STEPS - 1} against the "
          f"uninterrupted run: max relative loss difference {rel:.3e} "
          f"(<= 1e-6: {'ok' if rel <= 1e-6 else 'FAIL'}); losses and final "
          f"parameters bit-identical: {bits}")
    if set(tail_a) != set(tail_b) or rel > 1e-6:
        raise AssertionError("resume does not replay the uninterrupted run")

    # the NaN guard: a NaN pixel leaves every parameter and state bit
    bad = stream.batch(0)
    bad["image"][0, 5, 7, 1] = np.nan
    p, o = loop_a.params, loop_a.opt_state
    p2, o2, m = step_k(p, o, put(bad))
    ok = int(m["skipped"]) == 1 and _same_state({"p": p, "o": o},
                                                {"p": p2, "o": o2})
    print(f"  NaN guard: a NaN pixel gives loss {float(m['loss'])}, skipped "
          f"{int(m['skipped'])}, parameters and optimizer state "
          f"bit-identical: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the NaN guard let the update through")

    # accumulation over 2 microbatches against one batch, under the
    # optimizer of the reference's accumulation test (its 2e-3 bound is
    # the bf16 grid plus a first Adam step of lr/3 that may flip sign where
    # a gradient element is near 0)
    acfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=3,
                                     total_steps=60))
    opt0 = adamw_init(params0, acfg.opt)
    p1, _, m1 = make_train_step(cfgs["cuda"], acfg,
                                loss_fn=_m3vit_loss(cfgs["cuda"]))(
        params0, opt0, b0)
    p2, _, m2 = make_train_step(cfgs["cuda"], replace(acfg, accum_steps=2),
                                loss_fn=_m3vit_loss(cfgs["cuda"]))(
        params0, opt0, b0)
    rel = abs(float(m2["loss"]) - float(m1["loss"])) / abs(float(m1["loss"]))
    dmax = max(float((p1[k].float() - p2[k].float()).abs().max())
               for k in p1)
    ok = rel <= 1e-5 and dmax < 2e-3
    print(f"  accumulation: accum_steps=2 against 1: loss relative {rel:.3e} "
          f"(<= 1e-5), max parameter difference {dmax:.3e} (< 2e-3): "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("accumulation disagrees with one batch")
    return train_counts


def train_lm() -> dict:
    """Llama-3.2-1B at the full CONFIG through the training launcher's
    step: 5 steps under cuda and under the default policy."""
    import time

    from repro_torch import ops
    from repro_torch.data import device_transform
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as LT
    from repro_torch.models import model as LM
    from repro_torch.train import LoopConfig, TrainLoop
    from repro_torch.train.step import loss_and_grads

    args = LT.parser().parse_args(LM_TRAIN)
    t0 = time.perf_counter()
    cfg, params, opt0, step_k, stream, dev, _ = LT.build(args)
    torch.cuda.synchronize()
    cfg_d = replace(cfg, policy=None)
    steps = {"cuda": step_k, "default": LT.train_step_for(cfg_d, args)}
    tokens = args.batch * args.seq_len
    print(f"  Llama-3.2-1B {cfg.num_layers} layers d={cfg.d_model} "
          f"{cfg.dtype}, {sum(v.numel() for v in params.values()) / 1e9:.3f}"
          f" B parameters from seed 0 in {time.perf_counter() - t0:.1f} s; "
          f"batch {args.batch} x {args.seq_len} tokens, AdamW lr {args.lr}")
    put = device_transform(dev)
    b0 = put(stream.batch(0))

    losses, grads = {}, {}
    calls = {}
    for name, c in (("cuda", cfg), ("default", cfg_d),
                    ("float32", replace(cfg_d, dtype="float32"))):
        def loss_fn(p, b, c=c):
            return LM.lm_loss(p, b, c)

        p = params if name != "float32" else {
            k: v.float() for k, v in params.items()}
        with recorded_launches(calls if name == "cuda" else {}):
            loss, grads[name] = loss_and_grads(loss_fn, p, b0)
        losses[name] = float(loss)
        del p
    _train_gates("Llama-3.2-1B step 0", losses, grads)
    del grads
    # the training forward's launches (M = 512 rows, causal GQA over 128
    # keys) against their plain versions, each distinct one once
    seen = set()
    with torch.no_grad():
        for name, launches in calls.items():
            for a in launches:
                case = CASES[name](a)
                if case.key in seen:
                    continue
                seen.add(case.key)
                got, want = case.kernel(), case.plain()
                if case.tol is None:
                    check_exact(name, case.label, got, want)
                else:
                    check(name, case.label, got, want, want.dtype,
                          **case.tol())
    del calls

    for name, step in steps.items():
        walls = []
        loop = TrainLoop(LoopConfig(total_steps=args.steps, log_every=1000),
                         _timed(step, walls), stream, params, opt0,
                         log=lambda s: None, batch_transform=put)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        ops.reset_dispatch_report()
        st = loop.run()
        counts, report = launch_counts(), ops.dispatch_report()
        peak = torch.cuda.max_memory_allocated()
        wall = statistics.median(walls[1:])
        hist = [l for _, l in st.history]
        print(f"  policy {name}: {args.steps} steps, losses "
              f"{', '.join(f'{l:.4f}' for l in hist)}; {wall * 1e3:.3f} ms a "
              f"step (median host wall of steps 1-{args.steps - 1}), "
              f"{tokens / wall:.1f} tokens/s; peak memory "
              f"{peak / 2**30:.2f} GiB")
        if len(hist) != args.steps or not np.isfinite(hist).all():
            raise AssertionError(f"Llama under {name}: a loss is not finite")
        if name == "cuda":
            # SiLU is fused into the gate projection's epilogue and the
            # model has no experts: two ops, two kernels
            _check_no_fallback("Llama training under cuda", report, counts,
                               ("linear", "attention"),
                               ("unified_linear", "flash_attention"))
            train_counts = counts
            read_variants("the Llama training run")
            _profile("Llama-3.2-1B cuda", step, loop.params,
                     loop.opt_state, b0, walls[1:], "llama")
        del loop
    return train_counts


# ------------------------------------------------------------ phase 7

RECURRENT = ("xlstm_350m", "recurrentgemma_9b")
RC_BATCH, RC_PROMPT, RC_NEW, RC_MAX_LEN = 8, 128, 32, 512   # (a), (c)
RING_BATCH, RING_MAX_LEN = 2, 4096             # (b): a ring of 2048 slots
CHUNK_PROMPT, CHUNK = 150, 64                  # (e): 64 + 64 + a 22 rest


def _slstm_simt(cfg, forwards: int) -> dict:
    """The SIMT launches an xLSTM run makes, for ``read_variants``: sLSTM's
    up, up2 and down projections have rows of 4d/3 = 1365 bf16 (2730
    bytes), which no TMA map can address, so ``unified_linear`` takes its
    SIMT route for them (three a layer and forward)."""
    n = sum(cfg.block_kind(i) == "slstm" for i in range(cfg.num_layers))
    if not n:
        return {}
    return {"unified_linear": (3 * n * forwards, "sLSTM's projections to "
            "and from 4d/3 = 1365 columns: bf16 rows of 2730 bytes, which "
            "TMA cannot address")}


#: phase 7's depth: full width, a cut of the layers (the time limit);
#: xLSTM one period of 7 mLSTM + 1 sLSTM, RecurrentGemma four periods of
#: (RG-LRU, RG-LRU, local attention) and its two remainder layers
RC_LAYERS = {"xlstm_350m": 8, "recurrentgemma_9b": 14}


def recurrent_model(name):
    """The ``CONFIG`` at full width and ``RC_LAYERS`` deep, with random
    weights drawn on the card from seed 0 (the same shapes, scales and
    dtypes as the host draw)."""
    import importlib
    import time

    from repro_torch.models import model as M

    full = importlib.import_module(f"repro_torch.configs.{name}").CONFIG
    cfg = replace(full, num_layers=RC_LAYERS[name])
    print(f"  {name}: {cfg.num_layers} of its {full.num_layers} layers")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = M.init_params(0, cfg, draw_on_device=True)
    torch.cuda.synchronize()
    n = sum(v.numel() for v in params.values())
    print(f"  {name}: {cfg.num_layers} layers of {cfg.block_pattern} "
          f"d={cfg.d_model} {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.hd} d_ff={cfg.d_ff} vocab={cfg.vocab_size} window="
          f"{cfg.window} {cfg.dtype}: {n / 1e9:.3f} B parameters drawn on "
          f"the card from seed 0 in {time.perf_counter() - t0:.1f} s")
    return cfg, params


def _float32_replay(cfg, params, prompts, toks, max_len) -> list:
    """The same model in float32 (weights widened, plain policy), teacher
    forced on ``toks``: the logits of the prefill and of every step."""
    from repro_torch import ops
    from repro_torch.models import model as M
    from repro_torch.train.step import make_serve_step

    cfg32 = replace(cfg, dtype="float32", policy=ops.policy_named("eager"))
    p32 = {k: v.float() for k, v in params.items()}
    prefill, decode = make_serve_step(cfg32)
    out = []
    with torch.inference_mode():
        state = M.init_state(cfg32, prompts.shape[0], max_len)
        logits, state = prefill(p32, prompts, state)
        out.append(logits)
        for i in range(toks.shape[1]):
            logits, state = decode(p32, toks[:, i:i + 1], state,
                                   prompts.shape[1] + i)
            out.append(logits)
    del p32, state
    torch.cuda.empty_cache()
    return out


def recurrent_static(label, cfg, params, policy, prompts, max_len, units,
                     expect):
    """One counted ``generate`` (RC_NEW greedy tokens) under the kernel
    policy, then the prefill and every decode step replayed teacher-forced
    under the kernel policy (the twin, recorded) and the plain ``eager``
    one: the replay's argmax gives back the tokens, and the logits agree
    (``compare.serving_agrees``).  ``expect(counts)`` checks the launches.
    Returns (counts, engine, tokens)."""
    import time

    from repro_torch import ops
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.compare import (SERVE_NOISE_RATIO, cosine,
                                             serving_agrees)
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeConfig, ServingEngine
    from repro_torch.train.step import make_serve_step

    b, s0 = prompts.shape
    engine = ServingEngine(cfg, params, ServeConfig(max_len=max_len,
                                                    policy=policy))
    engine.generate(prompts, 2)               # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    ops.reset_dispatch_report()
    t0 = time.perf_counter()
    tokens = engine.generate(prompts, RC_NEW)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    report = ops.dispatch_report()
    read_variants(label, _slstm_simt(cfg, 1 + RC_NEW))
    print(f"  {label}: {b} prompts of {s0} tokens, {RC_NEW} greedy tokens "
          f"each: {wall * 1e3:.1f} ms host wall, {b * RC_NEW / wall:.1f} "
          f"tokens/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  launches over the generate call: {json.dumps(counts)}")
    if tokens.shape != (b, RC_NEW) or not (
            (tokens >= 0) & (tokens < cfg.vocab_size)).all():
        raise AssertionError(f"{label}: tokens {tokens.shape} out of range")
    expect(counts)
    windowed = cfg.window is not None
    hits = {"linear": "cuda"}
    if windowed:
        hits.update(attention="cuda", attention_decode="cuda_fused")
    for op, impl in hits.items():
        entry = report.get(op, {})
        n = entry.get("hits", {}).get(impl, -1)
        if entry.get("fallbacks") or entry.get("modes") != {impl: {"cuda": n}}:
            raise AssertionError(f"{label}: dispatch report for {op}: "
                                 f"{entry}")
    if any(e.get("fallbacks") for e in report.values()):
        raise AssertionError(f"{label}: a fallback in {report}")
    print(f"  dispatch report: {json.dumps(report)}")

    plain_prefill, plain_decode = make_serve_step(
        replace(cfg, policy=ops.policy_named("eager")))
    prefill, decode = engine.steps()
    toks = torch.from_numpy(tokens).long().cuda()
    prefill_calls, decode_calls = {}, {}
    kern, plain, step_ms, prefill_ms = [], [], [], []
    with torch.inference_mode():
        for rep in range(3):
            state = M.init_state(cfg, b, max_len)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with recorded_launches(prefill_calls if rep == 0 else {}):
                logits, state = prefill(engine.params, prompts, state)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
        pstate = M.init_state(cfg, b, max_len)
        want, pstate = plain_prefill(engine.params, prompts, pstate)
        for i in range(RC_NEW):
            if not torch.equal(torch.argmax(logits, -1), toks[:, i]):
                raise AssertionError(f"{label} step {i}: the replayed "
                                     "logits do not give back the tokens")
            kern.append(logits)
            plain.append(want)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with recorded_launches(decode_calls):
                logits, state = decode(engine.params, toks[:, i:i + 1],
                                       state, s0 + i)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            want, pstate = plain_decode(engine.params, toks[:, i:i + 1],
                                        pstate, s0 + i)
        kern.append(logits)
        plain.append(want)
    del state, pstate
    cos = [cosine(k, p) for k, p in zip(kern, plain)]
    print(f"  logits vs the plain eager policy on the card, teacher-forced: "
          f"prefill cosine {cos[0]:.6f}, decode steps min "
          f"{min(cos[1:]):.6f} (>= 0.999: "
          f"{'ok' if min(cos) >= 0.999 else 'no'})")
    k32 = p32 = None
    if min(cos) < 0.999:
        ref = _float32_replay(cfg, params, prompts, toks, max_len)
        k32 = [cosine(k, r) for k, r in zip(kern, ref)]
        p32 = [cosine(p, r) for p, r in zip(plain, ref)]
        worst = max(range(len(k32)),
                    key=lambda i: (1 - k32[i]) / (1 - p32[i]))
        print(f"  bf16 noise exceeds 0.999: against the same model in "
              f"float32, kernels min cosine {min(k32):.6f}, plain "
              f"{min(p32):.6f}; worst step {worst}: kernels "
              f"{k32[worst]:.6f} vs plain {p32[worst]:.6f}, distance ratio "
              f"{(1 - k32[worst]) / (1 - p32[worst]):.3f} (at most "
              f"{SERVE_NOISE_RATIO} x the plain policy's + 1e-3: "
              f"{'ok' if serving_agrees(cos, k32, p32) else 'FAIL'})")
        del ref
    if not serving_agrees(cos, k32, p32):
        raise AssertionError(f"{label}: kernel logits disagree with the "
                             f"plain policy's (min cosine {min(cos)})")
    del kern, plain
    print(f"  prefill {statistics.median(prefill_ms):.3f} ms (median of 3, "
          f"B={b} x {s0} tokens); decode {statistics.median(step_ms):.3f} "
          f"ms per step (median of {RC_NEW}, B={b}, host wall to a "
          f"synchronized card)")
    units.append(Unit(f"{label} prefill, B={b} x {s0} tokens", 1,
                      prefill_calls))
    units.append(Unit(f"{label} decode step, B={b}, positions {s0}-"
                      f"{s0 + RC_NEW - 1}", RC_NEW, decode_calls))
    return counts, engine, tokens


def _expect_launches(label, cfg, steps):
    """The launch check of a counted run: ``unified_linear`` always; with
    local attention ``flash_attention`` (prefill) and ``decode_fused`` once
    per attention layer and decode step."""
    n_attn = sum(cfg.block_kind(i) == "attn_local_mlp"
                 for i in range(cfg.num_layers))

    def expect(counts):
        bad = not counts["unified_linear"] \
            or counts["decode_fused"] != n_attn * steps \
            or (counts["flash_attention"] == 0) != (n_attn == 0)
        if bad or counts["moe_gemm"] or counts["moe_fused"]:
            raise AssertionError(f"{label}: launches {counts} (decode_fused "
                                 f"must be {n_attn} x {steps})")
        print(f"  {label}: decode_fused {counts['decode_fused']} = {n_attn} "
              f"local-attention layers x {steps} steps")
    return expect


def recurrent_scheduler(label, cfg, params, policy, engine):
    """(c) 16 requests of 16..128-token prompts and 8..32 new tokens through
    the ``Scheduler`` (``LMBackend``, 8 slots): each request's tokens equal
    the static engine serving its prompt alone and in a batch of 8 copies,
    bit for bit."""
    import time

    from repro_torch.kernels import reset_launch_counts
    from repro_torch.serve import LMBackend, Request, Scheduler, ServeConfig

    backend = LMBackend(cfg, params, ServeConfig(max_len=RC_MAX_LEN,
                                                 policy=policy,
                                                 prefix_cache=32))
    if backend.prompt_pad or backend.prefix is not None:
        raise AssertionError(f"{label}: a recurrent backend padded its "
                             f"prompts or took a prefix cache")
    rng = np.random.default_rng(2)
    lengths = [16, 64, 70, 80] + rng.integers(16, 129, 12).tolist()
    news = rng.integers(8, 33, 16).tolist()
    specs = [dict(rid=i, task_id=0, prompt=rng.integers(
        0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=m)
        for i, (n, m) in enumerate(zip(lengths, news))]
    t0 = time.perf_counter()
    want = {}
    for spec in specs:
        p, m = spec["prompt"][None], spec["max_new_tokens"]
        alone = engine.generate(p, m)
        copies = engine.generate(np.repeat(p, RC_BATCH, 0), m)
        if not (copies == alone).all():
            raise AssertionError(f"{label}: request {spec['rid']} "
                                 f"({p.shape[1]} tokens): the static "
                                 f"engine's tokens depend on its batch")
        want[spec["rid"]] = alone[0].tolist()
    print(f"  {label}: static engine, each of the 16 prompts alone and in a "
          f"batch of {RC_BATCH} copies: the same tokens "
          f"({time.perf_counter() - t0:.1f} s)")
    sched = Scheduler(backend, total_slots=RC_BATCH, quantum=4, num_tasks=1)
    torch.cuda.synchronize()
    reset_launch_counts()
    done = sched.run([Request(**s) for s in specs])
    _scheduler_report(f"{label} scheduler (c)", sched, done)
    read_variants(f"{label} scheduler (c)", _slstm_simt(
        cfg, sched.buckets[None].steps + sched.buckets[None].admissions),
        tally=False)
    for r in done:
        if r.tokens != want[r.rid]:
            raise AssertionError(f"{label} scheduler (c): request {r.rid} "
                                 f"(prompt {len(r.prompt)}) differs from "
                                 f"the static engine's tokens")
    print("    every request's tokens equal the static engine's bit for bit")


def recurrent_preempt(cfg, params, policy, engine):
    """(d) One slot, a batch-tier request of 24 tokens and an interactive
    arrival mid-decode on a tick clock: the batch request's recurrent state
    is parked (``compress="none"``) and restored, and both requests get
    the tokens of their uninterrupted runs."""
    from repro_torch.serve import LMBackend, Request, Scheduler, ServeConfig
    from repro_torch.serve.slo import SLOPolicy, TickClock

    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32)
    sched = Scheduler(LMBackend(cfg, params, ServeConfig(
        max_len=RC_MAX_LEN, policy=policy)), total_slots=1, quantum=4,
        num_tasks=1, clock=TickClock(), slo=SLOPolicy(
            preemption=True, chunk_interleave=False, park_compress="none"))
    done = {r.rid: r for r in sched.run([
        Request(rid=0, task_id=0, prompt=prompts[0], max_new_tokens=24,
                arrival=0.0, tier="batch"),
        Request(rid=1, task_id=0, prompt=prompts[1], max_new_tokens=4,
                arrival=0.25, tier="interactive")])}
    m = sched.metrics()
    for rid, n in ((0, 24), (1, 4)):
        if done[rid].tokens != engine.generate(prompts[rid:rid + 1],
                                               n)[0].tolist():
            raise AssertionError(f"xLSTM preemption (d): request {rid} "
                                 f"differs from its uninterrupted run")
    if not (done[0].preemptions and m["preemptions"] and m["restores"]):
        raise AssertionError(f"xLSTM preemption (d): nothing preempted {m}")
    print(f"  xLSTM preemption (d): {m['preemptions']} preemptions, "
          f"{m['restores']} restores, parked peak "
          f"{m['parked_bytes_peak'] / 2**20:.2f} MiB; both requests equal "
          f"their uninterrupted runs")


def recurrent_chunked(cfg, params, policy, engine):
    """(e) 8 prompts of 150 tokens prefilled in chunks of 64 (64 + 64 + an
    unpadded 22) give the one-shot prefill's greedy tokens — checked with
    the weights in float32 (``cuda`` then takes its float32 kernels),
    where a chunked and a one-shot prefill differ by float32 roundings.
    In bf16 the two prefills' roundings differ in the mLSTM's chunkwise
    sums (64-token chunks against one 256-token chunk), and the xLSTM
    stack amplifies a bf16 rounding until the greedy streams part (its
    bf16 logits sit at cosine 0.96 of its float32 ones): the bf16 streams
    and the prefill logits' cosine are printed as a reading."""
    from repro_torch.kernels.compare import cosine
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    prompts = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (RC_BATCH, CHUNK_PROMPT)).astype(np.int32)
    cfg32 = replace(cfg, dtype="float32")
    p32 = {k: v.float() for k, v in params.items()}
    out = {}
    for dt, c, p, one in (("bfloat16", cfg, params, engine),
                          ("float32", cfg32, p32, None)):
        one = one or ServingEngine(c, p, ServeConfig(max_len=RC_MAX_LEN,
                                                      policy=policy))
        chk = ServingEngine(c, p, ServeConfig(
            max_len=RC_MAX_LEN, policy=policy, prefill_chunk=CHUNK))
        pt = torch.from_numpy(prompts).long().cuda()
        with torch.inference_mode():
            logits = [e._prefill(pt, M.init_state(c, RC_BATCH, RC_MAX_LEN),
                                 0)[0] for e in (one, chk)]
        a, b = one.generate(prompts, RC_NEW), chk.generate(prompts, RC_NEW)
        out[dt] = int((a == b).all(axis=1).sum())
        print(f"  xLSTM chunked prefill (e), {dt}: {RC_BATCH} prompts of "
              f"{CHUNK_PROMPT} tokens in chunks of {CHUNK}: prefill logits "
              f"at cosine {cosine(*logits):.6f} of the one-shot prefill's, "
              f"{out[dt]} of {RC_BATCH} greedy streams of {RC_NEW} tokens "
              f"equal")
    del p32
    torch.cuda.empty_cache()
    if out["float32"] != RC_BATCH:
        raise AssertionError("xLSTM chunked prefill (e) differs from the "
                             "one-shot tokens in float32")


def recurrent_path(units):
    """Phase 7: xLSTM-350M and RecurrentGemma-9B at full width and depth
    under ``cuda`` with ``attention_decode="cuda_fused"``.  Returns the
    launches of the counted runs (a) and (b); (c)-(e) are checked and
    printed only.  Returns (counts, context holding the models)."""
    import time

    from repro_torch import ops

    t_phase = time.perf_counter()
    policy = ops.policy_named("cuda").with_impls(attention_decode="cuda_fused")
    total, keep = {}, []
    for name in RECURRENT:
        t0 = time.perf_counter()
        cfg, params = recurrent_model(name)
        prompts = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, size=(RC_BATCH, RC_PROMPT))).cuda()
        counts, engine, _ = recurrent_static(
            f"{name} (a)", cfg, params, policy, prompts, RC_MAX_LEN, units,
            _expect_launches(f"{name} (a)", cfg, RC_NEW))
        for n, c in counts.items():
            total[n] = total.get(n, 0) + c
        if cfg.window is not None:
            long = torch.from_numpy(np.random.default_rng(5).integers(
                0, cfg.vocab_size, size=(RING_BATCH, 2304))).cuda()
            counts, _, _ = recurrent_static(
                f"{name} (b) ring", cfg, params, policy, long, RING_MAX_LEN,
                units, _expect_launches(f"{name} (b)", cfg, RC_NEW))
            for n, c in counts.items():
                total[n] = total.get(n, 0) + c
        recurrent_scheduler(name, cfg, params, policy, engine)
        if cfg.window is None:
            recurrent_preempt(cfg, params, policy, engine)
            recurrent_chunked(cfg, params, policy, engine)
        keep.append(params)
        torch.cuda.synchronize()
        print(f"  {name}: {time.perf_counter() - t0:.1f} s")
    print(f"  phase 7 wall time {time.perf_counter() - t_phase:.1f} s")
    return total, keep


# ------------------------------------------------------------ phase 8

#: the decoders of phase 8 and the depth each runs at (None: all of it);
#: weights for the three cut ones would not fit the card at full depth
FRONTIER = {"musicgen_large": None, "phi4_mini_3_8b": None,
            "qwen1_5_4b": None, "qwen2_vl_72b": 16, "deepseek_67b": 16,
            "llama4_scout_17b_a16e": 6}
FRONTIER_SCHEDULED = ("musicgen_large", "qwen2_vl_72b")     # (c)
FRONTIER_UNITS = ("qwen2_vl_72b", "llama4_scout_17b_a16e")  # to phase 5
M3VIT_MANY_LAUNCH = ["--arch", "m3vit_many", "--smoke", "--scheduler",
                     "--factor", "rank:8", "--expert-budget-bytes",
                     "2000000"]


def frontier_model(name):
    """The full-width ``CONFIG``, cut in depth where ``FRONTIER`` says,
    with random weights drawn on the card from seed 0."""
    import time

    from repro_torch.configs import get
    from repro_torch.models import model as M

    full = get(name)
    depth = FRONTIER[name]
    cfg = full if depth is None else replace(full, num_layers=depth)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = M.init_params(0, cfg, draw_on_device=True)
    torch.cuda.synchronize()
    nbytes = sum(v.numel() * v.element_size() for v in params.values())
    moe = (f", {cfg.moe.num_experts} experts top-{cfg.moe.top_k} d_ff "
           f"{cfg.moe.d_ff} + {cfg.moe.num_shared_experts} shared "
           f"({cfg.moe.impl})" if cfg.moe else "")
    cut = ("none" if depth is None else f"depth {depth} of "
           f"{full.num_layers} (widths as published; fewer layers make the "
           f"host's share of a step larger than in a deployment)")
    print(f"  {name}: {cfg.num_layers} layers of {full.num_layers}, "
          f"d={cfg.d_model} {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.hd} d_ff={cfg.d_ff} vocab={cfg.vocab_size} rope={cfg.rope} "
          f"qkv_bias={cfg.qkv_bias} input={cfg.embed_input}{moe}: "
          f"{cfg.param_count() / 1e9:.3f} B parameters (param_count of the "
          f"run config; {full.param_count() / 1e9:.3f} B at full depth), "
          f"{nbytes / 2**30:.2f} GiB of {cfg.dtype} weights drawn on the "
          f"card from seed 0 in {time.perf_counter() - t0:.1f} s; cut: {cut}")
    return cfg, params


def frontier_prompts(cfg, n: int, length: int, seed: int):
    """``n`` prompts of ``length`` on the card: token ids, or (length, d)
    float32 embeddings for a stub frontend."""
    rng = np.random.default_rng(seed)
    if cfg.embed_input == "tokens":
        a = rng.integers(0, cfg.vocab_size, (n, length))
    else:
        a = rng.standard_normal((n, length, cfg.d_model)).astype(np.float32)
    return torch.from_numpy(a).cuda()


def _frontier_expect(label, cfg, forwards: int, steps: int, counts):
    """The launches of ``forwards`` forwards (one prefill, ``steps`` decode
    steps): ``unified_linear`` 4 attention projections and the MLP's (or
    the shared expert's) 2 or 3 a layer and the head, ``flash_attention``
    a layer at prefill, ``decode_fused`` a layer and step; an MoE layer's
    three expert projections on ``moe_gemm`` (all routing groups in one
    launch each) and its SiLU on ``gelu_lut``."""
    n = cfg.num_layers
    mlp = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
    moe = n if cfg.moe is not None else 0
    want = {"unified_linear": forwards * (n * (4 + mlp) + 1),
            "flash_attention": n, "decode_fused": n * steps,
            "moe_gemm": 3 * moe * forwards, "gelu_lut": moe * forwards,
            "moe_fused": 0}
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, planned {want}")
    print(f"  {label}: launches as planned over {forwards} forwards: "
          f"{json.dumps(counts)}")


def _frontier_report(label, report, moe: bool) -> None:
    """Every op on a kernel impl reports mode ``cuda``; the only fallback
    is an MoE layer's ``moe_ffn`` (no ``cuda`` impl: the staged path, its
    GEMMs on ``moe_gemm``), recorded with its reason."""
    for op, entry in report.items():
        for impl, modes in entry.get("modes", {}).items():
            if set(modes) != {"cuda"}:
                raise AssertionError(f"{label}: {op}/{impl} modes {modes}")
        for fb in entry.get("fallbacks", ()):
            if not (moe and op == "moe_ffn"):
                raise AssertionError(f"{label}: fallback {op}: {fb}")
            print(f"  {label}: recorded fallback {op} {fb['requested']} -> "
                  f"{fb['used']} x{fb['count']}: {fb['reasons'][0]}")
    if moe and report["moe_grouped_gemm"]["modes"] != {
            "cuda": {"cuda": report["moe_grouped_gemm"]["hits"]["cuda"]}}:
        raise AssertionError(f"{label}: moe_grouped_gemm "
                             f"{report['moe_grouped_gemm']}")


def _frontier_yardstick(cfg, params, prompts, kern, plain) -> bool:
    """(a) past 0.999: the same model in float32 (the bf16 weights widened
    one op at a time by the plain policy, the token table widened once),
    its prefill logits the yardstick of ``compare.serving_agrees``."""
    from repro_torch import ops
    from repro_torch.kernels.compare import (SERVE_NOISE_RATIO, cosine,
                                             serving_agrees)
    from repro_torch.models import model as M
    from repro_torch.train.step import make_serve_step

    cfg32 = replace(cfg, dtype="float32", policy=ops.policy_named("eager"))
    p32 = dict(params)
    if "embed.tokens" in p32:
        p32["embed.tokens"] = p32["embed.tokens"].float()
    prefill, _ = make_serve_step(cfg32)
    with torch.inference_mode():
        ref, _ = prefill(p32, prompts, M.init_state(
            cfg32, prompts.shape[0], LM_MAX_LEN))
    del p32
    k32, p32c = cosine(kern, ref), cosine(plain, ref)
    ok = serving_agrees([cosine(kern, plain)], [k32], [p32c])
    print(f"  bf16 noise exceeds 0.999: against the same model in float32 "
          f"the kernels sit at cosine {k32:.6f}, the plain policy at "
          f"{p32c:.6f}: distance ratio {(1 - k32) / (1 - p32c):.3f} (at most "
          f"{SERVE_NOISE_RATIO} x the plain policy's + 1e-3: "
          f"{'ok' if ok else 'FAIL'})")
    torch.cuda.empty_cache()
    return ok


def frontier_static(name, cfg, params, policy, units):
    """(a), (b), (d): one counted ``generate`` of 8 prompts of 128 (token
    ids or embeddings), 32 greedy tokens, ``max_len`` 512; the prefill and
    every decode step replayed teacher-forced (the argmax must give back
    the tokens; prefill ms, ms a step); the prefill logits against the
    plain ``eager`` policy.  For ``FRONTIER_UNITS`` a counted
    ``generate(prompts, 1)`` (a prefill and a decode step) and its
    recorded twin go to phase 5 (``units``); its counts are returned."""
    import time

    from repro_torch import ops
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.compare import cosine, serving_agrees
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeConfig, ServingEngine
    from repro_torch.train.step import make_serve_step

    prompts = frontier_prompts(cfg, LM_BATCH, LM_PROMPT, seed=0)
    engine = ServingEngine(cfg, params, ServeConfig(max_len=LM_MAX_LEN,
                                                    policy=policy))
    engine.generate(prompts, 2)               # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    ops.reset_dispatch_report()
    t0 = time.perf_counter()
    tokens = engine.generate(prompts, LM_NEW)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    report = ops.dispatch_report()
    read_variants(f"{name} generate", tally=False)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if tokens.shape != (LM_BATCH, LM_NEW) or not (
            (tokens >= 0) & (tokens < cfg.vocab_size)).all():
        raise AssertionError(f"{name}: tokens {tokens.shape} out of range")
    _frontier_expect(f"{name} generate", cfg, 1 + LM_NEW, LM_NEW, counts)
    _frontier_report(name, report, cfg.moe is not None)
    print(f"  {name} dispatch report: {json.dumps(report)}")

    prefill, decode = engine.steps()
    toks = torch.from_numpy(tokens).long().cuda()
    step_ms, prefill_ms = [], []
    with torch.inference_mode():
        for _ in range(3):
            state = M.init_state(cfg, LM_BATCH, LM_MAX_LEN)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, state = prefill(engine.params, prompts, state)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
        kern = logits
        for i in range(LM_NEW):
            if not torch.equal(torch.argmax(logits, -1), toks[:, i]):
                raise AssertionError(f"{name} step {i}: the replayed "
                                     "logits do not give back the tokens")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, state = decode(engine.params,
                                   engine.feedback(toks[:, i]), state,
                                   LM_PROMPT + i)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        del state
        plain_prefill, _ = make_serve_step(
            replace(cfg, policy=ops.policy_named("eager")))
        plain, _ = plain_prefill(engine.params, prompts, M.init_state(
            cfg, LM_BATCH, LM_MAX_LEN))
    cos = cosine(kern, plain)
    print(f"  {name} (a): prefill logits vs the plain eager policy on the "
          f"card, cosine {cos:.6f} (>= 0.999: "
          f"{'ok' if cos >= 0.999 else 'no'})")
    torch.cuda.empty_cache()
    ok = serving_agrees([cos]) or _frontier_yardstick(cfg, params, prompts,
                                                     kern, plain)
    if not ok:
        raise AssertionError(f"{name}: kernel logits disagree with the "
                             f"plain policy's (cosine {cos})")
    print(f"  {name}: prefill {statistics.median(prefill_ms):.3f} ms "
          f"(median of 3, B={LM_BATCH} x {LM_PROMPT}); decode "
          f"{statistics.median(step_ms):.3f} ms a step (median of {LM_NEW}, "
          f"B={LM_BATCH}, host wall to a synchronized card); generate "
          f"{wall * 1e3:.1f} ms, {LM_BATCH * LM_NEW / wall:.1f} tokens/s; "
          f"peak memory {peak:.2f} GiB")
    if cfg.moe is not None:
        _frontier_fused_moe(name, cfg, params, policy, prompts)
    unit_counts = None
    if name in FRONTIER_UNITS:
        reset_launch_counts()
        engine.generate(prompts, 1)
        unit_counts = launch_counts()
        variants = read_variants(f"{name} prefill + one step", tally=False)
        _frontier_expect(f"{name} prefill + one step", cfg, 2, 1,
                         unit_counts)
        prefill_calls, decode_calls = {}, {}
        with torch.inference_mode():
            state = M.init_state(cfg, LM_BATCH, LM_MAX_LEN)
            with recorded_launches(prefill_calls):
                logits, state = prefill(engine.params, prompts, state)
            with recorded_launches(decode_calls):
                decode(engine.params, engine.feedback(toks[:, 0]), state,
                       LM_PROMPT)
        del state
        units.append((variants, [
            Unit(f"{name} prefill, B={LM_BATCH} x {LM_PROMPT}", 1,
                 prefill_calls),
            Unit(f"{name} decode step, B={LM_BATCH}, cache "
                 f"{LM_PROMPT + 1} keys", 1, decode_calls)]))
    return engine, unit_counts


def _frontier_fused_moe(name, cfg, params, policy, prompts):
    """(b) An MoE decoder with ``moe_ffn="cuda_fused"``: ``moe_fused``
    cannot take the layer (the reference's reason: ``onehot`` dispatch;
    d 5120 is also past both variants' 768), and with the operands on the
    card the port's dispatch raises naming the reason rather than run
    another impl in the kernel's place (on the CPU the same call falls
    back to the staged path, recorded, as the reference's does); no
    ``moe_fused`` launch is made."""
    from repro_torch import ops
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    engine = ServingEngine(cfg, params, ServeConfig(
        max_len=LM_MAX_LEN, policy=policy.with_impls(moe_ffn="cuda_fused")))
    reset_launch_counts()
    try:
        engine.generate(prompts, 1)
    except ops.DispatchError as e:
        why = str(e)
    else:
        raise AssertionError(f"{name}: moe_fused took a layer it cannot "
                             f"hold")
    if "onehot" not in why or launch_counts()["moe_fused"]:
        raise AssertionError(f"{name} with moe_ffn=cuda_fused: {why}")
    print(f"  {name} with moe_ffn=cuda_fused (b): refused on the card, no "
          f"moe_fused launch: {why}")


def frontier_scheduler(name, cfg, params, policy, engine):
    """(c) 16 requests of 16..128-position prompts (token ids or
    embeddings) and 8..16 new tokens through the ``Scheduler`` in 8 slots,
    prompts padded to multiples of 16: each request's tokens equal the
    static engine serving it alone, bit for bit."""
    import time

    from repro_torch.serve import LMBackend, Request, Scheduler, ServeConfig

    rng = np.random.default_rng(2)
    lengths = [16, 64, 70, 80] + rng.integers(16, 129, 12).tolist()
    news = rng.integers(8, 17, 16).tolist()
    specs = []
    for i, (n, m) in enumerate(zip(lengths, news)):
        p = frontier_prompts(cfg, 1, n, seed=100 + i)[0].cpu().numpy()
        specs.append(dict(rid=i, task_id=0, prompt=p, max_new_tokens=m))
    t0 = time.perf_counter()
    want = {s["rid"]: engine.generate(s["prompt"][None],
                                      s["max_new_tokens"])[0].tolist()
            for s in specs}
    print(f"  {name} (c): the static engine served each of the 16 prompts "
          f"alone ({time.perf_counter() - t0:.1f} s)")
    backend = LMBackend(cfg, params, ServeConfig(max_len=LM_MAX_LEN,
                                                 policy=policy),
                        stub_table=engine.fb_table)
    sched = Scheduler(backend, total_slots=LM_BATCH, quantum=4, num_tasks=1)
    done = sched.run([Request(**s) for s in specs])
    _scheduler_report(f"{name} scheduler (c)", sched, done)
    if sorted(r.rid for r in done) != list(range(16)):
        raise AssertionError(f"{name} scheduler (c): not every request done")
    for r in done:
        if r.tokens != want[r.rid]:
            raise AssertionError(f"{name} scheduler (c): request {r.rid} "
                                 f"({len(r.prompt)} positions) differs from "
                                 f"the static engine's tokens")
    print("    every request's tokens equal the static engine's bit for bit")


@contextlib.contextmanager
def recorded_topk(sets: list):
    """Append the expert set that each routing call gives each row
    ((..., T, k), sorted per row, on the host) to ``sets``."""
    from repro_torch.core import routing as R

    route = R.route

    def recording(*args, **kwargs):
        r = route(*args, **kwargs)
        sets.append(torch.sort(r.expert, -1).values.cpu())
        return r

    R.route = recording
    try:
        yield
    finally:
        R.route = route


def topk_differences(a: list, b: list) -> tuple[int, int]:
    """(rows whose expert sets differ, rows) over the routing calls of two
    recorded runs of the same inputs (group padding rows included)."""
    differ = sum(int((x != y).any(-1).sum()) for x, y in zip(a, b))
    return differ, sum(x[..., 0].numel() for x in a)


def m3vit_many_path():
    """(e) M³ViT-many (256 experts, 8 tasks) through ``M3ViTServer`` at
    batch 8 under ``cuda`` and with ``moe_ffn="cuda_fused"``: outputs
    finite and at cosine >= 0.999 of the plain policy's or, past bf16
    noise, within the float32 yardstick of ``compare.serving_agrees``;
    the routed rows whose top-4 expert set differs between the kernels,
    the plain policy and float32 are printed beside it (how far routing
    flips account for the gap); frame 0 at batch 1, 2, 4 equal to its
    batch-8 bits; then the launcher's factored, budgeted example to its
    end."""
    import time

    from repro_torch import ops
    from repro_torch.configs import m3vit as MV
    from repro_torch.configs import m3vit_many as MVM
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.compare import cosine, serving_agrees
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.vit import init_params
    from repro_torch.serve.vision import M3ViTServer

    cfg = MVM.CONFIG
    t0 = time.perf_counter()
    params = init_params(0, cfg)
    n_moe = cfg.num_layers // 2
    print(f"  m3vit_many: {cfg.num_layers} layers d={cfg.d_model}, "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} over "
          f"{cfg.moe.num_tasks} tasks: {cfg.param_count() / 1e9:.3f} B "
          f"parameters ({sum(v.numel() * v.element_size() for v in params.values()) / 2**30:.2f} "
          f"GiB) from seed 0 in {time.perf_counter() - t0:.1f} s; cut: none")
    rng = np.random.default_rng(7)
    batches = [(task, rng.normal(size=(BATCH, MV.IMAGE_H, MV.IMAGE_W, 3))
                .astype(np.float32)) for task in MV.TASKS]
    topk: dict[tuple[str, str], list] = {}

    def infer_recorded(server, imgs, task, label):
        with recorded_topk(topk.setdefault((label, task), [])):
            return server.infer(imgs, task)

    blocked = ops.policy_named("blocked")
    plain = {task: torch.from_numpy(infer_recorded(M3ViTServer(
        replace(cfg, policy=blocked), params), imgs, task, "plain"))
        for task, imgs in batches}
    f32 = M3ViTServer(replace(cfg, dtype="float32", policy=blocked),
                      {k: v.float() for k, v in params.items()})
    ref32 = {task: torch.from_numpy(infer_recorded(f32, imgs, task, "f32"))
             for task, imgs in batches}
    del f32
    cuda = ops.policy_named("cuda")
    for label, policy in (("cuda", cuda), ("cuda + moe_ffn=cuda_fused",
                          cuda.with_impls(moe_ffn="cuda_fused"))):
        server = M3ViTServer(replace(cfg, policy=policy), params)
        for task, imgs in batches:
            server.infer(imgs, task)          # warm-up, not counted
        torch.cuda.synchronize()
        reset_launch_counts()
        outs = {task: infer_recorded(server, imgs, task, label)
                for task, imgs in batches}
        counts = launch_counts()
        variants = read_variants(f"m3vit_many {label}", tally=False)
        fused = "fused" in label
        if fused and (counts["moe_fused"] != n_moe * len(batches)
                      or counts["moe_gemm"]
                      or variants["moe_fused"].get("simt")):
            raise AssertionError(f"m3vit_many {label}: launches {counts}")
        if not fused and (counts["moe_gemm"] != 2 * n_moe * len(batches)
                          or counts["moe_fused"]):
            raise AssertionError(f"m3vit_many {label}: launches {counts}")
        print(f"  m3vit_many {label}: launches {json.dumps(counts)}")
        for task, imgs in batches:
            y = torch.from_numpy(outs[task])
            cos = cosine(y, plain[task])
            k32, p32 = cosine(y, ref32[task]), cosine(plain[task],
                                                       ref32[task])
            ok = serving_agrees([cos], [k32], [p32])
            print(f"  m3vit_many {label}, {task}: output {tuple(y.shape)}, "
                  f"cosine vs the plain blocked policy {cos:.6f}; against "
                  f"the same model in float32 the kernels {k32:.6f}, the "
                  f"plain policy {p32:.6f} ({'ok' if ok else 'FAIL'})")
            flips = [topk_differences(topk[x], topk[y]) for x, y in (
                ((label, task), ("plain", task)),
                ((label, task), ("f32", task)),
                (("plain", task), ("f32", task)))]
            print(f"    routed rows whose top-{cfg.moe.top_k} expert set "
                  f"differs, of {flips[0][1]} over {n_moe} MoE layers: "
                  f"kernels vs plain {flips[0][0]}, kernels vs float32 "
                  f"{flips[1][0]}, plain vs float32 {flips[2][0]}")
            if not torch.isfinite(y).all() or not ok:
                raise AssertionError(f"m3vit_many {label} {task}: cosine "
                                     f"{cos}")
        _time_batches(server, batches)
        batch_independence(server, batches, f"m3vit_many {label}")
        del server
    del plain, ref32, params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    print(f"  m3vit_many, the launcher's example: python -m "
          f"repro_torch.launch.serve {' '.join(M3VIT_MANY_LAUNCH)}")
    if launch_serve.main(M3VIT_MANY_LAUNCH) != 0:
        raise AssertionError("the m3vit_many launcher example failed")
    print(f"  m3vit_many launcher example ran to its end in "
          f"{time.perf_counter() - t0:.1f} s")


def frontier_path() -> list:
    """Phase 8: the six remaining decoders at full width (three cut in
    depth) and M³ViT-many, one model at a time, each freed before the
    next.  Returns the phase-5 records of ``FRONTIER_UNITS``' counted
    prefill-and-step runs (each checked and timed while its model lives),
    to be added to the kernels' entries."""
    import time

    from repro_torch import ops

    t_phase = time.perf_counter()
    policy = ops.policy_named("cuda").with_impls(attention_decode="cuda_fused")
    extra = []
    for name in FRONTIER:
        t0 = time.perf_counter()
        cfg, params = frontier_model(name)
        units = []
        engine, unit_counts = frontier_static(name, cfg, params, policy,
                                              units)
        if name in FRONTIER_SCHEDULED:
            frontier_scheduler(name, cfg, params, policy, engine)
        if unit_counts is not None:
            print(f"  phase 5 units of {name}, checked and timed now (the "
                  f"model is freed before the next)")
            extra.append(path_records(units[0][1], unit_counts, units[0][0]))
        del engine, params, units     # the recorded launches hold weights
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  {name}: {time.perf_counter() - t0:.1f} s")
    m3vit_many_path()
    print(f"  phase 8 wall time {time.perf_counter() - t_phase:.1f} s")
    return extra


def add_records(records, extra) -> None:
    """Add phase 8's per-kernel readings (``path_records`` of its units)
    into phase 5's records: launches, times and bounds summed, units
    appended."""
    for more in extra:
        for rec, add in zip(records, more):
            if not add["launches"]:
                continue
            t = rec.pop("_total")
            _add(t, add.pop("_total"))
            rec.update(_entry(t), _total=t)
            rec["launches"] += add["launches"]
            rec["max_abs_err"] = max(rec["max_abs_err"], add["max_abs_err"])
            rec["units"] += add["units"]
            for v, k in add.get("variants", {}).items():
                rec.setdefault("variants", {})[v] = \
                    rec.get("variants", {}).get(v, 0) + k
    for rec in records:
        rec.pop("_total", None)


# ------------------------------------------------------------ phase 5


@dataclass
class Case:
    """One recorded launch, ready to check and time."""

    key: object                 # launches with equal keys share one reading
    label: str
    kernel: Callable
    plain: Callable
    library: Optional[Callable]
    nbytes: float
    flops: float
    peak: torch.dtype           # the type whose peak rate bounds the flops
    tol: Optional[Callable] = dict    # -> tolerance keywords; None: exact
    after: Optional[Callable] = None  # further check of the kernel's output
    staged: Optional[Callable] = None  # moe_fused: the staged cuda path
    variant: Optional[str] = None     # the planned kernel variant


def _linear_case(args) -> Case:
    from repro_torch.core.gelu import device_table
    from repro_torch.kernels import unified_linear as kul

    x, w, b, act, use_lut, step, rng, out_dtype, order_n = args
    m, k = x.shape
    n = w.shape[1]
    kw = dict(activation=act, use_lut=use_lut, step_log2=step, lut_range=rng,
              out_dtype=out_dtype)
    lut = bool(use_lut and act in ("gelu", "silu"))
    out_size = (x if out_dtype is None else torch.empty(
        (), dtype=out_dtype)).element_size()
    moved = (m * k + k * n) * x.element_size() + m * n * out_size \
        + (_nbytes(b) if b is not None else 0) \
        + (_nbytes(device_table(act, step, rng, x.device)) if lut else 0)
    plan = kul.plan_for(x, w, order_n=order_n)
    return Case(
        key=("linear", m, k, n, x.dtype, act, lut, b is not None, out_dtype,
             order_n),
        label=f"M={m} K={k} N={n} {act or 'none'}{'-lut' if lut else ''}"
              f"{' +bias' if b is not None else ''} {_dt(x)} "
              f"[{_plan_label(plan)}]", variant=plan.variant,
        kernel=lambda: kul.unified_linear(x, w, b, order_n=order_n, **kw),
        plain=lambda: kul.unified_linear_plain(x, w, b, **kw),
        library=lambda: torch.matmul(x, w), nbytes=moved,
        flops=2.0 * m * n * k, peak=x.dtype,
        tol=lambda: dict(
            lut_pre=kul.unified_linear_plain(x.float(), w.float(), b)
            if lut else None,
            kind=act if lut else "gelu", step_log2=step, lut_range=rng))


def _attention_case(args) -> Case:
    from repro_torch.core.attention import allowed_keys
    from repro_torch.kernels import flash_attention as kfa

    q, k, v, causal, window, q_offset, scale = args
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    ok = allowed_keys(torch.arange(sq, device=q.device) + q_offset,
                      torch.arange(skv, device=q.device), causal, window)
    pairs, keys = int(ok.sum()), int(ok.any(dim=0).sum())
    mask = ok if causal or window is not None else None
    kw = dict(causal=causal, window=window, q_offset=q_offset, scale=scale)
    plan = kfa.plan_for(q)
    return Case(
        key=("attention", tuple(q.shape), tuple(k.shape), q.dtype, causal,
             window, q_offset),
        label=f"B={b} Hq={hq} Hkv={hkv} Sq={sq} Skv={skv} D={d} "
              f"{'causal' if causal else 'non-causal'} q_offset={q_offset} "
              f"window={window} {_dt(q)} ({keys} keys visible) "
              f"[{_attn_label(plan)}]", variant=plan.variant,
        kernel=lambda: kfa.flash_attention(q, k, v, **kw),
        plain=lambda: kfa.flash_attention_plain(q, k, v, **kw),
        library=lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale, enable_gqa=hq != hkv),
        nbytes=(2 * q.numel() + 2 * b * hkv * keys * d) * q.element_size(),
        flops=4.0 * b * hq * pairs * d, peak=q.dtype)


def _activation_case(args) -> Case:
    from repro_torch.core.gelu import device_table
    from repro_torch.kernels import gelu_lut as kgl

    x, kind, step, rng = args
    return Case(
        key=("lut", tuple(x.shape), x.dtype, kind),
        label=f"{tuple(x.shape)} {kind} {_dt(x)}",
        kernel=lambda: kgl.lut_activation(x, kind, step_log2=step,
                                          lut_range=rng),
        plain=lambda: kgl.lut_activation_plain(x, kind, step_log2=step,
                                               rng=rng),
        library=None,
        nbytes=2 * _nbytes(x) + _nbytes(device_table(kind, step, rng,
                                                     x.device)),
        flops=10.0 * x.numel(), peak=torch.float32, tol=None)


def _moe_gemm_case(args) -> Case:
    from repro_torch.kernels import moe_gemm as kmg

    buf, w, sizes = args
    g, e, c, d = buf.shape
    f = w.shape[2]
    live = int(sizes.sum())
    active = int((sizes > 0).any(dim=0).sum())
    xb = buf.transpose(0, 1).reshape(e, g * c, d).contiguous()
    s = buf.element_size()
    plan = kmg.plan_for(buf, w)
    return Case(
        key=("moe_gemm", tuple(buf.shape), tuple(w.shape), buf.dtype,
             tuple(sizes.flatten().tolist())),
        label=f"G={g} E={e} C={c} D={d} F={f} {_dt(buf)}: {live} of "
              f"{g * e * c} rows live, {active} experts used "
              f"[{_plan_label(plan)}]", variant=plan.variant,
        kernel=lambda: kmg.moe_gemm(buf, w, sizes),
        plain=lambda: kmg.moe_gemm_plain(buf, w, sizes),
        library=lambda: torch.bmm(xb, w),
        nbytes=live * d * s + active * d * f * s + g * e * c * f * s
        + _nbytes(sizes),
        flops=2.0 * live * d * f, peak=buf.dtype,
        after=lambda got: _zero_tails("moe_gemm", got, sizes))


_EXPERT_WEIGHTS = {"gelu": ("w1", "b1", "w2", "b2"),
                   "swiglu": ("wg", "wu", "wd")}


def _moe_fused_case(args) -> Case:
    from repro_torch import ops
    from repro_torch.core import routing as R
    from repro_torch.core.gelu import device_table
    from repro_torch.core.moe import MoEConfig
    from repro_torch.kernels import moe_fused as kmf
    from repro_torch.kernels.compare import moe_lut_allowance

    (x, params, expert, gate, position, valid, sizes, kind, capacity,
     use_lut, step, rng) = args
    g, t, d = x.shape
    k, e = expert.shape[-1], sizes.shape[-1]
    weights = [params[n] for n in _EXPERT_WEIGHTS[kind]]
    f = weights[0].shape[-1]
    live, dropped = int(sizes.sum()), int((~valid).sum())
    active = int((sizes > 0).any(dim=0).sum())
    plan = kmf.plan_for(x, params, kind, capacity, device_table(
        "silu" if kind == "swiglu" else "gelu", step, rng,
        x.device) if use_lut else None)
    if plan.variant == "tc":    # 64 packed rows of one expert a block
        per_e = sizes.clamp(0, capacity).sum(dim=0)
        ran = int(((per_e + 63) // 64).sum()) * plan.grid[1]
    else:                       # 32 rows of one (group, expert) a block
        ran = int(((sizes.clamp(0, capacity) + 31) // 32).sum())
    call = (x, params, expert, gate, position, valid, sizes)
    kw = dict(kind=kind, capacity=capacity, use_lut=use_lut, step_log2=step,
              lut_range=rng)
    mcfg = MoEConfig(d_model=d, d_ff=f, num_experts=e, top_k=k,
                     expert_kind=kind)
    routing = R.Routing(expert=expert, gate=gate, position=position,
                        valid=valid, probs=None)
    staged_policy = ops.policy_named("cuda")

    def staged():
        with ops.use_policy(staged_policy):
            return ops.dispatch("moe_ffn", x, params, routing, sizes,
                                cfg=mcfg, capacity=capacity)

    per_expert = sum(w[0].numel() * w.element_size() for w in weights)
    return Case(
        key=None,               # every layer's routing is its own
        label=f"G={g} T={t} E={e} top-{k} C={capacity} d={d} f={f} "
              f"{kind}{'-lut' if use_lut else ''} {_dt(x)}: {live} slots "
              f"live, {dropped} dropped, {active} experts used, longest "
              f"queue {int(sizes.max())}, {ran} of {plan.blocks or ran} "
              f"blocks ran [{_fused_label(plan)}]", variant=plan.variant,
        kernel=lambda: kmf.fused_moe_ffn(*call, **kw),
        plain=lambda: kmf.fused_moe_ffn_plain(*call, **kw),
        library=None, staged=staged,
        nbytes=2 * _nbytes(x) + active * per_expert
        + _nbytes(expert, gate, position, valid, sizes),
        flops=(4.0 if kind == "gelu" else 6.0) * live * d * f, peak=x.dtype,
        tol=lambda: dict(extra=moe_lut_allowance(
            x, params, expert, gate, valid, kind=kind, step_log2=step,
            lut_range=rng) if use_lut else None))


def _decode_case(args) -> Case:
    from repro_torch.kernels import decode_fused as kdf

    q, k, v, cl, window, scale = args
    b, hq, _, d = q.shape
    hkv, smax = k.shape[1], k.shape[2]
    kpos = torch.arange(smax, device=q.device)[None, :]
    ok = kpos < cl[:, None]
    if window is not None:
        ok = ok & (kpos > cl[:, None] - 1 - window)
    n_keys = int(ok.sum())
    lengths = cl.tolist()
    kw = dict(window=window, scale=scale)
    return Case(
        key=("decode", tuple(q.shape), tuple(k.shape), q.dtype, window,
             tuple(lengths)),
        label=f"B={b} Hq={hq} Hkv={hkv} Smax={smax} D={d} cache_len "
              f"{min(lengths)}..{max(lengths)} window={window} {_dt(q)}",
        kernel=lambda: kdf.fused_decode_attention(q, k, v, cl, **kw),
        plain=lambda: kdf.fused_decode_attention_plain(q, k, v, cl, **kw),
        library=lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=ok[:, None, None, :], scale=scale,
            enable_gqa=hq != hkv),
        nbytes=2 * _nbytes(q) + 2 * n_keys * hkv * d * q.element_size()
        + _nbytes(cl),
        flops=4.0 * n_keys * hq * d, peak=q.dtype)


CASES = {"unified_linear": _linear_case, "flash_attention": _attention_case,
         "gelu_lut": _activation_case, "moe_gemm": _moe_gemm_case,
         "moe_fused": _moe_fused_case, "decode_fused": _decode_case}


def _check_case(name, case) -> tuple[float, float, float]:
    """Hold one recorded launch against its plain version, and time the
    launch alone (replayed on the same operands, which stay warm in L2);
    (max error, ms alone, bound ms)."""
    got, want = case.kernel(), case.plain()
    if case.tol is None:
        err = check_exact(name, case.label, got, want)
    else:
        err = check(name, case.label, got, want, want.dtype, **case.tol())
    if case.after is not None:
        case.after(got)
    del got, want
    alone = time_ms(case.kernel)
    t_bytes, t_ops = bound_ms(case.nbytes, case.flops, case.peak)
    print(f"    alone {alone:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
          f"({'bytes' if t_bytes >= t_ops else 'operations'})")
    return err, alone, (t_bytes, t_ops)


def _in_order(fns):
    def run():
        for fn in fns:
            fn()
    return run


def _run_reading(run) -> dict:
    """One run's recorded launches replayed in their order: the kernels,
    the plain versions, the library calls (and the staged path) each as one
    CUDA graph, so every launch meets its own operands as in the path."""
    t = {"ms": time_ms(_in_order([c.kernel for c in run]), calls=1),
         "plain_ms": time_ms(_in_order([c.plain for c in run]), calls=1),
         "library_ms": None}
    if all(c.library is not None for c in run):
        t["library_ms"] = time_ms(_in_order([c.library for c in run]),
                                  calls=1)
    if all(c.staged is not None for c in run):
        t["staged_cuda_ms"] = time_ms(_in_order([c.staged for c in run]),
                                      calls=1)
    return t


def _add(total: dict, t: dict) -> None:
    for k, v in t.items():
        total[k] = None if v is None else (total.get(k) or 0.0) + v


def _entry(total: dict) -> dict:
    out = {k: total[k] for k in ("ms", "plain_ms", "bound_ms")}
    out["bound_by"] = ("bytes" if total["bytes_ms"] >= total["ops_ms"]
                       else "operations")
    out["library_ms"] = total["library_ms"]
    for k in ("staged_cuda_ms", "alone_ms"):
        if k in total:
            out[k] = total[k]
    return out


def path_records(units, counted, counted_variants=None) -> list[dict]:
    """Each kernel's JSON entry from the recorded launches of the main
    paths, whose number must equal the counted launches (and whose planned
    variants the counted ones: ``counted_variants``, by default
    COUNTED_VARIANTS).  Every distinct launch (by shape and data) is
    checked and timed alone once; every distinct run is timed in order
    once.  A kernel no unit launched gets ``launches`` 0 and no times;
    each entry keeps its sums under ``_total`` (``add_records``)."""
    from repro_torch.kernels import KERNELS

    if counted_variants is None:
        counted_variants = COUNTED_VARIANTS
    checked: dict = {}      # case key -> (err, alone ms, bound parts)
    timed: dict = {}        # run's case keys -> in-order reading
    records = []
    for name in KERNELS:
        recorded = sum(len(u.calls.get(name, ())) for u in units)
        if recorded != counted[name]:
            raise AssertionError(f"{name}: {recorded} launches recorded in "
                                 f"the twins, {counted[name]} counted")
        rows, total, max_err, variants = [], {}, 0.0, {}
        for u in units:
            cases = [CASES[name](args) for args in u.calls.get(name, ())]
            if not cases:
                continue
            if len(cases) % u.runs:
                raise AssertionError(f"{name}: {len(cases)} launches over "
                                     f"{u.runs} runs of {u.label}")
            unit_total = {"alone_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                          "bound_ms": 0.0}
            for case in cases:
                if case.key is None or case.key not in checked:
                    reading = _check_case(name, case)
                    if case.key is not None:
                        checked[case.key] = reading
                else:
                    reading = checked[case.key]
                err, alone, (t_bytes, t_ops) = reading
                max_err = max(max_err, err)
                _add(unit_total, {"alone_ms": alone, "bytes_ms": t_bytes,
                                  "ops_ms": t_ops,
                                  "bound_ms": max(t_bytes, t_ops)})
            per = len(cases) // u.runs
            for i in range(u.runs):
                run = cases[i * per:(i + 1) * per]
                keys = tuple(c.key for c in run)
                if None in keys or keys not in timed:
                    reading = _run_reading(run)
                    if None not in keys:
                        timed[keys] = reading
                else:
                    reading = timed[keys]
                _add(unit_total, reading)
            _add(total, unit_total)
            row = {"per": u.label, "runs": u.runs, "launches": len(cases),
                   **_entry(unit_total)}
            if cases[0].variant is not None:
                row["variants"] = {}
                for c in cases:
                    row["variants"][c.variant] = \
                        row["variants"].get(c.variant, 0) + 1
                for v, k in row["variants"].items():
                    variants[v] = variants.get(v, 0) + k
            rows.append(row)
            n = u.runs
            lib = row["library_ms"]
            print(f"  {name} per {u.label}: {per} launches, in order: kernel "
                  f"{row['ms'] / n:.4f} ms, plain {row['plain_ms'] / n:.4f} "
                  f"ms, library "
                  f"{'%.4f ms' % (lib / n) if lib is not None else 'n/a'}"
                  + (f", staged cuda path {row['staged_cuda_ms'] / n:.4f} ms"
                     if "staged_cuda_ms" in row else "")
                  + f"; alone {row['alone_ms'] / n:.4f} ms; bound "
                  f"{row['bound_ms'] / n:.4f} ms ({row['bound_by']})"
                  + (f"; variants {row['variants']}" if "variants" in row
                     else ""))
        if not rows:
            records.append({"name": name, "launches": 0})
            continue
        extra = {}
        if name in counted_variants:
            counted_v = {v: k for v, k in counted_variants[name].items() if k}
            if variants != counted_v:
                raise AssertionError(f"{name}: recorded launches planned "
                                     f"{variants}, counters {counted_v}")
            extra["variants"] = variants
        records.append({"name": name, "route": "cuda",
                        "source": SOURCES[name], "replaces": REPLACES[name],
                        "launches": counted[name], "max_abs_err": max_err,
                        **_entry(total), **extra,
                        "per": "every launch of the counted main-path runs",
                        "units": rows, "_total": total})
    return records


# ------------------------------------------------------------ phase 9

#: the dry-run's peak against the card's: 10 % or 64 MiB, the larger; its
#: argument bytes against the card's allocation: 1 %
PEAK_TOL, PEAK_FLOOR, ARG_TOL = 0.10, 64 * 2**20, 0.01


def _wall_ms(run, reps: int = 5) -> float:
    """Median host wall time of one call that ends on the card."""
    import time

    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


#: kernel -> the prefix of its CUDA functions' names
KERNEL_NAME_PREFIXES = {"unified_linear": "unified_linear",
                        "flash_attention": "flash_attention",
                        "gelu_lut": "lut_activation", "moe_gemm": "moe_gemm",
                        "moe_fused": "moe_fused",
                        "decode_fused": "decode_fused"}


def _busy_by_scope(run, reps: int = 3) -> tuple[float, dict]:
    """(device busy ms per call, {scope: device ms per call}) from a
    ``torch.profiler`` run: the busy time is the union of the device's
    kernel and copy intervals (``serve/profile.py:_busy_us``).  A PyTorch
    kernel counts for the innermost scope open when its host-side launch
    was made (the scopes open a ``record_function`` while the profiler
    runs), else ``other``.  The hand-written kernels launch through
    ``ctypes``, which the profiler does not tie to a host call: their
    wrappers' launches are recorded with the scope they were made in, and
    matched to the device's kernels of that name in stream order (a
    stream runs its kernels in launch order)."""
    from collections import defaultdict

    from repro_torch import kernels
    from repro_torch.roofline import scope as S
    from repro_torch.roofline.scope import SCOPE_MARKERS
    from repro_torch.serve.profile import _busy_us, _short

    names = set(SCOPE_MARKERS) | {"moe_aux"}
    launched = defaultdict(list)        # kernel -> [scope], in order
    saved = []
    for name, wrapper in kernels.KERNELS.items():
        mod = sys.modules[wrapper.__module__]

        def note(*args, _launch=mod._launch, _name=name):
            launched[_name].append(S.current())
            return _launch(*args)

        saved.append((mod, mod._launch))
        mod._launch = note
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
    finally:
        for mod, launch in saved:
            mod._launch = launch
    events = prof.events()
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.name not in names]
    if not device:
        raise AssertionError("the profiler recorded no device time")
    busy = _busy_us((e.time_range.start, e.time_range.end)
                    for e in device) / reps / 1e3
    by_scope = defaultdict(float)
    # the hand-written kernels, matched in stream order
    for name, prefix in KERNEL_NAME_PREFIXES.items():
        ours = sorted((e for e in device
                       if _short(e.name).startswith(prefix)),
                      key=lambda e: e.time_range.start)
        scopes = launched.get(name, [])
        if not ours:
            continue
        if not scopes or len(ours) % len(scopes):
            # a launch that issued a varying number of kernels: the
            # family's time stays whole, under its own name
            print(f"    {name}: {len(ours)} device kernels for "
                  f"{len(scopes)} launches, not matched to scopes")
            scopes, per = [f"{name} (unmatched)"], len(ours)
        else:
            per = len(ours) // len(scopes)
        for j, e in enumerate(ours):
            by_scope[scopes[j // per]] += \
                e.time_range.elapsed_us() / reps / 1e3
    # PyTorch's own kernels, by their host-side launch
    host = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU]
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in host if e.name in names)
    own_launches = []
    for e in host:
        own = getattr(e, "self_device_time_total", None)
        own = e.self_cuda_time_total if own is None else own
        if own and e.name not in names:
            own_launches.append((e.time_range.start, own))
    open_spans, i = [], 0           # the scopes open at time t, nested
    for t, own in sorted(own_launches):
        while i < len(spans) and spans[i][0] <= t:
            while open_spans and open_spans[-1][1] < spans[i][0]:
                open_spans.pop()
            open_spans.append(spans[i])
            i += 1
        while open_spans and open_spans[-1][1] < t:
            open_spans.pop()
        by_scope[open_spans[-1][2] if open_spans else "other"] += \
            own / reps / 1e3
    return busy, dict(by_scope)


def _phase5_ops(calls) -> dict:
    """Phase 5's operation counts of recorded launches: 2·m·n·k a
    ``unified_linear``, 2·live·d·f a ``moe_gemm`` (live queue rows), (4 or
    6)·live·d·f a ``moe_fused``, 4·b·hq·pairs·d an attention launch
    (visible pairs only)."""
    out = {}
    for name, launches in calls.items():
        case = CASES[name]
        out[name] = sum(case(args).flops for args in launches)
    return out


def roofline_unit(label, run, eager_run, cfg, shape, kernels, smi):
    """Phase 9 on one unit: (a) the counter under the kernel policy and
    under ``eager`` (equal totals; the kernels launched), (b) the
    counter's FLOPs of ``unified_linear`` (equal) and of the expert
    products (>=, capacity rows) against phase 5's counts of the same
    launches, (d) the roofline time beside the device's busy time and the
    host wall."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.roofline.analysis import analyze_step
    from repro_torch.roofline.op_cost import count_cost

    with torch.no_grad():
        run()                                   # warm-up
        torch.cuda.synchronize()
        reset_launch_counts()
        with recorded_launches({}) as calls:
            report, _ = analyze_step(run, (), cfg, shape)
        torch.cuda.synchronize()
        counts = launch_counts()
        _, eager = count_cost(eager_run)
    print(f"  {label}: counted {report.hlo_flops:.6e} FLOPs, "
          f"{report.hlo_bytes:.6e} bytes under the kernels; eager "
          f"{eager.flops:.6e} FLOPs, {eager.bytes_accessed:.6e} bytes; "
          f"launches {json.dumps({k: v for k, v in counts.items() if v})}")
    if (report.hlo_flops, report.hlo_bytes) != (eager.flops,
                                                eager.bytes_accessed):
        raise AssertionError(f"{label}: the count under the kernels differs "
                             f"from eager's")
    if {k: v["flops"] for k, v in report.by_scope.items()} != \
            {k: v["flops"] for k, v in eager.by_scope.items()}:
        raise AssertionError(f"{label}: the count by scope differs")
    missing = [k for k in kernels if not counts[k]]
    if missing:
        raise AssertionError(f"{label}: {missing} never launched")
    ops5 = _phase5_ops(calls)
    lin = report.by_op.get("linear", {}).get("flops", 0.0)
    print(f"    unified_linear: counter {lin:.6e} FLOPs, phase 5's count "
          f"of the same {len(calls.get('unified_linear', ()))} launches "
          f"{ops5.get('unified_linear', 0.0):.6e}")
    if lin != ops5.get("unified_linear", 0.0):
        raise AssertionError(f"{label}: unified_linear FLOPs differ")
    for name in ("moe_gemm", "moe_fused"):
        if name in ops5:
            gemm = report.by_op["moe_grouped_gemm"]["flops"]
            print(f"    {name}: counter {gemm:.6e} FLOPs over the capacity "
                  f"rows >= phase 5's {ops5[name]:.6e} over the live rows")
            if gemm < ops5[name]:
                raise AssertionError(f"{label}: {name} counted below its "
                                     f"live rows")
    for name in ("flash_attention", "decode_fused"):
        if name in ops5:
            att = sum(v["flops"] for k, v in report.by_op.items()
                      if k.startswith("attention"))
            print(f"    {name}: counter {att:.6e} FLOPs over the whole "
                  f"rectangle (the reference's count), phase 5's "
                  f"{ops5[name]:.6e} over the visible pairs")
    with torch.no_grad():
        wall = _wall_ms(run)
        busy, scopes = _busy_by_scope(run)
    bound = report.t_roofline * 1e3
    top = sorted(scopes.items(), key=lambda kv: -kv[1])[:6]
    print(f"    roofline {bound:.4f} ms ({report.bottleneck}: compute "
          f"{report.t_compute * 1e3:.4f} ms, memory "
          f"{report.t_memory * 1e3:.4f} ms); busy {busy:.4f} ms, wall "
          f"{wall:.4f} ms; bound/busy {bound / busy:.4f}, bound/wall "
          f"{bound / wall:.4f} [{smi}]")
    print(f"    busy by scope (ms): "
          + ", ".join(f"{k} {v:.4f}" for k, v in top))
    return {"unit": label, "roofline_ms": bound,
            "bottleneck": report.bottleneck, "busy_ms": busy,
            "wall_ms": wall, "bound_over_busy": bound / busy,
            "bound_over_wall": bound / wall,
            "flops": report.hlo_flops, "bytes": report.hlo_bytes}


def _memory_check(cfg, params, tokens, state, prefill) -> None:
    """(c) The dry-run's meta counts of the Llama prefill under ``eager``
    against the card: its peak live bytes against
    ``max_memory_allocated`` (less what was allocated before), its
    argument bytes against the allocation the weights and cache took."""
    from repro_torch import ops
    from repro_torch.models import model as LM
    from repro_torch.quant import tree_bytes
    from repro_torch.roofline.op_cost import count_cost

    b, s = tokens.shape
    meta_args = (LM.param_specs(cfg),
                 torch.empty((b, s), dtype=tokens.dtype, device="meta"),
                 LM.init_state(cfg, b, state_len(state), device="meta"))
    with torch.no_grad(), ops.use_policy(ops.policy_named("eager")):
        _, meta = count_cost(prefill, *meta_args)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        prefill(params, tokens, state)
        torch.cuda.synchronize()
        card_peak = torch.cuda.max_memory_allocated() - before
    tol = max(PEAK_TOL * card_peak, PEAK_FLOOR)
    print(f"  Llama prefill under eager: dry-run peak live "
          f"{meta.peak_live_bytes / 2**20:.1f} MiB (meta), card "
          f"max_memory_allocated - before {card_peak / 2**20:.1f} MiB, "
          f"tolerance {tol / 2**20:.1f} MiB")
    if abs(meta.peak_live_bytes - card_peak) > tol:
        raise AssertionError("the dry-run's peak misses the card's")
    return tree_bytes(meta_args)


def state_len(state) -> int:
    return next(iter(state["layers"].values()))["k"].shape[3]


def roofline_path(smi) -> list:
    """Phase 9: the roofline of the main paths at full width."""
    from repro_torch import ops
    from repro_torch.configs import llama3_2_1b as LL
    from repro_torch.configs import m3vit as MV
    from repro_torch.configs.base import Shape
    from repro_torch.models import model as LM
    from repro_torch.models import vit
    from repro_torch.train.step import make_serve_step

    total = torch.cuda.get_device_properties(0).total_memory
    print(f"  the card's memory: total_memory {total} bytes; the dry-run's "
          f"HW.HBM_BYTES {HW.HBM_BYTES}")
    out = []
    params = vit.init_params(0, MV.CONFIG)
    images = randn((BATCH, MV.IMAGE_H, MV.IMAGE_W, 3), torch.float32,
                   seed=9)
    shape = Shape("m3vit_b8", "prefill", MV.NUM_PATCHES, BATCH)
    cuda = ops.policy_named("cuda")

    def m3vit(policy):
        cfg = replace(MV.CONFIG, policy=policy)
        return lambda: vit.forward(params, images, cfg, "semseg")

    for label, policy, kernels in (
            ("M3ViT semseg forward B=8, cuda", cuda, CUDA_PATH_KERNELS),
            ("M3ViT semseg forward B=8, moe_ffn=cuda_fused",
             cuda.with_impls(moe_ffn="cuda_fused"),
             ("unified_linear", "flash_attention", "moe_fused"))):
        out.append(roofline_unit(label, m3vit(policy),
                                 m3vit(ops.policy_named("eager")),
                                 MV.CONFIG, shape, kernels, smi))
    del params, images
    torch.cuda.empty_cache()

    cfg = LL.CONFIG
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    lparams = LM.init_params(0, cfg, draw_on_device=True)
    state = LM.init_state(cfg, LM_BATCH, LM_MAX_LEN)
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, size=(LM_BATCH, LM_PROMPT))).cuda()
    torch.cuda.synchronize()
    card_args = torch.cuda.memory_allocated() - m0
    prefill, decode = make_serve_step(cfg)
    meta_args = _memory_check(cfg, lparams, tokens, state, prefill)
    print(f"  Llama prefill argument bytes: dry-run {meta_args / 2**20:.1f}"
          f" MiB (meta), card memory_allocated after the weights, cache "
          f"and tokens {card_args / 2**20:.1f} MiB")
    if abs(meta_args - card_args) > ARG_TOL * card_args:
        raise AssertionError("the dry-run's argument bytes miss the card's")
    kern = cuda.with_impls(attention_decode="cuda_fused")

    def with_policy(policy, fn, *args):
        def run():
            with ops.use_policy(policy):
                return fn(*args)
        return run

    pshape = Shape("prefill_8x128", "prefill", LM_PROMPT, LM_BATCH)
    out.append(roofline_unit(
        f"Llama-3.2-1B prefill {LM_BATCH}x{LM_PROMPT}, cuda",
        with_policy(kern, prefill, lparams, tokens, state),
        with_policy(ops.policy_named("eager"), prefill, lparams, tokens,
                    state), cfg, pshape, ("unified_linear",
                                          "flash_attention"), smi))
    token = tokens[:, :1].contiguous()
    dshape = Shape("decode_b8", "decode", LM_PROMPT + 1, LM_BATCH)
    out.append(roofline_unit(
        f"Llama-3.2-1B decode step B={LM_BATCH} at {LM_PROMPT} cached, "
        f"cuda + attention_decode=cuda_fused",
        with_policy(kern, decode, lparams, token, state, LM_PROMPT),
        with_policy(ops.policy_named("eager"), decode, lparams, token,
                    state, LM_PROMPT), cfg, dshape,
        ("unified_linear", "decode_fused"), smi))
    return out


# ------------------------------------------------------------ phase 10

#: the FileStore of phase 10 (b)'s two ranks, under the git-ignored build/
MESH_STORE = ROOT / "build" / "mesh_two_ranks"
MESH_BATCHES = 3       # median of this many host walls per mesh reading


def _wall_ms(run, reps: int = MESH_BATCHES) -> float:
    import time

    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls) * 1e3


def _mesh_run(label, run, total) -> object:
    """``run()`` counted: launch counts set to 0 just before and read just
    after, added into ``total``; fails on any recorded fallback or kernel
    impl that did not run on the card; prints the launches by kernel and
    the collectives."""
    from repro_torch import ops
    from repro_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    ops.reset_dispatch_report()
    out = run()
    torch.cuda.synchronize()
    counts = launch_counts()
    report = ops.dispatch_report()
    for op, entry in report.items():
        if entry["fallbacks"]:
            raise AssertionError(f"{label}: {op} fell back: "
                                 f"{entry['fallbacks']}")
        for impl, modes in entry["modes"].items():
            if set(modes) != {"cuda"}:
                raise AssertionError(f"{label}: {op}/{impl} ran {modes}")
    coll = {}
    for c in ops.collective_report():
        key = f"{c['kind']}:{c['axis']}"
        coll[key] = coll.get(key, 0) + c["count"]
    for n, c in counts.items():
        total[n] = total.get(n, 0) + c
    print(f"  {label}: launches {json.dumps(counts)}; collectives "
          f"{json.dumps(coll)}; no fallback")
    return out


def _bit_equal(label, got, want) -> None:
    same = torch.equal(torch.as_tensor(got), torch.as_tensor(want))
    print(f"  {label}: bit-equal to no mesh: {same}")
    if not same:
        raise AssertionError(f"{label}: differs from the run with no mesh")


def _mesh_vision(rules, policy, total) -> None:
    from repro_torch.configs import m3vit as MV
    from repro_torch.core import moe as moe_lib
    from repro_torch.dist.sharding import use_rules
    from repro_torch.models.vit import init_params
    from repro_torch.ops import use_policy
    from repro_torch.serve.vision import M3ViTServer

    cfg = replace(MV.CONFIG, policy=policy)
    params = init_params(0, cfg)
    rng = np.random.default_rng(0)
    imgs = rng.normal(size=(BATCH, MV.IMAGE_H, MV.IMAGE_W, 3)).astype(
        np.float32)
    plain = M3ViTServer(cfg, params)
    for label, kw in (("M3ViTServer(rules=)", {}),
                      ("M3ViTServer(rules=) paged through "
                       "ShardedExpertCache at resident fraction 0.5",
                       {"resident_fraction": 0.5})):
        server = M3ViTServer(cfg, params, rules=rules, **kw)
        for task in MV.TASKS:
            want = plain.infer(imgs, task)
            server.infer(imgs, task)                  # warm-up
            got = _mesh_run(f"{label} {task} batch {BATCH}",
                            lambda: server.infer(imgs, task), total)
            _bit_equal(f"{label} {task} batch {BATCH}", got, want)
        print(f"    walls, semseg batch {BATCH}: "
              f"{_wall_ms(lambda: server.infer(imgs, 'semseg')):.3f} ms "
              f"with the mesh, "
              f"{_wall_ms(lambda: plain.infer(imgs, 'semseg')):.3f} ms "
              f"without (median of {MESH_BATCHES}, host wall)")
        st = server.cache_stats()
        print(f"    shard_load {st['shard_load']} imbalance "
              f"{st['shard_load_imbalance']:.3f}, hit_rate "
              f"{st['hit_rate']:.3f}, resident_fraction "
              f"{st['resident_fraction']:.2f}")
        del server
    mcfg = plain.mcfg
    layer = plain.layer_params[1]["moe"]
    h = randn((BATCH, 128, cfg.d_model), torch.bfloat16, seed=3)
    with use_policy(policy):
        want, aux_w = moe_lib.apply_moe(layer, mcfg, h)
        ep = replace(mcfg, impl="ep_local")
        with use_rules(rules):
            got, aux_g = _mesh_run("apply_moe_ep_local, M3ViT MoE layer",
                                   lambda: moe_lib.apply_moe(layer, ep, h),
                                   total)
    _bit_equal("apply_moe_ep_local against grouped", got, want)
    _bit_equal("apply_moe_ep_local aux against grouped", aux_g, aux_w)


def _mesh_lm(rules, total) -> None:
    from repro_torch import ops
    from repro_torch.configs import llama3_2_1b as LL
    from repro_torch.dist.sharding import use_rules
    from repro_torch.models import model as LM
    from repro_torch.serve.engine import ServeConfig, ServingEngine
    from repro_torch.serve.scheduler import LMBackend, Request, Scheduler

    policy = ops.policy_named("cuda").with_impls(attention_decode="cuda_fused")
    cfg = LL.CONFIG
    params = LM.init_params(0, cfg, draw_on_device=True)
    scfg = ServeConfig(max_len=LM_MAX_LEN, policy=policy)
    plain = ServingEngine(cfg, params, scfg)
    mesh = ServingEngine(cfg, params, scfg, rules=rules)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(LM_BATCH, LM_PROMPT))).cuda()
    want = plain.generate(prompts, LM_NEW)
    mesh.generate(prompts, 2)                         # warm-up
    got = _mesh_run(f"Llama-3.2-1B ServingEngine(rules=) {LM_BATCH} x "
                    f"{LM_PROMPT} prompts, {LM_NEW} greedy tokens",
                    lambda: mesh.generate(prompts, LM_NEW), total)
    _bit_equal("Llama-3.2-1B engine tokens", got, want)
    print(f"    walls, generate: "
          f"{_wall_ms(lambda: mesh.generate(prompts, LM_NEW)):.1f} ms with "
          f"the mesh, "
          f"{_wall_ms(lambda: plain.generate(prompts, LM_NEW)):.1f} ms "
          f"without (median of {MESH_BATCHES}, host wall)")

    def prefill(engine, r):
        with torch.inference_mode(), use_rules(r):
            state = LM.init_state(engine.cfg, LM_BATCH, LM_MAX_LEN,
                                  device="cuda")
            return engine.steps(0)[0](engine.params, prompts, state)[0]

    _bit_equal("Llama-3.2-1B prefill logits", prefill(mesh, rules),
               prefill(plain, None))
    del mesh, plain

    rng = np.random.default_rng(1)
    lens = rng.integers(16, LM_PROMPT + 1, LM_BATCH)
    reqs = [(rng.integers(0, cfg.vocab_size, int(n)), int(k)) for n, k in
            zip(lens, rng.integers(8, LM_NEW + 1, LM_BATCH))]

    def serve(r):
        sched = Scheduler(LMBackend(cfg, params, scfg, rules=r),
                          total_slots=LM_BATCH, quantum=4, num_tasks=1)
        done = sched.run([Request(rid=i, task_id=0, prompt=p,
                                  max_new_tokens=k)
                          for i, (p, k) in enumerate(reqs)])
        return sched, {q.rid: list(q.tokens) for q in done}

    _, want = serve(None)
    sched, got = _mesh_run(f"Llama-3.2-1B Scheduler(rules=) {LM_BATCH} "
                           f"requests in {LM_BATCH} slots",
                           lambda: serve(rules), total)
    same = got == want
    print(f"  Scheduler(rules=) tokens of every request bit-equal to no "
          f"mesh: {same}")
    if not same:
        raise AssertionError("Scheduler(rules=) differs from no mesh")


def _mesh_tiles() -> None:
    """The tile table has no ``cuda`` knob (the GEMM planners pick each
    launch's tile): a ``with_tiles`` override of ``linear.cuda`` raises
    on the card, never silently ignored."""
    from repro_torch import ops

    x = randn((TOKENS, 192), torch.bfloat16, seed=4)
    w = randn((192, 768), torch.bfloat16, scale=192 ** -0.5, seed=5)
    for tile in (dict(tokens=64, warpgroups=1), dict(tokens=48)):
        pol = ops.policy_named("cuda").with_tiles("linear", **tile)
        try:
            with ops.use_policy(pol):
                ops.dispatch("linear", x, w)
        except ValueError as e:
            print(f"  with_tiles linear.cuda {tile} raises: {e}")
        else:
            raise AssertionError(f"a linear.cuda tile override ran: {tile}")


def _two_ranks(rank: int, store: str, out: str) -> None:
    """One of phase 10 (b)'s and phase 11 (b)'s two ranks on the one
    card (phase 11's work after phase 10's: ``_two_ranks_train``).  First
    the probe: gloo starts and all-reduces a CUDA tensor.  Then, counted
    and checked for fallbacks:
    ``apply_moe_ep_local`` at M³ViT's width with 8 of its 16 experts a
    rank against single-device ``grouped`` (the bf16 tolerance); a
    grouped MoE on this rank's half of a data-split batch, with M³ViT's
    128-token groups and with one group over the whole batch, against the
    layer on the whole batch, bit for bit; Llama-3.2-1B,
    RecurrentGemma-9B (its RG-LRU mixers split) and xLSTM-350M (its mLSTM
    and sLSTM heads split) tensor-parallel over (1, 2) (``_tp_serve``
    for each of ``_tp_serving``'s runs); and parking over a bucket split
    over (2, 1) (``_two_ranks_park``)."""
    import time
    import traceback

    import torch.distributed as dist

    from repro_torch import ops
    from repro_torch.configs import m3vit as MV
    from repro_torch.core import moe as moe_lib
    from repro_torch.dist import spmd
    from repro_torch.dist.sharding import ShardingRules, use_rules
    from repro_torch.kernels.compare import max_abs_err, within_tolerance
    from repro_torch.models.transformer import moe_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    result = {"rank": rank}
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=2, rank=rank)
        probe = torch.full((4,), rank + 1.0, device="cuda")
        dist.all_reduce(probe)
        if probe.tolist() != [3.0] * 4:
            raise RuntimeError(f"gloo all-reduce of a CUDA tensor gave "
                               f"{probe.tolist()}")
    except Exception as e:          # (b) is left out, with this text
        result["probe_error"] = f"{type(e).__name__}: {e}"
        Path(out).write_text(json.dumps(result))
        return
    try:
        total: dict = {}
        mcfg = moe_config(MV.CONFIG)
        layer = moe_lib.init_moe(np.random.default_rng(0), mcfg)
        layer = {k: v.cuda() for k, v in layer.items()}
        h = randn((BATCH, 128, MV.CONFIG.d_model), torch.bfloat16, seed=3)
        with ops.use_policy(ops.policy_named("cuda")):
            want, _ = moe_lib.apply_moe(layer, mcfg, h)
            ep = replace(mcfg, impl="ep_local")
            with use_rules(ShardingRules.for_mesh(
                    spmd.init_mesh((1, 2)), fsdp=False)):
                got, _ = _mesh_run(f"(b) rank {rank} apply_moe_ep_local",
                                   lambda: moe_lib.apply_moe(layer, ep, h),
                                   total)
            result["max_abs_err"] = max_abs_err(got, want)
            result["within"] = bool(within_tolerance(got, want,
                                                     torch.bfloat16))
            result["launches"] = dict(total)
            rules = ShardingRules.for_mesh(spmd.init_mesh((2, 1)),
                                           fsdp=False)
            rows = spmd.batch_rows(BATCH, rules)
            result["split"] = {}
        # the staged expert layer by name (``cuda`` names no moe_ffn impl):
        # its grouped GEMMs are the moe_gemm kernel
        staged = ops.policy_named("cuda").with_impls(moe_ffn="eager")
        with ops.use_policy(staged):
            for group in (mcfg.group_size, BATCH * 128):
                cfg = replace(mcfg, group_size=group)
                whole = moe_lib.apply_moe(layer, cfg, h, return_stats=True)

                def split():
                    with spmd.batch_split(rules, BATCH):
                        return moe_lib.apply_moe(layer, cfg, h[rows],
                                                 return_stats=True)

                counted: dict = {}
                part = _mesh_run(f"(b) rank {rank} grouped MoE on a data "
                                 f"split, group {group}", split, counted)
                result["split"][group] = bool(counted.get("moe_gemm")) and \
                    all(torch.equal(a, b) for a, b in (
                        (part[0], whole[0][rows]), (part[1], whole[1]),
                        (part[2], whole[2])))
        del layer, h, want, got
        gc.collect()
        torch.cuda.empty_cache()
        result["tp"] = [_tp_serve(rank, run) for run in _tp_serving()]
        result["fsdp"] = _fsdp_serve(rank)
        result["park"] = _two_ranks_park(rank)
        gc.collect()
        torch.cuda.empty_cache()
        t_train = time.perf_counter()
        result["train"] = _two_ranks_train(rank, str(MESH_TRAIN_DIR))
        result["train_wall_s"] = time.perf_counter() - t_train
        dist.barrier()
        dist.destroy_process_group()
    except Exception:               # a fault: the parent raises with it
        result["error"] = traceback.format_exc()
    Path(out).write_text(json.dumps(result))


#: phase 10 (b)'s tensor-parallel Llama-3.2-1B: teacher-forced decode
#: steps held to the serving cosine, and the projections whose column and
#: row blocks phase 10 (b) holds against the whole product
TP_FORCED_STEPS = 8
TP_PROJECTIONS = (("wq", 2048, 2048), ("wk", 2048, 512),
                  ("wg", 2048, 8192), ("wo", 2048, 2048),
                  ("wd", 8192, 2048))


def _tp_kernels(rank: int) -> dict:
    """Phase 10 (b), rank 0: the three kernels of the tensor-parallel
    path on Llama-3.2-1B's shapes at (1, 2), each against its plain
    version — ``unified_linear``'s column blocks (N/2, summed in the whole
    weight's order) bit-equal to the whole product's columns and its row
    blocks (K/2, float32 out) within the float32 tolerance, at a decode
    step's 8 rows and a prefill's 1024; ``flash_attention`` at 16 of the
    32 q heads over 4 of the 8 KV heads; ``decode_fused`` at 4 KV heads
    with per-slot lengths.  Returns the largest error per kernel."""
    from repro_torch.kernels import decode_fused as kdf
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import unified_linear as kul

    errs = {"unified_linear": 0.0, "flash_attention": 0.0,
            "decode_fused": 0.0}
    for m in (LM_BATCH, TOKENS):
        for name, k, n in TP_PROJECTIONS:
            x = randn((m, k), torch.bfloat16, seed=71)
            w = randn((k, n), torch.bfloat16, scale=k ** -0.5, seed=72)
            whole = kul.unified_linear(x, w)
            h = n // 2
            for r in range(2):
                cols = kul.unified_linear(
                    x, w[:, r * h:(r + 1) * h].contiguous(), order_n=n)
                check_exact("unified_linear", f"(b) rank {rank} {name} "
                            f"column block {r} M={m} ({k}x{h} of {n})",
                            cols, whole[:, r * h:(r + 1) * h])
            kk = k // 2
            xr, wr = x[:, :kk].contiguous(), w[:kk].contiguous()
            part = kul.unified_linear(xr, wr, out_dtype=torch.float32)
            errs["unified_linear"] = max(errs["unified_linear"], check(
                "unified_linear", f"(b) rank {rank} {name} row block M={m} "
                f"({kk}x{n}, float32 out)", part,
                kul.unified_linear_plain(xr, wr, out_dtype=torch.float32),
                torch.float32))
    q = randn((LM_BATCH, 16, LM_PROMPT, 64), torch.bfloat16, seed=73)
    k = randn((LM_BATCH, 4, LM_PROMPT, 64), torch.bfloat16, seed=74)
    v = randn((LM_BATCH, 4, LM_PROMPT, 64), torch.bfloat16, seed=75)
    errs["flash_attention"] = check(
        "flash_attention", f"(b) rank {rank} 16 q heads over 4 KV heads, "
        f"causal", kfa.flash_attention(q, k, v),
        kfa.flash_attention_plain(q, k, v), torch.bfloat16)
    q = randn((LM_BATCH, 16, 1, 64), torch.bfloat16, seed=76)
    kc = randn((LM_BATCH, 4, LM_MAX_LEN, 64), torch.bfloat16, seed=77)
    vc = randn((LM_BATCH, 4, LM_MAX_LEN, 64), torch.bfloat16, seed=78)
    cl = torch.tensor([129, 130, 131, 132, 133, 140, 150, 160],
                      dtype=torch.int32, device="cuda")
    errs["decode_fused"] = check(
        "decode_fused", f"(b) rank {rank} 16 q heads over 4 KV heads, "
        f"per-slot lengths", kdf.fused_decode_attention(q, kc, vc, cl),
        kdf.fused_decode_attention_plain(q, kc, vc, cl), torch.bfloat16)
    return errs


#: phase 10 (b)'s and 11 (b)'s tensor-parallel RecurrentGemma-9B: full
#: width, one Griffin period deep (two RG-LRU blocks and one
#: local-attention block)
TP_RG_LAYERS = 3


def _rg_config(**over):
    """RecurrentGemma-9B at full width and ``TP_RG_LAYERS`` deep."""
    from repro_torch.configs import recurrentgemma_9b as RG

    return replace(RG.CONFIG, num_layers=TP_RG_LAYERS, **over)


def _tp_rg_kernels(rank: int, policy) -> dict:
    """Phase 10 (b), rank 0: the kernels of RecurrentGemma-9B's
    tensor-parallel serving at one rank's shapes over (1, 2), each against
    its plain version — ``unified_linear``'s column blocks of the RG-LRU's
    ``w_up`` and ``w_up2`` (with its GELU epilogue, the LUT where
    ``policy`` takes it), of the MLP's ``wg`` (GELU) and ``wu`` and of
    ``wq`` (N/2, summed in the whole weight's order) bit-equal to the
    whole product's columns, and their whole products against the plain
    version; the row blocks of ``w_down``, ``wd`` and ``wo`` (K/2, float32
    out) within the float32 tolerance; at a decode step's 8 rows and a
    prefill's 1024; ``flash_attention`` at 8 of the 16 q heads over the
    one KV head (MQA), head_dim 256, causal; ``decode_fused`` at those
    heads over the local attention's ring with per-slot lengths.  Returns
    the largest error per kernel."""
    from repro_torch.kernels import decode_fused as kdf
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import unified_linear as kul

    cfg = _rg_config()
    d, w, f = cfg.d_model, cfg.lru_width, cfg.d_ff
    geo = dict(step_log2=policy.lut_step_log2, lut_range=policy.lut_range)
    errs = {"unified_linear": 0.0, "flash_attention": 0.0,
            "decode_fused": 0.0}

    def held(name, label, got, want, dtype, **kw):
        errs[name] = max(errs[name], check(
            name, f"(b) rank {rank} RecurrentGemma-9B {label}", got, want,
            dtype, **kw))

    columns = (("rglru w_up", d, w, None), ("rglru w_up2", d, w, "gelu"),
               ("mlp wg", d, f, "gelu"), ("mlp wu", d, f, None),
               ("attn wq", d, cfg.num_heads * cfg.hd, None))
    rows = (("rglru w_down", w, d), ("mlp wd", f, d),
            ("attn wo", cfg.num_heads * cfg.hd, d))
    for m in (LM_BATCH, TOKENS):
        x = randn((m, d), torch.bfloat16, seed=81)
        for name, k, n, act in columns:
            wt = randn((k, n), torch.bfloat16, scale=k ** -0.5, seed=82)
            lut = bool(policy.lut_activations and act is not None)
            kw = dict(activation=act, use_lut=lut, **geo)
            whole = kul.unified_linear(x, wt, **kw)
            pre = kul.unified_linear_plain(x.float(), wt.float()) \
                if lut else None
            held("unified_linear", f"{name} whole M={m} ({k}x{n}, "
                 f"{act or 'none'}{'-lut' if lut else ''})", whole,
                 kul.unified_linear_plain(x, wt, **kw), torch.bfloat16,
                 lut_pre=pre, kind=act or "gelu", **geo)
            h = n // 2
            for r in range(2):
                cols = slice(r * h, (r + 1) * h)
                check_exact("unified_linear", f"(b) rank {rank} "
                            f"RecurrentGemma-9B {name} column block {r} "
                            f"M={m} ({k}x{h} of {n})",
                            kul.unified_linear(x, wt[:, cols].contiguous(),
                                               order_n=n, **kw),
                            whole[:, cols])
        for name, k, n in rows:
            kk = k // 2
            xr = randn((m, kk), torch.bfloat16, seed=83)
            wr = randn((kk, n), torch.bfloat16, scale=k ** -0.5, seed=84)
            f32 = dict(out_dtype=torch.float32)
            held("unified_linear", f"{name} row block M={m} ({kk}x{n}, "
                 f"float32 out)", kul.unified_linear(xr, wr, **f32),
                 kul.unified_linear_plain(xr, wr, **f32), torch.float32)
    hq, hd = cfg.num_heads // 2, cfg.hd
    q = randn((LM_BATCH, hq, LM_PROMPT, hd), torch.bfloat16, seed=85)
    k = randn((LM_BATCH, 1, LM_PROMPT, hd), torch.bfloat16, seed=86)
    v = randn((LM_BATCH, 1, LM_PROMPT, hd), torch.bfloat16, seed=87)
    held("flash_attention", f"{hq} q heads over 1 KV head, D={hd}, "
         f"causal", kfa.flash_attention(q, k, v),
         kfa.flash_attention_plain(q, k, v), torch.bfloat16)
    q = randn((LM_BATCH, hq, 1, hd), torch.bfloat16, seed=88)
    kc = randn((LM_BATCH, 1, LM_MAX_LEN, hd), torch.bfloat16, seed=89)
    vc = randn((LM_BATCH, 1, LM_MAX_LEN, hd), torch.bfloat16, seed=90)
    cl = torch.tensor([129, 130, 131, 132, 133, 140, 150, 160],
                      dtype=torch.int32, device="cuda")
    held("decode_fused", f"{hq} q heads over 1 KV head, D={hd}, per-slot "
         f"lengths", kdf.fused_decode_attention(q, kc, vc, cl),
         kdf.fused_decode_attention_plain(q, kc, vc, cl), torch.bfloat16)
    return errs


#: phase 10 (b)'s and 11 (b)'s tensor-parallel xLSTM-350M: full width,
#: one period deep (7 mLSTM blocks and 1 sLSTM); phase 10 (b) serves
#: XL_BATCH prompts of XL_PROMPT tokens and XL_NEW greedy tokens, phase
#: 11 (b) trains on XL_TRAIN_BATCH rows of XL_PROMPT tokens
TP_XL_LAYERS = 8
XL_BATCH, XL_PROMPT, XL_NEW, XL_TRAIN_BATCH = 4, 64, 16, 2


def _xl_config(**over):
    """xLSTM-350M at full width and ``TP_XL_LAYERS`` deep."""
    from repro_torch.configs import xlstm_350m as XL

    return replace(XL.CONFIG, num_layers=TP_XL_LAYERS, **over)


def _tp_xl_kernels(rank: int) -> dict:
    """Phase 10 (b), rank 0: ``unified_linear`` at xLSTM-350M's rank
    shapes over (1, 2), against its plain version: the column blocks of
    the mLSTM's ``w_up``, ``w_gates`` (1024 of 2048 columns) and
    ``w_qkv`` (3072 of 6144: the table's contiguous block), summed in the
    whole weight's order, bit-equal to the whole product's columns, and
    the whole products within the bf16 tolerance; the row block of
    ``w_down`` (1024 of 2048 rows, float32 out) within the float32
    tolerance; at phase 10 (b)'s decode step (``XL_BATCH`` rows: a ragged
    tile) and prefill (``XL_BATCH`` x ``XL_PROMPT``).  Phase 11 (b)'s
    training shapes are ``TP_TRAIN_SHAPES``'.  Returns the largest
    error."""
    from repro_torch.kernels import unified_linear as kul

    cfg = _xl_config()
    d = cfg.d_model
    di = 2 * d
    err = 0.0
    label = f"(b) rank {rank} xLSTM-350M"
    for m in (XL_BATCH, XL_BATCH * XL_PROMPT):
        x = randn((m, d), torch.bfloat16, seed=101)
        xu = randn((m, di), torch.bfloat16, seed=102)
        for name, xin, k, n in (("mlstm w_up", x, d, di),
                                ("mlstm w_gates", x, d, di),
                                ("mlstm w_qkv", xu, di, 3 * di)):
            wt = randn((k, n), torch.bfloat16, scale=k ** -0.5, seed=103)
            whole = kul.unified_linear(xin, wt)
            err = max(err, check("unified_linear", f"{label} {name} whole "
                                 f"M={m} ({k}x{n})", whole,
                                 kul.unified_linear_plain(xin, wt),
                                 torch.bfloat16))
            h = n // 2
            for r in range(2):
                cols = slice(r * h, (r + 1) * h)
                check_exact("unified_linear", f"{label} {name} column block "
                            f"{r} M={m} ({k}x{h} of {n})",
                            kul.unified_linear(xin, wt[:, cols].contiguous(),
                                               order_n=n), whole[:, cols])
        xr = randn((m, di // 2), torch.bfloat16, seed=104)
        wr = randn((di // 2, d), torch.bfloat16, scale=di ** -0.5, seed=105)
        f32 = dict(out_dtype=torch.float32)
        err = max(err, check("unified_linear", f"{label} mlstm w_down row "
                             f"block M={m} ({di // 2}x{d}, float32 out)",
                             kul.unified_linear(xr, wr, **f32),
                             kul.unified_linear_plain(xr, wr, **f32),
                             torch.float32))
    return {"unified_linear": err}


def _forced(engine, rules, prompts, toks, steps: int) -> list:
    """The logits of ``engine``'s prefill of ``prompts`` and of ``steps``
    decode steps teacher-forced on ``toks`` (numpy, a column a step),
    under ``rules`` (None: no mesh)."""
    from repro_torch.dist.sharding import use_rules

    prefill, decode = engine.steps(0)
    logits = []
    with torch.inference_mode(), use_rules(rules):
        state = engine.new_state(prompts.shape[0])
        lg, state = prefill(engine.params, prompts, state)
        logits.append(lg)
        for i in range(steps):
            tok = torch.from_numpy(toks[:, i:i + 1]).long().cuda()
            lg, state = decode(engine.params, tok, state,
                               prompts.shape[1] + i)
            logits.append(lg)
    return logits


def _held_bytes(mine: dict, whole: dict, parts=("",)) -> list:
    """Of the leaves whose names hold one of ``parts``: the bytes this
    rank holds, the whole model's, and those of the leaves it holds
    whole.  Every other leaf is cut in half over (1, 2) exactly where
    2 × held == whole + kept."""
    def nbytes(keys, tree):
        return sum(tree[k].numel() * tree[k].element_size() for k in keys)

    keys = [k for k in whole if any(p in k for p in parts)]
    return [nbytes(keys, mine), nbytes(keys, whole),
            nbytes([k for k in keys if mine[k].shape == whole[k].shape],
                   mine)]


def _tp_serving() -> list:
    """Phase 10 (b)'s tensor-parallel serving runs over (1, 2), each a
    model at full width: its label, config, prompts (batch, length),
    greedy tokens and ``max_len``, policy, the kernels rank 0 first holds
    at its shapes, the kernels its path must launch, the parts whose
    bytes a rank are reported (each with whether every leaf of it
    splits), and the
    float32 yardstick its logits fall back on where bf16 noise alone
    exceeds SERVE_COSINE (None: SERVE_COSINE holds)."""
    from repro_torch import ops
    from repro_torch.configs import llama3_2_1b as LL

    cuda = ops.policy_named("cuda")
    fused = cuda.with_impls(attention_decode="cuda_fused")
    attention = ("unified_linear", "flash_attention", "decode_fused")
    lm = dict(batch=LM_BATCH, prompt=LM_PROMPT, new=LM_NEW,
              max_len=LM_MAX_LEN, policy=fused, launched=attention,
              yardstick=None)
    return [
        dict(lm, label="Llama-3.2-1B", cfg=LL.CONFIG, kernels=_tp_kernels,
             parts={}),
        dict(lm, label=f"RecurrentGemma-9B ({TP_RG_LAYERS} layers)",
             cfg=_rg_config(),
             kernels=lambda rank: _tp_rg_kernels(rank, fused),
             parts={"RG-LRU": ((".rglru.",), True)}),
        dict(label=f"xLSTM-350M ({TP_XL_LAYERS} layers)", cfg=_xl_config(),
             batch=XL_BATCH, prompt=XL_PROMPT, new=XL_NEW,
             max_len=XL_PROMPT + XL_NEW, policy=cuda,
             launched=("unified_linear",), kernels=_tp_xl_kernels,
             parts={"mixer": ((".mlstm.", ".slstm."), False)},
             yardstick=_float32_replay)]


def _tp_serve(rank: int, run: dict) -> dict:
    """Phase 10 (b), one of ``_tp_serving``'s runs on this rank: first, on
    rank 0, its kernels at the rank's shapes against their plain versions;
    each rank draws its own blocks (held bit for bit to the narrowed whole
    draw), serves the run's prompts and greedy tokens under its policy
    (counted: launches, variants — SIMT only for xLSTM's 1365-wide sLSTM
    projections, exactly their count — collectives by ``where``, no
    fallback), and holds the prefill's and ``TP_FORCED_STEPS``
    teacher-forced steps' logits to the engine with no mesh at
    SERVE_COSINE, or, where the run has a float32 yardstick and its bf16
    noise alone exceeds that, against the same model in float32
    (``compare.serving_agrees``); the bytes a rank of its weights, of the
    run's parts and of its decode state (a sequence) against the whole.
    Returns what ``_tp_serve_report`` gates, with each step's wall."""
    import time

    from repro_torch import ops
    from repro_torch.dist import spmd
    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.kernels.compare import (SERVE_COSINE, cosine,
                                             serving_agrees)
    from repro_torch.models import model as LM
    from repro_torch.serve.engine import (ServeConfig, ServingEngine,
                                          local_params)
    from repro_torch.tree import flatten

    cfg, new = run["cfg"], run["new"]
    walls = {}
    t0 = time.perf_counter()
    out = {"kernel_errs": run["kernels"](rank) if rank == 0 else {}}
    walls["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rules = ShardingRules.for_mesh(spmd.init_mesh((1, 2)), fsdp=False)
    whole = LM.init_params(0, cfg, draw_on_device=True)
    mine = LM.init_params(0, cfg, draw_on_device=True, rules=rules)
    narrowed = local_params(whole, cfg, rules)
    out["draw_equal"] = mine.keys() == narrowed.keys() and all(
        torch.equal(mine[k], narrowed[k]) for k in mine)
    del narrowed
    out["bytes"] = {"weights": _held_bytes(mine, whole)}
    for name, (parts, _) in run["parts"].items():
        out["bytes"][name] = _held_bytes(mine, whole, parts)
    scfg = ServeConfig(max_len=run["max_len"], policy=run["policy"])
    plain = ServingEngine(cfg, whole, scfg)
    tp = ServingEngine(cfg, mine, scfg, rules=rules)
    out["bytes"]["decode state a sequence"] = _held_bytes(
        flatten(tp.new_state(1)), flatten(plain.new_state(1)))
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(run["batch"], run["prompt"]))).cuda()
    want = plain.generate(prompts, new)
    walls["draw and no mesh"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tp.generate(prompts, 2)                            # warm-up
    counted: dict = {}
    label = (f"(b) rank {rank} {run['label']} ServingEngine over (1, 2), "
             f"tensor-parallel, {run['batch']} x {run['prompt']} prompts, "
             f"{new} greedy tokens")
    got = _mesh_run(label, lambda: tp.generate(prompts, new), counted)
    out["launches"] = counted
    out["variants"] = read_variants(label, _slstm_simt(cfg, 1 + new),
                                    tally=False)
    out["collectives"] = [[c["kind"], c["axis"], c["where"], c["count"],
                           c["bytes"]] for c in ops.collective_report()]
    out["tokens_equal"] = float((got == want).mean())
    walls["mesh generate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    steps = min(TP_FORCED_STEPS, new)
    kern = _forced(tp, rules, prompts, want, steps)
    ref = _forced(plain, None, prompts, want, steps)
    cos = [cosine(a, b) for a, b in zip(kern, ref)]
    k32 = p32 = None
    if min(cos) < SERVE_COSINE and run["yardstick"] is not None:
        f32 = run["yardstick"](cfg, whole, prompts, torch.from_numpy(
            want[:, :steps]).long().cuda(), run["max_len"])
        k32 = [cosine(a, b) for a, b in zip(kern, f32)]
        p32 = [cosine(a, b) for a, b in zip(ref, f32)]
        del f32
    out["cosines"], out["cosines_f32"] = cos, [k32, p32]
    out["agrees"] = serving_agrees(cos, k32, p32)
    walls["teacher-forced"] = time.perf_counter() - t0
    out["walls_s"] = walls
    del plain, tp, whole, mine, kern, ref
    gc.collect()
    torch.cuda.empty_cache()
    return out


#: phase 10 (b)'s FSDP run: a rank's weight bytes at rest over (2, 1)
#: against ``fsdp=False``'s (every matrix halved; the norms stay whole)
FSDP_HELD_SHARE = 0.51


def _fsdp_serve(rank: int) -> dict:
    """Phase 10 (b), FSDP of serving's weights on this rank: Llama-3.2-1B
    at full width and ``MESH_LM_LAYERS`` layers over (2, 1) under the
    default rules (``fsdp=True``: ``place_params`` holds each matrix's
    half over data, and the forward gathers a layer's leaves just before
    it runs) against the same mesh under ``fsdp=False``.  The rank draws
    its blocks (``init_params(rules=)``, held bit for bit to
    ``place_params`` of the whole draw); then, after a warm-up, 8 × 128
    prompts and ``TP_FORCED_STEPS`` greedy tokens under ``cuda`` with
    ``cuda_fused`` decode, counted (launches, variants, no fallback),
    with the peak of allocated memory and the wall of each; the prefill's
    logits of this rank's rows and the tokens bit for bit.  Returns what
    ``_fsdp_serve_report`` gates."""
    import time

    from repro_torch import ops
    from repro_torch.configs import llama3_2_1b as LL
    from repro_torch.dist import spmd
    from repro_torch.dist.sharding import (ShardingRules, _axes,
                                           param_sharding_rules, use_rules)
    from repro_torch.models import model as LM
    from repro_torch.serve.engine import (ServeConfig, ServingEngine,
                                          place_params, shard_batch)

    cfg = replace(LL.CONFIG, num_layers=MESH_LM_LAYERS)
    mesh = spmd.init_mesh((2, 1))
    rules = ShardingRules.for_mesh(mesh)
    off = ShardingRules.for_mesh(mesh, fsdp=False)
    whole = LM.init_params(0, cfg, draw_on_device=True)
    mine = LM.init_params(0, cfg, draw_on_device=True, rules=rules)
    placed = place_params(whole, cfg, rules)
    out = {"draw_equal": mine.keys() == placed.keys() and all(
        torch.equal(mine[k], placed[k]) for k in mine)}
    del placed

    def nbytes(params):
        return sum(v.numel() * v.element_size() for v in params.values())

    table = 0
    for name, sh in param_sharding_rules(LM.param_specs(cfg),
                                         rules).items():
        split = 1
        for a in (a for e in sh.spec for a in _axes(e)):
            split *= spmd.axis_size(mesh, a)
        table += nbytes({name: whole[name]}) // split
    policy = ops.policy_named("cuda").with_impls(
        attention_decode="cuda_fused")
    scfg = ServeConfig(max_len=LM_MAX_LEN, policy=policy)
    plain = ServingEngine(cfg, whole, scfg, rules=off)
    fsdp = ServingEngine(cfg, mine, scfg, rules=rules)
    out["bytes"] = {"fsdp": nbytes(fsdp.params),
                    "no_fsdp": nbytes(plain.params), "table": table}
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(LM_BATCH, LM_PROMPT))).cuda()

    def prefill_logits(engine, r):
        prefill, _ = engine.steps(0)
        with torch.inference_mode(), use_rules(r), \
                spmd.batch_split(r, LM_BATCH):
            rows = shard_batch(prompts, r)
            state = engine.new_state(rows.shape[0])
            return prefill(engine.params, rows, state)[0]

    out["logits_equal"] = bool(torch.equal(prefill_logits(fsdp, rules),
                                           prefill_logits(plain, off)))
    runs = {}
    for name, engine in (("no_fsdp", plain), ("fsdp", fsdp)):
        engine.generate(prompts, 1)                    # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counted: dict = {}
        label = (f"(b) rank {rank} Llama-3.2-1B ({MESH_LM_LAYERS} layers) "
                 f"ServingEngine over (2, 1), "
                 f"{'fsdp=True' if name == 'fsdp' else 'fsdp=False'}, "
                 f"{LM_BATCH} x {LM_PROMPT} prompts, {TP_FORCED_STEPS} "
                 f"greedy tokens")
        t0 = time.perf_counter()
        toks = _mesh_run(label, lambda: engine.generate(
            prompts, TP_FORCED_STEPS), counted)
        runs[name] = {
            "wall_s": time.perf_counter() - t0, "tokens": toks,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "launches": counted,
            "variants": read_variants(label, tally=False),
            "collectives": [[c["kind"], c["axis"], c["where"], c["count"],
                             c["bytes"]] for c in ops.collective_report()]}
    out["tokens_equal"] = bool(np.array_equal(runs["fsdp"].pop("tokens"),
                                              runs["no_fsdp"].pop("tokens")))
    out["runs"] = runs
    out["forwards"] = 1 + TP_FORCED_STEPS
    del plain, fsdp, whole, mine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _fsdp_gathers_expect(cfg, forwards: int) -> int:
    """The ``fsdp gather`` all-gathers over data that ``forwards``
    forwards of Llama-3.2-1B make over (2, 1) under ``fsdp=True``, from
    the config: each layer's seven matrices (q, k, v, o; gate, up,
    down), and the tied table twice (the lookup, then the head)."""
    assert cfg.tie_embeddings and cfg.period == 1 and cfg.moe is None
    return forwards * (7 * cfg.num_layers + 2)


def _fsdp_serve_report(rank: int, r: dict, total: dict) -> dict:
    """Print and gate one rank's ``_fsdp_serve`` result (phase 10 (b)):
    the draw, the bytes at rest (the table's blocks exactly, at most
    ``FSDP_HELD_SHARE`` of ``fsdp=False``'s), the logits and tokens bit
    for bit, the ``fsdp gather`` all-gathers over data as counted from
    the config and every other collective as ``fsdp=False``'s, the
    path's kernels launched; returns ``total`` with its counted launches
    added."""
    from repro_torch.configs import llama3_2_1b as LL

    cfg = replace(LL.CONFIG, num_layers=MESH_LM_LAYERS)
    b, gib = r["bytes"], 2**30
    share = b["fsdp"] / b["no_fsdp"]
    runs = r["runs"]
    print(f"  (b) rank {rank} FSDP Llama-3.2-1B ({MESH_LM_LAYERS} layers) "
          f"over (2, 1): weights at rest {b['fsdp'] / gib:.4f} GiB "
          f"(the table's blocks {b['table'] / gib:.4f}) against "
          f"{b['no_fsdp'] / gib:.4f} GiB under fsdp=False, {share:.4f} of "
          f"it; per-rank draw bit-equal to place_params of the whole "
          f"draw: {r['draw_equal']}; prefill logits bit-equal to "
          f"fsdp=False: {r['logits_equal']}; {TP_FORCED_STEPS} greedy "
          f"tokens bit-equal: {r['tokens_equal']}")
    for name, run in runs.items():
        print(f"  (b) rank {rank} {name}: wall {run['wall_s'] * 1e3:.1f} ms "
              f"for {r['forwards']} forwards, max_memory_allocated "
              f"{run['peak_bytes'] / gib:.3f} GiB, launches "
              f"{json.dumps(run['launches'])}, variants "
              f"{json.dumps(run['variants'])}")
    coll = {name: {(k, a, w): (n, nb) for k, a, w, n, nb in run["collectives"]}
            for name, run in runs.items()}
    gathers = {k: v for k, v in coll["fsdp"].items() if k[2] == "fsdp gather"}
    rest = {k: v for k, v in coll["fsdp"].items() if k[2] != "fsdp gather"}
    want = _fsdp_gathers_expect(cfg, r["forwards"])
    for (kind, axis, where), (n, nb) in gathers.items():
        print(f"    collective {kind} over {axis} at {where!r}: {n} "
              f"({nb} bytes; {want} counted from the config)")
    ok_gathers = list(gathers) == [("all_gather", "data", "fsdp gather")] \
        and gathers[("all_gather", "data", "fsdp gather")][0] == want
    ok = (r["draw_equal"] and r["logits_equal"] and r["tokens_equal"]
          and b["fsdp"] == b["table"] and share <= FSDP_HELD_SHARE
          and ok_gathers and rest == coll["no_fsdp"]
          and all(runs["fsdp"]["launches"].get(k) for k in (
              "unified_linear", "flash_attention", "decode_fused")))
    if not ok:
        raise AssertionError(f"(b) rank {rank} FSDP serving: gathers "
                             f"{gathers} (want {want} over data), other "
                             f"collectives {rest} vs {coll['no_fsdp']}, {r}")
    for n, c in runs["fsdp"]["launches"].items():
        total[n] = total.get(n, 0) + c
    return total


def _two_ranks_park(rank: int) -> dict:
    """Phase 10 (b): tiered preemption over a bucket whose 4 lanes are
    split over (2, 1), Llama-3.2-1B at 4 layers of its full width: 6
    batch-tier requests, then 3 interactive arrivals that park them, on a
    tick clock — every request's tokens bit-equal to the same scheduler
    with no mesh, and the lanes that come back on the other rank moved
    over the data axis."""
    from repro_torch import ops
    from repro_torch.configs import llama3_2_1b as LL
    from repro_torch.dist import spmd
    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.models import model as LM
    from repro_torch.serve.engine import ServeConfig
    from repro_torch.serve.scheduler import LMBackend, Request, Scheduler
    from repro_torch.serve.slo import SLOPolicy
    from repro_torch.serve.slo.trace import TickClock

    rules = ShardingRules.for_mesh(spmd.init_mesh((2, 1)), fsdp=False)
    cfg = replace(LL.CONFIG, num_layers=MESH_LM_LAYERS)
    params = LM.init_params(0, cfg, draw_on_device=True)
    policy = ops.policy_named("cuda").with_impls(
        attention_decode="cuda_fused")

    def serve(r):
        rng = np.random.default_rng(4)
        reqs = [Request(rid=i, task_id=0,
                        prompt=rng.integers(0, cfg.vocab_size, 16 + 8 * i),
                        max_new_tokens=24 if i < 6 else 4,
                        arrival=0.0 if i < 6 else 0.05 * (i - 5),
                        tier="batch" if i < 6 else "interactive")
                for i in range(9)]
        sched = Scheduler(LMBackend(cfg, params, ServeConfig(
            max_len=LM_MAX_LEN, policy=policy), rules=r), total_slots=4,
            quantum=2, num_tasks=1, clock=TickClock(),
            slo=SLOPolicy(preemption=True, chunk_interleave=False))
        done = sched.run(reqs)
        return {q.rid: list(q.tokens) for q in done}, sched

    want, _ = serve(None)
    ops.reset_dispatch_report()
    got, sched = serve(rules)
    moved = sum(c["count"] for c in ops.collective_report()
                if c["where"] == "parked lane move")
    m = sched.metrics()
    return {"equal": got == want, "preemptions": m["preemptions"],
            "restores": m["restores"], "moved": moved}


def two_ranks_one_card() -> tuple[dict, dict, dict]:
    """Phases 10 (b) and 11 (b): two processes on the one card over gloo
    (NCCL refuses two ranks on one device).  A failed probe (gloo cannot
    start or cannot all-reduce a CUDA tensor), a fault after it, a rank
    that hangs or dies, or a missing result fails the run.  Returns phase
    11 (b)'s launches, phase 10 (b)'s tensor-parallel ones and phase 11
    (b)'s tensor-parallel ones, each with both ranks summed."""
    import shutil
    import time

    import torch.multiprocessing as mp

    shutil.rmtree(MESH_STORE, ignore_errors=True)
    MESH_STORE.mkdir(parents=True)
    shutil.rmtree(MESH_TRAIN_DIR, ignore_errors=True)
    MESH_TRAIN_DIR.mkdir(parents=True)
    outs = [MESH_STORE / f"rank{r}.json" for r in range(2)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_two_ranks,
                         args=(r, str(MESH_STORE / "store"), str(outs[r])))
             for r in range(2)]
    print(f"  (b) before the ranks start: "
          f"{torch.cuda.mem_get_info()[0] / 2**30:.2f} GiB of the card "
          f"free, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved "
          f"by this process")
    # the ranks' allocators grow segments in place: RecurrentGemma-9B's
    # one-process training step (56 GiB at its peak) otherwise leaves GiBs
    # reserved between its 4 GiB temporaries, with two more processes on
    # the card
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        for p in procs:
            p.start()
    finally:
        if alloc is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    hung = []
    for r, p in enumerate(procs):
        p.join(timeout=600)
        if p.is_alive():
            hung.append(r)
            p.kill()
            p.join()
    results = [json.loads(o.read_text()) if o.exists() else None
               for o in outs]
    shutil.rmtree(MESH_STORE, ignore_errors=True)
    if hung or any(r is None for r in results):
        raise AssertionError(f"(b): rank(s) {hung} hung, results {results}, "
                             f"exit codes {[p.exitcode for p in procs]}")
    probe = [r["probe_error"] for r in results if "probe_error" in r]
    if probe:
        # (b) carries the tensor-parallel checks: it is never left out
        raise AssertionError(f"(b) two ranks on the one card over gloo: the "
                             f"probe failed: {probe[0]}")
    faults = [f"(b) rank {r['rank']}: {r['error']}" for r in results
              if "error" in r]
    if faults:
        raise AssertionError("\n".join(faults))
    for r in results:
        print(f"  (b) rank {r['rank']}: gloo all-reduces CUDA tensors; "
              f"apply_moe_ep_local at M3ViT width, 8 of 16 experts a rank, "
              f"against single-device grouped: max abs err "
              f"{r['max_abs_err']:.3e}, within the bf16 tolerance "
              f"{r['within']}; launches {json.dumps(r['launches'])}")
        for group, same in r["split"].items():
            print(f"  (b) rank {r['rank']}: grouped MoE on its half of a "
                  f"data-split batch, group {group}, on moe_gemm: bit-equal "
                  f"to the whole batch: {same}")
        if not r["within"] or not r["launches"].get("moe_gemm") \
                or not all(r["split"].values()):
            raise AssertionError(f"(b) rank {r['rank']}: {r}")
    tp_launches = {}
    for r in results:
        for run, got in zip(_tp_serving(), r["tp"]):
            tp_launches = _tp_serve_report(r["rank"], run, got, tp_launches)
        tp_launches = _fsdp_serve_report(r["rank"], r["fsdp"], tp_launches)
        _park_report(r["rank"], r["park"])
    print("phase 11 (b): training over two ranks on the one card")
    t_parent = time.perf_counter()
    launches, tp_train = mesh_train_two(results)
    print(f"  phase 11 (b) wall time: "
          f"{max(r['train_wall_s'] for r in results):.1f} s on the ranks "
          f"+ {time.perf_counter() - t_parent:.1f} s of the parent's "
          f"checks and restore")
    shutil.rmtree(MESH_TRAIN_DIR, ignore_errors=True)
    return launches, tp_launches, tp_train


def _tp_serve_report(rank: int, run: dict, r: dict, total: dict) -> dict:
    """Print and gate one rank's result of one of ``_tp_serving``'s runs
    (phase 10 (b)): the draw, each part's bytes a rank (every narrowed
    leaf exactly half), the logits, the collectives over ``model`` as
    counted from the config (``_tp_serve_expect``) and nothing else over
    ``model``, and the path's kernels launched; returns ``total`` with its
    counted launches added."""
    cfg, forwards, name = run["cfg"], 1 + run["new"], run["label"]
    whole_split = {"weights": False, "decode state a sequence": False} | {
        part: every for part, (_, every) in run["parts"].items()}
    mib = 2**20
    sizes, halves = [], True
    for part, (held, whole, kept) in r["bytes"].items():
        sizes.append(f"{part} {held / mib:.2f} of {whole / mib:.2f} MiB "
                     f"(half of the split {(whole - kept) / mib:.2f} plus "
                     f"the whole {kept / mib:.2f})")
        halves &= 2 * held == whole + kept and kept < whole and not (
            whole_split[part] and kept)
    walls = r["walls_s"]
    print(f"  (b) rank {rank} tensor-parallel {name} over (1, 2): "
          + "; ".join(sizes) + f"; per-rank draw bit-equal to the narrowed "
          f"whole draw: {r['draw_equal']}; {sum(walls.values()):.1f} s on "
          f"the rank (" + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
          + " s)")
    if r["kernel_errs"]:
        print(f"  (b) rank {rank}: kernels at {name}'s TP shapes against "
              f"their plain versions (column blocks bit-equal), max abs err "
              f"{json.dumps(r['kernel_errs'])}")
    cos, (k32, p32) = r["cosines"], r["cosines_f32"]
    print(f"  (b) rank {rank}: {name} logits of the prefill and "
          f"{min(TP_FORCED_STEPS, run['new'])} teacher-forced steps at "
          f"cosine {min(cos):.6f}..{max(cos):.6f} of no mesh"
          + (f"; against float32: the mesh {min(k32):.6f}, no mesh "
             f"{min(p32):.6f} at their worst" if k32 else "")
          + f" (SERVE_COSINE"
          + (", or serving_agrees against float32" if run["yardstick"]
             else "")
          + f"): {r['agrees']}; greedy tokens equal to no mesh's: "
          f"{r['tokens_equal']:.4f} of them")
    where = {}
    for kind, axis, at, count, nbytes in r["collectives"]:
        where[f"{kind}:{axis}:{at}"] = count
        print(f"    collective {kind} over {axis} at {at!r}: {count} "
              f"({nbytes} bytes)")
    expect = _tp_serve_expect(cfg, forwards)
    keys = set(expect) | {k for k in where if k.split(":")[1] == "model"}
    bad = {k: (where.get(k, 0), expect.get(k, 0)) for k in keys
           if where.get(k, 0) != expect.get(k, 0)}
    counted = ", ".join(f"{k.split(':')[2]} {v}" for k, v in expect.items())
    print(f"  (b) rank {rank}: the collectives over model as counted from "
          f"the config over {forwards} forwards ({counted}), nothing else "
          f"over model: {'ok' if not bad else bad}")
    if bad or not r["draw_equal"] or not r["agrees"] or not halves \
            or not all(r["launches"].get(k) for k in run["launched"]):
        raise AssertionError(f"(b) rank {rank} {name} tensor parallel: "
                             f"collectives off {bad}, halves {halves}, {r}")
    for n, c in r["launches"].items():
        total[n] = total.get(n, 0) + c
    return total


def _park_report(rank: int, park: dict) -> None:
    """Print and gate one rank's parking result of phase 10 (b)."""
    print(f"  (b) rank {rank} parking over a bucket split over (2, 1): "
          f"{park['preemptions']} preemptions, {park['restores']} restores, "
          f"the parked rows moved between the ranks in {park['moved']} "
          f"all-gathers; every request's "
          f"tokens bit-equal to no mesh: {park['equal']}")
    if not park["equal"] or not park["preemptions"] or not park["restores"]:
        raise AssertionError(f"(b) rank {rank} parking: {park}")


def mesh_path() -> dict:
    """Phase 10 (a): mesh serving on the card at a world of one (NCCL, a
    (1, 1) ``DeviceMesh``), each check bit for bit against the same run
    with no mesh (the group is started here where none runs; phase 10
    (b), two ranks over gloo, is ``two_ranks_one_card``).  Returns the
    counted launches of (a)'s mesh runs."""
    import time

    import torch.distributed as dist

    from repro_torch import ops
    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.dist.spmd import init_mesh

    t_phase = time.perf_counter()
    torch.cuda.set_device(0)        # the mesh's device, before NCCL starts
    started = not dist.is_initialized()
    if started:
        dist.init_process_group("nccl", store=dist.HashStore(),
                                world_size=1, rank=0)
    total: dict = {}
    try:
        rules = ShardingRules.for_mesh(init_mesh((1, 1)), fsdp=False)
        print("  (a) a world of one: NCCL, DeviceMesh (1, 1) "
              "('data', 'model') on cuda")
        _mesh_vision(rules, ops.policy_named("cuda"), total)
        gc.collect()
        torch.cuda.empty_cache()
        _mesh_lm(rules, total)
        gc.collect()
        torch.cuda.empty_cache()
        _mesh_tiles()
    finally:
        if started:
            dist.destroy_process_group()
    mesh_kernels = ("unified_linear", "flash_attention", "gelu_lut",
                    "moe_gemm", "decode_fused")
    print(f"  (a) launches over the mesh runs: {json.dumps(total)}")
    if not all(total.get(k, 0) > 0 for k in mesh_kernels):
        raise AssertionError(f"a kernel of the mesh paths never launched: "
                             f"{total}")
    print(f"  phase 10 (a) wall time {time.perf_counter() - t_phase:.1f} s")
    return total


def mesh_phases() -> tuple[dict, dict, dict, dict]:
    """Phases 10 and 11 on the card: one NCCL world of one for 10 (a) and
    11 (a), then two ranks for 10 (b) and 11 (b).  Returns phase 10's
    launches ((a) and (b)'s tensor-parallel run), phase 11's (both parts)
    and the tensor-parallel ones alone of phase 10 (b) and of phase 11
    (b), the ranks' summed."""
    import time

    import torch.distributed as dist

    torch.cuda.set_device(0)        # the mesh's device, before NCCL starts
    started = not dist.is_initialized()
    if started:
        dist.init_process_group("nccl", store=dist.HashStore(),
                                world_size=1, rank=0)
    trained: dict = {}
    try:
        print("phase 10: mesh serving — a world of one, two ranks on the "
              "card")
        meshed = mesh_path()
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        print("phase 11: training over a mesh — (a) a world of one (phase "
              "10's NCCL group)")
        mesh_train_one(trained)
        print(f"  phase 11 (a) wall time {time.perf_counter() - t0:.1f} s")
    finally:
        if started:
            dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    two_trained, tp, tp_train = two_ranks_one_card()
    for n, c in two_trained.items():
        trained[n] = trained.get(n, 0) + c
    print(f"  phases 10 (b) and 11 (b) wall time "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"  phase 10 (b) tensor-parallel launches, both ranks: "
          f"{json.dumps(tp)}")
    for n, c in tp.items():
        meshed[n] = meshed.get(n, 0) + c
    print(f"  phase 11 launches (a) + (b): {json.dumps(trained)}")
    print(f"  phase 11 (b) tensor-parallel launches, both ranks: "
          f"{json.dumps(tp_train)}")
    if not all(trained.get(k, 0) > 0 for k in CUDA_PATH_KERNELS):
        raise AssertionError(f"a kernel of mesh training never launched: "
                             f"{trained}")
    if not all(tp_train.get(k, 0) > 0 for k in CUDA_PATH_KERNELS):
        raise AssertionError(f"a kernel of tensor-parallel training never "
                             f"launched: {tp_train}")
    return meshed, trained, tp, tp_train


# ------------------------------------------------------------ phase 11

#: phase 11's AdamW for the runs held to a tolerance: eps = 1 makes a
#: step proportional to the gradient, so the mesh's other bf16 sums move
#: a parameter by a fraction of its ulp — at eps 1e-8 Adam's first step
#: is the gradient's sign, and a near-zero element whose sign two sum
#: orders disagree on moves by 2·lr
MESH_OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10, eps=1.0,
                weight_decay=0.0)
MESH_LM_LAYERS = 4          # (b)'s Llama: two full-depth ranks do not fit
MESH_TRAIN_DIR = ROOT / "build" / "mesh_train"
#: the launcher's run on each of (b)'s ranks, and the parent's after it
MESH_LAUNCH = ["--arch", "llama3_2_1b", "--smoke", "--policy", "cuda",
               "--batch", "8", "--seq-len", "64", "--warmup", "1",
               "--lr", "1e-3"]


def _staged(policy):
    """``policy`` with M³ViT's expert layer staged by name: ``cuda`` names
    no ``moe_ffn`` impl (the fused one refuses gradients), and the staged
    layer's grouped GEMMs are the ``moe_gemm`` kernel."""
    return policy.with_impls(moe_ffn="eager")


def _host_tree(tree) -> dict:
    from repro_torch.tree import flatten

    return {k: v.detach().cpu() for k, v in flatten(tree).items()}


def _world_of_one_train(label, cfg, tcfg, params, batches, total,
                        loss_fn=None):
    """``make_train_step`` with no rules, then under ``for_mesh((1, 1))``
    rules (fsdp=True) at the world of one, each counted: every loss, the
    parameters and the AdamW state bit for bit.  Returns the meshed step,
    its last parameters and the rules."""
    from repro_torch.data import device_transform, shard_for
    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.dist.spmd import init_mesh
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_step
    from repro_torch.tree import flatten

    rules = ShardingRules.for_mesh(init_mesh((1, 1)))
    put = device_transform("cuda")

    def run(step, p, o, place):
        losses = []
        for b in batches:
            p, o, m = step(p, o, place(b))
            losses.append(m["loss"])
        return p, o, torch.stack(losses)

    opt0 = adamw_init(params, tcfg.opt)
    p, o, want = _mesh_run(f"{label} no rules", lambda: run(
        make_train_step(cfg, tcfg, loss_fn=loss_fn), params, opt0, put), {})
    want_state = _host_tree({"p": p, "o": o})
    del p, o
    step = make_train_step(cfg, tcfg, rules=rules, loss_fn=loss_fn)
    lay = step.layout
    blocks = lay.shard_params(params), lay.shard_opt_state(opt0)
    del opt0
    p, o, got = _mesh_run(f"{label} make_train_step(rules=) at (1, 1)",
                          lambda: run(step, *blocks,
                                      lambda b: shard_for(b, rules,
                                                          "cuda")), total)
    del blocks
    got_state = flatten({"p": p, "o": o})
    differ = [k for k, v in want_state.items()
              if not torch.equal(got_state[k], v.cuda())]
    same = torch.equal(got.cpu(), want.cpu()) and not differ
    print(f"  (a) {label}: losses {[round(float(x), 6) for x in got]}; "
          f"every loss, parameter and AdamW leaf ({len(want_state)}) "
          f"bit-equal to no rules: {same}")
    if not same:
        raise AssertionError(f"(a) {label}: differs from no rules: losses "
                             f"{got.tolist()} against {want.tolist()}, "
                             f"leaves {differ[:8]}")
    return step, p, rules


def mesh_train_one(total) -> None:
    """Phase 11 (a): training under rules at the world of one (phase 10's
    NCCL group), bit for bit against no rules: M³ViT at the full CONFIG,
    batch 8, 3 steps; Llama-3.2-1B at full width and depth, 4 × 128
    tokens, 2 steps; then ``compressed_psum`` of Llama's gradients."""
    from repro_torch import ops
    from repro_torch.configs import llama3_2_1b as LL
    from repro_torch.configs import m3vit as MV
    from repro_torch.data import DataConfig, make_stream, shard_for
    from repro_torch.dist import compress as C
    from repro_torch.models import model as LM
    from repro_torch.models import vit
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainConfig

    cuda = ops.policy_named("cuda")
    cfg = replace(MV.CONFIG, policy=_staged(cuda))
    stream = make_stream(DataConfig(batch=BATCH, seq_len=0, kind="m3vit",
                                    seed=0))
    tcfg = TrainConfig(opt=OptConfig(lr=3e-3, warmup_steps=2,
                                     total_steps=40, weight_decay=0.0))
    _world_of_one_train(f"M3ViT batch {BATCH}, 3 steps", cfg, tcfg,
                        vit.init_params(0, MV.CONFIG),
                        [stream.batch(i) for i in range(3)], total,
                        loss_fn=_m3vit_loss(cfg))
    gc.collect()
    torch.cuda.empty_cache()

    cfg = replace(LL.CONFIG, policy=cuda)
    stream = make_stream(DataConfig(batch=4, seq_len=128,
                                    vocab_size=cfg.vocab_size, seed=0))
    batches = [stream.batch(i) for i in range(2)]
    step, params, rules = _world_of_one_train(
        "Llama-3.2-1B 4 x 128, 2 steps", cfg, TrainConfig(),
        LM.init_params(0, cfg, draw_on_device=True), batches, total)
    _, grads = step.grads(params, shard_for(batches[0], rules, "cuda"))
    out, err = C.compressed_psum(grads, C.init_error_state(grads),
                                 rules.mesh)
    same = True
    for k, g in grads.items():
        gf = g.float()
        gf = torch.where(torch.isfinite(gf), gf, 0.0)
        deq = C.dequantize_int8(*C.quantize_int8(gf), gf.shape)
        same &= torch.equal(out[k], deq.to(g.dtype)) and torch.equal(
            err[k], gf - deq)
    print(f"  (a) compressed_psum of Llama-3.2-1B's {len(grads)} gradient "
          f"leaves at the world of one: the output equals the dequantized "
          f"payload and the carry gf - deq, bit for bit: {same}")
    if not same:
        raise AssertionError("(a) compressed_psum at the world of one")


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


#: phase 11 (b)'s tensor-parallel training shapes over (1, 2): (model,
#: rows, weight, K, N, activation, bias, how a rank holds it) — M³ViT's
#: MLP at its 8 images of 128 tokens, Llama-3.2-1B's projections at its
#: 4 x 128 rows, RecurrentGemma-9B's RG-LRU, MLP and attention
#: projections at its 2 x 128, xLSTM-350M's mLSTM projections at its
#: XL_TRAIN_BATCH x XL_PROMPT (``w_qkv``: the table's contiguous block of
#: 3072 columns; each rank runs the whole batch)
TP_TRAIN_SHAPES = (
    ("M3ViT", TOKENS, "w1", 192, 768, "gelu", True, "columns"),
    ("M3ViT", TOKENS, "w2", 768, 192, None, False, "rows"),
    ("Llama-3.2-1B", 4 * 128, "wq", 2048, 2048, None, False, "columns"),
    ("Llama-3.2-1B", 4 * 128, "wk", 2048, 512, None, False, "columns"),
    ("Llama-3.2-1B", 4 * 128, "wg", 2048, 8192, "silu", False, "columns"),
    ("Llama-3.2-1B", 4 * 128, "wu", 2048, 8192, None, False, "columns"),
    ("Llama-3.2-1B", 4 * 128, "wo", 2048, 2048, None, False, "rows"),
    ("Llama-3.2-1B", 4 * 128, "wd", 8192, 2048, None, False, "rows"),
    ("RecurrentGemma-9B", 2 * 128, "rglru w_up", 4096, 4096, None, False,
     "columns"),
    ("RecurrentGemma-9B", 2 * 128, "rglru w_up2", 4096, 4096, "gelu", False,
     "columns"),
    ("RecurrentGemma-9B", 2 * 128, "rglru w_down", 4096, 4096, None, False,
     "rows"),
    ("RecurrentGemma-9B", 2 * 128, "mlp wg", 4096, 12288, "gelu", False,
     "columns"),
    ("RecurrentGemma-9B", 2 * 128, "mlp wu", 4096, 12288, None, False,
     "columns"),
    ("RecurrentGemma-9B", 2 * 128, "mlp wd", 12288, 4096, None, False,
     "rows"),
    ("RecurrentGemma-9B", 2 * 128, "attn wq", 4096, 4096, None, False,
     "columns"),
    ("RecurrentGemma-9B", 2 * 128, "attn wo", 4096, 4096, None, False,
     "rows"),
    ("xLSTM-350M", XL_TRAIN_BATCH * XL_PROMPT, "mlstm w_up", 1024, 2048,
     None, False, "columns"),
    ("xLSTM-350M", XL_TRAIN_BATCH * XL_PROMPT, "mlstm w_gates", 1024, 2048,
     None, False, "columns"),
    ("xLSTM-350M", XL_TRAIN_BATCH * XL_PROMPT, "mlstm w_qkv", 2048, 6144,
     None, False, "columns"),
    ("xLSTM-350M", XL_TRAIN_BATCH * XL_PROMPT, "mlstm w_down", 2048, 1024,
     None, False, "rows"))


def _tp_train_kernels(policy) -> dict:
    """Phase 11 (b), rank 0: the kernels of the tensor-parallel training
    runs at their shapes over (1, 2) (``TP_TRAIN_SHAPES``), each against
    its plain version.  ``unified_linear``: the whole product with its
    epilogue (the LUT where ``policy`` takes it) within the bf16 tolerance
    (+1 table step at LUT index ties); each column block (N/2, its bias
    and epilogue, summed in the whole weight's K order) bit-equal to the
    whole product's columns; each row block (K/2, float32 out) within the
    float32 tolerance; and the backward (``UnifiedLinearFn``'s float32
    PyTorch) of each row block and of each column block without an
    activation against autograd through the plain version, at the bf16
    tolerance of the gradients' dtype.  ``flash_attention``: Llama's 16 of
    32 q heads over 4 of 8 KV heads at 4 x 128, and RecurrentGemma-9B's 8
    of 16 q heads over its one KV head at head_dim 256, 2 x 128, causal,
    forward and backward.  M³ViT's attention and routed experts (``gelu_lut``,
    ``moe_gemm``) run whole on each rank, at the shapes phases 5 and 6
    hold.  Returns the largest error per kernel."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import unified_linear as kul

    geo = dict(step_log2=policy.lut_step_log2, lut_range=policy.lut_range)
    errs = {"unified_linear": 0.0, "flash_attention": 0.0}

    def held(name, label, got, want, dtype, **kw):
        errs[name] = max(errs[name], check(name, f"(b) rank 0 {label}", got,
                                           want, dtype, **kw))

    def backward(name, label, kernel, plain, names, *inputs):
        """The gradients of ``kernel`` and of ``plain`` for one made-up
        output gradient, each input's (``names``) against the plain
        one's."""
        dy = None
        out = []
        for fn in (kernel, plain):
            ins = [t.detach().requires_grad_() for t in inputs]
            y = fn(*ins)
            if dy is None:
                dy = randn(tuple(y.shape), y.dtype, seed=94)
            out.append(torch.autograd.grad(y, ins, dy))
        for n, g, want in zip(names, *out):
            held(name, f"{label} backward d{n}", g, want, g.dtype)

    for model, m, name, k, n, act, bias, split in TP_TRAIN_SHAPES:
        x = randn((m, k), torch.bfloat16, seed=91)
        w = randn((k, n), torch.bfloat16, scale=k ** -0.5, seed=92)
        b = randn((n,), torch.float32, scale=0.1, seed=93) if bias else None
        lut = bool(policy.lut_activations and act in ("gelu", "silu"))
        kw = dict(activation=act, use_lut=lut, **geo)
        label = f"{model} {name} M={m}"
        if split == "columns":
            whole = kul.unified_linear(x, w, b, **kw)
            pre = kul.unified_linear_plain(x.float(), w.float(), b) \
                if lut else None
            held("unified_linear", f"{label} whole {k}x{n} "
                 f"{act or 'none'}{'-lut' if lut else ''}", whole,
                 kul.unified_linear_plain(x, w, b, **kw), torch.bfloat16,
                 lut_pre=pre, kind=act or "gelu", **geo)
            h = n // 2
            for r in range(2):
                cols = slice(r * h, (r + 1) * h)
                wr = w[:, cols].contiguous()
                br = None if b is None else b[cols].contiguous()
                check_exact("unified_linear", f"(b) rank 0 {label} column "
                            f"block {r} ({k}x{h} of {n})",
                            kul.unified_linear(x, wr, br, order_n=n, **kw),
                            whole[:, cols])
                if act is None:
                    backward("unified_linear", f"{label} column block {r}",
                             lambda a, c: kul.unified_linear(a, c,
                                                             order_n=n),
                             kul.unified_linear_plain, "xw", x, wr)
        else:
            kk = k // 2
            f32 = dict(out_dtype=torch.float32)
            for r in range(2):
                rows = slice(r * kk, (r + 1) * kk)
                xr, wr = x[:, rows].contiguous(), w[rows].contiguous()
                held("unified_linear", f"{label} row block {r} ({kk}x{n}, "
                     f"float32 out)", kul.unified_linear(xr, wr, **f32),
                     kul.unified_linear_plain(xr, wr, **f32), torch.float32)
                backward("unified_linear", f"{label} row block {r}",
                         lambda a, c: kul.unified_linear(a, c, **f32),
                         lambda a, c: kul.unified_linear_plain(a, c, **f32),
                         "xw", xr, wr)
    q = randn((4, 16, 128, 64), torch.bfloat16, seed=95)
    kv = [randn((4, 4, 128, 64), torch.bfloat16, seed=s) for s in (96, 97)]
    label = "Llama-3.2-1B 16 q heads over 4 KV heads, 4 x 128, causal"
    held("flash_attention", label, kfa.flash_attention(q, *kv),
         kfa.flash_attention_plain(q, *kv), torch.bfloat16)
    backward("flash_attention", label, kfa.flash_attention,
             kfa.flash_attention_plain, "qkv", q, *kv)
    q = randn((2, 8, 128, 256), torch.bfloat16, seed=98)
    kv = [randn((2, 1, 128, 256), torch.bfloat16, seed=s) for s in (99, 100)]
    label = ("RecurrentGemma-9B 8 q heads over 1 KV head, D=256, 2 x 128, "
             "causal")
    held("flash_attention", label, kfa.flash_attention(q, *kv),
         kfa.flash_attention_plain(q, *kv), torch.bfloat16)
    backward("flash_attention", label, kfa.flash_attention,
             kfa.flash_attention_plain, "qkv", q, *kv)
    return errs


#: the whole leaves an xLSTM rank reads in part, for its heads alone: over
#: ``model`` their gradients are the ranks' partial sums (the ``f`` on the
#: weight: ``mlstm`` / ``slstm whole leaves (backward)``)
XL_PARTLY_READ = ("w_if", "b_if", "gn_scale", "b_gates")
#: the floor of their bf16 cosines, mesh against one process, at their
#: worst leaf: ``tools/xlstm_grad_probe.py`` on the H100 at 8 layers, seeds
#: 0-2, reads 0.9915-0.9966 there; one process against itself under the
#: plain ``eager`` kernels' other sums (bf16 noise alone) 0.914-0.973; the
#: weights' ``f`` left out 0.43 (float32) and 0.49 (bf16)
XL_GRAD_BF16_FLOOR = 0.85


def _partly_read_grads(cfg, tcfg, params, batch, rules=None,
                       label=None) -> dict:
    """The gradients of ``params``' ``XL_PARTLY_READ`` leaves for
    ``batch``: of one process on the whole batch, or over ``rules``' mesh
    (each rank its blocks of ``params``, the gradients gathered whole;
    counted through ``_mesh_run`` as ``label`` where one is given)."""
    from repro_torch.data import device_transform, shard_for
    from repro_torch.dist import spmd
    from repro_torch.train import make_train_step

    step = make_train_step(cfg, tcfg, rules=rules)
    if rules is None:
        _, g = step.grads(params, device_transform("cuda")(batch))
    else:
        def run():
            return step.grads(step.layout.shard_params(params),
                              shard_for(batch, rules, "cuda"))

        _, g = _mesh_run(label, run, {}) if label else run()
    names = [k for k in g if k.rsplit(".", 1)[-1] in XL_PARTLY_READ]
    if rules is None:
        return {k: g[k] for k in names}
    with torch.no_grad():
        return {k: spmd.gather_param(g[k], step.layout.params[k],
                                     rules.mesh) for k in names}


def _xl_partly_read(rank: int, cfg, tcfg, params, batch, rules) -> dict:
    """Phase 11 (b): the gradients of the whole leaves each xLSTM rank
    reads for its heads alone (``XL_PARTLY_READ``) over ``rules``' (1, 2)
    mesh against one process on the whole batch (rank 0), by each leaf's
    cosine.  In float32 under ``eager`` (the weights widened) only the
    order of the sums differs, so the mesh sits within ~1e-9 of one
    process; a missing ``f`` leaves a rank its own heads' part of the
    gradient alone (every leaf below GRAD_COSINE_LEAF): float32 is held at
    GRAD_COSINE_LEAF.  In bf16 under ``cfg``'s policy the mesh and one
    process are two roundings of one gradient, as far apart as the
    model's bf16 noise: held at ``XL_GRAD_BF16_FLOOR``, and printed beside
    each one's cosine to the float32 one-process gradients.  Returns the
    readings and the verdict on every rank."""
    import torch.distributed as dist

    from repro_torch import ops
    from repro_torch.kernels import compare

    cfg32 = replace(cfg, dtype="float32", policy=ops.policy_named("eager"))
    p32 = {k: v.float() for k, v in params.items()}
    label = (f"(b) rank {rank} xLSTM-350M {cfg.num_layers} layers "
             f"partly-read leaves' gradients over 1x2")
    mesh = {"bf16": _partly_read_grads(cfg, tcfg, params, batch, rules,
                                       label),
            "f32": _partly_read_grads(cfg32, tcfg, p32, batch, rules)}
    out = {}
    if rank == 0:
        one = {"bf16": _partly_read_grads(cfg, tcfg, params, batch),
               "f32": _partly_read_grads(cfg32, tcfg, p32, batch)}

        def cos(a, b):
            return {k: compare.cosine(a[k], b[k]) for k in sorted(b)}

        out = {"f32": cos(mesh["f32"], one["f32"]),
               "bf16": cos(mesh["bf16"], one["bf16"]),
               "bf16 mesh to f32": cos(mesh["bf16"], one["f32"]),
               "bf16 one to f32": cos(one["bf16"], one["f32"])}
        del one
    del mesh, p32
    box = [out]
    dist.broadcast_object_list(box, src=0)
    out = box[0]
    kinds = [cfg.block_kind(i) for i in range(cfg.num_layers)]
    leaves = 3 * kinds.count("mlstm") + 2 * kinds.count("slstm")
    out["ok"] = (len(out["f32"]) == leaves
                 and min(out["f32"].values()) >= compare.GRAD_COSINE_LEAF
                 and min(out["bf16"].values()) >= XL_GRAD_BF16_FLOOR)
    return out


def _partly_read_line(g: dict) -> str:
    """``_xl_partly_read``'s readings, each at its worst leaf."""
    from repro_torch.kernels import compare

    worst = ", ".join(f"{name} {min(v.values()):.10f} ({min(v, key=v.get)})"
                      for name, v in g.items() if name != "ok")
    return (f"the gradients of the {len(g['f32'])} whole leaves each rank "
            f"reads for its heads ({', '.join(XL_PARTLY_READ)}) against one "
            f"process, worst cosine: {worst} (f32 >= "
            f"{compare.GRAD_COSINE_LEAF}, bf16 >= {XL_GRAD_BF16_FLOOR}): "
            f"{g['ok']}")


def _two_ranks_train(rank: int, workdir: str) -> dict:
    """Phase 11 (b) on one of the two ranks (gloo over CUDA tensors),
    after phase 10 (b)'s work: on rank 0 the kernels at the
    tensor-parallel training shapes (:func:`_tp_train_kernels`); M³ViT at
    2×1 (fsdp, batch 8 split 4 + 4, 2 steps) and at 1×2 (tensor-parallel
    MLPs) against one process on the whole batch; M³ViT at 1×2 under
    ``ep_local`` (8 of 16 experts a rank), every expert's gradient against
    single-device ``grouped``; Llama-3.2-1B at full width and
    ``MESH_LM_LAYERS`` layers at 2×1 and at 1×2 (tensor-parallel), 2
    steps, against one process; RecurrentGemma-9B at full width and
    ``TP_RG_LAYERS`` layers at 1×2 (its RG-LRU mixers split, never
    gathered over ``model``), batch 2 x 128, 2 steps, against one process;
    xLSTM-350M at full width and ``TP_XL_LAYERS`` layers at 1×2 (its
    mLSTM and sLSTM heads split), ``XL_TRAIN_BATCH`` x ``XL_PROMPT``, 2
    steps, against one process, and the gradients of the whole leaves
    each rank reads for its heads alone against one process's;
    ``compressed_psum`` over the ranks; the
    launcher's ``--mesh local`` for 3 steps with a checkpoint.  Returns
    what the parent prints."""
    import time

    import torch.distributed as dist

    from repro_torch import ops
    from repro_torch.configs import llama3_2_1b as LL
    from repro_torch.configs import m3vit as MV
    from repro_torch.data import (DataConfig, device_transform, make_stream,
                                  shard_for)
    from repro_torch.dist import compress as C
    from repro_torch.dist import spmd
    from repro_torch.dist.sharding import ShardingRules, local_slice
    from repro_torch.kernels import compare
    from repro_torch.launch import train as LT
    from repro_torch.models import model as LM
    from repro_torch.models import vit
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.train import TrainConfig, make_train_step

    res: dict = {}
    total: dict = {}
    tp_total: dict = {}         # the tensor-parallel runs' launches
    cuda = ops.policy_named("cuda")
    if rank == 0:
        res["tp_kernel_errs"] = _tp_train_kernels(cuda)
    put = device_transform("cuda")
    tcfg = TrainConfig(opt=OptConfig(**MESH_OPT))
    mesh21 = spmd.init_mesh((2, 1))
    rules21 = ShardingRules.for_mesh(mesh21)
    mesh12 = spmd.init_mesh((1, 2))
    rules12 = ShardingRules.for_mesh(mesh12)

    def against_one(label, cfg, params, batches, loss_fn=None,
                    rules=rules21, forwards=1, train=tcfg):
        """``batches`` over ``rules``' mesh against one process on the
        whole batch; over (1, 2) tensor-parallel, its collectives by
        ``where`` gated (``_tp_train_expect``) and no SIMT launch but
        the sLSTM's 1365-wide projections (``_slstm_simt``).  Each
        rank first takes its blocks of ``params``; the one-process steps
        then run on rank 0 alone (two of RecurrentGemma-9B's do not fit
        the card side by side) while rank 1 waits, and rank 0 sends its
        losses and grad norms, and later its verdict on the updated
        parameters, which the ranks' bit-equal re-gathered parameters
        make rank 1's too.  Returns the mesh step's layout."""
        t0 = time.perf_counter()
        mesh = rules.mesh
        shape = "x".join(map(str, mesh.shape))
        single = make_train_step(cfg, train, loss_fn=loss_fn)
        meshed = make_train_step(cfg, train, rules=rules, loss_fn=loss_fn)
        lay = meshed.layout
        # this rank's blocks, and the whole shapes for AdamW's state; the
        # whole weights kept on rank 0 alone (freed on rank 1 where the
        # caller keeps no other reference)
        pm = lay.shard_params(params)
        shapes = {k: v.to("meta") for k, v in params.items()}
        p = params if rank == 0 else None
        del params
        gc.collect()
        torch.cuda.empty_cache()
        one = {"metrics": [], "walls": []}
        if rank == 0:
            torch.cuda.reset_peak_memory_stats()
            free = torch.cuda.mem_get_info()[0]
            held = torch.cuda.memory_allocated()
            o = adamw_init(p, train.opt)
            for b in batches:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                p, o, m1 = single(p, o, put(b))
                torch.cuda.synchronize()
                one["walls"].append((time.perf_counter() - t1) * 1e3)
                one["metrics"].append({k: float(m1[k])
                                       for k in ("loss", "grad_norm")})
            del o
            print(f"  (b) rank 0 {label}: the one-process steps' peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
                  f"{held / 2**30:.2f} of it held before them, beside the "
                  f"{free / 2**30:.2f} GiB then free", flush=True)
            gc.collect()
            torch.cuda.empty_cache()
        box = [one]
        dist.broadcast_object_list(box, src=0)
        one = box[0]
        walls = {"one": one["walls"], "mesh": [],
                 "call_s": {"one": time.perf_counter() - t0}}
        # AdamW's zeroed state at this rank's blocks, shaped on meta
        dev = next(iter(pm.values())).device
        om = lay.shard_opt_state(adamw_init(shapes, train.opt))
        om = {"step": torch.zeros_like(om["step"], device=dev), "ema": {
            k: {n: torch.zeros_like(t, device=dev) for n, t in st.items()}
            for k, st in om["ema"].items()}}
        del shapes
        worst = {"loss": 0.0, "grad_norm": 0.0}
        where: dict = {}
        for i, b in enumerate(batches):
            m1 = one["metrics"][i]
            counted: dict = {}
            t1 = time.perf_counter()
            pm, om, m2 = _mesh_run(
                f"(b) rank {rank} {label} step {i} over {shape}",
                lambda: meshed(pm, om, shard_for(b, rules, "cuda")),
                counted)
            walls["mesh"].append((time.perf_counter() - t1) * 1e3)
            for into in (total, tp_total) if mesh is mesh12 else (total,):
                for n, c in counted.items():
                    into[n] = into.get(n, 0) + c
            for c in ops.collective_report():
                key = f"{c['kind']}:{c['axis']}:{c['where']}"
                where[key] = where.get(key, 0) + c["count"]
            if mesh is mesh12:
                read_variants(f"(b) rank {rank} {label} step {i} over "
                              f"{shape}", _slstm_simt(cfg, forwards),
                              tally=False)
            for k in worst:
                worst[k] = max(worst[k], _rel(m2[k], m1[k]))
        walls["call_s"]["mesh"] = time.perf_counter() - t0 \
            - walls["call_s"]["one"]
        with torch.no_grad():
            whole = {k: spmd.gather_param(v, lay.params[k], mesh)
                     for k, v in pm.items()}
        # the ranks' re-gathered parameters, bit for bit each other's
        same = True
        axis = "data" if mesh is mesh21 else "model"
        for k, v in whole.items():
            both = spmd.all_gather(v[None], mesh, axis,
                                   "phase 11 ranks' parameters")
            same &= torch.equal(both[0], both[1])
        # on rank 0, one step of the bf16 tolerance for each step taken, a
        # leaf's elements taken 2^24 at a time (RecurrentGemma's 1
        # G-element embedding widened whole would take GBs a temporary)
        steps = len(batches)
        within, worst_err = True, 0.0
        for k in p or {}:
            for g, w in zip(whole[k].reshape(-1).split(1 << 24),
                            p[k].reshape(-1).split(1 << 24)):
                within &= bool(((g.float() - w.float()).abs()
                                <= steps * compare.kernel_tolerance(
                                    g, w, w.dtype)).all())
                worst_err = max(worst_err, compare.max_abs_err(g, w))
        box = [(within, worst_err)]
        dist.broadcast_object_list(box, src=0)
        within, worst_err = box[0]
        walls["call_s"]["checks"] = time.perf_counter() - t0 \
            - walls["call_s"]["one"] - walls["call_s"]["mesh"]
        ok = (worst["loss"] <= compare.TRAIN_LOSS_RTOL
              and worst["grad_norm"] <= compare.TRAIN_LOSS_RTOL
              and within and same)
        res[label] = {"loss_rel": worst["loss"],
                      "grad_norm_rel": worst["grad_norm"],
                      "params_within": within, "max_abs_err": worst_err,
                      "ranks_equal": same, "mesh": shape, "ok": ok,
                      "walls_ms": walls}
        if mesh is mesh12:
            want = _tp_train_expect(cfg, lay, len(batches) * forwards,
                                    len(batches))
            keys = set(want) | {k for k in where if k.startswith(
                "all_gather:model:") or k.split(":", 2)[2] in TP_WHERE}
            bad = {k: (where.get(k, 0), want.get(k, 0)) for k in keys
                   if where.get(k, 0) != want.get(k, 0)}
            res[label].update(collectives=where, collectives_off=bad,
                              ok=ok and not bad)
        return lay

    # M³ViT at 2×1
    mcfg = replace(MV.CONFIG, policy=_staged(cuda))
    mstream = make_stream(DataConfig(batch=BATCH, seq_len=0, kind="m3vit",
                                     seed=0))
    mparams = vit.init_params(0, MV.CONFIG)
    against_one("M3ViT", mcfg, mparams, [mstream.batch(i) for i in range(2)],
                loss_fn=_m3vit_loss(mcfg))

    # M³ViT at 1×2: tensor-parallel MLPs (three heads: attention whole)
    against_one("M3ViT TP", mcfg, mparams,
                [mstream.batch(i) for i in range(2)],
                loss_fn=_m3vit_loss(mcfg), rules=rules12, forwards=2)

    # M³ViT at 1×2 under ep_local: every expert's gradient
    ecfg = replace(mcfg, moe=replace(mcfg.moe, impl="ep_local"))
    b = mstream.batch(0)
    _, want = make_train_step(mcfg, tcfg, loss_fn=_m3vit_loss(mcfg)).grads(
        mparams, put(b))
    ep = make_train_step(ecfg, tcfg, rules=rules12,
                         loss_fn=_m3vit_loss(ecfg))
    _, got = _mesh_run(
        f"(b) rank {rank} M3ViT ep_local gradients over 1x2",
        lambda: ep.grads(ep.layout.shard_params(mparams),
                         shard_for(b, rules12, "cuda")), total)
    # the expert stacks (keep also holds the MLPs' tensor-parallel blocks)
    cos, names = [], sorted(k for k in ep.layout.keep if ".moe." in k)
    for k in names:
        mine = want[k][local_slice(tuple(want[k].shape), ep.layout.params[k],
                                   mesh12)]
        for e in range(mine.shape[1]):
            if float(mine[:, e].float().norm()) > 0:
                cos.append(compare.cosine(got[k][:, e], mine[:, e]))
    whole_cos = compare.cosine(torch.cat([got[k].flatten() for k in names]),
                               torch.cat([want[k][local_slice(
                                   tuple(want[k].shape), ep.layout.params[k],
                                   mesh12)].flatten() for k in names]))
    res["ep_local"] = {"leaves": len(names), "experts": len(cos),
                       "worst_cosine": min(cos), "cosine": whole_cos,
                       "ok": min(cos) >= compare.GRAD_COSINE_LEAF
                       and whole_cos >= compare.GRAD_COSINE_ALL}
    del mparams, want, got
    gc.collect()
    torch.cuda.empty_cache()

    # Llama-3.2-1B at full width, MESH_LM_LAYERS layers, 2×1
    lcfg = replace(LL.CONFIG, num_layers=MESH_LM_LAYERS, policy=cuda)
    lstream = make_stream(DataConfig(batch=4, seq_len=128,
                                     vocab_size=lcfg.vocab_size, seed=0))
    lparams = LM.init_params(0, lcfg, draw_on_device=True)
    lbatches = [lstream.batch(i) for i in range(2)]
    against_one(f"Llama-3.2-1B {MESH_LM_LAYERS} layers", lcfg, lparams,
                lbatches)
    # the same at 1×2, tensor-parallel: 16 of 32 q heads, 4 of 8 KV heads,
    # half of the MLP's columns and of the vocabulary a rank
    against_one(f"Llama-3.2-1B {MESH_LM_LAYERS} layers TP", lcfg, lparams,
                lbatches, rules=rules12)
    del lparams
    gc.collect()
    torch.cuda.empty_cache()

    # RecurrentGemma-9B at full width, TP_RG_LAYERS layers, 1×2: its
    # RG-LRU mixers, MLPs, q heads and vocabulary split, k/v whole (MQA);
    # AdamW with the reference's large-model state (bf16 momentum, a
    # factored second moment: the split gates factored per head)
    gcfg = _rg_config(policy=cuda)
    gtrain = TrainConfig(opt=OptConfig(**MESH_OPT, momentum_dtype="bfloat16",
                                       factored=True))
    gstream = make_stream(DataConfig(batch=2, seq_len=128,
                                     vocab_size=gcfg.vocab_size, seed=0))
    label = f"RecurrentGemma-9B {TP_RG_LAYERS} layers TP"
    lay = against_one(label, gcfg,
                      LM.init_params(0, gcfg, draw_on_device=True),
                      [gstream.batch(i) for i in range(2)], rules=rules12,
                      train=gtrain)
    mixers = [k for k in lay.params if ".rglru." in k]
    kept = bool(mixers) and all(lay.keep.get(k) == ("model",)
                                for k in mixers)
    res[label].update(rglru_kept=kept, ok=res[label]["ok"] and kept)
    del lay
    gc.collect()
    torch.cuda.empty_cache()

    # xLSTM-350M at full width, TP_XL_LAYERS layers, 1×2: its mLSTM and
    # sLSTM heads and its vocabulary split, the sLSTM's 1365-wide
    # up-projection whole; first the gradients of the whole leaves each
    # rank reads for its heads alone, against one process on rank 0
    t_xl = time.perf_counter()
    xcfg = _xl_config(policy=cuda)
    xstream = make_stream(DataConfig(batch=XL_TRAIN_BATCH, seq_len=XL_PROMPT,
                                     vocab_size=xcfg.vocab_size, seed=0))
    xbatches = [xstream.batch(i) for i in range(2)]
    xparams = LM.init_params(0, xcfg, draw_on_device=True)
    label = f"xLSTM-350M {TP_XL_LAYERS} layers TP"
    xl_grads = _xl_partly_read(rank, xcfg, tcfg, xparams, xbatches[0],
                               rules12)
    lay = against_one(label, xcfg, xparams, xbatches, rules=rules12)
    del xparams
    split = {"mlstm": ("w_up", "w_gates", "w_qkv", "conv", "w_down"),
             "slstm": ("w_gates", "r_gates")}       # 1365 columns: whole
    mixers = {k: k.split(".")[-2:] for k in lay.params
              if k.split(".")[-2] in split}
    kept = len(mixers) == 7 * 8 + 7 and all(
        (lay.keep.get(k) == ("model",)) == (leaf in split[kind])
        for k, (kind, leaf) in mixers.items())
    res[label].update(xlstm_kept=kept, partly_read_grads=xl_grads,
                      ok=res[label]["ok"] and kept and xl_grads["ok"])
    res[label]["walls_ms"]["call_s"]["gradients"] = \
        time.perf_counter() - t_xl - sum(
            res[label]["walls_ms"]["call_s"].values())
    del lay
    gc.collect()
    torch.cuda.empty_cache()

    # compressed_psum over the two ranks: each rank knows both payloads
    rows = [randn((2048, 2048), torch.float32, seed=r) for r in range(2)]
    deqs = [C.dequantize_int8(*C.quantize_int8(r), r.shape) for r in rows]
    out, err = C.compressed_psum({"w": rows[rank]},
                                 C.init_error_state({"w": rows[rank]}),
                                 mesh21)
    res["compressed_psum"] = {"ok": torch.equal(out["w"], deqs[0] + deqs[1])
                              and torch.equal(err["w"],
                                              rows[rank] - deqs[rank])}

    # the launcher over a ("data",) mesh of the two ranks
    ckpt = os.path.join(workdir, "launch")
    loop = _mesh_run(
        f"(b) rank {rank} launch.train --mesh local, 3 steps",
        lambda: LT.run(MESH_LAUNCH + ["--mesh", "local", "--steps", "3",
                                      "--ckpt-dir", ckpt,
                                      "--ckpt-every", "3"]), total)
    res["launch"] = {"history": loop.state.history,
                     "mesh": list(loop.layout.mesh.shape),
                     "ok": loop.state.step == 3
                     and loop.state.nan_skip_count == 0}
    res["launches"] = total
    res["tp_launches"] = tp_total
    dist.barrier()
    return res


#: the tensor-parallel blocks' collectives (``models/layers.py``,
#: ``models/model.py:cross_entropy``), each held to its count by
#: ``_tp_train_expect`` in phase 11 (b)
TP_WHERE = ("attn_out all-reduce", "attn input (backward)",
            "mlp_down all-reduce", "mlp input (backward)",
            "rglru_down all-reduce", "rglru input (backward)",
            "embed all-reduce", "lm_head input (backward)", "loss max",
            "loss sum-exp", "loss label logit", "logits all-gather",
            "attn kv (backward)", "mlstm_down all-reduce",
            "mlstm input (backward)", "mlstm_uc input (backward)",
            "mlstm_qkv input (backward)", "mlstm whole leaves (backward)",
            "slstm_down all-reduce", "slstm input (backward)",
            "slstm_up input (backward)", "slstm whole leaves (backward)")


def _tp_counts(cfg, tp: int) -> dict:
    """The collectives over ``model`` one forward of ``cfg`` and its
    backward make over ``tp`` ranks, by ``kind:axis:where``: each split
    attention layer's ``attn_out``, each MLP's ``mlp_down`` and each split
    RG-LRU mixer's ``rglru_down`` all-reduce in the forward and their
    inputs' ``f`` in the backward, and where k/v stay whole beside split q
    heads the ``f`` of ``wk`` and ``wv``; each split mLSTM's uc and qkv
    all-gathers and ``mlstm_down`` all-reduce in the forward and, in the
    backward, the ``f`` of its input, of uc, of qkv and of its three
    partly-read whole leaves (``w_if``, ``b_if``, ``gn_scale``); each
    split sLSTM's hn all-gather and the ``f`` of its input and of its two
    whole leaves (``b_gates``, ``gn_scale``), and where its up-projection
    splits its ``slstm_down`` all-reduce and that input's ``f``; the
    embedding's all-reduce, the head's ``f`` and the vocab-parallel
    loss's three reduces where the vocabulary splits."""
    from repro_torch.models import rglru, xlstm
    from repro_torch.models.layers import attention_layout

    kinds = [cfg.block_kind(i) for i in range(cfg.num_layers)]
    q_split, kv_split = attention_layout(cfg, tp)
    attn = sum(k.startswith("attn") for k in kinds) if q_split else 0
    mlp = sum(k in ("attn_mlp", "attn_local_mlp", "rglru_mlp")
              for k in kinds)
    mixers = kinds.count("rglru_mlp") if rglru.split_over(cfg, tp) else 0
    xl = xlstm.split_over(cfg, tp)
    nm = kinds.count("mlstm") if xl else 0
    ns = kinds.count("slstm") if xl else 0
    nu = ns if (4 * cfg.d_model // 3) % tp == 0 else 0
    reduces = (("attn_out all-reduce", attn),
               ("attn input (backward)", attn),
               ("attn kv (backward)", 0 if kv_split else 2 * attn),
               ("mlp_down all-reduce", mlp),
               ("mlp input (backward)", mlp),
               ("rglru_down all-reduce", mixers),
               ("rglru input (backward)", mixers),
               ("mlstm_down all-reduce", nm),
               ("mlstm input (backward)", nm),
               ("mlstm_uc input (backward)", nm),
               ("mlstm_qkv input (backward)", nm),
               ("mlstm whole leaves (backward)", 3 * nm),
               ("slstm input (backward)", ns),
               ("slstm whole leaves (backward)", 2 * ns),
               ("slstm_down all-reduce", nu),
               ("slstm_up input (backward)", nu))
    if cfg.vocab_size:
        reduces += tuple((at, 1) for at in (
            "embed all-reduce", "lm_head input (backward)", "loss max",
            "loss sum-exp", "loss label logit"))
    gathers = (("mlstm_uc all-gather", nm), ("mlstm_qkv all-gather", nm),
               ("slstm_hn all-gather", ns))
    return {f"{kind}:model:{at}": n for kind, pairs in (
        ("all_reduce", reduces), ("all_gather", gathers))
        for at, n in pairs if n}


def _tp_serve_expect(cfg, forwards: int) -> dict:
    """The collectives over ``model`` a tensor-parallel serving run of
    ``forwards`` forwards over (1, 2) makes: ``_tp_counts``' forward ones
    but the loss's, and the logits all-gather a forward."""
    out = {k: n * forwards for k, n in _tp_counts(cfg, 2).items()
           if "(backward)" not in k and ":loss " not in k}
    out["all_gather:model:logits all-gather"] = forwards
    return out


def _tp_train_expect(cfg, lay, forwards: int, steps: int) -> dict:
    """The collectives over ``model`` a tensor-parallel training run of
    ``forwards`` forwards and backwards (``steps`` steps) makes, by
    ``kind:axis:where``: ``_tp_counts`` a forward, and a ``param gather``
    over ``model`` a step only for each leaf ``lay`` holds whole (M³ViT's
    attention and routed experts), none for a split one."""
    from repro_torch.dist import spmd

    out = {k: n * forwards for k, n in _tp_counts(
        cfg, spmd.axis_size(lay.mesh, "model")).items()}
    whole = [k for k, spec in lay.params.items() if k not in lay.keep
             and any("model" in ((e,) if isinstance(e, str) else e or ())
                     for e in spec)]
    if whole:
        out["all_gather:model:param gather"] = len(whole) * steps
    return out


def mesh_train_two(results) -> dict:
    """Phase 11 (b)'s results from both ranks, checked and printed; then
    the parent restores the launcher's mesh checkpoint without a mesh
    and trains on, against a run with no mesh from the start.  Returns
    the ranks' launches and those of their tensor-parallel runs, each
    summed over the ranks."""
    from repro_torch.kernels import compare
    from repro_torch.launch import train as LT

    launches: dict = {}
    tp_launches: dict = {}
    for r in results:
        t = r["train"]
        for label in ("M3ViT", f"Llama-3.2-1B {MESH_LM_LAYERS} layers",
                      "M3ViT TP", f"Llama-3.2-1B {MESH_LM_LAYERS} layers "
                      f"TP", f"RecurrentGemma-9B {TP_RG_LAYERS} layers TP",
                      f"xLSTM-350M {TP_XL_LAYERS} layers TP"):
            v = t[label]
            how = "fsdp, the batch split in two" if v["mesh"] == "2x1" \
                else "tensor-parallel, the whole batch on each rank"
            print(f"  (b) rank {r['rank']} {label} at {v['mesh']} ({how}), "
                  f"2 steps against one process: loss "
                  f"relative {v['loss_rel']:.3e}, grad norm relative "
                  f"{v['grad_norm_rel']:.3e} (<= {compare.TRAIN_LOSS_RTOL}); "
                  f"updated parameters within 2 steps of compare.py's "
                  f"tolerance: {v['params_within']} (max abs err "
                  f"{v['max_abs_err']:.3e}); the ranks' re-gathered "
                  f"parameters bit-equal: {v['ranks_equal']}")
            if "collectives" in v:
                print(f"  (b) rank {r['rank']} {label}: collectives "
                      f"{json.dumps(v['collectives'])}; against the count "
                      f"from the config (no logits all-gather, no gather "
                      f"over model of a split leaf): "
                      f"{v['collectives_off'] or 'ok'}")
            call = v["walls_ms"]["call_s"]
            print(f"  (b) rank {r['rank']} {label}: host walls a step "
                  f"(synchronized), one process (rank 0 alone) "
                  f"{', '.join(f'{w:.1f}' for w in v['walls_ms']['one'])} "
                  f"ms, over the mesh "
                  f"{', '.join(f'{w:.1f}' for w in v['walls_ms']['mesh'])} "
                  f"ms; the call {sum(call.values()):.1f} s ("
                  + ", ".join(f"{k} {w:.1f}" for k, w in call.items())
                  + " s)")
            if "rglru_kept" in v:
                print(f"  (b) rank {r['rank']} {label}: every RG-LRU leaf "
                      f"kept local over model, never gathered over it: "
                      f"{v['rglru_kept']}")
            if "xlstm_kept" in v:
                g = v["partly_read_grads"]
                print(f"  (b) rank {r['rank']} {label}: every split mixer "
                      f"leaf kept local over model, the whole ones not: "
                      f"{v['xlstm_kept']}; " + _partly_read_line(g))
        if "tp_kernel_errs" in t:
            print(f"  (b) rank {r['rank']} unified_linear and "
                  f"flash_attention at the tensor-parallel training shapes "
                  f"(M3ViT's MLP at M={TOKENS}, Llama-3.2-1B at M=512, "
                  f"RecurrentGemma-9B at M=256, xLSTM-350M at "
                  f"M={XL_TRAIN_BATCH * XL_PROMPT}; "
                  f"column blocks bit-equal, forward and backward against "
                  f"their plain versions): max abs err "
                  f"{json.dumps(t['tp_kernel_errs'])}")
        v = t["ep_local"]
        print(f"  (b) rank {r['rank']} M3ViT ep_local at 1x2, 8 of 16 "
              f"experts a rank: {v['experts']} expert gradients over "
              f"{v['leaves']} stacks against single-device grouped, worst "
              f"cosine {v['worst_cosine']:.6f}, all together "
              f"{v['cosine']:.6f}")
        print(f"  (b) rank {r['rank']} compressed_psum over the two ranks: "
              f"the sum of both dequantized payloads and this rank's carry, "
              f"bit for bit: {t['compressed_psum']['ok']}")
        print(f"  (b) rank {r['rank']} launch.train --mesh local over mesh "
              f"{t['launch']['mesh']}: losses "
              f"{[round(x, 5) for _, x in t['launch']['history']]}")
        bad = [k for k, v in t.items() if isinstance(v, dict) and "ok" in v
               and not v["ok"]]
        if bad:
            raise AssertionError(f"(b) rank {r['rank']}: {bad} failed: {t}")
        for n, c in t["launches"].items():
            launches[n] = launches.get(n, 0) + c
        for n, c in t["tp_launches"].items():
            tp_launches[n] = tp_launches.get(n, 0) + c
    # the parent: the mesh checkpoint restored without a mesh, 2 more
    # steps; against the same runs with no mesh (3 steps, then 2 more from
    # their checkpoint: the launcher's schedule follows --steps)
    def resume(ckpt):
        return LT.run(MESH_LAUNCH + ["--steps", "5", "--ckpt-dir", ckpt])

    resumed = resume(str(MESH_TRAIN_DIR / "launch"))
    plain_dir = str(MESH_TRAIN_DIR / "plain")
    plain = LT.run(MESH_LAUNCH + ["--steps", "3", "--ckpt-dir", plain_dir])
    plain_resumed = resume(plain_dir)
    got = {**dict(map(tuple, results[0]["train"]["launch"]["history"])),
           **dict(resumed.state.history)}
    want = {**dict(plain.state.history), **dict(plain_resumed.state.history)}
    worst = max(_rel(got[s], want[s]) for s in want)
    ok = set(got) == set(want) == set(range(5)) \
        and worst <= compare.TRAIN_LOSS_RTOL
    print(f"  (b) the parent restores the step-3 mesh checkpoint without a "
          f"mesh and trains steps 3-4: losses 0-2 over the mesh and 3-4 "
          f"after it against the same runs with no mesh: max relative "
          f"{worst:.3e} (<= {compare.TRAIN_LOSS_RTOL}): "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"(b) launcher checkpoint: {got} vs {want}")
    return launches, tp_launches

# ------------------------------------------------------------ phase 12

#: each example's arguments in phase 12 and the kernels it must launch
EXAMPLES = {
    "quickstart": ([], ("unified_linear", "flash_attention", "gelu_lut",
                        "moe_gemm")),
    "multitask_vit": (["--steps", "30", "--frames", "12"],
                      ("unified_linear", "flash_attention", "gelu_lut",
                       "moe_gemm")),
    "serve_lm": ([], ("unified_linear", "flash_attention", "decode_fused")),
    "train_lm": (["--steps", "20", "--batch", "8", "--seq-len", "128"],
                 ("unified_linear", "flash_attention")),
}
EXAMPLE_CKPT = ROOT / "build" / "examples_train_lm"


@contextlib.contextmanager
def simt_reasons(out: dict):
    """Tally into ``out`` (kernel -> {planner's reason: launches}) every
    GEMM or attention launch inside the block that its planner sends to
    the SIMT route; the launches run and count as they would."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import moe_gemm as MG
    from repro_torch.kernels import unified_linear as UL

    plans = ((UL, "unified_linear",
              lambda a: UL.plan_for(a[0], a[1], order_n=a[8])),
             (FA, "flash_attention", lambda a: FA.plan_for(a[0])),
             (MG, "moe_gemm", lambda a: MG.plan_for(a[0], a[1])))
    saved = []
    for mod, name, plan_of in plans:
        def launch(*args, _launch=mod._launch, _name=name, _plan=plan_of):
            plan = _plan(args)
            if plan.variant == "simt":
                by = out.setdefault(_name, {})
                by[plan.reason] = by.get(plan.reason, 0) + 1
            return _launch(*args)

        saved.append((mod, mod._launch))
        mod._launch = launch
    try:
        yield out
    finally:
        for mod, launch in saved:
            mod._launch = launch


def run_example(name: str, extra=()) -> tuple[dict, dict]:
    """One example's ``main`` on the card, counted: its launches by kernel
    and variant, the SIMT launches with their planner's reasons, and its
    dispatch report (no fallback, every kernel impl on the card).
    Returns (the example's result, its launch counts)."""
    import importlib
    import time

    from repro_torch import ops
    from repro_torch.kernels import (launch_counts, reset_launch_counts,
                                     variant_counts)

    module = importlib.import_module(f"repro_torch.examples.{name}")
    argv, kernels = EXAMPLES[name]
    torch.cuda.synchronize()
    reset_launch_counts()
    ops.reset_dispatch_report()
    reasons: dict = {}
    t0 = time.perf_counter()
    with simt_reasons(reasons):
        out = module.main(list(argv) + list(extra))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, variants = launch_counts(), variant_counts()
    report = ops.dispatch_report()
    print(f"  {name}: {wall:.2f} s of host wall; launches "
          f"{json.dumps(counts)}; variants {json.dumps(variants)}")
    for kernel, by in reasons.items():
        for why, n in by.items():
            print(f"  {name}: {n} {kernel} launch(es) on simt: {why}")
    for kernel, by in variants.items():
        if by.get("simt", 0) != sum(reasons.get(kernel, {}).values()):
            raise AssertionError(f"{name}: {kernel}'s simt counter "
                                 f"{by.get('simt', 0)} against "
                                 f"{reasons.get(kernel)} planned")
    missing = [k for k in kernels if counts[k] == 0]
    if missing:
        raise AssertionError(f"{name}: {missing} never launched: {counts}")
    for op, entry in report.items():
        off_card = {impl: m for impl, m in entry["modes"].items()
                    if set(m) != {"cuda"}}
        if entry["fallbacks"] or off_card:
            raise AssertionError(f"{name}: dispatch report for {op}: "
                                 f"{entry}")
    print(f"  {name}: dispatch report, every kernel impl on the card, no "
          f"fallback: {json.dumps(report)}")
    out["_wall_s"] = wall
    out["_simt"] = reasons
    return out, counts


def _close(label, got: float, want: float) -> None:
    """A scalar against the CPU run's at ``compare.py``'s float32 rule."""
    from repro_torch.kernels.compare import within_tolerance

    ok = within_tolerance(torch.tensor([got]), torch.tensor([want]),
                          torch.float32)
    print(f"  quickstart {label}: card {got:.6e}, CPU {want:.6e} (float32 "
          f"1e-5+1e-5|ref|: {'ok' if ok else 'FAIL'})")
    if not ok:
        raise AssertionError(f"quickstart {label}: {got} against {want}")


def example_quickstart() -> dict:
    """(a) quickstart at its defaults, against its run on the CPU and the
    M³ViT forward under ``eager`` on the card."""
    from dataclasses import replace as _replace

    from repro_torch import ops
    from repro_torch.configs import get
    from repro_torch.examples import quickstart
    from repro_torch.kernels.compare import cosine
    from repro_torch.models import vit

    out, counts = run_example("quickstart")
    simt = out["_simt"]
    if set(simt) - {"unified_linear"} or sum(
            simt.get("unified_linear", {}).values()) != 1:
        raise AssertionError(f"quickstart: SIMT launches beyond ④'s "
                             f"float32 GEMM: {simt}")
    print("  quickstart on the CPU (the same run's plain versions):")
    cpu = quickstart.main(["--device", "cpu"])
    for key in ("loads", "lut_entries", "queue_sizes", "empty_queues",
                "linear_shape", "softmax_matches"):
        if out[key] != cpu[key]:
            raise AssertionError(f"quickstart {key}: card {out[key]} CPU "
                                 f"{cpu[key]}")
    print(f"  quickstart ⑤ queues {out['queue_sizes']} and ①'s loads "
          f"{out['loads']}, ③'s {out['lut_entries']} entries: equal to the "
          f"CPU run's")
    for key in ("attn_max_diff", "softmax_bias", "softmax_denom",
                "lut_max_err"):
        _close(key, out[key], cpu[key])
    xw, w = (t.cpu().double() for t in cpu["linear_args"])
    check("unified_linear", "quickstart ④ float32 (simt) vs its CPU run",
          out["linear_out"].cpu(), cpu["linear_out"], torch.float32,
          lut_pre=(xw @ w).float())
    cfg = _replace(get("m3vit"), policy=ops.policy_named("eager"))
    params = vit.init_params(0, cfg)
    img = quickstart.m3vit_frame("cuda")
    with torch.inference_mode():
        for task, pred in out["m3vit"].items():
            want = vit.forward(params, img, cfg, task)[0]
            cos = cosine(pred, want)
            ok = bool(torch.isfinite(pred).all()) and cos >= 0.999
            print(f"  quickstart M3ViT[{task}] {tuple(pred.shape)}: finite, "
                  f"cosine vs eager on the card {cos:.6f} (>= 0.999: "
                  f"{'ok' if ok else 'FAIL'}); first call "
                  f"{out['m3vit_wall_s'][task] * 1e3:.2f} ms")
            if not ok:
                raise AssertionError(f"quickstart M3ViT[{task}]: cosine "
                                     f"{cos}")
    return counts


def example_multitask() -> dict:
    """(b) multitask_vit at the paper config, 30 steps and 12 frames."""
    out, counts = run_example("multitask_vit")
    if out["_simt"]:
        raise AssertionError(f"multitask_vit: SIMT launches in a bf16 "
                             f"M3ViT run: {out['_simt']}")
    losses = np.asarray(out["losses"])
    ok = bool(np.isfinite(losses).all()) and losses[-1, 0] < losses[0, 0]
    walls = out["step_walls_s"]
    print(f"  multitask_vit: {len(losses)} steps, semseg CE {losses[0, 0]:.4f}"
          f" -> {losses[-1, 0]:.4f}, depth RMSE {losses[0, 1]:.4f} -> "
          f"{losses[-1, 1]:.4f}, every loss finite and the last CE below the "
          f"first: {'ok' if ok else 'FAIL'}; {statistics.median(walls[1:]) * 1e3:.1f}"
          f" ms a step (median host wall of steps 1-{len(walls) - 1}), step "
          f"0 {walls[0] * 1e3:.1f} ms")
    if not ok:
        raise AssertionError(f"multitask_vit: losses {losses.tolist()}")
    frames = {t: statistics.median(ts) * 1e3 for t, ts in
              out["frame_s"].items()}
    moved = not (out["same_storage"] and out["same_memory"])
    print(f"  multitask_vit: task switch on every frame, median "
          f"{json.dumps({t: round(ms, 3) for t, ms in frames.items()})} ms "
          f"a frame at batch 1; every parameter's storage and "
          f"memory_allocated unchanged over the frames: "
          f"{'FAIL' if moved else 'ok'}; semseg pixel accuracy "
          f"{out['accuracy']:.4f}")
    if moved:
        raise AssertionError("multitask_vit: the task switch moved weights")
    return counts


def _replay_agrees(arch: str, r: dict) -> None:
    """(c) one family's generated tokens, replayed teacher-forced under the
    example's kernel policy (its argmax must give the tokens back) and the
    plain ``eager`` one, held by ``compare.serving_agrees``."""
    from repro_torch import ops
    from repro_torch.examples import serve_lm
    from repro_torch.kernels.compare import cosine, serving_agrees
    from repro_torch.models import model as M
    from repro_torch.train.step import make_serve_step

    engine = r["engine"]
    cfg, params = engine.cfg, engine.params
    prompts = r["prompts"].cuda()
    toks = torch.from_numpy(r["tokens"]).long().cuda()
    b, s0 = prompts.shape
    prefill, decode = engine.steps()
    plain_prefill, plain_decode = make_serve_step(
        replace(cfg, policy=ops.policy_named("eager")))
    kern, plain = [], []
    with torch.inference_mode():
        state = M.init_state(cfg, b, serve_lm.MAX_LEN)
        pstate = M.init_state(cfg, b, serve_lm.MAX_LEN)
        logits, state = prefill(params, prompts, state)
        want, pstate = plain_prefill(params, prompts, pstate)
        for i in range(toks.shape[1]):
            if not torch.equal(torch.argmax(logits, -1), toks[:, i]):
                raise AssertionError(f"serve_lm {arch} step {i}: the "
                                     "replay does not give the tokens back")
            kern.append(logits)
            plain.append(want)
            logits, state = decode(params, toks[:, i:i + 1], state, s0 + i)
            want, pstate = plain_decode(params, toks[:, i:i + 1], pstate,
                                        s0 + i)
        kern.append(logits)
        plain.append(want)
    cos = [cosine(k, p) for k, p in zip(kern, plain)]
    k32 = p32 = None
    if min(cos) < 0.999:
        ref = _float32_replay(cfg, params, prompts, toks, serve_lm.MAX_LEN)
        k32 = [cosine(k, x) for k, x in zip(kern, ref)]
        p32 = [cosine(p, x) for p, x in zip(plain, ref)]
    ok = serving_agrees(cos, k32, p32)
    extra = "" if k32 is None else (
        f"; below 0.999, against the float32 model: kernels min "
        f"{min(k32):.6f}, plain {min(p32):.6f}")
    print(f"  serve_lm {arch}: teacher-forced logits vs eager on the card, "
          f"min cosine {min(cos):.6f} over the prefill and "
          f"{len(cos) - 1} decode steps{extra} (compare.serving_agrees: "
          f"{'ok' if ok else 'FAIL'})")
    if not ok:
        raise AssertionError(f"serve_lm {arch}: kernel logits disagree")


def example_serve() -> dict:
    """(c) serve_lm at its defaults: each family's tokens against eager
    on the card, its decode state's bytes against the CPU's."""
    from repro_torch.examples import serve_lm

    out, counts = run_example("serve_lm")
    for arch in serve_lm.ARCHS:
        r = out[arch]
        cpu = serve_lm.state_bytes(r["engine"].cfg, r["prompts"].shape[0],
                                   "cpu")
        print(f"  serve_lm {arch}: {r['wall_s'] * 1e3:.1f} ms host wall, "
              f"{r['tok_per_s']:.1f} tok/s; {r['kind']} "
              f"{r['state_bytes']} B on the card, {cpu} B on the CPU")
        if r["state_bytes"] != cpu:
            raise AssertionError(f"serve_lm {arch}: state bytes differ")
        _replay_agrees(arch, r)
    return counts


def example_train() -> dict:
    """(d) train_lm, 20 steps of 8 x 128 tokens, from no checkpoint."""
    import shutil

    from repro_torch.examples import train_lm
    from repro_torch.models import model as M

    shutil.rmtree(EXAMPLE_CKPT, ignore_errors=True)
    try:
        out, counts = run_example("train_lm",
                                  ["--ckpt-dir", str(EXAMPLE_CKPT)])
    finally:
        shutil.rmtree(EXAMPLE_CKPT, ignore_errors=True)
    n = sum(p.numel() for p in M.param_specs(train_lm.lm_100m()).values())
    hist = [loss for _, loss in out["history"]]
    ok = (out["params"] == n and not out["resumed"] and len(hist) == 20
          and bool(np.isfinite(hist).all()) and hist[-1] < hist[0]
          and out["nan_skips"] == 0)
    print(f"  train_lm: {out['params']} parameters (lm_100m's {n}), loss "
          f"{hist[0]:.4f} -> {hist[-1]:.4f} over {len(hist)} steps, "
          f"stragglers {out['stragglers']}, nan skips {out['nan_skips']}; "
          f"step wall EMA {out['ema_step_s'] * 1e3:.1f} ms: "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"train_lm: {hist}")
    return counts


def examples_path() -> dict:
    """Phase 12: the four examples' ``main`` in-process on the card, each
    counted and checked.  Returns the launches by kernel, summed."""
    import time

    t_phase = time.perf_counter()
    total: dict = {}
    for part, run in (("(a)", example_quickstart),
                      ("(b)", example_multitask), ("(c)", example_serve),
                      ("(d)", example_train)):
        print(f"  phase 12 {part}")
        for name, c in run().items():
            total[name] = total.get(name, 0) + c
        gc.collect()
        torch.cuda.empty_cache()
    print(f"  phase 12 launches by kernel (kept out of phase 5 and of "
          f"'launches'): {json.dumps(total)}")
    print(f"  phase 12 wall time {time.perf_counter() - t_phase:.1f} s")
    return total


class PhaseWalls:
    """Each phase's host wall time, from its header to the next one's."""

    def __init__(self):
        import time

        self.clock = time.perf_counter
        self.t0 = self.clock()
        self.walls: dict = {}
        self.name, self.since = None, self.t0

    def start(self, title: str, show: bool = True) -> None:
        """Stop the running phase's clock and start ``title``'s (its name
        is what precedes the colon), printing it unless ``show`` is
        false."""
        now = self.clock()
        if self.name is not None:
            self.walls[self.name] = round(now - self.since, 1)
        self.name, self.since = title.split(":", 1)[0], now
        if show:
            print(title)

    def report(self) -> None:
        self.start("end", show=False)
        print(f"  phase walls (s): {json.dumps(self.walls)}; the script "
              f"{self.clock() - self.t0:.1f} s since main started")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "runs the port on an NVIDIA Hopper card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build

    walls = PhaseWalls()
    walls.start("phase 1: card, versions, build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"  torch {torch.__version__} CUDA {torch.version.cuda} python "
          f"{sys.version.split()[0]}; TF32 off for matmul and cuDNN (plain "
          f"versions run in full float32)")
    secs = build.build_seconds()
    print(f"  kernels built and loaded in {secs:.1f} s (nvcc "
          f"{' '.join(build.NVCC_FLAGS)})")
    log = build.build_log()
    for line in log.splitlines():
        if (any(w in line for w in ("entry function", "registers", "spill",
                                    "serialized"))
                and "C7519" not in line) or line.startswith("=="):
            print("   " + line.strip())
    # ptxas serializes the wgmmas of a kernel that issues one under a
    # branch (C7518) or runs short of registers (C7512); the fused MoE
    # source holds no other wgmma kernel than moe_fused_tc_kernel
    fused_log = log.split("== moe_fused.cu", 1)[-1].split("\n== ", 1)[0]
    if "C7518" in fused_log or "serialized" in fused_log:
        raise AssertionError("moe_fused_tc_kernel: ptxas serialized its "
                             "wgmmas")
    print("  moe_fused.cu: no wgmma serialization (C7518, C7512) in its "
          "build log")
    hgmma = build.sass_counts("HGMMA")
    for kernel, n in (("unified_linear_tc_kernel", 18),
                      ("moe_gemm_tc_kernel", 12),
                      ("flash_attention_tc_kernel", 3),
                      ("moe_fused_tc_kernel", 12)):
        found = {k: v for k, v in hgmma.items() if kernel in k}
        if len(found) != n:
            raise AssertionError(f"{kernel}: {len(found)} of {n} instances "
                                 f"issue HGMMA in their SASS")
        print(f"  {kernel}: HGMMA in the SASS of all {n} instances "
              f"({min(found.values())}..{max(found.values())} each)")

    walls.start("phase 2: kernels against their plain versions, made-up "
                "inputs")
    for run_checks in (check_unified_linear, check_unified_linear_rows,
                       check_flash_attention,
                       check_gelu_lut, check_moe_gemm, check_moe_fused,
                       check_decode_fused):
        run_checks()

    units: list[Unit] = []
    walls.start("phase 3: main path, M3ViT serving")
    counts, ctx = main_path(units)
    fused_counts = fused_path(ctx, units)
    paged_path(ctx)
    vision_counts = scheduler_vision(ctx, units)
    packed_path(ctx)

    walls.start("phase 4: LM path, Llama-3.2-1B serving")
    lm_counts, lm_ctx = lm_path(units)
    sched_counts = scheduler_lm(lm_ctx, units)
    packed_lm(lm_ctx)
    counted = {n: counts[n] + fused_counts[n] + lm_counts[n]
               + vision_counts.get(n, 0) + sched_counts.get(n, 0)
               for n in counts}

    walls.start("phase 7: the recurrent families, xLSTM-350M and "
                "RecurrentGemma-9B serving")
    rc_counts, rc_models = recurrent_path(units)
    for n, c in rc_counts.items():
        counted[n] += c

    walls.start("phase 5: the kernels at the main paths' own inputs")
    records = path_records(units, counted)
    del units, ctx, lm_ctx, rc_models
    gc.collect()                # RecurrentGemma's 19 GB before phase 8
    torch.cuda.empty_cache()

    walls.start("phase 8: the remaining configurations — MusicGen-Large, "
                "Phi-4-mini, Qwen1.5-4B, Qwen2-VL-72B, DeepSeek-67B, "
                "Llama-4-Scout, M3ViT-many")
    add_records(records, frontier_path())

    walls.start("phase 6: training, M3ViT and Llama-3.2-1B")
    m3vit_train = train_m3vit()
    torch.cuda.empty_cache()
    lm_train = train_lm()
    for rec in records:
        name = rec["name"]
        trained = m3vit_train[name] + lm_train[name]
        rec["launches"] += trained
        rec["training_launches"] = trained
        rec["training_ms"] = TRAIN_KERNEL_MS.get(name)
    print(f"  training launches per kernel (M3ViT {TRAIN_STEPS} steps + "
          f"Llama {LM_TRAIN[3]} steps, counted runs under cuda): "
          + json.dumps({r["name"]: r["training_launches"] for r in records}))

    torch.cuda.empty_cache()
    walls.start("phase 9: the roofline of the main paths")
    roofline = roofline_path(smi)
    print(f"  roofline per unit: {json.dumps(roofline)}")

    gc.collect()
    torch.cuda.empty_cache()
    walls.start("phases 10-11", show=False)      # mesh_phases prints them
    meshed, trained, tp, tp_train = mesh_phases()
    for rec in records:
        rec["tp_launches"] = tp.get(rec["name"], 0)
        rec["tp_train_launches"] = tp_train.get(rec["name"], 0)
        rec["mesh_launches"] = meshed.get(rec["name"], 0)
        rec["mesh_train_launches"] = trained.get(rec["name"], 0)
        rec["launches"] += rec["mesh_launches"] + rec["mesh_train_launches"]

    gc.collect()
    torch.cuda.empty_cache()
    walls.start("phase 12: the examples — quickstart, multitask_vit, "
                "serve_lm, train_lm")
    examples = examples_path()
    for rec in records:
        rec["example_launches"] = examples.get(rec["name"], 0)

    walls.report()
    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

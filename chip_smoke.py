#!/usr/bin/env python3
"""Drive the PyTorch port's training and serving paths on one CUDA card and
check them.

    python3 chip_smoke.py [--layers N] [--seed S]
    python3 chip_smoke.py --kernels-only [--src DIR]
    python3 chip_smoke.py --quant-only [--src DIR]
    python3 chip_smoke.py --serve-only [--src DIR]
    python3 chip_smoke.py --slo-only
    python3 chip_smoke.py --family-only
    python3 chip_smoke.py --moe-only
    python3 chip_smoke.py --train-long-only
    python3 chip_smoke.py --vlm-only
    python3 chip_smoke.py --hybrid-only
    python3 chip_smoke.py --rwkv-only
    python3 chip_smoke.py --encdec-only
    python3 chip_smoke.py --eval-only
    python3 chip_smoke.py --mesh-only
    python3 chip_smoke.py --mesh-train-only
    python3 chip_smoke.py --mesh-family-only
    python3 chip_smoke.py --dryrun-only
    python3 chip_smoke.py --train-only [--src DIR]

``--kernels-only`` runs phases 1-3b and stops, ``--quant-only`` phases 1,
2, 5 and 8a, ``--slo-only`` phases 1, 2 and 12, ``--family-only`` phases
1, 2, 3b, 13 and 14, ``--moe-only`` phases 1, 2 and 15,
``--train-long-only`` phases 1, 2 and 16, ``--vlm-only`` phases 1, 2 and
17, ``--hybrid-only`` phases 1, 2 and 18, ``--rwkv-only`` phases 1, 2 and
19, ``--encdec-only`` phases 1, 2 and 20, ``--eval-only`` phases 1, 2 and
21, ``--mesh-only`` phases 1, 2 and 22, ``--mesh-train-only`` phases 1, 2
and 23, ``--mesh-family-only`` phases 1, 2 and 24, ``--dryrun-only``
phases 1, 2 and 25, ``--train-only``
phases 1 and 2
and then phase 6's smollm-135m runs A and B, each step split into its
parts (with ``--src``, another tree's, for a same-call A/B of the training
step), ``--serve-only`` phases 1 and 2 and then greedy
waves of the
dense and the paged graph engine (qwen3-4b, at ``--layers``) at mxint8 and
mxint4, a capturing wave and three timed ones each, printing the median
tick wall per kind of tick and a digest of the streams (no result line in
any of them): with ``--src`` naming another tree's ``src`` (one whose
wrappers this script knows), the same measurement of that tree, for an
A/B of two trees in one call on one card.

Phases (any failure exits non-zero before the result line):
  1. the card: name, power limit, device count; TF32 off for matmuls and
     cuDNN;
  2. build every CUDA source of the port (src/repro_torch/csrc/*.cu) with
     nvcc for sm_90a into one library, one nvcc per source started
     together, and print the ptxas register / shared-memory / spill lines;
  3. dequant-GEMM kernels: at every qwen3-4b projection shape, at M = 4
     (decode; the decode body) and 16, 20, 32, 64, 128, 256 (the prefill
     buckets, the speculative verify's 4 x 5 and the mixed tick's 4 x 64;
     the tiled body), each tiled plan
     logged, hold mx_matmul (mxint8, mxfp8) and mx_matmul_int4 (mxint4)
     against their plain PyTorch versions on the same card tensors (rtol
     1e-4, atol 1e-4 * max|plain|: both accumulate in f32, only the
     summation order differs), hold a repeated call and two CUDA-graph
     replays bit-identical at M = 4 and 256, and time the kernel, the
     plain version and torch.matmul of x by the pre-densified bf16 weight
     (the nearest library call; it streams 2x / 4x the weight bytes), one
     layer's sum per M; then both bodies at M = 4, 8, 12, 16 (held to the
     plain version and timed), where DECODE_MAX_M is chosen;
 3b. the same kernels at every starcoder2-3b and qwen2-72b projection
     shape (N = 256 and 1024 for their k / v projections, 12288 and 29568
     for their MLPs), at M = 4 and 256, held against the plain versions at
     the same tolerance and timed beside torch's bf16 matmul and the
     bound, one layer's sum per M;
  4. paged-attention kernels at qwen3-4b attention shapes (H 32, Hkv 8,
     D 128, page 16, bf16 pools of 129 pages, 4 slots, random page
     permutations): paged_attention (B3) at decode lengths, ragged lengths,
     a window, a zero-length row and a long context (cache_len 4096 x 4 on
     its own pool of 1025 pages), paged_attention_mq (B4) at a mixed tick
     and at the speculative verify (4 rows at q_len 5); each case's split
     plan logged (splits, blocks, blocks with pages);
     each held against its plain version (same tolerance), NaN in every
     dead page leaving the output bit-identical, a repeated call, eagerly
     and replayed from a CUDA graph, bit-identical, B4 at q_len 1 agreeing
     with B3; timed beside the plain version, the HBM bound and
     scaled_dot_product_attention on a contiguous copy of the live K/V
     (timing only, not called by the port); NaN in a live page of one row
     through the single walk, the warps' merge and the cross-split merge,
     for B3 and B4: that row exact zeros in kernel and plain version, the
     others bit-identical to the clean call; then B3 and B4 at the head
     layouts no serving phase runs, G = 3 (9 / 3 heads, D 64, smollm-135m)
     and G = 12 (24 / 2, D 128, starcoder2-3b), held against the plain
     version and NaN-poisoned dead pages, and timed;
  5. quantize / fake-quant / Slice-and-Scale kernels: ss_convert (B5) on
     every code byte and int8 scale of each pair below, and its split-N
     mode on every nibble pair; then at every qwen3-4b projection weight
     shape mx_quantize (B6) f32 and bf16 -> mxint8 and mxfp8, ss_convert
     mxint8 -> mxint6 / 4 / 2 (and split-N mxint4) and mxfp8 -> mxfp6 / 4,
     fake_quant (B7) -> mxint4 / mxfp4 / mxint8, and B5-B7 at stacked
     leaves; each bit-identical with its plain version on data with an
     all-zero, a subnormal, a scale-clipping and a +-max block (and B6 /
     B7 on blocks holding +-inf, apart); timed beside the plain version
     and the HBM bound (no single PyTorch call does MX block
     quantization), summed per case over one layer;
  6. training: smollm-135m at full width and depth from random weights,
     seq 512 x batch 8 (one cycled pool of 8 synthetic examples, as the
     paper cycles a small QAT set), run_training through the
     sequential MXINT schedule (8 steps, B7) and the anchored mxint8
     variant (4 interleaved steps, B6 + B5), then qwen3-4b at full width
     and depth 4 (2 direct steps, B7 at its large leaves), all with the
     reference's defaults (flash_vjp, remat); run A once more with both
     off (autograd through prefill_attention), its step beside the
     defaults'; per-step CUDA event times, losses, grad norms, peak memory
     and launch counts equal to what the structure predicts; for
     smollm-135m and qwen3-4b, one step split into its parts (CUDA events)
     and profiled by kernel (torch.profiler);
  7. the pipeline: run B's trained weights -> make_anchor (B6) ->
     save_anchor / load_anchor -> ElasticEngine at mxint8 and mxint4 (B5
     builds it), first-token logits at mxint4 within 5% of max|logit| of
     the trained model's anchored fake-quant forward, 4 greedy requests
     served at each format (B1 / B2);
  8a. format build: from the qwen3-4b MXINT8 anchor below (all 36
     layers), ElasticEngine.weights_for("mxint4") and ("mxint6") on fresh
     engines, timed (host wall, CUDA events, device busy time under
     torch.profiler, rise of the peak allocation), one B5 launch per
     quantized leaf, each tree equal leaf for leaf to the plain versions'
     build (slice_and_scale, pack_leaf_int4; no kernel);
  8. dense serving: qwen3-4b at full width (random weights from a seeded
     generator) -> MXINT8 anchor (B6) -> save_anchor / load_anchor ->
     ElasticEngine(batch_slots=4, max_len=512), logit guard on, every
     decode tick a CUDA-graph replay after the first of its format (the
     default), serves 8 greedy requests at mxint8 and at mxint4 (B5 builds
     it) through the kernels, with launch counts read off the kernel
     wrappers (a replay credits what its capture recorded), no fault
     detected, and the same requests through the densify contract as the
     reference; one decode step replayed as a CUDA graph (the device-time
     floor); the same wave on an eager twin (cuda_graphs=False, the same
     weight trees): streams equal token for token, then each engine's
     wave again, timed (decode tick wall median and range, tok/s, TTFT)
     and under torch.profiler (the card's idle share over the steady
     decode ticks), captures and capture seconds; then a short wave at
     mxint4 with NaN logits planted at scheduler tick 2 while the batch
     runs at mxint4 (FaultInjector): every request completes after exactly
     one escalation, mxint4 -> mxint6 (captured mid-wave), with the tokens
     before the fault equal to the clean wave's, and the eager twin
     escalating the same way to the same streams;
  9. paged serving, at phase 8's depth: ElasticEngine(kv_layout=
     "paged", kv_page_size=16, prefill_chunk=64) — the mixed scheduler,
     every attention read through B3/B4, decode and mixed ticks as CUDA
     graphs — serves the same 8 requests at mxint8 and mxint4; launch
     counts, one executable per tick, balanced pages, the first mixed
     tick's logits against the gather contract, and the eager twin's A/B
     as in 8, over the pure decode and the mixed ticks; sampled waves, and
     chaos at mxint4 (wave A: allocation failure, crash, cancellation,
     deadline; wave B: a NaN page in a decoding row's live pages, which
     B3/B4 turn into zeros, so every request completes, as in the JAX
     engine);
 10. speculative: the dense and the paged graph engines pinned at mxint8
     with SpecConfig(draft_fmt="mxint4", k=4): lane 0 of the first verify
     within 5% of max|logit| of the plain decode tick on the same cache;
     every request complete, pages balanced, 1 <= committed <= k_eff + 1
     per slot and spec tick, launches per draft step and verify attempt,
     an eager twin's streams equal; acceptance, spec ticks, tokens per
     tick, the spec tick wall split into drafts and verify, wave tok/s
     beside plain decode, the streams' agreement with plain decode
     (reported: the verify's M = 20 bodies and B4 round differently from
     the decode body and B3); every draft NaN: one abort, mxint4
     quarantined, plain streams;
 11. preemption: the paged graph engine preempted with a slot
     mid-prefill, snapshot to a temporary directory; a fresh engine's
     resume and the original engine's (no new capture) both equal the
     uninterrupted wave, pages balanced; snapshot bytes, save and resume
     seconds;
 12. SLO serving: a fresh paged graph engine (qwen3-4b, phase 8's depth) with
     FormatPolicy(cost=CostModel.from_roofline(...)) over mxint4 / 6 / 8
     and admission_order="slo" serves one seeded trace of 12 requests (4
     latency-tier with TTFT and TPOT budgets, 4 throughput-tier, 4
     best-effort; arrivals over ticks 0-20 with a burst of four) in
     rounds (SLO_ROUNDS): first at a TPOT budget between the mxint8 and
     mxint4 pure decode ticks, then at one below both. Gates: every
     request complete, pages balanced, admission by tier rank among the
     arrived, launches as the structure predicts, base_s x hbm ==
     weight_bytes per built rung, every pinned rung measured. Printed:
     picks and history, per-tier TTFT against the budget and tok/s, idle
     ticks, each rung's predicted tick beside its measured median and
     its factor;
 13. the rest of the dense family on the dense graph engine: starcoder2-3b
     at full width and depth (gelu MLP, q/k/v and MLP biases) at mxint8
     and mxint4, qwen2-72b at full width and depth QWEN2_LAYERS (q/k/v
     biases) at mxint8: biases raw in the anchor; the prefill's and the
     first decode tick's logits (that tick fed the same token on both
     sides) within 5% of max|logit| of the densify contract; 8 greedy
     requests, launches as the structure predicts, weight-stream bytes
     within 2% of serve_weight_stream_bytes, streams equal to an eager
     twin's; tick wall, tok/s and TTFT;
 14. the serving CLI: ``python3 -m repro_torch.launch.serve --arch
     starcoder2-3b --no-reduced --fmt mxint4`` in a process of its own
     exits 0 with four ``req`` lines;
 15. the MoE family: B1 / B2 at every mixtral-8x7b and mixtral-8x22b
     attention and expert shape at M = 4, 80 and 256, held against their
     plain versions (phase 3's tolerance) and timed beside torch's bf16
     matmul and the bound, one layer's sum per M; mixtral-8x7b at full
     width and depth MOE_LAYERS: an MXINT8 anchor through B6 (one launch
     per stacked leaf, the (G, 8, K, N) expert leaves included; the router
     raw; its peak), the dense graph engine at mxint8 and mxint4 (B5
     builds it), as in 13: the prefill's and the first decode tick's
     logits within 5% of max|logit| of the densify contract in f32 (in
     bf16 reported beside the router picks that differ: a bf16 rounding
     difference can flip a token's experts), B1/B2 launches (4 + 3 x 8) x
     layers per executable, and the rest of 13's gates; then the paged
     graph engine (page 16, prefill_chunk 64, mixed scheduler) at mxint8
     on the 8 requests and one of LONG_PROMPT tokens (max_len
     LONG_MAX_LEN): that request's first decode tick through B3 within 5%
     of the gather contract in f32 (bf16 reported), B3's
     walk the window's pages (pages_read with the window, fewer than
     without), B3 on its pools against its plain version and timed with
     and without the window; launches (B3 / B4 per pure / mixed tick), one
     executable per tick, pages balanced, every request complete, streams
     equal to an eager twin's;
 16. long-sequence training: qwen3-4b at full width and depth 4, seq
     2048 x batch 1, two direct steps in each of the four (flash_vjp,
     remat) settings (step ms, peak); the same at seq 8192 with both on
     (both off would keep >= 17 GB of scores per layer: reckoned, not
     run); mixtral-8x7b at full width, one layer, seq 8192 x batch 1, two
     direct steps through flash_vjp's banded path (the band logged) and
     B7 on the (1, 8, 4096, 14336) expert leaves: finite losses, aux loss
     > 0, step ms, peak, B7 launches as the structure predicts;
 17. the vision-language backbone: llava-next-mistral-7b at full width and
     depth, an MXINT8 anchor (B6) and the packed mxint8 / mxint4 trees
     (B5); 4 requests, each with its own (2880, 4096) image embeddings
     from the seed and a prompt of 16-200 tokens padded to 192 + 256 j
     (prefills of 3072 or 3328 positions), through ``prefill_slot`` into
     a dense cache (max_len 512 + 2880) and into a paged one (pages of
     16, B3), then 16 greedy ``serve_step``s: 224 B1/B2 and (paged) 32
     B3 launches per step; one request's prefill and first decode tick
     within 5% of max|logit| of the densify contract in f32 (the first
     tick of each wave in bf16 reported: the two contracts round each
     projection's output at different places); B1/B2 at each prefill's M
     against the plain versions; prefill ms per request, step wall, peak,
     KV bytes and the dense-against-paged agreement reported; then MF-QAT
     forward +
     backward (B7) at depth 4, batch 1, 2880 + 1216 positions: ms, peak,
     finite loss and gradients;
 18. the hybrid: B1 / B2 at every jamba-1.5-large projection shape (x_proj
     16384 -> 544 with its ragged N edge, in_proj 8192 -> 32768, out_proj,
     attention, MLP and expert shapes) at M = 4 and 256 as in 3b; then
     jamba at full width, its published layers 3-4 (Mamba + 16-expert
     MoE, attention + MLP): an MXINT8 anchor (A_log quantized as the
     reference quantizes it, the other SSM leaves raw), the dense graph
     engine (monolithic unbucketed admission, the sequential scheduler)
     at mxint8 and mxint4 as in 13 with the contracts gated in f32 (58
     B1/B2 launches per executable) and the card's idle share; a row
     poisoned at the anchor rung (the survivors' streams equal the clean
     wave's), a poisoned mxint4 tick escalating to mxint6 with its replay
     from the kept Mamba state (graph == eager, the tokens before the
     fault equal the clean wave's), a mid-wave snapshot resumed on a
     fresh engine (equal to the uninterrupted wave); the state bytes per
     slot; then MF-QAT forward + backward of published layer 2 (Mamba +
     MLP) at seq 2048 and 8192: ms, peak, the longest that runs.
 19. RWKV6: B1 / B2 at every rwkv6-7b projection shape (4096 -> 4096, the
     time mix's five and the channel mix's receptance; 4096 <-> 14336) at
     M = 4 and 256 as in 3b; then rwkv6-7b at full width and depth (32
     layers, 7.53 B parameters): an MXINT8 anchor built leaf by leaf (the
     seven (32, 4096) mix_* leaves quantized along the layer axis, as the
     reference quantizes them, ROADMAP C.11; the decay LoRA, bonus,
     decay_base, ln_scale raw), the dense graph engine (monolithic
     unbucketed admission, the sequential scheduler) at mxint8 and mxint4
     as in 13 with the contracts gated in f32 (256 B1/B2 launches per
     executable), the weight bytes against the term plus
     rwkv_leaf_bytes, the card's idle share and the state bytes per slot
     (wkv f32, shift_t, shift_c); the guard's and the snapshot's waves as
     in 18 (the replay rewinding all three state leaves); then MF-QAT
     forward + backward at depth 4 over seq 2048 and 8192: ms, peak, the
     longest that runs;
 20. the encoder-decoder: B1 / B2 at every seamless-m4t-large-v2
     projection shape (1024 -> 1024; 1024 <-> 8192) at M = 4 and 256;
     then seamless at full width and depth (24 + 24 layers): an MXINT8
     anchor (B6), packed mxint8 / mxint4 trees (B5), the engine's refusal
     (ROADMAP C.12); 4 requests, each with its own (1024, 1024) frame
     embeddings and a prompt of 16-200 tokens, through ``prefill_slot``
     into one dense cache and 16 greedy ``serve_step``s, every projection
     through B1/B2 (384 launches per prefill, 192 per step); one
     request's prefill and first decode tick within 5% of max|logit| of
     the densify contract in f32 (bf16 reported); prefill ms per request,
     the eager step; then MF-QAT forward + backward of the whole model at
     batch 4 x 512 tokens over 2048 frames: ms, peak, finite loss and
     gradients;
 21. the paper's evaluation path: B1 at mxfp6 and mxfp4 at every
     smollm-135m and qwen3-4b projection shape at M = 4 and 256, held
     against the plain version (phase 3's tolerance) and timed beside
     torch's bf16 matmul and the bound, no B2 launch; then Fig. 4's
     protocol on smollm-135m at full width and depth through
     ``train/harness.py`` (HarnessConfig(reduced=False): EVAL_EXAMPLES of
     the reference's 128 examples, seq 64, batch 8, one epoch per format,
     lr 5e-4, from a base pretrained EVAL_PRETRAIN_STEPS of its 600 steps
     at lr 2e-3, batch 16; flash_vjp and remat on): plain multi-format
     MXINT 2/4/6/8, interleaved with an mxint8 anchor, plain multi-format
     MXFP 4/6/8, interleaved with an mxfp8 anchor, each with its step ms (CUDA events), losses and B5 / B6 / B7
     launches per step as the structure predicts; held-out PPL at mxint2-8
     and mxfp4-8, by PTQ (plain) and by anchor + Slice-and-Scale
     (anchored), and the FP base's: the Fig. 4 table with its rel_gap,
     every value finite, PTQ at mxint8 / mxfp8 equal to the anchor route
     within 1e-6 (the same weight values), the plain MXINT variant's
     held-out accuracy; then the mxfp8-anchored weights -> make_anchor (B6)
     -> save_anchor / load_anchor -> the dense graph engine with the MXFP
     ladder (B5 builds mxfp6 / mxfp4) serving 8 greedy requests at mxfp8,
     mxfp6 and mxfp4 as in 13 (7 B1 launches per layer per executable, no
     B2);
 22. replicas, tensor parallelism and gradient compression, qwen3-4b at
     full width and MESH_LAYERS layers: a ReplicaSet(n_replicas=2, tp=1)
     of graph engines and a lone engine serve 8 greedy requests at mxint8
     and mxint4 (streams equal per request, home and partition by rid % 2,
     tok/s of both); then MESH_TP processes on the one card in a gloo
     group (each rebuilds the anchor from the seed: equal digests) run
     ElasticEngine(mesh=make_debug_mesh(1, 2)) — eager ticks, half the
     heads, d_ff and vocabulary each, split-N leaves repacked per shard —
     on the dense and the paged layout (chunked, mixed scheduler) at
     mxint8 and mxint4: greedy streams equal between the ranks and to the
     single-process eager engine's, launches as the structure predicts on
     each rank (B3 / B4 at 4 local kv heads), last-position logits within
     5% of max|logit| of the single process's, per-chip weight bytes
     within 1% of half, the eager tick and the share of a wave spent in
     collectives (timed in a second wave, synchronized); B1 / B2 at every
     rank's shard shapes of one layer at M = 4 and 256 against their plain
     versions (each repacked shard dequantizing to its slice of the whole
     weight), B3 / B4 at (16, 4, 128) as in 4; ef_compress_leaf of a
     (2560, 9728) f32 leaf bit-identical to the plain path with the error
     feedback exact, and compressed_bytes of qwen3-4b against 4 bytes a
     parameter;
 23. the sharded training step and sharded replicas, processes sharing the
     card over gloo (a correctness run, not a sharded speed): qwen3-4b at
     full width and MESH_LAYERS layers, batch 8 x seq 512, f32, direct
     MXINT QAT at mxint4, its masks differing between the row halves, the
     single process's gradients and step, then make_sharded_train_step at
     (1, 2) (tensor parallelism, differentiable collectives) and (2, 1)
     (FSDP): loss and grad norm within MESH_TRAIN_TOL relative of the
     single process's, every gathered gradient leaf within MESH_TRAIN_TOL
     x its max|g|, each process's state bytes about half the whole, the
     step's CUDA-event ms beside the single process's, B7 launches per
     step equal to the single process's; mixtral-8x7b at 1 layer, batch 4,
     at (2, 1) (the Switch balance loss summed over the shards) with the
     same gates; then ReplicaSet(n_replicas=2, tp=2) in four processes
     serving 8 greedy requests at mxint8: every process returns every
     request, homes rid % 2, the set's stats summed, the streams equal to a
     single-process ReplicaSet(2)'s up to near ties (as 22); and the
     sequence-parallel residual: qwen3-4b at MESH_LAYERS layers, (1, 2),
     f32, the forward and backward with ``seq_sharding`` against the same
     two processes with it off: loss, grad norm and every gradient leaf's
     shard in both processes (the gathered tree) bit-identical, B7
     launches equal, rank 0's peak allocation rise over the forward and
     backward below the flag-off one by SP_SAVING_TOL of (tp - 1) / tp of
     the saved group inputs (both printed);
 24. tensor-parallel training of every other family, two processes sharing
     the card over gloo (a correctness run, not a sharded speed), each at
     its published widths, f32, direct MXINT QAT at mxint4, batch 2 x seq
     512 with the two rows' masks differing: mixtral-8x7b at 1 layer
     (expert-parallel, 4 of 8 experts a process), jamba's published layer
     2 (Mamba + MLP, d_inner 16384 split in two), rwkv6-7b at 1 layer (32
     of 64 heads a process), llava at 1 layer behind its 2880-token image
     prefix, seamless at 1 encoder + 1 decoder layer over 1,024 frames;
     make_sharded_train_step at (1, 2) against one process's forward and
     backward: loss and grad norm within MESH_TRAIN_TOL relative, every
     gradient leaf within MESH_TRAIN_TOL x its max|g|, B7 launches equal;
     each process's parameter bytes against the whole and the CUDA-event
     ms beside one process's printed;
 25. the dry run (``launch/dryrun.py``) against the card: qwen3-4b at
     full width and MESH_LAYERS layers, f32, batch 8 x seq 512, one whole
     1 x 1 train step on real zeros on the card (after a warm-up step),
     its FLOPs (FlopCounterMode) and B7 launches equal to the trace's on
     fake ``cuda`` tensors, exactly, and the argument + temp bytes of both
     within DRYRUN_MEM_TOL of the card's peak allocation over the step; a
     w4 decode step (qwen3-4b at MESH_LAYERS layers, 4 rows at 1,024
     positions: B6 anchor, B5 split-N build, B2 in the step; after a
     warm-up cell) the same way, every kernel's launches equal, the
     card's peak taken over the step alone; meanwhile one production
     cell, qwen3-4b train_4k on the 16 x 16 mesh over a fake world of 256
     ranks, at ``baseline`` and at ``sp`` (the sequence-parallel residual;
     its temp bytes below the baseline's), traced on this host by
     ``python -m repro_torch.launch.dryrun`` in a process of its own
     (``meta`` tensors) and both records printed;
     the default process group as it was before the phase.
``--layers N`` serves qwen3-4b at N of its 36 layers in phases 8a-12 and
in the modes that run them alone; the default is QWEN3_LAYERS (20), cut
from 36 to give back the time of phases 22 (28 layers) and 23 (20).
The training phases (6, 16-21) and the llava and seamless prefills print
``launch/costmodel.py::roofline``'s bound for one H100 beside each
measured time, at the depth, width, batch and sequence the phase runs.
The last two lines of standard output are the kernels' JSON record and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import atexit
import bisect
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
BF16_FLOP_PER_S = 989e12         # H100 SXM dense bf16 tensor cores
F32_FLOP_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
# qwen3-4b projections (K, N) and how many of each one layer runs.
PROJ_SHAPES = {(2560, 4096): 1, (2560, 1024): 2, (4096, 2560): 1,
               (2560, 9728): 2, (9728, 2560): 1}
PROJ_PER_LAYER = sum(PROJ_SHAPES.values())          # 7
KERNEL_MS = (4, 16, 20, 32, 64, 128, 256)   # decode (4 slots), then the
#                  prefill buckets the tiled body serves (20 is the
#                  speculative verify's 4 x (k + 1) at k = 4, 256 also the
#                  mixed tick's 4 x 64)
CROSSOVER_MS = (4, 8, 12, 16)   # both bodies, to place DECODE_MAX_M
KERNEL_CASES = (("mx_matmul", "mxint8"), ("mx_matmul", "mxfp8"),
                ("mx_matmul_int4", "mxint4"))
TPU_KERNEL = {
    "mx_matmul": "src/repro/kernels/mx_matmul.py:54 mx_matmul_pallas",
    "mx_matmul_int4": "src/repro/kernels/mx_matmul.py:108 "
                      "mx_matmul_int4_pallas",
    "paged_attention": "src/repro/kernels/paged_attention.py:204 "
                       "paged_attention_pallas",
    "paged_attention_mq": "src/repro/kernels/paged_attention.py:339 "
                          "paged_attention_pallas_mq",
    "ss_convert": "src/repro/kernels/ss_convert.py:49 ss_convert_pallas",
    "mx_quantize": "src/repro/kernels/mx_quantize.py:26 mx_quantize_pallas",
    "fake_quant": "src/repro/kernels/fake_quant.py:25 fake_quant_pallas",
}
# Slice-and-Scale conversions the kernel phase holds B5 to (anchor -> lower)
SS_CASES = (("mxint8", "mxint6"), ("mxint8", "mxint4"), ("mxint8", "mxint2"),
            ("mxfp8", "mxfp6"), ("mxfp8", "mxfp4"))
# smollm-135m's stacked (30, K, N) projection leaves, as training reads them
SMOLLM_LEAVES = ((576, 576), (576, 192), (576, 192), (576, 576),
                 (576, 1536), (576, 1536), (1536, 576))
TRAIN_SEQ, TRAIN_BATCH, TRAIN_LR = 512, 8, 1e-3
PIPE_TOL = 0.05    # served mxint4 first-token logits vs the trained model's
#                    anchored fake-quant forward at mxint4: 5% of max|logit|
FUSED_TOL = 0.05   # max|fused - densify| <= 5% of max|densify| (bf16 rounds
#                    each projection's output at different places); also
#                    max|paged_kernel - gather| on the first mixed tick
# qwen3-4b attention at the serving settings of the paged phase.
ATTN_H, ATTN_HKV, ATTN_D, PAGE, POOL_PAGES, SLOTS, MAX_LEN = \
    32, 8, 128, 16, 129, 4, 512
N_REQ, MAX_NEW, CHUNK = 8, 16, 64
SPEC_K = 4         # self-speculative decoding: mxint4 drafts, k per burst
SPEC_TOL = 0.05    # lane 0 of the first verify vs the plain decode tick's
#                    logits on the same cache: 5% of max|logit|
# the sampled waves: the engine's parameters, and two requests with their own
SAMPLE = dict(seed=0, temperature=0.8, top_p=0.95)
OWN_TEMPERATURE, OWN_TOP_P = (1, 1.2), (2, 0.8)      # (rid, value)
# The rest of the dense family: B1 / B2 held at its projection shapes at
# these M, and served (qwen2-72b at a cut depth that is not a multiple of
# 32, so its stacked (G, n) biases stay raw, as the JAX package keeps them).
FAMILY = ("starcoder2-3b", "qwen2-72b")
FAMILY_MS = (4, 256)
QWEN2_LAYERS = 8
# The MoE family (phase 15): B1 / B2 at both mixtral configs' shapes at
# these M (decode's 4 slots x cap 1; the mixed tick's 4 rows x cap 20 of
# C = 64; a prefill bucket), mixtral-8x7b served at a cut depth, and one
# long request whose decode reads only the sliding window's pages.
MOE = ("mixtral-8x7b", "mixtral-8x22b")
MOE_MS = (4, 80, 256)
MOE_LAYERS = 4
LONG_PROMPT, LONG_NEW, LONG_MAX_LEN = 4608, 16, 4736
# Long-sequence training (phase 16): qwen3-4b at depth 4 over the four
# (flash_vjp, remat) settings, then at seq 8192; mixtral-8x7b at one layer.
LONG_SEQ_LEVERS = (2048, 2)       # (seq, steps) per (flash_vjp, remat)
LONG_SEQ = 8192
# The SLO phase: the paged graph engine (qwen3-4b at --layers) with a cost
# model, serving one seeded trace of 12 requests per round: rounds at a
# latency-tier TPOT budget between the paged pure-decode ticks measured at
# mxint8 and mxint4 at 36 layers (14.44 and 16.34 ms, NVIDIA H100 80GB
# HBM3, 700 W, PERF.md), then rounds at one below both.
SLO_ROUNDS = ((15.4, 3), (11.0, 4))     # (latency TPOT budget ms, rounds)
SLO_TTFT_MS = {"latency": 250.0, "throughput": 2000.0}
SLO_FMTS = ("mxint4", "mxint6", "mxint8")
# The vlm phase (17): llava-next-mistral-7b at full depth, its requests'
# text padded so that each prefill is a multiple of 256 positions.
VLM_REQ, VLM_STEPS, VLM_MAX_LEN = 4, 16, 512
VLM_TRAIN_LAYERS, VLM_TRAIN_TEXT = 4, 1216        # 2880 + 1216 = 4096
# The hybrid phase (18): jamba-1.5-large's published layers 3-4 served,
# layer 2 trained at these lengths; B1/B2 at its shapes at these M.
HYBRID = ("jamba-1.5-large-398b",)
HYBRID_MS = (4, 256)
HYBRID_TRAIN_SEQS = (2048, 8192)
# The RWKV phase (19): rwkv6-7b at full width and depth served, depth
# RWKV_TRAIN_LAYERS trained at these lengths; B1/B2 at its shapes.
RWKV = ("rwkv6-7b",)
RWKV_TRAIN_LAYERS = 4
RWKV_TRAIN_SEQS = (2048, 8192)
# The encoder-decoder phase (20): seamless-m4t-large-v2 at full width and
# depth, ENCDEC_REQ requests with their own ENCDEC_FRAMES frame embeddings
# and ENCDEC_STEPS greedy decode steps; trained at (batch, tokens, frames).
ENCDEC = ("seamless-m4t-large-v2",)
ENCDEC_REQ, ENCDEC_FRAMES, ENCDEC_STEPS = 4, 1024, 16
ENCDEC_TRAIN = (4, 512, 2048)
# The evaluation phase (21): B1 at the MXFP rungs the serving path had not
# run, at smollm-135m's and qwen3-4b's projection shapes; Fig. 4's protocol
# on smollm-135m at full width and depth (train/harness.py, the reference's
# defaults but the base's pretraining steps and the fine-tuning pool's size,
# cut to what the phase's gates need: every format trained, the launches per
# step, PTQ = the anchor route, the MXFP rungs served), then its
# mxfp8-anchored weights served down the MXFP ladder. A quality cell of the
# protocol needs the reference's sizes and a run of its own.
EVAL_ARCHS = ("smollm-135m", "qwen3-4b")
EVAL_CASES = (("mx_matmul", "mxfp6"), ("mx_matmul", "mxfp4"))
EVAL_PRETRAIN_STEPS = 32      # of the reference's 600
EVAL_EXAMPLES = 32            # of its 128: 4 steps a format at batch 8
MXFP_LADDER = ((32, "mxfp4"), (8, "mxfp6"), (0, "mxfp8"))
PPL_ID_TOL = 1e-6      # PTQ at the anchor format vs the anchor route, rel.
# The mesh phase (22): qwen3-4b at full width and this depth, served by a
# ReplicaSet of two single-device replicas and by a tensor-parallel engine
# of MESH_TP processes on the one card (gloo); MX gradient compression of
# one qwen3-4b-sized leaf (w_gate's (2560, 9728)).
MESH_LAYERS, MESH_TP = 4, 2
# qwen3-4b's depth on the serving path (format build, dense and paged
# serving, speculation, preemption, SLO): cut from 36 to give back the
# time of phases 22 and 23 within the script's limit (PERF.md §4).
QWEN3_LAYERS = 20
MESH_GRAD = (2560, 9728)
# The mesh-training phase (23): the sharded step's loss and grad norm
# within this of one process's (relative), each gathered gradient leaf
# within this times its max|g|.
MESH_TRAIN_TOL = 1e-3
# Phase 23's sequence-parallel case: rank 0's peak allocation rise over the
# forward and backward falls, against the flag off, by (tp - 1) / tp of the
# saved group inputs within this share of that amount.
SP_SAVING_TOL = 0.25
# The dry-run phase (25): a trace's argument + temp bytes within this of
# the card's peak allocation over the real step (relative): the caching
# allocator rounds every block up to 512 bytes (the train step's gap was
# -0.012 %). The w4 decode step's cache holds DRYRUN_DECODE positions
# behind 4 rows.
DRYRUN_MEM_TOL = 0.005
DRYRUN_DECODE = 1024
# phase 25's production cell is traced at these variants
DRYRUN_VARIANTS = ("baseline", "sp")
_SMI = [""]     # the card's name and power limit, as nvidia-smi gives them


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_time_ms(fn, n_iter: int) -> float:
    """Device time per call of ``fn(i)``: ``n_iter`` calls captured in one
    CUDA graph, replayed between CUDA events. The graph takes the host's
    launch cost out, so this is the card's time for the work itself."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(2):                      # warm up outside the graph
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_iter):
            fn(i)
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / n_iter
    del graph
    return ms


def _bound(cfg, kind: str, seq: int, batch: int, ms: float) -> str:
    """The least time one H100 could take for the entry point ``kind``
    ("train" or "prefill") of ``cfg`` (at the depth and width the phase
    runs) on ``batch`` sequences of ``seq`` tokens:
    ``launch/costmodel.py::roofline(cfg, ShapeSpec, MeshDesc(1, 1, 1))``'s
    ``step_time_lower_bound``, beside a measured ``ms`` and the share of
    the bound it reaches (bound / measured)."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.costmodel import MeshDesc, roofline
    r = roofline(cfg, ShapeSpec(kind, seq, batch, kind), MeshDesc(1, 1, 1))
    b = 1e3 * r["step_time_lower_bound"]
    return (f"roofline bound {b:.3f} ms ({r['dominant']}, {kind} {batch} x "
            f"{seq}, one H100) against {ms:.2f} ms measured: "
            f"{100 * b / ms:.2f}% of the bound")


# ---------------------------------------------------------------------------
def phase_card():
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    _SMI[0] = smi
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device 0 = {torch.cuda.get_device_name(0)}; "
        f"count = {torch.cuda.device_count()}")
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build():
    from repro_torch.kernels import (build, fake_quant, mx_matmul,
                                     mx_quantize, paged_attention,
                                     ss_convert)
    for mod in (mx_matmul, paged_attention, mx_quantize, fake_quant,
                ss_convert):
        mod.build()
    info = build.build_info
    log(f"build: {', '.join(info['sources'])} in {info['seconds']:.1f} s"
        f"{' (already built)' if info['cached'] else ''} -> {info['path']}")
    for line in info["ptxas"]:
        log(f"  {line.strip()}")


def phase_kernels(seed: int):
    """Per-shape checks and times at every M of ``KERNEL_MS`` (the decode
    body up to ``DECODE_MAX_M``, the tiled body above; 256 is the mixed
    tick's M), and of both bodies at ``CROSSOVER_MS``; a repeated call and
    two CUDA-graph replays bit-identical at M = 4 and 256. Returns the
    per-kernel aggregates over one layer's seven projections, at M = 4 in
    the top level, per M under "by_m" and per body under "crossover"."""
    import torch
    from repro_torch.core.formats import get_format
    from repro_torch.core.mx import dequantize, quantize
    from repro_torch.kernels import mx_matmul, ref
    from repro_torch.serve.packed_params import pack_leaf_int4

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    agg = {}
    log("kernel phase: device ms per call (CUDA graph of many calls, timed "
        "with CUDA events), rotating over weight copies > 50 MB L2")
    log(f"{'kernel':16s}{'fmt':8s}{'M':>4s}{'K':>6s}{'N':>6s}{'max_err':>11s}"
        f"{'ms':>9s}{'plain':>9s}{'torch_bf16':>11s}{'bound':>9s} by")
    for k, n in PROJ_SHAPES:
        w = torch.randn((k, n), generator=gen, device=dev) * 0.02
        for name, fname in KERNEL_CASES:
            t = quantize(w, get_format(fname, 32), axis=0)
            if name == "mx_matmul_int4":
                leaf = pack_leaf_int4(t)
                codes = leaf.packed
                kern, plain = mx_matmul.mx_matmul_int4, ref.ref_mx_matmul_int4
            else:
                codes = t.codes
                kern, plain = mx_matmul.mx_matmul, ref.ref_mx_matmul
            scales = t.scale_exp
            p = mx_matmul.decode_plan(4, k, n, 32, name == "mx_matmul_int4")
            log(f"  {name}[{fname}] K={k} N={n}: decode plan strip "
                f"{p.strip} B, cluster {p.cluster}, {p.blocks} blocks at "
                "M <= 4")
            for m in KERNEL_MS:
                if m <= mx_matmul.DECODE_MAX_M:
                    continue
                p = mx_matmul.tiled_plan(m, k, n, 32,
                                         name == "mx_matmul_int4")
                log(f"  {name}[{fname}] K={k} N={n} M={m}: tiled plan "
                    f"{p.bm}x{mx_matmul.TILED_BN} tiles, cluster "
                    f"{p.cluster}, {p.m_tiles}x{p.n_tiles} tiles, "
                    f"{p.blocks} blocks")
            wbytes = codes.numel() + scales.numel()
            n_copy = max(1, min(64, math.ceil(128e6 / wbytes)))
            copies = [(codes.clone(), scales.clone()) for _ in range(n_copy)]
            w_bf16 = dequantize(t, torch.bfloat16)
            n_dense = max(1, min(16, math.ceil(128e6 / (2 * k * n))))
            dense = [w_bf16.clone() for _ in range(n_dense)]
            for m in KERNEL_MS:
                x = (torch.randn((m, k), generator=gen, device=dev)
                     ).to(torch.bfloat16)
                got = kern(x, codes, scales, t.fmt)
                want = plain(x, codes, scales, t.fmt)
                torch.cuda.synchronize()
                scale = float(want.abs().max())
                err = float((got - want).abs().max())
                if not torch.allclose(got, want, rtol=1e-4,
                                      atol=1e-4 * scale):
                    fail(f"{name}[{fname}] M={m} K={k} N={n}: max abs err "
                         f"{err:.3g} vs max|plain| {scale:.3g}")
                if m in (4, 256) and not _bit_stable(
                        lambda: kern(x, codes, scales, t.fmt), got):
                    fail(f"{name}[{fname}] M={m} K={k} N={n}: a repeated "
                         "call (eager or in a CUDA graph) is not "
                         "bit-identical")
                ms = cuda_time_ms(lambda i: kern(
                    x, copies[i % n_copy][0], copies[i % n_copy][1], t.fmt),
                    50)
                plain_ms = cuda_time_ms(
                    lambda i: plain(x, codes, scales, t.fmt), 5)
                lib_ms = cuda_time_ms(
                    lambda i: torch.matmul(x, dense[i % n_dense]), 50)
                nbytes = wbytes + m * k * 2 + m * n * 4
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = 2 * m * k * n / BF16_FLOP_PER_S * 1e3
                bound = max(t_bytes, t_ops)
                by = "bytes" if t_bytes >= t_ops else "operations"
                log(f"{name:16s}{fname:8s}{m:4d}{k:6d}{n:6d}{err:11.3g}"
                    f"{ms:9.4f}{plain_ms:9.4f}{lib_ms:11.4f}{bound:9.4f} {by}")
                a = agg.setdefault((name, fname), dict(
                    max_abs_err=0.0, max_err=0.0, by_m={}))
                a["max_abs_err"] = max(a["max_abs_err"], err)
                a["max_err"] = max(a["max_err"], err / scale)
                per = a["by_m"].setdefault(m, dict(
                    ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                    t_bytes=0.0, t_ops=0.0))
                mult = PROJ_SHAPES[(k, n)]
                for key, val in (("ms", ms), ("plain_ms", plain_ms),
                                 ("library_ms", lib_ms), ("bound_ms", bound),
                                 ("t_bytes", t_bytes), ("t_ops", t_ops)):
                    per[key] += mult * val
            a = agg[(name, fname)].setdefault("crossover", {})
            for m in CROSSOVER_MS:
                x = (torch.randn((m, k), generator=gen, device=dev)
                     ).to(torch.bfloat16)
                want = plain(x, codes, scales, t.fmt)
                row = a.setdefault(m, {"decode": 0.0, "tiled": 0.0})
                for body in ("decode", "tiled"):
                    got = kern(x, codes, scales, t.fmt, body=body)
                    if not torch.allclose(got, want, rtol=1e-4, atol=1e-4
                                          * float(want.abs().max())):
                        fail(f"{name}[{fname}] M={m} K={k} N={n}: the "
                             f"{body} body disagrees with the plain version")
                    row[body] += PROJ_SHAPES[(k, n)] * cuda_time_ms(
                        lambda i: kern(x, copies[i % n_copy][0],
                                       copies[i % n_copy][1], t.fmt,
                                       body=body), 50)
            del copies, dense
            torch.cuda.empty_cache()
    for (name, fname), a in agg.items():
        a.update(a["by_m"][4])
        for m, per in sorted(a["by_m"].items()):
            log(f"one layer's {PROJ_PER_LAYER} projections at M={m}, "
                f"{name}[{fname}]: {per['ms']:.4f} ms (bound "
                f"{per['bound_ms']:.4f} ms, {100 * per['bound_ms'] / per['ms']:.1f}"
                f"% of it; plain {per['plain_ms']:.4f} ms; torch bf16 "
                f"{per['library_ms']:.4f} ms)")
        for m, row in sorted(a["crossover"].items()):
            log(f"crossover, one layer at M={m}, {name}[{fname}]: decode "
                f"body {row['decode']:.4f} ms, tiled body {row['tiled']:.4f} "
                f"ms (DECODE_MAX_M = {mx_matmul.DECODE_MAX_M})")
    return agg


def _paged_inputs(gen, spans, c: int, pool_pages: int = POOL_PAGES,
                  max_len: int = MAX_LEN, heads=(ATTN_H, ATTN_HKV, ATTN_D)):
    """q (4, c, H, D), bf16 pools (pool_pages, 16, Hkv, D) and a block table
    (4, max_len / 16) of random pages covering spans[i] tokens per row
    (page 0 is scratch); ``heads`` is (H, Hkv, D)."""
    import torch
    dev = torch.device("cuda")
    h, hkv, d = heads
    mp = max_len // PAGE
    q = torch.randn((len(spans), c, h, d), generator=gen,
                    device=dev).to(torch.bfloat16)
    kp, vp = (torch.randn((pool_pages, PAGE, hkv, d), generator=gen,
                          device=dev).to(torch.bfloat16) for _ in range(2))
    perm = torch.randperm(pool_pages - 1, generator=gen, device=dev) + 1
    bt = torch.zeros((len(spans), mp), dtype=torch.int32, device=dev)
    for i, n in enumerate(spans):
        k = -(-n // PAGE)
        bt[i, :k] = perm[i * mp:i * mp + k].to(torch.int32)
    return q, kp, vp, bt


def _poison_dead(kp, vp, bt, spans):
    """NaN in every page no row maps (page 0 included) and past each row's
    frontier inside its last page."""
    kp, vp = kp.clone(), vp.clone()
    table = bt.cpu().numpy()
    used = set(table.flatten().tolist()) - {0}
    dead = [pg for pg in range(kp.shape[0]) if pg not in used]
    kp[dead] = float("nan")
    vp[dead] = float("nan")
    for i, n in enumerate(spans):
        pg, off = n // PAGE, n % PAGE
        if off:
            kp[int(table[i, pg]), off:] = float("nan")
            vp[int(table[i, pg]), off:] = float("nan")
    return kp, vp


def _sdpa_ms(q, length: int):
    """scaled_dot_product_attention on contiguous K/V of ``length`` tokens
    per row (timing only, not called by the port)."""
    import torch
    import torch.nn.functional as F
    b, _, _, d = q.shape
    k, v = (torch.randn((b, ATTN_HKV, length, d), device=q.device,
                        dtype=q.dtype) for _ in range(2))
    qt = q.transpose(1, 2).contiguous()
    return cuda_time_ms(lambda i: F.scaled_dot_product_attention(
        qt, k, v, enable_gqa=True), 50)


def _log_plan(pa, case, q, bt, rows, window):
    """The split plan of one case: its splits, its blocks and how many of
    them have pages to read. ``rows`` are (q_offset, q_len) per slot, B3's
    (cache_len - 1, 1)."""
    c = q.shape[1] if q.ndim == 4 else 1
    mp = bt.shape[1]
    plan = pa.split_plan(q.shape[0], c, ATTN_H, ATTN_HKV, ATTN_D, PAGE, mp,
                         q.element_size())
    live = 0
    for qo, ql in rows:
        for qb in range(plan.nq):
            w = pa.walk(qo, ql, qb, plan.tq, c, PAGE, mp, window)
            if w is not None:
                rows_qb = pa.live_lanes(ql, qb, plan.tq, c) * (ATTN_H
                                                              // ATTN_HKV)
                live += sum(len(pa.split_pages(plan, *w, s, rows_qb)) > 0
                            for s in range(plan.splits))
    grid = plan.grid
    log(f"  {case}: {plan.splits} splits of {plan.pages_per_split} pages "
        f"({plan.tiles_per_split} tile(s), {plan.stages} stage(s)); grid "
        f"{grid} = {grid[0] * grid[1] * grid[2]} blocks, "
        f"{live * ATTN_HKV} with pages to read")


def _bit_stable(fn, first) -> bool:
    """``fn()`` again, then captured in a CUDA graph and replayed twice:
    all bit-identical with ``first``."""
    import torch
    again = fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    graph.replay()
    torch.cuda.synchronize()
    once = captured.clone()
    graph.replay()
    torch.cuda.synchronize()
    ok = torch.equal(again, first) and torch.equal(once, first) \
        and torch.equal(captured, first)
    del graph
    return ok


def phase_paged_kernels(seed: int):
    """B3/B4 checks and times at qwen3-4b attention shapes; returns the
    record of the decode case (B3) and the mixed-tick case (B4)."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    kv_token = 2 * ATTN_HKV * ATTN_D * 2          # K + V bytes, bf16
    out = {}
    log("paged-attention phase: H 32, Hkv 8, D 128, page 16, bf16 pools of "
        "129 pages (1025 at cache_len 4096), 4 slots; device ms per call "
        "(CUDA graph, CUDA events)")
    log(f"{'kernel':20s}{'case':26s}{'max_err':>10s}{'ms':>9s}{'plain':>9s}"
        f"{'sdpa':>9s}{'bound':>9s} by")

    def record(name, case, got, want, ms, plain_ms, lib_ms, nbytes, flops):
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=1e-4, atol=1e-4 * scale):
            fail(f"{name} [{case}]: max abs err {err:.3g} vs max|plain| "
                 f"{scale:.3g}")
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOP_PER_S * 1e3
        by = "bytes" if t_bytes >= t_ops else "operations"
        log(f"{name:20s}{case:26s}{err:10.3g}{ms:9.4f}{plain_ms:9.4f}"
            f"{lib_ms:9.4f}{max(t_bytes, t_ops):9.4f} {by}")
        return dict(max_abs_err=err, max_err=err / scale, ms=ms,
                    plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=max(t_bytes, t_ops), bound_by=by,
                    timed_as=f"{case}, qwen3-4b attention, one layer")

    # ---- B3: decode lengths, ragged lengths, a window, a zero-length row,
    # and a long context on its own pool of 1025 pages (34 MB per pool)
    for case, spans, window, pool_pages, max_len in (
            ("cache_len 200 x4", [200] * 4, None, POOL_PAGES, MAX_LEN),
            ("ragged 1/16/17/511", [1, 16, 17, 511], None, POOL_PAGES,
             MAX_LEN),
            ("window 100, len 200", [200] * 4, 100, POOL_PAGES, MAX_LEN),
            ("with cache_len 0", [0, 200, 37, 511], None, POOL_PAGES,
             MAX_LEN),
            ("cache_len 4096 x4", [4096] * 4, None, 4 * 4096 // PAGE + 1,
             4096)):
        q, kp, vp, bt = _paged_inputs(gen, spans, 1, pool_pages, max_len)
        q = q[:, 0].contiguous()
        cl = torch.tensor(spans, dtype=torch.int32, device="cuda")
        _log_plan(pa, case, q, bt, [(n - 1, 1) for n in spans], window)
        got = pa.paged_attention(q, kp, vp, bt, cl, window)
        want = ref.ref_paged_attention(q, kp, vp, bt, cl, window)
        kp_p, vp_p = _poison_dead(kp, vp, bt, spans)
        dirty = pa.paged_attention(q, kp_p, vp_p, bt, cl, window)
        torch.cuda.synchronize()
        if not torch.equal(got, dirty):
            fail(f"paged_attention [{case}]: NaN in dead pages changed the "
                 "output")
        if not _bit_stable(lambda: pa.paged_attention(q, kp, vp, bt, cl,
                                                      window), got):
            fail(f"paged_attention [{case}]: a repeated call (eager or in "
                 "a CUDA graph) is not bit-identical")
        if 0 in spans and not (got[spans.index(0)] == 0).all():
            fail("paged_attention: a cache_len 0 row is not exact zeros")
        live = sum(min(n, window or n) for n in spans)
        ms = cuda_time_ms(lambda i: pa.paged_attention(q, kp, vp, bt, cl,
                                                       window), 50)
        plain_ms = cuda_time_ms(lambda i: ref.ref_paged_attention(
            q, kp, vp, bt, cl, window), 5)
        lib_ms = _sdpa_ms(q[:, None], max(spans))
        rec = record("paged_attention", case, got, want, ms, plain_ms,
                     lib_ms, live * kv_token + q.numel() * 2 + got.numel() * 4,
                     4 * ATTN_H * ATTN_D * live)
        out.setdefault("paged_attention", rec)
        del kp, vp, kp_p, vp_p

    # ---- B4: a mixed tick — 3 decode rows and a 64-token chunk at 128
    rows = [(200, 1), (150, 1), (17, 1), (128, CHUNK)]
    spans = [o + n for o, n in rows]
    q, kp, vp, bt = _paged_inputs(gen, spans, CHUNK)
    qo = torch.tensor([r[0] for r in rows], dtype=torch.int32, device="cuda")
    ql = torch.tensor([r[1] for r in rows], dtype=torch.int32, device="cuda")
    _log_plan(pa, "mixed tick 3x1 + 64 at 128", q, bt, rows, None)
    got = pa.paged_attention_mq(q, kp, vp, bt, qo, ql)
    want = ref.ref_paged_attention_mq(q, kp, vp, bt, qo, ql)
    kp_p, vp_p = _poison_dead(kp, vp, bt, spans)
    dirty = pa.paged_attention_mq(q, kp_p, vp_p, bt, qo, ql)
    ones = torch.ones_like(ql)
    collapse = pa.paged_attention_mq(q, kp, vp, bt, qo, ones)[:, 0]
    single = pa.paged_attention(q[:, 0].contiguous(), kp, vp, bt, qo + 1)
    torch.cuda.synchronize()
    if not torch.equal(got, dirty):
        fail("paged_attention_mq: NaN in dead pages changed the output")
    if not _bit_stable(lambda: pa.paged_attention_mq(q, kp, vp, bt, qo, ql),
                       got):
        fail("paged_attention_mq: a repeated call (eager or in a CUDA "
             "graph) is not bit-identical")
    if any(not (got[i, n:] == 0).all() for i, (_, n) in enumerate(rows)):
        fail("paged_attention_mq: a dead lane is not exact zeros")
    c_scale = float(single.abs().max())
    if not torch.allclose(collapse, single, rtol=1e-4, atol=1e-4 * c_scale):
        fail("paged_attention_mq at q_len 1 disagrees with paged_attention: "
             f"{float((collapse - single).abs().max()):.3g}")
    log(f"paged_attention_mq at q_len 1 vs paged_attention: max abs diff "
        f"{float((collapse - single).abs().max()):.3g}")
    live_q = sum(n for _, n in rows)
    pairs = sum(o + i + 1 for o, n in rows for i in range(n))
    ms = cuda_time_ms(lambda i: pa.paged_attention_mq(q, kp, vp, bt, qo, ql),
                      50)
    plain_ms = cuda_time_ms(lambda i: ref.ref_paged_attention_mq(
        q, kp, vp, bt, qo, ql), 5)
    lib_ms = _sdpa_ms(q, max(spans))
    out["paged_attention_mq"] = record(
        "paged_attention_mq", "mixed tick 3x1 + 64 at 128", got, want, ms,
        plain_ms, lib_ms,
        sum(spans) * kv_token + live_q * ATTN_H * ATTN_D * 2
        + got.numel() * 4, 4 * ATTN_H * ATTN_D * pairs)
    del kp, vp, kp_p, vp_p

    # ---- B4 at the speculative verify: 4 rows at q_len k + 1
    case = f"verify 4x{SPEC_K + 1} at decode lengths"
    rows = [(200, SPEC_K + 1), (150, SPEC_K + 1), (17, SPEC_K + 1),
            (506, SPEC_K + 1)]
    spans = [o + n for o, n in rows]
    q, kp, vp, bt = _paged_inputs(gen, spans, SPEC_K + 1)
    qo = torch.tensor([r[0] for r in rows], dtype=torch.int32, device="cuda")
    ql = torch.tensor([r[1] for r in rows], dtype=torch.int32, device="cuda")
    _log_plan(pa, case, q, bt, rows, None)
    got = pa.paged_attention_mq(q, kp, vp, bt, qo, ql)
    want = ref.ref_paged_attention_mq(q, kp, vp, bt, qo, ql)
    kp_p, vp_p = _poison_dead(kp, vp, bt, spans)
    if not torch.equal(got, pa.paged_attention_mq(q, kp_p, vp_p, bt, qo,
                                                  ql)):
        fail(f"paged_attention_mq [{case}]: NaN in dead pages changed the "
             "output")
    pairs = sum(o + i + 1 for o, n in rows for i in range(n))
    rec = record(
        "paged_attention_mq", case, got, want,
        cuda_time_ms(lambda i: pa.paged_attention_mq(q, kp, vp, bt, qo, ql),
                     50),
        cuda_time_ms(lambda i: ref.ref_paged_attention_mq(
            q, kp, vp, bt, qo, ql), 5), _sdpa_ms(q, max(spans)),
        sum(spans) * kv_token + q.numel() * 2 + got.numel() * 4,
        4 * ATTN_H * ATTN_D * pairs)
    out["paged_attention_mq"]["verify_q_len_5"] = {
        k: rec[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms",
                            "bound_ms", "bound_by")}
    del kp, vp, kp_p, vp_p
    _nan_live_page(gen, pa, ref)
    _paged_other_heads(gen, pa, ref)
    torch.cuda.empty_cache()
    return out


def _nan_live_page(gen, pa, ref):
    """NaN in the first page of one row (every live query of the row sees
    it: its sum is NaN), through each epilogue that divides by the sum —
    the single walk (one key slice per warp: more than 32 query rows,
    here 64 heads over 1 kv head, D 64), the warps' merge (qwen3-4b heads,
    a short row in one split) and the cross-split merge (cache_len 4096) —
    for B3 and for B4 at q_len 5: that row exact zeros in every head and
    lane, as the plain version and the Pallas kernels give (where(l > 0,
    out, 0)); every other row bit-identical to the clean call and within
    tolerance of the plain version."""
    import torch
    c = SPEC_K + 1
    for case, heads, spans, victim, max_len, pool in (
            ("single walk", (64, 1, 64), [200, 40, 17, 100], 1, MAX_LEN,
             POOL_PAGES),
            ("warp merge", (ATTN_H, ATTN_HKV, ATTN_D), [200, 40, 17, 100], 1,
             MAX_LEN, POOL_PAGES),
            ("split merge", (ATTN_H, ATTN_HKV, ATTN_D), [4096, 300, 40, 3001],
             0, 4096, 4 * 4096 // PAGE + 1)):
        h, hkv, d = heads
        q, kp, vp, bt = _paged_inputs(gen, spans, c, pool, max_len, heads)
        kp_n, vp_n = kp.clone(), vp.clone()
        page = int(bt[victim, 0])
        kp_n[page] = float("nan")
        vp_n[page] = float("nan")
        q1 = q[:, 0].contiguous()
        cl = torch.tensor(spans, dtype=torch.int32, device="cuda")
        qo = cl - c
        ql = torch.full_like(cl, c)
        for name, lanes, run, plain in (
                ("paged_attention", 1,
                 lambda k, v: pa.paged_attention(q1, k, v, bt, cl),
                 lambda k, v: ref.ref_paged_attention(q1, k, v, bt, cl)),
                ("paged_attention_mq", c,
                 lambda k, v: pa.paged_attention_mq(q, k, v, bt, qo, ql),
                 lambda k, v: ref.ref_paged_attention_mq(q, k, v, bt, qo,
                                                         ql))):
            plan = pa.split_plan(len(spans), lanes, h, hkv, d, PAGE,
                                 bt.shape[1], q.element_size())
            first, last = pa.walk(spans[victim] - lanes, lanes, 0, plan.tq,
                                  lanes, PAGE, bt.shape[1])
            rows = plan.tq * (h // hkv)
            n_splits = sum(1 for s in range(plan.splits)
                           if pa.split_pages(plan, first, last, s, rows))
            if (n_splits > 1) != (case == "split merge") \
                    or (rows > 32) != (case == "single walk") or first:
                fail(f"{name} NaN live page [{case}]: the case runs "
                     f"{n_splits} split(s) of {rows} query rows")
            clean, got, want = run(kp, vp), run(kp_n, vp_n), plain(kp_n,
                                                                   vp_n)
            torch.cuda.synchronize()
            others = [i for i in range(len(spans)) if i != victim]
            if not (torch.equal(got[victim], torch.zeros_like(got[victim]))
                    and torch.equal(want[victim],
                                    torch.zeros_like(want[victim]))):
                fail(f"{name} NaN live page [{case}]: the row is not exact "
                     f"zeros (kernel: {int(got[victim].isnan().sum())} NaN, "
                     f"max {float(got[victim].nan_to_num().abs().max()):.3g})")
            if not torch.equal(got[others], clean[others]):
                fail(f"{name} NaN live page [{case}]: another row changed")
            scale = float(want[others].abs().max())
            err = float((got[others] - want[others]).abs().max())
            if not torch.allclose(got[others], want[others], rtol=1e-4,
                                  atol=1e-4 * scale):
                fail(f"{name} NaN live page [{case}]: max abs err {err:.3g} "
                     f"vs max|plain| {scale:.3g}")
            log(f"{name} NaN in a live page [{case}, {n_splits} split(s), "
                f"{rows} query rows]: the row exact zeros in kernel and "
                f"plain; other rows bit-identical to the clean call, max abs "
                f"err {err:.3g}")
        del q, kp, vp, kp_n, vp_n


def _paged_other_heads(gen, pa, ref, layouts=(("G 3, D 64", (9, 3, 64)),
                                               ("G 12, D 128",
                                                (24, 2, 128)))):
    """B3 and B4 at head layouts (H, Hkv, D) the qwen3-4b serving phases do
    not run (default: G = 3, smollm-135m's 9 query heads over 3 kv heads,
    D 64, and G = 12, starcoder2-3b's 24 over 2, D 128). Each held against
    its plain version (same tolerance), NaN in every dead page leaving it
    bit-identical, dead lanes exact zeros; timed beside the plain
    version."""
    import torch
    log(f"{'kernel':20s}{'case':26s}{'max_err':>10s}{'ms':>9s}{'plain':>9s}")
    for label, heads in layouts:
        # B3 rows are (cache_len - 1, 1): one of cache_len 0
        for name, rows in (
                ("paged_attention", [(199, 1), (-1, 1), (36, 1), (510, 1)]),
                ("paged_attention_mq", [(200, 1), (150, 1), (17, 1),
                                        (128, CHUNK)])):
            spans = [o + n for o, n in rows]
            c = CHUNK if name == "paged_attention_mq" else 1
            q, kp, vp, bt = _paged_inputs(gen, spans, c, heads=heads)
            kp_p, vp_p = _poison_dead(kp, vp, bt, spans)
            qo = torch.tensor([r[0] for r in rows], dtype=torch.int32,
                              device="cuda")
            ql = torch.tensor([r[1] for r in rows], dtype=torch.int32,
                              device="cuda")
            if c == 1:
                q = q[:, 0].contiguous()
                cl = torch.tensor(spans, dtype=torch.int32, device="cuda")
                run = lambda k, v: pa.paged_attention(q, k, v, bt, cl)
                plain = lambda: ref.ref_paged_attention(q, kp, vp, bt, cl)
            else:
                run = lambda k, v: pa.paged_attention_mq(q, k, v, bt, qo, ql)
                plain = lambda: ref.ref_paged_attention_mq(q, kp, vp, bt, qo,
                                                           ql)
            got, want, dirty = run(kp, vp), plain(), run(kp_p, vp_p)
            torch.cuda.synchronize()
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            if not torch.allclose(got, want, rtol=1e-4, atol=1e-4 * scale):
                fail(f"{name} [{label}]: max abs err {err:.3g} vs "
                     f"max|plain| {scale:.3g}")
            if not torch.equal(got, dirty):
                fail(f"{name} [{label}]: NaN in dead pages changed the "
                     "output")
            if c > 1 and any(not (got[i, n:] == 0).all()
                             for i, (_, n) in enumerate(rows)):
                fail(f"{name} [{label}]: a dead lane is not exact zeros")
            if c == 1 and not (got[1] == 0).all():
                fail(f"{name} [{label}]: a cache_len 0 row is not zeros")
            ms = cuda_time_ms(lambda i: run(kp, vp), 50)
            plain_ms = cuda_time_ms(lambda i: plain(), 5)
            log(f"{name:20s}{label:26s}{err:10.3g}{ms:9.4f}{plain_ms:9.4f}")
            del q, kp, vp, kp_p, vp_p


def _plant_edge_blocks(v, bs: int = 32, inf: bool = False):
    """Plant five edge blocks, blocked along K, twice in v (..., K, N): in
    the first K-block of the first slice (columns 0-4) and in the last
    K-block of the last slice (columns N-5..N-1), so that a stacked leaf's
    outer offset and scale index meet them too. Of each five: all zeros,
    subnormal, a block with max in [2^-126, 2^-120) (its scale clips to
    -127 at 8 bits), values in [-1, 1] (with ``inf``, +inf and -inf among
    them), and +-the largest finite bf16 (finite in f32 and in bf16)."""
    import torch
    gen = torch.Generator(device=v.device).manual_seed(7)
    k, n = v.shape[-2:]
    big = torch.finfo(torch.bfloat16).max
    for lead, rows, c0 in (((0,) * (v.ndim - 2), slice(0, bs), 0),
                           ((-1,) * (v.ndim - 2), slice(k - bs, k), n - 5)):
        v[lead + (rows, c0)] = 0.0
        v[lead + (rows, c0 + 1)] = torch.randn(
            bs, generator=gen, device=v.device) * 1e-40
        v[lead + (rows, c0 + 2)] = (torch.rand(
            bs, generator=gen, device=v.device) * 2 - 1) * 2.0 ** -123
        v[lead + (rows.start, c0 + 2)] = 2.0 ** -121
        v[lead + (rows, c0 + 3)] = torch.rand(
            bs, generator=gen, device=v.device) * 2 - 1
        if inf:
            v[lead + (rows.start + 1, c0 + 3)] = float("inf")
            v[lead + (rows.start + 2, c0 + 3)] = float("-inf")
        v[lead + (rows, c0 + 4)] = big
        v[lead + (rows.start, c0 + 4)] = -big
    return v


def _inf_gate(ops):
    """B6 and B7 on blocks holding +-inf (two qwen3-4b projection shapes
    and a stacked leaf): bit-identical with the plain versions, whose
    frexp gives inf the exponent 0 (fault C.5: the kernels gave such a
    block another scale)."""
    import torch
    from repro_torch.core.formats import get_format
    from repro_torch.core.mx import quantize
    gen = torch.Generator(device="cuda").manual_seed(11)
    cases = 0
    for shape in [(2560, 1024), (9728, 2560), (3, 256, 160)]:
        axis = len(shape) - 2
        w = _plant_edge_blocks(torch.randn(shape, generator=gen,
                                           device="cuda"), inf=True)
        for dtype in (torch.float32, torch.bfloat16):
            wd = w.to(dtype)
            for fname in ("mxint8", "mxfp8", "mxfp4"):
                fmt = get_format(fname, 32)
                got, want = ops.mx_quantize(wd, fmt, axis), quantize(
                    wd, fmt, axis)
                if not (torch.equal(got.codes, want.codes)
                        and torch.equal(got.scale_exp, want.scale_exp)):
                    fail(f"mx_quantize {dtype} -> {fname} {shape}: blocks "
                         "holding inf differ from the plain version")
                cases += 1
        for fname, out_dtype in (("mxint4", torch.bfloat16),
                                 ("mxfp4", torch.bfloat16),
                                 ("mxint8", torch.float32)):
            for ste in (False, True):
                kw = dict(out_dtype=out_dtype, ste=ste)
                fmt = get_format(fname, 32)
                got = ops.fake_quant(w, fmt, axis, **kw)
                want = ops.fake_quant_plain(w, fmt, axis, **kw)
                if not torch.equal(_bits(got), _bits(want)):
                    fail(f"fake_quant -> {fname} ste={ste} {shape}: blocks "
                         "holding inf differ from the plain version")
                cases += 1
    log(f"+-inf gate: {cases} B6 / B7 cases bit-identical with the plain "
        "versions")


def _bits(t):
    import torch
    return t.view({torch.bfloat16: torch.int16, torch.float32: torch.int32,
                   torch.int8: torch.int8, torch.uint8: torch.uint8}[t.dtype])


def _all_codes(high: str):
    """(256, 512) codes blocked along axis 0 at bs 32: column j of row r
    holds byte (j + r) % 256, column j + 256 byte (2j + r) % 256, so every
    code byte occurs and every (low, high) nibble pair of the split-N
    layout; (512, 8) scales running over the whole int8 range."""
    import torch
    from repro_torch.core.formats import get_format
    from repro_torch.core.mx import MXTensor
    j = torch.arange(512, device="cuda")
    r = torch.arange(256, device="cuda")[:, None]
    codes = ((j * (1 + (j >= 256)) + r) % 256).to(torch.uint8)
    if high.startswith("mxint"):
        codes = codes.view(torch.int8)
    scales = (torch.arange(4096, device="cuda") % 256 - 128).to(
        torch.int8).reshape(512, 8)
    return MXTensor(codes=codes, scale_exp=scales, fmt=get_format(high, 32),
                    block_axis=0)


def _ss_exhaustive(ops):
    """B5 against its plain version on every code byte and every int8 scale
    of each SS_CASES pair; the split-N mode on every nibble pair."""
    import torch
    from repro_torch.core.formats import get_format
    from repro_torch.core.slice_scale import slice_and_scale
    from repro_torch.serve.packed_params import pack_leaf_int4
    for high, low in SS_CASES:
        t, lo = _all_codes(high), get_format(low, 32)
        got, want = ops.ss_convert(t, lo), slice_and_scale(t, lo)
        if not (torch.equal(got.codes, want.codes)
                and torch.equal(got.scale_exp, want.scale_exp)):
            fail(f"ss_convert {high} -> {low}: not bit-identical with its "
                 "plain version over all 256 codes")
    t, lo = _all_codes("mxint8"), get_format("mxint4", 32)
    packed, scales = ops.ss_convert_int4_splitn(t, lo)
    want = pack_leaf_int4(slice_and_scale(t, lo))
    if not (torch.equal(packed, want.packed)
            and torch.equal(scales, want.scale_exp)):
        fail("ss_convert split-N mxint8 -> mxint4: not bit-identical with "
             "its plain version over all 65536 nibble pairs")
    log(f"ss_convert exhaustive: all 256 codes and int8 scales of "
        f"{len(SS_CASES)} pairs bit-identical, split-N all 65536 nibble "
        "pairs too")


def phase_quant_kernels(seed: int):
    """B6 / B7 / B5 at every qwen3-4b projection weight shape, and at the
    stacked leaves the main path gives them in one launch each (every
    smollm-135m leaf, one qwen3-4b leaf): bit identity with the plain
    versions on the same card tensors (edge blocks planted; +-inf in a gate
    of its own), B5 over every code byte, device ms beside the HBM bound.
    Returns each kernel's record, summed over one qwen3-4b layer's seven
    projection weights at the main path's settings — B6 f32 -> mxint8 (the
    anchor export), B7 f32 -> bf16 mxint4 with the straight-through epilogue
    (the direct-QAT forward), B5 mxint8 -> mxint4 (the anchored QAT step) —
    with every other case's layer sum under "by_case"."""
    import torch
    from repro_torch.core.formats import get_format
    from repro_torch.core.mx import quantize
    from repro_torch.core.slice_scale import slice_and_scale
    from repro_torch.kernels import ops
    from repro_torch.serve.packed_params import pack_leaf_int4

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    fused = ops.ss_convert_int4_splitn
    log("quantize / fake-quant / Slice-and-Scale phase: bit identity with "
        "the plain versions; device ms per call (CUDA graph, CUDA events), "
        "rotating over copies > 128 MB")
    _ss_exhaustive(ops)
    _inf_gate(ops)
    log(f"{'kernel':12s}{'case':26s}{'shape':>18s}{'ms':>9s}{'plain':>9s}"
        f"{'bound':>9s}  GB/s")
    main_case = {"mx_quantize": "f32 -> mxint8",
                 "fake_quant": "f32 -> mxint4 bf16 STE",
                 "ss_convert": "mxint8 -> mxint4"}
    agg = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, t_bytes=0.0,
                   t_ops=0.0, max_abs_err=0.0, by_case={})
           for k in main_case}

    def check_time(name, case, shape, got, want, kern, plain, nbytes,
                   flops, layer_mult):
        same = all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want))
        if not same:
            fail(f"{name} [{case}] {shape}: not bit-identical with its plain "
                 "version")
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))
        agg[name]["max_abs_err"] = max(agg[name]["max_abs_err"], err)
        ms = cuda_time_ms(kern, 50)
        plain_ms = cuda_time_ms(plain, 3)
        # the f32 operations the case does over the f32 CUDA-core peak
        # (B6 / B7: a few dozen per element, 32 reckoned; B5: none, a code
        # is a table lookup), against the bytes over HBM
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOP_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        log(f"{name:12s}{case:26s}{str(tuple(shape)):>18s}{ms:9.4f}"
            f"{plain_ms:9.4f}{bound:9.4f}  {nbytes / ms / 1e6:.0f}")
        if not layer_mult:
            return
        per = agg[name]["by_case"].setdefault(case, dict(
            ms=0.0, plain_ms=0.0, bound_ms=0.0))
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("bound_ms", bound)):
            per[key] += layer_mult * val
        if case == main_case[name]:
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("bound_ms", bound), ("t_bytes", t_bytes),
                             ("t_ops", t_ops)):
                agg[name][key] += layer_mult * val

    def copies_of(t, nbytes):
        n = max(1, min(16, math.ceil(128e6 / nbytes)))
        return [t.clone() for _ in range(n)]

    lo4 = get_format("mxint4", 32)
    for k, n in PROJ_SHAPES:
        mult = PROJ_SHAPES[(k, n)]
        w = _plant_edge_blocks(torch.randn((k, n), generator=gen,
                                           device=dev) * 0.02)
        nel, nsc = k * n, k * n // 32
        for dtype, vb in ((torch.bfloat16, 2), (torch.float32, 4)):
            wd = w.to(dtype)
            ws = copies_of(wd, vb * k * n)
            dn = "bf16" if vb == 2 else "f32"
            for fname in ("mxint8", "mxfp8"):
                fmt = get_format(fname, 32)
                got, want = ops.mx_quantize(wd, fmt, 0), quantize(wd, fmt, 0)
                check_time("mx_quantize", f"{dn} -> {fname}", (k, n),
                           (got.codes, got.scale_exp),
                           (want.codes, want.scale_exp),
                           lambda i: ops.mx_quantize(ws[i % len(ws)], fmt, 0),
                           lambda i: quantize(wd, fmt, 0),
                           vb * nel + nel + nsc, 32 * nel, mult)
            del ws
        ws = copies_of(w, 4 * k * n)
        for fname in ("mxint8", "mxfp8"):
            fmt = get_format(fname, 32)
            anchor = ops.mx_quantize(w, fmt, 0)
            cs = copies_of(anchor.codes, nel)
            ts = [type(anchor)(codes=c, scale_exp=anchor.scale_exp,
                               fmt=fmt, block_axis=0) for c in cs]
            for high, low in SS_CASES:
                if high != fname:
                    continue
                lo = get_format(low, 32)
                got_s = ops.ss_convert(anchor, lo)
                want_s = slice_and_scale(anchor, lo)
                check_time("ss_convert", f"{high} -> {low}", (k, n),
                           (got_s.codes, got_s.scale_exp),
                           (want_s.codes, want_s.scale_exp),
                           lambda i: ops.ss_convert(ts[i % len(ts)], lo),
                           lambda i: slice_and_scale(anchor, lo),
                           2 * (nel + nsc), 0, mult)
            if fname == "mxint8":
                want_p = pack_leaf_int4(slice_and_scale(anchor, lo4))
                check_time("ss_convert", "mxint8 -> mxint4 split-N", (k, n),
                           fused(anchor, lo4),
                           (want_p.packed, want_p.scale_exp),
                           lambda i: fused(ts[i % len(ts)], lo4),
                           lambda i: pack_leaf_int4(
                               slice_and_scale(anchor, lo4)),
                           nel + nel // 2 + 2 * nsc, 0, mult)
            del cs, ts
        for fname, out_dtype in (("mxint4", torch.bfloat16),
                                 ("mxfp4", torch.bfloat16),
                                 ("mxint8", torch.float32)):
            fmt = get_format(fname, 32)
            kw = dict(out_dtype=out_dtype, ste=True)
            obytes = 2 if out_dtype == torch.bfloat16 else 4
            check_time("fake_quant", f"f32 -> {fname} "
                       f"{'bf16' if obytes == 2 else 'f32'} STE", (k, n),
                       (ops.fake_quant(w, fmt, 0, **kw),),
                       (ops.fake_quant_plain(w, fmt, 0, **kw),),
                       lambda i: ops.fake_quant(ws[i % len(ws)], fmt, 0, **kw),
                       lambda i: ops.fake_quant_plain(w, fmt, 0, **kw),
                       (4 + obytes) * nel, 32 * nel, mult)
        del w, ws
        torch.cuda.empty_cache()
    # B7 as the training step runs it: one launch per stacked leaf
    fmt = get_format("mxint4", 32)
    for k, n in sorted(set(SMOLLM_LEAVES)):
        w = _plant_edge_blocks(torch.randn((30, k, n), generator=gen,
                                           device=dev) * 0.02)
        kw = dict(out_dtype=torch.bfloat16, ste=True)
        check_time("fake_quant", "smollm stacked, mxint4 STE", w.shape,
                   (ops.fake_quant(w, fmt, 1, **kw),),
                   (ops.fake_quant_plain(w, fmt, 1, **kw),),
                   lambda i: ops.fake_quant(w, fmt, 1, **kw),
                   lambda i: ops.fake_quant_plain(w, fmt, 1, **kw),
                   6 * w.numel(), 32 * w.numel(), 0)
    # B6 and B5 as make_anchor, convert, the format build and run B's
    # anchored fake-quant run them: the whole stacked leaf in one launch,
    # blocked along axis 1
    anc = get_format("mxint8", 32)
    stacked = [(30, k, n) for k, n in sorted(set(SMOLLM_LEAVES))] \
        + [(36, 2560, 1024)]
    for shape in stacked:
        w = _plant_edge_blocks(torch.randn(shape, generator=gen, device=dev)
                               * 0.02)
        ws = copies_of(w, 4 * w.numel())
        nel, nsc = w.numel(), w.numel() // 32
        got, want = ops.mx_quantize(w, anc, 1), quantize(w, anc, 1)
        check_time("mx_quantize", "stacked, f32 -> mxint8", shape,
                   (got.codes, got.scale_exp), (want.codes, want.scale_exp),
                   lambda i: ops.mx_quantize(ws[i % len(ws)], anc, 1),
                   lambda i: quantize(w, anc, 1), 5 * nel + nsc, 32 * nel, 0)
        got_s, want_s = ops.ss_convert(got, lo4), slice_and_scale(got, lo4)
        check_time("ss_convert", "stacked, mxint8 -> mxint4", shape,
                   (got_s.codes, got_s.scale_exp),
                   (want_s.codes, want_s.scale_exp),
                   lambda i: ops.ss_convert(got, lo4),
                   lambda i: slice_and_scale(got, lo4), 2 * (nel + nsc), 0,
                   0)
        want_p = pack_leaf_int4(want_s)
        check_time("ss_convert", "stacked, split-N mxint4", shape,
                   fused(got, lo4), (want_p.packed, want_p.scale_exp),
                   lambda i: fused(got, lo4),
                   lambda i: pack_leaf_int4(slice_and_scale(got, lo4)),
                   nel + nel // 2 + 2 * nsc, 0, 0)
        del w, ws, got, want, got_s, want_s
    torch.cuda.empty_cache()
    for name, a in agg.items():
        log(f"one qwen3-4b layer's {PROJ_PER_LAYER} projection weights, "
            f"{name}: {a['ms']:.4f} ms (bound {a['bound_ms']:.4f} ms, "
            f"{100 * a['bound_ms'] / a['ms']:.1f}% of it; plain "
            f"{a['plain_ms']:.4f} ms)")
        for case, per in a["by_case"].items():
            share = 100 * per["bound_ms"] / per["ms"]
            log(f"  {name} [{case}], one layer: {per['ms']:.4f} ms, bound "
                f"{per['bound_ms']:.4f} ms ({share:.1f}% of it), plain "
                f"{per['plain_ms']:.4f} ms")
    return agg


def _profiled(fn):
    """Run ``fn()`` once under torch.profiler: (its result, the kernels it
    ran on the card as (ms, count, name) by device time, the profiler).
    Only the events that ran on the card count: the operator rows above
    them would count the same time twice."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kernels = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                      for e in prof.key_averages()
                      if getattr(e, "device_type", None) == DeviceType.CUDA
                      and e.self_device_time_total > 0), reverse=True)
    return out, kernels, prof


def _plain_leaves(anchor, fmt_name: str):
    """The served leaves by the plain versions, no kernel: each whole
    stacked leaf through ``slice_and_scale``, 4-bit MXINT then packed by
    ``pack_leaf_int4``. Slice-and-Scale is elementwise on codes and
    blockwise on scales, so this is also what the per-layer build made.
    The reference for the format build, not the main path."""
    from repro_torch.core.formats import get_format
    from repro_torch.core.slice_scale import slice_and_scale
    from repro_torch.serve.packed_params import pack_leaf_int4
    out = {}
    for path, t in anchor.quantized.items():
        low = get_format(fmt_name, t.fmt.block_size)
        leaf = slice_and_scale(t, low)
        if low.kind == "int" and low.bits == 4:
            leaf = pack_leaf_int4(leaf)
            out[path] = (leaf.packed, leaf.scale_exp)
        else:
            out[path] = (leaf.codes, leaf.scale_exp)
    return out


def phase_format_build(cfg, anchor):
    """ElasticEngine.weights_for("mxint4") and ("mxint6") from the qwen3-4b
    MXINT8 anchor, each on a fresh engine: one warm-up build, then three
    timed (host wall to a synchronize, CUDA events around the call, the
    rise of max_memory_allocated over what was allocated before and what
    the tree keeps), one under torch.profiler (device busy time, kernel
    count). Gates: B5 launched once per quantized leaf, and the tree equal,
    leaf for leaf, to the plain versions' build. Returns the B5 / B6 / B7
    launches of one build per format (the other builds repeat it for
    timing)."""
    import numpy as np
    import torch
    from repro_torch.core.tree import flatten_paths
    from repro_torch.models.transformer import make_model
    from repro_torch.serve.engine import ElasticEngine

    api = make_model(cfg)
    n_leaves = len(anchor.quantized)
    log(f"format-build phase: {cfg.name}, {cfg.n_layers} layers, "
        f"{n_leaves} quantized leaves, anchor {anchor.fmt_name}; B5 "
        f"launches per build {n_leaves}")
    totals = {}
    for fmt in ("mxint4", "mxint6"):
        walls, events, rises, held = [], [], [], []
        for rep in range(5):
            eng = ElasticEngine(api, anchor, batch_slots=SLOTS,
                                max_len=MAX_LEN, device="cuda")
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _reset_quant_launches()
            if rep == 4:
                tree, kernels, prof = _profiled(lambda: eng.weights_for(fmt))
                busy_ms = sum(k[0] for k in kernels)
                n_kernels = sum(k[1] for k in kernels)
                top = sorted(prof.key_averages(),
                             key=lambda e: -e.self_cpu_time_total)[:6]
                log(f"format build {fmt}, host time by op (profiled "
                    "build): " + ", ".join(
                        f"{e.key} {e.self_cpu_time_total / 1e3:.2f} ms "
                        f"x{e.count}" for e in top))
            else:
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                t0 = time.perf_counter()
                start.record()
                tree = eng.weights_for(fmt)
                end.record()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if rep:                                  # rep 0 warms up
                    walls.append(1e3 * wall)
                    events.append(start.elapsed_time(end))
                    rises.append((torch.cuda.max_memory_allocated() - base)
                                 / 1e9)
                    held.append((torch.cuda.memory_allocated() - base) / 1e9)
            counts = _quant_launches()
            if counts["ss_convert"] != n_leaves or counts["mx_quantize"] \
                    or counts["fake_quant"]:
                fail(f"format build {fmt}: launches {counts}, want "
                     f"{n_leaves} ss_convert")
            if rep == 0:
                for kname, v in counts.items():
                    totals[kname] = totals.get(kname, 0) + v
            if rep < 4:
                del eng, tree
        ref = _plain_leaves(anchor, fmt)
        leaves = dict(flatten_paths(tree))
        for path, want in ref.items():
            leaf = leaves[path]
            got = (leaf.packed, leaf.scale_exp) if hasattr(leaf, "packed") \
                else (leaf.codes, leaf.scale_exp)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                fail(f"format build {fmt}: leaf {path} differs from the "
                     "plain versions' build")
        log(f"format build {fmt}: host wall {np.round(walls, 3)} ms, CUDA "
            f"events {np.round(events, 3)} ms, device busy {busy_ms:.3f} ms "
            f"over {n_kernels} kernels (profiled build), peak allocation "
            f"rise {np.round(rises, 3)} GB of which the tree keeps "
            f"{np.round(held, 3)} GB; {n_leaves} leaves equal to the plain "
            "versions' build")
        del eng, tree, ref, leaves
        torch.cuda.empty_cache()
    return totals


def _quant_launches():
    from repro_torch.kernels import fake_quant, mx_quantize, ss_convert
    return {**mx_quantize.launches, **fake_quant.launches,
            **ss_convert.launches}


def _restore_fake_quant(count: int) -> None:
    """Set B7's count back to ``count``: launches made to measure, not by
    the run being counted."""
    from repro_torch.kernels import fake_quant
    fake_quant.launches["fake_quant"] = count


def _reset_quant_launches():
    from repro_torch.kernels import fake_quant, mx_quantize, ss_convert
    for mod in (mx_quantize, fake_quant, ss_convert):
        mod.reset_launches()


def _n_proj_leaves(cfg) -> int:
    """Stacked projection leaves a train step fake-quantizes: attention's
    4 and the MLP's 3 (SwiGLU) or 2 (gelu), or a MoE layer's 3 expert
    leaves, per in-group layer. Written out here, not read off the tree,
    so that an older tree's run (``--train-only --src``) counts the same."""
    n = 0
    for j in range(cfg.scan_group):
        moe = getattr(cfg, "moe_experts", 0) > 0 and \
            j % cfg.moe_every == cfg.moe_offset
        n += 4 + (3 if moe or getattr(cfg, "act", "swiglu") == "swiglu"
                  else 2)
    return n


def _train(label, cfg, qat, schedule, steps, seed, seq=TRAIN_SEQ,
           batch=TRAIN_BATCH):
    """``run_training`` from random weights on the card, each step timed
    with CUDA events around the train step; gates: finite losses and grad
    norms, and B5 / B6 / B7 launched exactly as the structure predicts
    (fake-quant of the 7 stacked projection leaves once per step: B7 per
    direct step off the pass-through branch, B6 per anchored step, B5 per
    anchored step whose target is not the anchor). Returns (final state,
    history, launches, step ms (CUDA events), peak allocated GB)."""
    import numpy as np
    import torch
    from repro_torch.data.pipeline import DataConfig, LMDataset
    from repro_torch.models.transformer import make_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import LoopConfig, make_schedule, run_training
    from repro_torch.train.state import build_train_step

    api = make_model(cfg, qat=qat)
    opt = AdamWConfig(lr=TRAIN_LR)
    # one pool of TRAIN_BATCH examples, cycled (the paper cycles a small
    # QAT set of 128): every step sees the same batch, so a few steps show
    # the loss falling instead of batch-to-batch noise
    data = LMDataset(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                global_batch=batch, seed=seed,
                                n_examples=batch))
    inner = build_train_step(api, opt)
    events = []

    def timed_step(state, batch, fmt_idx):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = inner(state, batch, fmt_idx)
        end.record()
        events.append((start, end))
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_quant_launches()
    out = run_training(api, data, opt, LoopConfig(total_steps=steps,
                                                  schedule=schedule),
                       step_fn=timed_step, seed=seed, device="cuda")
    torch.cuda.synchronize()
    counts = _quant_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    hist = out["history"]
    ms = [s.elapsed_time(e) for s, e in events]
    n_fmt = len(qat.formats)
    sched = make_schedule(schedule, n_fmt, steps)
    leaves = _n_proj_leaves(cfg)
    quantized = [int(i) for i in sched if i < n_fmt]
    if qat.anchor is None:
        want = {"fake_quant": leaves * len(quantized), "mx_quantize": 0,
                "ss_convert": 0}
    else:
        moved = [i for i in quantized if qat.formats[i] != qat.anchor]
        want = {"fake_quant": 0, "mx_quantize": leaves * steps,
                "ss_convert": leaves * len(moved)}
    for h, t in zip(hist, ms):
        fmt = qat.formats[h["fmt_idx"]] if h["fmt_idx"] < n_fmt else "fp"
        log(f"{label} step {h['step']} fmt {fmt}: "
            f"loss {h['loss']:.4f}, grad norm {h['grad_norm']:.4f}, "
            f"{t:.2f} ms (CUDA events), {1e3 * h['sec']:.2f} ms host wall")
    log(f"{label}: {cfg.name} layers={cfg.n_layers} d={cfg.d_model} "
        f"seq {seq} x batch {batch}; step ms {np.round(ms, 2)}; "
        f"steady-state mean {np.mean(ms[1:]):.2f} ms; peak allocated "
        f"{peak:.2f} GB; launches {counts} (want {want}); "
        + _bound(cfg, "train", seq, batch, float(np.mean(ms[1:]))))
    if not all(np.isfinite([h["loss"] for h in hist] +
                           [h["grad_norm"] for h in hist])):
        fail(f"{label}: a loss or grad norm is not finite")
    if counts != want:
        fail(f"{label}: kernel launches {counts}, want {want}")
    return out["state"], hist, counts, ms, peak


def _step_breakdown(label, cfg, qat, state, seed, fmt_idx=1):
    """Where one train step's device time goes, from the state a run left:
    CUDA-event times of its parts (the fake-quant of the 7 projection
    leaves, forward with the loss, forward and backward, AdamW) and of the
    whole step, and torch.profiler's device time by kernel over one step,
    summed by kind, beside that step time (the card's busy share)."""
    import torch
    from repro_torch.core.tree import flatten_paths, unflatten_paths
    from repro_torch.data.pipeline import DataConfig, LMDataset
    from repro_torch.models.transformer import fake_quant_blocks, make_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_update
    from repro_torch.train.state import build_train_step

    api = make_model(cfg, qat=qat)
    opt = AdamWConfig(lr=TRAIN_LR)
    data = LMDataset(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                global_batch=TRAIN_BATCH, seed=seed,
                                n_examples=TRAIN_BATCH))
    batch = {k: torch.from_numpy(v).to("cuda")
             for k, v in data.batch_at(0).items()}
    flat = flatten_paths(state.params)
    leaves = [p.detach().requires_grad_(True) for _, p in flat]
    params = unflatten_paths({k: p for (k, _), p in zip(flat, leaves)})

    def event_ms(fn, reps=3):
        out = fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps, out

    quant_ms, _ = event_ms(lambda: fake_quant_blocks(qat, fmt_idx, params,
                                                     cfg))
    fwd_ms, _ = event_ms(lambda: api.train_loss(params, batch, fmt_idx)[0])
    fb_ms, grads = event_ms(lambda: torch.autograd.grad(
        api.train_loss(params, batch, fmt_idx)[0], leaves))
    grads = unflatten_paths({k: g for (k, _), g in zip(flat, grads)})
    # the timed calls drop their new trees at once (a state each)
    opt_ms, _ = event_ms(lambda: (adamw_update(state.params, grads,
                                               state.opt, opt), None)[1])
    del grads, params, leaves
    torch.cuda.empty_cache()
    log(f"{label} step parts (CUDA events, fmt {qat.formats[fmt_idx]}): "
        f"fake-quant of the 7 leaves {quant_ms:.2f} ms, forward + loss "
        f"{fwd_ms:.2f} ms, forward + backward {fb_ms:.2f} ms, AdamW "
        f"{opt_ms:.2f} ms")

    step = build_train_step(api, opt)
    step_ms, _ = event_ms(lambda: (step(state, batch, fmt_idx), None)[1],
                          reps=2)
    _, kernels, _ = _profiled(lambda: step(state, batch, fmt_idx))
    total = sum(k[0] for k in kernels)
    groups = {}
    for ms, _, name in kernels:
        low = name.lower()
        kind = ("B5/B6/B7" if any(k in low for k in (
                    "fake_quant", "mx_quantize", "ss_convert"))
                else "GEMM f32" if any(k in low for k in (
                    "f32f32", "sgemm"))
                else "GEMM bf16" if any(k in low for k in (
                    "gemm", "xmma", "cutlass", "bf16bf16"))
                else "reductions" if any(k in low for k in (
                    "reduce", "softmax", "norm", "logsumexp"))
                else "elementwise" if "elementwise" in low
                else "other")
        groups[kind] = groups.get(kind, 0.0) + ms
    log(f"{label} train step (fmt {qat.formats[fmt_idx]}): {step_ms:.2f} ms "
        f"(CUDA events); kernel time {total:.2f} ms over "
        f"{sum(k[1] for k in kernels)} kernels, "
        f"{100 * total / step_ms:.0f}% of the step; by kind: "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(
            groups.items(), key=lambda kv: -kv[1])))
    for ms, count, name in kernels[:8]:
        log(f"  {ms:9.2f} ms {100 * ms / max(total, 1e-9):5.1f}% x{count:<5d} "
            f"{name[:90]}")
    if not kernels:
        log(f"{label}: the profiler saw no kernel; the CUDA-event parts "
            "above stand alone")


def phase_training(seed: int):
    """smollm-135m at full width and depth through both QAT variants, then
    qwen3-4b at full width and depth 4 through direct QAT. Returns run B's
    trained master weights and every run's launches."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.formats import TRAIN_FORMATS_MXINT
    from repro_torch.core.qat import QATConfig

    cfg = get_config("smollm-135m")
    log(f"training phase: {cfg.name} (all {cfg.n_layers} layers, d "
        f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, tied head), seq {TRAIN_SEQ} x batch "
        f"{TRAIN_BATCH} (one pool of {TRAIN_BATCH} synthetic examples, "
        f"cycled), AdamW lr {TRAIN_LR}, random init from seed {seed}")
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    direct = QATConfig(formats=TRAIN_FORMATS_MXINT)
    state_a, hist_a, counts, ms_a, _ = _train(
        "run A (sequential MXINT 2/4/6/8, 2 steps each)", cfg, direct,
        "multiformat", 8, seed)
    add(counts)
    if not hist_a[-1]["loss"] < hist_a[0]["loss"]:
        fail(f"run A: last loss {hist_a[-1]['loss']} not below the first "
             f"{hist_a[0]['loss']}")
    _step_breakdown("smollm-135m", cfg, direct, state_a, seed)
    del state_a
    # run A once more on the path before flash_vjp and remat (autograd
    # through prefill_attention, nothing recomputed): the defaults' price
    plain = dataclasses.replace(cfg, flash_vjp=False, remat=False)
    _, _, counts, ms_p, _ = _train(
        "run A, flash_vjp and remat off", plain, direct, "multiformat", 8,
        seed)
    add(counts)
    log(f"run A steady-state step: {np.mean(ms_a[1:]):.2f} ms with "
        f"flash_vjp and remat (the defaults), {np.mean(ms_p[1:]):.2f} ms "
        "without (CUDA events, one call)")
    state_b, hist_b, counts, _, _ = _train(
        "run B (anchored mxint8, interleaved targets)", cfg,
        QATConfig(formats=TRAIN_FORMATS_MXINT, anchor="mxint8"),
        "interleaved", 4, seed + 1)
    add(counts)
    if not hist_b[-1]["loss"] < hist_b[0]["loss"]:
        fail(f"run B: last loss {hist_b[-1]['loss']} not below the first "
             f"{hist_b[0]['loss']}")
    trained = state_b.params
    del state_b
    torch.cuda.empty_cache()

    big = dataclasses.replace(get_config("qwen3-4b"), n_layers=4)
    log(f"DEPTH CUT: qwen3-4b training runs {big.n_layers} of 36 layers "
        "(widths unchanged)")
    state_q, _, counts, _, _ = _train("qwen3-4b direct MXINT", big, direct,
                                      "multiformat", 2, seed + 2)
    add(counts)
    _step_breakdown("qwen3-4b depth 4", big, direct, state_q, seed + 2)
    del state_q
    torch.cuda.empty_cache()
    return cfg, trained, totals


def phase_pipeline(cfg, trained, seed: int):
    """The paper's pipeline end to end on run B's trained master weights:
    make_anchor (B6) -> save_anchor / load_anchor -> ElasticEngine at
    mxint8 and mxint4 (the mxint4 tree built by B5) serving 4 greedy
    requests on the dense layout (B1 / B2). Gate: the served first-token
    logits at mxint4 within 5% of max|logit| of the trained model's own
    forward under the anchored fake-quant at mxint4 (the same weight values
    by construction). Returns the B5 / B6 launches."""
    import numpy as np
    import torch
    from repro_torch.checkpoint.anchor_ckpt import load_anchor, save_anchor
    from repro_torch.core.anchor import make_anchor
    from repro_torch.core.formats import TRAIN_FORMATS_MXINT
    from repro_torch.core.qat import QATConfig
    from repro_torch.kernels import mx_matmul
    from repro_torch.kernels.dispatch import make_qmm
    from repro_torch.models.transformer import fake_quant_blocks, make_model
    from repro_torch.serve.engine import ElasticEngine, Request

    log("pipeline phase: trained weights -> anchor -> Slice-and-Scale -> "
        "serve")
    _reset_quant_launches()
    anchor = make_anchor(trained, QATConfig(anchor="mxint8"), device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        nbytes = save_anchor(os.path.join(tmp, "anchor"), anchor)
        del anchor
        anchor = load_anchor(os.path.join(tmp, "anchor"), device="cuda")
    api = make_model(cfg)
    eng = ElasticEngine(api, anchor, batch_slots=SLOTS, max_len=256,
                        device="cuda")
    w4 = eng.weights_for("mxint4")
    eng.weights_for("mxint8")
    torch.cuda.synchronize()
    counts = _quant_launches()
    log(f"anchor {nbytes / 1e6:.1f} MB; make_anchor + format builds "
        f"launched {counts}")
    # make_anchor: one B6 launch per projection leaf; the mxint4 build: one
    # B5 launch per leaf (the mxint8 build is the anchor itself)
    want = {"mx_quantize": PROJ_PER_LAYER, "ss_convert": PROJ_PER_LAYER,
            "fake_quant": 0}
    if counts != want:
        fail(f"pipeline: kernel launches {counts}, want {want}")

    rng = np.random.default_rng(seed + 5)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in (24, 40, 57, 80)]
    qat = QATConfig(formats=TRAIN_FORMATS_MXINT, anchor="mxint8")
    with torch.no_grad():
        ref_params = fake_quant_blocks(qat, qat.formats.index("mxint4"),
                                       trained, cfg)
    kapi = api.with_qmm(make_qmm("kernel"))
    worst = 0.0
    for p in prompts:
        batch = {"tokens": torch.as_tensor(p[None], device="cuda")}
        cache = kapi.init_cache(1, 256, device="cuda")
        served, _, _ = kapi.prefill_slot(w4, batch, cache, 0)
        cache = api.init_cache(1, 256, device="cuda")
        ref, _, _ = api.prefill_slot(ref_params, batch, cache, 0)
        diff = float((served.float() - ref.float()).abs().max())
        top = float(ref.float().abs().max())
        worst = max(worst, diff / top)
        log(f"prompt {len(p)}: served mxint4 vs anchored fake-quant forward "
            f"max|diff| {diff:.4g}, max|logit| {top:.4g}, argmax "
            f"{int(served.argmax())} vs {int(ref.argmax())}")
        if not (torch.isfinite(served).all() and diff <= PIPE_TOL * top):
            fail(f"pipeline: served logits differ by {diff:.4g} > "
                 f"{PIPE_TOL} * {top:.4g}")
    for fmt in ("mxint8", "mxint4"):
        reqs = [Request(rid=i, prompt=p, max_new=MAX_NEW)
                for i, p in enumerate(prompts)]
        mx_matmul.reset_launches()
        t0 = time.perf_counter()
        eng.generate(reqs, fmt_override=fmt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        bad = [r.rid for r in reqs if r.status.value != "completed"
               or len(r.out_tokens) != MAX_NEW]
        log(f"pipeline {fmt}: {len(reqs)} requests x {MAX_NEW} tokens in "
            f"{wall:.2f} s; launches {dict(mx_matmul.launches)}")
        if bad or not any(mx_matmul.launches.values()):
            fail(f"pipeline {fmt}: requests {bad} incomplete or no "
                 "dequant-GEMM launched")
    log(f"pipeline gate: worst max|diff| / max|logit| {worst:.4f} "
        f"(limit {PIPE_TOL})")
    del eng, anchor, w4, ref_params
    torch.cuda.empty_cache()
    return counts


def _requests(vocab: int, seed: int):
    import numpy as np
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(
        0, vocab, size=int(rng.integers(16, 201))).astype(np.int32),
        max_new=MAX_NEW) for i in range(N_REQ)]


def qwen3_4b(n_layers: int):
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config("qwen3-4b")
    if n_layers != cfg.n_layers:
        log(f"DEPTH CUT: qwen3-4b runs {n_layers} of {cfg.n_layers} layers "
            "(widths unchanged)")
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return cfg


def build_anchor(cfg, seed: int, save: bool = True):
    """Random weights from a seeded generator -> MXINT8 anchor ->
    save_anchor / load_anchor (unless ``save`` is false), on the card."""
    import torch
    from repro_torch.checkpoint.anchor_ckpt import load_anchor, save_anchor
    from repro_torch.core.anchor import make_anchor
    from repro_torch.core.qat import QATConfig
    from repro_torch.models.transformer import init_params

    log(f"model: {cfg.name} d_model={cfg.d_model} "
        f"layers={cfg.n_layers} heads={cfg.n_heads}/{cfg.n_kv_heads} "
        f"head_dim={cfg.hd} d_ff={cfg.d_ff} vocab={cfg.vocab}")
    t0 = time.perf_counter()
    params = init_params(cfg, seed, device="cuda")
    anchor = make_anchor(params, QATConfig(anchor="mxint8"), device="cuda")
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"init + make_anchor: {time.perf_counter() - t0:.1f} s")
    if not save:
        return anchor
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        nbytes = save_anchor(os.path.join(tmp, "anchor"), anchor)
        t_save = time.perf_counter() - t0
        del anchor
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        anchor = load_anchor(os.path.join(tmp, "anchor"), device="cuda")
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    log(f"anchor checkpoint: {nbytes / 1e9:.3f} GB, save {t_save:.1f} s, "
        f"load {t_load:.1f} s")
    return anchor


def _twin(eng, **kw):
    """An engine with ``eng``'s model, anchor and knobs, and ``kw`` on top,
    that serves ``eng``'s own weight trees: no second format build, so the
    count of builds stands (a build it needs, it adds to them all)."""
    from repro_torch.serve.engine import ElasticEngine
    twin = ElasticEngine(eng.api, eng.anchor, batch_slots=eng.slots,
                         max_len=eng.max_len, kv_layout=eng.kv_layout,
                         kv_page_size=eng.kv_page_size,
                         prefill_chunk=eng.prefill_chunk, device="cuda", **kw)
    twin._weights = eng._weights
    return twin


def _eager_twin(eng, **kw):
    """``_twin`` that runs every tick eagerly (``cuda_graphs=False``)."""
    return _twin(eng, cuda_graphs=False, **kw)


def _timed_wave(eng, reqs, fmt: str, greedy: bool = True) -> float:
    """``eng.generate(reqs)``, host seconds to a synchronize."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(reqs, greedy=greedy, fmt_override=fmt)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _check_same_streams(what: str, got, want) -> None:
    a = [r.out_tokens for r in got]
    b = [r.out_tokens for r in want]
    if a != b:
        fail(f"{what}: streams differ under CUDA graphs and eagerly: "
             f"{a} vs {b}")


def _tick_wall(trace, pick) -> str:
    """Median and range of the host wall of the ticks ``pick`` selects."""
    import numpy as np
    ms = [1e3 * t["wall_s"] for t in trace if pick(t)]
    return (f"median {np.median(ms):.2f} ms ({min(ms):.2f}-{max(ms):.2f}, "
            f"n {len(ms)})")


def _profile_events(fn):
    """Run ``fn()`` under torch.profiler (CPU and CUDA activity) and return
    the trace's events as ``export_chrome_trace`` writes them (parsing that
    file is much faster than ``prof.events()`` on a wave's worth)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _idle_share(events, trace, pick):
    """The card's idle share over the ticks ``pick`` selects from
    ``trace``, read from the profile of the wave that wrote it: the
    engine's ``ElasticEngine.tick`` ranges on the host are its ticks in
    order, and the card is busy where any of its activities (kernels,
    copies, fills) overlaps one. Returns (idle share, ticks, profiled tick
    mean ms)."""
    span_of = lambda e: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
    ticks = sorted(span_of(e) for e in events
                   if e.get("name") == "ElasticEngine.tick"
                   and e.get("cat") == "user_annotation")
    if len(ticks) != len(trace):
        fail(f"profile holds {len(ticks)} tick ranges for {len(trace)} "
             "ticks")
    busy = sorted(span_of(e) for e in events
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    wins = [w for w, t in zip(ticks, trace) if pick(t)]
    if len(wins) < 8:
        fail(f"idle share wants at least 8 steady ticks, got {len(wins)}")
    if not busy:
        fail("the profile saw no activity on the card")
    span = on = 0.0
    for lo, hi in wins:
        span += hi - lo
        end = lo
        # the union of the activity in [lo, hi]; a tick ends in a
        # synchronize, so no activity of an earlier tick reaches into it
        first = max(bisect.bisect_left(busy, (lo,)) - 1, 0)
        for a, b in busy[first:]:
            if a >= hi:
                break
            a, b = max(a, end), min(b, hi)
            if b > a:
                on += b - a
                end = b
    return 1 - on / span, len(wins), span / len(wins) / 1e3


def _graph_vs_eager(label, geng, greqs, make_reqs, fmt, picks):
    """The wave ``geng`` (CUDA graphs) just served as ``greqs``, on an
    eager twin: greedy streams equal token for token. The twin's wave is
    timed; so is a second wave of ``geng`` (no capture and one replay per
    tick: the keys are known); then each serves it once more under
    torch.profiler. Logs tick wall (median, range), tok/s, TTFT and, per
    kind of tick in ``picks`` ({kind: trace predicate}), the card's busy
    ms per profiled tick and its idle share, eager against graph."""
    t_ab = time.perf_counter()
    st = geng.stats()
    log(f"{label} {fmt}: the graph engine has captured "
        f"{st['graph_captures']} tick(s) in {st['graph_capture_s']:.3f} s "
        f"and replayed {st['graph_replays']}")
    for mode, eng in (("eager", _eager_twin(geng)), ("graph", geng)):
        before = eng.stats()
        reqs = make_reqs()
        wall = _timed_wave(eng, reqs, fmt)
        _check_same_streams(f"{label} {fmt} {mode}", reqs, greqs)
        after = eng.stats()
        replays = after["graph_replays"] - before["graph_replays"]
        ticks = after["ticks"] - before["ticks"]
        if after["graph_captures"] != before["graph_captures"] or \
                replays != (ticks if mode == "graph" else 0):
            fail(f"{label} {fmt} {mode}: a wave of known keys made "
                 f"{after['graph_captures'] - before['graph_captures']} "
                 f"captures and {replays} replays over {ticks} ticks")
        trace = list(eng.tick_trace)
        total = sum(len(r.out_tokens) for r in reqs)
        t_prof = time.perf_counter()
        events = _profile_events(
            lambda: eng.generate(make_reqs(), fmt_override=fmt))
        t_prof = time.perf_counter() - t_prof
        idle = []
        for kind, pick in picks.items():
            share, n, mean_ms = _idle_share(events, eng.tick_trace, pick)
            idle.append(f"{kind} {100 * share:.1f}% over {n} ticks, busy "
                        f"{(1 - share) * mean_ms:.2f} ms of a profiled tick "
                        f"of {mean_ms:.2f} ms")
        log(f"{label} {fmt} {mode}: " + "; ".join(
            f"{kind} tick {_tick_wall(trace, pick)}"
            for kind, pick in picks.items())
            + f"; wave {total} tokens in {wall:.3f} s = {total / wall:.1f} "
            f"tok/s, TTFT s {[round(r.ttft_s, 3) for r in reqs]}; card "
            "idle (torch.profiler): " + "; ".join(idle)
            + f"; profiled wave and trace read in {t_prof:.1f} s")
        del events
    log(f"{label} {fmt}: graph-vs-eager A/B in "
        f"{time.perf_counter() - t_ab:.1f} s")


def phase_serving(cfg, anchor, seed: int):
    """Dense KV layout, monolithic admission; returns the B1/B2 launch
    counts, each format's greedy streams and the graph engine."""
    import torch
    from repro_torch.kernels import mx_matmul
    from repro_torch.kernels.dispatch import make_qmm
    from repro_torch.models.transformer import make_model
    from repro_torch.serve.engine import ElasticEngine

    log(f"dense serving phase: {cfg.n_layers} layers")
    api = make_model(cfg)
    fused = ElasticEngine(api, anchor, batch_slots=SLOTS, max_len=MAX_LEN,
                          device="cuda")
    dense = ElasticEngine(api, anchor, batch_slots=SLOTS, max_len=MAX_LEN,
                          fused=False, device="cuda")
    launches, streams = {}, {}
    for fmt, kernel in (("mxint8", "mx_matmul"),
                        ("mxint4", "mx_matmul_int4")):
        weights = fused.weights_for(fmt)           # build outside the timing
        dense.weights_for(fmt)
        # ---- first-step logits: kernel contract vs the densify contract
        prompt = _requests(cfg.vocab, seed)[0].prompt
        batch = {"tokens": torch.as_tensor(prompt[None], device="cuda")}
        got = {}
        for mode in ("kernel", "densify"):
            mapi = api.with_qmm(make_qmm(mode))
            cache = mapi.init_cache(1, 512, device="cuda")
            lg, cache, clen = mapi.prefill_slot(weights, batch, cache, 0)
            nxt = torch.argmax(lg)[None, None].to(torch.int32)
            lg2, _ = mapi.serve_step(weights, {"tokens": nxt}, cache,
                                     clen[None])
            got[mode] = (lg.float(), lg2[0].float())
        for step, (a, b) in enumerate(zip(got["kernel"], got["densify"])):
            diff = float((a - b).abs().max())
            ref_max = float(b.abs().max())
            log(f"{fmt} step {step} logits: max|kernel - densify| = "
                f"{diff:.4g}, max|densify| = {ref_max:.4g}, argmax "
                f"{int(a.argmax())} vs {int(b.argmax())}")
            if not (torch.isfinite(a).all() and diff <= FUSED_TOL * ref_max):
                fail(f"{fmt} step {step}: kernel logits differ from densify "
                     f"by {diff:.4g} > {FUSED_TOL} * {ref_max:.4g}")

        # ---- the engine, through the kernels: counts read off the wrappers
        reqs = _requests(cfg.vocab, seed)
        before = dict(fused.stats())
        mx_matmul.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused.generate(reqs, fmt_override=fmt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(mx_matmul.launches)
        st = fused.stats()
        steps = (st["prefills"] - before["prefills"]) \
            + (st["ticks"] - before["ticks"])
        ticks = st["ticks"] - before["ticks"]
        want = PROJ_PER_LAYER * cfg.n_layers * steps
        other = "mx_matmul_int4" if kernel == "mx_matmul" else "mx_matmul"
        log(f"{fmt}: launches {counts} over {steps} steps "
            f"({st['prefills'] - before['prefills']} prefills + {ticks} "
            f"decode ticks; want {want} = {PROJ_PER_LAYER} x {cfg.n_layers} "
            f"per step)")
        if counts[kernel] != want or counts[other] != 0:
            fail(f"{fmt}: {kernel} launched {counts[kernel]} times, want "
                 f"{want}; {other} {counts[other]}, want 0")
        launches[kernel] = counts[kernel]
        bad = [r.rid for r in reqs if r.status.value != "completed"
               or len(r.out_tokens) != 16]
        faults = st["faults_detected"] - before["faults_detected"]
        log(f"{fmt}: logit guard {st['logit_guard']}, faults detected "
            f"{faults}, ticks replayed "
            f"{st['ticks_replayed'] - before['ticks_replayed']}")
        if bad or faults or not st["logit_guard"] \
                or st["nonfinite_logit_rows"] != before["nonfinite_logit_rows"]:
            fail(f"{fmt}: requests {bad} incomplete, non-finite logits "
                 f"({st['nonfinite_logit_rows']}) or guard faults {faults}")
        if st["prefills"] - before["prefills"] <= fused.slots:
            fail(f"{fmt}: no slot was re-admitted")
        # ---- one decode step at 4 live slots: driven from the host as the
        # engine drives it, and replayed as a CUDA graph (device time only)
        sapi = api.with_qmm(make_qmm("kernel"))
        cache = sapi.init_cache(4, 512, device="cuda")
        clen = torch.full((4,), 200, dtype=torch.int32, device="cuda")
        toks = torch.zeros((4, 1), dtype=torch.int32, device="cuda")

        def step(i):
            return sapi.serve_step(weights, {"tokens": toks}, cache, clen)

        step(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(5):
            step(i)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / 5
        dev_ms = cuda_time_ms(step, 3)
        del cache
        log(f"{fmt} decode step (4 slots, cache_len 200): host-driven "
            f"{host_ms:.2f} ms, device time {dev_ms:.2f} ms (CUDA graph "
            f"replay); the card idles {100 * (1 - dev_ms / host_ms):.0f}% "
            "of a host-driven step")

        ref_reqs = _requests(cfg.vocab, seed)
        dense.generate(ref_reqs, fmt_override=fmt)
        same = sum(x == y for r, q in zip(reqs, ref_reqs)
                   for x, y in zip(r.out_tokens, q.out_tokens))
        total = sum(len(r.out_tokens) for r in reqs)
        prefill_ms = (st["prefill_s"] - before["prefill_s"]) * 1e3 \
            / (st["prefills"] - before["prefills"])
        decode_ms = (st["decode_s"] - before["decode_s"]) * 1e3 / ticks
        log(f"{fmt}: {len(reqs)} requests x 16 tokens in {wall:.2f} s = "
            f"{total / wall:.1f} tok/s; prefill {prefill_ms:.1f} ms/request "
            f"(prompts 16-200, pow2 buckets); decode {decode_ms:.2f} ms/step "
            f"(4 slots); weight-stream bytes {st['weight_bytes'][fmt]}; "
            f"peak allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} "
            f"GB; greedy tokens equal to the densify contract: "
            f"{same}/{total} ({100 * same / total:.1f}%)")
        streams[fmt] = [r.out_tokens for r in reqs]
        picks = {"decode": lambda t: t["decode"] and not t["prefill_tokens"]}
        _graph_vs_eager("dense", fused, reqs,
                        lambda: _requests(cfg.vocab, seed), fmt, picks)
        for k, n in _sampled_waves("dense", fused, cfg, fmt, seed,
                                   streams[fmt], picks).items():
            launches[k] = launches.get(k, 0) + n
    for kernel, n in _poisoned_wave(api, anchor, cfg, seed,
                                    streams["mxint4"]).items():
        launches[kernel] += n
    return launches, streams, fused


def _poisoned_wave(api, anchor, cfg, seed: int, clean):
    """4 requests x 6 tokens at mxint4 with every logit of scheduler tick 2
    turned NaN while the batch runs at mxint4: the guard escalates to
    mxint6 once, replays the tick and every request completes; the tokens
    before the fault (the prefill's and ticks 0-1's) equal the clean
    wave's. Returns the B1 / B2 launches of the wave."""
    import torch
    from repro_torch.kernels import mx_matmul
    from repro_torch.runtime.fault import FaultInjector
    from repro_torch.serve.engine import ElasticEngine, Request

    fi = FaultInjector(poison_logits={2: None}, poison_fmt="mxint4")
    eng = ElasticEngine(api, anchor, batch_slots=SLOTS, max_len=MAX_LEN,
                        fault_injector=fi, device="cuda")
    eng.weights_for("mxint4")                   # builds outside the wave
    eng.weights_for("mxint6")
    reqs = [Request(rid=r.rid, prompt=r.prompt, max_new=6)
            for r in _requests(cfg.vocab, seed)[:SLOTS]]
    mx_matmul.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(reqs, fmt_override="mxint4")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats()
    counts = dict(mx_matmul.launches)
    execs = sum(t["execs"] for t in eng.tick_trace)
    events = [(e["tick"], e["from"], e["to"])
              for e in st["escalation_events"]]
    log(f"poisoned wave (NaN logits at tick 2 while at mxint4): "
        f"{len(reqs)} requests x 6 tokens in {wall:.2f} s; statuses "
        f"{st['request_statuses']}; escalations {events}; quarantined "
        f"{st['quarantined_formats']}; faults {st['faults_detected']}, "
        f"replays {st['ticks_replayed']}; fmt_used "
        f"{sorted({r.fmt_used for r in reqs})}; launches {counts} over "
        f"{execs} executables")
    bad = [r.rid for r in reqs if r.status.value != "completed"
           or len(r.out_tokens) != 6]
    if bad or events != [(2, "mxint4", "mxint6")] \
            or st["quarantined_formats"] != ["mxint4"] \
            or st["faults_detected"] != 1 or st["ticks_replayed"] != 1 \
            or len(fi.events) != 1:
        fail(f"poisoned wave: requests {bad} incomplete or the guard did "
             f"not escalate exactly once ({events}, faults "
             f"{st['faults_detected']}, replays {st['ticks_replayed']})")
    if sum(counts.values()) != PROJ_PER_LAYER * cfg.n_layers * execs \
            or not (counts["mx_matmul"] and counts["mx_matmul_int4"]):
        fail(f"poisoned wave: launches {counts}, want "
             f"{PROJ_PER_LAYER} x {cfg.n_layers} x {execs} over both "
             "kernels")
    early = [r.out_tokens[:3] for r in reqs]
    if early != [c[:3] for c in clean[:SLOTS]]:
        fail(f"poisoned wave: tokens before the fault {early} differ from "
             f"the clean wave's {[c[:3] for c in clean[:SLOTS]]}")
    # the same plan on an eager twin: the same escalation, the same streams
    twin = _eager_twin(eng, fault_injector=FaultInjector(
        poison_logits={2: None}, poison_fmt="mxint4"))
    twin_reqs = [Request(rid=r.rid, prompt=r.prompt, max_new=6)
                 for r in _requests(cfg.vocab, seed)[:SLOTS]]
    twin.generate(twin_reqs, fmt_override="mxint4")
    _check_same_streams("poisoned wave", reqs, twin_reqs)
    tst = twin.stats()
    if [(e["tick"], e["from"], e["to"]) for e in tst["escalation_events"]] \
            != events or tst["ticks_replayed"] != st["ticks_replayed"]:
        fail(f"poisoned wave: the eager twin escalated "
             f"{tst['escalation_events']}, the graph engine {events}")
    log(f"poisoned wave: graph engine {st['graph_captures']} captures "
        f"({st['graph_capture_s']:.3f} s, the mxint6 tick's mid-wave) and "
        f"{st['graph_replays']} replays; eager twin: the same escalation "
        "and streams")
    del eng, twin
    torch.cuda.empty_cache()
    return counts


def _first_mixed_tick(api, weights, vocab: int, seed: int):
    """From one cache state — three slots decoding after their prompts, the
    fourth holding its first 64-token chunk — the first mixed tick's logits
    under attn_impl "paged_kernel" (B3/B4) and "gather"."""
    import numpy as np
    import torch
    from repro_torch.kernels.dispatch import make_qmm

    dev = torch.device("cuda")
    kapi = api.with_serving(make_qmm("kernel"), "paged_kernel")
    gapi = api.with_serving(make_qmm("kernel"), "gather")
    rng = np.random.default_rng(seed + 2)
    lens = [40, 64, 17, 150]
    prompts = [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]
    cache = kapi.init_cache(SLOTS, MAX_LEN, device=dev, kv_layout="paged",
                            page_size=PAGE)
    per_row = 12                                  # 192 positions per slot
    perm = rng.permutation(np.arange(1, POOL_PAGES))
    bt = np.zeros(tuple(cache["block_table"].shape), np.int32)
    for i in range(SLOTS):
        bt[i, :per_row] = perm[i * per_row:(i + 1) * per_row]
    cache["block_table"].copy_(torch.from_numpy(bt))
    tokens = torch.zeros(SLOTS, dtype=torch.int32, device=dev)
    for i in range(3):
        batch = {"tokens": torch.as_tensor(prompts[i][None], device=dev)}
        lg, cache, _ = kapi.prefill_slot(weights, batch, cache, i)
        tokens[i] = torch.argmax(lg)
    batch = {"tokens": torch.as_tensor(prompts[3][None, :CHUNK], device=dev),
             "lengths": torch.tensor([lens[3]], dtype=torch.int32,
                                     device=dev)}
    kapi.prefill_chunk_slot(weights, batch, cache, 3, 0)
    cache_len = torch.tensor(lens[:3] + [CHUNK], dtype=torch.int32,
                             device=dev)
    tok2d = torch.zeros((SLOTS, CHUNK), dtype=torch.int32, device=dev)
    tok2d[:, 0] = tokens
    tok2d[3] = torch.as_tensor(prompts[3][CHUNK:2 * CHUNK], device=dev)
    mixed = {"tokens": tok2d, "q_len": torch.tensor(
        [1, 1, 1, CHUNK], dtype=torch.int32, device=dev)}
    twin = {"blocks": [{k: t.clone() for k, t in c.items()}
                       for c in cache["blocks"]],
            "block_table": cache["block_table"].clone()}
    got, _ = kapi.mixed_step(weights, mixed, cache, cache_len)
    want, _ = gapi.mixed_step(weights, mixed, twin, cache_len)
    return got.float(), want.float()


def phase_paged_serving(cfg, anchor, seed: int, dense_streams):
    """The paged layout under chunked admission and the mixed scheduler,
    every attention read through B3/B4, greedy and sampled, then the chaos
    phase on its trees; returns the launch counts of B1-B4, the graph
    engine and its greedy streams per format."""
    import numpy as np
    import torch
    from repro_torch.kernels import mx_matmul
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.transformer import make_model
    from repro_torch.serve.engine import ElasticEngine

    n_layers = cfg.n_layers
    log(f"paged serving phase: {n_layers} layers, ElasticEngine("
        f"batch_slots={SLOTS}, max_len={MAX_LEN}, kv_layout='paged', "
        f"kv_page_size={PAGE}, prefill_chunk={CHUNK})")
    api = make_model(cfg)
    eng = ElasticEngine(api, anchor, batch_slots=SLOTS, max_len=MAX_LEN,
                        kv_layout="paged", kv_page_size=PAGE,
                        prefill_chunk=CHUNK, device="cuda")
    if (eng.scheduler, eng.attn_impl) != ("mixed", "paged_kernel"):
        fail(f"paged engine resolved to {eng.scheduler}/{eng.attn_impl}")
    totals = {k: 0 for k in pa.launches}
    streams = {}
    for fmt, kernel in (("mxint8", "mx_matmul"),
                        ("mxint4", "mx_matmul_int4")):
        weights = eng.weights_for(fmt)             # build outside the timing
        got, want = _first_mixed_tick(api, weights, cfg.vocab, seed)
        diff = float((got - want).abs().max())
        ref_max = float(want.abs().max())
        same = int((got.argmax(-1) == want.argmax(-1)).sum())
        log(f"{fmt} first mixed tick: max|paged_kernel - gather| = "
            f"{diff:.4g}, max|gather| = {ref_max:.4g}, argmax equal in "
            f"{same}/{SLOTS} rows")
        if not (torch.isfinite(got).all() and diff <= FUSED_TOL * ref_max):
            fail(f"{fmt}: paged_kernel logits differ from gather by "
                 f"{diff:.4g} > {FUSED_TOL} * {ref_max:.4g}")

        reqs = _requests(cfg.vocab, seed)
        before = eng.stats()
        mx_matmul.reset_launches()
        pa.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate(reqs, fmt_override=fmt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        mm, at = dict(mx_matmul.launches), dict(pa.launches)
        st = eng.stats()
        trace = eng.tick_trace
        pure = [t for t in trace if t["decode"] and not t["prefill_chunks"]]
        mixed = [t for t in trace if t["decode"] and t["prefill_chunks"]]
        alone = [t for t in trace if not t["decode"] and t["execs"]]
        execs = sum(t["execs"] for t in trace)
        other = "mx_matmul_int4" if kernel == "mx_matmul" else "mx_matmul"
        log(f"{fmt}: {len(trace)} ticks = {len(pure)} pure decode + "
            f"{len(mixed)} mixed + {len(alone)} chunks alone; launches "
            f"{at} (want {n_layers} x pure, {n_layers} x mixed), {kernel} "
            f"{mm[kernel]} (want {PROJ_PER_LAYER} x {n_layers} x {execs} "
            f"executables)")
        if max(t["execs"] for t in trace) > 1:
            fail(f"{fmt}: a tick ran more than one executable")
        if at["paged_attention"] != n_layers * len(pure) or \
                at["paged_attention_mq"] != n_layers * len(mixed) or \
                not (pure and mixed):
            fail(f"{fmt}: paged-attention launches {at} for {len(pure)} "
                 f"pure and {len(mixed)} mixed ticks")
        if mm[kernel] != PROJ_PER_LAYER * n_layers * execs or mm[other]:
            fail(f"{fmt}: {kernel} launched {mm[kernel]} times, want "
                 f"{PROJ_PER_LAYER * n_layers * execs}; {other} {mm[other]}")
        bad = [r.rid for r in reqs if r.status.value != "completed"
               or len(r.out_tokens) != MAX_NEW]
        if bad or st["faults_detected"] != before["faults_detected"] \
                or st["nonfinite_logit_rows"] != before["nonfinite_logit_rows"]:
            fail(f"{fmt}: requests {bad} incomplete, non-finite logits or "
                 "a guard fault")
        if st["kv_pages_alloc"] != st["kv_pages_freed"]:
            fail(f"{fmt}: pages alloc {st['kv_pages_alloc']} != freed "
                 f"{st['kv_pages_freed']} at drain")
        for k in at:
            totals[k] += at[k]
        totals[kernel] = totals.get(kernel, 0) + mm[kernel]
        total = sum(len(r.out_tokens) for r in reqs)
        if dense_streams is not None:
            eq = sum(x == y for r, d in zip(reqs, dense_streams[fmt])
                     for x, y in zip(r.out_tokens, d))
            share = f"{eq}/{total} ({100 * eq / total:.1f}%)"
        else:
            share = "not compared (dense phase at another depth)"
        ms = lambda ts: 1e3 * float(np.mean([t["wall_s"] for t in ts]))
        log(f"{fmt} paged: {N_REQ} requests x {MAX_NEW} tokens in "
            f"{wall:.2f} s = {total / wall:.1f} tok/s; pure decode tick "
            f"{ms(pure):.2f} ms, mixed tick {ms(mixed):.2f} ms, chunk alone "
            f"{ms(alone) if alone else float('nan'):.2f} ms (host wall, "
            f"{SLOTS} slots); TTFT s "
            f"{[round(r.ttft_s, 3) for r in reqs]}; kv_cache_bytes "
            f"{st['kv_cache_bytes']}, kv_pages_hwm {st['kv_pages_hwm']} of "
            f"{st['kv_total_pages'] - 1}, attn_read_bytes "
            f"{st['attn_read_bytes'] - before['attn_read_bytes']}; peak "
            f"allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
            f"greedy tokens equal to the dense layout: {share}")
        picks = {"pure decode": lambda t: t["decode"]
                 and not t["prefill_chunks"],
                 "mixed": lambda t: t["decode"] and t["prefill_chunks"]}
        _graph_vs_eager("paged", eng, reqs,
                        lambda: _requests(cfg.vocab, seed), fmt, picks)
        streams[fmt] = [r.out_tokens for r in reqs]
        for k, n in _sampled_waves("paged", eng, cfg, fmt, seed,
                                   streams[fmt], picks).items():
            totals[k] = totals.get(k, 0) + n
    for k, n in phase_chaos(eng, cfg, seed).items():
        totals[k] = totals.get(k, 0) + n
    return totals, eng, streams


def _check_launches(what: str, trace, n_layers: int, mm, at=None,
                    per_layer: int = PROJ_PER_LAYER) -> None:
    """B1 + B2 launches = ``per_layer`` (qwen3-4b: 7) projections x layers
    x the wave's executables (guard
    replays included, a crashed attempt launches nothing; a speculative
    tick's draft steps and verify attempts each count); on the paged
    layout B3 = layers x the executables of its pure decode ticks (a
    speculative tick's draft steps) and B4 of its mixed ticks and verify
    attempts."""
    execs = sum(t["execs"] for t in trace)
    if sum(mm.values()) != per_layer * n_layers * execs:
        fail(f"{what}: B1/B2 launches {mm}, want {per_layer} x "
             f"{n_layers} x {execs} executables")
    if at is None:
        return
    pure = sum(t["execs"] - t["verify_execs"] for t in trace
               if t["decode"] and not t["prefill_chunks"])
    mixed = sum(t["execs"] if t["prefill_chunks"] else t["verify_execs"]
                for t in trace if t["decode"])
    if at["paged_attention"] != n_layers * pure or \
            at["paged_attention_mq"] != n_layers * mixed:
        fail(f"{what}: paged-attention launches {at}, want {n_layers} x "
             f"{pure} pure and {n_layers} x {mixed} mixed executables")


def _sampled_requests(vocab: int, seed: int):
    """``_requests``, two of them with their own temperature / top-p."""
    reqs = _requests(vocab, seed)
    reqs[OWN_TEMPERATURE[0]].temperature = OWN_TEMPERATURE[1]
    reqs[OWN_TOP_P[0]].top_p = OWN_TOP_P[1]
    return reqs


def _draw_cost(seed: int):
    """One batch draw (``sampling.sample_batch``) over SLOTS x 151,936
    logits: host-driven wall (eager launches, to a synchronize) and device
    time (a CUDA graph of 10 draws between CUDA events); its keys equal the
    CPU's bit for bit. Returns (host ms, device ms)."""
    import torch
    from repro_torch.serve.sampling import prng_key, sample_batch, split
    vocab = 151936
    gen = torch.Generator(device="cuda").manual_seed(seed)
    logits = torch.randn((SLOTS, vocab), generator=gen, device="cuda") * 3
    keys = split(prng_key(seed), SLOTS).cuda()
    temps = torch.full((SLOTS,), SAMPLE["temperature"], device="cuda")
    tops = torch.full((SLOTS,), SAMPLE["top_p"], device="cuda")
    nxt, toks = sample_batch(keys, logits, temps, tops)
    cnxt, ctoks = sample_batch(keys.cpu(), logits.cpu(), temps.cpu(),
                               tops.cpu())
    if not torch.equal(nxt.cpu(), cnxt):
        fail("the draw's advanced keys differ between the card and the CPU")
    same = int((toks.cpu() == ctoks).sum())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        sample_batch(keys, logits, temps, tops)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / 20
    dev_ms = cuda_time_ms(lambda i: sample_batch(keys, logits, temps, tops),
                          10)
    log(f"draw (sample_batch, {SLOTS} x {vocab} logits, T "
        f"{SAMPLE['temperature']}, top-p {SAMPLE['top_p']}): eager "
        f"host-driven {host_ms:.3f} ms, device {dev_ms:.3f} ms per draw "
        f"(CUDA graph of 10 draws, CUDA events); keys equal to the CPU's, "
        f"tokens equal in {same}/{SLOTS} rows")
    return host_ms, dev_ms


def _sampled_waves(label, geng, cfg, fmt: str, seed: int, greedy_streams,
                   picks):
    """Sampled serving on ``geng``'s layout and weight trees at ``fmt``:
    a graph engine (``SAMPLE``) serves ``_sampled_requests`` — launches as
    the structure predicts, every request complete, the draw captured once
    — then an eager twin serves them to the same streams; the graph engine
    again (no capture, one tick and one draw replay per tick) to the same
    streams, timed, and greedily, timed, to ``greedy_streams``; seed 1
    changes a stream; top_p 1e-6 gives ``greedy_streams``. Logs the
    sampled tick wall beside the greedy one of the same engine, per kind
    of tick in ``picks``. Returns the first wave's launches."""
    import torch
    from repro_torch.kernels import mx_matmul
    from repro_torch.kernels import paged_attention as pa

    what = f"{label} sampled {fmt}"
    t_all = time.perf_counter()
    paged = geng.kv_layout == "paged"
    make = lambda: _sampled_requests(cfg.vocab, seed)
    eng = _twin(geng, **SAMPLE)
    reqs = make()
    mx_matmul.reset_launches()
    pa.reset_launches()
    torch.cuda.synchronize()
    eng.generate(reqs, greedy=False, fmt_override=fmt)
    torch.cuda.synchronize()
    mm, at = dict(mx_matmul.launches), dict(pa.launches)
    _check_launches(what, eng.tick_trace, cfg.n_layers, mm,
                    at if paged else None)
    if not paged and any(at.values()):
        fail(f"{what}: paged-attention launches {at} on the dense layout")
    st = eng.stats()
    bad = [r.rid for r in reqs if r.status.value != "completed"
           or len(r.out_tokens) != MAX_NEW]
    if bad or st["faults_detected"] or st["draw_graph_captures"] != 1:
        fail(f"{what}: requests {bad} incomplete, guard faults "
             f"{st['faults_detected']} or draw captures "
             f"{st['draw_graph_captures']}")
    streams = [r.out_tokens for r in reqs]
    if streams == greedy_streams:
        fail(f"{what}: every sampled stream equals the greedy one")
    twin = _eager_twin(geng, **SAMPLE)
    twin_reqs = make()
    twin.generate(twin_reqs, greedy=False, fmt_override=fmt)
    _check_same_streams(what, twin_reqs, reqs)

    before = eng.stats()
    again = make()
    wall = _timed_wave(eng, again, fmt, greedy=False)
    after = eng.stats()
    if [r.out_tokens for r in again] != streams:
        fail(f"{what}: the same seed twice gave other streams")
    ticks = after["ticks"] - before["ticks"]
    if after["graph_captures"] != before["graph_captures"] \
            or after["draw_graph_captures"] != 1 \
            or after["graph_replays"] - before["graph_replays"] != ticks \
            or after["draw_graph_replays"] - before["draw_graph_replays"] \
            != ticks:
        fail(f"{what}: a wave of known keys captured or missed replays "
             f"({before} -> {after})")
    strace = list(eng.tick_trace)
    greedy = _requests(cfg.vocab, seed)
    gwall = _timed_wave(eng, greedy, fmt)
    if [r.out_tokens for r in greedy] != greedy_streams:
        fail(f"{what}: a greedy wave on the sampling engine differs from "
             "the greedy engine's")
    gtrace = list(eng.tick_trace)

    other = _twin(geng, **dict(SAMPLE, seed=1))
    reqs1 = make()
    other.generate(reqs1, greedy=False, fmt_override=fmt)
    changed = sum(r.out_tokens != s for r, s in zip(reqs1, streams))
    if not changed:
        fail(f"{what}: seed 1 drew the same streams as seed 0")
    collapse = _twin(geng, **dict(SAMPLE, top_p=1e-6))
    reqs_c = _requests(cfg.vocab, seed)
    collapse.generate(reqs_c, greedy=False, fmt_override=fmt)
    if [r.out_tokens for r in reqs_c] != greedy_streams:
        fail(f"{what}: top_p 1e-6 differs from the greedy streams")
    total = sum(len(r.out_tokens) for r in again)
    log(f"{what} (seed 0, T {SAMPLE['temperature']}, top-p "
        f"{SAMPLE['top_p']}; rid {OWN_TEMPERATURE[0]} T "
        f"{OWN_TEMPERATURE[1]}, rid {OWN_TOP_P[0]} top-p {OWN_TOP_P[1]}): "
        f"launches {mm}{' ' + str(at) if paged else ''}; graph == eager, "
        "seed 0 twice equal, seed 1 changed "
        f"{changed}/{len(reqs1)} streams, top-p 1e-6 == greedy; "
        + "; ".join(f"{kind} tick sampled {_tick_wall(strace, pick)} vs "
                    f"greedy {_tick_wall(gtrace, pick)}"
                    for kind, pick in picks.items())
        + f"; wave {total / wall:.1f} tok/s sampled vs "
        f"{sum(len(r.out_tokens) for r in greedy) / gwall:.1f} greedy "
        f"(same engine); draw replays {after['draw_graph_replays']}; "
        f"{time.perf_counter() - t_all:.1f} s")
    del eng, twin, other, collapse
    torch.cuda.empty_cache()
    return {k: v for k, v in {**mm, **at}.items() if v}


def _chaos_injector(**plan):
    """A ``FaultInjector`` whose targets are picked when the wave gets
    there: ``cancel_from`` cancels the lowest rid decoding at the first
    tick from then on with no request queued or mid-prefill (from there on
    every tick is a pure decode tick, cancellation or not, so no other
    request's schedule moves); ``raise_from`` crashes the first decode or
    mixed step at that tick or after; ``poison_at`` NaN-fills, before that
    tick, the first page of the lowest slot that maps one (``rows``: the
    slots that map it). ``engine`` and ``reqs`` are set by the caller."""
    from repro_torch.runtime.fault import FaultInjector

    class Chaos(FaultInjector):
        engine = reqs = cancel_from = raise_from = poison_at = rows = None

        def cancel_rid(self, tick):
            if self.cancel_from is not None and tick >= self.cancel_from \
                    and not self.cancel_at:
                state = [(r.status.value, bool(r.out_tokens))
                         for r in self.reqs]
                live = [r.rid for r, st in zip(self.reqs, state)
                        if st == ("running", True)]
                if live and ("queued", False) not in state \
                        and ("running", False) not in state:
                    self.cancel_at = {tick: live[0]}
            return super().cancel_rid(tick)

        def maybe_raise_step(self, tick):
            if self.raise_from is not None and tick >= self.raise_from \
                    and not self.raise_in_step:
                self.raise_in_step = (tick,)
            super().maybe_raise_step(tick)

        def pool_poison_page(self, tick):
            if tick == self.poison_at:
                bt = self.engine._cache["block_table"].cpu().numpy()
                row = next(i for i in range(len(bt)) if bt[i].any())
                page = int(bt[row][bt[row] != 0][0])
                self.rows = [i for i in range(len(bt))
                             if (bt[i] == page).any()]
                self.poison_pool = {tick: page}
            return super().pool_poison_page(tick)

    fi = Chaos(fail_allocs=plan.pop("fail_allocs", ()))
    for k, v in plan.items():
        setattr(fi, k, v)
    return fi


def _chaos_wave(peng, cfg, seed: int, fmt: str, plan, deadline_rid=None,
                cuda_graphs=True):
    """``peng``'s layout and trees under ``_chaos_injector(**plan)``,
    greedy at ``fmt``: (engine, requests, injector, launches)."""
    import torch
    from repro_torch.kernels import mx_matmul
    from repro_torch.kernels import paged_attention as pa
    fi = _chaos_injector(**plan)
    eng = _twin(peng, fault_injector=fi, cuda_graphs=cuda_graphs)
    reqs = _requests(cfg.vocab, seed)
    if deadline_rid is not None:
        reqs[deadline_rid].deadline_s = 0.0
    fi.engine, fi.reqs = eng, reqs
    mx_matmul.reset_launches()
    pa.reset_launches()
    torch.cuda.synchronize()
    eng.generate(reqs, fmt_override=fmt)
    torch.cuda.synchronize()
    return eng, reqs, fi, {**mx_matmul.launches, **pa.launches}


def phase_chaos(peng, cfg, seed: int):
    """The paged graph engine's failure model at full width, greedy at
    mxint4 (escalation has rungs to climb). Wave A: the first allocation
    fails (an admission, requeued), a decode step crashes once (retried at
    the same format), the lowest rid decoding once nothing is queued or
    mid-prefill is cancelled, the last request has a zero deadline: each
    request ends in its planned status and the survivors' streams equal
    the clean wave's. On the card a row's numerics depend on its tick's
    kind (a mixed tick runs B1/B2 at M = 256 and B4, a pure decode tick the
    decode body and B3), so the clean wave keeps every survivor's
    schedule: it leaves out the request that never gets in (the others'
    ticks then fall as in wave A, one tick later there: the failed
    allocation delays everything by one), and the cancellation lands
    where every later tick is pure decode either way. Wave B: the first
    page of a decoding row is NaN-filled before tick 6: B3/B4 give that
    row exact zeros (its sum is NaN; the reference's kernels do the same),
    so its logits stay finite and every request completes with no fault
    and no escalation, as in the JAX engine. Pages balance in both; an
    eager twin under the same plans ends the same. Returns the graph
    waves' launches."""
    import torch
    fmt = "mxint4"
    last = N_REQ - 1
    totals = {}
    t_phase = time.perf_counter()
    log(f"chaos phase: paged graph engine, {cfg.n_layers} layers, greedy "
        f"at {fmt}")
    clean_eng = _twin(peng)
    clean_reqs = _requests(cfg.vocab, seed)[:last]
    clean_eng.generate(clean_reqs, fmt_override=fmt)
    clean = [r.out_tokens for r in clean_reqs]
    del clean_eng
    waves = {
        "A": (dict(fail_allocs=(0,), cancel_from=0, raise_from=12), last),
        "B": (dict(poison_at=6), None)}
    for name, (plan, deadline_rid) in waves.items():
        t0 = time.perf_counter()
        eng, reqs, fi, counts = _chaos_wave(peng, cfg, seed, fmt,
                                            dict(plan), deadline_rid)
        wall = time.perf_counter() - t0
        st = eng.stats()
        what = f"chaos wave {name}"
        _check_launches(what, eng.tick_trace, cfg.n_layers,
                        {k: counts[k] for k in ("mx_matmul",
                                                "mx_matmul_int4")},
                        counts)
        statuses = [r.status.value for r in reqs]
        kinds = [e["kind"] for e in fi.events]
        events = [(e["tick"], e["from"], e["to"])
                  for e in st["escalation_events"]]
        log(f"{what}: {wall:.2f} s; statuses {statuses}; injector events "
            f"{fi.events}; escalations {events}; faults "
            f"{st['faults_detected']}, replays {st['ticks_replayed']}, "
            f"requeues {st['admission_requeues']}; pages "
            f"{st['kv_pages_alloc']} alloc / {st['kv_pages_freed']} freed; "
            f"graph captures {st['graph_captures']}, replays "
            f"{st['graph_replays']}; launches {counts}")
        if name == "A":
            cancelled = next(iter(fi.cancel_at.values()), None)
            want = ["completed"] * N_REQ
            want[last] = "timed_out"
            if cancelled is not None:
                want[cancelled] = "cancelled"
            if statuses != want or sorted(kinds) != sorted(
                    ["fail_alloc", "cancel", "raise_in_step"]) \
                    or st["fmt_escalations"] or not st["ticks_replayed"] \
                    or not st["admission_requeues"]:
                fail(f"{what}: statuses {statuses} (want {want}), events "
                     f"{kinds}, escalations {events}, replays "
                     f"{st['ticks_replayed']}, requeues "
                     f"{st['admission_requeues']}")
            bad = [r.rid for r in reqs if r.status.value == "completed"
                   and r.out_tokens != clean[r.rid]]
            if bad:
                fail(f"{what}: survivors {bad} differ from the clean wave")
        else:
            hit = len(fi.rows or [])
            if not hit or statuses != ["completed"] * N_REQ or events \
                    or st["faults_detected"]:
                fail(f"{what}: {hit} row(s) mapped the poisoned page; "
                     f"statuses {statuses} (want all completed), "
                     f"escalations {events}, faults "
                     f"{st['faults_detected']} (want none)")
        if st["kv_pages_alloc"] != st["kv_pages_freed"]:
            fail(f"{what}: pages alloc {st['kv_pages_alloc']} != freed "
                 f"{st['kv_pages_freed']}")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        twin, twin_reqs, tfi, _ = _chaos_wave(peng, cfg, seed, fmt,
                                              dict(plan), deadline_rid,
                                              cuda_graphs=False)
        tst = twin.stats()
        if [r.status for r in twin_reqs] != [r.status for r in reqs] \
                or tfi.events != fi.events \
                or tst["escalation_events"] != st["escalation_events"]:
            fail(f"{what}: the eager twin ended "
                 f"{[r.status.value for r in twin_reqs]} with events "
                 f"{tfi.events}")
        _check_same_streams(what, twin_reqs, reqs)
        del eng, twin
        torch.cuda.empty_cache()
    log(f"chaos phase: the eager twin ended both waves the same way; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return totals


def _first_verify(eng, seed: int):
    """From one cache state — 4 slots decoding after their prompts — the
    plain mxint8 decode tick's logits and lane 0 of a verify's at q_len
    k + 1 (seeded draft tokens) on a copy of the same cache, on ``eng``'s
    layout and trees: (lane 0, plain)."""
    import numpy as np
    import torch
    from repro_torch.kernels.dispatch import make_qmm

    dev, api, vocab = eng.device, eng.api, eng.api.cfg.vocab
    weights = eng.weights_for("mxint8")
    paged = eng.kv_layout == "paged"
    kapi = api.with_serving(make_qmm("kernel"),
                            "paged_kernel" if paged else "gather")
    rng = np.random.default_rng(seed + 3)
    lens = [40, 64, 17, 150]
    layout = dict(kv_layout="paged", page_size=PAGE) if paged else {}
    cache = kapi.init_cache(SLOTS, MAX_LEN, device=dev, **layout)
    if paged:
        per_row = 12                              # 192 positions per slot
        perm = rng.permutation(np.arange(1, POOL_PAGES))
        bt = np.zeros(tuple(cache["block_table"].shape), np.int32)
        for i in range(SLOTS):
            bt[i, :per_row] = perm[i * per_row:(i + 1) * per_row]
        cache["block_table"].copy_(torch.from_numpy(bt))
    tokens = torch.zeros((SLOTS, 1), dtype=torch.int32, device=dev)
    for i, n in enumerate(lens):
        prompt = rng.integers(0, vocab, size=n).astype(np.int32)
        lg, cache, _ = kapi.prefill_slot(
            weights, {"tokens": torch.as_tensor(prompt[None], device=dev)},
            cache, i)
        tokens[i, 0] = torch.argmax(lg)
    twin = {k: ([{n: t.clone() for n, t in c.items()} for c in v]
                if k == "blocks" else v.clone()) for k, v in cache.items()}
    cache_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    plain, _ = kapi.serve_step(weights, {"tokens": tokens}, cache, cache_len)
    tok2d = torch.as_tensor(rng.integers(0, vocab, size=(SLOTS, SPEC_K + 1))
                            .astype(np.int32), device=dev)
    tok2d[:, :1] = tokens
    q_len = torch.full((SLOTS,), SPEC_K + 1, dtype=torch.int32, device=dev)
    got, _ = kapi.verify_step(weights, {"tokens": tok2d, "q_len": q_len},
                              twin, cache_len)
    return got[:, 0].float(), plain.float()


def _agreement(got, want):
    """Tokens equal between two sets of streams, and each stream's first
    position of difference (None where equal)."""
    same = sum(x == y for g, w in zip(got, want) for x, y in zip(g, w))
    first = [next((i for i, (x, y) in enumerate(zip(g, w)) if x != y),
                  None if len(g) == len(w) else min(len(g), len(w)))
             for g, w in zip(got, want)]
    return same, sum(len(w) for w in want), first


def phase_speculative(label: str, base, cfg, seed: int, plain_streams):
    """Self-speculative decoding on ``base``, the dense or the paged graph
    engine of a serving phase (its trees), pinned mxint8, drafting k = 4
    at mxint4: lane 0 of the first verify within SPEC_TOL of
    max|logit| of the plain decode tick on the same cache; a graph wave
    (drafts and verifies captured) — every request complete, pages
    balanced, 1 <= committed <= k_eff + 1 per live slot and spec tick,
    launches as the structure predicts (B2 7 x layers per draft step, B1
    per verify attempt and prefill, on the paged layout B3 per draft step
    and B4 per verify attempt and mixed tick); an eager twin to the same
    streams; the graph wave again, timed (spec tick wall split into drafts
    and the verify), beside a plain graph wave of the same engine; the
    streams' agreement with plain decode, reported, not gated (the verify
    runs B1/B2 at M = 20 and B4, plain decode the decode body and B3); a
    wave whose every draft is NaN: the burst aborts once, mxint4 is
    quarantined and the wave finishes on plain decode with the plain
    streams. Returns the first graph wave's launches."""
    import numpy as np
    import torch
    from repro_torch.kernels import mx_matmul
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.runtime.fault import FaultInjector
    from repro_torch.serve import engine as engine_mod
    from repro_torch.serve.policy import SpecConfig

    spec = SpecConfig(draft_fmt="mxint4", k=SPEC_K)
    t_phase = time.perf_counter()
    log(f"speculative phase, {label}: {cfg.n_layers} layers, pinned "
        f"mxint8, SpecConfig(draft_fmt='mxint4', k={SPEC_K})")
    accept = engine_mod.spec_accept_counts
    paged = base.kv_layout == "paged"
    what = f"speculative {label}"
    got, want = _first_verify(base, seed)
    diff = float((got - want).abs().max())
    ref_max = float(want.abs().max())
    same = int((got.argmax(-1) == want.argmax(-1)).sum())
    log(f"{what} first verify: max|lane 0 - plain decode tick| = "
        f"{diff:.4g}, max|plain| = {ref_max:.4g}, argmax equal in "
        f"{same}/{SLOTS} rows")
    if not (torch.isfinite(got).all() and diff <= SPEC_TOL * ref_max):
        fail(f"{what}: lane 0 of the verify differs from the plain "
             f"decode tick by {diff:.4g} > {SPEC_TOL} * {ref_max:.4g}")

    eng = _twin(base, speculative=spec)
    commits, draft_s = [], []
    burst = eng._draft_burst

    def timed_burst(*a, burst=burst):
        t0 = time.perf_counter()
        out = burst(*a)                 # each step's host copy syncs
        draft_s.append(time.perf_counter() - t0)
        return out

    def spy(drafts, anchor_toks, budgets):
        out = accept(drafts, anchor_toks, budgets)
        commits.append((drafts.shape[1], np.asarray(budgets).copy(),
                        out.copy()))
        return out

    eng._draft_burst = timed_burst
    engine_mod.spec_accept_counts = spy
    try:
        reqs = _requests(cfg.vocab, seed)
        mx_matmul.reset_launches()
        pa.reset_launches()
        torch.cuda.synchronize()
        eng.generate(reqs, fmt_override="mxint8")
        torch.cuda.synchronize()
        mm, at = dict(mx_matmul.launches), dict(pa.launches)
        st = eng.stats()
        trace = list(eng.tick_trace)
        _check_launches(what, trace, cfg.n_layers, mm,
                        at if paged else None)
        if not paged and any(at.values()):
            fail(f"{what}: paged-attention launches {at} on the dense "
                 "layout")
        drafts = sum(t["draft_execs"] for t in trace)
        if mm["mx_matmul_int4"] != PROJ_PER_LAYER * cfg.n_layers * drafts:
            fail(f"{what}: B2 launched {mm['mx_matmul_int4']} times for "
                 f"{drafts} draft steps")
        bad = [r.rid for r in reqs if r.status.value != "completed"
               or len(r.out_tokens) != MAX_NEW]
        spec_ticks = [t for t in trace if t["draft_execs"]]
        if bad or st["faults_detected"] or not spec_ticks \
                or st["spec_aborts"] \
                or st["kv_pages_alloc"] != st["kv_pages_freed"] \
                or len(spec_ticks) != st["spec_ticks"]:
            fail(f"{what}: requests {bad} incomplete, faults "
                 f"{st['faults_detected']}, {len(spec_ticks)} spec ticks "
                 f"({st['spec_ticks']} counted, {st['spec_aborts']} "
                 f"aborted), pages {st['kv_pages_alloc']} / "
                 f"{st['kv_pages_freed']}")
        for k_eff, budgets, commit in commits:
            live = budgets > 0
            if (commit[live] < 1).any() or (commit[live] > k_eff + 1).any():
                fail(f"{what}: committed {commit} at k_eff {k_eff}")
        rows = sum(int((b > 0).sum()) for _, b, _ in commits)
        committed = sum(int(c.sum()) for _, _, c in commits)
        streams = [r.out_tokens for r in reqs]

        twin = _eager_twin(base, speculative=spec)
        twin_reqs = _requests(cfg.vocab, seed)
        t0 = time.perf_counter()
        twin.generate(twin_reqs, fmt_override="mxint8")
        torch.cuda.synchronize()
        t_eager = time.perf_counter() - t0
        _check_same_streams(what, twin_reqs, reqs)
        tst = twin.stats()
        if [tst[k] for k in ("spec_ticks", "spec_accepted")] != \
                [st[k] for k in ("spec_ticks", "spec_accepted")]:
            fail(f"{what}: the eager twin accepted differently")

        before = eng.stats()
        draft_s.clear()
        again = _requests(cfg.vocab, seed)
        wall = _timed_wave(eng, again, "mxint8")
        after = eng.stats()
        if [r.out_tokens for r in again] != streams \
                or after["graph_captures"] != before["graph_captures"]:
            fail(f"{what}: a wave of known keys gave other streams or "
                 "captured")
        strace = [t for t in eng.tick_trace if t["draft_execs"]]
        tick_ms = [1e3 * t["wall_s"] for t in strace]
        d_ms = [1e3 * x for x in draft_s]
        if len(d_ms) != len(tick_ms):
            fail(f"{what}: {len(d_ms)} bursts for {len(tick_ms)} spec "
                 "ticks")
        v_ms = [t - d for t, d in zip(tick_ms, d_ms)]
        per_draft = [1e3 * x / t["draft_execs"]
                     for x, t in zip(draft_s, strace)]
    finally:
        engine_mod.spec_accept_counts = accept
    plain = _requests(cfg.vocab, seed)
    pwall = _timed_wave(base, plain, "mxint8")
    pure = "pure decode" if paged else "decode"
    pick = (lambda t: t["decode"] and not t["prefill_chunks"]) if paged \
        else (lambda t: t["decode"] and not t["prefill_tokens"])
    eq, total, first = _agreement(streams, plain_streams)
    if [r.out_tokens for r in plain] != plain_streams:
        fail(f"{what}: the plain graph wave changed its streams")
    log(f"{what}: acceptance {st['spec_acceptance_rate']:.3f} "
        f"({st['spec_accepted']} accepted, {st['spec_rejected']} "
        f"rejected), {st['spec_ticks']} spec ticks of {st['ticks']} "
        f"decode-carrying ticks, {committed / rows:.2f} tokens per live "
        f"slot per spec tick; graph == eager; launches {mm}"
        f"{' ' + str(at) if paged else ''}; captures "
        f"{st['graph_captures']} ({st['graph_capture_s']:.3f} s)")
    log(f"{what}: spec tick wall median {np.median(tick_ms):.2f} ms "
        f"({min(tick_ms):.2f}-{max(tick_ms):.2f}, n {len(tick_ms)}) = "
        f"drafts {np.median(d_ms):.2f} ms ({np.median(per_draft):.2f} ms "
        f"per draft step) + verify and commit {np.median(v_ms):.2f} ms; "
        f"plain {pure} tick {_tick_wall(base.tick_trace, pick)}; wave "
        f"{MAX_NEW * N_REQ / wall:.1f} tok/s speculative vs "
        f"{MAX_NEW * N_REQ / pwall:.1f} plain (graph, same trees), "
        f"{MAX_NEW * N_REQ / t_eager:.1f} eager speculative")
    log(f"{what}: streams vs plain mxint8 decode: {eq}/{total} tokens "
        f"equal, {sum(f is None for f in first)}/{len(first)} streams "
        f"equal; first differing position per stream {first}")

    fi = FaultInjector(poison_logits={t: None for t in range(4096)},
                       poison_fmt="mxint4")
    sick = _twin(base, speculative=spec, fault_injector=fi)
    sick_reqs = _requests(cfg.vocab, seed)
    sick.generate(sick_reqs, fmt_override="mxint8")
    sst = sick.stats()
    if any(r.status.value != "completed" for r in sick_reqs) \
            or sst["spec_aborts"] != 1 or sst["spec_ticks"] \
            or sst["quarantined_formats"] != ["mxint4"] \
            or sst["fmt_escalations"] \
            or sst["kv_pages_alloc"] != sst["kv_pages_freed"] \
            or [r.out_tokens for r in sick_reqs] != plain_streams:
        fail(f"{what}, every draft NaN: statuses "
             f"{[r.status.value for r in sick_reqs]}, aborts "
             f"{sst['spec_aborts']}, spec ticks {sst['spec_ticks']}, "
             f"quarantined {sst['quarantined_formats']}, escalations "
             f"{sst['fmt_escalations']}, or streams other than plain")
    log(f"{what}, every draft NaN: the first burst aborted, mxint4 "
        f"quarantined, the wave finished on plain decode with the plain "
        f"streams; faults {sst['faults_detected']}")
    del eng, twin, sick
    torch.cuda.empty_cache()
    log(f"speculative phase, {label}: {time.perf_counter() - t_phase:.1f} s")
    return {**mm, **at}


def phase_preemption(peng, cfg, seed: int):
    """The paged graph engine's preemption at mxint8: an engine on the
    paged phase's trees serves the wave once (every key captured; its
    streams are the uninterrupted wave's), then again with a preemption
    triggered at the first tick from 4 on that leaves a slot mid-prefill
    and others decoding: a snapshot at the next tick boundary. A fresh
    engine resumes it to the uninterrupted streams (pages balanced across
    both engines, launches as the structure predicts); then the original
    engine resumes the same snapshot with its graphs: the same streams and
    no new capture. Logs snapshot bytes, save seconds, and resume seconds
    up to the first tick (fresh: its first capture; original: its first
    replay). Returns the fresh resume's launches."""
    import torch
    from repro_torch.kernels import mx_matmul
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.runtime.fault import FaultInjector, PreemptionGuard

    class Preempt(FaultInjector):
        """Triggers at the first tick from 4 on after which a request is
        still mid-prefill (each tick runs one chunk of it: its chunks so
        far, this tick's included, do not cover its prompt) while another
        decodes."""
        reqs = chunk = None
        chunks: dict = {}

        def maybe_preempt(self, tick, guard):
            filling = [r for r in self.reqs if r.status.value == "running"
                       and not r.out_tokens]
            for r in filling:
                self.chunks[r.rid] = self.chunks.get(r.rid, 0) + 1
            if self.preempt_at is None and tick >= 4 and any(
                    self.chunks[r.rid] * self.chunk < r.prompt.size
                    for r in filling) and any(
                    r.status.value == "running" and r.out_tokens
                    for r in self.reqs):
                self.preempt_at = tick
            super().maybe_preempt(tick, guard)

    def first_tick_timer(eng, t_start):
        """Seconds from ``t_start`` to the end of ``eng``'s next graph
        tick (synchronized), filled in when it runs."""
        run, out = eng._graphs.run, {}

        def timed(key, step):
            replays = eng._graphs.replays
            logits = run(key, step)
            if not out:
                torch.cuda.synchronize()
                out["s"] = time.perf_counter() - t_start[0]
                out["replay"] = eng._graphs.replays > replays
            return logits
        eng._graphs.run = timed
        return out

    t_phase = time.perf_counter()
    fmt = "mxint8"
    eng = _twin(peng)
    want = _requests(cfg.vocab, seed)
    eng.generate(want, fmt_override=fmt)
    want = [r.out_tokens for r in want]
    with tempfile.TemporaryDirectory() as tmp:
        fi = Preempt()
        reqs = _requests(cfg.vocab, seed)
        fi.reqs, fi.chunk, fi.chunks = reqs, eng.prefill_chunk, {}
        eng._fault_injector = fi
        save, saved = eng._save_snapshot, []

        def timed_save(*a):
            t0 = time.perf_counter()
            path = save(*a)
            saved.append(time.perf_counter() - t0)
            return path
        eng._save_snapshot = timed_save
        guard = PreemptionGuard()
        eng.generate(reqs, fmt_override=fmt, guard=guard, snapshot_dir=tmp)
        path = eng.last_snapshot
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path))
        with open(os.path.join(path, "manifest.json")) as f:
            meta = json.load(f)["meta"]
        if not guard.preempted or meta["filling"] is None \
                or all(r.done for r in reqs):
            fail(f"preemption: preempted {guard.preempted} at tick "
                 f"{fi.preempt_at}, mid-prefill rid {meta['filling']}")
        eng._fault_injector = None

        fresh = _twin(peng)
        mx_matmul.reset_launches()
        pa.reset_launches()
        t_start = [time.perf_counter()]
        fresh_first = first_tick_timer(fresh, t_start)
        done = fresh.resume(tmp)
        torch.cuda.synchronize()
        t_fresh = time.perf_counter() - t_start[0]
        counts = {**mx_matmul.launches, **pa.launches}
        st = fresh.stats()
        _check_launches("preemption: the fresh resume", fresh.tick_trace,
                        cfg.n_layers, {k: counts[k] for k in (
                            "mx_matmul", "mx_matmul_int4")}, counts)
        if [r.out_tokens for r in done] != want \
                or any(r.status.value != "completed" for r in done) \
                or st["kv_pages_alloc"] != st["kv_pages_freed"] \
                or st["resumes"] != 1:
            fail(f"preemption: the fresh engine's resume ended "
                 f"{[r.status.value for r in done]} with pages "
                 f"{st['kv_pages_alloc']} / {st['kv_pages_freed']}, or "
                 "streams other than the uninterrupted wave's")

        captures = eng.stats()["graph_captures"]
        t_start[0] = time.perf_counter()
        own_first = first_tick_timer(eng, t_start)
        again = eng.resume(tmp)
        torch.cuda.synchronize()
        t_own = time.perf_counter() - t_start[0]
        ost = eng.stats()
        if [r.out_tokens for r in again] != want \
                or ost["graph_captures"] != captures \
                or ost["kv_pages_alloc"] != ost["kv_pages_freed"] \
                or not own_first.get("replay"):
            fail(f"preemption: the original engine's resume gave other "
                 f"streams, captured {ost['graph_captures'] - captures} "
                 f"graph(s), or its first tick was not a replay")
    log(f"preemption: at tick {fi.preempt_at} (rid {meta['filling']} "
        f"mid-prefill at {meta['fill_cursor']}, active "
        f"{meta['active']} (rid per slot), {len(meta['pending'])} queued); "
        f"snapshot {nbytes / 1e9:.3f} GB saved in {saved[0]:.2f} s; fresh "
        f"engine: resume to its first tick {fresh_first['s']:.2f} s (a "
        f"capture), the wave in {t_fresh:.2f} s, {st['graph_captures']} "
        f"captures; the original engine: resume to its first replayed tick "
        f"{own_first['s']:.2f} s, the wave in {t_own:.2f} s, no new "
        f"capture; both equal the uninterrupted wave; pages "
        f"{st['kv_pages_alloc']} / {st['kv_pages_freed']}; launches "
        f"{counts}; {time.perf_counter() - t_phase:.1f} s")
    del eng, fresh
    torch.cuda.empty_cache()
    return counts


def phase_serve_walls(seed: int, n_layers: int):
    """Greedy graph ticks for a same-call A/B of two trees: the dense and
    the paged (mixed scheduler) engine, qwen3-4b at ``n_layers``, 4 slots, at
    mxint8 and mxint4; a capturing wave, then three timed waves; the
    median tick wall (and quartiles) per kind over the three, and a digest
    of the streams."""
    import hashlib

    import numpy as np
    import torch
    from repro_torch.models.transformer import make_model
    from repro_torch.serve.engine import ElasticEngine
    cfg = qwen3_4b(n_layers)
    anchor = build_anchor(cfg, seed, save=False)
    api = make_model(cfg)
    layouts = {
        "dense": ({}, {"decode": lambda t: t["decode"]
                       and not t["prefill_tokens"]}),
        "paged": (dict(kv_layout="paged", kv_page_size=PAGE,
                       prefill_chunk=CHUNK),
                  {"pure decode": lambda t: t["decode"]
                   and not t["prefill_chunks"],
                   "mixed": lambda t: t["decode"] and t["prefill_chunks"]})}
    for label, (kw, picks) in layouts.items():
        eng = ElasticEngine(api, anchor, batch_slots=SLOTS, max_len=MAX_LEN,
                            device="cuda", **kw)
        for fmt in ("mxint8", "mxint4"):
            reqs = _requests(cfg.vocab, seed)
            eng.generate(reqs, fmt_override=fmt)
            digest = hashlib.sha1(str([r.out_tokens for r in reqs])
                                  .encode()).hexdigest()[:12]
            walls = {kind: [] for kind in picks}
            for _ in range(3):
                _timed_wave(eng, _requests(cfg.vocab, seed), fmt)
                for kind, pick in picks.items():
                    walls[kind] += [1e3 * t["wall_s"] for t in eng.tick_trace
                                    if pick(t)]
            log(f"{label} {fmt} greedy graph: streams {digest}; " + "; ".join(
                f"{kind} tick median {np.median(ms):.2f} ms (quartiles "
                f"{np.percentile(ms, 25):.2f}-{np.percentile(ms, 75):.2f}, "
                f"n {len(ms)})" for kind, ms in walls.items()))
        del eng
        torch.cuda.empty_cache()

# ---------------------------------------------------------------------------
_OTHER = {"mx_matmul": "mx_matmul_int4", "mx_matmul_int4": "mx_matmul"}


def _proj_shapes(cfg):
    """{(K, N): count} of one scan group's projection weights (one layer's
    but for jamba; a MoE layer's expert leaves count once per expert; an
    encoder-decoder's one encoder and one decoder layer)."""
    from repro_torch.models import encdec, transformer
    if cfg.family == "encdec":
        shapes = encdec.param_shapes(cfg)
        groups = [(shapes[k]["blocks"][0], encdec.projections(cfg, k))
                  for k in ("encoder", "decoder")]
    else:
        groups = [(block, transformer.projections(cfg, j)) for j, block in
                  enumerate(transformer.param_shapes(cfg)["blocks"])]
    out = {}
    for block, subs in groups:
        for sub, names in subs.items():
            node = block
            for key in sub.split("."):
                node = node[key]
            for name in names:
                shape, _ = node[name]
                k, n = shape[-2:]
                per = shape[1] if len(shape) == 4 else 1
                out[(k, n)] = out.get((k, n), 0) + per
    return out


def _per_layer(cfg) -> int:
    """B1/B2 launches per layer of one executable: a scan group's
    projections over its layers (jamba's groups mix Mamba, attention, MoE
    and MLP layers)."""
    total = sum(_proj_shapes(cfg).values())
    if total % cfg.scan_group:
        fail(f"{cfg.name}: {total} projections do not split over "
             f"{cfg.scan_group} layers")
    return total // cfg.scan_group


def phase_family_kernels(seed: int, archs=FAMILY, ms_=FAMILY_MS,
                         cases=KERNEL_CASES):
    """B1 (mxint8, mxfp8) and B2 (mxint4), or the (kernel, format)
    ``cases``, at every projection shape of ``archs`` (starcoder2-3b and
    qwen2-72b; the mixtral configs' attention and expert shapes in phase
    15; mxfp6 and mxfp4 at smollm-135m's and qwen3-4b's in phase 21), at
    each M of ``ms_`` (4: the decode body; 256: the tiled body), held
    against their plain versions (the
    tolerance of phase 3) and timed beside the plain version, torch.matmul
    of the densified bf16 weight and the bound. Returns one record per
    case."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.formats import get_format
    from repro_torch.core.mx import dequantize, quantize
    from repro_torch.kernels import mx_matmul, ref
    from repro_torch.serve.packed_params import pack_leaf_int4

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    rows = []
    log(f"family kernel phase: B1 / B2 at the {' and '.join(archs)} "
        f"projection shapes, M {ms_}, device ms per call as in phase 3")
    log(f"{'arch':14s}{'kernel':16s}{'fmt':8s}{'M':>4s}{'K':>6s}{'N':>6s}"
        f"{'max_err':>11s}{'ms':>9s}{'plain':>9s}{'torch_bf16':>11s}"
        f"{'bound':>9s} by")
    for arch in archs:
        for (k, n), mult in _proj_shapes(get_config(arch)).items():
            w = torch.randn((k, n), generator=gen, device=dev) * 0.02
            for name, fname in cases:
                int4 = name == "mx_matmul_int4"
                t = quantize(w, get_format(fname, 32), axis=0)
                if int4:
                    codes = pack_leaf_int4(t).packed
                    kern, plain = mx_matmul.mx_matmul_int4, \
                        ref.ref_mx_matmul_int4
                else:
                    codes = t.codes
                    kern, plain = mx_matmul.mx_matmul, ref.ref_mx_matmul
                scales = t.scale_exp
                wbytes = codes.numel() + scales.numel()
                n_copy = max(1, min(64, math.ceil(128e6 / wbytes)))
                copies = [(codes.clone(), scales.clone())
                          for _ in range(n_copy)]
                n_dense = max(1, min(16, math.ceil(128e6 / (2 * k * n))))
                w_bf16 = dequantize(t, torch.bfloat16)
                dense = [w_bf16.clone() for _ in range(n_dense)]
                for m in ms_:
                    x = torch.randn((m, k), generator=gen,
                                    device=dev).to(torch.bfloat16)
                    got = kern(x, codes, scales, t.fmt)
                    want = plain(x, codes, scales, t.fmt)
                    torch.cuda.synchronize()
                    scale = float(want.abs().max())
                    err = float((got - want).abs().max())
                    if not torch.allclose(got, want, rtol=1e-4,
                                          atol=1e-4 * scale):
                        fail(f"{arch} {name}[{fname}] M={m} K={k} N={n}: "
                             f"max abs err {err:.3g} vs max|plain| "
                             f"{scale:.3g}")
                    ms = cuda_time_ms(lambda i: kern(
                        x, copies[i % n_copy][0], copies[i % n_copy][1],
                        t.fmt), 50)
                    plain_ms = cuda_time_ms(
                        lambda i: plain(x, codes, scales, t.fmt), 3)
                    lib_ms = cuda_time_ms(
                        lambda i: torch.matmul(x, dense[i % n_dense]), 50)
                    t_bytes = (wbytes + m * k * 2 + m * n * 4) \
                        / HBM_BYTES_PER_S * 1e3
                    t_ops = 2 * m * k * n / BF16_FLOP_PER_S * 1e3
                    by = "bytes" if t_bytes >= t_ops else "operations"
                    rows.append(dict(
                        arch=arch, kernel=name, format=fname, M=m, K=k, N=n,
                        per_layer=mult, max_abs_err=err, ms=ms,
                        plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=max(t_bytes, t_ops), bound_by=by))
                    log(f"{arch:14s}{name:16s}{fname:8s}{m:4d}{k:6d}{n:6d}"
                        f"{err:11.3g}{ms:9.4f}{plain_ms:9.4f}{lib_ms:11.4f}"
                        f"{max(t_bytes, t_ops):9.4f} {by}")
                del copies, dense, w_bf16, t, codes, scales
            del w
            torch.cuda.empty_cache()
    for arch in archs:
        for name, fname in cases:
            for m in ms_:
                sel = [r for r in rows if (r["arch"], r["kernel"],
                                           r["format"], r["M"])
                       == (arch, name, fname, m)]
                tot = {key: sum(r["per_layer"] * r[key] for r in sel)
                       for key in ("ms", "plain_ms", "library_ms",
                                   "bound_ms")}
                log(f"one {arch} scan group's "
                    f"{sum(r['per_layer'] for r in sel)} "
                    f"projections at M={m}, {name}[{fname}]: "
                    f"{tot['ms']:.4f} ms (bound {tot['bound_ms']:.4f} ms, "
                    f"{100 * tot['bound_ms'] / tot['ms']:.1f}% of it; plain "
                    f"{tot['plain_ms']:.4f} ms; torch bf16 "
                    f"{tot['library_ms']:.4f} ms)")
    return rows


def _slo_trace(vocab: int, seed: int, tpot_ms: float):
    """12 requests, 4 per tier, prompts of 16-64 tokens (one chunk each),
    arrivals spread over ticks 0-20 with a burst of four at tick 12; the
    latency tier carries the TPOT budget ``tpot_ms``."""
    import numpy as np
    from repro_torch.serve.engine import Request
    from repro_torch.serve.slo import SLOClass
    rng = np.random.default_rng(seed + 22)
    tiers = rng.permutation(["latency"] * 4 + ["throughput"] * 4
                            + ["best_effort"] * 4).tolist()
    arrivals = sorted(rng.integers(0, 21, size=8).tolist() + [12] * 4)
    slos = {"latency": SLOClass.latency(ttft_ms=SLO_TTFT_MS["latency"],
                                        tpot_ms=tpot_ms),
            "throughput": SLOClass.throughput(
                ttft_ms=SLO_TTFT_MS["throughput"]),
            "best_effort": SLOClass.best_effort()}
    return [Request(rid=i, prompt=rng.integers(
        0, vocab, size=int(rng.integers(16, 65))).astype(np.int32),
        max_new=MAX_NEW, slo=slos[tier], tenant=tier, arrival_tick=tick)
        for i, (tier, tick) in enumerate(zip(tiers, arrivals))]


def _check_tier_order(what: str, reqs) -> None:
    """Among the requests that had arrived by a tick, none of a lower tier
    was admitted at it while one of a higher tier waited."""
    from repro_torch.serve.slo import tier_rank
    for r in reqs:
        for q in reqs:
            if q.arrival_tick <= r.admitted_tick < q.admitted_tick and \
                    tier_rank(q.slo) < tier_rank(r.slo):
                fail(f"{what}: rid {r.rid} ({r.slo.tier}) admitted at tick "
                     f"{r.admitted_tick} while rid {q.rid} ({q.slo.tier}, "
                     f"arrived at {q.arrival_tick}) waited")


def phase_slo(cfg, anchor, seed: int):
    """SLO-tiered serving on the paged graph engine with a cost model
    seeded from the roofline and calibrated online; returns the launches
    of B1-B5 over its rounds."""
    import numpy as np
    import torch
    from repro_torch.kernels import mx_matmul
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.transformer import make_model
    from repro_torch.serve.engine import ElasticEngine
    from repro_torch.serve.policy import FormatPolicy
    from repro_torch.serve.slo import TIERS, CostModel

    cost = CostModel.from_roofline(cfg, SLO_FMTS, max_len=MAX_LEN,
                                   kv_layout="paged", kv_page_size=PAGE)
    log(f"SLO phase: {cfg.n_layers} layers, paged graph engine "
        f"(admission_order='slo'), CostModel.from_roofline at "
        f"{cost.hbm_bytes_per_s:.3g} B/s; raw roofline terms " + ", ".join(
            f"{f} {1e3 * cost.terms[f].base_s:.3f} ms + "
            f"{1e3 * cost.terms[f].per_row_s:.4f} ms/row" for f in SLO_FMTS))
    eng = ElasticEngine(make_model(cfg), anchor, batch_slots=SLOTS,
                        max_len=MAX_LEN, kv_layout="paged",
                        kv_page_size=PAGE, prefill_chunk=CHUNK,
                        policy=FormatPolicy(cost=cost),
                        admission_order="slo", device="cuda")
    _reset_quant_launches()
    totals = {}
    walls = {f: [] for f in SLO_FMTS}
    pure = lambda t: t["decode"] and not t["prefill_chunks"]
    rnd = 0
    for tpot, n_rounds in SLO_ROUNDS:
        for _ in range(n_rounds):
            reqs = _slo_trace(cfg.vocab, seed, tpot)
            h0 = len(eng.policy.history)
            mx_matmul.reset_launches()
            pa.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.generate(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            what = f"SLO round {rnd} (TPOT {tpot} ms)"
            trace = eng.tick_trace
            _check_launches(what, trace, cfg.n_layers,
                            dict(mx_matmul.launches), dict(pa.launches))
            for k, v in {**mx_matmul.launches, **pa.launches}.items():
                totals[k] = totals.get(k, 0) + v
            bad = [r.rid for r in reqs if r.status.value != "completed"
                   or len(r.out_tokens) != MAX_NEW]
            if bad:
                fail(f"{what}: requests {bad} incomplete")
            _check_tier_order(what, reqs)
            picks = eng.policy.history[h0:]
            if len(set(picks)) == 1:
                walls[picks[0]] += [1e3 * t["wall_s"] for t in trace
                                    if pure(t)]
            idle = sum(1 for t in trace if not t["execs"])
            tiers = []
            for tier in TIERS:
                sel = [r for r in reqs if r.slo.tier == tier]
                budget = SLO_TTFT_MS.get(tier)
                ttft = [1e3 * (r.ttft_s - r.arrival_s) for r in sel]
                met = "-" if budget is None else \
                    f"{sum(v <= budget for v in ttft)}/{len(sel)}"
                tiers.append(
                    f"{tier}: TTFT ms {[round(v, 1) for v in ttft]} "
                    f"(budget {budget}, met {met}), "
                    f"{sum(len(r.out_tokens) for r in sel) / wall:.1f} "
                    "tok/s")
            log(f"{what}: picks {picks}, admitted ticks "
                f"{[r.admitted_tick for r in reqs]} (arrivals "
                f"{[r.arrival_tick for r in reqs]}), {len(trace)} ticks of "
                f"which {idle} idle, pure decode tick "
                f"{_tick_wall(trace, pure)}; {'; '.join(tiers)}; wave "
                f"{sum(len(r.out_tokens) for r in reqs) / wall:.1f} tok/s")
            rnd += 1
    st = eng.stats()
    if st["kv_pages_alloc"] != st["kv_pages_freed"]:
        fail(f"SLO phase: pages alloc {st['kv_pages_alloc']} != freed "
             f"{st['kv_pages_freed']}")
    log(f"SLO phase: policy history {eng.policy.history}")
    snap = st["cost_model"]
    for f in SLO_FMTS:
        term = snap[f]
        med = f"{np.median(walls[f]):.2f} ms (n {len(walls[f])})" \
            if walls[f] else "not pinned alone"
        log(f"SLO cost model {f}: predict_ms at 1 / {SLOTS} rows "
            f"{cost.predict_ms(f, 1):.3f} / {cost.predict_ms(f, SLOTS):.3f} "
            f"ms; factor {term['factor']:.3f} over "
            f"{term['ticks_observed']} ticks; raw "
            f"{1e3 * cost.raw_predict_s(f, SLOTS):.4f} ms at {SLOTS} rows; "
            f"measured median pure decode tick {med}")
        if f in st["weight_bytes"]:
            wb = st["weight_bytes"][f]
            if not math.isclose(term["base_s"] * cost.hbm_bytes_per_s, wb,
                                rel_tol=1e-12):
                fail(f"SLO phase {f}: base_s x hbm = "
                     f"{term['base_s'] * cost.hbm_bytes_per_s} != "
                     f"weight_bytes {wb}")
        if f in eng.policy.history and not cost.measured(f):
            fail(f"SLO phase: {f} was pinned but never measured "
                 f"({term['ticks_observed']} clean ticks)")
    counts = _quant_launches()
    builds = sum(1 for f in st["formats_cached"] if f != anchor.fmt_name)
    want = {"mx_quantize": 0, "ss_convert": PROJ_PER_LAYER * builds,
            "fake_quant": 0}
    if counts != want:
        fail(f"SLO phase: kernel launches {counts}, want {want}")
    log(f"SLO phase: formats built {st['formats_cached']}, launches "
        f"{totals} and {counts}")
    del eng
    torch.cuda.empty_cache()
    return {**totals, **counts}


def _dense_waves(name, cfg, api, eng, fmt, per_layer, seed, totals):
    """One format on a dense graph engine: the prefill's and the first
    decode tick's logits through the kernel and the densify contracts
    (that tick fed the kernel path's token on both sides) within
    FUSED_TOL of max|logit|; 8 greedy requests complete; B1/B2 launches
    ``per_layer`` x layers per executable, the other kernel none;
    weight-stream bytes within 2% of ``serve_weight_stream_bytes``;
    streams equal to an eager twin's; then a timed wave (decode tick wall,
    tok/s, TTFT). A MoE config's contracts are gated in f32 and reported
    in bf16: routing is a discrete function of the router's logits, so a
    bf16 rounding difference upstream can flip a token's experts and move
    the logits by a routed expert's whole output; so are an RWKV stack's,
    whose recurrence carries each token's rounding through the prompt.
    The weight bytes are held against the reference's term plus the leaves
    it counts otherwise (``mamba_leaf_bytes``, ``rwkv_leaf_bytes``: the
    residue, reported). Adds B1/B2 launches to ``totals``."""
    import dataclasses

    import torch
    from repro_torch.kernels import mx_matmul
    from repro_torch.launch.costmodel import (mamba_leaf_bytes,
                                              rwkv_leaf_bytes,
                                              serve_weight_stream_bytes)
    from repro_torch.models.transformer import make_model

    kernel = "mx_matmul_int4" if fmt == "mxint4" else "mx_matmul"
    weights = eng.weights_for(fmt)
    prompt = _requests(cfg.vocab, seed)[0].prompt
    contracts = [("bf16", weights, api)]
    if getattr(cfg, "moe_experts", 0) > 0 or cfg.family == "ssm":
        contracts.append(("f32", _as_f32(weights), make_model(
            dataclasses.replace(cfg, compute_dtype=torch.float32))))
    for dtype, wts, capi in contracts:
        got, flips = _contract_logits(capi, wts, prompt)
        gated = dtype == contracts[-1][0]
        for step, (a, b) in enumerate(zip(got["kernel"], got["densify"])):
            diff = float((a - b).abs().max())
            ref_max = float(b.abs().max())
            n_flip, n_tok = flips[step]
            log(f"{name} {fmt} {dtype} step {step} logits: max|kernel - "
                f"densify| = {diff:.4g}, max|densify| = {ref_max:.4g}, "
                f"argmax {int(a.argmax())} vs {int(b.argmax())}"
                + (f"; router picks differing in {n_flip} of {n_tok} "
                   "(layer, token) pairs" if n_tok else ""))
            if not torch.isfinite(a).all() or (
                    gated and diff > FUSED_TOL * ref_max):
                fail(f"{name} {fmt} {dtype} step {step}: kernel logits "
                     f"differ from densify by {diff:.4g} > {FUSED_TOL} * "
                     f"{ref_max:.4g}, or are not finite")
    del contracts, wts, capi
    reqs = _requests(cfg.vocab, seed)
    mx_matmul.reset_launches()
    wall = _timed_wave(eng, reqs, fmt)
    mm = dict(mx_matmul.launches)
    _check_launches(f"{name} {fmt}", eng.tick_trace, cfg.n_layers, mm,
                    per_layer=per_layer)
    if mm[_OTHER[kernel]]:
        fail(f"{name} {fmt}: launches {mm} ran the other kernel")
    for k, v in mm.items():
        totals[k] = totals.get(k, 0) + v
    bad = [r.rid for r in reqs if r.status.value != "completed"
           or len(r.out_tokens) != MAX_NEW]
    if bad:
        fail(f"{name} {fmt}: requests {bad} incomplete")
    st = eng.stats()
    term = serve_weight_stream_bytes(cfg, fmt)
    residue = mamba_leaf_bytes(cfg, fmt) + rwkv_leaf_bytes(cfg, fmt)
    want_bytes = term + residue
    rel = st["weight_bytes"][fmt] / want_bytes - 1
    if abs(rel) > 0.02:
        fail(f"{name} {fmt}: weight bytes {st['weight_bytes'][fmt]} off "
             f"the roofline term {want_bytes:.0f} by {100 * rel:.2f}%")
    twin = _eager_twin(eng)
    treqs = _requests(cfg.vocab, seed)
    twin.generate(treqs, fmt_override=fmt)
    _check_same_streams(f"{name} {fmt}", reqs, treqs)
    del twin
    reqs = _requests(cfg.vocab, seed)
    wall2 = _timed_wave(eng, reqs, fmt)
    total = sum(len(r.out_tokens) for r in reqs)
    tick = _tick_wall(eng.tick_trace, lambda t: t["decode"]
                      and not t["prefill_tokens"])
    log(f"{name} {fmt} dense graph engine, {cfg.n_layers} layers: "
        f"capturing wave {wall:.2f} s; timed wave {total} tokens in "
        f"{wall2:.3f} s = {total / wall2:.1f} tok/s; decode tick {tick}; "
        f"TTFT s {[round(r.ttft_s, 3) for r in reqs]}; weight-stream bytes "
        f"{st['weight_bytes'][fmt]} ({100 * rel:+.2f}% of the roofline "
        f"term {term:.0f} + residue {residue:.0f}); streams equal to the eager twin's; launches {mm} (want "
        f"{per_layer} x {cfg.n_layers} x executables); peak allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


def phase_dense_family(seed: int):
    """starcoder2-3b at full width and depth on the dense graph engine at
    mxint8 and mxint4, and qwen2-72b at full width and depth
    ``QWEN2_LAYERS`` at mxint8; returns the launches of B1, B2, B5, B6."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import make_model
    from repro_torch.serve.engine import ElasticEngine

    totals = {}
    for arch, depth, fmts in (("starcoder2-3b", None, ("mxint8", "mxint4")),
                              ("qwen2-72b", QWEN2_LAYERS, ("mxint8",))):
        cfg = get_config(arch)
        if depth is not None:
            log(f"DEPTH CUT: {arch} serves {depth} of {cfg.n_layers} layers "
                "(widths unchanged; not a multiple of 32, so the stacked "
                "biases stay raw)")
            cfg = dataclasses.replace(cfg, n_layers=depth)
        per_layer = sum(_proj_shapes(cfg).values())
        _reset_quant_launches()
        torch.cuda.reset_peak_memory_stats()
        anchor = build_anchor(cfg, seed, save=False)
        log(f"{arch}: anchor peak allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        biases = [k for k in list(anchor.raw) + list(anchor.quantized)
                  if k.endswith(("['bq']", "['bk']", "['bv']", "['b_up']",
                                 "['b_down']"))]
        if not biases or any(k not in anchor.raw for k in biases):
            fail(f"{arch}: bias leaves {biases} not all raw in the anchor")
        api = make_model(cfg)
        eng = ElasticEngine(api, anchor, batch_slots=SLOTS, max_len=MAX_LEN,
                            device="cuda")
        for fmt in fmts:
            _dense_waves(arch, cfg, api, eng, fmt, per_layer, seed, totals)
        counts = _quant_launches()
        want = {"mx_quantize": per_layer,
                "ss_convert": per_layer * sum(f != "mxint8" for f in fmts),
                "fake_quant": 0}
        if counts != want:
            fail(f"{arch}: anchor and format builds launched {counts}, "
                 f"want {want}")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        del eng, anchor, api
        torch.cuda.empty_cache()
    return totals


def phase_train_ab(seed: int):
    """smollm-135m runs A and B of phase 6, each with its step split into
    parts (``_step_breakdown``), and nothing else: run on two trees in one
    call (``--src``), the same-call A/B of the training step."""
    from repro_torch.configs import get_config
    from repro_torch.core.formats import TRAIN_FORMATS_MXINT
    from repro_torch.core.qat import QATConfig

    cfg = get_config("smollm-135m")
    direct = QATConfig(formats=TRAIN_FORMATS_MXINT)
    anchored = QATConfig(formats=TRAIN_FORMATS_MXINT, anchor="mxint8")
    state, _, _, _, _ = _train(
        "run A (sequential MXINT 2/4/6/8, 2 steps each)", cfg, direct,
        "multiformat", 8, seed)
    _step_breakdown("smollm-135m run A", cfg, direct, state, seed)
    del state
    state, _, _, _, _ = _train(
        "run B (anchored mxint8, interleaved targets)", cfg, anchored,
        "interleaved", 4, seed + 1)
    _step_breakdown("smollm-135m run B", cfg, anchored, state, seed + 1)


def _as_f32(tree):
    """A served tree with its raw float leaves in f32 (packed leaves, the
    same codes and scales, shared)."""
    import torch
    from repro_torch.serve.packed_params import is_packed_leaf
    if isinstance(tree, dict):
        return {k: _as_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_f32(v) for v in tree]
    if is_packed_leaf(tree) or not tree.is_floating_point():
        return tree
    return tree.to(torch.float32)


def _routing_recorder():
    """Wrap the MoE block's top-k (``layers._topk_stable``) to record the
    router's picks (B, S, k) of every call, in call order; returns (picks,
    undo)."""
    from repro_torch.models import layers as L
    real = L._topk_stable
    picks = []

    def rec(x, k):
        vals, idx = real(x, k)
        if len(picks) % 2 == 0:             # router, then the capacity pick
            picks.append(idx.sort(-1).values.cpu())
        else:
            picks.append(None)
        return vals, idx

    L._topk_stable = rec
    return picks, lambda: setattr(L, "_topk_stable", real)


def _contract_logits(api, weights, prompt):
    """The prefill's logits and the first decode tick's (fed the kernel
    path's argmax on both sides) under the kernel and the densify
    contracts, and per step (router picks that differ, (layer, token)
    pairs routed): (0, 0) for a model with no MoE layer."""
    import torch
    from repro_torch.kernels.dispatch import make_qmm
    batch = {"tokens": torch.as_tensor(prompt[None], device="cuda")}
    got, routes, nxt = {}, {}, None
    for mode in ("kernel", "densify"):
        mapi = api.with_qmm(make_qmm(mode))
        cache = mapi.init_cache(1, MAX_LEN, device="cuda")
        picks, undo = _routing_recorder()
        try:
            lg, cache, clen = mapi.prefill_slot(weights, batch, cache, 0)
            n_pre = len(picks)
            if nxt is None:
                nxt = torch.argmax(lg)[None, None].to(torch.int32)
            lg2, _ = mapi.serve_step(weights, {"tokens": nxt}, cache,
                                     clen[None])
        finally:
            undo()
        got[mode] = (lg.float(), lg2[0].float())
        routes[mode] = ([p for p in picks[:n_pre] if p is not None],
                        [p for p in picks[n_pre:] if p is not None])
        del cache
    flips = []
    for step in range(2):
        a, b = routes["kernel"][step], routes["densify"][step]
        diff = sum(int((x != y).any(-1).sum()) for x, y in zip(a, b))
        total = sum(x.shape[0] * x.shape[1] for x in a)
        flips.append((diff, total))
    return got, flips


def _long_request(vocab: int, seed: int):
    import numpy as np
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(seed + 5)
    return Request(rid=N_REQ, prompt=rng.integers(
        0, vocab, size=LONG_PROMPT).astype(np.int32), max_new=LONG_NEW)


def _long_first_decode(api, weights, cfg, seed: int, time_b3=True):
    """The long request alone in a one-slot paged cache (pages of PAGE,
    a random page permutation): its prompt prefilled in one piece (flash
    attention, banded: the prompt exceeds the window), then its first
    decode tick through B3 (``paged_kernel``) and through the gather
    contract on a copy of the cache; and B3 alone on layer 0's pools,
    timed with the window and without it. Returns (kernel logits, gather
    logits, B3 ms windowed, B3 ms unwindowed, B3 against its plain
    version's max abs error)."""
    import numpy as np
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.kernels.dispatch import make_qmm

    dev = torch.device("cuda")
    kapi = api.with_serving(make_qmm("kernel"), "paged_kernel")
    gapi = api.with_serving(make_qmm("kernel"), "gather")
    req = _long_request(cfg.vocab, seed)
    cache = kapi.init_cache(1, LONG_MAX_LEN, device=dev, kv_layout="paged",
                            page_size=PAGE)
    mp = cache["block_table"].shape[1]
    perm = np.random.default_rng(seed + 6).permutation(np.arange(1, mp + 1))
    cache["block_table"].copy_(torch.from_numpy(
        perm[None].astype(np.int32)))
    batch = {"tokens": torch.as_tensor(req.prompt[None], device=dev)}
    lg, cache, clen = kapi.prefill_slot(weights, batch, cache, 0)
    nxt = torch.argmax(lg)[None, None].to(torch.int32)
    twin = {"blocks": [{k: t.clone() for k, t in c.items()}
                       for c in cache["blocks"]],
            "block_table": cache["block_table"].clone()}
    got, _ = kapi.serve_step(weights, {"tokens": nxt}, cache, clen[None])
    want, _ = gapi.serve_step(weights, {"tokens": nxt}, twin, clen[None])
    if not time_b3:
        return got[0].float(), want[0].float(), None, None, None
    # B3 on layer 0's pools as the first decode tick reads them
    kp = cache["blocks"][0]["k_pages"][0]
    vp = cache["blocks"][0]["v_pages"][0]
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    q = torch.randn((1, cfg.n_heads, cfg.hd), generator=gen,
                    device=dev).to(kp.dtype)
    lens = (clen + 1).reshape(1).to(torch.int32)
    bt = cache["block_table"]
    win = cfg.sliding_window
    out = pa.paged_attention(q, kp, vp, bt, lens, win).float()
    ref_out = ref.ref_paged_attention(q, kp, vp, bt, lens, win).float()
    err = float((out - ref_out).abs().max())
    if not torch.allclose(out, ref_out, rtol=1e-4,
                          atol=1e-4 * float(ref_out.abs().max())):
        fail(f"B3 with window {win} on the long request: max abs err "
             f"{err:.3g} against its plain version")
    win_ms = cuda_time_ms(lambda i: pa.paged_attention(
        q, kp, vp, bt, lens, win), 50)
    full_ms = cuda_time_ms(lambda i: pa.paged_attention(
        q, kp, vp, bt, lens, None), 50)
    return got[0].float(), want[0].float(), win_ms, full_ms, err


def phase_moe_serving(seed: int):
    """mixtral-8x7b at full width and depth MOE_LAYERS: an MXINT8 anchor
    through B6, the dense graph engine at mxint8 and mxint4 (logits of the
    prefill and first decode tick against densify, 8 greedy requests,
    launches, streams against an eager twin, weight bytes against the
    roofline term, tick wall, tok/s, TTFT), then the paged graph engine
    (mixed scheduler) at mxint8 on the same 8 requests plus one of
    LONG_PROMPT tokens whose decode reads only the window. Returns the
    launches of B1-B6."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import mx_matmul
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.transformer import make_model
    from repro_torch.serve.engine import ElasticEngine

    full = get_config("mixtral-8x7b")
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    log(f"DEPTH CUT: mixtral-8x7b serves {MOE_LAYERS} of {full.n_layers} "
        "layers (widths unchanged): about 6 B per parameter at init (f32 "
        "weights, then the anchor), so 6.07 B parameters need about 36 GB; "
        "all 32 layers (46.7 B) would not fit one 80 GB card")
    per_layer = sum(_proj_shapes(cfg).values())        # 4 + 3 x E
    totals = {}
    _reset_quant_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    anchor = build_anchor(cfg, seed, save=False)
    log(f"mixtral-8x7b: anchor built in {time.perf_counter() - t0:.1f} s, "
        f"peak allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if "['blocks'][0]['moe']['router']" not in anchor.raw or not all(
            f"['blocks'][0]['moe']['experts']['{n}']" in anchor.quantized
            for n in ("w_gate", "w_up", "w_down")):
        fail("mixtral-8x7b: the router is not raw or an expert leaf is not "
             "quantized in the anchor")
    api = make_model(cfg)
    eng = ElasticEngine(api, anchor, batch_slots=SLOTS, max_len=MAX_LEN,
                        device="cuda")
    for fmt in ("mxint8", "mxint4"):
        _dense_waves("mixtral-8x7b", cfg, api, eng, fmt, per_layer, seed,
                     totals)
    del eng
    torch.cuda.empty_cache()

    log(f"mixtral-8x7b paged graph engine: ElasticEngine(batch_slots="
        f"{SLOTS}, max_len={LONG_MAX_LEN}, kv_layout='paged', kv_page_size="
        f"{PAGE}, prefill_chunk={CHUNK}), the {N_REQ} requests and one of "
        f"{LONG_PROMPT} prompt tokens (+{LONG_NEW}), window "
        f"{cfg.sliding_window}")
    peng = ElasticEngine(api, anchor, batch_slots=SLOTS,
                         max_len=LONG_MAX_LEN, kv_layout="paged",
                         kv_page_size=PAGE, prefill_chunk=CHUNK,
                         device="cuda")
    if (peng.scheduler, peng.attn_impl) != ("mixed", "paged_kernel"):
        fail(f"paged engine resolved to {peng.scheduler}/{peng.attn_impl}")
    fmt = "mxint8"
    weights = peng.weights_for(fmt)
    got, want, win_ms, full_ms, b3_err = _long_first_decode(
        api, weights, cfg, seed)
    diff = float((got - want).abs().max())
    ref_max = float(want.abs().max())
    # the same in f32 (the gate; bf16 is reported: a rounding difference
    # can flip the decode token's experts)
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    got32, want32, _, _, _ = _long_first_decode(
        make_model(cfg32), _as_f32(weights), cfg32, seed, time_b3=False)
    diff32 = float((got32 - want32).abs().max())
    ref32 = float(want32.abs().max())
    length = LONG_PROMPT + 1
    mp = -(-LONG_MAX_LEN // PAGE)
    first, last = pa.walk(length - 1, 1, 0, 1, 1, PAGE, mp,
                          cfg.sliding_window)
    clamped = pa.pages_read(length, PAGE, cfg.sliding_window)
    unclamped = pa.pages_read(length, PAGE)
    log(f"long request's first decode tick ({length} positions): "
        f"max|paged_kernel - gather| = {diff:.4g} in bf16 (max|gather| "
        f"{ref_max:.4g}, argmax {int(got.argmax())} vs "
        f"{int(want.argmax())}), {diff32:.4g} in f32 (max|gather| "
        f"{ref32:.4g}); B3's walk pages {first}..{last} = "
        f"{last - first + 1} (pages_read with the window {clamped}, without "
        f"{unclamped}); B3 on layer 0 {win_ms:.4f} ms with the window, "
        f"{full_ms:.4f} ms without (CUDA events), max abs err against its "
        f"plain version {b3_err:.3g}")
    if not (torch.isfinite(got).all() and diff32 <= FUSED_TOL * ref32):
        fail(f"long request: paged_kernel logits differ from gather by "
             f"{diff32:.4g} > {FUSED_TOL} * {ref32:.4g} in f32")
    if last - first + 1 != clamped or clamped >= unclamped:
        fail(f"long request: B3's walk {first}..{last} is not the window's "
             f"{clamped} pages (of {unclamped})")
    reqs = _requests(cfg.vocab, seed) + [_long_request(cfg.vocab, seed)]
    before = peng.stats()
    mx_matmul.reset_launches()
    pa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    wall = _timed_wave(peng, reqs, fmt)
    mm, at = dict(mx_matmul.launches), dict(pa.launches)
    st = peng.stats()
    trace = peng.tick_trace
    _check_launches(f"mixtral-8x7b paged {fmt}", trace, cfg.n_layers, mm,
                    at=at, per_layer=per_layer)
    if max(t["execs"] for t in trace) > 1:
        fail("mixtral-8x7b paged: a tick ran more than one executable")
    bad = [r.rid for r in reqs if r.status.value != "completed"
           or len(r.out_tokens) != r.max_new]
    if bad or st["faults_detected"] != before["faults_detected"]:
        fail(f"mixtral-8x7b paged: requests {bad} incomplete or a guard "
             "fault")
    if st["kv_pages_alloc"] != st["kv_pages_freed"]:
        fail(f"mixtral-8x7b paged: pages alloc {st['kv_pages_alloc']} != "
             f"freed {st['kv_pages_freed']} at drain")
    for k, v in list(mm.items()) + list(at.items()):
        totals[k] = totals.get(k, 0) + v
    pure = [t for t in trace if t["decode"] and not t["prefill_chunks"]]
    mixed = [t for t in trace if t["decode"] and t["prefill_chunks"]]
    ms = lambda ts: 1e3 * float(np.mean([t["wall_s"] for t in ts]))
    total = sum(len(r.out_tokens) for r in reqs)
    log(f"mixtral-8x7b paged {fmt}: {len(trace)} ticks ({len(pure)} pure "
        f"decode, {len(mixed)} mixed); {total} tokens in {wall:.2f} s = "
        f"{total / wall:.1f} tok/s; pure decode tick {ms(pure):.2f} ms, "
        f"mixed tick {ms(mixed):.2f} ms (host wall); TTFT s "
        f"{[round(r.ttft_s, 3) for r in reqs]}; attn_read_bytes "
        f"{st['attn_read_bytes'] - before['attn_read_bytes']} (the engine "
        f"counts pages_read with the window); kv_pages_hwm "
        f"{st['kv_pages_hwm']}; launches {mm} {at}; peak allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    twin = _eager_twin(peng)
    treqs = _requests(cfg.vocab, seed) + [_long_request(cfg.vocab, seed)]
    twin.generate(treqs, fmt_override=fmt)
    _check_same_streams(f"mixtral-8x7b paged {fmt}", reqs, treqs)
    log("mixtral-8x7b paged: streams equal to the eager twin's")
    del twin, peng, weights
    counts = _quant_launches()
    want = {"mx_quantize": per_layer - 3 * (cfg.moe_experts - 1),
            "ss_convert": per_layer - 3 * (cfg.moe_experts - 1),
            "fake_quant": 0}
    log(f"mixtral-8x7b anchor and format builds: launches {counts} (want "
        f"{want}: one per stacked leaf, 4-D expert leaves included)")
    if counts != want:
        fail(f"mixtral-8x7b: anchor and format builds launched {counts}, "
             f"want {want}")
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v
    del anchor, api
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def _fb_peak(cfg, qat, params, seq: int, seed: int):
    """Forward and backward of one batch (seq x 1) from ``params``: the
    rise of the peak allocation over what is allocated before (the
    activations the backward keeps, the gradients included) and the CUDA
    event ms. The step's own peak is AdamW's (old and new state trees
    alive at once), the same in every setting."""
    import torch
    from repro_torch.core.tree import flatten_paths, unflatten_paths
    from repro_torch.models.transformer import make_model
    api = make_model(cfg, qat=qat)
    flat = flatten_paths(params)
    leaves = [p.detach().requires_grad_(True) for _, p in flat]
    tree = unflatten_paths({k: p for (k, _), p in zip(flat, leaves)})
    gen = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (1, seq), generator=gen,
                         device="cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    loss, _ = api.train_loss(tree, {"tokens": toks, "labels": toks}, 1)
    grads = torch.autograd.grad(loss, leaves)
    end.record()
    torch.cuda.synchronize()
    rise = (torch.cuda.max_memory_allocated() - base) / 1e9
    del grads, loss, tree, leaves
    return rise, start.elapsed_time(end)


def phase_train_long(seed: int):
    """qwen3-4b at full width and depth 4, seq LONG_SEQ_LEVERS[0] x batch
    1, two steps in each of the four (flash_vjp, remat) settings; then at
    seq LONG_SEQ with both on; then mixtral-8x7b at full width, one layer,
    seq LONG_SEQ x batch 1 (the banded flash path: seq > window; B7 on the
    4-D expert leaves), direct MXINT. Step ms (CUDA events), peak
    allocated and finite losses; mixtral's aux loss > 0. Returns the B7
    launches."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.formats import TRAIN_FORMATS_MXINT
    from repro_torch.core.qat import QATConfig
    from repro_torch.models.flash_vjp import _plan
    from repro_torch.models.transformer import fake_quant_blocks, make_model

    direct = QATConfig(formats=TRAIN_FORMATS_MXINT)
    totals = {}
    qwen = dataclasses.replace(get_config("qwen3-4b"), n_layers=4)
    log("DEPTH CUT: long-sequence training runs qwen3-4b at 4 of 36 layers "
        "and mixtral-8x7b at 1 of 32 (widths unchanged)")
    seq, steps = LONG_SEQ_LEVERS
    rows = []
    for fv, rm in ((True, True), (True, False), (False, True),
                   (False, False)):
        cfg = dataclasses.replace(qwen, flash_vjp=fv, remat=rm)
        state, _, counts, ms, peak = _train(
            f"qwen3-4b seq {seq} flash_vjp={fv} remat={rm}", cfg, direct,
            "multiformat", steps, seed + 3, seq=seq, batch=1)
        before = _quant_launches()["fake_quant"]
        rise, fb_ms = _fb_peak(cfg, direct, state.params, seq, seed)
        _restore_fake_quant(before)
        rows.append((fv, rm, ms, peak, rise, fb_ms))
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        del state
        gc.collect()
        torch.cuda.empty_cache()
    for fv, rm, ms, peak, rise, fb_ms in rows:
        log(f"qwen3-4b depth 4 seq {seq} x 1: flash_vjp={fv!s:5s} "
            f"remat={rm!s:5s} step ms {np.round(ms, 2)} (last "
            f"{ms[-1]:.2f}), step peak {peak:.2f} GB; forward + backward "
            f"{fb_ms:.2f} ms, its peak {rise:.2f} GB above the weights "
            "(activations and gradients); the step's "
            + _bound(qwen, "train", seq, 1, fb_ms))
    h, hkv = qwen.n_heads, qwen.n_kv_heads
    log(f"qwen3-4b at seq {LONG_SEQ} with both levers off is not run: "
        f"autograd through prefill_attention keeps f32 (B, H, S, S) "
        f"tensors of {4 * h * LONG_SEQ ** 2 / 1e9:.1f} GB, at least two per "
        f"layer (the masked scores and the softmax), so >= "
        f"{8 * h * LONG_SEQ ** 2 / 1e9:.1f} GB per layer")
    state, hist, counts, ms, peak = _train(
        f"qwen3-4b seq {LONG_SEQ} (flash_vjp and remat on)", qwen, direct,
        "multiformat", 2, seed + 4, seq=LONG_SEQ, batch=1)
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v
    before = _quant_launches()["fake_quant"]
    rise, fb_ms = _fb_peak(qwen, direct, state.params, LONG_SEQ, seed)
    _restore_fake_quant(before)
    del state
    log(f"qwen3-4b depth 4 seq {LONG_SEQ} x 1: step ms {np.round(ms, 2)}, "
        f"step peak {peak:.2f} GB, losses "
        f"{[round(h_['loss'], 4) for h_ in hist]}; forward + backward "
        f"{fb_ms:.2f} ms, its peak {rise:.2f} GB above the weights; the "
        "step's " + _bound(qwen, "train", LONG_SEQ, 1, fb_ms))
    gc.collect()
    torch.cuda.empty_cache()

    mix = dataclasses.replace(get_config("mixtral-8x7b"), n_layers=1)
    cq, ck, _, _, banded, band, _ = _plan(LONG_SEQ, LONG_SEQ, True,
                                          mix.sliding_window, mix.seq_chunk)
    log(f"mixtral-8x7b 1 layer seq {LONG_SEQ}: flash_vjp chunks {cq} / "
        f"{ck}, banded={banded}, band {band} keys per query chunk (window "
        f"{mix.sliding_window}); about 1.71 B parameters x 16 B (f32 "
        "master, grad, m and v) = 27 GB")
    if not banded:
        fail("mixtral-8x7b at seq 8192 did not take the banded path")
    state, hist, counts, ms, peak = _train(
        f"mixtral-8x7b 1 layer seq {LONG_SEQ}", mix, direct, "multiformat",
        2, seed + 5, seq=LONG_SEQ, batch=1)
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v
    api = make_model(mix, qat=direct)
    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    toks = torch.randint(0, mix.vocab, (1, LONG_SEQ), generator=gen,
                         device="cuda")
    before = _quant_launches()["fake_quant"]
    with torch.no_grad():
        loss, parts = api.train_loss(state.params, {"tokens": toks,
                                                    "labels": toks}, 0)
    aux = float(parts["aux"])
    leaf = fake_quant_blocks(direct, 0, state.params, mix)[
        "blocks"][0]["moe"]["experts"]["w_up"]
    shape = tuple(leaf.shape)
    del leaf
    rise, fb_ms = _fb_peak(mix, direct, state.params, LONG_SEQ, seed)
    _restore_fake_quant(before)         # these are not steps of the run
    log(f"mixtral-8x7b 1 layer seq {LONG_SEQ} x 1: step ms "
        f"{np.round(ms, 2)}, step peak {peak:.2f} GB, losses "
        f"{[round(h_['loss'], 4) for h_ in hist]}, aux loss {aux:.6f}; B7 "
        f"fake-quantizes expert leaves of shape {shape}; forward + "
        f"backward {fb_ms:.2f} ms, its peak {rise:.2f} GB above the "
        "weights; the step's " + _bound(mix, "train", LONG_SEQ, 1, fb_ms))
    if not (math.isfinite(aux) and aux > 0 and math.isfinite(float(loss))):
        fail(f"mixtral-8x7b training: aux loss {aux}, loss {float(loss)}")
    del state, api
    gc.collect()
    torch.cuda.empty_cache()
    return totals


# ---------------------------------------------------------------------------
def _vlm_text_len(n: int) -> int:
    """The padded text length of an n-token llava prompt: 192 + 256 j, so
    S = 2880 + 192 + 256 j: 3072 = 3 x 1024 runs flash attention's
    1024-wide chunks as they are; 3328, which 1024 does not divide, runs
    them padded to 4096 (``models/flash_vjp.py::_plan``)."""
    p = 192
    while p < n:
        p += 256
    return p


def _vlm_batches(cfg, seed: int):
    """VLM_REQ requests: prompts of 16-200 tokens right-padded to
    ``_vlm_text_len`` with their true ``lengths``, each with its own
    (1, 2880, d) image embeddings from the seed, on the card."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed + 17)
    gen = torch.Generator(device="cuda").manual_seed(seed + 17)
    out = []
    for _ in range(VLM_REQ):
        n = int(rng.integers(16, 201))
        toks = np.zeros(_vlm_text_len(n), np.int32)
        toks[:n] = rng.integers(0, cfg.vocab, size=n)
        ve = (torch.randn((1, cfg.vision_tokens, cfg.d_model), generator=gen,
                          device="cuda") * 0.02).to(cfg.compute_dtype)
        out.append({"tokens": torch.as_tensor(toks[None], device="cuda"),
                    "lengths": torch.tensor([n], dtype=torch.int32,
                                            device="cuda"),
                    "vision_embeds": ve})
    return out


def _vlm_serve(label, api, weights, cfg, batches, layout, seed):
    """The batches through ``prefill_slot`` into one cache of VLM_REQ
    slots (``layout``), then VLM_STEPS greedy ``serve_step``s of all of
    them; the first step also through the densify contract on a copy of
    the cache (reported: in bf16 the two round each projection's output
    at different places; ``_vlm_contract`` gates in f32). Returns
    (streams, per-prefill ms,
    step wall ms, launches per step, the first step's logits error, the
    run's B1/B2/B3 launches)."""
    import numpy as np
    import torch
    from repro_torch.kernels import mx_matmul
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.dispatch import make_qmm

    paged = layout == "paged"
    impl = "paged_kernel" if paged else "gather"
    kapi = api.with_serving(make_qmm("kernel"), impl)
    kw = dict(kv_layout="paged", page_size=PAGE) if paged else {}
    cache = kapi.init_cache(VLM_REQ, VLM_MAX_LEN, device="cuda", **kw)
    if paged:
        mp = cache["block_table"].shape[1]
        perm = np.random.default_rng(seed + 18).permutation(
            np.arange(1, VLM_REQ * mp + 1)).reshape(VLM_REQ, mp)
        cache["block_table"].copy_(torch.from_numpy(perm.astype(np.int32)))
    mx_matmul.reset_launches()
    pa.reset_launches()
    pre_ms, firsts, lens = [], [], []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache, clen = kapi.prefill_slot(weights, batch, cache, i)
        firsts.append(int(torch.argmax(lg)))
        torch.cuda.synchronize()
        pre_ms.append(1e3 * (time.perf_counter() - t0))
        lens.append(int(clen))
    want_len = [cfg.vision_tokens + int(b["lengths"]) for b in batches]
    if lens != want_len:
        fail(f"{label} {layout}: cache_len {lens}, want {want_len}")
    tokens = torch.tensor(firsts, dtype=torch.int32, device="cuda")[:, None]
    cache_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    twin = {"blocks": [{k: t.clone() for k, t in c.items()}
                       for c in cache["blocks"]]}
    if paged:
        twin["block_table"] = cache["block_table"].clone()
    dapi = api.with_serving(make_qmm("densify"), impl)
    want, _ = dapi.serve_step(weights, {"tokens": tokens}, twin,
                              cache_len.clone())
    del twin
    torch.cuda.empty_cache()
    streams = [[t] for t in firsts]
    walls, per_step = [], []
    first_err = None
    for step in range(VLM_STEPS):
        before = (dict(mx_matmul.launches), dict(pa.launches))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = kapi.serve_step(weights, {"tokens": tokens}, cache,
                                    cache_len)
        nxt = torch.argmax(lg, -1).to(torch.int32)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        per_step.append((
            sum(mx_matmul.launches.values()) - sum(before[0].values()),
            pa.launches["paged_attention"] - before[1]["paged_attention"]))
        if step == 0:
            diff = float((lg.float() - want.float()).abs().max())
            ref_max = float(want.float().abs().max())
            first_err = (diff, ref_max)
            if not torch.isfinite(lg).all():
                fail(f"{label} {layout}: first decode tick not finite")
        for i, t in enumerate(nxt.tolist()):
            streams[i].append(t)
        tokens = nxt[:, None]
        cache_len = cache_len + 1
    want_step = (PROJ_PER_LAYER * cfg.n_layers, cfg.n_layers if paged else 0)
    if any(s != want_step for s in per_step):
        fail(f"{label} {layout}: launches per decode step (B1+B2, B3) "
             f"{sorted(set(per_step))}, want {want_step}")
    del cache
    torch.cuda.empty_cache()
    return streams, pre_ms, walls, per_step[0], first_err, \
        {**mx_matmul.launches, **pa.launches}


def _vlm_contract(api, weights, batch):
    """One request's prefill and first decode tick through the kernel and
    the densify contracts on one dense slot, both fed the kernel path's
    first token: [(max|kernel - densify|, max|densify|)] per step."""
    import torch
    from repro_torch.kernels.dispatch import make_qmm
    got, nxt = {}, None
    for mode in ("kernel", "densify"):
        mapi = api.with_serving(make_qmm(mode), "gather")
        cache = mapi.init_cache(1, VLM_MAX_LEN, device="cuda")
        lg, cache, clen = mapi.prefill_slot(weights, batch, cache, 0)
        if nxt is None:
            nxt = torch.argmax(lg)[None, None].to(torch.int32)
        lg2, _ = mapi.serve_step(weights, {"tokens": nxt}, cache,
                                 clen[None])
        got[mode] = (lg.float(), lg2[0].float())
        del cache
    return [(float((a - b).abs().max()), float(b.abs().max()))
            for a, b in zip(got["kernel"], got["densify"])]


def phase_vlm(seed: int):
    """llava-next-mistral-7b at full width and depth: an MXINT8 anchor
    (B6), packed mxint8 and mxint4 trees (B5), VLM_REQ requests with their
    own 2880-token image prefixes through ``prefill_slot`` and VLM_STEPS
    greedy ``serve_step``s on the dense layout and on the paged one (B3):
    launches per step, B1/B2 at each prefill's M against their plain
    versions; one request's prefill and first decode tick within
    FUSED_TOL of densify in f32 (bf16 reported); then MF-QAT forward and
    backward at depth VLM_TRAIN_LAYERS, seq 2880 + 1216.
    Returns the launches of B1-B3 and B5-B7."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.formats import TRAIN_FORMATS_MXINT
    from repro_torch.core.qat import QATConfig
    from repro_torch.core.tree import flatten_paths, unflatten_paths
    from repro_torch.kernels import mx_matmul, ref
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.transformer import init_params, make_model
    from repro_torch.serve.packed_params import (layer_slice,
                                                 make_packed_params)

    cfg = get_config("llava-next-mistral-7b")
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    gc.collect()
    torch.cuda.empty_cache()
    log(f"vlm phase: llava-next-mistral-7b at full width and depth "
        f"({cfg.n_layers} layers, {cfg.vision_tokens} image embeddings per "
        f"request), {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
        "before it; card " + _SMI[0])
    _reset_quant_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    anchor = build_anchor(cfg, seed, save=False)
    log(f"llava: anchor built in {time.perf_counter() - t0:.1f} s, peak "
        f"allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    weights = {fmt: make_packed_params(anchor, target_fmt=fmt,
                                       dtype=cfg.compute_dtype)
               for fmt in ("mxint8", "mxint4")}
    counts = _quant_launches()
    want = {"mx_quantize": PROJ_PER_LAYER, "ss_convert": PROJ_PER_LAYER,
            "fake_quant": 0}
    if counts != want:
        fail(f"llava: anchor and mxint4 build launched {counts}, want {want}")
    add(counts)
    del anchor
    gc.collect()
    torch.cuda.empty_cache()
    api = make_model(cfg)
    batches = _vlm_batches(cfg, seed)
    plens = [int(b["lengths"]) for b in batches]
    ms_ = [cfg.vision_tokens + b["tokens"].shape[1] for b in batches]
    log(f"llava requests: prompts {plens} tokens, padded to "
        f"{[b['tokens'].shape[1] for b in batches]} (prefill M {ms_}); KV "
        f"{2 * cfg.n_layers * cfg.n_kv_heads * cfg.hd * 2 // 1024} KiB per "
        f"position, so {[round((cfg.vision_tokens + n) * 131072 / 1e6, 1) for n in plens]}"
        f" MB per request, {cfg.vision_tokens * 131072 / 1e6:.1f} MB for "
        "the prefix alone")
    for fmt in ("mxint8", "mxint4"):
        streams = {}
        for layout in ("dense", "paged"):
            torch.cuda.reset_peak_memory_stats()
            st, pre_ms, walls, per_step, err, pre_l = _vlm_serve(
                f"llava {fmt}", api, weights[fmt], cfg, batches, layout,
                seed)
            streams[layout] = st
            add(pre_l)
            log(f"llava {fmt} {layout}: prefill ms per request "
                f"{[round(m, 1) for m in pre_ms]}; decode step wall median "
                f"{np.median(walls):.2f} ms ({min(walls):.2f}-"
                f"{max(walls):.2f}, n {len(walls)}, host wall to a "
                f"synchronize, eager launches); launches per step B1/B2 "
                f"{per_step[0]}, B3 {per_step[1]}; first decode tick "
                f"max|kernel - densify| {err[0]:.4g} of max|densify| "
                f"{err[1]:.4g}; peak allocated "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
            for b, m in zip(batches, pre_ms):
                log(f"llava {fmt} {layout} prefill of "
                    f"{cfg.vision_tokens} + {b['tokens'].shape[1]}: "
                    + _bound(cfg, "prefill", b["tokens"].shape[1], 1, m))
        agree = sum(a == b for x, y in zip(streams["dense"], streams["paged"])
                    for a, b in zip(x, y))
        total = sum(len(x) for x in streams["dense"])
        log(f"llava {fmt}: dense and paged streams agree on {agree} of "
            f"{total} tokens (the dense decode reads through the gather "
            "path, the paged one through B3: rounding may differ)")
    # B1/B2 at each request's prefill M, held against the plain versions,
    # and the contracts in f32 (launches made to compare, not counted)
    mm_before = dict(mx_matmul.launches)
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    api32 = make_model(cfg32)
    b32 = dict(batches[0], vision_embeds=batches[0]["vision_embeds"].float())
    for fmt in ("mxint8", "mxint4"):
        errs = _vlm_contract(api32, _as_f32(weights[fmt]), b32)
        log(f"llava {fmt} f32 contract, request 0: prefill and first decode "
            "tick max|kernel - densify| / max|densify| "
            f"{[(round(e, 6), round(m, 4)) for e, m in errs]}")
        for step, (e, m) in enumerate(errs):
            if not math.isfinite(e) or e > FUSED_TOL * m:
                fail(f"llava {fmt} f32 step {step}: kernel differs from "
                     f"densify by {e:.4g} > {FUSED_TOL} * {m:.4g}")
    del api32, b32
    gen = torch.Generator(device="cuda").manual_seed(seed + 19)
    for fmt in ("mxint8", "mxint4"):
        leaf = layer_slice(weights[fmt]["blocks"][0]["attn"]["wq"], 0)
        for m in sorted(set(ms_)):
            x = torch.randn((m, cfg.d_model), generator=gen,
                            device="cuda").to(torch.bfloat16)
            if fmt == "mxint4":
                from repro_torch.core.formats import get_format
                f4 = get_format("mxint4", 32)
                got = mx_matmul.mx_matmul_int4(x, leaf.packed, leaf.scale_exp,
                                               f4)
                wnt = ref.ref_mx_matmul_int4(x, leaf.packed, leaf.scale_exp,
                                             f4)
            else:
                got = mx_matmul.mx_matmul(x, leaf.codes, leaf.scale_exp,
                                          leaf.fmt)
                wnt = ref.ref_mx_matmul(x, leaf.codes, leaf.scale_exp,
                                        leaf.fmt)
            scale = float(wnt.abs().max())
            err = float((got - wnt).abs().max())
            log(f"llava {fmt} wq at prefill M={m}: max abs err {err:.3g} "
                f"against the plain version (max|plain| {scale:.3g})")
            if not torch.allclose(got, wnt, rtol=1e-4, atol=1e-4 * scale):
                fail(f"llava {fmt} wq M={m}: kernel differs from its plain "
                     f"version by {err:.3g}")
    mx_matmul.launches.update(mm_before)
    del weights, api
    gc.collect()
    torch.cuda.empty_cache()

    # MF-QAT training: depth VLM_TRAIN_LAYERS, the prefix and 1216 tokens
    tcfg = dataclasses.replace(cfg, n_layers=VLM_TRAIN_LAYERS)
    log(f"DEPTH CUT: llava training runs {VLM_TRAIN_LAYERS} of "
        f"{cfg.n_layers} layers (widths unchanged), batch 1, "
        f"{cfg.vision_tokens} + {VLM_TRAIN_TEXT} positions")
    qat = QATConfig(formats=TRAIN_FORMATS_MXINT)
    params = init_params(tcfg, seed, device="cuda")
    flat = flatten_paths(params)
    leaves = [p.requires_grad_(True) for _, p in flat]
    tree = unflatten_paths({k: p for (k, _), p in zip(flat, leaves)})
    gen = torch.Generator(device="cuda").manual_seed(seed + 20)
    toks = torch.randint(0, cfg.vocab, (1, VLM_TRAIN_TEXT), generator=gen,
                         device="cuda")
    batch = {"tokens": toks, "labels": toks,
             "vision_embeds": torch.randn(
                 (1, cfg.vision_tokens, cfg.d_model), generator=gen,
                 device="cuda") * 0.02}
    tapi = make_model(tcfg, qat=qat)
    _reset_quant_launches()
    rows = []
    for rep in range(2):
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        loss, _ = tapi.train_loss(tree, batch, 1)
        grads = torch.autograd.grad(loss, leaves)
        end.record()
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in grads)
        rows.append((start.elapsed_time(end),
                     (torch.cuda.max_memory_allocated() - base) / 1e9,
                     float(loss.detach()), finite))
        del grads, loss
    counts = _quant_launches()
    if not all(r[3] for r in rows) or counts["fake_quant"] != \
            2 * PROJ_PER_LAYER:
        fail(f"llava training: finite {[r[3] for r in rows]}, B7 launches "
             f"{counts['fake_quant']} (want {2 * PROJ_PER_LAYER})")
    add(counts)
    log(f"llava depth {VLM_TRAIN_LAYERS} MF-QAT train_loss (mxint4) forward "
        f"+ backward, seq {cfg.vision_tokens} + {VLM_TRAIN_TEXT} x 1: "
        f"{[round(r[0], 1) for r in rows]} ms (CUDA events; the first "
        f"warms up), peak {[round(r[1], 2) for r in rows]} GB above the "
        f"weights, loss {rows[-1][2]:.4f}, loss and gradients finite; B7 "
        f"launches {counts['fake_quant']} (7 stacked leaves per call); the "
        "step's " + _bound(tcfg, "train", VLM_TRAIN_TEXT, 1, rows[-1][0]))
    del tree, leaves, params, flat, tapi
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def _anchor_by_leaf(cfg, seed: int):
    """``make_anchor(init_params(cfg, seed))`` at MXINT8, one stacked leaf
    at a time: each leaf drawn in f32 on the card from the same generator
    in the same order (``param_leaves``, ``init_leaf``), quantized by one
    B6 launch or kept raw by the anchor's rule, and freed before the next.
    The peak is the anchor plus one f32 leaf, not the whole f32 tree."""
    import torch
    from repro_torch.core.anchor import AnchorModel
    from repro_torch.core.qat import QATConfig, pytree_block_axis
    from repro_torch.kernels.ops import mx_quantize
    from repro_torch.models import param_shapes
    from repro_torch.models.transformer import init_leaf, param_leaves

    qat = QATConfig(anchor="mxint8")
    fmt = qat.anchor_obj()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, raw = {}, {}
    for path, (shape, init) in param_leaves(cfg, param_shapes(cfg)):
        w = init_leaf(shape, init, gen)
        ax = pytree_block_axis(w)
        if (w.ndim >= 2 and qat.is_quantized_path(path)
                and w.shape[ax] % fmt.block_size == 0):
            q[path] = mx_quantize(w, fmt, axis=ax)
        else:
            raw[path] = w
        del w
    return AnchorModel(quantized=q, raw=raw, fmt_name=fmt.name)


def _jamba_cut():
    import dataclasses
    from repro_torch.configs import get_config
    full = get_config("jamba-1.5-large-398b")
    cfg = dataclasses.replace(full, n_layers=2, scan_group=2, attn_every=2,
                              attn_offset=1, moe_every=2, moe_offset=0)
    log("DEPTH CUT: jamba-1.5-large-398b serves its published layers 3-4 "
        "(layer 3: Mamba + 16-expert MoE; layer 4: attention + MLP) at "
        f"full width; all {full.n_layers} layers (398 B parameters) do not "
        "fit one card")
    return full, cfg


def _guard_waves(name, eng, cfg, seed: int):
    """A recurrent stack's engine (``eng``, graph ticks) through the
    guard's and the snapshot's waves: a row poisoned at the anchor rung
    (the survivors' streams equal the clean wave's), a poisoned mxint4 tick
    that escalates to mxint6 and replays from the kept state (graph ==
    eager, the tokens before the fault equal the clean wave's), a mid-wave
    snapshot resumed on a fresh engine (equal to the uninterrupted wave).
    Returns the B1/B2 launches."""
    from repro_torch.kernels import mx_matmul
    from repro_torch.runtime.fault import FaultInjector, PreemptionGuard

    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    # the clean mxint8 wave, then a row poisoned at the anchor rung
    clean = _requests(cfg.vocab, seed)
    eng.generate(clean, fmt_override="mxint8")
    mx_matmul.reset_launches()
    twin = _twin(eng, fault_injector=FaultInjector(poison_logits={3: 1}))
    reqs = _requests(cfg.vocab, seed)
    twin.generate(reqs, fmt_override="mxint8")
    st = twin.stats()
    dead = [r.rid for r in reqs if r.status.value == "failed_numeric"]
    same = [r.rid for r, c in zip(reqs, clean)
            if r.rid not in dead and r.out_tokens == c.out_tokens]
    log(f"{name} row poison (tick 3, slot 1, mxint8 = the anchor rung): "
        f"statuses {st['request_statuses']}, failed {dead}; survivors' "
        f"streams equal the clean wave's for {len(same)} of "
        f"{len(reqs) - len(dead)}")
    if len(dead) != 1 or len(same) != len(reqs) - 1:
        fail(f"{name} row poison: failed {dead}, survivors equal {same}")
    add(dict(mx_matmul.launches))
    # a poisoned mxint4 tick: escalate to mxint6 and replay from the kept
    # recurrent state; the eager twin the same
    clean4 = _requests(cfg.vocab, seed)
    eng.generate(clean4, fmt_override="mxint4")
    mx_matmul.reset_launches()
    plan = dict(poison_logits={3: None}, poison_fmt="mxint4")
    twin = _twin(eng, fault_injector=FaultInjector(**plan))
    reqs = _requests(cfg.vocab, seed)
    twin.generate(reqs, fmt_override="mxint4")
    st = twin.stats()
    add(dict(mx_matmul.launches))
    etwin = _eager_twin(eng, fault_injector=FaultInjector(**plan))
    ereqs = _requests(cfg.vocab, seed)
    etwin.generate(ereqs, fmt_override="mxint4")
    events = [(e["tick"], e["from"], e["to"])
              for e in st["escalation_events"]]
    # the first SLOTS requests' tokens of the prefill and ticks 0-1
    early = [r.out_tokens[:3] == c.out_tokens[:3] for r, c in
             zip(reqs[:SLOTS], clean4)]
    log(f"{name} poisoned mxint4 tick 3: escalations {events}, replays "
        f"{st['ticks_replayed']}, statuses {st['request_statuses']}; the "
        f"tokens before the fault equal the clean wave's for {sum(early)} "
        f"of {len(early)} requests; streams equal the eager twin's")
    if events != [(3, "mxint4", "mxint6")] or st["ticks_replayed"] != 1 \
            or not all(early) or any(r.status.value != "completed"
                                     for r in reqs):
        fail(f"{name} poisoned mxint4 wave: escalations {events}, replays "
             f"{st['ticks_replayed']}, early tokens equal {early}")
    _check_same_streams(f"{name} poisoned mxint4 wave", reqs, ereqs)
    del twin, etwin
    # preempted mid-wave at mxint8, resumed on a fresh engine
    with tempfile.TemporaryDirectory() as tmp:
        mx_matmul.reset_launches()
        twin = _twin(eng, fault_injector=FaultInjector(preempt_at=4))
        part = twin.generate(_requests(cfg.vocab, seed),
                             fmt_override="mxint8", guard=PreemptionGuard(),
                             snapshot_dir=tmp)
        fresh = _twin(eng)
        done = fresh.resume(tmp)
        add(dict(mx_matmul.launches))
        if all(r.done for r in part) or \
                [r.out_tokens for r in done] != \
                [r.out_tokens for r in clean]:
            fail(f"{name} snapshot / resume: the resumed wave differs from "
                 "the uninterrupted one")
        log(f"{name} snapshot at tick 4 ({sum(r.done for r in part)} of "
            f"{len(part)} done), resumed on a fresh engine: streams equal "
            "the uninterrupted wave's")
        del twin, fresh
    return totals


def phase_hybrid(seed: int):
    """jamba-1.5-large at full width, published layers 3-4: an MXINT8
    anchor (B6; A_log quantized, D / conv / dt raw), the dense graph
    engine at mxint8 and mxint4 as in phase 13 (the contracts in f32 and
    bf16, 58 B1/B2 launches per executable, weight bytes, eager twin,
    tick wall, tok/s, TTFT) plus the card's idle share, a row poisoned at
    the anchor rung (survivors equal the clean wave), a poisoned mxint4
    tick that escalates and replays (graph == eager, the tokens before it
    equal the clean wave's), a mid-wave snapshot resumed on a fresh engine
    (equal to the uninterrupted wave); then MF-QAT forward and backward of
    published layer 2 (Mamba + MLP) at seq 2048 and 8192. Returns the
    launches of B1, B2, B5, B6, B7."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core.formats import TRAIN_FORMATS_MXINT
    from repro_torch.core.qat import QATConfig
    from repro_torch.kernels import mx_matmul
    from repro_torch.launch.costmodel import total_params
    from repro_torch.models.transformer import init_params, make_model
    from repro_torch.serve.engine import ElasticEngine

    full, cfg = _jamba_cut()
    per_layer = _per_layer(cfg)                 # (3 + 48 + 4 + 3) / 2
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    _reset_quant_launches()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 1e9
    log(f"hybrid phase: {total_params(cfg) / 1e9:.2f} B parameters (f32 "
        f"{4 * total_params(cfg) / 1e9:.1f} GB at init), {held:.2f} GB "
        "allocated before it; the anchor is built one stacked leaf at a "
        "time (the whole f32 tree, then its anchor, peaked at 72.19 GB on an "
        "H100 80GB behind the earlier phases); card " + _SMI[0])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    anchor = _anchor_by_leaf(cfg, seed)
    torch.cuda.synchronize()
    log(f"jamba: anchor built in {time.perf_counter() - t0:.1f} s, peak "
        f"allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    m = "['blocks'][0]['mamba']"
    if f"{m}['A_log']" not in anchor.quantized or any(
            f"{m}['{k}']" not in anchor.raw
            for k in ("D", "conv_w", "conv_b", "dt_w", "dt_bias")):
        fail("jamba: A_log not quantized or an SSM leaf not raw in the "
             "anchor (the reference's rule, ROADMAP C.9)")
    api = make_model(cfg)
    eng = ElasticEngine(api, anchor, batch_slots=SLOTS, max_len=MAX_LEN,
                        device="cuda")
    if eng._bucket or eng.prefill_chunk is not None \
            or eng.scheduler != "sequential":
        fail("jamba engine: not the monolithic, unbucketed, sequential "
             "defaults of a recurrent stack")
    for fmt in ("mxint8", "mxint4"):
        _dense_waves("jamba", cfg, api, eng, fmt, per_layer, seed, totals)
        events = _profile_events(lambda: eng.generate(
            _requests(cfg.vocab, seed), fmt_override=fmt))
        pick = lambda t: t["decode"] and not t["prefill_tokens"]
        share, n, mean_ms = _idle_share(events, eng.tick_trace, pick)
        del events
        log(f"jamba {fmt}: card idle {100 * share:.1f}% over {n} pure "
            f"decode ticks (torch.profiler; busy {(1 - share) * mean_ms:.2f}"
            f" ms of a profiled tick of {mean_ms:.2f} ms)")
        mx_matmul.reset_launches()
    h = eng._cache["blocks"][0]["h"]
    conv = eng._cache["blocks"][0]["conv"]
    log(f"jamba state per slot and Mamba layer: h {tuple(h.shape[2:])} "
        f"{h.dtype} = {h[0, 0].numel() * h.element_size() / 2 ** 20:.2f} "
        f"MiB, conv {tuple(conv.shape[2:])} {conv.dtype} = "
        f"{conv[0, 0].numel() * conv.element_size() / 2 ** 10:.0f} KiB; "
        f"stats kv_bytes_per_slot {eng.stats()['kv_bytes_per_slot']}")
    add(_guard_waves("jamba", eng, cfg, seed))
    counts = _quant_launches()
    n_q = len(anchor.quantized)
    want = {"mx_quantize": n_q, "ss_convert": 2 * n_q, "fake_quant": 0}
    log(f"jamba anchor and format builds (mxint4, mxint6): launches {counts} "
        f"(want {want}: one per stacked leaf, A_log included)")
    if counts != want:
        fail(f"jamba: anchor and builds launched {counts}, want {want}")
    add(counts)
    del eng, anchor, api
    gc.collect()
    torch.cuda.empty_cache()

    # MF-QAT training: published layer 2 alone (Mamba + MLP)
    tcfg = dataclasses.replace(full, n_layers=1, scan_group=1, attn_every=2,
                               attn_offset=1, moe_every=2, moe_offset=1)
    log(f"DEPTH CUT: jamba training runs published layer 2 alone (Mamba + "
        f"MLP, {total_params(tcfg) / 1e9:.2f} B parameters)")
    qat = QATConfig(formats=TRAIN_FORMATS_MXINT)
    params = init_params(tcfg, seed, device="cuda")
    _reset_quant_launches()
    longest = None
    for seq in HYBRID_TRAIN_SEQS:
        try:
            rise, fb_ms = _fb_peak(tcfg, qat, params, seq, seed)
        except torch.cuda.OutOfMemoryError as e:
            log(f"jamba layer 2 seq {seq}: out of memory ({e})")
            break
        longest = seq
        log(f"jamba layer 2 MF-QAT train_loss forward + backward, seq {seq} "
            f"x 1: {fb_ms:.1f} ms (CUDA events), peak {rise:.2f} GB above "
            "the weights; the step's " + _bound(tcfg, "train", seq, 1, fb_ms))
    counts = _quant_launches()
    log(f"jamba training: the longest sequence that runs is {longest}; B7 "
        f"launches {counts['fake_quant']}")
    if longest is None or counts["fake_quant"] == 0:
        fail("jamba training: no sequence length ran")
    add(counts)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def phase_rwkv(seed: int):
    """rwkv6-7b at full width and depth: an MXINT8 anchor built leaf by
    leaf (B6; the seven (32, d) ``mix_*`` leaves quantized along the layer
    axis, ROADMAP C.11; the decay LoRA, ``bonus``, ``decay_base`` and
    ``ln_scale`` raw), the dense graph engine at mxint8 and mxint4 as in
    phase 13 (the contracts gated in f32 and reported in bf16, 8 B1/B2
    launches per layer and executable, weight bytes against the term plus
    ``rwkv_leaf_bytes``, eager twin, tick wall, tok/s, TTFT) plus the
    card's idle share and the state bytes per slot; the guard's and the
    snapshot's waves (``_guard_waves``); then MF-QAT forward and backward
    at depth RWKV_TRAIN_LAYERS over RWKV_TRAIN_SEQS. Returns the launches
    of B1, B2, B5, B6, B7."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.formats import TRAIN_FORMATS_MXINT
    from repro_torch.core.qat import QATConfig
    from repro_torch.kernels import mx_matmul
    from repro_torch.launch.costmodel import total_params
    from repro_torch.models.transformer import init_params, make_model
    from repro_torch.serve.engine import ElasticEngine

    cfg = get_config("rwkv6-7b")
    per_layer = _per_layer(cfg)                 # 5 + 3
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    _reset_quant_launches()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"rwkv phase: rwkv6-7b at full width and depth ({cfg.n_layers} "
        f"layers, {total_params(cfg) / 1e9:.2f} B parameters, f32 "
        f"{4 * total_params(cfg) / 1e9:.1f} GB at init; the anchor is "
        f"built one stacked leaf at a time), "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated before "
        "it; card " + _SMI[0])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    anchor = _anchor_by_leaf(cfg, seed)
    torch.cuda.synchronize()
    log(f"rwkv: anchor built in {time.perf_counter() - t0:.1f} s, peak "
        f"allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    b = "['blocks'][0]"
    mix = [f"{b}['{s}']['mix_{m}']" for s, ms in (("rwkv", "rkvgw"),
                                                   ("cmix", "kr"))
           for m in ms]
    raw = [f"{b}['rwkv']['{k}']" for k in ("decay_base", "decay_w1",
                                            "decay_w2", "bonus", "ln_scale")]
    if any(k not in anchor.quantized for k in mix) or \
            any(k not in anchor.raw for k in raw):
        fail("rwkv: the mix_* leaves not quantized along the layer axis or "
             "a decay / bonus / scale leaf not raw (the reference's rule, "
             "ROADMAP C.11)")
    api = make_model(cfg)
    eng = ElasticEngine(api, anchor, batch_slots=SLOTS, max_len=MAX_LEN,
                        device="cuda")
    if eng._bucket or eng.prefill_chunk is not None \
            or eng.scheduler != "sequential":
        fail("rwkv engine: not the monolithic, unbucketed, sequential "
             "defaults of a recurrent stack")
    for fmt in ("mxint8", "mxint4"):
        _dense_waves("rwkv6-7b", cfg, api, eng, fmt, per_layer, seed,
                     totals)
        events = _profile_events(lambda: eng.generate(
            _requests(cfg.vocab, seed), fmt_override=fmt))
        pick = lambda t: t["decode"] and not t["prefill_tokens"]
        share, n, mean_ms = _idle_share(events, eng.tick_trace, pick)
        del events
        log(f"rwkv6-7b {fmt}: card idle {100 * share:.1f}% over {n} pure "
            f"decode ticks (torch.profiler; busy {(1 - share) * mean_ms:.2f}"
            f" ms of a profiled tick of {mean_ms:.2f} ms)")
        mx_matmul.reset_launches()
    c = eng._cache["blocks"][0]
    per_slot = {k: t[0, 0].numel() * t.element_size() * cfg.n_layers
                for k, t in c.items()}
    log(f"rwkv6-7b state per slot over {cfg.n_layers} layers: "
        + ", ".join(f"{k} {tuple(t.shape[2:])} {t.dtype} "
                    f"{per_slot[k] / 2 ** 20:.2f} MiB"
                    for k, t in sorted(c.items()))
        + f"; stats kv_bytes_per_slot {eng.stats()['kv_bytes_per_slot']}, "
        f"attn_read_bytes {eng.stats()['attn_read_bytes']}")
    add(_guard_waves("rwkv6-7b", eng, cfg, seed))
    counts = _quant_launches()
    n_q = len(anchor.quantized)
    want = {"mx_quantize": n_q, "ss_convert": 2 * n_q, "fake_quant": 0}
    log(f"rwkv6-7b anchor and format builds (mxint4, mxint6): launches "
        f"{counts} (want {want}: one per stacked leaf, the mix_* included)")
    if counts != want:
        fail(f"rwkv6-7b: anchor and builds launched {counts}, want {want}")
    add(counts)
    del eng, anchor, api
    gc.collect()
    torch.cuda.empty_cache()

    # MF-QAT training at depth RWKV_TRAIN_LAYERS
    tcfg = dataclasses.replace(cfg, n_layers=RWKV_TRAIN_LAYERS)
    log(f"DEPTH CUT: rwkv6-7b training runs {RWKV_TRAIN_LAYERS} of "
        f"{cfg.n_layers} layers (widths unchanged, "
        f"{total_params(tcfg) / 1e9:.2f} B parameters), batch 1")
    qat = QATConfig(formats=TRAIN_FORMATS_MXINT)
    params = init_params(tcfg, seed, device="cuda")
    _reset_quant_launches()
    longest = None
    for seq in RWKV_TRAIN_SEQS:
        try:
            rise, fb_ms = _fb_peak(tcfg, qat, params, seq, seed)
        except torch.cuda.OutOfMemoryError as e:
            log(f"rwkv6-7b depth {RWKV_TRAIN_LAYERS} seq {seq}: out of "
                f"memory ({e})")
            break
        longest = seq
        log(f"rwkv6-7b depth {RWKV_TRAIN_LAYERS} MF-QAT train_loss "
            f"(mxint4) forward + backward, seq {seq} x 1: {fb_ms:.1f} ms "
            f"(CUDA events), peak {rise:.2f} GB above the weights; the "
            "step's " + _bound(tcfg, "train", seq, 1, fb_ms))
    counts = _quant_launches()
    log(f"rwkv6-7b training: the longest sequence tried that trains is "
        f"{longest} (of {RWKV_TRAIN_SEQS}); B7 launches "
        f"{counts['fake_quant']} (8 stacked leaves per call)")
    if longest is None or counts["fake_quant"] != 8 * (
            RWKV_TRAIN_SEQS.index(longest) + 1):
        fail(f"rwkv6-7b training: longest {longest}, B7 launches "
             f"{counts['fake_quant']}")
    add(counts)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def _encdec_batches(cfg, seed: int):
    """ENCDEC_REQ requests: a prompt of 16-200 tokens and its own
    (1, ENCDEC_FRAMES, d) frame embeddings from the seed, on the card."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed + 21)
    gen = torch.Generator(device="cuda").manual_seed(seed + 21)
    return [{"tokens": torch.as_tensor(rng.integers(
                0, cfg.vocab, size=(1, int(rng.integers(16, 201)))).astype(
                np.int32), device="cuda"),
             "frame_embeds": torch.randn(
                (1, ENCDEC_FRAMES, cfg.d_model), generator=gen,
                device="cuda").to(cfg.compute_dtype)}
            for _ in range(ENCDEC_REQ)]


def _encdec_contract(api, weights, batch):
    """One request's prefill and first decode tick through the kernel and
    the densify contracts on one slot, both fed the kernel path's first
    token: [(max|kernel - densify|, max|densify|)] per step."""
    import torch
    from repro_torch.kernels.dispatch import make_qmm
    got, nxt = {}, None
    for mode in ("kernel", "densify"):
        mapi = api.with_serving(make_qmm(mode))
        cache = mapi.init_cache(1, MAX_LEN, s_enc=ENCDEC_FRAMES,
                                device="cuda")
        lg, cache, clen = mapi.prefill_slot(weights, batch, cache, 0)
        if nxt is None:
            nxt = torch.argmax(lg)[None, None].to(torch.int32)
        lg2, _ = mapi.serve_step(weights, {"tokens": nxt}, cache,
                                 clen[None])
        got[mode] = (lg.float(), lg2[0].float())
        del cache
    return [(float((a - b).abs().max()), float(b.abs().max()))
            for a, b in zip(got["kernel"], got["densify"])]


def phase_encdec(seed: int):
    """seamless-m4t-large-v2 at full width and depth: an MXINT8 anchor
    (B6), packed mxint8 and mxint4 trees (B5); ENCDEC_REQ requests with
    their own ENCDEC_FRAMES frame embeddings through ``prefill_slot`` into
    one dense cache, then ENCDEC_STEPS greedy ``serve_step``s of all of
    them, every projection of both stacks through B1/B2 (the launches per
    prefill and per step as the structure predicts); one request's prefill
    and first decode tick within FUSED_TOL of densify in f32 (bf16
    reported); the engine's refusal (ROADMAP C.12); then MF-QAT forward
    and backward of the whole model at ENCDEC_TRAIN. Returns the launches
    of B1, B2, B5, B6, B7."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.formats import TRAIN_FORMATS_MXINT
    from repro_torch.core.qat import QATConfig
    from repro_torch.core.tree import flatten_paths, unflatten_paths
    from repro_torch.kernels import mx_matmul
    from repro_torch.kernels.dispatch import make_qmm
    from repro_torch.launch.costmodel import total_params
    from repro_torch.models import encdec, get_model
    from repro_torch.serve.engine import ElasticEngine
    from repro_torch.serve.packed_params import make_packed_params

    cfg = get_config("seamless-m4t-large-v2")
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    gc.collect()
    torch.cuda.empty_cache()
    log(f"encdec phase: seamless-m4t-large-v2 at full width and depth "
        f"({cfg.enc_layers} + {cfg.n_layers} layers, "
        f"{total_params(cfg) / 1e9:.2f} B parameters, vocab {cfg.vocab}), "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated before "
        "it; card " + _SMI[0])
    _reset_quant_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    anchor = _anchor_by_leaf(cfg, seed)
    log(f"seamless: anchor built in {time.perf_counter() - t0:.1f} s, peak "
        f"allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    api = get_model(cfg)
    try:
        ElasticEngine(api, anchor, batch_slots=SLOTS, max_len=MAX_LEN,
                      device="cuda")
        fail("seamless: the engine took an encoder-decoder config")
    except ValueError as e:
        if "C.12" not in str(e):
            fail(f"seamless: the engine refused with {e!r}, not C.12")
        log(f"seamless: the engine refuses the config: {e}")
    weights = {fmt: make_packed_params(anchor, target_fmt=fmt,
                                       dtype=cfg.compute_dtype)
               for fmt in ("mxint8", "mxint4")}
    n_q = len(anchor.quantized)
    counts = _quant_launches()
    want = {"mx_quantize": n_q, "ss_convert": n_q, "fake_quant": 0}
    if counts != want:
        fail(f"seamless: anchor and mxint4 build launched {counts}, want "
             f"{want}")
    add(counts)
    del anchor
    gc.collect()
    torch.cuda.empty_cache()
    batches = _encdec_batches(cfg, seed)
    enc, dec = (sum(len(v) for v in encdec.projections(cfg, k).values())
                for k in ("encoder", "decoder"))
    # a prefill runs every projection of both stacks; a decode step the
    # decoder's but the cross attention's K/V, cached at prefill
    per_pre = cfg.enc_layers * enc + cfg.n_layers * dec
    per_step = cfg.n_layers * (dec - 2)
    log(f"seamless requests: prompts {[b['tokens'].shape[1] for b in batches]}"
        f" tokens, each over {ENCDEC_FRAMES} frames; B1/B2 launches per "
        f"prefill {per_pre}, per decode step {per_step}; cross K/V "
        f"{2 * cfg.n_layers * ENCDEC_FRAMES * cfg.n_kv_heads * cfg.hd * 2 / 1e6:.1f}"
        " MB per slot")
    for fmt in ("mxint8", "mxint4"):
        kapi = api.with_serving(make_qmm("kernel"))
        cache = kapi.init_cache(ENCDEC_REQ, MAX_LEN, s_enc=ENCDEC_FRAMES,
                                device="cuda")
        mx_matmul.reset_launches()
        pre_ms, firsts, lens, pre_l = [], [], [], []
        for i, batch in enumerate(batches):
            before = sum(mx_matmul.launches.values())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache, clen = kapi.prefill_slot(weights[fmt], batch, cache, i)
            firsts.append(int(torch.argmax(lg)))
            torch.cuda.synchronize()
            pre_ms.append(1e3 * (time.perf_counter() - t0))
            pre_l.append(sum(mx_matmul.launches.values()) - before)
            lens.append(int(clen))
        tokens = torch.tensor(firsts, dtype=torch.int32,
                              device="cuda")[:, None]
        cache_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
        walls, step_l, streams = [], [], [[t] for t in firsts]
        for _ in range(ENCDEC_STEPS):
            before = sum(mx_matmul.launches.values())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = kapi.serve_step(weights[fmt], {"tokens": tokens},
                                        cache, cache_len)
            nxt = torch.argmax(lg, -1).to(torch.int32)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
            step_l.append(sum(mx_matmul.launches.values()) - before)
            if not torch.isfinite(lg).all():
                fail(f"seamless {fmt}: decode logits not finite")
            for i, t in enumerate(nxt.tolist()):
                streams[i].append(t)
            tokens = nxt[:, None]
            cache_len = cache_len + 1
        add(dict(mx_matmul.launches))
        kernel = "mx_matmul_int4" if fmt == "mxint4" else "mx_matmul"
        if set(pre_l) != {per_pre} or set(step_l) != {per_step} \
                or mx_matmul.launches[_OTHER[kernel]]:
            fail(f"seamless {fmt}: B1/B2 launches per prefill {pre_l}, per "
                 f"step {sorted(set(step_l))}, want {per_pre} / {per_step} "
                 f"of {kernel}")
        log(f"seamless {fmt}: prefill ms per request "
            f"{[round(m, 1) for m in pre_ms]} (host wall to a synchronize, "
            f"eager); decode step of {ENCDEC_REQ} rows median "
            f"{np.median(walls):.2f} ms ({min(walls):.2f}-{max(walls):.2f},"
            f" n {len(walls)}, eager); launches per prefill {pre_l[0]}, per "
            f"step {step_l[0]}; {sum(len(x) for x in streams)} tokens; peak "
            f"allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        for b, m in zip(batches, pre_ms):
            # the term counts seq // audio_downsample encoder frames, fewer
            # than the ENCDEC_FRAMES run: a looser bound
            log(f"seamless {fmt} prefill of {b['tokens'].shape[1]} tokens: "
                + _bound(cfg, "prefill", b["tokens"].shape[1], 1, m))
        del cache
        torch.cuda.empty_cache()
    # the contracts, bf16 reported and f32 gated (launches made to
    # compare, not counted)
    mm_before = dict(mx_matmul.launches)
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    api32 = get_model(cfg32)
    b32 = dict(batches[0], frame_embeds=batches[0]["frame_embeds"].float())
    for fmt in ("mxint8", "mxint4"):
        for dtype, capi, wts, batch in (
                ("bf16", api, weights[fmt], batches[0]),
                ("f32", api32, _as_f32(weights[fmt]), b32)):
            errs = _encdec_contract(capi, wts, batch)
            log(f"seamless {fmt} {dtype} contract, request 0: prefill and "
                "first decode tick max|kernel - densify| / max|densify| "
                f"{[(round(e, 6), round(m, 4)) for e, m in errs]}")
            for step, (e, m) in enumerate(errs):
                if not math.isfinite(e) or (dtype == "f32"
                                            and e > FUSED_TOL * m):
                    fail(f"seamless {fmt} {dtype} step {step}: kernel "
                         f"differs from densify by {e:.4g} > {FUSED_TOL} "
                         f"* {m:.4g}")
    mx_matmul.launches.update(mm_before)
    del weights, api32, b32
    gc.collect()
    torch.cuda.empty_cache()

    # MF-QAT training of the whole model
    bsz, ntok, nfr = ENCDEC_TRAIN
    qat = QATConfig(formats=TRAIN_FORMATS_MXINT)
    tapi = get_model(cfg, qat=qat)
    params = tapi.init_params(seed, device="cuda")
    flat = flatten_paths(params)
    leaves = [p.requires_grad_(True) for _, p in flat]
    tree = unflatten_paths({k: p for (k, _), p in zip(flat, leaves)})
    gen = torch.Generator(device="cuda").manual_seed(seed + 22)
    toks = torch.randint(0, cfg.vocab, (bsz, ntok), generator=gen,
                         device="cuda")
    batch = {"tokens": toks, "labels": toks,
             "frame_embeds": torch.randn((bsz, nfr, cfg.d_model),
                                         generator=gen, device="cuda")}
    _reset_quant_launches()
    rows = []
    for _ in range(2):
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        loss, _ = tapi.train_loss(tree, batch, 1)
        grads = torch.autograd.grad(loss, leaves)
        end.record()
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in grads)
        rows.append((start.elapsed_time(end),
                     (torch.cuda.max_memory_allocated() - base) / 1e9,
                     float(loss.detach()), finite))
        del grads, loss
    counts = _quant_launches()
    if not all(r[3] for r in rows) or counts["fake_quant"] != 2 * n_q:
        fail(f"seamless training: finite {[r[3] for r in rows]}, B7 "
             f"launches {counts['fake_quant']} (want {2 * n_q})")
    add(counts)
    log(f"seamless MF-QAT train_loss (mxint4) forward + backward, the whole "
        f"model, batch {bsz} x {ntok} tokens over {nfr} frames: "
        f"{[round(r[0], 1) for r in rows]} ms (CUDA events; the first warms "
        f"up), peak {[round(r[1], 2) for r in rows]} GB above the weights, "
        f"loss {rows[-1][2]:.4f}, loss and gradients finite; B7 launches "
        f"{counts['fake_quant']} ({n_q} stacked leaves per call); the step's "
        + _bound(cfg, "train", ntok, bsz, rows[-1][0])
        + f" (the term counts {ntok} // {cfg.audio_downsample} encoder "
        f"frames of the {nfr} run)")
    del tree, leaves, params, flat, tapi
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def _eval_launches(hc, anchored_api: bool, fmt, ss: bool, leaves: int):
    """B5 / B6 / B7 launches of one ``eval_ppl``: PTQ fake-quantizes each
    projection leaf once (B7); the anchor route quantizes each to the
    anchor (B6) and converts it unless the format is the anchor's (B5); an
    anchored variant's api runs its anchor fake-quant in every eval batch's
    forward (``train_loss(..., None)``: B6 per leaf)."""
    anchor = hc.anchor or ("mxint8" if fmt.startswith("mxint") else "mxfp8")
    per_batch = leaves * hc.n_eval_batches if anchored_api else 0
    if ss:
        return {"fake_quant": 0, "mx_quantize": leaves + per_batch,
                "ss_convert": 0 if fmt == anchor else leaves}
    return {"fake_quant": leaves, "mx_quantize": per_batch, "ss_convert": 0}


def phase_eval(seed: int):
    """Phase 21: (a) B1 at mxfp6 / mxfp4 at smollm-135m's and qwen3-4b's
    projection shapes, M 4 and 256, against the plain version (no B2
    launch); (b) Fig. 4's protocol on smollm-135m at full width and depth
    through ``train/harness.py`` (the harness's defaults but
    EVAL_PRETRAIN_STEPS and EVAL_EXAMPLES: a pretrained base, then plain
    multi-format MXINT, interleaved with an mxint8 anchor, plain
    multi-format MXFP, interleaved with an mxfp8 anchor):
    step ms (CUDA events), losses, B5 / B6 / B7 launches per step as the
    structure predicts; (c) held-out PPL at every format of EVAL_MXINT /
    EVAL_MXFP, by PTQ for the plain variants and by anchor + Slice-and-
    Scale for the anchored ones, the FP base's, the Fig. 4 table with its
    rel_gap, the plain MXINT variant's accuracy; gates: every value finite,
    PTQ at the anchor format equal to the anchor route within PPL_ID_TOL
    (mxint8, mxfp8); (d) the mxfp8-anchored weights -> make_anchor (B6) ->
    save_anchor / load_anchor -> the dense graph engine with the MXFP
    ladder, 8 greedy requests at mxfp8, mxfp6 and mxfp4 (``_dense_waves``).
    Returns (the main path's launches of B1 and B5-B7, the kernel rows of
    (a))."""
    import dataclasses

    import torch
    from repro_torch.checkpoint.anchor_ckpt import load_anchor, save_anchor
    from repro_torch.core.anchor import make_anchor
    from repro_torch.core.formats import TRAIN_FORMATS_MXFP, \
        TRAIN_FORMATS_MXINT
    from repro_torch.core.qat import QATConfig
    from repro_torch.kernels import mx_matmul
    from repro_torch.models.transformer import make_model
    from repro_torch.serve.engine import ElasticEngine
    from repro_torch.serve.policy import FormatPolicy
    from repro_torch.train import harness as H
    from repro_torch.train.loop import make_schedule

    t_phase = time.perf_counter()
    b2 = mx_matmul.launches["mx_matmul_int4"]
    rows = phase_family_kernels(seed, EVAL_ARCHS, FAMILY_MS, EVAL_CASES)
    if mx_matmul.launches["mx_matmul_int4"] != b2:
        fail("eval phase: B2 launched at an MXFP rung")
    t_kernels = time.perf_counter() - t_phase

    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    def timed(what, fn, want):
        """``fn()`` between CUDA events, its B5-B7 launches held to
        ``want``; (result, device ms)."""
        _reset_quant_launches()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        counts = _quant_launches()
        if counts != want:
            fail(f"eval phase, {what}: launches {counts}, want {want}")
        add(counts)
        return out, start.elapsed_time(end)

    base_hc = H.HarnessConfig(arch="smollm-135m", reduced=False,
                              pretrain_steps=EVAL_PRETRAIN_STEPS,
                              n_examples=EVAL_EXAMPLES, seed=seed)
    cfg = base_hc.model_config()
    leaves = _n_proj_leaves(cfg)
    log(f"eval phase: Fig. 4's protocol on {cfg.name} at full width and "
        f"depth ({cfg.n_layers} layers, d {cfg.d_model}, vocab {cfg.vocab}, "
        f"flash_vjp={cfg.flash_vjp}, remat={cfg.remat}); "
        f"HarnessConfig(reduced=False): {base_hc.n_examples} examples, seq "
        f"{base_hc.seq_len}, batch {base_hc.batch}, "
        f"{base_hc.epochs_per_format} epoch per format, lr {base_hc.lr}; "
        f"base pretrained {base_hc.pretrain_steps} steps at lr "
        f"{base_hc.pretrain_lr}, batch 16")
    log(f"SIZE CUT: the base pretrains {EVAL_PRETRAIN_STEPS} of the "
        f"reference's 600 steps and fine-tunes on {EVAL_EXAMPLES} of its 128 "
        "examples: the phase checks the path, not the paper's quality")
    zero = {"fake_quant": 0, "mx_quantize": 0, "ss_convert": 0}
    base, ms = timed("pretraining", lambda: H.pretrained_base(
        base_hc, device="cuda"), zero)
    per = ms / base_hc.pretrain_steps
    log(f"pretraining: {base_hc.pretrain_steps} steps in {ms / 1e3:.2f} s, "
        f"{per:.2f} ms per step (CUDA events over the run); "
        + _bound(cfg, "train", base_hc.seq_len, 16, per))

    variants = {}
    for name, fmts, anchor, sched in (
            ("MF-QAT MXINT", TRAIN_FORMATS_MXINT, None, "multiformat"),
            ("MF-QAT MXINT + mxint8 anchor", TRAIN_FORMATS_MXINT, "mxint8",
             "interleaved"),
            ("MF-QAT MXFP", TRAIN_FORMATS_MXFP, None, "multiformat"),
            ("MF-QAT MXFP + mxfp8 anchor", TRAIN_FORMATS_MXFP, "mxfp8",
             "interleaved")):
        hc = dataclasses.replace(base_hc, train_formats=fmts, anchor=anchor)
        steps = H._build(hc, sched)[3]
        order = make_schedule(sched, len(fmts), steps)
        if anchor is None:
            want = dict(zero, fake_quant=leaves * steps)
        else:
            moved = sum(fmts[int(i)] != anchor for i in order)
            want = dict(zero, mx_quantize=leaves * steps,
                        ss_convert=leaves * moved)
        out, ms = timed(name, lambda: H.train_variant(hc, sched,
                                                      device="cuda"), want)
        losses = [h["loss"] for h in out["history"]]
        if len(losses) != steps or not all(map(math.isfinite, losses)):
            fail(f"eval phase, {name}: losses {losses}")
        per = ms / steps
        log(f"{name} ({sched}, {steps} steps, formats {fmts}): "
            f"{per:.2f} ms per step (CUDA events over the run), losses "
            f"{[round(x, 4) for x in losses]}; per step B7 "
            f"{want['fake_quant'] / steps:g}, B6 "
            f"{want['mx_quantize'] / steps:g}, B5 "
            f"{want['ss_convert'] / steps:g} launches as the structure "
            "predicts; " + _bound(cfg, "train", hc.seq_len, hc.batch, per))
        variants[name] = (hc, out)

    def ppl(name, fmt, ss=False):
        hc, out = variants[name]
        want = zero if fmt is None else _eval_launches(
            hc, hc.anchor is not None, fmt, ss, leaves)
        val, _ = timed(f"{name} eval {fmt}", lambda: H.eval_ppl(
            out["cfg"], out["api"], out["params"], fmt, hc,
            use_anchor_ss=ss), want)
        if not math.isfinite(val):
            fail(f"eval phase, {name} at {fmt}: PPL {val}")
        return val

    plain_int = variants["MF-QAT MXINT"]
    fp_base, _ = timed("FP base eval", lambda: H.eval_ppl(
        cfg, plain_int[1]["api"], base, None, base_hc), zero)
    if not math.isfinite(fp_base):
        fail(f"eval phase: the FP base's PPL {fp_base}")
    log(f"FP base (pretrained, no quantization): held-out PPL {fp_base:.3f}")
    worst = 0.0
    table = {}
    for kind, evals, plain, anchored in (
            ("mxint", H.EVAL_MXINT, "MF-QAT MXINT",
             "MF-QAT MXINT + mxint8 anchor"),
            ("mxfp", H.EVAL_MXFP, "MF-QAT MXFP",
             "MF-QAT MXFP + mxfp8 anchor")):
        log(f"# fig4 {kind}: plain MF-QAT (PTQ) vs MF-QAT + anchor storage "
            "+ SS; fmt,ppl_multiformat,ppl_anchor_ss,rel_gap")
        for f in evals:
            p_plain, p_ss = ppl(plain, f), ppl(anchored, f, ss=True)
            gap = abs(p_ss - p_plain) / p_plain
            worst = max(worst, gap)
            table[f] = (p_plain, p_ss, gap)
            log(f"{f},{p_plain:.3f},{p_ss:.3f},{gap:.4f}")
        anchor = variants[anchored][0].anchor
        p_ptq = ppl(anchored, anchor)
        rel = abs(p_ptq - table[anchor][1]) / table[anchor][1]
        log(f"{anchored}: PTQ at {anchor} {p_ptq!r} vs the anchor route "
            f"{table[anchor][1]!r}: rel {rel:.3g} (limit {PPL_ID_TOL})")
        if not rel <= PPL_ID_TOL:
            fail(f"eval phase: PTQ at {anchor} differs from the anchor "
                 f"route by {rel:.3g}")
    log(f"fig4 worst rel_gap {worst:.4f}")
    accs = []
    for f in [None] + H.EVAL_MXINT:
        a, _ = timed(f"accuracy {f}", lambda: H.eval_accuracy(
            plain_int[1]["cfg"], plain_int[1]["api"], plain_int[1]["params"],
            f, plain_int[0]), dict(zero, fake_quant=0 if f is None
                                    else leaves))
        if not 0.0 <= a <= 1.0:
            fail(f"eval phase: accuracy {a} at {f}")
        accs.append(a)
    log("MF-QAT MXINT held-out next-token accuracy (Table 1-2 stand-in): "
        + ", ".join(f"{f or 'fp'} {a:.4f}"
                    for f, a in zip([None] + H.EVAL_MXINT, accs)))
    t_train_eval = time.perf_counter() - t_phase - t_kernels

    # (d) the mxfp8-anchored weights served down the MXFP ladder
    t0 = time.perf_counter()
    out = variants["MF-QAT MXFP + mxfp8 anchor"][1]
    del variants, base, plain_int
    _reset_quant_launches()
    anchor = make_anchor(out["params"], QATConfig(anchor="mxfp8"),
                         device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        nbytes = save_anchor(os.path.join(tmp, "anchor"), anchor)
        del anchor
        anchor = load_anchor(os.path.join(tmp, "anchor"), device="cuda")
    del out
    api = make_model(cfg)
    eng = ElasticEngine(api, anchor, batch_slots=SLOTS, max_len=MAX_LEN,
                        device="cuda", policy=FormatPolicy(
                            anchor="mxfp8", ladder=MXFP_LADDER))
    log(f"eval phase serving: the mxfp8-anchored variant's weights -> "
        f"anchor {nbytes / 1e6:.1f} MB -> dense graph engine, ladder "
        f"{MXFP_LADDER}")
    for fmt in ("mxfp8", "mxfp6", "mxfp4"):
        _dense_waves(cfg.name, cfg, api, eng, fmt, leaves, seed, totals)
    counts = _quant_launches()
    want = dict(zero, mx_quantize=leaves, ss_convert=2 * leaves)
    if counts != want:
        fail(f"eval phase serving: anchor and builds launched {counts}, "
             f"want {want}")
    add(counts)
    del eng, anchor, api
    gc.collect()
    torch.cuda.empty_cache()
    log(f"eval phase: {time.perf_counter() - t_phase:.1f} s (B1 kernels "
        f"{t_kernels:.1f} s, training and evaluation {t_train_eval:.1f} s, "
        f"serving {time.perf_counter() - t0:.1f} s)")
    return totals, rows


def _anchor_digest(anchor):
    """Sums of every anchor leaf's bytes: equal digests, the same anchor."""
    import torch
    tot = 0
    for t in list(anchor.quantized.values()) + list(anchor.raw.values()):
        for x in ((t.codes, t.scale_exp) if hasattr(t, "codes") else (t,)):
            flat = x.contiguous().view(torch.uint8).reshape(-1)
            for i in range(0, flat.numel(), 1 << 26):   # 0.5 GB of int64
                tot += int(flat[i:i + (1 << 26)].sum(dtype=torch.int64))
    return tot


def _mesh_serve(eng, cfg, seed: int, fmt: str, timed: bool):
    """One greedy wave of ``_requests`` at ``fmt`` on ``eng``: its streams,
    host seconds, tick trace and the launches of B1-B4 (counted from 0);
    with ``timed`` the engine's collectives are timed (synchronized)."""
    import torch
    from repro_torch.kernels import mx_matmul
    from repro_torch.kernels import paged_attention as pa
    tp = eng.tensor_parallel
    if tp is not None:
        tp.timed, tp.collective_s = timed, 0.0
    reqs = _requests(cfg.vocab, seed)
    mx_matmul.reset_launches()
    pa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(reqs, fmt_override=fmt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if any(r.status.value != "completed" or len(r.out_tokens) != MAX_NEW
           for r in reqs):
        fail(f"mesh phase {fmt}: requests incomplete "
             f"{[r.status.value for r in reqs]}")
    return dict(streams=[r.out_tokens for r in reqs], wall=wall,
                trace=list(eng.tick_trace),
                launches={**mx_matmul.launches, **pa.launches},
                collective_s=tp.collective_s if tp is not None else 0.0)


def _first_logits(eng, fmt: str, prompt):
    """The logits of ``prompt``'s last position (``prefill_slot``) and of
    one decode step after it (``serve_step`` on the prompt's last token)
    through the model of ``eng`` (a dense-layout engine) at ``fmt``: on a
    mesh, the sharded model, gathered to the global vocab. (2, V) f32 on
    the host."""
    import torch
    api, w = eng._api_for(fmt), eng.weights_for(fmt)
    cache = eng._init_cache(1)
    lg, cache, clen = api.prefill_slot(
        w, {"tokens": torch.as_tensor(prompt[None], device="cuda")}, cache, 0)
    tok = torch.full((1, 1), int(prompt[-1]), dtype=torch.int32,
                     device="cuda")
    lg2, _ = api.serve_step(w, {"tokens": tok}, cache, clen[None])
    return torch.stack([lg.float(), lg2[0].float()]).cpu()


MESH_LAYOUTS = {"dense": {}, "paged": dict(kv_layout="paged",
                                           kv_page_size=PAGE,
                                           prefill_chunk=CHUNK)}
MESH_FMTS = (("mxint8", "mx_matmul"), ("mxint4", "mx_matmul_int4"))


def _mesh_rank(rank: int, port: int, seed: int, q) -> None:
    """One process of phase 22's tensor-parallel engine, on cuda:0 in a
    gloo group of MESH_TP: rebuilds the anchor from the seed, then per
    layout and format a wave (its streams, tick walls, launches) and a
    wave with the collectives timed, the last-position logits of one
    prompt and the weight bytes; puts the record (or the error) on ``q``."""
    import traceback
    try:
        import torch
        import torch.distributed as dist
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=MESH_TP, rank=rank)
        try:
            q.put((rank, "ok", _mesh_rank_work(seed)))
        finally:
            dist.destroy_process_group()
    except (Exception, SystemExit):     # fail() raises SystemExit; the
        #                                 parent reports the traceback
        q.put((rank, "error", traceback.format_exc()))


def _mesh_rank_work(seed: int):
    import torch
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.transformer import make_model
    from repro_torch.serve.engine import ElasticEngine

    cfg = qwen3_4b(MESH_LAYERS)
    _reset_quant_launches()
    anchor = build_anchor(cfg, seed, save=False)
    out = {"digest": _anchor_digest(anchor), "waves": {}, "logits": {},
           "bytes": {}}
    mesh = make_debug_mesh(1, MESH_TP)
    prompt = _requests(cfg.vocab, seed)[0].prompt
    for layout, kw in MESH_LAYOUTS.items():
        eng = ElasticEngine(make_model(cfg), anchor, batch_slots=SLOTS,
                            max_len=MAX_LEN, device="cuda", mesh=mesh, **kw)
        for fmt, _ in MESH_FMTS:
            eng.weights_for(fmt)              # build outside the timing
            plain = _mesh_serve(eng, cfg, seed, fmt, timed=False)
            timed = _mesh_serve(eng, cfg, seed, fmt, timed=True)
            out["waves"][layout, fmt] = dict(
                plain, timed_wall=timed["wall"],
                collective_s=timed["collective_s"],
                timed_same=timed["streams"] == plain["streams"])
            if layout == "dense":       # numpy: a tensor would travel
                #                             the queue as a shared fd
                out["logits"][fmt] = _first_logits(eng, fmt,
                                                   prompt).numpy()
        st = eng.stats()
        out["bytes"][layout] = (st["weight_bytes"],
                                st["weight_bytes_per_chip"], st["mesh"],
                                st["cuda_graphs"], st["kv_cache_bytes"])
        del eng
        torch.cuda.empty_cache()
    out["quant"] = _quant_launches()
    return out


def _near_ties(eng, fmt: str, cfg, seed: int, got, want, first,
               what: str) -> None:
    """Where a tensor-parallel stream leaves the single process's, the
    single process's own logits at that position (``prefill`` of the
    prompt and the common prefix) hold the two tokens within
    ``2 * FUSED_TOL`` of max|logit| of each other: a flip the logits
    contract allows (a near tie under reordered f32 sums), not a wrong
    token."""
    import torch
    prompts = [r.prompt for r in _requests(cfg.vocab, seed)]
    for i, p in enumerate(first):
        if p is None:
            continue
        seq = list(prompts[i]) + list(want[i][:p])
        lg = _first_logits(eng, fmt, torch.tensor(seq).numpy())[0]
        scale = float(lg.abs().max())
        margin = float(lg[want[i][p]] - lg[got[i][p]])
        top2 = torch.topk(lg, 2).values
        log(f"mesh phase {what} stream {i} at position {p}: single process "
            f"{want[i][p]}, tp {got[i][p]}; the single process's prefill "
            f"logits there: margin {margin:.4g} ({100 * margin / scale:.3f}% "
            f"of max|logit| {scale:.4g}; its top-2 gap "
            f"{float(top2[0] - top2[1]):.4g})")
        if abs(margin) > 2 * FUSED_TOL * scale:
            fail(f"mesh phase {what} stream {i}: tp token {got[i][p]} at "
                 f"position {p} is {margin:.4g} below the single process's "
                 f"{want[i][p]}, beyond 2 x {FUSED_TOL} of max|logit|")


def _run_mesh_ranks(seed: int):
    """Start the MESH_TP processes of the tensor-parallel engine together
    and return their records in rank order; fails if one fails."""
    import multiprocessing as mp
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_mesh_rank, args=(r, port, seed, q))
             for r in range(MESH_TP)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            rank, kind, val = q.get(timeout=600)
            got[rank] = (kind, val)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    errors = [f"rank {r}: {v}" for r, (k, v) in got.items() if k != "ok"]
    if errors:
        fail("tensor-parallel ranks failed:\n" + "\n".join(errors))
    return [got[r][1] for r in range(MESH_TP)]


def _shard_kernels(anchor, cfg, gen):
    """B1 / B2 at the shard shapes of a (1, MESH_TP) mesh, every rank's
    layer-0 projections (column-parallel N / tp, row-parallel K / tp) at
    M = 4 (decode) and 256 (the mixed tick), B2 on the leaves repacked per
    shard: each shard's dequantized weight equal to its slice of the
    global one, the kernel held against its plain version (phase 3's
    tolerance); one layer's seven shard projections timed at M = 4 beside
    the whole projections'."""
    import numpy as np
    import torch
    from repro_torch.core.formats import get_format
    from repro_torch.core.tree import flatten_paths
    from repro_torch.kernels import ref
    from repro_torch.kernels.dispatch import qmatmul
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.transformer import param_axes
    from repro_torch.serve.packed_params import (
        MXTensor, densify_leaf, layer_slice, local_shard, make_packed_params,
        packed_param_specs, repack_splitn_for_tp)
    mesh = Mesh(np.arange(MESH_TP).reshape(1, MESH_TP), ("data", "model"))
    axes = param_axes(cfg)
    rec = {}
    for fmt, kernel in MESH_FMTS:
        w = make_packed_params(anchor, target_fmt=fmt)
        specs = packed_param_specs(w, axes, mesh)
        rep = repack_splitn_for_tp(w, specs, mesh)
        whole = {k: layer_slice(v, 0) for k, v in flatten_paths(w)
                 if "'blocks'" in k and hasattr(v, "scale_exp")}
        err, ms_shard = 0.0, 0.0
        for r in range(MESH_TP):
            local = dict(flatten_paths(local_shard(
                rep, specs, mesh, {"data": 0, "model": r})))
            for k, g in whole.items():
                leaf = layer_slice(local[k], 0)
                dg = densify_leaf(g, None, torch.float32, serving_axis=True)
                dl = densify_leaf(leaf, None, torch.float32,
                                  serving_axis=True)
                kk, nn = dl.shape
                rows = slice(None) if kk == dg.shape[0] else \
                    slice(r * kk, (r + 1) * kk)
                cols = slice(None) if nn == dg.shape[1] else \
                    slice(r * nn, (r + 1) * nn)
                if not torch.equal(dl, dg[rows, cols]):
                    fail(f"mesh phase {fmt} {k} rank {r}: the shard "
                         "(repacked) does not dequantize to its slice of "
                         "the whole weight")
                for m in (4, SLOTS * CHUNK):
                    x = torch.randn((m, kk), generator=gen,
                                    device="cuda").to(torch.bfloat16)
                    got = qmatmul(x, leaf, out_dtype=torch.float32)
                    if isinstance(leaf, MXTensor):
                        want = ref.ref_mx_matmul(x, leaf.codes,
                                                 leaf.scale_exp, leaf.fmt)
                    else:
                        want = ref.ref_mx_matmul_int4(
                            x, leaf.packed, leaf.scale_exp,
                            get_format(leaf.fmt_name, 32))
                    scale = float(want.abs().max())
                    e = float((got - want).abs().max())
                    if not torch.allclose(got, want, rtol=1e-4,
                                          atol=1e-4 * scale):
                        fail(f"mesh phase {kernel} {k} rank {r} M={m} "
                             f"(K {kk}, N {nn}): max abs err {e:.3g} vs "
                             f"max|plain| {scale:.3g}")
                    err = max(err, e)
                    if m == 4 and r == 0:
                        ms_shard += cuda_time_ms(
                            lambda i: qmatmul(x, leaf), 50)
        x4 = {k: torch.randn((4, densify_leaf(
            g, None, torch.float32, serving_axis=True).shape[0]),
            generator=gen, device="cuda").to(torch.bfloat16)
            for k, g in whole.items()}
        ms_whole = sum(cuda_time_ms(lambda i: qmatmul(x4[k], g), 50)
                       for k, g in whole.items())
        log(f"mesh phase {kernel} [{fmt}] at the shard shapes of tp "
            f"{MESH_TP} ({len(whole)} projections x {MESH_TP} ranks, M 4 "
            f"and {SLOTS * CHUNK}): max abs err {err:.3g} against the plain "
            f"version; one layer at M = 4: rank 0's shards {ms_shard:.4f} "
            f"ms, the whole projections {ms_whole:.4f} ms (device, CUDA "
            "graph of 50)")
        rec[kernel] = dict(max_abs_err=err, shard_ms=ms_shard,
                           whole_ms=ms_whole)
        del w, rep
    return rec


def phase_mesh(seed: int):
    """Phase 22: data-parallel replicas, tensor-parallel serving and MX
    gradient compression on the one card. Returns the launch counts of the
    main path (the replicas' waves, the ranks' waves; B5 / B6 of every
    build and of the compression) and the shard-shape kernel record."""
    import numpy as np
    import torch
    from repro_torch.core.formats import get_format
    from repro_torch.core.mx import dequantize
    from repro_torch.kernels import mx_matmul, ref
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import param_shapes
    from repro_torch.models.transformer import make_model, param_leaves
    from repro_torch.serve.engine import ElasticEngine
    from repro_torch.serve.replicas import ReplicaSet
    from repro_torch.train.compression import (compressed_bytes,
                                               ef_compress_leaf)

    t_phase = time.perf_counter()
    cfg = qwen3_4b(MESH_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(seed + 22)
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    _reset_quant_launches()
    anchor = build_anchor(cfg, seed, save=False)
    digest = _anchor_digest(anchor)
    api = make_model(cfg)
    kw = dict(batch_slots=SLOTS, max_len=MAX_LEN, device="cuda")

    # ---- 1. two single-device replicas against a lone engine (graphs)
    lone = ElasticEngine(api, anchor, **kw)
    rs = ReplicaSet(api, anchor, n_replicas=2, **kw)
    for fmt, _ in MESH_FMTS:
        lone.weights_for(fmt)
        for e in rs.engines:
            e.weights_for(fmt)
        for what, server in (("lone", lone), ("replicas", rs)):
            server.generate(_requests(cfg.vocab, seed), fmt_override=fmt)
        res = {}
        for what, server in (("lone", lone), ("replicas", rs)):
            reqs = _requests(cfg.vocab, seed)
            mx_matmul.reset_launches()
            pa.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            server.generate(reqs, fmt_override=fmt)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            add({**mx_matmul.launches, **pa.launches})
            res[what] = (reqs, wall)
        (lreqs, lwall), (rreqs, rwall) = res["lone"], res["replicas"]
        if {r.rid: r.out_tokens for r in rreqs} != \
                {r.rid: r.out_tokens for r in lreqs}:
            fail(f"mesh phase {fmt}: a replica's stream differs from the "
                 "lone engine's")
        homes = [rs.home(r.rid) for r in rreqs]
        parts = [[r.rid for r in p] for p in rs.partition(rreqs)]
        if homes != [r.rid % 2 for r in rreqs] or parts != [
                [r.rid for r in rreqs if r.rid % 2 == h] for h in (0, 1)]:
            fail(f"mesh phase {fmt}: home / partition {homes} {parts}")
        if any(r.status.value != "completed" for r in rreqs):
            fail(f"mesh phase {fmt}: replica requests incomplete")
        tokens = N_REQ * MAX_NEW
        st = rs.stats()
        log(f"mesh phase replicas {fmt}: ReplicaSet(n_replicas=2, tp=1) "
            f"{tokens} tokens in {rwall:.3f} s = {tokens / rwall:.1f} tok/s "
            f"(replicas serve one after another) beside the lone engine's "
            f"{tokens / lwall:.1f} tok/s ({lwall:.3f} s); streams equal; "
            f"homes {homes}; ticks {st['ticks']} (lone "
            f"{lone.stats()['ticks']})")
    del lone, rs
    torch.cuda.empty_cache()

    # ---- 2. the single-process reference of the tensor-parallel engine
    prompt = _requests(cfg.vocab, seed)[0].prompt
    single = {}
    want_logits = {}
    single_bytes = {}
    for layout, lkw in MESH_LAYOUTS.items():
        eng = ElasticEngine(api, anchor, cuda_graphs=False, **kw, **lkw)
        for fmt, _ in MESH_FMTS:
            eng.weights_for(fmt)
            single[layout, fmt] = _mesh_serve(eng, cfg, seed, fmt, False)
            if layout == "dense":
                want_logits[fmt] = _first_logits(eng, fmt, prompt)
        single_bytes[layout] = eng.stats()["weight_bytes"]
        if layout == "dense":
            dense_single = eng      # kept: the near-tie check below
        else:
            del eng
    add(_quant_launches())
    torch.cuda.empty_cache()
    ranks = _run_mesh_ranks(seed)
    for r, rec in enumerate(ranks):
        if rec["digest"] != digest:
            fail(f"mesh phase: rank {r}'s anchor differs from the parent's")
        add(rec["quant"])
    for layout, _ in MESH_LAYOUTS.items():
        for fmt, kernel in MESH_FMTS:
            ref_w = single[layout, fmt]
            for r, rec in enumerate(ranks):
                wv = rec["waves"][layout, fmt]
                _check_launches(
                    f"mesh phase rank {r} {layout} {fmt}", wv["trace"],
                    MESH_LAYERS, {k: v for k, v in wv["launches"].items()
                                  if k.startswith("mx_matmul")},
                    {k: v for k, v in wv["launches"].items()
                     if k.startswith("paged")}
                    if layout == "paged" else None)
                if not wv["timed_same"]:
                    fail(f"mesh phase rank {r} {layout} {fmt}: the timed "
                         "wave's streams differ from the untimed one's")
                add(wv["launches"])
            w0 = ranks[0]["waves"][layout, fmt]
            if any(rec["waves"][layout, fmt]["streams"] != w0["streams"]
                   for rec in ranks):
                fail(f"mesh phase {layout} {fmt}: the ranks' streams differ")
            same, total, first = _agreement(w0["streams"], ref_w["streams"])
            pick = (lambda t: t["decode"] and not t["prefill_chunks"]
                    and not t["prefill_tokens"])
            tick = lambda tr: float(np.median(
                [1e3 * t["wall_s"] for t in tr if pick(t)]))
            share = max(rec["waves"][layout, fmt]["collective_s"]
                        / rec["waves"][layout, fmt]["timed_wall"]
                        for rec in ranks)
            log(f"mesh phase tp {MESH_TP} {layout} {fmt}: greedy tokens "
                f"equal to the single-process engine's {same}/{total}, "
                f"{sum(f is None for f in first)}/{len(first)} streams "
                f"equal, first differing position per stream {first}; "
                "eager pure "
                f"decode tick median {tick(w0['trace']):.2f} ms (single "
                f"process, eager: {tick(ref_w['trace']):.2f} ms); wave "
                f"{w0['wall']:.3f} s ({ref_w['wall']:.3f} s); collectives "
                f"{100 * share:.1f}% of the timed wave's wall (synchronized "
                "around each collective; a correctness run on one card, "
                "not a TP speed)")
            _near_ties(dense_single, fmt, cfg, seed, w0["streams"],
                       ref_w["streams"], first, f"{layout} {fmt}")
    del dense_single
    for fmt, _ in MESH_FMTS:
        for step, what in enumerate(("prefill, last position",
                                     "first decode step")):
            want = want_logits[fmt][step]
            scale = float(want.abs().max())
            for r, rec in enumerate(ranks):
                got = torch.from_numpy(rec["logits"][fmt][step])
                diff = float((got - want).abs().max())
                same = int(got.argmax()) == int(want.argmax())
                log(f"mesh phase {fmt} rank {r} {what}: logits max|tp - "
                    f"single| = {diff:.4g}, max|single| = {scale:.4g} "
                    f"({100 * diff / scale:.3f}%), argmax equal: {same}")
                if not (torch.isfinite(got).all()
                        and diff <= FUSED_TOL * scale):
                    fail(f"mesh phase {fmt} rank {r} {what}: logits differ "
                         f"by {diff:.4g} > {FUSED_TOL} * {scale:.4g}")
    for layout in MESH_LAYOUTS:
        for r, rec in enumerate(ranks):
            glob, chip, mesh_s, graphs, kvb = rec["bytes"][layout]
            for fmt, _ in MESH_FMTS:
                ratio = chip[fmt] / single_bytes[layout][fmt]
                log(f"mesh phase {layout} {fmt} rank {r}: weight bytes per "
                    f"chip {chip[fmt]} of {single_bytes[layout][fmt]} "
                    f"({ratio:.4f}); mesh {mesh_s}, cuda_graphs {graphs}, "
                    f"kv_cache_bytes {kvb}")
                if glob[fmt] != single_bytes[layout][fmt] or \
                        abs(ratio - 0.5) > 0.01 * 0.5 or graphs:
                    fail(f"mesh phase {layout} {fmt} rank {r}: per-chip "
                         f"weight bytes {chip[fmt]} not within 1% of half "
                         f"of {single_bytes[layout][fmt]} (global "
                         f"{glob[fmt]}), or graphs on")

    # ---- 3. B1 / B2 / B3 / B4 at the shard shapes (not counted)
    _reset_quant_launches()
    shard_rec = _shard_kernels(anchor, cfg, gen)
    _paged_other_heads(gen, pa, ref, layouts=(
        (f"G 4, local (tp {MESH_TP})", (ATTN_H // MESH_TP,
                                        ATTN_HKV // MESH_TP, ATTN_D)),))
    del anchor
    torch.cuda.empty_cache()

    # ---- 4. MX gradient compression of a qwen3-4b-sized leaf
    fmt = get_format("mxint8", 32)
    g = torch.randn(MESH_GRAD, generator=gen, device="cuda") * 1e-3
    err = torch.randn(MESH_GRAD, generator=gen, device="cuda") * 1e-5
    _reset_quant_launches()
    t, new_err = ef_compress_leaf(g, err, fmt)
    torch.cuda.synchronize()
    add(_quant_launches())
    pt, pnew = ef_compress_leaf(g.cpu(), err.cpu(), fmt)
    deq = dequantize(t).reshape(-1)[:g.numel()].reshape(g.shape)
    if not (torch.equal(t.codes.cpu(), pt.codes)
            and torch.equal(t.scale_exp.cpu(), pt.scale_exp)
            and torch.equal(new_err.cpu(), pnew)):
        fail("mesh phase: ef_compress_leaf on the card differs from the "
             "plain path")
    if not torch.equal((g + err) - deq, new_err):
        fail("mesh phase: corrected - dequant != new error state")
    ms = cuda_time_ms(lambda i: ef_compress_leaf(g, err, fmt), 5)
    full = qwen3_4b(36)
    meta = {k: torch.empty(shape, device="meta") for k, (shape, _) in
            param_leaves(full, param_shapes(full))}
    n_par = sum(v.numel() for v in meta.values())
    cb = compressed_bytes(meta, "mxint8")
    log(f"mesh phase compression: ef_compress_leaf of a {MESH_GRAD} f32 "
        f"leaf on the card {ms:.4f} ms (B6 + dequantize + residual; CUDA "
        f"graph of 5), codes / scales / error bit-identical to the plain "
        f"path, corrected - dequant == new error exactly; compressed_bytes "
        f"of qwen3-4b (36 layers, {n_par} parameters) {cb} against "
        f"{4 * n_par} at 4 bytes a parameter ({cb / (4 * n_par):.4f})")
    log(f"mesh phase: {time.perf_counter() - t_phase:.1f} s")
    return launches, shard_rec


# ---- phase 23: the sharded training step and sharded replicas -------------
# (config, layers, batch rows, layouts, whole step): qwen3-4b runs whole
# steps (AdamW included); mixtral-8x7b's f32 state (20.5 GB whole) leaves
# room on the one card for its forward and backward only.
MESH_TRAIN = (("qwen3-4b", MESH_LAYERS, 8, ((1, 2), (2, 1)), True),
              ("mixtral-8x7b", 1, 4, ((2, 1),), False))


def _mesh_train_cfg(name: str, layers: int):
    """``name`` at full width cut to ``layers`` layers, in f32: the gates
    hold a sharded step to one process's at 1e-3, and bf16 rounds each
    shard's partial products where the single process rounds their sum."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    cfg = get_config(name)
    log(f"DEPTH CUT: {name} trains {layers} of {cfg.n_layers} layers "
        "(widths unchanged), compute in f32")
    return dataclasses.replace(cfg, n_layers=layers,
                               compute_dtype=torch.float32)


def _mesh_train_batch(cfg, batch: int, seed: int, seq: int = TRAIN_SEQ):
    """A seeded batch on the card (the same in every process), seq
    ``seq``, its masks differing between the two row halves."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed + 23)
    tok = torch.randint(0, cfg.vocab, (batch, seq + 1), generator=gen,
                        device="cuda", dtype=torch.int64).to(torch.int32)
    mask = torch.ones((batch, seq), device="cuda")
    mask[:batch // 2, seq // 4:] = 0.0
    return {"tokens": tok[:, :-1].contiguous(),
            "labels": tok[:, 1:].contiguous(), "mask": mask}


def _state_bytes(params, opt) -> int:
    from repro_torch.core.tree import flatten_paths
    return sum(t.numel() * t.element_size() for _, t in flatten_paths(
        (params, opt["m"], opt["v"])))


def _timed(fn):
    """(fn(), its CUDA-event ms on this process's stream)."""
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _mesh_train_work(rank: int, seed: int):
    """One process of phase 23's training part (two processes on cuda:0).
    Both warm up together (a forward and backward of one short row), then
    per config each computes, in turn, the single-process reference from
    the seeded weights (a whole step, or with ``step`` false the forward
    and backward), keeping on the host what the gate compares: the first
    moment after the step from zero (0.1 x the clipped gradient), or the
    gradients. Then each layout's sharded step runs in both: the whole
    batch's loss and grad norm, this process's shard of each compared leaf
    held against the same slice of its reference (max |sharded - single|
    / max |single| over the whole leaf), the state bytes held, the
    CUDA-event ms and the B7 launches of the step (or of the forward and
    backward). No gradient is gathered: gloo's collectives are slow on
    one card, and each process holds the reference itself."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core.formats import TRAIN_FORMATS_MXINT
    from repro_torch.core.qat import QATConfig
    from repro_torch.core.tree import flatten_paths
    from repro_torch.kernels import fake_quant
    from repro_torch.launch.mesh import Mesh, make_debug_mesh
    from repro_torch.models.transformer import make_model
    from repro_torch.optim.adamw import (AdamWConfig, global_norm,
                                         init_opt_state)
    from repro_torch.serve.packed_params import local_shard
    from repro_torch.train.state import (TrainState, build_train_step,
                                         make_sharded_train_step, with_specs)

    opt = AdamWConfig(lr=TRAIN_LR)
    one = Mesh(np.arange(1).reshape(1, 1), ("data", "model"))
    t0 = time.perf_counter()

    def lap(what):
        log(f"mesh train rank {rank}: {what} at "
            f"{time.perf_counter() - t0:.1f} s")

    def reference(api, batch, whole_step):
        """The single-process reference: (its record, {path: host
        tensor} of the compared tree, {path: max |x|})."""
        params = api.init_params(seed, device="cuda")
        fake_quant.reset_launches()
        if whole_step:
            state = TrainState(params, init_opt_state(params, opt), 0)
            (new, m), ms = _timed(lambda: build_train_step(api, opt)(
                state, batch, 1))
            rec = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                       ms=ms, bytes=_state_bytes(state.params, state.opt))
            tree = new.opt["m"]
        else:
            single, _ = make_sharded_train_step(api, one, opt, batch)
            (loss, tree), ms = _timed(lambda: single.loss_and_grads(
                params, batch, 1))
            rec = dict(loss=float(loss), grad_norm=float(global_norm(tree)),
                       ms=ms)
        rec["fake_quant"] = fake_quant.launches["fake_quant"]
        ref = {k: v.cpu() for k, v in flatten_paths(tree)}
        scale = {k: float(v.abs().max()) for k, v in flatten_paths(tree)}
        return rec, ref, scale

    out = {}
    for name, layers, rows, layouts, whole_step in MESH_TRAIN:
        cfg = _mesh_train_cfg(name, layers)
        api = make_model(cfg, qat=QATConfig(formats=TRAIN_FORMATS_MXINT))
        batch = _mesh_train_batch(cfg, rows, seed)
        if not out:         # both processes load their kernels together:
            #                 a forward and backward of one short row (no
            #                 optimizer state: both processes do it at once)
            params = api.init_params(seed, device="cuda")
            one_row = make_sharded_train_step(api, one, opt, batch)[0]
            one_row.loss_and_grads(params, {k: v[:1, :64]
                                            for k, v in batch.items()}, 1)
            del params, one_row
            torch.cuda.empty_cache()
            lap("warm-up")
        rec = {"layouts": {}}
        for turn in range(2):       # one reference at a time on the card
            if turn == rank:
                rec["single"], ref, scale = reference(api, batch,
                                                      whole_step)
                torch.cuda.empty_cache()
                lap(f"{name} single process")
            dist.barrier()
        for shape in layouts:
            mesh = make_debug_mesh(*shape)
            step, specs = make_sharded_train_step(api, mesh, opt, batch)
            params = api.init_params(seed, device="cuda")
            whole_bytes = 3 * sum(t.numel() * t.element_size()
                                  for _, t in flatten_paths(params))
            lp = local_shard(params, specs.params, mesh)
            del params
            torch.cuda.empty_cache()
            lb = step.shard_batch(batch)
            fake_quant.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            if whole_step:
                local = TrainState(lp, init_opt_state(lp, opt), 0)
                (new, m), ms = _timed(lambda: step(local, lb, 1))
                loss, gnorm = m["loss"], m["grad_norm"]
                held = _state_bytes(local.params, local.opt)
                cmp = new.opt["m"]
                del local, m, new
            else:
                (loss, cmp), ms = _timed(
                    lambda: step.loss_and_grads(lp, lb, 1))
                gnorm = step.global_norm(cmp)
                held = 3 * sum(t.numel() * t.element_size()
                               for _, t in flatten_paths(lp))
            launched = fake_quant.launches["fake_quant"]
            peak = torch.cuda.max_memory_allocated() / 1e9
            lap(f"{name} {shape} step")
            worst, worst_leaf = 0.0, None
            for k, leaf, spec in with_specs(cmp, specs.params):
                want = local_shard(ref[k], spec, mesh).to(leaf.device)
                err = float((leaf - want).abs().max()) / max(scale[k], 1e-30)
                if err >= worst:
                    worst, worst_leaf = err, k
                del want
            rec["layouts"][shape] = dict(
                loss=float(loss), grad_norm=float(gnorm), ms=ms,
                fake_quant=launched, worst=worst, worst_leaf=worst_leaf,
                bytes=held, whole_bytes=whole_bytes, peak=peak)
            del lp, lb, step, cmp
            torch.cuda.empty_cache()
            dist.barrier()
            lap(f"{name} {shape} compared")
        out[name] = rec
        del batch, ref
        torch.cuda.empty_cache()
    out["sp"] = _mesh_sp_work(seed, opt)
    lap("sequence-parallel case")
    return out


def _mesh_sp_work(seed: int, opt):
    """Phase 23's sequence-parallel case in one process of two: qwen3-4b at
    MESH_LAYERS layers, f32, the forward and backward of the sharded step
    at (1, 2) with ``seq_sharding`` off, then on, from the same weights
    and batch. Per setting: loss, grad norm, B7 launches, CUDA-event ms and
    the peak allocation's rise over the step; whether every gradient leaf
    of this process's shard is bit-identical between the two."""
    import dataclasses

    import torch
    from repro_torch.core.formats import TRAIN_FORMATS_MXINT
    from repro_torch.core.qat import QATConfig
    from repro_torch.core.tree import flatten_paths
    from repro_torch.kernels import fake_quant
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.transformer import make_model
    from repro_torch.serve.packed_params import local_shard
    from repro_torch.train.state import make_sharded_train_step

    cfg = _mesh_train_cfg("qwen3-4b", MESH_LAYERS)
    batch = _mesh_train_batch(cfg, TRAIN_BATCH, seed)
    mesh = make_debug_mesh(1, MESH_TP)
    rec, grads = {}, {}
    for flag in (False, True):
        api = make_model(dataclasses.replace(cfg, seq_sharding=flag),
                         qat=QATConfig(formats=TRAIN_FORMATS_MXINT))
        step, specs = make_sharded_train_step(api, mesh, opt, batch)
        params = api.init_params(seed, device="cuda")
        lp = local_shard(params, specs.params, mesh)
        del params
        torch.cuda.empty_cache()
        lb = step.shard_batch(batch)
        fake_quant.reset_launches()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (loss, g), ms = _timed(lambda: step.loss_and_grads(lp, lb, 1))
        rise = torch.cuda.max_memory_allocated() - base
        grads[flag] = dict(flatten_paths(g))
        rec[flag] = dict(loss=float(loss),
                         grad_norm=float(step.global_norm(g)), ms=ms,
                         rise=rise,
                         fake_quant=fake_quant.launches["fake_quant"])
        del lp, lb, step, g
        torch.cuda.empty_cache()
    rec["same"] = grads[False].keys() == grads[True].keys() and all(
        torch.equal(v, grads[True][k]) for k, v in grads[False].items())
    rec["saved_inputs"] = cfg.n_groups * TRAIN_BATCH * TRAIN_SEQ * \
        cfg.d_model * 4
    return rec


def _mesh_train_rank(rank: int, port: int, seed: int, q) -> None:
    """One process of phase 23's training part: cuda:0 in a gloo group of
    two; puts its record (or the error) on ``q``."""
    import traceback
    try:
        import torch
        import torch.distributed as dist
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=2, rank=rank)
        try:
            q.put((rank, "ok", _mesh_train_work(rank, seed)))
        finally:
            dist.destroy_process_group()
    except (Exception, SystemExit):
        q.put((rank, "error", traceback.format_exc()))


def _replica_rank(rank: int, port: int, seed: int, q) -> None:
    """One process of phase 23's ReplicaSet(2, tp=2): cuda:0 in a gloo
    group of four, the anchor rebuilt from the seed, one greedy wave of
    ``_requests`` at mxint8; puts its record on ``q``."""
    import traceback
    try:
        import torch
        import torch.distributed as dist
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=4, rank=rank)
        try:
            from repro_torch.kernels import mx_matmul
            from repro_torch.kernels import paged_attention as pa
            from repro_torch.models.transformer import make_model
            from repro_torch.serve.replicas import ReplicaSet
            start = time.perf_counter()
            cfg = qwen3_4b(MESH_LAYERS)
            _reset_quant_launches()
            anchor = build_anchor(cfg, seed, save=False)
            rs = ReplicaSet(make_model(cfg), anchor, n_replicas=2, tp=2,
                            batch_slots=SLOTS, max_len=MAX_LEN,
                            device="cuda")
            rs.engines[0].weights_for("mxint8")
            digest = _anchor_digest(anchor)
            torch.cuda.empty_cache()    # four processes share the card
            reqs = _requests(cfg.vocab, seed)
            mx_matmul.reset_launches()
            pa.reset_launches()
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = rs.generate(reqs, fmt_override="mxint8")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            log(f"replicas rank {rank}: anchor and engine built, then the "
                f"wave in {wall:.1f} s, at {time.perf_counter() - start:.1f}"
                " s")
            launches = {**mx_matmul.launches, **pa.launches}
            st = rs.stats()
            q.put((rank, "ok", dict(
                digest=digest, replica=rs.replica,
                same=all(a is b for a, b in zip(got, reqs)),
                rids=[r.rid for r in got],
                streams=[r.out_tokens for r in got],
                status=[r.status.value for r in got],
                homes=[rs.home(r.rid) for r in got], wall=wall,
                launches=launches, quant=_quant_launches(),
                stats={k: st[k] for k in ("n_replicas", "tp", "tokens_out",
                                          "ticks")})))
        finally:
            dist.destroy_process_group()
    except (Exception, SystemExit):
        q.put((rank, "error", traceback.format_exc()))


def _spawn(target, world: int, seed: int, what: str):
    """Start ``world`` processes of ``target`` together and return their
    records in rank order; fails if one fails."""
    import multiprocessing as mp
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, port, seed, q))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            rank, kind, val = q.get(timeout=600)
            got[rank] = (kind, val)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    errors = [f"rank {r}: {v}" for r, (k, v) in got.items() if k != "ok"]
    if errors:
        fail(f"{what} processes failed:\n" + "\n".join(errors))
    return [got[r][1] for r in range(world)]


def _check_sp(ranks) -> None:
    """Phase 23's sequence-parallel gates (``_mesh_sp_work``'s records):
    bit identity and equal B7 launches in every process, and rank 0's peak
    rise below the flag-off one by about (tp - 1) / tp of the saved group
    inputs."""
    for r, out in enumerate(ranks):
        rec = out["sp"]
        off, on = rec[False], rec[True]
        log(f"mesh train qwen3-4b (1, 2) seq_sharding rank {r}: loss "
            f"{on['loss']!r} (off {off['loss']!r}), grad norm "
            f"{on['grad_norm']!r} (off {off['grad_norm']!r}); every "
            f"gradient leaf of this shard bit-identical: {rec['same']}; "
            f"forward + backward {on['ms']:.1f} ms (off {off['ms']:.1f}; "
            f"gloo on one card, not a speed); peak allocation rise "
            f"{on['rise']} B (off {off['rise']} B); B7 launches "
            f"{on['fake_quant']} (off {off['fake_quant']})")
        if (on["loss"], on["grad_norm"]) != (off["loss"], off["grad_norm"]) \
                or not rec["same"]:
            fail(f"mesh train seq_sharding rank {r}: not bit-identical to "
                 "the flag off")
        if on["fake_quant"] != off["fake_quant"]:
            fail(f"mesh train seq_sharding rank {r}: B7 launches "
                 f"{on['fake_quant']} against {off['fake_quant']}")
    rec = ranks[0]["sp"]
    want = rec["saved_inputs"] * (MESH_TP - 1) / MESH_TP
    drop = rec[False]["rise"] - rec[True]["rise"]
    log(f"mesh train seq_sharding rank 0: the peak rise falls by {drop} B; "
        f"(tp - 1) / tp of the saved group inputs is {want:.0f} B "
        f"({drop / want:.4f} of it; gate {1 - SP_SAVING_TOL:.2f}-"
        f"{1 + SP_SAVING_TOL:.2f})")
    if not abs(drop - want) <= SP_SAVING_TOL * want:
        fail(f"mesh train seq_sharding: the peak rise fell by {drop} B, "
             f"not about {want:.0f} B")


def phase_mesh_train(seed: int):
    """Phase 23: the sharded training step (FSDP and tensor parallelism)
    and a ReplicaSet of tp = 2 on the one card, processes over gloo.
    Returns the launch counts of the main path: B7 of the sharded steps,
    B1-B4 and B5 / B6 of the replicas' processes."""
    import torch
    from repro_torch.models.transformer import make_model
    from repro_torch.serve.replicas import ReplicaSet

    t_phase = time.perf_counter()
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    gc.collect()            # what earlier phases' engines still hold
    torch.cuda.empty_cache()
    held, reserved = (f(0) / 1e9 for f in (torch.cuda.memory_allocated,
                                            torch.cuda.memory_reserved))
    log(f"mesh train: this process holds {held:.2f} GB ({reserved:.2f} GB "
        "reserved) of the card the processes share")
    ranks = _spawn(_mesh_train_rank, 2, seed, "mesh training")
    tol = MESH_TRAIN_TOL
    for name, layers, rows, layouts, whole_step in MESH_TRAIN:
        single = ranks[0][name]["single"]
        other = ranks[1][name]["single"]
        if abs(other["loss"] - single["loss"]) > tol * abs(single["loss"]):
            fail(f"mesh train {name}: the two processes' single-process "
                 f"references differ ({single['loss']} / {other['loss']})")
        what = "a whole step" if whole_step else "forward + backward"
        cmp = "first moment after the step (0.1 x the clipped gradient)" \
            if whole_step else "gradient"
        log(f"mesh train {name} ({layers} layers, batch {rows} x seq "
            f"{TRAIN_SEQ}, f32, direct MXINT QAT at mxint4): one process's "
            f"loss {single['loss']:.6f}, grad norm {single['grad_norm']:.6f}, "
            f"{what} {single['ms']:.1f} ms (CUDA events)"
            + (f", state {single['bytes']} bytes" if whole_step else "")
            + f"; B7 launches {single['fake_quant']} (process 1's "
            f"reference: loss {other['loss']:.6f}, {other['ms']:.1f} ms)")
        for shape in layouts:
            recs = [r[name]["layouts"][shape] for r in ranks]
            for r, rec in enumerate(recs):
                add({"fake_quant": rec["fake_quant"]})
                ratio = rec["bytes"] / rec["whole_bytes"]
                log(f"mesh train {name} {shape} rank {r}: loss "
                    f"{rec['loss']:.6f}, grad norm {rec['grad_norm']:.6f}; "
                    f"{what} {rec['ms']:.1f} ms (CUDA events; two processes "
                    "share the card over gloo: a correctness run, not a "
                    f"sharded speed); state {rec['bytes']} of "
                    f"{rec['whole_bytes']} bytes ({ratio:.4f}), peak "
                    f"allocated {rec['peak']:.2f} GB; B7 launches "
                    f"{rec['fake_quant']}")
                for key in ("loss", "grad_norm"):
                    if abs(rec[key] - single[key]) > tol * abs(single[key]):
                        fail(f"mesh train {name} {shape} rank {r}: {key} "
                             f"{rec[key]} vs one process's {single[key]}, "
                             f"beyond {tol} relative")
                if not 0.5 <= ratio < 0.52:
                    fail(f"mesh train {name} {shape} rank {r}: state bytes "
                         f"{ratio:.4f} of the whole, not about half")
                if rec["fake_quant"] != single["fake_quant"]:
                    fail(f"mesh train {name} {shape} rank {r}: B7 launches "
                         f"{rec['fake_quant']}, one process "
                         f"{single['fake_quant']}")
            worst = max(recs, key=lambda r: r["worst"])
            log(f"mesh train {name} {shape}: each process's shard of the "
                f"{cmp}, worst leaf {worst['worst_leaf']} at "
                f"{worst['worst']:.3g} x its max (gate {tol}); {what} "
                f"{max(r['ms'] for r in recs):.1f} ms against one process's "
                f"{single['ms']:.1f} ms")
            if not worst["worst"] <= tol:
                fail(f"mesh train {name} {shape}: {cmp} "
                     f"{worst['worst_leaf']} differs by "
                     f"{worst['worst']:.3g} of its max")
    _check_sp(ranks)
    log(f"mesh train: {time.perf_counter() - t_phase:.1f} s")

    # ---- ReplicaSet(2, tp=2): four processes against one process's set
    cfg = qwen3_4b(MESH_LAYERS)
    _reset_quant_launches()
    anchor = build_anchor(cfg, seed, save=False)
    digest = _anchor_digest(anchor)
    lone = ReplicaSet(make_model(cfg), anchor, n_replicas=2,
                      batch_slots=SLOTS, max_len=MAX_LEN, device="cuda",
                      cuda_graphs=False)
    want = [r.out_tokens for r in lone.generate(_requests(cfg.vocab, seed),
                                                fmt_override="mxint8")]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reps = _spawn(_replica_rank, 4, seed, "ReplicaSet(2, tp=2)")
    spawn_s = time.perf_counter() - t0
    for r, rec in enumerate(reps):
        add(rec["launches"])
        add(rec["quant"])
        if rec["digest"] != digest:
            fail(f"replicas rank {r}: its anchor differs from the parent's")
        if not rec["same"] or rec["rids"] != list(range(N_REQ)) or \
                rec["homes"] != [i % 2 for i in range(N_REQ)] or \
                rec["status"] != ["completed"] * N_REQ or \
                rec["replica"] != r // 2:
            fail(f"replicas rank {r}: rids {rec['rids']}, homes "
                 f"{rec['homes']}, status {rec['status']}, replica "
                 f"{rec['replica']}")
        if rec["stats"] != {"n_replicas": 2, "tp": 2,
                            "tokens_out": N_REQ * MAX_NEW,
                            "ticks": rec["stats"]["ticks"]}:
            fail(f"replicas rank {r}: stats {rec['stats']}")
        if rec["streams"] != reps[0]["streams"]:
            fail(f"replicas rank {r}: streams differ from rank 0's")
    same, total, first = _agreement(reps[0]["streams"], want)
    tokens = N_REQ * MAX_NEW
    wall = max(rec["wall"] for rec in reps)
    log(f"mesh phase ReplicaSet(n_replicas=2, tp=2), four processes on the "
        f"card: {tokens} tokens in {wall:.3f} s = {tokens / wall:.1f} tok/s "
        f"(eager ticks over gloo, the replicas at the same time; a "
        f"correctness run); every process returned all {N_REQ} requests; "
        f"greedy tokens equal to the single-process set's {same}/{total}, "
        f"first differing position per stream {first}; homes rid % 2; "
        f"ticks {reps[0]['stats']['ticks']}; the four processes took "
        f"{spawn_s:.1f} s from spawn to their records")
    _near_ties(lone.engines[0], "mxint8", cfg, seed, reps[0]["streams"], want,
               first, "ReplicaSet tp 2 mxint8")
    del lone, anchor
    torch.cuda.empty_cache()
    log(f"mesh train phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---- phase 24: tensor-parallel training of the other families -----------
# (config, cut of the published config): each at its published widths, one
# layer (jamba: published layer 2, Mamba + MLP, phase 18's training cut;
# seamless: one encoder and one decoder layer).
MESH_FAMILY = (
    ("mixtral-8x7b", dict(n_layers=1)),
    ("jamba-1.5-large-398b", dict(n_layers=1, scan_group=1, attn_every=2,
                                  attn_offset=1, moe_every=2, moe_offset=1)),
    ("rwkv6-7b", dict(n_layers=1)),
    ("llava-next-mistral-7b", dict(n_layers=1)),
    ("seamless-m4t-large-v2", dict(n_layers=1, enc_layers=1)))
MESH_FAMILY_ROWS, MESH_FAMILY_FRAMES = 2, 1024
# llava's text behind its 2,880 image positions: 3,392 positions in all,
# which its seq_chunk (1,024) does not divide, so flash attention runs its
# padded plan (4 chunks of 1,024, the causally empty pairs skipped; the
# reference's rule would halve the chunk to 64: 53 x 53 blocks)
MESH_FAMILY_VLM_TEXT = 512


def _mesh_family_cfg(name: str):
    """``name`` cut as MESH_FAMILY says, in f32 (as phase 23's configs)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(name), compute_dtype=torch.float32,
                               **dict(MESH_FAMILY)[name])


def _mesh_family_batch(cfg, seed: int):
    """``_mesh_train_batch`` of MESH_FAMILY_ROWS rows, with the image
    prefix (x 0.02, as the vlm phase's) ahead of MESH_FAMILY_VLM_TEXT
    tokens, or the MESH_FAMILY_FRAMES frame embeddings the family reads."""
    import torch
    batch = _mesh_train_batch(cfg, MESH_FAMILY_ROWS, seed,
                              MESH_FAMILY_VLM_TEXT if cfg.vision_tokens
                              else TRAIN_SEQ)
    gen = torch.Generator(device="cuda").manual_seed(seed + 24)
    if cfg.vision_tokens:
        batch["vision_embeds"] = torch.randn(
            (MESH_FAMILY_ROWS, cfg.vision_tokens, cfg.d_model),
            generator=gen, device="cuda") * 0.02
    if cfg.family == "encdec":
        batch["frame_embeds"] = torch.randn(
            (MESH_FAMILY_ROWS, MESH_FAMILY_FRAMES, cfg.d_model),
            generator=gen, device="cuda")
    return batch


def _mesh_family_work(rank: int, seed: int):
    """One process of phase 24 (two processes on cuda:0). Both warm up
    together (the reduced mixtral's step at (1, 2): B7 and the
    collectives), then per family each computes, in turn, the
    single-process forward and backward from the seeded weights and keeps
    its own shard of the gradients on the card (no host copy); then
    make_sharded_train_step at (1, 2) runs in both: the whole batch's loss
    and grad norm, this process's shard of each gradient leaf held against
    the same slice of its reference (max |sharded - single| / max |single|
    over the whole leaf), the parameter bytes it holds against the whole
    tree's, the CUDA-event ms and the B7 launches of the forward and
    backward. No AdamW (phase 23 learned that the f32 states of two
    processes do not fit with the references)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_reduced
    from repro_torch.core.formats import TRAIN_FORMATS_MXINT
    from repro_torch.core.qat import QATConfig
    from repro_torch.core.tree import flatten_paths
    from repro_torch.kernels import fake_quant
    from repro_torch.launch.mesh import Mesh, make_debug_mesh
    from repro_torch.models import get_model
    from repro_torch.optim.adamw import AdamWConfig, global_norm
    from repro_torch.serve.packed_params import local_shard
    from repro_torch.train.state import make_sharded_train_step, with_specs

    opt = AdamWConfig(lr=TRAIN_LR)
    qat = QATConfig(formats=TRAIN_FORMATS_MXINT)
    one = Mesh(np.arange(1).reshape(1, 1), ("data", "model"))
    mesh = make_debug_mesh(1, 2)
    t0 = time.perf_counter()

    def lap(what):
        log(f"mesh family rank {rank}: {what} at "
            f"{time.perf_counter() - t0:.1f} s")

    def nbytes(tree):
        return sum(t.numel() * t.element_size()
                   for _, t in flatten_paths(tree))

    small = get_model(get_reduced("mixtral-8x7b"), qat)
    params = small.init_params(seed, device="cuda")
    batch = _mesh_train_batch(small.cfg, 2, seed)
    step, specs = make_sharded_train_step(small, mesh, opt, batch)
    step.loss_and_grads(local_shard(params, specs.params, mesh),
                        step.shard_batch(batch), 1)
    del small, params, batch, step
    lap("warm-up")
    out = {}
    for name, _ in MESH_FAMILY:
        cfg = _mesh_family_cfg(name)
        api = get_model(cfg, qat)
        batch = _mesh_family_batch(cfg, seed)
        step, specs = make_sharded_train_step(api, mesh, opt, batch)
        rec = {}
        for turn in range(2):       # one reference at a time on the card
            if turn == rank:
                params = api.init_params(seed, device="cuda")
                single, _ = make_sharded_train_step(api, one, opt, batch)
                fake_quant.reset_launches()
                (loss, grads), ms = _timed(lambda: single.loss_and_grads(
                    params, batch, 1))
                rec["single"] = dict(loss=float(loss),
                                     grad_norm=float(global_norm(grads)),
                                     ms=ms, fake_quant=fake_quant.launches[
                                         "fake_quant"])
                scale = {k: float(v.abs().max())
                         for k, v in flatten_paths(grads)}
                ref = {k: local_shard(v, spec, mesh).clone()
                       for k, v, spec in with_specs(grads, specs.params)}
                del params, single, grads, loss
                torch.cuda.empty_cache()
                lap(f"{name} single process")
            dist.barrier()
        params = api.init_params(seed, device="cuda")
        whole = nbytes(params)
        lp = local_shard(params, specs.params, mesh)
        del params
        torch.cuda.empty_cache()
        lb = step.shard_batch(batch)
        fake_quant.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        (loss, grads), ms = _timed(lambda: step.loss_and_grads(lp, lb, 1))
        gnorm = step.global_norm(grads)
        launched = fake_quant.launches["fake_quant"]
        peak = torch.cuda.max_memory_allocated() / 1e9
        worst, worst_leaf = 0.0, None
        for k, leaf in flatten_paths(grads):
            err = float((leaf - ref[k]).abs().max()) / max(scale[k], 1e-30)
            if err >= worst:
                worst, worst_leaf = err, k
        rec["tp"] = dict(loss=float(loss), grad_norm=float(gnorm), ms=ms,
                         fake_quant=launched, worst=worst,
                         worst_leaf=worst_leaf, bytes=nbytes(lp),
                         whole_bytes=whole, peak=peak,
                         dims=str(step.tensor_parallel.dims))
        out[name] = rec
        del lp, lb, step, grads, loss, batch, ref
        torch.cuda.empty_cache()
        dist.barrier()
        lap(f"{name} (1, 2) compared")
    return out


def _mesh_family_rank(rank: int, port: int, seed: int, q) -> None:
    """One process of phase 24: cuda:0 in a gloo group of two; puts its
    record (or the error) on ``q``."""
    import traceback
    try:
        import torch
        import torch.distributed as dist
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=2, rank=rank)
        try:
            q.put((rank, "ok", _mesh_family_work(rank, seed)))
        finally:
            dist.destroy_process_group()
    except (Exception, SystemExit):
        q.put((rank, "error", traceback.format_exc()))


def phase_mesh_family(seed: int):
    """Phase 24: tensor-parallel training of every family but the dense
    one, at (1, 2), two processes on the one card over gloo (a correctness
    run, not a sharded speed): forward and backward against one process's,
    gated on the loss, every gradient leaf and the B7 launches. Returns
    the B7 launches of the sharded runs."""
    import torch
    t_phase = time.perf_counter()
    for name, cut in MESH_FAMILY:
        prefix = _mesh_family_cfg(name).vision_tokens
        seq = f"{prefix} + {MESH_FAMILY_VLM_TEXT}" if prefix \
            else f"{TRAIN_SEQ}"
        log(f"DEPTH CUT: {name} trains {cut['n_layers']} layer"
            + (f" and {cut['enc_layers']} encoder layer"
               if "enc_layers" in cut else "")
            + f" at published widths, f32, batch {MESH_FAMILY_ROWS} x seq "
            + seq + (", published layer 2 (Mamba + MLP)" if "jamba" in name
                     else ""))
    log("DEPTH CUT: jamba's expert layer (16 experts of 8192 x 24576) is "
        "left out: its f32 weights and gradients do not fit twice on one "
        "card beside the references, so mixtral-8x7b carries the "
        "expert-parallel path on the card")
    gc.collect()
    torch.cuda.empty_cache()
    ranks = _spawn(_mesh_family_rank, 2, seed, "mesh family training")
    tol = MESH_TRAIN_TOL
    launches = 0
    for name, _ in MESH_FAMILY:
        single = ranks[0][name]["single"]
        other = ranks[1][name]["single"]
        if abs(other["loss"] - single["loss"]) > tol * abs(single["loss"]):
            fail(f"mesh family {name}: the two processes' single-process "
                 f"references differ ({single['loss']} / {other['loss']})")
        log(f"mesh family {name} one process: loss {single['loss']:.6f}, "
            f"grad norm {single['grad_norm']:.6f}, forward + backward "
            f"{single['ms']:.1f} ms (CUDA events), B7 launches "
            f"{single['fake_quant']} (process 1's reference: loss "
            f"{other['loss']:.6f}, {other['ms']:.1f} ms)")
        recs = [r[name]["tp"] for r in ranks]
        for r, rec in enumerate(recs):
            launches += rec["fake_quant"]
            log(f"mesh family {name} (1, 2) rank {r} ({rec['dims']}): loss "
                f"{rec['loss']:.6f}, grad norm {rec['grad_norm']:.6f}; "
                f"forward + backward {rec['ms']:.1f} ms (CUDA events; two "
                "processes share the card over gloo: a correctness run, "
                f"not a sharded speed); parameters {rec['bytes']} of "
                f"{rec['whole_bytes']} bytes "
                f"({rec['bytes'] / rec['whole_bytes']:.4f}), peak allocated "
                f"{rec['peak']:.2f} GB; B7 launches {rec['fake_quant']}")
            for key in ("loss", "grad_norm"):
                if abs(rec[key] - single[key]) > tol * abs(single[key]):
                    fail(f"mesh family {name} rank {r}: {key} {rec[key]} "
                         f"vs one process's {single[key]}, beyond {tol} "
                         "relative")
            if rec["fake_quant"] != single["fake_quant"]:
                fail(f"mesh family {name} rank {r}: B7 launches "
                     f"{rec['fake_quant']}, one process "
                     f"{single['fake_quant']}")
        worst = max(recs, key=lambda r: r["worst"])
        log(f"mesh family {name} (1, 2): each process's shard of the "
            f"gradient, worst leaf {worst['worst_leaf']} at "
            f"{worst['worst']:.3g} x its max (gate {tol}); forward + "
            f"backward {max(r['ms'] for r in recs):.1f} ms against one "
            f"process's {single['ms']:.1f} ms; card " + _SMI[0])
        if not worst["worst"] <= tol:
            fail(f"mesh family {name}: gradient {worst['worst_leaf']} "
                 f"differs by {worst['worst']:.3g} of its max")
    log(f"mesh family phase: {time.perf_counter() - t_phase:.1f} s")
    return {"fake_quant": launches}


def phase_dryrun(seed: int, src: str) -> None:
    """Phase 25: the dry run held against the card. A 1 x 1 qwen3-4b train
    step on real zeros (``trace_cell(fake=False)``: the same counters)
    against the trace of the same step on fake ``cuda`` tensors: FLOPs and
    B7 launches equal, argument + temp bytes within DRYRUN_MEM_TOL of the
    card's peak over the step; a w4 decode step the same way, every
    kernel's launches equal. Then the records of one production cell on a
    fake world of 256 ranks at each of DRYRUN_VARIANTS, which the dry run's
    CLI traced on this host beside the card's phases
    (``start_dryrun_cell``; the whole run starts it before phase 21); the
    ``sp`` cell's temp bytes below the baseline's. Nothing here counts toward the kernels' record:
    the real steps are comparisons, the traces launch nothing."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh

    t_phase = time.perf_counter()
    was = dist.is_available() and dist.is_initialized()
    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_debug_mesh(1, 1)
    cfg = _mesh_train_cfg("qwen3-4b", MESH_LAYERS)
    start_dryrun_cell(src)        # a no-op where the whole run started it
    _dryrun_card_steps(cfg, mesh)
    t0 = time.perf_counter()
    cell = _DRYRUN_CELL
    recs = {}
    try:
        rc = cell["proc"].wait(timeout=600)
        for variant in DRYRUN_VARIANTS:
            path = os.path.join(
                cell["out_dir"], f"qwen3-4b__train_4k__16x16__{variant}.json")
            if rc != 0 or not os.path.exists(path):
                with open(os.path.join(cell["out_dir"], "log")) as f:
                    fail(f"dry run CLI ({' '.join(cell['cmd'][1:])}) exited "
                         f"{rc}: {f.read()[-2000:]}")
            with open(path) as f:
                recs[variant] = json.load(f)
    finally:
        _stop_dryrun_cell()
    now = dist.is_available() and dist.is_initialized()
    if now != was:
        fail(f"dry run: the default process group was {was} before the "
             f"phase and is {now} after it")
    for variant, rec in recs.items():
        log(f"dry run production cell ({variant}): " + json.dumps(rec))
        mem = rec.get("memory", {})
        log(f"dry run production cell qwen3-4b train_4k 16x16 {variant}: "
            f"{rec['status']}, traced in {rec.get('compile_s', 0):.1f} s "
            f"beside the card's phases; per rank argument "
            f"{mem.get('argument_size_in_bytes', 0) / 2**30:.2f} GiB + temp "
            f"{mem.get('temp_size_in_bytes', 0) / 2**30:.2f} GiB; "
            f"all-gather {rec.get('collectives', {}).get('all-gather', 0)} "
            "B a rank")
        if rec["status"] != "ok" or rec["n_devices"] != 256 or \
                rec["launches"] != {"fake_quant": _n_proj_leaves(cfg)}:
            fail(f"dry run production cell {variant}: {rec.get('status')}, "
                 f"launches {rec.get('launches')}")
    log(f"dry run production cells: {time.perf_counter() - t0:.1f} s "
        "waited for")
    temp = {v: r["memory"]["temp_size_in_bytes"] for v, r in recs.items()}
    if not temp["sp"] < temp["baseline"]:
        fail(f"dry run production cell: temp at sp {temp['sp']} B, not "
             f"below the baseline's {temp['baseline']} B")
    log(f"dry run phase: {time.perf_counter() - t_phase:.1f} s")


_DRYRUN_CELL: dict = {}     # phase 25's production-cell trace, running


def start_dryrun_cell(src: str) -> None:
    """Start phase 25's production cell: ``python -m
    repro_torch.launch.dryrun`` traces qwen3-4b train_4k on the 16 x 16 mesh
    over a fake world of 256 ranks on ``meta`` tensors at each of
    DRYRUN_VARIANTS, in turn, in a process of
    its own that sees no card. It is host work only, so it runs beside the
    card's phases; it is stopped at exit, whatever happens."""
    if _DRYRUN_CELL:
        return
    out_dir = tempfile.mkdtemp(prefix="dryrun_cell_")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "qwen3-4b", "--shape", "train_4k", "--mesh", "single",
           "--variant", ",".join(DRYRUN_VARIANTS), "--out", out_dir]
    with open(os.path.join(out_dir, "log"), "w") as out:
        proc = subprocess.Popen(
            cmd, env=dict(os.environ, PYTHONPATH=os.path.abspath(src),
                          CUDA_VISIBLE_DEVICES=""),
            stdout=out, stderr=subprocess.STDOUT)
    _DRYRUN_CELL.update(proc=proc, out_dir=out_dir, cmd=cmd)
    atexit.register(_stop_dryrun_cell)


def _stop_dryrun_cell() -> None:
    proc = _DRYRUN_CELL.get("proc")
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait()
    if "out_dir" in _DRYRUN_CELL:
        shutil.rmtree(_DRYRUN_CELL["out_dir"], ignore_errors=True)
    _DRYRUN_CELL.clear()


def _dryrun_card_steps(cfg, mesh) -> None:
    """Phase 25's steps on the card: the 1 x 1 train step of ``cfg`` and
    a w4 decode step, each real against its fake ``cuda`` trace."""
    import torch
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun

    def at_step():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def real_step(cell_cfg, cell_shape, variant="baseline"):
        """The real cell on the card: (record, the card's peak allocation
        over its step alone, above what was allocated before the cell)."""
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        rec = dryrun.trace_cell(cell_cfg, cell_shape, mesh, variant,
                                device="cuda", fake=False,
                                before_step=at_step)
        torch.cuda.synchronize()
        return rec, torch.cuda.max_memory_allocated() - before

    def held_to_peak(tag, rec, peak):
        mem = rec["memory"]
        held = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        gap = (held - peak) / peak
        log(f"dry run {tag}: FLOPs {rec['flops_counted']:.6g} counted + "
            f"{rec['flops'] - rec['flops_counted']:.6g} in kernels, bytes "
            f"{rec['bytes_accessed']:.6g}, memory {mem}, argument + temp "
            f"{held} against the card's peak over the step {peak} "
            f"({100 * gap:+.4f} %), setup launches {rec['setup_launches']}"
            f", step launches {rec['launches']}, trace "
            f"{rec['compile_s']:.2f} s; card " + _SMI[0])
        if abs(gap) > DRYRUN_MEM_TOL:
            fail(f"dry run {tag}: argument + temp {held} bytes, the card's "
                 f"peak {peak}: beyond {DRYRUN_MEM_TOL} relative")

    def held_to_real(tag, rec, real):
        if rec["flops_counted"] != real["flops_counted"] or \
                rec["launches"] != real["launches"] or \
                rec["setup_launches"] != real["setup_launches"]:
            fail(f"dry run {tag}: FLOPs {rec['flops_counted']} / launches "
                 f"{rec['setup_launches']}, {rec['launches']}; the real "
                 f"step's {real['flops_counted']} / "
                 f"{real['setup_launches']}, {real['launches']}")
        if rec["trace_device"] is None or \
                not rec["trace_device"].startswith("cuda"):
            fail(f"dry run {tag}: traced on {rec['trace_device']}, not on "
                 "fake cuda tensors")
        log(f"dry run {tag}: FLOPs and launches equal to the real step's, "
            "tracked memory " + ("equal to" if rec["memory"] == real["memory"]
                                 else "differs from") + " the real step's")

    # ---- a 1 x 1 train step: B7 in the forward
    shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    t0 = time.perf_counter()
    real_step(cfg, shape)                     # warm-up: kernels, cuBLAS
    log(f"dry run: qwen3-4b ({MESH_LAYERS} layers, f32) 1 x 1 train step "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} (warm-up "
        f"{time.perf_counter() - t0:.1f} s)")
    real, peak = real_step(cfg, shape)
    gc.collect()
    torch.cuda.empty_cache()
    trace = dryrun.trace_cell(cfg, shape, mesh, device="cuda")
    held_to_peak("train real", real, peak)
    held_to_peak("train fake cuda", trace, peak)
    held_to_real("train fake cuda", trace, real)
    if real["launches"] != {"fake_quant": _n_proj_leaves(cfg)}:
        fail(f"dry run: the real step launched {real['launches']}, want "
             f"B7 {_n_proj_leaves(cfg)} times")
    del real, trace

    # ---- a w4 decode step: the tree's build (B6, B5) and B2 in the step
    scfg = qwen3_4b(MESH_LAYERS)
    dshape = ShapeSpec("decode", DRYRUN_DECODE, SLOTS, "decode")
    gc.collect()
    torch.cuda.empty_cache()
    real_step(scfg, dshape, "w4")             # warm-up
    dreal, dpeak = real_step(scfg, dshape, "w4")
    gc.collect()
    torch.cuda.empty_cache()
    trace = dryrun.trace_cell(scfg, dshape, mesh, "w4", device="cuda")
    held_to_peak("w4 decode real", dreal, dpeak)
    held_to_peak("w4 decode fake cuda", trace, dpeak)
    held_to_real("w4 decode fake cuda", trace, dreal)
    if set(dreal["launches"]) != {"mx_matmul_int4"} or \
            set(dreal["setup_launches"]) != {"mx_quantize", "ss_convert"}:
        fail(f"dry run w4 decode: launches {dreal['setup_launches']} / "
             f"{dreal['launches']}, want B6 + B5 then B2")
    del dreal, trace
    gc.collect()
    torch.cuda.empty_cache()


def phase_cli(src: str):
    """The serving CLI at full width as a user runs it, in a process of its
    own: ``python3 -m repro_torch.launch.serve --arch starcoder2-3b
    --no-reduced --fmt mxint4`` prints four ``req`` lines and exits 0."""
    import torch
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "starcoder2-3b", "--no-reduced", "--fmt", "mxint4"]
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    lines = [line for line in proc.stdout.splitlines()
             if line.startswith("req ")]
    if proc.returncode != 0 or len(lines) != 4 or \
            any("fmt=mxint4" not in line for line in lines):
        fail(f"serving CLI exited {proc.returncode} with {len(lines)} req "
             f"lines: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    log(f"serving CLI ({' '.join(cmd[1:])}): exit 0 in {wall:.1f} s")
    for line in lines:
        log(f"  {line}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=QWEN3_LAYERS,
                    help="qwen3-4b depth of the format build, serving, "
                         "speculative, preemption and SLO phases (default: "
                         f"{QWEN3_LAYERS} of 36)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels-only", action="store_true",
                    help="card, build and dequant-GEMM phases only; no "
                         "result line")
    ap.add_argument("--quant-only", action="store_true",
                    help="card, build, quantize / fake-quant / "
                         "Slice-and-Scale and format-build phases only; no "
                         "result line")
    ap.add_argument("--serve-only", action="store_true",
                    help="card, build and the greedy graph ticks' walls "
                         "only; no result line")
    ap.add_argument("--slo-only", action="store_true",
                    help="card, build and the SLO phase only; no result "
                         "line")
    ap.add_argument("--family-only", action="store_true",
                    help="card, build, B1/B2 at the starcoder2-3b and "
                         "qwen2-72b shapes, their serving and the CLI only; "
                         "no result line")
    ap.add_argument("--moe-only", action="store_true",
                    help="card, build and the MoE phase (B1/B2 at the "
                         "mixtral shapes, mixtral-8x7b served) only; no "
                         "result line")
    ap.add_argument("--train-long-only", action="store_true",
                    help="card, build and long-sequence training only; no "
                         "result line")
    ap.add_argument("--vlm-only", action="store_true",
                    help="card, build and the vlm phase (llava served and "
                         "trained) only; no result line")
    ap.add_argument("--hybrid-only", action="store_true",
                    help="card, build, B1/B2 at the jamba shapes and the "
                         "hybrid phase (jamba served and trained) only; no "
                         "result line")
    ap.add_argument("--rwkv-only", action="store_true",
                    help="card, build, B1/B2 at the rwkv6-7b shapes and the "
                         "RWKV phase (rwkv6-7b served and trained) only; no "
                         "result line")
    ap.add_argument("--encdec-only", action="store_true",
                    help="card, build, B1/B2 at the seamless shapes and the "
                         "encoder-decoder phase (seamless served and "
                         "trained) only; no result line")
    ap.add_argument("--eval-only", action="store_true",
                    help="card, build and the evaluation phase (B1 at "
                         "mxfp6 / mxfp4, Fig. 4's protocol on smollm-135m, "
                         "its mxfp8 anchor served) only; no result line")
    ap.add_argument("--mesh-only", action="store_true",
                    help="card, build and the mesh phase (replicas, "
                         "tensor-parallel serving over gloo, gradient "
                         "compression) only; no result line")
    ap.add_argument("--mesh-train-only", action="store_true",
                    help="card, build and the mesh-training phase (the "
                         "sharded train step at (1, 2) and (2, 1), "
                         "ReplicaSet(2, tp=2)) only; no result line")
    ap.add_argument("--mesh-family-only", action="store_true",
                    help="card, build and tensor-parallel training of the "
                         "other families at (1, 2) only; no result line")
    ap.add_argument("--dryrun-only", action="store_true",
                    help="card, build and the dry-run phase (traces held "
                         "against real steps on the card, one production "
                         "cell) only; no result line")
    ap.add_argument("--train-only", action="store_true",
                    help="card, build and smollm-135m training runs A and B "
                         "only, for a same-call A/B of two trees; no result "
                         "line")
    ap.add_argument("--src", default=os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "src"),
        help="the tree whose repro_torch to measure (default: this one's)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke FAILED: no CUDA device; this script measures the "
              "port on a card and has no CPU mode", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    t_all = time.perf_counter()
    phase_card()
    phase_build()
    if args.serve_only:
        phase_serve_walls(args.seed, args.layers)
        log(f"greedy graph ticks only, {args.src}: "
            f"{time.perf_counter() - t_all:.1f} s")
        return 0
    if args.slo_only:
        cfg = qwen3_4b(args.layers)
        phase_slo(cfg, build_anchor(cfg, args.seed, save=False), args.seed)
        log(f"SLO phase only, {args.src}: "
            f"{time.perf_counter() - t_all:.1f} s")
        return 0
    if args.train_only:
        phase_train_ab(args.seed)
        log(f"training runs A and B only, {args.src}: "
            f"{time.perf_counter() - t_all:.1f} s")
        return 0
    if args.moe_only:
        phase_family_kernels(args.seed, MOE, MOE_MS)
        phase_moe_serving(args.seed)
        log(f"MoE only, {args.src}: {time.perf_counter() - t_all:.1f} s")
        return 0
    if args.vlm_only:
        phase_vlm(args.seed)
        log(f"vlm only, {args.src}: {time.perf_counter() - t_all:.1f} s")
        return 0
    if args.hybrid_only:
        phase_family_kernels(args.seed, HYBRID, HYBRID_MS)
        phase_hybrid(args.seed)
        log(f"hybrid only, {args.src}: {time.perf_counter() - t_all:.1f} s")
        return 0
    if args.rwkv_only:
        phase_family_kernels(args.seed, RWKV, FAMILY_MS)
        phase_rwkv(args.seed)
        log(f"rwkv only, {args.src}: {time.perf_counter() - t_all:.1f} s")
        return 0
    if args.encdec_only:
        phase_family_kernels(args.seed, ENCDEC, FAMILY_MS)
        phase_encdec(args.seed)
        log(f"encdec only, {args.src}: {time.perf_counter() - t_all:.1f} s")
        return 0
    if args.mesh_only:
        phase_mesh(args.seed)
        log(f"mesh only, {args.src}: {time.perf_counter() - t_all:.1f} s")
        return 0
    if args.mesh_train_only:
        phase_mesh_train(args.seed)
        log(f"mesh training only, {args.src}: "
            f"{time.perf_counter() - t_all:.1f} s")
        return 0
    if args.mesh_family_only:
        phase_mesh_family(args.seed)
        log(f"mesh family training only, {args.src}: "
            f"{time.perf_counter() - t_all:.1f} s")
        return 0
    if args.dryrun_only:
        phase_dryrun(args.seed, args.src)
        log(f"dry run only, {args.src}: {time.perf_counter() - t_all:.1f} s")
        return 0
    if args.eval_only:
        phase_eval(args.seed)
        log(f"eval only, {args.src}: {time.perf_counter() - t_all:.1f} s")
        return 0
    if args.train_long_only:
        phase_train_long(args.seed)
        log(f"long-sequence training only, {args.src}: "
            f"{time.perf_counter() - t_all:.1f} s")
        return 0
    if args.family_only:
        phase_family_kernels(args.seed)
        phase_dense_family(args.seed)
        phase_cli(args.src)
        log(f"dense family only, {args.src}: "
            f"{time.perf_counter() - t_all:.1f} s")
        return 0
    if args.quant_only:
        phase_quant_kernels(args.seed)
        cfg = qwen3_4b(args.layers)
        phase_format_build(cfg, build_anchor(cfg, args.seed, save=False))
        log(f"quantize kernels and format build only, {args.src}: "
            f"{time.perf_counter() - t_all:.1f} s")
        return 0
    mark = [time.perf_counter()]

    def lap(what: str) -> None:
        """The wall seconds since the last lap: where the script's time
        goes, against its time limit."""
        now = time.perf_counter()
        log(f"wall: {what} {now - mark[0]:.1f} s (total {now - t_all:.1f})")
        mark[0] = now

    agg = phase_kernels(args.seed)
    family_rows = phase_family_kernels(args.seed)
    lap("dequant-GEMM kernels")
    if args.kernels_only:
        log(f"kernels only, {args.src}: {time.perf_counter() - t_all:.1f} s")
        return 0
    paged_rec = phase_paged_kernels(args.seed)
    lap("paged-attention kernels")
    quant_rec = phase_quant_kernels(args.seed)
    lap("quantize kernels")
    # B5 / B6 / B7 launches: the sum over every run of the main path, each
    # read from counts set to 0 just before it
    quant_launches = {k: 0 for k in quant_rec}

    def add(counts):
        for k, v in counts.items():
            quant_launches[k] += v

    train_cfg, trained, counts = phase_training(args.seed)
    add(counts)
    add(phase_pipeline(train_cfg, trained, args.seed))
    del trained
    lap("training and pipeline")
    torch.cuda.empty_cache()
    cfg = qwen3_4b(args.layers)
    _reset_quant_launches()
    anchor = build_anchor(cfg, args.seed)
    counts = _quant_launches()
    if counts != {"mx_quantize": PROJ_PER_LAYER, "ss_convert": 0,
                  "fake_quant": 0}:
        fail(f"qwen3-4b make_anchor: kernel launches {counts}")
    add(counts)
    add(phase_format_build(cfg, anchor))
    lap("qwen3-4b anchor and format build")
    _reset_quant_launches()
    _draw_cost(args.seed)
    launches, streams, dense_eng = phase_serving(cfg, anchor, args.seed)
    torch.cuda.empty_cache()
    lap("dense serving")
    # B1/B2 launches: the dense waves' and the paged waves' (prefill chunks,
    # mixed and pure decode ticks), greedy, sampled, chaos, speculative and
    # resumed; B3/B4: the paged waves'
    paged, paged_eng, paged_streams = phase_paged_serving(cfg, anchor,
                                                          args.seed, streams)
    for k, v in paged.items():
        launches[k] = launches.get(k, 0) + v
    lap("paged serving and chaos")
    for label, eng, plain in (("dense", dense_eng, streams["mxint8"]),
                              ("paged", paged_eng, paged_streams["mxint8"])):
        for k, v in phase_speculative(label, eng, cfg, args.seed,
                                      plain).items():
            launches[k] = launches.get(k, 0) + v
    lap("speculative")
    for k, v in phase_preemption(paged_eng, cfg, args.seed).items():
        launches[k] = launches.get(k, 0) + v
    lap("preemption")
    del dense_eng, paged_eng
    torch.cuda.empty_cache()
    counts = _quant_launches()
    # five format builds — the dense phase's fused, unfused and poisoned
    # engines at mxint4, the poisoned one's mxint6 and the paged engine's
    # mxint4 — one B5 launch per leaf each (the sampling, chaos,
    # speculative and preemption engines serve their phase engine's trees,
    # and chaos wave B no longer escalates); the mxint8 builds are the
    # anchor itself and launch nothing
    want = {"mx_quantize": 0, "ss_convert": PROJ_PER_LAYER * 5,
            "fake_quant": 0}
    log(f"qwen3-4b serving phases (every format build): "
        f"launches {counts} (want {want})")
    if counts != want:
        fail(f"qwen3-4b serving: kernel launches {counts}, want {want}")
    add(counts)
    # the SLO phase on the qwen3-4b anchor, then the rest of the dense
    # family and the serving CLI; each phase reads its counts from 0
    for k, v in phase_slo(cfg, anchor, args.seed).items():
        if k in quant_launches:
            quant_launches[k] += v
        else:
            launches[k] = launches.get(k, 0) + v
    lap("SLO")
    del anchor
    gc.collect()        # what deleted engines may still hold, before the
    #                     family's anchors (the largest of the run)
    torch.cuda.empty_cache()
    for k, v in phase_dense_family(args.seed).items():
        if k in quant_launches:
            quant_launches[k] += v
        else:
            launches[k] = launches.get(k, 0) + v
    lap("dense family")
    phase_cli(args.src)
    lap("CLI")
    # the MoE family, long-sequence training, llava, jamba, rwkv6-7b and
    # seamless; each phase reads its counts from 0
    moe_rows = phase_family_kernels(args.seed, MOE, MOE_MS)
    hybrid_rows = phase_family_kernels(args.seed, HYBRID, HYBRID_MS)
    rwkv_rows = phase_family_kernels(args.seed, RWKV, FAMILY_MS)
    encdec_rows = phase_family_kernels(args.seed, ENCDEC, FAMILY_MS)
    lap("B1/B2 at the other families' shapes")
    for phase in (phase_moe_serving, phase_train_long, phase_vlm,
                  phase_hybrid, phase_rwkv, phase_encdec):
        for k, v in phase(args.seed).items():
            if k in quant_launches:
                quant_launches[k] += v
            else:
                launches[k] = launches.get(k, 0) + v
        lap(phase.__name__)
    # phase 25's production cell, traced on the host from here on
    start_dryrun_cell(args.src)
    # the evaluation path: Fig. 4's protocol and the MXFP rungs served
    counts, eval_rows = phase_eval(args.seed)
    for k, v in counts.items():
        if k in quant_launches:
            quant_launches[k] += v
        else:
            launches[k] = launches.get(k, 0) + v
    lap("phase_eval")
    # replicas, tensor-parallel serving and gradient compression
    counts, mesh_rows = phase_mesh(args.seed)
    for k, v in counts.items():
        if k in quant_launches:
            quant_launches[k] += v
        else:
            launches[k] = launches.get(k, 0) + v
    lap("phase_mesh")
    # the sharded training step and sharded replicas
    for k, v in phase_mesh_train(args.seed).items():
        if k in quant_launches:
            quant_launches[k] += v
        else:
            launches[k] = launches.get(k, 0) + v
    lap("phase_mesh_train")
    # tensor-parallel training of the other families
    add(phase_mesh_family(args.seed))
    lap("phase_mesh_family")
    # the dry run held against the card (its real steps compare, and
    # count toward no kernel's launches)
    phase_dryrun(args.seed, args.src)
    lap("phase_dryrun")
    from repro_torch.kernels import (fake_quant, mx_matmul, mx_quantize,
                                     paged_attention, ss_convert)
    root = os.path.dirname(os.path.abspath(__file__))
    kernels = []
    for (name, fname), a in agg.items():
        if fname == "mxfp8":
            continue              # the serving path runs mx_matmul at mxint8
        kernels.append({
            "name": name, "format": fname, "route": "cuda",
            "source": os.path.relpath(mx_matmul.SOURCE, root),
            "replaces": TPU_KERNEL[name],
            "launches": launches[name],
            "max_abs_err": a["max_abs_err"], "max_err": a["max_err"],
            "ms": a["ms"], "plain_ms": a["plain_ms"],
            "bound_ms": a["bound_ms"],
            "bound_by": "bytes" if a["t_bytes"] >= a["t_ops"]
            else "operations",
            "library_ms": a["library_ms"],
            "timed_as": f"one layer's {PROJ_PER_LAYER} qwen3-4b projections "
                        "at M=4",
            "ms_by_m": {m: per["ms"] for m, per in a["by_m"].items()},
            "ms_by_body_at_m": a["crossover"],
            "library_ms_by_m": {m: per["library_ms"]
                                for m, per in a["by_m"].items()},
            "family_shapes": [r for r in family_rows if r["kernel"] == name],
            "moe_shapes": [r for r in moe_rows if r["kernel"] == name],
            "hybrid_shapes": [r for r in hybrid_rows
                              if r["kernel"] == name],
            "rwkv_shapes": [r for r in rwkv_rows if r["kernel"] == name],
            "encdec_shapes": [r for r in encdec_rows
                              if r["kernel"] == name],
            "mxfp_shapes": [r for r in eval_rows if r["kernel"] == name],
            "tp_shard_shapes": mesh_rows.get(name),
        })
    for name, a in paged_rec.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(paged_attention.SOURCE, root),
            "replaces": TPU_KERNEL[name], "launches": launches[name],
            **a})
    sources = {"mx_quantize": mx_quantize.SOURCE,
               "fake_quant": fake_quant.SOURCE, "ss_convert": ss_convert.SOURCE}
    timed_as = {"mx_quantize": "f32 -> mxint8 (anchor export)",
                "fake_quant": "f32 -> bf16 mxint4 with the straight-through "
                              "epilogue (direct-QAT forward)",
                "ss_convert": "mxint8 -> mxint4 (the anchored QAT step's "
                              "conversion; the served mxint4 build runs the "
                              "split-N mode, under ms_by_case)"}
    for name, a in quant_rec.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(sources[name], root),
            "replaces": TPU_KERNEL[name],
            "launches": quant_launches[name],
            "max_abs_err": a["max_abs_err"],
            "ms": a["ms"], "plain_ms": a["plain_ms"],
            "bound_ms": a["bound_ms"],
            "bound_by": "bytes" if a["t_bytes"] >= a["t_ops"]
            else "operations",
            "library_ms": None,     # no single PyTorch call does MX blocks
            "timed_as": f"one qwen3-4b layer's {PROJ_PER_LAYER} projection "
                        f"weights, {timed_as[name]}",
            "ms_by_case": a["by_case"],
        })
    wrappers = set(mx_matmul.launches) | set(paged_attention.launches) \
        | set(_quant_launches())
    if wrappers != {k["name"] for k in kernels}:
        fail(f"kernel record {[k['name'] for k in kernels]} does not cover "
             f"every wrapper {sorted(wrappers)}")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

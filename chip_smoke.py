#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py [--rusa-scale 1e-2] [--lj-scale 1e-3] [--seed 0]

Phases, one JSON line each; any failure raises and the script exits
non-zero without a result line:

  1. env     — versions, the card and the host's MemAvailable; TF32 is
               switched off for matmuls.
  2. build   — nvcc builds the kernel library from this checkout's sources;
               ptxas's registers and spills per instance (the backward's
               softcapped ones, its d = 128 ones and the d = 256 ones of
               every attention kernel listed apart).
  3. host    — the rUSA plans: serving at width 1024, training at 256 in
               both directions.
  4. kernel  — the SpMM kernel against its plain PyTorch version on the
               card: at the serving path's shape (the rUSA graph's first
               streamed segment against its resident H), with bf16 H over
               f32 and over bf16 bricks there, on the training plan's first
               transposed segment and on its 422-slot hub row block alone,
               on socLJ1's first serving segment, on a ragged shape, with a
               zeroed brick in every row block, with dense bricks, f16
               operands and empty row blocks; every case must take the
               "zero_skip" route.
  5. fused   — the fused GCN-layer kernel against its plain version: the
               training plan's first segment at gcn_paper width (F_out 256
               and 64), a ragged shape and empty row blocks, each on the
               "grouped" route.
  6. serve   — the port's `ServingEngine` on the card, two gcn_paper-width
               graphs, two epochs of four requests each, every output held
               against a float64 scipy reference of the request semantics;
               the kernel's launch count must equal the segments streamed.
  7. layer   — `AiresSpGEMM.gcn_layer` at gcn_paper width on rUSA, forward
               and backward of Σ tanh(y), against a float64 autograd
               reference; the fused kernel runs once per forward segment,
               the SpMM once per recompute and transposed segment.
  8. train   — `gcn_train_loop`, gcn_paper (256→256→256→64) on rUSA, three
               AdamW steps; the first step's loss and gradients against
               float64, the loss must fall, SpMM launches must equal the
               segments streamed forward and backward.
               serve, layer and train fail unless every SpMM launch took
               the "zero_skip" route and every fused one "grouped".
  9. schedule — the paper's schedulers in execute mode on rUSA at
               gcn_paper's feature width (H 239,400 x 256 from --seed):
               AIRES (8 x 8 bricks) at a budget of two segments, once
               plain and twice through a segment cache (the second run
               hits every segment), and MaxMemory, UCG and ETC at a
               budget each can run; every output against float64 A.H, the
               SpMM launched once per AIRES segment on "zero_skip", the
               execute metrics equal to a cost interpretation of the same
               plan. Modeled seconds are PAPER_GPU_SYSTEM cost-model
               output, not card times.
 10. epoch   — `gcn_epoch` under AIRES in execute mode, gcn_paper's
               widths (256 -> 256 -> 256 -> 64) on rUSA, forward and
               backward: three streams each way of at least two segments,
               each stream's uploaded bytes equal to its plan's wire
               bytes, SpMM launches equal to the segments streamed, the
               modeled per-layer metrics equal to the scheduler's own.
 11. passes  — (a) one serving engine for both graphs with the plan passes
               (shard placement, transfer coalescing, EDF) and analysis
               on: requests with deadlines, served in `deadline_order`,
               every output within SERVE_TOL of float64; (b) socLJ1 split
               into at least 8 segments with every transfer coalesced:
               merged uploads, one SpMM launch per segment, the output
               against the plain stream's within MAIN_TOL.
               schedule, epoch and passes run with the static plan
               analyzer on and fail on any error-severity finding.
 12. shard   — two `ServingEngine` workers sharing a `CacheDirectory`, each
               over a four-shard cache whose device tier is half of rUSA's
               wire bytes, with the three passes, analysis and a
               `CostCalibrator` each, serve `serve`'s requests for two
               epochs: outputs within SERVE_TOL of float64 and within
               SHARD_REL_TOL of an unsharded engine's, the warm epoch
               uploading nothing, ICI and skipped-demotion bytes above 0,
               each calibrator refitted; the calibrated spec and the
               calibrated vs uncalibrated mean |error_s| per epoch are
               printed, not gated. Then `serve_gcn(workers=2,
               cache_shards=4, calibrate=True, passes=True)` at its
               defaults.
 13. warm    — worker 0's cache checkpointed, a fresh engine warm-started
               from it (every exported brick restored) serving one epoch
               without uploading, within SERVE_TOL; then `evict_graph`
               of rUSA returns its queued requests, leaves no key or
               directory holding under its prefix and frees the device
               bytes it held. The checkpoint is removed at the end.
               shard and warm, like serve, fail unless every SpMM launch
               took "zero_skip" and equals the segments streamed.
 14. tune    — `ServingEngine.autotune(install=True)` for rUSA and socLJ1
               at serve's width and budgets, under the engine's
               `cost_spec()`; each `TunedSchedule.describe()` printed; the
               installed bucket sets and brick bytes equal to the
               autotuner's arithmetic done again on the host from the CSR;
               serve's requests for the epochs, epoch 0 uploading exactly
               the installed plan's wire bytes, outputs within SERVE_TOL
               of float64 and SHARD_REL_TOL of serve's default-schedule
               outputs, relative; the SpMM against its plain version on
               each graph's widest tuned brick (ell_w 49 and 467, row
               blocks with n_tiles below ell_w among them).
 15. update  — on the tuned rUSA engine, `update_graph` with 1,000 inserts
               and 1,000 deletes drawn from --seed in the rows of its last
               segment, then one epoch: uploads equal to the bricks whose
               keys the update made new (the re-tiled ones, plus any reused
               one whose positional key went stale), everything else a
               cache hit, outputs within SERVE_TOL of float64 on the
               updated graph and SHARD_REL_TOL of a fresh engine's.
 16. partition — an SBM graph (`generate_sbm_graph`) of rUSA's 239,400
               rows, 8 blocks, p_in 0.9 and about rUSA's nonzeros, on a
               four-shard ring cache whose device tier holds its wire
               bytes: CRC owners and `partition_graph(a, 8)`'s, two epochs
               each; every epoch's uploaded, hit, promoted and ICI bytes
               equal to a CPU host model (the same engine serving one
               width-1 request through the same layers), the partition
               arm's warm ICI at most the CRC arm's, outputs across arms
               within SHARD_REL_TOL and within SERVE_TOL of float64.
               tune, update and partition, like serve, fail unless every
               SpMM launch took "zero_skip" and equals the segments
               streamed.
 17. continuous — one engine for both of serve's graphs (serve's budget
               rule at plan width 1024, EDF on a `VirtualClock`, no
               calibrator), its cache on an `ElasticMesh` of this card
               (grid [[cuda:0]], sharded over "data": one shard), replays a
               Poisson trace of 32 arrivals from --seed (256 wide, rate 1.5
               and deadlines of 3 per unit, the unit being the costlier
               graph's modeled request) through `ContinuousServer` and
               `replay_continuous` inside `Supervisor.run`, each step's
               wall seconds (after a synchronise) fed to `observe_step`;
               each graph's arrivals cycle through serve's four requests.
               Fails unless every served output is within SERVE_TOL of
               float64, served + expired + rejected = offered, the event
               order and virtual stamps equal a fresh engine's replay of
               the trace, and a burst of serve's 8 requests at t = 0
               through the loop uploads and hits what `run_batch` does on
               a fresh engine, outputs within SHARD_REL_TOL; and, like
               serve, unless every SpMM launch took "zero_skip" and equals
               the segments streamed. Prints `summarize`'s dict, the step
               wall seconds (min, median, max) and the stragglers.
 18. attn    — the flash-attention and GQA flash-decode kernels against
               their plain versions: flash at Yi-6B's prefill shape (causal),
               with a window of 512, at a ragged S and in f32; decode at
               decode_32k's shape with per-sequence lengths (1 and S among
               them), in f32, with a group of 1 (MHA) and a ragged cache.
               The 16-bit (tensor-core) kernels also at the edges of their
               64-row tiles: flash at S = 63, 64, 65, 129, with a window
               whose edge crosses tiles, and in f16; decode with lens one
               below, at and one above tile and split edges, with groups of
               1, 5 and 16, and in f16. The flash backward kernel against
               its plain version (dQ, dK, dV per element within BWD_TOL,
               the forward kernel's lse within LSE_TOL, two launches bit
               for bit; 16-bit inputs on its tensor-core route, f32 on its
               FMA route, kernels.flash_attn.BWD_ROUTES): at lm_train's
               microbatch (4, 32, 512, 128) bf16 and lm_train_check's
               (2, 32, 128, 128) f32, with a window of 512, at S = 63, 64,
               65, 127, 128, 129 across the 32-row tiles of the f32
               kernels and the 64-row tiles of the 16-bit ones, in f16.
               Both forward kernels with an attention softcap: Gemma-2's
               50 at gemma_serve's prefill layer (1, 32, 8192, 128) bf16
               and gemma_check's (1, 32, 4160, 128) f32, both in a window
               of 4096, and 50 and 1 (a cap that bites on every score) in
               bf16, f16 and f32 with windows; decode at gemma_serve's
               cache (16 KV heads of 2) at every position, on rings of
               4096 slots with lens below the cache, in all three types.
               The d = 256 instances (RecurrentGemma's head dim) in bf16,
               f16 and f32: flash at rgemma_serve's prefill layer and
               rgemma_check's, at S = 63, 64, 65, 129, with a window whose
               edge crosses tiles and at d = 200 (padded); decode at
               rgemma_serve's cache at every position and with lens at and
               around tile and split edges, groups 1 and 10. The
               backward's d = 256 instances at rgemma_train's layer (1, 10,
               4096, 256) bf16 and rgemma_train_check's f32, both in the
               window of 2048, at S across both routes' tiles, in a window
               of 100, without the causal mask, with a prefix and at d =
               200, in bf16, f16 and f32. Both flash directions with the
               bidirectional prefix P (Qwen2-VL's 256 vision positions):
               the forward at qwen_serve's prefill layer (1, 64, 4096, 128)
               bf16, both at qwen_check's (2, 64, 512, 128) f32, then P =
               1, 8, 63, 64, 65, 256 and P = S in all three types, with a
               window and with the softcap. Both flash directions with a
               key length of their own (`cross_cases`): non-causal at
               every pair of Sq in 1, 31, 65, 512 and Sk in 17, 64, 1000,
               1024 in bf16 at d = 64 and 128 (a diagonal of those pairs
               in f16 and f32), one d = 256 pair, causal with off = Sk -
               Sq > 0 with and without a window in all three types, the
               shapes seamless_check, seamless_serve and seamless_train
               give them, the refusals (causal with Sk < Sq, a prefix with
               Sq != Sk) before any launch, and the decode kernel over
               SeamlessM4T's 1024 frames (its cross step) in f32 and bf16.
               The two kernels of the decode over a slice of the head dim
               (`decode_hd_cases`): decode_scores within HD_SCORES_TOL and
               decode_softmax_v (on the plain scores) within ATTN_TOL, at
               hints_check's caches, at the production slices HD_YI_SLICE
               and HD_MIXTRAL_SLICE (d' = 8 of 128) with per-sequence lens,
               in f32 with lens 0 and 1, with a softcap of 50, at 16
               query heads of d' = 256 in f16 and of d' = 8 in bf16, and
               with lens inside a split and at the edges of the kernels'
               splits and chunks on this card (`hd_edge_lens`).
 19. lm_check — Yi-6B width cut to 4 layers, float32, batch 2 x 128
               tokens: `forward` and a teacher-forced `decode_step` at every
               position against the script's own float64 forward; flash
               launches = 4, decode launches = 4 x 128.
 20. lm_train_check — lm_check's model and batch without remat: the
               gradients of `lm_loss` for every parameter through the
               flash kernel and its backward kernels (f32 FMA routes of
               both) against float64 autograd of the script's own forward,
               within LM_GRAD_REL_TOL per tensor; flash launches = 4,
               backward launches = 4.
 21. lm_train — Yi-6B's CONFIG (bf16, remat, published widths) cut to 4
               layers (full depth's weights, gradients and AdamW moments
               need 73 GB before any activation): `train_loop` with AdamW,
               two microbatches of TokenPipeline(vocab, 512, 4) per step
               and int8 error-feedback compression, 4 steps, the first
               loss within LM_TRAIN_LOSS_TOL of the float64 loss of the
               same batch; then Adafactor for 3 steps with a checkpoint
               at step 2 restored bit for bit. Each microbatch launches
               the flash forward 4 times, its recompute 4 and the backward
               4, every forward and backward on the tensor-core route.
               Prints ms per step (after a synchronise), tokens/s, peak
               allocated bytes, the loss history and one profiled step's
               device time by kind (the backward's kernels dkdv_kernel,
               dq_kernel and delta_kernel under flash_bwd).
 22. lm_serve — full Yi-6B (32 layers, bf16, weights from --seed):
               `serve` of 4 prompts of 128 tokens for 32 steps (decode
               launches = 32 x 160), `forward` on one 4096-token sequence
               (flash launches = 32), and teacher-forced decode logits
               against that forward's over the first 128 positions. Every
               attention launch of lm_serve takes the tensor-core route,
               every one of lm_check the f32 FMA route.
 23. gemma_check — Gemma-2 27B's widths cut to 2 layers (local, then
               global), float32: `forward` on one 4160-token sequence (the
               window of 4096 bites) and teacher-forced `decode_step` over
               it (the local layer's ring of 4096 slots wraps), against the
               script's own float64 forward with the window and both
               softcaps at 32 positions before the wrap and the last 64;
               flash launches = 2, decode launches = 2 x 4160, every one on
               the f32 FMA route with the softcap.
 24. gemma_serve — full Gemma-2 27B (46 layers, bf16, 56.8 GB of weights
               from --seed), as lm_serve: `serve` (decode launches = 46 x
               160), `forward` on one 8192-token sequence (flash launches
               = 46; the window bites in the 23 local layers) and the
               decode-vs-forward cross-check; every launch on the
               tensor-core route with the softcap. lm_serve and
               gemma_serve also profile one more prefill (device busy ms).
 25. gemma_train_check — Gemma-2 27B's widths cut to 2 f32 layers, one
               4160-token sequence, no remat: `lm_loss` gradients through
               the softcapped flash kernel and backward (f32 FMA routes)
               against float64 autograd with the window and both softcaps,
               every layer tensor and the final norm within
               LM_GRAD_REL_TOL (the embedding's and head's checked finite);
               flash launches = 2, backward launches = 2, all softcapped.
 26. gemma_train — Gemma-2 27B's bf16 CONFIG cut to 2 layers, remat on:
               `train_loop` with Adafactor, two microbatches of
               TokenPipeline(256000, 512, 4) a step, int8 EF compression,
               4 steps; the first loss within LM_TRAIN_LOSS_TOL of float64,
               step 0's batch lower after the steps; every forward,
               recompute and backward on the tensor-core route with the
               softcap. Prints ms per step, tokens/s, peak bytes and one
               profiled step by kind.
 27. moe_check — Mixtral 8x22B's widths cut to 2 f32 layers, batch 2 x
               128: `forward` and teacher-forced decode against the
               script's own float64 forward (the reference's capacity,
               drops and combine, routed as each path routes) within
               LM_REL_TOL; flash launches = 2, decode launches = 2 x 128,
               no window; dropped assignments and router picks unlike
               float64's printed.
 28. mixtral_serve — Mixtral 8x22B's bf16 CONFIG cut to 12 of 56 layers
               (60.9 GB of weights), as lm_serve (decode launches = 12 x
               160, flash launches = 12), the decode-vs-forward check under
               MOE_FLIP_RULE.
 29. moe_train_check — Mixtral 8x22B's widths cut to 2 f32 layers, no
               remat, one sequence of 512 tokens: `lm_loss` gradients
               through the flash kernel and the backward (f32 FMA routes)
               against float64 autograd of the script's own forward, routed
               as the port routed (the picks `RouterSpy` saw, so no
               near-tie flips a token's expert) and with the aux term, in
               passes of at most 7 GiB of float64 tensors; every layer
               tensor (attention, norms, w_router, w_gate, w_up, w_down)
               and the final norm within LM_GRAD_REL_TOL, the loss within
               LM_REL_TOL; the picks float64 would make otherwise and the
               dropped assignments printed.
 30. moe_train — Mixtral 8x22B's bf16 CONFIG cut to 1 layer, remat on
               (2.91e9 parameters): `train_loop` with Adafactor, two
               microbatches of TokenPipeline(32768, 512, 4) a step, int8 EF
               compression, 4 steps; the first loss within
               LM_TRAIN_LOSS_TOL of float64 (routed as the port's forward
               routed step 0's batch, the aux term added), step 0's batch
               lower after the steps; every flash forward, recompute and
               backward on the tensor-core route at d = 128, none
               softcapped. Prints ms per step, tokens/s, peak bytes, one
               profiled step by kind, step 0's aux losses and dropped
               assignments per microbatch.
 31. moe_shard_map_check — `models.moe_shard_map` on a one-rank NCCL
               group (a HashStore) under a (1, 1) ("data", "model")
               DeviceMesh: one Mixtral layer's experts at published widths,
               2 x 128 tokens at capacity factor 8; the output, aux and
               gradients (x, router, the three banks) against `moe_ffn`'s
               in f32 within LM_REL_TOL and LM_GRAD_REL_TOL, the bf16
               output within LM_BF16_TOL; the all-to-all bytes and one
               call's time printed.
 32. mesh_check — a child process on the "fake" process-group backend:
               `make_production_mesh` over 256 and 512 ranks, Mixtral's and
               Kimi K2's full-size stacked meta params through
               `tree_pspecs` and `tree_placements`, every leaf
               `distribute_tensor`ed with the local shape its spec implies.
 32b. hints_check — the sharding hints on a one-rank NCCL group under a
               (1, 1) DeviceMesh: bf16 Yi-6B at full width cut to 2 layers,
               DTensor params from `tree_placements`, `forward` and
               `lm_loss` with MESH_AXES_SINGLE against the plain calls (bit
               for bit, else within LM_BF16_TOL and the reason printed), 2
               flash launches each through the operator; one bf16 Mixtral
               layer's `moe_ffn` with its two hints within LM_BF16_TOL;
               then that Yi-6B's `decode_step`, 8 teacher-forced steps on
               DTensor caches placed by `state_pspecs` (each rank writes
               and reads its own shard), every step's logits and the
               caches bit for bit against the plain step's, 2 decode
               launches a step through the operator; then the same steps
               with the caches' head dim placed over "model" (as
               `state_pspecs` places it where the KV heads do not divide
               over that axis): 2 launches a step of decode_scores and of
               decode_softmax_v with the scores' all-reduce between them,
               none of the decode kernel, the logits within LM_BF16_TOL of
               the plain step's.
 32c. dryrun_check — `launch.dryrun.run_cell` for Yi-6B train_4k,
               xLSTM-125M prefill_32k (the sLSTM's loop one operator) and
               decode_32k (each rank updating its shard of the mLSTM
               state), Qwen2-VL-72B prefill_32k (M-RoPE, the vision
               prefix; FSDP, each layer read from its shards) on the
               single-pod mesh and Mixtral decode_32k on the two-pod mesh
               (its 8 KV heads do not divide over 16: decode_scores and
               decode_softmax_v traced on each rank's head-dim slice),
               each in a child process on the "fake" backend, all started
               after gemma_train at nice 10 and collected before timing,
               the fake tensors on "cuda": ok, the per-device argument
               bytes the local-shard sum of the cell's specs, Mixtral's
               collective bytes below its local caches' (printed beside
               DRYRUN_MOVED_CACHE_BYTES, the figure when the cache write
               moved them), Qwen2-VL's all-gather bytes within
               DRYRUN_GATHER_WEIGHTS times its params' bytes over "model"
               plus its layers' K and V (gathered over "model": 8 KV
               heads over 16) and xLSTM decode's collectives below its argument bytes
               (each beside DRYRUN_BEFORE, the figure before those
               repairs); params, per-device argument, temp and output
               bytes, FLOPs, collective bytes by kind, trace seconds and
               the phase's beside DRYRUN_TARGET_S printed (planning
               numbers, not measurements).
 33. rgemma_check — RecurrentGemma-2B's widths cut to 2 float32 layers
               (an RG-LRU, then a local attention layer at head dim 256):
               `forward` on one 2112-token sequence (the window of 2048
               bites) and teacher-forced `decode_step` over it (the ring of
               2048 slots wraps), against the script's own float64 forward
               (the recurrences stepped over time) at 32 positions before
               the wrap and the last 64, within LM_REL_TOL; flash launches
               = 1, decode launches = 2112, every one on the f32 FMA route
               at d = 256.
 34. xlstm_check — xLSTM-125M's widths cut to 2 float32 layers (an sLSTM,
               then an mLSTM), batch 2 x 128: `forward` and teacher-forced
               decode against the script's own float64 forward (both
               blocks stepped over time) within LM_REL_TOL; no attention
               launch at all.
 35. rgemma_serve — full RecurrentGemma-2B (26 layers, bf16, 7.1 GB of
               weights from --seed), as lm_serve: `serve` (decode launches =
               8 x 160: its 8 local layers), `forward` on one 4096-token
               sequence (flash launches = 8; the window bites) and the
               decode-vs-forward check; every launch on the tensor-core
               route at d = 256.
 36. xlstm_serve — full xLSTM-125M (12 layers, bf16), as lm_serve with a
               2048-token prefill; no attention launch.
 37. rgemma_train_check — rgemma_check's model (an RG-LRU, then a local
               layer at d = 256, float32) on one 2112-token sequence, no
               remat: `lm_loss` gradients through the flash kernel and the
               backward's d = 256 instance (f32 FMA routes), the RG-LRU
               scan and the conv differentiated as plain PyTorch, against
               float64 autograd of the script's own forward, every layer
               tensor and the final norm within LM_GRAD_REL_TOL (the
               embedding's and head's checked finite); one flash and one
               backward launch, both at d = 256.
 38. rgemma_train — RecurrentGemma-2B's bf16 CONFIG at full width and
               depth (26 layers, 8 local, remat on): `train_loop` with
               Adafactor, two microbatches of TokenPipeline(256000, 4096,
               1) a step (the window of 2048 bites in the backward), int8
               EF compression, 4 steps; the first loss within
               LM_TRAIN_LOSS_TOL of float64, step 0's batch lower after the
               steps; every forward, recompute and backward on the
               tensor-core route at d = 256, 16 backward launches a step.
               Prints ms per step, tokens/s, peak bytes and one profiled
               step by kind.
 39. qwen_check — Qwen2-VL-72B's widths cut to 2 float32 layers, batch 2 x
               512 with 256 vision embeddings from --seed: `forward` with
               them against the script's own float64 forward (M-RoPE, the
               vision block's bidirectional mask), teacher-forced
               `decode_step` against the float64 forward without M-RoPE and
               the prefix (the reference's decode semantics, R6), both
               within LM_REL_TOL, and `lm_loss` gradients (`vision_proj`
               among them) within LM_GRAD_REL_TOL; every flash launch,
               forward and backward, with the prefix of 256 on the f32 FMA
               route.
 40. qwen_serve — Qwen2-VL-72B's bf16 CONFIG cut to 32 of 80 layers (61.3
               GB of weights), as lm_serve: `serve` (decode launches = 32 x
               160), `forward` on one 4096-token sequence with 256 vision
               embeddings (flash launches = 32, every one with the prefix
               of 256 on the tensor-core route), and decode against a
               forward without M-RoPE and the prefix (QWEN_DECODE_RULE).
 41. seamless_check — SeamlessM4T-medium's widths (the full vocabulary of
               256,206) cut to 2 encoder and 2 decoder layers, float32,
               batch 2 x 512 over 1024 frames from --seed: `encode`,
               `forward` and teacher-forced `decode_step(enc_out=)`
               against the script's own float64 encoder-decoder within
               LM_REL_TOL (the decode also against its own forward), and
               `lm_loss` gradients (`xattn`, `enc_layers` and `audio_proj`
               among them) within LM_GRAD_REL_TOL; every launch on the f32
               FMA route, the encoder's and the cross-attention's flash
               launches non-causal, the cross ones at Sq != Sk.
 42. seamless_serve — full SeamlessM4T-medium (12 + 12 layers, bf16, 1.96
               GB of weights from --seed): `serve` (the reference's f32
               zero frames encoded once, 12 flash launches on the f32
               route; per step 12 self-attention decode launches on the
               tensor-core route and 12 cross-attention ones on the f32
               route), a 4096-token `forward` with bf16 frames from --seed
               (36 flash launches, 12 of them cross at Sq = 4096, Sk =
               1024), and a teacher-forced decode held to that prefill
               within LM_BF16_TOL.
 43. seamless_train — SeamlessM4T-medium's bf16 CONFIG at full width and
               depth, remat on: `train_loop` with Adafactor, two
               microbatches of TokenPipeline(256206, 512, 4) a step, each
               with (4, 1024, 1024) bf16 frames from --seed, int8 EF, 4
               steps; the first loss within LM_TRAIN_LOSS_TOL of float64,
               step 0's batch lower after the steps; every flash forward,
               recompute and backward on the tensor-core route, the
               encoder's and cross-attention's non-causal.
 44. stacked_check — `models.stacked` in float32 at full width:
               seamless_check's model and RecurrentGemma-2B cut to 4
               layers (its unit of 3 once, one remainder layer):
               `forward_scan` and teacher-forced `decode_step_scan`
               against `forward` and `decode_step` on the same weights
               within the reference test's atol 2e-4 and rtol 1e-4,
               bit-for-bit equality printed.
 45. experts — one Kimi K2 layer's expert bank (384 experts, 33.8 GB of
               bf16 in pinned host memory, drawn on the card from --seed)
               streamed through `StreamedWeightProvider(2 GiB, align 8,
               depth 2)`: 16 blocks of 24 experts, each block's range and
               shapes, sampled rows bit for bit against the host bank, the
               uploaded bytes the bank's; prints the StreamStats and GB/s.
 46. timing  — each kernel, its plain version and a PyTorch yardstick the
               port never calls, at the main paths' shapes, with the bound
               (decode_scores and decode_softmax_v at HD_YI_SLICE,
               HD_MIXTRAL_SLICE and hints_check's shape, bf16, each with
               the route it took, no yardstick);
               the GCN kernels' bound counted on the bricks' nonzeros and,
               beside it, on every brick entry, and the fused layer's also
               with X·W at the rate of its three TF32 products; the SpMM
               also on socLJ1's first serving segment and at the tuned
               widths; decode also at lm_serve's own shape; the flash
               backward (tensor-core route) at lm_train's microbatch and
               at Yi-6B's prefill, beside SDPA's forward + backward less
               its forward, with the function's bound (10·d FLOPs a valid
               pair) and, beside it, the bound at the 20·d its split MMAs
               do (bound_ms_split_mma); the softcapped flash at
               gemma_serve's prefill layer beside the same call without
               the softcap (no PyTorch call softcaps attention: library_ms
               null), the decode at gemma_serve's cache with and without
               the softcap, and the backward's CAP instances at
               gemma_train's microbatch beside the same call without; the
               d = 256 instances at rgemma_serve's prefill layer (1, 10,
               4096, 256) bf16, window 2048, beside SDPA with that window as
               a mask and causal SDPA without it, and the decode at its
               cache (4, 1, 10, 256) over a ring of 2048 and at (128, 1, 10,
               256) over 2048, beside SDPA with enable_gqa; and the
               recurrent blocks, plain PyTorch, at the serve phases'
               widths (each `*_train` at its prefill length, each `*_step`
               at serve's batch); the backward's d = 256 instance at
               rgemma_train's layer (1, 10, 4096, 256) bf16, window 2048,
               beside SDPA with the window as a mask and causal SDPA
               without it; both directions with the prefix of 256 at
               qwen_serve's prefill layer (1, 64, 4096, 128) bf16, beside
               the same calls without it and SDPA with the prefix as a
               mask; both flash directions non-causal at SeamlessM4T's
               shapes (the cross-attention forward (4, 16, 4096, 64) and
               backward (4, 16, 512, 64) over 1024 frames, the encoder
               (4, 16, 1024, 64) both ways) beside SDPA without a mask, and
               the decode kernel's cross step (4, 16, 1, 64) over 1024.
 47. phase_seconds, kernels — each phase's seconds; the summary line
               (softcapped, d = 256, prefixed, cross (Sq != Sk) and
               non-causal launches by path among it, the backward's by
               route, softcap, d = 256 and prefix; decode_scores and
               decode_softmax_v from hints_check), then the card's name
               and power limit, then the result line.

Each main path (serve, layer, train, schedule, epoch, passes, shard,
warm, tune, update, partition, continuous, lm_check, lm_train_check, each
run of lm_train, lm_serve, gemma_check, gemma_serve, gemma_train_check,
gemma_train, moe_check, mixtral_serve, moe_train_check, moe_train,
rgemma_check, xlstm_check,
rgemma_serve, xlstm_serve, rgemma_train_check, rgemma_train, qwen_check,
qwen_serve, seamless_check, seamless_serve, seamless_train, stacked_check,
hints_check) runs with the launch counters set
to 0 just before it and read just after. It needs no network and one card, and
exits non-zero when no card is visible or when the package is not beside
it.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3, NVIDIA data sheet
PEAK_F32_FLOPS = 67e12         # H100 SXM f32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12       # H100 SXM bf16 tensor cores, dense
PEAK_TF32_FLOPS = 495e12       # H100 SXM TF32 tensor cores, dense
MAIN_TOL = 1e-4                # f32, sums in another order
F16_TOL = 1e-2
# bf16 bricks and H against the plain version at the serving shape: every
# bf16 value converts to f32 exactly and both sides sum f32 products, so
# they differ only in the order of the sums, as f32 operands do.
BF16_TOL = 1e-4
SERVE_TOL = 1e-3               # f32 engine vs float64 after three layers
SHARDS = 4                     # cache shards per worker in shard and warm
# Sharded vs unsharded outputs, relative to scale: the same kernel on the
# same bricks, sums reordered only by the long row blocks' f32 atomics.
SHARD_REL_TOL = 1e-6
# f32 training path vs float64, as max |Δ| over the reference's largest
# magnitude: dW and db sum up to 239,400 row terms, whose rounding error
# grows like sqrt(n)·2^-24 ≈ 3e-5 of that scale. The float64 reference
# takes its relu masks from the card's forward: an f32 pre-activation
# within rounding of 0 may fall on the other side of the kink, which
# changes that row's gradient by O(1) at any precision.
REL_TOL = 1e-4
TRAIN_STEPS = 3
TRAIN_LR = 1e-3
# Attention kernels against their plain versions, per element:
# |kernel - plain| <= rtol·|plain| + atol. Both sides compute in f32 and sum
# in other orders (a gap near 1e-6 at the shapes here: the H100 measured at
# most 1.07e-6 in f32), then round once to the output type. Two f32 values
# that close round to the same value or to neighbours, one ulp apart, and an
# ulp is at most 2^-7·|x| in bf16 and 2^-10·|x| in f16; atol takes the f32
# gap. A typical |out| is 0.01 to 0.1 at these lengths, so atol lies three
# orders below it.
ATTN_TOL = {"float32": (0.0, 4e-6), "float16": (2.0 ** -10, 4e-6),
            "bfloat16": (2.0 ** -7, 4e-6)}
# The 4-layer float32 Yi-6B-width model against float64, as max |Δ| over
# the largest |logit|: sums of up to 11,008 f32 terms per layer, and RoPE
# angles of up to 127 rad taken in f32 (an error near 1e-5 rad). The same
# limit holds gemma_check, whose angles reach 4159 rad (an f32 ulp there
# is 4.9e-4 rad): the H100 measured 6.1e-5 there, 3.7e-6 for Yi-6B.
LM_REL_TOL = 1e-4
# Full-depth bf16 Yi-6B: teacher-forced decode against the prefill forward,
# as max |Δ| over the largest |logit|. The two paths round in other places
# (matmuls of 1 row against 4096 rows, the two attention kernels' sums), 32
# layers deep; the first run on the H100 measured 0.0211, with the argmax
# agreeing at 96% of positions. The limit leaves room for other seeds.
LM_BF16_TOL = 0.05
# The backward kernel against its plain version, per element:
# |kernel - plain| <= rtol·|plain| + atol·M, M the largest |plain| over dQ,
# dK and dV. Both sum f32 products in other orders; dK and dQ sum up to S
# terms of dS = P (dO·v - D), whose two parts cancel, so the gap scales
# with the size of the terms, which M measures (atol, relative to it),
# then each rounds once to the output type, one ulp apart at most (rtol,
# as in ATTN_TOL). The forward kernel's lse against the plain forward's
# within LSE_TOL: f32 sums in other orders of values of order log S.
BWD_TOL = {"float32": (0.0, 2e-5), "float16": (2.0 ** -10, 2e-5),
           "bfloat16": (2.0 ** -7, 2e-5)}
LSE_TOL = 1e-5
# lm_loss gradients of the 4-layer float32 Yi-6B-width model against
# float64 autograd, as max |Δ| over the largest |g| per tensor: the
# backward's products sum as many f32 terms as the forward's (up to 11,008
# per layer, 256 token rows per weight gradient, 64,000 logits in the
# softmax), and the attention backward recomputes P from the forward's f32
# lse; as for the logits (LM_REL_TOL), an order above the sqrt(n)·2^-24
# rounding of such sums.
LM_GRAD_REL_TOL = 1e-4
# lm_train's first loss (bf16 weights and activations) against the float64
# forward of the same bf16 weights on the same batch: bf16 rounds every
# matmul output to 2^-8 of its size, so each logit of order 1 moves by
# about 0.004 at random; the loss (near ln 64000 = 11.07) averages the
# gold logits' errors over 4,096 tokens. 0.02 is five such roundings.
LM_TRAIN_LOSS_TOL = 0.02
LM_TRAIN_SEQ = 512             # lm_train: TokenPipeline(vocab, 512, 4)
LM_TRAIN_BATCH = 4
LM_TRAIN_STEPS = 4
PROFILED_STEPS = 4
LM_PROMPT = 128
LM_STEPS = 32
LM_BATCH = 4
LM_PREFILL = 4096
# gemma_check: one sequence past the local layers' window (4096), into
# caches of as many positions (rings of 4096 slots, which wrap after
# position 4095); compared at 32 positions before the wrap and the last 64.
GEMMA_CHECK_SEQ = 4160
GEMMA_POSITIONS = list(range(0, 4096, 128)) + list(range(4096, 4160))
GEMMA_PREFILL = 8192           # gemma_serve: the window bites in 23 layers
GEMMA_TRAIN_STEPS = 4          # gemma_train: Adafactor steps of 2 x (4, 512)
# mixtral_serve: 12 of Mixtral 8x22B's 56 layers, 30,451,390,464
# parameters (60.9 GB in bf16); 56 layers need 282 GB, and 13 leave too
# little room for the 4096-token prefill.
MIXTRAL_SERVE_LAYERS = 12
EXPERTS_BUDGET = 2 << 30       # experts: 2 GiB blocks, 24 Kimi K2 experts
# moe_train_check: Mixtral's widths at 2 f32 layers hold 5.4e9 parameters,
# 21.6 GB, and as much again in gradients; the float64 side takes its
# gradients in passes of at most 7 GiB of float64 tensors (an expert bank
# of w_gate, w_up or w_down is 6.4 GB).
MOE_TRAIN_CHECK_LAYERS = 2
MOE_F64_GROUP_BYTES = 7 << 30
# moe_train: Mixtral's bf16 CONFIG cut to 1 layer, 2.91e9 parameters;
# train_loop holds about 20 bytes a parameter (bf16 weights, the f32
# accumulator, the old and new f32 error feedback, its int8 copy).
MOE_TRAIN_LAYERS = 1
MOE_TRAIN_STEPS = 4
# moe_shard_map_check: 2 x 128 tokens through one Mixtral layer's experts
# on a one-rank mesh, at the reference test's capacity factor (nothing
# drops, so moe_ffn computes the same function).
SHARD_MAP_TOKENS = (2, 128)
SHARD_MAP_CAPACITY = 8.0
MESH_WORLDS = (256, 512)       # mesh_check: both production meshes
# hints_check: bf16 Yi-6B cut to 2 layers, 2 x 512 tokens, and one bf16
# Mixtral layer over 2 x 256 tokens, on a one-rank (1, 1) mesh; then that
# Yi-6B's decode, HINTS_DECODE_STEPS teacher-forced steps into caches of
# HINTS_DECODE_LEN positions placed by `state_pspecs`.
HINTS_LAYERS = 2
HINTS_TOKENS = (2, 512)
HINTS_MOE_TOKENS = (2, 256)
HINTS_DECODE_STEPS = 8
HINTS_DECODE_LEN = 64
# The decode over a slice of the head dim (decode_scores, decode_softmax_v)
# at the per-rank shapes of the production decode cells whose KV heads do
# not divide over "model" (16), each rank holding 8 of the 128 head dims:
# (b, n_kv, group, S, d') for Yi-6B decode_32k on the single-pod mesh (128
# sequences over "data" 16) and Mixtral 8x22B decode_32k on the two-pod
# mesh (over "pod" x "data" 32).
HD_YI_SLICE = (8, 4, 8, 32768, 8)
HD_MIXTRAL_SLICE = (4, 8, 6, 32768, 8)
# decode_scores against its plain version, per element: f32 sums of d'
# products in another order, |s| about sqrt(d') for unit inputs: an f32
# gap of a few ulps of the products' sum.
HD_SCORES_TOL = (1e-5, 1e-4)
# dryrun_check: a dense train cell, an MoE decode cell on the two-pod
# mesh and the prefill cells of the recurrent xLSTM-125M and of
# Qwen2-VL-72B (M-RoPE and the vision prefix), each in a child process of
# its own, all at once. Mixtral, not Kimi K2 (61 layers), is the MoE arch
# with fewer layers to trace. The phase's target is DRYRUN_TARGET_S; a
# child is stopped at DRYRUN_TIMEOUT_S.
DRYRUN_CELLS = (("yi_6b", "train_4k", False),
                ("mixtral_8x22b", "decode_32k", True),
                ("xlstm_125m", "prefill_32k", False),
                ("qwen2_vl_72b", "prefill_32k", False),
                ("xlstm_125m", "decode_32k", False))
# Two cells' figures before the stacked layers were read from their shards
# (Qwen2-VL-72B prefill_32k's all-gather bytes a device, FSDP gathering
# every stacked weight whole for each layer) and before the mLSTM's decode
# step updated its state on each rank's shard (xLSTM-125M decode_32k's
# collective bytes, the state gathered each step): printed beside the
# cells' own ("NVIDIA H100 80GB HBM3, 700.00 W", torch 2.11). Qwen2-VL's
# all-gather must now stay within twice its params' bytes a device over
# "model" (DRYRUN_GATHER_WEIGHTS) plus its K and V projections, which every
# layer gathers over "model" because its 8 KV heads do not divide over 16
# (`ops.fit_groups`; the same gather is all that the two-pod cell, which
# never gathered a stack, does); xLSTM's collectives below its argument
# bytes.
DRYRUN_BEFORE = {"qwen2_vl_72b__prefill_32k__single": {
                     "all_gather_bytes": 724.44e9},
                 "xlstm_125m__decode_32k__single": {
                     "collective_bytes": 1.373e9}}
DRYRUN_GATHER_WEIGHTS = 2.0
# Mixtral decode_32k's collective bytes a device when the decode step's
# cache write moved the caches between layouts (61.65 GB, 60.17 GB of it
# all-to-all, on "NVIDIA H100 80GB HBM3, 700.00 W", torch 2.11): printed
# beside the cell's. The cell must now move less than its local caches.
DRYRUN_MOVED_CACHE_BYTES = 61.65e9
DRYRUN_TARGET_S = 180.0
DRYRUN_TIMEOUT_S = 600.0
# mixtral_serve's decode-vs-forward rule. The prefill routes each layer's
# 4096 tokens through one (4096, 6144) x (6144, 8) bf16 router product and
# the decode step one token through a (1, 6144) one, and their inputs
# differ by the two paths' bf16 roundings; a token whose second and third
# expert lie within that may take another expert in the two paths, and
# then its FFN output is another function, not a rounding of the same one.
# The limit stays LM_BF16_TOL, as lm_serve and gemma_serve hold every
# position. It was first applied to every position whose experts agree in
# all layers; the first run at this width refuted that set (66 of 128
# positions routed differently, the other 62 at 0.068): a later position
# attends to the keys and values of the earlier ones, which another expert
# changed. So it holds the positions before the first one whose experts
# differ in any layer, which no such change reaches (causal attention);
# the positions with other experts, and the gap over all, are reported,
# and every logit must be finite.
MOE_FLIP_RULE = ("positions before the first with other experts in any "
                 "layer: rel gap <= LM_BF16_TOL; the others: counted and "
                 "reported")
# xlstm_serve's decode-vs-forward rule. xLSTM-125M in bf16 with random
# weights amplifies a rounding in its recurrent state through the sLSTM's
# exponential gates and 12 layers without a feed-forward: the reference
# itself, on the CPU at this config (scripts/recurrent_bf16_gap.py, its own
# weights from seed 0), decodes 0.585 (relative to the largest |logit|)
# away from its own bf16 forward over 128 positions, and its bf16 forward
# lies 0.647 away from its f32 forward; only position 0, where no state
# has been carried, stays near one rounding (0.014; the port's 0.012). The limit stays LM_BF16_TOL, held at position 0;
# the other positions' gaps are reported. That decode equals the forward
# past position 0 is held in float32 by xlstm_check, to float64.
XLSTM_BF16_RULE = ("position 0 (no recurrent state yet): rel gap <= "
                   "LM_BF16_TOL; the later positions: reported, the "
                   "reference's own bf16 gap being O(1) there")
# rgemma_check: one sequence past the local layer's window (2048), into a
# cache of as many positions (a ring of 2048 slots, which wraps after
# position 2047); compared at 32 positions before the wrap and the last 64.
RGEMMA_CHECK_SEQ = 2112
RGEMMA_POSITIONS = list(range(0, 2048, 64)) + list(range(2048, 2112))
RGEMMA_PREFILL = 4096          # rgemma_serve: the window bites in 8 layers
RGEMMA_TRAIN_SEQ = 4096        # rgemma_train: TokenPipeline(vocab, 4096, 1)
RGEMMA_TRAIN_STEPS = 4
RGEMMA_TRAIN_LAYERS = 0        # 0: the full 26; 12 if the peak passes 76 GB
QWEN_VISION_TOKENS = 256       # Qwen2-VL's n_vision_tokens: the prefix P
QWEN_CHECK_SEQ = 512           # qwen_check: batch 2 x 512
# qwen_serve: 32 of Qwen2-VL-72B's 80 layers, 30.6e9 parameters (61.3 GB
# in bf16); 80 layers need 145 GB.
QWEN_SERVE_LAYERS = 32
# qwen_serve's decode-vs-forward rule. The reference decodes Qwen2-VL with
# plain RoPE at the index and a causal cache mask (ROADMAP.md queue 3, R6),
# while its forward rotates by M-RoPE and lets the 256 vision positions
# attend to each other both ways, so decode and the M-RoPE forward are two
# functions at every position, 0 included. The decode is held to a
# `forward` of the same weights under replace(cfg, mrope_sections=None,
# n_vision_tokens=0), which computes the decode's semantics, within
# LM_BF16_TOL as lm_serve's; the M-RoPE forward is checked finite and
# reported.
QWEN_DECODE_RULE = ("decode vs forward(replace(cfg, mrope_sections=None, "
                    "n_vision_tokens=0)) on the same tokens: rel gap <= "
                    "LM_BF16_TOL (R6: the reference's decode has no M-RoPE "
                    "and no vision prefix)")
XLSTM_PREFILL = 2048           # xlstm_serve: 3 sLSTM loops of 2048 steps
# SeamlessM4T-medium: 1024 audio frames, 16 heads of 64 (MHA).
SEAMLESS_FRAMES = 1024
SEAMLESS_HEADS = 16
SEAMLESS_HD = 64
SEAMLESS_CHECK_SEQ = 512       # seamless_check: batch 2 x 512, 2 + 2 layers
SEAMLESS_CHECK_LAYERS = 2      # encoder and decoder layers of the checks
SEAMLESS_PREFILL = 4096        # seamless_serve: the decoder's prefill
SEAMLESS_TRAIN_STEPS = 4       # seamless_train: Adafactor steps
STACKED_SEQ = 128              # stacked_check: batch 2 x 128 tokens
STACKED_STEPS = 16             # ... and teacher-forced decode steps
STACKED_ATOL, STACKED_RTOL = 2e-4, 1e-4   # tests/test_stacked_scan.py's
ATTENTION_KINDS = ("attn", "local", "moe")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def ptxas_table(report: str) -> list:
    """One line per compiled kernel from nvcc's -Xptxas -v report: its name
    (demangled where the CUDA toolkit's cu++filt is found) and what ptxas
    said of its registers, stack and spills."""
    import re
    import shutil
    from torch.utils.cpp_extension import CUDA_HOME
    names, props = [], []
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            names.append(m.group(1))
            props.append([])
        elif names and ("Used" in ln or "spill" in ln):
            props[-1].append(ln.split(":", 1)[-1].strip())
    cufilt = shutil.which("cu++filt") or os.path.join(CUDA_HOME or "", "bin",
                                                      "cu++filt")
    def literal(m):               # template arguments as cu++filt casts them
        return (("false", "true")[int(m.group(2))] if m.group(1) == "bool"
                else m.group(2))

    if names and os.path.exists(cufilt):
        out = subprocess.run([cufilt], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            names = [re.sub(r"\((bool|int)\)(-?\d+)", literal,
                            n.replace("(anonymous namespace)::", "")
                            .replace("<unnamed>::", "")).split("(")[0]
                     for n in out.stdout.splitlines()]
    return [f"{n}: {'; '.join(p)}" for n, p in zip(names, props)]


def sync() -> None:
    import torch
    if DEV == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, repeats: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def paper_graph(name: str, scale: float, seed: int):
    from repro_torch.data import (
        SUITESPARSE_SPECS, generate_graph, normalized_adjacency, scaled_spec,
    )
    return normalized_adjacency(generate_graph(
        scaled_spec(SUITESPARSE_SPECS[name], scale), seed=seed))


def serve_budget(a, width: int) -> int:
    """launch/serve.py's budget rule at the engine's plan width."""
    from repro_torch.core import plan_memory_dense_features
    est = plan_memory_dense_features(a, a.n_rows, width, float("inf"))
    return int(est.m_b + est.m_c + 0.6 * a.nbytes())


def brick_tensors(ell):
    import numpy as np
    import torch
    return [torch.from_numpy(np.ascontiguousarray(x)).to(DEV)
            for x in (ell.blocks, ell.col_tile, ell.n_tiles)]


def zero_gcn_counts(kmod) -> None:
    """The Block-ELL kernels' launch counts, in all and by route, to 0."""
    kmod.LAUNCHES = kmod.FUSED_LAUNCHES = 0
    for routes in (kmod.SPMM_ROUTE_LAUNCHES, kmod.FUSED_ROUTE_LAUNCHES):
        for route in routes:
            routes[route] = 0


# Launches by route of each GCN main path, as check_gcn_routes read them.
GCN_ROUTES = {}


def check_gcn_routes(label: str, kmod, spmm: int, fused: int = 0) -> dict:
    """Every SpMM and fused launch counted since zero_gcn_counts took the
    zero-skipping route; returns the launches by route and keeps them in
    GCN_ROUTES[label]."""
    routes = {"bcsr_spmm": dict(kmod.SPMM_ROUTE_LAUNCHES),
              "fused_gcn_layer": dict(kmod.FUSED_ROUTE_LAUNCHES)}
    if (routes["bcsr_spmm"]["zero_skip"], routes["fused_gcn_layer"][
            "grouped"]) != (spmm, fused) or (
            sum(routes["bcsr_spmm"].values()),
            sum(routes["fused_gcn_layer"].values())) != (spmm, fused):
        raise AssertionError(f"{label}: launches by route {routes}, want "
                             f"{spmm} SpMM on zero_skip and {fused} fused "
                             "on grouped")
    GCN_ROUTES[label] = routes
    return routes


def launch_route(routes: dict, fn):
    """Calls `fn` once; returns its output and the one route whose launch
    count (in `routes`, a kernel module's counters) it raised."""
    before = dict(routes)
    out = fn()
    taken = [r for r in routes if routes[r] != before[r]]
    if len(taken) != 1:
        raise AssertionError(f"one launch raised the counts of {taken}")
    return out, taken[0]


def spmm_case(kmod, ell, h, tol, label, relative=False, blocks=None):
    """The SpMM kernel against its plain version on one segment's bricks
    (`blocks` replaces the bricks' values); fails unless they agree within
    `tol` (times max |plain| when `relative`) and the launch took the
    "zero_skip" route."""
    args = brick_tensors(ell)
    if blocks is not None:
        args[0] = blocks
    out, route = launch_route(kmod.SPMM_ROUTE_LAUNCHES, lambda: (
        kmod.bcsr_spmm_cuda(*args, h, bm=ell.bm, bk=ell.bk)))
    plain = kmod.bcsr_spmm_plain(*args, h, bm=ell.bm, bk=ell.bk)
    sync()
    err = float((out - plain).abs().max())
    scale = float(plain.abs().max())
    limit = tol * scale if relative else tol
    if not err <= limit:
        raise AssertionError(f"{label}: max |kernel - plain| {err} > "
                             f"{limit}")
    if route != "zero_skip":
        raise AssertionError(f"{label}: took route {route}")
    return {"case": label, "blocks": list(args[0].shape),
            "blocks_dtype": str(args[0].dtype).split(".")[-1],
            "h": list(h.shape), "h_dtype": str(h.dtype).split(".")[-1],
            "route": route, "max_abs_err": err, "max_abs_plain": scale,
            "tol": f"{tol} x max |plain|" if relative else tol}


def phase_kernel(kmod, main_ell, h_main, bwd_ell, g_bwd, lj_ell, h_lj):
    """Kernel vs plain version on the card; returns the largest error at
    the main paths' shapes. Every case has 8 x 8 bricks and must take the
    "zero_skip" route."""
    import functools
    import types

    import numpy as np
    import torch
    from repro_torch.sparse import csr_from_dense, tile_csr_to_block_ell

    compare = functools.partial(spmm_case, kmod)
    rng = np.random.default_rng(1)
    cases = [compare(main_ell, h_main, MAIN_TOL, "main-path rUSA segment 0"),
             # Aᵀ's hub row blocks sum up to 422 bricks (3,376 terms) per
             # output: f32 rounding, held to the output's scale.
             compare(bwd_ell, g_bwd, REL_TOL,
                     "training plan's transposed rUSA segment 0, F=256",
                     relative=True),
             # 107 of its 208 row blocks pass the first kernel's 64 slots
             # and sum up to 512 bricks per output: held to its scale.
             compare(lj_ell, h_lj, REL_TOL,
                     "serving's socLJ1 segment 0, F=1024", relative=True)]
    h_bf16 = h_main.bfloat16()
    cases.append(compare(main_ell, h_bf16, BF16_TOL,
                         "serving shape, f32 bricks, bf16 H"))
    cases.append(compare(main_ell, h_bf16, BF16_TOL,
                         "serving shape, bf16 bricks and H",
                         blocks=brick_tensors(main_ell)[0].bfloat16()))
    # The hub: Aᵀ's row block with the most slots, alone, at its ell_w, so
    # its tail runs through the second zero-skip kernel.
    hub = int(np.argmax(bwd_ell.n_tiles))
    hub_ell = types.SimpleNamespace(
        bm=bwd_ell.bm, bk=bwd_ell.bk,
        blocks=bwd_ell.blocks[hub:hub + 1], col_tile=bwd_ell.col_tile[
            hub:hub + 1], n_tiles=bwd_ell.n_tiles[hub:hub + 1])
    case = compare(hub_ell, g_bwd, REL_TOL,
                   "transposed segment's hub row block alone", relative=True)
    case["n_tiles"] = int(bwd_ell.n_tiles[hub])
    cases.append(case)
    dense = ((rng.random((1003, 997)) < 0.01)
             * rng.standard_normal((1003, 997))).astype(np.float32)
    ragged = tile_csr_to_block_ell(csr_from_dense(dense), bm=8, bk=8)
    cases.append(compare(ragged, torch.randn(997, 200, device=DEV),
                         MAIN_TOL, "ragged 1003x997, F=200"))
    # A valid brick of zeros: no column of it is gathered.
    zeroed = brick_tensors(ragged)[0]
    zeroed[:, 0] = 0.0
    cases.append(compare(ragged, torch.randn(997, 200, device=DEV),
                         MAIN_TOL, "first brick of every row block zeroed",
                         blocks=zeroed))
    full = tile_csr_to_block_ell(csr_from_dense(rng.standard_normal(
        (64, 64)).astype(np.float32)), bm=8, bk=8)
    cases.append(compare(full, torch.randn(64, 256, device=DEV), MAIN_TOL,
                         "dense bricks, all 8 columns nonzero"))
    f16 = tile_csr_to_block_ell(csr_from_dense(dense), bm=8, bk=8,
                                dtype=np.float16)
    cases.append(compare(f16, torch.randn(997, 256, device=DEV).half(),
                         F16_TOL, "f16 blocks and H"))
    dense = np.zeros((40, 40), np.float32)
    dense[3, 5], dense[33, 39] = 2.0, -1.0      # row blocks 1-3 empty
    empty = tile_csr_to_block_ell(csr_from_dense(dense), bm=8, bk=8)
    cases.append(compare(empty, torch.randn(40, 64, device=DEV),
                         MAIN_TOL, "empty row blocks"))
    emit({"phase": "kernel", "cases": cases})
    return max(c["max_abs_err"] for c in cases[:3])


def phase_fused(kmod, main_ell, h_main):
    """Fused kernel vs plain version on the card; returns the largest
    error at the main path's shape."""
    import numpy as np
    import torch
    from repro_torch.sparse import csr_from_dense, tile_csr_to_block_ell

    gen = torch.Generator(device=DEV).manual_seed(2)

    def compare(ell, h, f_out, label):
        f = h.shape[1]
        w = torch.randn((f, f_out), device=DEV, generator=gen) * f ** -0.5
        b = 0.1 * torch.randn((f_out,), device=DEV, generator=gen)
        args = brick_tensors(ell)
        out, route = launch_route(kmod.FUSED_ROUTE_LAUNCHES, lambda: (
            kmod.fused_gcn_layer_cuda(*args, h, w, b, bm=ell.bm, bk=ell.bk)))
        plain = kmod.fused_gcn_layer_plain(*args, h, w, b, bm=ell.bm,
                                           bk=ell.bk)
        sync()
        err = float((out - plain).abs().max())
        if not err <= MAIN_TOL:
            raise AssertionError(f"{label}: max |kernel - plain| {err} > "
                                 f"{MAIN_TOL}")
        if route != "grouped":
            raise AssertionError(f"{label}: took route {route}")
        return {"case": label, "blocks": list(ell.blocks.shape),
                "h": list(h.shape), "w": [f, f_out], "route": route,
                "max_abs_err": err, "tol": MAIN_TOL}

    rng = np.random.default_rng(3)
    cases = [compare(main_ell, h_main, h_main.shape[1],
                     "main-path rUSA training segment 0"),
             compare(main_ell, h_main, 64, "F_out=64, last gcn_paper layer")]
    dense = ((rng.random((1003, 997)) < 0.01)
             * rng.standard_normal((1003, 997))).astype(np.float32)
    ragged = tile_csr_to_block_ell(csr_from_dense(dense), bm=8, bk=8)
    cases.append(compare(ragged, torch.randn(997, 200, device=DEV,
                                             generator=gen),
                         120, "ragged 1003x997, F=200"))
    dense = np.zeros((40, 40), np.float32)
    dense[3, 5], dense[33, 39] = 2.0, -1.0      # row blocks 1-3 empty
    empty = tile_csr_to_block_ell(csr_from_dense(dense), bm=8, bk=8)
    cases.append(compare(empty, torch.randn(40, 64, device=DEV,
                                            generator=gen),
                         48, "empty row blocks"))
    emit({"phase": "fused", "cases": cases})
    return max(c["max_abs_err"] for c in cases[:2])


def reference_outputs(a, features, weights):
    """float64 scipy reference: h <- relu((A h) W_l), last layer linear."""
    import numpy as np
    import scipy.sparse as sp
    a64 = sp.csr_matrix((a.data.astype(np.float64), a.indices, a.indptr),
                        shape=a.shape)
    hs = [f.astype(np.float64) for f in features]
    for layer, w in enumerate(weights):
        x = a64 @ np.concatenate(hs, axis=1)
        f = hs[0].shape[1]
        hs = [x[:, i * f:(i + 1) * f] @ w.astype(np.float64)
              for i in range(len(hs))]
        if layer < len(weights) - 1:
            hs = [np.maximum(h, 0.0) for h in hs]
    return hs


def serve_requests(graphs, args) -> dict:
    """gcn_paper's weights and four requests per graph from --seed, with
    their float64 reference outputs: the inputs of the serve and passes
    phases."""
    import torch
    from repro_torch.configs.gcn_paper import CONFIG
    from repro_torch.models import gcn_init

    gen = torch.Generator().manual_seed(args.seed)
    params = gcn_init(CONFIG, gen, device="cpu")
    weights = [params[f"w{i}"].numpy() for i in range(3)]
    requests, refs = {}, {}
    t0 = time.perf_counter()
    for name, a in graphs.items():
        requests[name] = [torch.randn((a.n_rows, CONFIG.feature_dim),
                                      generator=gen).numpy()
                          for _ in range(4)]
        refs[name] = reference_outputs(a, requests[name], weights)
    return {"weights": weights, "requests": requests, "refs": refs,
            "width": 4 * CONFIG.feature_dim,
            "setup_s": time.perf_counter() - t0}


def check_outputs(label: str, results, refs) -> float:
    """Each result's output against its float64 reference within
    SERVE_TOL; returns the largest |Δ|."""
    import numpy as np
    worst = 0.0
    for res, ref in zip(results, refs):
        out = res.output
        if out.shape != ref.shape or not np.isfinite(out).all():
            raise AssertionError(f"{label}: bad output {out.shape}")
        err = float(np.abs(out - ref).max())
        if not err <= SERVE_TOL:
            raise AssertionError(f"{label}: |out - float64 ref| {err}")
        worst = max(worst, err)
    return worst


def phase_serve(kmod, graphs, args, inputs):
    from repro_torch.runtime import (
        EngineConfig, InferenceRequest, ServingEngine,
    )

    weights, requests, refs = (inputs[k] for k in ("weights", "requests",
                                                     "refs"))
    width = inputs["width"]
    engines = {}
    t0 = time.perf_counter()
    for name, a in graphs.items():
        eng = ServingEngine(EngineConfig(
            device_budget_bytes=serve_budget(a, width),
            max_batch_features=width))
        eng.register_graph(name, a)
        engines[name] = eng
    setup_s = inputs["setup_s"] + time.perf_counter() - t0

    zero_gcn_counts(kmod)                  # the main path starts here
    epochs = []
    for epoch in range(args.epochs):
        row = {"epoch": epoch, "graphs": {}}
        for name, eng in engines.items():
            for h in requests[name]:
                eng.submit(InferenceRequest(name, h, weights))
            rep = eng.run_batch()
            row["graphs"][name] = {
                "wall_s": rep.wall_seconds,
                "uploaded_bytes": rep.uploaded_bytes,
                "cache_hit_bytes": rep.cache_hit_bytes,
                "promoted_bytes": rep.promoted_bytes,
                "segments_streamed": rep.segments_streamed,
                "aggregation_passes": rep.aggregation_passes,
                "max_abs_err_vs_float64": check_outputs(
                    f"{name} epoch {epoch}", rep.results, refs[name]),
            }
            if epoch == 0:                 # what `tune` is held to
                inputs.setdefault("serve_outputs", {})[name] = [
                    r.output for r in rep.results]
        epochs.append(row)
    launches = kmod.LAUNCHES              # ... and ends here
    segments = sum(g["segments_streamed"] for row in epochs
                   for g in row["graphs"].values())
    if launches != segments or launches == 0:
        raise AssertionError(f"kernel launches {launches} != segments "
                             f"streamed {segments}")
    routes = check_gcn_routes("serve", kmod, launches)
    for name in graphs:
        first, last = (epochs[0]["graphs"][name]["uploaded_bytes"],
                       epochs[-1]["graphs"][name]["uploaded_bytes"])
        if not last < first:
            raise AssertionError(f"{name}: epoch {args.epochs - 1} uploaded "
                                 f"{last} B, not below epoch 0's {first} B")
    emit({"phase": "serve", "setup_s": setup_s,
          "graphs": {name: {"n": a.n_rows, "nnz": a.nnz,
                            "budget_bytes": engines[name].config
                            .device_budget_bytes,
                            "requests_per_epoch": 4,
                            "layers": [list(w.shape) for w in weights]}
                     for name, a in graphs.items()},
          "epochs": epochs, "kernel_launches": launches,
          "launches_by_route": routes["bcsr_spmm"],
          "segments_streamed": segments})
    return launches


def f64_adjacency(a):
    """Ã as a float64 sparse COO tensor on the CPU: the yardstick of the
    training checks, never called by the port."""
    import numpy as np
    import torch
    rows = np.repeat(np.arange(a.n_rows, dtype=np.int64), np.diff(a.indptr))
    idx = torch.from_numpy(np.stack([rows, a.indices.astype(np.int64)]))
    return torch.sparse_coo_tensor(
        idx, torch.from_numpy(a.data.astype(np.float64)), a.shape,
        check_invariants=True).coalesce()


def rel_err(out, ref) -> float:
    """max |out - ref| over the reference's largest magnitude, in float64
    on out's device (a vocabulary's logits are gigabytes in float64: the
    host would take seconds over them)."""
    import torch
    out = out.detach().to(torch.float64)
    ref = ref.detach().to(device=out.device, dtype=torch.float64)
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise AssertionError(f"bad output {tuple(out.shape)} vs "
                             f"{tuple(ref.shape)}")
    return float((out - ref).abs().max()) / max(float(ref.abs().max()),
                                                1e-30)


def check_errors(label: str, errs: dict) -> None:
    bad = {k: e for k, e in errs.items() if not e <= REL_TOL}
    if bad:
        raise AssertionError(f"{label}: relative error above {REL_TOL}: "
                             f"{bad}")


def engine_at(a, width: int):
    """An `AiresSpGEMM` planned at width `width`, with launch/serve.py's
    budget rule at that width."""
    from repro_torch.core import AiresConfig, AiresSpGEMM
    return AiresSpGEMM(AiresConfig(
        device_budget_bytes=serve_budget(a, width), bm=8, bk=8,
        plan_features=width, device=DEV))


def phase_layer(kmod, eng, a, a64, seed: int):
    """gcn_layer forward and backward at gcn_paper width; returns the
    fused and SpMM launches of the run."""
    import torch
    from repro_torch.configs.gcn_paper import CONFIG

    width = CONFIG.feature_dim
    eng.reset_stats_logs()
    gen = torch.Generator().manual_seed(seed + 1)
    h = torch.randn((a.n_rows, width), generator=gen)
    w = torch.randn((width, width), generator=gen) * width ** -0.5
    b = 0.1 * torch.randn((width,), generator=gen)
    leaves = [t.to(DEV).requires_grad_(True) for t in (h, w, b)]
    sync()

    zero_gcn_counts(kmod)                         # the main path starts here
    t0 = time.perf_counter()
    y = eng.gcn_layer(a, *leaves)
    sync()
    t1 = time.perf_counter()
    torch.sum(torch.tanh(y)).backward()
    sync()
    t2 = time.perf_counter()
    fused, launches = kmod.FUSED_LAUNCHES, kmod.LAUNCHES   # ... and ends here

    fwd = [s.segments for s in eng.forward_stats_log]
    bwd = [s.segments for s in eng.backward_stats_log]   # recompute, Aᵀ
    if fused != sum(fwd) or fused == 0:
        raise AssertionError(f"fused launches {fused} != forward segments "
                             f"{fwd}")
    if len(bwd) != 2 or launches != sum(bwd):
        raise AssertionError(f"SpMM launches {launches} != recompute + "
                             f"transposed segments {bwd}")
    routes = check_gcn_routes("layer", kmod, launches, fused)
    ref = [t.detach().to(torch.float64).requires_grad_(True)
           for t in (h, w, b)]
    mask = (y.detach() > 0).cpu()                 # see REL_TOL
    y64 = (torch.sparse.mm(a64, ref[0]) @ ref[1] + ref[2]) * mask
    torch.sum(torch.tanh(y64)).backward()
    errs = {"y": rel_err(y, y64)}
    errs.update({f"d{n}": rel_err(t.grad, r.grad)
                 for n, t, r in zip("Wb", leaves[1:], ref[1:])})
    errs["dH"] = rel_err(leaves[0].grad, ref[0].grad)
    check_errors("layer", errs)
    emit({"phase": "layer", "n": a.n_rows, "width": width,
          "forward_segments": fwd, "backward_segments": bwd,
          "fused_launches": fused, "spmm_launches": launches,
          "launches_by_route": routes,
          "forward_s": t1 - t0, "backward_s": t2 - t1,
          "rel_err_vs_float64": errs, "tol": REL_TOL})
    return fused, launches


def relu_masks(eng, a, params, h0):
    """The relu masks of gcn_forward's hidden layers on the card, from the
    same operations in the same order."""
    import torch
    n_layers = len([k for k in params if k.startswith("w")])
    masks, h = [], h0
    with torch.no_grad():
        for i in range(n_layers - 1):
            z = eng(a, h) @ params[f"w{i}"] + params[f"b{i}"]
            masks.append((z > 0).cpu())
            h = torch.relu(z)
    return masks


def f64_gcn_grads(a64, params, h0, labels, masks):
    """Loss and parameter gradients of gcn_loss in float64 on the CPU, the
    hidden relus given by `masks` (see REL_TOL)."""
    import torch
    p64 = {k: v.detach().to(torch.float64).requires_grad_(True)
           for k, v in params.items()}
    n_layers = len([k for k in p64 if k.startswith("w")])
    h = h0.to(torch.float64)
    for i in range(n_layers):
        h = torch.sparse.mm(a64, h) @ p64[f"w{i}"] + p64[f"b{i}"]
        if i < n_layers - 1:
            h = h * masks[i]
    gold = torch.gather(h, 1, labels.long()[:, None])[:, 0]
    loss = torch.mean(torch.logsumexp(h, dim=-1) - gold)
    grads = torch.autograd.grad(loss, list(p64.values()))
    return loss.detach(), dict(zip(p64, grads))


def phase_train(kmod, eng, a, a64, seed: int):
    """gcn_train_loop with gcn_paper on `a`; returns the SpMM launches."""
    import torch
    from repro_torch.configs.gcn_paper import CONFIG
    from repro_torch.models import gcn_init, gcn_loss
    from repro_torch.train import gcn_train_loop

    width = CONFIG.feature_dim
    eng.reset_stats_logs()
    gen = torch.Generator().manual_seed(seed + 2)
    params = gcn_init(CONFIG, gen, device="cpu")
    h0 = torch.randn((a.n_rows, width), generator=gen)
    labels = torch.randint(0, CONFIG.n_classes, (a.n_rows,), generator=gen)
    h0_dev, labels_dev = h0.to(DEV), labels.to(DEV)
    fwd_segs = len(eng.stream_plan(a, h0.shape).robw.segments)
    bwd_segs = len(eng.stream_plan(a, h0.shape, transpose=True).robw.segments)
    if fwd_segs < 2 or bwd_segs < 2:
        raise AssertionError(f"the budget must stream both directions: "
                             f"{fwd_segs} forward, {bwd_segs} backward "
                             "segments")

    # The first step's gradient, timed by direction, against float64.
    leaves = {k: v.to(DEV).requires_grad_(True) for k, v in params.items()}
    sync()
    t0 = time.perf_counter()
    loss = gcn_loss(CONFIG, leaves, a, h0_dev, labels_dev, engine=eng)
    sync()
    t1 = time.perf_counter()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    sync()
    t2 = time.perf_counter()
    masks = relu_masks(eng, a, leaves, h0_dev)
    ref_loss, ref_grads = f64_gcn_grads(a64, params, h0, labels, masks)
    errs = {"loss": rel_err(loss, ref_loss)}
    errs.update({f"d{k}": rel_err(g, ref_grads[k])
                 for k, g in zip(leaves, grads)})
    check_errors("train", errs)

    zero_gcn_counts(kmod)                         # the main path starts here
    trained, info = gcn_train_loop(CONFIG, eng, a, h0_dev, labels_dev,
                                   {k: v.to(DEV) for k, v in params.items()},
                                   n_epochs=TRAIN_STEPS, lr=TRAIN_LR)
    launches = kmod.LAUNCHES                      # ... and ends here
    routes = check_gcn_routes("train", kmod, launches)

    # One more step's gradient, warm, timed by direction.
    leaves = {k: v.requires_grad_(True) for k, v in trained.items()}
    sync()
    t3 = time.perf_counter()
    loss = gcn_loss(CONFIG, leaves, a, h0_dev, labels_dev, engine=eng)
    sync()
    t4 = time.perf_counter()
    torch.autograd.grad(loss, list(leaves.values()))
    sync()
    t5 = time.perf_counter()
    segments = sum(s.segments for ep in info["epochs"]
                   for s in ep["forward_stream"] + ep["backward_stream"])
    if launches != segments or launches == 0:
        raise AssertionError(f"SpMM launches {launches} != segments "
                             f"streamed {segments}")
    losses = [loss for _, loss in info["history"]]
    if abs(losses[0] - float(ref_loss)) > REL_TOL * abs(float(ref_loss)):
        raise AssertionError(f"first loss {losses[0]} vs float64 "
                             f"{float(ref_loss)}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    emit({"phase": "train", "config": CONFIG.name,
          "layers": CONFIG.layer_dims(), "n": a.n_rows,
          "budget_bytes": eng.config.device_budget_bytes,
          "steps": TRAIN_STEPS, "optimizer": "adamw", "lr": TRAIN_LR,
          "first_step": {"forward_s": t1 - t0, "backward_s": t2 - t1},
          "warm_step": {"forward_s": t4 - t3, "backward_s": t5 - t4},
          "seconds_per_step": info["seconds"] / TRAIN_STEPS,
          "losses": losses, "float64_loss": float(ref_loss),
          "rel_err_vs_float64": errs, "tol": REL_TOL,
          "epochs": [{"forward_segments": [s.segments for s in
                                           ep["forward_stream"]],
                      "backward_segments": [s.segments for s in
                                            ep["backward_stream"]],
                      "uploaded_bytes": sum(
                          s.uploaded_bytes for s in
                          ep["forward_stream"] + ep["backward_stream"])}
                     for ep in info["epochs"]],
          "spmm_launches": launches,
          "launches_by_route": routes["bcsr_spmm"],
          "segments_streamed": segments})
    return launches


# The modeled fields of a ScheduleMetrics (the reference tests' list: every
# field but the wall-clock host_measured_s).
METRIC_FIELDS = (
    "makespan_s", "io_modeled_s", "compute_modeled_s", "host_preprocess_s",
    "bytes_by_path", "seconds_by_path", "total_transfer_bytes",
    "cache_hit_bytes", "merge_events", "merge_io_s", "segments", "oom")


def modeled(m) -> dict:
    """What the schedule and epoch phases print of a ScheduleMetrics: cost
    model output under PAPER_GPU_SYSTEM (the paper's RTX 4090-class
    system), never a time on this card."""
    return {"cost_model": "PAPER_GPU_SYSTEM", "makespan_s": m.makespan_s,
            "bytes_by_path": m.bytes_by_path, "segments": m.segments,
            "merge_events": m.merge_events, "oom": m.oom}


def same_metrics(label: str, got, want) -> None:
    bad = [f for f in METRIC_FIELDS if getattr(got, f) != getattr(want, f)]
    if bad:
        raise AssertionError(f"{label}: metrics differ in {bad}")


def no_analysis_errors(label: str, plan, **kw) -> int:
    """Runs the static analyzer over `plan`; raises on any error-severity
    finding, returns the number of findings."""
    from repro_torch.core import analyze_plan
    report = analyze_plan(plan, **kw)
    if report.errors:
        raise AssertionError(f"{label}: {[str(f) for f in report.errors]}")
    return len(report.findings)


def phase_schedule(kmod, a, a64, seed: int) -> int:
    """The paper's scheduler and its three baselines in execute mode on
    rUSA at gcn_paper's feature width; returns the SpMM launches."""
    import torch
    from repro_torch.configs.gcn_paper import CONFIG
    from repro_torch.core import (
        SCHEDULERS, AiresScheduler, CostInterpreter, FeatureSpec,
        required_bytes,
    )
    from repro_torch.io import PAPER_GPU_SYSTEM, TieredSegmentCache

    spec = PAPER_GPU_SYSTEM
    gen = torch.Generator().manual_seed(seed + 3)
    h = torch.randn((a.n_rows, CONFIG.feature_dim), generator=gen)
    h_dev = h.to(DEV)
    ref = torch.sparse.mm(a64, h.to(torch.float64))
    budget = serve_budget(a, CONFIG.feature_dim)
    kw = dict(device_budget=budget, bm=8, bk=8, wire_format="bricks",
              device=DEV)
    cache = TieredSegmentCache(device_budget_bytes=1 << 40, device=DEV)
    out = {"phase": "schedule", "n": a.n_rows, "nnz": a.nnz,
           "features": list(h.shape), "aires_budget_bytes": budget,
           "schedulers": {}}
    sync()

    zero_gcn_counts(kmod)                         # the main path starts here
    t0 = time.perf_counter()
    res = AiresScheduler(spec, **kw).run(a, h_dev, mode="execute")
    sync()
    t1 = time.perf_counter()
    cached = AiresScheduler(spec, segment_cache=cache, **kw)
    cold = cached.run(a, h_dev, mode="execute")
    warm = cached.run(a, h_dev, mode="execute")
    sync()
    launches = kmod.LAUNCHES                      # ... and ends here
    segs = res.metrics.segments
    if segs < 2:
        raise AssertionError(f"AIRES plan has {segs} segment(s), want >= 2")
    routes = check_gcn_routes("schedule", kmod, 3 * segs)
    errs = {"aires": rel_err(res.x, ref)}
    same_metrics("aires execute vs cost interpretation",
                 CostInterpreter(spec).run(res.pipeline)[0], res.metrics)
    wire = cold.pipeline.wire_bytes()             # the probes' wire bytes
    if (cold.metrics.cache_hit_bytes, warm.metrics.cache_hit_bytes) != (
            0, wire) or wire == 0:
        raise AssertionError(
            f"cached AIRES: hit bytes {cold.metrics.cache_hit_bytes}, "
            f"{warm.metrics.cache_hit_bytes}; want 0, {wire}")
    errs["aires_cached_warm"] = rel_err(warm.x, ref)
    warm_vs_first = rel_err(warm.x, res.x)
    if not warm_vs_first <= MAIN_TOL:
        raise AssertionError(f"cached run moved x by {warm_vs_first}")
    findings = no_analysis_errors("aires", res.pipeline, spec=spec,
                                  released=True)
    out["schedulers"]["aires"] = {
        **modeled(res.metrics), "execute_s": t1 - t0,
        "cached_warm": modeled(warm.metrics),
        "cache_hit_bytes_warm": warm.metrics.cache_hit_bytes,
        "wire_bytes": wire, "analysis_findings": findings}

    # The baselines at 1.1 x the requirement (the reference tests'
    # choice), raised for all three to 2.2 x H's bytes: MaxMemory's static
    # split must hold H in half the budget, which 1.1 x does not at this
    # width.
    feat = FeatureSpec.of(h)
    base_budget = max(int(1.1 * required_bytes(a, feat)),
                      int(2.2 * feat.compressed_bytes))
    out["baseline_budget_bytes"] = base_budget
    for name in ("maxmemory", "ucg", "etc"):
        t0 = time.perf_counter()
        bres = SCHEDULERS[name](spec, device_budget=base_budget,
                                device=DEV).run(a, h_dev, mode="execute")
        sync()
        if bres.metrics.oom:
            raise AssertionError(f"{name}: OOM at {base_budget} B")
        errs[name] = rel_err(bres.x, ref)
        out["schedulers"][name] = {
            **modeled(bres.metrics), "execute_s": time.perf_counter() - t0,
            "analysis_findings": no_analysis_errors(
                name, bres.pipeline, spec=spec, released=True)}
    bad = {k: e for k, e in errs.items() if not e <= MAIN_TOL}
    if bad:
        raise AssertionError(f"schedule: relative error above {MAIN_TOL}: "
                             f"{bad}")
    emit({**out, "rel_err_vs_float64": errs, "tol": MAIN_TOL,
          "spmm_launches": launches, "launches_by_route": routes[
              "bcsr_spmm"], "aires_segments": segs})
    return launches


def phase_epoch(kmod, a, seed: int) -> int:
    """gcn_epoch under AIRES in execute mode, gcn_paper's widths on rUSA;
    returns the SpMM launches."""
    import torch
    from repro_torch.configs.gcn_paper import CONFIG
    from repro_torch.core import (
        AiresConfig, AiresScheduler, AiresSpGEMM, FeatureSpec, gcn_epoch,
    )
    from repro_torch.io import PAPER_GPU_SYSTEM

    spec = PAPER_GPU_SYSTEM
    dims = CONFIG.layer_dims()                   # [(256, 256), ..., (256, 64)]
    gen = torch.Generator().manual_seed(seed + 4)
    h0 = torch.randn((a.n_rows, dims[0][0]), generator=gen).to(DEV)
    ws = [(torch.randn((fi, fo), generator=gen) * fi ** -0.5).to(DEV)
          for fi, fo in dims]
    budget = serve_budget(a, CONFIG.feature_dim)
    cfg = AiresConfig(budget, bm=8, bk=8, device=DEV)
    sync()

    zero_gcn_counts(kmod)                         # the main path starts here
    em = gcn_epoch(a, h0, ws, "aires", spec, budget, mode="execute",
                   engine_config=cfg)
    launches = kmod.LAUNCHES                      # ... and ends here
    fwd = [s.segments for s in em.forward_stream]
    bwd = [s.segments for s in em.backward_stream]
    if len(fwd) != len(ws) or len(bwd) != len(ws) or min(fwd + bwd) < 2:
        raise AssertionError(f"epoch streams: forward {fwd}, backward {bwd}")
    routes = check_gcn_routes("epoch", kmod, sum(fwd) + sum(bwd))

    # Each stream's wire bytes, from an engine with the same config, and
    # the modeled per-layer metrics, from the scheduler run alone. The
    # twin's first plan in each direction times the host work (RoBW,
    # transpose, densification, pinning) that the epoch's first forward
    # and backward calls do inside wall_seconds.
    twin = AiresSpGEMM(cfg)
    t0 = time.perf_counter()
    twin.stream_plan(a, (a.n_rows, dims[0][0]))
    t1 = time.perf_counter()
    a_t = twin.transpose_of(a)
    twin.stream_plan(a, (a.n_rows, dims[0][0]), transpose=True)
    prepare_s = {"forward": t1 - t0, "backward": time.perf_counter() - t1}
    sched = AiresScheduler(spec, device_budget=budget)
    findings = 0
    for i, w in enumerate(ws):
        shape = (a.n_rows, int(w.shape[0]))
        for label, plan, stats in (
                ("forward", twin.stream_plan(a, shape),
                 em.forward_stream[i]),
                ("backward", twin.stream_plan(a, shape, transpose=True),
                 em.backward_stream[i])):
            if stats.uploaded_bytes != plan.wire_bytes():
                raise AssertionError(
                    f"layer {i} {label}: uploaded {stats.uploaded_bytes} B, "
                    f"plan {plan.wire_bytes()} B")
            findings += no_analysis_errors(f"layer {i} {label}", plan)
        feat = FeatureSpec(a.n_rows, shape[1], 4, 0.0)
        same_metrics(f"layer {i} forward", em.per_layer[i],
                     sched.run(a, feat).metrics)
        same_metrics(f"layer {i} backward", em.per_layer_backward[i],
                     sched.run(a_t, feat).metrics)
    sim = gcn_epoch(a, h0, ws, "aires", spec, budget, mode="simulate")
    emit({"phase": "epoch", "config": CONFIG.name, "layers": dims,
          "n": a.n_rows, "budget_bytes": budget,
          "forward_segments": fwd, "backward_segments": bwd,
          "uploaded_bytes": [s.uploaded_bytes for s in
                             em.forward_stream + em.backward_stream],
          "wall_seconds": em.wall_seconds, "host_prepare_s": prepare_s,
          "modeled_cost_model": "PAPER_GPU_SYSTEM",
          "modeled_execute_epoch_makespan_s": em.epoch_makespan_s,
          "modeled_simulate_epoch_makespan_s": sim.epoch_makespan_s,
          "modeled_per_layer": [modeled(m) for m in em.per_layer],
          "modeled_per_layer_backward": [modeled(m) for m in
                                         em.per_layer_backward],
          "analysis_findings": findings,
          "spmm_launches": launches,
          "launches_by_route": routes["bcsr_spmm"]})
    return launches


def fixed_clock() -> float:
    """A clock that stands still: deadlines and their order then do not
    depend on how long the phase takes."""
    return 1000.0


def phase_passes(kmod, graphs, inputs) -> int:
    """The serving engine with the reference's pass set and analysis on,
    requests with deadlines; then a stream that really coalesces. Returns
    the SpMM launches."""
    import torch
    from repro_torch.core import (
        AiresConfig, AiresSpGEMM, CoalescedPayload, EDFOrderingPass,
        PassPipeline, ShardPlacementPass, TransferCoalescingPass,
        TransferOp, deadline_order, plan_memory_dense_features,
    )
    from repro_torch.configs.gcn_paper import CONFIG
    from repro_torch.runtime import (
        EngineConfig, InferenceRequest, ServingEngine,
    )

    # (a) One engine serving both graphs through the three passes, each
    # request with a deadline; socLJ1's, submitted second, are earlier.
    weights, requests, refs = (inputs[k] for k in ("weights", "requests",
                                                     "refs"))
    width = inputs["width"]
    clock = fixed_clock
    eng = ServingEngine(EngineConfig(
        device_budget_bytes=max(serve_budget(a, width)
                                for a in graphs.values()),
        max_batch_features=width, analyze_plans=True, clock=clock,
        device=DEV,
        plan_passes=[ShardPlacementPass(), TransferCoalescingPass(),
                     EDFOrderingPass(clock=clock)]))
    for name, a in graphs.items():
        eng.register_graph(name, a)
    first_deadline = {"rUSA": 600.0, "socLJ1": 300.0}
    queued = []
    for name in graphs:
        for i, h in enumerate(requests[name]):
            req = InferenceRequest(name, h, weights,
                                   deadline_s=first_deadline[name] + i)
            rid = eng.submit(req)
            queued.append((int(rid), name, req.deadline_s,
                           rid.estimated_cost_s))
    want = [name for _, name, _, _ in deadline_order(
        queued, cost_of=lambda q: q[3], deadline_of=lambda q: q[2])]
    sync()

    zero_gcn_counts(kmod)                         # the main path starts here
    rep = eng.run_batch()
    sync()
    served_launches = kmod.LAUNCHES
    if served_launches != rep.segments_streamed or served_launches == 0:
        raise AssertionError(f"passes (a): SpMM launches {served_launches} "
                             f"!= segments streamed {rep.segments_streamed}")
    by_id = {r.request_id: r for r in rep.results}
    errs = {}
    for name in graphs:
        ids = [rid for rid, g, _, _ in queued if g == name]
        errs[name] = check_outputs(f"passes {name}",
                                   [by_id[rid] for rid in ids], refs[name])
    served = [lat.graph for lat in sorted(rep.request_latency,
                                          key=lambda lat: lat.actual_s)]
    if list(dict.fromkeys(served)) != list(dict.fromkeys(want)):
        raise AssertionError(f"passes (a): groups served {served}, "
                             f"deadline order {want}")
    serve_routes = check_gcn_routes("passes_serve", kmod, served_launches)

    # (b) A stream that really coalesces: socLJ1 split into >= 8 segments,
    # no segment cache, every segment below the coalescing threshold.
    lj = graphs["socLJ1"]
    f = CONFIG.feature_dim
    est = plan_memory_dense_features(lj, lj.n_rows, f, float("inf"))
    budget = int(est.m_b + est.m_c + 0.1 * lj.nbytes())
    plain = AiresSpGEMM(AiresConfig(budget, bm=8, bk=8, device=DEV))
    raw = plain.stream_plan(lj, (lj.n_rows, f))
    seg_bytes = [b.op.nbytes for b in raw.ops
                 if isinstance(b.op, TransferOp)]
    if raw.segments < 8:
        raise AssertionError(f"passes (b): {raw.segments} segments, want 8")
    coalesce = PassPipeline([TransferCoalescingPass(
        min_bytes=max(seg_bytes) + 1)])
    co = AiresSpGEMM(AiresConfig(budget, bm=8, bk=8, device=DEV),
                     plan_passes=coalesce, analyze=True)
    plan = co.stream_plan(lj, (lj.n_rows, f))
    merged = [b.op for b in plan.ops if isinstance(b.op, TransferOp)
              and isinstance(b.op.payload[1], CoalescedPayload)]
    members = sum(len(op.payload[1].payloads) for op in merged)
    if not merged or members != raw.segments:
        raise AssertionError(f"passes (b): {len(merged)} merged transfers "
                             f"hold {members} of {raw.segments} segments")
    gen = torch.Generator(device=DEV).manual_seed(7)
    h = torch.randn((lj.n_rows, f), device=DEV, generator=gen)
    x_plain = plain(lj, h)
    sync()
    zero_gcn_counts(kmod)                         # the main path starts here
    x_co = co(lj, h)
    sync()
    co_launches = kmod.LAUNCHES                   # ... and ends here
    stats = co.last_stream_stats
    if co_launches != raw.segments or stats.segments != len(merged):
        raise AssertionError(
            f"passes (b): {co_launches} SpMM launches for {raw.segments} "
            f"segments, {stats.segments} streamer issues for {len(merged)} "
            "merged transfers")
    routes = check_gcn_routes("passes_coalesce", kmod, co_launches)
    errs["coalesced_vs_plain"] = rel_err(x_co, x_plain)
    if not errs["coalesced_vs_plain"] <= MAIN_TOL:
        raise AssertionError(f"passes (b): coalesced vs plain "
                             f"{errs['coalesced_vs_plain']}")
    if stats.uploaded_bytes != plain.last_stream_stats.uploaded_bytes:
        raise AssertionError("passes (b): coalescing changed the bytes")
    emit({"phase": "passes",
          "serve": {"requests": len(queued), "graph_order": served,
                    "deadline_order": want,
                    "segments_streamed": rep.segments_streamed,
                    "uploaded_bytes": rep.uploaded_bytes,
                    "spmm_launches": served_launches,
                    "launches_by_route": serve_routes["bcsr_spmm"],
                    "max_abs_err_vs_float64": {k: errs[k] for k in graphs},
                    "tol": SERVE_TOL},
          "coalesce": {"graph": "socLJ1", "budget_bytes": budget,
                       "segments": raw.segments,
                       "segment_wire_bytes": seg_bytes,
                       "min_bytes": coalesce.passes[0].min_bytes,
                       "merged_transfers": len(merged),
                       "streamer_issues": stats.segments,
                       "uploaded_bytes": stats.uploaded_bytes,
                       "spmm_launches": co_launches,
                       "rel_err_vs_plain": errs["coalesced_vs_plain"],
                       "tol": MAIN_TOL,
                       "launches_by_route": routes["bcsr_spmm"]}})
    return served_launches + co_launches


def rel_to_scale(out, ref) -> float:
    """max |out - ref| over ref's largest magnitude (numpy arrays)."""
    import numpy as np
    if out.shape != ref.shape or not np.isfinite(out).all():
        raise AssertionError(f"bad output {out.shape} vs {ref.shape}")
    return float(np.abs(out - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-30)


def sharded_config(graphs, width: int, device_bytes, worker_id: int):
    """The `shard` and `warm` phases' engine config: the serving width and
    shared budget of `passes`, four cache shards over `device_bytes`, the
    three passes, analysis on, a calibrator of its own."""
    from repro_torch.core import (
        CostCalibrator, EDFOrderingPass, ShardPlacementPass,
        TransferCoalescingPass,
    )
    from repro_torch.runtime import EngineConfig
    return EngineConfig(
        device_budget_bytes=max(serve_budget(a, width)
                                for a in graphs.values()),
        max_batch_features=width, device=DEV, analyze_plans=True,
        cache_shards=SHARDS, cache_device_bytes=device_bytes,
        worker_id=worker_id, calibrator=CostCalibrator(),
        plan_passes=[ShardPlacementPass(), TransferCoalescingPass(),
                     EDFOrderingPass(clock=fixed_clock)])


def serve_epoch(eng, graphs, inputs) -> tuple:
    """The eight requests of `serve` through one engine: (report, outputs
    by graph in submit order, largest |Δ| against float64)."""
    from repro_torch.runtime import InferenceRequest
    ids = {name: [int(eng.submit(InferenceRequest(name, h,
                                                  inputs["weights"])))
                  for h in inputs["requests"][name]] for name in graphs}
    rep = eng.run_batch()
    by_id = {r.request_id: r for r in rep.results}
    outs, err = {}, 0.0
    for name in graphs:
        results = [by_id[i] for i in ids[name]]
        err = max(err, check_outputs(f"{name}", results,
                                     inputs["refs"][name]))
        outs[name] = [r.output for r in results]
    return rep, outs, err


def report_row(rep) -> dict:
    return {"wall_s": rep.wall_seconds,
            "uploaded_bytes": rep.uploaded_bytes,
            "cache_hit_bytes": rep.cache_hit_bytes,
            "promoted_bytes": rep.promoted_bytes,
            "ici_bytes": rep.ici_bytes,
            "directory_hit_bytes": rep.directory_hit_bytes,
            "duplicate_avoided_bytes": rep.duplicate_avoided_bytes,
            "segments_streamed": rep.segments_streamed,
            "aggregation_passes": rep.aggregation_passes}


def phase_shard(kmod, graphs, args, inputs) -> tuple:
    """Two workers over four-shard caches sharing a `CacheDirectory`,
    calibrators attached, two epochs of `serve`'s requests; then the
    launcher with workers, shards, passes and calibration. Returns the
    SpMM launches and what `warm` continues from."""
    import numpy as np
    from repro_torch.io import CacheDirectory
    from repro_torch.launch.serve import serve_gcn
    from repro_torch.runtime import InferenceRequest, ServingEngine

    width = inputs["width"]
    t0 = time.perf_counter()
    # The unsharded single-worker engine the sharded outputs are held to,
    # and the wire bytes of rUSA's plan that size the sharded device tier.
    single = ServingEngine(dataclasses.replace(
        sharded_config(graphs, width, None, 0), cache_shards=1,
        calibrator=None))
    for name, a in graphs.items():
        single.register_graph(name, a)
    single_rep, single_out, _ = serve_epoch(single, graphs, inputs)
    wire_epoch = single_rep.uploaded_bytes + single_rep.cache_hit_bytes
    a = graphs["rUSA"]
    wire_rusa = single._engines["rUSA"].stream_plan(
        a, (a.n_rows, width), apply_passes=False).wire_bytes()
    directory = CacheDirectory()
    workers = [ServingEngine(sharded_config(graphs, width, wire_rusa // 2,
                                            wid), directory=directory)
               for wid in range(2)]
    for eng in workers:
        for name, a in graphs.items():
            eng.register_graph(name, a)
    spec = workers[0].config.tier_spec
    uncal = {name: workers[0].estimate_request_cost(
        InferenceRequest(name, inputs["requests"][name][0],
                         inputs["weights"]), spec=spec) for name in graphs}
    sync()
    setup_s = time.perf_counter() - t0

    zero_gcn_counts(kmod)                         # the main path starts here
    epochs, errs = [], {"vs_float64": 0.0, "vs_unsharded_rel": 0.0}
    for epoch in range(args.epochs):
        row = {"epoch": epoch, "workers": []}
        lats = []
        for wid, eng in enumerate(workers):
            rep, outs, err = serve_epoch(eng, graphs, inputs)
            errs["vs_float64"] = max(errs["vs_float64"], err)
            for name in graphs:
                for out, ref in zip(outs[name], single_out[name]):
                    errs["vs_unsharded_rel"] = max(errs["vs_unsharded_rel"],
                                                   rel_to_scale(out, ref))
            row["workers"].append(report_row(rep))
            lats += rep.request_latency
        row["mean_abs_err_s"] = {
            "calibrated": sum(abs(lt.error_s) for lt in lats) / len(lats),
            "uncalibrated": sum(abs(lt.processing_s - uncal[lt.graph])
                                for lt in lats) / len(lats)}
        epochs.append(row)
    launches = kmod.LAUNCHES                      # ... and ends here
    segments = sum(w["segments_streamed"] for row in epochs
                   for w in row["workers"])
    if launches != segments or launches == 0:
        raise AssertionError(f"shard: SpMM launches {launches} != segments "
                             f"streamed {segments}")
    routes = check_gcn_routes("shard", kmod, launches)
    if not errs["vs_unsharded_rel"] <= SHARD_REL_TOL:
        raise AssertionError(f"shard: outputs {errs['vs_unsharded_rel']} "
                             "from the unsharded engine's, relative")
    for wid, w in enumerate(epochs[-1]["workers"]):
        if w["uploaded_bytes"] != 0 or w["cache_hit_bytes"] != wire_epoch:
            raise AssertionError(
                f"shard: worker {wid}'s warm epoch uploaded "
                f"{w['uploaded_bytes']} B and hit {w['cache_hit_bytes']} B "
                f"of {wire_epoch}")
    totals = {f: sum(w[f] for row in epochs for w in row["workers"])
              for f in ("ici_bytes", "duplicate_avoided_bytes",
                        "directory_hit_bytes")}
    if not (totals["ici_bytes"] > 0 and totals["duplicate_avoided_bytes"] > 0):
        raise AssertionError(f"shard: {totals}")
    generations = [eng.config.calibrator.generation for eng in workers]
    if not all(g > 0 for g in generations):
        raise AssertionError(f"shard: calibrator generations {generations}")
    fitted = {}
    for wid, eng in enumerate(workers):
        cal = eng.cost_spec()
        fitted[wid] = {"error_scale": eng.config.calibrator.error_scale,
                       "paths": {p.value: {"bw_bytes_per_s": cal.bw[p],
                                           "latency_s": cal.latency_s[p],
                                           "base_bw": spec.bw[p],
                                           "base_latency_s":
                                               spec.latency_s[p]}
                                 for p in cal.bw}}

    # The entry point a user calls, at its defaults (scale 1e-4).
    summary = {}
    zero_gcn_counts(kmod)                         # the main path starts here
    t1 = time.perf_counter()
    reports = serve_gcn(workers=2, cache_shards=SHARDS, calibrate=True,
                        passes=True, summary_out=summary, device=DEV)
    sync()
    cli_s = time.perf_counter() - t1
    cli_launches = kmod.LAUNCHES                  # ... and ends here
    cli_segments = sum(r.segments_streamed for e in reports for r in e)
    if cli_launches != cli_segments or cli_launches == 0:
        raise AssertionError(f"shard: serve_gcn launched {cli_launches} "
                             f"for {cli_segments} segments")
    cli_routes = check_gcn_routes("shard_serve_gcn", kmod, cli_launches)
    for e in reports:
        for r in e:
            for res in r.results:
                if not np.isfinite(res.output).all():
                    raise AssertionError("shard: serve_gcn output not finite")
    if len(summary["epoch_errors"]) != 2:
        raise AssertionError(f"shard: serve_gcn summary {summary}")
    emit({"phase": "shard", "setup_s": setup_s, "shards": SHARDS,
          "workers": 2,
          "cache_device_bytes": workers[0].config.cache_device_bytes,
          "shard_budget_bytes": workers[0].cache.shard_budget_bytes,
          "rusa_wire_bytes": wire_rusa, "wire_bytes_per_epoch": wire_epoch,
          "epochs": epochs, "totals": totals,
          "max_abs_err_vs_float64": errs["vs_float64"], "tol": SERVE_TOL,
          "rel_err_vs_unsharded": errs["vs_unsharded_rel"],
          "rel_tol": SHARD_REL_TOL,
          "calibrator_generations": generations, "fitted_spec": fitted,
          "spmm_launches": launches, "segments_streamed": segments,
          "launches_by_route": routes["bcsr_spmm"],
          "serve_gcn": {"seconds": cli_s, "spmm_launches": cli_launches,
                        "launches_by_route": cli_routes["bcsr_spmm"],
                        "epochs": [[report_row(r) for r in e]
                                   for e in reports],
                        "epoch_errors_s": summary["epoch_errors"]}})
    state = {"worker": workers[0], "wire_epoch": wire_epoch}
    return launches + cli_launches, state


def phase_warm(kmod, graphs, inputs, state) -> int:
    """Worker 0's cache checkpointed, a fresh engine warm-started from it
    serving one epoch without uploading, then rUSA evicted. Returns the
    SpMM launches."""
    import gc
    import shutil
    import tempfile
    import torch
    from repro_torch.core import AiresSpGEMM, CostCalibrator
    from repro_torch.io import CacheDirectory, prefix_matches
    from repro_torch.io.tiers import MemoryTier
    from repro_torch.runtime import InferenceRequest, ServingEngine

    worker = state["worker"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bricks_")
    try:
        exported = [(k, n) for k, v, n in worker.cache.export_entries()]
        t0 = time.perf_counter()
        path = worker.checkpoint_cache(tmp)
        save_s = time.perf_counter() - t0
        npz_bytes = sum(f.stat().st_size for f in Path(path).iterdir())
        # The same config, with a calibrator of its own.
        fresh = ServingEngine(dataclasses.replace(
            worker.config, calibrator=CostCalibrator()),
            directory=CacheDirectory())
        for name, a in graphs.items():
            fresh.register_graph(name, a)
        sync()
        t1 = time.perf_counter()
        ws = fresh.warm_start(tmp)
        warm_s = time.perf_counter() - t1
        if (ws.bricks, ws.wire_bytes) != (len(exported),
                                          sum(n for _, n in exported)):
            raise AssertionError(f"warm: restored {ws} of {len(exported)} "
                                 "exported bricks")

        zero_gcn_counts(kmod)                     # the main path starts here
        rep, _, err = serve_epoch(fresh, graphs, inputs)
        launches = kmod.LAUNCHES                  # ... and ends here
        if launches != rep.segments_streamed or launches == 0:
            raise AssertionError(f"warm: SpMM launches {launches} != "
                                 f"segments {rep.segments_streamed}")
        routes = check_gcn_routes("warm", kmod, launches)
        if rep.uploaded_bytes != 0 or rep.cache_hit_bytes != \
                state["wire_epoch"]:
            raise AssertionError(f"warm: first epoch uploaded "
                                 f"{rep.uploaded_bytes} B, hit "
                                 f"{rep.cache_hit_bytes} B")

        a = graphs["rUSA"]
        prefix = AiresSpGEMM.graph_cache_prefix(a)
        queued = [int(fresh.submit(InferenceRequest("rUSA", h,
                                                    inputs["weights"])))
                  for h in inputs["requests"]["rUSA"]]
        entries = fresh.cache.export_entries()
        dev_bytes = sum(n for k, _, n in entries
                        if prefix_matches(k.graph_id, prefix)
                        and fresh.cache.tier_of(k) is MemoryTier.DEVICE)
        host_bytes = sum(n for k, _, n in entries
                         if prefix_matches(k.graph_id, prefix)
                         and fresh.cache.tier_of(k) is MemoryTier.HOST)
        host_used = fresh.cache.host_used_bytes
        del entries
        gc.collect()
        sync()
        mem0 = torch.cuda.memory_allocated() if DEV == "cuda" else 0
        orphans = fresh.evict_graph("rUSA")
        gc.collect()
        sync()
        mem1 = torch.cuda.memory_allocated() if DEV == "cuda" else 0
        if [r.request_id for r in orphans] != queued:
            raise AssertionError(f"warm: evict returned "
                                 f"{[r.request_id for r in orphans]}")
        left = [k for k, _, _ in fresh.cache.export_entries()
                if prefix_matches(k.graph_id, prefix)]
        held = [k for k in fresh.directory._entries
                if prefix_matches(k.graph_id, prefix)]
        if left or held or "rUSA" in fresh._engines:
            raise AssertionError(f"warm: {len(left)} keys, {len(held)} "
                                 "directory holdings left under rUSA")
        if mem0 - mem1 < dev_bytes:
            raise AssertionError(f"warm: evict freed {mem0 - mem1} B of "
                                 f"device memory for {dev_bytes} B")
        if host_used - fresh.cache.host_used_bytes != host_bytes:
            raise AssertionError("warm: evict left rUSA's host tier")
        emit({"phase": "warm", "checkpoint_s": save_s,
              "checkpoint_file_bytes": npz_bytes,
              "bricks": ws.bricks, "wire_bytes": ws.wire_bytes,
              "warm_start_s": warm_s,
              "modeled_warm_start_s": ws.modeled_seconds,
              "first_epoch": report_row(rep),
              "max_abs_err_vs_float64": err, "tol": SERVE_TOL,
              "spmm_launches": launches,
              "launches_by_route": routes["bcsr_spmm"],
              "evict": {"orphans": len(orphans),
                        "device_tier_bytes": dev_bytes,
                        "host_tier_bytes": host_bytes,
                        "memory_allocated_freed": mem0 - mem1}})
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---- tune, update and partition ---------------------------------------------

# The port's host planner at width 1024, serve_budget and 8 x 8 bricks, as
# predicted before the first run (PERF.md): (segments' true ELL widths,
# bucket set, its brick bytes, the power-of-two bytes). The tune phase fails
# unless the autotuner installs exactly these and the served bricks have
# these true widths.
TUNE_PREDICTED = {"rUSA": ([49, 42], [42, 49], 359_555_140, 498_071_700),
                  "socLJ1": ([467, 341], [341, 467], 60_455_800, 80_540_020)}
UPDATE_EDGES = 1000            # inserts and as many deletes, update phase
SBM_BLOCKS = 8                 # SBM communities = partition clusters
SBM_P_IN = 0.9
SBM_SEG_FRAC = 24              # bench_partition's stream budget rule


def prepared_plan(spg):
    """The one prepared (forward, serving-width) plan of an engine."""
    (prep,) = spg._prepared.values()
    return prep


def serve_graph(eng, name, requests, weights) -> tuple:
    """One epoch of `requests` against one graph: (report, outputs in
    submit order)."""
    from repro_torch.runtime import InferenceRequest
    ids = [int(eng.submit(InferenceRequest(name, h, weights)))
           for h in requests]
    rep = eng.run_batch()
    by_id = {r.request_id: r for r in rep.results}
    return rep, [by_id[i].output for i in ids]


def phase_tune(kmod, graphs, args, inputs) -> tuple:
    """Autotune and install each graph's schedule under the engine's
    `cost_spec()`, then `serve`'s requests for the epochs; the installed
    bucket sets and bytes against the values predicted before the run
    (`TUNE_PREDICTED`), epoch 0's uploads against the
    installed plan's wire bytes, outputs against float64 and against
    `serve`'s default-schedule outputs. Returns the SpMM launches and the
    tuned engines."""
    import torch
    from repro_torch.runtime import EngineConfig, ServingEngine
    from repro_torch.sparse import csr_row_slice

    width, weights = inputs["width"], inputs["weights"]
    engines, tuned, rows = {}, {}, {}
    t0 = time.perf_counter()
    for name, a in graphs.items():
        eng = ServingEngine(EngineConfig(
            device_budget_bytes=serve_budget(a, width),
            max_batch_features=width))
        eng.register_graph(name, a)
        t1 = time.perf_counter()
        tuned[name] = eng.autotune(name, install=True)
        tune_s = time.perf_counter() - t1
        print(tuned[name].describe(), flush=True)
        spg = eng._engines[name]
        got = (list(tuned[name].ell_buckets)
               if tuned[name].ell_buckets is not None else None)
        if eng.installed_schedules[name] != tuned[name] or (
                spg.config.ell_buckets != got):
            raise AssertionError(f"tune: {name}'s schedule not installed")
        _, want_buckets, want_bytes, want_default = TUNE_PREDICTED[name]
        if (got, tuned[name].ell_bytes, tuned[name].default_ell_bytes) != (
                want_buckets, want_bytes, want_default):
            raise AssertionError(
                f"tune: {name} installed {got}, {tuned[name].ell_bytes} B "
                f"(power of two {tuned[name].default_ell_bytes} B); "
                f"predicted {want_buckets}, {want_bytes} B ({want_default} B)")
        rows[name] = {
            "describe": tuned[name].describe(), "autotune_s": tune_s,
            "installed_buckets": got,
            "ell_bytes": tuned[name].ell_bytes,
            "default_ell_bytes": tuned[name].default_ell_bytes,
            "predicted_makespan_s": tuned[name].predicted_makespan_s,
            "default_makespan_s": tuned[name].default_makespan_s,
            "min_bytes": tuned[name].min_bytes,
            "pass_order": list(tuned[name].pass_order),
            "epochs": []}
        engines[name] = eng
    sync()
    setup_s = time.perf_counter() - t0

    zero_gcn_counts(kmod)                         # the main path starts here
    errs = {"vs_float64": 0.0, "vs_serve_rel": 0.0}
    for epoch in range(args.epochs):
        for name, eng in engines.items():
            rep, outs = serve_graph(eng, name, inputs["requests"][name],
                                    weights)
            errs["vs_float64"] = max(errs["vs_float64"], check_outputs(
                f"tune {name}", rep.results, inputs["refs"][name]))
            for out, ref in zip(outs, inputs["serve_outputs"][name]):
                errs["vs_serve_rel"] = max(errs["vs_serve_rel"],
                                           rel_to_scale(out, ref))
            rows[name]["epochs"].append(report_row(rep))
    launches = kmod.LAUNCHES                      # ... and ends here
    segments = sum(e["segments_streamed"] for r in rows.values()
                   for e in r["epochs"])
    if launches != segments or launches == 0:
        raise AssertionError(f"tune: SpMM launches {launches} != segments "
                             f"streamed {segments}")
    routes = check_gcn_routes("tune", kmod, launches)
    if not errs["vs_serve_rel"] <= SHARD_REL_TOL:
        raise AssertionError(f"tune: outputs {errs['vs_serve_rel']} from "
                             "the default schedule's, relative")
    for name, row in rows.items():
        # The served bricks' true widths (their longest row block) and
        # padded widths, read off the prepared plan's tiles.
        prep = prepared_plan(engines[name]._engines[name])
        row["ell_widths"] = [int(e.n_tiles.max()) for e in prep.ells]
        row["padded_widths"] = [int(e.blocks.shape[1]) for e in prep.ells]
        widths, buckets = TUNE_PREDICTED[name][:2]
        if row["ell_widths"] != widths or row["padded_widths"] != [
                min(b for b in buckets if b >= w) for w in widths]:
            raise AssertionError(
                f"tune: {name}'s bricks are {row['ell_widths']} wide, padded "
                f"to {row['padded_widths']}; predicted {widths} in {buckets}")
        # Epoch 0 prepared the installed plan (as `serve`'s epoch 0 did the
        # default one): its wire bytes are the tuned bricks' bytes.
        a = graphs[name]
        row["plan_wire_bytes"] = wire = engines[name]._engines[
            name].stream_plan(a, (a.n_rows, width),
                              apply_passes=False).wire_bytes()
        if not row["epochs"][0]["uploaded_bytes"] == wire == row[
                "ell_bytes"]:
            raise AssertionError(f"tune: {name}'s epoch 0 uploaded "
                                 f"{row['epochs'][0]['uploaded_bytes']} B; "
                                 f"plan {wire} B, tuned {row['ell_bytes']}")

    # The kernel at the widest tuned brick of each graph, against its plain
    # version (not counted: the main path's counts were read above).
    cases, widest = [], {}
    gen = torch.Generator(device=DEV).manual_seed(args.seed + 7)
    for name, a in graphs.items():
        prep = prepared_plan(engines[name]._engines[name])
        i = max(range(len(prep.ells)),
                key=lambda j: prep.ells[j].blocks.shape[1])
        ell, seg = prep.ells[i], prep.plan.segments[i]
        short = int((ell.n_tiles < ell.blocks.shape[1]).sum())
        if not short:
            raise AssertionError(f"tune: every row block of {name}'s "
                                 "widest brick is full")
        h = torch.randn((a.n_cols, width), device=DEV, generator=gen)
        case = spmm_case(kmod, ell, h, REL_TOL,
                         f"tuned {name} brick, ell_w "
                         f"{ell.blocks.shape[1]}", relative=True)
        case["row_blocks_below_ell_w"] = short
        case["segment"] = i
        cases.append(case)
        widest[name] = {"ell": ell, "segment": i, "csr": csr_row_slice(
            a, seg.row_start, seg.row_end)}
        del h
    emit({"phase": "tune", "setup_s": setup_s, "graphs": rows,
          "max_abs_err_vs_float64": errs["vs_float64"], "tol": SERVE_TOL,
          "rel_err_vs_serve": errs["vs_serve_rel"],
          "rel_tol": SHARD_REL_TOL, "spmm_launches": launches,
          "segments_streamed": segments,
          "launches_by_route": routes["bcsr_spmm"],
          "kernel_cases": cases})
    return launches, {"engines": engines, "tuned": tuned, "widest": widest,
                      "kernel_err": max(c["max_abs_err"] for c in cases)}


def edge_delta(a, seg, seed: int, n: int) -> tuple:
    """`n` inserts of absent edges and `n` deletes of present off-diagonal
    edges, all in the rows of `seg`, drawn from `seed`."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lo, hi = seg.row_start, seg.row_end
    rows = np.repeat(np.arange(lo, hi, dtype=np.int64),
                     np.diff(a.indptr[lo:hi + 1]))
    cols = np.asarray(a.indices[a.indptr[lo]:a.indptr[hi]], dtype=np.int64)
    pick = rng.choice(np.nonzero(rows != cols)[0], size=n, replace=False)
    deletes = [(int(rows[i]), int(cols[i])) for i in pick]
    present = set(zip(rows.tolist(), cols.tolist()))
    inserts, used = [], set()
    while len(inserts) < n:
        r, c = int(rng.integers(lo, hi)), int(rng.integers(0, a.n_cols))
        if (r, c) in present or (r, c) in used:
            continue
        used.add((r, c))
        inserts.append((r, c, float(rng.uniform(0.05, 0.25))))
    return inserts, deletes


def phase_update(kmod, graphs, args, inputs, tune_state) -> int:
    """An edge delta confined to the last segment of the tuned rUSA
    engine, then one epoch: uploads equal to the host plan's prediction
    (the re-tiled bricks, plus any reused one whose positional key went
    stale), the rest served as cache hits, outputs against float64 on the
    updated graph and against a fresh engine registered on it."""
    import numpy as np
    from repro_torch.runtime import ServingEngine

    name, width = "rUSA", inputs["width"]
    eng = tune_state["engines"][name]
    spg = eng._engines[name]
    a = eng._graphs[name]
    prep = prepared_plan(spg)
    old_keys = set(spg._segment_keys(prep))
    t0 = time.perf_counter()
    inserts, deletes = edge_delta(a, prep.plan.segments[-1], args.seed,
                                  UPDATE_EDGES)
    delta_s = time.perf_counter() - t0
    report = eng.update_graph(name, inserts=inserts, deletes=deletes)
    new_a = eng._graphs[name]
    new_prep = prepared_plan(spg)
    keys = spg._segment_keys(new_prep)
    fresh_keys = [i for i, k in enumerate(keys) if k not in old_keys]
    stale_reused = [i for i in fresh_keys if new_prep.fps[i] in prep.fps]
    predicted = sum(new_prep.ells[i].nbytes() for i in fresh_keys)
    stale_reused_bytes = sum(new_prep.ells[i].nbytes()
                             for i in stale_reused)
    if predicted != report.retiled_bytes + stale_reused_bytes:
        raise AssertionError(f"update: {predicted} B of fresh keys, "
                             f"{report.retiled_bytes} B re-tiled and "
                             f"{stale_reused_bytes} B reused but stale")
    wire = sum(e.nbytes() for e in new_prep.ells)
    t1 = time.perf_counter()
    refs = reference_outputs(new_a, inputs["requests"][name],
                             inputs["weights"])
    refs_s = time.perf_counter() - t1
    fresh = ServingEngine(eng.config)
    fresh.register_graph(name, new_a)
    sync()

    zero_gcn_counts(kmod)                         # the main path starts here
    rep, outs = serve_graph(eng, name, inputs["requests"][name],
                            inputs["weights"])
    fresh_rep, fresh_outs = serve_graph(fresh, name,
                                        inputs["requests"][name],
                                        inputs["weights"])
    launches = kmod.LAUNCHES                      # ... and ends here
    segments = rep.segments_streamed + fresh_rep.segments_streamed
    if launches != segments or launches == 0:
        raise AssertionError(f"update: SpMM launches {launches} != "
                             f"segments streamed {segments}")
    routes = check_gcn_routes("update", kmod, launches)
    err = check_outputs("update", rep.results, refs)
    rel = max(rel_to_scale(o, f) for o, f in zip(outs, fresh_outs))
    if not rel <= SHARD_REL_TOL:
        raise AssertionError(f"update: outputs {rel} from a fresh engine's "
                             "on the updated graph, relative")
    hits = rep.aggregation_passes * wire - predicted
    if (rep.uploaded_bytes, rep.cache_hit_bytes) != (predicted, hits):
        raise AssertionError(f"update: uploaded {rep.uploaded_bytes} B and "
                             f"hit {rep.cache_hit_bytes} B; the host plan "
                             f"predicts {predicted} B and {hits} B")
    reused = [i for i, k in enumerate(keys) if k in old_keys]
    emit({"phase": "update", "graph": name, "edges": {
        "inserts": len(inserts), "deletes": len(deletes),
        "rows": [prep.plan.segments[-1].row_start,
                 prep.plan.segments[-1].row_end]},
        "delta_draw_s": delta_s,
        "report": {k: getattr(report, k) for k in (
            "plans_updated", "segments_retiled", "segments_reused",
            "retiled_bytes", "stale_keys", "cache_entries_dropped",
            "wall_seconds")},
        "segments": [list(e.blocks.shape) for e in new_prep.ells],
        "reused_key_bytes": sum(new_prep.ells[i].nbytes() for i in reused),
        "stale_reused_segments": stale_reused,
        "predicted_uploaded_bytes": predicted, "fresh_keys": len(fresh_keys),
        "epoch": report_row(rep), "fresh_engine_epoch": report_row(
            fresh_rep), "float64_refs_s": refs_s,
        "max_abs_err_vs_float64": err, "tol": SERVE_TOL,
        "rel_err_vs_fresh_engine": rel, "rel_tol": SHARD_REL_TOL,
        "spmm_launches": launches, "segments_streamed": segments,
        "launches_by_route": routes["bcsr_spmm"]})
    del fresh
    return launches


def phase_partition(kmod, graphs, args, inputs) -> int:
    """An SBM graph of rUSA's rows and about its nonzeros on a four-shard
    ring cache whose device tier holds the graph's wire bytes, two arms
    (CRC owners; `partition_graph(a, 8, n_shards=4, topology=ICI_RING)`)
    for the epochs: each epoch's bytes against the host model (the same
    engine on the CPU, serving one width-1 request through the same three
    layers: the same plan, passes and cache traffic; this shows that the
    card's and the CPU's accounting agree, not that the accounting is
    right, which the CPU tests hold against the reference), the partition
    arm's warm ICI at most the CRC arm's, outputs across arms and against
    float64."""
    import numpy as np
    import torch
    from repro_torch.core import (
        AiresConfig, AiresSpGEMM, ShardPlacementPass, bucket_set_bytes,
        plan_memory_dense_features, segment_ell_widths,
    )
    from repro_torch.data import generate_sbm_graph, normalized_adjacency
    from repro_torch.io.tiers import ICI_RING
    from repro_torch.runtime import EngineConfig, ServingEngine
    from repro_torch.sparse import partition_graph

    rusa, width, weights = graphs["rUSA"], inputs["width"], inputs["weights"]
    t0 = time.perf_counter()
    a = normalized_adjacency(generate_sbm_graph(
        rusa.n_rows, rusa.nnz - rusa.n_rows, n_blocks=SBM_BLOCKS,
        p_in=SBM_P_IN, seed=args.seed))
    gen = torch.Generator().manual_seed(args.seed + 11)
    requests = [torch.randn((a.n_rows, width // 4), generator=gen).numpy()
                for _ in range(4)]
    refs = reference_outputs(a, requests, weights)
    est = plan_memory_dense_features(a, a.n_rows, width, float("inf"))
    budget = int(est.m_b + est.m_c + a.nbytes() / SBM_SEG_FRAC)
    cfg = AiresConfig(device_budget_bytes=budget, bm=8, bk=8,
                      plan_features=width, device="cpu")
    _, plan = AiresSpGEMM(cfg).plan(a, (a.n_rows, width))
    wire = bucket_set_bytes(segment_ell_widths(a, plan, bm=8, bk=8),
                            [s.n_rows for s in plan.segments], None, 8, 8)
    graph_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    part = partition_graph(a, SBM_BLOCKS, n_shards=SHARDS,
                           topology=ICI_RING)
    partition_s = time.perf_counter() - t1

    def engine(device, arm):
        eng = ServingEngine(EngineConfig(
            device_budget_bytes=budget, cache_device_bytes=wire,
            cache_shards=SHARDS, ici_topology=ICI_RING,
            plan_passes=[ShardPlacementPass()], max_batch_features=width,
            device=device, analyze_plans=True))
        eng.register_graph("sbm", a,
                           partition=part if arm == "partition" else None)
        return eng

    fields = ("uploaded_bytes", "cache_hit_bytes", "promoted_bytes",
              "ici_bytes", "segments_streamed")
    t2 = time.perf_counter()
    host = {}
    for arm in ("crc", "partition"):
        twin = engine("cpu", arm)
        host[arm] = []
        for _ in range(args.epochs):
            rep, _ = serve_graph(twin, "sbm", [np.ones((a.n_rows, 1),
                                                      np.float32)],
                                 [np.ones((1, 1), np.float32)] * 3)
            host[arm].append({f: getattr(rep, f) for f in fields})
        del twin
    host_s = time.perf_counter() - t2
    card = {arm: engine(DEV, arm) for arm in ("crc", "partition")}
    sync()
    setup_s = time.perf_counter() - t0

    zero_gcn_counts(kmod)                         # the main path starts here
    epochs, outs, err = {}, {}, 0.0
    for arm, eng in card.items():
        epochs[arm] = []
        for _ in range(args.epochs):
            rep, outs[arm] = serve_graph(eng, "sbm", requests, weights)
            err = max(err, check_outputs(f"partition {arm}", rep.results,
                                         refs))
            epochs[arm].append(report_row(rep))
    launches = kmod.LAUNCHES                      # ... and ends here
    segments = sum(e["segments_streamed"] for arm in epochs.values()
                   for e in arm)
    if launches != segments or launches == 0:
        raise AssertionError(f"partition: SpMM launches {launches} != "
                             f"segments streamed {segments}")
    routes = check_gcn_routes("partition", kmod, launches)
    for arm in epochs:
        got = [{f: e[f] for f in fields} for e in epochs[arm]]
        if got != host[arm]:
            raise AssertionError(f"partition: {arm} epochs {got}, the host "
                                 f"model {host[arm]}")
    warm = {arm: epochs[arm][-1]["ici_bytes"] for arm in epochs}
    if not warm["partition"] <= warm["crc"]:
        raise AssertionError(f"partition: warm ICI {warm}")
    rel = max(rel_to_scale(o, c) for o, c in zip(outs["partition"],
                                                 outs["crc"]))
    if not rel <= SHARD_REL_TOL:
        raise AssertionError(f"partition: arms {rel} apart, relative")
    spg = card["partition"]._engines["sbm"]
    emit({"phase": "partition", "graph": {
        "n": a.n_rows, "nnz": a.nnz, "blocks": SBM_BLOCKS, "p_in": SBM_P_IN,
        "seed": args.seed, "budget_bytes": budget,
        "crc_segments": len(plan.segments),
        "partition_segments": len(prepared_plan(spg).ells),
        "wire_bytes": wire, "cache_device_bytes": wire},
        "partition": {"clusters": part.n_clusters,
                      "cluster_to_shard": part.cluster_to_shard.tolist(),
                      "shard_nnz": part.shard_nnz.tolist(),
                      "boundaries": int(part.boundaries().size),
                      "seconds": partition_s},
        "graph_and_refs_s": graph_s, "host_model_s": host_s,
        "setup_s": setup_s, "epochs": epochs, "host_model": host,
        "warm_ici_bytes": warm, "max_abs_err_vs_float64": err,
        "tol": SERVE_TOL, "rel_err_across_arms": rel,
        "rel_tol": SHARD_REL_TOL, "spmm_launches": launches,
        "segments_streamed": segments,
        "launches_by_route": routes["bcsr_spmm"]})
    return launches


CONT_ARRIVALS = 32             # Poisson arrivals over both graphs
CONT_RATE = 1.5                # arrivals per unit, as serve_continuous
CONT_DEADLINE = 3.0            # units, as serve_continuous
CONT_BURST = 4                 # requests per graph in the single burst


def continuous_engine(graphs, width: int):
    """The `continuous` phase's engine: both graphs, `serve`'s budget rule
    at the plan width, EDF on a virtual clock, no calibrator (the timeline
    then depends on modeled costs alone), and the cache sharded over the
    data axis of an `ElasticMesh` of the visible cards (on one card, one
    shard). Returns (engine, mesh)."""
    from repro_torch.core import EDFOrderingPass
    from repro_torch.runtime import (
        ElasticMesh, EngineConfig, ServingEngine, VirtualClock,
    )
    clock = VirtualClock()
    mesh = ElasticMesh(model_parallel=1).make()
    eng = ServingEngine(EngineConfig(
        device_budget_bytes=max(serve_budget(a, width)
                                for a in graphs.values()),
        max_batch_features=width, clock=clock, device=DEV,
        cache_shard_axis="data",
        plan_passes=[EDFOrderingPass(clock=clock)]), mesh=mesh)
    for name, a in graphs.items():
        eng.register_graph(name, a)
    return eng, mesh


def request_maker(inputs):
    """make_request for a trace: each graph's arrivals cycle through its
    four `serve` requests (with their float64 references). Returns the
    function and a map from a request's features to its reference."""
    from repro_torch.runtime import InferenceRequest
    seen = {}
    ref_of = {id(h): ref for name in inputs["requests"]
              for h, ref in zip(inputs["requests"][name],
                                inputs["refs"][name])}

    def make_request(arr):
        k = seen.get(arr.graph, 0)
        seen[arr.graph] = k + 1
        h = inputs["requests"][arr.graph][k % len(inputs["requests"][
            arr.graph])]
        return InferenceRequest(arr.graph, h, inputs["weights"],
                                deadline_s=arr.deadline_s)

    return make_request, ref_of


def timeline(rep) -> tuple:
    """A ServeReport's event order and virtual stamps, with its verdicts."""
    return ([(e.request_id, e.graph, e.submitted_s, e.started_s,
              e.finished_s, e.predicted_s) for e in rep.events],
            [(v.request_id, v.graph, v.reason)
             for v in rep.expired + rep.rejected])


def phase_continuous(kmod, graphs, args, inputs) -> int:
    """A seeded Poisson trace over both graphs through `ContinuousServer`
    and `replay_continuous`, under `Supervisor.run`, on an engine whose
    cache lies on an `ElasticMesh` of this card; each step's wall seconds
    (after a synchronise) fed to `observe_step`. Checks: served outputs
    within SERVE_TOL of float64; served + expired + rejected = offered;
    the timeline equal to a replay of the trace on a fresh engine; and a
    single burst through the loop uploads and hits the bytes `run_batch`
    does on a fresh engine, with its outputs within SHARD_REL_TOL.
    Returns the SpMM launches of the supervised replay."""
    import numpy as np
    import torch
    from repro_torch.runtime import (
        ContinuousServer, InferenceRequest, Supervisor, SupervisorConfig,
        poisson_trace, replay_continuous, summarize,
    )

    t_phase = time.perf_counter()
    width, weights = inputs["width"], inputs["weights"]
    feature_dim = inputs["requests"]["rUSA"][0].shape[1]
    eng, mesh = continuous_engine(graphs, width)
    grid = mesh.devices.tolist()
    if grid != [[torch.device("cuda", 0)]] or mesh.axis_names != (
            "data", "model"):
        raise AssertionError(f"continuous: mesh {grid} {mesh.axis_names}")
    if eng.cache.n_shards != 1:
        raise AssertionError(f"continuous: {eng.cache.n_shards} shards")
    unit_of = {name: eng.estimate_request_cost(InferenceRequest(
        name, inputs["requests"][name][0], weights)) for name in graphs}
    unit_graph = max(unit_of, key=unit_of.get)
    unit = unit_of[unit_graph]
    trace = poisson_trace(n=CONT_ARRIVALS, rate_hz=CONT_RATE / unit,
                          graphs=sorted(graphs), seed=args.seed,
                          feature_dim=feature_dim,
                          n_layers=len(weights),
                          deadline_s=CONT_DEADLINE * unit)
    make_request, ref_of = request_maker(inputs)
    sup = Supervisor(SupervisorConfig())
    walls, stragglers, refs, outs = [], [], {}, {}

    class TimedServer(ContinuousServer):
        """The loop, each served step timed to its synchronise and fed to
        the supervisor, each admitted request's reference kept."""

        def submit(self, request, at=None):
            receipt = super().submit(request, at=at)
            refs[int(receipt)] = ref_of[id(request.features)]
            return receipt

        def step(self):
            t0 = time.perf_counter()
            rep = super().step()
            sync()
            if rep is not None and rep.events:
                wall = time.perf_counter() - t0
                walls.append(wall)
                if sup.observe_step(wall):
                    stragglers.append({"step": len(walls) - 1,
                                       "graph": rep.graph, "wall_s": wall})
                outs.update((r.request_id, r.output) for r in rep.results)
            return rep

    server = TimedServer(eng)
    sync()
    setup_s = time.perf_counter() - t_phase

    zero_gcn_counts(kmod)                         # the main path starts here
    t0 = time.perf_counter()
    report = {}

    def body(start: int) -> int:
        report["rep"] = replay_continuous(server, trace[start:],
                                          make_request)
        return len(trace)

    state = sup.run(body)
    replay_s = time.perf_counter() - t0
    launches = kmod.LAUNCHES                      # ... and ends here
    rep = report["rep"]
    if launches != rep.stats.segments_streamed or launches == 0:
        raise AssertionError(f"continuous: SpMM launches {launches} != "
                             f"segments streamed "
                             f"{rep.stats.segments_streamed}")
    routes = check_gcn_routes("continuous", kmod, launches)
    if state.restarts or state.step != len(trace):
        raise AssertionError(f"continuous: supervisor state {state}")
    summary = summarize(rep)
    if (summary["served"] + summary["expired"] + summary["rejected"]
            != summary["offered"] or summary["offered"] != len(trace)):
        raise AssertionError(f"continuous: summary {summary}")
    if summary["served"] == 0 or len({e.graph for e in rep.events}) != 2:
        raise AssertionError("continuous: both graphs must be served")
    err = 0.0
    for e in rep.events:
        out, ref = outs[e.request_id], refs[e.request_id]
        if out.shape != ref.shape or not np.isfinite(out).all():
            raise AssertionError(f"continuous: bad output {out.shape}")
        err = max(err, float(np.abs(out - ref).max()))
    if not err <= SERVE_TOL:
        raise AssertionError(f"continuous: |out - float64 ref| {err}")

    # The same trace on a fresh engine: the timeline is the modeled one.
    t1 = time.perf_counter()
    twin, _ = continuous_engine(graphs, width)
    twin_make, _ = request_maker(inputs)
    twin_rep = replay_continuous(ContinuousServer(twin), trace, twin_make)
    sync()
    if timeline(twin_rep) != timeline(rep):
        raise AssertionError("continuous: the timeline differs from a "
                             "fresh engine's replay of the same trace")
    twin_s = time.perf_counter() - t1
    del twin, twin_rep

    # One burst: the loop against run_batch on fresh engines.
    t2 = time.perf_counter()
    burst = [(name, h) for name in graphs
             for h in inputs["requests"][name][:CONT_BURST]]
    loop_eng, _ = continuous_engine(graphs, width)
    loop = ContinuousServer(loop_eng)
    for name, h in burst:
        loop.submit(InferenceRequest(name, h, weights), at=0.0)
    steps = loop.drain()
    loop_rep = loop.report()
    loop_outs = {r.request_id: r.output for s in steps for r in s.results}
    del loop, loop_eng
    round_eng, _ = continuous_engine(graphs, width)
    for name, h in burst:
        round_eng.submit(InferenceRequest(name, h, weights))
    round_rep = round_eng.run_batch()
    sync()
    del round_eng
    fields = ("uploaded_bytes", "cache_hit_bytes", "promoted_bytes",
              "segments_streamed", "aggregation_passes")
    burst_loop = {f: getattr(loop_rep.stats, f) for f in fields}
    burst_round = {f: getattr(round_rep, f) for f in fields}
    if burst_loop != burst_round or loop_rep.served != len(burst):
        raise AssertionError(f"continuous: burst {burst_loop} through the "
                             f"loop, {burst_round} through run_batch")
    burst_rel = max(rel_to_scale(loop_outs[r.request_id], r.output)
                    for r in round_rep.results)
    if not burst_rel <= SHARD_REL_TOL:
        raise AssertionError(f"continuous: burst outputs {burst_rel} apart")
    burst_s = time.perf_counter() - t2

    emit({"phase": "continuous", "mesh": {
        "axis_names": list(mesh.axis_names),
        "devices": [[str(d) for d in row] for row in grid],
        "cache_shards": eng.cache.n_shards},
        "budget_bytes": eng.config.device_budget_bytes,
        "max_batch_features": width,
        "trace": {"kind": "poisson", "arrivals": len(trace),
                  "seed": args.seed, "feature_dim": feature_dim,
                  "layers": [list(w.shape) for w in weights],
                  "unit_graph": unit_graph, "unit_s": unit,
                  "unit_s_by_graph": unit_of,
                  "rate_per_unit": CONT_RATE,
                  "deadline_units": CONT_DEADLINE,
                  "by_graph": {name: sum(a.graph == name for a in trace)
                               for name in sorted(graphs)}},
        "summary": summary,
        "step_wall_s": {"steps": len(walls), "min": min(walls),
                        "median": float(np.median(walls)),
                        "max": max(walls)},
        "supervisor": {"restarts": state.restarts,
                       "straggler_events": state.straggler_events,
                       "step_time_ewma_s": state.step_time_ewma,
                       "stream_deadline_s": sup.stream_deadline()},
        "stragglers": stragglers,
        "max_abs_err_vs_float64": err, "tol": SERVE_TOL,
        "twin_replay_equal": True,
        "burst": {"requests": len(burst), "loop": burst_loop,
                  "run_batch": burst_round, "groups": len(steps),
                  "rel_err": burst_rel, "rel_tol": SHARD_REL_TOL},
        "spmm_launches": launches,
        "launches_by_route": routes["bcsr_spmm"],
        "setup_s": setup_s, "replay_s": replay_s, "twin_s": twin_s,
        "burst_s": burst_s, "phase_s": time.perf_counter() - t_phase})
    return launches


def brick_work(args, ell, k_rows: int, f: int, h_itemsize: int) -> dict:
    """What the aggregation needs for these inputs, counted two ways. Both
    read the valid bricks, col_tile and n_tiles once. By bricks: the H tiles
    the valid bricks reference, read once, and 2*bm*bk FLOPs per valid brick
    and feature column. By nonzeros: the H rows under the bricks' nonzero
    columns, read once, and 2 FLOPs per nonzero and feature column. The
    output is the caller's to add."""
    import torch
    blocks, col_tile, n_tiles = args
    slots = torch.arange(col_tile.shape[1], device=col_tile.device)[None, :]
    valid = (slots < n_tiles.long()[:, None]) & (col_tile >= 0)
    n_valid = int(valid.sum())
    tiles = col_tile[valid].long()
    h_tiles = int(torch.unique(tiles).numel())
    nz = blocks[valid] != 0                              # (n_valid, bm, bk)
    nnz = int(nz.sum())
    rows = tiles[:, None] * ell.bk + torch.arange(ell.bk, device=tiles.device)
    h_rows = int(torch.unique(rows[nz.any(dim=1) & (rows < k_rows)]).numel())
    fixed = (n_valid * ell.bm * ell.bk * blocks.element_size()
             + col_tile.numel() * 4 + n_tiles.numel() * 4)
    return {"valid_bricks": n_valid, "h_tiles_referenced": h_tiles,
            "nonzeros": nnz, "h_rows_referenced": h_rows,
            "bytes_bricks": fixed + min(h_tiles * ell.bk, k_rows) * f
            * h_itemsize,
            "flops_bricks": 2.0 * n_valid * ell.bm * ell.bk * f,
            "bytes": fixed + h_rows * f * h_itemsize,
            "flops": 2.0 * nnz * f}


def bound(nbytes: float, flops: float) -> tuple:
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bounds(work: dict, extra_bytes: float, extra_flops: float) -> dict:
    """The bound on the nonzeros (`bound_ms`, `bound_by`) and the one on
    every brick entry (`bound_ms_bricks`, `bound_by_bricks`), each with the
    work beyond the aggregation added."""
    ms, by = bound(work["bytes"] + extra_bytes, work["flops"] + extra_flops)
    ms_b, by_b = bound(work["bytes_bricks"] + extra_bytes,
                       work["flops_bricks"] + extra_flops)
    return {"min_bytes": work["bytes"] + extra_bytes,
            "flops": work["flops"] + extra_flops, "bound_ms": ms,
            "bound_by": by, "min_bytes_bricks": work["bytes_bricks"]
            + extra_bytes, "flops_bricks": work["flops_bricks"] + extra_flops,
            "bound_ms_bricks": ms_b, "bound_by_bricks": by_b}


def csr_on_card(a):
    import numpy as np
    import torch
    return torch.sparse_csr_tensor(
        torch.from_numpy(a.indptr.astype(np.int64)),
        torch.from_numpy(a.indices.astype(np.int64)),
        torch.from_numpy(a.data.copy()), size=a.shape,
        check_invariants=True).to(DEV)


def time_spmm(kmod, ell, csr, h) -> dict:
    """The SpMM kernel on one segment, its plain version and
    `torch.sparse.mm` (a yardstick the port never calls), with both
    bounds; `bound_share` is against the one on the nonzeros."""
    import torch
    args = brick_tensors(ell)
    bm, bk = ell.bm, ell.bk
    k_rows, f = h.shape
    _, route = launch_route(kmod.SPMM_ROUTE_LAUNCHES, lambda: (
        kmod.bcsr_spmm_cuda(*args, h, bm=bm, bk=bk)))
    ms = cuda_ms(lambda: kmod.bcsr_spmm_cuda(*args, h, bm=bm, bk=bk), 20)
    plain_ms = cuda_ms(lambda: kmod.bcsr_spmm_plain(*args, h, bm=bm, bk=bk),
                       3, warmup=1)
    a_csr = csr_on_card(csr)
    library_ms = cuda_ms(lambda: torch.sparse.mm(a_csr, h), 20)
    work = brick_work(args, ell, k_rows, f, h.element_size())
    b = bounds(work, ell.n_row_blocks * bm * f * 4, 0.0)      # X written
    return {"shape": {"blocks": list(ell.blocks.shape), "h": [k_rows, f]},
            "route": route,
            **{k: work[k] for k in ("valid_bricks", "h_tiles_referenced",
                                    "nonzeros", "h_rows_referenced")},
            **b, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_call": "torch.sparse.mm (CUDA CSR)",
            "bound_share": b["bound_ms"] / ms}


def time_fused(kmod, ell, csr, h, f_out: int) -> dict:
    """The fused kernel on one segment, its plain version and the two-call
    yardstick `torch.sparse.mm` then `addmm` + `relu` (no single PyTorch
    call computes the fused function), with both bounds, and a third at the
    rate of the method the kernel uses: X·W as three TF32 tensor-core
    products (`bound_ms_split_tf32`, against which `bound_share` is
    taken)."""
    import torch
    gen = torch.Generator(device=DEV).manual_seed(4)
    k_rows, f = h.shape
    w = torch.randn((f, f_out), device=DEV, generator=gen) * f ** -0.5
    b = 0.1 * torch.randn((f_out,), device=DEV, generator=gen)
    args = brick_tensors(ell)
    bm, bk = ell.bm, ell.bk
    _, route = launch_route(kmod.FUSED_ROUTE_LAUNCHES, lambda: (
        kmod.fused_gcn_layer_cuda(*args, h, w, b, bm=bm, bk=bk)))
    ms = cuda_ms(lambda: kmod.fused_gcn_layer_cuda(*args, h, w, b, bm=bm,
                                                   bk=bk), 20)
    plain_ms = cuda_ms(lambda: kmod.fused_gcn_layer_plain(
        *args, h, w, b, bm=bm, bk=bk), 3, warmup=1)
    a_csr = csr_on_card(csr)
    yardstick_ms = cuda_ms(lambda: torch.relu(torch.addmm(
        b, torch.sparse.mm(a_csr, h), w)), 20)
    work = brick_work(args, ell, k_rows, f, h.element_size())
    rows = ell.n_row_blocks * bm
    xw_flops = 2.0 * rows * f * f_out
    bnd = bounds(work, (f * f_out + f_out) * 4 + rows * f_out * 4,  # W, b; Y
                 xw_flops)
    # The aggregation's FLOPs at the f32 rate, then X·W's three products
    # at the TF32 tensor-core rate (an f32-accurate ceiling of 165 TFLOP/s).
    t_bytes = bnd["min_bytes"] / PEAK_BYTES_PER_S
    t_ops = work["flops"] / PEAK_F32_FLOPS + 3 * xw_flops / PEAK_TF32_FLOPS
    split_ms = 1e3 * max(t_bytes, t_ops)
    return {"shape": {"blocks": list(ell.blocks.shape), "h": [k_rows, f],
                      "w": [f, f_out]},
            "route": route,
            **{k: work[k] for k in ("valid_bricks", "h_tiles_referenced",
                                    "nonzeros", "h_rows_referenced")},
            **bnd, "bound_ms_split_tf32": split_ms,
            "bound_by_split_tf32": "bytes" if t_bytes >= t_ops
            else "operations",
            "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "yardstick_ms": yardstick_ms,
            "yardstick_call": "torch.sparse.mm (CUDA CSR), then addmm + relu",
            "bound_share": split_ms / ms}


def attn_compare(fn_cuda, fn_plain, args, kwargs, label, dtype,
                 lens_sweep: int = 0) -> dict:
    """One attention kernel against its plain version on the same inputs,
    per element within ATTN_TOL. With `lens_sweep` = S the decode kernel is
    called as `decode_step` calls it, once for each lens = t + 1 the same
    for every sequence, t in [0, S)."""
    import torch
    rtol, atol = ATTN_TOL[dtype]
    if lens_sweep:
        q, k, v, lens = args
        calls = [(q, k, v, torch.full_like(lens, t + 1))
                 for t in range(lens_sweep)]
    else:
        calls = [args]
    err = ratio = max_plain = sum_plain = 0.0
    n_plain = 0
    for call in calls:
        out = fn_cuda(*call, **kwargs)
        plain = fn_plain(*call, **kwargs)
        sync()
        if out.dtype != plain.dtype or out.shape != plain.shape:
            raise AssertionError(f"{label}: kernel gave {out.dtype} "
                                 f"{tuple(out.shape)}, plain {plain.dtype} "
                                 f"{tuple(plain.shape)}")
        delta = (out.float() - plain.float()).abs()
        mag = plain.float().abs()
        err = max(err, float(delta.max()))
        ratio = max(ratio, float((delta / (rtol * mag + atol)).max()))
        max_plain = max(max_plain, float(mag.max()))
        sum_plain += float(mag.sum())
        n_plain += mag.numel()
    if not ratio <= 1.0:
        raise AssertionError(f"{label}: |kernel - plain| exceeds {rtol}·"
                             f"|plain| + {atol} by a factor {ratio} (max "
                             f"|Δ| {err})")
    case = {"case": label, "shape": [list(a.shape) for a in args[:3]],
            "dtype": dtype, **kwargs, "max_abs_err": err,
            "max_err_over_limit": ratio, "max_abs_plain": max_plain,
            "mean_abs_plain": sum_plain / n_plain, "rtol": rtol,
            "atol": atol}
    if lens_sweep:
        case["lens"] = f"every sequence t + 1, t in [0, {lens_sweep})"
    return case


def attn_inputs(shape, dtype, gen):
    import torch
    return [torch.randn(shape, device=DEV, generator=gen).to(
        getattr(torch, dtype)) for _ in range(3)]


def decode_inputs(b, n_kv, group, s_len, dtype, gen, lens=None, d=128):
    """q (b, n_kv, group, d), k, v (b, n_kv, s_len, d) and lens drawn in
    [1, s_len] per sequence, the first s_len and the second 1."""
    import torch
    dt = getattr(torch, dtype)
    q = torch.randn((b, n_kv, group, d), device=DEV, generator=gen).to(dt)
    k, v = (torch.randn((b, n_kv, s_len, d), device=DEV,
                        generator=gen).to(dt) for _ in range(2))
    if lens is None:
        lens = torch.randint(1, s_len + 1, (b,), device=DEV, generator=gen,
                             dtype=torch.int32)
        lens[0] = s_len
        if b > 1:
            lens[1] = 1
    return q, k, v, lens


def hd_compare(dmod, label: str, shape, dtype: str, gen, softcap=None,
               lens=None) -> list:
    """The two kernels of the decode over a slice of the head dim against
    their plain versions on the same inputs: decode_scores on q (b, n_kv,
    group, d') and k (b, n_kv, S, d') within HD_SCORES_TOL, then
    decode_softmax_v on the plain scores and v within ATTN_TOL, scale 1 /
    sqrt(16 d') (the slice one of 16). Two cases."""
    import torch
    b, n_kv, group, s_len, d = shape
    q, k, v, drawn = decode_inputs(b, n_kv, group, s_len, dtype, gen, d=d)
    lens = drawn if lens is None else torch.tensor(
        lens, dtype=torch.int32, device=DEV)
    scale = 1.0 / (16 * d) ** 0.5
    cases = []
    s_plain = dmod.decode_scores_plain(q, k, lens)
    for name, out, plain, (rtol, atol) in (
            ("decode_scores", dmod.decode_scores(q, k, lens), s_plain,
             HD_SCORES_TOL),
            ("decode_softmax_v",
             dmod.decode_softmax_v(s_plain, v, lens, scale, softcap),
             dmod.decode_softmax_v_plain(s_plain, v, lens, scale, softcap),
             ATTN_TOL[dtype])):
        sync()
        if out.dtype != plain.dtype or out.shape != plain.shape:
            raise AssertionError(f"{name}: {label}: kernel gave {out.dtype} "
                                 f"{tuple(out.shape)}, plain {plain.dtype} "
                                 f"{tuple(plain.shape)}")
        delta = (out.float() - plain.float()).abs()
        mag = plain.float().abs()
        ratio = float((delta / (rtol * mag + atol)).max())
        if not ratio <= 1.0:
            raise AssertionError(f"{name}: {label}: |kernel - plain| "
                                 f"exceeds {rtol}·|plain| + {atol} by a "
                                 f"factor {ratio} (max |Δ| "
                                 f"{float(delta.max())})")
        cases.append({"case": f"{name}: {label}", "shape": list(shape),
                      "dtype": dtype, "softcap": softcap,
                      "lens": [int(x) for x in lens[:8]],
                      "max_abs_err": float(delta.max()),
                      "max_err_over_limit": ratio,
                      "max_abs_plain": float(mag.max()), "rtol": rtol,
                      "atol": atol})
    return cases


def hd_edge_lens(dmod, b: int, n_kv: int, group: int, s_len: int) -> list:
    """lens for a (b, n_kv, group, s_len) case at the edges of the blocks
    the kernels cut the positions into on this card: one short of, at and
    one past the end of decode_softmax_v's first split and decode_scores'
    first chunk, and inside a later split, clipped to s_len."""
    import torch
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    split, _ = dmod.hd_split_plan(b, n_kv, group, s_len, n_sm)
    chunk = dmod.hd_scores_chunk(b, n_kv, s_len, n_sm)
    lens = [split - 1, split, split + 1, chunk - 1, chunk + 1,
            2 * split + split // 2]
    return [min(s_len, x) for x in lens[:b]]


def decode_hd_cases(dmod, gen) -> list:
    """hd_compare at the main path's shapes (hints_check's caches, the
    production slices HD_YI_SLICE and HD_MIXTRAL_SLICE) and at its edges:
    f32, a softcap, 16 query heads a KV head at d' = 8 and 256, lens of 0,
    1, inside a split and at the edges of the kernels' splits and chunks
    (`hd_edge_lens`)."""
    b, steps = HINTS_TOKENS[0], HINTS_DECODE_STEPS
    return (hd_compare(dmod, "hints_check's decode step", (
                b, 4, 8, HINTS_DECODE_LEN, 128), "bfloat16", gen,
                lens=[steps] * b)
            + hd_compare(dmod, "Yi-6B decode_32k's slice", HD_YI_SLICE,
                         "bfloat16", gen)
            + hd_compare(dmod, "Mixtral 8x22B decode_32k's slice",
                         HD_MIXTRAL_SLICE, "bfloat16", gen)
            + hd_compare(dmod, "f32, ragged", (4, 2, 5, 1000, 64),
                         "float32", gen, lens=[0, 1, 64, 1000])
            + hd_compare(dmod, "softcap 50", (2, 4, 8, 300, 32),
                         "bfloat16", gen, softcap=50.0, lens=[63, 300])
            + hd_compare(dmod, "group 16 at d' = 256", (2, 1, 16, 129, 256),
                         "float16", gen, lens=[65, 129])
            + hd_compare(dmod, "group 16 at d' = 8", (3, 2, 16, 4096, 8),
                         "bfloat16", gen, lens=[4096, 1, 1500])
            + hd_compare(dmod, "lens at split and chunk edges",
                         (6, 2, 8, 4096, 8), "bfloat16", gen,
                         lens=hd_edge_lens(dmod, 6, 2, 8, 4096))
            + hd_compare(dmod, "lens at split edges, f32, d' = 64",
                         (6, 1, 4, 3000, 64), "float32", gen,
                         lens=hd_edge_lens(dmod, 6, 1, 4, 3000)))


def phase_attn(fmod, dmod, seed: int) -> dict:
    """Both attention kernels against their plain versions on the card;
    returns each kernel's largest error at the shapes lm_check and lm_serve
    give it."""
    import torch
    from repro_torch.configs import SHAPES

    gen = torch.Generator(device=DEV).manual_seed(seed + 3)
    torch.cuda.reset_peak_memory_stats()
    flash, decode = fmod.flash_attention_cuda, dmod.decode_attention_cuda
    f_plain, d_plain = fmod.flash_attention_plain, dmod.decode_attention_plain
    cases = [attn_compare(flash, f_plain,
                          attn_inputs((1, 32, LM_PREFILL, 128), "bfloat16",
                                      gen), {"causal": True},
                          "flash: lm_serve's prefill layer (train_4k length)",
                          "bfloat16")]
    cases.append(attn_compare(flash, f_plain,
                              attn_inputs((1, 8, LM_PREFILL, 128),
                                          "bfloat16", gen),
                              {"causal": True, "window": 512},
                              "flash: sliding window 512", "bfloat16"))
    cases.append(attn_compare(flash, f_plain,
                              attn_inputs((2, 8, 1000, 128), "bfloat16",
                                          gen), {"causal": True},
                              "flash: ragged S = 1000", "bfloat16"))
    cases.append(attn_compare(flash, f_plain,
                              attn_inputs((1, 8, 1024, 128), "float32", gen),
                              {"causal": True}, "flash: f32", "float32"))
    cases.append(attn_compare(flash, f_plain,
                              attn_inputs((2, 32, LM_PROMPT, 128), "float32",
                                          gen), {"causal": True},
                              "flash: lm_check's forward, f32", "float32"))
    dec = SHAPES["decode_32k"]
    cases.append(attn_compare(
        decode, d_plain, decode_inputs(dec["global_batch"], 4, 8,
                                       dec["seq_len"], "bfloat16", gen), {},
        "decode: decode_32k layer, per-sequence lens", "bfloat16"))
    cases.append(attn_compare(decode, d_plain,
                              decode_inputs(8, 4, 8, 4096, "float32", gen),
                              {}, "decode: f32", "float32"))
    cases.append(attn_compare(decode, d_plain,
                              decode_inputs(4, 32, 1, 2048, "bfloat16", gen),
                              {}, "decode: group 1 (MHA, as DeepSeek-7B)",
                              "bfloat16"))
    cases.append(attn_compare(decode, d_plain,
                              decode_inputs(4, 4, 8, 1000, "bfloat16", gen),
                              {}, "decode: ragged cache S = 1000",
                              "bfloat16"))
    serve_len = LM_PROMPT + LM_STEPS + 1        # serve's max_len
    cases.append(attn_compare(
        decode, d_plain, decode_inputs(LM_BATCH, 4, 8, serve_len, "bfloat16",
                                       gen), {},
        "decode: lm_serve's cache, every position", "bfloat16",
        lens_sweep=serve_len))
    cases.append(attn_compare(
        decode, d_plain, decode_inputs(2, 4, 8, LM_PROMPT, "float32", gen),
        {}, "decode: lm_check's cache, every position", "float32",
        lens_sweep=LM_PROMPT))
    cases += tile_edge_cases(fmod, dmod, gen)
    cases += softcap_cases(fmod, dmod, gen)
    cases += head_dim_112_cases(fmod, dmod, gen)
    cases += head_dim_256_cases(fmod, dmod, gen)
    t0 = time.perf_counter()
    cases += backward_cases(fmod, gen)
    cases += backward_softcap_cases(fmod, gen)
    cases += backward_d256_cases(fmod, gen)
    cases += prefix_cases(fmod, gen)
    cases += cross_cases(fmod, dmod, gen)
    hd = decode_hd_cases(dmod, gen)
    cases += hd
    emit({"phase": "attn", "cases": cases,
          "backward_cases_seconds": time.perf_counter() - t0,
          "peak_allocated_bytes": torch.cuda.max_memory_allocated()})
    torch.cuda.empty_cache()
    main = [c for c in cases                           # main-path shapes
            if "lm_" in c["case"] or "gemma_" in c["case"]
            or "mixtral_" in c["case"] or "moe_" in c["case"]
            or "qwen_" in c["case"] or "seamless_" in c["case"]]
    wide = [c for c in main if "d = 256" in c["case"]]
    prefixed = [c for c in main if "prefix" in c["case"]]
    seamless = [c for c in main if "seamless_" in c["case"]]
    return {**{name: max(c["max_abs_err"] for c in main
                         if c["case"].startswith(name))
               for name in ("flash", "decode", "backward")},
            **{f"{name}_d256": max(c["max_abs_err"] for c in wide
                                   if c["case"].startswith(name))
               for name in ("flash", "decode", "backward")},
            **{f"{name}_prefix": max(c["max_abs_err"] for c in prefixed
                                     if c["case"].startswith(name))
               for name in ("flash", "backward")},
            **{f"{name}_seamless": max(c["max_abs_err"] for c in seamless
                                       if c["case"].startswith(name))
               for name in ("flash", "backward", "decode")},
            **{name: max(c["max_abs_err"] for c in hd
                         if c["case"].startswith(name + ":"))
               for name in ("decode_scores", "decode_softmax_v")}}


def softcap_cases(fmod, dmod, gen) -> list:
    """Both kernels with an attention softcap against their plain versions:
    Gemma-2's cap of 50 at the shapes gemma_check and gemma_serve give
    them, and a cap of 1 that bites on every score; f32, f16 and bf16;
    flash within a window, decode with lens shorter than the cache."""
    flash, decode = fmod.flash_attention_cuda, dmod.decode_attention_cuda
    f_plain, d_plain = fmod.flash_attention_plain, dmod.decode_attention_plain
    window = 4096
    cases = [attn_compare(flash, f_plain,
                          attn_inputs((1, 32, GEMMA_PREFILL, 128), "bfloat16",
                                      gen),
                          {"causal": True, "window": window, "softcap": 50.0},
                          "flash: gemma_serve's prefill layer, softcap 50",
                          "bfloat16"),
             attn_compare(flash, f_plain,
                          attn_inputs((1, 32, GEMMA_CHECK_SEQ, 128),
                                      "float32", gen),
                          {"causal": True, "window": window, "softcap": 50.0},
                          "flash: gemma_check's forward, f32, softcap 50",
                          "float32")]
    for dtype, shape, kw in (
            ("bfloat16", (2, 8, 1000, 128), {"window": 300}),
            ("float16", (1, 8, 2048, 128), {"window": 512}),
            ("float32", (1, 8, 1024, 128), {"window": 100}),
            ("float16", (2, 4, 129, 64), {})):
        for cap in (50.0, 1.0):
            cases.append(attn_compare(
                flash, f_plain, attn_inputs(shape, dtype, gen),
                {"causal": True, **kw, "softcap": cap},
                f"flash: softcap {cap}, {dtype}", dtype))
    # gemma_serve's cache at every position (16 KV heads of 2 queries).
    serve_len = LM_PROMPT + LM_STEPS + 1
    cases.append(attn_compare(
        decode, d_plain, decode_inputs(LM_BATCH, 16, 2, serve_len,
                                       "bfloat16", gen), {"softcap": 50.0},
        "decode: gemma_serve's cache, every position, softcap 50",
        "bfloat16", lens_sweep=serve_len))
    # Rings of 4096 slots (gemma_check's), lens drawn below the cache.
    cases.append(attn_compare(
        decode, d_plain, decode_inputs(4, 16, 2, window, "float32", gen),
        {"softcap": 50.0}, "decode: gemma_check's ring, f32, softcap 50",
        "float32"))
    for dtype in ("bfloat16", "float16", "float32"):
        for cap in (50.0, 1.0):
            cases.append(attn_compare(
                decode, d_plain, decode_inputs(8, 4, 8, window, dtype, gen),
                {"softcap": cap},
                f"decode: lens below the cache, softcap {cap}, {dtype}",
                dtype))
    return cases


def bwd_compare(fmod, shape, dtype, gen, label, causal=True,
                window=0, softcap=None, prefix=0, sk=None) -> dict:
    """The backward kernel against `flash_attention_bwd_plain` on the same
    q, k, v, dout and the forward kernel's out and lse (softcapped where
    `softcap` is given, with the bidirectional `prefix`, both directions),
    each of dQ, dK, dV per element within BWD_TOL; lse against the plain
    forward's within LSE_TOL; a second launch gives the same bits (no
    atomics). q is `shape` (B, H, Sq, d); k and v take `sk` keys where
    given (Sq otherwise)."""
    import torch
    if sk is None:
        q, k, v, dout = attn_inputs(shape, dtype, gen) + attn_inputs(
            shape, dtype, gen)[:1]
    else:
        q, dout = attn_inputs(shape, dtype, gen)[:2]
        k, v = attn_inputs((*shape[:2], sk, shape[3]), dtype, gen)[:2]
    rtol, atol = BWD_TOL[dtype]
    with torch.no_grad():
        out, lse = fmod.flash_attention_lse_cuda(q, k, v, causal=causal,
                                                 window=window,
                                                 softcap=softcap,
                                                 prefix=prefix)
        _, lse_plain = fmod.flash_attention_plain_lse(
            q, k, v, causal=causal, window=window, softcap=softcap,
            prefix=prefix)
        got = fmod.flash_attention_bwd_cuda(q, k, v, out, dout, lse, causal,
                                            window, softcap, prefix=prefix)
        again = fmod.flash_attention_bwd_cuda(q, k, v, out, dout, lse,
                                              causal, window, softcap,
                                              prefix=prefix)
        want = fmod.flash_attention_bwd_plain(q, k, v, out, dout, lse,
                                              causal, window, softcap,
                                              prefix=prefix)
        del q, k, v, dout, out
    sync()
    lse_err = float((lse - lse_plain).abs().max())
    if not lse_err <= LSE_TOL:
        raise AssertionError(f"{label}: lse off the plain forward's by "
                             f"{lse_err} > {LSE_TOL}")
    case = {"case": label, "shape": list(shape), "sk": sk or shape[2],
            "dtype": dtype, "causal": causal, "window": window,
            "softcap": softcap, "prefix": prefix,
            "lse_max_abs_err": lse_err, "rtol": rtol,
            "atol_over_max_abs_plain": atol}
    err = 0.0
    scale = max(float(w.float().abs().max()) for w in want)
    for name, g, g2, w in zip(("dq", "dk", "dv"), got, again, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{label}: {name} {g.dtype} "
                                 f"{tuple(g.shape)}, plain {w.dtype} "
                                 f"{tuple(w.shape)}")
        if not torch.equal(g, g2):
            raise AssertionError(f"{label}: {name} differs between two "
                                 "launches")
        delta = (g.float() - w.float()).abs()
        mag = w.float().abs()
        ratio = float((delta / (rtol * mag + atol * scale)).max())
        if not ratio <= 1.0:
            raise AssertionError(f"{label}: |{name} - plain| exceeds "
                                 f"{rtol}·|plain| + {atol}·{scale} by a "
                                 f"factor {ratio} (max |Δ| "
                                 f"{float(delta.max())})")
        case[name] = {"max_abs_err": float(delta.max()),
                      "max_err_over_limit": ratio,
                      "max_abs_plain": float(mag.max())}
        err = max(err, float(delta.max()))
    case["max_abs_err"] = err
    return case


def backward_cases(fmod, gen) -> list:
    """The backward kernels at the training paths' shapes (lm_train's bf16
    microbatch on the tensor-core route, lm_train_check's f32 batch on the
    FMA route), with a window of 512, at S across the f32 kernels' 32-row
    and the 16-bit kernels' 64-row tiles, and in f16."""
    b, h, d = LM_TRAIN_BATCH, 32, 128
    cases = [bwd_compare(fmod, (b, h, LM_TRAIN_SEQ, d), "bfloat16", gen,
                         "backward: lm_train's microbatch, bf16"),
             bwd_compare(fmod, (2, h, LM_PROMPT, d), "float32", gen,
                         "backward: lm_train_check's batch, f32"),
             bwd_compare(fmod, (1, 8, 2048, d), "bfloat16", gen,
                         "backward: sliding window 512", window=512),
             bwd_compare(fmod, (2, 8, LM_TRAIN_SEQ, d), "float16", gen,
                         "backward: f16")]
    cases += [bwd_compare(fmod, (2, 8, s_len, d), "bfloat16", gen,
                          f"backward: S = {s_len}, tile edge")
              for s_len in (63, 64, 65, 127, 128, 129)]
    cases.append(bwd_compare(fmod, (2, 8, 129, d), "float32", gen,
                             "backward: S = 129, f32"))
    return cases


def backward_softcap_cases(fmod, gen) -> list:
    """The backward kernels' CAP instances: caps 50 (Gemma-2's) and 1 (it
    bites on every score) in bf16, f16 (tensor-core route) and f32 (FMA
    route), causal and in a window whose edge crosses tiles, at S across
    both routes' tiles, and at gemma_train's microbatch."""
    cases = [bwd_compare(fmod, (LM_TRAIN_BATCH, 32, LM_TRAIN_SEQ, 128),
                         "bfloat16", gen,
                         "backward: gemma_train's microbatch, softcap 50",
                         softcap=50.0)]
    for dtype in ("bfloat16", "float16", "float32"):
        for cap in (50.0, 1.0):
            cases.append(bwd_compare(fmod, (1, 8, 1000, 128), dtype, gen,
                                     f"backward: softcap {cap}, window 100, "
                                     f"{dtype}", window=100, softcap=cap))
            cases += [bwd_compare(fmod, (2, 4, s_len, 128), dtype, gen,
                                  f"backward: softcap {cap}, S = {s_len}, "
                                  f"{dtype}", softcap=cap)
                      for s_len in (63, 64, 65, 127, 128, 129)]
    return cases


def backward_d256_cases(fmod, gen) -> list:
    """The backward's d = 256 instances (each key tile's dK and dV split in
    two dim halves on the tensor-core route, NC = 16 on the FMA route) in
    bf16, f16 and f32: at rgemma_train's layer (1, 10, 4096, 256) bf16 and
    rgemma_train_check's (1, 10, 2112, 256) f32, both in RecurrentGemma's
    window of 2048, at S across both routes' tiles, in a window of 100
    whose edge crosses tiles, without the causal mask, with a prefix and at
    d = 200 (padded to 256)."""
    window = 2048
    cases = [bwd_compare(fmod, (1, 10, RGEMMA_TRAIN_SEQ, 256), "bfloat16",
                         gen, "backward: rgemma_train's layer, d = 256",
                         window=window),
             bwd_compare(fmod, (1, 10, RGEMMA_CHECK_SEQ, 256), "float32", gen,
                         "backward: rgemma_train_check's layer, d = 256, f32",
                         window=window)]
    for dtype in ("bfloat16", "float16", "float32"):
        cases += [bwd_compare(fmod, (2, 3, s_len, 256), dtype, gen,
                              f"backward: d = 256, S = {s_len}, {dtype}")
                  for s_len in (31, 33, 63, 64, 65, 129)]
        cases.append(bwd_compare(fmod, (1, 4, 1000, 256), dtype, gen,
                                 f"backward: d = 256, window 100, {dtype}",
                                 window=100))
        cases.append(bwd_compare(fmod, (1, 3, 150, 256), dtype, gen,
                                 f"backward: d = 256, not causal, {dtype}",
                                 causal=False))
        cases.append(bwd_compare(fmod, (1, 3, 300, 256), dtype, gen,
                                 f"backward: d = 256, prefix 100, {dtype}",
                                 prefix=100))
        cases.append(bwd_compare(fmod, (1, 4, 300, 200), dtype, gen,
                                 f"backward: d = 200, padded to 256, {dtype}",
                                 window=64))
    return cases


def prefix_cases(fmod, gen) -> list:
    """Both flash directions with a bidirectional prefix P (Qwen2-VL's 256
    vision positions; key j valid for query i iff j <= max(i, P - 1))
    against their plain versions: the forward at qwen_serve's prefill layer
    (1, 64, 4096, 128) bf16 and both directions at qwen_check's (2, 64,
    512, 128) f32, then P = 1, 8, 63, 64, 65, 256 and P = S (all
    bidirectional) in bf16, f16 and f32, across both routes' tiles, with a
    window and with the softcap."""
    flash, f_plain = fmod.flash_attention_cuda, fmod.flash_attention_plain
    nv = QWEN_VISION_TOKENS
    cases = [
        attn_compare(flash, f_plain,
                     attn_inputs((1, 64, LM_PREFILL, 128), "bfloat16", gen),
                     {"causal": True, "prefix": nv},
                     "flash: qwen_serve's prefill layer, prefix 256",
                     "bfloat16"),
        attn_compare(flash, f_plain,
                     attn_inputs((2, 64, QWEN_CHECK_SEQ, 128), "float32",
                                 gen), {"causal": True, "prefix": nv},
                     "flash: qwen_check's layer, prefix 256, f32", "float32"),
        bwd_compare(fmod, (2, 64, QWEN_CHECK_SEQ, 128), "float32", gen,
                    "backward: qwen_check's layer, prefix 256, f32",
                    prefix=nv),
        bwd_compare(fmod, (1, 16, LM_PREFILL, 128), "bfloat16", gen,
                    "backward: qwen's prefill layer, 16 heads, prefix 256",
                    prefix=nv)]
    for dtype in ("bfloat16", "float16", "float32"):
        for p_len in (1, 8, 63, 64, 65, nv, 300):
            cases.append(attn_compare(
                flash, f_plain, attn_inputs((2, 3, 300, 128), dtype, gen),
                {"causal": True, "prefix": p_len},
                f"flash: prefix {p_len}, S = 300", dtype))
            cases.append(bwd_compare(fmod, (2, 3, 300, 64), dtype, gen,
                                     f"backward: prefix {p_len}, S = 300, "
                                     f"{dtype}", prefix=p_len))
        cases.append(attn_compare(
            flash, f_plain, attn_inputs((1, 4, 700, 128), dtype, gen),
            {"causal": True, "prefix": 200, "window": 100},
            "flash: prefix 200 in a window of 100", dtype))
        cases.append(bwd_compare(fmod, (1, 4, 700, 128), dtype, gen,
                                 f"backward: prefix 200, window 100, {dtype}",
                                 prefix=200, window=100))
        cases.append(bwd_compare(fmod, (1, 4, 300, 128), dtype, gen,
                                 f"backward: prefix 65, softcap 50, {dtype}",
                                 prefix=65, softcap=50.0))
    return cases


def kv_inputs(shape, sk: int, dtype, gen):
    """q (B, H, Sq, d) and k, v (B, H, sk, d) from `gen`."""
    q = attn_inputs(shape, dtype, gen)[0]
    return [q] + attn_inputs((*shape[:2], sk, shape[3]), dtype, gen)[:2]


CROSS_SQ = (1, 31, 65, 512)          # cross cases: query lengths ...
CROSS_SK = (17, 64, 1000, 1024)      # ... and key lengths, every pair


def cross_cases(fmod, dmod, gen) -> list:
    """Both flash directions with a key length of their own (Sq != Sk)
    against their plain versions: non-causal (the encoder-decoder's
    cross-attention) at every pair of CROSS_SQ and CROSS_SK in bf16 at
    d = 64 and 128, a diagonal of those pairs in f16 and f32 at both, and
    one d = 256 case; causal with off = Sk - Sq > 0 (attention against a
    KV cache), with and without a window, in all three types; the
    encoder's non-causal Sq = Sk; the shapes seamless_check,
    seamless_serve and seamless_train give them; the refusals (causal
    with Sk < Sq, a prefix with Sq != Sk) before any launch; and the
    decode kernel over seamless's 1024 frames with lens = 1024, the
    decode step's cross-attention."""
    import torch
    flash, f_plain = fmod.flash_attention_cuda, fmod.flash_attention_plain
    decode, d_plain = dmod.decode_attention_cuda, dmod.decode_attention_plain
    frames, h, d = SEAMLESS_FRAMES, SEAMLESS_HEADS, SEAMLESS_HD
    cases = [
        attn_compare(flash, f_plain,
                     kv_inputs((1, h, SEAMLESS_PREFILL, d), frames,
                               "bfloat16", gen), {"causal": False},
                     "flash: seamless_serve's prefill cross-attention",
                     "bfloat16"),
        attn_compare(flash, f_plain,
                     attn_inputs((LM_BATCH, h, frames, d), "bfloat16", gen),
                     {"causal": False}, "flash: seamless_train's encoder",
                     "bfloat16"),
        attn_compare(flash, f_plain,
                     attn_inputs((2, h, frames, d), "float32", gen),
                     {"causal": False}, "flash: seamless_check's encoder, "
                     "f32", "float32"),
        attn_compare(flash, f_plain,
                     kv_inputs((2, h, SEAMLESS_CHECK_SEQ, d), frames,
                               "float32", gen), {"causal": False},
                     "flash: seamless_check's cross-attention, f32",
                     "float32"),
        bwd_compare(fmod, (LM_BATCH, h, LM_TRAIN_SEQ, d), "bfloat16", gen,
                    "backward: seamless_train's cross-attention",
                    causal=False, sk=frames),
        bwd_compare(fmod, (LM_BATCH, h, frames, d), "bfloat16", gen,
                    "backward: seamless_train's encoder", causal=False),
        bwd_compare(fmod, (2, h, SEAMLESS_CHECK_SEQ, d), "float32", gen,
                    "backward: seamless_check's cross-attention, f32",
                    causal=False, sk=frames),
        bwd_compare(fmod, (2, h, frames, d), "float32", gen,
                    "backward: seamless_check's encoder, f32",
                    causal=False)]
    diagonal = list(zip(CROSS_SQ, CROSS_SK))
    for dtype in ("bfloat16", "float16", "float32"):
        pairs = ([(sq, sk) for sq in CROSS_SQ for sk in CROSS_SK]
                 if dtype == "bfloat16" else diagonal)
        for hd in (64, 128):
            for sq, sk in pairs:
                cases.append(attn_compare(
                    flash, f_plain, kv_inputs((2, 3, sq, hd), sk, dtype, gen),
                    {"causal": False},
                    f"flash: cross Sq {sq}, Sk {sk}, d {hd}", dtype))
                cases.append(bwd_compare(
                    fmod, (2, 3, sq, hd), dtype, gen,
                    f"backward: cross Sq {sq}, Sk {sk}, d {hd}, {dtype}",
                    causal=False, sk=sk))
        for sq, sk, window in ((1, 100, 0), (64, 200, 0), (65, 1000, 0),
                               (64, 200, 50), (130, 1000, 100),
                               (7, 7, 3)):
            kw = {"causal": True, "window": window}
            cases.append(attn_compare(
                flash, f_plain, kv_inputs((2, 3, sq, 128), sk, dtype, gen),
                kw, f"flash: cache, off {sk - sq}, window {window}", dtype))
            cases.append(bwd_compare(
                fmod, (2, 3, sq, 128), dtype, gen,
                f"backward: cache, off {sk - sq}, window {window}, {dtype}",
                window=window, sk=sk))
        cases.append(attn_compare(
            flash, f_plain, kv_inputs((2, 3, 65, 256), 1000, dtype, gen),
            {"causal": False}, "flash: cross Sq 65, Sk 1000, d = 256",
            dtype))
        cases.append(bwd_compare(
            fmod, (2, 3, 65, 256), dtype, gen,
            f"backward: cross Sq 65, Sk 1000, d = 256, {dtype}",
            causal=False, sk=1000))
    # The refusals, before any launch.
    q, k, v = kv_inputs((1, 2, 64, 64), 32, "bfloat16", gen)
    before = (fmod.FLASH_LAUNCHES, fmod.FLASH_BWD_LAUNCHES)
    refused = []
    for label, call in (
            ("causal, Sk < Sq", lambda: flash(q, k, v, causal=True)),
            ("causal backward, Sk < Sq", lambda: fmod.flash_attention_bwd_cuda(
                q, k, v, q, q, torch.zeros(q.shape[:3], device=DEV), True)),
            ("prefix, Sq != Sk", lambda: flash(q, k, v, causal=False,
                                               prefix=8)),
            ("prefix, Sq != Sk, under autograd", lambda: flash(
                q.requires_grad_(), k, v, causal=True, prefix=8))):
        try:
            call()
        except ValueError as err:
            refused.append({"call": label, "error": str(err)[:120]})
        else:
            raise AssertionError(f"cross cases: {label} was not refused")
    if (fmod.FLASH_LAUNCHES, fmod.FLASH_BWD_LAUNCHES) != before:
        raise AssertionError("cross cases: a refused call launched")
    cases.append({"case": "refusals", "refused": refused})
    for dtype in ("float32", "bfloat16"):
        args = decode_inputs(LM_BATCH, h, 1, frames, dtype, gen,
                             lens=torch.full((LM_BATCH,), frames,
                                             dtype=torch.int32, device=DEV),
                             d=d)
        cases.append(attn_compare(
            decode, d_plain, args, {},
            f"decode: seamless_serve's cross step over {frames} frames",
            dtype))
    return cases


def head_dim_112_cases(fmod, dmod, gen) -> list:
    """Kimi K2's head dim 112 (64 query heads over 8 KV heads) through the
    flash and decode dispatches, padded to the 128-wide instances: bf16
    (tensor-core route) and f32 (FMA route)."""
    flash, decode = fmod.flash_attention_cuda, dmod.decode_attention_cuda
    f_plain, d_plain = fmod.flash_attention_plain, dmod.decode_attention_plain
    cases = []
    for dtype in ("bfloat16", "float32"):
        cases.append(attn_compare(flash, f_plain,
                                  attn_inputs((1, 64, 1024, 112), dtype,
                                              gen), {"causal": True},
                                  f"flash: Kimi K2's head dim 112, {dtype}",
                                  dtype))
        cases.append(attn_compare(decode, d_plain,
                                  decode_inputs(4, 8, 8, 2048, dtype, gen,
                                                d=112), {},
                                  f"decode: Kimi K2's head dim 112, {dtype}",
                                  dtype))
    return cases


def lens_at(dmod, b: int, n_kv: int, s_len: int, edges, d: int = 128):
    """lens one below, at and one above each edge (the splits' own among
    them), then 1 and s_len, cycled over the batch."""
    import torch
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    chunk, _ = dmod.split_plan(b, n_kv, s_len, n_sm, d)
    vals = list(dict.fromkeys(
        [e + o for e in (*edges, chunk, 2 * chunk) for o in (-1, 0, 1)
         if 1 <= e + o <= s_len] + [1, s_len]))
    return torch.tensor([vals[i % len(vals)] for i in range(b)],
                        dtype=torch.int32, device=DEV)


def head_dim_256_cases(fmod, dmod, gen) -> list:
    """The d = 256 instances (RecurrentGemma's head dim; 64 query rows and
    32 keys a tile on the tensor cores, 64 rows on the FMA route) against
    their plain versions in bf16, f16 and f32: flash at rgemma_serve's and
    rgemma_check's prefill layers (10 heads, window 2048), at S = 63, 64,
    65 and 129, with a window of 100 whose edge crosses tiles, and at
    d = 200 (padded to 256); decode at rgemma_serve's cache (MQA, group
    10) at every position and with lens at and around tile and split
    edges at groups 1 and 10."""
    flash, decode = fmod.flash_attention_cuda, dmod.decode_attention_cuda
    f_plain, d_plain = fmod.flash_attention_plain, dmod.decode_attention_plain
    window = 2048
    cases = [
        attn_compare(flash, f_plain,
                     attn_inputs((1, 10, RGEMMA_PREFILL, 256), "bfloat16",
                                 gen), {"causal": True, "window": window},
                     "flash: rgemma_serve's prefill layer, d = 256",
                     "bfloat16"),
        attn_compare(flash, f_plain,
                     attn_inputs((1, 10, RGEMMA_CHECK_SEQ, 256), "float32",
                                 gen), {"causal": True, "window": window},
                     "flash: rgemma_check's layer, d = 256, f32", "float32")]
    serve_len = LM_PROMPT + LM_STEPS + 1
    cases.append(attn_compare(
        decode, d_plain, decode_inputs(LM_BATCH, 1, 10, serve_len, "bfloat16",
                                       gen, d=256), {},
        "decode: rgemma_serve's cache, d = 256, every position", "bfloat16",
        lens_sweep=serve_len))
    for dtype in ("bfloat16", "float16", "float32"):
        for s_len in (63, 64, 65, 129):
            cases.append(attn_compare(
                flash, f_plain, attn_inputs((2, 3, s_len, 256), dtype, gen),
                {"causal": True}, f"flash: d = 256, S = {s_len}, tile edge",
                dtype))
        cases.append(attn_compare(
            flash, f_plain, attn_inputs((1, 4, 1000, 256), dtype, gen),
            {"causal": True, "window": 100},
            "flash: d = 256, window 100, its edge across tiles", dtype))
        cases.append(attn_compare(
            flash, f_plain, attn_inputs((1, 4, 300, 200), dtype, gen),
            {"causal": True, "window": 64}, "flash: d = 200, padded to 256",
            dtype))
        for b, group, s_len in ((12, 10, 2048), (8, 1, 1000)):
            args = decode_inputs(b, 1, group, s_len, dtype, gen, d=256,
                                 lens=lens_at(dmod, b, 1, s_len,
                                              (64, 128, 192), d=256))
            case = attn_compare(decode, d_plain, args, {},
                                f"decode: d = 256, group {group}, lens at "
                                "tile and split edges", dtype)
            case["lens"] = args[3].tolist()
            cases.append(case)
        cases.append(attn_compare(
            decode, d_plain, decode_inputs(4, 2, 5, 700, dtype, gen, d=200),
            {}, "decode: d = 200, padded to 256", dtype))
    return cases


def tile_edge_cases(fmod, dmod, gen) -> list:
    """The 16-bit (tensor-core) kernels at the edges of their 64-row tiles
    and of the decode splits, and in f16, against their plain versions."""
    import torch
    flash, decode = fmod.flash_attention_cuda, dmod.decode_attention_cuda
    f_plain, d_plain = fmod.flash_attention_plain, dmod.decode_attention_plain
    cases = [attn_compare(flash, f_plain,
                          attn_inputs((2, 8, s_len, 128), "bfloat16", gen),
                          {"causal": True}, f"flash: S = {s_len}, tile edge",
                          "bfloat16")
             for s_len in (63, 64, 65, 129)]
    cases.append(attn_compare(flash, f_plain,
                              attn_inputs((1, 8, 1000, 128), "bfloat16",
                                          gen),
                              {"causal": True, "window": 100},
                              "flash: window 100, its edge across tiles",
                              "bfloat16"))
    cases.append(attn_compare(flash, f_plain,
                              attn_inputs((1, 8, 2048, 128), "float16", gen),
                              {"causal": True}, "flash: f16", "float16"))
    tile = dmod.TILE
    for b, n_kv, group, s_len, edges, label in (
            (16, 4, 8, 4160, (tile, 2 * tile, 3 * tile),
             "splits of a few tiles"),
            (12, 4, 8, 32768, (4096,), "splits that wrap the ring"),
            (8, 8, 1, 1000, (tile,), "group 1"),
            (8, 4, 5, 1000, (tile,), "group 5"),
            (8, 2, 16, 2048, (tile,), "group 16")):
        args = decode_inputs(b, n_kv, group, s_len, "bfloat16", gen,
                             lens=lens_at(dmod, b, n_kv, s_len, edges))
        case = attn_compare(decode, d_plain, args, {},
                            f"decode: lens at tile and split edges, {label}",
                            "bfloat16")
        case["lens"] = args[3].tolist()
        cases.append(case)
    cases.append(attn_compare(decode, d_plain,
                              decode_inputs(8, 4, 8, 4096, "float16", gen),
                              {}, "decode: f16", "float16"))
    return cases


def _f64(t):
    import torch
    return t.to(torch.float64)


def _f64_norm(x, scale):
    import torch
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6) \
        * (1.0 + _f64(scale))


def _f64_cap(x, c):
    import torch
    return c * torch.tanh(x / c) if c else x


def _ckpt(on: bool, fn, *args):
    """fn(*args), through torch.utils.checkpoint where `on` (its saved
    tensors are recomputed in the backward, one call at a time)."""
    from torch.utils.checkpoint import checkpoint
    return checkpoint(fn, *args, use_reentrant=False) if on else fn(*args)


def _f64_expert(rows, wg, wu, wd):
    """One expert's SwiGLU on its rows (float64), its weights converted
    here: under `_ckpt` the float64 copies live for one call at a time."""
    import torch.nn.functional as F
    return (F.silu(rows @ _f64(wg)) * (rows @ _f64(wu))) @ _f64(wd)


def f64_moe(cfg, p, h, per_position: bool = False, routes=None,
            pinned=None, aux=None, ckpt: bool = False):
    """The top-k MoE feed-forward in float64, written from the
    architecture: the router softmax, top-k renormalised, each expert's
    assignments in (token, slot) order of which the first `cap` are kept
    (cap = max(1, int(cf·T·k/e)) rounded up to 64, T the tokens routed
    together), each kept assignment's expert output times its weight added
    to its token. Tokens route together over the whole batch, or, with
    `per_position`, one position of the batch at a time, as decode_step
    routes them. Appends each routing's (T, k) sorted expert ids to
    `routes` where given. `pinned` (T, k) expert ids of a routing of the
    batch, in slot order, take the place of float64's own picks (the port's routing of the same
    tokens, from `RouterSpy.picks`), their weights float64's probabilities
    renormalised; `routes` still records float64's own. `aux` collects the
    load-balancing loss, e·Σ(me·ce)/k of the mean probabilities and the
    picks' counts over T. Each expert converts its weights itself, under
    `ckpt` in a checkpoint."""
    import torch
    b, s, d = h.shape
    e, k = cfg.n_experts, cfg.top_k
    wr = _f64(p["w_router"])
    groups = [h[:, i:i + 1] for i in range(s)] if per_position else [h]
    outs = []
    for g in groups:
        t = g.shape[0] * g.shape[1]
        xf = g.reshape(t, d)
        probs = torch.softmax(xf @ wr, -1)
        top_e = torch.topk(probs, k, -1).indices
        if routes is not None:
            routes.append(top_e.sort(-1).values)
        if pinned is not None:
            top_e = pinned.reshape(t, k)
        top_p = probs.gather(-1, top_e)
        top_p = top_p / top_p.sum(-1, keepdim=True)
        if aux is not None:
            ce = torch.bincount(top_e.reshape(-1), minlength=e).double() / t
            aux.append(e * (probs.mean(0) * ce).sum() / k)
        cap = max(1, int(cfg.capacity_factor * t * k / e))
        cap = (cap + 63) // 64 * 64
        flat_e, flat_w = top_e.reshape(-1), top_p.reshape(-1)
        tok = torch.arange(t, device=h.device).repeat_interleave(k)
        out = torch.zeros_like(xf)
        for ex in range(e):
            idx = (flat_e == ex).nonzero()[:, 0][:cap]
            if idx.numel() == 0:
                continue
            y = _ckpt(ckpt, _f64_expert, xf[tok[idx]], p["w_gate"][ex],
                      p["w_up"][ex], p["w_down"][ex])
            out = out.index_add(0, tok[idx], y * flat_w[idx, None])
        outs.append(out.reshape(g.shape))
    return torch.cat(outs, 1)


def f64_recurrent(cfg, kind: str, p, h):
    """A recurrent block's mixer in float64 on its normed input h (B, S,
    d), written from the architectures (xLSTM's sLSTM and mLSTM, Griffin's
    RG-LRU branch with its causal conv and GeLU gate), not from the port's
    code: every recurrence stepped over time with its running stabilizer,
    where the port takes the mLSTM's parallel form and a log-depth scan for
    the RG-LRU."""
    import torch
    import torch.nn.functional as F
    b, s, d = h.shape
    w = {name: _f64(t) for name, t in p[{"rglru": "rec"}.get(kind,
                                                             kind)].items()}
    if kind == "rglru":
        gate = F.gelu(h @ w["w_branch_gate"], approximate="tanh")
        lin = F.pad(h @ w["w_branch_lin"], (0, 0, cfg.conv_width - 1, 0))
        u = sum(lin[:, i:i + s] * w["conv_w"][i]
                for i in range(cfg.conv_width)) + w["conv_b"]
        log_a = -8.0 * F.softplus(w["lambda"]) * torch.sigmoid(
            u @ w["w_rec_gate"])
        gx = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
            * u * torch.sigmoid(u @ w["w_in_gate"])
        a, state, out = torch.exp(log_a), torch.zeros_like(u[:, 0]), []
        for t in range(s):
            state = a[:, t] * state + gx[:, t]
            out.append(state)
        return (gate * torch.stack(out, 1)) @ w["w_out"]
    if kind == "slstm":
        xs = [h @ w[n] for n in ("wz", "wi_g", "wf_g", "wo_g")]
        zeros = torch.zeros((b, d), dtype=torch.float64, device=DEV)
        c, n, hh, m, out = zeros, zeros + 1.0, zeros, zeros, []
        for t in range(s):
            z, i, f, o = (x[:, t] + hh @ w[r]
                          for x, r in zip(xs, ("rz", "ri", "rf", "ro")))
            log_f = F.logsigmoid(f)
            m_new = torch.maximum(log_f + m, i)
            i_g, f_g = torch.exp(i - m_new), torch.exp(log_f + m - m_new)
            c = f_g * c + i_g * torch.tanh(z)
            n = torch.clamp_min(f_g * n + i_g, 1e-6)
            hh, m = torch.sigmoid(o) * c / n, m_new
            out.append(hh)
        return torch.stack(out, 1) @ w["wo"]
    # mLSTM: matrix memory C and normalizer n per head, stabilizer m.
    nh = cfg.n_heads
    hd = d // nh
    q, k, v = ((h @ w[n]).view(b, s, nh, hd) for n in ("wq", "wk", "wv"))
    i_pre, f_pre = h @ w["wi"], h @ w["wf"]                  # (B, S, H)
    cm = torch.zeros((b, nh, hd, hd), dtype=torch.float64, device=DEV)
    nv = torch.zeros((b, nh, hd), dtype=torch.float64, device=DEV)
    m = torch.full((b, nh), -1e30, dtype=torch.float64, device=DEV)
    out = []
    for t in range(s):
        log_f = F.logsigmoid(f_pre[:, t])
        m_new = torch.maximum(log_f + m, i_pre[:, t])
        i_g = torch.exp(i_pre[:, t] - m_new)[..., None]
        f_g = torch.exp(log_f + m - m_new)[..., None]
        cm = f_g[..., None] * cm + i_g[..., None] * (
            v[:, t, :, :, None] * k[:, t, :, None, :])
        nv = f_g * nv + i_g * k[:, t]
        qs = q[:, t] / math.sqrt(hd)
        den = torch.maximum((nv * qs).sum(-1).abs(), torch.exp(-m_new))
        out.append((cm @ qs[..., None])[..., 0] / den[..., None])
        m = m_new
    hh = torch.stack(out, 1)                                  # (B, S, H, hd)
    hh = hh * torch.rsqrt(hh.pow(2).mean(-1, keepdim=True) + 1e-6)
    return (hh.reshape(b, s, d) * (1.0 + w["gn"])) @ w["wo"]


def f64_encode(cfg, params, audio, ckpt: bool = False):
    """The encoder in float64, written from the architecture: the frames
    projected by `audio_proj`, then per layer RMSNorm, softmax attention
    over every frame (no mask, no RoPE; KV heads repeated) and a SwiGLU
    MLP, each added to the residual, then the final `enc_norm`: (B,
    frames, d). With `ckpt` each head group and MLP is checkpointed."""
    import torch
    import torch.nn.functional as F
    b, frames, _ = audio.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def heads(q, k, v):
        return torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(hd),
                             -1) @ v

    def mlp(h, wg, wu, wd):
        return (F.silu(h @ _f64(wg)) * (h @ _f64(wu))) @ _f64(wd)

    e = _f64(audio) @ _f64(params["audio_proj"])
    for p in params["enc_layers"]:
        h = _f64_norm(e, p["ln1"])
        a = p["attn"]
        q, k, v = ((h @ _f64(a[w])).view(b, frames, n, hd).transpose(1, 2)
                   for w, n in (("wq", hq), ("wk", hkv), ("wv", hkv)))
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
        o = torch.cat([_ckpt(ckpt, heads, q[:, h0:h0 + 8], k[:, h0:h0 + 8],
                             v[:, h0:h0 + 8]) for h0 in range(0, hq, 8)], 1)
        e = e + o.transpose(1, 2).reshape(b, frames, hq * hd) @ _f64(a["wo"])
        m = p["mlp"]
        e = e + _ckpt(ckpt, mlp, _f64_norm(e, p["ln2"]), m["w_gate"],
                      m["w_up"], m["w_down"])
    return _f64_norm(e, params["enc_norm"])


def f64_hidden(cfg, params, tokens, ckpt: bool = False,
               per_position: bool = False, routes=None, vision=None,
               audio=None, pinned=None, aux=None):
    """The decoder stack in float64 with plain torch ops, written from the
    architecture (RMSNorm with 1 + scale, RoPE on halves, causal softmax
    attention with KV heads repeated, within `cfg.sliding_window` on the
    local layers only, its scores softcapped by `cfg.attn_softcap`, then a
    SwiGLU MLP or the MoE of `f64_moe`; a recurrent block's mixer from
    `f64_recurrent`, then its MLP where it has one), not from the port's
    code, up to and through the final norm: (B, S, d). Under M-RoPE
    (Qwen2-VL) the angles come from each frequency slot's section of the
    (t, h, w) ids, which give the first nv = n_vision_tokens positions
    t = 0 on a grid of width int(sqrt(nv)) and text position i t = h = w =
    i - nv + 1, and key j is valid for query i iff t_j <= t_i; `vision`
    (B, nv, d) projected by `vision_proj` takes the first nv embeddings'
    place. With `audio` frames (an encoder-decoder) `f64_encode` runs
    first and every attention layer attends, after its self-attention,
    over the encoder output (RMSNorm by ln_x, q from it, k and v from the
    encoder output by `xattn`, no mask, no RoPE). Attention in groups of 8
    heads, so that no float64 temporary holds a whole layer's scores; with
    `ckpt` each head group, each MLP and each expert is checkpointed for
    the backward. `pinned` lists the MoE layers' routings to take in
    place of float64's own, one a layer, and `aux` collects their
    load-balancing losses (`f64_moe`)."""
    import torch
    import torch.nn.functional as F

    b, s = tokens.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    inv = cfg.rope_theta ** (-torch.arange(0, hd, 2, dtype=torch.float64,
                                           device=DEV) / hd)
    pos = torch.arange(s, device=DEV)
    t_ids = pos
    if cfg.mrope_sections:
        nv = cfg.n_vision_tokens
        grid_w = max(1, int(nv ** 0.5))
        vis = torch.arange(nv, device=DEV)
        text = torch.arange(1, s - nv + 1, device=DEV)
        ids = torch.stack([torch.cat([vis * 0, text]),
                           torch.cat([vis // grid_w, text]),
                           torch.cat([vis % grid_w, text])])      # (3, S)
        sec = torch.repeat_interleave(
            torch.arange(3, device=DEV),
            torch.tensor(cfg.mrope_sections, device=DEV))       # (hd/2,)
        ang = ids[sec].T.double() * inv
        t_ids = ids[0]
    else:
        ang = pos[:, None].double() * inv
    cos, sin = torch.cos(ang), torch.sin(ang)

    def rope(t):
        t1, t2 = t[..., :hd // 2], t[..., hd // 2:]
        return torch.cat([t1 * cos - t2 * sin, t1 * sin + t2 * cos], -1)

    def heads(q, k, v, valid):
        att = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        att = _f64_cap(att, cfg.attn_softcap)
        return torch.softmax(att.masked_fill(~valid, float("-inf")), -1) @ v

    def mlp(h, wg, wu, wd):
        return (F.silu(h @ _f64(wg)) * (h @ _f64(wu))) @ _f64(wd)

    causal = t_ids[None, :] <= t_ids[:, None]
    pins = iter(pinned or [])
    enc = None if audio is None else f64_encode(cfg, params, audio, ckpt)
    x = _f64(params["embed"][tokens])
    if vision is not None:
        x = torch.cat([_f64(vision) @ _f64(params["vision_proj"]),
                       x[:, cfg.n_vision_tokens:]], 1)
    for kind, p in zip(cfg.blocks(), params["layers"]):
        h = _f64_norm(x, p["ln1"])
        if kind.value not in ATTENTION_KINDS:
            x = x + f64_recurrent(cfg, kind.value, p, h)
            if "mlp" in p:
                m = p["mlp"]
                x = x + _ckpt(ckpt, mlp, _f64_norm(x, p["ln2"]),
                              m["w_gate"], m["w_up"], m["w_down"])
            continue
        a = p["attn"]
        valid = causal
        if kind.value == "local" and cfg.sliding_window:
            valid = causal & (pos[None, :] > pos[:, None] - cfg.sliding_window)
        q = rope((h @ _f64(a["wq"])).view(b, s, hq, hd).transpose(1, 2))
        k = rope((h @ _f64(a["wk"])).view(b, s, hkv, hd).transpose(1, 2))
        v = (h @ _f64(a["wv"])).view(b, s, hkv, hd).transpose(1, 2)
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
        o = torch.cat([_ckpt(ckpt, heads, q[:, h0:h0 + 8], k[:, h0:h0 + 8],
                             v[:, h0:h0 + 8], valid)
                       for h0 in range(0, hq, 8)], 1)
        x = x + o.transpose(1, 2).reshape(b, s, hq * hd) @ _f64(a["wo"])
        if enc is not None:
            xa, frames = p["xattn"], enc.shape[1]
            hx = _f64_norm(x, p["ln_x"])
            q = (hx @ _f64(xa["wq"])).view(b, s, hq, hd).transpose(1, 2)
            k, v = ((enc @ _f64(xa[w])).view(b, frames, hkv, hd).transpose(
                1, 2).repeat_interleave(hq // hkv, dim=1)
                for w in ("wk", "wv"))
            every = torch.ones((s, frames), dtype=torch.bool, device=DEV)
            o = torch.cat([_ckpt(ckpt, heads, q[:, h0:h0 + 8],
                                 k[:, h0:h0 + 8], v[:, h0:h0 + 8], every)
                           for h0 in range(0, hq, 8)], 1)
            x = x + o.transpose(1, 2).reshape(b, s, hq * hd) @ _f64(
                xa["wo"])
        h = _f64_norm(x, p["ln2"])
        if "moe" in p:
            x = x + f64_moe(cfg, p["moe"], h, per_position, routes,
                            pinned=next(pins, None), aux=aux, ckpt=ckpt)
        else:
            m = p["mlp"]
            x = x + _ckpt(ckpt, mlp, h, m["w_gate"], m["w_up"], m["w_down"])
    return _f64_norm(x, params["final_norm"])


def f64_logits(cfg, params, x):
    """The head of the float64 stack on its final-normed x, in vocabulary
    chunks (no float64 copy of the whole head), logit softcap applied."""
    import torch
    head = params["lm_head"]
    logits = torch.cat([x @ _f64(head[:, c:c + 32768])
                        for c in range(0, head.shape[1], 32768)], -1)
    return _f64_cap(logits, cfg.logit_softcap)


def f64_lm_forward(cfg, params, tokens, positions=None,
                   per_position: bool = False, routes=None, vision=None,
                   audio=None):
    """The float64 stack's logits (B, S, V), or only at `positions`."""
    x = f64_hidden(cfg, params, tokens, per_position=per_position,
                   routes=routes, vision=vision, audio=audio)
    if positions is not None:
        x = x[:, positions]
    return f64_logits(cfg, params, x)


def teacher_forced(cfg, params, tokens, positions=None, enc_out=None):
    """decode_step over every position of `tokens`, into caches of
    S positions (rings of min(window, S) slots), attending over `enc_out`
    where given (an encoder-decoder); logits (B, S, V), or only at
    `positions`."""
    import torch
    from repro_torch.models import decode_step, init_decode_state
    b, s = tokens.shape
    keep = set(range(s) if positions is None else positions)
    state = init_decode_state(cfg, b, s, device=DEV)
    out = []
    for t in range(s):
        logits, state = decode_step(cfg, params, tokens[:, t:t + 1], state,
                                    enc_out=enc_out)
        if t in keep:
            out.append(logits[:, 0])
    return torch.stack(out, dim=1)


def zero_attn_counts(fmod, dmod) -> None:
    """The attention kernels' launch counts, in all, by route, with a
    softcap, at d > 128, with a prefix, with Sq != Sk and without the
    causal mask, to 0."""
    fmod.FLASH_LAUNCHES = dmod.DECODE_LAUNCHES = 0
    fmod.FLASH_CROSS_LAUNCHES = fmod.FLASH_BWD_CROSS_LAUNCHES = 0
    fmod.FLASH_NONCAUSAL_LAUNCHES = fmod.FLASH_BWD_NONCAUSAL_LAUNCHES = 0
    fmod.FLASH_SOFTCAP_LAUNCHES = dmod.DECODE_SOFTCAP_LAUNCHES = 0
    fmod.FLASH_WIDE_LAUNCHES = dmod.DECODE_WIDE_LAUNCHES = 0
    fmod.FLASH_BWD_LAUNCHES = fmod.FLASH_BWD_SOFTCAP_LAUNCHES = 0
    fmod.FLASH_BWD_WIDE_LAUNCHES = 0
    fmod.FLASH_PREFIX_LAUNCHES = fmod.FLASH_BWD_PREFIX_LAUNCHES = 0
    for routes in (fmod.FLASH_ROUTE_LAUNCHES, dmod.DECODE_ROUTE_LAUNCHES,
                   fmod.FLASH_BWD_ROUTE_LAUNCHES, dmod.DECODE_HD_LAUNCHES,
                   dmod.DECODE_HD_SCORES_ROUTE_LAUNCHES):
        for route in routes:
            routes[route] = 0


def attn_counts(fmod, dmod) -> dict:
    return {"flash": fmod.FLASH_LAUNCHES,
            "flash_routes": dict(fmod.FLASH_ROUTE_LAUNCHES),
            "flash_softcap": fmod.FLASH_SOFTCAP_LAUNCHES,
            "flash_wide": fmod.FLASH_WIDE_LAUNCHES,
            "flash_prefix": fmod.FLASH_PREFIX_LAUNCHES,
            "flash_cross": fmod.FLASH_CROSS_LAUNCHES,
            "flash_noncausal": fmod.FLASH_NONCAUSAL_LAUNCHES,
            "flash_bwd": fmod.FLASH_BWD_LAUNCHES,
            "flash_bwd_routes": dict(fmod.FLASH_BWD_ROUTE_LAUNCHES),
            "flash_bwd_softcap": fmod.FLASH_BWD_SOFTCAP_LAUNCHES,
            "flash_bwd_wide": fmod.FLASH_BWD_WIDE_LAUNCHES,
            "flash_bwd_prefix": fmod.FLASH_BWD_PREFIX_LAUNCHES,
            "flash_bwd_cross": fmod.FLASH_BWD_CROSS_LAUNCHES,
            "flash_bwd_noncausal": fmod.FLASH_BWD_NONCAUSAL_LAUNCHES,
            "decode": dmod.DECODE_LAUNCHES,
            "decode_routes": dict(dmod.DECODE_ROUTE_LAUNCHES),
            "decode_softcap": dmod.DECODE_SOFTCAP_LAUNCHES,
            "decode_wide": dmod.DECODE_WIDE_LAUNCHES,
            "decode_scores_routes": dict(
                dmod.DECODE_HD_SCORES_ROUTE_LAUNCHES),
            **dmod.DECODE_HD_LAUNCHES}


def check_wide(label: str, counts: dict, kernel: str, wide: bool) -> None:
    """Every launch of `kernel` counted in `counts` took its d = 256
    instance (`wide`), or none did."""
    want = counts[kernel] if wide else 0
    if counts[f"{kernel}_wide"] != want:
        raise AssertionError(f"{label}: {counts[f'{kernel}_wide']} of "
                             f"{counts[kernel]} {kernel} launches at d > "
                             f"128, want {want}")


def check_prefix(label: str, counts: dict, kernel: str, on: bool) -> None:
    """Every launch of `kernel` counted in `counts` had a bidirectional
    prefix P > 0 (`on`), or none did."""
    want = counts[kernel] if on else 0
    if counts[f"{kernel}_prefix"] != want:
        raise AssertionError(f"{label}: {counts[f'{kernel}_prefix']} of "
                             f"{counts[kernel]} {kernel} launches with a "
                             f"prefix, want {want}")


def add_counts(*counts: dict) -> dict:
    """The sum of `attn_counts` dicts, by route too."""
    return {k: ({r: sum(c[k][r] for c in counts) for r in v}
                if isinstance(v, dict) else sum(c[k] for c in counts))
            for k, v in counts[0].items()}


def n_attention_layers(cfg) -> int:
    return sum(kind.value in ATTENTION_KINDS for kind in cfg.blocks())


def check_routes(label: str, counts: dict, kernel: str, route: str) -> None:
    """Every launch of `kernel` counted in `counts` took `route`."""
    routes = counts[f"{kernel}_routes"]
    if routes[route] != counts[kernel] or sum(routes.values()) != counts[
            kernel]:
        raise AssertionError(f"{label}: {kernel} launches by route {routes}, "
                             f"want all {counts[kernel]} on {route}")


def phase_lm_check(fmod, dmod, seed: int) -> dict:
    """4-layer float32 Yi-6B width: forward and teacher-forced decode
    against float64; returns the launches of each."""
    import torch
    from repro_torch.configs.yi_6b import CONFIG
    from repro_torch.models import forward, init_params

    cfg = dataclasses.replace(CONFIG, n_layers=4, dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV).manual_seed(seed + 4)
    params = init_params(cfg, gen, device=DEV)
    tokens = torch.randint(0, cfg.vocab, (2, LM_PROMPT), device=DEV,
                           generator=gen)
    with torch.inference_mode():
        zero_attn_counts(fmod, dmod)                     # forward starts
        logits, _ = forward(cfg, params, tokens)
        fwd_counts = attn_counts(fmod, dmod)             # ... and ends here
        zero_attn_counts(fmod, dmod)                     # decode starts
        dec = teacher_forced(cfg, params, tokens)
        dec_counts = attn_counts(fmod, dmod)             # ... and ends here
        sync()
        ref = f64_lm_forward(cfg, params, tokens)
    flash, decode = fwd_counts["flash"], dec_counts["decode"]
    errs = {"forward": rel_err(logits, ref), "decode": rel_err(dec, ref)}
    agree = float((dec.argmax(-1) == ref.argmax(-1)).float().mean())
    if (flash, fwd_counts["decode"], dec_counts["flash"], decode) != (
            cfg.n_layers, 0, 0, cfg.n_layers * LM_PROMPT):
        raise AssertionError(f"lm_check launches: forward {fwd_counts}, "
                             f"decode {dec_counts}; want flash "
                             f"{cfg.n_layers}, decode "
                             f"{cfg.n_layers * LM_PROMPT}")
    check_routes("lm_check forward", fwd_counts, "flash", "f32_fma")
    check_routes("lm_check decode", dec_counts, "decode", "f32_fma")
    check_softcap("lm_check forward", fwd_counts, "flash", False)
    check_softcap("lm_check decode", dec_counts, "decode", False)
    bad = {k: e for k, e in errs.items() if not e <= LM_REL_TOL}
    if bad:
        raise AssertionError(f"lm_check: relative error above {LM_REL_TOL}: "
                             f"{bad}")
    emit({"phase": "lm_check", "config": "yi-6b width, 4 layers, float32",
          "batch": 2, "tokens": LM_PROMPT,
          "rel_err_vs_float64": errs, "tol": LM_REL_TOL,
          "argmax_agreement_decode_vs_float64": agree,
          "flash_launches": flash, "decode_launches": decode,
          "launches_by_route": {"flash": fwd_counts["flash_routes"],
                                "decode": dec_counts["decode_routes"]},
          "peak_allocated_bytes": torch.cuda.max_memory_allocated()})
    del params, logits, dec, ref
    torch.cuda.empty_cache()
    return {"flash": flash, "decode": decode,
            "flash_routes": fwd_counts["flash_routes"],
            "decode_routes": dec_counts["decode_routes"],
            "flash_softcap": 0, "decode_softcap": 0}


def profile_decode(cfg, params, enc_out=None) -> dict:
    """torch.profiler over PROFILED_STEPS decode steps at serve's batch
    (outside the counted runs): kernels launched and device busy time per
    step, from the trace's device events; the busy share of wall time
    needs the unprofiled step time beside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import decode_step, init_decode_state
    state = init_decode_state(cfg, LM_BATCH, LM_PROMPT + LM_STEPS + 1,
                              device=DEV)
    tok = torch.zeros((LM_BATCH, 1), dtype=torch.long, device=DEV)
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_STEPS):
            _, state = decode_step(cfg, params, tok, state, enc_out=enc_out)
        sync()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"steps": PROFILED_STEPS,
            "kernels_per_step": len(kernels) / PROFILED_STEPS,
            "device_busy_ms_per_step": busy_us / 1e3 / PROFILED_STEPS,
            "top_kernels_ms_per_step": {
                name[:80]: us / 1e3 / PROFILED_STEPS for name, us in top}}


def check_softcap(label: str, counts: dict, kernel: str, capped: bool
                  ) -> None:
    """Every launch of `kernel` counted in `counts` took the softcap
    (`capped`), or none did."""
    want = counts[kernel] if capped else 0
    if counts[f"{kernel}_softcap"] != want:
        raise AssertionError(f"{label}: {counts[f'{kernel}_softcap']} of "
                             f"{counts[kernel]} {kernel} launches with a "
                             f"softcap, want {want}")


def profile_prefill(cfg, params, seq, vision=None, audio=None) -> dict:
    """torch.profiler over one more `forward` of `seq` (outside the counted
    run): the device's busy time, from the trace's device events, and the
    flash kernel's share of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import forward
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        forward(cfg, params, seq, vision_embeds=vision, audio_embeds=audio)
        sync()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    flash_us = sum(e.time_range.elapsed_us() for e in kernels
                   if "flash_attn_kernel" in e.name)
    return {"kernels": len(kernels), "device_busy_ms": busy_us / 1e3,
            "flash_ms": flash_us / 1e3}


def serve_phase(fmod, dmod, seed: int, arch: str, prefill: int,
                label: str, n_layers: int = 0,
                profiled_tokens: int = 0) -> dict:
    """The bf16 `arch` (cut to `n_layers` where given): serve, a prefill
    forward of `prefill` tokens, and decode against the forward; returns
    the launches of each path, one per attention layer (none for an
    attention-free stack). Every attention launch on the tensor-core
    route, with the softcap exactly where the config sets one, and at
    d = 256 exactly where the config's head dim exceeds 128. For an
    MoE config the routers' picks are recorded in the forward and the
    cross-check: the positions before the first whose experts differ in
    any layer are held to LM_BF16_TOL, the rest counted and reported
    (MOE_FLIP_RULE). A vision config's prefill takes n_vision_tokens
    embeddings from --seed and every flash launch has that prefix; its
    decode is held to a forward without M-RoPE and the prefix
    (QWEN_DECODE_RULE). The profiled prefill takes the first
    `profiled_tokens` of the sequence where given (all of it otherwise)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import (
        decode_step, forward, init_decode_state, init_params, param_count,
    )

    cfg = get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    capped = cfg.attn_softcap is not None
    wide = cfg.hd > 128
    vision_prefix = cfg.n_vision_tokens > 0
    n_attn = n_attention_layers(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(seed),
                         device=DEV)
    sync()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab, size=(LM_BATCH, LM_PROMPT),
                           dtype=np.int32)
    with torch.inference_mode():                     # warm-up, not counted
        decode_step(cfg, params, torch.zeros((LM_BATCH, 1), dtype=torch.long,
                                             device=DEV),
                    init_decode_state(cfg, LM_BATCH, 2, device=DEV))
    sync()

    zero_attn_counts(fmod, dmod)                     # serve starts here
    t0 = time.perf_counter()
    tokens = serve(cfg, params, prompts, steps=LM_STEPS)
    sync()
    serve_s = time.perf_counter() - t0
    serve_counts = attn_counts(fmod, dmod)           # ... and ends here
    serve_launches = {"flash": serve_counts["flash"],
                      "decode": serve_counts["decode"]}
    serve_peak = torch.cuda.max_memory_allocated()
    want = n_attn * (LM_PROMPT + LM_STEPS)
    if serve_launches != {"flash": 0, "decode": want}:
        raise AssertionError(f"serve launches {serve_launches}, want decode "
                             f"{want}")
    check_routes(f"{label} serve", serve_counts, "decode", "tensor_core")
    check_softcap(f"{label} serve", serve_counts, "decode", capped)
    check_wide(f"{label} serve", serve_counts, "decode", wide)
    if tokens.shape != (LM_BATCH, LM_STEPS) or not (
            (tokens >= 0) & (tokens < cfg.vocab)).all():
        raise AssertionError(f"serve tokens {tokens.shape} out of range")

    profile = profile_decode(cfg, params)

    seq = np.concatenate([prompts[:1], rng.integers(
        0, cfg.vocab, size=(1, prefill - LM_PROMPT), dtype=np.int32)], 1)
    seq = torch.from_numpy(seq).long().to(DEV)
    vision = qwen_vision(cfg, 1, torch.Generator(device=DEV).manual_seed(
        seed + 12)) if vision_prefix else None
    torch.cuda.reset_peak_memory_stats()
    fwd_spy, dec_spy = RouterSpy(cfg.is_moe), RouterSpy(cfg.is_moe)
    with torch.inference_mode():
        zero_attn_counts(fmod, dmod)                     # prefill starts
        sync()
        t0 = time.perf_counter()
        with fwd_spy:
            logits, _ = forward(cfg, params, seq, vision_embeds=vision)
        sync()
        prefill_s = time.perf_counter() - t0
        prefill_counts = attn_counts(fmod, dmod)         # ... and ends here
        prefill_flash = prefill_counts["flash"]
        prefill_peak = torch.cuda.max_memory_allocated()
        if prefill_flash != n_attn or prefill_counts["decode"] != 0:
            raise AssertionError(f"prefill flash launches {prefill_flash}, "
                                 f"want {n_attn}")
        check_routes(f"{label} prefill", prefill_counts, "flash",
                     "tensor_core")
        check_softcap(f"{label} prefill", prefill_counts, "flash", capped)
        check_wide(f"{label} prefill", prefill_counts, "flash", wide)
        check_prefix(f"{label} prefill", prefill_counts, "flash",
                     vision_prefix)
        if logits.shape != (1, prefill, cfg.vocab) or not torch.isfinite(
                logits).all():
            raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                                 "not finite")
        fwd = logits[:, :LM_PROMPT].clone()
        del logits
        reference_forward = None
        if vision_prefix:                # QWEN_DECODE_RULE's forward
            plain = dataclasses.replace(cfg, mrope_sections=None,
                                        n_vision_tokens=0)
            zero_attn_counts(fmod, dmod)
            fwd = forward(plain, params, seq[:, :LM_PROMPT])[0]
            reference_forward = attn_counts(fmod, dmod)
            if reference_forward["flash"] != n_attn:
                raise AssertionError(f"{label} reference forward launches "
                                     f"{reference_forward}")
            check_prefix(f"{label} reference forward", reference_forward,
                         "flash", False)
    prefill_profile = profile_prefill(cfg, params,
                                      seq[:, :profiled_tokens or prefill],
                                      vision)
    prefill_profile["tokens"] = profiled_tokens or prefill
    with torch.inference_mode():
        zero_attn_counts(fmod, dmod)                 # cross-check starts
        with dec_spy:
            dec = teacher_forced(cfg, params, seq[:, :LM_PROMPT])
        cross_counts = attn_counts(fmod, dmod)       # ... and ends here
        cross_decode = cross_counts["decode"]
    gap = rel_err(dec, fwd)
    agree = float((dec.argmax(-1) == fwd.argmax(-1)).float().mean())
    if cross_decode != n_attn * LM_PROMPT:
        raise AssertionError(f"cross-check decode launches {cross_decode}")
    check_routes(f"{label} cross-check", cross_counts, "decode",
                 "tensor_core")
    check_softcap(f"{label} cross-check", cross_counts, "decode", capped)
    check_wide(f"{label} cross-check", cross_counts, "decode", wide)
    held, routing = gap, None
    if cfg.is_moe:
        # Decode step t, layer l is call t·L + l; the forward's call l
        # holds every position of layer l.
        n = cfg.n_layers
        flipped = torch.zeros(LM_PROMPT, dtype=torch.bool, device=DEV)
        for li in range(n):
            dec_l = torch.cat([dec_spy.routes[t * n + li]
                               for t in range(LM_PROMPT)])
            flipped |= (dec_l != fwd_spy.routes[li][:LM_PROMPT]).any(-1)
        first = int(flipped.nonzero()[0, 0]) if flipped.any() else LM_PROMPT
        held = rel_err(dec[:, :first], fwd[:, :first]) if first else 0.0
        same = (~flipped).nonzero()[:, 0]
        routing = {"positions_with_other_experts": int(flipped.sum()),
                   "of_positions": LM_PROMPT,
                   "first_position_with_other_experts": first,
                   "rel_gap_before_it": held,
                   "rel_gap_same_experts": rel_err(dec[:, same],
                                                   fwd[:, same]),
                   "rel_gap_other_experts": rel_err(dec[:, flipped],
                                                    fwd[:, flipped])
                   if flipped.any() else None,
                   "forward_dropped_assignments": [
                       dropped(cfg, r) for r in fwd_spy.routes],
                   "rule": MOE_FLIP_RULE}
    by_position = None
    if cfg.name.startswith("xlstm"):
        # XLSTM_BF16_RULE: position 0 alone, before any recurrent state.
        held = rel_err(dec[:, :1], fwd[:, :1])
        by_position = {"rel_gap_position_0": held,
                   "rel_gap_by_position": {
                       t: rel_err(dec[:, t:t + 1], fwd[:, t:t + 1])
                       for t in (1, 2, 4, 8, 16, 32, 64, LM_PROMPT - 1)
                       if t < LM_PROMPT},
                   "rule": XLSTM_BF16_RULE}
    if not held <= LM_BF16_TOL or not torch.isfinite(dec).all():
        raise AssertionError(f"decode vs forward logits: relative gap {held} "
                             f"> {LM_BF16_TOL} (routing {routing}, "
                             f"{by_position})")
    emit({"phase": label, "config": cfg.name, "dtype": cfg.dtype,
          "layers": cfg.n_layers, "attention_layers": n_attn,
          "head_dim": cfg.hd, "params": param_count(params),
          "init_s": init_s, "attn_softcap": cfg.attn_softcap,
          "sliding_window": cfg.sliding_window,
          "serve": {"batch": LM_BATCH, "prompt": LM_PROMPT,
                    "steps": LM_STEPS, "seconds": serve_s,
                    "generated_tokens_per_s": LM_BATCH * LM_STEPS / serve_s,
                    "processed_tokens_per_s":
                        LM_BATCH * (LM_PROMPT + LM_STEPS) / serve_s,
                    "ms_per_decode_step":
                        1e3 * serve_s / (LM_PROMPT + LM_STEPS),
                    "launches": serve_launches,
                    "decode_launches_by_route":
                        serve_counts["decode_routes"],
                    "decode_softcap_launches": serve_counts["decode_softcap"],
                    "decode_d256_launches": serve_counts["decode_wide"],
                    "peak_allocated_bytes": serve_peak,
                    "first_tokens": tokens[:, :8].tolist(),
                    "profiled_decode_steps": profile},
          "prefill": {"tokens": prefill, "seconds": prefill_s,
                      "tokens_per_s": prefill / prefill_s,
                      "flash_launches": prefill_flash,
                      "flash_launches_by_route":
                          prefill_counts["flash_routes"],
                      "flash_softcap_launches":
                          prefill_counts["flash_softcap"],
                      "flash_d256_launches": prefill_counts["flash_wide"],
                      "flash_prefix_launches": prefill_counts["flash_prefix"],
                      "vision_tokens": cfg.n_vision_tokens,
                      "peak_allocated_bytes": prefill_peak,
                      "profiled": prefill_profile},
          "decode_vs_forward": {"positions": LM_PROMPT,
                                "rel_gap": gap, "tol": LM_BF16_TOL,
                                "argmax_agreement": agree,
                                "moe_routing": routing,
                                "xlstm_positions": by_position,
                                "vision_rule": QWEN_DECODE_RULE
                                if vision_prefix else None,
                                "reference_forward_flash_launches":
                                    reference_forward and
                                    reference_forward["flash"],
                                "decode_launches": cross_decode},
          "idle_share_decode": 1.0 - profile["device_busy_ms_per_step"]
          / (1e3 * serve_s / (LM_PROMPT + LM_STEPS))})
    del params, dec, fwd
    torch.cuda.empty_cache()
    return {"flash": prefill_flash, "decode": serve_launches["decode"],
            "decode_crosscheck": cross_decode,
            "flash_routes": {r: n + (reference_forward["flash_routes"][r]
                                     if reference_forward else 0)
                             for r, n in prefill_counts["flash_routes"].items()},
            "decode_routes": {r: serve_counts["decode_routes"][r]
                              + cross_counts["decode_routes"][r]
                              for r in serve_counts["decode_routes"]},
            "flash_softcap": prefill_counts["flash_softcap"],
            "decode_softcap": serve_counts["decode_softcap"]
            + cross_counts["decode_softcap"],
            "flash_wide": prefill_counts["flash_wide"],
            "flash_prefix": prefill_counts["flash_prefix"],
            "flash_reference_forward": reference_forward["flash"]
            if reference_forward else 0,
            "decode_wide": serve_counts["decode_wide"]
            + cross_counts["decode_wide"]}


def phase_lm_serve(fmod, dmod, seed: int) -> dict:
    """Full Yi-6B in bf16: serve, a 4096-token prefill forward, and decode
    against the forward, no launch with a softcap."""
    return serve_phase(fmod, dmod, seed, "yi_6b", LM_PREFILL, "lm_serve")


def phase_gemma_check(fmod, dmod, seed: int) -> dict:
    """Gemma-2 27B's published widths cut to 2 layers (local, then global),
    float32: `forward` on one sequence of GEMMA_CHECK_SEQ tokens, past the
    local layer's window, and teacher-forced `decode_step`, whose ring
    wraps after position 4095, both against the script's own float64
    forward at GEMMA_POSITIONS (before the wrap and the last 64); every
    launch on the f32 FMA route with the softcap. Returns the launches."""
    import torch
    from repro_torch.configs.gemma2_27b import CONFIG
    from repro_torch.models import forward, init_params, param_count

    cfg = dataclasses.replace(CONFIG, n_layers=2, dtype="float32")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV).manual_seed(seed + 8)
    params = init_params(cfg, gen, device=DEV)
    tokens = torch.randint(0, cfg.vocab, (1, GEMMA_CHECK_SEQ), device=DEV,
                           generator=gen)
    with torch.inference_mode():
        zero_attn_counts(fmod, dmod)                     # forward starts
        logits, _ = forward(cfg, params, tokens)
        fwd_counts = attn_counts(fmod, dmod)             # ... and ends here
        finite = bool(torch.isfinite(logits).all())
        fwd = logits[:, GEMMA_POSITIONS].clone()
        del logits
        zero_attn_counts(fmod, dmod)                     # decode starts
        t0 = time.perf_counter()
        dec = teacher_forced(cfg, params, tokens, GEMMA_POSITIONS)
        sync()
        decode_s = time.perf_counter() - t0
        dec_counts = attn_counts(fmod, dmod)             # ... and ends here
        ref = f64_lm_forward(cfg, params, tokens, GEMMA_POSITIONS)
    wrap = cfg.sliding_window
    before = [i for i, t in enumerate(GEMMA_POSITIONS) if t < wrap]
    after = [i for i, t in enumerate(GEMMA_POSITIONS) if t >= wrap]
    errs = {"forward": rel_err(fwd, ref), "decode": rel_err(dec, ref),
            "decode_before_wrap": rel_err(dec[:, before], ref[:, before]),
            "decode_after_wrap": rel_err(dec[:, after], ref[:, after]),
            "decode_vs_forward": rel_err(dec, fwd)}
    agree = float((dec.argmax(-1) == ref.argmax(-1)).float().mean())
    flash, decode = fwd_counts["flash"], dec_counts["decode"]
    if not finite:
        raise AssertionError("gemma_check: forward logits not finite")
    if (flash, fwd_counts["decode"], dec_counts["flash"], decode) != (
            cfg.n_layers, 0, 0, cfg.n_layers * GEMMA_CHECK_SEQ):
        raise AssertionError(f"gemma_check launches: forward {fwd_counts}, "
                             f"decode {dec_counts}; want flash "
                             f"{cfg.n_layers}, decode "
                             f"{cfg.n_layers * GEMMA_CHECK_SEQ}")
    check_routes("gemma_check forward", fwd_counts, "flash", "f32_fma")
    check_routes("gemma_check decode", dec_counts, "decode", "f32_fma")
    check_softcap("gemma_check forward", fwd_counts, "flash", True)
    check_softcap("gemma_check decode", dec_counts, "decode", True)
    bad = {k: e for k, e in errs.items() if not e <= LM_REL_TOL}
    if bad:
        raise AssertionError(f"gemma_check: relative error above "
                             f"{LM_REL_TOL}: {bad}")
    emit({"phase": "gemma_check", "config": "gemma2-27b width, 2 layers "
          "(local, global), float32", "params": param_count(params),
          "tokens": GEMMA_CHECK_SEQ, "window": cfg.sliding_window,
          "attn_softcap": cfg.attn_softcap,
          "logit_softcap": cfg.logit_softcap,
          "compared_positions": GEMMA_POSITIONS,
          "rel_err_vs_float64": errs, "tol": LM_REL_TOL,
          "argmax_agreement_decode_vs_float64": agree,
          "decode_seconds": decode_s,
          "flash_launches": flash, "decode_launches": decode,
          "launches_by_route": {"flash": fwd_counts["flash_routes"],
                                "decode": dec_counts["decode_routes"]},
          "softcap_launches": {"flash": fwd_counts["flash_softcap"],
                               "decode": dec_counts["decode_softcap"]},
          "peak_allocated_bytes": torch.cuda.max_memory_allocated()})
    del params, fwd, dec, ref
    torch.cuda.empty_cache()
    return {"flash": flash, "decode": decode,
            "flash_routes": fwd_counts["flash_routes"],
            "decode_routes": dec_counts["decode_routes"],
            "flash_softcap": fwd_counts["flash_softcap"],
            "decode_softcap": dec_counts["decode_softcap"]}


class RouterSpy:
    """While active (and `on`), records for each call of the port's
    `moe_ffn` the (T, k) expert ids its router picks, in slot order
    (`picks`) and sorted (`routes`), and the call's aux loss (`aux`,
    detached): the router recomputed from the call's inputs with the same
    ops and the same tie order, a stable sort (no attention kernel, so the
    launch counts are untouched)."""

    def __init__(self, on: bool = True):
        self.on, self.routes, self.picks, self.aux = on, [], [], []

    def __enter__(self):
        from repro_torch.models import layers
        self._layers, self._orig = layers, layers.moe_ffn
        if not self.on:
            return self

        def spy(cfg, p, x, mesh_axes=None):
            import torch
            with torch.no_grad():
                logits = x.reshape(-1, x.shape[-1]) @ p["w_router"]
                top = torch.sort(torch.softmax(logits.float(), -1),
                                 dim=-1, descending=True,
                                 stable=True).indices[:, :cfg.top_k]
                self.picks.append(top)
                self.routes.append(top.sort(-1).values)
            out = self._orig(cfg, p, x, mesh_axes)
            self.aux.append(out[1].detach())
            return out

        layers.moe_ffn = spy
        return self

    def __exit__(self, *exc):
        self._layers.moe_ffn = self._orig


def picks_unlike(ours, theirs) -> int:
    """Tokens whose sorted (T, k) picks differ between two routings."""
    return sum(int((a != b).any(-1).sum()) for a, b in zip(ours, theirs))


def dropped(cfg, routes) -> int:
    """Assignments past the capacity for one routing of T tokens ((T, k)
    expert ids): the reference's cap, max(1, int(cf·T·k/e)) rounded up to
    a multiple of 64, against each expert's count."""
    import torch
    t, k, e = routes.shape[0], cfg.top_k, cfg.n_experts
    cap = max(1, int(cfg.capacity_factor * t * k / e))
    cap = (cap + 63) // 64 * 64
    counts = torch.bincount(routes.reshape(-1), minlength=e)
    return int((counts - cap).clamp_min(0).sum())


def phase_gemma_serve(fmod, dmod, seed: int) -> dict:
    """Full Gemma-2 27B in bf16 (46 layers, 56.8 GB of weights): serve,
    an 8192-token prefill forward whose window bites in the 23 local
    layers, and decode against the forward, every launch softcapped."""
    return serve_phase(fmod, dmod, seed, "gemma2_27b", GEMMA_PREFILL,
                       "gemma_serve")


def recurrent_check(fmod, dmod, seed: int, label: str, cfg, batch: int,
                    seq: int, positions=None) -> dict:
    """`cfg` (float32) on `batch` sequences of `seq` tokens: `forward` and
    teacher-forced `decode_step` against the script's own float64 forward,
    at `positions` (every one when None) within LM_REL_TOL; each attention
    layer launches the flash kernel once and the decode kernel once a
    position, on the f32 FMA route, at d = 256 where cfg.hd > 128, none
    softcapped. Returns the launches."""
    import torch
    from repro_torch.models import forward, init_params, param_count

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV).manual_seed(seed + 9)
    params = init_params(cfg, gen, device=DEV)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), device=DEV,
                           generator=gen)
    keep = list(range(seq)) if positions is None else positions
    with torch.inference_mode():
        zero_attn_counts(fmod, dmod)                     # forward starts
        logits, _ = forward(cfg, params, tokens)
        fwd_counts = attn_counts(fmod, dmod)             # ... and ends here
        finite = bool(torch.isfinite(logits).all())
        fwd = logits[:, keep].clone()
        del logits
        zero_attn_counts(fmod, dmod)                     # decode starts
        t0 = time.perf_counter()
        dec = teacher_forced(cfg, params, tokens, positions)
        sync()
        decode_s = time.perf_counter() - t0
        dec_counts = attn_counts(fmod, dmod)             # ... and ends here
        ref = f64_lm_forward(cfg, params, tokens, positions)
    errs = {"forward": rel_err(fwd, ref), "decode": rel_err(dec, ref),
            "decode_vs_forward": rel_err(dec, fwd)}
    window = cfg.sliding_window
    if window and positions is not None:
        before = [i for i, t in enumerate(positions) if t < window]
        after = [i for i, t in enumerate(positions) if t >= window]
        errs["decode_before_wrap"] = rel_err(dec[:, before], ref[:, before])
        errs["decode_after_wrap"] = rel_err(dec[:, after], ref[:, after])
    agree = float((dec.argmax(-1) == ref.argmax(-1)).float().mean())
    n_attn = n_attention_layers(cfg)
    flash, decode = fwd_counts["flash"], dec_counts["decode"]
    if not finite:
        raise AssertionError(f"{label}: forward logits not finite")
    if (flash, fwd_counts["decode"], dec_counts["flash"], decode) != (
            n_attn, 0, 0, n_attn * seq):
        raise AssertionError(f"{label} launches: forward {fwd_counts}, "
                             f"decode {dec_counts}; want flash {n_attn}, "
                             f"decode {n_attn * seq}")
    for path, counts, kernel in (("forward", fwd_counts, "flash"),
                                 ("decode", dec_counts, "decode")):
        check_routes(f"{label} {path}", counts, kernel, "f32_fma")
        check_softcap(f"{label} {path}", counts, kernel, False)
        check_wide(f"{label} {path}", counts, kernel, cfg.hd > 128)
    bad = {k: e for k, e in errs.items() if not e <= LM_REL_TOL}
    if bad:
        raise AssertionError(f"{label}: relative error above {LM_REL_TOL}: "
                             f"{bad}")
    emit({"phase": label, "config": f"{cfg.name} width, {cfg.n_layers} "
          f"layers {[k.value for k in cfg.blocks()]}, float32",
          "params": param_count(params), "batch": batch, "tokens": seq,
          "window": window, "head_dim": cfg.hd,
          "compared_positions": "all" if positions is None else positions,
          "rel_err_vs_float64": errs, "tol": LM_REL_TOL,
          "argmax_agreement_decode_vs_float64": agree,
          "decode_seconds": decode_s,
          "flash_launches": flash, "decode_launches": decode,
          "launches_by_route": {"flash": fwd_counts["flash_routes"],
                                "decode": dec_counts["decode_routes"]},
          "d256_launches": {"flash": fwd_counts["flash_wide"],
                            "decode": dec_counts["decode_wide"]},
          "peak_allocated_bytes": torch.cuda.max_memory_allocated()})
    del params, fwd, dec, ref
    torch.cuda.empty_cache()
    return {"flash": flash, "decode": decode,
            "flash_routes": fwd_counts["flash_routes"],
            "decode_routes": dec_counts["decode_routes"],
            "flash_softcap": 0, "decode_softcap": 0,
            "flash_wide": fwd_counts["flash_wide"],
            "decode_wide": dec_counts["decode_wide"]}


def phase_rgemma_check(fmod, dmod, seed: int) -> dict:
    """RecurrentGemma-2B's published widths cut to 2 float32 layers, an
    RG-LRU then a local attention layer (its own pattern cycles rglru,
    rglru, local, whose first two layers hold no attention): one sequence
    of RGEMMA_CHECK_SEQ tokens past the window of 2048, whose ring wraps
    in the decode; the attention at d = 256 on the f32 FMA route."""
    from repro_torch.configs.recurrentgemma_2b import CONFIG
    cfg = dataclasses.replace(CONFIG, n_layers=2, dtype="float32",
                              block_pattern=("rglru", "local"))
    return recurrent_check(fmod, dmod, seed, "rgemma_check", cfg, 1,
                           RGEMMA_CHECK_SEQ, RGEMMA_POSITIONS)


def phase_xlstm_check(fmod, dmod, seed: int) -> dict:
    """xLSTM-125M's published widths cut to 2 float32 layers, an sLSTM then
    an mLSTM, batch 2 x 128 at every position; no attention launch."""
    from repro_torch.configs.xlstm_125m import CONFIG
    cfg = dataclasses.replace(CONFIG, n_layers=2, dtype="float32",
                              block_pattern=("slstm", "mlstm"))
    return recurrent_check(fmod, dmod, seed, "xlstm_check", cfg, 2,
                           LM_PROMPT)


def phase_rgemma_serve(fmod, dmod, seed: int) -> dict:
    """Full RecurrentGemma-2B in bf16 (26 layers, 7.1 GB of weights):
    serve, a 4096-token prefill forward whose window bites in the 8 local
    layers, and decode against the forward, every launch at d = 256."""
    return serve_phase(fmod, dmod, seed, "recurrentgemma_2b", RGEMMA_PREFILL,
                       "rgemma_serve")


def phase_xlstm_serve(fmod, dmod, seed: int) -> dict:
    """Full xLSTM-125M in bf16 (12 layers): serve, a 2048-token prefill
    forward and decode against the forward (XLSTM_BF16_RULE), no attention
    launch. The profiler traces a prefill of 256 tokens: the full one
    launches about 191,000 kernels (the sLSTM's loop), whose trace alone
    took most of a minute."""
    return serve_phase(fmod, dmod, seed, "xlstm_125m", XLSTM_PREFILL,
                       "xlstm_serve", profiled_tokens=256)


def f64_lm_loss(cfg, params, tokens, labels, ckpt: bool = False,
                vision=None, audio=None, pinned=None, routes=None):
    """Mean next-token NLL of `f64_lm_forward`, in float64, plus 0.01 ×
    the MoE layers' load-balancing losses, as the reference's loss adds
    them (0 for other stacks). `pinned` and `routes` go to `f64_hidden`:
    the MoE layers route as the port routed, and float64's own picks are
    recorded. With `ckpt` the head and loss run in checkpointed chunks
    of 520 tokens, so that the backward holds one chunk's float64 logits
    at a time, and `f64_hidden` checkpoints its head groups, MLPs and
    experts."""
    import torch

    def nll_sum(x, lbl):
        logits = f64_logits(cfg, params, x)
        gold = torch.gather(logits, -1, lbl.long()[..., None])[..., 0]
        return (torch.logsumexp(logits, -1) - gold).sum()

    aux = []
    x = f64_hidden(cfg, params, tokens, ckpt=ckpt, vision=vision,
                   audio=audio, pinned=pinned, routes=routes, aux=aux)
    if not ckpt:
        nll = nll_sum(x, labels) / labels.numel()
    else:
        nll = sum(_ckpt(True, nll_sum, x[:, c:c + 520], labels[:, c:c + 520])
                  for c in range(0, tokens.shape[1], 520)) / labels.numel()
    return nll + 0.01 * sum(aux) if aux else nll


def phase_lm_train_check(fmod, dmod, seed: int) -> dict:
    """lm_check's 4-layer float32 Yi-6B-width model and batch, without
    remat: the gradients of `lm_loss` for every parameter through the
    kernels (flash forward and backward, f32 FMA routes) against float64
    autograd of the script's own forward; returns the launches."""
    import torch
    from repro_torch.configs.yi_6b import CONFIG
    from repro_torch.models import init_params, lm_loss
    from repro_torch.train.optim import tree_leaves, tree_map

    cfg = dataclasses.replace(CONFIG, n_layers=4, dtype="float32",
                              remat=False)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV).manual_seed(seed + 4)  # lm_check's
    params = init_params(cfg, gen, device=DEV)
    tokens = torch.randint(0, cfg.vocab, (2, LM_PROMPT), device=DEV,
                           generator=gen)
    labels = torch.roll(tokens, -1, 1)
    live = tree_map(lambda t: t.requires_grad_(True), params)
    sync()
    zero_attn_counts(fmod, dmod)                     # the step starts
    t0 = time.perf_counter()
    loss = lm_loss(cfg, live, tokens, labels)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    sync()
    seconds = time.perf_counter() - t0
    counts = attn_counts(fmod, dmod)                 # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    live64 = tree_map(lambda t: t.detach().double().requires_grad_(True),
                      params)
    loss64 = f64_lm_loss(cfg, live64, tokens, labels)
    grads64 = torch.autograd.grad(loss64, tree_leaves(live64))
    # max |Δ| over the largest |g64|, on the card (the embedding and head
    # gradients are 262M entries each).
    errs = {name: float((g.double() - g64).abs().max())
            / max(float(g64.abs().max()), 1e-30)
            for name, g, g64 in zip(_leaf_names(params), grads, grads64)}
    if (counts["flash"], counts["flash_bwd"], counts["decode"]) != (
            cfg.n_layers, cfg.n_layers, 0):
        raise AssertionError(f"lm_train_check launches {counts}; want flash "
                             f"{cfg.n_layers}, backward {cfg.n_layers}")
    check_routes("lm_train_check forward", counts, "flash", "f32_fma")
    check_routes("lm_train_check backward", counts, "flash_bwd", "f32_fma")
    loss_err = abs(float(loss.detach()) - float(loss64.detach()))
    worst = max(errs, key=errs.get)
    if not errs[worst] <= LM_GRAD_REL_TOL or not loss_err <= LM_REL_TOL * \
            abs(float(loss64.detach())):
        raise AssertionError(f"lm_train_check: {worst} relative error "
                             f"{errs[worst]} > {LM_GRAD_REL_TOL} or loss off "
                             f"by {loss_err}")
    emit({"phase": "lm_train_check",
          "config": "yi-6b width, 4 layers, float32, no remat",
          "batch": 2, "tokens": LM_PROMPT, "loss": float(loss),
          "loss_float64": float(loss64), "seconds_fwd_bwd": seconds,
          "grad_rel_err_vs_float64": errs, "worst": worst,
          "tol": LM_GRAD_REL_TOL,
          "flash_launches": counts["flash"],
          "flash_bwd_launches": counts["flash_bwd"],
          "launches_by_route": {"flash": counts["flash_routes"],
                                "flash_bwd": counts["flash_bwd_routes"]},
          "peak_allocated_bytes": peak})
    del params, live, grads, live64, grads64
    torch.cuda.empty_cache()
    return counts


def _leaf_names(tree, prefix="") -> list:
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in _leaf_names(v, f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def train_batches(pipe, accum: int, times: list):
    """`TokenPipeline` batches on the card, `accum` consecutive ones
    stacked per step (the (accum, batch, seq) layout `make_train_step`
    takes); each request for the next step appends the wall time after a
    synchronise, so consecutive entries bound one step."""
    import numpy as np
    import torch
    step = 0
    while True:
        sync()
        times.append(time.perf_counter())
        parts = [pipe.batch_at(accum * step + i) for i in range(accum)]
        tokens = np.stack([t for t, _ in parts])
        labels = np.stack([lbl for _, lbl in parts])
        if accum == 1:
            tokens, labels = tokens[0], labels[0]
        yield {"tokens": torch.from_numpy(tokens).to(DEV),
               "labels": torch.from_numpy(labels).to(DEV)}
        step += 1


def profile_train_step(cfg, lc, params, opt_state, ef, batch) -> dict:
    """torch.profiler over one more step of `lc` (outside the counted run):
    kernels launched and device busy time, by kind of kernel and the
    costliest by name, from the trace's device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train import make_train_step

    step = make_train_step(cfg, lc)
    sync()
    # Device events alone: a step launches up to 25,000 kernels, and the
    # host-side events beside them took seconds to collect.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = step(params, opt_state, batch, ef)
        sync()
        wall = time.perf_counter() - t0
    del out
    kinds = (("flash_bwd", ("dkdv_kernel", "dq_kernel", "delta_kernel")),
             ("flash_fwd", ("flash_attn_kernel",)),
             ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "Kernel2")))
    by_kind, by_name, n = {}, {}, 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        n += 1
        kind = next((k for k, keys in kinds
                     if any(key in e.name for key in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3
        by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"kernels": n, "device_busy_ms": sum(by_kind.values()),
            "wall_ms_profiled": 1e3 * wall, "device_ms_by_kind": by_kind,
            "top_kernels_ms": {k[:80]: v for k, v in top}}


def phase_lm_train(fmod, dmod, seed: int) -> dict:
    """Yi-6B's CONFIG (bf16, remat, published widths) cut to 4 layers:
    run A, `train_loop` with AdamW, two microbatches per step and int8
    error-feedback compression on `TokenPipeline` batches; run B,
    Adafactor with a checkpoint at step 2, restored bit for bit. Returns
    the launches of each run."""
    import tempfile

    import torch
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import init_params, param_count
    from repro_torch.train import TrainLoopConfig, make_optimizer, train_loop
    from repro_torch.train.optim import tree_leaves

    cfg = dataclasses.replace(get_config("yi_6b"), n_layers=4)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(seed),
                         device=DEV)
    pipe = TokenPipeline(cfg.vocab, LM_TRAIN_SEQ, LM_TRAIN_BATCH, seed=seed)
    accum = 2
    with torch.no_grad():                # step 0's batch in float64
        first = next(train_batches(pipe, accum, []))
        loss64 = sum(float(f64_lm_loss(cfg, params, first["tokens"][i],
                                       first["labels"][i]))
                     for i in range(accum)) / accum
    del first
    torch.cuda.empty_cache()

    runs, launches = {}, {}
    for name, lc, acc, ckpt in (
            ("adamw", TrainLoopConfig(optimizer="adamw", grad_accum=accum,
                                      compress=True,
                                      max_steps=LM_TRAIN_STEPS), accum,
             False),
            ("adafactor", TrainLoopConfig(optimizer="adafactor",
                                          checkpoint_every=2, max_steps=3),
             1, True)):
        times = []
        tmp = tempfile.TemporaryDirectory() if ckpt else None
        torch.cuda.reset_peak_memory_stats()
        zero_attn_counts(fmod, dmod)                 # the run starts
        init_opt = make_optimizer(lc.optimizer, lr=lc.lr)[0]
        out_params, out_state, info = train_loop(
            cfg, lc, params, init_opt(params), train_batches(pipe, acc, times),
            checkpointer=Checkpointer(tmp.name) if ckpt else None,
            log_every=1)
        counts = attn_counts(fmod, dmod)             # ... and ends here
        peak = torch.cuda.max_memory_allocated()
        times.append(time.perf_counter())
        steps = lc.max_steps
        micro = steps * acc
        want = {"flash": 2 * cfg.n_layers * micro,    # forward + recompute
                "flash_bwd": cfg.n_layers * micro, "decode": 0}
        got = {k: counts[k] for k in want}
        if got != want:
            raise AssertionError(f"lm_train {name} launches {got}, want "
                                 f"{want}")
        check_routes(f"lm_train {name} forward", counts, "flash",
                     "tensor_core")
        check_routes(f"lm_train {name} backward", counts, "flash_bwd",
                     "tensor_core")
        losses = [x for _, x in info["history"]]
        if len(losses) != steps or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"lm_train {name}: losses {losses}")
        step_s = [b - a for a, b in zip(times[:steps], times[1:steps + 1])]
        # Steady steps: after the first (cuBLAS and allocator warm-up),
        # without a checkpoint write.
        steady = [x for i, x in enumerate(step_s)
                  if i and not (ckpt and i % lc.checkpoint_every == 0)]
        tokens = acc * LM_TRAIN_BATCH * LM_TRAIN_SEQ
        runs[name] = {"optimizer": lc.optimizer, "grad_accum": acc,
                      "compress": lc.compress, "steps": steps,
                      "loss_history": info["history"],
                      "seconds": info["seconds"],
                      "step_ms": [1e3 * x for x in step_s],
                      "ms_per_steady_step": 1e3 * sum(steady) / len(steady),
                      "tokens_per_step": tokens,
                      "tokens_per_s_steady": tokens * len(steady)
                      / sum(steady),
                      "flash_launches": counts["flash"],
                      "flash_bwd_launches": counts["flash_bwd"],
                      "launches_by_route": {
                          "flash": counts["flash_routes"],
                          "flash_bwd": counts["flash_bwd_routes"]},
                      "peak_allocated_bytes": peak}
        launches[name] = counts
        if ckpt:                 # step 2 is the last step: its state
            restored, step = Checkpointer(tmp.name).restore(
                {"params": out_params, "opt_state": out_state})
            pairs = list(zip(tree_leaves(restored["params"])
                             + tree_leaves(restored["opt_state"]),
                             tree_leaves(out_params)
                             + tree_leaves(out_state)))
            same = all(
                (torch.equal(a, b) and a.dtype == b.dtype)
                if isinstance(b, torch.Tensor) else int(a) == int(b)
                for a, b in pairs)
            if step != 2 or not same:
                raise AssertionError(f"lm_train checkpoint: step {step}, "
                                     f"bit for bit {same}")
            runs[name]["checkpoint"] = {
                "step": step, "leaves": len(pairs), "bit_for_bit": same,
                "bytes": sum(t.numel() * t.element_size()
                             for t, _ in pairs
                             if isinstance(t, torch.Tensor))}
            del restored, pairs
            tmp.cleanup()
        else:
            first_loss = losses[0]
            runs[name]["profiled_step"] = profile_train_step(
                cfg, lc, out_params, out_state, info["ef"],
                next(train_batches(pipe, acc, [])))
        del out_params, out_state, info
        torch.cuda.empty_cache()
    loss_gap = abs(first_loss - loss64)
    if not loss_gap <= LM_TRAIN_LOSS_TOL:
        raise AssertionError(f"lm_train: first loss {first_loss} vs float64 "
                             f"{loss64}, gap {loss_gap} > "
                             f"{LM_TRAIN_LOSS_TOL}")
    emit({"phase": "lm_train", "config": cfg.name, "dtype": cfg.dtype,
          "layers": cfg.n_layers, "remat": cfg.remat,
          "params": param_count(params), "batch": LM_TRAIN_BATCH,
          "seq": LM_TRAIN_SEQ, "first_loss": first_loss,
          "first_loss_float64": loss64, "loss_gap": loss_gap,
          "loss_tol": LM_TRAIN_LOSS_TOL, "runs": runs})
    del params
    torch.cuda.empty_cache()
    return launches


def _groups(sizes: list, budget) -> list:
    """Consecutive runs of indices whose sizes sum to at most `budget` (a
    size above it alone); one run of all when `budget` is None."""
    if budget is None:
        return [list(range(len(sizes)))]
    runs, run, total = [], [], 0
    for i, n in enumerate(sizes):
        if run and total + n > budget:
            runs.append(run)
            run, total = [], 0
        run.append(i)
        total += n
    return runs + [run] if run else runs


def grad_check(fmod, dmod, label: str, cfg, params, tokens, vision=None,
               audio=None, f64_group_bytes=None) -> tuple:
    """`lm_loss` gradients of the float32 `cfg` (no remat) through the
    flash kernels against float64 autograd of the script's own forward
    (`f64_lm_loss`, checkpointed), per tensor within LM_GRAD_REL_TOL, for
    every layer tensor, the final norm and, given `vision` embeddings,
    `vision_proj`, given `audio` frames, every encoder tensor and
    `audio_proj`; the loss within LM_REL_TOL. The embedding's and the
    head's gradients are checked finite, not compared: their float64
    copies would take gigabytes beside the rest (the float64 side converts
    them on the fly in chunks). A MoE stack's float64 side routes as the
    port's step routed (`RouterSpy` picks, so a near-tie cannot flip a
    token's expert) and adds the aux term; the tokens whose float64 picks
    would differ are counted. With `f64_group_bytes` the float64 gradients
    are taken in passes, each over consecutive compared tensors of at most
    that many float64 bytes (one Mixtral expert bank is 6.4 GB). Returns
    (the launches of the port's step, the fields its phase line prints)."""
    import torch
    from repro_torch.models import lm_loss, param_count
    from repro_torch.train.optim import tree_leaves, tree_map

    labels = torch.roll(tokens, -1, 1)
    names = _leaf_names(params)
    live = tree_map(lambda t: t.requires_grad_(True), params)
    torch.cuda.reset_peak_memory_stats()
    sync()
    zero_attn_counts(fmod, dmod)                     # the step starts
    t0 = time.perf_counter()
    with RouterSpy(cfg.is_moe) as spy:
        loss = lm_loss(cfg, live, tokens, labels, vision_embeds=vision,
                       audio_embeds=audio)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    sync()
    seconds = time.perf_counter() - t0
    counts = attn_counts(fmod, dmod)                 # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    loss = float(loss.detach())
    compared = [i for i, n in enumerate(names)
                if n.startswith(("layers/", "enc_layers/"))
                or n in ("final_norm", "vision_proj", "audio_proj",
                         "enc_norm")]
    unchecked = {n: bool(torch.isfinite(g).all())
                 for n, g in zip(names, grads) if n in ("embed", "lm_head")}
    grads = {i: grads[i] for i in compared}
    for t in tree_leaves(params):
        t.requires_grad_(False)
    torch.cuda.empty_cache()
    leaves = tree_leaves(params)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    errs, routes64, loss64 = {}, [], None
    runs = _groups([8 * leaves[i].numel() for i in compared],
                   f64_group_bytes)
    for run in runs:
        group = [compared[j] for j in run]
        p64 = {i: leaves[i].detach().double().requires_grad_(True)
               for i in group}
        it = iter(range(len(leaves)))
        tree64 = tree_map(lambda t: p64.get(next(it), t), params)
        l64 = f64_lm_loss(cfg, tree64, tokens, labels, ckpt=True,
                          vision=vision, audio=audio, pinned=spy.picks,
                          routes=routes64 if loss64 is None else None)
        grads64 = torch.autograd.grad(l64, [p64[i] for i in group])
        loss64 = float(l64.detach()) if loss64 is None else loss64
        errs.update({names[i]: float((grads[i].double() - g64).abs().max())
                     / max(float(g64.abs().max()), 1e-30)
                     for i, g64 in zip(group, grads64)})
        del p64, tree64, grads64, l64
        torch.cuda.empty_cache()
    f64_s = time.perf_counter() - t0
    peak64 = torch.cuda.max_memory_allocated()
    loss_err = abs(loss - loss64)
    worst = max(errs, key=errs.get)
    if not all(unchecked.values()) or (vision is not None
                                       and "vision_proj" not in errs) or (
            audio is not None and "audio_proj" not in errs):
        raise AssertionError(f"{label}: compared {sorted(errs)}, finite "
                             f"{unchecked}")
    if not errs[worst] <= LM_GRAD_REL_TOL or not loss_err <= LM_REL_TOL * \
            abs(loss64):
        raise AssertionError(f"{label}: {worst} relative error "
                             f"{errs[worst]} > {LM_GRAD_REL_TOL} or loss off "
                             f"by {loss_err}")
    out = {"params": param_count(params), "tokens": tokens.shape[1],
           "batch": tokens.shape[0], "loss": loss, "loss_float64": loss64,
           "seconds_fwd_bwd": seconds, "seconds_float64": f64_s,
           "grad_rel_err_vs_float64": errs, "worst": worst,
           "tol": LM_GRAD_REL_TOL, "compared_tensors": len(errs),
           "finite_not_compared": unchecked,
           "flash_launches": counts["flash"],
           "flash_bwd_launches": counts["flash_bwd"],
           "launches_by_route": {"flash": counts["flash_routes"],
                                 "flash_bwd": counts["flash_bwd_routes"]},
           "peak_allocated_bytes": peak,
           "peak_allocated_bytes_float64": peak64}
    if cfg.is_moe:
        out.update({"aux_by_layer": [float(a) for a in spy.aux],
                    "dropped_assignments": [dropped(cfg, r)
                                            for r in spy.routes],
                    "router_picks_unlike_float64": picks_unlike(
                        spy.routes, routes64),
                    "float64_passes": len(runs)})
    del live, grads
    torch.cuda.empty_cache()
    return counts, out


def check_step_launches(label: str, counts: dict, n_attn: int, route: str,
                        capped: bool, wide: bool, prefix: bool) -> None:
    """A gradient step's launches: one flash forward and one backward per
    attention layer, no decode, every one on `route`, with the softcap, at
    d = 256 and with a prefix exactly where asked."""
    if (counts["flash"], counts["flash_bwd"], counts["decode"]) != (
            n_attn, n_attn, 0):
        raise AssertionError(f"{label} launches {counts}; want flash "
                             f"{n_attn}, backward {n_attn}")
    for kernel in ("flash", "flash_bwd"):
        check_routes(f"{label} {kernel}", counts, kernel, route)
        check_softcap(f"{label} {kernel}", counts, kernel, capped)
        check_wide(f"{label} {kernel}", counts, kernel, wide)
        check_prefix(f"{label} {kernel}", counts, kernel, prefix)


def phase_gemma_train_check(fmod, dmod, seed: int) -> dict:
    """Gemma-2 27B's published widths cut to 2 layers (local, then
    global), float32, no remat, one sequence of GEMMA_CHECK_SEQ tokens (the
    window of 4096 bites): `grad_check` through the softcapped flash kernel
    and its softcapped backward (f32 FMA routes) against float64 autograd
    with the window and both softcaps, for every layer tensor (the
    attention's wq, wk, wv, wo, the norms, the MLP) and the final norm.
    Returns the launches."""
    import torch
    from repro_torch.configs.gemma2_27b import CONFIG
    from repro_torch.models import init_params

    cfg = dataclasses.replace(CONFIG, n_layers=2, dtype="float32",
                              remat=False)
    torch.cuda.empty_cache()
    gen = torch.Generator(device=DEV).manual_seed(seed + 10)
    params = init_params(cfg, gen, device=DEV)
    tokens = torch.randint(0, cfg.vocab, (1, GEMMA_CHECK_SEQ), device=DEV,
                           generator=gen)
    counts, out = grad_check(fmod, dmod, "gemma_train_check", cfg, params,
                             tokens)
    check_step_launches("gemma_train_check", counts, cfg.n_layers, "f32_fma",
                        capped=True, wide=False, prefix=False)
    attn = [n for n in out["grad_rel_err_vs_float64"] if "/attn/" in n]
    if len(attn) != 4 * cfg.n_layers:
        raise AssertionError(f"gemma_train_check: compared {attn}")
    emit({"phase": "gemma_train_check",
          "config": "gemma2-27b width, 2 layers (local, global), float32, "
                    "no remat", "window": cfg.sliding_window,
          "attn_softcap": cfg.attn_softcap,
          "logit_softcap": cfg.logit_softcap, **out,
          "softcap_launches": {"flash": counts["flash_softcap"],
                               "flash_bwd": counts["flash_bwd_softcap"]}})
    del params
    torch.cuda.empty_cache()
    return counts


def phase_rgemma_train_check(fmod, dmod, seed: int) -> dict:
    """rgemma_check's model (RecurrentGemma-2B's widths, an RG-LRU then a
    local layer at d = 256, float32) without remat on one sequence of
    RGEMMA_CHECK_SEQ tokens (the window of 2048 bites): `grad_check`
    through the flash forward and the backward's d = 256 instance on the
    f32 FMA route, the RG-LRU scan and the temporal conv differentiated as
    plain PyTorch, against float64 autograd of the script's own forward,
    whose recurrence steps over time. Returns the launches."""
    import torch
    from repro_torch.configs.recurrentgemma_2b import CONFIG
    from repro_torch.models import init_params

    cfg = dataclasses.replace(CONFIG, n_layers=2, dtype="float32",
                              remat=False, block_pattern=("rglru", "local"))
    torch.cuda.empty_cache()
    gen = torch.Generator(device=DEV).manual_seed(seed + 9)  # rgemma_check's
    params = init_params(cfg, gen, device=DEV)
    tokens = torch.randint(0, cfg.vocab, (1, RGEMMA_CHECK_SEQ), device=DEV,
                           generator=gen)
    counts, out = grad_check(fmod, dmod, "rgemma_train_check", cfg, params,
                             tokens)
    check_step_launches("rgemma_train_check", counts, 1, "f32_fma",
                        capped=False, wide=True, prefix=False)
    emit({"phase": "rgemma_train_check",
          "config": "recurrentgemma-2b width, 2 layers (rglru, local), "
                    "float32, no remat", "window": cfg.sliding_window,
          "head_dim": cfg.hd, **out,
          "d256_launches": {"flash": counts["flash_wide"],
                            "flash_bwd": counts["flash_bwd_wide"]}})
    del params
    torch.cuda.empty_cache()
    return counts


def with_audio(cfg, batches, seed: int):
    """`batches` with "audio_embeds" beside the tokens: for each step,
    (accum, B, audio_frames, d_model) bf16 frames drawn on the card from a
    generator seeded with `seed` and the step (the reference's audio
    frontend is a stub of precomputed frames)."""
    import torch
    for step, batch in enumerate(batches):
        gen = torch.Generator(device=DEV).manual_seed(seed * 1000 + step)
        shape = (*batch["tokens"].shape[:-1], cfg.audio_frames, cfg.d_model)
        yield {**batch, "audio_embeds": torch.randn(
            shape, device=DEV, generator=gen).to(torch.bfloat16)}


def train_phase(fmod, dmod, seed: int, label: str, cfg, seq: int,
                batch: int, steps: int) -> dict:
    """`cfg` (bf16, remat on): `train_loop` with Adafactor, two
    microbatches of TokenPipeline(vocab, seq, batch) a step and int8
    error-feedback compression, `steps` steps; the first loss within
    LM_TRAIN_LOSS_TOL of the float64 loss of the same batch, and the loss
    of that batch lower after the steps than before. A MoE config's
    float64 loss routes step 0's batch as the port's forward routes it
    (`RouterSpy` over a forward of each microbatch before the run) and
    adds the aux term; the phase prints those forwards' aux losses and
    dropped assignments, and the tokens float64 would route otherwise. Every flash forward,
    recompute and backward on the tensor-core route, with the softcap and
    at d = 256 exactly where the config asks, none with a prefix. An
    encoder-decoder config's batches carry bf16 frames (`with_audio`): its
    encoder layers and every decoder layer's cross-attention launch the
    flash kernels too, non-causal, the cross-attention with Sq != Sk.
    Prints ms per step, tokens/s, peak bytes and one profiled step by
    kind. Returns the launches."""
    import torch
    from repro_torch.data import TokenPipeline
    from repro_torch.models import init_params, lm_loss, param_count
    from repro_torch.train import TrainLoopConfig, make_optimizer, train_loop

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(seed),
                         device=DEV)
    pipe = TokenPipeline(cfg.vocab, seq, batch, seed=seed)
    accum = 2

    def batches(times):
        it = train_batches(pipe, accum, times)
        return with_audio(cfg, it, seed) if cfg.is_enc_dec else it

    first = next(batches([]))
    audio = first.get("audio_embeds")
    spies = [RouterSpy(cfg.is_moe) for _ in range(accum)]
    routes64, moe = [], {}
    with torch.no_grad():
        if cfg.is_moe:                   # step 0's routing, microbatch by
            for i, spy in enumerate(spies):  # microbatch, as the step's
                with spy:                # forward routes it
                    lm_loss(cfg, params, first["tokens"][i],
                            first["labels"][i])
        loss64 = sum(float(f64_lm_loss(  # step 0's batch in float64
            cfg, params, first["tokens"][i], first["labels"][i],
            ckpt=cfg.is_enc_dec,
            audio=None if audio is None else audio[i],
            pinned=spies[i].picks, routes=routes64))
            for i in range(accum)) / accum
    if cfg.is_moe:
        moe = {"first_step_aux_by_microbatch": [
                   [float(a) for a in spy.aux] for spy in spies],
               "dropped_assignments_by_microbatch": [
                   [dropped(cfg, r) for r in spy.routes] for spy in spies],
               "router_picks_unlike_float64": picks_unlike(
                   [r for spy in spies for r in spy.routes], routes64)}
    del spies
    torch.cuda.empty_cache()
    lc = TrainLoopConfig(optimizer="adafactor", grad_accum=accum,
                         compress=True, max_steps=steps)
    times = []
    torch.cuda.reset_peak_memory_stats()
    zero_attn_counts(fmod, dmod)                     # the run starts
    out_params, out_state, info = train_loop(
        cfg, lc, params, make_optimizer(lc.optimizer, lr=lc.lr)[0](params),
        batches(times), log_every=1)
    counts = attn_counts(fmod, dmod)                 # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    times.append(time.perf_counter())
    micro = lc.max_steps * accum
    n_attn = n_attention_layers(cfg)
    # Per microbatch: each attention layer's self-attention, and in an
    # encoder-decoder its cross-attention and each encoder layer.
    n_flash = n_attn * (2 if cfg.is_enc_dec else 1) + cfg.encoder_layers
    want = {"flash": 2 * n_flash * micro,            # forward + recompute
            "flash_bwd": n_flash * micro, "decode": 0,
            "flash_cross": 2 * n_attn * micro * cfg.is_enc_dec,
            "flash_bwd_cross": n_attn * micro * cfg.is_enc_dec,
            "flash_noncausal": 2 * (n_flash - n_attn) * micro,
            "flash_bwd_noncausal": (n_flash - n_attn) * micro}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{label} launches {got}, want {want}")
    for kernel in ("flash", "flash_bwd"):
        check_routes(f"{label} {kernel}", counts, kernel, "tensor_core")
        check_softcap(f"{label} {kernel}", counts, kernel,
                      cfg.attn_softcap is not None)
        check_wide(f"{label} {kernel}", counts, kernel, cfg.hd > 128)
        check_prefix(f"{label} {kernel}", counts, kernel, False)
    losses = [x for _, x in info["history"]]
    if len(losses) != lc.max_steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{label}: losses {losses}")
    with torch.no_grad():                # step 0's batch after the steps
        after = sum(float(lm_loss(
            cfg, out_params, first["tokens"][i], first["labels"][i],
            audio_embeds=None if audio is None else audio[i]))
            for i in range(accum)) / accum
    step_s = [b - a for a, b in zip(times[:lc.max_steps],
                                    times[1:lc.max_steps + 1])]
    steady = step_s[1:]
    tokens = accum * batch * seq
    profiled = profile_train_step(cfg, lc, out_params, out_state, info["ef"],
                                  next(batches([])))
    gap = abs(losses[0] - loss64)
    if not gap <= LM_TRAIN_LOSS_TOL or not after < losses[0]:
        raise AssertionError(f"{label}: first loss {losses[0]} vs "
                             f"float64 {loss64} (gap {gap} > "
                             f"{LM_TRAIN_LOSS_TOL}?), step 0's batch after "
                             f"the steps {after}")
    emit({"phase": label, "config": cfg.name, "dtype": cfg.dtype,
          "layers": cfg.n_layers, "attention_layers": n_attn,
          "head_dim": cfg.hd, "remat": cfg.remat,
          "params": param_count(params), "optimizer": lc.optimizer,
          "grad_accum": accum, "compress": lc.compress,
          "batch": batch, "seq": seq,
          "first_loss": losses[0], "first_loss_float64": loss64,
          "loss_gap": gap, "loss_tol": LM_TRAIN_LOSS_TOL,
          "loss_history": info["history"],
          "first_batch_loss_after_steps": after,
          "step_ms": [1e3 * x for x in step_s],
          "ms_per_steady_step": 1e3 * sum(steady) / len(steady),
          "tokens_per_step": tokens,
          "tokens_per_s_steady": tokens * len(steady) / sum(steady),
          "flash_launches": counts["flash"],
          "flash_bwd_launches": counts["flash_bwd"],
          "launches_by_route": {"flash": counts["flash_routes"],
                                "flash_bwd": counts["flash_bwd_routes"]},
          "softcap_launches": {"flash": counts["flash_softcap"],
                               "flash_bwd": counts["flash_bwd_softcap"]},
          "d256_launches": {"flash": counts["flash_wide"],
                            "flash_bwd": counts["flash_bwd_wide"]},
          "cross_launches": {"flash": counts["flash_cross"],
                             "flash_bwd": counts["flash_bwd_cross"]},
          "noncausal_launches": {"flash": counts["flash_noncausal"],
                                 "flash_bwd": counts["flash_bwd_noncausal"]},
          "encoder_layers": cfg.encoder_layers,
          "audio_frames": cfg.audio_frames if cfg.is_enc_dec else 0,
          **moe, "peak_allocated_bytes": peak, "profiled_step": profiled})
    del params, out_params, out_state, info, first, audio
    torch.cuda.empty_cache()
    return counts


def phase_gemma_train(fmod, dmod, seed: int) -> dict:
    """Gemma-2 27B's bf16 CONFIG (remat on, published widths) cut to 2
    layers: `train_phase` with two microbatches of TokenPipeline(vocab,
    512, 4), GEMMA_TRAIN_STEPS steps, every launch softcapped."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("gemma2_27b"), n_layers=2)
    return train_phase(fmod, dmod, seed, "gemma_train", cfg, LM_TRAIN_SEQ,
                       LM_TRAIN_BATCH, GEMMA_TRAIN_STEPS)


def phase_rgemma_train(fmod, dmod, seed: int) -> dict:
    """RecurrentGemma-2B's bf16 CONFIG at full width and depth (26 layers,
    8 of them local attention at d = 256, remat on): `train_phase` with
    two microbatches of TokenPipeline(vocab, 4096, 1) a step, so that the
    window of 2048 bites in the backward, RGEMMA_TRAIN_STEPS steps; every
    flash forward, recompute and backward on the tensor-core route at
    d = 256, 16 backward launches a step."""
    from repro_torch.configs import get_config
    cfg = get_config("recurrentgemma_2b")
    if RGEMMA_TRAIN_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=RGEMMA_TRAIN_LAYERS)
    return train_phase(fmod, dmod, seed, "rgemma_train", cfg,
                       RGEMMA_TRAIN_SEQ, 1, RGEMMA_TRAIN_STEPS)


def qwen_vision(cfg, batch: int, gen):
    """`batch` sequences of the config's n_vision_tokens patch embeddings,
    float32, drawn from `gen` (the reference's vision tower is a stub of
    precomputed embeddings)."""
    import torch
    return torch.randn((batch, cfg.n_vision_tokens, cfg.d_model), device=DEV,
                       generator=gen)


def phase_qwen_check(fmod, dmod, seed: int) -> dict:
    """Qwen2-VL-72B's published widths cut to 2 float32 layers, batch 2 x
    QWEN_CHECK_SEQ with 256 vision embeddings from --seed: `forward` with
    them against the script's own float64 forward (M-RoPE, the vision
    block's bidirectional mask, the projection), teacher-forced
    `decode_step` against its float64 forward without M-RoPE and the
    vision prefix (the reference's decode semantics, R6), both within
    LM_REL_TOL, and `grad_check` with the vision input (`vision_proj`
    compared). Every flash launch, forward and backward, on the f32 FMA
    route with the prefix of 256; decode launches 2 x QWEN_CHECK_SEQ.
    Returns the launches."""
    import torch
    from repro_torch.configs.qwen2_vl_72b import CONFIG
    from repro_torch.models import forward, init_params

    cfg = dataclasses.replace(CONFIG, n_layers=2, dtype="float32",
                              remat=False)
    plain = dataclasses.replace(cfg, mrope_sections=None, n_vision_tokens=0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV).manual_seed(seed + 12)
    params = init_params(cfg, gen, device=DEV)
    tokens = torch.randint(0, cfg.vocab, (2, QWEN_CHECK_SEQ), device=DEV,
                           generator=gen)
    vision = qwen_vision(cfg, 2, gen)
    with torch.inference_mode():
        zero_attn_counts(fmod, dmod)                     # forward starts
        logits, _ = forward(cfg, params, tokens, vision_embeds=vision)
        fwd_counts = attn_counts(fmod, dmod)             # ... and ends here
        zero_attn_counts(fmod, dmod)                     # decode starts
        dec = teacher_forced(cfg, params, tokens)
        dec_counts = attn_counts(fmod, dmod)             # ... and ends here
        sync()
        ref = f64_lm_forward(cfg, params, tokens, vision=vision)
        errs = {"forward": rel_err(logits, ref)}
        del ref
        ref_dec = f64_lm_forward(plain, params, tokens)
        errs["decode"] = rel_err(dec, ref_dec)
        # R6: how far the reference's decode semantics lie from its forward.
        gap_r6 = rel_err(dec, logits)
        finite = bool(torch.isfinite(logits).all() and torch.isfinite(
            dec).all())
        del logits, dec, ref_dec
    n_attn = cfg.n_layers
    if (fwd_counts["flash"], fwd_counts["decode"], dec_counts["flash"],
            dec_counts["decode"]) != (n_attn, 0, 0, n_attn * QWEN_CHECK_SEQ):
        raise AssertionError(f"qwen_check launches: forward {fwd_counts}, "
                             f"decode {dec_counts}")
    check_routes("qwen_check forward", fwd_counts, "flash", "f32_fma")
    check_prefix("qwen_check forward", fwd_counts, "flash", True)
    check_routes("qwen_check decode", dec_counts, "decode", "f32_fma")
    bad = {k: e for k, e in errs.items() if not e <= LM_REL_TOL}
    if bad or not finite:
        raise AssertionError(f"qwen_check: relative error above "
                             f"{LM_REL_TOL}: {bad} (finite {finite})")
    counts, grads = grad_check(fmod, dmod, "qwen_check", cfg, params, tokens,
                               vision)
    check_step_launches("qwen_check gradient", counts, n_attn, "f32_fma",
                        capped=False, wide=False, prefix=True)
    emit({"phase": "qwen_check",
          "config": "qwen2-vl-72b width, 2 layers, float32, no remat",
          "vision_tokens": cfg.n_vision_tokens,
          "mrope_sections": cfg.mrope_sections,
          "rel_err_vs_float64": errs, "tol": LM_REL_TOL,
          "decode_reference": "float64 forward without M-RoPE and the "
                              "vision prefix (the reference's decode, R6)",
          "rel_gap_decode_vs_forward_r6": gap_r6,
          "flash_launches": fwd_counts["flash"],
          "flash_prefix_launches": fwd_counts["flash_prefix"],
          "decode_launches": dec_counts["decode"],
          "launches_by_route": {"flash": fwd_counts["flash_routes"],
                                "decode": dec_counts["decode_routes"]},
          "gradients": {**grads, "prefix_launches": {
              "flash": counts["flash_prefix"],
              "flash_bwd": counts["flash_bwd_prefix"]}}})
    del params, vision
    torch.cuda.empty_cache()
    total = add_counts(fwd_counts, dec_counts, counts)
    return total


def phase_qwen_serve(fmod, dmod, seed: int) -> dict:
    """Qwen2-VL-72B's bf16 CONFIG cut to QWEN_SERVE_LAYERS of 80 layers:
    `serve_phase` with 256 vision embeddings in the 4096-token prefill
    (every flash launch with the prefix of 256), decode held to a forward
    without M-RoPE and the vision prefix (QWEN_DECODE_RULE)."""
    return serve_phase(fmod, dmod, seed, "qwen2_vl_72b", LM_PREFILL,
                       "qwen_serve", n_layers=QWEN_SERVE_LAYERS)


def seamless_audio(cfg, batch: int, gen, dtype="float32"):
    """`batch` sequences of the config's audio_frames frame embeddings in
    `dtype`, drawn from `gen` (the reference's speech frontend is a stub of
    precomputed frames)."""
    import torch
    return torch.randn((batch, cfg.audio_frames, cfg.d_model), device=DEV,
                       generator=gen).to(getattr(torch, dtype))


def seamless_check_cfg():
    """SeamlessM4T-medium's published widths (d_model 1024, 16 heads of 64,
    d_ff 4096, the full vocabulary of 256,206, 1024 frames) cut to
    SEAMLESS_CHECK_LAYERS encoder and decoder layers, float32, no remat."""
    from repro_torch.configs.seamless_m4t_medium import CONFIG
    return dataclasses.replace(CONFIG, n_layers=SEAMLESS_CHECK_LAYERS,
                               encoder_layers=SEAMLESS_CHECK_LAYERS,
                               dtype="float32", remat=False)


def check_cross(label: str, counts: dict, kernel: str, cross: int,
                noncausal: int) -> None:
    """`kernel`'s launches with Sq != Sk and without the causal mask."""
    got = (counts[f"{kernel}_cross"], counts[f"{kernel}_noncausal"])
    if got != (cross, noncausal):
        raise AssertionError(f"{label}: {kernel} launches cross, non-causal "
                             f"{got}, want {(cross, noncausal)}")


def phase_seamless_check(fmod, dmod, seed: int) -> dict:
    """SeamlessM4T-medium's widths cut to 2 encoder and 2 decoder layers,
    float32, batch 2 x SEAMLESS_CHECK_SEQ tokens over 1024 frames from
    --seed: `encode`, `forward` and teacher-forced `decode_step(enc_out=)`
    against the script's own float64 encoder-decoder within LM_REL_TOL,
    the decode also against its own forward (the reference's decode of
    this arch is its forward), and `grad_check` with the frames (every
    `xattn`, `enc_layers` tensor and `audio_proj` compared). Every launch
    on the f32 FMA route: the encoder's flash non-causal at Sq = Sk, the
    decoder's cross-attention non-causal at Sq != Sk, its decode step's
    cross-attention through the decode kernel over the 1024 frames.
    Returns the launches."""
    import torch
    from repro_torch.models import encode, forward, init_params

    cfg = seamless_check_cfg()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV).manual_seed(seed + 16)
    params = init_params(cfg, gen, device=DEV)
    tokens = torch.randint(0, cfg.vocab, (2, SEAMLESS_CHECK_SEQ), device=DEV,
                           generator=gen)
    audio = seamless_audio(cfg, 2, gen)
    n, ne = cfg.n_layers, cfg.encoder_layers
    with torch.inference_mode():
        zero_attn_counts(fmod, dmod)                     # encode starts
        enc = encode(cfg, params, audio)
        enc_counts = attn_counts(fmod, dmod)             # ... and ends here
        zero_attn_counts(fmod, dmod)                     # forward starts
        logits, _ = forward(cfg, params, tokens, audio_embeds=audio)
        fwd_counts = attn_counts(fmod, dmod)             # ... and ends here
        zero_attn_counts(fmod, dmod)                     # decode starts
        dec = teacher_forced(cfg, params, tokens, enc_out=enc)
        dec_counts = attn_counts(fmod, dmod)             # ... and ends here
        sync()
        enc64 = f64_encode(cfg, params, audio)
        errs = {"encode": rel_err(enc, enc64)}
        del enc64
        ref = f64_lm_forward(cfg, params, tokens, audio=audio)
        errs["forward"] = rel_err(logits, ref)
        errs["decode"] = rel_err(dec, ref)
        errs["decode_vs_own_forward"] = rel_err(dec, logits)
        del ref, logits, dec, enc
    want = {"encode": (ne, 0, 0, ne), "forward": (ne + 2 * n, 0, n, ne + n),
            "decode": (0, 2 * n * SEAMLESS_CHECK_SEQ, 0, 0)}
    for name, counts in (("encode", enc_counts), ("forward", fwd_counts),
                         ("decode", dec_counts)):
        got = (counts["flash"], counts["decode"], counts["flash_cross"],
               counts["flash_noncausal"])
        if got != want[name]:
            raise AssertionError(f"seamless_check {name} launches (flash, "
                                 f"decode, cross, non-causal) {got}, want "
                                 f"{want[name]}")
    check_routes("seamless_check forward", fwd_counts, "flash", "f32_fma")
    check_routes("seamless_check decode", dec_counts, "decode", "f32_fma")
    bad = {k: e for k, e in errs.items() if not e <= LM_REL_TOL}
    if bad:
        raise AssertionError(f"seamless_check: relative error above "
                             f"{LM_REL_TOL}: {bad}")
    counts, grads = grad_check(fmod, dmod, "seamless_check", cfg, params,
                               tokens, audio=audio)
    if (counts["flash"], counts["flash_bwd"], counts["flash_cross"],
            counts["flash_bwd_cross"], counts["flash_bwd_noncausal"]) != (
            ne + 2 * n, ne + 2 * n, n, n, ne + n):
        raise AssertionError(f"seamless_check gradient launches {counts}")
    for kernel in ("flash", "flash_bwd"):
        check_routes(f"seamless_check gradient {kernel}", counts, kernel,
                     "f32_fma")
    emit({"phase": "seamless_check",
          "config": "seamless-m4t-medium width, 2 + 2 layers, float32, "
                    "no remat",
          "batch": 2, "tokens": SEAMLESS_CHECK_SEQ,
          "audio_frames": cfg.audio_frames,
          "rel_err_vs_float64": errs, "tol": LM_REL_TOL,
          "launches": {name: {k: c[k] for k in (
              "flash", "flash_cross", "flash_noncausal", "decode")}
              for name, c in (("encode", enc_counts), ("forward", fwd_counts),
                              ("decode", dec_counts))},
          "launches_by_route": {"flash": fwd_counts["flash_routes"],
                                "decode": dec_counts["decode_routes"]},
          "gradients": {**grads, "cross_launches": {
              "flash": counts["flash_cross"],
              "flash_bwd": counts["flash_bwd_cross"]},
              "noncausal_launches": {
              "flash": counts["flash_noncausal"],
              "flash_bwd": counts["flash_bwd_noncausal"]}},
          "peak_allocated_bytes": torch.cuda.max_memory_allocated()})
    del params, audio
    torch.cuda.empty_cache()
    return add_counts(enc_counts, fwd_counts, dec_counts, counts)


def phase_seamless_serve(fmod, dmod, seed: int) -> dict:
    """Full SeamlessM4T-medium (12 encoder and 12 decoder layers, bf16,
    1.96 GB of weights from --seed): `serve` of LM_BATCH prompts of
    LM_PROMPT tokens for LM_STEPS steps, which encodes the reference's f32
    zero frames once (12 flash launches on the f32 FMA route, non-causal)
    and attends over them in every step (per step 12 self-attention
    decode launches on the tensor-core route and 12 cross-attention ones
    on the f32 route: f32 K and V from the f32 encoder output). That
    encoder output is exactly zero, so its tokens cannot show a
    cross-attention fault; so also a SEAMLESS_PREFILL-token `forward` with
    bf16 frames from --seed (36 flash launches, the 12 cross ones at Sq =
    4096, Sk = 1024) and a teacher-forced decode of its first LM_PROMPT
    tokens over the same frames' encoding, held to those prefill logits
    within LM_BF16_TOL. Prints ms per decode step, the profiled device
    busy ms and idle share, the prefill's seconds, and launches by kernel.
    Returns the launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import (
        decode_step, encode, forward, init_decode_state, init_params,
        param_count,
    )

    cfg = get_config("seamless_m4t_medium")
    n, ne = cfg.n_layers, cfg.encoder_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(seed),
                         device=DEV)
    sync()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab, size=(LM_BATCH, LM_PROMPT),
                           dtype=np.int32)
    zero_frames = torch.zeros((LM_BATCH, cfg.audio_frames, cfg.d_model),
                              device=DEV)
    with torch.inference_mode():                     # warm-up, not counted
        enc0 = encode(cfg, params, zero_frames)
        decode_step(cfg, params, torch.zeros((LM_BATCH, 1), dtype=torch.long,
                                             device=DEV),
                    init_decode_state(cfg, LM_BATCH, 2, device=DEV),
                    enc_out=enc0)
    sync()

    zero_attn_counts(fmod, dmod)                     # serve starts here
    t0 = time.perf_counter()
    tokens = serve(cfg, params, prompts, steps=LM_STEPS)
    sync()
    serve_s = time.perf_counter() - t0
    serve_counts = attn_counts(fmod, dmod)           # ... and ends here
    serve_peak = torch.cuda.max_memory_allocated()
    steps = LM_PROMPT + LM_STEPS
    want = {"flash": ne, "flash_noncausal": ne, "flash_cross": 0,
            "decode": 2 * n * steps}
    got = {k: serve_counts[k] for k in want}
    if got != want or serve_counts["flash_routes"]["f32_fma"] != ne or \
            serve_counts["decode_routes"] != {"tensor_core": n * steps,
                                              "f32_fma": n * steps}:
        raise AssertionError(f"seamless_serve serve launches {got}, by "
                             f"route {serve_counts['flash_routes']}, "
                             f"{serve_counts['decode_routes']}; want {want}")
    if tokens.shape != (LM_BATCH, LM_STEPS) or not (
            (tokens >= 0) & (tokens < cfg.vocab)).all():
        raise AssertionError(f"serve tokens {tokens.shape} out of range")
    profile = profile_decode(cfg, params, enc0)
    del enc0

    seq = np.concatenate([prompts[:1], rng.integers(
        0, cfg.vocab, size=(1, SEAMLESS_PREFILL - LM_PROMPT),
        dtype=np.int32)], 1)
    seq = torch.from_numpy(seq).long().to(DEV)
    frames = seamless_audio(cfg, 1, torch.Generator(device=DEV).manual_seed(
        seed + 17), "bfloat16")
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        zero_attn_counts(fmod, dmod)                     # prefill starts
        sync()
        t0 = time.perf_counter()
        logits, _ = forward(cfg, params, seq, audio_embeds=frames)
        sync()
        prefill_s = time.perf_counter() - t0
        prefill_counts = attn_counts(fmod, dmod)         # ... and ends here
        prefill_peak = torch.cuda.max_memory_allocated()
        want = {"flash": ne + 2 * n, "flash_cross": n,
                "flash_noncausal": ne + n, "decode": 0}
        got = {k: prefill_counts[k] for k in want}
        if got != want:
            raise AssertionError(f"seamless_serve prefill launches {got}, "
                                 f"want {want}")
        check_routes("seamless_serve prefill", prefill_counts, "flash",
                     "tensor_core")
        if logits.shape != (1, SEAMLESS_PREFILL, cfg.vocab) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                                 "not finite")
        fwd = logits[:, :LM_PROMPT].clone()
        del logits
    prefill_profile = profile_prefill(cfg, params, seq, audio=frames)
    with torch.inference_mode():
        enc = encode(cfg, params, frames)
        zero_attn_counts(fmod, dmod)                 # cross-check starts
        dec = teacher_forced(cfg, params, seq[:, :LM_PROMPT], enc_out=enc)
        cross_counts = attn_counts(fmod, dmod)       # ... and ends here
    gap = rel_err(dec, fwd)
    agree = float((dec.argmax(-1) == fwd.argmax(-1)).float().mean())
    if cross_counts["decode"] != 2 * n * LM_PROMPT or \
            cross_counts["flash"] != 0:
        raise AssertionError(f"seamless_serve cross-check launches "
                             f"{cross_counts}")
    check_routes("seamless_serve cross-check", cross_counts, "decode",
                 "tensor_core")
    if not gap <= LM_BF16_TOL or not torch.isfinite(dec).all():
        raise AssertionError(f"seamless_serve: decode vs prefill relative "
                             f"gap {gap} > {LM_BF16_TOL}")
    ms_step = 1e3 * serve_s / steps
    emit({"phase": "seamless_serve", "config": cfg.name, "dtype": cfg.dtype,
          "layers": n, "encoder_layers": ne, "head_dim": cfg.hd,
          "params": param_count(params), "init_s": init_s,
          "serve": {"batch": LM_BATCH, "prompt": LM_PROMPT,
                    "steps": LM_STEPS, "seconds": serve_s,
                    "frames": "f32 zeros, encoded once (the reference's)",
                    "generated_tokens_per_s": LM_BATCH * LM_STEPS / serve_s,
                    "ms_per_decode_step": ms_step,
                    "launches": {k: serve_counts[k] for k in (
                        "flash", "flash_noncausal", "decode")},
                    "flash_launches_by_route": serve_counts["flash_routes"],
                    "decode_launches_by_route":
                        serve_counts["decode_routes"],
                    "cross_step_decode_launches":
                        serve_counts["decode_routes"]["f32_fma"],
                    "peak_allocated_bytes": serve_peak,
                    "first_tokens": tokens[:, :8].tolist(),
                    "profiled_decode_steps": profile},
          "prefill": {"tokens": SEAMLESS_PREFILL,
                      "frames": "bf16 from --seed", "seconds": prefill_s,
                      "tokens_per_s": SEAMLESS_PREFILL / prefill_s,
                      "flash_launches": prefill_counts["flash"],
                      "flash_cross_launches": prefill_counts["flash_cross"],
                      "flash_noncausal_launches":
                          prefill_counts["flash_noncausal"],
                      "flash_launches_by_route":
                          prefill_counts["flash_routes"],
                      "peak_allocated_bytes": prefill_peak,
                      "profiled": prefill_profile},
          "decode_vs_prefill": {"positions": LM_PROMPT, "rel_gap": gap,
                                "tol": LM_BF16_TOL,
                                "argmax_agreement": agree,
                                "decode_launches": cross_counts["decode"]},
          "idle_share_decode": 1.0 - profile["device_busy_ms_per_step"]
          / ms_step})
    del params, dec, fwd, enc, frames
    torch.cuda.empty_cache()
    return {"flash": serve_counts["flash"] + prefill_counts["flash"],
            "decode": serve_counts["decode"],
            "decode_crosscheck": cross_counts["decode"],
            **{k: serve_counts[k] + prefill_counts[k]
               for k in ("flash_cross", "flash_noncausal")},
            "flash_routes": {r: serve_counts["flash_routes"][r]
                             + prefill_counts["flash_routes"][r]
                             for r in serve_counts["flash_routes"]},
            "decode_routes": {r: serve_counts["decode_routes"][r]
                              + cross_counts["decode_routes"][r]
                              for r in serve_counts["decode_routes"]},
            # serve's cross steps: its f32 launches (its self steps are bf16).
            "decode_cross_step": serve_counts["decode_routes"]["f32_fma"]}


def phase_seamless_train(fmod, dmod, seed: int) -> dict:
    """SeamlessM4T-medium's bf16 CONFIG at full width and depth (12 + 12
    layers, remat on): `train_phase` with two microbatches of
    TokenPipeline(256206, 512, 4) a step, each with (4, 1024, 1024) bf16
    frames from --seed, SEAMLESS_TRAIN_STEPS steps; every encoder and
    cross-attention launch, forward and backward, non-causal on the
    tensor-core route."""
    from repro_torch.configs import get_config
    return train_phase(fmod, dmod, seed, "seamless_train",
                       get_config("seamless_m4t_medium"), LM_TRAIN_SEQ,
                       LM_TRAIN_BATCH, SEAMLESS_TRAIN_STEPS)


def phase_stacked_check(fmod, dmod, seed: int) -> dict:
    """`models.stacked` at full width in float32: seamless_check's model
    (2 + 2 layers) and RecurrentGemma-2B cut to 4 layers (its unit of 3
    once, then 1 remainder layer), each drawn by `init_params_stacked` and
    `init_params` from the same seed: `forward_scan` against `forward` and
    STACKED_STEPS teacher-forced `decode_step_scan` steps against
    `decode_step`, within the reference test's atol STACKED_ATOL and rtol
    STACKED_RTOL, printing whether the two are equal bit for bit. Returns
    the launches of the stacked paths."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import (
        decode_step, encode, forward, init_decode_state, init_params,
    )
    from repro_torch.models import stacked as st

    rg = dataclasses.replace(get_config("recurrentgemma_2b"), n_layers=4,
                             dtype="float32", remat=False)
    results, launches = {}, []
    for label, cfg in (("seamless", seamless_check_cfg()),
                       ("recurrentgemma", rg)):
        torch.cuda.empty_cache()
        gen = torch.Generator(device=DEV).manual_seed(seed + 18)
        sp = st.init_params_stacked(cfg, torch.Generator(
            device=DEV).manual_seed(seed + 19), device=DEV)
        params = init_params(cfg, torch.Generator(device=DEV).manual_seed(
            seed + 19), device=DEV)
        tokens = torch.randint(0, cfg.vocab, (2, STACKED_SEQ), device=DEV,
                               generator=gen)
        audio = seamless_audio(cfg, 2, gen) if cfg.is_enc_dec else None
        with torch.inference_mode():
            ref, _ = forward(cfg, params, tokens, audio_embeds=audio)
            zero_attn_counts(fmod, dmod)                 # scan starts
            out, _ = st.forward_scan(cfg, sp, tokens, audio_embeds=audio)
            enc = None if audio is None else st.encode_scan(cfg, sp, audio)
            state = st.init_decode_state_stacked(cfg, 2, STACKED_STEPS,
                                                 device=DEV)
            rows = []
            for t in range(STACKED_STEPS):
                logits, state = st.decode_step_scan(
                    cfg, sp, tokens[:, t:t + 1], state, enc_out=enc)
                rows.append(logits[:, 0])
            counts = attn_counts(fmod, dmod)             # ... and ends here
            dec = torch.stack(rows, 1)
            flat_enc = None if audio is None else encode(cfg, params, audio)
            flat_state = init_decode_state(cfg, 2, STACKED_STEPS, device=DEV)
            rows = []
            for t in range(STACKED_STEPS):
                logits, flat_state = decode_step(cfg, params,
                                                 tokens[:, t:t + 1],
                                                 flat_state, enc_out=flat_enc)
                rows.append(logits[:, 0])
            flat_dec = torch.stack(rows, 1)
        pairs = {"forward": (out, ref), "decode": (dec, flat_dec)}
        row = {}
        for name, (got, want) in pairs.items():
            delta = (got - want).abs()
            ratio = float((delta / (STACKED_ATOL + STACKED_RTOL
                                    * want.abs())).max())
            row[name] = {"max_abs_err": float(delta.max()),
                         "max_err_over_limit": ratio,
                         "bit_for_bit": bool(torch.equal(got, want))}
            if not ratio <= 1.0 or not torch.isfinite(got).all():
                raise AssertionError(f"stacked_check {label} {name}: "
                                     f"{row[name]}")
        # forward_scan's attention layers (and, for the encoder-decoder,
        # its cross-attention and encoder layers, and encode_scan's); one
        # decode launch a layer and step, two with cross-attention.
        n_attn, ne = n_attention_layers(cfg), cfg.encoder_layers
        want = (n_attn * (2 if ne else 1) + 2 * ne,
                n_attn * (2 if ne else 1) * STACKED_STEPS)
        if (counts["flash"], counts["decode"]) != want:
            raise AssertionError(f"stacked_check {label}: flash, decode "
                                 f"launches {counts['flash']}, "
                                 f"{counts['decode']}, want {want}")
        results[label] = {"config": cfg.name, "layers": cfg.n_layers,
                          "encoder_layers": cfg.encoder_layers,
                          "repeats_remainder": list(st.group_split(cfg)),
                          "unit": [k.value for k in st.unit_kinds(cfg)],
                          **row, "flash_launches": counts["flash"],
                          "decode_launches": counts["decode"]}
        launches.append(counts)
        del sp, params, out, ref, dec, flat_dec, state, flat_state
    emit({"phase": "stacked_check", "tokens": STACKED_SEQ,
          "decode_steps": STACKED_STEPS, "atol": STACKED_ATOL,
          "rtol": STACKED_RTOL, "models": results})
    torch.cuda.empty_cache()
    return add_counts(*launches)


def phase_moe_check(fmod, dmod, seed: int) -> dict:
    """Mixtral 8x22B's published widths cut to 2 layers, float32, batch
    2 x 128: `forward` and a teacher-forced `decode_step` at every position
    against the script's own float64 forward, routed as each path routes
    (the forward all 256 tokens together, decode one position's 2 tokens
    at a time) with the reference's capacity, drops and combine, within
    LM_REL_TOL; every layer MOE, so no window and full caches. Prints the
    dropped assignments and counts the router picks that differ from
    float64's. Returns the launches."""
    import torch
    from repro_torch.configs.mixtral_8x22b import CONFIG
    from repro_torch.models import (
        forward, init_decode_state, init_params, param_count,
    )

    cfg = dataclasses.replace(CONFIG, n_layers=2, dtype="float32")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV).manual_seed(seed + 9)
    params = init_params(cfg, gen, device=DEV)
    tokens = torch.randint(0, cfg.vocab, (2, LM_PROMPT), device=DEV,
                           generator=gen)
    if any("slot_pos" in st for st in init_decode_state(
            cfg, 1, 2, device=DEV)["layers"]):
        raise AssertionError("moe_check: an MOE layer got a ring cache")
    with torch.inference_mode():
        zero_attn_counts(fmod, dmod)                     # forward starts
        with RouterSpy() as f_spy:
            logits, aux = forward(cfg, params, tokens)
        fwd_counts = attn_counts(fmod, dmod)             # ... and ends here
        zero_attn_counts(fmod, dmod)                     # decode starts
        t0 = time.perf_counter()
        with RouterSpy() as d_spy:
            dec = teacher_forced(cfg, params, tokens)
        sync()
        decode_s = time.perf_counter() - t0
        dec_counts = attn_counts(fmod, dmod)             # ... and ends here
        f_routes, d_routes = [], []
        ref = f64_lm_forward(cfg, params, tokens, routes=f_routes)
        ref_dec = f64_lm_forward(cfg, params, tokens, per_position=True,
                                 routes=d_routes)
    n, s_len = cfg.n_layers, LM_PROMPT
    # Port decode: call t·n + l; float64 per position: call l·S + t.
    other = {"forward": picks_unlike(f_spy.routes, f_routes),
             "decode": sum(int((d_spy.routes[t * n + li]
                                != d_routes[li * s_len + t]).any(-1).sum())
                           for li in range(n) for t in range(s_len))}
    drops = {"forward": [dropped(cfg, r) for r in f_spy.routes],
             "decode": sum(dropped(cfg, r) for r in d_spy.routes)}
    errs = {"forward": rel_err(logits, ref), "decode": rel_err(dec, ref_dec),
            "decode_vs_forward": rel_err(dec, logits)}
    flash, decode = fwd_counts["flash"], dec_counts["decode"]
    if (flash, fwd_counts["decode"], dec_counts["flash"], decode) != (
            n, 0, 0, n * s_len):
        raise AssertionError(f"moe_check launches: forward {fwd_counts}, "
                             f"decode {dec_counts}; want flash {n}, decode "
                             f"{n * s_len}")
    check_routes("moe_check forward", fwd_counts, "flash", "f32_fma")
    check_routes("moe_check decode", dec_counts, "decode", "f32_fma")
    bad = {k: e for k, e in errs.items()
           if k != "decode_vs_forward" and not e <= LM_REL_TOL}
    if bad:
        raise AssertionError(f"moe_check: relative error above {LM_REL_TOL}: "
                             f"{bad}; router picks unlike float64's {other}")
    emit({"phase": "moe_check", "config": "mixtral-8x22b width, 2 layers, "
          "float32", "params": param_count(params), "batch": 2,
          "tokens": s_len, "experts": cfg.n_experts, "top_k": cfg.top_k,
          "aux": float(aux), "rel_err_vs_float64": errs, "tol": LM_REL_TOL,
          "dropped_assignments": drops,
          "router_picks_unlike_float64": other,
          "decode_seconds": decode_s, "flash_launches": flash,
          "decode_launches": decode,
          "launches_by_route": {"flash": fwd_counts["flash_routes"],
                                "decode": dec_counts["decode_routes"]},
          "peak_allocated_bytes": torch.cuda.max_memory_allocated()})
    del params, logits, dec, ref, ref_dec
    torch.cuda.empty_cache()
    return {"flash": flash, "decode": decode,
            "flash_routes": fwd_counts["flash_routes"],
            "decode_routes": dec_counts["decode_routes"],
            "flash_softcap": 0, "decode_softcap": 0}


def phase_mixtral_serve(fmod, dmod, seed: int) -> dict:
    """Mixtral 8x22B's bf16 CONFIG at published widths cut to
    MIXTRAL_SERVE_LAYERS layers (60.9 GB of weights from --seed): serve,
    a 4096-token prefill forward and decode against the forward, with the
    MoE routing rule (MOE_FLIP_RULE); every launch on the tensor-core
    route, none softcapped."""
    return serve_phase(fmod, dmod, seed, "mixtral_8x22b", LM_PREFILL,
                       "mixtral_serve", n_layers=MIXTRAL_SERVE_LAYERS)


def phase_moe_train_check(fmod, dmod, seed: int) -> dict:
    """Mixtral 8x22B's published widths cut to MOE_TRAIN_CHECK_LAYERS f32
    layers, no remat, one sequence of LM_TRAIN_SEQ tokens: `grad_check`
    through the flash kernels and the backward (f32 FMA routes, d = 128)
    against float64 autograd routed as the port routed, with the aux term,
    in passes of at most MOE_F64_GROUP_BYTES; every layer tensor (the
    attention's, the norms, w_router, w_gate, w_up, w_down) and the final
    norm within LM_GRAD_REL_TOL. Returns the launches."""
    import torch
    from repro_torch.configs.mixtral_8x22b import CONFIG
    from repro_torch.models import init_params

    cfg = dataclasses.replace(CONFIG, n_layers=MOE_TRAIN_CHECK_LAYERS,
                              dtype="float32", remat=False)
    torch.cuda.empty_cache()
    gen = torch.Generator(device=DEV).manual_seed(seed + 13)
    params = init_params(cfg, gen, device=DEV)
    tokens = torch.randint(0, cfg.vocab, (1, LM_TRAIN_SEQ), device=DEV,
                           generator=gen)
    counts, out = grad_check(fmod, dmod, "moe_train_check", cfg, params,
                             tokens, f64_group_bytes=MOE_F64_GROUP_BYTES)
    check_step_launches("moe_train_check", counts, cfg.n_layers, "f32_fma",
                        capped=False, wide=False, prefix=False)
    moe = [n for n in out["grad_rel_err_vs_float64"] if "/moe/" in n]
    if len(moe) != 4 * cfg.n_layers:
        raise AssertionError(f"moe_train_check: compared {moe}")
    emit({"phase": "moe_train_check",
          "config": f"mixtral-8x22b width, {cfg.n_layers} layers, float32, "
                    "no remat", "experts": cfg.n_experts, "top_k": cfg.top_k,
          "capacity_factor": cfg.capacity_factor, **out})
    del params
    torch.cuda.empty_cache()
    return counts


def phase_moe_train(fmod, dmod, seed: int) -> dict:
    """Mixtral 8x22B's bf16 CONFIG (remat on, published widths) cut to
    MOE_TRAIN_LAYERS layer: `train_phase` with two microbatches of
    TokenPipeline(32768, 512, 4), MOE_TRAIN_STEPS steps; every launch on
    the tensor-core route at d = 128, none softcapped."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("mixtral_8x22b"),
                              n_layers=MOE_TRAIN_LAYERS)
    return train_phase(fmod, dmod, seed, "moe_train", cfg, LM_TRAIN_SEQ,
                       LM_TRAIN_BATCH, MOE_TRAIN_STEPS)


def phase_moe_shard_map_check(seed: int) -> dict:
    """`models.moe_shard_map` on the card: a one-rank NCCL process group
    (a HashStore, world size 1) under a (1, 1) ("data", "model")
    DeviceMesh; one Mixtral layer's experts at published widths, 2 x 128
    tokens at capacity factor SHARD_MAP_CAPACITY. In f32 the output, aux
    and the gradients of Σ out·g + aux (x, the router and the three banks)
    against `moe_ffn`'s at the same weights, within LM_REL_TOL and
    LM_GRAD_REL_TOL; in bf16 the output within LM_BF16_TOL and the
    gradients finite and nonzero. Prints the all-to-all bytes a call and
    the time of one call beside `moe_ffn`'s."""
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs.mixtral_8x22b import CONFIG
    from repro_torch.models import init_params
    from repro_torch.models.layers import moe_ffn
    from repro_torch.models.moe_shard_map import moe_ffn_shard_map

    torch.cuda.empty_cache()
    cfg = dataclasses.replace(CONFIG, n_layers=1, dtype="float32",
                              capacity_factor=SHARD_MAP_CAPACITY)
    gen = torch.Generator(device=DEV).manual_seed(seed + 14)
    bank = init_params(cfg, gen, device=DEV)["layers"][0]["moe"]
    torch.cuda.empty_cache()
    x = torch.randn((*SHARD_MAP_TOKENS, cfg.d_model), device=DEV,
                    generator=gen)
    g = torch.randn(x.shape, device=DEV, generator=gen)
    dist.init_process_group("nccl" if DEV == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh(DEV, (1, 1),
                                mesh_dim_names=("data", "model"))

        def run(fn, p, xin):
            p = {k: v.detach().requires_grad_(True) for k, v in p.items()}
            xin = xin.detach().requires_grad_(True)
            out, aux = fn(p, xin)
            loss = torch.sum(out.float() * g) + aux
            grads = torch.autograd.grad(loss, [xin, *p.values()])
            return out.detach(), aux.detach(), dict(zip(["x", *p], grads))

        def sharded(p, xin):
            return moe_ffn_shard_map(cfg, p, xin, mesh, ("data",), "model")

        def plain(p, xin):
            return moe_ffn(cfg, p, xin)

        rec = {}
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            p = {k: v.to(dt) for k, v in bank.items()}
            xd = x.to(dt)
            out_sm, aux_sm, g_sm = run(sharded, p, xd)
            out_ref, aux_ref, g_ref = run(plain, p, xd)
            errs = {"out": rel_err(out_sm, out_ref),
                    "aux": abs(float(aux_sm) - float(aux_ref))
                    / abs(float(aux_ref))}
            grad_errs = {k: rel_err(g_sm[k], g_ref[k]) for k in g_ref}
            nonzero = {k: bool(torch.isfinite(v).all() and v.abs().max() > 0)
                       for k, v in g_sm.items()}
            del g_sm, g_ref
            with torch.no_grad():
                ms = cuda_ms(lambda: sharded(p, xd), 5)
                ms_plain = cuda_ms(lambda: plain(p, xd), 5)
            t = x.shape[0] * x.shape[1]
            cap = max(1, int(cfg.capacity_factor * t * cfg.top_k / 1))
            slots = (cap + 7) // 8 * 8
            rec[dtype] = {
                "rel_err_vs_moe_ffn": errs, "grad_rel_err_vs_moe_ffn":
                    grad_errs, "grads_finite_nonzero": nonzero,
                "aux": float(aux_sm), "ms": ms, "moe_ffn_ms": ms_plain,
                "all_to_all_bytes": 2 * slots * cfg.d_model
                * xd.element_size() + slots * 8,
                "slots": slots}
            tol = LM_REL_TOL if dtype == "float32" else LM_BF16_TOL
            bad = not all(nonzero.values()) or errs["out"] > tol or (
                dtype == "float32" and (errs["aux"] > LM_REL_TOL or max(
                    grad_errs.values()) > LM_GRAD_REL_TOL))
            if bad:
                raise AssertionError(f"moe_shard_map_check {dtype}: "
                                     f"{rec[dtype]}")
            del p, xd
            torch.cuda.empty_cache()
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    emit({"phase": "moe_shard_map_check", "config": "mixtral-8x22b width, "
          "one layer's experts", "mesh": [1, 1], "backend": backend,
          "tokens": list(SHARD_MAP_TOKENS),
          "capacity_factor": SHARD_MAP_CAPACITY,
          "exchange": "autograd.Function over all_to_all_single, its "
                      "backward the reverse exchange",
          "functional_all_to_all_single_autograd": hasattr(
              fc, "all_to_all_single_autograd"),
          "tol": {"float32": [LM_REL_TOL, LM_GRAD_REL_TOL],
                  "bfloat16": LM_BF16_TOL}, **rec})
    del bank, x, g
    torch.cuda.empty_cache()
    return rec


def mesh_child(device_type: str) -> None:
    """mesh_check's child (its own process: it makes process groups of
    256 and 512 ranks on the "fake" backend): each production mesh,
    Mixtral's and Kimi K2's full-size meta params, stacked and the first
    layer unstacked (where the per-layer rules apply: the expert banks
    (E, d, f) and the attention's projections), and each leaf
    `distribute_tensor`ed by `tree_placements`, its local shape beside the
    one its spec implies. Prints one JSON line."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as M
    from repro_torch.launch import sharding as S
    from repro_torch.models import init_params
    from repro_torch.models.stacked import init_params_stacked

    def walk(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from walk(v, f"{path}/{k}" if path else k)
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from walk(v, f"{path}/{i}" if path else str(i))
        else:
            yield path, tree

    out = {}
    for world in MESH_WORLDS:
        t0 = time.perf_counter()
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
        mesh = M.make_production_mesh(multi_pod=world == 512,
                                      device_type=device_type)
        rec = {"names": list(mesh.mesh_dim_names), "shape": list(mesh.shape),
               "data_axes": list(M.data_axes(mesh)), "leaves": 0,
               "mismatch": {}, "specs": {}}
        for arch in ("mixtral_8x22b", "kimi_k2_1t_a32b"):
            cfg = get_config(arch)
            flat = init_params(cfg, None, device="meta")
            for tree in (init_params_stacked(cfg, None, device="meta"),
                         {**flat, "layers": flat["layers"][:1]}):
                specs = dict(walk(S.tree_pspecs(tree, mesh, fsdp=True)))
                places = dict(walk(S.tree_placements(tree, mesh,
                                                     fsdp=True)))
                for path, leaf in walk(tree):
                    local = tuple(distribute_tensor(
                        leaf, mesh, list(places[path])).to_local().shape)
                    want = S.local_shape(leaf.shape, specs[path], mesh)
                    rec["leaves"] += 1
                    rec["specs"][f"{arch}:{path}"] = [str(specs[path]),
                                                      list(local)]
                    if local != want:
                        rec["mismatch"][f"{arch}:{path}"] = [list(local),
                                                             list(want)]
        rec["seconds"] = time.perf_counter() - t0
        out[str(world)] = rec
        dist.destroy_process_group()
    print(json.dumps(out), flush=True)


def phase_mesh_check() -> dict:
    """`launch.mesh` and `launch.sharding` on this machine's torch, in a
    child process on the "fake" process-group backend: both production
    meshes ((16, 16) over 256 ranks, (2, 16, 16) over 512, CUDA meshes),
    and every Mixtral and Kimi K2 full-size meta leaf (stacked, and the
    first layer unstacked) distributed by its `tree_placements` with the
    local shape its PartitionSpec implies."""
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            f"import chip_smoke; chip_smoke.mesh_child({DEV!r})")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"mesh_check child: {proc.stderr[-3000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for world in MESH_WORLDS:
        rec = out[str(world)]
        names = (["pod"] if world == 512 else []) + ["data", "model"]
        if rec["names"] != names or rec["mismatch"] or rec["leaves"] < 20 \
                or rec["data_axes"] != names[:-1]:
            raise AssertionError(f"mesh_check {world}: {rec}")
    emit({"phase": "mesh_check", "backend": "fake", "seconds": seconds,
          **{w: {k: v for k, v in rec.items() if k != "specs"}
             for w, rec in out.items()},
          "layer0_moe_specs": {
              w: {k: v for k, v in rec["specs"].items()
                  if k.split(":")[1].startswith("layers/0/moe/")}
              for w, rec in out.items()}})
    return out


def phase_hints_check(fmod, dmod, seed: int) -> dict:
    """The sharding hints on the card: one NCCL rank (a HashStore) under a
    (1, 1) ("data", "model") DeviceMesh, bf16 Yi-6B at full width cut to
    HINTS_LAYERS layers, every param a DTensor placed by `tree_placements`,
    the tokens by `batch_pspec`. `forward` and `lm_loss` with
    MESH_AXES_SINGLE against the same calls on the plain tensors: bit for
    bit, else within LM_BF16_TOL with the reason printed; each run's flash
    launches counted through the operator (one a layer). Then one bf16
    Mixtral layer's `moe_ffn` at published widths with its two hints on
    DTensors against the plain call, within LM_BF16_TOL. Then the Yi-6B
    model's `decode_step`, HINTS_DECODE_STEPS teacher-forced steps from
    the tokens, on DTensor caches of HINTS_DECODE_LEN positions placed by
    `state_pspecs` (each rank writes and reads its own shard), against the
    plain step on plain caches: every step's logits and the last caches
    bit for bit, HINTS_LAYERS decode launches a step through the operator.
    Then the same decode with the caches' head dim placed over "model", as
    `state_pspecs` places it where the KV heads do not divide over that
    axis: each layer a step through the two kernels of the decode over a
    slice of the head dim (`decode_scores`, the all-reduce of the scores
    over "model", `decode_softmax_v`), HINTS_LAYERS launches of each a
    step and none of the decode kernel, the logits within LM_BF16_TOL of
    the plain step's (another kernel's sums). Returns the launches of the
    hinted forward, loss and both decodes."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.mixtral_8x22b import CONFIG as MIXTRAL
    from repro_torch.configs.yi_6b import CONFIG
    from repro_torch.launch.sharding import (batch_pspec, placements,
                                             state_pspecs, tree_placements)
    from repro_torch.models import (decode_step, forward, init_decode_state,
                                    init_params, lm_loss)
    from repro_torch.models.layers import moe_ffn
    from repro_torch.models.transformer import MESH_AXES_SINGLE
    from repro_torch.train.optim import tree_map

    torch.cuda.empty_cache()
    cfg = dataclasses.replace(CONFIG, n_layers=HINTS_LAYERS)
    gen = torch.Generator(device=DEV).manual_seed(seed + 30)
    params = init_params(cfg, gen, device=DEV)
    tokens = torch.randint(0, cfg.vocab, HINTS_TOKENS, device=DEV,
                           generator=gen)
    labels = torch.roll(tokens, -1, dims=1)
    moe_cfg = dataclasses.replace(MIXTRAL, n_layers=1)
    bank = init_params(moe_cfg, gen, device=DEV)["layers"][0]["moe"]
    x = torch.randn((*HINTS_MOE_TOKENS, moe_cfg.d_model), device=DEV,
                    generator=gen).to(torch.bfloat16)
    dist.init_process_group("nccl" if DEV == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh(DEV, (1, 1),
                                mesh_dim_names=("data", "model"))
        dp = tree_map(lambda t, p: distribute_tensor(t, mesh, list(p)),
                      params, tree_placements(params, mesh))
        tok_pl = list(placements(batch_pspec(tokens.shape, mesh), mesh))
        d_tok, d_lab = (distribute_tensor(t, mesh, tok_pl)
                        for t in (tokens, labels))
        rec, counts = {}, {}
        with torch.no_grad():
            want_logits, _ = forward(cfg, params, tokens)
            want_loss = lm_loss(cfg, params, tokens, labels)
            zero_attn_counts(fmod, dmod)             # hinted forward starts
            got_logits, _ = forward(cfg, dp, d_tok,
                                    mesh_axes=MESH_AXES_SINGLE)
            counts["forward"] = attn_counts(fmod, dmod)  # ... and ends here
            zero_attn_counts(fmod, dmod)             # hinted loss starts
            got_loss = lm_loss(cfg, dp, d_tok, d_lab,
                               mesh_axes=MESH_AXES_SINGLE)
            counts["lm_loss"] = attn_counts(fmod, dmod)  # ... and ends here
            rec["logits_placements"] = str(got_logits.placements)
            got_logits = got_logits.to_local()
            got_loss = got_loss.full_tensor()
            for name, got, want in (("logits", got_logits, want_logits),
                                    ("loss", got_loss, want_loss)):
                equal = torch.equal(got, want)
                rec[name] = {"bit_equal": equal,
                             "rel_err": rel_err(got, want)}
                if not equal:
                    rec[name]["why"] = (
                        "the hinted call's DTensor ops ran other kernels "
                        "than the plain call's on the same local tensors")
            del want_logits, got_logits
            moe_want, aux_want = moe_ffn(moe_cfg, bank, x)
            bank_pl = tree_placements({"moe": bank}, mesh)["moe"]
            d_bank = {k: distribute_tensor(v, mesh, list(bank_pl[k]))
                      for k, v in bank.items()}
            with implicit_replication():
                moe_got, aux_got = moe_ffn(
                    moe_cfg, d_bank,
                    distribute_tensor(x, mesh, list(placements(
                        batch_pspec(x.shape, mesh), mesh))),
                    mesh_axes=MESH_AXES_SINGLE)
            moe_got = moe_got.full_tensor()
            rec["moe_ffn"] = {"bit_equal": torch.equal(moe_got, moe_want),
                              "rel_err": rel_err(moe_got, moe_want),
                              "aux_equal": bool(torch.equal(
                                  aux_got.full_tensor(), aux_want))}
            del moe_want, moe_got, d_bank
            want_state = init_decode_state(cfg, tokens.shape[0],
                                           HINTS_DECODE_LEN, device=DEV)
            got_state = init_decode_state(cfg, tokens.shape[0],
                                          HINTS_DECODE_LEN, device=DEV)
            st_specs = state_pspecs(got_state, mesh)
            got_state["layers"] = [
                {k: distribute_tensor(t, mesh, list(placements(sp[k], mesh)))
                 for k, t in layer.items()}
                for layer, sp in zip(got_state["layers"],
                                     st_specs["layers"])]
            step_pl = list(placements(batch_pspec((tokens.shape[0], 1),
                                                  mesh), mesh))
            want_steps, got_steps = [], []
            for i in range(HINTS_DECODE_STEPS):
                tok = tokens[:, i:i + 1].contiguous()
                lg, want_state = decode_step(cfg, params, tok, want_state)
                want_steps.append(lg)
            zero_attn_counts(fmod, dmod)             # hinted decode starts
            for i in range(HINTS_DECODE_STEPS):
                tok = distribute_tensor(tokens[:, i:i + 1].contiguous(),
                                        mesh, step_pl)
                lg, got_state = decode_step(cfg, dp, tok, got_state)
                got_steps.append(lg)
            counts["decode"] = attn_counts(fmod, dmod)  # ... and ends here
            got_all = torch.cat([g.full_tensor() for g in got_steps], 1)
            want_all = torch.cat(want_steps, 1)
            caches = [torch.equal(g[k].full_tensor(), w[k])
                      for g, w in zip(got_state["layers"],
                                      want_state["layers"]) for k in w]
            rec["decode"] = {"steps": HINTS_DECODE_STEPS,
                             "cache_len": HINTS_DECODE_LEN,
                             "bit_equal": torch.equal(got_all, want_all),
                             "caches_bit_equal": all(caches),
                             "rel_err": rel_err(got_all, want_all)}
            del want_state, got_state
            hd_state = init_decode_state(cfg, tokens.shape[0],
                                         HINTS_DECODE_LEN, device=DEV)
            hd_pl = [Shard(0), Shard(3)]   # batch over "data", hd "model"
            hd_state["layers"] = [
                {k: distribute_tensor(t, mesh, hd_pl)
                 for k, t in layer.items()} for layer in hd_state["layers"]]
            hd_steps = []
            zero_attn_counts(fmod, dmod)             # head-dim decode starts
            for i in range(HINTS_DECODE_STEPS):
                tok = distribute_tensor(tokens[:, i:i + 1].contiguous(),
                                        mesh, step_pl)
                lg, hd_state = decode_step(cfg, dp, tok, hd_state)
                hd_steps.append(lg)
            counts["decode_head_dim"] = attn_counts(fmod, dmod)  # ... ends
            hd_all = torch.cat([g.full_tensor() for g in hd_steps], 1)
            rec["decode_head_dim"] = {
                "steps": HINTS_DECODE_STEPS, "cache_len": HINTS_DECODE_LEN,
                "cache_placements": str(hd_state["layers"][0]["k"]
                                        .placements),
                "rel_err": rel_err(hd_all, want_all),
                "bit_equal": torch.equal(hd_all, want_all)}
            del hd_state, hd_all
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    n_dec = HINTS_LAYERS * HINTS_DECODE_STEPS
    for label, c in counts.items():
        want = {"decode": (0, 0, n_dec, 0, 0),
                "decode_head_dim": (0, 0, 0, n_dec, n_dec)}.get(
                    label, (HINTS_LAYERS, 0, 0, 0, 0))
        if (c["flash"], c["flash_bwd"], c["decode"], c["decode_scores"],
                c["decode_softmax_v"]) != want:
            raise AssertionError(f"hints_check {label}: launches {c}, want "
                                 f"(flash, backward, decode, decode_scores, "
                                 f"decode_softmax_v) {want}")
    for name in ("logits", "loss", "moe_ffn", "decode_head_dim"):
        if rec[name]["rel_err"] > LM_BF16_TOL:
            raise AssertionError(f"hints_check {name}: {rec[name]}")
    if not (rec["decode"]["bit_equal"] and rec["decode"]["caches_bit_equal"]):
        raise AssertionError(f"hints_check decode: {rec['decode']}")
    emit({"phase": "hints_check", "config": "yi-6b width, 2 bf16 layers; "
          "one bf16 mixtral-8x22b layer's moe_ffn", "mesh": [1, 1],
          "backend": backend, "tokens": list(HINTS_TOKENS),
          "moe_tokens": list(HINTS_MOE_TOKENS), "tol": LM_BF16_TOL,
          "launches": {k: {"flash": c["flash"], "decode": c["decode"],
                           "decode_scores": c["decode_scores"],
                           "decode_softmax_v": c["decode_softmax_v"]}
                       for k, c in counts.items()}, **rec})
    del params, dp, bank, x
    torch.cuda.empty_cache()
    return add_counts(*counts.values())


def dryrun_child(arch: str, shape: str, multi_pod: bool) -> None:
    """dryrun_check's child (its own process: the dry run's fake world of
    512 ranks): `launch.dryrun.run_cell` on the card machine, the fake
    tensors on "cuda", and beside it the per-device argument bytes the
    cell's specs imply (`launch.sharding` on the full-size meta trees).
    Prints one JSON line. Runs at nice 10, beside the card phases."""
    os.nice(10)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import sharding as S
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.specs import input_specs
    from repro_torch.models.stacked import (init_decode_state_stacked,
                                            init_params_stacked)
    from repro_torch.train.optim import make_optimizer, tree_leaves

    t0 = time.perf_counter()
    res = D.run_cell(arch, shape, multi_pod)
    seconds = time.perf_counter() - t0
    cfg, spec = get_config(arch), SHAPES[shape]
    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model")) \
        if multi_pod else AbstractMesh((16, 16), ("data", "model"))
    params = init_params_stacked(cfg, None, device="meta")
    header = D.cell_header(cfg, spec, params)
    p_specs = S.tree_pspecs(params, mesh, fsdp=header["fsdp"])
    trees = [(params, p_specs)]
    batch = input_specs(cfg, spec)
    trees.append((batch, {k: S.batch_pspec(v.shape, mesh)
                          for k, v in batch.items()}))
    if spec["kind"] == "train":
        opt = make_optimizer(header["optimizer"])[0](params)
        trees.append((opt, S.opt_state_pspecs(opt, p_specs, mesh)))
    elif spec["kind"] == "decode":
        state = init_decode_state_stacked(cfg, spec["global_batch"],
                                          spec["seq_len"], device="meta")
        st_specs = S.state_pspecs(state, mesh)
        trees.append((state, st_specs))
        res["spec_cache_bytes"] = sum(
            math.prod(S.local_shape(unit[k].shape, sp[k], mesh))
            * unit[k].element_size()
            for unit, sp in zip(state["scan"] + state["rest"],
                                st_specs["scan"] + st_specs["rest"])
            for k in ("k", "v") if k in unit)

    def local_bytes(tree, specs) -> int:
        leaves = tree_leaves(tree)
        spec_leaves = tree_leaves(specs)
        return sum(4 if isinstance(t, int) else math.prod(
            S.local_shape(t.shape, sp, mesh)) * t.element_size()
            for t, sp in zip(leaves, spec_leaves))

    res["spec_argument_bytes"] = sum(local_bytes(t, sp) for t, sp in trees)
    res["child_seconds"] = seconds
    print(json.dumps(res), flush=True)


# Processes started by this run that outlive a phase (dryrun_check's
# children); `main` stops them, whatever happens.
CHILDREN = []


def start_dryrun_check() -> dict:
    """Start dryrun_check's children: DRYRUN_CELLS, each `run_cell` in a
    process of its own on the "fake" backend, which lowers its own CPU
    priority (nice 10), their output to temporary files. They trace beside the card phases that follow (no storage on
    the card: the fake tensors allocate nothing), and
    `phase_dryrun_check` collects them before the timing phase."""
    import tempfile
    run = {"started": time.perf_counter(), "children": []}
    for arch, shape, multi in DRYRUN_CELLS:
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        proc = subprocess.Popen(
            [sys.executable, "-c",
             f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
             f"import chip_smoke; chip_smoke.dryrun_child({arch!r}, "
             f"{shape!r}, {multi!r})"],
            cwd=ROOT, stdout=out, stderr=err, text=True)
        CHILDREN.append(proc)
        run["children"].append((proc, out, err))
    return run


def phase_dryrun_check(run: dict) -> dict:
    """`launch.dryrun` on this machine's torch: collects the children
    `start_dryrun_check` started (DRYRUN_CELLS, the fake tensors on
    "cuda", so that the attention nodes are the kernels' operators),
    stopping them at DRYRUN_TIMEOUT_S from their start. Each must come
    back ok, with its per-device argument bytes equal to the local-shard
    sum of its specs. Prints each cell's params, per-device argument,
    temp and output bytes, FLOPs, collective bytes by kind and trace
    seconds, the seconds from the children's start beside DRYRUN_TARGET_S
    and the seconds this phase waited for them. The figures are planning
    numbers on the fake backend, not measurements of the card."""
    t0 = time.perf_counter()
    outs = []
    try:
        for proc, out, err in run["children"]:
            proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S - (
                time.perf_counter() - run["started"])))
            out.seek(0)
            err.seek(0)
            outs.append((out.read(), err.read()))
    finally:
        for proc, _, _ in run["children"]:
            proc.kill()
    waited = time.perf_counter() - t0
    seconds = time.perf_counter() - run["started"]
    procs = [proc for proc, _, _ in run["children"]]
    cells = {}
    for (arch, shape, multi), p, (out, err) in zip(DRYRUN_CELLS, procs,
                                                   outs):
        if p.returncode != 0:
            raise AssertionError(f"dryrun_check {arch} {shape}: "
                                 f"{err[-3000:]}")
        res = json.loads(out.strip().splitlines()[-1])
        name = f"{arch}__{shape}__{'multi' if multi else 'single'}"
        if not res.get("ok"):
            raise AssertionError(f"dryrun_check {name}: {res.get('error')} "
                                 f"{res.get('traceback')}")
        mem = res["memory"]
        if mem["argument_bytes"] != res["spec_argument_bytes"]:
            raise AssertionError(f"dryrun_check {name}: argument bytes "
                                 f"{mem['argument_bytes']}, its specs "
                                 f"{res['spec_argument_bytes']}")
        if "spec_cache_bytes" in res and arch == "mixtral_8x22b":
            if res["collectives"]["bytes"] >= res["spec_cache_bytes"]:
                raise AssertionError(
                    f"dryrun_check {name}: {res['collectives']['bytes']} "
                    f"collective bytes, not below the local caches' "
                    f"{res['spec_cache_bytes']}")
        cells[name] = {
            "params": res["params"], "fsdp": res["fsdp"],
            "optimizer": res.get("optimizer"), "memory": mem,
            "flops": res["cost"]["flops"],
            "bytes_accessed": res["cost"]["bytes_accessed"],
            "collective_bytes": res["collectives"]["bytes"],
            "collective_bytes_by_kind": res["collectives"]["by_kind"],
            "collective_count": res["collectives"]["count"],
            "body_flops": res["body"]["cost"]["flops"],
            "trace_s": res["lower_s"], "count_s": res["compile_s"],
            "cell_s": res["elapsed_s"], "child_s": res["child_seconds"]}
        if "spec_cache_bytes" in res:
            cells[name]["local_cache_bytes"] = res["spec_cache_bytes"]
        if arch == "mixtral_8x22b":
            cells[name]["moved_cache_collective_bytes"] = \
                DRYRUN_MOVED_CACHE_BYTES
        if name in DRYRUN_BEFORE:
            cells[name]["before"] = DRYRUN_BEFORE[name]
        if arch == "qwen2_vl_72b":
            # The params' bytes a device sharded over "model" alone, and
            # each layer's K and V for the rank's sequences, bf16.
            from repro_torch.configs import SHAPES, get_config
            cfg, spec = get_config(arch), SHAPES[shape]
            weights = 2 * res["params"] / 16
            kv = (cfg.n_layers * 2 * spec["global_batch"] // 16
                  * spec["seq_len"] * cfg.n_kv_heads * cfg.hd * 2)
            gathered = res["collectives"]["by_kind"].get("all-gather", 0)
            cells[name]["model_sharded_param_bytes"] = weights
            cells[name]["kv_projection_bytes"] = kv
            if gathered > DRYRUN_GATHER_WEIGHTS * weights + kv:
                raise AssertionError(
                    f"dryrun_check {name}: {gathered} bytes of all-gather "
                    f"a device, over {DRYRUN_GATHER_WEIGHTS} x the "
                    f"{weights} bytes of its model-sharded params and "
                    f"its layers' {kv} bytes of K and V")
        if arch == "xlstm_125m" and shape == "decode_32k" and \
                res["collectives"]["bytes"] >= mem["argument_bytes"]:
            raise AssertionError(
                f"dryrun_check {name}: {res['collectives']['bytes']} "
                f"collective bytes, not below its "
                f"{mem['argument_bytes']} argument bytes")
    import torch
    emit({"phase": "dryrun_check", "backend": "fake", "device_type": "cuda",
          "seconds": seconds, "waited_s": waited,
          "target_s": DRYRUN_TARGET_S, "nice": 10,
          "torch": torch.__version__,
          "note": "per-device planning numbers on the fake backend, not "
                  "measurements of the card", "cells": cells})
    return cells


def phase_experts(seed: int) -> dict:
    """One Kimi K2 layer's expert bank at published widths (384 experts of
    w_gate, w_up (7168, 2048) and w_down (2048, 7168), bf16: 33.8 GB) in
    pinned host memory, drawn from --seed on the card a block at a time,
    streamed through `StreamedWeightProvider(hbm_budget_bytes=2 GiB,
    align=8, depth=2)`: each block's expert range and shapes, rows sampled
    from each block bit for bit against the host bank, and the uploaded
    bytes equal to the bank's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.io import ExpertBank, StreamedWeightProvider

    cfg = get_config("kimi_k2_1t_a32b")
    e, d, f = cfg.n_experts, cfg.d_model, cfg.expert_d_ff
    shapes = {"w_gate": (e, d, f), "w_up": (e, d, f), "w_down": (e, f, d)}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # Pinned by cudaHostRegister: the caching host allocator behind
    # pin_memory=True would round each 11.3 GB array up to 16 GiB.
    host = {k: torch.empty(shp, dtype=torch.bfloat16)
            for k, shp in shapes.items()}
    cudart = torch.cuda.cudart() if DEV == "cuda" else None
    for a in host.values() if cudart else ():
        err = cudart.cudaHostRegister(a.data_ptr(),
                                      a.numel() * a.element_size(), 0)
        if int(getattr(err, "value", err)) != 0 or not a.is_pinned():
            raise RuntimeError(f"experts: cudaHostRegister failed ({err})")
    pin_s = time.perf_counter() - t0
    gen = torch.Generator(device=DEV).manual_seed(seed + 11)
    t0 = time.perf_counter()
    for k, a in host.items():            # drawn on the card, 24 at a time
        for s0 in range(0, e, 24):
            a[s0:s0 + 24].copy_(torch.randn(
                a[s0:s0 + 24].shape, generator=gen, device=DEV,
                dtype=torch.bfloat16))
    sync()
    fill_s = time.perf_counter() - t0
    bank = ExpertBank(layer=0, arrays=host)
    bank_bytes = bank.expert_bytes() * e
    budget = EXPERTS_BUDGET
    provider = StreamedWeightProvider([bank], hbm_budget_bytes=budget,
                                      align=8, depth=2, device=DEV)
    blocks = provider.blocks_for(bank)
    size = max(8, budget // bank.expert_bytes() // 8 * 8)   # 24 at 2 GiB
    want = [(s0, min(s0 + size, e)) for s0 in range(0, e, size)]
    if provider.block_size != size or blocks != want:
        raise AssertionError(f"experts: block_size {provider.block_size}, "
                             f"blocks {blocks}")
    rows = torch.randint(0, f, (4,), generator=torch.Generator().manual_seed(
        seed))
    samples, seen = [], []
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    for (s0, s1), arrays in provider.stream_layer(bank):
        seen.append((s0, s1))
        for k, a in arrays.items():
            if tuple(a.shape) != (s1 - s0, *shapes[k][1:]) or \
                    a.device.type != DEV:
                raise AssertionError(f"experts: block {s0}:{s1} {k} "
                                     f"{tuple(a.shape)} on {a.device}")
            samples.append((k, s0, a[:, rows.to(DEV)].clone()))
    sync()
    stream_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    mismatched = [(k, s0) for k, s0, got in samples
                  if not torch.equal(got.cpu(),
                                     host[k][s0:s0 + got.shape[0], rows])]
    st = provider.stats
    if seen != want or mismatched or st.uploaded_bytes != bank_bytes:
        raise AssertionError(f"experts: blocks {seen}, mismatched "
                             f"{mismatched}, uploaded {st.uploaded_bytes} "
                             f"of {bank_bytes}")
    emit({"phase": "experts", "config": cfg.name, "experts": e,
          "expert_bytes": bank.expert_bytes(), "bank_bytes": bank_bytes,
          "budget_bytes": budget, "align": 8, "depth": 2,
          "block_size": provider.block_size, "blocks": len(seen),
          "sampled_rows_per_block": 4 * 3, "bit_for_bit": True,
          "pin_s": pin_s, "fill_s": fill_s, "stream_s": stream_s,
          "gb_per_s": bank_bytes / stream_s / 1e9,
          "stream_stats": dataclasses.asdict(st),
          "peak_allocated_bytes": peak})
    del bank, provider, samples
    sync()
    for a in host.values() if cudart else ():
        cudart.cudaHostUnregister(a.data_ptr())
    del host
    torch.cuda.empty_cache()
    return {"blocks": len(seen), "uploaded_bytes": st.uploaded_bytes}


def time_flash(fmod, seed: int) -> dict:
    """The flash kernel at Yi-6B's per-layer prefill (train_4k length), its
    plain version and SDPA (a yardstick the port never calls)."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device=DEV).manual_seed(seed + 5)
    b, h, s_len, d = 1, 32, LM_PREFILL, 128
    q, k, v = attn_inputs((b, h, s_len, d), "bfloat16", gen)
    ms = cuda_ms(lambda: fmod.flash_attention_cuda(q, k, v, causal=True), 10)
    plain_ms = cuda_ms(lambda: fmod.flash_attention_plain(q, k, v,
                                                          causal=True),
                       3, warmup=1)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), 10)
    pairs = b * h * s_len * (s_len + 1) // 2        # causal (query, key)
    flops = 4.0 * d * pairs
    nbytes = 4 * b * h * s_len * d * q.element_size()   # q, k, v, out
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return {"shape": [b, h, s_len, d], "dtype": "bfloat16", "causal": True,
            "flops": flops, "min_bytes": nbytes, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_call": "F.scaled_dot_product_attention(is_causal=True)",
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_ms_f32_fma": 1e3 * flops / PEAK_F32_FLOPS,
            "bound_share": 1e3 * max(t_ops, t_bytes) / ms}


def time_flash_softcap(fmod, seed: int) -> dict:
    """The softcapped flash kernel at Gemma-2's per-layer prefill in
    gemma_serve (1, 32, 8192, 128) bf16, causal, window 4096, beside the
    same call without the softcap and the plain version; no single PyTorch
    call computes a softcapped attention (library_ms null). The bound
    counts the valid (query, key) pairs of the causal window."""
    import torch
    gen = torch.Generator(device=DEV).manual_seed(seed + 8)
    b, h, s_len, d, window = 1, 32, GEMMA_PREFILL, 128, 4096
    q, k, v = attn_inputs((b, h, s_len, d), "bfloat16", gen)
    kw = {"causal": True, "window": window}
    ms = cuda_ms(lambda: fmod.flash_attention_cuda(q, k, v, softcap=50.0,
                                                   **kw), 10)
    no_cap_ms = cuda_ms(lambda: fmod.flash_attention_cuda(q, k, v, **kw), 10)
    plain_ms = cuda_ms(lambda: fmod.flash_attention_plain(q, k, v,
                                                          softcap=50.0, **kw),
                       3, warmup=1)
    per_head = valid_pairs_per_head(s_len, window)
    pairs = b * h * per_head
    flops = 4.0 * d * pairs
    nbytes = 4 * b * h * s_len * d * q.element_size()   # q, k, v, out
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return {"shape": [b, h, s_len, d], "dtype": "bfloat16", "causal": True,
            "window": window, "softcap": 50.0, "valid_pairs_per_head":
            per_head, "flops": flops, "min_bytes": nbytes, "ms": ms,
            "no_softcap_ms": no_cap_ms, "plain_ms": plain_ms,
            "library_ms": None,
            "library_call": "none: no PyTorch call softcaps attention",
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_share": 1e3 * max(t_ops, t_bytes) / ms,
            "bound_share_no_softcap": 1e3 * max(t_ops, t_bytes) / no_cap_ms}


def time_flash_rgemma(fmod, seed: int) -> dict:
    """The d = 256 flash instance at rgemma_serve's per-layer prefill, (1,
    10, 4096, 256) bf16 (its single KV head repeated to the 10 query
    heads, as `layers.attention` gives it), causal within a window of
    2048; its plain version; SDPA with that window as a boolean mask (the
    same function) and causal SDPA without the window (more work, the
    fastest call SDPA has at this shape). The bound counts the valid (query,
    key) pairs of the causal window."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device=DEV).manual_seed(seed + 10)
    b, h, s_len, d, window = 1, 10, RGEMMA_PREFILL, 256, 2048
    q, k, v = attn_inputs((b, h, s_len, d), "bfloat16", gen)
    kw = {"causal": True, "window": window}
    ms = cuda_ms(lambda: fmod.flash_attention_cuda(q, k, v, **kw), 20)
    plain_ms = cuda_ms(lambda: fmod.flash_attention_plain(q, k, v, **kw), 3,
                       warmup=1)
    mask = valid_mask(s_len, window)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), 20)
    causal_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), 20)
    per_head = valid_pairs_per_head(s_len, window)
    flops = 4.0 * d * b * h * per_head
    nbytes = 4 * b * h * s_len * d * q.element_size()   # q, k, v, out
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return {"shape": [b, h, s_len, d], "dtype": "bfloat16", **kw,
            "valid_pairs_per_head": per_head, "flops": flops,
            "min_bytes": nbytes, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library_call": "F.scaled_dot_product_attention(attn_mask= the "
                            "causal window, bool)",
            "sdpa_causal_no_window_ms": causal_ms,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_ms_split_pv": 1e3 * max(1.5 * t_ops, t_bytes),
            "bound_share": 1e3 * max(t_ops, t_bytes) / ms}


def time_recurrent_blocks(seed: int) -> dict:
    """The recurrent blocks, plain PyTorch (no kernel of the reference, so
    none of the port's yet), at the serve phases' bf16 widths: each
    `*_train` at its prefill length (xLSTM-125M's sLSTM and mLSTM over
    XLSTM_PREFILL tokens, RecurrentGemma-2B's RG-LRU scan and temporal
    conv over RGEMMA_PREFILL) and each `*_step` at serve's batch, ms per
    call after a synchronise; `device_ms` the kernels' own time where a
    call launches few enough of them to trace (not the sLSTM's loop)."""
    import torch
    from repro_torch.configs import recurrentgemma_2b, xlstm_125m
    from repro_torch.models import init_params, init_decode_state
    from repro_torch.models import recurrent as R
    gen = torch.Generator(device=DEV).manual_seed(seed + 11)
    xcfg = dataclasses.replace(xlstm_125m.CONFIG, n_layers=2,
                               block_pattern=("slstm", "mlstm"))
    rcfg = dataclasses.replace(recurrentgemma_2b.CONFIG, n_layers=1)
    xl = init_params(xcfg, gen, device=DEV)["layers"]
    rec = init_params(rcfg, gen, device=DEV)["layers"][0]["rec"]
    d, w, nh = xcfg.d_model, rcfg.lru_width, xcfg.n_heads
    x = torch.randn((1, XLSTM_PREFILL, d), device=DEV,
                    generator=gen).bfloat16()
    u = torch.randn((1, RGEMMA_PREFILL, w), device=DEV,
                    generator=gen).bfloat16()
    xs = x[:LM_BATCH, :1].expand(LM_BATCH, 1, d).contiguous()
    us = u[:, :1].expand(LM_BATCH, 1, w).contiguous()
    st = init_decode_state(xcfg, LM_BATCH, 2, device=DEV)["layers"]
    h0 = R.rglru_init_state(LM_BATCH, w, device=DEV)
    conv0 = torch.zeros((LM_BATCH, rcfg.conv_width - 1, w), device=DEV,
                        dtype=torch.bfloat16)
    calls = {
        "slstm_train": (lambda: R.slstm_train(xl[0]["slstm"], x), 1, False),
        "mlstm_train": (lambda: R.mlstm_train(xl[1]["mlstm"], x, nh), 5,
                        True),
        "rglru_train": (lambda: R.rglru_train(rec, u), 5, True),
        "temporal_conv_train": (lambda: R.temporal_conv_train(
            rec, u, rcfg.conv_width), 5, True),
        "slstm_step": (lambda: R.slstm_step(xl[0]["slstm"], xs, st[0]), 50,
                       True),
        "mlstm_step": (lambda: R.mlstm_step(xl[1]["mlstm"], xs, st[1], nh),
                       50, True),
        "rglru_step": (lambda: R.rglru_step(rec, us, h0), 50, True),
        "temporal_conv_step": (lambda: R.temporal_conv_step(
            rec, us, conv0, rcfg.conv_width), 50, True),
    }
    out = {"dtype": "bfloat16", "train_tokens": {
        "slstm": XLSTM_PREFILL, "mlstm": XLSTM_PREFILL,
        "rglru": RGEMMA_PREFILL, "temporal_conv": RGEMMA_PREFILL},
        "step_batch": LM_BATCH, "widths": {"xlstm": d, "rglru": w}}
    with torch.inference_mode():
        for name, (fn, repeats, trace) in calls.items():
            out[name] = {"ms": cuda_ms(fn, repeats, warmup=1)}
            if trace:
                out[name]["device_ms"] = device_ms(fn, repeats)
    return out


def valid_mask(s_len: int, window: int = 0, prefix: int = 0):
    """(S, S) bool on the card, the flash kernels' causal mask: key j valid
    for query i iff j <= max(i, prefix - 1) and, with a window, j > i -
    window."""
    import torch
    pos = torch.arange(s_len, device=DEV)
    mask = pos[None, :] <= torch.clamp_min(pos[:, None], prefix - 1)
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    return mask


def valid_pairs_per_head(s_len: int, window: int = 0, prefix: int = 0
                         ) -> int:
    """The (query, key) pairs of one head that `valid_mask` keeps: query i
    sees the keys from max(i - window + 1, 0) (0 without a window) to
    min(max(i, prefix - 1), S - 1)."""
    return sum(max(min(max(i, prefix - 1), s_len - 1)
                   - (max(i - window + 1, 0) if window else 0) + 1, 0)
               for i in range(s_len))


def time_flash_bwd(fmod, seed: int, shape, repeats: int,
                   softcap=None, window: int = 0, prefix: int = 0) -> dict:
    """The backward kernels at `shape` (bf16, causal: the tensor-core
    route; softcapped where `softcap` is given: the CAP instances; within
    `window`, with the bidirectional `prefix`), their plain version and, as
    the yardstick the port never calls, SDPA's forward + backward less its
    forward (the same flash forward, saving its lse for the backward;
    causal, or with the window or the prefix as a bool mask, beside causal
    SDPA without them; none with a softcap, which no PyTorch call takes);
    also the forward kernel as training launches it, writing lse. The
    bound counts the valid pairs of the mask."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device=DEV).manual_seed(seed + 7)
    b, h, s_len, d = shape
    q, k, v, dout = attn_inputs(shape, "bfloat16", gen) + attn_inputs(
        shape, "bfloat16", gen)[:1]
    kw = {"window": window, "prefix": prefix}
    with torch.no_grad():
        out, lse = fmod.flash_attention_lse_cuda(q, k, v, causal=True,
                                                 softcap=softcap, **kw)
        ms = cuda_ms(lambda: fmod.flash_attention_bwd_cuda(
            q, k, v, out, dout, lse, True, window, softcap, prefix=prefix),
            repeats)
        fwd_lse_ms = cuda_ms(lambda: fmod.flash_attention_lse_cuda(
            q, k, v, causal=True, softcap=softcap, **kw), repeats)
        plain_ms = cuda_ms(lambda: fmod.flash_attention_bwd_plain(
            q, k, v, out, dout, lse, True, window, softcap, prefix=prefix),
            2, warmup=1)
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
    mask = valid_mask(s_len, window, prefix) if window or prefix else None

    def sdpa_fwd(masked=True):
        if masked and mask is not None:
            return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
        return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)

    def sdpa_bwd_ms(masked=True):
        return cuda_ms(lambda: torch.autograd.grad(
            sdpa_fwd(masked), (qs, ks, vs), dout), repeats) - cuda_ms(
                lambda: sdpa_fwd(masked), repeats)

    library_ms = None if softcap else sdpa_bwd_ms()
    pairs = b * h * valid_pairs_per_head(s_len, window, prefix)
    flops = 10.0 * d * pairs
    # q, k, v, out, dout in; dq, dk, dv out; lse in, f32.
    nbytes = 8 * b * h * s_len * d * q.element_size() + 4 * b * h * s_len
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    # What the tensor-core route's MMAs do a pair: q.k and dO.v (2·d each)
    # in each of its two kernels, at d = 256 twice in the dK/dV kernel (once
    # per dim half), and dV, dK, dQ on split P and dS, two products of 2·d
    # each: 20·d, at d = 256 24·d.
    mma_flops = (24.0 if d > 128 else 20.0) * d * pairs
    split_ms = 1e3 * max(mma_flops / PEAK_BF16_FLOPS, t_bytes)
    row = {"shape": list(shape), "dtype": "bfloat16", "causal": True,
           "softcap": softcap, "window": window, "prefix": prefix,
           "valid_pairs": pairs, "flops": flops, "min_bytes": nbytes,
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "library_call": "none: no PyTorch call softcaps attention"
                           if softcap else
                           "F.scaled_dot_product_attention(" +
                           ("attn_mask= the mask, bool" if mask is not None
                            else "is_causal=True") +
                           ") forward + backward, less its forward",
           "bound_ms": 1e3 * max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "bound_ms_f32_fma": 1e3 * flops / PEAK_F32_FLOPS,
           "bound_share": 1e3 * max(t_ops, t_bytes) / ms,
           "bound_ms_split_mma": split_ms,
           "bound_share_split_mma": split_ms / ms,
           "forward_with_lse_ms": fwd_lse_ms}
    if mask is not None and not softcap:
        row["sdpa_causal_unmasked_ms"] = sdpa_bwd_ms(masked=False)
    return row


def time_flash_prefix(fmod, seed: int) -> dict:
    """The flash forward at qwen_serve's per-layer prefill, (1, 64, 4096,
    128) bf16 (its 8 KV heads repeated to the 64 query heads, as
    `layers.attention` gives them), causal with the prefix of 256 vision
    positions; the same call without the prefix (P = 0, the plain causal
    kernel on the same shape); its plain version; SDPA with the prefix as
    a boolean mask (the same function) and causal SDPA without it. The
    bound counts the valid (query, key) pairs of the prefix mask."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device=DEV).manual_seed(seed + 13)
    b, h, s_len, d, prefix = 1, 64, LM_PREFILL, 128, QWEN_VISION_TOKENS
    q, k, v = attn_inputs((b, h, s_len, d), "bfloat16", gen)
    ms = cuda_ms(lambda: fmod.flash_attention_cuda(q, k, v, prefix=prefix),
                 20)
    no_prefix_ms = cuda_ms(lambda: fmod.flash_attention_cuda(q, k, v), 20)
    plain_ms = cuda_ms(lambda: fmod.flash_attention_plain(q, k, v,
                                                          prefix=prefix), 3,
                       warmup=1)
    mask = valid_mask(s_len, prefix=prefix)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), 20)
    causal_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), 20)
    per_head = valid_pairs_per_head(s_len, prefix=prefix)
    flops = 4.0 * d * b * h * per_head
    nbytes = 4 * b * h * s_len * d * q.element_size()   # q, k, v, out
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return {"shape": [b, h, s_len, d], "dtype": "bfloat16", "causal": True,
            "prefix": prefix, "valid_pairs_per_head": per_head,
            "flops": flops, "min_bytes": nbytes, "ms": ms,
            "no_prefix_ms": no_prefix_ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library_call": "F.scaled_dot_product_attention(attn_mask= the "
                            "prefix mask, bool)",
            "sdpa_causal_no_prefix_ms": causal_ms,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_share": 1e3 * max(t_ops, t_bytes) / ms}


def time_flash_noncausal(fmod, seed: int, shape, sk: int, repeats: int,
                         directions=("forward", "backward")) -> dict:
    """Both flash directions without the causal mask (the encoder-
    decoder's), q `shape` (B, H, Sq, d) over `sk` keys, bf16 (the
    tensor-core route): each kernel, its plain version and, as the
    yardstick the port never calls, SDPA without a mask (forward; forward
    + backward less its forward). The bound counts every (query, key)
    pair: 4·d FLOPs a pair forward, 10·d backward."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device=DEV).manual_seed(seed + 20)
    b, h, sq, d = shape
    q, dout = attn_inputs(shape, "bfloat16", gen)[:2]
    k, v = attn_inputs((b, h, sk, d), "bfloat16", gen)[:2]
    pairs = b * h * sq * sk
    rows_q, rows_k = b * h * sq * d * 2, b * h * sk * d * 2   # bf16 bytes
    out = {}
    if "forward" in directions:
        flops, nbytes = 4.0 * d * pairs, 2 * rows_q + 2 * rows_k
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
        ms = cuda_ms(lambda: fmod.flash_attention_cuda(q, k, v,
                                                       causal=False),
                     repeats)
        out["forward"] = {
            "q": list(shape), "kv": [b, h, sk, d], "dtype": "bfloat16",
            "causal": False, "pairs": pairs, "flops": flops,
            "min_bytes": nbytes, "ms": ms,
            "plain_ms": cuda_ms(lambda: fmod.flash_attention_plain(
                q, k, v, causal=False), 2, warmup=1),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v), repeats),
            "library_call": "F.scaled_dot_product_attention (no mask)",
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_share": 1e3 * max(t_ops, t_bytes) / ms}
    if "backward" in directions:
        with torch.no_grad():
            o, lse = fmod.flash_attention_lse_cuda(q, k, v, causal=False)
            ms = cuda_ms(lambda: fmod.flash_attention_bwd_cuda(
                q, k, v, o, dout, lse, False), repeats)
            plain_ms = cuda_ms(lambda: fmod.flash_attention_bwd_plain(
                q, k, v, o, dout, lse, False), 2, warmup=1)
        qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
        library_ms = cuda_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qs, ks, vs), (qs, ks, vs), dout),
            repeats) - cuda_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs), repeats)
        flops = 10.0 * d * pairs
        # q, out, dout in, dq out; k, v in, dk, dv out; lse in, f32.
        nbytes = 4 * rows_q + 4 * rows_k + 4 * b * h * sq
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
        split_ms = 1e3 * max(20.0 * d * pairs / PEAK_BF16_FLOPS, t_bytes)
        out["backward"] = {
            "q": list(shape), "kv": [b, h, sk, d], "dtype": "bfloat16",
            "causal": False, "pairs": pairs, "flops": flops,
            "min_bytes": nbytes, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library_call": "F.scaled_dot_product_attention (no mask) "
                            "forward + backward, less its forward",
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_share": 1e3 * max(t_ops, t_bytes) / ms,
            "bound_ms_split_mma": split_ms,
            "bound_share_split_mma": split_ms / ms}
    return out


def device_ms(fn, repeats: int) -> "float | None":
    """Device time per call of `fn`, which launches each of its kernels
    once: the mean duration of each kernel over a torch.profiler trace of
    `repeats` calls, summed over the kernels (None where the trace kept no
    kernel of the calls). Unlike cuda_ms it leaves out
    the gaps in which the card waits for the host; the mean, not the sum
    over `repeats`, because the trace may miss a call's kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        sync()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    if not by_name:
        return None                   # the trace kept no kernel: unmeasured
    return sum(sum(us) / len(us) for us in by_name.values()) / 1e3


def time_decode(dmod, seed: int, b: int, s_len: int,
                repeats: int = 10, n_kv: int = 4, group: int = 8,
                softcap=None, d: int = 128) -> dict:
    """The decode kernels at one layer's shape, every cache full (Yi-6B's 4
    KV heads of 8 query heads at d = 128 unless given), their plain version
    and SDPA with enable_gqa (a yardstick the port never calls; none with a
    softcap, which no PyTorch call takes). `ms` is per eager call, host
    included; `device_ms` the kernels' time on the card."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device=DEV).manual_seed(seed + 6)
    lens = torch.full((b,), s_len, dtype=torch.int32, device=DEV)
    q, k, v, lens = decode_inputs(b, n_kv, group, s_len, "bfloat16", gen,
                                  lens=lens, d=d)
    ms = cuda_ms(lambda: dmod.decode_attention_cuda(q, k, v, lens, softcap),
                 repeats)
    dev_ms = device_ms(lambda: dmod.decode_attention_cuda(q, k, v, lens,
                                                          softcap), repeats)
    plain_ms = cuda_ms(lambda: dmod.decode_attention_plain(q, k, v, lens,
                                                           softcap), 2,
                       warmup=1)
    library_ms = None
    if softcap is None:
        from torch.nn.attention import SDPBackend, sdpa_kernel
        q_sdpa = q.reshape(b, n_kv * group, 1, d)
        # Not the math backend: it would repeat K and V to every query head
        # (68 GB at decode_32k).
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION]):
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q_sdpa, k, v, enable_gqa=True), 10)
    n_valid = int(lens.long().sum())
    nbytes = (2 * n_valid * n_kv * d * k.element_size()        # K, V rows
              + 2 * q.numel() * q.element_size() + lens.numel() * 4)
    flops = 4.0 * n_valid * n_kv * group * d
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return {"q": list(q.shape), "kv": list(k.shape), "dtype": "bfloat16",
            "softcap": softcap, "lens": s_len, "splits": list(dmod.split_plan(
                b, n_kv, s_len,
                torch.cuda.get_device_properties(0).multi_processor_count,
                d)),
            "flops": flops, "min_bytes": nbytes, "ms": ms,
            "device_ms": dev_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_call": "F.scaled_dot_product_attention(enable_gqa=True)"
                            if softcap is None else
                            "none: no PyTorch call softcaps attention",
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_share": 1e3 * max(t_ops, t_bytes) / ms,
            "achieved_bytes_per_s": nbytes / (ms * 1e-3)}


def time_decode_hd(dmod, seed: int, shape, repeats: int = 20) -> dict:
    """The two kernels of the decode over a slice of the head dim at one
    rank's shape (b, n_kv, group, S, d'), bf16, every cache full, each
    beside its plain version; `ms` per eager call, `device_ms` on the
    card, and the route each took (decode_scores' by its C entry point's
    choice, `HD_SCORES_ROUTES`; decode_softmax_v has one: a split kernel and
    the combine). No PyTorch call computes either function (masked scores
    in f32 from bf16 operands; a softmax of given scores applied to V), so
    `library_ms` is None."""
    import torch
    b, n_kv, group, s_len, d = shape
    gen = torch.Generator(device=DEV).manual_seed(seed + 31)
    lens = torch.full((b,), s_len, dtype=torch.int32, device=DEV)
    q, k, v, lens = decode_inputs(b, n_kv, group, s_len, "bfloat16", gen,
                                  lens=lens, d=d)
    s = dmod.decode_scores_plain(q, k, lens)
    scale = 1.0 / (16 * d) ** 0.5
    calls = {"decode_scores": (lambda: dmod.decode_scores(q, k, lens),
                               lambda: dmod.decode_scores_plain(q, k, lens)),
             "decode_softmax_v": (
                 lambda: dmod.decode_softmax_v(s, v, lens, scale),
                 lambda: dmod.decode_softmax_v_plain(s, v, lens, scale))}
    rows, esz = b * n_kv * s_len, k.element_size()
    # Bytes each must move, each input read once and each output written
    # once: scores read q, K and lens and write s; softmax_v reads s, V
    # and lens and writes out (q's shape).
    nbytes = {"decode_scores": q.numel() * esz + rows * d * esz
              + s.numel() * 4 + 4 * b,
              "decode_softmax_v": s.numel() * 4 + rows * d * esz
              + q.numel() * esz + 4 * b}
    flops = 2.0 * rows * group * d
    before = dict(dmod.DECODE_HD_SCORES_ROUTE_LAUNCHES)
    dmod.decode_scores(q, k, lens)
    routes = {"decode_scores": [r for r, n in
                                dmod.DECODE_HD_SCORES_ROUTE_LAUNCHES.items()
                                if n != before[r]][0],
              "decode_softmax_v": "split_combine"}
    out = {}
    for name, (kernel, plain) in calls.items():
        t_ops = flops / PEAK_F32_FLOPS
        t_bytes = nbytes[name] / PEAK_BYTES_PER_S
        ms = cuda_ms(kernel, repeats)
        out[name] = {"shape": list(shape), "dtype": "bfloat16",
                     "kernel_route": routes[name],
                     "ms": ms, "device_ms": device_ms(kernel, repeats),
                     "plain_ms": cuda_ms(plain, 3, warmup=1),
                     "library_ms": None, "flops": flops,
                     "min_bytes": nbytes[name],
                     "bound_ms": 1e3 * max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes",
                     "bound_share": 1e3 * max(t_ops, t_bytes) / ms}
    return out


def phase_timing(kmod, fmod, dmod, plans, h_main, h_lj, h_train, g_train,
                 seed: int, tuned: dict) -> dict:
    import torch
    from repro_torch.configs import SHAPES
    torch.cuda.reset_peak_memory_stats()
    lj = plans["lj_serve"]
    timing = {
        "bcsr_spmm": time_spmm(kmod, plans["serve"]["ell"],
                               plans["serve"]["csr"], h_main),
        "bcsr_spmm_socLJ1": time_spmm(kmod, lj["ell"], lj["csr"], h_lj),
        "bcsr_spmm_transposed": time_spmm(kmod, plans["bwd"]["ell"],
                                          plans["bwd"]["csr"], g_train),
        # The tuned bucket widths, beside the power-of-two rows above.
        "bcsr_spmm_tuned_rUSA": time_spmm(kmod, tuned["rUSA"]["ell"],
                                          tuned["rUSA"]["csr"], h_main),
        "bcsr_spmm_tuned_socLJ1": time_spmm(kmod, tuned["socLJ1"]["ell"],
                                            tuned["socLJ1"]["csr"], h_lj),
        "fused_gcn_layer": time_fused(kmod, plans["fwd"]["ell"],
                                      plans["fwd"]["csr"], h_train,
                                      h_train.shape[1]),
        "flash_attention": time_flash(fmod, seed),
        "flash_bwd": time_flash_bwd(fmod, seed, (LM_TRAIN_BATCH, 32,
                                                 LM_TRAIN_SEQ, 128), 10),
        "flash_bwd_prefill": time_flash_bwd(fmod, seed,
                                            (1, 32, LM_PREFILL, 128), 3),
        # gemma_train's microbatch, the CAP instances, beside flash_bwd.
        "flash_bwd_softcap": time_flash_bwd(fmod, seed, (
            LM_TRAIN_BATCH, 32, LM_TRAIN_SEQ, 128), 10, softcap=50.0),
        "decode_attention": time_decode(dmod, seed,
                                        SHAPES["decode_32k"]["global_batch"],
                                        SHAPES["decode_32k"]["seq_len"]),
        # lm_serve's cache at its longest (serve's max_len).
        "decode_attention_lm_serve": time_decode(
            dmod, seed, LM_BATCH, LM_PROMPT + LM_STEPS + 1, repeats=200),
        "flash_attention_gemma_softcap": time_flash_softcap(fmod, seed),
        # gemma_serve's cache at its longest, with and without the softcap.
        "decode_attention_gemma_serve_softcap": time_decode(
            dmod, seed, LM_BATCH, LM_PROMPT + LM_STEPS + 1, repeats=200,
            n_kv=16, group=2, softcap=50.0),
        "decode_attention_gemma_serve": time_decode(
            dmod, seed, LM_BATCH, LM_PROMPT + LM_STEPS + 1, repeats=200,
            n_kv=16, group=2),
        # The d = 256 instances at RecurrentGemma's shapes: its prefill
        # layer, and its MQA decode (10 query heads) over a full ring of
        # 2048 at serve's batch and at decode_32k's.
        "flash_attention_rgemma": time_flash_rgemma(fmod, seed),
        "decode_attention_rgemma_serve": time_decode(
            dmod, seed, LM_BATCH, 2048, repeats=200, n_kv=1, group=10,
            d=256),
        "decode_attention_rgemma_b128": time_decode(
            dmod, seed, SHAPES["decode_32k"]["global_batch"], 2048,
            repeats=50, n_kv=1, group=10, d=256),
        # The backward's d = 256 instance at rgemma_train's layer, and both
        # directions with Qwen2-VL's prefix at qwen_serve's prefill layer.
        "flash_bwd_rgemma": time_flash_bwd(
            fmod, seed, (1, 10, RGEMMA_TRAIN_SEQ, 256), 5, window=2048),
        "flash_attention_qwen_prefix": time_flash_prefix(fmod, seed),
        "flash_bwd_qwen_prefix": time_flash_bwd(
            fmod, seed, (1, 64, LM_PREFILL, 128), 3,
            prefix=QWEN_VISION_TOKENS),
        # Plain PyTorch, candidates for later kernels (PERF.md §5).
        "recurrent_blocks": time_recurrent_blocks(seed),
        # SeamlessM4T's attentions, non-causal: the cross-attention of
        # seamless_serve's prefill (its forward) and of seamless_train's
        # microbatch (its backward) over the 1024 frames, the encoder in
        # both directions, and the decode step's cross-attention.
        "flash_seamless_cross_prefill": time_flash_noncausal(
            fmod, seed, (LM_BATCH, SEAMLESS_HEADS, SEAMLESS_PREFILL,
                         SEAMLESS_HD), SEAMLESS_FRAMES, 10, ("forward",)),
        "flash_seamless_cross_train": time_flash_noncausal(
            fmod, seed, (LM_TRAIN_BATCH, SEAMLESS_HEADS, LM_TRAIN_SEQ,
                         SEAMLESS_HD), SEAMLESS_FRAMES, 10, ("backward",)),
        "flash_seamless_encoder": time_flash_noncausal(
            fmod, seed, (LM_BATCH, SEAMLESS_HEADS, SEAMLESS_FRAMES,
                         SEAMLESS_HD), SEAMLESS_FRAMES, 10),
        "decode_attention_seamless_cross": time_decode(
            dmod, seed, LM_BATCH, SEAMLESS_FRAMES, repeats=200,
            n_kv=SEAMLESS_HEADS, group=1, d=SEAMLESS_HD),
        # The decode over a slice of the head dim at the production slices.
        "decode_hd_yi": time_decode_hd(dmod, seed, HD_YI_SLICE),
        "decode_hd_mixtral": time_decode_hd(dmod, seed, HD_MIXTRAL_SLICE),
        # hints_check's decode at its longest cache, the whole head dim.
        "decode_hd_hints": time_decode_hd(dmod, seed, (
            HINTS_TOKENS[0], 4, 8, HINTS_DECODE_LEN, 128)),
    }
    emit({"phase": "timing", **timing,
          "peak_allocated_bytes": torch.cuda.max_memory_allocated()})
    return timing


def first_segment(plan, a_streamed) -> dict:
    """Segment 0 of a stream plan: its bricks and its rows of the streamed
    matrix as a CSR."""
    from repro_torch.sparse import csr_row_slice
    seg = plan.robw.segments[0]
    return {"ell": plan.stream_payloads()[0][1],
            "csr": csr_row_slice(a_streamed, seg.row_start, seg.row_end),
            "segments": [list(e.blocks.shape)
                         for _, e in plan.stream_payloads()]}


PHASE_SECONDS = {}


def timed(name: str, fn, *args):
    """fn(*args), its wall seconds kept under `name` for the phase_seconds
    line."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = time.perf_counter() - t0
    return out


def mem_available_bytes() -> int:
    """The host's MemAvailable (/proc/meminfo), in bytes."""
    for ln in Path("/proc/meminfo").read_text().splitlines():
        if ln.startswith("MemAvailable:"):
            return int(ln.split()[1]) * 1024
    return -1


def run(args) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 matmuls sum in f32 throughout (no reduced-precision split-K).
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = nvidia_smi()
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "nvidia_smi": smi,
          "tf32": "off (matmul and cudnn)",
          "bf16_reduced_precision_reduction": "off",
          "host_mem_available_bytes": mem_available_bytes(),
          "scales": {"rUSA": args.rusa_scale, "socLJ1": args.lj_scale}})

    kmod = importlib.import_module("repro_torch.kernels.bcsr_spmm")
    from repro_torch.kernels import decode_attn as dmod
    from repro_torch.kernels import flash_attn as fmod
    t_start = time.perf_counter()
    info = kmod.build()
    table = ptxas_table(info.ptxas)
    emit({"phase": "build", "seconds": info.seconds,
          "library": str(info.library.relative_to(ROOT)),
          "ptxas": table,
          # The backward's CAP instances, beside those without the cap.
          "flash_bwd_softcap_instances": [
              row for row in table if ("dkdv_kernel" in row
                                       or "dq_kernel" in row)
              and ", true>" in row],
          # The d = 256 instances (NC = 16) of every attention kernel.
          "d256_instances": [row for row in table if ", 16, " in row],
          # The d = 128 (NC = 8) instances of the backward, the ones held to
          # their registers and spills beside the prefix.
          "flash_bwd_d128_instances": [
              row for row in table if ("dkdv_kernel" in row
                                       or "dq_kernel" in row)
              and ", 8, " in row]})
    PHASE_SECONDS["build"] = info.seconds

    t0 = time.perf_counter()
    # Seeds follow launch/serve.py: graphs in ("socLJ1", "rUSA") order.
    graphs = {"rUSA": paper_graph("rUSA", args.rusa_scale, 1),
              "socLJ1": paper_graph("socLJ1", args.lj_scale, 0)}
    a = graphs["rUSA"]
    width, train_width = 1024, 256
    shape, train_shape = (a.n_rows, width), (a.n_rows, train_width)
    serve_eng, train_eng = engine_at(a, width), engine_at(
        a, train_width)
    lj = graphs["socLJ1"]
    plans = {"serve": first_segment(serve_eng.stream_plan(a, shape), a),
             "lj_serve": first_segment(engine_at(lj, width).stream_plan(
                 lj, (lj.n_rows, width)), lj),
             "fwd": first_segment(train_eng.stream_plan(a, train_shape), a),
             "bwd": first_segment(train_eng.stream_plan(
                 a, train_shape, transpose=True), train_eng.transpose_of(a))}
    emit({"phase": "host", "seconds": time.perf_counter() - t0,
          "segments": {k: v["segments"] for k, v in plans.items()}})
    gen = torch.Generator(device=DEV).manual_seed(args.seed)
    h_main = torch.randn(shape, device=DEV, generator=gen)
    h_train = torch.randn(train_shape, device=DEV, generator=gen)
    g_train = torch.randn(train_shape, device=DEV, generator=gen)
    h_lj = torch.randn((lj.n_rows, width), device=DEV, generator=gen)

    spmm_err = timed("kernel", phase_kernel, kmod, plans["serve"]["ell"],
                     h_main, plans["bwd"]["ell"], g_train,
                     plans["lj_serve"]["ell"], h_lj)
    fused_err = timed("fused", phase_fused, kmod, plans["fwd"]["ell"],
                      h_train)
    inputs = serve_requests(graphs, args)
    launches = {"serve": timed("serve", phase_serve, kmod, graphs, args,
                               inputs)}
    a64 = f64_adjacency(a)
    fused_launches, launches["layer"] = timed(
        "layer", phase_layer, kmod, train_eng, a, a64, args.seed)
    launches["train"] = timed("train", phase_train, kmod, train_eng, a, a64,
                              args.seed)
    # The scheduler slice's phases run with the static plan analyzer on:
    # an error-severity finding in any plan they interpret or stream
    # raises PlanAnalysisError.
    from repro_torch.core import set_default_analyze
    previous = set_default_analyze(True)
    launches["schedule"] = timed("schedule", phase_schedule, kmod, a, a64,
                                 args.seed)
    launches["epoch"] = timed("epoch", phase_epoch, kmod, a, args.seed)
    launches["passes"] = timed("passes", phase_passes, kmod, graphs, inputs)
    launches["shard"], shard_state = timed("shard", phase_shard, kmod,
                                           graphs, args, inputs)
    launches["warm"] = timed("warm", phase_warm, kmod, graphs, inputs,
                             shard_state)
    del shard_state
    launches["tune"], tune_state = timed("tune", phase_tune, kmod, graphs,
                                         args, inputs)
    launches["update"] = timed("update", phase_update, kmod, graphs, args,
                               inputs, tune_state)
    tuned, spmm_err = tune_state["widest"], max(spmm_err,
                                                tune_state["kernel_err"])
    del tune_state
    launches["partition"] = timed("partition", phase_partition, kmod,
                                  graphs, args, inputs)
    launches["continuous"] = timed("continuous", phase_continuous, kmod,
                                   graphs, args, inputs)
    set_default_analyze(previous)
    attn_err = timed("attn", phase_attn, fmod, dmod, args.seed)
    lm = {"lm_check": timed("lm_check", phase_lm_check, fmod, dmod,
                            args.seed)}
    lm["lm_train_check"] = timed("lm_train_check", phase_lm_train_check,
                                 fmod, dmod, args.seed)
    train_runs = timed("lm_train", phase_lm_train, fmod, dmod, args.seed)
    lm.update({f"lm_train_{name}": c for name, c in train_runs.items()})
    lm["lm_serve"] = timed("lm_serve", phase_lm_serve, fmod, dmod, args.seed)
    lm["gemma_check"] = timed("gemma_check", phase_gemma_check, fmod, dmod,
                              args.seed)
    lm["gemma_serve"] = timed("gemma_serve", phase_gemma_serve, fmod, dmod,
                              args.seed)
    lm["gemma_train_check"] = timed("gemma_train_check",
                                    phase_gemma_train_check, fmod, dmod,
                                    args.seed)
    lm["gemma_train"] = timed("gemma_train", phase_gemma_train, fmod, dmod,
                              args.seed)
    # After gemma_train, the run's peak of card memory (the children each
    # take a CUDA context).
    dryrun = start_dryrun_check()
    lm["moe_check"] = timed("moe_check", phase_moe_check, fmod, dmod,
                            args.seed)
    lm["mixtral_serve"] = timed("mixtral_serve", phase_mixtral_serve, fmod,
                                dmod, args.seed)
    lm["moe_train_check"] = timed("moe_train_check", phase_moe_train_check,
                                  fmod, dmod, args.seed)
    lm["moe_train"] = timed("moe_train", phase_moe_train, fmod, dmod,
                            args.seed)
    timed("moe_shard_map_check", phase_moe_shard_map_check, args.seed)
    timed("mesh_check", phase_mesh_check)
    lm["hints_check"] = timed("hints_check", phase_hints_check, fmod, dmod,
                              args.seed)
    lm["rgemma_check"] = timed("rgemma_check", phase_rgemma_check, fmod,
                               dmod, args.seed)
    lm["xlstm_check"] = timed("xlstm_check", phase_xlstm_check, fmod, dmod,
                              args.seed)
    lm["rgemma_serve"] = timed("rgemma_serve", phase_rgemma_serve, fmod,
                               dmod, args.seed)
    lm["xlstm_serve"] = timed("xlstm_serve", phase_xlstm_serve, fmod, dmod,
                              args.seed)
    lm["rgemma_train_check"] = timed("rgemma_train_check",
                                     phase_rgemma_train_check, fmod, dmod,
                                     args.seed)
    lm["rgemma_train"] = timed("rgemma_train", phase_rgemma_train, fmod,
                               dmod, args.seed)
    lm["qwen_check"] = timed("qwen_check", phase_qwen_check, fmod, dmod,
                             args.seed)
    lm["qwen_serve"] = timed("qwen_serve", phase_qwen_serve, fmod, dmod,
                             args.seed)
    lm["seamless_check"] = timed("seamless_check", phase_seamless_check,
                                 fmod, dmod, args.seed)
    lm["seamless_serve"] = timed("seamless_serve", phase_seamless_serve,
                                 fmod, dmod, args.seed)
    lm["seamless_train"] = timed("seamless_train", phase_seamless_train,
                                 fmod, dmod, args.seed)
    lm["stacked_check"] = timed("stacked_check", phase_stacked_check, fmod,
                                dmod, args.seed)
    timed("experts", phase_experts, args.seed)
    timed("dryrun_check", phase_dryrun_check, dryrun)
    timing = timed("timing", phase_timing, kmod, fmod, dmod, plans, h_main,
                   h_lj, h_train, g_train, args.seed, tuned)
    emit({"phase": "phase_seconds", **PHASE_SECONDS,
          "total": time.perf_counter() - t_start})
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    gcn_keys = (*keys, "bound_ms_bricks", "bound_by_bricks")
    bwd_keys = ("bound_ms_split_mma", "bound_share_split_mma",
                "bound_ms_f32_fma")

    def gcn_by_route(kernel: str) -> dict:
        routes = [path[kernel] for path in GCN_ROUTES.values()]
        return {route: sum(r[route] for r in routes) for route in routes[0]}

    train_paths = [p for p in lm if p.startswith(
        ("lm_train", "gemma_train", "moe_train", "rgemma_train",
         "qwen_check", "seamless_check", "seamless_train"))]
    flash_paths = {"lm_check": lm["lm_check"]["flash"],
                   **{p: lm[p]["flash"] for p in train_paths},
                   "lm_serve_prefill": lm["lm_serve"]["flash"],
                   "gemma_check": lm["gemma_check"]["flash"],
                   "gemma_serve_prefill": lm["gemma_serve"]["flash"],
                   "moe_check": lm["moe_check"]["flash"],
                   "mixtral_serve_prefill": lm["mixtral_serve"]["flash"],
                   "rgemma_check": lm["rgemma_check"]["flash"],
                   "rgemma_serve_prefill": lm["rgemma_serve"]["flash"],
                   "xlstm_check": lm["xlstm_check"]["flash"],
                   "xlstm_serve_prefill": lm["xlstm_serve"]["flash"],
                   "qwen_serve_prefill": lm["qwen_serve"]["flash"],
                   "qwen_serve_reference_forward":
                       lm["qwen_serve"]["flash_reference_forward"],
                   "seamless_serve": lm["seamless_serve"]["flash"],
                   "stacked_check": lm["stacked_check"]["flash"],
                   "hints_check": lm["hints_check"]["flash"]}
    bwd_paths = {p: lm[p]["flash_bwd"] for p in train_paths}

    def by_route(kernel: str, routes=("tensor_core", "f32_fma")) -> dict:
        return {route: sum(path.get(f"{kernel}_routes", {}).get(route, 0)
                           for path in lm.values())
                for route in routes}

    decode_paths = {"lm_check": lm["lm_check"]["decode"],
                    "lm_serve": lm["lm_serve"]["decode"],
                    "lm_serve_crosscheck":
                        lm["lm_serve"]["decode_crosscheck"],
                    "gemma_check": lm["gemma_check"]["decode"],
                    "gemma_serve": lm["gemma_serve"]["decode"],
                    "gemma_serve_crosscheck":
                        lm["gemma_serve"]["decode_crosscheck"],
                    "moe_check": lm["moe_check"]["decode"],
                    "mixtral_serve": lm["mixtral_serve"]["decode"],
                    "mixtral_serve_crosscheck":
                        lm["mixtral_serve"]["decode_crosscheck"],
                    "rgemma_check": lm["rgemma_check"]["decode"],
                    "rgemma_serve": lm["rgemma_serve"]["decode"],
                    "rgemma_serve_crosscheck":
                        lm["rgemma_serve"]["decode_crosscheck"],
                    "xlstm_check": lm["xlstm_check"]["decode"],
                    "xlstm_serve": lm["xlstm_serve"]["decode"],
                    "xlstm_serve_crosscheck":
                        lm["xlstm_serve"]["decode_crosscheck"],
                    "qwen_check": lm["qwen_check"]["decode"],
                    "qwen_serve": lm["qwen_serve"]["decode"],
                    "qwen_serve_crosscheck":
                        lm["qwen_serve"]["decode_crosscheck"],
                    "seamless_check": lm["seamless_check"]["decode"],
                    "seamless_serve": lm["seamless_serve"]["decode"],
                    "seamless_serve_crosscheck":
                        lm["seamless_serve"]["decode_crosscheck"],
                    "stacked_check": lm["stacked_check"]["decode"]}

    def softcapped(kernel: str) -> dict:
        """Softcapped launches by path (Gemma-2's; every other 0)."""
        return {name: path.get(f"{kernel}_softcap", 0)
                for name, path in lm.items()}

    def wide(kernel: str) -> dict:
        """d = 256 launches by path (RecurrentGemma's; every other 0)."""
        return {name: path.get(f"{kernel}_wide", 0)
                for name, path in lm.items()}

    def prefixed(kernel: str) -> dict:
        """Launches with a prefix by path (Qwen2-VL's; every other 0)."""
        return {name: path.get(f"{kernel}_prefix", 0)
                for name, path in lm.items()}

    def by_path(key: str) -> dict:
        """The count `key` by path, the paths where it is not 0: launches
        with Sq != Sk (`*_cross`) and without the causal mask
        (`*_noncausal`), SeamlessM4T's."""
        return {name: path[key] for name, path in lm.items()
                if path.get(key)}

    def seamless(kernel: str) -> dict:
        counts = {key: by_path(f"{kernel}_{key}")
                  for key in ("cross", "noncausal")}
        return {"cross_launches": sum(counts["cross"].values()),
                "cross_launches_by_path": counts["cross"],
                "noncausal_launches": sum(counts["noncausal"].values()),
                "noncausal_launches_by_path": counts["noncausal"]}
    emit({"kernels": [
        {"name": "bcsr_spmm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/bcsr_spmm.cu",
         "replaces": "src/repro/kernels/bcsr_spmm.py:50",
         "launches": sum(launches.values()), "launches_by_path": launches,
         "launches_by_route": gcn_by_route("bcsr_spmm"),
         "max_abs_err": spmm_err,
         **{k: timing["bcsr_spmm"][k] for k in gcn_keys},
         "transposed": {k: timing["bcsr_spmm_transposed"][k]
                        for k in gcn_keys},
         "socLJ1": {k: timing["bcsr_spmm_socLJ1"][k] for k in gcn_keys},
         **{f"tuned_{name}": {
             "ell_w": timing[f"bcsr_spmm_tuned_{name}"]["shape"]["blocks"][1],
             "segment": tuned[name]["segment"],
             **{k: timing[f"bcsr_spmm_tuned_{name}"][k] for k in gcn_keys}}
            for name in ("rUSA", "socLJ1")}},
        {"name": "fused_gcn_layer", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_gcn_layer.cu",
         "replaces": "src/repro/kernels/bcsr_spmm.py:127",
         "launches": fused_launches,
         "launches_by_path": {"layer": fused_launches},
         "launches_by_route": gcn_by_route("fused_gcn_layer"),
         "max_abs_err": fused_err,
         **{k: timing["fused_gcn_layer"][k] for k in (
             *gcn_keys, "bound_ms_split_tf32", "bound_by_split_tf32")},
         "yardstick_ms": timing["fused_gcn_layer"]["yardstick_ms"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attn.cu",
         "replaces": "src/repro/kernels/flash_attn.py:87",
         "launches": sum(flash_paths.values()),
         "launches_by_path": flash_paths,
         "launches_by_route": by_route("flash"),
         "max_abs_err": attn_err["flash"],
         **{k: timing["flash_attention"][k] for k in keys},
         "bound_ms_f32_fma": timing["flash_attention"]["bound_ms_f32_fma"],
         "forward_with_lse_ms": {
             "lm_train": timing["flash_bwd"]["forward_with_lse_ms"],
             "prefill": timing["flash_bwd_prefill"]["forward_with_lse_ms"]},
         "softcap_launches": sum(softcapped("flash").values()),
         "softcap_launches_by_path": softcapped("flash"),
         "gemma_prefill_softcap": {
             k: timing["flash_attention_gemma_softcap"][k]
             for k in (*keys, "no_softcap_ms", "window", "softcap")},
         "d256_launches": sum(wide("flash").values()),
         "d256_launches_by_path": wide("flash"),
         "max_abs_err_d256": attn_err["flash_d256"],
         "rgemma_prefill_d256": {
             k: timing["flash_attention_rgemma"][k]
             for k in (*keys, "shape", "window", "sdpa_causal_no_window_ms",
                       "bound_ms_split_pv")},
         "prefix_launches": sum(prefixed("flash").values()),
         "prefix_launches_by_path": prefixed("flash"),
         "max_abs_err_prefix": attn_err["flash_prefix"],
         "qwen_prefill_prefix": {
             k: timing["flash_attention_qwen_prefix"][k]
             for k in (*keys, "shape", "prefix", "no_prefix_ms",
                       "sdpa_causal_no_prefix_ms")},
         **seamless("flash"),
         "max_abs_err_seamless": attn_err["flash_seamless"],
         "seamless_cross_prefill": {
             k: timing["flash_seamless_cross_prefill"]["forward"][k]
             for k in (*keys, "q", "kv")},
         "seamless_encoder": {
             k: timing["flash_seamless_encoder"]["forward"][k]
             for k in (*keys, "q", "kv")}},
        {"name": "flash_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attn_bwd.cu",
         "replaces": "src/repro/models/layers.py:90",
         "replaces_note": "XLA autodiff of _attn_core; the JAX package has "
                          "no Pallas backward",
         "launches": sum(bwd_paths.values()),
         "launches_by_path": bwd_paths,
         "launches_by_route": by_route("flash_bwd"),
         "softcap_launches": sum(softcapped("flash_bwd").values()),
         "softcap_launches_by_path": softcapped("flash_bwd"),
         "max_abs_err": attn_err["backward"],
         **{k: timing["flash_bwd"][k] for k in keys},
         **{k: timing["flash_bwd"][k] for k in bwd_keys},
         "prefill_shape": {k: timing["flash_bwd_prefill"][k]
                           for k in (*keys, *bwd_keys)},
         "softcap_50": {k: timing["flash_bwd_softcap"][k]
                        for k in (*keys, *bwd_keys, "softcap")},
         "d256_launches": sum(wide("flash_bwd").values()),
         "d256_launches_by_path": wide("flash_bwd"),
         "max_abs_err_d256": attn_err["backward_d256"],
         "rgemma_train_d256": {
             k: timing["flash_bwd_rgemma"][k]
             for k in (*keys, *bwd_keys, "shape", "window",
                       "sdpa_causal_unmasked_ms")},
         "prefix_launches": sum(prefixed("flash_bwd").values()),
         "prefix_launches_by_path": prefixed("flash_bwd"),
         "max_abs_err_prefix": attn_err["backward_prefix"],
         "qwen_prefill_prefix": {
             k: timing["flash_bwd_qwen_prefix"][k]
             for k in (*keys, *bwd_keys, "shape", "prefix",
                       "sdpa_causal_unmasked_ms")},
         **seamless("flash_bwd"),
         "max_abs_err_seamless": attn_err["backward_seamless"],
         "seamless_cross_train": {
             k: timing["flash_seamless_cross_train"]["backward"][k]
             for k in (*keys, "q", "kv", "bound_ms_split_mma")},
         "seamless_encoder": {
             k: timing["flash_seamless_encoder"]["backward"][k]
             for k in (*keys, "q", "kv", "bound_ms_split_mma")}},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/decode_attn.cu",
         "replaces": "src/repro/kernels/decode_attn.py:68",
         "launches": sum(decode_paths.values()),
         "launches_by_path": decode_paths,
         "launches_by_route": by_route("decode"),
         "max_abs_err": attn_err["decode"],
         **{k: timing["decode_attention"][k] for k in keys},
         "lm_serve_shape": {k: timing["decode_attention_lm_serve"][k]
                            for k in (*keys, "device_ms")},
         "softcap_launches": sum(softcapped("decode").values()),
         "softcap_launches_by_path": softcapped("decode"),
         "gemma_serve_shape_softcap": {
             k: timing["decode_attention_gemma_serve_softcap"][k]
             for k in (*keys, "device_ms", "softcap")},
         "gemma_serve_shape": {
             k: timing["decode_attention_gemma_serve"][k]
             for k in (*keys, "device_ms")},
         "d256_launches": sum(wide("decode").values()),
         "d256_launches_by_path": wide("decode"),
         "max_abs_err_d256": attn_err["decode_d256"],
         **{f"{name}_d256": {
             k: timing[f"decode_attention_{name}"][k]
             for k in (*keys, "device_ms", "q", "kv", "splits")}
            for name in ("rgemma_serve", "rgemma_b128")},
         "cross_step_launches_by_path": by_path("decode_cross_step"),
         "max_abs_err_seamless": attn_err["decode_seamless"],
         "seamless_cross_step": {
             k: timing["decode_attention_seamless_cross"][k]
             for k in (*keys, "device_ms", "q", "kv", "splits")}},
        *({"name": name, "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/decode_attn_hd.cu",
           "replaces": "src/repro/kernels/decode_attn.py:68",
           "replaces_note": "with decode_attention, where the caches' head "
                            "dim is sharded: the scores' sum over the "
                            "ranks comes between the two kernels",
           "launches": lm["hints_check"][name],
           "launches_by_path": {"hints_check": lm["hints_check"][name]},
           "max_abs_err": attn_err[name],
           **{k: timing["decode_hd_yi"][name][k] for k in keys},
           **{label: {k: timing[key][name][k]
                      for k in (*keys, "device_ms", "shape", "kernel_route",
                                "bound_share")}
              for label, key in (("yi_6b_decode_32k_slice", "decode_hd_yi"),
                                 ("mixtral_decode_32k_slice",
                                  "decode_hd_mixtral"),
                                 ("hints_check_shape", "decode_hd_hints"))}}
          for name in ("decode_scores", "decode_softmax_v"))]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rusa-scale", type=float, default=1e-2)
    ap.add_argument("--lj-scale", type=float, default=1e-3)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.epochs < 2:
        ap.error("--epochs must be at least 2 (epoch 2 checks the cache)")
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # Phases from a few MB to 74 GB share this process. With fixed-size
    # segments, memory cached by earlier phases once stranded 20.6 GB
    # (reserved, unallocated), and rgemma_train, which alone peaks at 66.3
    # GB, ran out of memory at 57.6 GB allocated (PERF.md §6).
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        run(args)
    finally:
        for proc in CHILDREN:
            proc.kill()
    return 0


if __name__ == "__main__":
    sys.exit(main())

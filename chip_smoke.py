"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure ends the run with a
non-zero exit (nothing is caught):

1. device: card name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 off for matmuls and convolutions.
2. build: every CUDA kernel of the port, from paddle_tpu_torch/csrc/,
   K2 with a fault planted in its p v step and the backward with faults
   planted in K3's ds k and K5's store, with nvcc (one process per
   library, started together); the tensor-core kernels K2, K3/K5 and K4
   must show 0 spills in ptxas's report and HMMA in cuobjdump's SASS at
   every instantiation (fp32/bf16 x D 64/128, and x dQ/dBias for K3/K5).
3. bounds: the least time of K1 and K6 at the shapes of their paths,
   computed from their work (no device work).
4. kernel: the flash-attention forward (K2) against its plain PyTorch
   version on the card — BERT-base shapes with a [B,1,S,S] padding bias
   in fp32 and bf16, causal with the LSE, a ragged cross case (S_q=77,
   S_kv=200), D=128, and the edges of its mma fragments and tiles (1 x 1,
   9 x 13, 130 x 130) with biases read through other strides (broadcast
   over heads or batch, transposed, rows longer than S_kv); the K2 with a
   planted fault must fail the same check; then its time beside the
   plain version, one scaled_dot_product_attention call (the yardstick,
   never used by the port) and the bound (fp32 products at the faster of
   the CUDA cores and split TF32 on the tensor cores).
5. kernel_bwd: the backward kernels K3 (dQ), K4 (dK/dV) and K5 (dBias)
   against their plain versions — the BERT-base training shape (BH=384,
   S=128, D=64, [32,1,128,128] padding bias) in fp32 and bf16, causal,
   ragged cross 77 x 200, D=128 and phase 4's edge cases; the backward
   with planted faults must fail the same check on dq and dbias in fp32
   and bf16, and two launches of K3 (and of K5) give the same bits —
   then their times at the training shape beside the plain versions, the
   SDPA backward (and the names of the kernels it runs) and the bounds,
   and K2's with the LSE.
5b. kernel_nmt: K2 (with the LSE), K3 and K4 at Transformer NMT's
   shape (BH=256, S=256, D=64), causal and with its [B,1,1,S] pad bias
   read as a stride-0 view, in fp32 (the dtype its attention runs in)
   and bf16, against their plain versions at the same tolerances (K5 too
   in the pad-bias check); their times beside the plain versions, SDPA
   and the bounds, the causal half of the work counted.
6. kernel_conv: ptxas's report for K1's wgmma kernel (registers,
   spills: none allowed); K1 (3x3 implicit-GEMM conv) against its plain
   version at the four ResNet-50 3x3 stride-1 shapes, batch 256 in bf16
   and batch 32 in fp32, with and without the BN+relu epilogue, each
   launching the variant its plan names (wgmma in bf16, fp32 in fp32);
   then its time per shape beside the plain version, cuDNN (F.conv2d,
   channels_last bf16; never called by the port for these convs), the
   bound, and the NCHW -> NHWC copy the wrapper makes of an input that
   is not channels_last.
7. kernel_ln: K6 (row layer norm) against its plain version at
   [4096, 768] fp32 and bf16 and a ragged [1000, 1000]; its time beside
   the plain version, F.layer_norm and the bound.
8. slice: BERT-base (12 x 768, 12 heads, S=128, ~109M parameters, random
   weights from a seed) built with the port's layers, cloned for test,
   started on CUDAPlace(0) and served through ServingExecutor(max_batch=8)
   — 24 requests of 1-8 rows with random true lengths — checked against
   the same rows run alone, against the matmul/softmax composition with
   the same weights, and against the port's CPU path on two rows; K2's
   launch count must be 12 per dispatched batch, and no other kernel
   may launch.  Then a profile.
9. train: BERT-base pretraining (build_pretrain: batch 32, 20 masked
   positions, fp32, Adam lr 1e-4, hidden dropout 0.1, attention dropout
   0) through Executor, 2 warm-up and 4 timed steps on one synthetic
   batch: finite falling losses, 12 K2, 12 K3, 12 K4 and 0 K5 launches
   per step, ms per step, sequences/s, tokens/s, peak memory, one
   profiled step; then fused vs composition path and card vs the port's
   CPU path (batch 2) on the step-1 loss and named gradients.
9b. dp_train: phase 9 again as one rank of an NCCL world, a child of
   ``python -m paddle_tpu_torch.distributed.launch``: BERT-base through
   fleet.distributed_optimizer (fused GradAllReduce, 32 MB buckets) from
   phase 9's initial parameters and batch, 6 steps: the NCCL backend,
   one c_allreduce_sum per bucket a step, 12 K2/K3/K4 and 0 K5 a step,
   losses and parameters bit-equal to phase 9's (or within twice the
   spread of a second plain run); ms per step against phase 9's, the
   collective bytes a step and one profiled step's NCCL device time.
9c. dp_two_ranks: two ranks on card 0 over gloo (--selected_devices
   0,0), BERT-base with all dropout off, 16 of phase 9's rows each, 3
   steps, against one process on the 32 rows: the mean of the ranks'
   losses within 1e-4, the parameters within 1e-3 relative L2 (or twice
   the spread of the one process fed its rows in the other order), the
   ranks' parameters bit-equal after every step, and the two ranks'
   dropout masks different.
9d. dp_wus: Transformer NMT base as phase 16 runs it (pure bf16, batch
   32, attention dropout off), one NCCL rank under the launcher, through
   GradAllReduce(weight_update_sharding=True), 6 steps from the plain
   program's startup weights: losses and parameters bit-equal to the
   plain program's (or within twice the spread of two plain runs), 18
   K2/K3/K4 a step, one reduce-scatter and one all-gather per bucket a
   step; the same on the int8 wire (the quantizer at N = 1), each loss
   within 2/127 of plain (the CPU tests' bound); ms per step against
   plain and the rank's optimizer-state bytes.  BERT-base (phase 9's
   weights and batch) through fleet on the int8 wire, 6 steps: each
   loss within 2/127 of phase 9's, 12 K2/K3/K4 a step; fleet's
   weight-update sharding of BERT refused, as in the JAX package (its
   tied word embedding takes a gradient summed from two contributions).
9e. dp_two_ranks_sharded: two gloo ranks on card 0.  BERT-base as phase
   9c runs it, through fleet on the int8 wire (each loss within 2/127 of
   fp32, about a quarter of its wire bytes) and with hierarchical
   allreduce, two nodes of one rank (bit-equal to fp32); NMT base,
   dropout off, 16 rows a rank, 3 steps: sharded bit-equal to the plain
   GradAllReduce after every step, each rank holding half of the Adam
   moments (plus the bucket's pad), on the int8 wire within 2/127; the
   wire bytes of each precision.
9f. train_surface, three parts, each from phase 9's initial parameters
   and batch.  bert_recompute: phase 9's program with
   RecomputeOptimizer over its Adam, the 12 post-FFN layer_norm outputs
   as checkpoints, 2 + 4 steps (after the same of the plain program,
   timed beside it): losses and parameters bit-equal to phase 9's (or
   within twice a second plain run's spread), 24 K2, 12 K3, 12 K4 and 0
   K5 a step (K2 runs again in each span's replay), peak memory below
   phase 9's, one profiled step.  bert_gradient_merge: all dropout off,
   GradientMergeOptimizer(Adam, k_steps=4) over the 32 rows as 4
   micro-batches of 8, 8 micro-steps: parameters bit-unchanged between
   the applies, the averaged accumulation of the first apply within
   1e-5 relative L2 of the 32-row gradient, the parameters after it
   within max(2 x spread, 1e-6) of one plain 32-row Adam step net of
   each side's own step, 12 K2/K3/K4 a micro-step, one
   conditional_block predicate sync a micro-step (the branch's host
   read); a non-apply and an apply micro-step profiled.
   bert_amp_dynamic: pure bf16 with dynamic loss scaling (2^15, x2
   every 2 good steps, x0.8 every bad one) over Adam, 5 steps, step 3
   fed an input_mask holding one inf: the scale after each step its
   closed form, step 3's gated gradients all 0, the other losses
   finite, 12 K2/K3/K4 a step; a profiled step beside the same program
   without scaling (the gate's launches).
10. train_bias: an attention layer whose bias is a trainable [1,H,S,S]
   parameter — the path that launches K5 — against the composition path.
11. train_attn_dropout: BERT with attention dropout 0.1 at 2 layers, the
   composition route: finite losses, no flash kernel launched.
12. resnet_train: bench.py's bench_resnet program built with the port —
   ResNet-50 v1.5, 224 x 224, batch 256, pure bf16, Momentum 0.9 with
   L2Decay 1e-4, lr 0.1, FLAGS_conv_pallas=1 — 2 warm-up and 4 timed
   steps on one synthetic batch: finite falling losses, 13 K1 launches
   per step, all of the wgmma variant, and no other kernel; how many of
   the 13 copy their input to NHWC first; ms per step, images/s, peak
   memory.
13. resnet_profile: one profiled ResNet-50 step: kernel time against
   wall, device busy share, events, launch calls, top kernels, kernel
   time by kind (K1's share must not be 0).
   resnet_check: step 1 from the startup weights, the K1 route against
   the cuDNN route (flag off, bf16, batch 256) and the card against the
   port's CPU path (fp32, batch 2), on the loss and chosen gradients,
   each within the larger of its fixed bound and twice the spread of a
   route that runs no K1 either.
13b. dp_resnet: phase 12's program through
   CompiledProgram.with_data_parallel with BuildStrategy.sync_batch_norm
   as one NCCL rank (a child of the launcher), from phase 12's startup
   weights, 6 steps: 53 sync_batch_norm ops with one all-reduce each
   and 13 wgmma K1 a step, one c_allreduce_sum per bucket a step, each
   loss within resnet_check's 1e-2 of phase 12's; ms per step against
   phase 12's.
14. ln_path: a fused_layer_norm program forward and backward through
   Executor: one K6 launch per run, and the gradients of the layer_norm
   op's program.
15. nmt_train: bench.py's bench_nmt program built with the port —
   Transformer NMT base (6 + 6 layers, width 512, 8 heads, S=256,
   vocabularies of 30,000, dropout 0.1, label smoothing 0.1), Adam on
   noam_decay, pure bf16, batch 32, bench_nmt's two all-ones-mask feeds
   in turn — 2 warm-up and 4 timed steps: finite losses, the fetched
   learning rate equal to the Noam closed form at steps 1-6, the step
   counter at 10, no flash kernel (attention dropout takes the
   composition); ms per step, tokens/s, peak memory, one profiled step.
16. nmt_train_flash: the same with attention dropout off and ragged
   masks: 18 K2, 18 K3, 18 K4 (6 causal) and 0 K5 per step; then
   nmt_check: step 1 from the startup weights, dropout off, the fused
   route against the composition route (bf16, batch 32) and the card
   against the port's CPU path (fp32, batch 2, 2 + 2 layers), each
   within the larger of its fixed bound and twice the spread of the
   fused route running the kernels' plain versions.
17. lenet_train: bench_lenet's program (LeNet-5, batch 1024, Adam 1e-3,
   two feeds in turn), 2 warm-up and 4 timed steps: finite falling
   losses, images/s, none of the port's kernels launched.
18. deepfm_train: bench_deepfm's program (DeepFM base_config: 26
   fields over a 1,000,001-row table, embeddings of 10, a 400 x 3 tower;
   Adam 1e-3, batch 4096, two feeds in turn), 2 warm-up and 4 timed
   steps: finite falling losses, examples/s, peak memory, one profiled
   step, none of the port's kernels launched; then deepfm_check: three
   steps from the startup weights on the card (twice, then with each
   batch's examples reversed) and on the port's CPU path (as fed and
   reversed), losses within 1e-4, each parameter within max(2 x the sum
   of the largest spreads over the card's runs and the CPU's, 1e-6).
19. deepfm_optimizers: DeepFM at batch 512, the same check for each of
   the eight optimizers the port adds (LarsMomentum, Adamax, Adagrad,
   DecayedAdagrad, Adadelta, centered RMSProp, Ftrl, Lamb), Adam with
   GradientClipByGlobalNorm, SGD with GradientClipByValue on the tower
   and a per-parameter rate of 0.5 on fm_emb, and SGD on each of the
   seven schedules, whose fetched rate must equal its closed form
   within 1e-6.
19b. wrappers: DeepFM at batch 512 through ExponentialMovingAverage
   and ModelAverage(max_average_window=2) after Adam,
   LookaheadOptimizer(Adam, k=2), DGCMomentumOptimizer (rampup from
   step 1, a world of one) and a hand-built proximal_gd /
   proximal_adagrad program (l1, l2 > 0), 3 steps each held as phase 19
   holds its runs; EMA's apply against its bias-corrected closed form,
   ModelAverage's after step 2 (the window's mean) and step 3 (after
   its reset, the last step), each restore bit-equal to the trained
   parameters; Lookahead synced after step 2 only; DGC's u zero before
   rampup and v entries cleared after; no port kernel launched.
19c. ps_deepfm: the parameter server.  bench_deepfm's program (not cut)
   transpiled with the default DistributeTranspilerConfig to two pservers
   on 127.0.0.1 — children of this script (``ps_child server``) serving
   on CPUPlace(), as a Fluid 1.5 pserver keeps its tables on the host —
   sync mode, one trainer on the card: fm_emb and fm_w1 live on the
   pservers in two row blocks each (the tower's 273 x 400 and 400 x 400
   weights are sliced too); the trainer prefetches the rows a batch
   touches and pushes their gradient rows.  The plain program from the
   same startup weights and feeds timed beside it; 2 warm-up and 4 timed
   PS steps: step 1's loss bit-equal to the plain step 1, step 2 within
   1e-4 of the plain step 2, finite losses, the last below the first, no
   port kernel, neither table in the trainer's scope, peak device memory
   below the plain run's by at least the tables, their Adam moments and
   their dense gradients (~176 MB); ms per step and examples/s of both,
   the host time in send, recv and the prefetches a step, the bytes each
   way, one profiled step's busy share.  Then the trainer on the card and
   on CPUPlace() (and each on the reversed batches) 3 steps each against
   fresh pservers from one state, every pserver value saved through
   checkpoint_notify: losses within 1e-4, every value within max(2 x
   (card spread + host spread), 1e-6).
19d. ps_two_trainers: the same program as two trainer processes on card
   0 (``ps_child trainer``), rows 0-2047 and 2048-4095 of each feed, two
   pservers, sync, 3 steps: the mean of their step-1 losses within 1e-5
   of ps_deepfm's step 1, every pserver value within ps_deepfm's
   card-against-host bound of its one-trainer card run; then each
   pserver's apply per round (whole and touched rows) as its child
   timed it.
20. lookup_grad: the lookup_table rule's table gradient (torch's
   embedding backward under its deterministic algorithms) against
   torch's default one, at BERT-base's three tables (batch 32) and
   DeepFM's two (batch 4096): wall ms per call, distinct results over
   5 calls (the rule's must be 1), agreement within 1e-4 of the
   gradient's largest entry.
21. ckpt_resume: BERT-base pretraining as phase 9 builds it (batch 32,
   fp32, Adam 1e-4, hidden dropout 0.1), one batch per step.  Run A: 6
   steps, twice.  Run B: 3 steps, an async CheckpointManager.save() (~1.3
   GB: parameters and both Adam moments), a 4th step with the write in
   flight, a second save killed mid-write by a fault hook (a torn
   .tmp-* directory), a fresh Scope and Executor with the program
   rebuilt, resume() (which must pick the complete checkpoint), steps
   4-6: losses at steps 4-6 and every persistable after step 6 equal to
   run A's bit for bit (twice the A runs' spread if those differ); 12
   K2, K3, K4 a step; the checkpoint's bytes, the snapshot's ms, the
   async write's seconds, the step's ms with the write in flight and
   without, the restore's seconds.
22. export_serve: phase 8's BERT-base serving program exported with
   save_inference_model once per file and once with params_filename;
   ServingExecutor.from_inference_model(dir, max_batch=8) serves phase
   8's 24-request burst from each: rows bit-equal to the live
   ServingExecutor's, the same batches, 0 recompiles after warmup(), 12
   K2 a batch; the export and load seconds.
23. predictor_resnet: ResNet-50 inference (bench_resnet's model,
   is_test, fp32, 224 x 224, batch 32) with batch-norm statistics from a
   seeded calibration batch, exported and run by create_paddle_predictor(Config(
   dir)) on the card with the default passes (53 batch_norm folded; rtol
   1e-3 / atol 1e-4 of Executor.run of the unexported program) and with
   switch_ir_optim(False) (1e-4 / 1e-5); export and load seconds, ms per
   batch.
24. window_train: BERT-base pretraining as phase 9 builds it through the
   training loop, 4 seeded batches in turn, every run from one state.
   Run A: 2 warm-up and 12 timed exe.run calls, twice.  Run B: 2 warm-up
   runs, then 12 batches through a program-bound DataLoader
   (steps_per_run=4) on the feed ring (pinned staging, side-stream
   copies), pulled by exe.run() with no feed, with a windowed
   CheckpointManager saving after window 2.  Run C: B with
   FLAGS_feed_ring_depth=0.  B and C bit-equal to A (or within twice the
   A runs' spread); 12 K2/K3/K4 and 0 K5 per inner step; no new plan and
   no recorded host sync inside a window; 3 window step events; the
   checkpoint on the window-end marker with steps_per_run 4, a save off
   it raising; one window traced with FLAGS_device_profile=1 naming
   K2-K4; the host-sync sites of one window (set_sync_debug_mode).
25. dataset_train: bench_deepfm's configuration trained from 16 x 4096
   MultiSlot lines written from a seed: train_from_dataset
   (steps_per_run=4) bit-equal to exe.run over the same parsed batches;
   a real SIGTERM as window 3 starts stops the loop at step 12 after a
   final synchronous save, and a restore finishes the last window equal
   to the unbroken run; no port kernel.
25b. elastic_shrink: NMT base widths at 2 + 2 layers (dropout off, pure
   bf16), weight-update sharding and async pod saves every 3 steps,
   through elastic.run_elastic and train_from_dataset(
   checkpoint_manager=), under ``launch --selected_devices 0,0
   --max_restarts 1 --elastic_min_nproc 1`` over gloo: rank 1 SIGKILLs
   itself at batch 6 once a save has committed, the launcher relaunches
   a world of one, which restores with reshard=True (2 -> 1) and trains
   to batch 9: the restored state bit-equal to the checkpoint's global
   values, the final parameters bit-equal to a world of one here that
   restores the same checkpoint and takes the same batches (or twice
   the spread of two such runs), the newest committed step the one
   restored, a resize record; pod save ms, restore s, recovery_s.
26. watchdog_stall: the watchdog (2 s, no abort) over BERT-base: a
   normal window gives no record, a loader stalled once for 5 s gives
   one kind="hang" record naming feed_wait.
27. book_train: the reference's book models (Fluid 1.5 tests/book/,
   ``models/book.py``) through Executor at the reference tests' widths
   on the port's synthetic datasets: fit_a_line (13 -> fc 1, batch 20),
   image classification (resnet_cifar10 depth 32 and vgg16_bn_drop on
   3 x 32 x 32, batch 128), word2vec (softmax and nce, N 5, embedding
   32, hidden 256), understand_sentiment (conv net, embedding 32, hidden
   32; 3-layer stacked LSTM, embedding 128, hidden 512; T 64),
   recommender_system (embeddings 32, towers fc 200, a title
   sequence_conv_pool of 32 filters), label_semantic_roles (word 32,
   mark 5, hidden 512, depth 8), rnn_encoder_decoder (a StaticRNN
   decoder; dictionary 30,000, word 16, hidden 32, T 8) and
   machine_translation (a DynamicRNN decoder; the same widths), each
   8 steps (2 warm-up) over its first 4 batches: finite losses, no port
   kernel launched; ms per step, one profiled step's launches and busy
   share, peak memory; then machine_translation's beam decode (beam 2,
   8 steps) from the trained weights.
28. book_check: each book program's step 1 from its startup weights on
   the card (twice, and with the batch's examples reversed) and on the
   port's CPU path (as fed and reversed), the CNNs at batch 16 and VGG
   without dropout: the loss within 1e-4, each parameter within max(2 x
   (card spread + CPU spread), 1e-6); word2vec nce's card loss equal to
   its formula on the card's own samples (1e-5); the beam decode from
   the trained weights on the card and the CPU: SentenceIds equal, the
   scores within max(1e-5 relative, 2 x the reversed-batch spreads).
29. mp_bert: tensor and sequence parallelism, two gloo ranks on card 0
   (``dp_child mp_bert``, one pack that also runs pp_bert and the moe
   paths, checked in 29b and 30): BERT-base at phase 9's configuration with
   all dropout off (batch 32, fp32, Adam 1e-4), from phase 9's initial
   parameters and batch, through fleet with mp_degree=2 (tp_bert), then
   sp_degree=2 ring and Ulysses (sp_bert_ring, sp_bert_ulysses), 1 + 1
   steps each, against the same program in this process: every step's
   loss within 1e-4 (steps 2-3 after the layer's backward and sharded
   update), both ranks' losses equal, 12 K2/K3/K4 a step (0 on the
   ring, whose padding bias takes the einsum ring) and 0 K5; tp_bert's
   parameters a rank below one process's; ms per step, peak memory,
   parameter and optimizer-state bytes a rank, the model-parallel
   collectives a step (calls and wire bytes).
29b. pp_bert, pp_mp_bert, mp_sp_bert: pipelines and the compositions,
   gloo ranks on card 0 (pp_bert in mp_bert's pack, ``dp_child
   pp_mp_bert``), BERT-base at phase 9's configuration with all dropout
   off from phase 9's initial parameters and batch, 1 + 1 steps each,
   against mp_bert's run of the same program in this process: pp_bert,
   two stages of six layers (``device_guard`` at layer 6,
   PipelineOptimizer with 4 microbatches, ``mask_pos`` re-based to its
   microbatch) as two ranks; pp_mp_bert, the same with the Megatron
   pairs at mp 2 (dp 1 x pp 2 x mp 2) as four ranks; mp_sp_bert,
   BERT-base through fleet at mp 2 x sp 2 Ulysses with no pipeline, in
   the same four.  Every step's loss within 1e-4, every rank the same
   losses, per rank and step 48 K2, 24 K3 and 24 K4 on a pipeline (the
   backward recomputes each stage's forward) and 12 each on mp_sp_bert,
   0 K5; parameter bytes a rank below one process's (a pipeline's at
   most 0.6 of it), half of each paired weight a rank, 4 sends a rank
   a step; ms per step, peak memory, the collectives a step.
30. moe: the MoE block of tests/test_moe_transformer_composition.py at
   fluid/benchmark.py:329's widths (batch 8, S 512, hidden 768, 12
   heads, 8 experts of ffn 3072, capacity 1.25), two gloo ranks on card
   0 (in mp_bert's pack), from one startup's weights: sp_ring_flash (sp 2
   ring, T_local 256: the flash ring, K2 with the LSE twice a forward,
   K3 and K4 twice a backward with the global LSE, asserted), then
   ep_moe dense, a2a fp32 and a2a int8 (ep 2); against the block in this
   process: every step's loss and the step-1 aux loss within 1e-4, the
   MoE op's step-1 output within 1e-4 of its largest entry (int8:
   2/127), each rank holding half the experts; ms per step, peak
   memory, the a2a
   bytes by precision.  kernel_ring: the flash ring's forward and
   backward at that shape (B 8, H 12, S 512 as two shards, D 64) in fp32
   and bf16 on each rank, against the einsum ring and the plain K2-K4
   over the whole sequence (1e-4 fp32, 2e-2 bf16, of each of o, dq, dk
   and dv's own largest entry); wall ms of both rings (their exchanges
   go through the host on gloo).
31. control_flow: the programs of the JAX package's control-flow and
   LoD tests (While counting and filling a tensor array, cond, Switch,
   IfElse, the rank table, the LoD tensor / array round trip,
   shrink_rnn_memory, split / merge), the branch gradients
   (conditional_block_grad taken and not, cond_grad) and a tensor array
   written past its capacity, on the card against the port's CPU path:
   integers equal, floats within 1e-6, their closed forms; the host
   syncs each makes (a While of N iterations reads its condition N + 1
   times).
31b. sequence_ops: the programs of the 25 sequence, RNN and CTC op
   types (``seq_programs``, the CPU tests' programs: each op in all its
   modes, its outputs and the gradients of its float inputs and
   parameters) on the card against the port's CPU path from the same
   weights: floats within the CPU tests' tolerances (SEQ_TOL), integers
   equal; each chunk_eval op reads its inputs back once a run on the
   card, never on the CPU.
31c. crnn_ctc_train: CRNN-CTC text recognition (``models/crnn_ctc.py``,
   the model zoo's OCR program) at its widths: batch 32 of 48 x 512
   images, four conv groups of 16-128 channels with batch norm,
   ``im2sequence`` to 64 steps of 768, GRUs of 200 both ways, 96
   classes, ``warpctc``, Momentum with L2 decay.  Step 1 on the card
   within 1e-4 of the port's CPU path; 2 warm-up and 4 timed steps:
   finite losses, no port kernel launched; ms per step, images/s, peak
   memory, one profiled step; the greedy decode and edit distances on
   the trained scope.
31d. detection_ops: the programs of the 33 detection op types
   (``det_programs``, the CPU tests' programs) on the card against the
   port's CPU path from the same weights: floats within DET_TOL,
   integers (match indices, keep masks, sampled indices) equal;
   detection_map and generate_mask_labels read their inputs back once
   an op a run on the card, never on the CPU.
31e. ssd_train: MobileNet-SSD (``models/ssd.py``, the model zoo's
   detector) at its widths: batch 64 of 300 x 300 images, 1917 priors,
   21 classes, RMSProp on the piecewise rate with L2 decay.  Step 1 at
   batch 8 on the card within 1e-3 of the port's CPU path; 2 warm-up and
   4 timed steps: finite losses, no port kernel launched, no host sync
   in a step; ms per step, peak memory, one profiled step; the eval
   program (detection_output + detection_map) on the trained scope: the
   [64, 200, 6] slab, the mAP, one detection_map sync, ms a batch.
31f. ssd_head_k1: multi_box_head with the layer's 3x3 heads under
   FLAGS_conv_pallas at base widths over the six maps (batch 8), fp32
   and bf16, against the flag-off run: K1 within its tolerances, 12
   launches a run, each variant as k1_plan plans it.
31g. core_ops: the programs of the 34 core op types of ROADMAP item 13c.3a and
   of ``fill_any_like`` (``core_programs``, the CPU tests' programs) on the
   card against the port's CPU path from the same weights: floats within
   CORE_TOL, integers and selections equal, the uniform draws by their
   statistics on each side; no port kernel launched and no host sync in a run
   (torch's sync debug mode).
31h. yolov3_train: YOLOv3 on DarkNet-53 (``models/yolov3.py``, the model
   zoo's detector) at its widths: batch 8 of 608 x 608 images, 80
   classes, 75 convolutions, Momentum with L2 decay on the warmed-up
   piecewise rate.  Step 1 at batch 2 and 320 x 320 on the card against
   the port's CPU path: the loss within 1e-5, the output convs' gradients
   within 1e-4, the whole gradient within 2e-2 (the CPU's own change under a
   1e-7 nudge of the image shown beside it); 2 warm-up and 4 timed steps
   through ``timing.timed_steps``: finite losses, no port kernel launched, no
   host sync in a step; ms per step, peak memory, one profiled step and the
   cost ledger's count of a step.
31i. yolov3_eval: the eval program (yolo_box on the three maps,
   transpose, concat, multiclass_nms over 80 classes) on the trained
   scope: the [8, 100, 6] slab, ms a batch, no host sync; the slab equal
   to the port's CPU multiclass_nms of the card's own candidates, at
   full size and at batch 2 and 320 x 320, where the candidates' boxes
   and scores also agree with the port's CPU path's.
31j. yolo_k1: YOLOv3's 3x3 stride-1 convs (six shapes, 3 -> 32 at 608²
   to 512 -> 1024 at 19², batch 8) forward and backward under
   FLAGS_conv_pallas in fp32 and bf16 against cuDNN: K1 within its
   tolerances, one launch a conv that k1_applies takes, each variant as
   k1_plan plans it; then each shape's K1 time beside cuDNN, the plain
   version and the bound.
31k. misc_ops: the programs of the 49 op types of misc_ops.py and
   misc_ops2.py (activations, losses, group/instance/spectral norms, the
   image and shape ops, temporal_shift, grid_sampler, linspace, the 3-D
   convs and pool3d, lrn, the CTR ops, mean_iou; forward and gradients)
   on the card against the port's CPU path: floats within the CPU tests'
   tolerances, integers and linspace's points equal, sampling_id by its
   frequencies on each side; no port kernel, no host sync.
31l. tsm_train: TSM, the model zoo's temporal-shift ResNet-50 video
   classifier (16 clips x 8 frames of 224², 400 classes, 16
   temporal_shifts, fp32, Momentum + L2Decay on the piecewise rate):
   step 1 at 2 clips of 112², dropout off, within 1e-5 of the port's CPU
   path (loss), the fc gradients within 1e-4, the whole gradient within
   10x the CPU's own gap under a 1e-7 nudge of the frames; 2 warm-up and
   8 timed steps: finite losses, no port kernel launched, no host sync in
   a step; ms per step, clips and frames a second, peak memory, one
   profiled step and the cost ledger's count of a step.
32. cost_ledger: ``Executor.cost_record`` of BERT-base training (phase
   9's configuration), the ResNet-50 step of phase 12 and the BERT-base
   serving buckets (``warmup(ledger=True)``): FLOPs, bytes, peak,
   ``estimated_step_s``, the measured ms a step (``timing.timed_steps``)
   and the FLOPs a second as a share of the dtype's peak.  Fails unless
   the counted FLOPs of mul / matmul / conv2d and their grads lie within
   2% of the analytic count from the ops' shapes, and K1-K4's counted
   FLOPs equal their launches times their ``kernel_work``.
33. op_bench: ``fluid/benchmark.py``'s resnet50 (batch 256) and bert
   (batch 64) suites on the card, one row per entry (ms fwd + bwd,
   TFLOP/s, GB/s, the ledger's counted FLOPs); fails on an entry that
   errs or whose counted conv / mul / matmul FLOPs miss the estimate by
   more than 2%.  Then the whole run's wall time.
34. kernels: one JSON line listing every ported kernel, with its
   launches on every main path (0 on DeepFM's, the wrappers', the
   parameter server's, ResNet-50 inference's, the book models',
   CRNN-CTC's, the detection programs', MobileNet-SSD's, the core op
   programs', YOLOv3's, the misc op programs' and TSM's; the
   data-parallel and model-parallel paths' as their rank 0 counted
   them, the elastic path's as its world of one counted them); K2's row
   carries kernel_ring's record.

The last line is {"ok": true, "device": {...}}.  Exits non-zero, printing
no result, where torch.cuda.is_available() is false.  ``python3
chip_smoke.py dp_child <mode> <dir>`` is a data- or model-parallel
phase's rank (the launcher runs it; not for direct use), and ``python3
chip_smoke.py
ps_child <server|trainer> <dir> <index>`` a pserver or trainer of the
PS phases (not for direct use either).  The PS phases alone (no build
needed): ``python3 -c 'import chip_smoke as c; c.phase_device(); cl =
c._PsCluster(c._ps_init()); cl.__enter__(); l, ref =
c.phase_ps_deepfm(cl); c.phase_ps_two_trainers(cl, ref);
cl.__exit__(None, None, None)'``.  The new phases alone (with
the build and phase 9, whose weights and batch they take): ``python3 -c
'import chip_smoke as c; c.phase_device(); c.phase_build(); t =
c.phase_train(); c.phase_dp_wus(t); c.phase_dp_two_ranks_sharded(t);
c.phase_elastic_shrink()'``.  The book phases alone (no build needed):
``python3 -c 'import chip_smoke as c; c.phase_device(); p, mt =
c.phase_book_train(); c.phase_book_check(mt)'``.  The training surface
and the wrappers alone: ``python3 -c 'import chip_smoke as c;
c.phase_device(); c.phase_build(); t = c.phase_train();
c.phase_train_surface(t); c.phase_wrappers()'``.  The model-parallel
phases and the pipelines alone: ``python3 -c 'import chip_smoke as c;
c.phase_device(); c.phase_build(); t = c.phase_train(); p, ref, two =
c.phase_mp_bert(t); c.phase_pp_bert(t, ref, two); c.phase_moe(two)'``.  The control flow,
the ledger and the per-op bench alone: ``python3 -c 'import chip_smoke
as c; c.phase_device(); c.phase_build(); c.phase_control_flow();
c.phase_cost_ledger(); c.phase_op_bench()'``.  The sequence ops and
CRNN-CTC alone (no build needed): ``python3 -c 'import chip_smoke as c;
c.phase_device(); c.phase_sequence_ops(); c.phase_crnn_ctc_train()'``.
Detection and MobileNet-SSD alone (K1 built for the head check):
``python3 -c 'import chip_smoke as c; c.phase_device(); c.phase_build();
c.phase_detection_ops(); c.phase_ssd_train(); c.phase_ssd_head_k1()'``.
The core op types and YOLOv3 alone (K1 built for yolo_k1): ``python3 -c
'import chip_smoke as c; c.phase_device(); c.phase_build();
c.phase_core_ops(); l, s, h = c.phase_yolov3_train();
c.phase_yolov3_eval(s, h); c.phase_yolo_k1()'``.  The misc op types and
TSM alone (no build needed): ``python3 -c 'import chip_smoke as c;
c.phase_device(); c.phase_misc_ops(); c.phase_tsm_train()'``.
"""

import contextlib
import functools
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import timing
from paddle_tpu_torch.fluid.costmodel import kernel_work, stored_bytes
from paddle_tpu_torch.fluid.ops import _kernels, attention_ops
from paddle_tpu_torch.fluid.ops.attention_ops import (
    attention_delta, attention_reference, dbias_reference, dkv_reference,
    dq_reference, flash_attention, flash_attention_bwd_dbias,
    flash_attention_bwd_dkv, flash_attention_bwd_dq, recompute_p_dp)
from paddle_tpu_torch.fluid.ops.conv_ops import (
    K1_VARIANTS, conv3x3_bn_relu, conv3x3_bn_relu_reference, k1_plan)
from paddle_tpu_torch.fluid.ops.norm_ops import (
    layer_norm_reference, row_layer_norm)
from paddle_tpu_torch.models import (bert, book, crnn_ctc, deepfm, lenet,
                                     resnet, ssd, transformer, tsm, yolov3)

# H100 SXM published peaks (NVIDIA data sheet): device memory rate, and
# float32 on the CUDA cores (the main path runs fp32 with TF32 off)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12      # tensor cores, dense (K1's bound in bf16)
PEAK_TF32_FLOPS = 495e12      # tensor cores, dense; split TF32 (three
#                               products for one fp32-accurate product, as
#                               K2 and K4 compute) runs at a third of it
# the K2 variant with a wrong pairing of p's columns and V's rows, which
# phase_kernel's check must fail
PLANTED_FAULT = ("flash_attention_fwd", ("PADDLE_ATTN_PLANTED_FAULT",))
# the backward variant whose K3 pairs K's rows 2t and 2t + 1 with the wrong
# columns of ds in ds k, and whose K5 swaps the two columns of each pair it
# writes: phase_kernel_bwd's check must fail both
BWD_PLANTED_FAULT = ("flash_attention_bwd", ("PADDLE_ATTN_BWD_PLANTED_FAULT",))
# the tensor-core kernels of the attention sources, held to no spills and
# to HMMA instructions in their machine code, with their instantiations
# (fp32/bf16 x D 64/128; q_rows_kernel also x dQ (K3) / dBias (K5))
MMA_KERNELS = (("flash_attention_fwd", "flash_fwd_kernel", 4),
               ("flash_attention_bwd", "dkv_kernel", 4),
               ("flash_attention_bwd", "q_rows_kernel", 8))

SEED = 1234
# every kernel wrapper of the port, by the name the kernels line gives it
KERNELS = {"flash_attention_fwd": flash_attention,
           "flash_attention_bwd_dq": flash_attention_bwd_dq,
           "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
           "flash_attention_bwd_dbias": flash_attention_bwd_dbias,
           "conv3x3_bn_relu": conv3x3_bn_relu,
           "layer_norm": row_layer_norm}
B, H, S, D = 8, 12, 128, 64             # BERT-base serving shape
# Tolerances.  A query row whose every key is masked (a padding position:
# BERT's mask adds -1e4 to all its scores) holds its scores at -1e4 + O(1),
# where float32 spacing is 2^-10 ~ 1e-3: two summation orders that differ
# by one ulp in q.k move such a row's probabilities by up to ~1e-3
# relative, so its output by up to ~1e-3 * max|v|.  Those rows get their
# own bound; every other row is held to the tight one.
FP32_ATOL = 1e-4              # kernel vs plain version, fp32, real rows
MASKED_ATOL = 5e-3            # ... fully masked rows (|v| <= ~5 for randn)
BF16_TOL = 2e-2               # bf16 kernel vs fp32 plain (atol and rtol)
SERVE_TOL = 1e-3              # served rows vs alone / composition / CPU,
#                               real token positions
SERVE_PAD_TOL = 5e-2          # ... padding positions: the masked-row
#                               spread above (~3e-3 per layer) over 12 layers


_EMITTED = []                 # (phase, perf_counter) of every line emitted


def emit(**kw):
    _EMITTED.append((kw.get("phase"), time.perf_counter()))
    print(json.dumps(kw), flush=True)


def _seconds_by_phase(t_start):
    """Wall seconds from one run of lines of a phase name to the next,
    the last line of each run closing it: where the whole run's time
    went, phase by phase (a phase's own setup counted in it)."""
    out, prev = {}, t_start
    for i, (name, t) in enumerate(_EMITTED):
        if i + 1 < len(_EMITTED) and _EMITTED[i + 1][0] == name:
            continue
        out[name] = out.get(name, 0.0) + t - prev
        prev = t
    return out


def cuda_time_ms(fn, iters=50, warmup=20):
    """Device time per call of ``fn``.  A spin kernel holds the stream
    while the host enqueues the calls, so the CUDA events around them
    bracket device work only, not Python's launch overhead.  The calls
    must also fit the device's queue of pending launches (about a
    thousand), or enqueueing blocks: while the host cannot get ahead,
    the spin doubles and the count halves.  A call that waits for the
    device inside never lets the host get ahead, and its timing fails."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin = 100_000_000                  # GPU cycles, ~50 ms at 2 GHz
    while iters >= 1:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(spin)
        ev[1].record()
        h0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - h0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / iters
        spin *= 2
        iters //= 2
    raise SystemExit("could not keep the host ahead of the device "
                     "while timing %r" % (fn,))


def _check_no_host_sync(fn, spin=100_000_000):
    """A kernel wrapper must only enqueue: called while a spin kernel holds
    the stream, it has to return long before the spin ends."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    torch.cuda._sleep(spin)
    ev[1].record()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin_ms = ev[0].elapsed_time(ev[1])
    emit(phase="kernel_no_host_sync", host_ms=host_ms, spin_ms=spin_ms,
         ok=host_ms < spin_ms / 2)
    if host_ms >= spin_ms / 2:
        raise SystemExit("a kernel wrapper blocked the host %.1f ms behind "
                         "a %.1f ms busy stream (a hidden synchronisation)"
                         % (host_ms, spin_ms))


def _fail_unless(name, checks):
    """Ends the run, naming the phase and its failed checks, unless every
    check passed."""
    if not all(checks.values()):
        raise SystemExit("%s checks failed: %s"
                         % (name, [k for k, ok in checks.items() if not ok]))


@functools.lru_cache(maxsize=None)
def _card():
    """The card's name and power limit, as nvidia-smi prints them (read
    once a process: neither changes while it runs, and each nvidia-smi
    call costs its start-up)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_device():
    t0 = time.perf_counter()
    smi = _card()
    smi_s = time.perf_counter() - t0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit(phase="device", nvidia_smi=smi, nvidia_smi_s=smi_s,
         torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(),
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return smi


SASS_OPS = ("HMMA", "LDSM", "LDGSTS")    # tensor-core mma, ldmatrix, cp.async


def _sass_counts(source, kernel):
    """Instructions of each name in SASS_OPS in cuobjdump's SASS of each
    instantiation of ``kernel`` in the library of ``source``."""
    cuobjdump = str(Path(_kernels._nvcc()).with_name("cuobjdump"))
    sass = subprocess.run(
        [cuobjdump, "-sass", str(_kernels.library_path(source))],
        capture_output=True, text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[1].strip()
            name = fn if kernel in fn else None
            if name is not None:
                counts[name] = dict.fromkeys(SASS_OPS, 0)
        elif name is not None:
            for op in SASS_OPS:
                if op + "." in ln or op + " " in ln:
                    counts[name][op] += 1
    return counts


def phase_build():
    """Every source and the planted-fault variants of K2 and of the
    backward, one nvcc each, all at once; then the tensor-core attention
    kernels (K2, K3/K5, K4) are held to 0 spills (ptxas) and to HMMA
    instructions (cuobjdump) at every instantiation."""
    t0 = time.perf_counter()
    times = _kernels.build_all(variants=[PLANTED_FAULT, BWD_PLANTED_FAULT])
    wall = time.perf_counter() - t0
    ptxas = {}
    for src in _kernels.sources():
        lines = _kernels.build_log(src.stem).splitlines()
        ptxas[src.stem] = [ln.strip() for ln in lines
                           if "registers" in ln or "spill" in ln]
    emit(phase="build", seconds=round(wall, 3), compiled=times,
         ptxas=ptxas)
    bad = []
    for source, kernel, want in MMA_KERNELS:
        report = _ptxas_report(source, kernel)
        sass = _sass_counts(source, kernel)
        spill_free = {n: any(" 0 bytes spill stores, 0 bytes spill loads"
                             in ln for ln in lines)
                      for n, lines in report.items()}
        emit(phase="build_mma", source=source, kernel=kernel,
             instantiations=len(report), ptxas=report, sass=sass,
             spill_free=spill_free)
        if len(report) != want or len(sass) != want:
            bad.append("%s: %d instantiations in ptxas's report, %d in "
                       "the SASS (want %d)"
                       % (kernel, len(report), len(sass), want))
        bad += ["%s spills" % n for n, ok in spill_free.items() if not ok]
        bad += ["%s has no HMMA" % n for n, c in sass.items()
                if not c["HMMA"]]
    if bad:
        raise SystemExit("attention kernels fail the build gate: %s" % bad)


def _padding_bias(lengths, dtype, dev):
    """[B, 1, S, S] additive mask as bert_encoder builds it: 0 where both
    query and key are real tokens, -1e4 elsewhere."""
    m = (torch.arange(S, device=dev)[None, :] <
         torch.as_tensor(lengths, device=dev)[:, None]).float()
    keep = m[:, :, None] * m[:, None, :]
    return ((keep - 1.0) * 1e4).unsqueeze(1).to(dtype)


def _fully_masked_rows(bias, BH, S_q):
    """[BH, S_q] bool: rows whose every key carries a -1e4 mask."""
    if bias is None:
        return torch.zeros(BH, S_q, dtype=torch.bool, device="cuda")
    rows = bias.float().amax(-1)                # [Bb, 1|heads, S_q] or 3-D
    if rows.dim() == 2:
        return rows <= -1e3
    Bb = rows.shape[0]
    return (rows.expand(Bb, BH // Bb, S_q) <= -1e3).reshape(BH, S_q)


def _k2_check(name, t, dt, causal):
    """K2 against attention_reference (fp32, on the dt-rounded inputs) in
    one case: (ok, report)."""
    args = [None if t[n] is None else t[n].to(dt)
            for n in ("q", "k", "v", "bias")]
    scale = 1.0 / math.sqrt(args[0].shape[-1])
    got, lse = flash_attention(*args, scale, causal=causal, with_lse=True)
    torch.cuda.synchronize()
    # the plain version in fp32 on the (possibly bf16-rounded) inputs
    ref_args = [None if a is None else a.float() for a in args]
    want, want_lse = attention_reference(*ref_args, scale, causal=causal,
                                         with_lse=True)
    row_err = (got.float() - want).abs().amax(-1)       # [BH, S_q]
    masked = _fully_masked_rows(args[3], *row_err.shape)
    err = row_err[~masked].max().item()
    masked_err = row_err[masked].max().item() if masked.any() else 0.0
    lse_err = (lse - want_lse).abs()[~masked].max().item()
    finite = bool(torch.isfinite(got.float()).all())
    if dt == torch.float32:
        ok = err <= FP32_ATOL and lse_err <= FP32_ATOL and \
            masked_err <= MASKED_ATOL
        tol = "atol %g (fully masked rows %g)" % (FP32_ATOL, MASKED_ATOL)
    else:
        ok = bool(torch.allclose(got.float(), want, atol=BF16_TOL,
                                 rtol=BF16_TOL)) and lse_err <= BF16_TOL
        tol = "atol/rtol %g vs fp32 plain of bf16 inputs" % BF16_TOL
    b = args[3]
    return ok and finite, dict(
        case=name, dtype=str(dt), shape=list(args[0].shape),
        kv=args[1].shape[1], causal=causal,
        bias=None if b is None else dict(shape=list(b.shape),
                                         strides=list(b.stride())),
        max_abs_err=err, masked_rows=int(masked.sum()),
        masked_rows_max_abs_err=masked_err, lse_max_abs_err=lse_err,
        tolerance=tol, finite=finite)


def phase_kernel():
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def qkv(BH, S_q, S_kv, d=D, bias=None):
        return dict(q=rand(BH, S_q, d), k=rand(BH, S_kv, d),
                    v=rand(BH, S_kv, d), bias=bias)

    lengths = torch.randint(1, S + 1, (B,), generator=gen,
                            device=dev).tolist()
    base = qkv(B * H, S, S, bias=_padding_bias(lengths, torch.float32, dev))
    cases = [
        ("bert_base_fp32", base, torch.float32, False),
        ("bert_base_bf16", base, torch.bfloat16, False),
        ("causal_lse_fp32", qkv(B * H, S, S), torch.float32, True),
        ("ragged_cross_77x200_fp32",
         qkv(16, 77, 200, bias=torch.where(rand(16, 77, 200) < -1.5, -1e4,
                                           0.0)), torch.float32, False),
        ("d128_bias_fp32", qkv(48, S, S, 128, bias=base["bias"][:4]),
         torch.float32, False),
        ("d128_causal_lse_bf16", qkv(48, S, S, 128), torch.bfloat16, True),
        # the edges of the mma fragments and tiles: S_q and S_kv not
        # multiples of 8 or 16, one key, three K/V tiles under causal
        ("1x1_fp32", qkv(4, 1, 1), torch.float32, False),
        ("9x13_head_broadcast_bias_fp32",
         qkv(24, 9, 13, bias=rand(2, 1, 9, 13)), torch.float32, False),
        ("130x130_causal_fp32", qkv(8, 130, 130), torch.float32, True),
        ("130x130_bias_bf16", qkv(8, 130, 130, bias=rand(8, 130, 130)),
         torch.bfloat16, False),
        # a bias read with bs_k != 1 (a transposed view) and one broadcast
        # over the batch (bs_b = 0)
        ("transposed_bias_77x200_fp32",
         qkv(16, 77, 200, bias=rand(16, 200, 77).transpose(1, 2)),
         torch.float32, False),
        ("transposed_bias_77x200_bf16",
         qkv(16, 77, 200, bias=rand(16, 200, 77).transpose(1, 2)),
         torch.bfloat16, False),
        # rows longer than S_kv: the last 16-byte chunk of a bias row is cut
        ("sliced_bias_77x198_fp32",
         qkv(16, 77, 198, bias=rand(16, 77, 208)[:, :, :198]),
         torch.float32, False),
        ("batch_broadcast_bias_d128_fp32",
         qkv(4 * H, S, S, 128, bias=rand(1, H, S, S).expand(4, H, S, S)),
         torch.float32, False),
    ]
    errs = {}
    for name, t, dt, causal in cases:
        ok, rep = _k2_check(name, t, dt, causal)
        emit(phase="kernel_check", ok=ok, **rep)
        if not ok:
            raise SystemExit("flash_attention disagrees with its plain "
                             "version in case %s" % name)
        errs[name] = rep["max_abs_err"]
    _planted_fault_check(cases[:2])

    # timing at the main path's shape and dtype (BERT-base, fp32, B=8)
    q, k, v, bias = base["q"], base["k"], base["v"], base["bias"]
    scale = 1.0 / math.sqrt(D)
    _check_no_host_sync(lambda: flash_attention(q, k, v, bias, scale))
    ms = cuda_time_ms(lambda: flash_attention(q, k, v, bias, scale))
    plain_ms = cuda_time_ms(
        lambda: attention_reference(q, k, v, bias, scale))
    q4, k4, v4 = (t.view(B, H, S, D) for t in (q, k, v))
    library_ms = cuda_time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=bias, scale=scale))
    flops, nbytes = kernel_work("K2", bh=B * H, sq=S, sk=S, d=D,
                                esz=q.element_size(),
                                bias_bytes=stored_bytes(bias))
    timing = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                  **_attention_bound(nbytes, flops))
    emit(phase="kernel_time", shape=[B * H, S, D], dtype="float32",
         roofline_share=timing["bound_ms"] / ms, **timing)
    return dict(max_abs_err=errs["bert_base_fp32"], **timing)


def _planted_fault_check(cases):
    """K2 built with a wrong pairing of p's columns and V's rows in p v
    (PLANTED_FAULT) must fail _k2_check in every one of ``cases``."""
    real = _kernels.load
    name, defines = PLANTED_FAULT
    _kernels.load = lambda n, d=(): real(n, defines if n == name else d)
    try:
        caught = {c[0]: not _k2_check(*c)[0] for c in cases}
    finally:
        _kernels.load = real
    emit(phase="kernel_planted_fault", fault="p v rows 2t and 2t+1 "
         "swapped (%s)" % defines[0], caught=caught, ok=all(caught.values()))
    if not all(caught.values()):
        raise SystemExit("the K2 check passed a kernel with a fault planted "
                         "in its p v step: %s" % caught)


FEEDS = ("src_ids", "pos_ids", "sent_ids", "input_mask")


def _build_bert(cfg):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        data = [fluid.layers.data(n, [cfg.max_seq_len, 1],
                                  dtype="float32" if n == "input_mask"
                                  else "int64") for n in FEEDS]
        enc = bert.bert_encoder(*data, cfg)
    return main, startup, enc


def _requests(cfg, rng, n):
    out = []
    for _ in range(n):
        rows = int(rng.randint(1, 9))
        lengths = rng.randint(1, cfg.max_seq_len + 1, rows)
        out.append({
            "src_ids": rng.randint(0, cfg.vocab_size,
                                   (rows, cfg.max_seq_len, 1)),
            "pos_ids": np.tile(np.arange(cfg.max_seq_len).reshape(
                1, -1, 1), (rows, 1, 1)),
            "sent_ids": rng.randint(0, 2, (rows, cfg.max_seq_len, 1)),
            "input_mask": (np.arange(cfg.max_seq_len)[None, :, None] <
                           lengths[:, None, None]).astype(np.float32),
        })
    return out


def _split_err(a, b, feed):
    """[max abs err over real token positions, over padding positions]."""
    real = feed["input_mask"][..., 0] > 0
    d = np.abs(a - b).max(-1)
    return [float(d[real].max()),
            float(d[~real].max()) if (~real).any() else 0.0]


def _within(err):
    return bool(err[0] <= SERVE_TOL and err[1] <= SERVE_PAD_TOL)


def _device_ms(prof, n):
    """Kernel time per iteration, by kernel name, from a profiler run of
    n iterations: device-side events only (CPU ops also carry the time of
    the kernels they launched, which would count it twice)."""
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kern) / n / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    return total, [dict(name=e.key[:90],
                        ms=e.self_device_time_total / n / 1e3,
                        calls=e.count / n) for e in top]


def _timeline(prof):
    """(busy ms, idle-gap ms, event count) of the device timeline of a
    profiled window: kernels, copies and fills in start order; busy is
    the union of their spans, idle the time between the first start and
    the last end that no event covers."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, idle_us, end = 0.0, 0.0, None
    for a, b in spans:
        if end is not None and a > end:
            idle_us += a - end
        lo = a if end is None else max(a, end)
        busy_us += max(0.0, b - lo)
        end = b if end is None else max(end, b)
    return busy_us / 1e3, idle_us / 1e3, len(spans)


WARM_STEPS, TIMED_STEPS = 2, 4      # every training phase but tsm_train


def _train_steps(exe, main, feeds, fetch, scope):
    """Runs WARM_STEPS + TIMED_STEPS steps, feeds taken in turn; (fetches
    of each step as tensors, ms per timed step)."""
    got = []
    for i in range(WARM_STEPS + TIMED_STEPS):
        if i == WARM_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        got.append(exe.run(main, feed=feeds[i % len(feeds)],
                           fetch_list=fetch, scope=scope,
                           return_numpy=False))
    torch.cuda.synchronize()
    return got, (time.perf_counter() - t0) / TIMED_STEPS * 1e3


def _profile_record(exe, main, feed, fetch, scope):
    """One profiled step: ({wall ms, kernel ms, device busy ms and share,
    device events, CUDA kernel launch calls, top kernels}, the profile)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                return_numpy=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    dev_ms, top = _device_ms(prof, 1)
    busy_ms, _, events = _timeline(prof)
    launch = [e for e in prof.key_averages()
              if e.key.startswith("cudaLaunchKernel")]
    return dict(wall_ms=wall_ms, kernel_ms=dev_ms, device_busy_ms=busy_ms,
                device_busy_share=busy_ms / wall_ms, device_events=events,
                launch_calls=sum(e.count for e in launch),
                top_kernels=top), prof


def _profile_step(name, exe, main, feed, fetch, scope):
    """One profiled step: kernel time against wall, the device timeline's
    busy share, device events, launch calls, top kernels and the kernel
    time by kind, which it returns."""
    rec, prof = _profile_record(exe, main, feed, fetch, scope)
    kinds = _kernel_kinds(prof)
    emit(phase=name, kernel_ms_by_kind=kinds, **rec)
    return kinds


def phase_profile(exe, infer, enc, scope, sv_args, reqs):
    """Where the time goes.  (a) One full batch of 8: host wall of
    back-to-back Executor.run calls (no serving threads) against the
    kernel time torch.profiler records.  (b) The same 24-request burst
    served again under the profiler: the device timeline's busy time and
    idle gaps against wall, and the host's kernel-launch calls."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    req = max(reqs, key=lambda r: r["src_ids"].shape[0])
    feed = {n: np.concatenate([a] * 8)[:8] for n, a in req.items()}

    def run():
        exe.run(infer, feed=feed, fetch_list=[enc], scope=scope,
                return_numpy=False)
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    n = 10
    t0 = time.perf_counter()
    for _ in range(n):
        run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=acts) as prof:
        for _ in range(5):
            run()
        torch.cuda.synchronize()
    dev_ms, top = _device_ms(prof, 5)
    emit(phase="profile_batch", batch=8,
         ops_per_batch=len(infer.global_block().ops),
         host_wall_ms_per_batch=wall_ms, device_ms_per_batch=dev_ms,
         device_busy_share=dev_ms / wall_ms, top_kernels=top)

    sv = fluid.ServingExecutor(**sv_args)
    sv.warmup()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        futs = [sv.submit(r) for r in reqs]
        for f in futs:
            f.result(timeout=300)
        wall_ms = (time.perf_counter() - t0) * 1e3
        sv.close()
    st = sv.stats()
    busy_ms, idle_ms, events = _timeline(prof)
    launch = [e for e in prof.key_averages()
              if e.key.startswith("cudaLaunchKernel")]
    emit(phase="profile_serve", requests=len(reqs), batches=st["batches"],
         wall_ms=wall_ms, wall_ms_per_batch=wall_ms / st["batches"],
         device_events=events,
         device_events_per_batch=events / st["batches"],
         device_busy_ms=busy_ms, device_idle_gaps_ms=idle_ms,
         device_busy_share=busy_ms / wall_ms,
         launch_calls=sum(e.count for e in launch),
         launch_api_ms=sum(e.self_cpu_time_total for e in launch) / 1e3)


def phase_slice():
    cfg = bert.base_config()
    main, startup, enc = _build_bert(cfg)
    infer = main.clone(for_test=True)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    n_params = sum(scope.find_var(v.name).numel()
                   for v in main.global_block().all_parameters())
    emit(phase="startup", seconds=time.perf_counter() - t0,
         parameters=int(n_params), layers=cfg.num_layers,
         hidden=cfg.hidden_size, heads=cfg.num_heads, seq=cfg.max_seq_len)

    specs = {n: ((cfg.max_seq_len, 1), "float32" if n == "input_mask"
                 else "int64") for n in FEEDS}
    sv_args = dict(program=infer, feed_specs=specs, fetch_list=[enc],
                   scope=scope, executor=exe, max_batch=8)
    sv = fluid.ServingExecutor(**sv_args)
    reqs = _requests(cfg, np.random.RandomState(SEED), 24)
    torch.cuda.reset_peak_memory_stats()
    # the main path's run: counts go to 0 here and are read after close()
    _reset_launches()
    warm = sv.warmup()
    warm_launches = flash_attention.launches
    done = {}
    t_start = time.perf_counter()
    futs = []
    for i, r in enumerate(reqs):
        t = time.perf_counter()
        f = sv.submit(r)
        f.add_done_callback(
            lambda _f, i=i: done.__setitem__(i, time.perf_counter()))
        futs.append((f, t))
    outs = [f.result(timeout=300)[0] for f, _ in futs]
    wall = time.perf_counter() - t_start
    sv.close()
    all_launches = _launches()
    launches = all_launches["flash_attention_fwd"]
    st = sv.stats()
    served_launches = launches - warm_launches
    lat_ms = sorted((done[i] - t) * 1e3 for i, (_, t) in enumerate(futs))
    rows = sum(r["src_ids"].shape[0] for r in reqs)
    emit(phase="serve", warmup_s=warm, stats=st, wall_s=wall,
         requests_per_s=len(reqs) / wall, rows_per_s=rows / wall,
         p50_ms=float(np.percentile(lat_ms, 50)),
         p99_ms=float(np.percentile(lat_ms, 99)),
         peak_device_mb=torch.cuda.max_memory_allocated() / 2**20,
         kernel_launches=launches, warmup_launches=warm_launches,
         served_launches=served_launches)
    checks = {
        "recompiles_after_warmup_0": st["recompiles"] == 0,
        "all_answered": st["responses"] == len(reqs),
        "launches_12_per_warmup_bucket":
            warm_launches == cfg.num_layers * len(sv.buckets),
        "launches_12_per_batch":
            served_launches == cfg.num_layers * st["batches"],
        "no_backward_launches": not any(
            c for n, c in all_launches.items() if n != "flash_attention_fwd"),
    }

    # every response finite, and equal to its rows run alone
    err_alone = [0.0, 0.0]
    for r, out in zip(reqs, outs):
        n = r["src_ids"].shape[0]
        if out.shape != (n, cfg.max_seq_len, cfg.hidden_size) or \
                not np.isfinite(out).all():
            raise SystemExit("non-finite or mis-shaped response %s"
                             % (out.shape,))
        alone, = exe.run(infer, feed=r, fetch_list=[enc], scope=scope)
        err_alone = np.maximum(err_alone, _split_err(out, alone, r))
    checks["batched_matches_alone"] = _within(err_alone)

    # the composition path (use_fused_attention=False) with the same weights
    ccfg = bert.base_config(use_fused_attention=False)
    cmain, _, cenc = _build_bert(ccfg)
    probe = reqs[int(np.argmax([r["src_ids"].shape[0] for r in reqs]))]
    fused, = exe.run(infer, feed=probe, fetch_list=[enc], scope=scope)
    comp, = exe.run(cmain.clone(for_test=True), feed=probe,
                    fetch_list=[cenc], scope=scope)
    err_comp = _split_err(fused, comp, probe)
    checks["composition_matches_fused"] = _within(err_comp)

    # the port's CPU path (plain attention, CPU matmuls) on two rows
    cpu_scope = fluid.Scope()
    for v in main.global_block().all_parameters():
        cpu_scope.set_var(v.name, scope.find_var(v.name).cpu())
    two = {n: a[:2] for n, a in probe.items()}
    cpu_out, = fluid.Executor(fluid.CPUPlace()).run(
        infer, feed=two, fetch_list=[enc], scope=cpu_scope)
    err_cpu = _split_err(fused[:2], cpu_out, two)
    checks["gpu_matches_cpu_path"] = _within(err_cpu)

    emit(phase="slice_check",
         tolerance="atol %g real tokens, %g padding positions"
         % (SERVE_TOL, SERVE_PAD_TOL),
         max_abs_err_batched_vs_alone=list(map(float, err_alone)),
         max_abs_err_fused_vs_composition=err_comp,
         max_abs_err_gpu_vs_cpu=err_cpu, checks=checks)
    _fail_unless("slice", checks)
    phase_profile(exe, infer, enc, scope, sv_args, reqs)
    return all_launches


# ---------------------------------------------------------------------------
# Backward kernels (K3, K4, K5) and BERT-base pretraining
# ---------------------------------------------------------------------------

BT = 32                       # BERT-base training batch
MAX_PRED = 20                 # masked positions per sequence
TRAIN_LR = 1e-4
BWD_FP32_ATOL = 1e-4          # K3/K4/K5 vs plain version, fp32, real rows
# A fully masked query row has scores at -1e4 + O(1), where fp32 spacing
# is 2^-10 ~ 1e-3: two summation orders can put s one grid step apart,
# which moves p = exp(s - lse) by up to ~1e-3 relative (2e-3 allows one
# step in the scale product and one in the bias add).  Such rows are held
# to that bound propagated through each gradient (_masked_bounds); every
# other entry keeps BWD_FP32_ATOL.
MASKED_P_REL = 2e-3
TRAIN_LOSS_RTOL = 1e-4        # step-1 loss, card fused vs composition/CPU
TRAIN_GRAD_TOL = 1e-3         # |grad diff| / max|grad|, same comparisons


def _bwd_args(t, dt, causal, zero_masked_do):
    """(q, k, v, bias, scale, dO, lse, delta, causal) in ``dt``, with out
    and LSE from the plain forward in fp32 of the dt-rounded inputs.
    ``zero_masked_do``: dO is 0 on fully masked rows, as training gives it
    (the loss never reads a padding position)."""
    q, k, v, b, dO = [None if t[n] is None else t[n].to(dt)
                      for n in ("q", "k", "v", "bias", "dO")]
    scale = 1.0 / math.sqrt(q.shape[-1])
    masked = _fully_masked_rows(b, q.shape[0], q.shape[1])
    if zero_masked_do:
        dO = dO.masked_fill(masked.unsqueeze(-1), 0.0)
    ref = [None if a is None else a.float() for a in (q, k, v, b)]
    out, lse = attention_reference(*ref, scale, causal=causal,
                                   with_lse=True)
    delta = attention_delta(out.to(dt), dO)
    return (q, k, v, b, scale, dO, lse, delta, causal), masked


def _masked_bounds(args, masked):
    """Per-entry bounds on dq, dk, dv, dbias from MASKED_P_REL on the p of
    fully masked rows (see above), from the plain version's p and dp."""
    q, k, v, b, scale, dO, lse, delta, causal = args
    p, dp = recompute_p_dp(q, k, v, b, scale, dO, lse, causal)
    p_err = p * masked.unsqueeze(-1) * MASKED_P_REL   # 0 on other rows
    ds_err = p_err * (dp - delta.float().unsqueeze(-1)).abs()
    return dict(
        dq=torch.einsum("bqk,bkd->bqd", ds_err * scale, k.float().abs()),
        dk=torch.einsum("bqk,bqd->bkd", ds_err * scale, q.float().abs()),
        dv=torch.einsum("bqk,bqd->bkd", p_err, dO.float().abs()),
        dbias=ds_err)


def _bound(nbytes, flops, peak_flops=PEAK_FP32_FLOPS):
    """The least time (ms) for work of ``flops`` moving ``nbytes``, at
    ``peak_flops`` (fp32 on the CUDA cores unless given)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                gflop=flops / 1e9, mbytes=nbytes / 1e6)


def _attention_bound(nbytes, flops):
    """_bound of an fp32 attention kernel (K2-K5): its products at the
    faster of the CUDA cores' fp32 (67 TFLOP/s) and split TF32 on the
    tensor cores (495 / 3 TFLOP/s, fp32-accurate), named in ``ops_peak``;
    ``bound_ms_cuda_cores`` keeps the bound at the CUDA cores' rate."""
    peak, ops = max((PEAK_FP32_FLOPS, "fp32 CUDA cores 67 TFLOP/s"),
                    (PEAK_TF32_FLOPS / 3, "split TF32 495/3 TFLOP/s"))
    return dict(_bound(nbytes, flops, peak), ops_peak=ops,
                bound_ms_cuda_cores=_bound(nbytes, flops)["bound_ms"])


# ResNet-50 v1.5's 3x3 stride-1 pad-1 convs (the ones K1 takes behind
# FLAGS_conv_pallas): (H = W, C = O, convs per step) — the 3x3 conv of
# each bottleneck block but the first of stages 2-4 (stride 2)
RESNET_K1_SHAPES = ((56, 64, 3), (28, 128, 3), (14, 256, 5), (7, 512, 2))
RN_BATCH = 256                # bench.py bench_resnet's batch
RN_SIZE = 224
LN_SHAPE = (BT * S, H * D)    # K6: BERT-base's training hidden state


def k1_work(n, hw, c, o, esz):
    """(bytes, flops) of one K1 launch (``costmodel.kernel_work``): x
    read once, w read once, out written once (scale/shift absent on the
    op path), 2·M·K·N flops."""
    flops, nbytes = kernel_work("K1", n=n, h=hw, w=hw, c=c, o=o, esz=esz)
    return nbytes, flops


def k1_bound(n, hw, c, esz=2):
    """K1's least time at one shape: bf16 against the tensor cores' peak
    (the work the card could do there), fp32 against the CUDA cores'."""
    peak = PEAK_BF16_FLOPS if esz == 2 else PEAK_FP32_FLOPS
    return _bound(*k1_work(n, hw, c, c, esz), peak)


def k6_bound(M, Dm, esz=4):
    """K6's least time (``costmodel.kernel_work``): x read and y written
    once, scale and bias read once; mean, centre, square, variance,
    scale and shift ~8 flops per entry."""
    flops, nbytes = kernel_work("K6", m=M, d=Dm, esz=esz)
    return _bound(nbytes, flops)


def phase_bounds():
    """Bounds of K1 and K6 at the shapes of their paths, from their work
    (no device work).  K1 (conv_pallas.py:80) runs on the 13 3x3 stride-1
    convs of ResNet-50 training (bench_resnet: batch 256, 224 x 224, pure
    bf16), forward only; K6 (pallas_ops.py:726) backs fused_layer_norm,
    at BERT-base's training hidden state x2d [32 * 128, 768] fp32."""
    rows, step_ms = [], 0.0
    for hw, c, n in RESNET_K1_SHAPES:
        b = k1_bound(RN_BATCH, hw, c)
        rows.append(dict(hw=hw, C=c, O=c, convs=n, **b))
        step_ms += n * b["bound_ms"]
    emit(phase="bounds", kernel="K1 conv3x3", dtype="bfloat16",
         batch=RN_BATCH, convs=rows, bound_ms_per_step=step_ms,
         bound_by=rows[0]["bound_by"])
    k6 = k6_bound(*LN_SHAPE)
    emit(phase="bounds", kernel="K6 layer_norm", dtype="float32",
         x2d=list(LN_SHAPE), **k6)
    return dict(k1_rows=rows, k1_step_ms=step_ms, k6=k6)


def _bwd_check(name, t, dt, causal, zero_do):
    """K3, K4 and K5 (with a bias) against dq_reference, dkv_reference
    and dbias_reference in one case: (ok, report); each output's entry
    in report["errors"] carries its own ``ok``."""
    args, masked = _bwd_args(t, dt, causal, zero_do)
    before = _launches()
    got = dict(dq=flash_attention_bwd_dq(*args))
    got["dk"], got["dv"] = flash_attention_bwd_dkv(*args)
    want = dict(dq=dq_reference(*args))
    want["dk"], want["dv"] = dkv_reference(*args)
    if args[3] is not None:
        got["dbias"] = flash_attention_bwd_dbias(*args)
        want["dbias"] = dbias_reference(*args)
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in _launches().items()
                if n.startswith("flash_attention_bwd")}
    finite = all(bool(torch.isfinite(g.float()).all())
                 for g in got.values())
    # each wrapper must have launched its kernel once (K5 with a bias)
    rep, ok = {}, finite and launched == {
        "flash_attention_bwd_dq": 1, "flash_attention_bwd_dkv": 1,
        "flash_attention_bwd_dbias": int(args[3] is not None)}
    if dt == torch.float32:
        bounds = _masked_bounds(args, masked)
        for n in got:
            diff = (got[n].float() - want[n].float()).abs()
            excess = (diff - BWD_FP32_ATOL - bounds[n]).max().item()
            if n in ("dq", "dbias"):
                rows = diff.amax(-1)
                real = rows[~masked]
                rep[n] = dict(
                    max_abs_err=real.max().item() if real.numel() else 0.0,
                    masked_rows_max_abs_err=rows[masked].max().item()
                    if masked.any() else 0.0)
            else:
                rep[n] = dict(max_abs_err=diff.max().item(),
                              masked_rows_bound_max=bounds[n].max().item())
            rep[n]["ok"] = excess <= 0
        tol = ("atol %g; fully masked rows and their share of dk/dv add "
               "%g x |p| propagated" % (BWD_FP32_ATOL, MASKED_P_REL))
    else:
        for n in got:
            rep[n] = dict(
                max_abs_err=(got[n].float() - want[n].float()).abs().max()
                .item(),
                ok=bool(torch.allclose(got[n].float(), want[n].float(),
                                       atol=BF16_TOL, rtol=BF16_TOL)))
        tol = ("atol/rtol %g vs the plain version in bf16 (same rounding "
               "points)" % BF16_TOL)
    ok = ok and all(r["ok"] for r in rep.values())
    return ok, dict(
        case=name, dtype=str(dt), shape=list(args[0].shape),
        kv=args[1].shape[1], causal=causal,
        bias=None if args[3] is None else list(args[3].shape),
        dO_zero_on_masked_rows=zero_do, masked_rows=int(masked.sum()),
        launched=launched, errors=rep, tolerance=tol, finite=finite, ok=ok)


def _bwd_planted_fault_check(cases):
    """The backward built with BWD_PLANTED_FAULT must fail _bwd_check on
    dq and on dbias in every one of ``cases`` (each with a bias)."""
    real = _kernels.load
    name, defines = BWD_PLANTED_FAULT
    _kernels.load = lambda n, d=(): real(n, defines if n == name else d)
    try:
        caught = {}
        for c in cases:
            errors = _bwd_check(*c)[1]["errors"]
            caught[c[0]] = {n: not errors[n]["ok"] for n in ("dq", "dbias")}
    finally:
        _kernels.load = real
    ok = all(all(c.values()) for c in caught.values())
    emit(phase="kernel_bwd_planted_fault", fault="ds k: K's rows 2t and "
         "2t+1 swapped; dbias: the columns of each stored pair swapped "
         "(%s)" % defines[0], caught=caught, ok=ok)
    if not ok:
        raise SystemExit("the backward check passed a kernel with a fault "
                         "planted in ds k or in the dbias store: %s"
                         % caught)


def _bwd_repeat_check(t):
    """Two launches of K3, and two of K5, on the same inputs (the BERT
    training case in fp32) give the same bits."""
    args, _ = _bwd_args(t, torch.float32, False, True)
    same = {}
    for name, fn in (("dq", flash_attention_bwd_dq),
                     ("dbias", flash_attention_bwd_dbias)):
        first, second = fn(*args), fn(*args)
        same[name] = bool(torch.equal(first, second))
    emit(phase="kernel_bwd_repeat", case="bert_train_fp32",
         bit_identical=same, ok=all(same.values()))
    if not all(same.values()):
        raise SystemExit("K3/K5 gave other bits on a second launch: %s"
                         % same)


def phase_kernel_bwd():
    """K3, K4 and K5 against their plain versions on the card (and the
    planted faults and repeat launches of K3 and K5), then their times at
    the BERT-base training shape (and K2's, with the LSE)."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def rand(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def qkvd(BH, S_q, S_kv, d=D, bias=None):
        return dict(q=rand(BH, S_q, d), k=rand(BH, S_kv, d),
                    v=rand(BH, S_kv, d), dO=rand(BH, S_q, d), bias=bias)

    lengths = torch.randint(S // 2, S + 1, (BT,), generator=gen,
                            device=dev).tolist()
    BH = BT * H
    train = qkvd(BH, S, S, bias=_padding_bias(lengths, torch.float32, dev))
    cases = [
        ("bert_train_fp32", train, torch.float32, False, True),
        ("bert_padding_rows_fp32", train, torch.float32, False, False),
        ("bert_train_bf16", train, torch.bfloat16, False, True),
        ("causal_fp32", qkvd(96, S, S), torch.float32, True, False),
        ("ragged_cross_77x200_fp32",
         qkvd(16, 77, 200, bias=torch.where(rand(16, 77, 200) < -1.5, -1e4,
                                            0.0)),
         torch.float32, False, False),
        ("d128_bias_fp32", qkvd(48, S, S, 128, bias=train["bias"][:4]),
         torch.float32, False, True),
        ("d128_causal_bf16", qkvd(48, S, S, 128), torch.bfloat16, True,
         False),
        # fragment and tile edges, and biases read through other strides,
        # as phase_kernel's
        ("1x1_fp32", qkvd(4, 1, 1), torch.float32, False, False),
        ("9x13_head_broadcast_bias_fp32",
         qkvd(24, 9, 13, bias=rand(2, 1, 9, 13)), torch.float32, False,
         False),
        ("130x130_causal_fp32", qkvd(8, 130, 130), torch.float32, True,
         False),
        ("130x130_bias_bf16", qkvd(8, 130, 130, bias=rand(8, 130, 130)),
         torch.bfloat16, False, False),
        ("transposed_bias_77x200_fp32",
         qkvd(16, 77, 200, bias=rand(16, 200, 77).transpose(1, 2)),
         torch.float32, False, False),
        ("transposed_bias_77x200_bf16",
         qkvd(16, 77, 200, bias=rand(16, 200, 77).transpose(1, 2)),
         torch.bfloat16, False, False),
        ("sliced_bias_77x198_fp32",
         qkvd(16, 77, 198, bias=rand(16, 77, 208)[:, :, :198]),
         torch.float32, False, False),
        ("batch_broadcast_bias_d128_fp32",
         qkvd(4 * H, S, S, 128, bias=rand(1, H, S, S).expand(4, H, S, S)),
         torch.float32, False, False),
    ]
    kernels = (("dq", flash_attention_bwd_dq),
               ("dkv", flash_attention_bwd_dkv),
               ("dbias", flash_attention_bwd_dbias))
    errs = {}
    for case in cases:
        ok, rep = _bwd_check(*case)
        emit(phase="kernel_bwd_check", **rep)
        if not ok:
            raise SystemExit("flash-attention backward kernels disagree "
                             "with their plain versions in case %s"
                             % case[0])
        errs[case[0]] = rep["errors"]
    _bwd_planted_fault_check([c for c in cases
                              if c[0] in ("bert_train_fp32",
                                          "bert_train_bf16")])
    _bwd_repeat_check(train)

    # times at the training shape (fp32, [32,1,128,128] padding mask)
    args, _ = _bwd_args(train, torch.float32, False, True)
    q, k, v, b, scale, dO, lse, delta, _c = args
    for name, fn in kernels:
        _check_no_host_sync(lambda fn=fn: fn(*args))
    shape = dict(bh=BH, sq=S, sk=S, d=D, esz=q.element_size(),
                 bias_bytes=stored_bytes(b))
    q4, k4, v4 = (t.detach().view(BT, H, S, D).requires_grad_()
                  for t in (q, k, v))
    mask = b.detach().clone().requires_grad_()
    g4 = dO.view(BT, H, S, D)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    o_qkv = sdpa(q4, k4, v4, attn_mask=b, scale=scale)
    o_all = sdpa(q4, k4, v4, attn_mask=mask, scale=scale)
    lib_qkv = cuda_time_ms(lambda: torch.autograd.grad(
        o_qkv, (q4, k4, v4), g4, retain_graph=True))
    lib_all = cuda_time_ms(lambda: torch.autograd.grad(
        o_all, (q4, k4, v4, mask), g4, retain_graph=True))
    # which kernels the yardstick runs (its backward computes dq, dk and
    # dv in one pass)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(sdpa(q4, k4, v4, attn_mask=b, scale=scale),
                            (q4, k4, v4), g4)
        torch.cuda.synchronize()
    emit(phase="library_kernels", call="scaled_dot_product_attention "
         "forward + backward, fp32, [32,1,128,128] mask",
         kernels=sorted({e.key for e in prof.key_averages()
                         if "fmha" in e.key or "ttention" in e.key}))
    plain = dict(dq=dq_reference, dkv=dkv_reference, dbias=dbias_reference)
    # (bytes, flops) of each launch (costmodel.kernel_work)
    work = {name: kernel_work(k, **shape)[::-1] for name, k in
            (("dq", "K3"), ("dkv", "K4"), ("dbias", "K5"))}
    out = {}
    for name, fn in kernels:
        timing = dict(ms=cuda_time_ms(lambda fn=fn: fn(*args)),
                      plain_ms=cuda_time_ms(
                          lambda p=plain[name]: p(*args)),
                      library_ms=lib_all if name == "dbias" else lib_qkv,
                      **_attention_bound(*work[name]))
        emit(phase="kernel_bwd_time", kernel=name, shape=[BH, S, D],
             bias=list(b.shape), dtype="float32",
             library="scaled_dot_product_attention backward (dq, dk, dv%s)"
             % (", dmask" if name == "dbias" else ""),
             roofline_share=timing["bound_ms"] / timing["ms"], **timing)
        rep = errs["bert_train_fp32"]
        err = max(rep["dk"]["max_abs_err"], rep["dv"]["max_abs_err"]) \
            if name == "dkv" else rep[name]["max_abs_err"]
        out[name] = dict(max_abs_err=err, **timing)
    # K2 with the LSE, as training launches it
    k2 = dict(ms=cuda_time_ms(lambda: flash_attention(
        q, k, v, b, scale, with_lse=True)),
        plain_ms=cuda_time_ms(lambda: attention_reference(
            q, k, v, b, scale, with_lse=True)),
        library_ms=cuda_time_ms(lambda: sdpa(q4.detach(), k4.detach(),
                                             v4.detach(), attn_mask=b,
                                             scale=scale)),
        **_attention_bound(*kernel_work("K2", lse=True, **shape)[::-1]))
    emit(phase="kernel_time", kernel="flash_attention_fwd with_lse",
         shape=[BH, S, D], bias=list(b.shape), dtype="float32",
         roofline_share=k2["bound_ms"] / k2["ms"], **k2)
    out["fwd_with_lse"] = k2
    return out


# Transformer NMT's attention (bench_nmt: batch 32, 8 heads, S = 256,
# D = 64): the decoder's causal self-attention and the encoder's and the
# cross-attention's [B,1,1,S] pad bias, which fused_attention hands the
# kernels as a [B,1,S,S] view with a stride-0 query dim
NB, NH, NS = 32, 8, 256


def _pad_bias_view(lengths, dtype, dev):
    """[B,1,1,S] additive key-padding bias as _pad_bias builds it (0 on a
    real key, -1e4 on a padding key), in ``dtype``, expanded to [B,1,S,S]
    as the fused_attention op expands it."""
    m = (torch.arange(NS, device=dev)[None, :] <
         torch.as_tensor(lengths, device=dev)[:, None]).float()
    bias = ((m - 1.0) * 1e4).reshape(len(lengths), 1, 1, NS).to(dtype)
    return bias.expand(len(lengths), 1, NS, NS)


def phase_kernel_nmt():
    """K2, K3 and K4 at Transformer NMT's shape (BH = 256, S = 256,
    D = 64), causal and with the stride-0 pad-bias view, in float32 (the
    dtype the program's attention runs in under pure bf16: every q/k/v
    projection adds its float32 bias) and in bf16, against their plain
    versions at the unchanged tolerances; then their times beside the
    plain versions, SDPA and the bounds (the causal half of the work
    counted).  The pad-bias cases also run K5 in the check; the NMT path
    launches none."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)

    def rand(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    BH = NB * NH
    lengths = torch.randint(NS // 2, NS + 1, (NB,), generator=gen,
                            device=dev).tolist()
    t = dict(q=rand(BH, NS, D), k=rand(BH, NS, D), v=rand(BH, NS, D),
             dO=rand(BH, NS, D))
    cases = {}
    for dt in (torch.float32, torch.bfloat16):
        tag = "fp32" if dt == torch.float32 else "bf16"
        cases["causal_" + tag] = (dict(t, bias=None), dt, True)
        cases["pad_bias_" + tag] = (
            dict(t, bias=_pad_bias_view(lengths, dt, dev)), dt, False)
    errs = {}
    for name, (tt, dt, causal) in cases.items():
        ok, rep = _k2_check("nmt_" + name, tt, dt, causal)
        emit(phase="kernel_nmt_check", kernel="K2", ok=ok, **rep)
        if not ok:
            raise SystemExit("flash_attention disagrees with its plain "
                             "version at the NMT shape, case %s" % name)
        bok, brep = _bwd_check("nmt_" + name, tt, dt, causal, True)
        emit(phase="kernel_nmt_check", kernel="K3/K4/K5", **brep)
        if not bok:
            raise SystemExit("flash-attention backward kernels disagree "
                             "with their plain versions at the NMT shape, "
                             "case %s" % name)
        errs[name] = dict(fwd=rep["max_abs_err"], **{
            n: e["max_abs_err"] for n, e in brep["errors"].items()})

    sdpa = torch.nn.functional.scaled_dot_product_attention
    timings = {}
    for name, (tt, dt, causal) in cases.items():
        args, _ = _bwd_args(tt, dt, causal, True)
        q, k, v, b, scale, dO, lse, delta, _c = args
        esz = q.element_size()
        # the pad bias is read as a stride-0 view: [NB, NS] entries
        shape = dict(bh=BH, sq=NS, sk=NS, d=D, esz=esz, causal=causal,
                     bias_bytes=0 if b is None else NB * NS * esz)
        peak_bound = (_attention_bound if dt == torch.float32 else
                      lambda nb, fl: _bound(nb, fl, PEAK_BF16_FLOPS))
        q4, k4, v4 = (x.detach().view(NB, NH, NS, D).requires_grad_()
                      for x in (q, k, v))
        g4 = dO.view(NB, NH, NS, D)
        kw = dict(is_causal=True) if causal else dict(attn_mask=b)
        o4 = sdpa(q4, k4, v4, scale=scale, **kw)
        lib_bwd = cuda_time_ms(lambda: torch.autograd.grad(
            o4, (q4, k4, v4), g4, retain_graph=True))
        # (bytes, flops) of each launch (costmodel.kernel_work; K2 with
        # the LSE, K3 and K4 read it and delta)
        work = dict(fwd=kernel_work("K2", lse=True, **shape)[::-1],
                    dq=kernel_work("K3", **shape)[::-1],
                    dkv=kernel_work("K4", **shape)[::-1])
        fns = dict(
            fwd=(lambda: flash_attention(q, k, v, b, scale, causal=causal,
                                         with_lse=True),
                 lambda: attention_reference(q, k, v, b, scale,
                                             causal=causal, with_lse=True),
                 cuda_time_ms(lambda: sdpa(q4.detach(), k4.detach(),
                                           v4.detach(), scale=scale,
                                           **kw))),
            dq=(lambda: flash_attention_bwd_dq(*args),
                lambda: dq_reference(*args), lib_bwd),
            dkv=(lambda: flash_attention_bwd_dkv(*args),
                 lambda: dkv_reference(*args), lib_bwd))
        for kname, (fn, plain, lib) in fns.items():
            timing = dict(ms=cuda_time_ms(fn), plain_ms=cuda_time_ms(plain),
                          library_ms=lib, **peak_bound(*work[kname]))
            emit(phase="kernel_nmt_time", kernel=kname, case=name,
                 shape=[BH, NS, D], dtype=str(dt), causal=causal,
                 bias=None if b is None else [NB, 1, 1, NS],
                 library="scaled_dot_product_attention %s"
                 % ("forward" if kname == "fwd" else
                    "backward (dq, dk, dv)"),
                 roofline_share=timing["bound_ms"] / timing["ms"], **timing)
            timings.setdefault(kname, {})[name] = timing
    return dict(errors=errs, timings=timings)


class _GradsOnly:
    """An optimizer stand-in for build_pretrain: the backward only, so a
    comparison run reads gradients and leaves the weights as they are."""

    def minimize(self, loss):
        return [], fluid.append_backward(loss)


def _build_pretrain(cfg, optimizer=None):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = bert.build_pretrain(cfg, lr=TRAIN_LR, max_pred_per_seq=MAX_PRED,
                                  optimizer=optimizer)
    return main, startup, out


def _train_feed(cfg, batch, seed):
    """Synthetic pretraining batch: true lengths S/2..S, MAX_PRED distinct
    masked positions per sequence (flat indices into [batch * S]), random
    MLM and NSP labels."""
    rng = np.random.RandomState(seed)
    S_ = cfg.max_seq_len
    lengths = rng.randint(S_ // 2, S_ + 1, batch)
    pos = np.stack([rng.choice(n, MAX_PRED, replace=False) + i * S_
                    for i, n in enumerate(lengths)])
    return {
        "src_ids": rng.randint(0, cfg.vocab_size, (batch, S_, 1)),
        "pos_ids": np.tile(np.arange(S_).reshape(1, S_, 1), (batch, 1, 1)),
        "sent_ids": rng.randint(0, 2, (batch, S_, 1)),
        "input_mask": (np.arange(S_)[None, :, None] <
                       lengths[:, None, None]).astype(np.float32),
        "mask_pos": pos.reshape(-1, 1).astype(np.int32),
        "mask_label": rng.randint(0, cfg.vocab_size, (batch * MAX_PRED, 1)),
        "nsp_label": rng.randint(0, 2, (batch, 1)),
    }


def _head(feed, n):
    """The first n sequences of a pretraining batch."""
    out = {k: v[:n] for k, v in feed.items()}
    out["mask_pos"] = feed["mask_pos"][:n * MAX_PRED]
    out["mask_label"] = feed["mask_label"][:n * MAX_PRED]
    return out


def _reset_launches():
    for fn in KERNELS.values():
        fn.launches = 0
    conv3x3_bn_relu.launches_by_variant = dict.fromkeys(K1_VARIANTS, 0)
    conv3x3_bn_relu.input_copies = 0


def _launches():
    return {n: fn.launches for n, fn in KERNELS.items()}


def _grads(exe, prog, out, names, feed, scope):
    loss, *gs = exe.run(prog, feed=feed, fetch_list=[out["loss"]] +
                        [prog._grad_name_map[n] for n in names], scope=scope)
    return float(loss[0]), gs


def _compare(a, b, names):
    """[loss relative diff, {param: max|Δg| / max|g|}] of two runs."""
    (la, ga), (lb, gb) = a, b
    return (abs(la - lb) / abs(lb),
            {n: float(np.abs(x - y).max() / np.abs(y).max())
             for n, x, y in zip(names, ga, gb)})


def phase_train():
    """BERT-base pretraining (12 x 768, 12 heads, S=128, vocab 30522,
    batch 32, 20 masked positions, fp32, Adam lr 1e-4, hidden dropout
    0.1, attention dropout 0) through Executor on the card: 2 warm-up and
    4 timed steps on one batch, then the checks against the composition
    path and the port's CPU path."""
    cfg = bert.base_config(attn_dropout=0.0)
    main, startup, out = _build_pretrain(cfg)
    ops = [op.type for op in main.global_block().ops]
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    params = main.global_block().all_parameters()
    n_params = sum(scope.find_var(p.name).numel() for p in params)
    emit(phase="train_startup", seconds=time.perf_counter() - t0,
         parameters=int(n_params), parameter_tensors=len(params),
         ops=len(ops), grad_ops=sum(t.endswith("_grad") for t in ops),
         adam_ops=ops.count("adam"),
         fused_attention_grad_ops=ops.count("fused_attention_grad"))
    feed = _train_feed(cfg, BT, SEED)
    init = _host_params(main, scope)        # dp_train starts from these
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_mb = torch.cuda.memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    # the main path's run: counts go to 0 here and are read after it
    _reset_launches()
    got, step_ms = _train_steps(exe, main, [feed], [out["loss"]], scope)
    launches = _launches()
    final = _host_params(main, scope)
    losses = [float(g[0].item()) for g in got]
    steps = len(got)
    per_step = {n: c / steps for n, c in launches.items()}
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    emit(phase="train", steps=steps, losses=losses, ms_per_step=step_ms,
         sequences_per_s=BT / step_ms * 1e3,
         tokens_per_s=BT * cfg.max_seq_len / step_ms * 1e3,
         peak_device_mb=peak_mb, allocated_before_mb=base_mb,
         launches=launches, launches_per_step=per_step)
    L = cfg.num_layers
    checks = {
        "losses_finite": bool(np.isfinite(losses).all()),
        "last_loss_below_first": losses[-1] < losses[0],
        "k2_k3_k4_12_per_step": all(launches[n] == L * steps for n in (
            "flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv")),
        "k5_0": launches["flash_attention_bwd_dbias"] == 0,
    }

    _profile_step("train_profile", exe, main, feed, [out["loss"]], scope)

    # fused vs composition on the card, and the card vs the port's CPU
    # path, from the trained weights.  Dropout is off in these programs:
    # masks come from per-device Philox streams, and the two attention
    # routes number their random ops differently, so only a dropout-free
    # step can agree to rounding.
    names = ["fc_0.w_0", "fc_%d.w_0" % (6 * L - 1), "word_embedding"]
    gcfg = dict(hidden_dropout=0.0, attn_dropout=0.0)
    fused, _, fout = _build_pretrain(bert.base_config(**gcfg), _GradsOnly())
    comp, _, cout = _build_pretrain(
        bert.base_config(use_fused_attention=False, **gcfg), _GradsOnly())
    assert all(fused.global_block().has_var(n) for n in names)
    wscope = fluid.Scope()
    for p in params:
        wscope.set_var(p.name, scope.find_var(p.name))
    _reset_launches()
    card = _grads(exe, fused, fout, names, feed, wscope)
    card_comp = _grads(exe, comp, cout, names, feed, wscope)
    two = _head(feed, 2)
    card2 = _grads(exe, fused, fout, names, two, wscope)
    cpu_scope = fluid.Scope()
    for p in params:
        cpu_scope.set_var(p.name, scope.find_var(p.name).cpu())
    t2 = time.perf_counter()
    cpu2 = _grads(fluid.Executor(fluid.CPUPlace()), fused, fout, names, two,
                  cpu_scope)
    cpu_s = time.perf_counter() - t2
    comp_loss, comp_g = _compare(card, card_comp, names)
    cpu_loss, cpu_g = _compare(card2, cpu2, names)
    checks["fused_matches_composition"] = \
        comp_loss <= TRAIN_LOSS_RTOL and max(comp_g.values()) <= TRAIN_GRAD_TOL
    checks["card_matches_cpu_path"] = \
        cpu_loss <= TRAIN_LOSS_RTOL and max(cpu_g.values()) <= TRAIN_GRAD_TOL
    emit(phase="train_check",
         tolerance="loss rel %g, grads max|diff|/max|grad| %g"
         % (TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL),
         loss_card=card[0], loss_card_composition=card_comp[0],
         fused_vs_composition=dict(loss_rel=comp_loss, grads=comp_g),
         loss_card_b2=card2[0], loss_cpu_b2=cpu2[0], cpu_seconds=cpu_s,
         card_vs_cpu=dict(loss_rel=cpu_loss, grads=cpu_g), checks=checks)
    _fail_unless("train", checks)
    return dict(launches=launches, ms_per_step=step_ms, init=init,
                final=final, losses=losses, feed=feed, peak_mb=peak_mb,
                base_mb=base_mb)


def _bias_program(fused, optimizer=None, B_=8):
    """One attention layer at BERT-base head shape whose additive bias is
    a trainable [1, H, S, S] parameter: x -> q, k, v -> attention(+bias)
    -> output projection -> mean.  ``fused`` picks fused_attention (the
    flash kernels) or the matmul/softmax/matmul composition."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    hid = H * D
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [S, hid])
        q, k, v = (fluid.layers.transpose(fluid.layers.reshape(
            fluid.layers.fc(x, hid, num_flatten_dims=2), [0, S, H, D]),
            [0, 2, 1, 3]) for _ in range(3))
        bias = fluid.layers.create_parameter(
            [1, H, S, S], "float32", name="attn_bias",
            default_initializer=fluid.initializer.Normal(0.0, 0.5))
        if fused:
            ctx = fluid.layers.fused_attention(q, k, v, bias,
                                               scale=1.0 / math.sqrt(D))
        else:
            s = fluid.layers.matmul(q, k, transpose_y=True,
                                    alpha=1.0 / math.sqrt(D))
            ctx = fluid.layers.matmul(fluid.layers.softmax(s + bias), v)
        ctx = fluid.layers.reshape(fluid.layers.transpose(ctx, [0, 2, 1, 3]),
                                   [0, S, hid])
        loss = fluid.layers.mean(fluid.layers.fc(ctx, 1, num_flatten_dims=2,
                                                 act="tanh"))
        if optimizer is None:
            fluid.optimizer.AdamOptimizer(learning_rate=1e-3).minimize(loss)
        else:
            optimizer.minimize(loss)
    return main, startup, loss


def phase_train_bias(B_=8, steps=3):
    """The path that reaches K5: a trainable attention bias.  Checks its
    gradient against the composition path from the same weights, then
    trains a few steps and counts the launches."""
    main, startup, loss = _bias_program(True)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    x = np.random.RandomState(SEED).randn(B_, S, H * D).astype(np.float32)
    grads = {}
    for fused in (True, False):
        prog, _, gl = _bias_program(fused, _GradsOnly())
        grads[fused] = exe.run(prog, feed={"x": x},
                               fetch_list=[gl, "attn_bias@GRAD"],
                               scope=scope)
    gf, gc = grads[True][1], grads[False][1]
    bias_err = float(np.abs(gf - gc).max() / np.abs(gc).max())
    _reset_launches()
    losses = [float(exe.run(main, feed={"x": x}, fetch_list=[loss],
                            scope=scope)[0][0]) for _ in range(steps)]
    launches = _launches()
    checks = {
        "k5_once_per_step": launches["flash_attention_bwd_dbias"] == steps,
        "k2_k3_k4_once_per_step": all(launches[n] == steps for n in (
            "flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv")),
        "losses_finite": bool(np.isfinite(losses).all()),
        "bias_grad_matches_composition": bias_err <= TRAIN_GRAD_TOL,
    }
    emit(phase="train_bias", batch=B_, bias_shape=[1, H, S, S],
         losses=losses, launches=launches,
         bias_grad_shape=list(gf.shape),
         bias_grad_max_err_rel=bias_err, tolerance="max|diff|/max|grad| %g"
         % TRAIN_GRAD_TOL, checks=checks)
    _fail_unless("train_bias", checks)
    return launches


def phase_train_attn_dropout(batch=8, steps=2):
    """BERT's default attn_dropout=0.1 at a cut depth (2 layers): the
    attention-dropout composition route, which launches no flash
    kernel."""
    cfg = bert.base_config(num_layers=2)
    main, startup, out = _build_pretrain(cfg)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    feed = _train_feed(cfg, batch, SEED + 2)
    _reset_launches()
    losses = [float(exe.run(main, feed=feed, fetch_list=[out["loss"]],
                            scope=scope)[0][0]) for _ in range(steps)]
    launches = _launches()
    ok = bool(np.isfinite(losses).all()) and not any(launches.values())
    emit(phase="train_attn_dropout", layers=2, batch=batch,
         attn_dropout=cfg.attn_dropout, losses=losses, launches=launches,
         ok=ok)
    if not ok:
        raise SystemExit("attention-dropout route: non-finite loss or a "
                         "flash kernel launched: %s %s" % (losses, launches))


# ---------------------------------------------------------------------------
# K1 (3x3 conv) and K6 (row layer norm); ResNet-50 training
# ---------------------------------------------------------------------------

K1_FP32_BATCH = 32
K1_FP32_TOL = 1e-4            # |kernel - plain| / max|plain|, fp32
K1_BF16_TOL = 2e-2            # ... bf16 (the same float32 sum, one rounding)
K6_FP32_TOL = 1e-5            # K6, fp32
K6_BF16_TOL = 1e-2            # K6, bf16
# ResNet-50 checks, from the startup weights.  Each bound is the larger
# of a fixed tolerance and twice how far a route that runs no K1 either
# lies from the reference.  In pure bf16 at batch 256 rounding alone
# moves most gradients by as much as their size: the card's two library
# routes (cuDNN, and unfold x matmul) give gradients at cosine ~0.5,
# apart by ~100% of the largest entry of most conv and batch-norm
# gradients, and by ~10% of the classifier's.  So the bf16 comparison
# holds the loss and the gradients RN_GRADS only.  The sharp comparison
# is float32 at batch 2: there the loss and the classifier's weight
# gradient agree within 1e-6 and 1e-4 between routes, and all 161
# gradients together are held in relative L2 norm (~2% between routes).
RN_LOSS_RTOL = 1e-2           # step-1 loss, K1 route vs cuDNN route (bf16)
RN_GRAD_TOL = 5e-2            # RN_GRADS, same comparison
RN_CPU_LOSS_RTOL = 1e-4       # step-1 loss, card vs CPU path (fp32, b2)
RN_CPU_GRAD_TOL = 1e-3        # RN_GRADS and all gradients in L2, same
LN_PATH_TOL = 1e-5            # fused_layer_norm vs layer_norm op grads


def _rel(a, b):
    """max |a - b| / max |b| over two tensors or arrays, in float32."""
    a = torch.as_tensor(a).float()
    b = torch.as_tensor(b).float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _ptxas_report(source, kernel):
    """ptxas's lines (registers, barriers, stack, spills) for each
    instantiation of ``kernel`` in the build log of ``source``."""
    report, name = {}, None
    for ln in _kernels.build_log(source).splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if kernel in ln else None
            if name is not None:
                report[name] = []
        elif name is not None and ("registers" in ln or "spill" in ln):
            report[name].append(ln.replace("ptxas info    :", "").strip())
    return report


def phase_kernel_conv(bounds):
    """K1 against conv3x3_bn_relu_reference on the card at the four
    ResNet-50 shapes (bf16 at batch 256, fp32 at batch 32), with and
    without the epilogue, one launch of the planned variant asserted per
    case (wgmma in bf16, fp32 in fp32); ptxas's report for the wgmma
    kernel, which must not spill; then K1's time per shape in bf16 at
    batch 256 without epilogue (the op path's call) beside the plain
    version, cuDNN, the bound, and the NCHW -> NHWC copy the wrapper
    makes when its input is not channels_last."""
    ptxas = _ptxas_report("conv3x3_bn_relu", "conv3x3_wgmma_kernel")
    spills = {n: [ln for ln in lines if "spill" in ln and
                  not ln.startswith("0 bytes stack frame, 0 bytes spill "
                                    "stores, 0 bytes spill loads")]
              for n, lines in ptxas.items()}
    emit(phase="kernel_conv_ptxas", kernel="conv3x3_wgmma_kernel",
         report=ptxas, ok=bool(ptxas) and not any(spills.values()))
    if not ptxas or any(spills.values()):
        raise SystemExit("the wgmma K1 kernel is missing from the build log "
                         "or spills: %s" % spills)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    errs = []
    for hw, c, _ in RESNET_K1_SHAPES:
        for dt, n in ((torch.bfloat16, RN_BATCH),
                      (torch.float32, K1_FP32_BATCH)):
            x = torch.randn(n, hw, hw, c, device=dev, generator=gen).to(dt)
            w = (torch.randn(3, 3, c, c, device=dev, generator=gen) *
                 (2.0 / (9 * c)) ** 0.5).to(dt)
            sc = torch.rand(c, device=dev, generator=gen) + 0.5
            sh = torch.randn(c, device=dev, generator=gen)
            plan = k1_plan(n, hw, hw, c, c, dt)
            want_variant = "wgmma" if dt == torch.bfloat16 else "fp32"
            for epi in (False, True):
                args = (x, w, sc, sh) if epi else (x, w, None, None)
                before = conv3x3_bn_relu.launches
                by_variant = dict(conv3x3_bn_relu.launches_by_variant)
                got = conv3x3_bn_relu(*args, relu=epi)
                torch.cuda.synchronize()
                launched = conv3x3_bn_relu.launches - before
                variants = {k: v - by_variant[k] for k, v in
                            conv3x3_bn_relu.launches_by_variant.items()
                            if v != by_variant[k]}
                want = conv3x3_bn_relu_reference(*args, relu=epi)
                err = _rel(got, want)
                tol = K1_FP32_TOL if dt == torch.float32 else K1_BF16_TOL
                finite = bool(torch.isfinite(got.float()).all())
                ok = launched == 1 and variants == {want_variant: 1} and \
                    plan["variant"] == want_variant and err <= tol and \
                    finite and got.dtype == dt
                emit(phase="kernel_conv_check", shape=[n, hw, hw, c, c],
                     dtype=str(dt), epilogue=epi, launched=launched,
                     variant=variants, plan=plan, max_err_rel=err,
                     tolerance="max|diff| <= %g max|plain|" % tol,
                     finite=finite, ok=ok)
                if not ok:
                    raise SystemExit("K1 disagrees with its plain version "
                                     "or took another variant at %s %s "
                                     "epilogue=%s" % ([n, hw, hw, c], dt, epi))
                if dt == torch.bfloat16 and not epi:
                    errs.append(err * want.float().abs().max().item())
                del got, want
    times, step = [], dict(ms=0.0, plain_ms=0.0, library_ms=0.0,
                           input_copy_ms=0.0)
    for (hw, c, count), b in zip(RESNET_K1_SHAPES, bounds["k1_rows"]):
        x = torch.randn(RN_BATCH, hw, hw, c, device=dev,
                        generator=gen).to(torch.bfloat16)
        # the weights in the kernel's K-major [O, 3, 3, C] storage, passed
        # as their HWIO view: the wrapper makes no copy, so the time is
        # the kernel's (the op path's OIHW weights take one small copy)
        wk = (torch.randn(c, 3, 3, c, device=dev, generator=gen) * 0.05).to(
            torch.bfloat16)
        w = wk.permute(1, 2, 3, 0)
        if hw == 56:
            _check_no_host_sync(lambda: conv3x3_bn_relu(x, w, relu=False))
        # cuDNN on the same data: NCHW views of NHWC storage (channels_last)
        xl = x.permute(0, 3, 1, 2)
        wl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        # the copy conv3x3_bn_relu makes of an NCHW-contiguous input
        xn = xl.contiguous()
        # the plain version's F.unfold launches one im2col kernel per
        # image, 262 launches a call at batch 256: three calls fill the
        # launch queue, so it is timed two at a time
        t = dict(ms=cuda_time_ms(lambda: conv3x3_bn_relu(x, w, relu=False)),
                 plain_ms=cuda_time_ms(lambda: conv3x3_bn_relu_reference(
                     x, w, relu=False), iters=2, warmup=2),
                 library_ms=cuda_time_ms(lambda: torch.nn.functional.conv2d(
                     xl, wl, padding=1)),
                 input_copy_ms=cuda_time_ms(
                     lambda: xn.permute(0, 2, 3, 1).contiguous()))
        row = dict(shape=[RN_BATCH, hw, hw, c, c], convs_per_step=count,
                   variant=k1_plan(RN_BATCH, hw, hw, c, c,
                                   torch.bfloat16)["variant"],
                   bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                   tflops=b["gflop"] / t["ms"], **t)
        row["roofline_share"] = b["bound_ms"] / t["ms"]
        emit(phase="kernel_conv_time", dtype="bfloat16", **row)
        times.append(row)
        for k in step:
            step[k] += count * t[k]
        del x, w, wk, xl, wl, xn
    emit(phase="kernel_conv_step", per="ResNet-50 step, 13 launches",
         bound_ms=bounds["k1_step_ms"], **step)
    return dict(max_abs_err=max(errs), per="ResNet-50 step (13 launches "
                "at batch 256, bf16); per shape in kernel_conv_time",
                bound_ms=bounds["k1_step_ms"],
                bound_by=bounds["k1_rows"][0]["bound_by"],
                **{k: step[k] for k in ("ms", "plain_ms", "library_ms")})


def phase_kernel_ln(bounds):
    """K6 against layer_norm_reference at [4096, 768] in fp32 and bf16 and
    a ragged [1000, 1000]; its time at [4096, 768] fp32 beside the plain
    version, F.layer_norm and the bound."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    errs = {}
    for name, (M, Dm), dt in (("bert_hidden_fp32", LN_SHAPE, torch.float32),
                              ("bert_hidden_bf16", LN_SHAPE, torch.bfloat16),
                              ("ragged_1000_fp32", (1000, 1000),
                               torch.float32)):
        x = (torch.randn(M, Dm, device=dev, generator=gen) * 3 + 1).to(dt)
        sc = torch.rand(Dm, device=dev, generator=gen) + 0.5
        bi = torch.randn(Dm, device=dev, generator=gen)
        before = row_layer_norm.launches
        got = row_layer_norm(x, sc, bi, 1e-5)
        torch.cuda.synchronize()
        launched = row_layer_norm.launches - before
        err = _rel(got, layer_norm_reference(x, sc, bi, 1e-5))
        tol = K6_FP32_TOL if dt == torch.float32 else K6_BF16_TOL
        ok = launched == 1 and err <= tol and got.dtype == dt
        emit(phase="kernel_ln_check", case=name, shape=[M, Dm],
             dtype=str(dt), launched=launched, max_err_rel=err,
             tolerance="max|diff| <= %g max|plain|" % tol, ok=ok)
        if not ok:
            raise SystemExit("K6 disagrees with its plain version in %s"
                             % name)
        errs[name] = err * got.float().abs().max().item()
    M, Dm = LN_SHAPE
    x = torch.randn(M, Dm, device=dev, generator=gen)
    sc = torch.rand(Dm, device=dev, generator=gen) + 0.5
    bi = torch.randn(Dm, device=dev, generator=gen)
    _check_no_host_sync(lambda: row_layer_norm(x, sc, bi, 1e-5))
    t = dict(ms=cuda_time_ms(lambda: row_layer_norm(x, sc, bi, 1e-5)),
             plain_ms=cuda_time_ms(lambda: layer_norm_reference(x, sc, bi,
                                                                1e-5)),
             library_ms=cuda_time_ms(lambda: torch.nn.functional.layer_norm(
                 x, (Dm,), sc, bi, 1e-5)))
    b = bounds["k6"]
    emit(phase="kernel_ln_time", shape=[M, Dm], dtype="float32",
         roofline_share=b["bound_ms"] / t["ms"], **b, **t)
    return dict(max_abs_err=errs["bert_hidden_fp32"], bound_ms=b["bound_ms"],
                bound_by=b["bound_by"], **t)


def _resnet_program(pure_bf16=True):
    """bench.py bench_resnet's program in the port: ResNet-50 v1.5 at
    224 x 224, 1000 classes, Momentum 0.9 + L2Decay 1e-4, lr 0.1, and
    (``pure_bf16``) pure-bf16 AMP; the random weights come from the
    startup program's seed."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data(name="img", shape=[3, RN_SIZE, RN_SIZE],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        logits = resnet.resnet(img, class_dim=1000, depth=50)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        opt = fluid.optimizer.MomentumOptimizer(
            learning_rate=0.1, momentum=0.9,
            regularization=fluid.regularizer.L2Decay(1e-4))
        if pure_bf16:
            opt = fluid.contrib.mixed_precision.decorate(
                opt, use_pure_bf16=True)
        opt.minimize(loss)
    return main, startup, loss


def _resnet_feed(batch, seed):
    rng = np.random.RandomState(seed)
    return {"img": rng.normal(0, 1, (batch, 3, RN_SIZE, RN_SIZE))
            .astype(np.float32),
            "label": rng.randint(0, 1000, (batch, 1)).astype(np.int64)}


def _state_copy(main, scope, device="cuda"):
    """A scope holding a copy, on ``device``, of every persistable of
    ``main`` in ``scope``."""
    out = fluid.Scope()
    for v in main.list_vars():
        if v.persistable:
            out.set_var(v.name, scope.find_var(v.name).to(device, copy=True))
    return out


# the classifier's weight and bias, and the last batch norm's bias
RN_GRADS = ("fc_0.w_0", "fc_0.b_0", "batch_norm_52.b_0")
# a K1 conv's weight and the batch norm's scale after it: reported in
# bf16, not held (rounding dominates them there)
RN_ROUNDING = ("conv2d_2.w_0", "batch_norm_2.w_0")


def _step_grads(exe, main, loss, state, feed, names=RN_GRADS):
    """The loss and the gradients of ``names`` of one step of ``main`` on
    a copy of ``state``."""
    scope = _state_copy(main, state, exe.device)
    out = exe.run(main, feed=feed, fetch_list=[loss] + [
        main._grad_name_map[n] for n in names], scope=scope)
    return float(out[0].reshape(-1)[0]), dict(zip(names, out[1:]))


def _l2_rel(a, b):
    """||a - b|| / ||b|| over every gradient of two {name: grad} dicts."""
    num = sum(float(((torch.as_tensor(a[n]).double() -
                      torch.as_tensor(b[n]).double()) ** 2).sum())
              for n in b)
    den = sum(float((torch.as_tensor(b[n]).double() ** 2).sum()) for n in b)
    return math.sqrt(num / den)


def _route_check(got, want, other, loss_rtol, grad_tol, whole=False,
                 names=RN_GRADS):
    """``got``, a route through the kernels under test (K1; K2-K4 for
    NMT), against ``want`` ((loss, {name: grad}) each): the loss, each of
    ``names`` and (``whole``) every gradient together in L2, each bound
    the larger of the fixed one and twice how far ``other``, a route
    that runs none of those kernels either, lies from ``want``."""
    def dist(a):
        d = {"loss": abs(a[0] - want[0]) / abs(want[0])}
        d.update((n, _rel(a[1][n], want[1][n])) for n in names)
        if whole:
            d["all_grads_l2"] = _l2_rel(a[1], want[1])
        return d
    err, spread = dist(got), dist(other)
    bound = {k: max(loss_rtol if k == "loss" else grad_tol, 2 * v)
             for k, v in spread.items()}
    return dict(err=err, spread=spread, bound=bound,
                ok=all(err[k] <= bound[k] for k in err))


def phase_resnet_train():
    """bench_resnet through the port's Executor on the card (see the
    module docstring, phase 12)."""
    from paddle_tpu_torch.fluid import flags
    flags.set_flag("conv_pallas", True)
    main, startup, loss = _resnet_program()
    ops = [op.type for op in main.global_block().ops]
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    params = main.global_block().all_parameters()
    emit(phase="resnet_startup", seconds=time.perf_counter() - t0,
         parameters=int(sum(scope.find_var(p.name).numel() for p in params)),
         parameter_tensors=len(params), ops=len(ops),
         grad_ops=sum(t.endswith("_grad") for t in ops),
         conv2d=ops.count("conv2d"), batch_norm=ops.count("batch_norm"),
         momentum=ops.count("momentum"), batch=RN_BATCH, image=RN_SIZE,
         amp="pure bf16", conv_pallas=True)
    init = _state_copy(main, scope)         # the startup weights
    feed = {k: torch.from_numpy(v).to("cuda")
            for k, v in _resnet_feed(RN_BATCH, SEED).items()}
    torch.cuda.reset_peak_memory_stats()
    # the main path's run: counts go to 0 here and are read after it
    _reset_launches()
    got, step_ms = _train_steps(exe, main, [feed], [loss], scope)
    launches = _launches()
    k1_variants = dict(conv3x3_bn_relu.launches_by_variant)
    k1_copies = conv3x3_bn_relu.input_copies
    losses = [float(g[0].float().item()) for g in got]
    steps = len(got)
    emit(phase="resnet_train", steps=steps, losses=losses,
         ms_per_step=step_ms, images_per_s=RN_BATCH / step_ms * 1e3,
         peak_device_mb=torch.cuda.max_memory_allocated() / 2**20,
         launches=launches,
         launches_per_step={n: c / steps for n, c in launches.items()},
         k1_launches_by_variant=k1_variants,
         k1_input_copies_per_step=k1_copies / steps)
    checks = {
        "losses_finite": bool(np.isfinite(losses).all()),
        "last_loss_below_first": losses[-1] < losses[0],
        "k1_13_per_step": launches["conv3x3_bn_relu"] == 13 * steps,
        "k1_all_wgmma": k1_variants["wgmma"] == 13 * steps,
        "no_other_kernel": not any(c for n, c in launches.items()
                                   if n != "conv3x3_bn_relu"),
    }
    checks["profile_has_k1"] = _profile_step(
        "resnet_profile", exe, main, feed, [loss], scope)["k1"] > 0
    checks.update(phase_resnet_check(exe, main, loss, init, feed))
    _fail_unless("resnet_train", checks)
    return dict(launches=launches, ms_per_step=step_ms,
                k1_launches_by_variant=k1_variants, init=init,
                losses=losses)


def phase_resnet_check(exe, main, loss, init, feed):
    """Step 1 from the startup weights ``init``: the K1 route against the
    cuDNN route (flag off) in bf16 at batch 256, with the unfold x matmul
    route as the spread; then the card against the port's CPU path, fp32
    with the flag on, at batch 2, with the card's cuDNN route as the
    spread.  Returns the checks by name."""
    from paddle_tpu_torch.fluid import flags

    def route(prog, ls, state, fd, pallas, im2col="off", **kw):
        flags.set_flag("conv_pallas", pallas)
        flags.set_flag("conv_im2col", im2col)
        try:
            return _step_grads(exe, prog, ls, state, fd, **kw)
        finally:
            flags.set_flag("conv_pallas", False)
            flags.set_flag("conv_im2col", "off")

    names = RN_GRADS + RN_ROUNDING
    card = route(main, loss, init, feed, True, names=names)
    cudnn = route(main, loss, init, feed, False, names=names)
    im2col = route(main, loss, init, feed, False, "all", names=names)
    bf16 = _route_check(card, cudnn, im2col, RN_LOSS_RTOL, RN_GRAD_TOL)
    bf16["not_held"] = {n: dict(err=_rel(card[1][n], cudnn[1][n]),
                                spread=_rel(im2col[1][n], cudnn[1][n]))
                        for n in RN_ROUNDING}
    fmain, _, floss = _resnet_program(pure_bf16=False)
    names = [p.name for p in fmain.global_block().all_parameters()]
    two = {k: v[:2] for k, v in _resnet_feed(RN_BATCH, SEED).items()}
    before = conv3x3_bn_relu.launches
    card2 = route(fmain, floss, init, two, True, names=names)
    k1_card2 = conv3x3_bn_relu.launches - before
    t2 = time.perf_counter()
    flags.set_flag("conv_pallas", True)
    try:
        cpu2 = _step_grads(fluid.Executor(fluid.CPUPlace()), fmain, floss,
                             init, two, names)
    finally:
        flags.set_flag("conv_pallas", False)
    cpu_s = time.perf_counter() - t2
    cudnn2 = route(fmain, floss, init, two, False, names=names)
    fp32 = _route_check(card2, cpu2, cudnn2, RN_CPU_LOSS_RTOL,
                        RN_CPU_GRAD_TOL, whole=True)
    checks = {"k1_route_matches_cudnn_route": bf16["ok"],
              "card_fp32_ran_k1": k1_card2 == 13,
              "card_matches_cpu_path": fp32["ok"]}
    emit(phase="resnet_check",
         tolerance="each: max(fixed, 2 x the spread of a route without K1 "
         "from the same reference); fixed: K1 vs cuDNN route (bf16, batch "
         "%d; spread: unfold x matmul route) loss rel %g, grads "
         "max|diff|/max|grad| %g; card vs CPU (fp32, batch 2; spread: the "
         "card's cuDNN route) %g, %g, all gradients in relative L2 %g"
         % (RN_BATCH, RN_LOSS_RTOL, RN_GRAD_TOL, RN_CPU_LOSS_RTOL,
            RN_CPU_GRAD_TOL, RN_CPU_GRAD_TOL),
         grads=list(RN_GRADS), loss_k1_route=card[0],
         loss_cudnn_route=cudnn[0], loss_im2col_route=im2col[0],
         k1_vs_cudnn=bf16, loss_card_b2=card2[0], loss_cpu_b2=cpu2[0],
         loss_cudnn_b2=cudnn2[0], cpu_seconds=cpu_s, card_vs_cpu=fp32,
         checks=checks)
    return checks


def _kernel_kinds(prof):
    """Device ms of one profiled step by kind of kernel, from the kernel
    names: K1; the flash-attention kernels K2-K5; the library's
    convolutions and GEMMs (cuDNN / cuBLAS / cuBLASLt's nvjet / CUTLASS
    names); embedding, index, gather and scatter kernels (DeepFM's
    lookups and their gradients); reductions; PyTorch's elementwise
    kernels; everything else (copies, fills)."""
    kinds = dict(k1=0.0, k2_k5=0.0, library_conv_gemm=0.0,
                 gather_scatter=0.0, reduce=0.0, elementwise=0.0, other=0.0)
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.key.lower()
        if "conv3x3" in name:
            kind = "k1"
        elif any(w in name for w in ("flash_fwd_kernel", "dkv_kernel",
                                     "q_rows_kernel")):
            kind = "k2_k5"
        elif any(w in name for w in ("xmma", "cudnn", "cutlass", "gemm",
                                     "nvjet", "implicit", "conv", "dgrad",
                                     "wgrad")):
            kind = "library_conv_gemm"
        elif any(w in name for w in ("embedding", "index", "scatter",
                                     "gather")):
            kind = "gather_scatter"
        elif "reduce" in name:
            kind = "reduce"
        elif "elementwise" in name:
            kind = "elementwise"
        else:
            kind = "other"
        kinds[kind] += e.self_device_time_total / 1e3
    return kinds


def _ln_program(fused):
    """x [32, 128, 768] -> layer norm over the last axis (fused_layer_norm
    appended by hand, or the layer_norm layer) with trainable scale and
    bias -> mean(fc(y, 1)); backward only."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    shape = [BT, S, H * D]
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape, append_batch_size=False)
        x.stop_gradient = False
        if fused:
            blk = main.global_block()
            sc = fluid.layers.create_parameter(
                [H * D], "float32", name="ln_scale",
                default_initializer=fluid.initializer.Constant(1.0))
            bi = fluid.layers.create_parameter(
                [H * D], "float32", name="ln_bias",
                default_initializer=fluid.initializer.Constant(0.0))
            y = blk.create_var(name="ln_y", shape=shape, dtype="float32")
            outs = {n: [blk.create_var(name="ln_" + n.lower(),
                                       dtype="float32")]
                    for n in ("Mean", "Variance")}
            blk.append_op("fused_layer_norm",
                          inputs={"X": [x], "Scale": [sc], "Bias": [bi]},
                          outputs=dict(Y=[y], **outs),
                          attrs={"begin_norm_axis": 2, "epsilon": 1e-5})
        else:
            y = fluid.layers.layer_norm(
                x, begin_norm_axis=2, param_attr="ln_scale",
                bias_attr="ln_bias")
        loss = fluid.layers.mean(fluid.layers.fc(y, 1, num_flatten_dims=2))
        fluid.append_backward(loss)
    return main, startup, loss


def phase_ln_path():
    """The fused_layer_norm path through Executor on the card: one K6
    launch per run, and the gradients of x, scale and bias equal to the
    layer_norm op's program from the same weights."""
    fused, startup, floss = _ln_program(True)
    plain, _, ploss = _ln_program(False)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(SEED)
    feed = {"x": (rng.randn(BT, S, H * D) * 3 + 1).astype(np.float32)}
    names = ["x", "ln_scale", "ln_bias"]
    _reset_launches()
    got = exe.run(fused, feed=feed, fetch_list=[floss] + [
        fused._grad_name_map[n] for n in names], scope=scope)
    launches = _launches()
    want = exe.run(plain, feed=feed, fetch_list=[ploss] + [
        plain._grad_name_map[n] for n in names], scope=scope)
    errs = {n: _rel(a, b) for n, a, b in zip(["loss"] + names, got, want)}
    checks = {
        "k6_once": launches["layer_norm"] == 1,
        "no_other_kernel": not any(c for n, c in launches.items()
                                   if n != "layer_norm"),
        "grads_match_layer_norm_op": max(errs.values()) <= LN_PATH_TOL,
    }
    emit(phase="ln_path", x=[BT, S, H * D], launches=launches,
         errors_rel=errs, tolerance="max|diff|/max|ref| %g" % LN_PATH_TOL,
         checks=checks)
    _fail_unless("ln_path", checks)
    return launches



# ---------------------------------------------------------------------------
# Transformer NMT training (bench_nmt) and LeNet (bench_lenet)
# ---------------------------------------------------------------------------

NMT_BATCH = 32                # bench.py runs bench_nmt(batch=32)
NMT_LR, NMT_WARMUP = 2.0, 4000
NMT_LR_RTOL = 1e-6            # fetched learning rate vs the closed form
NMT_LOSS_RTOL = 1e-2          # step-1 loss, fused route vs composition (bf16)
NMT_GRAD_TOL = 5e-2           # _nmt_grad_names, same comparison
NMT_CPU_BATCH = 2             # card vs CPU path: fp32, batch 2,
NMT_CPU_LAYERS = 2            # 2 + 2 layers
NMT_CPU_LOSS_RTOL = 1e-4
NMT_CPU_GRAD_TOL = 1e-3       # named gradients, and all in relative L2
LENET_BATCH = 1024            # bench.py runs bench_lenet(batch=1024)
COUNTER = "@LR_DECAY_COUNTER@"


def _nmt_config(**kw):
    return transformer.base_config(**kw)


def _nmt_program(cfg, amp=True):
    """bench_nmt's program: build_train(cfg, lr=2.0, warmup_steps=4000)
    and (``amp``) pure bf16 as bench_nmt tags it."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = transformer.build_train(cfg, lr=NMT_LR,
                                      warmup_steps=NMT_WARMUP)
    if amp:
        main._amp_dtype = "bfloat16"
        main._amp_keep = True
    return main, startup, out


def _nmt_feed(cfg, batch, rng, ragged=False):
    """A feed on the card drawn as bench_nmt draws it (all-ones masks), or
    with source and target lengths S/2..S (``ragged``)."""
    S_ = cfg.max_len

    def mask():
        if not ragged:
            return np.ones((batch, S_, 1), np.float32)
        n = rng.randint(S_ // 2, S_ + 1, batch)
        return (np.arange(S_)[None, :, None] < n[:, None, None]).astype(
            np.float32)
    feed = {"src_ids": rng.randint(0, cfg.src_vocab_size, (batch, S_, 1)),
            "src_mask": mask(),
            "trg_ids": rng.randint(0, cfg.trg_vocab_size, (batch, S_, 1)),
            "trg_mask": mask(),
            "label": rng.randint(0, cfg.trg_vocab_size, (batch, S_, 1))}
    return {k: torch.from_numpy(np.asarray(v)).to("cuda")
            for k, v in feed.items()}


def _nmt_grad_names(L):
    """The encoder's first q projection, the decoder's first
    self-attention q projection (causal) and the output projection: fc
    numbering runs 6 per encoder layer, 10 per decoder layer, then the
    projection."""
    return ("fc_0.w_0", "fc_%d.w_0" % (6 * L), "fc_%d.w_0" % (16 * L))


@contextlib.contextmanager
def _plain_attention():
    """The attention wrappers run their plain versions on the card's
    tensors: a route through the fused op that launches none of K2-K5."""
    real = attention_ops._kernel_device
    attention_ops._kernel_device = lambda *a, **kw: False
    try:
        yield
    finally:
        attention_ops._kernel_device = real


def _nmt_startup(name, main, startup, cfg):
    ops = [op.type for op in main.global_block().ops]
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    params = main.global_block().all_parameters()
    emit(phase=name + "_startup", seconds=time.perf_counter() - t0,
         parameters=int(sum(scope.find_var(p.name).numel() for p in params)),
         parameter_tensors=len(params), ops=len(ops),
         startup_ops=len(startup.global_block().ops),
         grad_ops=sum(t.endswith("_grad") for t in ops),
         adam_ops=ops.count("adam"),
         fused_attention=ops.count("fused_attention"),
         attn_dropout=cfg.attn_dropout, hidden_dropout=cfg.dropout,
         amp="pure bf16", batch=NMT_BATCH, seq=cfg.max_len,
         layers=cfg.num_layers)
    return exe, scope


def _nmt_phase(name, cfg, feeds, fetch_lr, checks_fn, keep_init=False):
    """One NMT training phase: bench_nmt's program for ``cfg`` started on
    the card, WARM_STEPS + TIMED_STEPS steps with ``feeds`` taken in turn
    (the main path's run, with the launch counts set to 0 before it and
    read after it), ms per step, tokens/s (batch x S a step, as bench_nmt
    counts), peak memory and launches, then one profiled step.
    ``checks_fn(got, launches, extra, scope)`` returns the checks by
    name and may add fields to ``extra`` for the phase's line.  Returns
    the executor, a copy of the startup weights (``keep_init``, else
    None), the checks and the launches."""
    main, startup, out = _nmt_program(cfg)
    exe, scope = _nmt_startup(name, main, startup, cfg)
    init = _state_copy(main, scope) if keep_init else None
    fetch = [out["loss"]]
    if fetch_lr:
        fetch.append(out["optimizer"]._global_learning_rate(main))
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    got, step_ms = _train_steps(exe, main, feeds, fetch, scope)
    launches = _launches()
    extra = dict(losses=[float(g[0].float().item()) for g in got])
    checks = {"losses_finite": bool(np.isfinite(extra["losses"]).all())}
    checks.update(checks_fn(got, launches, extra, scope))
    emit(phase=name, card=_card(), steps=len(got), ms_per_step=step_ms,
         tokens_per_s=NMT_BATCH * cfg.max_len / step_ms * 1e3,
         peak_device_mb=torch.cuda.max_memory_allocated() / 2**20,
         launches=launches,
         launches_per_step={n: c / len(got) for n, c in launches.items()},
         **extra)
    _profile_step(name + "_profile", exe, main, feeds[0], fetch, scope)
    return exe, init, checks, launches


def phase_nmt_train():
    """bench_nmt's configuration through Executor on the card: base_config
    (6 + 6 layers, width 512, 8 heads, ffn 2048, S = 256, vocabularies of
    30,000, dropout 0.1 on the hidden states and the attention weights,
    label smoothing 0.1), Adam on noam_decay(512, 4000) x 2.0, pure bf16,
    batch 32, all-ones masks, bench_nmt's two feeds taken in turn.
    Attention dropout routes every fused_attention op through the
    composition: no flash kernel may launch.  The learning rate of each
    run must be the closed form and the step counter 10 after ten runs;
    the loss only finite (over these steps the rate stays under
    3.5e-6)."""
    cfg = _nmt_config()
    rng = np.random.RandomState(0)
    feeds = [_nmt_feed(cfg, NMT_BATCH, rng) for _ in range(2)]

    def checks(got, launches, extra, scope):
        lrs = [float(g[1].reshape(-1)[0].item()) for g in got]
        t = np.arange(1, len(got) + 1, dtype=np.float64)
        want = NMT_LR * cfg.hidden_size ** -0.5 * np.minimum(
            t ** -0.5, t * NMT_WARMUP ** -1.5)
        lr_err = float(np.max(np.abs(np.array(lrs) - want) / want))
        counter = float(scope.find_var(COUNTER).reshape(-1)[0].item())
        extra.update(learning_rates=lrs, lr_max_rel_err=lr_err,
                     counter=counter)
        return {"lr_is_noam": lr_err <= NMT_LR_RTOL,
                "counter_reads_10": counter == len(got),
                "no_flash_kernel": not any(launches.values())}
    _, _, ok, launches = _nmt_phase("nmt_train", cfg, feeds, True, checks)
    _fail_unless("nmt_train", ok)
    return launches


def phase_nmt_train_flash():
    """bench_nmt's widths, batch and bf16 with attention dropout off
    (hidden dropout stays 0.1) and ragged masks: every fused_attention
    op runs flash attention, 18 K2, 18 K3, 18 K4 and 0 K5 a step (6
    causal).  Then phase_nmt_check."""
    cfg = _nmt_config()
    cfg.attn_dropout = 0.0
    feed = _nmt_feed(cfg, NMT_BATCH, np.random.RandomState(SEED),
                     ragged=True)
    n_attn = 3 * cfg.num_layers

    def checks(got, launches, extra, scope):
        steps = len(got)
        return {
            "k2_k3_k4_18_per_step": all(
                launches[n] == n_attn * steps for n in (
                    "flash_attention_fwd", "flash_attention_bwd_dq",
                    "flash_attention_bwd_dkv")),
            "k5_0": launches["flash_attention_bwd_dbias"] == 0,
            "no_other_kernel": not any(
                c for n, c in launches.items()
                if not n.startswith("flash_attention"))}
    exe, init, ok, launches = _nmt_phase("nmt_train_flash", cfg, [feed],
                                         False, checks, keep_init=True)
    ok.update(phase_nmt_check(exe, init, feed))
    _fail_unless("nmt_train_flash", ok)
    return launches


def phase_nmt_check(exe, init, feed):
    """Step 1 from the startup weights ``init``, with all dropout off in
    both routes of each comparison (the routes number their random ops
    differently): the fused route (K2-K4) against the composition route
    (use_fused_attention=False) in bf16 at batch 32, with the fused route
    running the kernels' plain versions as the spread; then the card
    against the port's CPU path, fp32 at batch 2 and 2 + 2 layers, with
    the card's plain-version route as the spread.  Returns the checks by
    name."""
    L = _nmt_config().num_layers
    names = _nmt_grad_names(L)
    fused, _, fout = _nmt_program(_nmt_config(dropout=0.0))
    comp, _, cout = _nmt_program(_nmt_config(dropout=0.0,
                                             use_fused_attention=False))
    before = _launches()
    card = _step_grads(exe, fused, fout["loss"], init, feed, names)
    ran = {n: c - before[n] for n, c in _launches().items()}
    want = _step_grads(exe, comp, cout["loss"], init, feed, names)
    with _plain_attention():
        plain = _step_grads(exe, fused, fout["loss"], init, feed, names)
    bf16 = _route_check(card, want, plain, NMT_LOSS_RTOL, NMT_GRAD_TOL,
                        names=names)

    cut = _nmt_config(dropout=0.0, num_layers=NMT_CPU_LAYERS)
    fmain, fstartup, fo = _nmt_program(cut, amp=False)
    fscope = fluid.Scope()
    exe.run(fstartup, scope=fscope)
    all_names = [p.name for p in fmain.global_block().all_parameters()]
    two = {k: v[:NMT_CPU_BATCH] for k, v in feed.items()}
    before = _launches()
    card2 = _step_grads(exe, fmain, fo["loss"], fscope, two, all_names)
    ran2 = {n: c - before[n] for n, c in _launches().items()}
    t2 = time.perf_counter()
    cpu2 = _step_grads(fluid.Executor(fluid.CPUPlace()), fmain, fo["loss"],
                         fscope, {k: v.cpu() for k, v in two.items()},
                         all_names)
    cpu_s = time.perf_counter() - t2
    with _plain_attention():
        plain2 = _step_grads(exe, fmain, fo["loss"], fscope, two,
                               all_names)
    fp32 = _route_check(card2, cpu2, plain2, NMT_CPU_LOSS_RTOL,
                        NMT_CPU_GRAD_TOL, whole=True,
                        names=_nmt_grad_names(NMT_CPU_LAYERS))
    kernels = ("flash_attention_fwd", "flash_attention_bwd_dq",
               "flash_attention_bwd_dkv")
    checks = {
        "fused_route_ran_k2_k3_k4": all(ran[n] == 3 * L for n in kernels)
        and ran["flash_attention_bwd_dbias"] == 0,
        "fused_matches_composition": bf16["ok"],
        "card_fp32_ran_k2_k3_k4": all(ran2[n] == 3 * NMT_CPU_LAYERS
                                      for n in kernels),
        "card_matches_cpu_path": fp32["ok"],
    }
    emit(phase="nmt_check",
         tolerance="each: max(fixed, 2 x the spread of a route without "
         "K2-K5 from the same reference); dropout off in every route; "
         "fixed: fused vs composition route (bf16, batch %d; spread: the "
         "fused route with the kernels' plain versions) loss rel %g, "
         "grads max|diff|/max|grad| %g; card vs CPU (fp32, batch %d, %d + "
         "%d layers; spread: the card's plain-version route) %g, %g, all "
         "gradients in relative L2 %g"
         % (NMT_BATCH, NMT_LOSS_RTOL, NMT_GRAD_TOL, NMT_CPU_BATCH,
            NMT_CPU_LAYERS, NMT_CPU_LAYERS, NMT_CPU_LOSS_RTOL,
            NMT_CPU_GRAD_TOL, NMT_CPU_GRAD_TOL),
         grads=list(names), loss_fused_route=card[0],
         loss_composition_route=want[0], loss_plain_route=plain[0],
         fused_vs_composition=bf16, launched_fused_route=ran,
         loss_card_b2=card2[0], loss_cpu_b2=cpu2[0],
         loss_plain_b2=plain2[0], cpu_seconds=cpu_s, card_vs_cpu=fp32,
         launched_card_b2=ran2, checks=checks)
    return checks


def phase_lenet_train():
    """bench_lenet's configuration through Executor on the card: LeNet-5,
    1 x 28 x 28, batch 1024, Adam 1e-3, bench_lenet's two feeds taken in
    turn, 2 warm-up and 4 timed steps: finite losses, the last below the
    first, and none of the port's kernels launched (its 5x5 convs are
    cuDNN's)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = lenet.build_train(lr=1e-3)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feeds = []
    for _ in range(2):
        feeds.append({
            "img": torch.from_numpy(rng.normal(
                0, 1, (LENET_BATCH, 1, 28, 28)).astype(np.float32)).cuda(),
            "label": torch.from_numpy(rng.randint(
                0, 10, (LENET_BATCH, 1)).astype(np.int64)).cuda()})
    torch.cuda.reset_peak_memory_stats()
    # the main path's run: counts go to 0 here and are read after it
    _reset_launches()
    got, step_ms = _train_steps(exe, main, feeds, [out["loss"]], scope)
    launches = _launches()
    losses = [float(g[0].item()) for g in got]
    checks = {"losses_finite": bool(np.isfinite(losses).all()),
              "last_loss_below_first": losses[-1] < losses[0],
              "no_port_kernel": not any(launches.values())}
    emit(phase="lenet_train", card=_card(), steps=len(got),
         batch=LENET_BATCH,
         losses=losses, ms_per_step=step_ms,
         images_per_s=LENET_BATCH / step_ms * 1e3,
         peak_device_mb=torch.cuda.max_memory_allocated() / 2**20,
         launches=launches, checks=checks)
    _fail_unless("lenet_train", checks)
    return launches


DFM_BATCH = 4096              # bench.py runs bench_deepfm(batch=4096)
DFM_LR = 1e-3                 # ... with build_train(cfg, lr=1e-3): Adam
DFM_OPT_BATCH = 512           # deepfm_optimizers: the CPU side stays cheap
DFM_CHECK_STEPS = 3           # card vs the port's CPU path, from one state
DFM_LOSS_RTOL = 1e-4          # per-step losses, card vs CPU
DFM_PARAM_FLOOR = 1e-6        # parameters, card vs CPU: max(2 x the
                              # card's spread, this floor)
DFM_LR_RTOL = 1e-6            # fetched rate vs the schedule's closed form


def _dfm_config():
    return deepfm.base_config()


def _dfm_feeds(cfg, batch, n=2):
    """bench_deepfm's feeds: ``n`` batches drawn from RandomState(0),
    taken in turn, as numpy arrays."""
    rng = np.random.RandomState(0)
    return [{"sparse_ids": rng.randint(0, cfg.sparse_feature_dim,
                                       (batch, cfg.num_fields, 1))
             .astype(np.int64),
             "dense_value": rng.rand(batch, cfg.dense_dim).astype(np.float32),
             "label": rng.randint(0, 2, (batch, 1)).astype(np.int64)}
            for _ in range(n)]


def _dfm_program(make_opt=None, tweak=None):
    """DeepFM at ``_dfm_config()``: bench_deepfm's build_train(cfg,
    lr=1e-3) (Adam), or with ``make_opt`` the same forward, then
    ``tweak(main)`` (clip or rate attributes on its parameters) and
    ``make_opt().minimize``.  (main, startup, loss, optimizer)."""
    cfg = _dfm_config()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        if make_opt is None:
            out = deepfm.build_train(cfg, lr=DFM_LR)
            return main, startup, out["loss"], out["optimizer"]
        ids = fluid.layers.data(name="sparse_ids",
                                shape=[cfg.num_fields, 1], dtype="int64")
        dense = fluid.layers.data(name="dense_value", shape=[cfg.dense_dim],
                                  dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        loss, _ = deepfm.deepfm(ids, dense, label, cfg)
        if tweak is not None:
            tweak(main)
        opt = make_opt()
        opt.minimize(loss)
    return main, startup, loss, opt


def _dfm_steps(exe, main, loss, fetch, state, feeds, steps=DFM_CHECK_STEPS):
    """``steps`` runs of ``main`` on a copy of ``state`` on ``exe``'s
    device, feeds taken in turn: ([loss and ``fetch`` of each step],
    {parameter: value after the last step})."""
    scope = _state_copy(main, state, exe.device)
    got = []
    for i in range(steps):
        out = exe.run(main, feed=feeds[i % len(feeds)],
                      fetch_list=[loss] + fetch, scope=scope,
                      return_numpy=False)
        got.append([float(t.reshape(-1)[0].item()) for t in out])
    return got, {p.name: scope.find_var(p.name)
                 for p in main.global_block().all_parameters()}


def _max_abs(a, b):
    return float((a.double().cpu() - b.double().cpu()).abs().max())


def _reversed(feeds):
    """The same batches with their examples in reverse order: the same
    loss and gradients in exact arithmetic, summed in another order."""
    return [{k: np.ascontiguousarray(v[::-1]) for k, v in f.items()}
            for f in feeds]


def _dfm_card_vs_cpu(exe, main, loss, init, feeds, fetch=()):
    """Three card runs (the feeds twice, then each batch's examples in
    reverse order) and two runs of the port's CPU path (the feeds, then
    reversed), each DFM_CHECK_STEPS steps from the state ``init``:
    per-step losses within DFM_LOSS_RTOL; each parameter within the
    larger of DFM_PARAM_FLOOR and twice the sum of the two sides'
    spreads, a side's spread being how far its first run lies from its
    others (the card's nondeterminism, and each side's rounding: sums in
    another order), at the parameter that moves most.  Adagrad, Adamax
    and Ftrl divide by the gradient's own size plus a small epsilon,
    which turns the rounding of a gradient entry near 0 into a step up
    to lr/epsilon times larger; which tensor holds the most sensitive
    entry is chance, so the spread is taken over the whole model, not
    tensor by tensor.  Returns (report, checks, fetches of the first
    card run); no port kernel may launch."""
    before = _launches()
    card, cp = _dfm_steps(exe, main, loss, list(fetch), init, feeds)
    card2, cp2 = _dfm_steps(exe, main, loss, list(fetch), init, feeds)
    rev, rp = _dfm_steps(exe, main, loss, list(fetch), init,
                         _reversed(feeds))
    launched = {n: c - before[n] for n, c in _launches().items()}
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    t0 = time.perf_counter()
    cpu, pp = _dfm_steps(cpu_exe, main, loss, list(fetch), init, feeds)
    cpu_s = time.perf_counter() - t0
    _, prp = _dfm_steps(cpu_exe, main, loss, list(fetch), init,
                        _reversed(feeds))
    loss_err = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(card, cpu))
    spread = {n: max(_max_abs(cp[n], cp2[n]), _max_abs(cp[n], rp[n]))
              for n in cp}
    cpu_spread = {n: _max_abs(pp[n], prp[n]) for n in cp}
    err = {n: _max_abs(cp[n], pp[n]) for n in cp}
    bound = max(2 * (max(spread.values()) + max(cpu_spread.values())),
                DFM_PARAM_FLOOR)
    over = {n: e for n, e in err.items() if e > bound}
    losses = [g[0] for g in card]
    checks = {"losses_finite": bool(np.isfinite(losses).all()),
              "card_losses_match_cpu": loss_err <= DFM_LOSS_RTOL,
              "card_params_match_cpu": not over,
              "no_port_kernel": not any(launched.values())}
    report = dict(losses_card=losses, losses_card_2=[g[0] for g in card2],
                  losses_card_reversed=[g[0] for g in rev],
                  losses_cpu=[g[0] for g in cpu], loss_max_rel_err=loss_err,
                  card_runs_bit_equal=all(_max_abs(cp[n], cp2[n]) == 0
                                          for n in cp),
                  param_max_abs_err=err, param_spread_card=spread,
                  param_spread_cpu=cpu_spread, param_bound=bound,
                  params_over_bound=over,
                  cpu_seconds=cpu_s)
    return report, checks, card


def phase_deepfm_train():
    """bench_deepfm's configuration through Executor on the card:
    base_config (26 fields over a 1,000,001-row table, embeddings of 10,
    13 dense features, a 273 -> 400 -> 400 -> 400 -> 1 tower), Adam 1e-3,
    batch 4096, bench_deepfm's two feeds from RandomState(0) taken in
    turn, 2 warm-up and 4 timed steps: finite losses, the last below the
    first, none of the port's kernels launched (the lookups, their dense
    scatter-add gradients and the tower are PyTorch's); ms per step,
    examples/s, peak memory, one profiled step.  Then phase_deepfm_check
    from the startup weights."""
    main, startup, loss, _ = _dfm_program()
    ops = [op.type for op in main.global_block().ops]
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    params = main.global_block().all_parameters()
    emit(phase="deepfm_startup", seconds=time.perf_counter() - t0,
         parameters=int(sum(scope.find_var(p.name).numel() for p in params)),
         parameter_tensors=len(params), ops=len(ops),
         grad_ops=sum(t.endswith("_grad") for t in ops),
         adam_ops=ops.count("adam"), batch=DFM_BATCH)
    init = _state_copy(main, scope)
    feeds_np = _dfm_feeds(_dfm_config(), DFM_BATCH)
    feeds = [{k: torch.from_numpy(v).cuda() for k, v in f.items()}
             for f in feeds_np]
    torch.cuda.reset_peak_memory_stats()
    # the main path's run: counts go to 0 here and are read after it
    _reset_launches()
    got, step_ms = _train_steps(exe, main, feeds, [loss], scope)
    launches = _launches()
    losses = [float(g[0].item()) for g in got]
    checks = {"losses_finite": bool(np.isfinite(losses).all()),
              "last_loss_below_first": losses[-1] < losses[0],
              "no_port_kernel": not any(launches.values())}
    emit(phase="deepfm_train", card=_card(), steps=len(got),
         batch=DFM_BATCH, losses=losses, ms_per_step=step_ms,
         examples_per_s=DFM_BATCH / step_ms * 1e3,
         peak_device_mb=torch.cuda.max_memory_allocated() / 2**20,
         launches=launches, checks=checks)
    _profile_step("deepfm_train_profile", exe, main, feeds[0], [loss], scope)
    checks.update(phase_deepfm_check(exe, main, loss, init, feeds_np))
    _fail_unless("deepfm_train", checks)
    return launches


def phase_deepfm_check(exe, main, loss, init, feeds):
    """The card against the port's CPU path at full width: bench_deepfm's
    program from the startup weights ``init``, its two feeds, three Adam
    steps.  Returns the checks by name."""
    report, checks, _ = _dfm_card_vs_cpu(exe, main, loss, init, feeds)
    emit(phase="deepfm_check", batch=DFM_BATCH, steps=DFM_CHECK_STEPS,
         tolerance="losses rel %g; each parameter max|card - cpu| <= "
         "max(2 x (card spread + cpu spread), %g); card spread: the "
         "largest max|card - card again| or max|card - card on the "
         "reversed batches| of any parameter; cpu spread: the largest "
         "max|cpu - cpu on the reversed batches|"
         % (DFM_LOSS_RTOL, DFM_PARAM_FLOOR),
         checks=checks, **report)
    return checks


# optimizer runs of deepfm_optimizers: name -> (make the optimizer,
# tweak the program before minimize)
def _tower_clip(main):
    for p in main.global_block().all_parameters():
        if p.name.startswith("fc_"):
            p.gradient_clip_attr = fluid.clip.GradientClipByValue(0.01)


def _tower_clip_and_emb_rate(main):
    _tower_clip(main)
    main.global_block().var("fm_emb").optimize_attr["learning_rate"] = 0.5


def _global_norm_clip(main):
    fluid.clip.set_gradient_clip(fluid.clip.GradientClipByGlobalNorm(1.0),
                                 program=main)


DFM_OPTIMIZERS = {
    "lars_momentum": (lambda: fluid.optimizer.LarsMomentumOptimizer(
        0.1, momentum=0.9), None),
    "adamax": (lambda: fluid.optimizer.AdamaxOptimizer(1e-3), None),
    "adagrad": (lambda: fluid.optimizer.AdagradOptimizer(1e-2), None),
    "decayed_adagrad": (
        lambda: fluid.optimizer.DecayedAdagradOptimizer(1e-2), None),
    "adadelta": (lambda: fluid.optimizer.AdadeltaOptimizer(1.0), None),
    "rmsprop_centered": (lambda: fluid.optimizer.RMSPropOptimizer(
        1e-3, momentum=0.9, centered=True), None),
    "ftrl": (lambda: fluid.optimizer.FtrlOptimizer(
        1e-2, l1=1e-4, l2=1e-4), None),
    "lamb": (lambda: fluid.optimizer.LambOptimizer(1e-3), None),
    "adam_global_norm_clip": (
        lambda: fluid.optimizer.AdamOptimizer(DFM_LR), _global_norm_clip),
    "sgd_tower_clip_emb_rate": (
        lambda: fluid.optimizer.SGDOptimizer(0.5), _tower_clip_and_emb_rate),
}


def _closed_poly_cycle(t, lr0, ds, end, power):
    decay = ds * np.maximum(np.ceil(t / ds), 1.0)
    return (lr0 - end) * (1.0 - t / decay) ** power + end


# schedule runs: name -> (the rate as a Variable, its closed form at the
# step t = 0, 1, ...); SGD reads it
DFM_SCHEDULES = {
    "exponential_decay": (
        lambda L: L.exponential_decay(0.1, 2, 0.5, staircase=True),
        lambda t: 0.1 * 0.5 ** np.floor(t / 2)),
    "natural_exp_decay": (lambda L: L.natural_exp_decay(0.1, 2, 0.3),
                          lambda t: 0.1 * np.exp(-0.3 * t / 2)),
    "inverse_time_decay": (lambda L: L.inverse_time_decay(0.1, 2, 0.5),
                           lambda t: 0.1 / (1 + 0.5 * t / 2)),
    "polynomial_decay": (
        lambda L: L.polynomial_decay(0.1, 2, 1e-3, power=2.0, cycle=True),
        lambda t: _closed_poly_cycle(t, 0.1, 2, 1e-3, 2.0)),
    "piecewise_decay": (
        lambda L: L.piecewise_decay([1, 2], [0.1, 0.05, 0.01]),
        lambda t: np.array([0.1, 0.05, 0.01])[
            np.searchsorted([1, 2], t, side="right")]),
    "cosine_decay": (lambda L: L.cosine_decay(0.1, 1, 8),
                     lambda t: 0.05 * (np.cos(np.pi * t / 8) + 1)),
    "linear_lr_warmup": (lambda L: L.linear_lr_warmup(0.1, 2, 0.01, 0.1),
                         lambda t: np.where(t < 2, 0.01 + 0.09 * t / 2,
                                            0.1)),
}


def phase_deepfm_optimizers():
    """DeepFM at base_config and batch 512: each of the eight optimizers
    the port adds, Adam with GradientClipByGlobalNorm(1.0), SGD with
    GradientClipByValue(0.01) on the tower and a rate of 0.5 on fm_emb,
    and SGD on each of the seven schedules, for three steps on the card
    and on the port's CPU path from one startup state, held as
    deepfm_check holds Adam; each schedule's fetched rate within
    DFM_LR_RTOL of its closed form.  Any miss fails the run."""
    feeds = _dfm_feeds(_dfm_config(), DFM_OPT_BATCH)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    runs = [(n, make, tweak, None) for n, (make, tweak) in
            DFM_OPTIMIZERS.items()]
    for n, (sched, closed) in DFM_SCHEDULES.items():
        runs.append((n, lambda sched=sched: fluid.optimizer.SGDOptimizer(
            sched(fluid.layers)), None, closed))
    checks = {}
    for name, make, tweak, closed in runs:
        main, startup, loss, opt = _dfm_program(make, tweak)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        fetch = [] if closed is None else [opt._global_learning_rate(main)]
        report, ok, card = _dfm_card_vs_cpu(exe, main, loss, scope, feeds,
                                            fetch)
        if closed is not None:
            rates = [g[1] for g in card]
            want = closed(np.arange(len(rates), dtype=np.float64))
            lr_err = float(np.max(np.abs(np.array(rates) - want) / want))
            report.update(learning_rates=rates, lr_max_rel_err=lr_err)
            ok["lr_is_closed_form"] = lr_err <= DFM_LR_RTOL
        ops = main.global_block().ops
        emit(phase="deepfm_optimizers", run=name, batch=DFM_OPT_BATCH,
             steps=DFM_CHECK_STEPS, ops=len(ops),
             clip_ops=sum(op.type in ("clip", "squared_l2_norm") and
                          op.attr("op_role") == fluid.OpRole.Optimize
                          for op in ops), checks=ok, **report)
        checks.update({"%s_%s" % (name, k): v for k, v in ok.items()})
    _fail_unless("deepfm_optimizers", checks)


# ---------------------------------------------------------------------------
# Checkpoints, model export and the inference predictor
# ---------------------------------------------------------------------------

# every file these phases write lives here, inside the checkout (build/ is
# gitignored), and is removed when the phase ends
IO_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_io"
CKPT_STEPS = 6                # run A; run B: 3, save, resume, 3
PRED_BATCH = 32               # predictor_resnet: ResNet-50 at 224 x 224
PRED_FUSED_TOL = dict(rtol=1e-3, atol=1e-4)   # conv-bn folded vs executor
PRED_PLAIN_TOL = dict(rtol=1e-4, atol=1e-5)   # no passes vs executor


class _Killed(BaseException):
    """A kill at a checkpoint write boundary (fault hook)."""


def _io_dir(name):
    d = IO_DIR / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


def _dir_bytes(d):
    return sum(p.stat().st_size for p in Path(d).rglob("*") if p.is_file())


def _ckpt_run(cfg, feeds, start=0, stop=None, scope=None):
    """Build BERT-base pretraining as phase_train does; with no scope, a
    fresh one from the startup program.  Runs feeds[start:stop]; returns
    (main, scope, exe, losses as tensors, ms per step)."""
    main, startup, out = _build_pretrain(cfg)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    if scope is None:
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in feeds[start:stop]:
        losses.append(exe.run(main, feed=f, fetch_list=[out["loss"]],
                              scope=scope, return_numpy=False)[0])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / max(1, len(losses))
    return main, scope, exe, out, losses, ms


def _persistables(main, scope):
    return {v.name: scope.find_var(v.name) for v in main.list_vars()
            if v.persistable}


def _spread(a, b):
    """{name: max |a - b|} over the tensors of two states that differ."""
    out = {}
    for n, t in a.items():
        d = float((t.double() - b[n].double()).abs().max())
        if d:
            out[n] = d
    return out


def phase_lookup_grad(repeats=5):
    """What the lookup_table rule's table gradient costs: the rule takes
    ``embedding_dense_backward`` under torch's deterministic algorithms
    (``tensor_ops.LookupFunction``, which makes ckpt_resume's runs
    bit-equal), torch's default takes it without.  Both at each table of
    BERT-base pretraining (batch 32) and of DeepFM (batch 4096), on the
    ids of those paths: wall ms per call over 50 calls, the device
    drained before and after, and how many distinct results ``repeats``
    calls give.  The deterministic one must give one, and agree with the
    default one within 1e-4 of the gradient's largest entry."""
    from paddle_tpu_torch.fluid.ops.tensor_ops import _deterministic
    cfg = bert.base_config()
    bf = _train_feed(cfg, BT, SEED)
    dcfg = _dfm_config()
    sparse = _dfm_feeds(dcfg, DFM_BATCH, 1)[0]["sparse_ids"]
    H = cfg.hidden_size
    tables = {"bert_word": (cfg.vocab_size, H, bf["src_ids"]),
              "bert_position": (cfg.max_position, H, bf["pos_ids"]),
              "bert_sentence": (cfg.type_vocab_size, H, bf["sent_ids"]),
              "deepfm_fm_emb": (dcfg.sparse_feature_dim,
                                dcfg.embedding_size, sparse),
              "deepfm_fm_w1": (dcfg.sparse_feature_dim, 1, sparse)}
    rng = torch.Generator(device="cuda").manual_seed(SEED)
    out, ok = {}, True
    for name, (rows, width, ids) in tables.items():
        ids = torch.from_numpy(ids.reshape(-1)).cuda()
        g = torch.randn(ids.numel(), width, device="cuda", generator=rng)

        def plain():
            return torch.ops.aten.embedding_dense_backward(
                g, ids, rows, -1, False)

        def fixed():
            with _deterministic():
                return plain()
        res = {}
        for label, fn in (("default", plain), ("deterministic", fixed)):
            got = [fn() for _ in range(repeats)]
            res[label] = dict(
                ms=_wall_ms(fn, n=50),
                distinct=len({t.cpu().numpy().tobytes() for t in got}),
                first=got[0])
        scale = float(res["default"]["first"].abs().max())
        err = float((res["deterministic"]["first"] -
                     res["default"]["first"]).abs().max())
        ok = ok and res["deterministic"]["distinct"] == 1 and \
            err <= 1e-4 * scale
        out[name] = dict(rows=rows, width=width, ids=ids.numel(),
                         max_abs_err=err, grad_max_abs=scale,
                         **{"%s_%s" % (label, k): r[k]
                            for label, r in res.items()
                            for k in ("ms", "distinct")})
        del res, g
    emit(phase="lookup_grad", repeats=repeats, tables=out)
    _fail_unless("lookup_grad", {"deterministic_repeats_and_agrees": ok})


def phase_ckpt_resume():
    """Checkpoint and resume BERT-base pretraining exactly as phase_train
    builds it (batch 32, fp32, Adam 1e-4, hidden dropout 0.1, attention
    dropout 0; one synthetic batch per step).  Run A: 6 steps, twice,
    from the startup program.  Run B: 3 steps; an async
    CheckpointManager.save(); a 4th step while its write is in flight; a
    second save killed at its first tensor file's midpoint, which leaves
    a torn .tmp-* directory; a fresh Scope and Executor with the program
    rebuilt; resume(), which must pick the complete checkpoint and skip
    the torn one; steps 4-6.  Dropout seeds come from the step counter,
    which the checkpoint restores, so run B's losses at steps 4-6 and
    every persistable after step 6 must equal run A's bit for bit (or,
    if the two A runs differ, lie within twice their largest difference
    over the model; the tensors whose first update already differs name
    the non-deterministic gradients); 12 K2, K3 and K4 a step, no K5."""
    cfg = bert.base_config(attn_dropout=0.0)
    feeds = [{k: torch.from_numpy(v).cuda() for k, v in
              _train_feed(cfg, BT, SEED + i).items()}
             for i in range(CKPT_STEPS)]
    d = _io_dir("ckpt_resume")
    torch.cuda.reset_peak_memory_stats()
    # the path's run: counts go to 0 here and are read after run B
    _reset_launches()
    runs_a = []
    for _ in range(2):
        main_a, scope_a, _, _, loss_a, _ = _ckpt_run(cfg, feeds, 0, 1)
        step1 = {n: t.clone() for n, t in
                 _persistables(main_a, scope_a).items()}
        more = _ckpt_run(cfg, feeds, 1, None, scope=scope_a)
        ms_a = more[5]          # steps 2-6
        runs_a.append((_persistables(main_a, scope_a), step1,
                       loss_a + more[4]))
    (state_a, step1_a, loss_a), (state_a2, step1_a2, loss_a2) = runs_a
    # the tensors whose first update already differs between two runs
    # from the same state name the non-deterministic gradients
    step1_spread = _spread(step1_a, step1_a2)
    spread = _spread(state_a, state_a2)
    loss_spread = max(abs(float(x) - float(y))
                      for x, y in zip(loss_a, loss_a2))
    del runs_a, state_a2, step1_a, step1_a2

    half = CKPT_STEPS // 2
    main_b, scope_b, exe_b, out_b, loss_b1, ms_plain = _ckpt_run(
        cfg, feeds, 0, half)
    mgr = fluid.CheckpointManager(str(d), async_save=True,
                                  main_program=main_b)
    t0 = time.perf_counter()
    path = mgr.save(scope=scope_b)
    save_return_ms = (time.perf_counter() - t0) * 1e3
    snapshot_ms = mgr.last_snapshot_ms
    t1 = time.perf_counter()
    extra = exe_b.run(main_b, feed=feeds[half], fetch_list=[out_b["loss"]],
                      scope=scope_b, return_numpy=False)[0]
    torch.cuda.synchronize()
    ms_in_flight = (time.perf_counter() - t1) * 1e3
    write_in_flight = mgr._thread is not None and mgr._thread.is_alive()
    t2 = time.perf_counter()
    mgr.wait()
    wait_s = time.perf_counter() - t2
    ckpt_bytes = _dir_bytes(path)
    write_s, serialized = mgr.last_save_s, mgr.last_bytes

    def kill(point):
        if point.startswith("tensor:") and point.endswith("_mid"):
            raise _Killed(point)
    prev = fluid.checkpoint.set_fault_hook(kill)
    try:
        mgr.save(scope=scope_b, sync=True)
        killed = False
    except _Killed:
        killed = True
    finally:
        fluid.checkpoint.set_fault_hook(prev)
    torn = sorted(p.name for p in d.iterdir() if ".tmp-" in p.name)
    del scope_b, exe_b, mgr

    main_r, _, _ = _build_pretrain(cfg)
    scope_r = fluid.Scope()
    mgr_r = fluid.CheckpointManager(str(d), main_program=main_r)
    t3 = time.perf_counter()
    meta = mgr_r.resume(scope=scope_r)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t3
    _, scope_r, _, _, loss_b2, _ = _ckpt_run(cfg, feeds, half, None,
                                             scope=scope_r)
    launches = _launches()
    steps = 2 * CKPT_STEPS + CKPT_STEPS + 1
    state_b = _persistables(main_r, scope_r)
    diff = _spread(state_a, state_b)
    loss_diff = [abs(float(x) - float(y))
                 for x, y in zip(loss_a[half:], loss_b2)]
    # which tensor of the model holds the largest rounding difference is
    # chance, so the bound is the whole model's: twice the largest
    # difference between the two A runs (0: bit-equality)
    bound = 2 * max(spread.values(), default=0.0)
    b_max = max(diff.values(), default=0.0)

    def top(d, k=8):
        return dict(sorted(d.items(), key=lambda kv: -kv[1])[:k])
    emit(phase="ckpt_resume", steps_a=CKPT_STEPS, losses_a=[
        float(x) for x in loss_a], losses_b=[float(x) for x in loss_b1] +
        [float(x) for x in loss_b2], loss_step4_while_saving=float(extra),
        checkpoint_bytes=ckpt_bytes, tensors=len(state_b),
        serialized_bytes=serialized, snapshot_ms=snapshot_ms,
        save_return_ms=save_return_ms, async_write_s=write_s,
        wait_after_step_s=wait_s, step_ms_without_save=ms_plain,
        step_ms_run_a=ms_a, step_ms_save_in_flight=ms_in_flight,
        write_in_flight_after_step=write_in_flight, restore_s=restore_s,
        resumed=os.path.basename(meta["path"]), torn=torn,
        a_step1_differ=top(step1_spread, 16),
        a_runs_differ=len(spread), a_runs_top=top(spread),
        a_loss_spread=loss_spread, bound=bound,
        b_vs_a_differ=len(diff), b_vs_a_top=top(diff), b_vs_a_max=b_max,
        b_vs_a_loss_diff=loss_diff, launches=launches,
        peak_device_mb=torch.cuda.max_memory_allocated() / 2**20)
    shutil.rmtree(d, ignore_errors=True)
    L = cfg.num_layers
    checks = {
        "losses_finite": bool(np.isfinite([float(x) for x in loss_a +
                                           loss_b1 + loss_b2]).all()),
        "killed_mid_write": killed and bool(torn),
        "resumed_the_complete_checkpoint":
            os.path.basename(meta["path"]) == "step-%d" % (half + 1)
            and scope_r.step_counter == 2 * half + 1,
        "losses_4_to_6_equal_run_a": all(
            x <= 2 * loss_spread for x in loss_diff),
        "persistables_equal_run_a": b_max <= bound and
            set(state_b) == set(state_a),
        "k2_k3_k4_12_per_step": all(launches[n] == L * steps for n in (
            "flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv")),
        "k5_0": launches["flash_attention_bwd_dbias"] == 0,
    }
    _fail_unless("ckpt_resume", checks)
    return launches


def _served(sv, reqs):
    """Submit every request, then drain: with every request queued within
    the scheduler's wait the batches are packed the same way every time,
    so two executors see the same buckets."""
    futs = [sv.submit(r) for r in reqs]
    sv.close()
    return [f.result(timeout=300)[0] for f in futs], sv.stats()


def phase_export_serve():
    """BERT-base serving program as phase_slice builds it, exported with
    save_inference_model once per file and once with params_filename,
    then served by ServingExecutor.from_inference_model(dir, max_batch=8)
    for each layout: the same 24-request burst as phase_slice, whose rows
    must equal the live ServingExecutor's rows for the same requests bit
    for bit, with 0 recompiles after warmup() and 12 K2 a batch."""
    cfg = bert.base_config()
    main, startup, enc = _build_bert(cfg)
    infer = main.clone(for_test=True)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    reqs = _requests(cfg, np.random.RandomState(SEED), 24)
    specs = {n: ((cfg.max_seq_len, 1), "float32" if n == "input_mask"
                 else "int64") for n in FEEDS}
    # max_wait_ms holds a batch open while the burst is queued, so the
    # packing does not depend on the host's timing
    sv_kw = dict(max_batch=8, max_wait_ms=1000)
    live = fluid.ServingExecutor(infer, feed_specs=specs, fetch_list=[enc],
                                 scope=scope, executor=exe, **sv_kw)
    live.warmup()
    want, live_st = _served(live, reqs)
    d = _io_dir("export_serve")
    exports, checks = {}, {}
    _reset_launches()
    for layout, pf in (("files", None), ("combined", "params")):
        target = d / layout
        t0 = time.perf_counter()
        with fluid.scope_guard(scope):
            fluid.io.save_inference_model(str(target), list(FEEDS), [enc],
                                          exe, main, params_filename=pf)
        export_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        sv = fluid.ServingExecutor.from_inference_model(str(target),
                                                        **sv_kw)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t1
        sv.warmup()
        before = flash_attention.launches
        got, st = _served(sv, reqs)
        k2 = flash_attention.launches - before
        same = all(g.shape == w.shape and np.array_equal(g, w)
                   for g, w in zip(got, want))
        exports[layout] = dict(export_s=export_s, load_s=load_s,
                               bytes=_dir_bytes(target),
                               files=len(list(target.iterdir())),
                               batches=st["batches"], k2=k2,
                               recompiles=st["recompiles"])
        checks.update({
            layout + "_rows_equal_live": same,
            layout + "_same_batches": st["batches"] == live_st["batches"],
            layout + "_recompiles_after_warmup_0": st["recompiles"] == 0,
            layout + "_k2_12_per_batch":
                k2 == cfg.num_layers * st["batches"],
            layout + "_feed_order": sv.feed_names == list(FEEDS)})
    launches = _launches()
    checks["no_backward_launches"] = not any(
        c for n, c in launches.items() if n != "flash_attention_fwd")
    emit(phase="export_serve", requests=len(reqs),
         live_batches=live_st["batches"], exports=exports,
         launches=launches, checks=checks)
    shutil.rmtree(d, ignore_errors=True)
    _fail_unless("export_serve", checks)
    return launches


def _wall_ms(fn, n=10, warmup=3):
    """Wall milliseconds per call of ``fn`` over ``n`` calls after
    ``warmup``, the device drained before and after."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def phase_predictor_resnet():
    """ResNet-50 inference (bench_resnet's model, is_test, fp32, 224 x
    224, batch 32) with the startup program's weights and batch-norm
    statistics taken from a seeded calibration batch; exported, then run by create_paddle_predictor(Config(dir)) on
    the card with the default passes (every one of the 53 batch_norm ops
    folded into its conv) and with switch_ir_optim(False), both held
    against Executor.run of the unexported program."""
    from paddle_tpu_torch.fluid import flags
    from paddle_tpu_torch.fluid.inference import (
        Config, create_paddle_predictor)
    flags.set_flag("conv_pallas", False)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data("img", [3, RN_SIZE, RN_SIZE],
                                dtype="float32")
        logits = resnet.resnet(img, class_dim=1000, depth=50)
    infer = main.clone(for_test=True)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(SEED)
    bns = [op for op in infer.global_block().ops if op.type == "batch_norm"]
    # batch-norm statistics from one training-mode pass over a seeded
    # calibration batch with momentum 0 (each running mean and variance
    # becomes its batch's), so that the activations stay near unit scale
    # as in a trained network
    calib = main.clone()
    for op in calib.global_block().ops:
        if op.type == "batch_norm":
            op._set_attr("momentum", 0.0)
    exe.run(calib, feed={"img": rng.randn(
        PRED_BATCH, 3, RN_SIZE, RN_SIZE).astype(np.float32)}, scope=scope)
    x = rng.randn(PRED_BATCH, 3, RN_SIZE, RN_SIZE).astype(np.float32)
    ref, = exe.run(infer, feed={"img": x}, fetch_list=[logits], scope=scope)
    d = _io_dir("predictor_resnet")
    t0 = time.perf_counter()
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(str(d), ["img"], [logits], exe, main)
    export_s = time.perf_counter() - t0
    xt = torch.from_numpy(x).cuda()
    runs, checks = {}, {}
    # the path's run: counts go to 0 here and are read after both
    # predictors (fp32 ResNet-50 inference reaches no port kernel)
    _reset_launches()
    for name, optim, tol in (("passes", True, PRED_FUSED_TOL),
                             ("no_passes", False, PRED_PLAIN_TOL)):
        config = Config(str(d))
        config.switch_ir_optim(optim)
        t1 = time.perf_counter()
        pred = create_paddle_predictor(config)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t1
        got, = pred.run([x])
        ops = [op.type for op in pred.program().global_block().ops]
        err = np.abs(got - ref)
        ratio = float((err / (tol["atol"] + tol["rtol"] *
                              np.abs(ref))).max())
        ms = _wall_ms(lambda: pred._exe.run(
            pred._program, feed={"img": xt}, fetch_list=pred._fetch_vars,
            scope=pred._scope, return_numpy=False))
        runs[name] = dict(load_s=load_s, ms_per_batch=ms,
                          max_abs_err=float(err.max()),
                          err_over_tolerance=ratio, ops=len(ops),
                          batch_norm=ops.count("batch_norm"),
                          folded_bias_adds=sum(
                              n.endswith("@bn_folded_bias")
                              for n in pred._scope.var_names()))
        checks[name + "_within_tolerance"] = bool(np.isfinite(got).all()
                                                  and ratio <= 1.0)
    checks["passes_fold_every_batch_norm"] = \
        runs["passes"]["batch_norm"] == 0 and \
        runs["passes"]["folded_bias_adds"] == len(bns) == 53
    checks["no_passes_keep_batch_norm"] = \
        runs["no_passes"]["batch_norm"] == len(bns)
    launches = _launches()
    checks["no_port_kernel_launches"] = not any(launches.values())
    exe_ms = _wall_ms(lambda: exe.run(
        infer, feed={"img": xt}, fetch_list=[logits], scope=scope,
        return_numpy=False))
    emit(phase="predictor_resnet", batch=PRED_BATCH, image=RN_SIZE,
         batch_norm=len(bns), export_s=export_s, export_bytes=_dir_bytes(d),
         executor_ms_per_batch=exe_ms, logits_max_abs=float(np.abs(
             ref).max()), tolerance=dict(passes=PRED_FUSED_TOL,
                                         no_passes=PRED_PLAIN_TOL),
         runs=runs, launches=launches, checks=checks)
    shutil.rmtree(d, ignore_errors=True)
    _fail_unless("predictor_resnet", checks)
    return launches


# -- the training-loop runtime: windows, the feed ring, datasets, hooks -----

WIN_K = 4                     # window_train: steps per run_window
WIN_BATCHES = 4               # distinct seeded batches, taken in turn
WIN_STEPS = 14                # 2 warm-up + 12 timed (3 windows of 4)
DS_BATCHES = 16               # dataset_train: 16 x 4096 MultiSlot lines
STALL_S = 5.0                 # watchdog_stall: the generator's one stall
STALL_TIMEOUT_S = 2.0         # ... against this watchdog timeout
FLASH_KERNELS = ("flash_fwd_kernel", "q_rows_kernel", "dkv_kernel")


def _scope_from(main, init, step):
    """A scope holding a copy of the persistables ``init`` holds, its
    counter at ``step``: every run of a phase starts from one state."""
    scope = _state_copy(main, init)
    scope.step_counter = step
    return scope


def _events_since(n0):
    """Step events recorded after the first ``n0`` (the ring is large
    enough for one phase)."""
    recorded = fluid.telemetry.step_events_recorded()
    evs = fluid.telemetry.step_events()
    return evs[len(evs) - (recorded - n0):] if recorded > n0 else []


def _feed_vars(main, names):
    return [main.global_block().var(n) for n in names]


def _window_run(cfg, init, step0, feeds, depth, ckpt=None):
    """Run B (depth 2) or C (depth 0) of window_train: 2 warm-up run()
    calls with explicit feeds, then the remaining WIN_STEPS - 2 batches
    through a program-bound DataLoader(steps_per_run=WIN_K) on the card,
    pulled by exe.run() with no feed.  With ``ckpt`` a windowed
    CheckpointManager saves after window 2.  Returns a dict of what the
    gates read."""
    main, _, out = _build_pretrain(cfg)
    scope = _scope_from(main, init, step0)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    losses = [exe.run(main, feed=feeds[i], fetch_list=[out["loss"]],
                      scope=scope, return_numpy=False)[0].reshape(1)
              for i in range(2)]
    flags = fluid.flags
    prev = flags.get_flag("feed_ring_depth")
    flags.set_flag("feed_ring_depth", depth)
    try:
        with fluid.program_guard(main):
            loader = fluid.io.DataLoader.from_generator(
                feed_list=_feed_vars(main, list(feeds[0])), capacity=2,
                iterable=False, steps_per_run=WIN_K)

        def gen():
            for i in range(2, WIN_STEPS):
                yield feeds[i % WIN_BATCHES]
        loader.set_batch_generator(gen, places=fluid.CUDAPlace(0))
        reg = fluid.telemetry.registry()
        wait0 = reg.get("data_wait_seconds_total").value()
        pinned0 = reg.get("feed_pinned_copies_total").value()
        ev0 = fluid.telemetry.step_events_recorded()
        loader.start()
        window_ms, syncs, plans, saved = [], [], [], None
        while True:
            s0 = fluid.profiler.host_sync_count()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                got = exe.run(main, fetch_list=[out["loss"]], scope=scope,
                              return_numpy=False)
            except fluid.core.EOFException:
                break
            torch.cuda.synchronize()
            window_ms.append((time.perf_counter() - t0) * 1e3)
            syncs.append(fluid.profiler.host_sync_count() - s0)
            plans.append(exe.compile_count())
            losses.append(got[0].reshape(-1))
            if ckpt is not None and len(window_ms) == 2:
                path = ckpt.save(scope=scope, sync=True)
                saved = dict(path=path, marker=scope._window_end,
                             meta=fluid.checkpoint.checkpoint_metadata(path))
                try:
                    ckpt.save(step=scope._window_end + 1, scope=scope)
                    saved["off_marker_raised"] = False
                except ValueError as e:
                    saved["off_marker_raised"] = \
                        "not a window boundary" in str(e)
        evs = [e for e in _events_since(ev0) if "kind" not in e]
        return dict(
            main=main, out=out, exe=exe, scope=scope,
            losses=torch.cat(losses), window_ms=window_ms, syncs=syncs,
            plans=plans, saved=saved,
            data_wait_s=reg.get("data_wait_seconds_total").value() - wait0,
            pinned_windows=reg.get("feed_pinned_copies_total").value() -
            pinned0,
            window_events=sum(1 for e in evs
                              if e.get("window") and e.get("k") == WIN_K),
            event_syncs=[e["syncs"] for e in evs if e.get("window")])
    finally:
        flags.set_flag("feed_ring_depth", prev)


def _sync_sites(run):
    """The sites that synchronize with the host while ``run()`` runs (a
    window or a step whose feed already lies on the card), from
    torch.cuda.set_sync_debug_mode("warn"): {file:line: message}."""
    import warnings
    sites = {}
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    for w in caught:
        if "called a synchronizing" not in str(w.message):
            continue
        key = "%s:%d" % (os.path.relpath(w.filename), w.lineno)
        sites.setdefault(key, str(w.message)[:120])
    return sites


def phase_window_train():
    """BERT-base pretraining (phase_train's configuration: batch 32, 20
    masked positions, fp32, Adam 1e-4, hidden dropout 0.1, attention
    dropout 0) through the training loop, every run from one saved
    initial state, WIN_BATCHES seeded batches taken in turn.  Run A: 2
    warm-up and 12 timed exe.run calls (K=1), twice.  Run B: 2 warm-up
    runs, then the next 12 batches through a program-bound non-iterable
    DataLoader(steps_per_run=4) on the feed ring (depth 2, pinned
    staging on a side stream), pulled by exe.run() with no feed — 3
    windows — with CheckpointManager(steps_per_run=4) saving after window
    2.  Run C: run B with FLAGS_feed_ring_depth=0, no save.  Gates: B's
    and C's losses and every persistable equal A's (bit for bit, or
    within twice the two A runs' largest difference), 12 K2, K3, K4 and
    0 K5 per inner step, no new plan after the first window, no host
    sync recorded inside a window, 3 step events with window=4, the
    checkpoint's manifest holds steps_per_run 4 and its step is the
    window-end marker, a save off the marker raises; then one window
    traced with FLAGS_device_profile=1, which must name K2-K4's kernels,
    and one window under torch.cuda.set_sync_debug_mode("warn") to name
    the sites that synchronize (reported, not gated)."""
    cfg = bert.base_config(attn_dropout=0.0)
    main, startup, out = _build_pretrain(cfg)
    scope0 = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope0)
    init, step0 = _state_copy(main, scope0), scope0.step_counter
    del scope0
    feeds = [_train_feed(cfg, BT, SEED + 100 + i) for i in range(WIN_BATCHES)]
    d = _io_dir("window_train")
    torch.cuda.reset_peak_memory_stats()
    # the path's run (A twice, B, C): counts go to 0 here, read after C
    _reset_launches()
    runs_a = []
    for _ in range(2):
        scope = _scope_from(main, init, step0)
        losses = []
        for i in range(WIN_STEPS):
            if i == 2:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            losses.append(exe.run(main, feed=feeds[i % WIN_BATCHES],
                                  fetch_list=[out["loss"]], scope=scope,
                                  return_numpy=False)[0].reshape(1))
        torch.cuda.synchronize()
        ms_k1 = (time.perf_counter() - t0) * 1e3 / (WIN_STEPS - 2)
        runs_a.append((torch.cat(losses), _persistables(main, scope),
                       ms_k1))
    mgr = fluid.CheckpointManager(str(d), main_program=main,
                                  steps_per_run=WIN_K)
    b = _window_run(cfg, init, step0, feeds, 2, ckpt=mgr)
    c = _window_run(cfg, init, step0, feeds, 0)
    launches = _launches()
    inner = 4 * WIN_STEPS         # A twice, B, C
    (loss_a, state_a, ms_k1), (loss_a2, state_a2, ms_k1_2) = runs_a
    spread = _spread(state_a, state_a2)
    bound = 2 * max(spread.values(), default=0.0)
    loss_bound = 2 * float((loss_a - loss_a2).abs().max())
    cmp = {}
    for name, r in (("b", b), ("c", c)):
        diff = _spread(state_a, _persistables(r["main"], r["scope"]))
        cmp[name] = dict(
            loss_max_diff=float((r["losses"] - loss_a).abs().max()),
            persistables_differ=len(diff),
            persistables_max_diff=max(diff.values(), default=0.0))
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    # one traced window and one under the sync debug mode, after the
    # path's run, on run B's state
    stacked = {k: np.stack([feeds[i % WIN_BATCHES][k] for i in range(WIN_K)])
               for k in feeds[0]}
    fl = fluid.flags
    fl.set_flag("device_profile", 1)     # a window counts K: all of it
    fl.set_flag("device_profile_dir", str(d / "trace"))
    fluid.profiler.device_profile_reset()
    try:
        torch.cuda.synchronize()
        ev0 = fluid.telemetry.step_events_recorded()
        b["exe"].run_window(b["main"], feed=stacked,
                            fetch_list=[b["out"]["loss"]], scope=b["scope"],
                            steps_per_run=WIN_K)
        # the window's own wall: its step event's dispatch time, which
        # ends before the trace is stopped and written
        traced_ms = _events_since(ev0)[-1]["dur_ns"] / 1e6
        prof, trace_path = fluid.profiler.device_profile_result()
    finally:
        fl.set_flag("device_profile", 0)
        fl.set_flag("device_profile_dir", "")
    busy_ms, idle_ms, events = _timeline(prof)
    names = {e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    traced = {k: any(k in n for n in names) for k in FLASH_KERNELS}
    trace_bytes = os.path.getsize(trace_path)
    del prof
    on_card = {k: torch.from_numpy(v).cuda() for k, v in stacked.items()}
    sites = _sync_sites(lambda: b["exe"].run_window(
        b["main"], feed=on_card, fetch_list=[b["out"]["loss"]],
        scope=b["scope"], steps_per_run=WIN_K))
    L = cfg.num_layers
    saved = b["saved"] or {}
    meta = saved.get("meta") or {}
    emit(phase="window_train", card=_card(), k=WIN_K, inner_steps=inner,
         ms_per_inner_step_k1=[ms_k1, ms_k1_2],
         ms_per_inner_step_k4=sum(b["window_ms"]) / (WIN_STEPS - 2),
         ms_per_inner_step_k4_ring_off=sum(c["window_ms"]) / (WIN_STEPS - 2),
         window_ms=b["window_ms"], window_ms_ring_off=c["window_ms"],
         data_wait_seconds=b["data_wait_s"],
         data_wait_seconds_ring_off=c["data_wait_s"],
         pinned_windows=b["pinned_windows"],
         pinned_windows_ring_off=c["pinned_windows"],
         losses_a=loss_a.tolist(), a_runs_differ=len(spread),
         bound=bound, loss_bound=loss_bound, vs_a=cmp,
         plans=b["plans"], window_syncs=b["syncs"],
         event_syncs=b["event_syncs"], window_events=b["window_events"],
         checkpoint=dict(step=meta.get("step"),
                         steps_per_run=meta.get("steps_per_run"),
                         marker=saved.get("marker"),
                         off_marker_raised=saved.get("off_marker_raised")),
         traced_window_ms=traced_ms, traced_busy_ms=busy_ms,
         traced_idle_ms=idle_ms, device_busy_share=busy_ms / traced_ms,
         device_busy_share_of_span=busy_ms / (busy_ms + idle_ms)
         if events else None,
         traced_events=events, traced_kernels=traced,
         trace_bytes=trace_bytes, sync_sites=sites,
         peak_device_mb=peak_mb, launches=launches)
    shutil.rmtree(d, ignore_errors=True)
    checks = {
        "losses_finite": bool(torch.isfinite(loss_a).all()),
        "b_equals_a": cmp["b"]["persistables_max_diff"] <= bound and
            cmp["b"]["loss_max_diff"] <= loss_bound,
        "c_equals_a": cmp["c"]["persistables_max_diff"] <= bound and
            cmp["c"]["loss_max_diff"] <= loss_bound,
        "k2_k3_k4_12_per_inner_step": all(launches[n] == L * inner for n in (
            "flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv")),
        "k5_0": launches["flash_attention_bwd_dbias"] == 0,
        "no_new_plan_after_window_1": len(set(b["plans"])) == 1 and
            len(set(c["plans"])) == 1,
        "no_host_sync_in_a_window": not any(b["syncs"] + c["syncs"] +
                                            b["event_syncs"]),
        "3_window_events": b["window_events"] == c["window_events"] == 3,
        "ring_staged_pinned": b["pinned_windows"] == 3 and
            c["pinned_windows"] == 0,
        "checkpoint_on_the_marker": meta.get("steps_per_run") == WIN_K and
            meta.get("step") == saved.get("marker") == step0 + 2 + 2 * WIN_K,
        "save_off_the_marker_raises": bool(saved.get("off_marker_raised")),
        "trace_names_k2_k4": all(traced.values()),
    }
    _fail_unless("window_train", checks)
    return launches


def _write_multislot(path, cfg, n, seed):
    """``n`` MultiSlot text lines (``num_fields`` sparse ids, ``dense_dim``
    floats, a label), drawn from RandomState(seed)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.sparse_feature_dim, (n, cfg.num_fields))
    dense = rng.rand(n, cfg.dense_dim).astype(np.float32)
    label = rng.randint(0, 2, n)
    head_i, head_d = "%d " % cfg.num_fields, " %d " % cfg.dense_dim
    with open(path, "w") as f:
        for i in range(n):
            f.write(head_i + " ".join(map(str, ids[i])) + head_d +
                    " ".join("%.6g" % v for v in dense[i]) +
                    " 1 %d\n" % label[i])
    return str(path)


def phase_dataset_train():
    """bench_deepfm's configuration (base_config, batch 4096, Adam 1e-3)
    trained from MultiSlot text files: DS_BATCHES x 4096 lines written
    under build/chip_smoke_io/ from a seed, loaded by an InMemoryDataset
    (lines parsed per second).  From one startup state: the parsed
    batches through exe.run, train_from_dataset(steps_per_run=4) (its
    window losses captured), exe.run again: losses and
    parameters bit-equal (or within twice the two exe.run runs' largest
    difference); none of the port's kernels launched.  Then
    preemption.install() and a real SIGTERM to this process as window 3
    starts: the loop returns {"preempted": True, "steps": 12} after a
    final synchronous save; a fresh scope restored from it finishes the
    last window and equals the unbroken run; uninstall() in a finally.
    Printed: lines/s, ms per step, data_wait_seconds, the drain's ms."""
    import signal
    from paddle_tpu_torch.fluid import preemption
    cfg = _dfm_config()
    d = _io_dir("dataset_train")
    t0 = time.perf_counter()
    half = DS_BATCHES * DFM_BATCH // 2
    files = [_write_multislot(d / ("part-%d.txt" % i), cfg, half, SEED + i)
             for i in range(2)]
    write_s = time.perf_counter() - t0
    main, startup, loss, _ = _dfm_program()
    blk = main.global_block()
    ds = fluid.DatasetFactory().create_dataset("InMemoryDataset")
    ds.set_batch_size(DFM_BATCH)
    ds.set_filelist(files)
    ds.set_use_var(_feed_vars(main, ["sparse_ids", "dense_value", "label"]))
    t0 = time.perf_counter()
    ds.load_into_memory()
    parse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    batches = list(ds)
    batchify_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope0 = fluid.Scope()
    exe.run(startup, scope=scope0)
    init, step0 = _state_copy(main, scope0), scope0.step_counter
    del scope0
    params = [p.name for p in blk.all_parameters()]

    def capture(e):
        """Record the stacked losses of every run_window the loop makes."""
        got, real = [], e.run_window

        def run_window(*a, **k):
            out = real(*a, **k)
            got.append(out[0].reshape(-1))
            return out
        e.run_window = run_window
        return got

    def run_loop():
        """The parsed batches through exe.run, one step each."""
        scope = _scope_from(main, init, step0)
        losses = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for bt in batches:
            losses.append(exe.run(main, feed=bt, fetch_list=[loss],
                                  scope=scope, return_numpy=False)[0]
                          .reshape(-1))
        torch.cuda.synchronize()
        return (torch.cat(losses), _persistables(main, scope),
                (time.perf_counter() - t0) * 1e3 / DS_BATCHES)

    # the path's run: counts go to 0 here and are read after it
    _reset_launches()
    runs = [run_loop()]
    reg = fluid.telemetry.registry()
    wait0 = reg.get("data_wait_seconds_total").value()
    scope_t = _scope_from(main, init, step0)
    exe_t = fluid.Executor(fluid.CUDAPlace(0))
    win_losses = capture(exe_t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stat = exe_t.train_from_dataset(main, ds, scope=scope_t,
                                    fetch_list=[loss], steps_per_run=WIN_K,
                                    print_period=10 ** 9)
    tfd_ms = (time.perf_counter() - t0) * 1e3 / DS_BATCHES
    data_wait = reg.get("data_wait_seconds_total").value() - wait0
    runs.append(run_loop())
    launches = _launches()
    (loss_r, state_r, run_ms), (loss_r2, state_r2, run_ms2) = runs
    bound = 2 * max(_spread(state_r, state_r2).values(), default=0.0)
    loss_bound = 2 * float((loss_r - loss_r2).abs().max())
    state_t = _persistables(main, scope_t)
    tfd_diff = _spread(state_r, state_t)
    tfd_loss = torch.cat(win_losses)
    tfd_loss_diff = float((tfd_loss - loss_r).abs().max()) \
        if tfd_loss.numel() == loss_r.numel() else float("inf")

    # preemption: a real SIGTERM as window 3 starts
    mgr = fluid.CheckpointManager(str(d / "ckpt"), main_program=main,
                                  steps_per_run=WIN_K)
    scope_p = _scope_from(main, init, step0)
    exe_p = fluid.Executor(fluid.CUDAPlace(0))
    real, calls = exe_p.run_window, [0]

    def run_window(*a, **k):
        calls[0] += 1
        if calls[0] == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(*a, **k)
    exe_p.run_window = run_window
    ev0 = fluid.telemetry.step_events_recorded()
    preemption.install()
    try:
        pstat = exe_p.train_from_dataset(main, ds, scope=scope_p,
                                         steps_per_run=WIN_K,
                                         checkpoint_manager=mgr)
    finally:
        preemption.uninstall()
        preemption.clear()
    drains = [e for e in _events_since(ev0) if e.get("kind") == "preemption"]
    meta = fluid.checkpoint.checkpoint_metadata(mgr.latest_checkpoint())
    scope_r = fluid.Scope()
    fluid.CheckpointManager(str(d / "ckpt"), main_program=main,
                            steps_per_run=WIN_K).resume(scope=scope_r)
    resumed_step = scope_r.step_counter
    last = {k: np.stack([bt[k] for bt in batches[-WIN_K:]]) for k in batches[0]}
    fluid.Executor(fluid.CUDAPlace(0)).run_window(
        main, feed=last, fetch_list=[loss], scope=scope_r,
        steps_per_run=WIN_K)
    resume_diff = _spread(state_t, _persistables(main, scope_r))
    launches_after = _launches()
    emit(phase="dataset_train", card=_card(), lines=DS_BATCHES * DFM_BATCH,
         write_s=write_s, parse_s=parse_s,
         lines_parsed_per_s=DS_BATCHES * DFM_BATCH / parse_s,
         batchify_ms_per_batch=batchify_ms,
         batches=len(batches), k=WIN_K, status=stat,
         ms_per_step_train_from_dataset=tfd_ms,
         ms_per_step_exe_run=[run_ms, run_ms2],
         data_wait_seconds=data_wait, bound=bound, loss_bound=loss_bound,
         tfd_vs_run=dict(persistables_differ=len(tfd_diff),
                         persistables_max_diff=max(tfd_diff.values(),
                                                   default=0.0),
                         loss_max_diff=tfd_loss_diff),
         preempted=pstat, drain_ms=drains[0]["dur_ns"] / 1e6 if drains
         else None, checkpoint_step=meta["step"],
         checkpoint_steps_per_run=meta["steps_per_run"],
         resumed_step=resumed_step,
         resumed_vs_unbroken_max_diff=max(resume_diff.values(), default=0.0),
         launches=launches)
    shutil.rmtree(d, ignore_errors=True)
    checks = {
        "status": stat == {"steps": DS_BATCHES, "preempted": False,
                           "rollbacks": 0},
        "losses_finite": bool(torch.isfinite(loss_r).all()),
        "tfd_equals_run": max(tfd_diff.values(), default=0.0) <= bound and
            tfd_loss_diff <= loss_bound,
        "no_port_kernel": not any(launches.values()) and
            not any(launches_after.values()),
        "preempted_at_12": pstat == {"steps": 12, "preempted": True,
                                     "rollbacks": 0},
        "final_save_committed": meta["step"] == step0 + 12 and
            meta["steps_per_run"] == WIN_K and len(drains) == 1 and
            drains[0]["saved"],
        "resumed_run_equals_unbroken": resumed_step == step0 + 12 and
            max(resume_diff.values(), default=0.0) <= bound,
        "handlers_restored": signal.getsignal(signal.SIGTERM) is not
            preemption._handler,
    }
    _fail_unless("dataset_train", checks)
    return launches


def phase_watchdog_stall():
    """The watchdog (timeout_s=2, abort=False) armed over BERT-base
    pretraining (phase_train's configuration): one normal window with an
    explicit feed gives no record; then a program-bound
    DataLoader(steps_per_run=4) whose generator stalls once for 5 s
    before its second window gives exactly one kind="hang" record,
    naming the consumer's feed_wait phase."""
    from paddle_tpu_torch.fluid import watchdog
    cfg = bert.base_config(attn_dropout=0.0)
    main, startup, out = _build_pretrain(cfg)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    feeds = [_train_feed(cfg, BT, SEED + 100 + i) for i in range(WIN_BATCHES)]
    stacked = {k: np.stack([feeds[i][k] for i in range(WIN_K)])
               for k in feeds[0]}
    with fluid.program_guard(main):
        loader = fluid.io.DataLoader.from_generator(
            feed_list=_feed_vars(main, list(feeds[0])), capacity=2,
            iterable=False, steps_per_run=WIN_K)

    def gen():
        for i in range(2 * WIN_K):
            if i == WIN_K:
                time.sleep(STALL_S)
            yield feeds[i % WIN_BATCHES]
    loader.set_batch_generator(gen, places=fluid.CUDAPlace(0))
    ev0 = fluid.telemetry.step_events_recorded()
    assert watchdog.arm(timeout_s=STALL_TIMEOUT_S, abort=False)
    try:
        exe.run_window(main, feed=stacked, fetch_list=[out["loss"]],
                       scope=scope, steps_per_run=WIN_K)
        torch.cuda.synchronize()
        normal = [e for e in _events_since(ev0) if e.get("kind") == "hang"]
        ev1 = fluid.telemetry.step_events_recorded()
        loader.start()
        t0 = time.perf_counter()
        windows = 0
        while True:
            try:
                exe.run(main, fetch_list=[out["loss"]], scope=scope,
                        return_numpy=False)
                windows += 1
            except fluid.core.EOFException:
                break
        torch.cuda.synchronize()
        stall_wall_s = time.perf_counter() - t0
        hangs = [e for e in _events_since(ev1) if e.get("kind") == "hang"]
        healthy = watchdog.health()["healthy"]
    finally:
        watchdog.disarm()
    emit(phase="watchdog_stall", timeout_s=STALL_TIMEOUT_S, stall_s=STALL_S,
         windows=windows, wall_s=stall_wall_s,
         hangs=[{k: h.get(k) for k in ("phase", "age_s", "budget_s")}
                for h in hangs], hangs_normal_window=len(normal),
         healthy_after=healthy)
    _fail_unless("watchdog_stall", {
        "none_over_a_normal_window": not normal,
        "one_hang": len(hangs) == 1,
        "names_the_feed_phase": bool(hangs) and
            hangs[0]["phase"] == "feed_wait",
        "two_windows": windows == 2,
    })


# ---------------------------------------------------------------------------
# Data parallel: each rank a child of the port's launcher
# ---------------------------------------------------------------------------

DP_TWO_ROWS = 16              # dp_two_ranks: rows per rank (2 x 16 = BT)
DP_TWO_STEPS = 3
DP_TWO_LOSS_RTOL = 1e-4       # mean of the ranks' losses vs one process
DP_TWO_PARAM_TOL = 1e-3       # parameters, relative L2 (or 2 x a spread)


def _host_params(main, scope):
    """{parameter: a host copy} of ``main``'s parameters in ``scope``."""
    return {p.name: scope.find_var(p.name).detach().to("cpu", copy=True)
            for p in main.global_block().all_parameters()}


def _free_port():
    return _free_ports(1)[0]


def _free_ports(n):
    """``n`` distinct free loopback ports: every socket stays bound until
    all are picked, so no port is handed out twice."""
    import socket
    with contextlib.ExitStack() as stack:
        socks = [stack.enter_context(socket.socket()) for _ in range(n)]
        for sk in socks:
            sk.bind(("127.0.0.1", 0))
        return [sk.getsockname()[1] for sk in socks]


def _launch_ranks(mode, devices, d, timeout=900):
    """Run this script's ``dp_child <mode> <d>`` as one rank per entry of
    ``devices`` under ``python -m paddle_tpu_torch.distributed.launch``;
    returns (each rank's JSON, wall seconds)."""
    _err, wall = _launch(mode, devices, d, timeout=timeout)
    return [json.loads((d / ("rank%d.json" % r)).read_text())
            for r in range(len(devices))], wall


def _launch(mode, devices, d, extra=(), timeout=900):
    """Run ``dp_child <mode> <d>`` under the launcher (``extra``: more
    launcher arguments); returns (the launcher's stderr, wall seconds),
    and raises SystemExit with the logs when it exits non-zero.  On a
    timeout the launcher gets SIGTERM, which it forwards to every rank
    (SIGKILL after its grace period), so no child outlives the phase."""
    here = Path(__file__).resolve().parent
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(here)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--selected_devices", ",".join(map(str, devices)),
           "--coordinator", "127.0.0.1:%d" % _free_port(),
           "--log_dir", str(d / "logs"), "--grace_period", "10", *extra,
           str(Path(__file__).resolve()), "dp_child", mode, str(d)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, cwd=str(here),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.terminate()
        out, err = proc.communicate(timeout=60)
        err += "\n(timed out after %d s)" % timeout
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        logs = [(d / "logs" / ("workerlog.%d" % r)).read_text()[-4000:]
                for r in range(len(devices))
                if (d / "logs" / ("workerlog.%d" % r)).exists()]
        raise SystemExit("%s: the launcher exited %s\n%s\n%s" % (
            mode, proc.returncode, err[-3000:], "\n".join(logs)))
    return err, wall


def _nccl_profile(exe, prog, feed, fetch, scope):
    """One profiled step: wall ms, kernel ms and the NCCL kernels' ms."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exe.run(prog, feed=feed, fetch_list=fetch, scope=scope,
                return_numpy=False)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    nccl = [e for e in kern if "nccl" in e.key.lower()]
    return dict(wall_ms=wall,
                kernel_ms=sum(e.self_device_time_total for e in kern) / 1e3,
                nccl_ms=sum(e.self_device_time_total for e in nccl) / 1e3,
                nccl_kernels=sorted({e.key[:60] for e in nccl}))


def _comm_per_step(steps):
    """Collective bytes of the last ``steps`` dispatches' step events."""
    from paddle_tpu_torch.fluid import telemetry
    ev = telemetry.step_events()[-steps:]
    return dict(bytes=[e["comm_bytes"] for e in ev],
                by=ev[-1]["comm_by"] if ev else None,
                buckets=[e["comm_buckets"] for e in ev])


def _rank_feed(feed, rank, rows=DP_TWO_ROWS):
    """Rank ``rank``'s rows of a pretraining batch, its masked positions
    re-based onto its own rows."""
    S_ = feed["src_ids"].shape[1]
    r0 = rank * rows
    out = {k: feed[k][r0:r0 + rows] for k in
           ("src_ids", "pos_ids", "sent_ids", "input_mask", "nsp_label")}
    p0 = r0 * MAX_PRED
    out["mask_pos"] = feed["mask_pos"][p0:p0 + rows * MAX_PRED] - r0 * S_
    out["mask_label"] = feed["mask_label"][p0:p0 + rows * MAX_PRED]
    return out


def _digest(tensors):
    """One int64 per tensor: the sum of its float32 bits, so two ranks
    whose tensors differ in any bit almost surely differ here."""
    return [int(t.detach().float().view(torch.int32).sum(dtype=torch.int64))
            for t in tensors]


def _child_world(backend):
    from paddle_tpu_torch.fluid import distributed as dist
    from paddle_tpu_torch.fluid.incubate.fleet.base import role_maker
    from paddle_tpu_torch.fluid.incubate.fleet.collective import fleet
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, n = dist.init(backend=backend)
    fleet.init(role_maker.PaddleCloudRoleMaker(is_collective=True))
    exe = fluid.Executor(fluid.CUDAPlace(dist.local_device_index()))
    return rank, n, fleet, exe


def _child_train(d, mode):
    """A rank of dp_train (NCCL, one rank, phase train's batch) or of
    dp_two_ranks (gloo, dropout off, its rows of the batch): BERT-base
    through fleet.distributed_optimizer from phase train's initial
    parameters."""
    from paddle_tpu_torch.fluid.ops import collective_ops
    two = mode == "two_ranks"
    rank, n, fleet, exe = _child_world("gloo" if two else "nccl")
    cfg = bert.base_config(attn_dropout=0.0, **(
        dict(hidden_dropout=0.0) if two else {}))
    main, startup, out = _build_pretrain(cfg, fleet.distributed_optimizer(
        fluid.optimizer.AdamOptimizer(learning_rate=TRAIN_LR)))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    for name, t in torch.load(d / "init.pt").items():
        scope.set_var(name, t.to(exe.device))
    feed = dict(np.load(d / "feed.npz"))
    if two:
        feed = _rank_feed(feed, rank)
    ops = [op.type for op in main.global_block().ops]
    res = dict(rank=rank, world=n,
               backend=torch.distributed.get_backend(),
               buckets=ops.count("c_allreduce_sum"))
    collective_ops.reset_calls()
    # the main path's run: counts go to 0 here and are read after it
    _reset_launches()
    if two:
        losses, digests = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DP_TWO_STEPS):
            losses.append(float(exe.run(main, feed=feed,
                                        fetch_list=[out["loss"]],
                                        scope=scope)[0].reshape(-1)[0]))
            params = [scope.find_var(p.name) for p in
                      main.global_block().all_parameters()]
            digests.append(_digest(params))
        torch.cuda.synchronize()
        res.update(ms_per_step=(time.perf_counter() - t0) * 1e3 /
                   DP_TWO_STEPS, digests=digests)
        steps = DP_TWO_STEPS
    else:
        got, step_ms = _train_steps(exe, main, [feed], [out["loss"]], scope)
        losses = [float(g[0].item()) for g in got]
        steps = len(got)
        res.update(ms_per_step=step_ms)
    res.update(losses=losses, launches=_launches(),
               calls=dict(collective_ops.calls),
               comm=_comm_per_step(steps))
    if rank == 0:
        torch.save(_host_params(main, scope), d / "final.pt")
    if two:
        # hidden dropout as BERT draws it: ranks fold their rank into
        # the seed, so their masks differ
        dmain = fluid.Program()
        dmain.random_seed = SEED
        with fluid.program_guard(dmain, fluid.Program()):
            x = fluid.layers.data(name="x", shape=[768], dtype="float32")
            y = fluid.layers.dropout(x, dropout_prob=0.1)
        mask = exe.run(dmain, feed={"x": np.ones((8, 768), np.float32)},
                       fetch_list=[y], scope=fluid.Scope())[0] == 0
        res["dropout_mask"] = hashlib.sha1(np.packbits(mask)).hexdigest()
        res["dropout_kept"] = float(1 - mask.mean())
    else:
        res["profile"] = _nccl_profile(exe, main, feed, [out["loss"]], scope)
        # the plain program in this process, for the step time alone
        pmain, pstartup, pout = _build_pretrain(cfg)
        res["plain_ms_per_step"] = _plain_ms(
            exe, pmain, pstartup, pout["loss"], feed, d / "init.pt")
    return res


def _plain_ms(exe, main, startup, loss, feed, init_path):
    """ms per timed step of ``main`` (no collectives) from the state in
    ``init_path``, in the calling rank's process."""
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    for name, t in torch.load(init_path).items():
        scope.set_var(name, t.to(exe.device))
    return _train_steps(exe, main, [feed], [loss], scope)[1]


def _child_resnet(d):
    """The rank of dp_resnet: bench_resnet's program (FLAGS_conv_pallas=1)
    through CompiledProgram.with_data_parallel with sync batch norm, from
    resnet_train's startup weights, on one rank over NCCL."""
    from paddle_tpu_torch.fluid import flags
    from paddle_tpu_torch.fluid.ops import collective_ops
    rank, n, _fleet, exe = _child_world("nccl")
    flags.set_flag("conv_pallas", True)
    main, startup, loss = _resnet_program()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    for name, t in torch.load(d / "init.pt").items():
        scope.set_var(name, t.to(exe.device))
    bs = fluid.BuildStrategy()
    bs.sync_batch_norm = True
    compiled = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, build_strategy=bs)
    feed = {k: torch.from_numpy(v).to(exe.device)
            for k, v in _resnet_feed(RN_BATCH, SEED).items()}
    collective_ops.reset_calls()
    # the main path's run: counts go to 0 here and are read after it
    _reset_launches()
    got, step_ms = _train_steps(exe, compiled, [feed], [loss], scope)
    launches = _launches()
    k1_variants = dict(conv3x3_bn_relu.launches_by_variant)
    calls = dict(collective_ops.calls)
    ops = [op.type for op in compiled._dp[1].global_block().ops]
    comm = _comm_per_step(len(got))
    profile = _nccl_profile(exe, compiled, feed, [loss], scope)
    return dict(rank=rank, world=n, backend=torch.distributed.get_backend(),
                losses=[float(g[0].float().item()) for g in got],
                ms_per_step=step_ms, launches=launches,
                k1_launches_by_variant=k1_variants,
                sync_batch_norm=ops.count("sync_batch_norm"),
                batch_norm=ops.count("batch_norm"),
                buckets=ops.count("c_allreduce_sum"),
                calls=calls, comm=comm, profile=profile,
                plain_ms_per_step=_plain_ms(exe, main, startup, loss, feed,
                                            d / "init.pt"))


def dp_child(mode, d):
    d = Path(d)
    child = {"resnet": _child_resnet, "wus": _child_wus,
             "sharded": _child_sharded, "elastic": _child_elastic,
             "mp_bert": _child_mp_bert,
             "pp_mp_bert": _child_pp_mp_bert}.get(mode)
    res = child(d) if child else _child_train(d, mode)
    name = res.pop("file", "rank%d.json" % res["rank"])
    (d / name).write_text(json.dumps(res))
    from paddle_tpu_torch.fluid import distributed as dist
    dist.shutdown()
    return 0


def _params_equal(a, b):
    return all(torch.equal(a[n], b[n]) for n in b)


def _max_diff(a, b):
    return {n: float((a[n].double() - b[n].double()).abs().max()) for n in b}


def phase_dp_train(train):
    """BERT-base as phase train runs it, through fleet.distributed_optimizer
    (fused GradAllReduce, 32 MB buckets) as one rank of an NCCL world
    under the launcher, from train's initial parameters and batch: the
    losses and parameters after the 6 steps bit-equal to train's, or
    within twice the spread of two plain runs."""
    d = _io_dir("dp_train")
    torch.save(train["init"], d / "init.pt")
    np.savez(d / "feed.npz", **train["feed"])
    torch.cuda.empty_cache()
    (r,), wall = _launch_ranks("train", [0], d)
    final = torch.load(d / "final.pt")
    steps = len(r["losses"])
    launches = r["launches"]
    held, spread = _held_to_train(train, r["losses"], final)
    L = 12
    checks = {
        "backend_nccl": r["backend"] == "nccl",
        "world_of_one": r["world"] == 1,
        "allreduce_calls_equal_buckets": r["calls"].get(
            "c_allreduce_sum") == r["buckets"] * steps,
        "k2_k3_k4_12_per_step": all(launches[k] == L * steps for k in (
            "flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv")),
        "k5_0": launches["flash_attention_bwd_dbias"] == 0,
        "matches_train": held in ("bit_equal", "spread"),
    }
    emit(phase="dp_train", seconds=wall, steps=steps, losses=r["losses"],
         ms_per_step=r["ms_per_step"], train_ms_per_step=train["ms_per_step"],
         ratio_to_train=r["ms_per_step"] / train["ms_per_step"],
         plain_ms_per_step_same_process=r["plain_ms_per_step"],
         ratio_to_plain_same_process=r["ms_per_step"] /
         r["plain_ms_per_step"],
         backend=r["backend"], buckets=r["buckets"], calls=r["calls"],
         calls_per_step={k: v / steps for k, v in r["calls"].items()},
         comm_bytes_per_step=r["comm"]["bytes"], comm_by=r["comm"]["by"],
         profile=r["profile"], launches=launches, held=held, spread=spread,
         checks=checks)
    _fail_unless("dp_train", checks)
    shutil.rmtree(d, ignore_errors=True)
    return launches


def phase_dp_two_ranks(train):
    """BERT-base with all dropout off as two ranks on card 0 over gloo
    (--selected_devices 0,0), 16 rows each, 3 steps, against one process
    on the 32 rows: the mean of the ranks' losses within 1e-4, the
    parameters within 1e-3 relative L2 (or twice the spread of the one
    process fed its rows in the other order), the ranks' parameters
    bit-equal after every step, and two ranks' dropout masks different."""
    d = _io_dir("dp_two_ranks")
    torch.save(train["init"], d / "init.pt")
    np.savez(d / "feed.npz", **train["feed"])
    torch.cuda.empty_cache()
    ranks, wall = _launch_ranks("two_ranks", [0, 0], d)
    final = torch.load(d / "final.pt")

    cfg = bert.base_config(hidden_dropout=0.0, attn_dropout=0.0)
    main, startup, out = _build_pretrain(cfg)
    exe = fluid.Executor(fluid.CUDAPlace(0))

    def one_process(feed):
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        for name, t in train["init"].items():
            scope.set_var(name, t.to("cuda"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [float(exe.run(main, feed=feed, fetch_list=[out["loss"]],
                                scope=scope)[0].reshape(-1)[0])
                  for _ in range(DP_TWO_STEPS)]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / DP_TWO_STEPS
        return losses, _host_params(main, scope), ms

    def l2(a, b):
        num = sum(float(((a[n].double() - b[n].double()) ** 2).sum())
                  for n in b)
        den = sum(float((b[n].double() ** 2).sum()) for n in b)
        return math.sqrt(num / den)

    ref_losses, ref, ref_ms = one_process(train["feed"])
    mean = [(a + b) / 2 for a, b in zip(ranks[0]["losses"],
                                        ranks[1]["losses"])]
    loss_err = max(abs(m - w) / abs(w) for m, w in zip(mean, ref_losses))
    param_err = l2(final, ref)
    bound = DP_TWO_PARAM_TOL
    spread = None
    if param_err > bound:
        swapped = {k: np.concatenate([_rank_feed(train["feed"], 1)[k],
                                      _rank_feed(train["feed"], 0)[k] +
                                      (DP_TWO_ROWS * cfg.max_seq_len
                                       if k == "mask_pos" else 0)])
                   for k in train["feed"]}
        _l, other, _ms = one_process(swapped)
        spread = l2(other, ref)
        bound = max(bound, 2 * spread)
    checks = {
        "backend_gloo": all(r["backend"] == "gloo" for r in ranks),
        "two_ranks": [r["rank"] for r in ranks] == [0, 1],
        "losses_match_one_process": loss_err <= DP_TWO_LOSS_RTOL,
        "params_match_one_process": param_err <= bound,
        "ranks_bit_equal_every_step":
            ranks[0]["digests"] == ranks[1]["digests"],
        "dropout_masks_differ": ranks[0]["dropout_mask"] !=
            ranks[1]["dropout_mask"],
        "allreduce_calls_equal_buckets": all(
            r["calls"].get("c_allreduce_sum") == r["buckets"] * DP_TWO_STEPS
            for r in ranks),
    }
    emit(phase="dp_two_ranks", seconds=wall,
         losses=[r["losses"] for r in ranks], mean_losses=mean,
         one_process_losses=ref_losses, loss_rel_err=loss_err,
         param_l2_rel_err=param_err, param_bound=bound, spread=spread,
         ms_per_step=[r["ms_per_step"] for r in ranks],
         one_process_ms_per_step=ref_ms, buckets=ranks[0]["buckets"],
         calls=ranks[0]["calls"],
         comm_bytes_per_step=ranks[0]["comm"]["bytes"],
         dropout_kept=[r["dropout_kept"] for r in ranks],
         launches=ranks[0]["launches"], checks=checks)
    _fail_unless("dp_two_ranks", checks)
    shutil.rmtree(d, ignore_errors=True)
    return ranks[0]["launches"]


def phase_dp_resnet(resnet_run):
    """bench_resnet's program through CompiledProgram.with_data_parallel
    with BuildStrategy.sync_batch_norm on one NCCL rank, from
    resnet_train's startup weights: 53 sync_batch_norm ops with one
    all-reduce each, 13 wgmma K1 a step, and each loss within
    resnet_check's bound (RN_LOSS_RTOL) of resnet_train's."""
    d = _io_dir("dp_resnet")
    torch.save({n: t.detach().cpu()
                for n, t in resnet_run["init"].vars.items()}, d / "init.pt")
    torch.cuda.empty_cache()
    (r,), wall = _launch_ranks("resnet", [0], d)
    steps = len(r["losses"])
    want = resnet_run["losses"]
    loss_err = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(r["losses"], want))
    launches = r["launches"]
    checks = {
        "backend_nccl": r["backend"] == "nccl",
        "sync_batch_norm_53": r["sync_batch_norm"] == 53 and
            r["batch_norm"] == 0,
        "k1_13_per_step": launches["conv3x3_bn_relu"] == 13 * steps,
        "k1_all_wgmma": r["k1_launches_by_variant"]["wgmma"] == 13 * steps,
        "losses_match_resnet_train": loss_err <= RN_LOSS_RTOL,
        "allreduce_calls_equal_buckets": r["calls"].get(
            "c_allreduce_sum") == r["buckets"] * steps,
        "one_allreduce_per_sync_batch_norm": r["calls"].get(
            "sync_batch_norm") == r["sync_batch_norm"] * steps,
    }
    emit(phase="dp_resnet", seconds=wall, steps=steps, losses=r["losses"],
         resnet_train_losses=want, loss_rel_err=loss_err,
         bit_equal=r["losses"] == want, ms_per_step=r["ms_per_step"],
         resnet_train_ms_per_step=resnet_run["ms_per_step"],
         ratio_to_resnet_train=r["ms_per_step"] / resnet_run["ms_per_step"],
         plain_ms_per_step_same_process=r["plain_ms_per_step"],
         ratio_to_plain_same_process=r["ms_per_step"] /
         r["plain_ms_per_step"],
         sync_batch_norm=r["sync_batch_norm"], buckets=r["buckets"],
         calls_per_step={k: v / steps for k, v in r["calls"].items()},
         comm_bytes_per_step=r["comm"]["bytes"], comm_by=r["comm"]["by"],
         profile=r["profile"], launches=launches, checks=checks)
    _fail_unless("dp_resnet", checks)
    shutil.rmtree(d, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# The rest of data parallel: weight-update sharding, the int8 wire,
# hierarchical allreduce, pod checkpoints and the elastic shrink
# ---------------------------------------------------------------------------

# int8 wire with error feedback against fp32, each step's loss: the
# bound tests/test_torch_weight_update_sharding.py derives and holds
# (one quantization step of 1/127 of a block's largest value, twice)
INT8_LOSS_RTOL = 2.0 / 127
SHARD_ROWS = 16               # dp_two_ranks_sharded: NMT rows per rank
EL_LAYERS = 2                 # elastic_shrink: NMT base widths, 2 + 2 layers
EL_ROWS, EL_TOTAL, EL_PERIOD, EL_KILL_AT = 8, 9, 3, 6


def _nmt_init(cfg):
    """Host copies of the startup parameters of ``cfg``'s NMT program
    (seeded): every run of a data-parallel NMT phase starts from them."""
    main, startup, _o = _nmt_program(cfg)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    return _host_params(main, scope)


def _nmt_dp_run(exe, cfg, init, feed, kw, rank, n, steps=None):
    """``cfg``'s NMT program (pure bf16), transpiled by GradAllReduce(**kw)
    for a world of ``n`` unless ``kw`` is None, from ``init``: the main
    path's run (launch counts to 0 before it, read after).  ``steps``
    runs that many untimed steps instead of _train_steps' 2 + 4."""
    from paddle_tpu_torch.fluid import telemetry
    from paddle_tpu_torch.fluid.ops import collective_ops
    from paddle_tpu_torch.fluid.transpiler import GradAllReduce
    main, startup, out = _nmt_program(cfg)
    if kw is not None:
        GradAllReduce(**kw).transpile(startup_program=startup,
                                      main_program=main, rank=rank,
                                      endpoints=["e"] * n, nranks=n)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    for name, t in init.items():
        scope.set_var(name, t.to(exe.device))
    collective_ops.reset_calls()
    _reset_launches()
    if steps is None:
        got, ms = _train_steps(exe, main, [feed], [out["loss"]], scope)
        losses = [float(g[0].float().item()) for g in got]
        digests = None
    else:
        losses, digests = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            losses.append(float(exe.run(main, feed=feed,
                                        fetch_list=[out["loss"]],
                                        scope=scope)[0].reshape(-1)[0]))
            digests.append(_digest(scope.find_var(p.name) for p in
                                   main.global_block().all_parameters()))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / steps
    ev = telemetry.step_events()[-1]
    ops = [op.type for op in main.global_block().ops]
    return dict(losses=losses, ms_per_step=ms, launches=_launches(),
                calls=dict(collective_ops.calls), digests=digests,
                opt_state_bytes=ev["opt_state_bytes"], comm_by=ev["comm_by"],
                comm_bytes=ev["comm_bytes"],
                buckets=ops.count("c_reducescatter") or
                ops.count("c_allreduce_sum"),
                shard_shapes={v: list(scope.find_var(v).shape)
                              for v in sorted(main._dp_sharded_state)},
                padded={v: [int(b), int(main.global_block().var(v).shape[0])]
                        for v, b in sorted(main._wus_padded_numel.items())},
                params=_host_params(main, scope))


def _bert_fleet_run(exe, fleet, d, cfg, feed, steps, kw):
    """BERT-base (``cfg``: train's widths) through
    fleet.distributed_optimizer(DistributedStrategy(**kw)) from train's
    initial parameters: (losses, per-step digests, launches, collective
    bytes of the last step, ms per step)."""
    from paddle_tpu_torch.fluid.incubate.fleet.collective import \
        DistributedStrategy
    from paddle_tpu_torch.fluid.ops import collective_ops
    main, startup, out = _build_pretrain(cfg, fleet.distributed_optimizer(
        fluid.optimizer.AdamOptimizer(learning_rate=TRAIN_LR),
        DistributedStrategy(**kw)))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    for name, t in torch.load(d / "init.pt").items():
        scope.set_var(name, t.to(exe.device))
    collective_ops.reset_calls()
    _reset_launches()
    losses, digests = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(float(exe.run(main, feed=feed, fetch_list=[
            out["loss"]], scope=scope)[0].reshape(-1)[0]))
        digests.append(_digest(scope.find_var(p.name) for p in
                               main.global_block().all_parameters()))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    return dict(losses=losses, digests=digests, launches=_launches(),
                calls=dict(collective_ops.calls), ms_per_step=ms,
                comm=_comm_per_step(1))


def _child_wus(d):
    """The rank of dp_wus: one NCCL rank.  NMT base (nmt_train_flash's
    configuration) plain twice, then through GradAllReduce(
    weight_update_sharding=True) in fp32 (the main path) and on the int8
    wire; BERT-base (train's configuration) through fleet on the int8
    wire, and fleet's weight-update sharding of BERT refused."""
    from paddle_tpu_torch.fluid.incubate.fleet.collective import \
        DistributedStrategy
    rank, n, fleet, exe = _child_world("nccl")
    cfg = _nmt_config()
    cfg.attn_dropout = 0.0
    init = _nmt_init(cfg)
    feed = _nmt_feed(cfg, NMT_BATCH, np.random.RandomState(SEED),
                     ragged=True)
    res = dict(rank=rank, world=n, backend=torch.distributed.get_backend())
    for tag, kw in (("plain", None), ("plain2", None),
                    ("wus", dict(weight_update_sharding=True)),
                    ("wus8", dict(weight_update_sharding=True,
                                  allreduce_precision="int8"))):
        r = _nmt_dp_run(exe, cfg, init, feed, kw, rank, n)
        torch.save(r.pop("params"), d / ("%s.pt" % tag))
        res[tag] = r
    bcfg = bert.base_config(attn_dropout=0.0)
    res["bert8"] = _bert_fleet_run(exe, fleet, d, bcfg,
                                   dict(np.load(d / "feed.npz")),
                                   WARM_STEPS + TIMED_STEPS,
                                   dict(allreduce_precision="int8"))
    try:
        _build_pretrain(bcfg, fleet.distributed_optimizer(
            fluid.optimizer.AdamOptimizer(learning_rate=TRAIN_LR),
            DistributedStrategy(weight_update_sharding=True)))
        res["bert_wus_refused"] = None
    except NotImplementedError as e:
        res["bert_wus_refused"] = str(e)
    return res


def _child_sharded(d):
    """A rank of dp_two_ranks_sharded (gloo, card 0): BERT-base as
    dp_two_ranks runs it through fleet, plain, on the int8 wire and with
    hierarchical allreduce (nnodes=2); NMT base with all dropout off,
    its rows of a 32-row batch, plain GradAllReduce, then sharded in fp32
    (the main path) and on the int8 wire."""
    rank, n, fleet, exe = _child_world("gloo")
    res = dict(rank=rank, world=n, backend=torch.distributed.get_backend())
    bcfg = bert.base_config(hidden_dropout=0.0, attn_dropout=0.0)
    bfeed = _rank_feed(dict(np.load(d / "feed.npz")), rank)
    for tag, kw in (("bert", {}), ("bert8", dict(allreduce_precision="int8")),
                    ("bert_hier", dict(
                        use_hierarchical_allreduce=True,
                        hierarchical_allreduce_inter_nranks=2))):
        res[tag] = _bert_fleet_run(exe, fleet, d, bcfg, bfeed, DP_TWO_STEPS,
                                   kw)
    cfg = _nmt_config(dropout=0.0)
    init = {k: v for k, v in torch.load(d / "nmt_init.pt").items()}
    whole = _nmt_feed(cfg, 2 * SHARD_ROWS, np.random.RandomState(SEED),
                      ragged=True)
    feed = {k: v[rank * SHARD_ROWS:(rank + 1) * SHARD_ROWS]
            for k, v in whole.items()}
    for tag, kw in (("nmt", {}),
                    ("nmt_wus", dict(weight_update_sharding=True)),
                    ("nmt_wus8", dict(weight_update_sharding=True,
                                      allreduce_precision="int8"))):
        r = _nmt_dp_run(exe, cfg, init, feed, kw, rank, n,
                        steps=DP_TWO_STEPS)
        r.pop("params")
        res[tag] = r
    return res


class _Batches:
    """The dataset elastic_shrink trains from: NMT batches ``start`` ..
    ``stop - 1`` (EL_ROWS rows each, seeded by the index, ragged masks),
    this rank's rows; ``on_batch(i)`` runs before batch i is handed out.
    train_from_dataset reads nothing else of a dataset."""

    def __init__(self, cfg, start, stop, rank, world, on_batch=None):
        self.cfg, self.start, self.stop = cfg, start, stop
        self.rank, self.world = rank, world
        self.on_batch = on_batch

    def set_thread(self, n):
        pass

    def _prepare_to_run(self):
        pass

    def _finish_to_run(self):
        pass

    def __iter__(self):
        for i in range(self.start, self.stop):
            if self.on_batch is not None:
                self.on_batch(i)
            yield _el_batch(self.cfg, i, self.rank, self.world)


def _el_batch(cfg, i, rank=0, world=1):
    feed = _nmt_feed(cfg, EL_ROWS, np.random.RandomState(1000 + i),
                     ragged=True)
    k = EL_ROWS // world
    return {n: v[rank * k:(rank + 1) * k].cpu().numpy()
            for n, v in feed.items()}


def _el_program(cfg, world):
    from paddle_tpu_torch.fluid.transpiler import GradAllReduce
    main, startup, out = _nmt_program(cfg)
    GradAllReduce(weight_update_sharding=True).transpile(
        startup_program=startup, main_program=main, rank=0,
        endpoints=["e"] * world, nranks=world)
    return main, startup, out


def _child_elastic(d):
    """A rank of elastic_shrink, in every incarnation of the pack: NMT
    base widths at 2 + 2 layers, weight-update sharding, through
    elastic.run_elastic and train_from_dataset(checkpoint_manager=) with
    async pod saves every EL_PERIOD steps.  In the first world (two gloo
    ranks on card 0), rank 1 SIGKILLs itself at batch EL_KILL_AT once a
    save has committed; the launcher relaunches a world of one, which
    reshard-restores and trains to EL_TOTAL, then saves."""
    import signal
    from paddle_tpu_torch.fluid import distributed as dist, elastic
    from paddle_tpu_torch.fluid.storage import (MARKER_NAME,
                                                ObjectStoreStorage)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    attempt, prev = elastic.world_env()
    if int(os.environ.get("PADDLE_TRAINERS_NUM", "1")) > 1:
        dist.init(backend="gloo")
    place = fluid.CUDAPlace(dist.local_device_index())
    exe = fluid.Executor(place)
    cfg = _nmt_config(num_layers=EL_LAYERS, dropout=0.0)
    init = torch.load(d / "init.pt")
    ckdir = d / "ck"
    log = dict(attempt=attempt, prev=prev)

    def build(ctx):
        main, startup, out = _el_program(cfg, ctx.process_count)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        for name, t in init.items():
            scope.set_var(name, t.to(exe.device))
        mgr = fluid.CheckpointManager(str(ckdir), main_program=main,
                                      place=place,
                                      storage=ObjectStoreStorage())
        build.loss = out["loss"]
        log.update(world=ctx.process_count, rank=ctx.process_index)
        latest = mgr.latest_checkpoint()
        if latest is not None:
            log["latest"] = os.path.basename(latest)
            log["dirs"] = {e: (ckdir / e / MARKER_NAME).is_file()
                           for e in sorted(os.listdir(ckdir))
                           if e.startswith("step-")}
        return mgr, scope, main

    def train(ctx):
        start = 0
        if ctx.restored is not None:
            start = ctx.scope.step_counter - 1
            log["restored"] = dict(step=ctx.restored["step"],
                                   path=ctx.restored["path"],
                                   resized=ctx.restored["resized"])
            torch.save({v.name: ctx.scope.find_var(v.name).detach().cpu()
                        for v in ctx.program.list_vars() if v.persistable},
                       d / ("restored_a%d.pt" % attempt))
            # the restore alone, timed into a scope of its own
            t0 = time.perf_counter()
            ctx.manager.restore(ctx.restored["path"], scope=fluid.Scope(),
                                main_program=ctx.program, reshard=True)
            torch.cuda.synchronize()
            log["restore_s"] = time.perf_counter() - t0
        progress = d / ("progress_a%d_r%d.jsonl" % (attempt,
                                                    ctx.process_index))

        def on_batch(i):
            m = ctx.manager
            with open(progress, "a") as f:
                f.write(json.dumps(dict(
                    batch=i, last_step=m.last_step, saves=m.saves,
                    snapshot_ms=m.last_snapshot_ms, save_s=m.last_save_s,
                    bytes=m.last_bytes)) + "\n")
            if attempt == 0 and ctx.process_index == 1 and i == EL_KILL_AT:
                m.wait()
                if m.last_step is not None:
                    os.kill(os.getpid(), signal.SIGKILL)

        # the main path's run: counts go to 0 here and are read after it
        _reset_launches()
        status = exe.train_from_dataset(
            ctx.program, _Batches(cfg, start, EL_TOTAL, ctx.process_index,
                                  ctx.process_count, on_batch),
            scope=ctx.scope, fetch_list=[build.loss], print_period=10 ** 9,
            checkpoint_manager=ctx.manager, checkpoint_period=EL_PERIOD)
        log["launches"] = _launches()
        ctx.manager.wait()
        if ctx.manager.last_step != ctx.scope.step_counter:
            ctx.manager.save(scope=ctx.scope, main_program=ctx.program,
                             sync=True)
        log["status"] = status
        torch.save(_host_params(ctx.program, ctx.scope),
                   d / ("final_a%d.pt" % attempt))
        return status

    status = elastic.run_elastic(build, train)
    from paddle_tpu_torch.fluid import telemetry
    resize = [e for e in telemetry.step_events() if e.get("kind") == "resize"]
    log.update(status={k: v for k, v in status.items() if k != "last"},
               resize=resize[-1] if resize else None,
               file="elastic_a%d_r%d.json" % (attempt, log["rank"]))
    return log


def phase_dp_wus(train):
    """NMT base as nmt_train_flash runs it, one NCCL rank under the
    launcher, through GradAllReduce(weight_update_sharding=True), 10
    steps from the same startup weights: losses and parameters bit-equal
    to the plain program's (or within twice the spread of two plain
    runs), 18 K2/K3/K4 a step, one reduce-scatter and one all-gather per
    bucket a step; the same on the int8 wire (through the quantizer at
    N = 1) with each loss within INT8_LOSS_RTOL of the plain run's; ms
    per step against the plain run's; the rank's optimizer-state bytes.
    BERT-base (train's configuration and batch) through fleet on the
    int8 wire, 6 steps: each loss within INT8_LOSS_RTOL of train's, 12
    K2/K3/K4 a step; its weight-update sharding refused (its word
    embedding is tied: a gradient summed from two contributions), as in
    the JAX package."""
    d = _io_dir("dp_wus")
    torch.save(train["init"], d / "init.pt")
    np.savez(d / "feed.npz", **train["feed"])
    torch.cuda.empty_cache()
    (r,), wall = _launch_ranks("wus", [0], d)
    plain, plain2, wus = (torch.load(d / ("%s.pt" % t)) for t in
                          ("plain", "plain2", "wus"))
    steps = len(r["wus"]["losses"])
    bit_equal = r["wus"]["losses"] == r["plain"]["losses"] and \
        _params_equal(wus, plain)
    spread = None
    held = "bit_equal"
    if not bit_equal:
        p_spread = _max_diff(plain2, plain)
        p_err = _max_diff(wus, plain)
        l_spread = max(abs(a - b) for a, b in zip(r["plain2"]["losses"],
                                                  r["plain"]["losses"]))
        l_err = max(abs(a - b) for a, b in zip(r["wus"]["losses"],
                                                r["plain"]["losses"]))
        held = "spread" if l_err <= 2 * l_spread and all(
            p_err[n] <= 2 * p_spread[n] for n in p_err) else "neither"
        spread = dict(loss_err=l_err, loss_spread=l_spread,
                      param_err_max=max(p_err.values()),
                      param_spread_max=max(p_spread.values()))
    n_attn = 3 * _nmt_config().num_layers

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))
    int8_err = rel(r["wus8"]["losses"], r["plain"]["losses"])
    bert8_err = rel(r["bert8"]["losses"], train["losses"])
    w, b8 = r["wus"], r["bert8"]
    checks = {
        "backend_nccl": r["backend"] == "nccl",
        "world_of_one": r["world"] == 1,
        "wus_matches_plain": held in ("bit_equal", "spread"),
        "k2_k3_k4_18_per_step": all(w["launches"][k] == n_attn * steps
                                    for k in ("flash_attention_fwd",
                                              "flash_attention_bwd_dq",
                                              "flash_attention_bwd_dkv")),
        "rs_ag_per_bucket": w["calls"].get("c_reducescatter") ==
            w["calls"].get("c_allgather") == w["buckets"] * steps,
        "int8_within_bound": int8_err <= INT8_LOSS_RTOL,
        "bert_int8_within_bound": bert8_err <= INT8_LOSS_RTOL,
        "bert_k2_k3_k4_12_per_step": all(
            b8["launches"][k] == bert.base_config().num_layers *
            len(b8["losses"]) for k in (
                "flash_attention_fwd", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkv")),
        "bert_wus_refused_as_jax": "word_embedding@GRAD@SUM" in (
            r["bert_wus_refused"] or ""),
    }
    emit(phase="dp_wus", card=_card(), seconds=wall, steps=steps,
         losses=w["losses"], plain_losses=r["plain"]["losses"], held=held,
         spread=spread, ms_per_step=w["ms_per_step"],
         plain_ms_per_step=[r["plain"]["ms_per_step"],
                            r["plain2"]["ms_per_step"]],
         ratio_to_plain=w["ms_per_step"] / min(r["plain"]["ms_per_step"],
                                               r["plain2"]["ms_per_step"]),
         int8_ms_per_step=r["wus8"]["ms_per_step"],
         int8_loss_max_rel_err=int8_err, int8_bound=INT8_LOSS_RTOL,
         opt_state_bytes=w["opt_state_bytes"],
         plain_opt_state_bytes=r["plain"]["opt_state_bytes"],
         buckets=w["buckets"], calls=w["calls"], comm_by=w["comm_by"],
         int8_comm_by=r["wus8"]["comm_by"], padded=w["padded"],
         bert_int8_losses=b8["losses"], bert_int8_loss_max_rel_err=bert8_err,
         bert_int8_ms_per_step=b8["ms_per_step"],
         bert_int8_comm=b8["comm"], bert_wus=r["bert_wus_refused"],
         launches=w["launches"], checks=checks)
    _fail_unless("dp_wus", checks)
    shutil.rmtree(d, ignore_errors=True)
    return w["launches"], b8["launches"]


def phase_dp_two_ranks_sharded(train):
    """Two gloo ranks on card 0 (--selected_devices 0,0).  BERT-base as
    dp_two_ranks runs it (dropout off, 16 rows each, 3 steps) through
    fleet: on the int8 wire each loss within INT8_LOSS_RTOL of the fp32
    run's, about a quarter of its wire bytes; with hierarchical
    allreduce (two nodes of one rank) bit-equal to it.  NMT base, dropout
    off, 16 rows each, 3 steps: GradAllReduce(weight_update_sharding=
    True) bit-equal to the plain GradAllReduce after every step, each
    rank holding half of the Adam moments (plus the bucket's pad) and
    about half the optimizer-state bytes; on the int8 wire each loss
    within INT8_LOSS_RTOL.  Wire bytes per precision."""
    d = _io_dir("dp_two_ranks_sharded")
    torch.save(train["init"], d / "init.pt")
    np.savez(d / "feed.npz", **train["feed"])
    torch.save(_nmt_init(_nmt_config(dropout=0.0)), d / "nmt_init.pt")
    torch.cuda.empty_cache()
    ranks, wall = _launch_ranks("sharded", [0, 0], d, timeout=1200)

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))
    r0, r1 = ranks
    n_attn = 3 * _nmt_config().num_layers
    bert_fp32 = r0["bert"]["comm"]["bytes"][-1]
    bert_int8 = r0["bert8"]["comm"]["bytes"][-1]
    nmt_fp32 = r0["nmt"]["comm_bytes"]
    nmt_wus8 = r0["nmt_wus8"]["comm_bytes"]
    shapes_ok = all(
        r["nmt_wus"]["shard_shapes"][v] == [r["nmt_wus"]["padded"][v][1] // 2]
        for r in ranks for v in r["nmt_wus"]["shard_shapes"])
    checks = {
        "backend_gloo": all(r["backend"] == "gloo" for r in ranks),
        "two_ranks": [r["rank"] for r in ranks] == [0, 1],
        "bert_int8_within_bound": all(
            rel(r["bert8"]["losses"], r["bert"]["losses"]) <= INT8_LOSS_RTOL
            for r in ranks),
        "bert_int8_about_a_quarter": 0.24 <= bert_int8 / bert_fp32 <= 0.30,
        "bert_hierarchical_bit_equal": all(
            r["bert_hier"]["digests"] == r["bert"]["digests"] and
            r["bert_hier"]["losses"] == r["bert"]["losses"] for r in ranks),
        "nmt_wus_bit_equal_every_step": all(
            r["nmt_wus"]["digests"] == r["nmt"]["digests"] for r in ranks),
        "ranks_bit_equal": r0["nmt_wus"]["digests"] ==
            r1["nmt_wus"]["digests"],
        "half_the_moments": shapes_ok,
        "about_half_the_state_bytes": all(
            r["nmt_wus"]["opt_state_bytes"] <=
            0.55 * r["nmt"]["opt_state_bytes"] for r in ranks),
        "nmt_int8_within_bound": all(
            rel(r["nmt_wus8"]["losses"], r["nmt"]["losses"]) <=
            INT8_LOSS_RTOL for r in ranks),
        "k2_k3_k4_18_per_step": all(
            r0["nmt_wus"]["launches"][k] == n_attn * DP_TWO_STEPS
            for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
                      "flash_attention_bwd_dkv")),
    }
    emit(phase="dp_two_ranks_sharded", card=_card(), seconds=wall,
         bert_losses=[r["bert"]["losses"] for r in ranks],
         bert_int8_losses=[r["bert8"]["losses"] for r in ranks],
         bert_hier_losses=[r["bert_hier"]["losses"] for r in ranks],
         bert_ms_per_step=[r["bert"]["ms_per_step"] for r in ranks],
         bert_int8_ms_per_step=[r["bert8"]["ms_per_step"] for r in ranks],
         bert_hier_ms_per_step=[r["bert_hier"]["ms_per_step"]
                                for r in ranks],
         wire_bytes_per_step=dict(bert_fp32=bert_fp32, bert_int8=bert_int8,
                                  bert_int8_ratio=bert_int8 / bert_fp32,
                                  bert_hier_by=r0["bert_hier"]["comm"]["by"],
                                  nmt_fp32=nmt_fp32,
                                  nmt_wus_fp32=r0["nmt_wus"]["comm_bytes"],
                                  nmt_wus_int8=nmt_wus8,
                                  nmt_int8_ratio=nmt_wus8 / nmt_fp32),
         nmt_losses=[r["nmt"]["losses"] for r in ranks],
         nmt_wus_losses=[r["nmt_wus"]["losses"] for r in ranks],
         nmt_int8_losses=[r["nmt_wus8"]["losses"] for r in ranks],
         nmt_ms_per_step=[r["nmt"]["ms_per_step"] for r in ranks],
         nmt_wus_ms_per_step=[r["nmt_wus"]["ms_per_step"] for r in ranks],
         opt_state_bytes=dict(plain=r0["nmt"]["opt_state_bytes"],
                              sharded=[r["nmt_wus"]["opt_state_bytes"]
                                       for r in ranks]),
         shard_shapes=r0["nmt_wus"]["shard_shapes"],
         padded=r0["nmt_wus"]["padded"],
         launches=r0["nmt_wus"]["launches"], checks=checks)
    _fail_unless("dp_two_ranks_sharded", checks)
    shutil.rmtree(d, ignore_errors=True)
    return r0["nmt_wus"]["launches"], r0["bert8"]["launches"]


def phase_elastic_shrink():
    """NMT base widths cut to 2 + 2 layers (dropout off, pure bf16),
    weight-update sharding with async pod saves every EL_PERIOD steps,
    through elastic.run_elastic and train_from_dataset(checkpoint_manager
    =), under ``launch --selected_devices 0,0 --max_restarts 1
    --elastic_min_nproc 1`` over gloo.  Rank 1 SIGKILLs itself at batch
    EL_KILL_AT once a save has committed; the launcher relaunches a world
    of one, which restores with reshard=True (degree 2 -> 1) and trains
    to batch EL_TOTAL: the restored parameters and moments bit-equal to
    the checkpoint's global values, the final parameters bit-equal to a
    world of one here that restores the same checkpoint and takes the
    same batches (or within twice the spread of two such runs), the
    newest committed step the one restored (a prefix without its marker
    never selected), a resize record with recovery_s; pod save ms,
    restore s."""
    from paddle_tpu_torch.fluid.checkpoint import (_load_manifest_entry,
                                                   read_manifest)
    d = _io_dir("elastic_shrink")
    cfg = _nmt_config(num_layers=EL_LAYERS, dropout=0.0)
    main1, startup1, out1 = _el_program(cfg, 1)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup1, scope=scope)
    torch.save(_host_params(main1, scope), d / "init.pt")
    torch.cuda.empty_cache()
    err, wall = _launch("elastic", [0, 0], d, extra=(
        "--max_restarts", "1", "--elastic_min_nproc", "1"), timeout=900)
    a1 = json.loads((d / "elastic_a1_r0.json").read_text())
    path = a1["restored"]["path"]
    body = read_manifest(path)
    saved = {n: _load_manifest_entry(path, n, e)
             for n, e in body["tensors"].items()}
    restored = torch.load(d / "restored_a1.pt")

    def host(t):
        t = t.detach().cpu()
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()
    restored_equal = all(
        np.array_equal(host(t)[:main1._wus_padded_numel.get(n, t.numel())],
                       saved[n][:main1._wus_padded_numel.get(n, t.numel())])
        for n, t in restored.items() if n in saved)

    def control():
        cscope = fluid.Scope()
        exe.run(startup1, scope=cscope)
        fluid.CheckpointManager(str(d / "ck"), place=fluid.CUDAPlace(0)) \
            .restore(path, scope=cscope, main_program=main1, reshard=True)
        for i in range(a1["restored"]["step"] - 1, EL_TOTAL):
            exe.run(main1, feed=_el_batch(cfg, i), fetch_list=[out1["loss"]],
                    scope=cscope, return_numpy=False)
        torch.cuda.synchronize()
        return _host_params(main1, cscope)
    final = torch.load(d / "final_a1.pt")
    want = control()
    held, spread = "bit_equal", None
    if not _params_equal(final, want):
        again = control()
        p_spread, p_err = _max_diff(again, want), _max_diff(final, want)
        held = "spread" if all(p_err[n] <= 2 * p_spread[n]
                               for n in p_err) else "neither"
        spread = dict(param_err_max=max(p_err.values()),
                      param_spread_max=max(p_spread.values()))
    committed = sorted((int(e.split("-")[1]), e)
                       for e, marked in a1["dirs"].items() if marked)
    pod = {}
    for r in range(2):
        f = d / ("progress_a0_r%d.jsonl" % r)
        if f.exists():
            for p in map(json.loads, f.read_text().splitlines()):
                if p["snapshot_ms"] is not None:
                    # one entry per rank and save (its snapshot), as
                    # last seen before the kill
                    pod[(r, p["snapshot_ms"])] = p
    pod = [dict(p, rank=r) for (r, _s), p in sorted(pod.items())]
    steps = EL_TOTAL - (a1["restored"]["step"] - 1)
    launches = a1["launches"]
    checks = {
        "relaunched_world_of_one": "world 2 -> 1" in err and
            (a1["attempt"], a1["prev"], a1["world"]) == (1, 2, 1),
        "resharded_2_to_1": a1["restored"]["resized"] and
            a1["resize"] is not None and
            (a1["resize"]["old_degree"], a1["resize"]["new_degree"]) ==
            (2, 1),
        "restored_bit_equal_to_checkpoint": restored_equal,
        "final_matches_world_of_one": held in ("bit_equal", "spread"),
        "newest_committed_restored": bool(committed) and
            a1["latest"] == committed[-1][1] and
            a1["restored"]["step"] == committed[-1][0],
        "trained_to_the_end": a1["status"]["preempted"] is False and
            a1["status"]["resizes"] == 1,
        "k2_k3_k4_6_per_step": all(launches[k] == 3 * EL_LAYERS * steps
                                   for k in ("flash_attention_fwd",
                                             "flash_attention_bwd_dq",
                                             "flash_attention_bwd_dkv")),
    }
    emit(phase="elastic_shrink", card=_card(), seconds=wall,
         layers="%d + %d (cut from 6 + 6)" % (EL_LAYERS, EL_LAYERS),
         restored_step=a1["restored"]["step"], steps_after=steps,
         committed=[c[1] for c in committed], dirs=a1["dirs"],
         pod_saves=[{k: p[k] for k in ("rank", "snapshot_ms", "save_s",
                                       "bytes", "last_step")} for p in pod],
         restore_s=a1["restore_s"], recovery_s=a1["resize"]["recovery_s"],
         held=held, spread=spread, launches=launches,
         relaunch_log=[x for x in err.splitlines() if "relaunch" in x],
         checks=checks)
    _fail_unless("elastic_shrink", checks)
    shutil.rmtree(d, ignore_errors=True)
    return launches



BOOK_STEPS = 8                # book_train: 2 warm-up + 6 timed steps
BOOK_FEEDS = 4                # distinct batches of each program, in turn
BOOK_CHECK_BATCH = {          # book_check: the CNNs' CPU side stays cheap
    "image_classification_resnet": 16, "image_classification_vgg": 16}
BOOK_LOSS_RTOL = 1e-4         # step-1 loss, card vs CPU
BOOK_GRAD_L2 = 1e-2           # step-1 gradients, card vs CPU, relative L2:
                              # max(this, 2 x (card + cpu spread) / |g|)
BOOK_PARAM_FLOOR = 1e-6       # parameters after step 1 less each side's
                              # step, card vs CPU: max(2 x (card spread
                              # + cpu spread), this)
BOOK_NCE_RTOL = 1e-5          # nce's loss vs its formula on the samples


def _book_program(name, cfg, decode=False):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = book.build_decode(cfg) if decode else book.build(name, cfg)
    return main, startup, out


def _book_feeds(name, cfg, n):
    """The first ``n`` batches of ``name``'s dataset, as numpy feeds."""
    it = book.feeds(name, cfg)
    return [next(it) for _ in range(n)]


def _cuda_feed(feed):
    return {k: torch.from_numpy(v).cuda() for k, v in feed.items()}


def phase_book_train():
    """The reference's book models (Fluid 1.5 tests/book/) through
    Executor on the card at the reference tests' widths
    (``book.base_config``): each program's startup, then BOOK_STEPS
    steps (2 warm-up) over its dataset's first BOOK_FEEDS batches in
    turn: finite losses, no port kernel launched (none lies on these
    paths); ms per step, one profiled step's kernel launches and busy
    share, peak memory.  After machine_translation, its beam decode
    from the trained weights.  Returns ({path: launches}, the trained
    machine-translation scope)."""
    t_phase = time.perf_counter()
    by_path, mt, card = {}, None, _card()
    for name in book.NAMES:
        t_prog = time.perf_counter()
        cfg = book.base_config(name)
        main, startup, out = _book_program(name, cfg)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup, scope=scope)
        feeds = [_cuda_feed(f)
                 for f in _book_feeds(name, cfg, BOOK_FEEDS)]
        fetch = [out["loss"]]
        torch.cuda.reset_peak_memory_stats()
        # the main path's run: counts go to 0 here and are read after it
        _reset_launches()
        losses = []
        for i in range(BOOK_STEPS):
            if i == 2:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            losses.append(exe.run(main, feed=feeds[i % BOOK_FEEDS],
                                  fetch_list=fetch, scope=scope,
                                  return_numpy=False)[0])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / (BOOK_STEPS - 2) * 1e3
        launches = _launches()
        losses = [float(v.reshape(-1)[0].item()) for v in losses]
        prof, _ = _profile_record(exe, main, feeds[0], fetch, scope)
        del prof["top_kernels"]
        checks = {"losses_finite": bool(np.isfinite(losses).all()),
                  "no_port_kernel": not any(launches.values())}
        emit(phase="book_train", program=name, card=card, config=cfg,
             steps=BOOK_STEPS, losses=losses, ms_per_step=step_ms,
             peak_device_mb=torch.cuda.max_memory_allocated() / 2**20,
             profiled_step=prof, launches=launches, checks=checks,
             seconds=time.perf_counter() - t_prog)
        _fail_unless("book_train " + name, checks)
        by_path["book_" + name] = launches
        if name == "machine_translation":
            mt = (main, scope)
            by_path["book_mt_decode"] = _book_decode(cfg, main, scope)
    emit(phase="book_train_total", seconds=time.perf_counter() - t_phase)
    return by_path, mt


def _book_decode(cfg, train_main, scope):
    """machine_translation's beam decode on the card from the trained
    weights in ``scope``: SentenceIds [B, beam, T] inside the vocabulary,
    finite scores sorted best first; ms per decode.  Returns its port
    kernel launches (none)."""
    main, _, out = _book_program(None, cfg, decode=True)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    feed = _book_feeds("machine_translation", cfg, 1)[0]
    feed = _cuda_feed({k: feed[k] for k in out["feeds"]})
    _reset_launches()
    ids, scores = exe.run(main, feed=feed, fetch_list=out["outs"],
                          scope=scope)
    launches = _launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        exe.run(main, feed=feed, fetch_list=out["outs"], scope=scope,
                return_numpy=False)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 5 * 1e3
    checks = {
        "ids_shape": ids.shape == (cfg["batch"], cfg["beam"], cfg["t_trg"]),
        "ids_in_vocabulary": bool((ids >= 0).all() and
                                  (ids < cfg["dict"]).all()),
        "scores_finite": bool(np.isfinite(scores).all()),
        "scores_sorted": bool((np.diff(scores, axis=1) <= 1e-5).all()),
        "no_port_kernel": not any(launches.values())}
    emit(phase="book_mt_decode", card=_card(), ms_per_decode=ms,
         beam=cfg["beam"], max_len=cfg["t_trg"], sentence_ids_head=
         ids[:2].tolist(), launches=launches, checks=checks)
    _fail_unless("book_mt_decode", checks)
    return launches


def _book_step(exe, main, loss, state, feed, fetch=(), grads=False):
    """One step of ``main`` on a copy of ``state`` on ``exe``'s device:
    ([loss, *fetch] as numpy, {parameter: value after the step} and,
    with ``grads``, {parameter: its step gradient}), as float64 tensors
    on the host."""
    scope = _state_copy(main, state, exe.device)
    params = [p.name for p in main.global_block().all_parameters()]
    gnames = [main._grad_name_map[n] for n in params] if grads else []
    got = exe.run(main, feed=feed, fetch_list=[loss] + list(fetch) + gnames,
                  scope=scope)
    got = [np.asarray(g) for g in got]
    head, tail = got[:1 + len(fetch)], got[1 + len(fetch):]
    after = {n: scope.find_var(n).double().cpu() for n in params}
    if not grads:
        return head, after
    return head, after, {n: torch.from_numpy(g).double()
                         for n, g in zip(params, tail)}


def _step1_update(main, rate, grads):
    """Each parameter's first step as its optimizer op computes it from
    the gradient ``grads[n]`` (float64): SGD ``−lr·g``; Adam from zero
    moments and beta powers ``β``, ``−lr·sqrt(1−β2)/(1−β1)·(1−β1)·g /
    (sqrt((1−β2)·g²) + eps)``, the op's own attributes."""
    opt = {op.input("Param")[0]: op for op in main.global_block().ops
           if op.type in ("sgd", "adam")}
    out = {}
    for n, g in grads.items():
        op, lr = opt[n], rate[n]
        if op.type == "sgd":
            out[n] = -lr * g
            continue
        b1, b2, eps = (float(np.float32(op.attr(a))) for a in
                       ("beta1", "beta2", "epsilon"))
        lr_t = lr * math.sqrt(1 - b2) / (1 - b1)
        out[n] = -lr_t * (1 - b1) * g / (torch.sqrt((1 - b2) * g * g) + eps)
    return out


def _book_check_one(name, cfg):
    """Step 1 of ``name`` from its startup weights on the card (twice,
    then with the batch's examples reversed) and on the port's CPU path
    (as fed and reversed).  A side's spread is how far its runs lie
    apart, tensor by tensor.  The loss within BOOK_LOSS_RTOL; each
    parameter's gradient within max(BOOK_GRAD_L2, 2 x (card spread +
    CPU spread) / |g|) in relative L2: a value that lands within the
    devices' rounding of a kink (relu's 0, a max-pool tie) takes its
    gradient down the other side, which moves that entry by its whole
    size (label_semantic_roles' relu candidates: 1.2% of a bias's
    largest entry, 0.16% in L2).  Each parameter after the step within
    max(BOOK_PARAM_FLOOR, 2 x (card spread + CPU spread)) of the CPU's
    once each side's step from its own gradient (``_step1_update``) is
    taken out: Adam's first step ``lr·g/(|g| + 31.6·eps)`` turns a
    gradient entry near 0 that the two devices round apart into steps
    up to 2·lr apart, which the gradient check already holds.
    word2vec_nce draws its noise classes from each device's own
    generator: its card loss is held to the nce formula on the card's
    samples instead."""
    main, startup, out = _book_program(name, cfg)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    init = _state_copy(main, scope, "cpu")
    feed = _book_feeds(name, cfg, 1)[0]
    loss = out["loss"]
    if name == "word2vec_nce":
        op = [o for o in main.global_block().ops if o.type == "nce"][0]
        (lv, hidden, samples), _ = _book_step(
            exe, main, loss, init, feed,
            [op.input("Input")[0], op.output("SampleLabels")[0]])
        w = init.find_var(op.input("Weight")[0]).double().numpy()
        b = init.find_var(op.input("Bias")[0]).double().numpy()[:, 0]
        lab = feed["w%d" % (cfg["n"] - 1)][:, 0]
        x, k, C = hidden.astype(np.float64), cfg["neg"], w.shape[0]
        lt = (w[lab] * x).sum(-1) + b[lab]
        ln = (w[samples] * x[:, None, :]).sum(-1) + b[samples]
        want = (np.logaddexp(0, -(lt - np.log(k / C))) +
                np.logaddexp(0, ln - np.log(k / C)).sum(-1)).mean()
        err = float(abs(float(lv.reshape(-1)[0]) - want) / abs(want))
        return dict(loss_card=float(lv.reshape(-1)[0]),
                    loss_formula=float(want), loss_rel_err=err), {
                        "nce_formula": err <= BOOK_NCE_RTOL}
    rev = {k: np.ascontiguousarray(v[::-1]) for k, v in feed.items()}
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    runs = [_book_step(e, main, loss, init, f, grads=True) for e, f in (
        (exe, feed), (exe, feed), (exe, rev), (cpu_exe, feed),
        (cpu_exe, rev))]
    (c1,), p1, g1 = runs[0]
    (h1,), q1, k1 = runs[3]

    def spread(i, j, k):
        """Run i against run j (and j + 1 on the card): the largest
        entry of the difference for parameters (k = 1), its L2 norm for
        gradients (k = 2)."""
        def size(d):
            return float(d.norm() if k == 2 else d.abs().max())
        return {n: max(size(runs[i][k][n] - runs[j][k][n]),
                       size(runs[i][k][n] - runs[j + 1][k][n])
                       if j == 1 else 0.0) for n in p1}
    gs_card, gs_cpu = spread(0, 1, 2), spread(3, 4, 2)
    ps_card, ps_cpu = spread(0, 1, 1), spread(3, 4, 1)
    rate = {p.name: cfg["lr"] * p.optimize_attr["learning_rate"]
            for p in main.global_block().all_parameters()}
    step_card = _step1_update(main, rate, g1)
    step_cpu = _step1_update(main, rate, k1)
    g_over, p_over, g_err, p_err, r_err = {}, {}, {}, {}, {}
    for n in p1:
        norm = max(float(k1[n].norm()), 1e-30)
        gb = max(BOOK_GRAD_L2, 2 * (gs_card[n] + gs_cpu[n]) / norm)
        g_err[n] = float((g1[n] - k1[n]).norm()) / norm
        if g_err[n] > gb:
            g_over[n] = (g_err[n], gb)
        pb = max(BOOK_PARAM_FLOOR, 2 * (ps_card[n] + ps_cpu[n]))
        p_err[n] = float((p1[n] - q1[n]).abs().max())
        # what is left once each side's step from its own gradient is
        # taken out of the difference
        r_err[n] = float(((p1[n] - step_card[n]) -
                          (q1[n] - step_cpu[n])).abs().max())
        if r_err[n] > pb:
            p_over[n] = (r_err[n], pb)
    lc, lh = float(c1.reshape(-1)[0]), float(h1.reshape(-1)[0])
    loss_err = abs(lc - lh) / abs(lh)
    loss_spread = abs(lc - float(runs[2][0][0].reshape(-1)[0])) + \
        abs(lh - float(runs[4][0][0].reshape(-1)[0]))
    checks = {"loss_finite": bool(np.isfinite(lc)),
              "card_loss_matches_cpu": loss_err <= max(
                  BOOK_LOSS_RTOL, 2 * loss_spread / abs(lh)),
              "card_grads_match_cpu": not g_over,
              "card_params_match_cpu": not p_over}
    worst = sorted(g_err, key=lambda n: -g_err[n])[:3]
    return dict(loss_card=lc, loss_card_2=float(runs[1][0][0].reshape(-1)[0]),
                loss_cpu=lh, loss_rel_err=loss_err,
                card_runs_bit_equal=all(
                    float((p1[n] - runs[1][1][n]).abs().max()) == 0
                    for n in p1),
                grad_rel_l2_err_worst={n: g_err[n] for n in worst},
                param_max_abs_err=max(p_err.values()),
                param_residual_max_abs_err=max(r_err.values()),
                param_spread_card=max(ps_card.values()),
                param_spread_cpu=max(ps_cpu.values()),
                grads_over_bound=g_over, params_over_bound=p_over), checks


def phase_book_check(mt):
    """Each book program's step 1 on the card against the port's CPU
    path (``_book_check_one``), at the reference widths with the CNNs'
    batch cut to BOOK_CHECK_BATCH and VGG's dropouts left out (the two
    devices draw other masks); then the beam decode from the trained
    weights ``mt`` on the card and the CPU: SentenceIds equal, scores
    within max(1e-5 relative, 2 x the spread of each side's decode of
    the batch in reverse order)."""
    t_phase = time.perf_counter()
    ok, card = True, _card()
    for name in book.NAMES:
        t_prog = time.perf_counter()
        cfg = book.base_config(name)
        if name in BOOK_CHECK_BATCH:
            cfg["batch"] = BOOK_CHECK_BATCH[name]
        if "dropout" in cfg:
            cfg["dropout"] = False
        report, checks = _book_check_one(name, cfg)
        report["seconds"] = time.perf_counter() - t_prog
        emit(phase="book_check", program=name, card=card, batch=
             cfg["batch"], tolerance="loss rel %g (or 2 x the reversed-"
             "batch spreads); each gradient |card - cpu| / |cpu| (L2) <= "
             "max(%g, 2 x (card spread + cpu spread) / |cpu|); each "
             "parameter max|(card - its step) - (cpu - its step)| <= "
             "max(2 x (card spread + cpu spread), %g), a side's step the "
             "optimizer's step-1 formula on its own gradient; card "
             "spread: the larger of "
             "card against card again and against the reversed batch; "
             "cpu spread: cpu against the reversed batch; tensor by tensor"
             % (BOOK_LOSS_RTOL, BOOK_GRAD_L2, BOOK_PARAM_FLOOR),
             checks=checks, **report)
        ok = ok and all(checks.values())
        if not all(checks.values()):
            print("book_check %s failed: %s" % (
                name, [k for k, v in checks.items() if not v]), flush=True)
    checks = _book_decode_check(*mt)
    emit(phase="book_check_total", seconds=time.perf_counter() - t_phase)
    _fail_unless("book_check", dict(programs=ok, decode=all(checks.values())))


def _book_decode_check(train_main, scope):
    cfg = book.base_config("machine_translation")
    main, _, out = _book_program(None, cfg, decode=True)
    feed = _book_feeds("machine_translation", cfg, 1)[0]
    feed = {k: feed[k] for k in out["feeds"]}
    rev = {k: np.ascontiguousarray(v[::-1]) for k, v in feed.items()}
    runs = {}
    for dev, exe in (("card", fluid.Executor(fluid.CUDAPlace(0))),
                     ("cpu", fluid.Executor(fluid.CPUPlace()))):
        state = _state_copy(train_main, scope, exe.device)
        for key, f in (("", feed), ("_rev", rev)):
            ids, sc = exe.run(main, feed=f, fetch_list=out["outs"],
                              scope=state)
            if key:
                ids, sc = ids[::-1], sc[::-1]
            runs[dev + key] = (np.asarray(ids), np.asarray(sc, np.float64))
    ids_c, sc_c = runs["card"]
    ids_h, sc_h = runs["cpu"]
    spread = np.abs(runs["card_rev"][1] - sc_c).max() + \
        np.abs(runs["cpu_rev"][1] - sc_h).max()
    spread = float(spread)
    bound = max(1e-5 * float(np.abs(sc_h).max()), 2 * spread)
    err = float(np.abs(sc_c - sc_h).max())
    checks = {"sentence_ids_equal": bool((ids_c == ids_h).all()),
              "scores_match": err <= bound}
    emit(phase="book_check_decode", card=_card(), batch=cfg["batch"],
         beam=cfg["beam"], rows_differing=int(
             (ids_c != ids_h).reshape(len(ids_c), -1).any(1).sum()),
         score_max_abs_err=err, score_spread=spread, score_bound=bound,
         checks=checks)
    return checks


# ---------------------------------------------------------------------------
# The rest of the training surface: recompute, gradient merge, dynamic loss
# scaling (BERT-base), and the wrapper optimizers (DeepFM)
# ---------------------------------------------------------------------------

GM_K = 4                      # bert_gradient_merge: micro-batches per apply
GM_ROWS = BT // GM_K          # ... of 8 of phase train's 32 rows
GM_STEPS = 2 * GM_K           # ... micro-steps: two applies
GM_ACC_L2 = 1e-5              # averaged accumulation vs the 32-row gradient
GM_PARAM_FLOOR = 1e-6         # parameters after the apply vs one plain step,
#                               net of each side's Adam step: max(2 x the
#                               plain step's spread, this)
AMP_STEPS = 5                 # bert_amp_dynamic
AMP_BAD_STEP = 3              # ... fed an input_mask holding one inf
AMP_SCALING = dict(init_loss_scaling=2.0 ** 15, use_dynamic_loss_scaling=True,
                   incr_every_n_steps=2, decr_every_n_nan_or_inf=1)
WRAP_DECAY = 0.9              # wrappers: ExponentialMovingAverage's decay
WRAP_CLOSED_RTOL = 1e-5       # applied values vs their closed form, of the
#                               tensor's largest entry


class _EncoderCheckpoints:
    """An optimizer stand-in for build_pretrain: RecomputeOptimizer over
    ``inner`` with each encoder layer's post-FFN layer_norm output as a
    checkpoint, picked from the loss's program (the embedding's
    layer_norm comes first, then two a layer)."""

    def __init__(self, inner, layers):
        self.inner, self.layers = inner, layers

    def minimize(self, loss):
        lns = [op.output("Y")[0] for op in
               loss.block.program.global_block().ops
               if op.type == "layer_norm"]
        opt = fluid.optimizer.RecomputeOptimizer(self.inner)
        opt._set_checkpoints(lns[2:2 * self.layers + 1:2])
        return opt.minimize(loss)


def _bert_state(main, startup, init):
    """(executor, scope) on the card holding ``main``'s startup state
    with the parameters ``init`` (host tensors) loaded."""
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    for name, t in init.items():
        scope.set_var(name, t.to("cuda"))
    return exe, scope


def _held_to_train(train, losses, final):
    """How ``losses`` and the parameters ``final`` of a run from phase
    train's initial state and batch hold against train's: "bit_equal",
    else "spread" when within twice the spread of a second plain run from
    the same state, else "neither"; (held, the spread's report)."""
    if losses == train["losses"] and _params_equal(final, train["final"]):
        return "bit_equal", None
    main, startup, out = _build_pretrain(bert.base_config(attn_dropout=0.0))
    exe, scope = _bert_state(main, startup, train["init"])
    got, _ms = _train_steps(exe, main, [train["feed"]], [out["loss"]], scope)
    again = _host_params(main, scope)
    del exe, scope
    torch.cuda.empty_cache()
    p_spread = _max_diff(again, train["final"])
    l_spread = max(abs(float(g[0].item()) - w)
                   for g, w in zip(got, train["losses"]))
    p_err = _max_diff(final, train["final"])
    l_err = max(abs(a - b) for a, b in zip(losses, train["losses"]))
    held = "spread" if l_err <= 2 * l_spread and all(
        p_err[n] <= 2 * p_spread[n] for n in p_err) else "neither"
    return held, dict(loss_err=l_err, loss_spread=l_spread,
                      param_err_max=max(p_err.values()),
                      param_spread_max=max(p_spread.values()))


def _bert_recompute(train):
    """bert_recompute: phase train's program (hidden dropout 0.1) with
    RecomputeOptimizer over its Adam, the 12 post-FFN layer_norm outputs
    as checkpoints, from train's initial parameters and batch: 2 warm-up
    and 4 timed steps, after the same of the plain program."""
    cfg = bert.base_config(attn_dropout=0.0)
    L = cfg.num_layers
    # the plain program first, timed in this phase too: the two step
    # times are compared within one phase (host time drifts across them)
    pmain, pstartup, pout = _build_pretrain(cfg)
    pexe, pscope = _bert_state(pmain, pstartup, train["init"])
    _pgot, plain_ms = _train_steps(pexe, pmain, [train["feed"]],
                                   [pout["loss"]], pscope)
    del pexe, pscope, _pgot
    main, startup, out = _build_pretrain(cfg, _EncoderCheckpoints(
        fluid.optimizer.AdamOptimizer(learning_rate=TRAIN_LR), L))
    ops = [op.type for op in main.global_block().ops]
    exe, scope = _bert_state(main, startup, train["init"])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_mb = torch.cuda.memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    # the main path's run: counts go to 0 here and are read after it
    _reset_launches()
    got, step_ms = _train_steps(exe, main, [train["feed"]], [out["loss"]],
                                scope)
    launches = _launches()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    losses = [float(g[0].item()) for g in got]
    final = _host_params(main, scope)
    steps = len(got)
    rec, _prof = _profile_record(exe, main, train["feed"], [out["loss"]],
                                 scope)
    del exe, scope, _prof
    torch.cuda.empty_cache()
    held, spread = _held_to_train(train, losses, final)
    per_step = {n: c / steps for n, c in launches.items()}
    checks = {
        "one_recompute_op_a_layer": ops.count("recompute") == L and
        ops.count("recompute_grad") == L,
        "losses_finite": bool(np.isfinite(losses).all()),
        "k2_24_per_step": launches["flash_attention_fwd"] == 2 * L * steps,
        "k3_k4_12_per_step": all(launches[n] == L * steps for n in (
            "flash_attention_bwd_dq", "flash_attention_bwd_dkv")),
        "k5_0": launches["flash_attention_bwd_dbias"] == 0,
        "matches_train": held in ("bit_equal", "spread"),
        "peak_below_train": peak_mb < train["peak_mb"],
    }
    emit(phase="bert_recompute", card=_card(), steps=steps, losses=losses,
         ms_per_step=step_ms, train_ms_per_step=train["ms_per_step"],
         ratio_to_train=step_ms / train["ms_per_step"],
         plain_ms_per_step_same_phase=plain_ms,
         ratio_to_plain_same_phase=step_ms / plain_ms,
         peak_device_mb=peak_mb, train_peak_device_mb=train["peak_mb"],
         allocated_before_mb=base_mb,
         train_allocated_before_mb=train["base_mb"],
         launches=launches, launches_per_step=per_step, held=held,
         spread=spread, profile=rec, checks=checks)
    _fail_unless("bert_recompute", checks)
    return launches


def _gm_acc_names(main):
    """{parameter: its *_gm_acc accumulator}: the ``elementwise_add`` that
    adds the parameter's gradient into the accumulator in place."""
    grad_of = {g: p for p, g in main._grad_name_map.items()}
    out = {}
    for op in main.global_block().ops:
        if op.type == "elementwise_add" and "_gm_acc" in op.input("X")[0] \
                and op.input("X") == op.output("Out"):
            out[grad_of[op.input("Y")[0]]] = op.input("X")[0]
    return out


def _bert_gradient_merge(train):
    """bert_gradient_merge: BERT-base with all dropout off through
    GradientMergeOptimizer(Adam, k_steps=GM_K) from phase train's initial
    parameters, train's 32 rows fed as GM_K micro-batches of GM_ROWS in
    turn, GM_STEPS micro-steps (two applies); then two more profiled
    micro-steps, a non-apply and an apply one (after two unprofiled)."""
    cfg = bert.base_config(attn_dropout=0.0, hidden_dropout=0.0)
    L = cfg.num_layers
    main, startup, out = _build_pretrain(cfg, fluid.optimizer
                                         .GradientMergeOptimizer(
                                             fluid.optimizer.AdamOptimizer(
                                                 learning_rate=TRAIN_LR),
                                             k_steps=GM_K))
    params = [p.name for p in main.global_block().all_parameters()]
    accs = _gm_acc_names(main)
    grads = [main._grad_name_map[n] for n in params]
    micro = [_rank_feed(train["feed"], i, GM_ROWS) for i in range(GM_K)]
    exe, scope = _bert_state(main, startup, train["init"])
    applied = {n: scope.find_var(n).clone() for n in params}
    kernels = ("flash_attention_fwd", "flash_attention_bwd_dq",
               "flash_attention_bwd_dkv")
    losses, step_ms, step_launches, unchanged = [], [], [], []
    syncs0 = fluid.profiler.host_sync_count("conditional_block")
    # the main path's run: counts go to 0 here and are read after it
    _reset_launches()
    for s in range(GM_STEPS):
        apply = (s + 1) % GM_K == 0
        last_of_first = s == GM_K - 1
        if last_of_first:
            acc3 = {n: scope.find_var(accs[n]).clone() for n in params}
        before = _launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = exe.run(main, feed=micro[s % GM_K], fetch_list=[out["loss"]] +
                      (grads if last_of_first else []), scope=scope,
                      return_numpy=False)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        after = _launches()
        step_launches.append({n: after[n] - before[n] for n in after})
        losses.append(float(got[0].reshape(-1)[0].item()))
        if last_of_first:
            g4 = dict(zip(params, got[1:]))
        cur = {n: scope.find_var(n) for n in params}
        if apply:
            applied = {n: cur[n].clone() for n in params}
            if last_of_first:
                first_apply = {n: cur[n].detach().double().cpu()
                               for n in params}
        else:
            unchanged.append(all(torch.equal(cur[n], applied[n])
                                 for n in params))
    launches = _launches()
    syncs = fluid.profiler.host_sync_count("conditional_block") - syncs0
    # two more micro-steps profiled: a non-apply one, then an apply one
    prof = {}
    for s in range(GM_STEPS, GM_STEPS + GM_K):
        if s % GM_K in (0, GM_K - 1):
            rec, _p = _profile_record(exe, main, micro[s % GM_K],
                                      [out["loss"]], scope)
            prof["apply" if s % GM_K == GM_K - 1 else "non_apply"] = rec
            del _p
        else:
            exe.run(main, feed=micro[s % GM_K], fetch_list=[out["loss"]],
                    scope=scope, return_numpy=False)
    # the averaged accumulation the first apply used, (acc after GM_K - 1
    # micro-steps + the last micro-batch's gradient) / GM_K, against the
    # gradient of the 32 rows at the same (unchanged) weights
    avg = {n: (acc3[n].double() + g4[n].double()) / GM_K for n in params}
    del acc3, g4, applied, cur, exe, scope
    torch.cuda.empty_cache()
    gmain, gstartup, gout = _build_pretrain(cfg, _GradsOnly())
    gexe, gscope = _bert_state(gmain, gstartup, train["init"])
    full = dict(zip(params, gexe.run(
        gmain, feed=train["feed"], fetch_list=[gmain._grad_name_map[n]
                                               for n in params],
        scope=gscope, return_numpy=False)))
    del gexe, gscope
    num = sum(float((avg[n] - full[n].double()).norm() ** 2) for n in params)
    den = sum(float(full[n].double().norm() ** 2) for n in params)
    acc_l2 = math.sqrt(num / den)
    per_param = {n: float((avg[n] - full[n].double()).norm() /
                          max(float(full[n].double().norm()), 1e-30))
                 for n in params}
    worst = sorted(per_param, key=lambda n: -per_param[n])[:3]
    avg = {n: t.cpu() for n, t in avg.items()}
    del full
    torch.cuda.empty_cache()
    # one plain Adam step on the 32 rows, twice (its spread), with its
    # gradients; each side's parameters less its own first Adam step
    pmain, pstartup, pout = _build_pretrain(cfg)
    plain = []
    for _ in range(2):
        pexe, pscope = _bert_state(pmain, pstartup, train["init"])
        got = pexe.run(pmain, feed=train["feed"],
                       fetch_list=[pmain._grad_name_map[n] for n in params],
                       scope=pscope, return_numpy=False)
        plain.append(({n: pscope.find_var(n).detach().double().cpu()
                       for n in params},
                      {n: g.detach().double().cpu()
                       for n, g in zip(params, got)}))
        del pexe, pscope, got
        torch.cuda.empty_cache()
    rate = {n: TRAIN_LR for n in params}
    step_gm = _step1_update(pmain, rate, avg)
    step_plain = _step1_update(pmain, rate, plain[0][1])
    init = {n: train["init"][n].double() for n in params}
    spread = max(float((plain[0][0][n] - plain[1][0][n]).abs().max())
                 for n in params)
    bound = max(2 * spread, GM_PARAM_FLOOR)
    resid = {n: float(((first_apply[n] - init[n] - step_gm[n]) -
                       (plain[0][0][n] - init[n] - step_plain[n]))
                      .abs().max()) for n in params}
    raw = max(float((first_apply[n] - plain[0][0][n]).abs().max())
              for n in params)
    apply_ms = [step_ms[s] for s in range(GM_STEPS) if (s + 1) % GM_K == 0]
    plain_ms = [step_ms[s] for s in range(1, GM_STEPS)
                if (s + 1) % GM_K != 0]
    checks = {
        "losses_finite": bool(np.isfinite(losses).all()),
        "params_unchanged_between_applies": len(unchanged) ==
        GM_STEPS - 2 and all(unchanged),
        "averaged_accumulation_matches_32_rows": acc_l2 <= GM_ACC_L2,
        "apply_matches_one_plain_step": max(resid.values()) <= bound,
        "k2_k3_k4_12_per_micro_step": all(
            sl[k] == L for sl in step_launches for k in kernels),
        "k5_0": launches["flash_attention_bwd_dbias"] == 0,
        "one_predicate_sync_per_micro_step": syncs == GM_STEPS,
    }
    emit(phase="bert_gradient_merge", card=_card(), k_steps=GM_K,
         micro_rows=GM_ROWS, micro_steps=GM_STEPS, losses=losses,
         ms_per_micro_step=step_ms, non_apply_ms_mean=float(
             np.mean(plain_ms)), apply_ms_mean=float(np.mean(apply_ms)),
         train_ms_per_step=train["ms_per_step"],
         acc_rel_l2=acc_l2, acc_rel_l2_worst={n: per_param[n]
                                              for n in worst},
         param_residual_max=max(resid.values()), param_bound=bound,
         plain_step_spread=spread, param_max_abs_diff_raw=raw,
         predicate_syncs=syncs, launches=launches,
         launches_per_micro_step=step_launches[0], profile=prof,
         checks=checks)
    _fail_unless("bert_gradient_merge", checks)
    return launches


def _amp_closed_form(n_steps, bad_step, init, incr_every, decr_every,
                     incr=2.0, decr=0.8):
    """The loss scale after each step by update_loss_scaling's rule in
    float32: good steps counted to incr_every multiply by incr, bad ones
    to decr_every by decr, never below 1."""
    scale, good, bad, out = np.float32(init), 0, 0, []
    for s in range(1, n_steps + 1):
        good, bad = (0, bad + 1) if s == bad_step else (good + 1, 0)
        if good >= incr_every:
            scale, good = np.float32(scale * np.float32(incr)), 0
        if bad >= decr_every:
            scale, bad = np.float32(scale * np.float32(decr)), 0
        scale = max(scale, np.float32(1.0))
        out.append(float(scale))
    return out


def _bert_amp_dynamic(train):
    """bert_amp_dynamic: phase train's BERT-base in pure bf16 with
    dynamic loss scaling over Adam (AMP_SCALING), from train's initial
    parameters and batch, AMP_STEPS steps, step AMP_BAD_STEP fed an
    input_mask holding one inf; then one profiled step beside the same
    program without loss scaling, for the launches the gate adds."""
    cfg = bert.base_config(attn_dropout=0.0)
    L = cfg.num_layers
    opt = fluid.contrib.mixed_precision.decorate(
        fluid.optimizer.AdamOptimizer(learning_rate=TRAIN_LR),
        use_pure_bf16=True, **AMP_SCALING)
    main, startup, out = _build_pretrain(cfg, opt)
    scale = opt.get_loss_scaling().name
    ops = main.global_block().ops
    gated = [op.output("Out")[0] for op in ops if op.type == "where"]
    feed = train["feed"]
    bad = dict(feed)
    bad["input_mask"] = feed["input_mask"].copy()
    bad["input_mask"][0, 3, 0] = np.inf
    exe, scope = _bert_state(main, startup, train["init"])
    losses, scales, zero, step_launches = [], [], None, []
    # the main path's run: counts go to 0 here and are read after it
    _reset_launches()
    for s in range(1, AMP_STEPS + 1):
        before = _launches()
        got = exe.run(main, feed=bad if s == AMP_BAD_STEP else feed,
                      fetch_list=[out["loss"]] +
                      (gated if s == AMP_BAD_STEP else []),
                      scope=scope, return_numpy=False)
        losses.append(float(got[0].reshape(-1)[0].item()))
        if s == AMP_BAD_STEP:
            zero = all(bool((g == 0).all()) for g in got[1:])
        scales.append(float(scope.find_var(scale).reshape(-1)[0].item()))
        after = _launches()
        step_launches.append({n: after[n] - before[n] for n in after})
    launches = _launches()
    want = _amp_closed_form(AMP_STEPS, AMP_BAD_STEP,
                            AMP_SCALING["init_loss_scaling"],
                            AMP_SCALING["incr_every_n_steps"],
                            AMP_SCALING["decr_every_n_nan_or_inf"])
    rec, _p = _profile_record(exe, main, feed, [out["loss"]], scope)
    del exe, scope, _p
    torch.cuda.empty_cache()
    # the same program without loss scaling: what the gate adds
    popt = fluid.contrib.mixed_precision.decorate(
        fluid.optimizer.AdamOptimizer(learning_rate=TRAIN_LR),
        use_pure_bf16=True)
    pmain, pstartup, pout = _build_pretrain(cfg, popt)
    pexe, pscope = _bert_state(pmain, pstartup, train["init"])
    for _ in range(2):
        pexe.run(pmain, feed=feed, fetch_list=[pout["loss"]], scope=pscope,
                 return_numpy=False)
    prec, _p = _profile_record(pexe, pmain, feed, [pout["loss"]], pscope)
    del pexe, pscope, _p
    torch.cuda.empty_cache()
    kernels = ("flash_attention_fwd", "flash_attention_bwd_dq",
               "flash_attention_bwd_dkv")
    gate_ops = len(ops) - len(pmain.global_block().ops)
    checks = {
        "scale_is_closed_form": scales == want,
        "bad_step_gradients_zero": bool(zero),
        "bad_step_loss_not_finite": not np.isfinite(
            losses[AMP_BAD_STEP - 1]),
        "later_losses_finite": bool(np.isfinite(
            losses[AMP_BAD_STEP:]).all()),
        "earlier_losses_finite": bool(np.isfinite(
            losses[:AMP_BAD_STEP - 1]).all()),
        "k2_k3_k4_12_per_step": all(sl[k] == L for sl in step_launches
                                    for k in kernels),
        "k5_0": launches["flash_attention_bwd_dbias"] == 0,
    }
    emit(phase="bert_amp_dynamic", card=_card(), steps=AMP_STEPS,
         bad_step=AMP_BAD_STEP, losses=losses, loss_scale=scales,
         loss_scale_closed_form=want, gated_gradients=len(gated),
         gate_ops=gate_ops, launches=launches,
         profile=rec, profile_without_scaling=prec,
         gate_launch_calls=rec["launch_calls"] - prec["launch_calls"],
         gate_wall_ms=rec["wall_ms"] - prec["wall_ms"], checks=checks)
    _fail_unless("bert_amp_dynamic", checks)
    return launches


def phase_train_surface(train):
    """BERT-base through the rest of the training surface, each part
    from phase train's initial parameters and batch: recompute
    (bert_recompute), gradient merge (bert_gradient_merge) and dynamic
    loss scaling (bert_amp_dynamic).  {path: its kernel launches}."""
    t0 = time.perf_counter()
    paths = {"bert_recompute": _bert_recompute(train),
             "bert_gradient_merge": _bert_gradient_merge(train),
             "bert_amp_dynamic": _bert_amp_dynamic(train)}
    emit(phase="train_surface", seconds=time.perf_counter() - t0)
    return paths


class _AfterMinimize:
    """An optimizer stand-in for ``_dfm_program``: ``inner``'s minimize,
    then ``then()`` in the same program build (EMA's ``update``,
    ModelAverage's construction); ``handle`` keeps what ``then`` gives."""

    def __init__(self, inner, then):
        self.inner, self.then, self.handle = inner, then, None

    def minimize(self, loss):
        got = self.inner.minimize(loss)
        self.handle = self.then()
        return got


class _ProximalOptimizer(fluid.optimizer.Optimizer):
    """A program built by hand (no optimizer class of either package
    appends these ops): ``proximal_adagrad`` on DeepFM's two tables (a
    moment started at 0.1: a row no example looks up has a zero
    gradient, and 0 / sqrt(0) is NaN) and ``proximal_gd`` on the rest,
    both with l1 and l2 above 0."""

    def __init__(self, learning_rate, l1, l2):
        super().__init__(learning_rate)
        self._l1, self._l2 = l1, l2

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            if p.name.startswith("fm_"):
                self._add_accumulator("moment", p, fill_value=0.1)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        ins = {"Param": [param], "Grad": [grad],
               "LearningRate": [self._create_param_lr(param_and_grad)]}
        outs = {"ParamOut": [param]}
        kind = "proximal_gd"
        if param.name.startswith("fm_"):
            m = self._get_accumulator("moment", param)
            ins["Moment"], outs["MomentOut"] = [m], [m]
            kind = "proximal_adagrad"
        return block.append_op(kind, inputs=ins, outputs=outs,
                               attrs={"l1": self._l1, "l2": self._l2})


def _wrapper_runs():
    """name -> a maker of the optimizer ``_dfm_program`` minimizes."""
    adam = lambda: fluid.optimizer.AdamOptimizer(DFM_LR)   # noqa: E731

    def ema():
        def then():
            e = fluid.optimizer.ExponentialMovingAverage(WRAP_DECAY)
            e.update()
            return e
        return _AfterMinimize(adam(), then)
    return {
        "ema": ema,
        "model_average": lambda: _AfterMinimize(
            adam(), lambda: fluid.optimizer.ModelAverage(
                0.15, max_average_window=2)),
        "lookahead": lambda: fluid.optimizer.LookaheadOptimizer(
            adam(), alpha=0.5, k=2),
        "dgc": lambda: fluid.optimizer.DGCMomentumOptimizer(
            0.05, momentum=0.9, rampup_begin_step=1),
        "proximal": lambda: _ProximalOptimizer(0.05, l1=1e-4, l2=1e-4),
    }


def _closed_err(got, want):
    """max|got − want| over the largest |want|, over a {name: tensor}."""
    return max(float((got[n].double().cpu() - want[n]).abs().max()) /
               max(float(want[n].abs().max()), 1e-30) for n in want)


def _wrapper_trace(name, exe, main, loss, init, feeds, handle):
    """DFM_CHECK_STEPS card steps from ``init`` keeping the scope: EMA's
    and ModelAverage's ``apply`` against their closed forms and
    ``restore`` bit-equal to the trained values (ModelAverage applied
    after step 2, the window's mean, and after step 3, where the reset
    leaves the last step alone); Lookahead's sync steps; DGC's cleared
    residual entries; the proximal tables' exact zeros."""
    scope = _state_copy(main, init, exe.device)
    params = [p.name for p in main.global_block().all_parameters()]
    small = [n for n in params if scope.find_var(n).numel() <= 10 ** 6]
    hist, report, checks = [], {}, {}

    def swap_check(tag, want):
        trained = {n: scope.find_var(n).clone() for n in params}
        with fluid.scope_guard(scope):
            with handle.apply(exe):
                got = {n: scope.find_var(n).clone() for n in want}
        err = _closed_err(got, want)
        report[tag + "_closed_err"] = err
        checks[tag + "_closed_form"] = err <= WRAP_CLOSED_RTOL
        checks[tag + "_restore_bit_equal"] = all(
            torch.equal(scope.find_var(n), trained[n]) for n in params)

    synced = []
    for s in range(1, DFM_CHECK_STEPS + 1):
        exe.run(main, feed=feeds[(s - 1) % len(feeds)], fetch_list=[loss],
                scope=scope)
        hist.append({n: scope.find_var(n).double().cpu() for n in small})
        if name == "lookahead":
            synced.append(all(torch.equal(scope.find_var(n), scope.find_var(
                n + "_la_slow")) for n in params))
        if name == "model_average" and s == 2:
            swap_check("apply_step2", {n: (hist[0][n] + hist[1][n]) / 2
                                       for n in small})
        if name == "dgc" and s == 1:
            checks["u_zero_before_rampup"] = all(
                not scope.find_var(n + "_dgc_u_0").any() for n in params)
    if name == "ema":
        shadow = {n: torch.zeros_like(hist[0][n]) for n in small}
        for h in hist:
            shadow = {n: WRAP_DECAY * shadow[n] + (1 - WRAP_DECAY) * h[n]
                      for n in small}
        corr = 1 - WRAP_DECAY ** len(hist)
        swap_check("apply", {n: shadow[n] / corr for n in small})
    if name == "model_average":
        checks["count_reset_to_1"] = float(scope.find_var(
            handle._count_name).reshape(-1)[0].item()) == 1.0
        swap_check("apply_step3", hist[-1])
    if name == "lookahead":
        report["synced_after_step"] = synced
        checks["syncs_on_step_2_only"] = synced == [False, True, False]
    if name == "dgc":
        v = scope.find_var("fc_0.w_0_dgc_v_0")
        report["fc_0_v_cleared_share"] = float((v == 0).float().mean())
        checks["residuals_cleared_after_rampup"] = \
            report["fc_0_v_cleared_share"] > 0
    if name == "proximal":
        emb = scope.find_var("fm_emb")
        report["fm_emb_zero_share"] = float((emb == 0).float().mean())
    return report, checks


def phase_wrappers():
    """DeepFM at base_config and batch DFM_OPT_BATCH through each wrapper
    (ExponentialMovingAverage and ModelAverage(max_average_window=2)
    after Adam, LookaheadOptimizer(Adam, k=2), DGCMomentumOptimizer in a
    world of one, rampup from step 1) and a hand-built proximal_gd /
    proximal_adagrad program, each DFM_CHECK_STEPS steps held as
    deepfm_optimizers holds its runs (card against the port's CPU path),
    then ``_wrapper_trace``'s checks; no port kernel may launch.  The
    launches of the whole phase (all 0)."""
    t0 = time.perf_counter()
    feeds = _dfm_feeds(_dfm_config(), DFM_OPT_BATCH)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    checks = {}
    # the main path's run: counts go to 0 here and are read after it
    _reset_launches()
    for name, make in _wrapper_runs().items():
        main, startup, loss, opt = _dfm_program(make)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        report, ok, _card_run = _dfm_card_vs_cpu(exe, main, loss, scope,
                                                 feeds)
        trace, tok = _wrapper_trace(name, exe, main, loss, scope, feeds,
                                    getattr(opt, "handle", None))
        ok.update(tok)
        kinds = [op.type for b in main.blocks for op in b.ops]
        emit(phase="wrappers", run=name, batch=DFM_OPT_BATCH,
             steps=DFM_CHECK_STEPS, ops=len(kinds),
             conditional_blocks=kinds.count("conditional_block"),
             checks=ok, **report, **trace)
        checks.update({"%s_%s" % (name, k): v for k, v in ok.items()})
        del scope
    launches = _launches()
    checks["no_port_kernel"] = not any(launches.values())
    emit(phase="wrappers_total", seconds=time.perf_counter() - t0,
         launches=launches, checks={"no_port_kernel":
                                    checks["no_port_kernel"]})
    _fail_unless("wrappers", checks)
    return launches


# ---------------------------------------------------------------------------
# The parameter server: ps_deepfm, ps_two_trainers
# ---------------------------------------------------------------------------

PS_SERVERS = 2                # pservers of both PS paths, on 127.0.0.1
PS_RUNS = {                   # run -> trainers its pair of pservers serves
    "timed": 1,               # ps_deepfm: 2 warm-up + 4 timed, profiled
    "card": 1,                # card against host: DFM_CHECK_STEPS each,
    "card_reversed": 1,       # ... from fresh pservers (the reversed
    "host": 1,                # ... batches give each side's spread)
    "host_reversed": 1,
    "two_trainers": 2,        # ps_two_trainers
}
PS_TWO_LOSS_RTOL = 1e-5       # the mean of two 2048-row step-1 losses vs
                              # one 4096-row loss: fp32 rounding of the
                              # batch mean (a sum of 4096 terms ~0.7)
PS_READY_S = 300              # a pserver or trainer child's start, at most
PS_TABLE_BYTES = 4 * 1000001 * 11 * 4   # fm_emb [1000001, 10] and fm_w1
                              # [1000001, 1] in fp32, their two Adam moments
                              # and their dense gradients
PS_CLIENT = ("send_grads", "get_params", "prefetch_rows")


def _dfm_transpile(eps, trainers=1, trainer_id=0):
    """bench_deepfm's program (``_dfm_program``) transpiled with the
    default DistributeTranspilerConfig (slice_var_up, min_block_size
    8192, RoundRobin) for the pservers ``eps``, sync mode: (transpiler,
    trainer program, trainer startup, loss)."""
    main, startup, loss, _ = _dfm_program()
    t = fluid.transpiler.DistributeTranspiler()
    t.transpile(trainer_id, program=main, pservers=",".join(eps),
                trainers=trainers, sync_mode=True, startup_program=startup)
    return t, main, startup, loss


class _PsClientClock:
    """Wall seconds, calls and payload bytes of the port's ps client
    functions, by wrapping them in the module the op rules call
    (``send_grads``: the push, ``get_params``: recv, ``prefetch_rows``:
    distributed_lookup_table).  Bytes are the arrays' own, each way:
    to the pservers dense gradients, sparse (ids, rows) pairs and
    prefetch ids; back dense parameters and prefetched rows."""

    def __init__(self):
        from paddle_tpu_torch.distributed import ps
        self.ps = ps
        self.real = {n: getattr(ps, n) for n in PS_CLIENT}
        self.reset()

    def reset(self):
        self.s = dict.fromkeys(PS_CLIENT, 0.0)
        self.calls = dict.fromkeys(PS_CLIENT, 0)
        self.bytes = dict.fromkeys(("to_dense", "to_sparse", "to_ids",
                                    "from_dense", "from_rows"), 0)

    def _timed(self, name, fn):
        def wrapped(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.s[name] += time.perf_counter() - t0
            self.calls[name] += 1
            self._count(name, args, kw, out)
            return out
        return wrapped

    def _count(self, name, args, kw, out):
        b = self.bytes
        if name == "send_grads":
            b["to_dense"] += sum(np.asarray(a).nbytes for a in args[2])
            sparse = kw.get("sparse_grads") or {}
            b["to_sparse"] += sum(np.asarray(i).nbytes + np.asarray(r).nbytes
                                  for i, r, _s in sparse.values())
        elif name == "get_params":
            b["from_dense"] += sum(np.asarray(v).nbytes for v in out)
        else:
            b["to_ids"] += np.asarray(args[2]).nbytes
            b["from_rows"] += np.asarray(out).nbytes

    def __enter__(self):
        for n, fn in self.real.items():
            setattr(self.ps, n, self._timed(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.real.items():
            setattr(self.ps, n, fn)

    def per_step(self, steps):
        return dict(host_ms={n: s * 1e3 / steps for n, s in self.s.items()},
                    calls={n: c / steps for n, c in self.calls.items()},
                    bytes={n: b / steps for n, b in self.bytes.items()})


class _PsCluster:
    """The pserver children of both PS paths: PS_SERVERS processes
    (``chip_smoke.py ps_child server <dir> <index>``), each hosting one
    pserver of every run in PS_RUNS on CPUPlace(), all from the
    startup weights in ``<dir>/init.npz``.  Used as a context manager:
    the children are stopped on every exit path (a stop request to each
    pserver, then SIGKILL to a child that has not exited)."""

    def __init__(self, init):
        self.d = _io_dir("ps")
        np.savez(self.d / "init.npz", **init)
        ports = iter(_free_ports(PS_SERVERS * len(PS_RUNS)))
        self.runs = {run: dict(trainers=n, eps=["127.0.0.1:%d" % next(ports)
                                                for _ in range(PS_SERVERS)])
                     for run, n in PS_RUNS.items()}
        (self.d / "ps.json").write_text(json.dumps({"runs": self.runs}))
        self.procs = []

    def eps(self, run):
        return self.runs[run]["eps"]

    def spawn(self, role, index):
        """A child ``chip_smoke.py ps_child <role> <dir> <index>``, its
        output in ``<dir>/<role><index>.log``; returns the process."""
        here = Path(__file__).resolve().parent
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(here)] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        log = open(self.d / ("%s%d.log" % (role, index)), "w")
        proc = subprocess.Popen(
            [sys.executable, "-u", str(Path(__file__).resolve()),
             "ps_child", role, str(self.d), str(index)], env=env,
            cwd=str(here), stdout=log, stderr=subprocess.STDOUT)
        log.close()
        self.procs.append(proc)
        return proc

    def wait_files(self, names, procs, timeout=PS_READY_S):
        """Wait until every file in ``names`` exists in the directory;
        fail with the children's logs if one of ``procs`` exits first."""
        t0 = time.perf_counter()
        while not all((self.d / n).exists() for n in names):
            dead = [p for p in procs if p.poll() is not None and
                    p.returncode != 0]
            if dead or time.perf_counter() - t0 > timeout:
                raise SystemExit("ps children failed (exit %s) or timed "
                                 "out:\n%s" % ([p.returncode for p in procs],
                                               self.logs()))
            time.sleep(0.2)
        return time.perf_counter() - t0

    def logs(self):
        return "\n".join("%s:\n%s" % (f.name, f.read_text()[-3000:])
                         for f in sorted(self.d.glob("*.log")))

    def __enter__(self):
        t0 = time.perf_counter()
        servers = [self.spawn("server", i) for i in range(PS_SERVERS)]
        self.wait_files(["ready%d" % i for i in range(PS_SERVERS)], servers)
        self.start_s = time.perf_counter() - t0
        return self

    def __exit__(self, *exc):
        from paddle_tpu_torch.distributed import ps
        if exc[0] is None:
            ps.stop_servers([ep for r in self.runs.values()
                             for ep in r["eps"]])
        for p in self.procs:
            try:
                p.wait(timeout=30 if exc[0] is None else 0.1)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        if exc[0] is None:
            self.emit_apply_times()
            shutil.rmtree(self.d, ignore_errors=True)

    def emit_apply_times(self):
        """The pservers' apply per round, as their children timed it:
        the whole apply and its touched-rows part, ms (median and all
        rounds), by run and pserver."""
        out = {}
        for i in range(PS_SERVERS):
            f = self.d / ("server%d_times.json" % i)
            for run, t in (json.loads(f.read_text()) if f.exists()
                           else {}).items():
                out.setdefault(run, {})["pserver%d" % i] = dict(
                    rounds=len(t.get("apply_ms", [])),
                    apply_ms_median=float(np.median(t["apply_ms"]))
                    if t.get("apply_ms") else None,
                    sparse_ms_median=float(np.median(t["sparse_ms"]))
                    if t.get("sparse_ms") else None, **t)
        emit(phase="ps_pserver_apply", runs=out)


def _ps_child_server(d, index):
    """One pserver of every run in ``<d>/ps.json``, in this process, as a
    Fluid 1.5 pserver script builds it: the same program transpiled with
    the same arguments, ``get_pserver_program``/``get_startup_program``
    for its endpoint, the parent's startup weights, CPUPlace()."""
    from paddle_tpu_torch.distributed.ps import ParameterServer
    runs = json.loads((d / "ps.json").read_text())["runs"]
    init = dict(np.load(d / "init.npz"))
    # wall seconds of each round's apply, and of its touched-rows part,
    # by endpoint: the package's methods wrapped here, not instrumented
    times, sparse_s = {}, {}
    apply, apply_sparse = ParameterServer._apply, ParameterServer._apply_sparse

    def timed_apply(self, *args, **kw):
        s0, t0 = sparse_s.get(self.endpoint, 0.0), time.perf_counter()
        out = apply(self, *args, **kw)
        t = times.setdefault(self.endpoint, {"apply_ms": [],
                                             "sparse_ms": []})
        t["apply_ms"].append((time.perf_counter() - t0) * 1e3)
        t["sparse_ms"].append((sparse_s.get(self.endpoint, 0.0) - s0) * 1e3)
        return out

    def timed_apply_sparse(self, *args, **kw):
        t0 = time.perf_counter()
        out = apply_sparse(self, *args, **kw)
        sparse_s[self.endpoint] = sparse_s.get(self.endpoint, 0.0) + \
            time.perf_counter() - t0
        return out

    ParameterServer._apply = timed_apply
    ParameterServer._apply_sparse = timed_apply_sparse
    servers = []
    for spec in runs.values():
        t, _main, _startup, _loss = _dfm_transpile(spec["eps"],
                                                   spec["trainers"])
        ep = spec["eps"][index]
        prog = t.get_pserver_program(ep)
        servers.append(ParameterServer(
            ep, prog, t.get_startup_program(ep, prog),
            trainers=spec["trainers"], sync_mode=True, init_weights=init,
            place=fluid.CPUPlace()))
    (d / ("ready%d" % index)).write_text("")
    for s in servers:
        s.join()
    (d / ("server%d_times.json" % index)).write_text(json.dumps(
        {run: times.get(spec["eps"][index], {})
         for run, spec in runs.items()}))
    return 0


def _ps_child_trainer(d, tid):
    """Trainer ``tid`` of ps_two_trainers on card 0: its half of each of
    bench_deepfm's two feeds, DFM_CHECK_STEPS steps; writes its losses,
    ms per step and launches."""
    from paddle_tpu_torch.distributed import ps
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eps = json.loads((d / "ps.json").read_text())["runs"]["two_trainers"][
        "eps"]
    half = slice(tid * DFM_BATCH // 2, (tid + 1) * DFM_BATCH // 2)
    feeds = [{k: torch.from_numpy(np.ascontiguousarray(v[half])).cuda()
              for k, v in np.load(d / ("feed%d.npz" % i)).items()}
             for i in range(2)]
    _t, main, startup, loss = _dfm_transpile(eps, trainers=2, trainer_id=tid)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    # the main path's run: counts go to 0 here and are read after it
    _reset_launches()
    losses, step_ms = [], []
    for i in range(DFM_CHECK_STEPS):
        t0 = time.perf_counter()
        losses.append(float(exe.run(main, feed=feeds[i % 2],
                                    fetch_list=[loss],
                                    scope=scope)[0].reshape(-1)[0]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = _launches()
    ps.notify_complete(eps, tid)
    (d / ("trainer%d.json" % tid)).write_text(json.dumps(dict(
        losses=losses, step_ms=step_ms, launches=launches,
        tables_in_scope=sorted(n for n in scope.vars
                               if n.startswith(("fm_emb", "fm_w1"))))))
    return 0


def ps_child(role, d, index):
    d = Path(d)
    if role == "server":
        return _ps_child_server(d, int(index))
    return _ps_child_trainer(d, int(index))


def _ps_save(eps, d):
    """checkpoint_notify to the pservers ``eps`` (one program holding the
    op, run on the host), then {var: value} of what they saved in ``d``."""
    prog = fluid.Program()
    prog.global_block().append_op(
        "checkpoint_notify", attrs={"endpoints": list(eps),
                                    "dirname": str(d)})
    fluid.Executor(fluid.CPUPlace()).run(prog, scope=fluid.Scope())
    return {f.name[:-len(".npy")]: np.load(f) for f in sorted(d.glob(
        "*.npy"))}


def _ps_run(cluster, run, place, feeds, steps=DFM_CHECK_STEPS):
    """One trainer on ``place`` against ``run``'s fresh pservers,
    ``steps`` steps on ``feeds`` (numpy) in turn, then the pservers'
    state through checkpoint_notify: (losses, saved state)."""
    eps = cluster.eps(run)
    _t, main, startup, loss = _dfm_transpile(eps)
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    losses = [float(exe.run(main, feed=feeds[i % len(feeds)],
                            fetch_list=[loss], scope=scope)[0].reshape(-1)[0])
              for i in range(steps)]
    return losses, _ps_save(eps, cluster.d / run)


def _max_state_diff(a, b):
    """max over the variables of max |a - b| (the same names in both)."""
    assert sorted(a) == sorted(b), (sorted(set(a) ^ set(b)))
    return max(float(np.abs(a[n].astype(np.float64) - b[n]).max())
               if a[n].size else 0.0 for n in a)


def _ps_init():
    """The startup weights deepfm_train starts from (``_dfm_program``'s
    startup on the card), as host arrays."""
    main, startup, _loss, _ = _dfm_program()
    scope = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=scope)
    return {p.name: scope.find_var(p.name).cpu().numpy()
            for p in main.global_block().all_parameters()}


def phase_ps_deepfm(cluster):
    """bench_deepfm's DeepFM (base_config, Adam 1e-3, batch 4096, not cut)
    transpiled with the default DistributeTranspilerConfig to two
    pservers (children of this script on 127.0.0.1, CPUPlace()), sync
    mode, one trainer on CUDAPlace(0): fm_emb [1000001, 10] and fm_w1
    [1000001, 1] live on the pservers in two row blocks, the 273 x 400
    and 400 x 400 tower weights are sliced too.  The plain program from
    the same startup weights on the same two feeds, timed in this phase;
    then the PS run, 2 warm-up and 4 timed steps, and one profiled step.
    Checks: step 1's loss bit-equal to the plain program's step 1; step
    2 within DFM_LOSS_RTOL of the plain step 2 (dense Adam runs on the
    host pservers); finite losses, the last below the first; no port
    kernel; neither table (nor its Adam state) in the trainer's scope;
    peak device memory below the plain run's by at least
    PS_TABLE_BYTES.  Then card against host: DFM_CHECK_STEPS steps with
    the trainer on the card and on CPUPlace() against fresh pservers
    from one state (and each again on the reversed batches, for the
    spreads), every pserver-held value saved through checkpoint_notify:
    losses within DFM_LOSS_RTOL, every value within phase_deepfm_check's
    rule, max(2 x (card spread + host spread), DFM_PARAM_FLOOR).
    Returns (launches, what ps_two_trainers compares with)."""
    cfg = _dfm_config()
    feeds_np = _dfm_feeds(cfg, DFM_BATCH)
    feeds = [{k: torch.from_numpy(v).cuda() for k, v in f.items()}
             for f in feeds_np]
    init = dict(np.load(cluster.d / "init.npz"))

    # the plain program, from the same weights, in this phase
    main, startup, loss, _ = _dfm_program()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    for n, v in init.items():
        scope.set_var(n, torch.from_numpy(v).cuda())
    # the peak from here: the state and the steps, not the copies above
    torch.cuda.reset_peak_memory_stats()
    got, plain_ms = _train_steps(exe, main, feeds, [loss], scope)
    plain_losses = [float(g[0].item()) for g in got]
    plain_peak = torch.cuda.max_memory_allocated() - base
    del scope, got

    # the PS run
    eps = cluster.eps("timed")
    t, pmain, pstartup, ploss = _dfm_transpile(eps)
    ops = [op.type for op in pmain.global_block().ops]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    pscope = fluid.Scope()
    exe.run(pstartup, scope=pscope)
    torch.cuda.reset_peak_memory_stats()
    clock = _PsClientClock()
    losses = []
    # the main path's run: counts go to 0 here and are read after it
    _reset_launches()
    with clock:
        for i in range(WARM_STEPS + TIMED_STEPS):
            if i == WARM_STEPS:
                torch.cuda.synchronize()
                clock.reset()
                t0 = time.perf_counter()
            losses.append(exe.run(pmain, feed=feeds[i % 2],
                                  fetch_list=[ploss], scope=pscope,
                                  return_numpy=False)[0])
        torch.cuda.synchronize()
        ps_ms = (time.perf_counter() - t0) / TIMED_STEPS * 1e3
        launches = _launches()
        ps_peak = torch.cuda.max_memory_allocated() - base
        split = clock.per_step(TIMED_STEPS)
        clock.reset()
        prof, _ = _profile_record(exe, pmain, feeds[0], [ploss], pscope)
        prof_split = clock.per_step(1)
    losses = [float(x.item()) for x in losses]
    held = sorted(n for n in pscope.vars
                  if n.startswith(("fm_emb", "fm_w1")))
    sparse = {s[0] for p in t._sparse_tables for s in t._slice_table(p)}
    sliced = {p: [list(s) for s in t._slice_table(p)] for p in t._slices}
    del pscope

    # card against host, from fresh pservers
    card, card_state = _ps_run(cluster, "card", fluid.CUDAPlace(0), feeds_np)
    card_rev, card_rev_state = _ps_run(cluster, "card_reversed",
                                       fluid.CUDAPlace(0),
                                       _reversed(feeds_np))
    host, host_state = _ps_run(cluster, "host", fluid.CPUPlace(), feeds_np)
    host_rev, host_rev_state = _ps_run(cluster, "host_reversed",
                                       fluid.CPUPlace(), _reversed(feeds_np))
    card_spread = _max_state_diff(card_state, card_rev_state)
    host_spread = _max_state_diff(host_state, host_rev_state)
    bound = max(2 * (card_spread + host_spread), DFM_PARAM_FLOOR)
    err = {n: float(np.abs(card_state[n].astype(np.float64) -
                           host_state[n]).max()) if card_state[n].size
           else 0.0 for n in card_state}
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card, host))
    checks = {
        "step1_bit_equal_plain": losses[0] == plain_losses[0],
        "step2_matches_plain": abs(losses[1] - plain_losses[1]) <=
            DFM_LOSS_RTOL * abs(plain_losses[1]),
        "losses_finite": bool(np.isfinite(losses).all()),
        "last_loss_below_first": losses[-1] < losses[0],
        "no_port_kernel": not any(launches.values()),
        "tables_not_on_trainer": not held,
        "tables_on_pservers": sparse == {
            "fm_emb.block0", "fm_emb.block1", "fm_w1.block0",
            "fm_w1.block1"} and sparse <= set(card_state),
        "lookups_distributed": ops.count("distributed_lookup_table") == 2
            and "lookup_table" not in ops,
        "peak_below_plain_by_tables": plain_peak - ps_peak >=
            PS_TABLE_BYTES,
        "card_losses_match_host": loss_err <= DFM_LOSS_RTOL,
        "card_state_matches_host": max(err.values()) <= bound,
    }
    emit(phase="ps_deepfm", card=_card(), pservers=PS_SERVERS,
         pserver_place="CPUPlace", batch=DFM_BATCH, steps=len(losses),
         children_start_s=cluster.start_s, losses=losses,
         plain_losses=plain_losses, ms_per_step=ps_ms,
         examples_per_s=DFM_BATCH / ps_ms * 1e3,
         plain_ms_per_step=plain_ms,
         plain_examples_per_s=DFM_BATCH / plain_ms * 1e3,
         per_step=split, profiled_step=dict(prof, **prof_split),
         peak_device_mb=ps_peak / 2**20, plain_peak_device_mb=plain_peak /
         2**20, peak_saving_mb=(plain_peak - ps_peak) / 2**20,
         tables_bytes_mb=PS_TABLE_BYTES / 2**20, sliced=sliced,
         trainer_ops=len(ops), launches=launches,
         card_vs_host=dict(
             steps=DFM_CHECK_STEPS, losses_card=card,
             losses_card_reversed=card_rev, losses_host=host,
             losses_host_reversed=host_rev, loss_max_rel_err=loss_err,
             state_vars=len(err), state_max_abs_err=max(err.values()),
             worst=max(err, key=err.get), card_spread=card_spread,
             host_spread=host_spread, bound=bound,
             tolerance="losses rel %g; every pserver value max|card - "
             "host| <= max(2 x (card spread + host spread), %g); a side's "
             "spread: max|run - run on the reversed batches| over every "
             "value" % (DFM_LOSS_RTOL, DFM_PARAM_FLOOR)),
         checks=checks)
    _fail_unless("ps_deepfm", checks)
    return launches, dict(step1=losses[0], state=card_state, bound=bound)


def phase_ps_two_trainers(cluster, ref):
    """ps_deepfm's program as two trainer processes sharing card 0
    (``chip_smoke.py ps_child trainer``), each feeding its half of each
    bench feed (rows 0-2047 and 2048-4095), against two pservers in sync
    mode, DFM_CHECK_STEPS steps.  DeepFM's loss is a mean over the batch
    and the pservers average the trainers' gradients, so: the mean of
    the two step-1 losses equals ps_deepfm's step 1 within
    PS_TWO_LOSS_RTOL, and after the steps every pserver value agrees
    with ps_deepfm's one-trainer 4096-row run (``card``) within its
    card-against-host bound."""
    for i, f in enumerate(_dfm_feeds(_dfm_config(), DFM_BATCH)):
        np.savez(cluster.d / ("feed%d.npz" % i), **f)
    t0 = time.perf_counter()
    procs = [cluster.spawn("trainer", tid) for tid in (0, 1)]
    cluster.wait_files(["trainer0.json", "trainer1.json"], procs)
    for p in procs:
        p.wait(timeout=60)
    wall = time.perf_counter() - t0
    res = [json.loads((cluster.d / ("trainer%d.json" % tid)).read_text())
           for tid in (0, 1)]
    state = _ps_save(cluster.eps("two_trainers"),
                     cluster.d / "two_trainers")
    mean1 = (res[0]["losses"][0] + res[1]["losses"][0]) / 2
    err = _max_state_diff(state, ref["state"])
    launches = {n: res[0]["launches"][n] + res[1]["launches"][n]
                for n in res[0]["launches"]}
    checks = {
        "trainers_exit_0": [p.returncode for p in procs] == [0, 0],
        "mean_step1_matches_one_trainer":
            abs(mean1 - ref["step1"]) <= PS_TWO_LOSS_RTOL *
            abs(ref["step1"]),
        "state_matches_one_trainer": err <= ref["bound"],
        "losses_finite": bool(np.isfinite(
            res[0]["losses"] + res[1]["losses"]).all()),
        "no_port_kernel": not any(launches.values()),
        "tables_not_on_trainers": not any(r["tables_in_scope"]
                                          for r in res),
    }
    emit(phase="ps_two_trainers", seconds=wall, steps=DFM_CHECK_STEPS,
         rows_per_trainer=DFM_BATCH // 2,
         losses=[r["losses"] for r in res], mean_step1=mean1,
         one_trainer_step1=ref["step1"],
         step1_rel_err=abs(mean1 - ref["step1"]) / abs(ref["step1"]),
         state_max_abs_err=err, bound=ref["bound"],
         step_ms=[r["step_ms"] for r in res],
         ms_per_step_after_first=[float(np.mean(r["step_ms"][1:]))
                                  for r in res], launches=launches,
         tolerance="mean step-1 loss rel %g (fp32 rounding of the batch "
         "mean); every pserver value within ps_deepfm's card-against-host "
         "bound" % PS_TWO_LOSS_RTOL, checks=checks)
    _fail_unless("ps_two_trainers", checks)
    return launches


# ---------------------------------------------------------------------------
# Tensor, sequence and expert parallelism: two gloo ranks on card 0
# ---------------------------------------------------------------------------

MP_STEPS = 2                  # 1 warm-up + 1 timed step a path
MP_LOSS_RTOL = 1e-4           # every step's loss, two ranks vs one process
MOE_OUT_RTOL = {"fp32": 1e-4,  # the MoE output at step 1 vs one process,
                "int8": 2.0 / 127}  # over its largest entry (int8: the
#                                     repo's int8 bound; one rounding to
#                                     1/254 of a token's largest entry on
#                                     each of the two a2a legs)
MOE_B, MOE_S, MOE_HID, MOE_HEADS = 8, 512, 768, 12    # fluid/benchmark.py
MOE_E, MOE_F, MOE_CF = 8, 3072, 1.25                  # :329's attention_moe
RING_TOL = {"float32": 1e-4, "bfloat16": 2e-2}        # kernel_ring, as the
#                                                       kernel rows' bounds,
#                                                       over each tensor's
#                                                       largest entry


def _mp_strategies():
    """(path name, DistributedStrategy kwargs) of mp_bert's three runs."""
    return (("tp_bert", dict(mp_degree=2)),
            ("sp_bert_ring", dict(sp_degree=2, sp_mode="ring")),
            ("sp_bert_ulysses", dict(sp_degree=2, sp_mode="ulysses")))


def _moe_program(transpile=None):
    """The MoE transformer block of tests/test_moe_transformer_composition.py
    (attention, then a switch_moe FFN; Momentum 0.05) at the widths of
    paddle_tpu/fluid/benchmark.py:329: batch 8, S 512, hidden 768, 12
    heads (D 64), 8 experts of ffn 3072, capacity factor 1.25.
    ``transpile(main, startup)`` runs after minimize."""
    L = fluid.layers
    D_ = MOE_HID // MOE_HEADS
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = L.data(name="x", shape=[MOE_S, MOE_HID], dtype="float32")
        label = L.data(name="label", shape=[1], dtype="int64")
        uni = fluid.ParamAttr(
            initializer=fluid.initializer.Uniform(-0.05, 0.05))
        q = L.transpose(L.reshape(L.fc(x, size=MOE_HID, num_flatten_dims=2,
                                       param_attr=uni),
                                  [0, MOE_S, MOE_HEADS, D_]), [0, 2, 1, 3])
        ctx = L.fused_attention(q, q, q, scale=D_ ** -0.5)
        h = x + L.reshape(L.transpose(ctx, [0, 2, 1, 3]),
                          [0, MOE_S, MOE_HID])
        moe, aux = L.switch_moe(h, num_experts=MOE_E, ffn_dim=MOE_F,
                                act="gelu", param_attr=uni,
                                capacity_factor=MOE_CF)
        logits = L.fc(L.reduce_mean(h + moe, dim=1), size=8, param_attr=uni)
        ce = L.mean(L.softmax_with_cross_entropy(logits, label))
        loss = ce + 0.01 * L.reduce_sum(aux)
        fluid.optimizer.MomentumOptimizer(0.05, 0.9).minimize(loss)
    if transpile is not None:
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            transpile(main, startup)
    return main, startup, loss, aux, moe


def _moe_feed():
    rng = np.random.RandomState(SEED)
    return {"x": rng.normal(0, 1, (MOE_B, MOE_S, MOE_HID)).astype(np.float32),
            "label": rng.randint(0, 8, (MOE_B, 1)).astype(np.int64)}


def _moe_runs():
    """(path name, transpile) of moe's four runs."""
    from paddle_tpu_torch.fluid.transpiler import (ExpertParallelTranspiler,
                                                   SequenceParallelTranspiler)
    return (
        ("sp_ring_flash", lambda m, s: SequenceParallelTranspiler(
            2, mode="ring").transpile(m, s)),
        ("ep_moe_dense", lambda m, s: ExpertParallelTranspiler(2)
         .transpile(m, s)),
        ("ep_moe_a2a_fp32", lambda m, s: ExpertParallelTranspiler(
            2, dispatch="a2a").transpile(m, s)),
        ("ep_moe_a2a_int8", lambda m, s: ExpertParallelTranspiler(
            2, dispatch="a2a", dispatch_precision="int8").transpile(m, s)))


def _mp_steps(exe, main, feed, fetch, scope, init, place, out=None):
    """The path's run from ``init``: MP_STEPS steps on ``feed``, the
    kernel counts set to 0 just before and read just after.  Returns the
    record of losses (and the other fetches of step 1), ms per timed
    step, peak and parameter bytes, launches, collective traffic; with
    ``out`` (a variable fetched on every step, left on the card), its
    step-1 value as ``out1`` (a host tensor)."""
    from paddle_tpu_torch.fluid import telemetry
    from paddle_tpu_torch.parallel import tensor_parallel as ptp
    fluid.load_numpy_params(scope, init, place, program=main)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ptp.reset_comm()
    n0 = telemetry.step_events_recorded()
    _reset_launches()
    got, out1 = [], None
    extra = [out] if out is not None else []
    for i in range(MP_STEPS):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        vals = exe.run(main, feed=feed, fetch_list=fetch + extra,
                       scope=scope, return_numpy=False)
        got.append([float(v.reshape(-1)[0]) for v in vals[:len(fetch)]])
        if i == 0 and out is not None:
            out1 = vals[-1].float().cpu()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (MP_STEPS - 1)
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    params = main.global_block().all_parameters()
    ev = telemetry.step_events()[-(telemetry.step_events_recorded() - n0):]
    return dict(
        losses=[g[0] for g in got], fetch1=got[0][1:], ms_per_step=ms,
        **({"out1": out1} if out is not None else {}),
        peak_mb=peak / 2**20, base_mb=base / 2**20,
        param_mb=sum(scope.find_var(p.name).numel() *
                     scope.find_var(p.name).element_size()
                     for p in params) / 2**20,
        opt_state_mb=(ev[-1].get("opt_state_bytes") or 0) / 2**20,
        launches=launches,
        comm_per_step={"%s@%s" % k: [v[0] / MP_STEPS, v[1] / MP_STEPS]
                       for k, v in ptp.comm.items()},
        recorded_comm_by=ev[-1]["comm_by"])


def _one_process(main, startup, feed, fetch, init, out=None):
    """The same program in this process (the reference of a two-rank
    path): its _mp_steps record."""
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    rec = _mp_steps(exe, main, feed, fetch, scope, init, fluid.CUDAPlace(0),
                    out=out)
    del scope
    torch.cuda.empty_cache()
    return rec


def _child_mp_bert(d):
    """A rank of mp_bert's pack: pp_bert's two pipeline stages, then
    BERT-base (dropout off) through fleet with mp_degree=2, then
    sp_degree=2 ring and Ulysses, each from phase train's initial
    parameters and batch; then the MoE paths and kernel_ring
    (``_moe_paths``)."""
    from paddle_tpu_torch.fluid.incubate.fleet.collective import \
        DistributedStrategy
    rank, n, fleet, exe = _child_world("gloo")
    init = {k: v.numpy() for k, v in torch.load(d / "init.pt").items()}
    feed = dict(np.load(d / "feed.npz"))
    cfg = bert.base_config(hidden_dropout=0.0, attn_dropout=0.0)
    res = dict(rank=rank, world=n, backend=torch.distributed.get_backend(),
               paths={})
    # pp_bert first, on a fresh card: its peak is held to a share of one
    # process's; then the three paths of the same two ranks
    res["paths"]["pp_bert"] = _pp_run(exe, cfg, init, feed)
    for name, kw in _mp_strategies():
        main, startup, out = _build_pretrain(cfg, fleet.distributed_optimizer(
            fluid.optimizer.AdamOptimizer(learning_rate=TRAIN_LR),
            strategy=DistributedStrategy(**kw)))
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        rec = _mp_steps(exe, main, feed, [out["loss"]], scope, init,
                        exe.place)
        rec["annotated"] = len(getattr(main, "_mp_shardings", {}) or {})
        res["paths"][name] = rec
        del scope, main, startup
        torch.cuda.empty_cache()
    moe = _moe_paths(exe, d)
    res["paths"].update(moe["paths"])
    res["kernel_ring"] = moe["kernel_ring"]
    return res


def _moe_paths(exe, d):
    """A rank's MoE runs: the block at sp 2 (the flash ring) and at ep 2
    (dense, a2a fp32, a2a int8), from the one-process startup weights;
    then kernel_ring.  Returns {"paths", "kernel_ring"}."""
    init = {k: v.numpy() for k, v in torch.load(d / "moe_init.pt").items()}
    ref_out = torch.load(d / "moe_out.pt")
    feed = _moe_feed()
    paths = {}
    for name, transpile in _moe_runs():
        main, startup, loss, aux, moe = _moe_program(transpile)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        rec = _mp_steps(exe, main, feed, [loss, aux], scope, init,
                        exe.place, out=moe)
        # the MoE op's step-1 output against one process's, over its
        # largest entry: a dropped or misrouted token moves it by O(1)
        got = rec.pop("out1")
        rec["moe_out_rel_err"] = float((got - ref_out).abs().max() /
                                       ref_out.abs().max())
        w = [p for p in main.global_block().all_parameters()
             if p.name.startswith("switch_moe") and len(p.shape) == 3]
        rec["expert_mb"] = sum(scope.find_var(p.name).numel() * 4
                               for p in w) / 2**20
        paths[name] = rec
        del scope, main, startup
        torch.cuda.empty_cache()
    return dict(paths=paths, kernel_ring=_kernel_ring(
        torch.distributed.get_rank()))


def _kernel_ring(rank):
    """The flash ring's forward and backward at the MoE block's attention
    shape (B 8, H 12, S 512 as two shards of 256, D 64), fp32 and bf16,
    on this rank's shard: against the einsum ring over the same group and
    against the plain K2-K4 (attention_reference and its backward) over
    the whole sequence; wall ms of both rings' forward + backward (their
    exchanges go through the host on gloo, so wall, not device, time)."""
    from paddle_tpu_torch.parallel import sequence_parallel as spm
    B_, H_, S_, D_ = MOE_B, MOE_HEADS, MOE_S, MOE_HID // MOE_HEADS
    Tl = S_ // 2
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        g = torch.Generator().manual_seed(SEED)
        q, k, v, do = (torch.randn(B_ * H_, S_, D_, generator=g) * 0.5
                       for _ in range(4))
        sl = slice(rank * Tl, (rank + 1) * Tl)
        loc = [t[:, sl].contiguous().to("cuda", dt) for t in (q, k, v, do)]
        scale = D_ ** -0.5

        def flash_ring():
            xs = [t.detach().requires_grad_() for t in loc[:3]]
            o = spm.RingFlashFunction.apply(*xs, None, scale)
            o.backward(loc[3])
            return o.detach(), [x.grad for x in xs]

        def einsum_ring():
            xs = [t.detach().requires_grad_() for t in loc[:3]]
            o = spm.ring_attention_einsum_bhsd(
                *[x.reshape(B_, H_, Tl, D_) for x in xs], None,
                scale=scale).reshape(B_ * H_, Tl, D_)
            o.backward(loc[3])
            return o.detach(), [x.grad for x in xs]

        attention_ops.flash_attention.launches = 0
        fo, fg = flash_ring()
        launches = dict(k2=attention_ops.flash_attention.launches)
        eo, eg = einsum_ring()
        full = [t.to("cuda", dt) for t in (q, k, v, do)]
        po, lse = attention_reference(*full[:3], None, scale, with_lse=True)
        from paddle_tpu_torch.fluid.ops.attention_ops import \
            flash_attention_bwd_reference
        pdq, pdk, pdv, _ = flash_attention_bwd_reference(
            *full[:3], None, scale, po, lse, full[3])
        plain = [po[:, sl], [pdq[:, sl], pdk[:, sl], pdv[:, sl]]]

        def err(a, b):
            # max |a - b| over max |b|, each tensor at its own scale (dq
            # and dk are ~0.03 at most here, o and dv ~0.1)
            b = b.float()
            return float((a.float() - b).abs().max() / b.abs().max())

        names = ("o", "dq", "dk", "dv")
        e_plain = {n: err(x, y) for n, x, y in
                   zip(names, [fo] + fg, [plain[0]] + plain[1])}
        e_einsum = {n: err(x, y) for n, x, y in
                    zip(names, [fo] + fg, [eo] + eg)}
        times = {}
        for label, fn in (("flash", flash_ring), ("einsum", einsum_ring),
                          ("einsum_again", einsum_ring),
                          ("flash_again", flash_ring)):
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            times[label] = (time.perf_counter() - t0) * 1e3 / 5
        out[str(dt).replace("torch.", "")] = dict(
            max_rel_err_vs_plain=max(e_plain.values()),
            max_rel_err_vs_einsum=max(e_einsum.values()),
            rel_err_vs_plain=e_plain, rel_err_vs_einsum=e_einsum,
            flash_ring_ms=min(times["flash"], times["flash_again"]),
            einsum_ring_ms=min(times["einsum"], times["einsum_again"]),
            k2_launches_forward=launches["k2"])
    return out


def _loss_rel_errs(recs, ref):
    """Each step's largest relative loss difference of the ranks from
    one process."""
    return [max(abs(r["losses"][i] - ref["losses"][i]) /
                abs(ref["losses"][i]) for r in recs)
            for i in range(MP_STEPS)]


def phase_mp_bert(train):
    """tp_bert and sp_bert: BERT-base at phase train's configuration with
    all dropout off, batch 32, from phase train's initial parameters and
    batch, as two gloo ranks on card 0 with mp_degree=2, then
    sp_degree=2 ring and Ulysses, MP_STEPS steps each; against the same
    program in one process: step-1 loss, peak memory and parameter bytes
    per rank, ms per step, the model-parallel collectives a step.  The
    same two ranks also run pp_bert and the MoE paths, whose records
    phase_pp_bert and phase_moe check: returns (launches by path, the
    one-process record, (the ranks' records, the pack's wall seconds, the
    MoE one-process record))."""
    cfg = bert.base_config(hidden_dropout=0.0, attn_dropout=0.0)
    init = {k: v.numpy() for k, v in train["init"].items()}
    main, startup, out = _build_pretrain(cfg)
    ref = _one_process(main, startup, train["feed"], [out["loss"]], init)
    del main, startup
    emit(phase="mp_bert_one_process", **ref)
    d = _io_dir("mp_bert")
    torch.save(train["init"], d / "init.pt")
    np.savez(d / "feed.npz", **train["feed"])
    moe_ref = _moe_prep(d)
    torch.cuda.empty_cache()
    ranks, wall = _launch_ranks("mp_bert", [0, 0], d)
    L = cfg.num_layers
    steps = MP_STEPS
    by_path = {}
    for name, _kw in _mp_strategies():
        recs = [r["paths"][name] for r in ranks]
        la = recs[0]["launches"]
        errs = _loss_rel_errs(recs, ref)
        loss_err = errs[0]
        kernels = 0 if name == "sp_bert_ring" else L * steps
        checks = {
            "gloo_two_ranks": [r["rank"] for r in ranks] == [0, 1] and
            all(r["backend"] == "gloo" for r in ranks),
            "step1_loss_matches_one_process": loss_err <= MP_LOSS_RTOL,
            # steps 2-4 follow a backward and an update through the
            # model-parallel layer (the rotations' and all-to-alls'
            # backward, the sharded optimizer state)
            "later_losses_match_one_process": max(errs[1:]) <= MP_LOSS_RTOL,
            "ranks_same_losses": recs[0]["losses"] == recs[1]["losses"],
            "losses_finite": bool(np.isfinite(recs[0]["losses"]).all()),
            "k2_k3_k4": all(la[k] == kernels for k in (
                "flash_attention_fwd", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkv")),
            "k5_0": la["flash_attention_bwd_dbias"] == 0,
        }
        if name == "tp_bert":
            checks["params_below_one_process"] = all(
                r["param_mb"] < ref["param_mb"] for r in recs)
        emit(phase=name, seconds=wall, losses=[r["losses"] for r in recs],
             one_process_losses=ref["losses"], step1_loss_rel_err=loss_err,
             loss_rel_errs=errs,
             ms_per_step=[r["ms_per_step"] for r in recs],
             one_process_ms_per_step=ref["ms_per_step"],
             peak_mb=[r["peak_mb"] for r in recs],
             one_process_peak_mb=ref["peak_mb"],
             param_mb=[r["param_mb"] for r in recs],
             one_process_param_mb=ref["param_mb"],
             opt_state_mb=[r["opt_state_mb"] for r in recs],
             one_process_opt_state_mb=ref["opt_state_mb"],
             comm_per_step=recs[0]["comm_per_step"],
             annotated_weights=recs[0]["annotated"], launches=la,
             checks=checks)
        _fail_unless(name, checks)
        by_path[name] = la
    shutil.rmtree(d, ignore_errors=True)
    return by_path, ref, (ranks, wall, moe_ref)


def _moe_prep(d):
    """The MoE block in one process from one startup's weights (the
    reference of phase_moe's paths); writes the weights and its step-1
    output into ``d`` for the ranks (``moe_init.pt``, ``moe_out.pt``) and
    returns its _mp_steps record."""
    main, startup, loss, aux, moe = _moe_program()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    init = {p: scope.find_var(p).cpu() for p in
            (v.name for v in main.list_vars() if v.persistable)
            if scope.find_var(p) is not None}
    del scope
    ref = _one_process(main, startup, _moe_feed(), [loss, aux],
                       {k: v.numpy() for k, v in init.items()}, out=moe)
    ref_out = ref.pop("out1")
    emit(phase="moe_one_process",
         expert_mb=2 * MOE_E * MOE_HID * MOE_F * 4 / 2**20,
         moe_out_max_abs=float(ref_out.abs().max()), **ref)
    torch.save(init, d / "moe_init.pt")
    torch.save(ref_out, d / "moe_out.pt")
    del ref_out
    torch.cuda.empty_cache()
    return ref


def phase_moe(two):
    """sp_ring_flash, ep_moe and kernel_ring: the MoE block at sp 2 (ring:
    T_local 256, no bias, so the flash ring: K2 with the LSE twice a
    forward, K3 and K4 twice a backward with the global LSE) and at ep 2
    (dense, a2a fp32, a2a int8), two gloo ranks on card 0, from one
    startup's weights; against the program in one process: the step-1
    loss and aux loss, peak memory, expert bytes per rank, ms per step,
    the a2a bytes by precision; then the flash ring's kernels against the
    einsum ring and the plain K2-K4.  The two ranks are mp_bert's pack:
    ``two`` holds their records, its wall seconds and the one-process
    record (``_moe_prep``)."""
    ranks, wall, ref = two
    expert_mb = 2 * MOE_E * MOE_HID * MOE_F * 4 / 2**20
    by_path = {}
    for name, _t in _moe_runs():
        recs = [r["paths"][name] for r in ranks]
        la = recs[0]["launches"]
        out_tol = MOE_OUT_RTOL["int8" if name.endswith("int8") else "fp32"]
        errs = _loss_rel_errs(recs, ref)
        loss_err = errs[0]
        aux_err = max(abs(r["fetch1"][0] - ref["fetch1"][0]) /
                      abs(ref["fetch1"][0]) for r in recs)
        out_err = max(r["moe_out_rel_err"] for r in recs)
        flash = 2 * MP_STEPS if name == "sp_ring_flash" else MP_STEPS
        checks = {
            "step1_loss_matches_one_process": loss_err <= MP_LOSS_RTOL,
            "later_losses_match_one_process": max(errs[1:]) <= MP_LOSS_RTOL,
            # the routing, before any exchange
            "step1_aux_matches_one_process": aux_err <= MP_LOSS_RTOL,
            "step1_moe_out_matches_one_process": out_err <= out_tol,
            "ranks_same_losses": recs[0]["losses"] == recs[1]["losses"],
            "losses_finite": bool(np.isfinite(recs[0]["losses"]).all()),
            "k2_k3_k4": all(la[k] == flash for k in (
                "flash_attention_fwd", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkv")),
            "k5_0": la["flash_attention_bwd_dbias"] == 0,
        }
        if name.startswith("ep_"):
            checks["half_the_experts"] = all(
                abs(r["expert_mb"] - expert_mb / 2) < 1e-6 for r in recs)
        emit(phase=name, seconds=wall, losses=[r["losses"] for r in recs],
             one_process_losses=ref["losses"], step1_loss_rel_err=loss_err,
             loss_rel_errs=errs, aux=[r["fetch1"][0] for r in recs],
             one_process_aux=ref["fetch1"][0], step1_aux_rel_err=aux_err,
             step1_moe_out_rel_err=out_err, moe_out_tolerance=out_tol,
             ms_per_step=[r["ms_per_step"] for r in recs],
             one_process_ms_per_step=ref["ms_per_step"],
             peak_mb=[r["peak_mb"] for r in recs],
             one_process_peak_mb=ref["peak_mb"],
             expert_mb=[r["expert_mb"] for r in recs],
             comm_per_step=recs[0]["comm_per_step"],
             recorded_comm_by=recs[0]["recorded_comm_by"], launches=la,
             checks=checks)
        _fail_unless(name, checks)
        by_path[name] = la
    ring = {r["rank"]: r["kernel_ring"] for r in ranks}
    checks = {}
    for dt, tol in RING_TOL.items():
        for rk, rec in ring.items():
            checks["%s_rank%d_vs_plain" % (dt, rk)] = \
                rec[dt]["max_rel_err_vs_plain"] <= tol
            checks["%s_rank%d_vs_einsum" % (dt, rk)] = \
                rec[dt]["max_rel_err_vs_einsum"] <= tol
            checks["%s_rank%d_k2_twice" % (dt, rk)] = \
                rec[dt]["k2_launches_forward"] == 2
    emit(phase="kernel_ring", shape=dict(B=MOE_B, H=MOE_HEADS, S=MOE_S,
                                         T_local=MOE_S // 2,
                                         D=MOE_HID // MOE_HEADS),
         tolerance=RING_TOL, ranks=ring, checks=checks)
    _fail_unless("kernel_ring", checks)
    return by_path, ring[0]


# ---------------------------------------------------------------------------
# Pipelines and the compositions: two or four gloo ranks on card 0
# ---------------------------------------------------------------------------

PP_MICRO = 4                  # pp_bert, pp_mp_bert: microbatches a step
PP_PARAM_SHARE = 0.6          # parameter bytes a rank over one process's,
#                               at most (shard_params holds ~1/2)
PP_PEAK_SHARE = 0.6           # peak memory a rank over one process's, at
#                               most (a stage gathers only what it reads)


def _pp_program(cfg, tp=False):
    """BERT-base pretraining in two stages, from models/bert.py's
    pieces: stage pp:0 the embeddings, the attention bias and layers
    0-5, stage pp:1 layers 6-11, the MLM and NSP heads and the loss;
    Adam TRAIN_LR under PipelineOptimizer(PP_MICRO).  Parameters are
    created in build_pretrain's order, so they carry its names.  ``tp``
    applies TensorParallelTranspiler(2) after the optimizer."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    S_, hid = cfg.max_seq_len, cfg.hidden_size
    half = cfg.num_layers // 2
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        with fluid.device_guard("pp:0"):
            src_ids = L.data(name="src_ids", shape=[S_, 1], dtype="int64")
            pos_ids = L.data(name="pos_ids", shape=[S_, 1], dtype="int64")
            sent_ids = L.data(name="sent_ids", shape=[S_, 1],
                              dtype="int64")
            input_mask = L.data(name="input_mask", shape=[S_, 1],
                                dtype="float32")
            emb = L.embedding(src_ids, size=[cfg.vocab_size, hid],
                              param_attr=fluid.ParamAttr(
                                  name="word_embedding",
                                  initializer=fluid.initializer
                                  .TruncatedNormal(scale=0.02)))
            pos = L.embedding(pos_ids, size=[cfg.max_position, hid],
                              param_attr=bert._param("pos"))
            sent = L.embedding(sent_ids, size=[cfg.type_vocab_size, hid],
                               param_attr=bert._param("sent"))
            x = L.layer_norm(emb + pos + sent, begin_norm_axis=2)
            mask2d = L.matmul(input_mask, input_mask, transpose_y=True)
            attn_bias = L.unsqueeze(L.scale(mask2d, scale=1e4, bias=-1.0,
                                            bias_after_scale=False), [1])
            attn_bias.stop_gradient = True
            for _ in range(half):
                x = bert.encoder_layer(x, attn_bias, cfg)
        with fluid.device_guard("pp:1"):
            mask_pos = L.data(name="mask_pos", shape=[1], dtype="int32")
            mask_label = L.data(name="mask_label", shape=[1], dtype="int64")
            nsp_label = L.data(name="nsp_label", shape=[1], dtype="int64")
            for _ in range(half, cfg.num_layers):
                x = bert.encoder_layer(x, attn_bias, cfg)
            mlm, nsp = bert.pretrain_heads(x, mask_pos, cfg)
            loss = L.mean(L.softmax_with_cross_entropy(mlm, mask_label)) + \
                L.mean(L.softmax_with_cross_entropy(nsp, nsp_label))
        fluid.optimizer.PipelineOptimizer(
            fluid.optimizer.AdamOptimizer(learning_rate=TRAIN_LR),
            num_microbatches=PP_MICRO).minimize(loss)
    if tp:
        fluid.transpiler.TensorParallelTranspiler(2).transpile(main, startup)
    return main, startup, loss


def _pp_feed(feed, seq_len):
    """The batch as the pipeline is fed it: ``mask_pos`` re-based to its
    microbatch, index - k·(B/M)·S for microbatch k (the indices address
    the whole [B·S, H] output; the pipeline cuts every feed into M)."""
    out = dict(feed)
    rows = len(feed["src_ids"]) // PP_MICRO
    per = len(feed["mask_pos"]) // PP_MICRO
    mp = feed["mask_pos"].copy()
    for k in range(PP_MICRO):
        mp[k * per:(k + 1) * per] -= k * rows * seq_len
    out["mask_pos"] = mp
    return out


PP_SPAN_STEPS = 2             # pp paths: steps more, their phases' spans


def _pp_spans(exe, main, feed, loss, scope):
    """Host ms a step of each phase of the pipeline's step (its spans,
    FLAGS_trace_spans), over PP_SPAN_STEPS more steps after the path's
    run; the card is synchronised before each phase ends only where a
    gloo exchange stages through the host."""
    from paddle_tpu_torch.fluid import telemetry
    n0 = telemetry.step_events_recorded()
    telemetry.enable_spans(True)
    try:
        for _ in range(PP_SPAN_STEPS):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
    finally:
        telemetry.enable_spans(False)
    ev = telemetry.step_events()[-(telemetry.step_events_recorded() - n0):]
    out = {}
    for e in ev:
        if e.get("kind") == "span" and e["span"].startswith("pipeline_"):
            key = e["span"][len("pipeline_"):]
            out[key] = out.get(key, 0.0) + e["dur_ns"] / 1e6 / PP_SPAN_STEPS
    return out


def _pp_run(exe, cfg, init, feed, tp=False):
    """One pipelined path's _mp_steps record on this rank, with the
    paired weights' shapes as it holds them and as declared, and the
    host ms a step of each phase of the schedule."""
    main, startup, loss = _pp_program(cfg, tp)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = _pp_feed(feed, cfg.max_seq_len)
    rec = _mp_steps(exe, main, feed, [loss], scope, init, exe.place)
    rec["phase_ms"] = _pp_spans(exe, main, feed, loss, scope)
    block = main.global_block()
    rec["paired"] = {n: [list(scope.find_var(n).shape),
                         list(block.var(n).shape)]
                     for n in getattr(main, "_mp_shardings", {}) or {}}
    del scope, main, startup
    torch.cuda.empty_cache()
    return rec


def _child_pp_mp_bert(d):
    """A rank of the four: pp_mp_bert (the two stages with
    TensorParallelTranspiler(2): dp 1 x pp 2 x mp 2), then mp_sp_bert
    (BERT-base through fleet with mp_degree=2, sp_degree=2 Ulysses)."""
    from paddle_tpu_torch.fluid.incubate.fleet.collective import \
        DistributedStrategy
    rank, n, fleet, exe = _child_world("gloo")
    init = {k: v.numpy() for k, v in torch.load(d / "init.pt").items()}
    feed = dict(np.load(d / "feed.npz"))
    cfg = bert.base_config(hidden_dropout=0.0, attn_dropout=0.0)
    res = dict(rank=rank, world=n, backend=torch.distributed.get_backend(),
               paths={"pp_mp_bert": _pp_run(exe, cfg, init, feed, tp=True)})
    main, startup, out = _build_pretrain(cfg, fleet.distributed_optimizer(
        fluid.optimizer.AdamOptimizer(learning_rate=TRAIN_LR),
        strategy=DistributedStrategy(mp_degree=2, sp_degree=2,
                                     sp_mode="ulysses")))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    rec = _mp_steps(exe, main, feed, [out["loss"]], scope, init, exe.place)
    block = main.global_block()
    rec["paired"] = {nm: [list(scope.find_var(nm).shape),
                          list(block.var(nm).shape)]
                     for nm in main._mp_shardings}
    res["paths"]["mp_sp_bert"] = rec
    return res


def phase_pp_bert(train, ref, two):
    """pp_bert, pp_mp_bert and mp_sp_bert: BERT-base at phase train's
    configuration with all dropout off, from its initial parameters and
    batch, against ``ref`` (mp_bert's run of the same program in this
    process): two stages of six layers, PP_MICRO microbatches, as two
    gloo ranks on card 0 (run in mp_bert's pack: ``two`` holds its
    records and wall seconds); the same with the Megatron pairs at mp 2
    as four ranks; and BERT-base at mp 2 x sp 2 (Ulysses) with no pipeline
    in the same four.  Every step's loss within MP_LOSS_RTOL, every rank
    the same losses, the K2-K4 counts a rank (a pipeline's recompute
    runs each stage's forward again: 2 x 6 layers x PP_MICRO K2, 6 x
    PP_MICRO K3 and K4 a step), parameter bytes a rank below one
    process's (the pipeline's at most PP_PARAM_SHARE of it, its peak at
    most PP_PEAK_SHARE), each rank holding half of every paired weight;
    ms per step, peak memory and the collectives a step (the pipeline's
    sends: calls and bytes)."""
    cfg = bert.base_config(hidden_dropout=0.0, attn_dropout=0.0)
    L = cfg.num_layers
    d = _io_dir("pp_bert")
    torch.save(train["init"], d / "init.pt")
    np.savez(d / "feed.npz", **train["feed"])
    torch.cuda.empty_cache()
    ranks2, wall2, _ = two
    ranks4, wall4 = _launch_ranks("pp_mp_bert", [0, 0, 0, 0], d)
    steps = MP_STEPS
    pipe = {"flash_attention_fwd": 2 * (L // 2) * PP_MICRO,
            "flash_attention_bwd_dq": (L // 2) * PP_MICRO,
            "flash_attention_bwd_dkv": (L // 2) * PP_MICRO}
    by_path = {}
    for name, ranks, wall in (("pp_bert", ranks2, wall2),
                              ("pp_mp_bert", ranks4, wall4),
                              ("mp_sp_bert", ranks4, wall4)):
        recs = [r["paths"][name] for r in ranks]
        errs = _loss_rel_errs(recs, ref)
        per_step = pipe if name != "mp_sp_bert" else dict.fromkeys(pipe, L)
        checks = {
            "gloo_ranks": [r["rank"] for r in ranks] ==
            list(range(len(ranks))) and
            all(r["backend"] == "gloo" for r in ranks),
            "step1_loss_matches_one_process": errs[0] <= MP_LOSS_RTOL,
            "later_losses_match_one_process": max(errs[1:]) <= MP_LOSS_RTOL,
            "ranks_same_losses": all(r["losses"] == recs[0]["losses"]
                                     for r in recs),
            "losses_finite": bool(np.isfinite(recs[0]["losses"]).all()),
            "k2_k3_k4_per_rank": all(
                r["launches"][k] == c * steps
                for r in recs for k, c in per_step.items()),
            "k5_0": all(r["launches"]["flash_attention_bwd_dbias"] == 0
                        for r in recs),
            "params_below_one_process": all(
                r["param_mb"] < ref["param_mb"] for r in recs),
        }
        if name != "mp_sp_bert":
            checks["params_about_half"] = all(
                r["param_mb"] <= PP_PARAM_SHARE * ref["param_mb"]
                for r in recs)
            checks["peak_below_share"] = all(
                r["peak_mb"] <= PP_PEAK_SHARE * ref["peak_mb"]
                for r in recs)
            checks["sends_each_step"] = all(
                r["comm_per_step"].get("send@pp", [0])[0] == PP_MICRO
                for r in recs)
        if name != "pp_bert":
            checks["half_of_each_paired_weight"] = all(
                r["paired"] and all(
                    2 * int(np.prod(a)) == int(np.prod(b))
                    for a, b in r["paired"].values()) for r in recs)
            checks["mp_allreduces"] = all(
                r["comm_per_step"].get("allreduce@mp", [0])[0] > 0
                for r in recs)
        emit(phase=name, seconds=wall, ranks=len(ranks),
             losses=[r["losses"] for r in recs],
             one_process_losses=ref["losses"], step1_loss_rel_err=errs[0],
             loss_rel_errs=errs,
             ms_per_step=[r["ms_per_step"] for r in recs],
             one_process_ms_per_step=ref["ms_per_step"],
             peak_mb=[r["peak_mb"] for r in recs],
             one_process_peak_mb=ref["peak_mb"],
             peak_share=[r["peak_mb"] / ref["peak_mb"] for r in recs],
             param_mb=[r["param_mb"] for r in recs],
             one_process_param_mb=ref["param_mb"],
             param_share=[r["param_mb"] / ref["param_mb"] for r in recs],
             opt_state_mb=[r["opt_state_mb"] for r in recs],
             comm_per_step=[r["comm_per_step"] for r in recs],
             phase_ms=[r.get("phase_ms") for r in recs],
             paired_weights=len(recs[0]["paired"]),
             launches=[r["launches"] for r in recs], checks=checks)
        _fail_unless(name, checks)
        by_path[name] = recs[0]["launches"]
    shutil.rmtree(d, ignore_errors=True)
    return by_path


# ---------------------------------------------------------------------------
# The device-cost ledger, the per-op bench and control flow
# ---------------------------------------------------------------------------

# the products the ledger's analytic check covers, with their grad ops
CONTRACTION_OPS = ("mul", "mul_grad", "matmul", "matmul_grad", "conv2d",
                   "conv2d_grad")
# the grad slots of each product's grad op
_GRAD_SLOTS = {"mul": ("X", "Y"), "matmul": ("X", "Y"),
               "conv2d": ("Input", "Filter")}
LEDGER_TOL = 0.02             # counted vs analytic contraction FLOPs
LEDGER_STEPS = 3              # timed steps a ledger path (after 1 warm-up)
OP_BENCH_STEPS = 4            # per-op bench: steps a window (doubled until
#                               it is at least 20 ms and 4 fence reads)
OP_BENCH_BERT_BATCH = 64      # benchmark.bert_suite's batch


def _prod(xs):
    return float(np.prod([int(x) for x in xs])) if len(xs) else 1.0


def _contraction_flops(op_type, shapes, outputs, attrs):
    """2·M·N·K of one mul / matmul / conv2d op, or of the gradients its
    grad op computes (one product each), from the op's input shapes."""
    grad = op_type.endswith("_grad")
    base = op_type[:-len("_grad")] if grad else op_type
    if base == "mul":
        x, y = shapes["X"][0], shapes["Y"][0]
        xn = int(attrs.get("x_num_col_dims", 1))
        yn = int(attrs.get("y_num_col_dims", 1))
        f = 2.0 * _prod(x[:xn]) * _prod(x[xn:]) * _prod(y[yn:])
    elif base == "matmul":
        x, y = list(shapes["X"][0]), list(shapes["Y"][0])
        if attrs.get("transpose_X"):
            x[-2], x[-1] = x[-1], x[-2]
        if attrs.get("transpose_Y"):
            y[-2], y[-1] = y[-1], y[-2]
        batch = _prod(np.broadcast_shapes(tuple(x[:-2]), tuple(y[:-2])))
        f = 2.0 * batch * x[-2] * x[-1] * y[-1]
    else:
        n, c, h, w = shapes["Input"][0]
        if attrs.get("data_format", "NCHW") == "NHWC":
            n, h, w, c = shapes["Input"][0]
        o, cg, kh, kw = shapes["Filter"][0]
        st = list(attrs.get("strides", [1, 1]))
        pd = list(attrs.get("paddings", [0, 0]))
        dl = list(attrs.get("dilations", [1, 1]) or [1, 1])
        ph = pd[0] + (pd[1] if len(pd) == 4 else pd[0])
        pw = (pd[2] + pd[3]) if len(pd) == 4 else 2 * pd[1]
        ho = (h + ph - dl[0] * (kh - 1) - 1) // st[0] + 1
        wo = (w + pw - dl[1] * (kw - 1) - 1) // st[1] + 1
        f = 2.0 * n * o * ho * wo * cg * kh * kw
    if not grad:
        return f
    return f * sum(1 for slot in _GRAD_SLOTS[base]
                   if any(outputs.get(slot + "@GRAD", [])))


def _ledger_path(name, exe, main, feed, fetch, scope, kernels):
    """One path's ledger record on the card, its measured ms a step and
    the two checks: counted contraction FLOPs of mul / matmul / conv2d
    and their grads within LEDGER_TOL of the analytic count from the
    ops' shapes, and each hand kernel's counted FLOPs equal to its
    launches in the capture times ``kernels[k]`` (its kernel_work at
    the path's shape: a list of (launches, flops) per shape)."""
    _reset_launches()
    rec = exe.cost_record(main, feed=feed, fetch_list=fetch, scope=scope,
                          tag=name, shape_ops=CONTRACTION_OPS)
    launches = _launches()

    def step(i):
        return exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                       return_numpy=False)

    detail = {}
    dt, _ = timing.timed_steps(step, LEDGER_STEPS, warmup=1, detail=detail)
    ms = dt / LEDGER_STEPS * 1e3
    counted = sum(v["flops_est"] for op, v in rec["attribution"].items()
                  if op[len("fluid_"):] in CONTRACTION_OPS)
    analytic = sum(_contraction_flops(*e) for e in rec["op_shapes"])
    peak = PEAK_BF16_FLOPS if rec["peak_dtype"] in ("bfloat16", "float16") \
        else PEAK_FP32_FLOPS
    hk = rec["hand_kernels"]
    names = {"K1": "conv3x3_bn_relu", "K2": "flash_attention_fwd",
             "K3": "flash_attention_bwd_dq", "K4": "flash_attention_bwd_dkv",
             "K5": "flash_attention_bwd_dbias", "K6": "layer_norm"}
    kernel_ok = {}
    for k, per_shape in kernels.items():
        n = sum(c for c, _f in per_shape)
        want = sum(c * f for c, f in per_shape)
        got = hk.get(k, {"calls": 0, "flops": 0.0})
        kernel_ok[k] = dict(launches=launches[names[k]], calls=got["calls"],
                            flops=got["flops"], want_flops=want,
                            ok=got["calls"] == n == launches[names[k]] and
                            got["flops"] == want)
    emit(phase="cost_ledger", path=name, sig=rec["sig"],
         flops=rec["flops"], tflop=rec["flops"] / 1e12,
         transcendentals=rec["transcendentals"],
         bytes_accessed=rec["bytes_accessed"],
         argument_bytes=rec["argument_bytes"],
         output_bytes=rec["output_bytes"], temp_bytes=rec["temp_bytes"],
         peak_bytes=rec["peak_bytes"], peak_mb=rec["peak_bytes"] / 2**20,
         aten_calls=rec["aten_calls"],
         hand_kernel_calls=rec["hand_kernel_calls"],
         estimated_step_ms=rec["estimated_step_s"] * 1e3,
         peak_dtype=rec["peak_dtype"], ms_per_step=ms,
         flops_per_s=rec["flops"] / (ms * 1e-3),
         share_of_peak=rec["flops"] / (ms * 1e-3) / peak,
         fence=dict(rtt_s=detail["fence_rtt_s"],
                    wall_s=detail["window_wall_s"]),
         contraction_counted=counted, contraction_analytic=analytic,
         contraction_rel=abs(counted - analytic) / analytic,
         hand_kernels=kernel_ok, top_ops=rec["top_ops"][:6])
    checks = {"contraction_flops_within_2pct":
              abs(counted - analytic) <= LEDGER_TOL * analytic,
              "kernel_work_times_launches":
              all(v["ok"] for v in kernel_ok.values()),
              "peak_measured": rec["peak_bytes"] is not None and
              rec["peak_bytes"] > rec["argument_bytes"]}
    _fail_unless("cost_ledger " + name, checks)
    return rec, ms


def phase_cost_ledger():
    """Device-cost ledger records (``Executor.cost_record``) of BERT-base
    training at phase train's configuration, the ResNet-50 step of
    resnet_train and the BERT-base serving buckets
    (``warmup(ledger=True)``), each beside its measured ms a step
    (``timing.timed_steps``) and its FLOPs a second as a share of its
    dtype's peak; fails unless the counted contraction FLOPs match the
    analytic count within 2% and K1-K5's counted FLOPs equal their
    launches times their kernel_work."""
    t0 = time.perf_counter()
    out = {}
    # BERT-base training, phase train's configuration
    cfg = bert.base_config(attn_dropout=0.0)
    main, startup, o = _build_pretrain(cfg)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    feed = _train_feed(cfg, BT, SEED)
    L = cfg.num_layers
    heads, seq = cfg.num_heads, cfg.max_seq_len
    att = dict(bh=BT * heads, sq=seq, sk=seq,
               d=cfg.hidden_size // heads, esz=4)
    kernels = {"K2": [(L, kernel_work("K2", lse=True, **att)[0])],
               "K3": [(L, kernel_work("K3", **att)[0])],
               "K4": [(L, kernel_work("K4", **att)[0])]}
    rec, ms = _ledger_path("bert_train", exe, main, feed, [o["loss"]],
                           scope, kernels)
    out["bert_train"] = dict(tflop=rec["flops"] / 1e12, ms=ms)
    del main, startup, scope, exe
    torch.cuda.empty_cache()
    # ResNet-50, resnet_train's program (pure bf16, K1 on)
    from paddle_tpu_torch.fluid import flags
    flags.set_flag("conv_pallas", True)
    main, startup, loss = _resnet_program()
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    feed = {k: torch.from_numpy(v).to("cuda")
            for k, v in _resnet_feed(RN_BATCH, SEED).items()}
    kernels = {"K1": [(n, kernel_work("K1", n=RN_BATCH, h=hw, w=hw, c=c, o=c,
                                      esz=2)[0])
                      for hw, c, n in RESNET_K1_SHAPES]}
    rec, ms = _ledger_path("resnet50_train", exe, main, feed, [loss], scope,
                           kernels)
    out["resnet50_train"] = dict(tflop=rec["flops"] / 1e12, ms=ms)
    del main, startup, scope, exe, feed
    torch.cuda.empty_cache()
    # BERT-base serving buckets
    cfg = bert.base_config()
    main, startup, enc = _build_bert(cfg)
    infer = main.clone(for_test=True)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    specs = {n: ((cfg.max_seq_len, 1), "float32" if n == "input_mask"
                 else "int64") for n in FEEDS}
    sv = fluid.ServingExecutor(program=infer, feed_specs=specs,
                               fetch_list=[enc], scope=scope, executor=exe,
                               max_batch=8)
    _reset_launches()
    sv.warmup(ledger=True)
    sv.close()
    recs = sv.ledger_records
    rows, checks = [], {}
    f1 = recs[1]["flops"]
    for b in sv.buckets:
        r = recs[b]
        feeds = {n: np.zeros((b,) + sample, dtype)
                 for n, (sample, dtype) in specs.items()}
        dt, _ = timing.timed_steps(
            lambda i, f=feeds: exe.run(infer, feed=f, fetch_list=[enc],
                                       scope=scope, return_numpy=False),
            LEDGER_STEPS, warmup=1)
        ms = dt / LEDGER_STEPS * 1e3
        k2 = kernel_work("K2", bh=b * cfg.num_heads, sq=cfg.max_seq_len,
                         sk=cfg.max_seq_len,
                         d=cfg.hidden_size // cfg.num_heads, esz=4)[0]
        rows.append(dict(bucket=b, tag=r["tag"], flops=r["flops"],
                         bytes_accessed=r["bytes_accessed"],
                         peak_mb=r["peak_bytes"] / 2**20,
                         estimated_step_ms=r["estimated_step_s"] * 1e3,
                         ms_per_batch=ms, peak_dtype=r["peak_dtype"],
                         share_of_peak=r["flops"] / (ms * 1e-3) /
                         PEAK_FP32_FLOPS,
                         k2_calls=r["hand_kernels"]["K2"]["calls"]))
        checks["b%d_flops_linear" % b] = \
            abs(r["flops"] - b * f1) <= 1e-9 * b * f1
        checks["b%d_k2_work" % b] = \
            r["hand_kernels"]["K2"]["calls"] == cfg.num_layers and \
            r["hand_kernels"]["K2"]["flops"] == cfg.num_layers * k2
    emit(phase="cost_ledger", path="bert_serving", buckets=rows,
         checks=checks)
    _fail_unless("cost_ledger serving", checks)
    out["bert_serving"] = {r["bucket"]: dict(tflop=r["flops"] / 1e12,
                                             ms=r["ms_per_batch"])
                           for r in rows}
    emit(phase="cost_ledger_done", seconds=time.perf_counter() - t0)
    return out


def phase_op_bench():
    """``fluid/benchmark.py``'s resnet50 suite (batch 256) and bert suite
    (batch 64) on the card: one row per entry, ms (fwd + bwd), TFLOP/s
    by the JAX package's estimates, GB/s, and the ledger's counted
    FLOPs; fails on any entry that errs, and unless the counted FLOPs of
    every conv2d / mul / matmul entry lie within 2% of the estimate."""
    from paddle_tpu_torch.fluid import benchmark
    t0 = time.perf_counter()
    checks = {}
    for suite, entries in (
            ("resnet50", benchmark.resnet50_suite(RN_BATCH)),
            ("bert", benchmark.bert_suite(OP_BENCH_BERT_BATCH))):
        rows = benchmark.run_suite(entries, steps=OP_BENCH_STEPS, warmup=2,
                                   place=fluid.CUDAPlace(0), progress=False)
        for r in rows:
            emit(phase="op_bench", suite=suite, key=r["key"], op=r["op"],
                 count=r["count"], ms=r["ms"], total_ms=r["total_ms"],
                 tflops=r.get("tflops"), gbps=r.get("gbps"),
                 flops_est=r.get("flops"),
                 counted_flops=r.get("counted_flops"),
                 error=r.get("error"))
            ok = "error" not in r and r["ms"] > 0
            if ok and r["op"] in ("conv2d", "mul", "matmul"):
                ok = abs(r["counted_flops"] - r["flops"]) <= \
                    LEDGER_TOL * r["flops"]
            checks["%s: %s" % (suite, r["key"])] = ok
        print(benchmark.format_table(
            rows, "%s per-op costs on %s" % (suite, _card())), flush=True)
    emit(phase="op_bench_done", seconds=time.perf_counter() - t0,
         entries=len(checks))
    _fail_unless("op_bench", checks)


def _cf_programs(pkg=fluid):
    """The control-flow programs of the JAX package's control-flow and
    LoD tests and the branch gradients: {name: (build, feed)}, each
    build returning its fetch list under program_guard."""
    L = pkg.layers

    def while_acc():
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        limit = L.fill_constant(shape=[1], dtype="int64", value=10)
        acc = L.fill_constant(shape=[1], dtype="float32", value=0.0)
        cond = L.less_than(x=i, y=limit)
        w = L.While(cond=cond)
        with w.block():
            one = L.fill_constant(shape=[1], dtype="float32", value=2.0)
            L.assign(acc + one, output=acc)
            L.increment(x=i, value=1, in_place=True)
            L.less_than(x=i, y=limit, cond=cond)
        return [i, acc]

    def while_array():
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        limit = L.fill_constant(shape=[1], dtype="int64", value=5)
        arr = L.create_array("float32", max_len=8)
        x = L.fill_constant(shape=[3], dtype="float32", value=1.0)
        cond = L.less_than(x=i, y=limit)
        w = L.While(cond=cond)
        with w.block():
            L.array_write(x * L.cast(i, "float32"), i, array=arr)
            L.increment(x=i, value=1, in_place=True)
            L.less_than(x=i, y=limit, cond=cond)
        st = L.tensor.create_tensor("float32")
        n = L.array_length(arr)
        pkg.default_main_program().current_block().append_op(
            "tensor_array_to_tensor", inputs={"X": [arr]},
            outputs={"Out": [st], "OutIndex": []},
            attrs={"axis": 0, "use_stack": True})
        return [st, n]

    def cond_fn(flag, grad):
        def build():
            x = L.data(name="x", shape=[4], dtype="float32",
                       append_batch_size=False)
            x.stop_gradient = False
            pred = L.greater_than(L.fill_constant([1], "float32", flag),
                                  L.fill_constant([1], "float32", 0.5))
            out = L.cond(pred, lambda: L.reduce_sum(x * 2.0),
                         lambda: L.reduce_mean(x + 2.0))
            return [out] + (list(pkg.gradients(out, [x])) if grad else [])
        return build

    def cond_outer():
        lr = L.tensor.create_global_var(shape=[1], value=1.0,
                                        dtype="float32", persistable=True,
                                        name="cond_lr")
        L.assign(L.fill_constant([1], "float32", 1.0), output=lr)
        pred = L.greater_than(L.fill_constant([1], "float32", 1.0),
                              L.fill_constant([1], "float32", 0.0))

        def true_fn():
            L.assign(L.fill_constant([1], "float32", 42.0), output=lr)

        L.cond(pred, true_fn, lambda: None)
        return [lr]

    def switch(step_val):
        def build():
            step = L.fill_constant(shape=[1], dtype="float32", value=step_val)
            lr = L.tensor.create_global_var(shape=[1], value=0.0,
                                            dtype="float32",
                                            persistable=True, name="sw_lr")
            b1 = L.fill_constant(shape=[1], dtype="float32", value=1.0)
            b2 = L.fill_constant(shape=[1], dtype="float32", value=10.0)
            with L.Switch() as sw:
                for c, v in ((L.less_than(step, b1), 0.1),
                             (L.less_than(step, b2), 0.2)):
                    with sw.case(c):
                        L.assign(L.fill_constant([1], "float32", v),
                                 output=lr)
                with sw.default():
                    L.assign(L.fill_constant([1], "float32", 0.3),
                             output=lr)
            return [lr]
        return build

    def ifelse():
        x = L.data(name="x", shape=[1], dtype="float32")
        cond = L.greater_than(x, L.fill_constant([1], "float32", 0.0))
        ie = L.IfElse(cond)
        with ie.true_block():
            ie.output(x * 2.0)
        with ie.false_block():
            ie.output(x - 1.0)
        return [ie()]

    def cond_block_grad(flag):
        def build():
            main = pkg.default_main_program()
            x = L.data("x", [4], dtype="float32")
            x.stop_gradient = False
            out = main.global_block().create_var(name="out", shape=(-1, 4),
                                                 dtype="float32")
            L.assign(x, out)
            pred = L.less_than(L.fill_constant([1], "float32", 0.0),
                               L.fill_constant([1], "float32", flag))
            cb = L.control_flow.ConditionalBlock([pred])
            with cb.block():
                L.assign(L.scale(x, scale=3.0), out)
            return list(pkg.gradients(L.mean(out), [x])) + [out]
        return build

    def past_capacity():
        arr = L.create_array("float32", max_len=4)
        i = L.fill_constant([1], "int64", 6)
        L.array_write(L.fill_constant([3], "float32", 2.0), i, array=arr)
        return [L.array_length(arr), L.array_read(arr, i)]

    def raw(specs, fetch, feed):
        def build():
            block = pkg.default_main_program().global_block()
            for n, v in feed.items():
                block.create_var(name=n, shape=np.shape(v), is_data=True,
                                 dtype=str(np.asarray(v).dtype))
            made = set(block.vars)
            for tp, ins, outs, attrs in specs:
                for names in outs.values():
                    for n in names:
                        if n not in made:
                            block.create_var(name=n)
                            made.add(n)
                block.append_op(tp, inputs=ins, outputs=outs, attrs=attrs)
            return fetch
        return build

    rng = np.random.RandomState(SEED)
    x3 = rng.randn(3, 4, 2).astype(np.float32)
    ln3 = np.array([4, 2, 3], np.int64)
    for b, n in enumerate(ln3):
        x3[b, n:] = 0
    table = ("lod_rank_table", {"X": ["x"], "Length": ["l"]},
             {"Out": ["t"]}, {})
    lod_feeds = {
        "lod_rank_table": {"x": np.zeros((3, 5, 2), np.float32),
                           "l": np.array([2, 5, 3], np.int64)},
        "lod_array_round_trip": {"x": x3, "l": ln3},
        "shrink_rnn_memory": {
            "x": np.arange(6, dtype=np.float32).reshape(3, 2) + 1,
            "l": np.array([3, 1, 2], np.int64),
            "i": np.array([1], np.int64)},
        "split_merge_lod_tensor": {
            "x": np.arange(8, dtype=np.float32).reshape(4, 2),
            "m": np.array([[1], [0], [1], [0]], np.int32)}}
    progs = {
        "while_acc": (while_acc, {}),
        "while_array": (while_array, {}),
        "cond_true": (cond_fn(1.0, False), {"x": [1.0, 2.0, 3.0, 1.0]}),
        "cond_false": (cond_fn(0.0, False), {"x": [1.0, 2.0, 3.0, 1.0]}),
        "cond_outer_write": (cond_outer, {}),
        "switch_0": (switch(0.0), {}),
        "switch_5": (switch(5.0), {}),
        "switch_50": (switch(50.0), {}),
        "ifelse": (ifelse, {"x": [[1.0], [-2.0], [3.0]]}),
        "cond_block_grad_taken": (cond_block_grad(1.0),
                                  {"x": np.ones((2, 4))}),
        "cond_block_grad_not_taken": (cond_block_grad(-1.0),
                                      {"x": np.ones((2, 4))}),
        "cond_grad_true": (cond_fn(1.0, True), {"x": [1.0, 2.0, 3.0, 1.0]}),
        "cond_grad_false": (cond_fn(0.0, True), {"x": [1.0, 2.0, 3.0, 1.0]}),
        "array_past_capacity": (past_capacity, {}),
        "lod_rank_table": ([table, ("max_sequence_len",
                                   {"RankTable": ["t"]}, {"Out": ["m"]},
                                   {})], ["t", "m"]),
        "lod_array_round_trip": ([
            table,
            ("lod_tensor_to_array", {"X": ["x"], "RankTable": ["t"]},
             {"Out": ["arr"]}, {}),
            ("array_to_lod_tensor", {"X": ["arr"], "RankTable": ["t"]},
             {"Out": ["back"]}, {}),
            ("reorder_lod_tensor_by_rank", {"X": ["x"], "RankTable": ["t"]},
             {"Out": ["ro"]}, {})], ["back", "ro"]),
        "shrink_rnn_memory": ([
            table,
            ("shrink_rnn_memory", {"X": ["x"], "I": ["i"],
                                   "RankTable": ["t"]}, {"Out": ["o"]}, {}),
            ("rnn_memory_helper", {"X": ["x"]}, {"Out": ["h"]}, {})],
            ["o", "h"]),
        "split_merge_lod_tensor": ([
            ("split_lod_tensor", {"X": ["x"], "Mask": ["m"]},
             {"OutTrue": ["t"], "OutFalse": ["f"]}, {}),
            ("merge_lod_tensor", {"InTrue": ["t"], "InFalse": ["f"],
                                  "Mask": ["m"], "X": ["x"]},
             {"Out": ["o"]}, {})], ["t", "f", "o"]),
    }
    for n, f in lod_feeds.items():
        specs, fetch = progs[n]
        progs[n] = (raw(specs, fetch, f), f)
    return {n: (b, {k: np.asarray(v, np.float32) if np.asarray(v).dtype
                    == np.float64 else np.asarray(v) for k, v in f.items()})
            for n, (b, f) in progs.items()}


# closed forms of the control-flow programs (their first fetch or two)
CF_EXPECT = {"while_acc": ([10], [20.0]), "cond_true": (14.0,),
             "cond_false": (3.75,), "cond_outer_write": ([42.0],),
             "switch_0": ([0.1],), "switch_5": ([0.2],),
             "switch_50": ([0.3],),
             "cond_block_grad_taken": (np.full((2, 4), 0.5),),
             "cond_block_grad_not_taken": (np.full((2, 4), 0.125),),
             "cond_grad_true": (14.0, np.full(4, 2.0)),
             "cond_grad_false": (3.75, np.full(4, 0.25)),
             "array_past_capacity": ([7], [2.0, 2.0, 2.0])}
# while iterations of each loop program: its condition is read N + 1 times
CF_WHILE_ITERS = {"while_acc": 10, "while_array": 5}


def phase_control_flow():
    """The control-flow and LoD-array programs (``_cf_programs``) on the
    card against the port's CPU path: integers equal, floats within
    1e-6, the closed forms of CF_EXPECT; the host syncs each run makes
    (``while``: N + 1 reads for N iterations; ``cond``,
    ``conditional_block``: one a run) counted."""
    t0 = time.perf_counter()
    checks, rows = {}, []
    tags = ("while", "cond", "conditional_block")
    for name, (build, feed) in _cf_programs().items():
        got = {}
        for where, place in (("card", fluid.CUDAPlace(0)),
                             ("cpu", fluid.CPUPlace())):
            main, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(main, startup), \
                    fluid.unique_name.guard():
                fetch = build()
            scope = fluid.Scope()
            exe = fluid.Executor(place)
            exe.run(startup, scope=scope)
            s0 = {t: fluid.profiler.host_sync_count(t) for t in tags}
            out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
            got[where] = (
                [np.asarray(v) for v in out],
                {t: fluid.profiler.host_sync_count(t) - s0[t] for t in tags})
        card, card_syncs = got["card"]
        cpu, cpu_syncs = got["cpu"]
        err = 0.0
        ok = len(card) == len(cpu)
        for a, b in zip(card, cpu):
            ok = ok and a.shape == b.shape and a.dtype == b.dtype
            if ok and a.dtype.kind == "f":
                err = max(err, float(np.abs(a - b).max()) if a.size else 0)
            elif ok:
                ok = bool(np.array_equal(a, b))
        ok = ok and err <= 1e-6
        for want, a in zip(CF_EXPECT.get(name, ()), card):
            ok = ok and bool(np.allclose(a, want, rtol=1e-6, atol=1e-7))
        if name in CF_WHILE_ITERS:
            ok = ok and card_syncs["while"] == CF_WHILE_ITERS[name] + 1
        ok = ok and not any(cpu_syncs.values())
        rows.append(dict(program=name, max_abs_err=err,
                         syncs_card=card_syncs, ok=ok))
        checks[name] = ok
    emit(phase="control_flow", programs=rows,
         seconds=time.perf_counter() - t0)
    _fail_unless("control_flow", checks)


# -- sequence, RNN and CTC ops; CRNN-CTC ------------------------------------

SEQ_TOL = {"plain": (1e-5, 1e-6),   # float32 rules: rtol, atol
           "scan": (1e-4, 1e-5),    # recurrences and warpctc (step sums)
           "exact": (0.0, 0.0)}     # edit distances, chunk_eval's rates
SEQ_LENS = np.array([5, 1, 3, 0], np.int64)
GRU_CASES = ((False, False), (True, False), (False, True), (True, True))
CHUNK_SCHEMES = ("IOB", "IOE", "IOBES", "plain")
CUDNN_CASES = {"one_layer": (1, False), "two_layers_bidirec": (2, True)}


def _seq_data(pkg, name, arr, grad=True):
    v = pkg.layers.data(name, list(arr.shape), dtype=str(arr.dtype),
                        append_batch_size=False)
    v.stop_gradient = not grad
    return v


def _seq_with_grads(pkg, outs, wrt, cs):
    """``outs`` + the gradients over ``wrt`` of ``sum_i mean(outs[i] *
    c_i)``, ``cs`` the (feed name, array) of each output's ``c``."""
    loss = None
    for out, (name, c) in zip(outs, cs):
        term = pkg.layers.mean(pkg.layers.elementwise_mul(
            out, _seq_data(pkg, name, c, False)))
        loss = term if loss is None else \
            pkg.layers.elementwise_add(loss, term)
    return list(outs) + list(pkg.gradients(loss, wrt))


def _seq_params(pkg):
    return pkg.default_main_program().global_block().all_parameters()


def _seq_op_output(pkg, op_type, slot):
    ops = [o for o in pkg.default_main_program().global_block().ops
           if o.type == op_type]
    return ops[-1].output(slot)[0]


def seq_weights(build, seed):
    """{parameter: ``0.5·randn`` from ``seed``} for every parameter that
    ``build`` creates (None: no parameters, the startup's draws)."""
    if seed is None:
        return {}
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        build(fluid)
    rng = np.random.RandomState(seed)
    return {p.name: (rng.randn(*p.shape) * 0.5).astype(np.float32)
            for p in main.global_block().all_parameters()}


def _cudnn_blob(rng, I, H, layers, ndir):
    """A flat cudnn_lstm weight blob in cuDNN's order (W_i, W_h of every
    layer and direction, then their biases)."""
    parts, biases = [], []
    for layer in range(layers):
        il = I if layer == 0 else H * ndir
        for _ in range(ndir):
            parts += [rng.randn(4 * H * il) * 0.4, rng.randn(4 * H * H) * 0.4]
            biases += [rng.randn(4 * H) * 0.1, rng.randn(4 * H) * 0.1]
    return np.concatenate(parts + biases).astype(np.float32)


def seq_programs():
    """The programs of the 25 sequence, RNN and CTC op types, one a type
    (tests/test_torch_sequence_rnn_ops.py holds each against the JAX
    package): {name: (build(pkg) -> fetch list, feed, weight seed or
    None, tolerance class of SEQ_TOL)}.  Each runs its op (every mode
    of it the op has, side by side) through the layer a user calls, a
    raw op for cudnn_lstm, then the gradients of ``mean(out * c)`` over
    its float inputs and parameters."""
    progs = {}

    def c_(rng, *shape):
        return rng.randn(*shape).astype(np.float32)

    def add(name, build, feed, seed=None, tol="plain"):
        progs[name] = (build, feed, seed, tol)

    L = SEQ_LENS
    rng = np.random.RandomState(20)
    x2, x3, c2, c3 = (c_(rng, 4, 6), c_(rng, 4, 6, 1), c_(rng, 4, 6),
                      c_(rng, 4, 6, 1))

    def softmax(pkg):
        lens = _seq_data(pkg, "lens", L, False)
        a, b = _seq_data(pkg, "x2", x2), _seq_data(pkg, "x3", x3)
        return _seq_with_grads(
            pkg, [pkg.layers.sequence_softmax(a, length=lens),
                  pkg.layers.sequence_softmax(b, length=lens)], [a, b],
            [("c2", c2), ("c3", c3)])
    add("sequence_softmax", softmax,
        {"x2": x2, "x3": x3, "lens": L, "c2": c2, "c3": c3})

    rng = np.random.RandomState(21)
    xr, cr = c_(rng, 4, 6, 3), c_(rng, 4, 6, 3)

    def reverse(pkg):
        xv = _seq_data(pkg, "x", xr)
        return _seq_with_grads(pkg, [pkg.layers.sequence_reverse(
            xv, length=_seq_data(pkg, "lens", L, False))], [xv], [("c", cr)])
    add("sequence_reverse", reverse, {"x": xr, "lens": L, "c": cr})

    rng = np.random.RandomState(22)
    xa, ca = c_(rng, 4, 3), c_(rng, 4, 6, 3)

    def expand_as(pkg):
        xv = _seq_data(pkg, "x", xa)
        return _seq_with_grads(pkg, [pkg.layers.sequence_expand_as(
            xv, length=_seq_data(pkg, "lens", L, False), maxlen=6)], [xv],
            [("c", ca)])
    add("sequence_expand_as", expand_as, {"x": xa, "lens": L, "c": ca})

    rng = np.random.RandomState(23)
    xe, ce = c_(rng, 4, 6, 3), c_(rng, 4, 7, 3)
    le, re_ = np.array([2, 1, 3, 0], np.int64), np.array([5, 7, 3, 2],
                                                         np.int64)

    def expand(pkg):
        xv = _seq_data(pkg, "x", xe)
        return _seq_with_grads(pkg, [pkg.layers.sequence_expand(
            xv, length=_seq_data(pkg, "lens", le, False),
            ref_length=_seq_data(pkg, "ref", re_, False), max_out_len=7)],
            [xv], [("c", ce)])
    add("sequence_expand", expand,
        {"x": xe, "lens": le, "ref": re_, "c": ce})

    rng = np.random.RandomState(24)
    xp, pv = c_(rng, 12, 3), np.array([-2.5], np.float32)
    cp1, cp2 = c_(rng, 4, 6, 3), c_(rng, 4, 6, 3)

    def pad(pkg):
        xv = _seq_data(pkg, "x", xp)
        lens = _seq_data(pkg, "lens", L, False)
        o1, l1 = pkg.layers.sequence_pad(xv, maxlen=6, length=lens)
        o2, _ = pkg.layers.sequence_pad(
            xv, pad_value=_seq_data(pkg, "pv", pv, False), maxlen=6,
            length=lens)
        return _seq_with_grads(pkg, [o1, o2], [xv],
                               [("c1", cp1), ("c2", cp2)]) + [l1]
    add("sequence_pad", pad,
        {"x": xp, "lens": L, "pv": pv, "c1": cp1, "c2": cp2})

    rng = np.random.RandomState(25)
    xu, cu = c_(rng, 4, 6, 3), c_(rng, 24, 3)

    def unpad(pkg):
        xv = _seq_data(pkg, "x", xu)
        return _seq_with_grads(pkg, [pkg.layers.sequence_unpad(
            xv, length=_seq_data(pkg, "lens", L, False))], [xv], [("c", cu)])
    add("sequence_unpad", unpad, {"x": xu, "lens": L, "c": cu})

    rng = np.random.RandomState(26)
    ka, kb, kc = c_(rng, 4, 5, 3), c_(rng, 4, 3, 3), c_(rng, 4, 8, 3)
    la, lb = np.array([5, 0, 2, 1], np.int64), np.array([1, 3, 0, 2],
                                                        np.int64)

    def concat(pkg):
        av, bv = _seq_data(pkg, "a", ka), _seq_data(pkg, "b", kb)
        out, oln = pkg.layers.sequence_concat(
            [av, bv], length=[_seq_data(pkg, "la", la, False),
                              _seq_data(pkg, "lb", lb, False)])
        return _seq_with_grads(pkg, [out], [av, bv], [("c", kc)]) + [oln]
    add("sequence_concat", concat,
        {"a": ka, "b": kb, "la": la, "lb": lb, "c": kc})

    rng = np.random.RandomState(27)
    xs, cs_ = c_(rng, 4, 6, 3), c_(rng, 4, 6, 3)
    off, ln = np.array([1, 0, 2, 5], np.int64), np.array([3, 1, 1, 2],
                                                         np.int64)

    def slice_(pkg):
        xv = _seq_data(pkg, "x", xs)
        return _seq_with_grads(pkg, [pkg.layers.sequence_slice(
            xv, _seq_data(pkg, "off", off, False),
            _seq_data(pkg, "ln", ln, False))], [xv], [("c", cs_)])
    add("sequence_slice", slice_, {"x": xs, "off": off, "ln": ln, "c": cs_})

    ids = np.random.RandomState(28).randint(1, 9, (4, 6)).astype(np.int64)

    def enumerate_(pkg):
        return [pkg.layers.sequence_enumerate(
            _seq_data(pkg, "ids", ids, False), win_size=3, pad_value=-1,
            length=_seq_data(pkg, "lens", L, False))]
    add("sequence_enumerate", enumerate_, {"ids": ids, "lens": L})

    rng = np.random.RandomState(30)
    D = 4
    xg, h0 = c_(rng, 4, 6, 3 * D), c_(rng, 4, D)
    cg = [("c%d" % k, c_(rng, 4, 6, D)) for k in range(len(GRU_CASES))]

    def gru(pkg):
        xv, hv = _seq_data(pkg, "x", xg), _seq_data(pkg, "h0", h0)
        lens = _seq_data(pkg, "lens", L, False)
        outs = [pkg.layers.dynamic_gru(
            xv, size=D, length=lens, h_0=hv if k < 2 else None,
            is_reverse=rev, origin_mode=orig)
            for k, (rev, orig) in enumerate(GRU_CASES)]
        return _seq_with_grads(pkg, outs, [xv, hv] + _seq_params(pkg), cg)
    add("gru", gru, dict(cg, x=xg, h0=h0, lens=L), 30, "scan")

    rng = np.random.RandomState(31)
    xi = c_(rng, 2, 3, 7, 9)
    ci = c_(rng, 2, 4 * 9, 18)

    def im2sequence(pkg):
        xv = _seq_data(pkg, "x", xi)
        return _seq_with_grads(pkg, [pkg.layers.im2sequence(
            xv, filter_size=[3, 2], stride=[2, 1], padding=[1, 0, 2, 1])],
            [xv], [("c", ci)])
    add("im2sequence", im2sequence, {"x": xi, "c": ci})

    rng = np.random.RandomState(32)
    xw, cw = c_(rng, 4, 6, 5), c_(rng, 4, 6, 5)

    def row_conv(pkg):
        xv = _seq_data(pkg, "x", xw)
        out = pkg.layers.row_conv(xv, future_context_size=2)
        return _seq_with_grads(pkg, [out], [xv] + _seq_params(pkg),
                               [("c", cw)])
    add("row_conv", row_conv, {"x": xw, "c": cw}, 32)

    rng = np.random.RandomState(33)
    xl, hl, cl = c_(rng, 4, 3), c_(rng, 4, 5), c_(rng, 4, 5)
    cl1, cl2 = c_(rng, 4, 5), c_(rng, 4, 5)

    def lstm_unit(pkg):
        # the JAX layer calls a ``concat`` its ``nn`` module lacks: its
        # side builds the layer's ops by hand
        xv, hv, cv = (_seq_data(pkg, n, a) for n, a in
                      (("x", xl), ("h", hl), ("cp", cl)))
        if pkg is fluid:
            ho, co = pkg.layers.lstm_unit(xv, hv, cv, forget_bias=1.0)
        else:
            gates = pkg.layers.fc(pkg.layers.concat([xv, hv], axis=-1),
                                  size=20)
            block = pkg.default_main_program().global_block()
            ho, co = (block.create_var(name=n, dtype="float32")
                      for n in ("lstm_unit_h", "lstm_unit_c"))
            block.append_op("lstm_unit",
                            inputs={"X": [gates], "C_prev": [cv]},
                            outputs={"C": [co], "H": [ho]},
                            attrs={"forget_bias": 1.0})
        return _seq_with_grads(pkg, [ho, co], [xv, hv, cv] +
                               _seq_params(pkg), [("c1", cl1), ("c2", cl2)])
    add("lstm_unit", lstm_unit,
        {"x": xl, "h": hl, "cp": cl, "c1": cl1, "c2": cl2}, 33)

    rng = np.random.RandomState(34)
    xq, hq = c_(rng, 4, 3 * D), c_(rng, 4, D)
    cq = [("c%d" % k, c_(rng, 4, (3 if k % 3 == 2 else 1) * D))
          for k in range(6)]

    def gru_unit(pkg):
        xv, hv = _seq_data(pkg, "x", xq), _seq_data(pkg, "h", hq)
        outs = []
        for origin_mode in (False, True):
            outs += list(pkg.layers.gru_unit(xv, hv, size=3 * D,
                                             origin_mode=origin_mode))
        return _seq_with_grads(pkg, outs, [xv, hv] + _seq_params(pkg), cq)
    add("gru_unit", gru_unit, dict(cq, x=xq, h=hq), 34)

    # logits [4, 8, 6], blank 5: a repeated label (no skip between equal
    # labels), a short logit length, an empty label
    rng = np.random.RandomState(35)
    logits = c_(rng, 4, 8, 6)
    label = np.array([[1, 1, 2], [0, 3, 0], [4, 0, 0], [0, 0, 0]], np.int64)
    label_len = np.array([3, 2, 1, 0], np.int64)
    logit_len = np.array([8, 5, 3, 4], np.int64)
    rng = np.random.RandomState(36)
    cc1, cc2 = c_(rng, 4, 1), c_(rng, 4, 1)

    def warpctc(pkg):
        lv = _seq_data(pkg, "logits", logits)
        kw = dict(label=_seq_data(pkg, "label", label, False), blank=5,
                  input_length=_seq_data(pkg, "logit_len", logit_len, False),
                  label_length=_seq_data(pkg, "label_len", label_len, False))
        return _seq_with_grads(
            pkg, [pkg.layers.warpctc(lv, **kw),
                  pkg.layers.warpctc(lv, norm_by_times=True, **kw)], [lv],
            [("c1", cc1), ("c2", cc2)])
    add("warpctc", warpctc, {"logits": logits, "label": label,
                             "label_len": label_len, "logit_len": logit_len,
                             "c1": cc1, "c2": cc2}, tol="scan")

    rng = np.random.RandomState(37)
    hyp = rng.randint(0, 4, (5, 6)).astype(np.int64)
    ref = rng.randint(0, 4, (5, 5)).astype(np.int64)
    hlen = np.array([6, 3, 0, 4, 2], np.int64)
    rlen = np.array([5, 5, 2, 0, 3], np.int64)

    def edit_distance(pkg):
        kw = dict(input_length=_seq_data(pkg, "hl", hlen, False),
                  label_length=_seq_data(pkg, "rl", rlen, False))
        h = _seq_data(pkg, "hyp", hyp, False)
        r = _seq_data(pkg, "ref", ref, False)
        d, n = pkg.layers.edit_distance(h, r, normalized=False, **kw)
        dn, _ = pkg.layers.edit_distance(h, r, normalized=True, **kw)
        return [d, dn, n]
    add("edit_distance", edit_distance,
        {"hyp": hyp, "ref": ref, "hl": hlen, "rl": rlen}, tol="exact")

    eids = np.array([[2, 1, 5, 3, 2, 4], [5, 5, 1, 0, 0, 0],
                     [3, 2, 6, 0, 0, 0], [1, 2, 3, 4, 5, 6]], np.int64)
    elen = np.array([6, 3, 3, 0], np.int64)

    def erase(pkg):
        out = pkg.layers.sequence_erase(
            _seq_data(pkg, "ids", eids, False), tokens=[2, 5],
            length=_seq_data(pkg, "lens", elen, False))
        return [out, _seq_op_output(pkg, "sequence_erase", "OutLength")]
    add("sequence_erase", erase, {"ids": eids, "lens": elen})

    rng = np.random.RandomState(38)
    xh, ch = c_(rng, 4, 6, 4), c_(rng, 4, 3, 8)

    def reshape(pkg):
        xv = _seq_data(pkg, "x", xh)
        out = pkg.layers.sequence_reshape(
            xv, new_dim=8, length=_seq_data(pkg, "lens", L, False))
        return _seq_with_grads(pkg, [out], [xv], [("c", ch)]) + \
            [_seq_op_output(pkg, "sequence_reshape", "OutLength")]
    add("sequence_reshape", reshape, {"x": xh, "lens": L, "c": ch})

    # repeated and negative ids within a row add up; padding adds 0
    rng = np.random.RandomState(39)
    xt, upd, ct = c_(rng, 4, 8), c_(rng, 4, 3), c_(rng, 4, 8)
    sids = np.array([[1, 1, 7], [0, 2, 3], [-1, 4, 5], [6, 6, 6]], np.int64)
    slen = np.array([3, 1, 2, 0], np.int64)

    def scatter(pkg):
        xv, uv = _seq_data(pkg, "x", xt), _seq_data(pkg, "upd", upd)
        out = pkg.layers.sequence_scatter(
            xv, _seq_data(pkg, "ids", sids, False), uv,
            length=_seq_data(pkg, "lens", slen, False))
        return _seq_with_grads(pkg, [out], [xv, uv], [("c", ct)])
    add("sequence_scatter", scatter,
        {"x": xt, "upd": upd, "ids": sids, "lens": slen, "c": ct})

    rng = np.random.RandomState(40)
    inf = rng.randint(0, 13, (4, 10)).astype(np.int64)
    lab = np.where(rng.rand(4, 10) < 0.3, rng.randint(0, 13, (4, 10)),
                   inf).astype(np.int64)
    clen = np.array([10, 7, 4, 0], np.int64)

    def chunk_eval(pkg):
        iv = _seq_data(pkg, "inf", inf, False)
        lv = _seq_data(pkg, "lab", lab, False)
        ln_ = _seq_data(pkg, "lens", clen, False)
        fetch = []
        for s in CHUNK_SCHEMES:
            fetch += list(pkg.layers.chunk_eval(iv, lv, s, 3, length=ln_))
        return fetch
    add("chunk_eval", chunk_eval, {"inf": inf, "lab": lab, "lens": clen},
        tol="exact")

    rng = np.random.RandomState(41)
    xo, co = c_(rng, 2, 5, 6), c_(rng, 2, 5, 6)

    def position(pkg):
        xv = _seq_data(pkg, "x", xo)
        return _seq_with_grads(pkg, [pkg.layers.add_position_encoding(
            xv, alpha=0.5, beta=2.0)], [xv], [("c", co)])
    add("add_position_encoding", position, {"x": xo, "c": co})

    # argmax paths with repeats and blanks (blank 4), one row empty
    rng = np.random.RandomState(42)
    best = np.array([[1, 1, 4, 1, 2, 2, 4, 4], [4, 4, 4, 3, 3, 0, 0, 1],
                     [0, 4, 0, 0, 1, 1, 1, 1], [2, 2, 2, 2, 2, 2, 2, 2]])
    probs = rng.rand(4, 8, 5).astype(np.float32) * 0.5
    np.put_along_axis(probs, best[..., None], 1.0, axis=2)
    plen = np.array([8, 5, 4, 0], np.int64)

    def ctc_align(pkg):
        return list(pkg.layers.ctc_greedy_decoder(
            _seq_data(pkg, "p", probs, False), blank=4,
            length=_seq_data(pkg, "lens", plen, False)))
    add("ctc_align", ctc_align, {"p": probs, "lens": plen})

    rng = np.random.RandomState(43)
    xm = c_(rng, 4, 6, 16)
    cm = [("c%d" % k, c_(rng, 4, 6, 3 if k % 2 == 0 else 4))
          for k in range(4)]

    def lstmp(pkg):
        xv = _seq_data(pkg, "x", xm)
        lens = _seq_data(pkg, "lens", L, False)
        outs = []
        for is_reverse in (False, True):
            outs += list(pkg.layers.dynamic_lstmp(
                xv, size=16, proj_size=3, is_reverse=is_reverse,
                length=lens))
        return _seq_with_grads(pkg, outs, [xv] + _seq_params(pkg), cm)
    add("lstmp", lstmp, dict(cm, x=xm, lens=L), 43, "scan")

    # time-major input [T 5, B 3, I 4], H 3; W takes no gradient
    rng = np.random.RandomState(45)
    T, B, I, H = 5, 3, 4, 3
    xc = c_(rng, T, B, I)
    cfeed, ccs = {"x": xc}, []
    for name, (layers, bidirec) in CUDNN_CASES.items():
        ndir = 2 if bidirec else 1
        cfeed["w_" + name] = _cudnn_blob(rng, I, H, layers, ndir)
        cfeed["h_" + name] = c_(rng, layers * ndir, B, H)
        cfeed["cc_" + name] = c_(rng, layers * ndir, B, H)
        for slot, shape in (("o", (T, B, H * ndir)),
                            ("lh", (layers * ndir, B, H)),
                            ("lc", (layers * ndir, B, H))):
            ccs.append(("c%s_%s" % (slot, name), c_(rng, *shape)))
    cfeed.update(ccs)

    def cudnn_lstm(pkg):
        block = pkg.default_main_program().global_block()
        xv = _seq_data(pkg, "x", xc)
        outs, wrt = [], [xv]
        for name, (layers, bidirec) in CUDNN_CASES.items():
            hv = _seq_data(pkg, "h_" + name, cfeed["h_" + name])
            cv = _seq_data(pkg, "cc_" + name, cfeed["cc_" + name])
            wv = _seq_data(pkg, "w_" + name, cfeed["w_" + name], False)
            vs = [block.create_var(name="%s_%s" % (s, name),
                                   dtype="float32")
                  for s in ("o", "lh", "lc")]
            block.append_op(
                "cudnn_lstm",
                inputs={"Input": [xv], "InitH": [hv], "InitC": [cv],
                        "W": [wv]},
                outputs={"Out": [vs[0]], "last_h": [vs[1]],
                         "last_c": [vs[2]]},
                attrs={"hidden_size": H, "num_layers": layers,
                       "is_bidirec": bidirec, "input_size": I,
                       "dropout_prob": 0.0})
            outs += vs
            wrt += [hv, cv]
        return _seq_with_grads(pkg, outs, wrt, ccs)
    add("cudnn_lstm", cudnn_lstm, cfeed, tol="scan")

    # the default tree at 7 classes and at 8 (a power of two), and a
    # custom tree whose paths pad with -1
    rng = np.random.RandomState(46)
    xz = c_(rng, 6, 5)
    lab7 = rng.randint(0, 7, (6, 1)).astype(np.int64)
    lab8 = np.array([[0], [7], [3], [4], [1], [6]], np.int64)
    table = np.array([[0, 2, -1], [0, 1, 3], [0, -1, -1], [1, 3, 4],
                      [2, 4, -1], [0, 1, 2]], np.int64)
    code = rng.randint(0, 2, (6, 3)).astype(np.int64)
    cz = [("c%d" % k, c_(rng, 6, 1)) for k in range(3)]

    def hsigmoid(pkg):
        xv = _seq_data(pkg, "x", xz)
        outs = [pkg.layers.hsigmoid(
                    xv, _seq_data(pkg, "lab7", lab7, False), 7),
                pkg.layers.hsigmoid(
                    xv, _seq_data(pkg, "lab8", lab8, False), 8),
                pkg.layers.hsigmoid(
                    xv, _seq_data(pkg, "lab8c", lab8, False), 5,
                    path_table=_seq_data(pkg, "table", table, False),
                    path_code=_seq_data(pkg, "code", code, False),
                    is_custom=True)]
        return _seq_with_grads(pkg, outs, [xv] + _seq_params(pkg), cz)
    add("hierarchical_sigmoid", hsigmoid,
        dict(cz, x=xz, lab7=lab7, lab8=lab8, lab8c=lab8, table=table,
             code=code), 46)
    return progs


def seq_run(build, feed, weights, place, host_ops=("chunk_eval",)):
    """``build``'s port program on ``place`` from ``weights``: (fetches
    as numpy, the host syncs of the run by the ``host_ops`` op types, the
    ops of those types in it)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        fetch = build(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    if weights:
        fluid.load_numpy_params(scope, weights, place)
    counts = [fluid.profiler.host_sync_count(t) for t in host_ops]
    out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    syncs = sum(fluid.profiler.host_sync_count(t) - n
                for t, n in zip(host_ops, counts))
    return ([np.asarray(v) for v in out], syncs,
            sum(op.type in host_ops for op in main.global_block().ops))


def _programs_card_vs_cpu(phase, programs, tols, host_ops):
    """Each of ``programs`` ({name: (build, feed, weight seed, tolerance
    class)}) on the card against the port's CPU path, from the same
    weights: floats within ``tols`` of their class, integers equal; each
    op of ``host_ops`` reads its inputs back once a run on the card (one
    host sync), never on the CPU."""
    t0 = time.perf_counter()
    checks, rows = {}, []
    for name, (build, feed, seed, tol) in programs.items():
        weights = seq_weights(build, seed)
        card, card_syncs, n_host = seq_run(build, feed, weights,
                                           fluid.CUDAPlace(0), host_ops)
        cpu, cpu_syncs, _ = seq_run(build, feed, weights, fluid.CPUPlace(),
                                    host_ops)
        rtol, atol = tols[tol]
        ok, err = len(card) == len(cpu), 0.0
        for a, b in zip(card, cpu):
            ok = ok and a.shape == b.shape and a.dtype == b.dtype
            if not ok:
                break
            if a.dtype.kind == "f":
                ok = bool(np.allclose(a, b, rtol=rtol, atol=atol))
                err = max(err, float(np.abs(a - b).max()) if a.size else 0)
            else:
                ok = bool(np.array_equal(a, b))
            if not ok:
                break
        ok = ok and cpu_syncs == 0 and card_syncs == n_host
        rows.append(dict(op=name, fetches=len(card), max_abs_err=err,
                         tolerance=dict(rtol=rtol, atol=atol),
                         host_syncs_card=card_syncs, ok=ok))
        checks[name] = ok
    emit(phase=phase, card=_card(), ops=rows,
         seconds=time.perf_counter() - t0)
    _fail_unless(phase, checks)


def phase_sequence_ops():
    """The 25 sequence, RNN and CTC op types (``seq_programs``: forward
    and gradients) on the card against the port's CPU path, each from
    the same weights: floats within the CPU tests' tolerances (SEQ_TOL),
    integers equal; each chunk_eval op reads its inputs back once a run
    on the card (one ``chunk_eval`` host sync), never on the CPU."""
    _programs_card_vs_cpu("sequence_ops", seq_programs(), SEQ_TOL,
                          ("chunk_eval",))


CRNN_FEEDS = 4                # crnn_ctc_train: distinct batches, in turn
CRNN_LOSS_RTOL = 1e-4         # step-1 loss, card vs the port's CPU path
CRNN_DECODES = 5              # timed greedy decodes of the eval program


def _crnn_program(cfg, evaluate=False):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = crnn_ctc.build_eval(cfg) if evaluate else crnn_ctc.build(cfg)
    return main, startup, out


def phase_crnn_ctc_train():
    """CRNN-CTC text recognition (``models/crnn_ctc.py``, the model zoo's
    OCR program) at ``base_config()``: batch 32 of 48 x 512 images, T 64
    steps of 768 features, GRUs of 200, 96 classes.  Step 1 from the
    startup weights on the card and on the port's CPU path: losses within
    CRNN_LOSS_RTOL.  Then WARM_STEPS + TIMED_STEPS steps through Executor
    on the card over CRNN_FEEDS synthetic batches in turn: finite
    losses, no port kernel launched (none lies on this path); ms per
    step, peak memory, one profiled step's launches and busy share.  The
    eval program (greedy decode and edit distance) on the trained scope:
    ids ``[32, 64]`` in ``[0, 95)``, lengths at most 64, distances at
    most the longer length; ms per decode.  Returns the path's port
    kernel launches (none)."""
    t0 = time.perf_counter()
    cfg = crnn_ctc.base_config()
    main, startup, out = _crnn_program(cfg)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    it = crnn_ctc.feeds(cfg, SEED)
    host = [next(it) for _ in range(CRNN_FEEDS)]
    loss = out["loss"]
    card1 = float(_book_step(exe, main, loss, scope, host[0])[0][0]
                  .reshape(-1)[0])
    cpu1 = float(_book_step(fluid.Executor(fluid.CPUPlace()), main, loss,
                            scope, host[0])[0][0].reshape(-1)[0])
    feeds = [_cuda_feed(f) for f in host]
    torch.cuda.reset_peak_memory_stats()
    # the main path's run: counts go to 0 here and are read after it
    _reset_launches()
    got, step_ms = _train_steps(exe, main, feeds, [loss], scope)
    launches = _launches()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    losses = [float(g[0].reshape(-1)[0].item()) for g in got]
    prof, _ = _profile_record(exe, main, feeds[0], [loss], scope)
    emain, _, eout = _crnn_program(cfg, evaluate=True)
    efeed = feeds[0]
    ids, ids_len, dist, n = exe.run(emain, feed=efeed,
                                    fetch_list=eout["outs"], scope=scope)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(CRNN_DECODES):
        exe.run(emain, feed=efeed, fetch_list=eout["outs"], scope=scope,
                return_numpy=False)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t1) / CRNN_DECODES * 1e3
    T = crnn_ctc.steps(cfg)
    label_len = host[0]["label_len"]
    checks = {
        "losses_finite": bool(np.isfinite(losses).all()),
        "step1_card_vs_cpu": abs(card1 - cpu1) <= CRNN_LOSS_RTOL * abs(cpu1),
        "no_port_kernel": not any(launches.values()),
        "ids_shape": ids.shape == (cfg["batch"], T),
        "ids_in_classes": bool(((ids >= 0) & (ids < cfg["classes"])).all()),
        "lengths": bool(((ids_len >= 0) & (ids_len <= T)).all()),
        "distances": bool(np.isfinite(dist).all() and (dist >= 0).all() and
                          (dist[:, 0] <= np.maximum(ids_len,
                                                    label_len)).all()),
        "sequence_num": int(n) == cfg["batch"]}
    emit(phase="crnn_ctc_train", card=_card(), config=cfg, steps=len(losses),
         losses=losses, step1_loss_card=card1, step1_loss_cpu=cpu1,
         step1_rel_err=abs(card1 - cpu1) / abs(cpu1), ms_per_step=step_ms,
         images_per_s=cfg["batch"] / step_ms * 1e3, peak_device_mb=peak_mb,
         profiled_step=prof, launches=launches, ms_per_decode=decode_ms,
         decoded_head=ids[:2, :int(ids_len[:2].max())].tolist(),
         decoded_lengths=ids_len[:8].tolist(),
         edit_distances=dist[:8, 0].tolist(), checks=checks,
         seconds=time.perf_counter() - t0)
    _fail_unless("crnn_ctc_train", checks)
    return launches


DET_TOL = {"plain": (1e-5, 1e-6),    # float32 rules: rtol, atol
           "pixels": (1e-5, 1e-4),   # yolo_box: boxes in image pixels (up
           #                           to ~300), a sigmoid or exp ulp apart
           #                           between the card and the CPU moves
           #                           a coordinate near 0 by up to ~6e-5
           "solve": (1e-4, 1e-5),    # roi_perspective_transform's 8x8 solves
           "exact": (0.0, 0.0)}      # detection_map's mAP
DET_HOST_OPS = ("detection_map", "generate_mask_labels")


def _det_boxes(rng, n, size, lo=0.1, hi=0.4):
    """``n`` boxes ``[x1, y1, x2, y2]`` inside a square of side ``size``,
    sides from ``lo`` to ``hi`` of it."""
    wh = rng.uniform(lo, hi, (n, 2)) * size
    xy = rng.uniform(0.0, 1.0, (n, 2)) * (size - wh)
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def _det_with_grads(pkg, outs, wrt):
    """``outs`` + the gradients over ``wrt`` of ``sum_i mean(outs[i]²)``."""
    loss = None
    for out in outs:
        term = pkg.layers.mean(pkg.layers.square(out))
        loss = term if loss is None else \
            pkg.layers.elementwise_add(loss, term)
    return list(outs) + list(pkg.gradients(loss, wrt))


def _det_raw(pkg, op_type, inputs, outputs, attrs):
    """One ``op_type`` op appended by hand: ``outputs`` is {slot: dtype};
    returns the output variables in that order."""
    helper = pkg.layer_helper.LayerHelper(op_type)
    outs = {slot: helper.create_variable_for_type_inference(dt)
            for slot, dt in outputs.items()}
    helper.append_op(op_type, inputs=inputs,
                     outputs={k: [v] for k, v in outs.items()}, attrs=attrs)
    return [outs[k] for k in outputs]


def det_programs():
    """The programs of the 33 detection op types, one a type
    (tests/test_torch_detection_ops.py holds each against the JAX
    package): {name: (build(pkg) -> fetch list, feed, weight seed or
    None, tolerance class of DET_TOL)}.  Each runs its op through the
    layer a user calls (a hand-built op for ``mine_hard_examples`` and
    ``detection_map``, which have no layer), every mode the op has side
    by side, then the gradients of ``sum mean(out²)`` over the float
    inputs the op differentiates and its parameters."""
    progs = {}

    def add(name, build, feed, seed=None, tol="plain"):
        progs[name] = (build, feed, seed, tol)

    def f32(rng, *shape, s=1.0):
        return (rng.randn(*shape) * s).astype(np.float32)

    D = _seq_data
    rng = np.random.RandomState(60)
    ib, ib2, iy = (_det_boxes(rng, 10, 1.0).reshape(2, 5, 4),
                   _det_boxes(rng, 5, 1.0), _det_boxes(rng, 7, 1.0))

    def iou(pkg):
        a, b = D(pkg, "xb", ib), D(pkg, "x2", ib2)
        y = D(pkg, "y", iy, False)
        return _det_with_grads(pkg, [pkg.layers.iou_similarity(a, y),
                                     pkg.layers.iou_similarity(b, y)],
                               [a, b])
    add("iou_similarity", iou, {"xb": ib, "x2": ib2, "y": iy})

    rng = np.random.RandomState(61)
    sx, sy = f32(rng, 6, 4), f32(rng, 6, 4)
    siw = rng.uniform(0, 2, (6, 4)).astype(np.float32)
    sow = rng.uniform(0, 2, (6, 4)).astype(np.float32)

    def smooth_l1(pkg):
        x, y = D(pkg, "x", sx), D(pkg, "y", sy)
        return _det_with_grads(pkg, [
            pkg.layers.smooth_l1(x, y),
            pkg.layers.smooth_l1(x, y, D(pkg, "iw", siw, False),
                                 D(pkg, "ow", sow, False), sigma=1.5)],
            [x, y])
    add("smooth_l1_loss", smooth_l1, {"x": sx, "y": sy, "iw": siw,
                                      "ow": sow})

    pf = np.zeros((1, 2, 3, 4), np.float32)
    pim = np.zeros((1, 3, 24, 32), np.float32)

    def prior(pkg):
        feat, img = D(pkg, "feat", pf, False), D(pkg, "img", pim, False)
        b1, v1 = pkg.layers.prior_box(feat, img, [4.0, 8.0], [6.0, 12.0],
                                      [2.0, 3.0], flip=True, clip=True)
        b2, v2 = pkg.layers.prior_box(feat, img, [5.0], None, [2.0, 2.0],
                                      variance=(0.2, 0.2, 0.1, 0.1),
                                      steps=(7.0, 9.0), offset=0.3)
        return [b1, v1, b2, v2]
    add("prior_box", prior, {"feat": pf, "img": pim})

    rng = np.random.RandomState(62)
    cp = _det_boxes(rng, 6, 1.0)
    cpv = rng.uniform(0.1, 0.3, (6, 4)).astype(np.float32)
    ct2 = _det_boxes(rng, 3, 1.0)
    ct3 = _det_boxes(rng, 8, 1.0).reshape(2, 4, 4)
    ct3[1, 3] = 0.0                   # a zero padding row: the 1e-10 floor
    cdl = f32(rng, 3, 6, 4, s=0.5)
    cpx = _det_boxes(rng, 6, 20.0)

    def coder(pkg):
        prior_v = D(pkg, "prior", cp, False)
        pvar = D(pkg, "pvar", cpv, False)
        t2, t3, dl = D(pkg, "t2", ct2), D(pkg, "t3", ct3), D(pkg, "dl", cdl)
        enc2 = pkg.layers.box_coder(prior_v, pvar, t2)
        enc3 = pkg.layers.box_coder(prior_v, [0.1, 0.1, 0.2, 0.2], t3)
        dec0 = pkg.layers.box_coder(prior_v, pvar, dl,
                                    code_type="decode_center_size")
        dl_t = D(pkg, "dlt", np.ascontiguousarray(cdl.transpose(1, 0, 2)))
        dec1 = pkg.layers.box_coder(prior_v, pvar, dl_t,
                                    code_type="decode_center_size", axis=1)
        dec_px = pkg.layers.box_coder(
            D(pkg, "priorpx", cpx, False), [0.1, 0.1, 0.2, 0.2], dl,
            code_type="decode_center_size", box_normalized=False)
        return _det_with_grads(pkg, [enc2, enc3, dec0, dec1, dec_px],
                               [t2, t3, dl, dl_t])
    add("box_coder", coder, {"prior": cp, "pvar": cpv, "t2": ct2,
                             "t3": ct3, "dl": cdl,
                             "dlt": np.ascontiguousarray(
                                 cdl.transpose(1, 0, 2)),
                             "priorpx": cpx})

    rng = np.random.RandomState(63)
    nb = np.stack([_det_boxes(rng, 12, 1.0, 0.2, 0.5) for _ in range(2)])
    nb[:, 5] = nb[:, 4]                # an exact duplicate: IoU 1
    ns = rng.rand(2, 4, 12).astype(np.float32)
    ns[:, 2] *= 0.05                   # a class mostly under the threshold
    nbp = (nb * 40.0).astype(np.float32)

    def nms(pkg):
        b, s = D(pkg, "b", nb, False), D(pkg, "s", ns, False)
        return [pkg.layers.multiclass_nms(b, s, 0.03, 6, 10, 0.4),
                pkg.layers.multiclass_nms(b, s, 0.0, 12, 40, 0.3,
                                          background_label=-1),
                pkg.layers.multiclass_nms(D(pkg, "bp", nbp, False), s, 0.1,
                                          5, 8, 0.5, normalized=False,
                                          background_label=3)]
    add("multiclass_nms", nms, {"b": nb, "s": ns, "bp": nbp})

    rng = np.random.RandomState(64)
    bd = rng.rand(2, 3, 8).astype(np.float32)
    bd[0, 1, 2] = bd[0, 2, 5] = bd[0].max() + 0.1    # a tie at the top
    bd[1, 0, :] = 0.0                                # a padding row
    bd2 = rng.rand(4, 6).astype(np.float32)

    def bip(pkg):
        d = D(pkg, "d", bd, False)
        i1, d1 = pkg.layers.bipartite_match(d)
        i2, d2 = pkg.layers.bipartite_match(d, "per_prediction", 0.4)
        i3, d3 = pkg.layers.bipartite_match(D(pkg, "d2", bd2, False))
        return [i1, d1, i2, d2, i3, d3]
    add("bipartite_match", bip, {"d": bd, "d2": bd2})

    rng = np.random.RandomState(65)
    tx = f32(rng, 2, 3, 4)
    tx4 = f32(rng, 2, 3, 5, 4)
    tlab = rng.randint(1, 6, (2, 3, 1)).astype(np.int32)
    tm = np.array([[0, -1, 2, 1, -1], [-1, 1, -1, -1, 0]], np.int32)
    tneg = np.array([[1, -1, -1], [2, 3, -1]], np.int32)

    def tassign(pkg):
        m = D(pkg, "m", tm, False)
        o1, w1 = pkg.layers.target_assign(D(pkg, "x", tx, False), m)
        o2, w2 = pkg.layers.target_assign(D(pkg, "x4", tx4, False), m,
                                          mismatch_value=0)
        o3, w3 = pkg.layers.target_assign(
            D(pkg, "lab", tlab, False), m,
            negative_indices=D(pkg, "neg", tneg, False), mismatch_value=0)
        return [o1, w1, o2, w2, o3, w3]
    add("target_assign", tassign, {"x": tx, "x4": tx4, "lab": tlab,
                                   "m": tm, "neg": tneg})

    rng = np.random.RandomState(66)
    mcl = rng.rand(2, 10).astype(np.float32)
    mcl[0, 7] = mcl[0, 3]                            # a tied loss
    mll = rng.rand(2, 10).astype(np.float32)
    mmi = np.array([[0, -1, -1, -1, 1, -1, -1, -1, -1, -1],
                    [-1, -1, 2, -1, -1, -1, -1, -1, -1, -1]], np.int32)
    mmd = rng.rand(2, 10).astype(np.float32) * 0.8

    def mine(pkg):
        ins = {"ClsLoss": [D(pkg, "cl", mcl, False)],
               "MatchIndices": [D(pkg, "mi", mmi, False)],
               "MatchDist": [D(pkg, "md", mmd, False)]}
        outs = {"NegIndices": "int32", "UpdatedMatchIndices": "int32"}
        a = _det_raw(pkg, "mine_hard_examples", ins, outs,
                     {"neg_pos_ratio": 3.0, "neg_dist_threshold": 0.5,
                      "mining_type": "max_negative"})
        b = _det_raw(pkg, "mine_hard_examples",
                     dict(ins, LocLoss=[D(pkg, "ll", mll, False)]), outs,
                     {"neg_pos_ratio": 3.0, "neg_dist_threshold": 0.5,
                      "mining_type": "hard_example", "sample_size": 4})
        return a + b
    add("mine_hard_examples", mine, {"cl": mcl, "mi": mmi, "md": mmd,
                                     "ll": mll})

    rng = np.random.RandomState(67)
    ix = f32(rng, 2, 3, 5, 7)

    def nearest(pkg):
        x = D(pkg, "x", ix)
        return _det_with_grads(pkg, [
            pkg.layers.resize_nearest(x, [9, 12]),
            pkg.layers.resize_nearest(x, [3, 4], align_corners=False),
            pkg.layers.resize_nearest(x, scale=2.0, align_corners=False)],
            [x])
    add("nearest_interp", nearest, {"x": ix})

    def bilinear(pkg):
        x = D(pkg, "x", ix)
        return _det_with_grads(pkg, [
            pkg.layers.resize_bilinear(x, [9, 12]),
            pkg.layers.resize_bilinear(x, [8, 10], align_corners=False,
                                       align_mode=0),
            pkg.layers.resize_bilinear(x, [4, 5], align_corners=False,
                                       align_mode=1),
            pkg.layers.image_resize(x, [6, 6], resample="NEAREST")], [x])
    add("bilinear_interp", bilinear, {"x": ix})

    rng = np.random.RandomState(68)
    yx = f32(rng, 2, 2 * (5 + 3), 4, 4)
    ysz = np.array([[320, 256], [200, 300]], np.int32)

    def yolo(pkg):
        boxes, scores = pkg.layers.yolo_box(
            D(pkg, "x", yx, False), D(pkg, "sz", ysz, False),
            [10, 13, 16, 30], 3, 0.4, 32)
        return [boxes, scores]
    add("yolo_box", yolo, {"x": yx, "sz": ysz}, tol="pixels")

    rng = np.random.RandomState(69)
    rx = f32(rng, 2, 3, 8, 8)
    rr = _det_boxes(rng, 4, 14.0, 0.05, 0.6)
    rbid = np.array([0, 1, 1, 0], np.int32)

    def align(pkg):
        x = D(pkg, "x", rx)
        rois, bid = D(pkg, "r", rr, False), D(pkg, "bid", rbid, False)
        return _det_with_grads(pkg, [
            pkg.layers.roi_align(x, rois, 2, 3, 0.5, -1, bid),
            pkg.layers.roi_align(x, rois, 3, 2, 0.5, 3, bid)], [x])
    add("roi_align", align, {"x": rx, "r": rr, "bid": rbid})

    rng = np.random.RandomState(70)
    dpb = _det_boxes(rng, 5, 30.0)
    dpv = np.array([0.1, 0.1, 0.2, 0.2], np.float32)
    dtb = f32(rng, 5, 12, s=0.5)
    dtb[0, 2] = 9.0                                  # past box_clip
    dsc = rng.rand(5, 3).astype(np.float32)

    def dec_assign(pkg):
        t = D(pkg, "t", dtb)
        dec, asg = pkg.layers.box_decoder_and_assign(
            D(pkg, "p", dpb, False), D(pkg, "v", dpv, False), t,
            D(pkg, "s", dsc, False), 4.135)
        return _det_with_grads(pkg, [dec, asg], [t])
    add("box_decoder_and_assign", dec_assign,
        {"p": dpb, "v": dpv, "t": dtb, "s": dsc})

    rng = np.random.RandomState(71)
    fr = [_det_boxes(rng, 6, 64.0), _det_boxes(rng, 5, 64.0)]
    fs = [rng.rand(6, 1).astype(np.float32), rng.rand(5, 1).astype(
        np.float32)]
    fs[1][2, 0] = fs[0][4, 0]                        # a tie across levels

    def collect(pkg):
        rois = [D(pkg, "r%d" % k, r, False) for k, r in enumerate(fr)]
        sc = [D(pkg, "s%d" % k, s, False) for k, s in enumerate(fs)]
        return [pkg.layers.collect_fpn_proposals(rois, sc, 2, 3, 8),
                pkg.layers.collect_fpn_proposals(rois, sc, 2, 3, 15)]
    add("collect_fpn_proposals", collect,
        {"r0": fr[0], "r1": fr[1], "s0": fs[0], "s1": fs[1]})

    rng = np.random.RandomState(72)
    dr = np.concatenate([_det_boxes(rng, 4, 100.0, 0.05, 0.2),
                         _det_boxes(rng, 4, 800.0, 0.2, 0.5),
                         _det_boxes(rng, 3, 300.0, 0.3, 0.6)])

    def distribute(pkg):
        multi, restore = pkg.layers.distribute_fpn_proposals(
            D(pkg, "r", dr, False), 2, 5, 4, 224)
        return list(multi) + [restore]
    add("distribute_fpn_proposals", distribute, {"r": dr})

    rng = np.random.RandomState(73)
    yl_x = f32(rng, 2, 2 * (5 + 3), 4, 4)
    yl_box = np.array([[[0.3, 0.4, 0.2, 0.3], [0.7, 0.2, 0.5, 0.4],
                        [0.0, 0.0, 0.0, 0.0]],
                       [[0.55, 0.6, 0.1, 0.15], [0.1, 0.9, 0.3, 0.2],
                        [0.8, 0.8, 0.35, 0.3]]], np.float32)
    yl_lab = np.array([[1, 2, 0], [0, 2, 1]], np.int32)
    yl_sc = rng.uniform(0.5, 1.0, (2, 3)).astype(np.float32)

    def yolov3(pkg):
        x = D(pkg, "x", yl_x)
        box, lab = D(pkg, "box", yl_box, False), D(pkg, "lab", yl_lab, False)
        l1 = pkg.layers.yolov3_loss(x, box, lab, [10, 13, 16, 30, 33, 23,
                                                  30, 61, 62, 45],
                                    [2, 3], 3, 0.5, 32)
        obj = _seq_op_output(pkg, "yolov3_loss", "ObjectnessMask")
        match = _seq_op_output(pkg, "yolov3_loss", "GTMatchMask")
        l2 = pkg.layers.yolov3_loss(x, box, lab, [10, 13, 16, 30, 33, 23],
                                    [0, 1], 3, 0.2, 32,
                                    gt_score=D(pkg, "gs", yl_sc, False),
                                    use_label_smooth=False)
        return _det_with_grads(pkg, [l1, l2], [x]) + [obj, match]
    add("yolov3_loss", yolov3, {"x": yl_x, "box": yl_box, "lab": yl_lab,
                                "gs": yl_sc})

    rng = np.random.RandomState(74)
    flx = f32(rng, 6, 4)
    flb = rng.randint(0, 5, (6, 1)).astype(np.int32)
    fln = np.array([3], np.int32)

    def focal(pkg):
        x = D(pkg, "x", flx)
        lab, fg = D(pkg, "lab", flb, False), D(pkg, "fg", fln, False)
        return _det_with_grads(pkg, [
            pkg.layers.sigmoid_focal_loss(x, lab, fg),
            pkg.layers.sigmoid_focal_loss(x, lab, fg, gamma=1.5,
                                          alpha=0.4)], [x])
    add("sigmoid_focal_loss", focal, {"x": flx, "lab": flb, "fg": fln})

    rng = np.random.RandomState(75)
    cb = (rng.rand(2, 5, 4) * 60 - 10).astype(np.float32)
    cim = np.array([[40, 30, 1.0], [20, 20, 0.5]], np.float32)

    def bclip(pkg):
        b = D(pkg, "b", cb)
        return _det_with_grads(pkg, [pkg.layers.box_clip(
            b, D(pkg, "im", cim, False))], [b])
    add("box_clip", bclip, {"b": cb, "im": cim})

    af = np.zeros((1, 2, 3, 4), np.float32)

    def anchors(pkg):
        feat = D(pkg, "f", af, False)
        a1, v1 = pkg.layers.anchor_generator(feat, [32.0, 64.0],
                                             [0.5, 1.0, 2.0],
                                             stride=[16.0, 16.0])
        a2, v2 = pkg.layers.anchor_generator(feat, [20.0], [1.5],
                                             variance=(1.0, 1.0, 1.0, 1.0),
                                             stride=[8.0, 12.0], offset=0.3)
        return [a1, v1, a2, v2]
    add("anchor_generator", anchors, {"f": af})

    dim = np.zeros((1, 3, 32, 32), np.float32)

    def density(pkg):
        feat, img = D(pkg, "f", af, False), D(pkg, "img", dim, False)
        b1, v1 = pkg.layers.density_prior_box(feat, img, [2, 1],
                                              [8.0, 16.0], [1.0, 2.0])
        b2, v2 = pkg.layers.density_prior_box(feat, img, [3], [12.0],
                                              clip=True, flatten_to_2d=True)
        return [b1, v1, b2, v2]
    add("density_prior_box", density, {"f": af, "img": dim})

    rng = np.random.RandomState(76)
    pg = f32(rng, 1, 4, 3, 5)

    def polygon(pkg):
        return [pkg.layers.polygon_box_transform(D(pkg, "x", pg, False))]
    add("polygon_box_transform", polygon, {"x": pg})

    rng = np.random.RandomState(77)
    px_ = f32(rng, 2, 3, 8, 8)
    pr = _det_boxes(rng, 4, 15.0, 0.1, 0.7)

    def rpool(pkg):
        x = D(pkg, "x", px_)
        rois, bid = D(pkg, "r", pr, False), D(pkg, "bid", rbid, False)
        return _det_with_grads(pkg, [
            pkg.layers.roi_pool(x, rois, 2, 3, 0.5, bid),
            pkg.layers.roi_pool(x, rois, 3, 3, 0.25, bid)], [x])
    add("roi_pool", rpool, {"x": px_, "r": pr, "bid": rbid})

    rng = np.random.RandomState(78)
    psx = f32(rng, 2, 8, 6, 6)
    psr = _det_boxes(rng, 3, 11.0, 0.2, 0.8)
    psb = np.array([1, 0, 1], np.int32)

    def psroi(pkg):
        x = D(pkg, "x", psx)
        return _det_with_grads(pkg, [pkg.layers.psroi_pool(
            x, D(pkg, "r", psr, False), 2, 0.5, 2, 2,
            D(pkg, "bid", psb, False))], [x])
    add("psroi_pool", psroi, {"x": psx, "r": psr, "bid": psb})

    rng = np.random.RandomState(79)
    H = W = 4
    A = 3
    gps = rng.rand(2, A, H, W).astype(np.float32)
    gpd = f32(rng, 2, 4 * A, H, W, s=0.1)
    gpi = np.array([[64.0, 64.0, 1.0], [60.0, 50.0, 2.0]], np.float32)
    gpa = np.zeros((H, W, A, 4), np.float32)
    for y in range(H):
        for x in range(W):
            for a in range(A):
                cx, cy, sz = x * 16 + 8, y * 16 + 8, 8 * (a + 1)
                gpa[y, x, a] = [cx - sz, cy - sz, cx + sz, cy + sz]
    gpv = np.full((H, W, A, 4), 1.0, np.float32)

    def proposals(pkg):
        args = [D(pkg, k, v, False) for k, v in
                (("s", gps), ("d", gpd), ("i", gpi), ("a", gpa), ("v", gpv))]
        r1, p1 = pkg.layers.generate_proposals(*args, pre_nms_top_n=20,
                                               post_nms_top_n=5,
                                               nms_thresh=0.7, min_size=0.0)
        r2, p2 = pkg.layers.generate_proposals(*args, pre_nms_top_n=30,
                                               post_nms_top_n=40,
                                               nms_thresh=0.5, min_size=4.0)
        return [r1, p1, r2, p2]
    add("generate_proposals", proposals,
        {"s": gps, "d": gpd, "i": gpi, "a": gpa, "v": gpv})

    rng = np.random.RandomState(80)
    ra = gpa.reshape(-1, 4)
    rgt = np.array([[2, 2, 20, 22], [30, 34, 60, 62], [0, 0, 0, 0]],
                   np.float32)
    rbp = f32(rng, 1, 4 * A, H, W)
    rcl = f32(rng, 1, A, H, W)
    rgl = np.array([[2], [1], [0]], np.int32)

    def rpn(pkg):
        bp, cl = D(pkg, "bp", rbp), D(pkg, "cl", rcl)
        anc, var = D(pkg, "a", ra, False), D(pkg, "v", ra, False)
        gt = D(pkg, "gt", rgt, False)
        sc, loc, tl, tb, iw = pkg.layers.rpn_target_assign(
            bp, cl, anc, var, gt, rpn_batch_size_per_im=16,
            rpn_fg_fraction=0.25, use_random=False)
        idx = [_seq_op_output(pkg, "rpn_target_assign", s)
               for s in ("LocationIndex", "ScoreIndex")]
        return _det_with_grads(pkg, [sc, loc, tb, iw], [bp, cl]) + \
            [tl] + idx
    add("rpn_target_assign", rpn, {"bp": rbp, "cl": rcl, "a": ra, "v": ra,
                                   "gt": rgt})

    def retina(pkg):
        bp = D(pkg, "bp", rbp)
        cl = D(pkg, "cl", np.ascontiguousarray(rcl.repeat(2, 1)))
        anc, var = D(pkg, "a", ra, False), D(pkg, "v", ra, False)
        sc, loc, tl, tb, iw, fg = pkg.layers.retinanet_target_assign(
            bp, cl, anc, var, D(pkg, "gt", rgt, False),
            D(pkg, "gl", rgl, False), num_classes=2, positive_overlap=0.3,
            negative_overlap=0.2)
        idx = [_seq_op_output(pkg, "retinanet_target_assign", s)
               for s in ("LocationIndex", "ScoreIndex")]
        return _det_with_grads(pkg, [sc, loc, tb, iw], [bp, cl]) + \
            [tl, fg] + idx
    add("retinanet_target_assign", retina,
        {"bp": rbp, "cl": np.ascontiguousarray(rcl.repeat(2, 1)), "a": ra,
         "v": ra, "gt": rgt, "gl": rgl})

    rng = np.random.RandomState(81)
    lr_ = np.concatenate([np.array([[1, 1, 16, 16], [0, 2, 14, 15]],
                                   np.float32), _det_boxes(rng, 8, 64.0)])
    lgt = np.array([[0, 0, 15, 15]], np.float32)
    lgc = np.array([3], np.int32)

    def labels(pkg):
        outs = pkg.layers.generate_proposal_labels(
            D(pkg, "r", lr_, False), D(pkg, "gc", lgc, False), None,
            D(pkg, "gb", lgt, False), batch_size_per_im=8, fg_fraction=0.5,
            fg_thresh=0.5, bg_thresh_hi=0.5, bg_thresh_lo=0.0, class_nums=5,
            use_random=False)
        return list(outs)
    add("generate_proposal_labels", labels, {"r": lr_, "gc": lgc,
                                             "gb": lgt})

    rng = np.random.RandomState(82)
    rd_a = [_det_boxes(rng, 6, 64.0, 0.1, 0.3),
            _det_boxes(rng, 3, 64.0, 0.3, 0.6)]
    rd_b = [f32(rng, 2, 6, 4, s=0.2), f32(rng, 2, 3, 4, s=0.2)]
    rd_s = [rng.rand(2, 6, 3).astype(np.float32),
            rng.rand(2, 3, 3).astype(np.float32)]
    rd_i = np.array([[64, 64, 1.0], [80, 60, 1.25]], np.float32)

    def retina_out(pkg):
        bb = [D(pkg, "b%d" % k, v, False) for k, v in enumerate(rd_b)]
        ss = [D(pkg, "s%d" % k, v, False) for k, v in enumerate(rd_s)]
        aa = [D(pkg, "a%d" % k, v, False) for k, v in enumerate(rd_a)]
        im = D(pkg, "im", rd_i, False)
        return [pkg.layers.retinanet_detection_output(bb, ss, aa, im, 0.3,
                                                      5, 12, 0.4),
                pkg.layers.retinanet_detection_output(bb, ss, aa, im, 0.05,
                                                      100, 40, 0.3)]
    add("retinanet_detection_output", retina_out,
        dict({"b%d" % k: v for k, v in enumerate(rd_b)},
             **{"s%d" % k: v for k, v in enumerate(rd_s)},
             **{"a%d" % k: v for k, v in enumerate(rd_a)}, im=rd_i))

    det = np.array([[[1, 0.9, 0, 0, 10, 10], [1, 0.7, 50, 50, 60, 60],
                     [2, 0.8, 20, 20, 31, 29], [2, 0.6, 21, 19, 30, 30],
                     [-1, 0, 0, 0, 0, 0]],
                    [[2, 0.95, 5, 5, 15, 15], [1, 0.5, 0, 0, 9, 11],
                     [1, 0.4, 30, 30, 40, 40], [-1, 0, 0, 0, 0, 0],
                     [-1, 0, 0, 0, 0, 0]]], np.float32)
    gtm = np.array([[[1, 0, 0, 10, 10, 0], [2, 20, 20, 30, 30, 0],
                     [1, 50, 48, 61, 60, 1]],
                    [[2, 6, 4, 15, 16, 0], [1, 30, 30, 40, 41, 0],
                     [-1, 0, 0, 0, 0, 0]]], np.float32)

    def dmap(pkg):
        ins = {"DetectRes": [D(pkg, "d", det, False)],
               "Label": [D(pkg, "l", gtm, False)]}
        outs = {"MAP": "float32", "AccumPosCount": "int32",
                "AccumTruePos": "float32", "AccumFalsePos": "float32"}
        got = []
        for ap, diff in (("integral", True), ("11point", False)):
            got += _det_raw(pkg, "detection_map", ins, outs,
                            {"overlap_threshold": 0.5,
                             "evaluate_difficult": diff, "ap_type": ap})
        return got
    add("detection_map", dmap, {"d": det, "l": gtm}, tol="exact")

    mrois = np.array([[0, 0, 8, 8], [2, 2, 10, 12], [1, 0, 9, 6],
                      [0, 0, 4, 4]], np.float32)
    mlab = np.array([[2], [1], [0], [2]], np.int32)
    mgc = np.array([2, 1], np.int32)
    msegs = np.array([[[0, 0], [4, 0], [4, 8], [0, 8], [-1, -1],
                       [-1, -1]],
                      [[3, 3], [10, 2], [9, 11], [5, 12], [2, 8],
                       [-1, -1]]], np.float32)
    minfo = np.array([[16, 16, 1.0]], np.float32)

    def masks(pkg):
        outs = pkg.layers.generate_mask_labels(
            D(pkg, "i", minfo, False), D(pkg, "gc", mgc, False), None,
            D(pkg, "gs", msegs, False), D(pkg, "r", mrois, False),
            D(pkg, "l", mlab, False), 3, 4)
        return list(outs)
    add("generate_mask_labels", masks, {"i": minfo, "gc": mgc, "gs": msegs,
                                        "r": mrois, "l": mlab})

    rng = np.random.RandomState(83)
    tx_ = f32(rng, 2, 2, 8, 8)
    tq = np.array([[1, 1, 6, 0.5, 7, 6, 0.5, 7],
                   [2, 3, 9, 2, 8, 9, 3, 8.5]], np.float32)
    tbid = np.array([1, 0], np.int32)

    def persp(pkg):
        x = D(pkg, "x", tx_)
        return _det_with_grads(pkg, [pkg.layers.roi_perspective_transform(
            x, D(pkg, "q", tq, False), 4, 5, 0.9,
            D(pkg, "bid", tbid, False))], [x])
    add("roi_perspective_transform", persp, {"x": tx_, "q": tq,
                                             "bid": tbid}, tol="solve")

    rng = np.random.RandomState(84)
    dcx = f32(rng, 2, 4, 6, 6)
    dco = f32(rng, 2, 2 * 2 * 9, 6, 6, s=0.8)
    dcm = rng.rand(2, 2 * 9, 6, 6).astype(np.float32)
    dco2 = f32(rng, 2, 2 * 4, 3, 3, s=0.8)

    def deform(pkg):
        x, off, m = D(pkg, "x", dcx), D(pkg, "o", dco), D(pkg, "m", dcm)
        off2 = D(pkg, "o2", dco2)
        y1 = pkg.layers.deformable_conv(x, off, m, 6, 3, padding=1,
                                        groups=2, deformable_groups=2,
                                        bias_attr=True)
        y2 = pkg.layers.deformable_conv(x, off2, None, 3, 2, stride=2,
                                        dilation=1)
        return _det_with_grads(pkg, [y1, y2],
                               [x, off, m, off2] + _seq_params(pkg))
    add("deformable_conv", deform, {"x": dcx, "o": dco, "m": dcm,
                                    "o2": dco2}, 85)

    rng = np.random.RandomState(86)
    dpx = f32(rng, 2, 8, 7, 7)
    dpr = _det_boxes(rng, 3, 12.0, 0.2, 0.7)
    dptr = f32(rng, 3, 2, 2, 2, s=0.5)

    def deform_pool(pkg):
        x, tr = D(pkg, "x", dpx), D(pkg, "tr", dptr)
        rois = D(pkg, "r", dpr, False)
        y1 = pkg.layers.deformable_roi_pooling(
            x, rois, tr, spatial_scale=0.5, group_size=[2],
            pooled_height=2, pooled_width=2, part_size=[2, 2],
            sample_per_part=2, trans_std=0.1, position_sensitive=True)
        y2 = pkg.layers.deformable_roi_pooling(
            x, rois, None, no_trans=True, pooled_height=2, pooled_width=1,
            sample_per_part=2)
        return _det_with_grads(pkg, [y1, y2], [x, tr])
    add("deformable_psroi_pooling", deform_pool, {"x": dpx, "r": dpr,
                                                  "tr": dptr})
    return progs


def phase_detection_ops():
    """The 33 detection op types (``det_programs``: forward and
    gradients) on the card against the port's CPU path, each from the
    same weights: floats within the CPU tests' tolerances (DET_TOL),
    integer outputs and keep masks equal; ``detection_map`` and
    ``generate_mask_labels`` read their inputs back once an op a run on
    the card (one host sync each), never on the CPU."""
    _programs_card_vs_cpu("detection_ops", det_programs(), DET_TOL,
                          DET_HOST_OPS)


SSD_FEEDS = 4                 # ssd_train: distinct batches, in turn
SSD_CPU_BATCH = 8             # step 1, card vs the port's CPU path
SSD_LOSS_RTOL = 1e-3          # ... its loss: 35 batch norms, the last on
#                               1 x 1 maps over 8 values, amplify cuDNN's
#                               and the CPU's roundings (~1e-5 at the head
#                               of a CPU run against JAX's at batch 4)
SSD_EVALS = 3                 # timed eval batches (detection + mAP)
SSD_HEAD_BATCH = 8            # ssd_head_k1: the six maps at base widths
SSD_HEAD_TOL = {"float32": K1_FP32_TOL, "bfloat16": K1_BF16_TOL}


def _conv_flops(main, batch=None):
    """The forward FLOPs of ``main``'s convolutions from their static
    shapes (2 x multiply-adds), the work that dominates a CNN's step; a
    training step's convolutions do about three times it.  ``batch``
    stands for a batch dimension the program leaves at -1."""
    block = main.global_block()
    total = 0
    for op in block.ops:
        if op.type in ("conv2d", "depthwise_conv2d"):
            O, cg, kh, kw = block.var(op.input("Filter")[0]).shape
            N, _, Ho, Wo = block.var(op.output("Output")[0]).shape
            N = batch if N < 0 else N
            total += 2 * N * Ho * Wo * O * cg * kh * kw
    return total


def _ssd_program(cfg, evaluate=False):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = ssd.build_eval(cfg) if evaluate else ssd.build(cfg)
    return main, startup, out


def phase_ssd_train():
    """MobileNet-SSD (``models/ssd.py``, the model zoo's detector) at
    ``base_config()``: batch 64 of 300 x 300 images, 1917 priors, 21
    classes, RMSProp on the piecewise rate with L2 decay.  Step 1 from the
    startup weights at batch SSD_CPU_BATCH of the same widths, on the card
    and on the port's CPU path: losses within SSD_LOSS_RTOL.  Then
    WARM_STEPS + TIMED_STEPS steps through Executor on the card over
    SSD_FEEDS synthetic batches in turn: finite losses, no port kernel
    launched (none lies on this path), no host sync in a step (the host
    sync counter over the steps, and torch's sync debug mode over one
    step whose fetch stays on the card); ms per step, peak memory, one
    profiled step's launches and busy share.  The eval program
    (``detection_output`` + ``detection_map``) on the trained scope: the
    ``[64, 200, 6]`` slab, labels -1 or in ``[1, 21)``, the mAP in [0, 1],
    one ``detection_map`` host sync a run; ms per eval batch.  Returns
    the path's port kernel launches (none)."""
    t0 = time.perf_counter()
    cfg = ssd.base_config()
    main, startup, out = _ssd_program(cfg)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    loss = out["loss"]
    small = dict(cfg, batch=SSD_CPU_BATCH)
    smain, _, sout = _ssd_program(small)
    shost = next(ssd.feeds(small, SEED))
    card1 = float(_book_step(exe, smain, sout["loss"], scope, shost)[0][0]
                  .reshape(-1)[0])
    cpu1 = float(_book_step(fluid.Executor(fluid.CPUPlace()), smain,
                            sout["loss"], scope, shost)[0][0].reshape(-1)[0])
    it = ssd.feeds(cfg, SEED)
    host = [next(it) for _ in range(SSD_FEEDS)]
    feeds = [_cuda_feed(f) for f in host]
    torch.cuda.reset_peak_memory_stats()
    syncs0 = fluid.profiler.host_sync_count()
    # the main path's run: counts go to 0 here and are read after it
    _reset_launches()
    got, step_ms = _train_steps(exe, main, feeds, [loss], scope)
    launches = _launches()
    step_syncs = fluid.profiler.host_sync_count() - syncs0
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    losses = [float(g[0].reshape(-1)[0].item()) for g in got]
    sites = _sync_sites(lambda: exe.run(
        main, feed=feeds[0], fetch_list=[loss], scope=scope,
        return_numpy=False))
    prof, _ = _profile_record(exe, main, feeds[0], [loss], scope)
    emain, _, eout = _ssd_program(cfg, evaluate=True)
    m0 = fluid.profiler.host_sync_count("detection_map")
    slab, mean_ap = exe.run(emain, feed=feeds[0], fetch_list=eout["outs"],
                            scope=scope)
    map_syncs = fluid.profiler.host_sync_count("detection_map") - m0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for k in range(SSD_EVALS):
        exe.run(emain, feed=feeds[k % len(feeds)], fetch_list=eout["outs"],
                scope=scope)
    eval_ms = (time.perf_counter() - t1) / SSD_EVALS * 1e3
    labels = slab[..., 0]
    kept = labels >= 0
    checks = {
        "losses_finite": bool(np.isfinite(losses).all()),
        "step1_card_vs_cpu": abs(card1 - cpu1) <= SSD_LOSS_RTOL * abs(cpu1),
        "no_port_kernel": not any(launches.values()),
        "no_host_sync_in_a_step": step_syncs == 0 and not sites,
        "slab_shape": slab.shape == (cfg["batch"], 200, 6),
        "slab_labels": bool(((labels == -1) | ((labels >= 1) &
                                                (labels < cfg["classes"])))
                            .all()) and bool(kept.any()),
        "slab_finite": bool(np.isfinite(slab).all()),
        "map_in_range": 0.0 <= float(mean_ap[0]) <= 1.0,
        "map_one_sync": map_syncs == 1}
    fwd_flops = _conv_flops(main)
    emit(phase="ssd_train", card=_card(), config=cfg, steps=len(losses),
         priors=ssd.num_priors(cfg), program_ops=len(main.global_block().ops),
         conv_gflop_forward=fwd_flops / 1e9,
         conv_tflops_per_s_step=3 * fwd_flops / step_ms / 1e9,
         conv_bound_ms_fp32=3 * fwd_flops / PEAK_FP32_FLOPS * 1e3,
         losses=losses, step1_loss_card=card1,
         step1_loss_cpu=cpu1, step1_rel_err=abs(card1 - cpu1) / abs(cpu1),
         step1_batch=SSD_CPU_BATCH, ms_per_step=step_ms,
         images_per_s=cfg["batch"] / step_ms * 1e3, peak_device_mb=peak_mb,
         host_syncs_over_steps=step_syncs, step_sync_sites=sites,
         profiled_step=prof, launches=launches, ms_per_eval_batch=eval_ms,
         eval_slab_shape=list(slab.shape), kept_rows=int(kept.sum()),
         mean_ap=float(mean_ap[0]), detection_map_syncs=map_syncs,
         checks=checks, seconds=time.perf_counter() - t0)
    _fail_unless("ssd_train", checks)
    return launches


def _ssd_head_program(dtype, sides, widths, classes):
    """multi_box_head with the layer's own 3x3 heads (``kernel_size=3,
    pad=1``) over six data maps of the given sides and widths."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    cfg = ssd.base_config()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        maps = [fluid.layers.data("m%d" % k, [SSD_HEAD_BATCH, c, s, s],
                                  dtype=dtype, append_batch_size=False)
                for k, (s, c) in enumerate(zip(sides, widths))]
        img = fluid.layers.data("image", [SSD_HEAD_BATCH, 3, 300, 300],
                                dtype=dtype, append_batch_size=False)
        locs, confs, _, _ = fluid.layers.multi_box_head(
            inputs=maps, image=img, base_size=300, num_classes=classes,
            aspect_ratios=[[2.], [2., 3.], [2., 3.], [2., 3.], [2., 3.],
                           [2., 3.]], min_ratio=20, max_ratio=90,
            min_sizes=cfg["min_sizes"], max_sizes=cfg["max_sizes"],
            offset=0.5, flip=True, kernel_size=3, pad=1)
    return main, startup, [locs, confs]


def phase_ssd_head_k1():
    """K1 at MobileNet-SSD's head shapes: ``multi_box_head`` with the
    layer's 3x3 heads under ``FLAGS_conv_pallas`` over the six maps at
    base widths (19², 10², 5², 3², 2², 1² by 512, 1024, 512, 256, 256,
    128; O = 12/63 on the first map, 24/126 on the others), in float32
    and bfloat16, against the same program with the flag off (cuDNN),
    from the same weights: max|diff| within K1's tolerances of
    max|flag off|, and one K1 launch a head conv (12), its variants as
    ``k1_plan`` plans them.  Returns the flag-on runs' port kernel
    launches."""
    from paddle_tpu_torch.fluid import flags
    t0 = time.perf_counter()
    sides = ssd.map_sides(ssd.base_config())
    widths = (512, 1024, 512, 256, 256, 128)
    classes = ssd.base_config()["classes"]
    rng = np.random.RandomState(SEED)
    rows, checks, total = [], {}, {n: 0 for n in KERNELS}
    for dt in ("float32", "bfloat16"):
        tdt = getattr(torch, dt)
        main, startup, fetch = _ssd_head_program(dt, sides, widths, classes)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup, scope=scope)
        feed = {"m%d" % k: torch.from_numpy(rng.randn(
            SSD_HEAD_BATCH, c, s, s).astype(np.float32)).to("cuda", tdt)
                for k, (s, c) in enumerate(zip(sides, widths))}
        feed["image"] = torch.zeros(SSD_HEAD_BATCH, 3, 300, 300,
                                    device="cuda", dtype=tdt)
        got = {}
        for on in (False, True):
            flags.set_flag("conv_pallas", on)
            try:
                _reset_launches()
                got[on] = [v.float().cpu().numpy() for v in exe.run(
                    main, feed=feed, fetch_list=fetch, scope=scope,
                    return_numpy=False)]
                torch.cuda.synchronize()
                if on:
                    launches = _launches()
                    variants = dict(conv3x3_bn_relu.launches_by_variant)
            finally:
                flags.set_flag("conv_pallas", False)
        for n, c in launches.items():
            total[n] += c
        want_variants = dict.fromkeys(K1_VARIANTS, 0)
        for s, c in zip(sides, widths):
            for o in (3 if s == sides[0] else 6) * np.array([4, classes]):
                want_variants[k1_plan(SSD_HEAD_BATCH, s, s, c, int(o), tdt)
                              ["variant"]] += 1
        err = max(float(np.abs(a - b).max() / np.abs(b).max())
                  for a, b in zip(got[True], got[False]))
        ok = err <= SSD_HEAD_TOL[dt] and \
            launches["conv3x3_bn_relu"] == 12 and \
            variants == want_variants and \
            all(np.isfinite(a).all() for a in got[True])
        rows.append(dict(dtype=dt, max_err_rel=err,
                         tolerance="max|diff| <= %g max|flag off|"
                         % SSD_HEAD_TOL[dt],
                         k1_launches=launches["conv3x3_bn_relu"],
                         variants=variants, want_variants=want_variants,
                         locs=list(got[True][0].shape),
                         confs=list(got[True][1].shape), ok=ok))
        checks[dt] = ok
    emit(phase="ssd_head_k1", card=_card(), sides=sides, widths=widths,
         batch=SSD_HEAD_BATCH, runs=rows, seconds=time.perf_counter() - t0)
    _fail_unless("ssd_head_k1", checks)
    return total


CORE_TOL = {"plain": (1e-5, 1e-6),   # float32 rules: rtol, atol
            "exact": (0.0, 0.0),     # shape/layout ops, selections
            "stats": None}           # uniform_random_batch_size_like:
#                                      the packages' and devices' random
#                                      streams differ, so its draws are
#                                      held by shape, dtype, range and
#                                      their mean and variance (URBSL_*)
URBSL_SIGMAS = 5.0            # mean and variance within 5 standard errors


def core_programs():
    """The programs of the 34 core op types of ROADMAP item 13c.3a and of
    ``fill_any_like`` (the op behind ``layers.ones_like``), one a type
    (tests/test_torch_core_ops.py holds each against the JAX package; the
    card's ``core_ops`` phase against the port's CPU path): {name:
    (build(pkg) -> fetch list, feed, weight seed or None, tolerance class
    of CORE_TOL)}.  Inputs, shapes and attributes follow
    the JAX package's own tests of each op (test_op_oracle_sweep*.py,
    test_sequence_ops.py, test_misc_ops2.py, test_misc_ops5.py), run
    through the layer a user calls where there is one, every mode side
    by side, with the points where the packages could part fed exactly:
    0 and the threshold for relu6, 0 for leaky_relu, the bounds of
    hard_sigmoid, tied extrema, tied sort keys, duplicate scatter ids,
    out-of-range gather and scatter indices, predictions on the auc bin
    edges.  Then the gradients of ``sum_i mean(out_i * c_i)`` (each
    ``c_i`` a fixed random array fed as ``c<i>``) over the float inputs
    the op differentiates and its parameters."""
    progs = {}
    D = _seq_data

    def add(name, build, feed, seed=None, tol="plain"):
        progs[name] = (build, feed, seed, tol)

    def f32(rng, *shape, lo=-2.0, hi=2.0):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    def grads(pkg, outs, wrt, feed_c):
        cs = sorted((k, v) for k, v in feed_c.items() if k.startswith("c"))
        return _seq_with_grads(pkg, outs, wrt, cs)

    def cs(rng, *shapes):
        return {"c%d" % i: rng.randn(*s).astype(np.float32)
                for i, s in enumerate(shapes)}

    # -- reductions: ties among the extrema, zeros in the products --------
    rng = np.random.RandomState(9)
    rx = f32(rng, 2, 3, 4)
    rx[0, 0, 2] = rx[0, 2, 2] = 5.0          # a tied max over dim 1
    rx[1, :, 1] = 5.0                        # three tied in one column
    rx[1, 2, 3] = rx[0, 1, 0] = -5.0         # tied min over dims 0, 2
    for name in ("reduce_max", "reduce_min"):
        c = cs(rng, (2, 4), (1, 3, 1), (1,), (2, 3, 4))

        def build(pkg, name=name, c=c):
            x = D(pkg, "x", rx)
            f = getattr(pkg.layers, name)
            outs = [f(x, dim=[1]), f(x, dim=[0, 2], keep_dim=True), f(x),
                    f(x, dim=[])]
            return grads(pkg, outs, [x], c)
        add(name, build, dict(c, x=rx))
    px = f32(rng, 2, 3, 4, lo=0.5, hi=1.5) * np.sign(rng.randn(2, 3, 4)) \
        .astype(np.float32)
    px[0, 1, 2] = 0.0                        # one zero in a row
    px[1, 0, 1] = px[1, 0, 3] = 0.0          # two zeros in a row
    pc = cs(rng, (2, 3), (1, 3, 1), (1,))

    def prod(pkg):
        x = D(pkg, "x", px)
        L = pkg.layers
        return grads(pkg, [L.reduce_prod(x, dim=[2]),
                           L.reduce_prod(x, dim=[0, 2], keep_dim=True),
                           L.reduce_prod(L.scale(x, 0.8))], [x], pc)
    add("reduce_prod", prod, dict(pc, x=px))

    # -- the attribute-carrying activations: kinks fed exactly --------------
    rng = np.random.RandomState(2)
    ax = f32(rng, 4, 5, lo=-3.0, hi=8.0)
    ax[0, :4] = [0.0, 6.0, 4.0, -0.0]
    ac = cs(rng, (4, 5), (4, 5))

    def relu6(pkg):
        x = D(pkg, "x", ax)
        return grads(pkg, [pkg.layers.relu6(x),
                           pkg.layers.relu6(x, threshold=4.0)], [x], ac)
    add("relu6", relu6, dict(ac, x=ax))

    def leaky(pkg):
        x = D(pkg, "x", ax)
        return grads(pkg, [pkg.layers.leaky_relu(x, alpha=0.1),
                           pkg.layers.leaky_relu(x)], [x], ac)
    add("leaky_relu", leaky, dict(ac, x=ax))
    hx = f32(rng, 4, 5, lo=-4.0, hi=4.0)
    # the bounds at slope 0.25; slope 0.2 has none in float32 (0.2 · 2.5
    # rounds to 0.5, but XLA's contracted multiply-add puts -2.5 · 0.2 +
    # 0.5 below 0, as the float32 slope is above 0.2)
    hx[0, :2] = [2.0, -2.0]

    def hard_sigmoid(pkg):
        x = D(pkg, "x", hx)
        return grads(pkg, [pkg.layers.hard_sigmoid(x),
                           pkg.layers.hard_sigmoid(x, slope=0.25)], [x], ac)
    add("hard_sigmoid", hard_sigmoid, dict(ac, x=hx))
    sx = f32(rng, 4, 5)

    def swish(pkg):
        x = D(pkg, "x", sx)
        return grads(pkg, [pkg.layers.swish(x),
                           pkg.layers.swish(x, beta=2.0)], [x], ac)
    add("swish", swish, dict(ac, x=sx))

    def stanh(pkg):
        x = D(pkg, "x", sx)
        return grads(pkg, [pkg.layers.stanh(x),
                           pkg.layers.stanh(x, scale_a=0.5, scale_b=2.0)],
                     [x], ac)
    add("stanh", stanh, dict(ac, x=sx))
    wx = sx.copy()
    wx[0, 0] = 0.0
    wpos = np.abs(sx) + 0.1
    wc = cs(rng, (4, 5), (4, 5), (4, 5))

    def pow_(pkg):
        x, xp = D(pkg, "x", wx), D(pkg, "xp", wpos)
        return grads(pkg, [pkg.layers.pow(x, factor=3.0),
                           pkg.layers.pow_(x, factor=2.0),
                           pkg.layers.pow(xp, factor=0.5)], [x, xp], wc)
    add("pow", pow_, dict(wc, x=wx, xp=wpos))
    rng = np.random.RandomState(27)
    lx = f32(rng, 4, 7, lo=-3.0, hi=3.0)
    lc = cs(rng, (4, 7), (4, 7))

    def log_softmax(pkg):
        x = D(pkg, "x", lx)
        return grads(pkg, [pkg.layers.log_softmax(x),
                           pkg.layers.log_softmax(x, axis=0)], [x], lc)
    add("log_softmax", log_softmax, dict(lc, x=lx))
    rng = np.random.RandomState(3)
    cx = f32(rng, 3, 5)
    cc = cs(rng, *[(3, 5)] * 5)

    def cumsum(pkg):
        x = D(pkg, "x", cx)
        L = pkg.layers
        return grads(pkg, [L.cumsum(x), L.cumsum(x, exclusive=True),
                           L.cumsum(x, reverse=True),
                           L.cumsum(x, axis=0, exclusive=True, reverse=True),
                           L.cumsum(x, axis=0)], [x], cc)
    add("cumsum", cumsum, dict(cc, x=cx))

    # -- shape ops: the v1 types without XShape, flatten2 with it -----------
    rng = np.random.RandomState(12)
    tx, t3 = f32(rng, 3, 4), f32(rng, 2, 3, 4)
    tc = cs(rng, (4, 3), (4, 2, 3))

    def transpose(pkg):
        x, y = D(pkg, "x", tx), D(pkg, "y", t3)
        a, = _det_raw(pkg, "transpose", {"X": [x]}, {"Out": "float32"},
                      {"axis": [1, 0]})
        b, = _det_raw(pkg, "transpose", {"X": [y]}, {"Out": "float32"},
                      {"axis": [2, 0, 1]})
        return grads(pkg, [a, b], [x, y], tc)
    add("transpose", transpose, dict(tc, x=tx, y=t3))
    rng = np.random.RandomState(11)
    fx = f32(rng, 2, 3, 4, 5)
    fc = cs(rng, (2, 60), (1, 120), (24, 5))

    def flatten2(pkg):
        x = D(pkg, "x", fx)
        L = pkg.layers
        return grads(pkg, [L.flatten(x), L.flatten(x, axis=0),
                           L.flatten(x, axis=3)], [x], fc)
    add("flatten2", flatten2, dict(fc, x=fx))
    fc1 = cs(rng, (6, 20))

    def flatten(pkg):
        x = D(pkg, "x", fx)
        a, = _det_raw(pkg, "flatten", {"X": [x]}, {"Out": "float32"},
                      {"axis": 2})
        return grads(pkg, [a], [x], fc1)
    add("flatten", flatten, dict(fc1, x=fx))
    qx = f32(rng, 3, 1, 4, 1)
    qc = cs(rng, (3, 4), (3, 4))

    def squeeze(pkg):
        x = D(pkg, "x", qx)
        a, = _det_raw(pkg, "squeeze", {"X": [x]}, {"Out": "float32"},
                      {"axes": [1, 3]})
        b, = _det_raw(pkg, "squeeze", {"X": [x]}, {"Out": "float32"},
                      {"axes": []})
        return grads(pkg, [a, b], [x], qc)
    add("squeeze", squeeze, dict(qc, x=qx))
    uc = cs(rng, (3, 1, 4, 1))

    def unsqueeze(pkg):
        y = D(pkg, "y", tx)
        a, = _det_raw(pkg, "unsqueeze", {"X": [y]}, {"Out": "float32"},
                      {"axes": [3, 1]})
        return grads(pkg, [a], [y], uc)
    add("unsqueeze", unsqueeze, dict(uc, y=tx))
    rng = np.random.RandomState(14)
    sx4 = f32(rng, 3, 4)
    sc = cs(rng, *([(4,)] * 3 + [(3,)] * 4))

    def unstack(pkg):
        x = D(pkg, "x", sx4)
        return grads(pkg, pkg.layers.unstack(x) +
                     pkg.layers.unstack(x, axis=1), [x], sc)
    add("unstack", unstack, dict(sc, x=sx4))
    small, target = f32(rng, 1, 4), f32(rng, 3, 4)
    col, big = f32(rng, 2, 1), f32(rng, 4, 3)
    ec = cs(rng, (3, 4), (4, 3))

    def expand_as(pkg):
        x, c_ = D(pkg, "x", small), D(pkg, "col", col)
        t, b = D(pkg, "t", target, False), D(pkg, "b", big, False)
        a, = _det_raw(pkg, "expand_as", {"X": [x], "target_tensor": [t]},
                      {"Out": "float32"}, {})
        e, = _det_raw(pkg, "expand_as", {"X": [c_], "target_tensor": [b]},
                      {"Out": "float32"}, {})
        return grads(pkg, [a, e], [x, c_], ec)
    add("expand_as", expand_as, dict(ec, x=small, t=target, col=col, b=big))

    # -- gathers and scatters: duplicate, negative, out-of-range ids --------
    rng = np.random.RandomState(21)
    gx = f32(rng, 3, 4, 5)
    gidx = np.array([[0, 1], [2, 3], [2, 3], [-1, 0], [5, -9]], np.int64)
    gidx3 = np.array([[[1], [0]], [[2], [2]]], np.int32)
    gc = cs(rng, (5, 5), (2, 2, 4, 5))

    def gather_nd(pkg):
        x = D(pkg, "x", gx)
        i, j = D(pkg, "i", gidx, False), D(pkg, "j", gidx3, False)
        return grads(pkg, [pkg.layers.gather_nd(x, i),
                           pkg.layers.gather_nd(x, j)], [x], gc)
    add("gather_nd", gather_nd, dict(gc, x=gx, i=gidx, j=gidx3))
    rng = np.random.RandomState(22)
    scx = f32(rng, 6, 4)
    sids = np.array([3, 0, -2, 9], np.int64)      # -2 is row 4; 9 dropped
    dups = np.array([1, 1, 4, 1, -1, -8], np.int64)
    su, sd = f32(rng, 4, 4), f32(rng, 6, 4)
    scc = cs(rng, (6, 4), (6, 4))

    def scatter(pkg):
        x = D(pkg, "x", scx)
        u, d = D(pkg, "u", su), D(pkg, "d", sd)
        i, j = D(pkg, "i", sids, False), D(pkg, "j", dups, False)
        return grads(pkg, [pkg.layers.scatter(x, i, u),
                           pkg.layers.scatter(x, j, d, overwrite=False)],
                     [x, u, d], scc)
    add("scatter", scatter, dict(scc, x=scx, u=su, d=sd, i=sids, j=dups))
    rng = np.random.RandomState(38)
    table = f32(rng, 10, 4)
    ids = np.array([1, 3, 3, 7, 0, 12], np.int64)
    ids2 = np.array([[2], [3], [9]], np.int64)
    lc2 = cs(rng, (6, 4), (3, 4))

    def lookup_v2(pkg):
        w = D(pkg, "w", table)
        i, j = D(pkg, "i", ids, False), D(pkg, "j", ids2, False)
        a, = _det_raw(pkg, "lookup_table_v2", {"W": [w], "Ids": [i]},
                      {"Out": "float32"}, {"padding_idx": -1})
        b, = _det_raw(pkg, "lookup_table_v2", {"W": [w], "Ids": [j]},
                      {"Out": "float32"}, {"padding_idx": 3})
        # the id past the table reads a NaN row, as jnp.take gives it:
        # has_nan sees it, the rest holds rows 0-4 of the first lookup
        a5 = pkg.layers.slice(a, axes=[0], starts=[0], ends=[5])
        return [pkg.layers.has_nan(a)] + grads(
            pkg, [a5, b], [w], {"c0": lc2["c0"][:5], "c1": lc2["c1"]})
    add("lookup_table_v2", lookup_v2, dict(c0=lc2["c0"][:5], c1=lc2["c1"],
                                           w=table, i=ids, j=ids2))

    # -- shape, selections and sorts: integers held exactly -----------------
    rng = np.random.RandomState(25)
    kx = np.round(f32(rng, 4, 6), 1)             # ties in every row
    kx[1] = 0.5
    kx[2, [1, 4]] = kx[2].max() + 1.0

    def shape(pkg):
        x = D(pkg, "x", gx, False)
        return [pkg.layers.shape(x), pkg.layers.shape(D(pkg, "k", kx,
                                                        False))]
    add("shape", shape, {"x": gx, "k": kx}, tol="exact")

    def arg_max(pkg):
        x = D(pkg, "x", kx, False)
        return [pkg.layers.argmax(x, axis=-1), pkg.layers.argmax(x, axis=0)]
    add("arg_max", arg_max, {"x": kx}, tol="exact")

    def arg_min(pkg):
        x = D(pkg, "x", kx, False)
        return [pkg.layers.argmin(x, axis=-1), pkg.layers.argmin(x, axis=0)]
    add("arg_min", arg_min, {"x": kx}, tol="exact")

    def argsort(pkg):
        x = D(pkg, "x", kx, False)
        return list(pkg.layers.argsort(x)) + list(pkg.layers.argsort(x,
                                                                    axis=0))
    add("argsort", argsort, {"x": kx}, tol="exact")
    rng = np.random.RandomState(17)
    dx, d3 = f32(rng, 2, 3), f32(rng, 2, 3, 4)
    dc = cs(rng, (3, 8), (2, 4, 7))

    def pad(pkg):
        x, y = D(pkg, "x", dx), D(pkg, "y", d3)
        return grads(pkg, [pkg.layers.pad(x, [1, 0, 2, 3], pad_value=9.0),
                           pkg.layers.pad(y, [0, 0, 1, 0, 2, 1])], [x, y],
                     dc)
    add("pad", pad, dict(dc, x=dx, y=d3))
    vc = cs(rng, (2, 3, 4), (2, 3, 4))

    def reverse(pkg):
        y = D(pkg, "y", d3)
        return grads(pkg, [pkg.layers.reverse(y, 0),
                           pkg.layers.reverse(y, [0, -1])], [y], vc)
    add("reverse", reverse, dict(vc, y=d3))
    rng = np.random.RandomState(12)
    clean = f32(rng, 3, 3)
    nan, inf = clean.copy(), clean.copy()
    nan[1, 1] = np.nan
    inf[2, 0] = -np.inf
    for name in ("has_nan", "has_inf"):
        def build(pkg, name=name):
            f = getattr(pkg.layers, name)
            return [f(D(pkg, k, v, False)) for k, v in
                    (("x", clean), ("n", nan), ("i", inf))]
        add(name, build, {"x": clean, "n": nan, "i": inf}, tol="exact")
    fids = np.array([[3, -1], [0, 7]], np.int64)

    def fill_any_like(pkg):
        # the op behind layers.ones_like, on a float and an int input,
        # and by hand with another value
        x, i = D(pkg, "x", nan, False), D(pkg, "ids", fids, False)
        a, = _det_raw(pkg, "fill_any_like", {"X": [x]}, {"Out": "float32"},
                      {"value": -2.5})
        return [pkg.layers.ones_like(x), pkg.layers.ones_like(i), a]
    add("fill_any_like", fill_any_like, {"x": nan, "ids": fids}, tol="exact")
    ref = np.zeros((500, 3), np.float32)

    def urbsl(pkg):
        r = D(pkg, "ref", ref, False)
        L = pkg.layers
        return [L.uniform_random_batch_size_like(r, [-1, 300]),
                L.uniform_random_batch_size_like(r, [7, -1], min=2.0,
                                                 max=5.0, input_dim_idx=1,
                                                 output_dim_idx=1)]
    add("uniform_random_batch_size_like", urbsl, {"ref": ref}, tol="stats")

    # -- the transposed convolutions, losses and the streaming auc ----------
    rng = np.random.RandomState(0)
    vx = f32(rng, 2, 4, 5, 5)
    vcc = cs(rng, (2, 6, 9, 9), (2, 4, 7, 7), (2, 4, 9, 9))

    def conv_t(pkg):
        x = D(pkg, "x", vx)
        L = pkg.layers
        outs = [L.conv2d_transpose(x, 6, filter_size=3, stride=2, padding=1),
                L.conv2d_transpose(x, 4, filter_size=3, groups=2,
                                   bias_attr=False),
                L.conv2d_transpose(x, 4, filter_size=3, dilation=2,
                                   act="relu")]
        return grads(pkg, outs, [x] + _seq_params(pkg), vcc)
    add("conv2d_transpose", conv_t, dict(vcc, x=vx), seed=5)
    dwx = rng.randn(1, 3, 5, 5).astype(np.float32)
    dww = rng.randn(3, 1, 3, 3).astype(np.float32)
    dwc = cs(rng, (1, 3, 9, 9))

    def dw_t(pkg):
        x, w = D(pkg, "x", dwx), D(pkg, "w", dww)
        o, = _det_raw(pkg, "depthwise_conv2d_transpose",
                      {"Input": [x], "Filter": [w]}, {"Output": "float32"},
                      {"strides": [2, 2], "paddings": [1, 1],
                       "dilations": [1, 1], "groups": 3})
        return grads(pkg, [o], [x, w], dwc)
    add("depthwise_conv2d_transpose", dw_t, dict(dwc, x=dwx, w=dww))
    rng = np.random.RandomState(28)
    hx2 = f32(rng, 4, 3)
    hy = hx2 + f32(rng, 4, 3)
    hx2[0, :2] = 0.0
    hy[0, :2] = [0.8, -0.8]                      # |r| exactly delta
    hc = cs(rng, (4, 3), (4, 3))

    def huber(pkg):
        x, y = D(pkg, "x", hx2), D(pkg, "y", hy)
        return grads(pkg, [pkg.layers.huber_loss(x, y, 0.8),
                           pkg.layers.huber_loss(x, y, 1.5)], [x, y], hc)
    add("huber_loss", huber, dict(hc, x=hx2, y=hy))
    rng = np.random.RandomState(33)
    nt = 4095
    p1 = rng.uniform(0, 1, 40).astype(np.float32)
    # on and beside the bin edges k / nt, where a float product rounds
    p1[:6] = np.float32([0.5, 1.0, 0.0, 1 / nt, 2047 / nt, 4094 / nt])
    p1[6:10] = np.nextafter(p1[2:6], np.float32(1))
    lab = (rng.rand(40, 1) < p1[:, None]).astype(np.int64)
    p2 = np.stack([1 - p1, p1], axis=1)

    def auc(pkg):
        a, b = D(pkg, "p1", p1[:, None], False), D(pkg, "p2", p2, False)
        lv = D(pkg, "lab", lab, False)
        out1, s1 = pkg.layers.auc(a, lv)
        out2, s2 = pkg.layers.auc(b, lv, num_thresholds=200)
        return [out1, out2] + s1 + s2
    add("auc", auc, {"p1": p1[:, None], "p2": p2, "lab": lab})
    return progs


def _stats_ok(a, lo, hi):
    """A uniform draw's shape-free checks: all in ``[lo, hi)`` and its
    mean and variance within URBSL_SIGMAS standard errors of the
    uniform's ``(lo + hi) / 2`` and ``(hi - lo)² / 12``."""
    n, w = a.size, hi - lo
    mean_se = w / np.sqrt(12 * n)
    # the sample variance's standard error: sqrt((mu4 - sigma^4) / n),
    # with mu4 = w^4 / 80 and sigma^4 = w^4 / 144 for a uniform of width w
    var_se = w * w * np.sqrt(1 / 180.0 / n)
    return bool(a.min() >= lo and a.max() < hi and
                abs(a.mean() - (lo + hi) / 2) <= URBSL_SIGMAS * mean_se and
                abs(a.var() - w * w / 12) <= URBSL_SIGMAS * var_se)


URBSL_DRAWS = ((500, 300, -1.0, 1.0), (7, 3, 2.0, 5.0))


def urbsl_ok(outs):
    """The two draws of the uniform_random_batch_size_like program:
    their shapes ``[500, 300]`` and ``[7, 3]``, float32, in range, and by
    statistics."""
    return all(o.shape == (r, c) and o.dtype == np.float32 and
               _stats_ok(o, lo, hi)
               for o, (r, c, lo, hi) in zip(outs, URBSL_DRAWS))


def _card_sync_sites(build, feed, weights):
    """The host sync sites (``_sync_sites``) of a second run of
    ``build``'s port program on the card, its feed already there."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        fetch = build(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    if weights:
        fluid.load_numpy_params(scope, weights, fluid.CUDAPlace(0))
    cfeed = _cuda_feed(feed)

    def run():
        return exe.run(main, feed=cfeed, fetch_list=fetch, scope=scope,
                       return_numpy=False)
    run()
    return _sync_sites(run)


def _random_op_programs(phase, progs, tols, random_row):
    """The body of ``core_ops`` and ``misc_ops``: ``progs`` (as
    ``core_programs`` gives them) on the card against the port's CPU
    path (``_programs_card_vs_cpu`` at ``tols``), those of tolerance
    class ``stats`` instead by ``random_row(name, card fetches, cpu
    fetches) -> (row, ok)`` on each side; no port kernel launched, and
    no host sync in a run of any program on the card (torch's sync debug
    mode over a second run whose feed lies on the card).  Returns the
    port kernel launches."""
    stats = {k: v for k, v in progs.items() if v[3] == "stats"}
    t0 = time.perf_counter()
    rows, checks = [], {}
    _reset_launches()
    for name, (build, feed, seed, _) in stats.items():
        card, _, _ = seq_run(build, feed, {}, fluid.CUDAPlace(0), ())
        cpu, _, _ = seq_run(build, feed, {}, fluid.CPUPlace(), ())
        row, checks[name] = random_row(name, card, cpu)
        rows.append(row)
    _programs_card_vs_cpu(
        phase, {k: v for k, v in progs.items() if k not in stats}, tols, ())
    launches = _launches()
    sites = {}
    for name, (build, feed, seed, _) in progs.items():
        got = _card_sync_sites(build, feed, seq_weights(build, seed))
        if got:
            sites[name] = got
    checks["no_port_kernel"] = not any(launches.values())
    checks["no_host_sync"] = not sites
    emit(phase=phase + "_checks", card=_card(), random_ops=rows,
         launches=launches, sync_sites=sites,
         seconds=time.perf_counter() - t0)
    _fail_unless(phase + "_checks", checks)
    return launches


def phase_core_ops():
    """The 34 core op types of ROADMAP item 13c.3a and ``fill_any_like``
    (``core_programs``: forward and gradients) on the card against the port's
    CPU path, each from the same weights: floats within CORE_TOL, integers and
    the selections equal, ``uniform_random_batch_size_like`` by its shape,
    range and statistics on each side; no port kernel launched, and no host
    sync in a run of any program on the card (none of these rules reads a
    value back).  Returns the port kernel launches."""
    def urbsl_row(name, card, cpu):
        ok = urbsl_ok(card) and urbsl_ok(cpu)
        return dict(op=name, card_mean=[float(o.mean()) for o in card],
                    cpu_mean=[float(o.mean()) for o in cpu], ok=ok), ok
    return _random_op_programs("core_ops", core_programs(), CORE_TOL,
                               urbsl_row)


def _step1_gaps(exe, smain, sloss, scope, shost, image, nudge, head):
    """Step 1 of ``smain`` from ``scope``'s state on the card (``exe``)
    and on the port's CPU path, and again on the CPU with ``shost[image]``
    moved by a relative ``nudge`` of seeded noise: (card loss, CPU loss,
    the whole gradient's relative L2 gap card vs CPU, the CPU's own gap
    under the nudge, {parameter named ``head``...: its gap card vs
    CPU})."""
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    (card1,), _, cgrad = _book_step(exe, smain, sloss, scope, shost,
                                    grads=True)
    (cpu1,), _, hgrad = _book_step(cpu_exe, smain, sloss, scope, shost,
                                   grads=True)
    x = shost[image]
    noise = np.random.RandomState(SEED).randn(*x.shape)
    nudged = dict(shost, **{image: (x * (1 + nudge * noise))
                            .astype(np.float32)})
    _, _, ngrad = _book_step(cpu_exe, smain, sloss, scope, nudged,
                             grads=True)

    def gap(grads):
        return float(torch.cat([(grads[n] - g).reshape(-1) for n, g in
                                hgrad.items()]).norm() /
                     torch.cat([g.reshape(-1) for g in hgrad.values()]).norm())
    heads = {n: float((cgrad[n] - g).norm() / g.norm().clamp_min(1e-30))
             for n, g in hgrad.items() if n.startswith(head)}
    return (float(card1.reshape(-1)[0]), float(cpu1.reshape(-1)[0]),
            gap(cgrad), gap(ngrad), heads)


def _timed_train(exe, main, loss, feeds, scope, warm, timed, tag):
    """``warm`` + ``timed`` steps of ``main`` over the card ``feeds`` in
    turn through ``timing.timed_steps`` (the main path's run: the launch
    counts go to 0 just before it and are read just after), then one
    step under torch's sync debug mode, one profiled step and the cost
    ledger's record of a step (tagged ``tag``): a dict of the losses, ms
    per step, launches, host syncs over the steps, peak MB, the fence's
    detail, the sync sites, the profile and the record."""
    torch.cuda.reset_peak_memory_stats()
    syncs0 = fluid.profiler.host_sync_count()
    got = []

    def step(i):
        r = exe.run(main, feed=feeds[i % len(feeds)], fetch_list=[loss],
                    scope=scope, return_numpy=False)
        got.append(r)
        return r

    detail = {}
    _reset_launches()
    dt, _ = timing.timed_steps(step, timed, warmup=warm, detail=detail)
    launches = _launches()
    out = dict(step_ms=dt / timed * 1e3, launches=launches,
               step_syncs=fluid.profiler.host_sync_count() - syncs0,
               peak_mb=torch.cuda.max_memory_allocated() / 2**20,
               losses=[float(g[0].reshape(-1)[0].item()) for g in got],
               detail=detail)
    out["sites"] = _sync_sites(lambda: exe.run(
        main, feed=feeds[0], fetch_list=[loss], scope=scope,
        return_numpy=False))
    out["prof"], _ = _profile_record(exe, main, feeds[0], [loss], scope)
    out["rec"] = exe.cost_record(main, feed=feeds[0], fetch_list=[loss],
                                 scope=scope, tag=tag)
    return out


YOLO_FEEDS = 4                # yolov3_train: distinct batches, in turn
YOLO_CPU = dict(batch=2, image=320)   # step 1 and the eval, card vs CPU:
#                               the zoo's smallest random shape at its
#                               widths (the CPU cannot run 8 x 608² here)
YOLO_LOSS_RTOL = 1e-5         # ... the step-1 loss (measured 9.8e-8)
YOLO_HEAD_GRAD_RL2 = 1e-4     # ... the three output convs' gradients,
#                               each in relative L2 (measured 9.9e-6 at
#                               most; TF32 or bf16 convs give ~1e-3)
YOLO_GRAD_RL2 = 2e-2          # ... and the whole gradient (measured
#                               4.8e-3, the same in every run): through 72
#                               batch norms at batch 2 the backbone's
#                               gradient is that sensitive to rounding;
#                               the CPU's own moves by 1.2e-3 when the
#                               image moves by ~1 ulp (YOLO_NUDGE, shown)
YOLO_NUDGE = 1e-7             # the image's relative perturbation
YOLO_BOX_ATOL = 1e-3          # ... the eval's candidate boxes in pixels (a
#                               score or an exp an ulp apart moves a
#                               320-pixel coordinate by ~1e-4)
YOLO_SCORE_ATOL = 1e-6        # ... and their scores (measured 6e-8)
YOLO_EVALS = 3                # timed eval batches
YOLO_K1_BATCH = 8             # yolo_k1: the per-card batch


def _yolo_program(cfg, evaluate=False):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = yolov3.build_eval(cfg) if evaluate else yolov3.build(cfg)
    return main, startup, out


def phase_yolov3_train():
    """YOLOv3 on DarkNet-53 (``models/yolov3.py``, the model zoo's
    detector) at ``base_config()``: batch 8 of 608 x 608 images, 80
    classes, 50 ground-truth slots, Momentum with L2 decay on the
    warmed-up piecewise rate; 75 cuDNN convs, 72 batch norms and
    leaky_relus, three ``yolov3_loss``.  Step 1 from the startup weights
    at YOLO_CPU (batch 2, 320 x 320, the same widths), on the card and on
    the port's CPU path: losses within YOLO_LOSS_RTOL, the output convs'
    gradients within YOLO_HEAD_GRAD_RL2 and the whole within YOLO_GRAD_RL2,
    beside the CPU's own gap when its image is nudged by YOLO_NUDGE.  Then
    WARM_STEPS + TIMED_STEPS steps through ``timing.timed_steps`` on the card
    over YOLO_FEEDS synthetic batches in turn: finite losses, no port kernel
    launched (none lies on this path), no host sync in a step (the host sync
    counter over the steps, and torch's sync debug mode over one
    step); ms per step, images/s, peak memory, one profiled step's
    launches, busy share and top kernels, and the cost ledger's count of
    the step.  Returns (the path's port kernel launches, the trained
    scope, the card feeds)."""
    t0 = time.perf_counter()
    cfg = yolov3.base_config()
    main, startup, out = _yolo_program(cfg)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    loss = out["loss"]
    small = dict(cfg, **YOLO_CPU)
    smain, _, sout = _yolo_program(small)
    card1, cpu1, whole, spread, heads = _step1_gaps(
        exe, smain, sout["loss"], scope, next(yolov3.feeds(small, SEED)),
        "image", YOLO_NUDGE, "yolo_output.")
    it = yolov3.feeds(cfg, SEED)
    host = [next(it) for _ in range(YOLO_FEEDS)]
    feeds = [_cuda_feed(f) for f in host]
    run = _timed_train(exe, main, loss, feeds, scope, WARM_STEPS,
                       TIMED_STEPS, "yolov3_train")
    launches, step_ms, losses = run["launches"], run["step_ms"], run["losses"]
    rec = run["rec"]
    ops = [o.type for o in main.global_block().ops]
    checks = {
        "losses_finite": bool(np.isfinite(losses).all()),
        "step1_card_vs_cpu": abs(card1 - cpu1) <= YOLO_LOSS_RTOL * abs(cpu1),
        "step1_head_grads_card_vs_cpu": len(heads) == 6 and
        max(heads.values()) <= YOLO_HEAD_GRAD_RL2,
        "step1_grad_card_vs_cpu": whole <= YOLO_GRAD_RL2,
        "no_port_kernel": not any(launches.values()),
        "no_host_sync_in_a_step": run["step_syncs"] == 0 and
        not run["sites"],
        # 75 convs and 72 leaky_relus at base_config (its 23 blocks)
        "every_conv": ops.count("conv2d") == 29 + 2 * sum(cfg["stages"])
        and ops.count("leaky_relu") == 26 + 2 * sum(cfg["stages"]) and
        ops.count("yolov3_loss") == 3}
    fwd_flops = _conv_flops(main)
    emit(phase="yolov3_train", card=_card(), config=cfg,
         steps=len(losses), program_ops=len(ops),
         conv_gflop_forward=fwd_flops / 1e9,
         conv_tflops_per_s_step=3 * fwd_flops / step_ms / 1e9,
         conv_bound_ms_fp32=3 * fwd_flops / PEAK_FP32_FLOPS * 1e3,
         ledger=dict(tflop=rec["flops"] / 1e12,
                     gbytes=rec["bytes_accessed"] / 1e9,
                     estimated_step_ms=rec["estimated_step_s"] * 1e3,
                     aten_calls=rec["aten_calls"],
                     top_ops=rec["top_ops"][:6]),
         losses=losses, step1_loss_card=card1, step1_loss_cpu=cpu1,
         step1_rel_err=abs(card1 - cpu1) / abs(cpu1), step1_config=YOLO_CPU,
         step1_grad_rel_l2=dict(whole=whole, cpu_nudged=spread,
                                heads=heads, parameters=len(
                                    smain.global_block().all_parameters())),
         ms_per_step=step_ms, images_per_s=cfg["batch"] / step_ms * 1e3,
         fence=dict(rtt_s=run["detail"]["fence_rtt_s"],
                    wall_s=run["detail"]["window_wall_s"]),
         peak_device_mb=run["peak_mb"],
         host_syncs_over_steps=run["step_syncs"],
         step_sync_sites=run["sites"], profiled_step=run["prof"],
         launches=launches,
         checks=checks, seconds=time.perf_counter() - t0)
    _fail_unless("yolov3_train", checks)
    return launches, scope, host


def _nms_alone(nms, boxes, scores, place):
    """The ``multiclass_nms`` op ``nms`` (its attributes) alone on
    ``place`` over the given ``BBoxes`` and ``Scores``: its slab."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        b = _seq_data(fluid, "bboxes", boxes, False)
        s = _seq_data(fluid, "scores", scores, False)
        out, = _det_raw(fluid, "multiclass_nms",
                        {"BBoxes": [b], "Scores": [s]}, {"Out": "float32"},
                        dict(nms.attrs))
    return np.asarray(fluid.Executor(place).run(
        main, feed={"bboxes": boxes, "scores": scores}, fetch_list=[out])[0])


def _nms_inputs(main):
    """``main``'s ``multiclass_nms`` op and its (BBoxes, Scores) names."""
    nms = [o for o in main.global_block().ops if o.type ==
           "multiclass_nms"][0]
    return nms, [nms.input("BBoxes")[0], nms.input("Scores")[0]]


def phase_yolov3_eval(scope, host):
    """The evaluation program (``yolo_box`` on the three maps, the scores
    transposed, joined, ``multiclass_nms`` over 80 classes: the zoo's
    0.005 / 400 / 100 / 0.45) on yolov3_train's trained scope at
    ``base_config()``: the ``[8, 100, 6]`` slab, labels -1 or in ``[0,
    80)``, finite, ms per batch over YOLO_EVALS batches, no host sync;
    the card's slab equal, every entry, to the port's CPU
    ``multiclass_nms`` run on the card's own candidates (its BBoxes and
    Scores).  Then at YOLO_CPU on the card and on the port's CPU path
    from the same state: every candidate box (within YOLO_BOX_ATOL
    pixels) and score (within YOLO_SCORE_ATOL) of the three maps, and
    again the card's slab equal to the CPU NMS of the card's candidates.
    The two devices' slabs are not compared with each other: after the
    warm-up's near-zero rate the kept scores all lie within ~1e-5 of
    0.25, so the candidates' last bits decide their order.
    Returns the path's port kernel launches (none)."""
    t0 = time.perf_counter()
    cfg = yolov3.base_config()
    emain, _, eout = _yolo_program(cfg, evaluate=True)
    nms, nms_in = _nms_inputs(emain)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    feeds = [_cuda_feed(yolov3.eval_feed(cfg, f)) for f in host]
    syncs0 = fluid.profiler.host_sync_count()
    _reset_launches()
    slab = exe.run(emain, feed=feeds[0], fetch_list=eout["outs"],
                   scope=scope, return_numpy=False)[0]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for k in range(YOLO_EVALS):
        exe.run(emain, feed=feeds[k % len(feeds)], fetch_list=eout["outs"],
                scope=scope, return_numpy=False)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t1) / YOLO_EVALS * 1e3
    launches = _launches()
    syncs = fluid.profiler.host_sync_count() - syncs0
    slab = slab.cpu().numpy()
    # one batch's slab with its candidates, outside the timed runs
    full = [np.asarray(v) for v in exe.run(
        emain, feed=feeds[0], fetch_list=eout["outs"] + nms_in, scope=scope)]
    full_cpu = _nms_alone(nms, full[1], full[2], fluid.CPUPlace())
    small = dict(cfg, **YOLO_CPU)
    smain, _, sout = _yolo_program(small, evaluate=True)
    snms, snms_in = _nms_inputs(smain)
    sfeed = yolov3.eval_feed(small, next(yolov3.feeds(small, SEED + 1)))
    sides = {}
    for name, place in (("card", fluid.CUDAPlace(0)),
                        ("cpu", fluid.CPUPlace())):
        side = fluid.Executor(place)
        sides[name] = [np.asarray(v) for v in side.run(
            smain, feed=sfeed, fetch_list=sout["outs"] + snms_in,
            scope=_state_copy(smain, scope, side.device))]
    (a, boxes, scores), (b, cboxes, cscores) = sides["card"], sides["cpu"]
    small_cpu = _nms_alone(snms, boxes, scores, fluid.CPUPlace())
    box_err = float(np.abs(boxes - cboxes).max())
    score_err = float(np.abs(scores - cscores).max())
    labels = slab[..., 0]
    kept = labels >= 0
    checks = {
        "slab_shape": slab.shape == (cfg["batch"], cfg["nms_posk"], 6),
        "slab_labels": bool(((labels == -1) | (kept & (labels <
                                                       cfg["classes"])))
                            .all()) and bool(kept.any()),
        "slab_finite": bool(np.isfinite(slab).all()),
        "no_port_kernel": not any(launches.values()),
        "no_host_sync": syncs == 0,
        "slab_is_cpu_nms_of_card_candidates": np.array_equal(full[0],
                                                             full_cpu),
        "boxes_card_vs_cpu": box_err <= YOLO_BOX_ATOL,
        "scores_card_vs_cpu": score_err <= YOLO_SCORE_ATOL,
        "small_slab_is_cpu_nms_of_card_candidates": np.array_equal(
            a, small_cpu)}
    emit(phase="yolov3_eval", card=_card(), slab_shape=list(slab.shape),
         kept_rows=int(kept.sum()), ms_per_eval_batch=eval_ms,
         host_syncs=syncs, launches=launches,
         full_vs_cpu_nms=dict(candidates=list(full[1].shape[:2]),
                              kept_rows=int((full[0][..., 0] >= 0).sum()),
                              rows_differ=int((full[0] != full_cpu)
                                              .any(-1).sum())),
         card_vs_cpu=dict(config=YOLO_CPU,
                          kept_rows=int((a[..., 0] >= 0).sum()),
                          rows_differ_from_cpu_nms=int((a != small_cpu)
                                                       .any(-1).sum()),
                          label_rows_differ_across_devices=int(
                              (a[..., 0] != b[..., 0]).sum()),
                          kept_score_spread=[
                              float(np.ptp(x[x[:, 0] >= 0, 1])) for x in b],
                          candidates=list(boxes.shape[:2]),
                          boxes_max_abs_err=box_err,
                          scores_max_abs_err=score_err),
         checks=checks, seconds=time.perf_counter() - t0)
    _fail_unless("yolov3_eval", checks)
    return launches


def yolo_k1_shapes(cfg):
    """YOLOv3's 3x3 stride-1 convs at ``cfg``: (C, O, side, count): the
    first conv, one 3x3 conv a basic block, two a detection block and
    its tip (three of C -> 2C on each of the three maps)."""
    div, side = cfg["width_div"], cfg["image"]
    shapes = [(3, 32 // div, side, 1)]
    for i, n in enumerate(cfg["stages"]):
        c = 32 * 2 ** i // div
        extra = 3 if i >= 2 else 0         # detection blocks on the
        shapes.append((c, 2 * c, side // 2 ** (i + 1), n + extra))
    return shapes


def _yolo_k1_program(dtype, shapes):
    """One conv2d (3x3, stride 1, padding 1, no bias) a shape over its
    own data input, and the gradients of ``sum mean(out²)`` over the
    inputs and filters."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        xs, outs = [], []
        for k, (c, o, s, _) in enumerate(shapes):
            x = fluid.layers.data("x%d" % k, [YOLO_K1_BATCH, c, s, s],
                                  dtype=dtype, append_batch_size=False)
            x.stop_gradient = False
            xs.append(x)
            outs.append(fluid.layers.conv2d(x, o, 3, padding=1,
                                            bias_attr=False))
        loss = None
        for y in outs:
            term = fluid.layers.mean(fluid.layers.square(
                fluid.layers.cast(y, "float32")))
            loss = term if loss is None else loss + term
        params = main.global_block().all_parameters()
        grads = fluid.gradients(loss, xs + params)
    return main, startup, outs + grads


def phase_yolo_k1():
    """K1 at YOLOv3's 3x3 stride-1 shapes (``yolo_k1_shapes`` at
    ``base_config()``, batch YOLO_K1_BATCH): one program of their convs
    forward and backward through Executor under ``FLAGS_conv_pallas``,
    in float32 and bfloat16, against the same program with the flag off
    (cuDNN), from the same weights: outputs and gradients within K1's
    tolerances of max|flag off|; one K1 launch for each conv that
    ``k1_applies`` takes (the 8 MiB padded-image gate leaves float32's
    304² x 32 conv to cuDNN), each of the variant ``k1_plan`` plans, and
    what the gate decides for the 3 -> 32 first conv at 608² recorded.
    Then each shape's K1 forward time (NHWC input, K-major weights, as
    kernel_conv times it) beside cuDNN, the plain version and the bound.
    Returns the flag-on runs' port kernel launches."""
    from paddle_tpu_torch.fluid import flags
    from paddle_tpu_torch.fluid.ops.conv_ops import k1_applies
    t0 = time.perf_counter()
    shapes = yolo_k1_shapes(yolov3.base_config())
    rng = np.random.RandomState(SEED)
    N = YOLO_K1_BATCH
    rows, checks, total = [], {}, {n: 0 for n in KERNELS}
    applies = {}
    for dt in ("float32", "bfloat16"):
        tdt = getattr(torch, dt)
        esz = 4 if dt == "float32" else 2
        main, startup, fetch = _yolo_k1_program(dt, shapes)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup, scope=scope)
        feed = {"x%d" % k: torch.from_numpy(rng.randn(N, c, s, s).astype(
            np.float32)).to("cuda", tdt)
            for k, (c, o, s, _) in enumerate(shapes)}
        took = [k1_applies((N, c, s, s), esz, (o, c, 3, 3), (1, 1), (1, 1),
                           (1, 1), 1) for c, o, s, _ in shapes]
        applies[dt] = took
        got = {}
        for on in (False, True):
            flags.set_flag("conv_pallas", on)
            try:
                _reset_launches()
                got[on] = exe.run(main, feed=feed, fetch_list=fetch,
                                  scope=scope, return_numpy=False)
                torch.cuda.synchronize()
                if on:
                    launches = _launches()
                    variants = dict(conv3x3_bn_relu.launches_by_variant)
            finally:
                flags.set_flag("conv_pallas", False)
        for n, c in launches.items():
            total[n] += c
        want_variants = dict.fromkeys(K1_VARIANTS, 0)
        for (c, o, s, _), t in zip(shapes, took):
            if t:
                want_variants[k1_plan(N, s, s, c, o, tdt)["variant"]] += 1
        tol = K1_FP32_TOL if dt == "float32" else K1_BF16_TOL
        # compared on the card: the fetches hold ~1.5 GB
        errs = [_rel(a, b) for a, b in zip(got[True], got[False])]
        ok = max(errs) <= tol and \
            launches["conv3x3_bn_relu"] == sum(took) and \
            variants == want_variants and \
            all(bool(torch.isfinite(a.float()).all()) for a in got[True])
        rows.append(dict(dtype=dt, k1_applies=dict(zip(
            ["%d->%d@%d" % s[:3] for s in shapes], took)),
            max_err_rel=max(errs), errs_rel=errs,
            tolerance="max|diff| <= %g max|flag off|" % tol,
            k1_launches=launches["conv3x3_bn_relu"], variants=variants,
            want_variants=want_variants, ok=ok))
        checks[dt] = ok
        del feed, got, scope
    checks["first_conv_gate_recorded"] = all(
        isinstance(applies[d][0], bool) for d in applies)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    times = []
    for c, o, s, count in shapes:
        for dt in (torch.float32, torch.bfloat16):
            esz = 4 if dt == torch.float32 else 2
            if not k1_applies((N, c, s, s), esz, (o, c, 3, 3), (1, 1),
                              (1, 1), (1, 1), 1):
                continue
            x = torch.randn(N, s, s, c, device=dev, generator=gen).to(dt)
            wk = (torch.randn(o, 3, 3, c, device=dev, generator=gen) *
                  0.05).to(dt)
            w = wk.permute(1, 2, 3, 0)
            xl = x.permute(0, 3, 1, 2)
            wl = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            t = dict(
                ms=cuda_time_ms(lambda: conv3x3_bn_relu(x, w, relu=False)),
                plain_ms=cuda_time_ms(lambda: conv3x3_bn_relu_reference(
                    x, w, relu=False), iters=2, warmup=1),
                library_ms=cuda_time_ms(lambda: torch.nn.functional.conv2d(
                    xl, wl, padding=1)))
            peak = PEAK_BF16_FLOPS if esz == 2 else PEAK_FP32_FLOPS
            b = _bound(*k1_work(N, s, c, o, esz), peak)
            row = dict(shape=[N, s, s, c, o], dtype=str(dt),
                       convs_per_step=count,
                       variant=k1_plan(N, s, s, c, o, dt)["variant"],
                       bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                       roofline_share=b["bound_ms"] / t["ms"],
                       tflops=b["gflop"] / t["ms"], **t)
            emit(phase="yolo_k1_time", **row)
            times.append(row)
            del x, w, wk, xl, wl
    emit(phase="yolo_k1", card=_card(), shapes=[list(s) for s in shapes],
         batch=N, runs=rows, seconds=time.perf_counter() - t0)
    _fail_unless("yolo_k1", checks)
    return total


MISC_TOL = {"plain": (1e-5, 1e-6),   # float32 rules: rtol, atol
            "exact": (0.0, 0.0),     # shape, index and integer ops, linspace
            "stats": None}           # sampling_id: each package and device
#                                      draws from its own stream, so its
#                                      draws are held by shape, dtype,
#                                      range and frequencies (SAMPLING_*)
SAMPLING_ROWS = 20000         # sampling_id: rows of the statistics row
SAMPLING_P = (0.1, 0.0, 0.3, 0.6)    # ... its class probabilities
SAMPLING_SIGMAS = 5.0         # frequencies within 5 standard errors


def misc_programs():
    """The programs of the 49 op types of ``misc_ops.py`` and
    ``misc_ops2.py`` (ROADMAP item 13c.3b), one a type
    (tests/test_torch_misc_ops.py holds each against the JAX package; the
    card's ``misc_ops`` phase against the port's CPU path): {name:
    (build(pkg) -> fetch list, feed, weight seed or None, tolerance class
    of MISC_TOL)}.  Inputs and attributes follow the JAX package's own
    tests of each op (tests/test_misc_ops.py, test_misc_ops2.py,
    test_op_oracle_sweep4.py, test_api_stragglers.py), run through the
    layer a user calls where there is one (the op by hand for
    ``hinge_loss``, ``modified_huber_loss``, ``squared_l2_distance``,
    ``l1_norm``, ``norm``, ``label_smooth`` and ``minus``, which have
    none), every mode side by side, with the points where the packages
    could part fed exactly: thresholds and clip bounds, 0 for the
    ``x > 0`` branches, ties of ``maximum``, grid points outside ``[-1,
    1]``, a channel count whose shift split is not whole, crop offsets
    past the edge, linspace end points that ``torch.linspace`` would
    round otherwise.  Then the gradients of ``sum_i mean(out_i * c_i)``
    over the float inputs the op differentiates and its parameters."""
    progs = {}
    D = _seq_data

    def add(name, build, feed, seed=None, tol="plain"):
        progs[name] = (build, feed, seed, tol)

    def f32(rng, *shape, lo=-2.0, hi=2.0):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    def cs(rng, *shapes):
        return {"c%d" % i: rng.randn(*s).astype(np.float32)
                for i, s in enumerate(shapes)}

    def flat(pkg, outs):
        """0-d outputs as ``[1]``, for their ``c``."""
        return [pkg.layers.reshape(o, [1]) for o in outs]

    def grads(pkg, outs, wrt, feed_c):
        c = sorted((k, v) for k, v in feed_c.items() if k.startswith("c"))
        return _seq_with_grads(pkg, outs, wrt, c)

    def op(pkg, op_type, inputs, outputs, attrs=None):
        return _det_raw(pkg, op_type, inputs, outputs, attrs or {})

    # -- the attribute activations: thresholds and bounds fed exactly ------
    rng = np.random.RandomState(31)
    ax = f32(rng, 4, 6, lo=-3.0, hi=3.0)
    ax[0] = [0.0, 0.5, -0.5, 1.0, -1.0, 0.3]
    ax[1, :3] = [np.float32(0.3), -np.float32(0.3), 24.5]
    ac = cs(rng, (4, 6), (4, 6))
    acts = {
        "elu": lambda L, x: [L.elu(x), L.elu(x, 0.5)],
        "softshrink": lambda L, x: [L.softshrink(x),
                                    L.softshrink(x, lambda_=0.3)],
        "hard_shrink": lambda L, x: [L.hard_shrink(x),
                                     L.hard_shrink(x, 0.3)],
        "tanh_shrink": lambda L, x: [L.tanh_shrink(x)],
        "thresholded_relu": lambda L, x: [L.thresholded_relu(x),
                                          L.thresholded_relu(x, 0.3)],
        "brelu": lambda L, x: [L.brelu(x), L.brelu(x, -1.0, 1.0)],
        "soft_relu": lambda L, x: [L.soft_relu(x),
                                   L.soft_relu(x, threshold=1.0)],
    }
    for name, layer in acts.items():
        def act(pkg, layer=layer):
            x = D(pkg, "x", ax)
            return grads(pkg, layer(pkg.layers, x), [x], ac)
        add(name, act, dict(ac, x=ax))

    px = f32(rng, 2, 3, 2, 2)
    px[0, :, 0, 0] = 0.0                     # the negative branch at 0
    pc = cs(rng, (2, 3, 2, 2), (2, 3, 2, 2), (2, 3, 2, 2))

    def prelu(pkg):
        x = D(pkg, "x", px)
        L = pkg.layers
        outs = [L.prelu(x, mode) for mode in ("all", "channel", "element")]
        return grads(pkg, outs, [x] + _seq_params(pkg), pc)
    add("prelu", prelu, dict(pc, x=px), seed=32)
    mx = f32(rng, 2, 4, 3, 3)
    mx[0, 1, 0, :] = mx[0, 0, 0, :]          # tied pairs within a group
    mx[1, 3, 2, 2] = mx[1, 2, 2, 2]
    mc = cs(rng, (2, 2, 3, 3), (2, 1, 3, 3))

    def maxout(pkg):
        x = D(pkg, "x", mx)
        return grads(pkg, [pkg.layers.maxout(x, 2), pkg.layers.maxout(x, 4)],
                     [x], mc)
    add("maxout", maxout, dict(mc, x=mx))

    # -- the losses ---------------------------------------------------------
    rng = np.random.RandomState(33)
    logp = np.log(_probs(rng, (4, 5)))
    tgt = _probs(rng, (4, 5))
    tgt[0, 2] = 0.0                          # log(max(t, 1e-10)) · 0
    kc = cs(rng, (1,), (1,), (1,), (4, 5))

    def kldiv(pkg):
        x, t = D(pkg, "x", logp), D(pkg, "t", tgt, False)
        outs = [pkg.layers.kldiv_loss(x, t, r)
                for r in ("mean", "sum", "batchmean", "none")]
        return grads(pkg, flat(pkg, outs[:3]) + outs[3:], [x], kc)
    add("kldiv_loss", kldiv, dict(kc, x=logp, t=tgt))
    pp = rng.uniform(0.05, 0.95, (6, 1)).astype(np.float32)
    yy = (rng.rand(6, 1) > 0.5).astype(np.float32)
    lc = cs(rng, (6, 1), (6, 1))

    def log_loss(pkg):
        p, y = D(pkg, "p", pp), D(pkg, "y", yy, False)
        L = pkg.layers
        return grads(pkg, [L.log_loss(p, y), L.log_loss(p, y, 1e-2)], [p], lc)
    add("log_loss", log_loss, dict(lc, p=pp, y=yy))
    left = f32(rng, 6, 1)
    right = f32(rng, 6, 1)
    right[0] = left[0]                       # d = 0: softplus' slope 1/2
    rc = cs(rng, (6, 1))

    def rank_loss(pkg):
        y = D(pkg, "y", yy, False)
        lv, rv = D(pkg, "l", left), D(pkg, "r", right)
        return grads(pkg, [pkg.layers.rank_loss(y, lv, rv)], [lv, rv], rc)
    add("rank_loss", rank_loss, dict(rc, y=yy, l=left, r=right))
    sign = np.where(yy > 0, 1.0, -1.0).astype(np.float32)
    mrc = cs(rng, (6, 1), (6, 1), (6, 1))

    def margin(pkg):
        y = D(pkg, "s", sign, False)
        lv, rv = D(pkg, "l", left, True), D(pkg, "r", right, True)
        L = pkg.layers
        a = L.margin_rank_loss(y, lv, rv)
        act = _seq_op_output(pkg, "margin_rank_loss", "Activated")
        b = L.margin_rank_loss(y, lv, rv, margin=0.0)   # a tie at l = r
        return grads(pkg, [a, b], [lv, rv], mrc) + [act]
    add("margin_rank_loss", margin, dict(mrc, s=sign, l=left, r=right))
    scores = f32(rng, 4, 5)
    blab = np.array([[0], [4], [2], [2]], np.int64)
    bc = cs(rng, (4, 1))

    def bpr(pkg):
        s, lab = D(pkg, "s", scores), D(pkg, "lab", blab, False)
        return grads(pkg, [pkg.layers.bpr_loss(s, lab)], [s], bc)
    add("bpr_loss", bpr, dict(bc, s=scores, lab=blab))

    # -- the norms: the statistics' outputs and the parameters' gradients -
    rng = np.random.RandomState(34)
    gx = f32(rng, 2, 4, 3, 3)
    gx3 = f32(rng, 2, 6, 5)
    gc = cs(rng, (2, 4, 3, 3), (2, 6, 5))

    def group_norm(pkg):
        x, x3 = D(pkg, "x", gx), D(pkg, "x3", gx3)
        L = pkg.layers
        a = L.group_norm(x, groups=2)
        stats = [_seq_op_output(pkg, "group_norm", s)
                 for s in ("Mean", "Variance")]
        b = L.group_norm(x3, groups=3, epsilon=1e-3, act="relu")
        return grads(pkg, [a, b], [x, x3] + _seq_params(pkg), gc) + stats
    add("group_norm", group_norm, dict(gc, x=gx, x3=gx3), seed=35)
    ic = cs(rng, (2, 4, 3, 3))

    def instance_norm(pkg):
        x = D(pkg, "x", gx)
        a = pkg.layers.instance_norm(x)
        stats = [_seq_op_output(pkg, "instance_norm", s)
                 for s in ("SavedMean", "SavedVariance")]
        return grads(pkg, [a], [x] + _seq_params(pkg), ic) + stats
    add("instance_norm", instance_norm, dict(ic, x=gx), seed=36)
    sw = f32(rng, 6, 4)
    sw3 = f32(rng, 3, 4, 2)
    sc = cs(rng, (6, 4), (3, 4, 2))

    def spectral(pkg):
        w, w3 = D(pkg, "w", sw), D(pkg, "w3", sw3)
        L = pkg.layers
        outs = [L.spectral_norm(w, power_iters=0),      # runs one
                L.spectral_norm(w3, dim=1, power_iters=3)]
        return grads(pkg, outs, [w, w3], sc)
    add("spectral_norm", spectral, dict(sc, w=sw, w3=sw3), seed=37)

    # -- image and shape ops --------------------------------------------------
    rng = np.random.RandomState(38)
    ix = f32(rng, 2, 3, 4, 5)
    padc = cs(rng, (2, 3, 7, 8), (2, 3, 7, 8), (2, 3, 7, 8))

    def pad2d(pkg):
        x = D(pkg, "x", ix)
        L = pkg.layers
        outs = [L.pad2d(x, [1, 2, 2, 1], pad_value=7.0),
                L.pad2d(x, [1, 2, 2, 1], mode="reflect"),
                L.pad2d(x, [1, 2, 2, 1], mode="edge")]
        return grads(pkg, outs, [x], padc)
    add("pad2d", pad2d, dict(padc, x=ix))
    sx = f32(rng, 2, 8, 3, 3)
    psc = cs(rng, (2, 2, 6, 6))

    def pixel_shuffle(pkg):
        x = D(pkg, "x", sx)
        return grads(pkg, [pkg.layers.pixel_shuffle(x, 2)], [x], psc)
    add("pixel_shuffle", pixel_shuffle, dict(psc, x=sx))
    dx = f32(rng, 2, 3, 4, 6)
    dc = cs(rng, (2, 12, 2, 3))

    def space_to_depth(pkg):
        x = D(pkg, "x", dx)
        return grads(pkg, [pkg.layers.space_to_depth(x, 2)], [x], dc)
    add("space_to_depth", space_to_depth, dict(dc, x=dx))
    hx = f32(rng, 2, 6, 3, 3)
    hc = cs(rng, (2, 6, 3, 3), (2, 6, 3, 3))

    def shuffle_channel(pkg):
        x = D(pkg, "x", hx)
        L = pkg.layers
        return grads(pkg, [L.shuffle_channel(x, 3), L.shuffle_channel(x, 2)],
                     [x], hc)
    add("shuffle_channel", shuffle_channel, dict(hc, x=hx))
    afx, afx2 = f32(rng, 2, 3, 4, 4), f32(rng, 4, 3)
    afs, afb = f32(rng, 3), f32(rng, 3)
    afc = cs(rng, (2, 3, 4, 4), (4, 3))

    def affine_channel(pkg):
        x, x2 = D(pkg, "x", afx), D(pkg, "x2", afx2)
        s, b = D(pkg, "s", afs), D(pkg, "b", afb)
        L = pkg.layers
        return grads(pkg, [L.affine_channel(x, s, b),
                           L.affine_channel(x2, s, b)], [x, x2, s, b], afc)
    add("affine_channel", affine_channel,
        dict(afc, x=afx, x2=afx2, s=afs, b=afb))
    # C = 10: C / 4 = 2.5 and C / 2 = 5 (truncated split points); C = 8 at
    # TSM's 1/8
    tx, tx8 = f32(rng, 2 * 4, 10, 2, 2), f32(rng, 3 * 2, 8, 2, 3)
    tc = cs(rng, (8, 10, 2, 2), (6, 8, 2, 3))

    def temporal_shift(pkg):
        x, x8 = D(pkg, "x", tx), D(pkg, "x8", tx8)
        L = pkg.layers
        return grads(pkg, [L.temporal_shift(x, 4),
                           L.temporal_shift(x8, 2, 1.0 / 8)], [x, x8], tc)
    add("temporal_shift", temporal_shift, dict(tc, x=tx, x8=tx8))
    gsx = f32(rng, 2, 3, 4, 5)
    grid = f32(rng, 2, 3, 4, 2, lo=-1.6, hi=1.6)
    grid[0, 0, :, 0] = [-1.0, 1.0, -1.5, 1.5]    # the ends, and outside
    grid[0, 1, :, 1] = [-1.0, 1.0, -1.25, 2.0]
    gsc = cs(rng, (2, 3, 3, 4))

    def grid_sampler(pkg):
        x, g = D(pkg, "x", gsx), D(pkg, "g", grid)
        return grads(pkg, [pkg.layers.grid_sampler(x, g)], [x, g], gsc)
    add("grid_sampler", grid_sampler, dict(gsc, x=gsx, g=grid))

    # -- sampling, indices, linspace, diag, roll ------------------------------
    probs = np.tile(np.asarray(SAMPLING_P, np.float32), (SAMPLING_ROWS, 1))
    probs[0] = [0.0, 0.0, 1.0, 0.0]          # a certain draw

    def sampling_id(pkg):
        return [pkg.layers.sampling_id(D(pkg, "p", probs, False))]
    add("sampling_id", sampling_id, {"p": probs}, tol="stats")
    ids = np.arange(-4, 20, dtype=np.int64).reshape(24, 1)

    def shard_index(pkg):
        i = D(pkg, "i", ids, False)
        L = pkg.layers
        return [L.shard_index(i, 20, 3, 1), L.shard_index(i, 20, 3, 0, -2),
                L.shard_index(i, 19, 2, 1)]
    add("shard_index", shard_index, {"i": ids}, tol="exact")
    ends = {"e%d" % k: np.array([v], np.float32)
            for k, v in enumerate([0.1, 3.7, -2.0, 5.0, 3.0, -1.0])}

    def linspace(pkg):
        L = pkg.layers
        b = [D(pkg, k, v, False) for k, v in sorted(ends.items())]
        return [L.linspace(b[0], b[1], 7), L.linspace(b[0], b[1], 100),
                L.linspace(b[2], b[3], 1), L.linspace(b[4], b[5], 5),
                L.linspace(b[2], b[3], 2)]
    add("linspace", linspace, dict(ends), tol="exact")
    dv, dvi = f32(rng, 5), np.array([3, -1, 7], np.int64)

    def diag(pkg):
        L = pkg.layers
        return [L.diag(D(pkg, "v", dv, False)), L.diag(D(pkg, "vi", dvi,
                                                          False))]
    add("diag", diag, {"v": dv, "vi": dvi}, tol="exact")
    rx = f32(rng, 3, 4)
    rlc = cs(rng, (3, 4), (3, 4), (3, 4))

    def roll(pkg):
        x = D(pkg, "x", rx)
        L = pkg.layers
        outs = [L.roll(x, 5), L.roll(x, -1, dims=0),
                L.roll(x, [1, -2], dims=[0, 1])]
        return grads(pkg, outs, [x], rlc)
    add("roll", roll, dict(rlc, x=rx))

    # -- misc_ops2.py: 3-D vision ------------------------------------------
    rng = np.random.RandomState(39)
    cx = f32(rng, 1, 2, 4, 5, 5)
    c3c = cs(rng, (1, 3, 5, 6, 6), (1, 4, 2, 3, 2))

    def conv3d(pkg):
        x = D(pkg, "x", cx)
        L = pkg.layers
        outs = [L.conv3d(x, 3, 2, padding=1),
                L.conv3d(x, 4, [2, 3, 3], stride=2, padding=[0, 1, 1],
                         dilation=[1, 1, 2], groups=2, bias_attr=False,
                         act="relu")]
        return grads(pkg, outs, [x] + _seq_params(pkg), c3c)
    add("conv3d", conv3d, dict(c3c, x=cx), seed=40)
    tx3 = f32(rng, 1, 4, 3, 3, 3)
    tw = f32(rng, 4, 2, 2, 2, 2)
    ttc = cs(rng, (1, 3, 4, 4, 4), (1, 4, 4, 4, 4))

    def conv3d_t(pkg):
        x, w = D(pkg, "x", tx3), D(pkg, "w", tw)
        L = pkg.layers
        a = L.conv3d_transpose(x, 3, 2, stride=2, padding=1)
        b, = op(pkg, "conv3d_transpose", {"Input": [x], "Filter": [w]},
                {"Output": "float32"},
                {"strides": [1, 1, 1], "paddings": [0, 0, 0],
                 "dilations": [1, 1, 1], "groups": 2})
        return grads(pkg, [a, b], [x, w] + _seq_params(pkg), ttc)
    add("conv3d_transpose", conv3d_t, dict(ttc, x=tx3, w=tw), seed=41)
    plx = rng.permutation(2 * 2 * 4 * 4 * 4).astype(np.float32) \
        .reshape(2, 2, 4, 4, 4) / 16.0       # distinct: no tie in a window
    plc = cs(rng, (2, 2, 4, 4, 4), (2, 2, 3, 3, 3), (2, 2, 1, 1, 1),
             (2, 2, 1, 1, 1))

    def pool3d(pkg):
        x = D(pkg, "x", plx)
        L = pkg.layers
        outs = [L.pool3d(x, 3, "max", 1, 1),         # overlapping windows
                L.pool3d(x, 2, "avg", 2, 1),         # padding counted
                L.pool3d(x, pool_type="max", global_pooling=True),
                L.pool3d(x, 3, "avg", 2, 1, global_pooling=True)]
        return grads(pkg, outs, [x], plc)
    add("pool3d", pool3d, dict(plc, x=plx))

    # -- misc_ops2.py: norms, activations, losses ----------------------------
    rng = np.random.RandomState(42)
    lx = f32(rng, 2, 6, 3, 3)
    lrc = cs(rng, (2, 6, 3, 3), (2, 6, 3, 3))

    def lrn(pkg):
        x = D(pkg, "x", lx)
        a = pkg.layers.lrn(x)                        # the layer's k = 1
        b, mid = op(pkg, "lrn", {"X": [x]},
                    {"Out": "float32", "MidOut": "float32"},
                    {"n": 3, "alpha": 0.1, "beta": 0.6})   # the op's k = 2
        return grads(pkg, [a, b], [x], lrc) + [mid]
    add("lrn", lrn, dict(lrc, x=lx))
    sex = f32(rng, 4, 3)
    sex[0] = [0.0, -0.0, 1e-3]
    sec = cs(rng, (4, 3), (4, 3))

    def selu(pkg):
        x = D(pkg, "x", sex)
        L = pkg.layers
        return grads(pkg, [L.selu(x), L.selu(x, scale=1.5, alpha=2.0)], [x],
                     sec)
    add("selu", selu, dict(sec, x=sex))
    hl = f32(rng, 5, 1)
    hlab = np.array([[1], [0], [1], [0], [1]], np.float32)
    hl[0], hl[1] = 1.0, -1.0                 # the hinge at 0 exactly
    hlc = cs(rng, (5, 1))

    def hinge(pkg):
        lg, lb = D(pkg, "lg", hl), D(pkg, "lb", hlab, False)
        h, = op(pkg, "hinge_loss", {"Logits": [lg], "Labels": [lb]},
                {"Loss": "float32"})
        return grads(pkg, [h], [lg], hlc)
    add("hinge_loss", hinge, dict(hlc, lg=hl, lb=hlab))
    mhx = np.array([[0.5], [1.0], [-1.0], [3.0], [-2.0], [0.2]], np.float32)
    mhy = np.array([[1], [1], [1], [0], [1], [0]], np.float32)
    mhc = cs(rng, (6, 1))

    def huber(pkg):
        x, y = D(pkg, "x", mhx), D(pkg, "y", mhy, False)
        out, s = op(pkg, "modified_huber_loss", {"X": [x], "Y": [y]},
                    {"Out": "float32", "IntermediateVal": "float32"})
        return grads(pkg, [out], [x], mhc) + [s]
    add("modified_huber_loss", huber, dict(mhc, x=mhx, y=mhy))
    sqx, sqy, sqy1 = f32(rng, 4, 3), f32(rng, 4, 3), f32(rng, 1, 3)
    sq3x, sq3y = f32(rng, 2, 3, 2), f32(rng, 2, 3, 2)
    sqc = cs(rng, (4, 1), (4, 1), (2, 1, 1))

    def sq_l2(pkg):
        x, y, y1 = D(pkg, "x", sqx), D(pkg, "y", sqy), D(pkg, "y1", sqy1)
        x3, y3 = D(pkg, "x3", sq3x), D(pkg, "y3", sq3y)
        outs, subs = [], []
        for a, b in ((x, y), (x, y1), (x3, y3)):
            o, sub = op(pkg, "squared_l2_distance", {"X": [a], "Y": [b]},
                        {"Out": "float32", "sub_result": "float32"})
            outs.append(o)
            subs.append(sub)
        return grads(pkg, outs, [x, y, y1, x3, y3], sqc) + subs
    add("squared_l2_distance", sq_l2,
        dict(sqc, x=sqx, y=sqy, y1=sqy1, x3=sq3x, y3=sq3y))
    l1x = f32(rng, 3, 4)
    l1x[0, 0] = 0.0                          # |x|'s gradient 0 at 0
    l1c = cs(rng, (1,))

    def l1_norm(pkg):
        x = D(pkg, "x", l1x)
        o, = op(pkg, "l1_norm", {"X": [x]}, {"Out": "float32"})
        return grads(pkg, flat(pkg, [o]), [x], l1c)
    add("l1_norm", l1_norm, dict(l1c, x=l1x))
    nx = f32(rng, 3, 4, 2)
    nx[0, :, 0] = 0.0                        # a zero column: epsilon
    nc = cs(rng, (3, 4, 2), (3, 4, 2))

    def norm(pkg):
        x = D(pkg, "x", nx)
        outs, norms = [], []
        for axis in (1, -1):
            o, n = op(pkg, "norm", {"X": [x]},
                      {"Out": "float32", "Norm": "float32"},
                      {"axis": axis, "epsilon": 1e-10})
            outs.append(o)
            norms.append(n)
        return grads(pkg, outs, [x], nc) + norms
    add("norm", norm, dict(nc, x=nx))
    bx, by = f32(rng, 4, 5), f32(rng, 4, 6)
    btc = cs(rng, (4, 3), (4, 2))

    def bilinear(pkg):
        x, y = D(pkg, "x", bx), D(pkg, "y", by)
        L = pkg.layers
        outs = [L.bilinear_tensor_product(x, y, 3),
                L.bilinear_tensor_product(x, y, 2, act="tanh",
                                          bias_attr=False)]
        return grads(pkg, outs, [x, y] + _seq_params(pkg), btc)
    add("bilinear_tensor_product", bilinear, dict(btc, x=bx, y=by), seed=43)
    tsx = f32(rng, 8, 1)
    tslab = np.array([[-2.5], [-1.0], [-0.5], [0.0], [0.3], [1.0], [1.7],
                      [-1.5]], np.float32)       # every branch, its bounds
    tsc = cs(rng, (8, 1))

    def ts_loss(pkg):
        x, lab = D(pkg, "x", tsx), D(pkg, "lab", tslab, False)
        return grads(pkg, [pkg.layers.teacher_student_sigmoid_loss(x, lab)],
                     [x], tsc)
    add("teacher_student_sigmoid_loss", ts_loss, dict(tsc, x=tsx, lab=tslab))
    cvx = f32(rng, 4, 6, lo=-1.0, hi=5.0)
    cvx[0, :2] = [-0.5, 0.0]                 # max(·, 0) below and at 0
    cvm_in = np.ones((4, 2), np.float32)
    cvc = cs(rng, (4, 6), (4, 4))

    def cvm(pkg):
        x, c = D(pkg, "x", cvx), D(pkg, "cvm", cvm_in, False)
        L = pkg.layers
        return grads(pkg, [L.continuous_value_model(x, c),
                           L.continuous_value_model(x, c, use_cvm=False)],
                     [x], cvc)
    add("cvm", cvm, dict(cvc, x=cvx, cvm=cvm_in))
    onehot = np.eye(4, dtype=np.float32)[[0, 2, 3]]
    prior = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    lsc = cs(rng, (3, 4), (3, 4))

    def label_smooth(pkg):
        x, p = D(pkg, "x", onehot), D(pkg, "prior", prior, False)
        a, = op(pkg, "label_smooth", {"X": [x]}, {"Out": "float32"},
                {"epsilon": 0.1})
        b, = op(pkg, "label_smooth", {"X": [x], "PriorDist": [p]},
                {"Out": "float32"}, {"epsilon": 0.25})
        return grads(pkg, [a, b], [x], lsc)
    add("label_smooth", label_smooth, dict(lsc, x=onehot, prior=prior))

    # -- misc_ops2.py: shape ops, size, minus, mean_iou -----------------------
    rng = np.random.RandomState(44)
    crx = f32(rng, 3, 5, 4)
    crc = cs(rng, (2, 3, 2), (2, 2, 2), (3, 5, 4))

    def crop(pkg):
        x = D(pkg, "x", crx)
        L = pkg.layers
        outs = [L.crop(x, [2, 3, 2], [1, 1, 2]),
                L.crop(x, [2, 2, 2], [2, 4, 3]),     # past the edge: clamped
                L.crop(x, [3, 5, 4])]
        return grads(pkg, outs, [x], crc)
    add("crop", crop, dict(crc, x=crx))
    big, small = f32(rng, 4, 5, 3), f32(rng, 2, 3, 3)
    pcc = cs(rng, (4, 5, 3))

    def pad_like(pkg):
        x, y = D(pkg, "big", big, False), D(pkg, "small", small)
        return grads(pkg, [pkg.layers.pad_constant_like(x, y, 1.5)], [y], pcc)
    add("pad_constant_like", pad_like, dict(pcc, big=big, small=small))
    ux = f32(rng, 2, 3, 5, 6)
    uc = cs(rng, (2, 18, 14), (2, 12, 20))

    def unfold(pkg):
        x = D(pkg, "x", ux)
        L = pkg.layers
        outs = [L.unfold(x, [2, 3], strides=[1, 2], paddings=[1, 0, 2, 1],
                         dilations=[1, 2]),
                L.unfold(x, 2)]
        return grads(pkg, outs, [x], uc)
    add("unfold", unfold, dict(uc, x=ux))
    szx, szi = f32(rng, 3, 4, 5), np.zeros((7,), np.int64)

    def size(pkg):
        L = pkg.layers
        return [L.size(D(pkg, "x", szx, False)),
                L.size(D(pkg, "i", szi, False))]
    add("size", size, {"x": szx, "i": szi}, tol="exact")
    mix, miy = f32(rng, 3, 4), f32(rng, 3, 4)
    mic = cs(rng, (3, 4))

    def minus(pkg):
        x, y = D(pkg, "x", mix), D(pkg, "y", miy)
        o, = op(pkg, "minus", {"X": [x], "Y": [y]}, {"Out": "float32"})
        return grads(pkg, [o], [x, y], mic)
    add("minus", minus, dict(mic, x=mix, y=miy))
    # class 3 never appears (no union), class 4 only predicted
    pred = np.array([0, 0, 1, 1, 2, 4, 2, 0], np.int64)
    lab = np.array([0, 1, 1, 1, 2, 2, 0, 0], np.int64)

    def mean_iou(pkg):
        p, lv = D(pkg, "pred", pred, False), D(pkg, "lab", lab, False)
        return list(pkg.layers.mean_iou(p, lv, 5))
    add("mean_iou", mean_iou, {"pred": pred, "lab": lab})
    return progs


def _probs(rng, shape):
    e = np.exp(rng.randn(*shape))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def sampling_ok(ids):
    """The sampling_id program's draws: one a row, in ``[0, 4)``, the
    first row's certain class, no draw of the class of probability 0,
    and each class's frequency over the other rows within
    SAMPLING_SIGMAS standard errors of its probability."""
    ids = np.asarray(ids).reshape(-1)
    rest = ids[1:]
    n = rest.size
    freq_ok = all(abs((rest == k).mean() - p) <=
                  SAMPLING_SIGMAS * np.sqrt(p * (1 - p) / n) + 1e-12
                  for k, p in enumerate(SAMPLING_P))
    return bool(ids.shape == (SAMPLING_ROWS,) and ids.min() >= 0 and
                ids.max() < 4 and ids[0] == 2 and freq_ok)


def phase_misc_ops():
    """The 49 op types of ``misc_ops.py`` and ``misc_ops2.py`` (ROADMAP
    item 13c.3b; ``misc_programs``: forward and gradients) on the card
    against the port's CPU path, each from the same weights: floats
    within MISC_TOL, integers and linspace's points equal, sampling_id's
    draws held by statistics on each side (``sampling_ok``; its dtype
    int64 on both); no port kernel launched, and no host sync in a run
    of any program on the card (none of these rules reads a value back).
    Returns the port kernel launches."""
    def sampling_row(name, card, cpu):
        ok = sampling_ok(card[0]) and sampling_ok(cpu[0]) and \
            card[0].dtype == cpu[0].dtype == np.int64
        freq = {side: [float((ids[0] == k).mean()) for k in range(4)]
                for side, ids in (("card", card), ("cpu", cpu))}
        return dict(op=name, card_freq=freq["card"], cpu_freq=freq["cpu"],
                    ok=ok), ok
    return _random_op_programs("misc_ops", misc_programs(), MISC_TOL,
                               sampling_row)


TSM_FEEDS = 4                 # tsm_train: distinct batches, in turn
TSM_CPU = dict(clips=2, image=112, dropout=0.0)   # step 1, card vs CPU:
#                               the zoo's widths and depth, 2 clips of 8
#                               frames at 112² (the CPU cannot run 128
#                               frames of 224² here), dropout off (the
#                               devices' random streams never match)
TSM_LOSS_RTOL = 1e-5          # ... the step-1 loss
TSM_HEAD_GRAD_RL2 = 1e-4      # ... the fc's gradients, each in relative
#                               L2 (TF32 or bf16 products give ~1e-3)
TSM_GRAD_SPREADS = 10.0       # ... and the whole gradient, within this
#                               many times the CPU's own gap when its
#                               frames move by TSM_NUDGE (about an ulp):
#                               53 batch norms over 16 frames make the
#                               gradient that sensitive to rounding
TSM_NUDGE = 1e-7              # the frames' relative perturbation
TSM_WARM, TSM_TIMED = 2, 8    # tsm_train's warm-up and timed steps


def _tsm_program(cfg):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = tsm.build(cfg)
    return main, startup, out


def phase_tsm_train():
    """TSM, the temporal-shift ResNet-50 video classifier
    (``models/tsm.py``, the model zoo's) at ``base_config()``: 16 clips of
    8 frames of 224 x 224 (128 frames a step), 400 classes, 16
    ``temporal_shift``s of 1/8, 53 cuDNN convs and batch norms in fp32,
    dropout 0.5, Momentum 0.9 with L2Decay(1e-4) on the piecewise rate.
    Step 1 from the startup weights at TSM_CPU (2 clips of 8 frames at
    112², dropout off, the same widths and depth), on the card and on the
    port's CPU path: losses within TSM_LOSS_RTOL, the fc's gradients
    within TSM_HEAD_GRAD_RL2, and the whole gradient within
    TSM_GRAD_SPREADS times the CPU's own gap when its frames are nudged
    by TSM_NUDGE.  Then TSM_WARM + TSM_TIMED steps through
    ``timing.timed_steps`` on the card over TSM_FEEDS synthetic batches
    in turn: finite losses, no port kernel launched (``FLAGS_conv_pallas``
    off, as on the reference's ResNet-50 bench), no host sync in a step
    (the host sync counter over the steps, and torch's sync debug mode
    over one step); ms per step, clips and frames a second, peak memory,
    one profiled step's launches, busy share and top kernels, and the
    cost ledger's count of the step.  Returns the path's port kernel
    launches."""
    t0 = time.perf_counter()
    cfg = tsm.base_config()
    main, startup, out = _tsm_program(cfg)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    loss = out["loss"]
    small = dict(cfg, **TSM_CPU)
    smain, _, sout = _tsm_program(small)
    card1, cpu1, whole, spread, heads = _step1_gaps(
        exe, smain, sout["loss"], scope, next(tsm.feeds(small, SEED)),
        "image", TSM_NUDGE, "fc_")
    it = tsm.feeds(cfg, SEED)
    feeds = [_cuda_feed(next(it)) for _ in range(TSM_FEEDS)]
    run = _timed_train(exe, main, loss, feeds, scope, TSM_WARM, TSM_TIMED,
                       "tsm_train")
    launches, step_ms, losses = run["launches"], run["step_ms"], run["losses"]
    rec = run["rec"]
    ops = [o.type for o in main.global_block().ops]
    frames = tsm.images_per_step(cfg)
    checks = {
        "losses_finite": bool(np.isfinite(losses).all()),
        "step1_card_vs_cpu": abs(card1 - cpu1) <= TSM_LOSS_RTOL * abs(cpu1),
        "step1_head_grads_card_vs_cpu": len(heads) == 2 and
        max(heads.values()) <= TSM_HEAD_GRAD_RL2,
        "step1_grad_card_vs_cpu": whole <= TSM_GRAD_SPREADS * spread,
        "no_port_kernel": not any(launches.values()),
        "no_host_sync_in_a_step": run["step_syncs"] == 0 and
        not run["sites"],
        # one shift a bottleneck, ahead of its first 1x1 conv; 53 convs
        "every_shift": ops.count("temporal_shift") == sum(cfg["depth"]) ==
        16 and ops.count("conv2d") == 53 and ops.count("dropout") == 1}
    fwd_flops = _conv_flops(main, frames)
    emit(phase="tsm_train", card=_card(), config=cfg,
         steps=len(losses), program_ops=len(ops),
         conv_gflop_forward=fwd_flops / 1e9,
         conv_tflops_per_s_step=3 * fwd_flops / step_ms / 1e9,
         conv_bound_ms_fp32=3 * fwd_flops / PEAK_FP32_FLOPS * 1e3,
         ledger=dict(tflop=rec["flops"] / 1e12,
                     gbytes=rec["bytes_accessed"] / 1e9,
                     estimated_step_ms=rec["estimated_step_s"] * 1e3,
                     aten_calls=rec["aten_calls"],
                     top_ops=rec["top_ops"][:6]),
         losses=losses, step1_loss_card=card1, step1_loss_cpu=cpu1,
         step1_rel_err=abs(card1 - cpu1) / abs(cpu1), step1_config=TSM_CPU,
         step1_grad_rel_l2=dict(whole=whole, cpu_nudged=spread,
                                gate=TSM_GRAD_SPREADS * spread,
                                heads=heads, parameters=len(
                                    smain.global_block().all_parameters())),
         ms_per_step=step_ms, clips_per_s=cfg["clips"] / step_ms * 1e3,
         frames_per_s=frames / step_ms * 1e3,
         fence=dict(rtt_s=run["detail"]["fence_rtt_s"],
                    wall_s=run["detail"]["window_wall_s"]),
         peak_device_mb=run["peak_mb"],
         host_syncs_over_steps=run["step_syncs"],
         step_sync_sites=run["sites"], profiled_step=run["prof"],
         launches=launches,
         checks=checks, seconds=time.perf_counter() - t0)
    _fail_unless("tsm_train", checks)
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; torch.cuda.is_available() "
              "is false", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    try:
        smi = phase_device()
        phase_build()
        bounds = phase_bounds()
        k2 = phase_kernel()
        bwd = phase_kernel_bwd()
        nmt = phase_kernel_nmt()
        k1 = phase_kernel_conv(bounds)
        k6 = phase_kernel_ln(bounds)
        by_path = {"serve": phase_slice()}
        train = phase_train()
        by_path["train"] = train["launches"]
        by_path["dp_train"] = phase_dp_train(train)
        by_path["dp_two_ranks"] = phase_dp_two_ranks(train)
        by_path["dp_wus"], by_path["dp_wus_bert_int8"] = phase_dp_wus(train)
        by_path["dp_two_ranks_sharded"], by_path["dp_two_ranks_int8"] = \
            phase_dp_two_ranks_sharded(train)
        by_path.update(phase_train_surface(train))
        mp_paths, mp_ref, pp_two = phase_mp_bert(train)
        by_path.update(mp_paths)
        by_path.update(phase_pp_bert(train, mp_ref, pp_two))
        del train, mp_ref
        by_path["train_bias"] = phase_train_bias()
        phase_train_attn_dropout()
        resnet = phase_resnet_train()
        by_path["resnet_train"] = resnet["launches"]
        by_path["dp_resnet"] = phase_dp_resnet(resnet)
        by_path["ln_path"] = phase_ln_path()
        by_path["nmt_train"] = phase_nmt_train()
        by_path["nmt_train_flash"] = phase_nmt_train_flash()
        by_path["lenet_train"] = phase_lenet_train()
        by_path["deepfm_train"] = phase_deepfm_train()
        phase_deepfm_optimizers()
        by_path["wrappers"] = phase_wrappers()
        with _PsCluster(_ps_init()) as cluster:
            by_path["ps_deepfm"], ps_ref = phase_ps_deepfm(cluster)
            by_path["ps_two_trainers"] = phase_ps_two_trainers(cluster, ps_ref)
        del ps_ref
        phase_lookup_grad()
        by_path["ckpt_resume"] = phase_ckpt_resume()
        by_path["export_serve"] = phase_export_serve()
        by_path["predictor_resnet"] = phase_predictor_resnet()
        by_path["window_train"] = phase_window_train()
        by_path["dataset_train"] = phase_dataset_train()
        by_path["elastic_shrink"] = phase_elastic_shrink()
        phase_watchdog_stall()
        moe_paths, ring = phase_moe(pp_two)
        del pp_two
        by_path.update(moe_paths)
        book_paths, mt = phase_book_train()
        by_path.update(book_paths)
        phase_book_check(mt)
        del mt
        phase_control_flow()
        phase_sequence_ops()
        by_path["crnn_ctc_train"] = phase_crnn_ctc_train()
        _reset_launches()
        phase_detection_ops()
        by_path["detection_ops"] = _launches()
        by_path["ssd_train"] = phase_ssd_train()
        by_path["ssd_head_k1"] = phase_ssd_head_k1()
        by_path["core_ops"] = phase_core_ops()
        by_path["yolov3_train"], yscope, yhost = phase_yolov3_train()
        by_path["yolov3_eval"] = phase_yolov3_eval(yscope, yhost)
        del yscope, yhost
        torch.cuda.empty_cache()
        by_path["yolo_k1"] = phase_yolo_k1()
        by_path["misc_ops"] = phase_misc_ops()
        by_path["tsm_train"] = phase_tsm_train()
        torch.cuda.empty_cache()
        phase_cost_ledger()
        phase_op_bench()
        timings = dict(flash_attention_fwd=k2,
                       flash_attention_bwd_dq=bwd["dq"],
                       flash_attention_bwd_dkv=bwd["dkv"],
                       flash_attention_bwd_dbias=bwd["dbias"],
                       conv3x3_bn_relu=k1, layer_norm=k6)
        csrc = "paddle_tpu_torch/csrc/"
        rows = []
        for name, source, replaces in (
                ("flash_attention_fwd", "flash_attention_fwd.cu",
                 "pallas_ops.py:44"),
                ("flash_attention_bwd_dq", "flash_attention_bwd.cu",
                 "pallas_ops.py:115"),
                ("flash_attention_bwd_dkv", "flash_attention_bwd.cu",
                 "pallas_ops.py:152"),
                ("flash_attention_bwd_dbias", "flash_attention_bwd.cu",
                 "pallas_ops.py:196"),
                ("conv3x3_bn_relu", "conv3x3_bn_relu.cu", "conv_pallas.py:33"),
                ("layer_norm", "layer_norm.cu", "pallas_ops.py:706")):
            t = timings[name]
            paths = {p: c.get(name, 0) for p, c in by_path.items()}
            rows.append(dict(
                name=name, route="cuda", source=csrc + source,
                replaces="paddle_tpu/fluid/ops/" + replaces,
                launches=sum(paths.values()), launches_by_path=paths,
                max_abs_err=t["max_abs_err"], ms=t["ms"],
                plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], library_ms=t["library_ms"],
                **({"ops_peak": t["ops_peak"]} if "ops_peak" in t else {}),
                **({"per": t["per"]} if "per" in t else {})))
            if name == "conv3x3_bn_relu":
                rows[-1]["variants_resnet_train"] = resnet[
                    "k1_launches_by_variant"]
            keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
            if name == "flash_attention_fwd":
                # the row's numbers are the serving shape's; training
                # launches it with the LSE at BH = 384
                rows[-1]["training_with_lse"] = {
                    key: bwd["fwd_with_lse"][key] for key in keys}
                # the flash ring (K2 with the LSE per step, K3/K4 with the
                # global LSE) at the MoE block's shape, rank 0's wall ms of
                # forward + backward beside the einsum ring's
                rows[-1]["flash_ring"] = ring
            nmt_key = {"flash_attention_fwd": "fwd", "flash_attention_bwd_dq":
                       "dq", "flash_attention_bwd_dkv": "dkv"}.get(name)
            if nmt_key:
                # Transformer NMT's shape (BH = 256, S = 256, D = 64; K2 with
                # the LSE), causal and with the pad bias, fp32 and bf16
                rows[-1]["nmt"] = {}
                for case, t in nmt["timings"][nmt_key].items():
                    e = nmt["errors"][case]
                    err = max(e["dk"], e["dv"]) if nmt_key == "dkv" else \
                        e[nmt_key]
                    rows[-1]["nmt"][case] = dict(
                        {key: t[key] for key in keys}, max_abs_err=err)
    except BaseException:
        # where a failed run's time went; the failure goes on as it was
        emit(phase="wall_at_failure", seconds=time.perf_counter() - t_start,
             by_phase=_seconds_by_phase(t_start))
        raise
    emit(phase="wall", seconds=time.perf_counter() - t_start,
         by_phase=_seconds_by_phase(t_start))
    emit(kernels=rows)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["dp_child"]:
        sys.exit(dp_child(*sys.argv[2:4]))
    if sys.argv[1:2] == ["ps_child"]:
        sys.exit(ps_child(*sys.argv[2:5]))
    sys.exit(main())

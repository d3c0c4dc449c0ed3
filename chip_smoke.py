#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root; needs a CUDA GPU and nvcc

Phases (any failure raises, and the exit code is non-zero):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. builds the hand-written CUDA kernels from this checkout (one nvcc per
     source, in parallel) and JIT-compiles the Triton ln_quant kernel;
  3. holds every kernel against its plain PyTorch version on the card:
     the attention kernel (bf16 and float32; int8_io with per-head and
     per-tensor scales; int8_out; plain, head-mean and rollout variants;
     clamp on and off; ViT-B B=8 N=197 and a ragged B=3 N=37; bf16 and
     float32 also at B=16 N=197 with 6 heads, a tensor-parallel rank's
     share; bf16 and int8 in the tensor-core design, launched twice for identical bits, and in the
     FMA design they ran before), the int8 GEMM
     (each prologue and epilogue at the five ViT-B GEMM shapes, M = 8*197,
     and a ragged M=111 K=200 N=72; the tensor-core design bit for bit the
     dp4a design it replaced), ln_quant, the fused MLP kernels in every
     design that takes the shape (bf16 and int8: the wgmma design, launched
     twice for identical bits, and the mma design it replaced; mlp_fused at
     bf16 and float32, both GELUs, the designs within TOL_MLP of each other;
     mlp_fused_int8 bit for bit at float32 output, and bit for bit the chain
     of two linear_int8 launches and the other design; M = 8*197 and 8*197+37
     at the ViT-B widths, M=111 with C, HID = 64, 256 and, the mma design
     only, 72, 200 and 66, 150), their occupancy in both designs (blocks an
     SM, registers, spills, shared memory) and the attention block kernel (bf16 in
     its tensor-core design, launched twice for identical bits, and in the
     FMA design it ran before, and float32; with and without the joint,
     clamp on and off, 30 % background and none, B=8 N=197, a ragged B=3
     N=37, and N=256 and N=17, the ends of its range), and reads the block
     kernel's occupancy (clusters at once, registers, local and shared
     memory) in both designs; the same block checks at the zoo's shapes at
     B=2 (ViT-H/14's N=257 C=1280 in 16 heads of 80, ViT-L/16@384's N=577,
     ViT-L/16@512's N=1025 and ViT-L/16's N=197 at C=1024), the streamed
     design's launches twice for identical bits in both dtypes, its
     occupancy and shared memory held to the Python formula; then times
     each kernel against its plain version at B=64 in turns (the designs
     they ran before are checked above and no longer timed: they do not
     change; the GEMMs beside bf16 F.linear and torch._int_mm; kernel 1's
     int8 rollout variants also at B=16 N=577; ln_quant also at batch 256's
     rows,
     and it and the GEMMs also out of a CUDA graph), the three fused kernels
     also beside the unfused route of several launches that the port
     already has (the MLP kernels also at M = 50432; the block kernel's
     streamed design also at ViT-H/14's B=64 N=257 and ViT-L/16@512's B=32
     N=1025);
  4. the main path: ViT-B/16 with random weights from a seed answers 3
     requests of 32 images with the rollout CAM in serving mode "bf16",
     then, calibrated on 16 seeded images, in "int8" and "int8_hifi" with
     ln_quant_fusion and int8_fused_gemm on.  Every launch count is set to 0
     before each path and read after it: one attention launch per layer,
     49 int8 GEMM launches and 24 (int8) / 12 (int8_hifi) ln_quant launches
     per forward.  The bf16 path is compared with the eager path, each int8
     path with the same quantized model on the CPU (the plain versions) on
     five seeded batches of 4 and 8 images; int8 CAMs against the bf16 ones
     are recorded; bf16, bf16 eager, int8 and int8_hifi are timed at batch
     256, in turns.  Then the two fused paths, served the same way: "bf16
     fused" (mlp_fusion and attn_block_fusion on: 12 attention_block_fused,
     12 mlp_fused and no attention-kernel launch per forward; held to the bf16
     kernel path) and "int8 fused" (the int8 model with both knobs on: 12
     mlp_fused_int8, 12 attention, 25 int8 GEMM and 12 ln_quant launches, the
     quantized qkv layer falling through the block kernel; held to the CPU
     plain versions as the other int8 paths), both in the batch-256 timing;
     and at float32, batch 4, the fused kernel path against the eager path;
  5. the backward attention kernel against its plain version (bf16 and
     float32, clamp off and on, 30 % background and none; at float32 also
     against torch.autograd through the plain forward) in every design that
     takes the shape: at bf16 the tensor-core design (the training path's;
     launched twice for identical bits) and the FMA designs bf16 ran before
     (one block per head where its tiles fit, two kernels), at float32 the
     two FMA designs; at head width 64 B=8 N=197, a ragged B=3 N=37, B=2
     N=577 and B=1 N=760 (12 heads), at head width 80 (16 heads) B=8 N=257,
     B=3 N=37 and B=2 N=577, B=1 N=1025 at both widths, a tensor-parallel
     rank's share (B=16 N=197 at 6 heads of 64, B=8 N=257 at 8 of 80), and
     each width's limit (BWD_MAX_N: 1564, 1520; 1704, 1656, 1636 at 16,
     32, 40), one past it refused by both wrappers and
     head width 48 refused; the occupancy of every backward kernel at N =
     197, 257 and 1025 with the ptxas spills of both translation units; then
     at bf16, B=64 N=197, B=16 N=577, ViT-H/14's B=64 N=257 (16 heads of 80)
     and ViT-L/16@512's B=16 N=1025 (16 heads), each design held to the
     plain version, then the tensor-core design, the plain version and the
     backward of F.scaled_dot_product_attention with the same mask (the
     library call: timed only, never on a path) in turns,
     beside the bound; kernel 1's training variant (bf16, plain, no clamp)
     at the last two shapes against its plain version, timed in turns;
  6. the training path: ViT-B/16 at full depth, float32 masters with bf16
     compute, attn_impl="kernel", remat on, batch 64, seeded weights and
     batches, through make_optimizer, create_train_state and
     train_one_epoch over an in-memory loader of 5 batches, then 5
     train_step calls on one fixed batch (the losses must be finite and
     fall), one train_step_accum with 2 microbatches and evaluate on 2
     batches.  The launch counts are set to 0 before and read after each
     part: per step and layer the forward kernel twice (forward and remat
     recompute) and the backward kernel once.  Every parameter must have
     moved; in a second run with freeze_backbone only the heads may; the step
     count and the learning rate must follow the schedule;
  7. one float32 training step at batch 8 on the kernel path against the
     eager path from the same weights (loss and every gradient), and the
     training throughput of both paths at batch 64, in turns (two readings
     of 20 steps each per path, with their spread).
  8. the sequence-parallel kernel (masked_attention_seq_local) against its
     plain version on every rank's shard of 1, 2, 4 and 8 ranks at N = 197,
     577 and 1025 (Np = 1032 at 8), float32 (the FMA design) and bf16 (the
     tensor-core design, launched twice for identical bits), clamp on and
     off, with and without the head mean (float32 and the element type), no
     background, 30 % and all but cls; the stitched shards against the
     attention kernel of the unsharded path where that takes the length; at
     B=16 N=577 C=1024 (one rank, and a shard of four) the tensor-core
     design and the FMA design bf16 ran before held to the plain version
     there, then the tensor-core design, the plain version and
     F.scaled_dot_product_attention with the same mask (timed only), in
     turns; the same kernel at head width 80 (16 heads; its own translation
     unit, as 16, 32 and 40) on every rank's shard of 1, 2, 4 and 8 ranks at
     N = 257 and 1025 in the same matrix, the stitched shards against kernel
     1 at width 80; at 16, 32 and 40 phase 24's shapes (WIDTH_CASES) in a
     compact matrix (30 % background; the float32 head mean with the clamp,
     and neither); widths 24 and 48 refused; each width at its longest
     padded axis (SEQ_MAX_NP: 1660, 1624, 1604, 1548, 1512 at 16,
     32, 40, 64, 80) against the plain version and one key past it refused;
     every width's occupancy at Np = 257 and at its limit; timed in turns
     with the plain version and SDPA at ViT-H/14's B=64 N=257 H=16 on one
     rank and a shard of two (NQ=129, Np=258) and at 16, 32 and 40 at phase
     24's timed shapes on one rank;
  9. the sequence-parallel main path: ViT-L/16@384 at full depth and width
     (24 layers, C=1024, 16 heads, N=577), seeded random weights of the 224
     model loaded through the 224 -> 384 pos-embed interpolation, bf16
     serving, apply_seq_parallel on a one-rank NCCL process group: 3
     requests of 16 images with the rollout CAM; 24 seq-kernel launches per
     forward and no launch of the unsharded attention kernel; held to the
     same model's unsharded kernel path (bf16 gates) and, at float32 and
     batch 2, to rollout row 1e-5 and logits 2e-4; throughput at batch 16 in
     turns with the unsharded kernel path (rollout_post on and off) and the
     eager path; then the same model with --seq_parallel 2 in two spawned
     processes that share the card (gloo, CUDA tensors staged through host
     memory), rank 0's outputs against the one-rank run;
 10. the validate entry point: cli.validate with ViT-L/16@384, --serving
     bf16, --seq_parallel 1, pseudo-seg PNGs, rollout-CAM overlays and
     scoring, on a faked VOC tree written to a temporary directory from a
     numpy seed.
 11. the split-tensor kernel (masked_attention, v1) against its plain
     version: float32 and bf16, with and without the head mean, 30 %
     background, none and all, B=8 N=197, a ragged B=3 N=37 and B=2 N=577
     (bf16 in its tensor-core design, launched twice for identical bits, and
     in the FMA design it ran before); its time at B=64 N=197 bf16 in the
     tensor-core design in turns with its plain version, beside the fused
     kernel's
     plain variant and F.scaled_dot_product_attention (timed only);
 12. the fused attention kernel with q_block 16 against 32 at B=8 N=197
     (bit-identical out), q_block 16 alone at N=1025 against the plain
     version, and a forced q_block 32 there refused;
 13. the eight attn_variants kernels against run_ref at B=8 N=197 and B=3
     N=37, bf16 (the tensor-core design, launched twice for identical bits,
     and the FMA design it ran before) and float32, and the tensor-core
     ``full`` bit for bit against kernel 1's bf16 rollout variant; then
     ``attn_variants --all`` at B=512 (eight ms/layer lines and the
     differences) and each variant's tensor-core design in turns with its
     plain version, ``full`` also beside kernel 1;
 14. the bench entry point through ``bench.main``, one JSON line each:
     default (int8), --bf16, --int8-hifi, --bf16 --xla, --no-cam, --latency,
     --mlp-fusion, --train --mixed --batch 64, ViT-L/16@384 --batch 16
     --bf16, and --f32 --batch 64 with and without --precision high (batch
     512 elsewhere); every run's launch counts are held to what its
     configuration must launch (12 attention launches per forward, 49 int8
     GEMM launches per int8 forward, ...);
 15. microbench (attn-v1, attn-v1-headmean, attn-rollout, model) at its
     default batch and qblock_sweep --batch 16 --seq 577 --bf16 --post.
 16. the quality protocol on trained weights (run after phase 7): through
     ``scripts.quality_eval.main``, ViT-B/16 fine-tuned afresh on the card
     for 600 steps at batch 64 with blocks 0-3 frozen (kernel 1's plain
     variant 24 times and the backward kernel 12 times a step), then scored
     on 256 held-out synthetic images against the float32 truth: the
     sabotaged background gate, bf16, int8_hifi, int8 and the per-tensor r2
     int8 scales; every launch count held.  Gates: the printed losses finite
     and falling, blocks 0-3 bit for bit their init and blocks 4-11 moved,
     truth mAP >= 0.95 and mIoU >= 50, the sabotage at least 5 points
     below, each serving row within 0.02 mAP and 3 mIoU of the truth, with
     a top-16 overlap >= 0.95.  Then "bf16 fused", "int8 fused" and "f32 high"
     on the same weights (recorded: finite, mAP within 0.02), seg_diagnose
     on the saved weights (the mask must engage in a block >= 4), and the
     precision ladder against float32 and float64 CPU references (the
     highest rungs within 1e-5 of the float32 one).
 17. the user path on the weights phase 16 leaves (run right after it):
     ``cli.tools convert`` takes the fine-tuned .pt to the JAX package's .npz
     and on to a reference .pth (the three state dicts bit for bit);
     ``cli.predict`` on one seeded 224 PNG of quality_eval's kind, ViT-B/16
     at full width, on the kernel path from the .npz and from the .pth (12
     launches of kernel 1's float32 rollout variant each; every array but
     the .pth's re-initialised head's logits bit for bit) and on the eager
     path (none), kernel vs eager within the float32 gates (CAMs 1e-5,
     head1 probabilities and logits 2e-4, token_sim 1e-4; the grid only
     where matplotlib is installed); ``scripts.e2e_bench`` at BASELINE
     config #3 (--n 128 --batch 64 --serving int8 --img 500x375: 24
     attention and 98 int8 GEMM launches, 128 PNGs and 128 overlays, finite
     mAP / mIoU, warm img/s printed); and ``examples.quickstart`` at its
     defaults (head width 64: kernel 1 and the backward kernel in the
     fine-tune, kernel 1 in both validate runs and predict, the int8 GEMM in
     the int8 validate), every launch count held per CLI call; since phase
     18 its step 6 too (``cli.export --check`` of the int8 tiny model and
     ``examples.serve_artifact`` over its val images).
 18. the serving artifact on the same weights: ``cli.export`` in int8 and
     bf16 at batch 64 through ``main`` (``--calib_npy``: quality_eval's 16
     calibration images), and int8 with ``ln_quant_fusion``,
     ``int8_fused_gemm`` and ``mlp_fusion`` and bf16 with ``mlp_fusion`` and
     ``attn_block_fusion`` through ``build_fn``'s overrides, each with
     ``--check`` (the loaded artifact bit for bit the live function); the
     launches of one artifact call and of one live call held to the
     forward's (kernels 1, 4, 6, 7, 8 and 9 as ``vitcam`` custom ops);
     export time, ``.pt2`` size and img/s of artifact and live function in
     turns recorded; ``examples.serve_artifact`` over 70 generated JPEGs
     from the int8 artifact (two calls, the tail padded): 70 overlays and
     the live model's printed classes.
 19. the zoo's widest and longest models (run right after phase 4): kernel
     1 at head width 80 (ViT-H/14's) against its plain version in every
     design and variant (float32 FMA; bf16 tensor-core, twice for identical
     bits, q_block 32 bit for bit 16, and FMA; int8_io per head and per
     tensor; int8_out; clamp on and off; B=8 N=257 H=16, B=3 N=37, B=2
     N=577; bf16 and float32 at B=8 N=257 H=8, a tensor-parallel rank's
     share; N=1025 at q_block 16, a forced 32 refused; head width 48
     refused), timed at B=64 N=257 H=16 (bf16 and int8_io rollout,
     tensor-core / plain in turns) beside its bound, with the
     occupancy of every kernel-1 instance at N=197 (dh 64) and N=257 (dh
     80) and the ptxas spills; ViT-H/14 at full width and depth (32 layers,
     C=1280, N=257, pre-logits 1280) and ViT-L/16@512 (24 layers, N=1025,
     the 224 model's seeded weights through the pos-embed interpolation)
     served in bf16 (held to the eager path), int8 and int8_hifi (ln_quant
     and the fused GEMM on; held to the same quantized model on the CPU on
     one seeded batch): 3 requests of 32 / 2 of 16 with their launch counts
     (32 / 24 kernel-1 launches a forward, 129 / 97 int8 GEMM launches an
     int8 forward), then in bf16 with mlp_fusion and with both fusions
     (the block kernel's streamed design, the rollout carried through the
     layers: 32 / 24 launches a forward, held to the eager path), img/s at
     batch 64 / 32 in turns; kernel 1's int8_io
     against int8_out head-mean variant at B=32 N=1025 H=16; bench.main at
     ViT-H/14 (int8 and --bf16, batch 64) and ViT-L/16@512 (batch 32), and
     cli.predict at ViT-H/14 (--no_figure), their launch counts held;
     ViT-H/14, the same build, also under apply_seq_parallel on a one-rank
     NCCL process group: float32 at batch 2 against its unsharded kernel
     path (rollout row 1e-5, logits 2e-4), bf16 over the 3 requests of 32
     against the unsharded bf16 kernel path within ZOO_BF16_GATES (32
     seq-kernel launches at head width 80 a forward, none of kernel 1), its
     img/s in the turns at batch 64.
 20. the zoo trained (run right after phase 19): ViT-H/14 (32 layers,
     C=1280, 16 heads of 80, N=257) at batch 64 and ViT-L/16@512 (24 layers,
     N=1025, the 224 model's seeded weights through the pos-embed
     interpolation) at batch 16, at full width and depth as cli.train builds
     them (no pre-logits layer), float32 masters with bf16 compute,
     attn_impl="kernel", remat on: train_one_epoch over 3 in-memory batches,
     then 5 train_step calls on one fixed batch (losses finite and falling,
     every parameter moved), each held to its launch counts (per step and
     layer kernel 1 twice and the backward once, at the model's head
     width); one float32 step at batch 4 / 2 on the kernel path against the
     eager path (loss and every gradient, TRAIN_TOL); training img/s of
     both paths in turns with a step's peak memory; bench.main --train
     --mixed --model at batch 64 / 16, its launch counts held.
 21. data parallelism on one card (run after phase 10): two gloo ranks
     share the card through ``parallel.worker`` (NCCL refuses two ranks on
     one device; CUDA tensors are staged through host memory), ViT-B/16 at
     full width on the kernel path.  A float32 DP step at global batch 8 (4
     a rank) against the one-rank step in this process, loss and every
     parameter's change within TRAIN_TOL (AdamW with eps 1, lr 1 and no
     decay, so that a first step's change is -g / (|g| + 1) and the
     gradient tolerance holds); a ZeRO-1 step and two accumulation steps
     under DP against the DP step, each rank's moment bytes against the
     unsharded ones; five mixed-precision DP steps at global batch 64
     (float32 masters, bf16 compute, remat) with the parameters' digests
     bit-equal on both ranks after every step and each rank's launches a
     step held (24 kernel-1, 12 backward); the img/s of the two ranks
     sharing the card beside one rank alone, in turns (no scaling
     figure); ``cli.validate --data_parallel`` on two ranks (ViT-B/16, a
     faked VOC tree of 11 images, batch 4, bf16 and int8) against the
     one-rank run: the PNGs byte for byte, mAP and mIoU equal.
 22. tensor parallelism and the pipeline on one card (run after phase 21):
     two gloo ranks share the card as in phase 21.  ViT-B/16 on a (1, 2)
     ('data', 'model') mesh on the kernel path (kernel 1 and the backward
     at 6 heads of 64 a rank): a float32 step at batch 8 against the
     one-rank step (TRAIN_TOL); five mixed-precision steps at batch 16 with
     the leaves both ranks hold whole bit-equal after each and the launches
     a step held (24 kernel-1, 12 backward); bf16 CAMs at batch 32 and
     float32 at batch 4 against one rank's kernel path (TP_GATES), 12
     head-mean launches a forward.  ViT-H/14 (8 heads of 80 a rank): a
     float32 step at batch 4 against the one-rank step (TRAIN_TOL) and a
     mixed step at batch 8 (loss finite, each rank's peak memory beside
     one rank alone), the launches held.  ViT-B/16 as a (1, 2) ('data',
     'stage') pipeline on the eager path: pipeline_forward at M = 2 and 4
     and one pipeline_train_step against one rank with the per-sample mask
     norm, 6 blocks a stage, no launch.  img/s of the two tensor-parallel
     ranks beside one rank alone, in turns (no scaling figure).
 23. sequence-parallel training and the batch-sharded artifact on one card
     (run after phase 22): two gloo ranks share the card as in phase 21.
     ViT-L/16@384 at full width and depth (24 layers, C=1024, N=577 as 289
     and 288 rows, padded to 578), built once on the host and copied into
     the ranks, on a (1, 2) ('data', 'seq') grid on the eager path: a
     float32 step at batch 2 against the one-rank step (TRAIN_TOL), three
     mixed-precision steps at batch 4 (float32 masters, remat; losses
     finite, the last below the first, every leaf bit-equal on both ranks
     after each, no kernel launch), each rank's peak memory beside one
     rank's, and one step with the K/V gathers and the gradient sum timed;
     the trained weights served in bf16 by the sequence-parallel kernel (24
     launches a rank and forward) against one rank's unsharded kernel path
     (SEQ_GATES).  ``cli.export --data_parallel`` of ViT-B/16 (phase 16's
     weights) at global batch 64 in int8 and bf16 by both ranks: ``--check``
     bit for bit on each rank's rows, the sidecar's ``nr_devices`` 2, each
     rank's launches a call held (12 kernel-1 and 49 ``linear_int8``; 12),
     the ranks' outputs against the one-rank artifact at batch 64
     (SP_EXPORT_GATES), and ``serve_artifact`` of the int8 one on both
     ranks over 70 JPEGs (rank 0 writes the overlays and prints the
     one-rank artifact's classes).
 24. kernel 1, the backward, the split-tensor kernel and the block kernel
     at head widths 16, 32 and 40 (run after phase 20; each width its own
     translation unit): at the JAX kernel
     tests' fuzz shapes (B=2: N=130, 4 heads of 32; N=147, 3 of 40; N=513
     and 1025, 2 of 32) and the JAX quickstart's N=65 with 4 heads of 16,
     kernel 1 in every dtype and int8 option (bf16, float32, int8_io per
     head and per tensor, int8_out), variant, clamp and design, the
     backward in both dtypes, both backgrounds, clamp off and on and every
     design, against their plain versions at the width-80 gates (the
     tensor-core designs twice, for identical bits); widths 24 and 48
     refused; each width's occupancy; each width timed at one shape (16:
     B=64 N=65 H=4; 32: B=16 N=1025 H=2; 40: B=64 N=147 H=3), kernel 1's
     bf16 and int8_io rollout against the FMA design and the plain version,
     the bf16 backward against its other designs, the plain version and the
     SDPA backward, in turns, beside the bounds; each width's model through
     bench.main (the JAX quickstart's tiny ViT; ViT-B/16's token grid at C =
     128 in 4 heads and C = 120 in 3), served in bf16 at batch 64 and
     trained at batch 32, the launch counts held at the model's width.  The
     quickstart of phase 17 trains and serves at width 16 too (the JAX tiny
     config), its width-16 counts held.  Each check's limit cases of phase 5
     now also run at 16, 32 and 40 (BWD_MAX_N 1704, 1656, 1636).  Each
     width's model also under apply_seq_parallel on a one-rank NCCL process
     group: float32 at batch 2 against its unsharded kernel path (rollout
     row 1e-5, logits 2e-4), bf16 over 3 requests of 64 against its
     unsharded bf16 kernel path (SEQ_GATES), a seq-kernel launch a layer at
     the model's width held.  The split-tensor kernel (v1) at head widths
     16, 32, 40 and 80 (each its own translation unit) against its plain
     version at the fuzz shapes, the JAX kernel test's B=2 N=37 in 4 heads
     of 16 and ViT-H/14's B=64 N=257 in 16 heads of 80, both dtypes and
     designs, with and without the head mean, background none, 30 % and
     all (the tensor-core design twice, for identical bits); width 40 with
     NaN past the tensors' ends; each width at V1_MAX_N and one key past it
     refused; widths 24 and 48 refused; its occupancy; each width timed
     against the plain version and SDPA with the pair mask, in turns; its
     path: each width's masked_attention at its timed shape in both dtypes,
     with and without the head mean, four launches a width held.  The
     block kernel's streamed design at 16, 32 and 40 against its plain
     version at the width models' shapes (B = 2 and 64), both dtypes, every
     background, joint and clamp, its occupancy, timed at B = 64 beside the
     unfused route; each width model with attn_block_fusion: float32 at
     batch 2 against its eager path (rollout row 1e-5, logits 2e-4), bf16
     over the 3 requests of 64 against its bf16 kernel path (CAM and logits
     5e-2), a block launch a layer held, and img/s at batch 64 of the two
     paths in turns.
 25. the CNN-CAM demo: cli.cnn_cam_demo.main for resnet18, squeezenet1_1
     and densenet161 at full width, 224 x 224, seeded weights, on the card
     and with --device cpu (the same top-5, CAMs within one step on at most
     1 % of the pixels), each module on the card against the same module on
     the CPU at float32 with TF32 off (logits and features within 1e-4 of
     their largest magnitude), and its warm img/s at batch 1 and 64.  The
     convolutions are cuDNN's, as the JAX ones are XLA's: no kernel row.
Nothing of the earlier phases was reduced.  It prints one JSON line
describing the kernels (with each one's bound from the shapes it was timed
at, and the library call's time where one PyTorch call computes the same
function), the card line, and as its last line {"ok": true, "device":
{...}}.  It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CSRC = "vision_transformer_cam_tpu_torch/kernels/csrc/"
# kernel 1's launches at head width 80 (ViT-H/14), a row of their own
W80 = "masked_attention_fused[head width 80]"
# the backward's calls at head width 80 (ViT-H/14's training path) and at
# N = 1025 (ViT-L/16@512's), rows of their own
BWD80 = "masked_attention_bwd[head width 80]"
BWD1025 = "masked_attention_bwd[N=1025]"
# kernel 1's and the backward's launches at head widths 16 (the JAX
# quickstart's tiny ViT), 32 and 40 (the JAX kernel tests' fuzz widths), rows
# of their own
NEW_WIDTHS = (16, 32, 40)
FWD_W = {dh: f"masked_attention_fused[head width {dh}]" for dh in NEW_WIDTHS}
BWD_W = {dh: f"masked_attention_bwd[head width {dh}]" for dh in NEW_WIDTHS}
# the fused MLP kernels' widths with rows of their own in the kernels line:
# ViT-B's, then ViT-L's and ViT-H/14's (two column groups each, the instances
# of mlp_fused_wgmma_wide.cu), launched by phase 19's fused paths
MLP_WIDTHS = (768, 1024, 1280)
MLP_W = {c: f"mlp_fused[C={c}]" for c in MLP_WIDTHS[1:]}
MLP8_W = {c: f"mlp_fused_int8[C={c}]" for c in MLP_WIDTHS[1:]}
# the block kernel's streamed design (attention_block_streamed.cuh), a row
# a head width: its calls at ViT-H/14's width 80 and at ViT-L/16@512's
# width 64, which phase 19's both-fusion paths launch, each timed at its
# model's shape (B, N, heads)
BLOCK_W = {80: "attention_block_fused[N=257 C=1280 w80]",
           64: "attention_block_fused[N=1025 C=1024]"}
BLOCK_TIMED = {80: (64, 257, 16), 64: (32, 1025, 16)}
# the streamed design's instances at head widths 16, 32 and 40, a row a
# width: phase 24's width models launch them under attn_block_fusion
BLOCK_NW = {dh: f"attention_block_fused[head width {dh}]" for dh in NEW_WIDTHS}
# the split-tensor kernel's (v1) instances at head widths 16, 32, 40 and 80,
# a row a width (phase 24's v1 path launches them)
V1_WIDTHS = (16, 32, 40, 80)
V1_W = {dh: f"masked_attention[head width {dh}]" for dh in V1_WIDTHS}
# the sequence-parallel kernel's instances at head widths 80 (ViT-H/14 served
# under sequence parallelism in phase 19) and 16, 32 and 40 (phase 24's
# models under it), a row a width, each timed at its shape (B, N, heads) on
# one rank: ViT-H/14's, and the widths' of phase 24 (WIDTH_TIMED)
SEQ_WIDTHS = (80, 16, 32, 40)
SEQ_W = {dh: f"masked_attention_seq[head width {dh}]" for dh in SEQ_WIDTHS}
SEQ_TIMED = {80: (64, 257, 16), 16: (64, 65, 4), 32: (16, 1025, 2),
             40: (64, 147, 3)}
KERNELS = {   # name: (route, source, TPU kernel replaced)
    "masked_attention_fused": (
        "cuda", CSRC + "masked_attention.cu",
        "vision_transformer_cam_tpu/kernels/attention.py:133"),
    # the same kernel as the training path launches it: bf16, plain variant,
    # no clamp (the forward of fused_attention_diff)
    "masked_attention_fused[bf16 plain, training]": (
        "cuda", CSRC + "masked_attention.cu",
        "vision_transformer_cam_tpu/kernels/attention.py:133"),
    # the same kernel's instances at head width 80 (csrc/masked_attention.cuh
    # instantiated by masked_attention_w80.cu), bf16 rollout as ViT-H/14's
    # bf16 serving path launches them
    W80: (
        "cuda", CSRC + "masked_attention_w80.cu",
        "vision_transformer_cam_tpu/kernels/attention.py:133"),
    "linear_int8_fused": (
        "cuda", CSRC + "int8_gemm.cu",
        "vision_transformer_cam_tpu/kernels/gemm.py:232"),
    "ln_quant": (
        "triton", "vision_transformer_cam_tpu_torch/kernels/gemm.py",
        "vision_transformer_cam_tpu/kernels/gemm.py:167"),
    "masked_attention_bwd": (
        "cuda", CSRC + "masked_attention_bwd.cu",
        "vision_transformer_cam_tpu/kernels/attention.py:803"),
    # the backward's instances at head width 80 (csrc/masked_attention_bwd.cuh
    # instantiated by masked_attention_bwd_w80.cu), bf16 as ViT-H/14's
    # training path launches them
    BWD80: (
        "cuda", CSRC + "masked_attention_bwd_w80.cu",
        "vision_transformer_cam_tpu/kernels/attention.py:803"),
    # the same kernel's width-64 instances at ViT-L/16@512's N = 1025, bf16,
    # as its training path launches them
    BWD1025: (
        "cuda", CSRC + "masked_attention_bwd.cu",
        "vision_transformer_cam_tpu/kernels/attention.py:803"),
    # both kernels' instances at head widths 16, 32 and 40 (each width its
    # own translation unit), bf16 rollout (kernel 1) and bf16 (the backward)
    **{FWD_W[dh]: ("cuda", CSRC + f"masked_attention_w{dh}.cu",
                   "vision_transformer_cam_tpu/kernels/attention.py:133")
       for dh in NEW_WIDTHS},
    **{BWD_W[dh]: ("cuda", CSRC + f"masked_attention_bwd_w{dh}.cu",
                   "vision_transformer_cam_tpu/kernels/attention.py:803")
       for dh in NEW_WIDTHS},
    # the same forward kernel as the bf16 serving path launches it: bf16 qkv,
    # rollout variant, clamp on
    "masked_attention_fused[bf16 rollout, serving]": (
        "cuda", CSRC + "masked_attention.cu",
        "vision_transformer_cam_tpu/kernels/attention.py:133"),
    # the Hopper design (64-row tiles, a TMA ring, wgmma); the earlier design
    # (mlp_fused.cu) takes float32 and the shapes it does not
    "mlp_fused": (
        "cuda", CSRC + "mlp_fused_wgmma.cu",
        "vision_transformer_cam_tpu/kernels/gemm.py:46"),
    "mlp_fused_int8": (
        "cuda", CSRC + "mlp_fused_wgmma.cu",
        "vision_transformer_cam_tpu/kernels/gemm.py:55"),
    # the same design at ViT-L's and ViT-H/14's widths: a block owns one of
    # two column groups (256 or 320 output columns a consumer warpgroup)
    **{MLP_W[c]: ("cuda", CSRC + "mlp_fused_wgmma_wide.cu",
                  "vision_transformer_cam_tpu/kernels/gemm.py:46")
       for c in MLP_W},
    **{MLP8_W[c]: ("cuda", CSRC + "mlp_fused_wgmma_wide.cu",
                   "vision_transformer_cam_tpu/kernels/gemm.py:55")
       for c in MLP8_W},
    "attention_block_fused": (
        "cuda", CSRC + "attention_block.cu",
        "vision_transformer_cam_tpu/kernels/attention.py:663"),
    BLOCK_W[80]: (
        "cuda", CSRC + "attention_block_streamed_w80.cu",
        "vision_transformer_cam_tpu/kernels/attention.py:663"),
    BLOCK_W[64]: (
        "cuda", CSRC + "attention_block_streamed.cu",
        "vision_transformer_cam_tpu/kernels/attention.py:663"),
    # the streamed design's instances at head widths 16, 32 and 40 (each its
    # own translation unit), bf16 rollout, clamp on, as the width models'
    # bf16 serving path launches them under attn_block_fusion
    **{BLOCK_NW[dh]: ("cuda", CSRC + f"attention_block_streamed_w{dh}.cu",
                      "vision_transformer_cam_tpu/kernels/attention.py:663")
       for dh in NEW_WIDTHS},
    "masked_attention_seq_local": (
        "cuda", CSRC + "masked_attention_seq.cu",
        "vision_transformer_cam_tpu/kernels/attention.py:433"),
    # the same kernel's instances at head widths 80, 16, 32 and 40
    # (csrc/masked_attention_seq.cuh, each width its own translation unit),
    # bf16 with the float32 head mean and clamp, as the serving path under
    # sequence parallelism launches them
    **{SEQ_W[dh]: ("cuda", CSRC + f"masked_attention_seq_w{dh}.cu",
                   "vision_transformer_cam_tpu/kernels/attention.py:433")
       for dh in SEQ_WIDTHS},
    # the split-tensor ("v1") kernel, which only scripts.microbench drives
    "masked_attention": (
        "cuda", CSRC + "masked_attention_v1.cu",
        "vision_transformer_cam_tpu/kernels/attention.py:39"),
    # its instances at head widths 16, 32, 40 and 80 (csrc/
    # masked_attention_v1.cuh, each width its own translation unit), which
    # phase 24's v1 path launches
    **{V1_W[dh]: ("cuda", CSRC + f"masked_attention_v1_w{dh}.cu",
                  "vision_transformer_cam_tpu/kernels/attention.py:39")
       for dh in V1_WIDTHS},
    # the ablation kernels, one row each (scripts.attn_variants drives them)
    **{f"attn_variants[{v}]": (
        "cuda", CSRC + "attn_variants.cu",
        "scripts/attn_variants.py:" + ("85" if v == "headbatch" else "32"))
       for v in ("full", "noexp", "matmul-only", "nomask", "int8qk", "int8pv",
                 "int8both", "headbatch")},
}
# the card's published peaks (NVIDIA H100 SXM data sheet, dense): device
# memory bytes/s, and operations/s by type
PEAK = {"bytes": 3.35e12, "int8": 1979e12, "bf16": 989e12, "f32": 67e12}
VARIANTS = ("plain", "headmean", "rollout")
# kernel vs plain version on the same card inputs: |a - b| <= atol + rtol*|b|,
# by output kind.  float32: the two sum in different orders, and the hot query
# rows (logits past the clamp at 80) carry the f32 rounding of logits ~1e2
# into exp, hence the rtol.  bf16: both round P and the outputs to bf16;
# rtol is 2 bf16 ulps (2^-6).  The rollout joint is float32 in both modes.
TOL = {(torch.float32, "out"): (5e-5, 1e-4),
       (torch.float32, "prob"): (1e-6, 1e-4),
       (torch.bfloat16, "out"): (1e-2, 2 ** -6),
       (torch.bfloat16, "prob"): (1e-5, 2 ** -6)}
TOL_JOINT = (1e-6, 1e-4)
# The block kernel forms qkv itself and is held to the tolerances above.  At
# float32 its inputs have two hot heads (logits ~ N(0, 40^2), past the clamp).
# At bf16 the kernel and its plain version sum the qkv GEMM in another order
# before both round qkv to bf16, so some elements land one bf16 ulp apart; a
# hot head (|q| ~ 40) would magnify one such ulp of k into 0.04 of a logit,
# so the bf16 cases use inputs with logits of order 1, where an ulp moves a
# logit by ~1e-3 and P by the same relative amount, within the 2^-6 rtol.
# The fused MLP against its plain version: float32 sums in another order
# (rtol 1e-4 as above); at bf16 both round the hidden tensor and the output
# to bf16, and an ulp of a hidden value moves a sum of 3072 terms by far less
# than the output's own ulp.
TOL_MLP = {torch.float32: (5e-5, 1e-4), torch.bfloat16: (1e-2, 2 ** -6)}
# backward kernel vs its plain version, on d_qkv.  Both form P, dP and dS in
# float32 from the same inputs and sum in another order.  float32: the hot
# query rows make |dK| reach the hundreds, so the float32 rounding of sums of
# that size needs the rtol.  bf16: both round Pb, dSb and d_qkv to bf16; a
# value next to a rounding boundary may land one bf16 ulp (2^-8 relative)
# apart, and an ulp of Pb or dSb moves a sum of up to 197 terms: rtol 2^-6
# (2 ulps of the result) plus an atol for results that cancel to near 0.  On
# an NVIDIA H100 80GB HBM3 the largest error beyond the rtol read 1.0e-3 over
# every bf16 case (B=64 N=197), so the atol is 5e-3.  float32 is held to the
# plain version evaluated in float64 (chip_smoke._bwd_ref_inputs).
TOL_BWD = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (5e-3, 2 ** -6)}
# int8 outputs: the two round the same float value after sums in another
# order, so a value next to a .5 boundary may round the other way: at most
# one step, on at most 0.1 % of the elements
I8_STEP, I8_FRAC = 1, 1e-3
# the five GEMMs of a ViT-B/16 forward, (K, N)
GEMM_SHAPES = {"patch": (768, 768), "qkv": (768, 2304), "proj": (768, 768),
               "fc1": (768, 3072), "fc2": (3072, 768)}
# whole int8 path, card (kernels) vs the same model on the CPU (plain
# versions), B=4.  The kernels agree with their plain versions (above), but
# bf16 rounds at other places in the two devices' own ops (LayerNorm, the
# residual adds, the float heads), and where that moves a value across a .5
# boundary its int8 quantization moves by a whole step.  With random
# weights the cls token is small and the final LayerNorm magnifies such
# steps into the logits: two int8 routes of the same model (ln_quant and
# the fused GEMM on against off) differ by 4.3e-2 on logits of magnitude
# 0.7 (ViT-B/16, seed 0, on the CPU).  On an NVIDIA H100 80GB HBM3 (700 W),
# over WHOLE_CASES and one more batch of 4 images in both int8 modes (12
# cases), card against CPU read 4.0e-2 to 6.0e-2 on the logits and 5.9e-5 to
# 1.2e-4 on the CAM.  So the logits are held to 1e-1, and the CAM, built
# from the attention rows and far less sensitive, to 1e-3: about 8x its
# worst reading, tight enough that a wrongly scaled or rounded int8 route
# fails it.
WHOLE_TOL = {"cam": 1e-3, "logits": 1e-1}
# (batch, numpy seed of the images) of the whole-path check
WHOLE_CASES = ((4, 11), (4, 12), (4, 13), (8, 14), (8, 15))


def say(*a):
    print(*a, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def build_kernels():
    from vision_transformer_cam_tpu_torch.kernels import _build, gemm
    t0 = time.perf_counter()
    _build.load()
    log = (_build.lib_path().parent / "build.log").read_text()
    for part in re.split(r"^== ", log, flags=re.M)[1:]:
        name, _, body = part.partition("\n")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", body)]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", body)]
        wall = re.search(r"nvcc wall ([\d.]+) s", body)
        if regs:
            say(f"build {name}: {len(regs)} entry points, registers max "
                f"{max(regs)}, spill stores max {max(spills, default=0)} "
                f"bytes" + (f", nvcc {wall.group(1)} s" if wall else ""))
    say(f"build: {time.perf_counter() - t0:.1f} s (nvcc, parallel, "
        f"{_build.build_seconds or 0:.1f} s); {_build.lib_path()}")
    t0 = time.perf_counter()
    x = torch.randn((4, 768), device="cuda", dtype=torch.bfloat16)
    w = torch.ones(768, device="cuda")
    gemm.ln_quant(x, w, w, eps=1e-6,
                  inv_a=torch.ones((), device="cuda"))
    torch.cuda.synchronize()
    say(f"build ln_quant (Triton JIT): {time.perf_counter() - t0:.1f} s")


def attention_inputs(b, n, heads, dtype, seed, dh=64):
    """Packed qkv (heads of width ``dh``) with random bg (cls column 0), hot
    query rows 1-3 whose logits pass the clamp at 80, and a row-stochastic
    float32 joint.  For int8 qkv: integers in [-127, 127] and per-head
    scales, head 0's q scale large enough for the clamp."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = heads * dh
    bg = (torch.rand((b, n), generator=g, device="cuda") < 0.3).float()
    bg[:, 0] = 0.0
    joint = torch.softmax(torch.randn((b, n, n), generator=g, device="cuda"),
                          dim=-1)
    if dtype == torch.int8:
        qkv = torch.randint(-127, 128, (b, n, 3 * c), generator=g,
                            device="cuda", dtype=torch.int8)
        sc = 0.01 + 0.02 * torch.rand((3 * heads,), generator=g,
                                      device="cuda")
        sc[0] = 0.3
        return qkv, bg, joint, sc
    qkv = torch.randn((b, n, 3 * c), generator=g, device="cuda")
    qkv[:, 1:4, :c] *= 40.0
    return qkv.to(dtype).contiguous(), bg.to(dtype), joint, None


def _call(fn, variant, qkv, bg, joint, heads, clamp, scales=None,
          float_dtype=torch.bfloat16, **extra):
    """Kernel 1 (or its plain version) at 1 / sqrt(head width) on the
    variant's inputs; ``extra``: q_block."""
    dh = qkv.shape[-1] // (3 * heads)
    kw = dict(num_heads=heads, scale=dh ** -0.5, clamp_softmax=clamp,
              float_dtype=float_dtype, **extra)
    j = joint if variant == "rollout" else None
    return fn(qkv, bg, j, scales, with_headmean=variant == "headmean", **kw)


def int8_excess(got, want):
    """(max step, share of elements that differ) of two int8 tensors, and
    whether they are within one step on at most 0.1 %."""
    d = (got.int() - want.int()).abs()
    step, frac = int(d.max()), float((d > 0).float().mean())
    return step, frac, step <= I8_STEP and frac <= I8_FRAC


def _compare(case, got, want, tols, failures):
    """Compare output tuples; tols: one (atol, rtol) per output or None for
    an int8 output.  Returns the worst absolute error."""
    worst, msg = 0.0, []
    for name, g_, w_, tol in zip(("out", "cls", "third"), got, want, tols):
        if tol is None:
            step, frac, ok = int8_excess(g_, w_)
            worst = max(worst, float(step))
            msg.append(f"{name} {step} step on {frac:.2e}")
            if not ok:
                failures.append(f"{case} {name}: int8 off by {step} on "
                                f"{frac:.2e} of the elements")
            continue
        atol, rtol = tol
        g_, w_ = g_.float(), w_.float()
        err = (g_ - w_).abs()
        worst = max(worst, float(err.max()))
        excess = float((err - atol - rtol * w_.abs()).max())
        msg.append(f"{name} {float(err.max()):.2e}")
        if not torch.isfinite(g_).all() or excess > 0:
            failures.append(f"{case} {name}: max abs err {float(err.max()):.3e}"
                            f" (atol {atol}, rtol {rtol:.3g})")
    say(f"check {case}: max abs err " + ", ".join(msg))
    return worst


# kernel 1's cases (B, N, heads): ViT-B/16's N = 197 and a ragged N = 37 at
# its 12 heads, in every dtype and int8 option; 6 heads, a tensor-parallel
# rank's share at m = 2, in the float dtypes its training and CAMs run
ATTN_CASES = ((8, 197, 12), (3, 37, 12), (16, 197, 6))


def check_attention():
    """Attention kernel vs plain version on the card, in every design that
    takes the dtype (bf16 and int8: the tensor-core design, launched twice
    for identical bits, and the FMA design they ran before; float32: the FMA
    design) at ATTN_CASES; returns {(kind, variant, clamp, n): worst error}
    of the path's design at 12 heads (int8 outputs count in steps)."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    errs, failures = {}, []
    for (b, n, heads) in ATTN_CASES:
        kinds = [(dt, None) for dt in (torch.bfloat16, torch.float32)]
        if heads == 12:
            kinds += [(torch.int8, "per_head"), (torch.int8, "per_tensor"),
                      (torch.bfloat16, "int8_out")]
        for dtype, opt in kinds:
            qkv, bg, joint, sc = attention_inputs(b, n, heads, dtype, seed=n)
            scales = None
            if opt == "per_head":
                scales = torch.cat([sc, torch.tensor([20.0], device="cuda")])
            elif opt == "per_tensor":
                scales = torch.tensor([0.3, 0.02, 0.02, 20.0], device="cuda")
            elif opt == "int8_out":
                scales = torch.tensor([20.0], device="cuda")
            fdt = torch.bfloat16 if dtype == torch.int8 else dtype
            for variant in VARIANTS:
                for clamp in (False, True):
                    want = _call(ka.masked_attention_fused_ref, variant, qkv,
                                 bg, joint, heads, clamp, scales)
                    kind = opt or str(dtype).split(".")[-1]
                    tols = [None if scales is not None else TOL[(fdt, "out")],
                            TOL[(fdt, "prob")],
                            TOL_JOINT if variant == "rollout"
                            else TOL[(fdt, "prob")]]
                    for design in fwd_designs(dtype):
                        got = _fwd_design(design, _call,
                                          ka.masked_attention_fused, variant,
                                          qkv, bg, joint, heads, clamp, scales)
                        torch.cuda.synchronize()
                        case = f"attention {design:11s} {kind:10s} " \
                               f"{variant:8s} clamp={clamp!s:5s} B={b} " \
                               f"N={n} H={heads}"
                        err = _compare(case, got, want, tols, failures)
                        if design == fwd_designs(dtype)[0] and heads == 12:
                            errs[(kind, variant, clamp, n)] = err
                        if design == "tensor-core" and not all(
                                torch.equal(x, y) for x, y in zip(got, _call(
                                    ka.masked_attention_fused, variant, qkv,
                                    bg, joint, heads, clamp, scales))):
                            failures.append(f"{case}: a second launch gave "
                                            "other bits")
    if failures:
        raise AssertionError("attention kernel != plain version:\n"
                             + "\n".join(failures))
    return errs


def fwd_designs(dtype):
    """The designs of kernel 1, the split-tensor kernel and the ablation
    kernels that take ``dtype``, the path's first: bf16 and int8 the
    tensor-core design, then the FMA design they ran before; float32 the FMA
    design."""
    return ("fma",) if dtype == torch.float32 else ("tensor-core", "fma")


def _fwd_design(design, fn, *args, **kw):
    """``fn(*args, **kw)`` with the forward wrapper's bf16 / int8 design set
    to ``design`` ("tensor-core", the path's, or "fma", the design those
    dtypes ran before); float32 runs the FMA design either way."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    saved, ka._fwd_bf16_design = ka._fwd_bf16_design, design
    try:
        return fn(*args, **kw)
    finally:
        ka._fwd_bf16_design = saved


def _gemm_design(design, *args, **kw):
    """``linear_int8`` on ``design`` ("tensor-core", the path's, or "dp4a",
    the design it ran before)."""
    from vision_transformer_cam_tpu_torch.kernels import gemm
    saved, gemm._int8_gemm_design = gemm._int8_gemm_design, design
    try:
        return gemm.linear_int8(*args, **kw)
    finally:
        gemm._int8_gemm_design = saved


def _bwd_call(fn, qkv, bg, d_out, heads, clamp):
    dh = qkv.shape[-1] // (3 * heads)
    return fn(qkv, bg, d_out, num_heads=heads, scale=dh ** -0.5,
              clamp_softmax=clamp)


def _bwd_design(design, qkv, bg, d_out, heads, clamp):
    """The backward wrapper made to take ``design`` ("tensor-core",
    "one-block" or "two-kernel") whatever its rule picks at this dtype and N
    (bf16 through the wrapper's private switch of the bf16 design, float32
    through the one-block limits), so that the designs can be checked and
    timed at one shape."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    saved = ka._bwd_bf16_design, ka.BWD_ONE_BLOCK_MAX_N
    if qkv.dtype == torch.bfloat16:
        ka._bwd_bf16_design = design
    else:
        ka.BWD_ONE_BLOCK_MAX_N = {
            dh: ka.BWD_MAX_N[dh] if design == "one-block" else 0
            for dh in ka.BWD_HEAD_DIMS}
    try:
        return _bwd_call(ka.masked_attention_bwd, qkv, bg, d_out, heads,
                         clamp)
    finally:
        ka._bwd_bf16_design, ka.BWD_ONE_BLOCK_MAX_N = saved


def bwd_designs(dtype, n, dh=64):
    """The backward designs that take (dtype, N, head width), the path's
    first: bf16 the tensor-core design, then the FMA designs it ran before
    (one block per head where its tiles fit, two kernels)."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    fma = (("one-block",) if n <= ka.BWD_ONE_BLOCK_MAX_N[dh] else ()) + \
        ("two-kernel",)
    return (("tensor-core",) if dtype == torch.bfloat16 else ()) + fma


# The width-64 backward's cases whose bits must not move when its source
# changes (B, N, heads): the shapes of check_attention_bwd that every
# version of the kernel takes (N <= 760)
BITS_CASES = ((8, 197, 12), (3, 37, 12), (2, 577, 12), (1, 760, 12))


def bwd_bits(root, out):
    """SHA-256 of the backward's d_qkv bytes, at head width 64 for every
    design, dtype, clamp and background at BITS_CASES and at head width 80
    at W80_SHAPES (16 heads), from the port of the
    checkout at ``root`` (imported from there, so that its kernels are
    built and run; call this in a process that has imported no module of
    the port), written to ``out`` as JSON:

        python3 -c "import chip_smoke as c; c.bwd_bits('build/parent', 'a.json')"
        python3 -c "import chip_smoke as c; c.bwd_bits('.', 'b.json')"
        python3 -c "import chip_smoke as c; c.compare_bits('a.json', 'b.json')"
    """
    import hashlib
    sys.path.insert(0, os.path.abspath(root))
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    designs = {torch.bfloat16: ("tensor-core", "one-block", "two-kernel"),
               torch.float32: ("one-block", "two-kernel")}
    got = {}
    cases = [(b, n, heads, 64) for b, n, heads in BITS_CASES] + \
        [(b, n, 16, 80) for b, n in W80_SHAPES]
    for b, n, heads, dh in cases:
        for dtype, names in designs.items():
            g = torch.Generator(device="cuda").manual_seed(n)
            qkv = torch.randn((b, n, 3 * heads * dh), generator=g,
                              device="cuda")
            qkv[:, 1:4, :heads * dh] *= 40.0
            qkv = qkv.to(dtype).contiguous()
            d_out = torch.randn((b, n, heads * dh), generator=g,
                                device="cuda").to(dtype)
            bg = (torch.rand((b, n), generator=g, device="cuda") < 0.3).float()
            bg[:, 0] = 0.0
            for design in names:
                if design == "one-block" and n > (256 if dh == 64 else 208):
                    continue
                # the design forced as _bwd_design does; the one-block
                # limit is a number in versions before head width 80
                saved = ka._bwd_bf16_design, ka.BWD_ONE_BLOCK_MAX_N
                big = 10 ** 6 if design == "one-block" else 0
                if dtype == torch.bfloat16:
                    ka._bwd_bf16_design = design
                else:
                    ka.BWD_ONE_BLOCK_MAX_N = (
                        {dh: big for dh in saved[1]}
                        if isinstance(saved[1], dict) else big)
                try:
                    for bg_kind, bg_ in (("30%", bg),
                                         ("none", torch.zeros_like(bg))):
                        for clamp in (False, True):
                            res = ka.masked_attention_bwd(
                                qkv, bg_, d_out, num_heads=heads,
                                scale=dh ** -0.5, clamp_softmax=clamp)
                            raw = res.view(torch.int16 if dtype ==
                                           torch.bfloat16 else torch.int32)
                            width = "" if dh == 64 else f" dh={dh}"
                            got[f"{design} {dtype} B={b} N={n} bg={bg_kind} "
                                f"clamp={clamp}{width}"] = hashlib.sha256(
                                raw.cpu().numpy().tobytes()).hexdigest()
                finally:
                    ka._bwd_bf16_design, ka.BWD_ONE_BLOCK_MAX_N = saved
    with open(out, "w") as f:
        json.dump(got, f, indent=1, sort_keys=True)
    say(f"bwd_bits: {len(got)} cases from {ka.__file__} -> {out}")
    return got


def fwd_bits(root, out):
    """SHA-256 of kernel 1's output bytes (out, cls row, head mean or J') at
    head widths 64 (ATTN_CASES' first two) and 80 (W80_SHAPES' first two),
    every dtype and int8 option, variant, clamp and design, from the port of
    the checkout at ``root``, as ``bwd_bits`` does (and compared by
    ``compare_bits``)."""
    import hashlib
    sys.path.insert(0, os.path.abspath(root))
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    got = {}
    cases = [(b, n, h, 64) for b, n, h in ATTN_CASES[:2]] + \
        [(b, n, 16, 80) for b, n in W80_SHAPES[:2]]
    for b, n, h, dh in cases:
        for dtype, opt in KERNEL1_KINDS:
            qkv, bg, joint, sc = attention_inputs(b, n, h, dtype, seed=n,
                                                  dh=dh)
            scales = _w80_scales(opt, sc)
            kind = opt or str(dtype).split(".")[-1]
            for variant in VARIANTS:
                for clamp in (False, True):
                    for design in fwd_designs(dtype):
                        res = _fwd_design(design, _call,
                                          ka.masked_attention_fused, variant,
                                          qkv, bg, joint, h, clamp, scales)
                        digest = hashlib.sha256()
                        for t in res:
                            digest.update(t.contiguous().view(torch.uint8)
                                          .cpu().numpy().tobytes())
                        got[f"{design} {kind} {variant} clamp={clamp} B={b} "
                            f"N={n} H={h} dh={dh}"] = digest.hexdigest()
    with open(out, "w") as f:
        json.dump(got, f, indent=1, sort_keys=True)
    say(f"fwd_bits: {len(got)} cases from {ka.__file__} -> {out}")
    return got


def mlp_bits(root, out):
    """SHA-256 of both fused MLP kernels' output bytes at the MLP_SHAPES of
    C <= 768 (one column group), in every design that takes the shape
    (bf16: wgmma and mma; float32: fma; int8: wgmma and mma with bf16 x and
    float32 and bf16 out, float32 x and out), both GELUs, from the port of
    the checkout at ``root``, as ``bwd_bits`` does (and compared by
    ``compare_bits``)."""
    import hashlib
    sys.path.insert(0, os.path.abspath(root))
    from vision_transformer_cam_tpu_torch.kernels import gemm
    got = {}

    def digest(t):
        return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                              .tobytes()).hexdigest()
    for si, (m, c, hid) in enumerate(MLP_SHAPES):
        if c > 768:
            continue
        for dtype in (torch.bfloat16, torch.float32):
            ops = mlp_operands(m, c, hid, dtype, seed=20 + si)
            for approx in (True, False):
                for design in mlp_designs(c, hid, dtype):
                    res = _mlp_design(design, gemm.mlp_fused, *ops,
                                      gelu_approx=approx)
                    got[f"mlp_fused {design} {dtype} approx={approx} M={m} "
                        f"C={c} HID={hid}"] = digest(res)
        for x_dtype, out_dtype in ((torch.bfloat16, torch.float32),
                                   (torch.bfloat16, torch.bfloat16),
                                   (torch.float32, torch.float32)):
            ops = mlp_int8_operands(m, c, hid, x_dtype, seed=30 + si)
            for approx in (True, False):
                for design in mlp_designs(c, hid, torch.int8):
                    res = _mlp_design(design, gemm.mlp_fused_int8, *ops,
                                      gelu_approx=approx,
                                      out_dtype=out_dtype)
                    got[f"mlp_fused_int8 {design} {x_dtype}->{out_dtype} "
                        f"approx={approx} M={m} C={c} HID={hid}"] = \
                        digest(res)
    with open(out, "w") as f:
        json.dump(got, f, indent=1, sort_keys=True)
    say(f"mlp_bits: {len(got)} cases from {gemm.__file__} -> {out}")
    return got


def compare_bits(a, b):
    """Two files of ``bwd_bits``, ``fwd_bits``, ``mlp_bits``, ``block_bits``
    or ``seq_bits``: raises where a case differs or is missing."""
    fa, fb = (json.load(open(f)) for f in (a, b))
    diff = sorted(k for k in set(fa) | set(fb) if fa.get(k) != fb.get(k))
    say(f"compare_bits {a} {b}: {len(fa)} and {len(fb)} cases, {len(diff)} "
        "differ" + "".join(f"\n  {k}" for k in diff))
    if diff or not fa:
        raise AssertionError(f"the bits moved in {len(diff)} cases")


def round_robin(fns, iters=20, timer=None):
    """{name: mean ms} of two runs of each function by ``timer`` (default
    ``time_ms``), in turns (the order, then the order reversed)."""
    timer = timer or time_ms
    names = list(fns)
    got = {name: [] for name in names}
    for order in (names, names[::-1]):
        for name in order:
            got[name].append(timer(fns[name], iters))
    return {name: sum(v) / len(v) for name, v in got.items()}


def graph_ms(fn, iters=20, warmup=3):
    """Mean device ms of ``fn()``: ``iters`` calls captured in one CUDA graph
    and replayed between two CUDA events, so the wrapper's host work (checks,
    allocation, the ctypes call), which for a call shorter than it would be
    timed in place of the kernel, stays out of the reading."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # relaxed: the wrappers set a kernel attribute (not a stream operation)
    # while the graph is captured
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


def bwd_inputs(b, n, heads, dtype, seed, dh=64):
    qkv, bg, _, _ = attention_inputs(b, n, heads, dtype, seed=100 + seed,
                                     dh=dh)
    g = torch.Generator(device="cuda").manual_seed(seed)
    d_out = torch.randn((b, n, heads * dh), generator=g,
                        device="cuda").to(dtype)
    return qkv, bg, d_out


def _bwd_ref_inputs(qkv, bg, d_out):
    """The inputs the backward's plain version is held at: bf16 as they are
    (it rounds Pb, dSb and d_qkv to bf16 as the kernel does); float32 widened
    to float64, the same values, so that the plain version's own float32
    products, which on this card's cuBLAS round further from the exact
    result than the kernel's FMA sums do at head width 80 (8.3e-4 against
    2.9e-4 at B=8 N=257), are not what the kernel is held to."""
    if qkv.dtype != torch.float32:
        return qkv, bg, d_out
    return qkv.double(), bg.double(), d_out.double()


# The backward's cases (B, N, heads, head width): ViT-B/16's N = 197, a
# ragged N = 37, ViT/16 at 384 pixels (N = 577) and N = 760 (the earlier limit)
# at width 64; at width 80 (ViT-H/14: 16 heads) its N = 257, 37 and 577;
# ViT-L/16@512's N = 1025 at both widths, and each width's limit; a
# tensor-parallel rank's share at m = 2: ViT-B/16's 6 heads of 64 and
# ViT-H/14's 8 of 80
BWD_CASES = ((8, 197, 12, 64), (3, 37, 12, 64), (2, 577, 12, 64),
             (1, 760, 12, 64), (8, 257, 16, 80), (3, 37, 16, 80),
             (2, 577, 16, 80), (1, 1025, 16, 64), (1, 1025, 16, 80),
             (16, 197, 6, 64), (8, 257, 8, 80))


def bwd_case(b, n, heads, dh, failures):
    """The backward at [B, N, H x dh] against its plain version in every
    design that takes the shape, bf16 and float32, 30 % background and none,
    clamp off and on (float32 without the clamp also against torch.autograd
    through the plain forward), at TOL_BWD; the tensor-core design launched
    twice for identical bits.  Returns {(dtype name, clamp, n, heads, bg
    kind, design, head width): worst error}."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        qkv, bg, d_out = bwd_inputs(b, n, heads, dtype, seed=n, dh=dh)
        name = str(dtype).split(".")[-1]
        for bg_kind, bg_ in (("30% bg", bg), ("no bg", torch.zeros_like(bg))):
            for clamp in (False, True):
                want = _bwd_call(ka.masked_attention_bwd_ref,
                                 *_bwd_ref_inputs(qkv, bg_, d_out), heads,
                                 clamp)
                auto = None
                if dtype == torch.float32 and not clamp:
                    q64, bg64, do64 = _bwd_ref_inputs(qkv, bg_, d_out)
                    leaf = q64.clone().requires_grad_(True)
                    out, _ = ka.masked_attention_fused_ref(
                        leaf, bg64, num_heads=heads, scale=dh ** -0.5)
                    auto, = torch.autograd.grad(out, leaf, do64)
                    del leaf, out, q64, bg64, do64
                for design in bwd_designs(dtype, n, dh):
                    got = _bwd_design(design, qkv, bg_, d_out, heads, clamp)
                    torch.cuda.synchronize()
                    case = f"attention bwd {design:11s} {name:8s} " \
                           f"clamp={clamp!s:5s} {bg_kind:6s} B={b} N={n} " \
                           f"H={heads} dh={dh}"
                    errs[(name, clamp, n, heads, bg_kind, design, dh)] = \
                        _compare(case, (got,), (want,), (TOL_BWD[dtype],),
                                 failures)
                    if auto is not None:
                        _compare(case + " vs autograd", (got,), (auto,),
                                 (TOL_BWD[dtype],), failures)
                    if design == "tensor-core" and not torch.equal(
                            got, _bwd_design(design, qkv, bg_, d_out, heads,
                                             clamp)):
                        failures.append(f"{case}: a second launch gave "
                                        "other bits")
                del want, auto
        del qkv, bg, d_out
    return errs


def check_attention_bwd():
    """Backward kernel vs its plain version on the card, in every design that
    takes the shape: bf16 the tensor-core design (the training path's) and
    the FMA designs it ran before, float32 the one-block design (where its
    tiles fit: N <= 256 at head width 64, 208 at 80) and the two-kernel
    design (its dQ tile of 32 query rows, or 16 past N = 760 / 732); at
    BWD_CASES and at each width's limit, BWD_MAX_N, with one past it
    refused; 30 % background and none, clamp off and on.  At float32 without
    the clamp also vs torch.autograd through the plain forward (an
    independent check of the formula).  float32 is held to the plain version
    evaluated in float64 on the same values (``_bwd_ref_inputs``).  The
    tensor-core design runs twice on the same inputs and must give identical
    bits.  Returns {(dtype name, clamp, n, heads, bg kind, design, head
    width): worst error}."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    errs, failures = {}, []
    cases = BWD_CASES + tuple((1, ka.BWD_MAX_N[dh], 16, dh)
                              for dh in ka.BWD_HEAD_DIMS)
    for case in cases:
        errs.update(bwd_case(*case, failures))
    # one past each width's limit: refused by both wrappers, in both dtypes
    for dh in ka.BWD_HEAD_DIMS:
        n = ka.BWD_MAX_N[dh] + 1
        for dtype in (torch.bfloat16, torch.float32):
            qkv, bg, d_out = bwd_inputs(1, n, 2, dtype, seed=1, dh=dh)
            for label, call in (
                    ("masked_attention_bwd", lambda: _bwd_call(
                        ka.masked_attention_bwd, qkv, bg, d_out, 2, False)),
                    ("fused_attention_diff", lambda: ka.fused_attention_diff(
                        qkv.requires_grad_(True), bg, num_heads=2,
                        scale=dh ** -0.5))):
                try:
                    call()
                    failures.append(f"{label} at N={n} dh={dh} {dtype}: not "
                                    "refused")
                except ValueError as e:
                    say(f"check {label} N={n} dh={dh} "
                        f"{str(dtype).split('.')[-1]} is refused: {e}")
                    if "N <=" not in str(e) or (
                            label == "fused_attention_diff"
                            and "attn_impl='eager'" not in str(e)):
                        failures.append(f"{label} N={n}: message {e}")
    # a width the backward is not compiled for
    qkv, bg, d_out = bwd_inputs(1, 37, 4, torch.bfloat16, seed=2, dh=48)
    try:
        _bwd_call(ka.masked_attention_bwd, qkv, bg, d_out, 4, False)
        failures.append("backward at head width 48: not refused")
    except ValueError as e:
        say(f"check backward at head width 48 is refused: {e}")
        if "64, 80" not in str(e):
            failures.append(f"head width 48: the message names no widths: {e}")
    if failures:
        raise AssertionError("attention backward kernel != plain version:\n"
                             + "\n".join(failures))
    return errs


def bwd_occupancy(cases=((197, 64), (1025, 64), (257, 80), (1025, 80))):
    """The backward's occupancy on this card for each kernel of every design
    that takes (N, head width) (blocks an SM at once, registers and local
    memory per thread, shared memory per block; the training path's instance,
    no clamp), with the ptxas spill stores of both translation units from
    build.log.  Returns {(design, dtype name, part, n, dh): info tuple}."""
    import ctypes

    from vision_transformer_cam_tpu_torch.kernels import _build
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    lib, got = _build.load(), {}
    log = (_build.lib_path().parent / "build.log").read_text()
    for part in re.split(r"^== ", log, flags=re.M)[1:]:
        name, _, body = part.partition("\n")
        if name.startswith("masked_attention_bwd"):
            spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                                 body)]
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", body)]
            say(f"occupancy {name}: {len(regs)} entries, registers "
                f"{min(regs)}-{max(regs)}, {sum(1 for x in spills if x)} "
                f"entries spill (max {max(spills, default=0)} bytes)")
    for n, dh in cases:
        for dtype in (torch.bfloat16, torch.float32):
            for design in bwd_designs(dtype, n, dh):
                for part in ((0,) if design == "one-block" else (0, 1)):
                    info = (ctypes.c_int * 4)()
                    err = lib.vitcam_masked_attention_bwd_occupancy(
                        n, ka._DTYPE_CODES[dtype], ka.BWD_DESIGNS[design],
                        dh, part, info)
                    if err:
                        raise RuntimeError(
                            f"backward occupancy ({design}, {dtype}, N={n}, "
                            f"dh={dh}, part {part}): cudaError {err} "
                            f"({lib.vitcam_cuda_error_string(err).decode()})")
                    name = str(dtype).split(".")[-1]
                    got[(design, name, part, n, dh)] = tuple(info)
                    kernel = ("one block" if design == "one-block" else
                              ("dQ", "dK/dV")[part])
                    say(f"occupancy attention bwd {design:11s} {name:8s} "
                        f"{kernel:9s} N={n} dh={dh}: {info[0]} blocks an SM, "
                        f"{info[1]} registers, {info[2]} bytes of local "
                        f"memory per thread, {info[3]} bytes of shared "
                        f"memory per block")
    return got


def sdpa_backward(qkv, bg, heads):
    """(leaf, out) of F.scaled_dot_product_attention on the packed qkv with
    the kernel's additive rank-1 mask, for timing its backward (the library
    call beside the backward kernel: timed only, never on a path)."""
    import torch.nn.functional as F
    b, n, c3 = qkv.shape
    dh = c3 // 3 // heads
    leaf = qkv.clone().requires_grad_(True)
    q, k, v = leaf.reshape(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
    bgf = bg.float()
    mask = ((1.0 - bgf)[:, :, None] * (bgf * -100.0)[:, None, :]
            )[:, None].to(qkv.dtype)
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                         scale=dh ** -0.5)
    return leaf, out.transpose(1, 2).reshape(b, n, heads * dh)


# the backward's timed shapes (B, N, heads, head width): the training path's
# (ViT-B/16), ViT/16 at 384 pixels, ViT-H/14's and ViT-L/16@512's
BWD_TIMED = ((64, 197, 12, 64), (16, 577, 12, 64), (64, 257, 16, 80),
             (16, 1025, 16, 64))


def time_attention_bwd(shapes=BWD_TIMED):
    """bf16, no clamp (the training path's call), at each of ``shapes``:
    the tensor-core design (the path's) and the FMA designs bf16 ran before
    held against the plain version, then the tensor-core design, the plain
    version and the backward of F.scaled_dot_product_attention with the same
    additive mask (the library call, timed only) in turns; the FMA designs
    no longer change and are not timed.  Returns {(B, N, heads, dh):
    (kernel, plain, library, worst error) ms}."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    res = {}
    for shape in shapes:
        bb, nn, heads, dh = shape
        qkv, bg, d_out = bwd_inputs(bb, nn, heads, torch.bfloat16,
                                    seed=3 if nn == 197 else 4, dh=dh)
        leaf, out = sdpa_backward(qkv, bg, heads)
        designs = bwd_designs(torch.bfloat16, nn, dh)
        fns = {d: (lambda d=d: _bwd_design(d, qkv, bg, d_out, heads, False))
               for d in designs}
        fns["plain"] = lambda: _bwd_call(ka.masked_attention_bwd_ref, qkv,
                                         bg, d_out, heads, False)
        fns["SDPA backward"] = lambda: torch.autograd.grad(
            out, leaf, d_out, retain_graph=True)[0]
        want, failures = fns["plain"](), []
        errs = {d: _compare(f"attention bwd {d} bfloat16 B={bb} N={nn} "
                            f"H={heads} dh={dh}", (fns[d](),), (want,),
                            (TOL_BWD[torch.bfloat16],), failures)
                for d in designs}
        if failures:
            raise AssertionError("attention backward kernel != plain "
                                 "version:\n" + "\n".join(failures))
        say(f"attention bwd kernel vs SDPA backward B={bb} N={nn} dh={dh} "
            f"(recorded, not gated): max abs dev "
            f"{float((fns['tensor-core']().float() - fns['SDPA backward']().float()).abs().max()):.3e}")
        del want
        ms = round_robin({k: f for k, f in fns.items() if k in (
            "tensor-core", "plain", "SDPA backward")},
            iters=20 if nn < 500 else 5)
        t_bound, by = bwd_bound(bb, nn, heads, dh)
        say(f"time attention bwd bf16 B={bb} N={nn} H={heads} dh={dh}: "
            + ", ".join(f"{name} {t:.4f} ms" for name, t in ms.items())
            + f"; bound {t_bound:.4f} ms ({by})")
        res[shape] = (ms["tensor-core"], ms["plain"], ms["SDPA backward"],
                      errs["tensor-core"])
        del leaf, out, fns, qkv, d_out
        gc_cuda()
    return res


def bwd_bound(b, n, heads, dh):
    """The bf16 backward's bound at [B, N, H x dh]: qkv, dO and the f32 bg
    in, d_qkv out (each once); five products at the bf16 rate."""
    m, c = b * n, heads * dh
    return bound(f"masked_attention_bwd bf16 B={b} N={n} H={heads} dh={dh}",
                 7 * m * c * 2 + m * 4,
                 {"bf16": 5 * 2 * b * heads * n * n * dh})


# kernel 1's training variant (bf16, plain, no clamp: the forward of
# fused_attention_diff) at the zoo's training shapes
TRAIN_FWD_SHAPES = ((64, 257, 16, 80), (16, 1025, 16, 64))


def time_training_forward():
    """Kernel 1's training variant at TRAIN_FWD_SHAPES, held against its
    plain version and timed in turns with it beside its bound.  Returns
    {shape: (kernel ms, plain ms, bound ms, bound by, worst error)}."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    res, failures = {}, []
    for shape in TRAIN_FWD_SHAPES:
        b, n, heads, dh = shape
        qkv, bg, _, _ = attention_inputs(b, n, heads, torch.bfloat16, seed=8,
                                         dh=dh)
        fns = {"kernel": lambda: _call(ka.masked_attention_fused, "plain",
                                       qkv, bg, None, heads, False),
               "plain": lambda: _call(ka.masked_attention_fused_ref, "plain",
                                      qkv, bg, None, heads, False)}
        err = _compare(f"attention training variant bf16 plain clamp=False "
                       f"B={b} N={n} H={heads} dh={dh}", fns["kernel"](),
                       fns["plain"](), [TOL[(torch.bfloat16, "out")],
                                        TOL[(torch.bfloat16, "prob")]],
                       failures)
        ms = round_robin(fns, iters=10)
        t_bound, by = attention_bound(b, n, heads, dh, "bf16", "plain")
        say(f"time attention training variant B={b} N={n} H={heads} dh={dh}"
            f": kernel {ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms; "
            f"bound {t_bound:.4f} ms ({by})")
        res[shape] = (ms["kernel"], ms["plain"], t_bound, by, err)
        del qkv, fns
    if failures:
        raise AssertionError("kernel 1's training variant != plain "
                             "version:\n" + "\n".join(failures))
    return res


def gemm_operands(m, k, n, seed, bias=True):
    """Activations ~N(0, 1) in bf16, int8 weights with per-channel scales,
    a static act scale (absmax / 127) and its inverse, a bias."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
    wq = torch.randint(-127, 128, (n, k), generator=g, device="cuda",
                       dtype=torch.int8)
    ws = 1e-3 * (1 + torch.rand((n,), generator=g, device="cuda"))
    act = x.float().abs().amax() / 127.0
    b = torch.randn((n,), generator=g, device="cuda") if bias else None
    return dict(x=x, wq=wq, ws=ws, act=act, inv=1.0 / act, cs=ws * act, b=b)


def gemm_cases(shape, n):
    """(label, route, x kind, epilogue, extra) for every prologue and
    epilogue at this GEMM shape (requant with 3 and 36 column groups where
    they divide N; the int8 epilogues on the fused route too), plus the
    float32 and bias-free forms on the ragged shape."""
    cases = [("fused bf16->bf16", "fused", "x", "float", {}),
             ("qlinear bf16->bf16", "qlinear", "x", "float", {}),
             ("qlinear int8->bf16", "qlinear", "xq", "float", {}),
             # the fused route's int8 epilogues (inverse scales multiply):
             # the first launch of the unfused int8 MLP chain
             ("fused gelu tanh x", "fused", "x", "gelu",
              {"gelu_approx": True}),
             ("fused requant/3 x", "fused", "x", "requant", {"groups": 3})]
    for x_kind in ("x", "xq"):
        for groups in (3, 36):
            if n % groups == 0:
                cases.append((f"requant/{groups} {x_kind}", "qlinear", x_kind,
                              "requant", {"groups": groups}))
        for approx in (True, False):
            cases.append((f"gelu {'tanh' if approx else 'erf'} {x_kind}",
                          "qlinear", x_kind, "gelu", {"gelu_approx": approx}))
    if shape == "ragged":
        cases += [("fused f32->f32", "fused", "x32", "float", {}),
                  ("qlinear f32->f32 nobias", "qlinear", "x32", "float",
                   {"nobias": True})]
    return cases


def _gemm_args(ops, route, x_kind, epilogue, extra, seed):
    x = {"x": ops["x"], "x32": ops["x"].float(),
         "xq": torch.clamp(torch.round(ops["x"].float() / ops["act"]),
                           -127, 127).to(torch.int8)}[x_kind]
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    kw = dict(route=route, epilogue=epilogue)
    if epilogue == "float":
        kw["out_dtype"] = torch.float32 if x_kind == "x32" else torch.bfloat16
    elif epilogue == "requant":
        kw["groups"] = extra["groups"]
        kw["out_scales"] = 0.1 + 0.1 * torch.rand(
            (extra["groups"],), generator=g, device="cuda")
    else:
        kw["gelu_approx"] = extra["gelu_approx"]
        kw["out_scales"] = torch.full((1,), 0.1, device="cuda")
    if epilogue != "float" and route == "fused":
        kw["out_scales"] = 1.0 / kw["out_scales"]
    cs = ops["cs"] if route == "fused" else ops["ws"]
    a = ops["inv"] if route == "fused" else ops["act"]
    b = None if extra.get("nobias") else ops["b"]
    return (x, ops["wq"], cs, b, a), kw


def check_gemm(m=8 * 197):
    """int8 GEMM vs its plain version on the card.  Float outputs: the two
    run the same rounded operations on the exact integer dot, so they are
    held to 1e-6 relative (float32) or one bf16 ulp (2^-8 relative); int8
    outputs to one step on at most 0.1 %.  The tensor-core design (the
    path's) and the dp4a design it replaced run one epilogue on the same
    exact dot: they must give the same bits.  Returns the worst float
    error."""
    from vision_transformer_cam_tpu_torch.kernels import gemm
    shapes = dict(GEMM_SHAPES, ragged=(200, 72))
    worst, failures = 0.0, []
    for si, (shape, (k, n)) in enumerate(shapes.items()):
        mm = 111 if shape == "ragged" else m
        ops = gemm_operands(mm, k, n, seed=si)
        for label, route, x_kind, epi, extra in gemm_cases(shape, n):
            args, kw = _gemm_args(ops, route, x_kind, epi, extra, si)
            got = gemm.linear_int8(*args, **kw)
            want = gemm.linear_int8_ref(*args, **kw)
            same = torch.equal(got, _gemm_design("dp4a", *args, **kw))
            torch.cuda.synchronize()
            case = f"gemm {shape:6s} M={mm} K={k} N={n} {label} (bits of " \
                   f"the dp4a design: {same})"
            if not same:
                failures.append(f"{case}: the tensor-core and the dp4a "
                                "designs differ")
            if epi == "float":
                rtol = 1e-6 if kw["out_dtype"] == torch.float32 else 2 ** -8
                tol = (0.0, rtol)
            else:
                tol = None
            w = _compare(case, (got,), (want,), (tol,), failures)
            if tol is not None:
                worst = max(worst, w)
    if failures:
        raise AssertionError("int8 GEMM != plain version:\n"
                             + "\n".join(failures))
    return worst


def check_ln_quant():
    """ln_quant vs its plain version: int8 within one step on <= 0.1 %
    (the two sum the row statistics in another order).  Returns the worst
    step."""
    from vision_transformer_cam_tpu_torch.kernels import gemm
    g = torch.Generator(device="cuda").manual_seed(7)
    worst, failures = 0, []
    for (m, c) in ((8 * 197, 768), (111, 72)):
        for dtype in (torch.bfloat16, torch.float32):
            x = (3.0 * torch.randn((m, c), generator=g, device="cuda")
                 + 0.5).to(dtype)
            w = 1 + 0.1 * torch.randn((c,), generator=g, device="cuda")
            b = 0.1 * torch.randn((c,), generator=g, device="cuda")
            inv = torch.tensor(127.0 / 4.0, device="cuda")
            args = (x, w.to(dtype), b.to(dtype))
            got = gemm.ln_quant(*args, eps=1e-6, inv_a=inv)
            want = gemm.ln_quant_ref(*args, eps=1e-6, inv_a=inv)
            torch.cuda.synchronize()
            worst = max(worst, _compare(
                f"ln_quant [{m}, {c}] {str(dtype).split('.')[-1]}",
                (got,), (want,), (None,), failures))
    if failures:
        raise AssertionError("ln_quant != plain version:\n"
                             + "\n".join(failures))
    return worst


def mlp_operands(m, c, hid, dtype, seed):
    """x ~ N(0, 1), weights ~ N(0, 1 / fan_in) in the torch layout, biases
    ~ 0.1 N(0, 1), all of ``dtype``."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, gain=1.0):
        return (gain * torch.randn(shape, generator=g, device="cuda")).to(dtype)
    return (rnd(m, c), rnd(hid, c, gain=c ** -0.5), rnd(hid, gain=0.1),
            rnd(c, hid, gain=hid ** -0.5), rnd(c, gain=0.1))


# (M, C, HID) of the fused MLP checks: the ViT-B widths at M = 8 * 197, two
# ragged shapes only the earlier design takes (72, 200; 66, 150: off every
# vector width), the ViT-B widths with a tail of 37 rows past a multiple of
# 64, the narrowest width the wgmma design takes (C = 64: most of its W2
# tiles out of bounds), and ViT-H/14's and ViT-L's widths (two column groups)
# at ragged rows past 8 of its images (N = 257) and 2 of ViT-L/16@512's (N =
# 1025).  Shape i's operands come from seed 20 + i (bf16, float32) or 30 + i
# (int8).
MLP_SHAPES = ((8 * 197, 768, 3072), (111, 72, 200), (111, 66, 150),
              (8 * 197 + 37, 768, 3072), (111, 64, 256),
              (8 * 257 + 37, 1280, 5120), (2 * 1025 + 37, 1024, 4096))


def mlp_designs(c, hid, dtype):
    """The fused MLP designs that take the shape, the path's first (dtype
    torch.int8 for mlp_fused_int8): where that is the wgmma design, then the
    earlier mma design it replaced."""
    from vision_transformer_cam_tpu_torch.kernels import gemm
    first = gemm.mlp_design(c, hid, dtype)
    return (first, "mma") if first == "wgmma" else (first,)


def _mlp_design(design, fn, *args, **kw):
    """``fn(*args, **kw)`` with both fused MLP wrappers' bf16 / int8 design
    set to ``design`` ("wgmma", the path's, or "mma", the design they ran
    before); shapes the wgmma design does not take run "mma" either way."""
    from vision_transformer_cam_tpu_torch.kernels import gemm
    saved = gemm._mlp_bf16_design, gemm._mlp_int8_design
    gemm._mlp_bf16_design = gemm._mlp_int8_design = design
    try:
        return fn(*args, **kw)
    finally:
        gemm._mlp_bf16_design, gemm._mlp_int8_design = saved


def check_mlp():
    """mlp_fused vs its plain version on the card at MLP_SHAPES, bf16 and
    float32, both GELUs, in every design that takes the shape: bf16 the
    wgmma design (launched twice for identical bits, and held to the mma
    design at the same tolerance) and the mma design it replaced; float32
    the FMA design.  Returns {C: the worst error of the path's design in
    bf16} at MLP_WIDTHS."""
    from vision_transformer_cam_tpu_torch.kernels import gemm
    worst, failures = dict.fromkeys(MLP_WIDTHS, 0.0), []
    for si, (m, c, hid) in enumerate(MLP_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            ops = mlp_operands(m, c, hid, dtype, seed=20 + si)
            for approx in (True, False):
                want = gemm.mlp_fused_plain(*ops, gelu_approx=approx)
                name = str(dtype).split(".")[-1]
                got = {}
                for design in mlp_designs(c, hid, dtype):
                    got[design] = _mlp_design(design, gemm.mlp_fused, *ops,
                                              gelu_approx=approx)
                    torch.cuda.synchronize()
                    case = f"mlp_fused {design:5s} {name:8s} " \
                           f"{'tanh' if approx else 'erf':4s} M={m} C={c} " \
                           f"HID={hid}"
                    err = _compare(case, (got[design],), (want,),
                                   (TOL_MLP[dtype],), failures)
                    if c in worst and dtype == torch.bfloat16 and \
                            design == mlp_designs(c, hid, dtype)[0]:
                        worst[c] = max(worst[c], err)
                if "wgmma" in got:
                    _compare(f"mlp_fused wgmma against mma {name} M={m} "
                             f"C={c} HID={hid}", (got["wgmma"],),
                             (got["mma"],), (TOL_MLP[dtype],), failures)
                    if not torch.equal(got["wgmma"], gemm.mlp_fused(
                            *ops, gelu_approx=approx)):
                        failures.append(f"mlp_fused wgmma M={m} C={c}: a "
                                        "second launch gave other bits")
    if failures:
        raise AssertionError("mlp_fused != plain version:\n"
                             + "\n".join(failures))
    return worst


def mlp_int8_operands(m, c, hid, x_dtype, seed):
    """The operands of mlp_fused_int8: activations ~N(0, 1), int8 weights
    with per-channel scales, static act scales (fc1: absmax / 127; fc2: 6 /
    127, so the hidden tensor clips a little), combined scales, biases."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, c), generator=g, device="cuda").to(x_dtype)

    def layer(n, k, act):
        wq = torch.randint(-127, 128, (n, k), generator=g, device="cuda",
                           dtype=torch.int8)
        ws = 1e-3 * (1 + torch.rand((n,), generator=g, device="cuda"))
        return wq, ws * act, torch.randn((n,), generator=g, device="cuda")
    act1 = x.float().abs().amax() / 127.0
    act2 = torch.tensor(6.0 / 127.0, device="cuda")
    w1q, cs1, b1 = layer(hid, c, act1)
    w2q, cs2, b2 = layer(c, hid, act2)
    return x, w1q, cs1, b1, w2q, cs2, b2, 1.0 / act1, 1.0 / act2


def mlp_int8_chain(x, w1q, cs1, b1, w2q, cs2, b2, inv_a1, inv_a2, *,
                   gelu_approx=True, out_dtype=torch.bfloat16):
    """The fused int8 MLP as two fused-route linear_int8 launches (the
    tensor-core GEMM): GELU-requant, then the float epilogue."""
    from vision_transformer_cam_tpu_torch.kernels import gemm
    hq = gemm.linear_int8(x, w1q, cs1, b1, inv_a1, route="fused",
                          epilogue="gelu", out_scales=inv_a2.reshape(1),
                          gelu_approx=gelu_approx)
    one = torch.ones((), device=x.device)
    return gemm.linear_int8(hq.float(), w2q, cs2, b2, one, route="fused",
                            out_dtype=out_dtype)


def check_mlp_int8():
    """mlp_fused_int8 vs its plain version (the chain of two fused-route int8
    GEMMs) on the card at MLP_SHAPES, in every design that takes the shape
    (the wgmma design, launched twice for identical bits, and the mma design
    it replaced).  Both run the same rounded float32 operations on exact
    integer sums, so the float32 output is held to 1e-6 relative (printed:
    whether it is equal bit for bit) and the bf16 output to one bf16 ulp;
    against the same chain of two linear_int8 launches on the card (the
    tensor-core GEMM), and the two designs against each other, it must be
    equal bit for bit.  Returns {C: the worst float32 error of the path's
    design} at MLP_WIDTHS."""
    from vision_transformer_cam_tpu_torch.kernels import gemm
    worst, failures = dict.fromkeys(MLP_WIDTHS, 0.0), []
    for si, (m, c, hid) in enumerate(MLP_SHAPES):
        designs = mlp_designs(c, hid, torch.int8)
        for x_dtype, out_dtype in ((torch.bfloat16, torch.float32),
                                   (torch.bfloat16, torch.bfloat16),
                                   (torch.float32, torch.float32)):
            ops = mlp_int8_operands(m, c, hid, x_dtype, seed=30 + si)
            for approx in (True, False):
                kw = dict(gelu_approx=approx, out_dtype=out_dtype)
                want = gemm.mlp_fused_int8_plain(*ops, **kw)
                chain = mlp_int8_chain(*ops, **kw)
                names = [str(d).split(".")[-1] for d in (x_dtype, out_dtype)]
                rtol = 1e-6 if out_dtype == torch.float32 else 2 ** -8
                got = {}
                for design in designs:
                    got[design] = _mlp_design(design, gemm.mlp_fused_int8,
                                              *ops, **kw)
                    torch.cuda.synchronize()
                    case = f"mlp_fused_int8 {design:5s} " \
                           f"{names[0]}->{names[1]} " \
                           f"{'tanh' if approx else 'erf':4s} M={m} C={c} " \
                           f"HID={hid}"
                    err = _compare(
                        f"{case} (bit for bit: plain "
                        f"{torch.equal(got[design], want)}, two linear_int8 "
                        f"launches {torch.equal(got[design], chain)})",
                        (got[design],), (want,), ((0.0, rtol),), failures)
                    if not torch.equal(got[design], chain):
                        failures.append(f"{case}: not the chain of two "
                                        "linear_int8 launches bit for bit")
                    if c in worst and out_dtype == torch.float32 and \
                            design == designs[0]:
                        worst[c] = max(worst[c], err)
                if "wgmma" in got:
                    if not torch.equal(got["wgmma"], got["mma"]):
                        failures.append(f"mlp_fused_int8 M={m} C={c} "
                                        f"{names}: the wgmma and mma designs "
                                        "differ")
                    if not torch.equal(got["wgmma"],
                                       gemm.mlp_fused_int8(*ops, **kw)):
                        failures.append(f"mlp_fused_int8 wgmma M={m} C={c}: "
                                        "a second launch gave other bits")
    if failures:
        raise AssertionError("mlp_fused_int8 != plain version:\n"
                             + "\n".join(failures))
    return worst


def mlp_occupancy(widths=MLP_WIDTHS):
    """For the fused MLP kernel instances the serving paths run (bf16; int8
    with bf16 x and out) in both designs at each C of ``widths``: blocks an
    SM holds at once, registers a thread at launch and local memory
    (cudaFuncGetAttributes), shared memory a block, and for the wgmma design
    its ring stages and a consumer warpgroup's output columns (the column
    group's instance); and from ptxas (build.log) every entry of the three
    sources with its registers and spill bytes (the wgmma design's consumers
    run at setmaxnreg 240, its producer at 24: ptxas reports the launch
    figure).  Returns {(design, kind, C): (blocks, registers, local bytes,
    shared bytes)}."""
    import ctypes

    from vision_transformer_cam_tpu_torch.kernels import _build
    lib, got = _build.load(), {}
    for c in widths:
        for design, fn, threads in (
                ("wgmma", lib.vitcam_mlp_wgmma_occupancy, 384),
                ("mma", lib.vitcam_mlp_fused_occupancy, 256)):
            for kind, name in ((1, "bf16"), (2, "int8")):
                info = (ctypes.c_int * 4)()
                err = fn(c, kind, info)
                if err:
                    raise RuntimeError(
                        f"mlp occupancy ({design}, {name}, C={c}): cudaError "
                        f"{err} ({lib.vitcam_cuda_error_string(err).decode()})")
                got[(design, name, c)] = tuple(info)
                ring = ""
                if design == "wgmma":
                    nw = lib.vitcam_mlp_wgmma_group_cols(c)
                    ring = (f"; {lib.vitcam_mlp_wgmma_ring_stages(c, kind)} "
                            f"ring stages, {nw} output columns a consumer "
                            f"warpgroup, {-(-c // (2 * nw))} column groups")
                say(f"mlp_occupancy {design:5s} {name:4s} C={c}: {info[0]} "
                    f"blocks of {threads} threads an SM, {info[1]} registers "
                    f"a thread at launch, {info[2]} bytes of local memory a "
                    f"thread, {info[3]} bytes of shared memory a block{ring}")
    log = (_build.lib_path().parent / "build.log").read_text()
    for part in re.split(r"^== ", log, flags=re.M)[1:]:
        src, _, body = part.partition("\n")
        if src not in ("mlp_fused_wgmma.cu", "mlp_fused_wgmma_wide.cu",
                       "mlp_fused.cu"):
            continue
        for entry, props in re.findall(
                r"Compiling entry function '(\S+)'.*?\n(.*?Used \d+ "
                r"registers)", body, flags=re.S):
            regs = re.search(r"Used (\d+) registers", props).group(1)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", props)
            short = re.search(r"(mlp_\w*?_kernel)I(\w+?)EEv", entry)
            if short:
                entry = f"{short.group(1)}<{short.group(2)}>"
            say(f"mlp_occupancy ptxas {src} {entry}: {regs} registers, "
                f"spill stores {spill.group(1) if spill else '?'} bytes, "
                f"spill loads {spill.group(2) if spill else '?'} bytes")
        for warn in re.findall(r".*(?:warning|setmaxnreg).*", body):
            say(f"mlp_occupancy ptxas {src}: {warn.strip()}")
    return got


def block_operands(b, n, heads, dtype, seed, hot, dh=64):
    """The operands of attention_block_fused at ``heads`` heads of width
    ``dh``: xn ~ N(0, 1), tokens ~ N(0, 1), weights ~ N(0, 1 / C) in the
    torch layout, biases ~ 0.1 N(0, 1), a random bg with 30 % background
    (cls column 0) and a row-stochastic float32 joint.  ``hot`` scales the
    q rows of heads 0 and 1 of the qkv weight by 40, so that logits of those
    heads pass the clamp at 80."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = heads * dh

    def rnd(*shape, gain=1.0):
        return gain * torch.randn(shape, generator=g, device="cuda")
    ops = (rnd(b, n, c), rnd(b, n, c), rnd(3 * c, c, gain=c ** -0.5),
           rnd(3 * c, gain=0.1), rnd(c, c, gain=c ** -0.5), rnd(c, gain=0.1))
    if hot:
        ops[2][:2 * dh] *= 40.0
    bg = (torch.rand((b, n), generator=g, device="cuda") < 0.3).float()
    bg[:, 0] = 0.0
    joint = torch.softmax(rnd(b, n, n), dim=-1)
    return tuple(t.to(dtype).contiguous() for t in ops), bg.to(dtype), joint


def block_designs(dtype, n=197, c=768, dh=64, rollout=True):
    """The block kernel's designs that take xn of ``dtype`` at this shape,
    the path's first (``kernels.attention.block_design``): the streamed
    design alone past the cluster design's shapes; else bf16 the cluster
    design's tensor-core core, then the FMA core it ran before where that
    fits; float32 the FMA core."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    path = ka.block_design(dtype, n, c, dh, rollout)
    if path == "tensor-core" and ka.block_smem_bytes(
            "fma", dtype, n, c, dh, rollout) <= ka.BLOCK_SMEM_LIMIT:
        return ("tensor-core", "fma")
    return (path,)


def _block_design(design, fn, *args, **kw):
    """``fn(*args, **kw)`` with the block wrapper's bf16 cluster core set to
    ``design`` ("tensor-core", the path's, or "fma", the core bf16 ran
    before; "streamed" leaves the switch as it is: the shape picks it);
    float32 runs the FMA core either way."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    saved = ka._block_bf16_design
    if design != "streamed":
        ka._block_bf16_design = design
    try:
        return fn(*args, **kw)
    finally:
        ka._block_bf16_design = saved


# the block kernel's cases (B, N, heads, head width): ViT-B/16's B=8 N=197
# (clusters of 7 blocks), a ragged B=3 N=37 (2) and the ends of the cluster
# design's range, B=2 N=256 (8) and B=2 N=17 (1), at 12 heads of 64; then
# the zoo's wider and longer shapes at B=2: ViT-H/14 (N=257, 16 heads of
# 80), ViT-L/16@384 (577), ViT-L/16@512 (1025) and ViT-L/16 (197, 16 of 64)
BLOCK_CASES = ((8, 197, 12, 64), (3, 37, 12, 64), (2, 256, 12, 64),
               (2, 17, 12, 64))
BLOCK_ZOO = ((2, 257, 16, 80), (2, 577, 16, 64), (2, 1025, 16, 64),
             (2, 197, 16, 64))


def _block_variants(b, n, heads, dh, dtype, seed):
    """(case label, operands, bg, joint or None, kwargs) of every variant of
    one block case: 30 % background and none, with and without the joint,
    clamp off and on."""
    ops, bg, joint = block_operands(b, n, heads, dtype, seed=seed,
                                    hot=dtype == torch.float32, dh=dh)
    name = str(dtype).split(".")[-1]
    for bg_kind, bg_ in (("30% bg", bg), ("no bg", torch.zeros_like(bg))):
        for with_joint in (True, False):
            for clamp in (False, True):
                kw = dict(num_heads=heads, scale=dh ** -0.5,
                          clamp_softmax=clamp)
                label = (name, with_joint, clamp, n, bg_kind)
                yield label, ops, bg_, joint if with_joint else None, kw


def check_attention_block(cases=BLOCK_CASES + BLOCK_ZOO,
                          bf16_joint=TOL_JOINT):
    """attention_block_fused vs its plain version on the card, in every
    design that takes the dtype and shape (block_designs; the path's bf16
    design launched twice for identical bits): with and without the joint,
    clamp on and off, 30 % background and none, at ``cases``; bf16's
    rollout update at ``bf16_joint``.  Returns {(dtype name, joint, clamp,
    n, bg kind): worst error} of the path's design at 12 heads of 64, and
    under ("zoo", n, dh) the worst error over each zoo shape's cases."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    errs, failures = {}, []
    for (b, n, heads, dh) in cases:
        c = heads * dh
        for dtype in (torch.bfloat16, torch.float32):
            for label, ops, bg_, j, kw in _block_variants(
                    b, n, heads, dh, dtype, seed=40 + n):
                want = ka.attention_block_fused_plain(*ops, bg_, j, **kw)
                tols = [TOL[(dtype, "out")], TOL[(dtype, "prob")],
                        bf16_joint if dtype == torch.bfloat16 else TOL_JOINT]
                designs = block_designs(dtype, n, c, dh, j is not None)
                for design in designs:
                    got = _block_design(design, ka.attention_block_fused,
                                        *ops, bg_, j, **kw)
                    torch.cuda.synchronize()
                    name, with_joint, clamp, _, bg_kind = label
                    case = f"attention block {design:11s} {name:8s} " \
                           f"joint={with_joint!s:5s} clamp={clamp!s:5s} " \
                           f"{bg_kind:6s} B={b} N={n} C={c} dh={dh}"
                    err = _compare(case, got, want, tols, failures)
                    if design == designs[0]:
                        if (heads, dh) == (12, 64):
                            errs[label] = err
                        else:
                            key = ("zoo", n, dh)
                            errs[key] = max(errs.get(key, 0.0), err)
                    if design != "fma" and not all(
                            torch.equal(x, y) for x, y in zip(
                                got, _block_design(
                                    design, ka.attention_block_fused,
                                    *ops, bg_, j, **kw))):
                        failures.append(f"{case}: a second launch gave "
                                        "other bits")
    if failures:
        raise AssertionError("attention block kernel != plain version:\n"
                             + "\n".join(failures))
    return errs


def block_bits(root, out):
    """SHA-256 of the block kernel's output bytes (out, cls row, J') at
    BLOCK_CASES (the cluster design's shapes: every dtype, background,
    joint, clamp and bf16 core, 96 cases) and at BLOCK_ZOO (the zoo shapes:
    the design each variant routes to, the streamed design at widths 64 and
    80 but bf16 with the rollout at N = 197, C = 1024, 64 cases), from the
    port of the checkout at ``root``, as ``bwd_bits`` does (and compared by
    ``compare_bits``)."""
    import hashlib
    sys.path.insert(0, os.path.abspath(root))
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    got = {}
    for (b, n, heads, dh) in BLOCK_CASES + BLOCK_ZOO:
        zoo = (b, n, heads, dh) in BLOCK_ZOO
        for dtype in (torch.bfloat16, torch.float32):
            for label, ops, bg_, j, kw in _block_variants(
                    b, n, heads, dh, dtype, seed=40 + n):
                if zoo:
                    designs = block_designs(dtype, n, heads * dh, dh,
                                            j is not None)[:1]
                else:
                    designs = ("fma",) if dtype == torch.float32 else \
                        ("tensor-core", "fma")
                for design in designs:
                    res = _block_design(design, ka.attention_block_fused,
                                        *ops, bg_, j, **kw)
                    digest = hashlib.sha256()
                    for t in res:
                        digest.update(t.contiguous().view(torch.uint8)
                                      .cpu().numpy().tobytes())
                    key = f"{design} {label}"
                    if zoo:
                        key = f"{design} B={b} H={heads} dh={dh} {label}"
                    got[key] = digest.hexdigest()
    with open(out, "w") as f:
        json.dump(got, f, indent=1, sort_keys=True)
    say(f"block_bits: {len(got)} cases from {ka.__file__} -> {out}")
    return got


# seq_bits' cases (B, N, heads, ranks) at head width 64: ViT-B's N = 197 on
# one rank and over four, and a ragged N = 37 over two
SEQ_BITS_CASES = ((2, 197, 16, 1), (2, 197, 16, 4), (3, 37, 12, 2))


def seq_bits(root, out):
    """SHA-256 of the sequence-parallel kernel's output bytes (out, row0,
    head mean) at head width 64 on every rank's shard of SEQ_BITS_CASES, in
    every design (float32: fma; bf16: tensor-core and fma), background,
    clamp and head-mean dtype, from the port of the checkout at ``root``, as
    ``bwd_bits`` does (and compared by ``compare_bits``)."""
    import hashlib
    sys.path.insert(0, os.path.abspath(root))
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    got = {}
    for (b, n, heads, sp) in SEQ_BITS_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            designs = ("fma",) if dtype == torch.float32 else \
                ("tensor-core", "fma")
            hms = (None, torch.float32) + (
                (torch.bfloat16,) if dtype == torch.bfloat16 else ())
            for bi, bg_kind in enumerate(("none", "30%", "all but cls")):
                qkv, bg = seq_inputs(b, n, heads, dtype, 100 * n + bi,
                                     bg_kind)
                shards, kv, bg_k = seq_shards(qkv, bg, sp)
                for clamp in (False, True):
                    for hm_dt in hms:
                        kw = dict(num_heads=heads, scale=0.125, n_real=n,
                                  clamp_softmax=clamp,
                                  with_headmean=hm_dt is not None,
                                  hm_dtype=hm_dt)
                        for design in designs:
                            for rank, (q, bg_q) in enumerate(shards):
                                res = _seq_design(design, q, kv, bg_q, bg_k,
                                                  **kw)
                                digest = hashlib.sha256()
                                for t in res:
                                    digest.update(t.contiguous().view(
                                        torch.uint8).cpu().numpy().tobytes())
                                got[f"{design} {dtype} B={b} N={n} H={heads} "
                                    f"sp={sp} rank {rank} bg={bg_kind} clamp="
                                    f"{clamp} hm={hm_dt}"] = digest.hexdigest()
    with open(out, "w") as f:
        json.dump(got, f, indent=1, sort_keys=True)
    say(f"seq_bits: {len(got)} cases from {ka.__file__} -> {out}")
    return got


def _block_smem_held(info, dtype, design, n, c, dh, qb=32):
    """The shared memory a block kernel instance takes (``info[3]``) held
    to the Python formula (kernels.attention.block_smem_bytes)."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    want = ka.block_smem_bytes(design, dtype, n, c, dh, True, qb)
    if info[3] != want:
        raise AssertionError(f"block kernel {design} N={n} C={c}: the "
                             f"kernel takes {info[3]} bytes of shared "
                             f"memory, the Python formula {want}")


def block_occupancy(heads=12):
    """For each instance of the block kernel the serving path could run
    (rollout, clamp): the cluster design at N = 197 (clusters of 7) and N =
    256 (8) at 12 heads of 64, how many clusters the card holds at once
    (cudaOccupancyMaxActiveClusters); the streamed design at the zoo's
    shapes (BLOCK_ZOO, streamed_occupancy); and the registers and local
    memory per thread and the shared memory per block of each, the shared
    memory also held to the Python formula
    (kernels.attention.block_smem_bytes).  Returns {(design, dtype name,
    n[, C, dh]): (clusters or blocks, registers, local bytes, shared
    bytes)}."""
    import ctypes

    from vision_transformer_cam_tpu_torch.kernels import _build
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    lib, got = _build.load(), {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n in (197, 256):
        for dtype in (torch.bfloat16, torch.float32):
            for design in block_designs(dtype):
                info = (ctypes.c_int * 4)()
                err = lib.vitcam_attention_block_occupancy(
                    n, heads, 1, 1, ka._DTYPE_CODES[dtype],
                    ka.BLOCK_DESIGNS[design], info)
                if err:
                    raise RuntimeError(
                        f"attention block occupancy ({design}, {dtype}, "
                        f"N={n}): cudaError {err} "
                        f"({lib.vitcam_cuda_error_string(err).decode()})")
                _block_smem_held(info, dtype, design, n, heads * 64, 64)
                name = str(dtype).split(".")[-1]
                got[(design, name, n)] = tuple(info)
                blocks = -(-n // ka.BLOCK_ROWS)
                say(f"occupancy attention block {design:11s} {name:8s} "
                    f"rollout clamp N={n}: {info[0]} clusters of {blocks} "
                    f"at once ({info[0] * blocks} blocks on {sms} SMs), "
                    f"{info[1]} registers, {info[2]} bytes of local "
                    f"memory per thread, {info[3]} bytes of shared memory "
                    f"per block")
    got.update(streamed_occupancy(BLOCK_ZOO))
    return got


def streamed_occupancy(cases):
    """The block kernel's streamed design at ``cases`` (B, N, heads, head
    width; B unused), each dtype whose route is the streamed design, with
    the rollout and the clamp: query rows a block, blocks an SM,
    registers, local memory, shared memory (held to the Python formula).
    Returns {("streamed", dtype name, n, C, dh): info}."""
    import ctypes

    from vision_transformer_cam_tpu_torch.kernels import _build
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    lib, got = _build.load(), {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for _, n, zh, dh in cases:
        c = zh * dh
        for dtype in (torch.bfloat16, torch.float32):
            design = ka.block_design(dtype, n, c, dh)
            if design != "streamed":
                continue
            qb = ka.block_rows(dtype, n, c, dh)
            info = (ctypes.c_int * 4)()
            err = lib.vitcam_attention_block_streamed_occupancy(
                n, zh, dh, 1, 1, ka._DTYPE_CODES[dtype], qb, info)
            if err:
                raise RuntimeError(
                    f"attention block occupancy (streamed, {dtype}, N={n} "
                    f"C={c}): cudaError {err} "
                    f"({lib.vitcam_cuda_error_string(err).decode()})")
            _block_smem_held(info, dtype, design, n, c, dh, qb)
            name = str(dtype).split(".")[-1]
            got[(design, name, n, c, dh)] = tuple(info)
            say(f"occupancy attention block streamed    {name:8s} rollout "
                f"clamp N={n} C={c} dh={dh}: {qb} query rows a block, "
                f"{info[0]} blocks an SM at once ({info[0] * sms} on {sms} "
                f"SMs), {info[1]} registers, {info[2]} bytes of local "
                f"memory per thread, {info[3]} bytes of shared memory per "
                f"block")
    return got


def seq_inputs(b, n, heads, dtype, seed, bg_kind="30%", dh=64):
    """Packed qkv [B, N, 3C] at head width ``dh`` with hot query rows 1-3
    (logits past the clamp) and a background of the given kind (cls column
    never background)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = heads * dh
    share = {"none": 0.0, "30%": 0.3, "all but cls": 1.1}[bg_kind]
    bg = (torch.rand((b, n), generator=g, device="cuda") < share).float()
    bg[:, 0] = 0.0
    qkv = torch.randn((b, n, 3 * c), generator=g, device="cuda")
    qkv[:, 1:4, :c] *= 40.0
    return qkv.to(dtype).contiguous(), bg.to(dtype)


def seq_shards(qkv, bg, sp):
    """The token axis zero-padded to a multiple of ``sp``: per rank (q, bg_q),
    and the K | V rows and bg of all ranks."""
    b, n, c3 = qkv.shape
    c, nq = c3 // 3, -(-n // sp)
    pad = nq * sp - n
    qkv_p = torch.nn.functional.pad(qkv, (0, 0, 0, pad))
    bg_p = torch.nn.functional.pad(bg, (0, pad))
    kv = qkv_p[:, :, c:].contiguous()
    shards = [(qkv_p[:, r * nq:(r + 1) * nq, :c].contiguous(),
               bg_p[:, r * nq:(r + 1) * nq].contiguous()) for r in range(sp)]
    return shards, kv, bg_p


def check_attention_seq(b=2, heads=16, dh=64, ns=(197, 577, 1025),
                        sps=(1, 2, 4, 8), compact=False, kept_n=577):
    """The sequence-parallel kernel at head width ``dh`` against its plain
    version on every rank's shard of ``sps`` ranks at each N of ``ns`` (bf16:
    the tensor-core design, launched twice for identical bits; float32: the
    FMA design), and the stitched shards against the attention kernel of the
    unsharded path (kernel 1, at the same width).  The full matrix: three
    backgrounds, clamp off and on, no head mean and the head mean in float32
    and in the element type; ``compact``: 30 % background, the float32 head
    mean with the clamp, and neither.  Returns the worst error of the (bf16,
    clamp, float32 head mean) cases at N = ``kept_n``."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    failures, n_cases, kept = [], 0, 0.0
    kw = dict(num_heads=heads, scale=dh ** -0.5)
    for n in ns:
        for sp in sps:
            for dtype in (torch.float32, torch.bfloat16):
                worst = {"out": 0.0, "row0": 0.0, "hm": 0.0, "stitched": 0.0}
                if compact:
                    combos = ((False, None), (True, torch.float32))
                    bgs = ("30%",)
                else:
                    hms = (None, torch.float32) if dtype == torch.float32 \
                        else (None, torch.float32, torch.bfloat16)
                    combos = tuple((clamp, hm_dt) for clamp in (False, True)
                                   for hm_dt in hms)
                    bgs = ("none", "30%", "all but cls")
                for bi, bg_kind in enumerate(bgs):
                    qkv, bg = seq_inputs(b, n, heads, dtype, 100 * n + bi,
                                         bg_kind, dh)
                    shards, kv, bg_k = seq_shards(qkv, bg, sp)
                    for clamp, hm_dt in combos:
                        ckw = dict(kw, clamp_softmax=clamp, n_real=n,
                                   with_headmean=hm_dt is not None,
                                   hm_dtype=hm_dt)
                        got_all = []
                        for rank, (q, bg_q) in enumerate(shards):
                            got = ka.masked_attention_seq_local(
                                q, kv, bg_q, bg_k, **ckw)
                            want = ka.masked_attention_seq_local_ref(
                                q, kv, bg_q, bg_k, **ckw)
                            got_all.append(got)
                            n_cases += 1
                            # the tensor-core design: identical bits from a
                            # second launch
                            if dtype == torch.bfloat16 and not all(
                                    torch.equal(x, y) for x, y in zip(
                                        got, ka.masked_attention_seq_local(
                                            q, kv, bg_q, bg_k, **ckw))):
                                failures.append(
                                    f"dh={dh} N={n} sp={sp} rank {rank} hm="
                                    f"{hm_dt} clamp={clamp} bg={bg_kind}: a "
                                    "second launch gave other bits")
                            tols = [TOL[(dtype, "out")], TOL[(dtype, "prob")],
                                    TOL[(hm_dt or dtype, "prob")]]
                            for name, g_, w_, (atol, rtol) in zip(
                                    ("out", "row0", "hm"), got, want, tols):
                                g_, w_ = g_.float(), w_.float()
                                err = (g_ - w_).abs()
                                worst[name] = max(worst[name],
                                                  float(err.max()))
                                if n == kept_n and clamp and \
                                        dtype == torch.bfloat16 and \
                                        hm_dt == torch.float32:
                                    kept = max(kept, float(err.max()))
                                if not torch.isfinite(g_).all() or float(
                                        (err - atol - rtol * w_.abs())
                                        .max()) > 0:
                                    failures.append(
                                        f"dh={dh} N={n} sp={sp} rank {rank} "
                                        f"{dtype} clamp={clamp} hm={hm_dt} "
                                        f"bg={bg_kind} {name}: "
                                        f"{float(err.max()):.3e}")
                        # stitched shards against the unsharded kernel
                        if dh == 64 and n > (780 if hm_dt is not None
                                             else 1516):
                            continue
                        ref = ka.masked_attention_fused(
                            qkv, bg, with_headmean=hm_dt is not None,
                            hm_dtype=hm_dt, clamp_softmax=clamp, **kw)
                        out = torch.cat([g_[0] for g_ in got_all],
                                        dim=1)[:, :n]
                        pairs = [(out, ref[0], TOL[(dtype, "out")]),
                                 (got_all[0][1][:, :n], ref[1],
                                  TOL[(dtype, "prob")])]
                        if hm_dt is not None:
                            hm = torch.cat([g_[2] for g_ in got_all],
                                           dim=1)[:, :n, :n]
                            pairs.append((hm, ref[2], TOL[(hm_dt, "prob")]))
                        for g_, w_, (atol, rtol) in pairs:
                            err = (g_.float() - w_.float()).abs()
                            worst["stitched"] = max(worst["stitched"],
                                                    float(err.max()))
                            if float((err - atol - rtol * w_.float().abs()
                                      ).max()) > 0:
                                failures.append(
                                    f"dh={dh} N={n} sp={sp} {dtype} clamp="
                                    f"{clamp} hm={hm_dt} bg={bg_kind} "
                                    "stitched vs masked_attention_fused: "
                                    f"{float(err.max()):.3e}")
                torch.cuda.synchronize()
                say(f"check attention_seq dh={dh} H={heads} N={n} sp={sp} "
                    f"(NQ={-(-n // sp)}, Np={-(-n // sp) * sp}) "
                    f"{str(dtype).split('.')[-1]:8s}: max abs err "
                    + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    say(f"check attention_seq dh={dh}: {n_cases} shard cases")
    if failures:
        raise AssertionError("sequence-parallel kernel != plain version:\n"
                             + "\n".join(failures[:40]))
    return kept


def check_attention_seq_widths():
    """Phase 8 at head widths 80, 16, 32 and 40: at 80 (16 heads) the full
    matrix of ``check_attention_seq`` on every rank's shard of 1, 2, 4 and 8
    ranks at N = 257 and 1025; at 16, 32 and 40 its compact matrix at phase
    24's shapes (WIDTH_CASES); widths 24 and 48 refused, naming the compiled
    widths; at each compiled width (64 too) the longest padded token axis
    (SEQ_MAX_NP: 16 query rows, 2 heads, the float32 head mean,
    clamp) against the plain version in both dtypes, and one key more
    refused, naming the bytes.  Returns {dh: worst error of the bf16, clamp,
    float32 head-mean cases} (at 80: at N = 257)."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    t0 = time.perf_counter()
    errs = {80: check_attention_seq(heads=16, dh=80, ns=(257, 1025),
                                    kept_n=257)}
    for (b, n, h, dh) in WIDTH_CASES:
        errs[dh] = max(errs.get(dh, 0.0), check_attention_seq(
            b, h, dh, ns=(n,), compact=True, kept_n=n))
    failures = []
    for dh in (24, 48):
        qkv, bg = seq_inputs(1, 37, 2, torch.bfloat16, 3, dh=dh)
        shards, kv, bg_k = seq_shards(qkv, bg, 1)
        q, bg_q = shards[0]
        try:
            ka.masked_attention_seq_local(q, kv, bg_q, bg_k, num_heads=2,
                                          scale=0.125)
            failures.append(f"head width {dh}: not refused")
        except ValueError as e:
            say(f"check attention_seq at head width {dh} is refused: {e}")
            if "16, 32, 40, 64, 80" not in str(e):
                failures.append(f"head width {dh}: {e}")
    for dh in ka.SEQ_HEAD_DIMS:
        limit = ka.SEQ_MAX_NP[dh]
        for dtype in (torch.float32, torch.bfloat16):
            qkv, bg = seq_inputs(1, limit, 2, dtype, limit, dh=dh)
            c = 2 * dh
            q, bg_q = qkv[:, :16, :c].contiguous(), bg[:, :16].contiguous()
            kv = qkv[:, :, c:].contiguous()
            kw = dict(num_heads=2, scale=dh ** -0.5, n_real=limit,
                      with_headmean=True, clamp_softmax=True,
                      hm_dtype=torch.float32)
            _compare(f"attention_seq dh={dh} {dtype} at Np={limit}",
                     ka.masked_attention_seq_local(q, kv, bg_q, bg, **kw),
                     ka.masked_attention_seq_local_ref(q, kv, bg_q, bg, **kw),
                     [TOL[(dtype, "out")], TOL[(dtype, "prob")],
                      TOL[(torch.float32, "prob")]], failures)
            kv1 = torch.nn.functional.pad(kv, (0, 0, 0, 1))
            bg1 = torch.nn.functional.pad(bg, (0, 1))
            try:
                ka.masked_attention_seq_local(q, kv1, bg_q, bg1,
                                              **dict(kw, n_real=limit + 1))
                failures.append(f"dh={dh} {dtype} Np={limit + 1}: not "
                                "refused")
            except ValueError as e:
                if dtype == torch.bfloat16:
                    say(f"check attention_seq dh={dh} at Np={limit + 1} is "
                        f"refused: {e}")
                if "bytes of shared memory" not in str(e):
                    failures.append(f"dh={dh} Np={limit + 1}: {e}")
    if failures:
        raise AssertionError("sequence-parallel kernel at head widths 80, "
                             "16, 32, 40 != plain version:\n"
                             + "\n".join(failures[:40]))
    say(f"check attention_seq widths: {time.perf_counter() - t0:.1f} s, worst "
        "bf16 clamp hm-f32 errors " + ", ".join(f"dh={k} {v:.2e}"
                                                for k, v in errs.items()))
    return errs


def seq_occupancy(widths=(64, 80, 16, 32, 40), n=257):
    """For each width's instances the serving path runs (the head mean,
    clamp): blocks an SM, registers and local memory (spills) a thread and
    shared memory a block of the tensor-core (bf16) and FMA (float32)
    designs at Np = ``n`` and at the width's limit (SEQ_MAX_NP),
    the shared memory held to the Python formula (seq_smem_bytes).
    Returns {(dh, design, Np): info}."""
    import ctypes

    from vision_transformer_cam_tpu_torch.kernels import _build
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    lib, got = _build.load(), {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dh in widths:
        for np_ in (n, ka.SEQ_MAX_NP[dh]):
            for design, dtype in (("tensor-core", torch.bfloat16),
                                  ("fma", torch.float32)):
                info = (ctypes.c_int * 4)()
                err = lib.vitcam_masked_attention_seq_occupancy(
                    np_, 1, ka._DTYPE_CODES[dtype], ka.SEQ_DESIGNS[design],
                    dh, info)
                if err:
                    raise RuntimeError(
                        f"attention_seq occupancy ({design}, dh={dh}, "
                        f"Np={np_}): cudaError {err} "
                        f"({lib.vitcam_cuda_error_string(err).decode()})")
                want = ka.seq_smem_bytes(np_, dh, True, design)
                if info[3] != want:
                    raise AssertionError(
                        f"attention_seq {design} dh={dh} Np={np_}: the kernel "
                        f"takes {info[3]} bytes of shared memory, the Python "
                        f"formula {want}")
                got[(dh, design, np_)] = tuple(info)
                say(f"occupancy attention_seq {design:11s} "
                    f"{str(dtype).split('.')[-1]:8s} hm clamp dh={dh} "
                    f"Np={np_}: {info[0]} blocks an SM at once "
                    f"({info[0] * sms} on {sms} SMs), {info[1]} registers, "
                    f"{info[2]} bytes of local memory per thread, {info[3]} "
                    "bytes of shared memory per block")
    return got


def _seq_design(design, *args, **kw):
    """The sequence-parallel wrapper made to run its bf16 call on ``design``
    ("tensor-core", the path's, or "fma", the design bf16 ran before)."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    saved, ka._seq_bf16_design = ka._seq_bf16_design, design
    try:
        return ka.masked_attention_seq_local(*args, **kw)
    finally:
        ka._seq_bf16_design = saved


def time_attention_seq(b=16, n=577, heads=16, dh=64, sps=(1, 4)):
    """The sequence-parallel kernel at head width ``dh``, bf16, clamp,
    float32 head mean (as the main path launches it), at the ViT-L/16@384
    shape by default: one rank (NQ = 577) and a shard of four (NQ = 145, Np
    = 580).  The FMA design bf16 ran before is held against the plain
    version too, then the tensor-core design (the path's), the plain version
    and F.scaled_dot_product_attention on the same q, K, V with the additive
    mask (a yardstick for the shape: it returns neither row0 nor hm) run in
    turns; the FMA design, which no longer changes, is not timed (PERF.md
    keeps its last times).  Returns {sp: (kernel ms, plain ms, sdpa ms)}."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    qkv, bg = seq_inputs(b, n, heads, torch.bfloat16, 7, dh=dh)
    times = {}
    for sp in sps:
        shards, kv, bg_k = seq_shards(qkv, bg, sp)
        q, bg_q = shards[0]
        kw = dict(num_heads=heads, scale=dh ** -0.5, clamp_softmax=True,
                  with_headmean=True, hm_dtype=torch.float32, n_real=n)
        nq, np_ = q.shape[1], kv.shape[1]
        qh = q.reshape(b, nq, heads, dh).transpose(1, 2)
        kh, vh = kv.reshape(b, np_, 2, heads, dh).permute(2, 0, 3, 1, 4)
        mask = ((1 - bg_q.float())[:, :, None]
                * (-100.0 * bg_k.float())[:, None, :])
        mask[:, :, n:] = -1e9
        mask = mask[:, None].to(torch.bfloat16)
        fns = {d: (lambda d=d: _seq_design(d, q, kv, bg_q, bg_k, **kw))
               for d in ("tensor-core", "fma")}
        fns["plain"] = lambda: ka.masked_attention_seq_local_ref(
            q, kv, bg_q, bg_k, **kw)
        fns["SDPA"] = lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask)
        want, failures = fns["plain"](), []
        for d in ("tensor-core", "fma"):
            tols = [TOL[(torch.bfloat16, "out")],
                    TOL[(torch.bfloat16, "prob")],
                    TOL[(torch.float32, "prob")]]
            _compare(f"attention_seq {d} bf16 hm f32 B={b} N={n} H={heads} "
                     f"dh={dh} sp={sp}", fns[d](), want, tols, failures)
        if failures:
            raise AssertionError("sequence-parallel kernel != plain version:"
                                 "\n" + "\n".join(failures))
        del fns["fma"]
        ms = round_robin(fns)
        times[sp] = (ms["tensor-core"], ms["plain"], ms["SDPA"])
        say(f"time attention_seq bf16 hm f32 B={b} N={n} H={heads} dh={dh} "
            f"sp={sp} (NQ={nq}, Np={np_}): tensor-core design "
            f"{ms['tensor-core']:.4f} ms, "
            f"plain {ms['plain']:.4f} ms, F.scaled_dot_product_attention (no "
            f"row0, no hm) {ms['SDPA']:.4f} ms")
        del want, fns
    return times


def time_attention_seq_widths():
    """Each width of SEQ_TIMED through ``time_attention_seq``: ViT-H/14's
    shape (B=64, N=257, 16 heads of 80) on one rank and on a shard of two
    (NQ = 129, Np = 258), the narrow widths on one rank.  Returns {dh: {sp:
    (kernel ms, plain ms, sdpa ms)}}."""
    return {dh: time_attention_seq(b, n, h, dh, (1, 2) if dh == 80 else (1,))
            for dh, (b, n, h) in SEQ_TIMED.items()}


def seq_bound(b, n, heads, dh, sp=1):
    """The sequence-parallel kernel's bound on one rank's shard of ``sp``
    (rank 0's: NQ = ceil(N / sp) query rows, Np = sp NQ keys), bf16 with
    the float32 head mean: bf16 q and K | V and the two float32 bg rows in;
    bf16 out and row0 and the float32 head mean [B, NQ, Np] out; both
    products at the bf16 rate."""
    nq = -(-n // sp)
    np_, c = nq * sp, heads * dh
    return bound(f"masked_attention_seq_local bf16, f32 head mean B={b} "
                 f"NQ={nq} Np={np_} H={heads} dh={dh}",
                 b * nq * c * 2 + b * np_ * 2 * c * 2 + b * (nq + np_) * 4
                 + b * nq * c * 2 + b * np_ * 2 + b * nq * np_ * 4,
                 {"bf16": 4 * b * heads * nq * np_ * dh})


def time_ms(fn, iters=20, warmup=3):
    """Mean ms of ``fn()`` between two CUDA events (the package's timer)."""
    from vision_transformer_cam_tpu_torch.utils import profiling
    return profiling.time_ms(fn, iters, warmup)


def in_turns(kern, plain, iters=20):
    """(kernel ms, plain ms), each the mean of two runs, in turns."""
    from vision_transformer_cam_tpu_torch.utils import profiling
    return profiling.in_turns(kern, plain, iters)


def time_kernels(b=64, n=197):
    """Each kernel against its plain version at ViT-B shapes and B=64, in
    turns: the attention variants (bf16 and int8 in the tensor-core design,
    float32 in the FMA design) and the int8 GEMMs (the tensor-core design;
    the designs they replaced, which no longer change, are not timed:
    PERF.md keeps their last times), the GEMMs also beside bf16 F.linear and
    torch._int_mm (the bare int8 product: no quantize, no epilogue) at the
    same shape; then kernel 1's int8 rollout variants at ViT-L/16@384's
    N = 577 (B=16, 16 heads), checked against the plain version and timed
    the same way.  Returns {key: (kernel ms, plain ms)}."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    from vision_transformer_cam_tpu_torch.kernels import gemm
    times = {}

    def attention_turns(label, dtype, qkv, bg, joint, heads, variant, clamp,
                        scales, iters=20):
        fns = {d: (lambda d=d: _fwd_design(
            d, _call, ka.masked_attention_fused, variant, qkv, bg, joint,
            heads, clamp, scales)) for d in fwd_designs(dtype)[:1]}
        fns["plain"] = lambda: _call(ka.masked_attention_fused_ref, variant,
                                     qkv, bg, joint, heads, clamp, scales)
        ms = round_robin(fns, iters)
        say(f"time attention {label}: " + ", ".join(
            f"{name} {t:.4f} ms" for name, t in ms.items()))
        return ms

    for kind in ("bf16", "float32", "int8_io", "int8_out"):
        dtype = {"bf16": torch.bfloat16, "float32": torch.float32,
                 "int8_io": torch.int8, "int8_out": torch.bfloat16}[kind]
        clamp = kind != "float32"
        qkv, bg, joint, sc = attention_inputs(b, n, 12, dtype, seed=1)
        scales = torch.cat([sc, torch.tensor([20.0], device="cuda")]) \
            if kind == "int8_io" else (torch.tensor([20.0], device="cuda")
                                       if kind == "int8_out" else None)
        for variant in VARIANTS if kind in ("bf16", "float32") \
                else ("rollout",):
            ms = attention_turns(f"{kind:8s} {variant:8s} B={b} N={n}", dtype,
                                 qkv, bg, joint, 12, variant, clamp, scales)
            times[("attention", kind, variant)] = (
                ms[fwd_designs(dtype)[0]], ms["plain"])
    # the training forward: bf16, plain variant, no clamp
    qkv, bg, joint, _ = attention_inputs(b, n, 12, torch.bfloat16, seed=1)
    ms = attention_turns(f"bf16 plain, no clamp (the training forward) B={b} "
                         f"N={n}", torch.bfloat16, qkv, bg, joint, 12, "plain",
                         False, None)
    times[("attention", "bf16 no clamp", "plain")] = (ms["tensor-core"],
                                                      ms["plain"])
    # kernel 1's int8 rollout variants past 512 tokens (ViT-L/16@384): the
    # int8 route of serving.py stops at 640 tokens; recorded, not routed
    ln, lb, lh = 577, 16, 16
    for kind in ("int8_io", "int8_out"):
        dtype = torch.int8 if kind == "int8_io" else torch.bfloat16
        qkv, bg, joint, sc = attention_inputs(lb, ln, lh, dtype, seed=2)
        scales = torch.cat([sc, torch.tensor([20.0], device="cuda")]) \
            if kind == "int8_io" else torch.tensor([20.0], device="cuda")
        want = _call(ka.masked_attention_fused_ref, "rollout", qkv, bg, joint,
                     lh, True, scales)
        failures = []
        for design in fwd_designs(dtype):
            _compare(f"attention {design} {kind} rollout clamp B={lb} N={ln} "
                     f"H={lh}", _fwd_design(
                         design, _call, ka.masked_attention_fused, "rollout",
                         qkv, bg, joint, lh, True, scales), want,
                     [None, TOL[(torch.bfloat16, "prob")], TOL_JOINT],
                     failures)
        if failures:
            raise AssertionError("attention kernel != plain version:\n"
                                 + "\n".join(failures))
        ms = attention_turns(f"{kind:8s} rollout  B={lb} N={ln} H={lh}",
                             dtype, qkv, bg, joint, lh, "rollout", True,
                             scales, iters=10)
        times[("attention", kind, "rollout", ln)] = (ms["tensor-core"],
                                                     ms["plain"])
        del want
    # the int8 GEMMs as the int8 main path calls them (ln_quant and the
    # fused route on): patch fused bf16 -> bf16, qkv int8 -> requant/36,
    # proj int8 -> bf16, fc1 int8 -> gelu, fc2 int8 -> bf16
    path = {"patch": ("fused", "x", "float", {}),
            "qkv": ("qlinear", "xq", "requant", {"groups": 36}),
            "proj": ("qlinear", "xq", "float", {}),
            "fc1": ("qlinear", "xq", "gelu", {"gelu_approx": True}),
            "fc2": ("qlinear", "xq", "float", {})}
    for si, (shape, (k, n_out)) in enumerate(GEMM_SHAPES.items()):
        ops = gemm_operands(b * n, k, n_out, seed=10 + si)
        route, x_kind, epi, extra = path[shape]
        args, kw = _gemm_args(ops, route, x_kind, epi, extra, si)
        fns = {"tensor-core": lambda: _gemm_design("tensor-core", *args,
                                                   **kw),
               "plain": lambda: gemm.linear_int8_ref(*args, **kw)}
        ms = round_robin(fns, iters=5)
        # the same calls' device time, out of a CUDA graph: a call shorter
        # than the wrapper's host work is timed as that work by time_ms
        dev = round_robin({"tensor-core": fns["tensor-core"]}, iters=10,
                          timer=graph_ms)
        times[("gemm", shape)] = (ms["tensor-core"], ms["plain"])
        times[("gemm_graph", shape)] = dev["tensor-core"]
        wb = torch.randn((n_out, k), device="cuda").to(torch.bfloat16)
        xq = torch.clamp(torch.round(ops["x"].float() / ops["act"]), -127,
                         127).to(torch.int8)
        wt = ops["wq"].t()   # [K, N], column major: cuBLASLt's int8 layout
        yard_fns = {
            "bf16 F.linear": lambda: torch.nn.functional.linear(ops["x"], wb,
                                                                None),
            "torch._int_mm": lambda: torch._int_mm(xq, wt)}
        yard = round_robin(yard_fns, iters=5)
        yard_dev = round_robin(yard_fns, iters=10, timer=graph_ms)
        times[("gemm_bf16", shape)] = yard["bf16 F.linear"]
        times[("gemm_int_mm", shape)] = yard["torch._int_mm"]
        times[("gemm_bf16_graph", shape)] = yard_dev["bf16 F.linear"]
        times[("gemm_int_mm_graph", shape)] = yard_dev["torch._int_mm"]
        say(f"time int8 GEMM {shape:5s} M={b * n} K={k} N={n_out} "
            f"({route}, {x_kind}, {epi}): tensor-core {ms['tensor-core']:.4f} "
            f"ms, plain {ms['plain']:.4f} ms; "
            f"bf16 F.linear {yard['bf16 F.linear']:.4f} ms, torch._int_mm "
            f"(int32 product only) {yard['torch._int_mm']:.4f} ms; out of a "
            f"CUDA graph (device time): tensor-core "
            f"{dev['tensor-core']:.4f} ms, bf16 "
            f"F.linear {yard_dev['bf16 F.linear']:.4f} ms, torch._int_mm "
            f"{yard_dev['torch._int_mm']:.4f} ms")
    five = {"tensor-core": [times[("gemm", s_)][0] for s_ in GEMM_SHAPES],
            "plain": [times[("gemm", s_)][1] for s_ in GEMM_SHAPES],
            "bf16 F.linear": [times[("gemm_bf16", s_)] for s_ in GEMM_SHAPES],
            "torch._int_mm": [times[("gemm_int_mm", s_)]
                              for s_ in GEMM_SHAPES],
            "tensor-core out of a CUDA graph": [times[("gemm_graph", s_)]
                                                for s_ in GEMM_SHAPES],
            "bf16 F.linear out of a CUDA graph": [
                times[("gemm_bf16_graph", s_)] for s_ in GEMM_SHAPES],
            "torch._int_mm out of a CUDA graph": [
                times[("gemm_int_mm_graph", s_)] for s_ in GEMM_SHAPES]}
    say("time int8 GEMM, the five: " + ", ".join(
        f"{name} {sum(v):.4f} ms" for name, v in five.items()))
    # ln_quant at the B=64 rows and at batch 256's, by CUDA events around
    # the wrapper calls and as device time out of a CUDA graph (a call this
    # short is otherwise timed as the wrapper's host work), beside its bound
    w = torch.ones(768, device="cuda", dtype=torch.bfloat16)
    inv = torch.tensor(30.0, device="cuda")
    for m in (b * n, 4 * b * n):
        x = torch.randn((m, 768), device="cuda").to(torch.bfloat16)
        fns = {"kernel": lambda: gemm.ln_quant(x, w, w, eps=1e-6, inv_a=inv),
               "plain": lambda: gemm.ln_quant_ref(x, w, w, eps=1e-6,
                                                  inv_a=inv)}
        ms = round_robin(fns)
        dev = round_robin({"kernel": fns["kernel"]}, timer=graph_ms)
        bound_ms = ln_quant_bound(m, 768)[0]
        times[("ln_quant", m)] = (ms["kernel"], ms["plain"])
        times[("ln_quant_graph", m)] = dev["kernel"]
        say(f"time ln_quant [{m}, 768] bf16: kernel {ms['kernel']:.4f} ms, "
            f"plain {ms['plain']:.4f} ms; out of a CUDA graph (device time) "
            f"{dev['kernel']:.4f} ms, bound {bound_ms:.4f} ms "
            f"({100 * bound_ms / dev['kernel']:.1f} % of the bound's rate)")
    return times


# the wide widths' timed shapes, C: (rows, C): ViT-H/14 at B = 64 (N = 257)
# and ViT-L/16@512 at B = 32 (N = 1025)
MLP_TIMED = {1280: (64 * 257, 1280), 1024: (32 * 1025, 1024)}


def time_mlp(rows, c, hid):
    """Both fused MLP kernels on [rows, c] (bf16 x; int8 with bf16 x and
    out) in the path's design, in turns with the plain version and the
    unfused route (F.linear -> F.gelu -> F.linear; two fused-route int8 GEMM
    launches).  Returns {name: (kernel ms, plain ms, unfused ms)}."""
    import torch.nn.functional as F
    from vision_transformer_cam_tpu_torch.kernels import gemm
    times = {}
    x, w1, b1, w2, b2 = mlp_operands(rows, c, hid, torch.bfloat16, seed=50)
    fns = {"wgmma": lambda: _mlp_design("wgmma", gemm.mlp_fused, x, w1,
                                        b1, w2, b2)}
    fns["plain"] = lambda: gemm.mlp_fused_plain(x, w1, b1, w2, b2)
    fns["unfused"] = lambda: F.linear(F.gelu(F.linear(x, w1, b1),
                                             approximate="tanh"), w2, b2)
    ms = round_robin(fns, iters=5)
    times["mlp_fused"] = (ms["wgmma"], ms["plain"], ms["unfused"])
    bound_ms = mlp_bound(rows, c, hid, torch.bfloat16)[0]
    say(f"time mlp_fused bf16 M={rows} C={c} HID={hid}, in turns: wgmma "
        f"{ms['wgmma']:.4f} ms, plain "
        f"{ms['plain']:.4f} ms; unfused F.linear, F.gelu, F.linear "
        f"(cuBLAS and ATen) {ms['unfused']:.4f} ms; bound {bound_ms:.4f} "
        f"ms ({100 * bound_ms / ms['wgmma']:.1f} % of the bound's rate)")
    del x, w1, b1, w2, b2, fns

    ops = mlp_int8_operands(rows, c, hid, torch.bfloat16, seed=51)
    xq, w1q, cs1, b1q, w2q, cs2, b2q, inv1, inv2 = ops
    one = torch.ones((), device="cuda")

    def chain():
        hq = gemm.linear_int8(xq, w1q, cs1, b1q, inv1, route="fused",
                              epilogue="gelu", out_scales=inv2.reshape(1))
        return gemm.linear_int8(hq.float(), w2q, cs2, b2q, one,
                                route="fused", out_dtype=torch.bfloat16)
    fns = {"wgmma": lambda: _mlp_design("wgmma", gemm.mlp_fused_int8, *ops)}
    fns["plain"] = lambda: gemm.mlp_fused_int8_plain(*ops)
    fns["unfused"] = chain
    ms = round_robin(fns, iters=5)
    times["mlp_fused_int8"] = (ms["wgmma"], ms["plain"], ms["unfused"])
    bound_ms = mlp_bound(rows, c, hid, torch.int8)[0]
    say(f"time mlp_fused_int8 bf16 M={rows} C={c} HID={hid}, in turns: "
        f"wgmma {ms['wgmma']:.4f} ms, "
        f"plain {ms['plain']:.4f} ms; unfused chain of two int8 GEMM "
        f"launches (and the cast between them) {ms['unfused']:.4f} ms; "
        f"bound {bound_ms:.4f} ms ({100 * bound_ms / ms['wgmma']:.1f} % "
        f"of the bound's rate)")
    return times


def time_fused(b=64, n=197, heads=12):
    """The three fused kernels at ViT-B shapes and B=64 (the MLP kernels
    also at batch 256's M = 50432 and at the wide widths, MLP_TIMED), in
    turns with their plain versions (the
    designs they replaced no longer change and are not timed: PERF.md keeps
    their last times), and beside each the unfused route the port already
    has, a yardstick for the shape and not the same single call: F.linear
    -> F.gelu -> F.linear; two fused-route int8 GEMM launches; the qkv GEMM,
    the attention kernel, the proj GEMM and the residual add.  Returns
    {name: (kernel ms, plain ms, unfused route ms)}, the MLP kernels at M =
    50432 under (name, M) and at a wide width under (name, "C=<C>")."""
    import torch.nn.functional as F
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    c, m = heads * 64, b * n
    times = {}

    # the two fused MLP kernels at B=64 and at batch 256's rows, and at the
    # wide widths (MLP_TIMED): the wgmma design, the plain version and the
    # unfused route, in turns
    for rows, mc in ((m, c), (4 * m, c)) + tuple(MLP_TIMED.values()):
        got = time_mlp(rows, mc, 4 * mc)
        for name, ms in got.items():
            key = name if (rows, mc) == (m, c) else \
                (name, rows) if mc == c else (name, f"C={mc}")
            times[key] = ms
    bops, bg, joint = block_operands(b, n, heads, torch.bfloat16, seed=52,
                                     hot=False)
    xn, tok, wqkv, bqkv, wproj, bproj = bops
    kw = dict(num_heads=heads, scale=64 ** -0.5, clamp_softmax=True)

    def unfused():
        o, _, _ = ka.masked_attention_fused(F.linear(xn, wqkv, bqkv), bg,
                                            joint, **kw)
        return tok + F.linear(o, wproj, bproj)
    fns = {"tensor-core": lambda: _block_design(
        "tensor-core", ka.attention_block_fused, *bops, bg, joint, **kw)}
    fns["plain"] = lambda: ka.attention_block_fused_plain(*bops, bg, joint,
                                                          **kw)
    fns["unfused"] = unfused
    ms = round_robin(fns, iters=5)
    times["attention_block_fused"] = (ms["tensor-core"], ms["plain"],
                                      ms["unfused"])
    say(f"time attention_block_fused bf16 rollout B={b} N={n}, in turns: "
        f"tensor-core {ms['tensor-core']:.4f} ms, "
        f"plain {ms['plain']:.4f} ms; unfused qkv GEMM, "
        f"attention kernel, proj GEMM, add {ms['unfused']:.4f} ms")
    del bops, bg, joint
    for dh, shape in BLOCK_TIMED.items():
        times[("attention_block_fused", dh)] = time_block_streamed(*shape, dh)
    return times


def time_block_streamed(b, n, heads, dh):
    """The block kernel's streamed design (bf16 rollout, clamp on, as the
    bf16 serving path launches it) at B, N, heads of ``dh``, its plain
    version and the unfused route (the qkv GEMM, kernel 1, the proj GEMM,
    the residual add), in turns.  Returns (kernel ms, plain ms, unfused
    ms)."""
    import torch.nn.functional as F
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    bops, bg, joint = block_operands(b, n, heads, torch.bfloat16, seed=53,
                                     hot=False, dh=dh)
    xn, tok, wqkv, bqkv, wproj, bproj = bops
    kw = dict(num_heads=heads, scale=dh ** -0.5, clamp_softmax=True)
    if ka.block_design(torch.bfloat16, n, heads * dh, dh) != "streamed":
        raise AssertionError(f"B={b} N={n}: not the streamed design")
    qb = ka.block_rows(torch.bfloat16, n, heads * dh, dh)

    def unfused():
        o, _, _ = ka.masked_attention_fused(F.linear(xn, wqkv, bqkv), bg,
                                            joint, **kw)
        return tok + F.linear(o, wproj, bproj)
    ms = round_robin({
        "streamed": lambda: ka.attention_block_fused(*bops, bg, joint, **kw),
        "plain": lambda: ka.attention_block_fused_plain(*bops, bg, joint,
                                                        **kw),
        "unfused": unfused}, iters=5)
    say(f"time attention_block_fused streamed bf16 rollout B={b} N={n} "
        f"{heads} heads of {dh} ({qb} query rows a block), in turns: "
        f"streamed {ms['streamed']:.4f} ms, "
        f"plain {ms['plain']:.4f} ms; unfused qkv GEMM, attention kernel, "
        f"proj GEMM, add {ms['unfused']:.4f} ms")
    del bops, bg, joint
    gc_cuda()
    return ms["streamed"], ms["plain"], ms["unfused"]


def reset_counts():
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    from vision_transformer_cam_tpu_torch.kernels import gemm
    from vision_transformer_cam_tpu_torch.scripts import attn_variants as av
    ka.launches = 0
    ka.width_launches = {dh: 0 for dh in ka.FWD_HEAD_DIMS}
    ka.bwd_launches = 0
    ka.bwd_width_launches = {dh: 0 for dh in ka.BWD_HEAD_DIMS}
    ka.block_launches = 0
    ka.block_streamed_launches = {dh: 0 for dh in ka.BLOCK_HEAD_DIMS}
    ka.seq_launches = 0
    ka.seq_width_launches = {dh: 0 for dh in ka.SEQ_HEAD_DIMS}
    ka.v1_launches = 0
    ka.v1_width_launches = {dh: 0 for dh in ka.V1_HEAD_DIMS}
    for variant in av.launches:
        av.launches[variant] = 0
    gemm.linear_int8_launches = 0
    gemm.ln_quant_launches = 0
    gemm.mlp_fused_launches = 0
    gemm.mlp_fused_int8_launches = 0


def read_counts():
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    from vision_transformer_cam_tpu_torch.kernels import gemm
    return {"masked_attention_fused": ka.launches,
            "linear_int8_fused": gemm.linear_int8_launches,
            "ln_quant": gemm.ln_quant_launches,
            "masked_attention_bwd": ka.bwd_launches,
            "mlp_fused": gemm.mlp_fused_launches,
            "mlp_fused_int8": gemm.mlp_fused_int8_launches,
            # the cluster design's; the streamed design's under BLOCK_W
            "attention_block_fused": ka.block_launches - sum(
                ka.block_streamed_launches.values()),
            **{BLOCK_W[dh]: ka.block_streamed_launches[dh] for dh in BLOCK_W},
            **{BLOCK_NW[dh]: ka.block_streamed_launches[dh]
               for dh in NEW_WIDTHS},
            "masked_attention_seq_local": ka.seq_launches,
            W80: ka.width_launches[80],
            BWD80: ka.bwd_width_launches[80],
            **{FWD_W[dh]: ka.width_launches[dh] for dh in NEW_WIDTHS},
            **{BWD_W[dh]: ka.bwd_width_launches[dh] for dh in NEW_WIDTHS},
            **{SEQ_W[dh]: ka.seq_width_launches[dh] for dh in SEQ_WIDTHS}}


def read_new_counts():
    """The launch counts of the split-tensor kernel and of the ablation
    variants, which no serving or training path runs."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    from vision_transformer_cam_tpu_torch.scripts import attn_variants as av
    return {"masked_attention": ka.v1_launches,
            **{f"attn_variants[{v}]": n for v, n in av.launches.items()}}


def serve(model, reqs, per_forward, label):
    """The requests through ``model`` with the rollout CAM; the launch
    counts are set to 0 before and read after, and must be ``per_forward``
    (a kernel it does not name: 0) times the number of requests."""
    from vision_transformer_cam_tpu_torch.ops.rollout import (
        cam_from_rollout_row)
    g = model.cfg.grid_size
    reset_counts()
    t0 = time.perf_counter()
    outs = []
    for x in reqs:
        out = model(x, need_rollout=True)
        outs.append((out, cam_from_rollout_row(out.rollout_row, g)))
    torch.cuda.synchronize()
    counts = read_counts()
    want = {k: per_forward.get(k, 0) * len(reqs) for k in counts}
    say(f"main path {label}: {len(reqs)} requests x {reqs[0].shape[0]} images "
        f"in {time.perf_counter() - t0:.3f} s (first includes warm-up), "
        f"launches {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts}, expected "
                             f"{want}")
    b = reqs[0].shape[0]
    for out, cam in outs:
        if tuple(cam.shape) != (b, g, g) or not torch.isfinite(cam).all():
            raise AssertionError(f"{label}: CAM {tuple(cam.shape)} not finite "
                                 f"[{b},{g},{g}]")
        if not torch.all(cam.amax(dim=(1, 2)) == 1.0):
            raise AssertionError(f"{label}: CAM max is not 1.0 for every "
                                 "image")
        if not torch.isfinite(out.logits.float()).all():
            raise AssertionError(f"{label}: logits not finite")
    return outs, counts


def deviation(outs, refs):
    """(CAM max abs dev, logits max abs dev, mean top-16 overlap)."""
    d_cam = d_logit = 0.0
    overlap = []
    for (out, cam), (ref, ref_cam) in zip(outs, refs):
        d_cam = max(d_cam, float((cam - ref_cam).abs().max()))
        d_logit = max(d_logit, float(
            (out.logits.float() - ref.logits.float()).abs().max()))
        for a, b_ in zip(out.top_patch_idx.tolist(),
                         ref.top_patch_idx.tolist()):
            overlap.append(len(set(a) & set(b_)) / len(a))
    return d_cam, d_logit, float(np.mean(overlap))


def whole_path_check(qm, mode, g, cases=WHOLE_CASES):
    """The quantized model on the card (kernels) against the same model
    on the CPU (plain versions), on ``cases`` ((batch, numpy seed of the
    images)); every case is printed before any failure raises."""
    from vision_transformer_cam_tpu_torch.ops.rollout import (
        cam_from_rollout_row)
    cpu = copy.deepcopy(qm).cpu()
    size = qm.cfg.img_size
    bad = []
    for b, seed in cases:
        xs = np.random.default_rng(seed).standard_normal(
            (b, size, size, 3), dtype=np.float32)
        got = qm(torch.from_numpy(xs).cuda(), need_rollout=True)
        ref = cpu(torch.from_numpy(xs), need_rollout=True)
        dc = float((cam_from_rollout_row(got.rollout_row, g).cpu()
                    - cam_from_rollout_row(ref.rollout_row, g)).abs().max())
        gl, rl = got.logits.float().cpu(), ref.logits.float()
        dl = float((gl - rl).abs().max())
        rel = float(((gl - rl).norm(dim=-1) / rl.norm(dim=-1)).max())
        say(f"{mode} card vs CPU plain versions (B={b}, images seed {seed}): "
            f"CAM max abs dev {dc:.3e} (tol {WHOLE_TOL['cam']}), logits max "
            f"abs dev {dl:.3e} (tol {WHOLE_TOL['logits']}; max |logits| "
            f"{float(rl.abs().max()):.3f}, worst per-image relative L2 "
            f"{rel:.3e})")
        if not (dc <= WHOLE_TOL["cam"] and dl <= WHOLE_TOL["logits"]):
            bad.append((b, seed))
    if bad:
        raise AssertionError(f"{mode}: the card disagrees with the plain "
                             f"versions on (B, seed) {bad}")


def main_path(batch=32, requests=3, bench_batch=256):
    from vision_transformer_cam_tpu_torch import configs, serving
    from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
    from vision_transformer_cam_tpu_torch.ops.rollout import (
        cam_from_rollout_row)

    cfg = configs.vit_base_patch16_224_in21k(num_classes=20).replace(
        representation_size=None)

    def new_model():
        return ViTCAM(cfg, device="cuda",
                      generator=torch.Generator().manual_seed(0))

    model = new_model()
    rng = np.random.default_rng(0)

    def images(b):
        return torch.from_numpy(rng.standard_normal(
            (b, cfg.img_size, cfg.img_size, 3), dtype=np.float32)).cuda()

    # float32, small batch: the kernel path against the eager path at the
    # CPU tests' tolerances (rollout row 1e-5, logits 2e-4)
    x = images(4)
    model.cfg = cfg.replace(attn_impl="kernel")
    got = model(x, need_rollout=True)
    model.cfg = cfg
    want = model(x, need_rollout=True)
    d_roll = float((got.rollout_row - want.rollout_row).abs().max())
    d_logit = float((got.logits - want.logits).abs().max())
    say(f"f32 kernel vs eager (B=4): rollout row {d_roll:.3e} (tol 1e-5), "
        f"logits {d_logit:.3e} (tol 2e-4)")
    if not (d_roll <= 1e-5 and d_logit <= 2e-4):
        raise AssertionError("f32 kernel path disagrees with the eager path")
    # the same with both serving fusions on: every block through the block
    # kernel and the fused MLP kernel, at float32
    model.cfg = cfg.replace(attn_impl="kernel", mlp_fusion=True,
                            attn_block_fusion=True)
    reset_counts()
    got = model(x, need_rollout=True)
    model.cfg = cfg
    counts = read_counts()
    d_roll = float((got.rollout_row - want.rollout_row).abs().max())
    d_logit = float((got.logits - want.logits).abs().max())
    say(f"f32 fused kernel path vs eager (B=4): rollout row {d_roll:.3e} (tol "
        f"1e-5), logits {d_logit:.3e} (tol 2e-4); launches {counts}")
    if not (d_roll <= 1e-5 and d_logit <= 2e-4) or \
            (counts["attention_block_fused"], counts["mlp_fused"],
             counts["masked_attention_fused"]) != (cfg.depth, cfg.depth, 0):
        raise AssertionError("f32 fused kernel path disagrees with the eager "
                             "path, or did not run its kernels")

    serving.apply_serving_mode(model, "bf16")
    kcfg = model.cfg
    g = cfg.grid_size
    reqs = [images(batch) for _ in range(requests)]
    totals = {}
    outs_bf16, counts = serve(model, reqs, {"masked_attention_fused":
                                            cfg.depth, "linear_int8_fused": 0,
                                            "ln_quant": 0,
                                            "masked_attention_bwd": 0},
                              "bf16")
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v
    totals["masked_attention_fused[bf16 rollout, serving]"] = \
        counts["masked_attention_fused"]

    # the same model on the eager attention path
    model.cfg = kcfg.replace(attn_impl="eager")
    refs = []
    for x in reqs:
        ref = model(x, need_rollout=True)
        refs.append((ref, cam_from_rollout_row(ref.rollout_row, g)))
    model.cfg = kcfg
    d_cam, d_logit, ov = deviation(outs_bf16, refs)
    say(f"bf16 kernel vs eager: CAM max abs dev {d_cam:.3e} (tol 5e-2), "
        f"logits max abs dev {d_logit:.3e} (tol 5e-2), top-16 overlap "
        f"{ov:.4f}")
    if not (d_cam <= 5e-2 and d_logit <= 5e-2):
        raise AssertionError("bf16 kernel path disagrees with the eager path")

    # the bf16 fused path: the block kernel and the fused MLP kernel on every
    # layer, against the bf16 kernel path
    fused = dict(mlp_fusion=True, attn_block_fusion=True)
    model.cfg = kcfg.replace(**fused)
    outs, counts = serve(model, reqs, {"attention_block_fused": cfg.depth,
                                       "mlp_fused": cfg.depth}, "bf16 fused")
    model.cfg = kcfg
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v
    d_cam, d_logit, ov = deviation(outs, outs_bf16)
    say(f"bf16 fused vs bf16 kernel path: CAM max abs dev {d_cam:.3e} (tol "
        f"5e-2), logits max abs dev {d_logit:.3e} (tol 5e-2), top-16 overlap "
        f"{ov:.4f}")
    if not (d_cam <= 5e-2 and d_logit <= 5e-2):
        raise AssertionError("bf16 fused path disagrees with the bf16 kernel "
                             "path")

    # int8 serving, calibrated on 16 seeded images, with the fused LN ->
    # int8 and the fused-quantize GEMM route on
    calib = np.random.default_rng(1).standard_normal(
        (16, cfg.img_size, cfg.img_size, 3), dtype=np.float32)
    served = {"bf16": (model, kcfg),
              "eager": (model, kcfg.replace(attn_impl="eager")),
              "bf16_fused": (model, kcfg.replace(**fused))}
    for mode in ("int8", "int8_hifi"):
        qm = serving.apply_serving_mode(new_model(), mode,
                                        calib_images=calib)
        qm.cfg = qm.cfg.replace(ln_quant_fusion=True, int8_fused_gemm=True)
        per_fwd = {"masked_attention_fused": cfg.depth,
                   "linear_int8_fused": 1 + 4 * cfg.depth,
                   "ln_quant": (2 if mode == "int8" else 1) * cfg.depth,
                   "masked_attention_bwd": 0}
        outs, counts = serve(qm, reqs, per_fwd, mode)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        whole_path_check(qm, mode, g)
        d_cam, d_logit, ov = deviation(outs, outs_bf16)
        say(f"{mode} vs bf16 kernel path (recorded, not gated): CAM max abs "
            f"dev {d_cam:.3e}, logits max abs dev {d_logit:.3e}, top-16 "
            f"overlap {ov:.4f}")
        served[mode] = (qm, qm.cfg)
        if mode != "int8":
            continue
        # the int8 fused path: the same model with mlp_fusion on (and
        # attn_block_fusion, which a quantized qkv layer falls through): the
        # fused int8 MLP kernel replaces fc1, fc2 and the second ln_quant
        qm.cfg = qm.cfg.replace(**fused)
        outs_f, counts = serve(
            qm, reqs, {"masked_attention_fused": cfg.depth,
                       "linear_int8_fused": 1 + 2 * cfg.depth,
                       "ln_quant": cfg.depth, "mlp_fused_int8": cfg.depth},
            "int8 fused")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        whole_path_check(qm, "int8 fused", g)
        d_cam, d_logit, ov = deviation(outs_f, outs)
        say(f"int8 fused vs int8 (recorded, not gated): CAM max abs dev "
            f"{d_cam:.3e}, logits max abs dev {d_logit:.3e}, top-16 overlap "
            f"{ov:.4f}")
        served["int8_fused"] = (qm, qm.cfg)
        qm.cfg = served["int8"][1]

    # throughput at batch 256, in turns; "eager" is the bf16 model on the
    # eager attention path
    xb = images(bench_batch)

    def rate(mode, iters=5):
        m, mcfg = served[mode]
        m.cfg = mcfg
        for _ in range(2):
            cam_from_rollout_row(m(xb, need_rollout=True).rollout_row, g)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            cam_from_rollout_row(m(xb, need_rollout=True).rollout_row, g)
        torch.cuda.synchronize()
        return bench_batch * iters / (time.perf_counter() - t)
    order = ("bf16", "eager", "int8", "int8_hifi", "bf16_fused", "int8_fused",
             "int8_fused", "bf16_fused", "int8_hifi", "int8", "eager", "bf16")
    rates = {}
    for mode in order:
        rates.setdefault(mode, []).append(rate(mode))
    model.cfg = kcfg
    for mode, r in rates.items():
        say(f"{mode} CAM throughput, batch {bench_batch}: "
            f"{np.mean(r):.1f} img/s ({r[0]:.1f}, {r[1]:.1f})")
    return totals


def bound(name, nbytes, ops):
    """(bound ms, "bytes" or "operations"): the least time the card could
    take, the largest of the bytes over the memory rate and, for each type,
    its operations ({type: count}) over the peak rate of that type (the
    types' units may run side by side).  Prints every term."""
    t_bytes = 1e3 * nbytes / PEAK["bytes"]
    t_ops = {kind: 1e3 * n / PEAK[kind] for kind, n in ops.items()}
    say(f"bound {name}: {nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms; "
        + ", ".join(f"{n / 1e9:.2f} G{kind} operations -> {t_ops[kind]:.4f} "
                    f"ms" for kind, n in ops.items()))
    worst = max(t_ops.values())
    return max(t_bytes, worst), "bytes" if t_bytes >= worst else "operations"


def ln_quant_bound(m, c):
    """ln_quant's bound on [m, c]: bf16 rows and the two affine vectors in,
    int8 rows out."""
    return bound(f"ln_quant [{m}, {c}]", m * c * 2 + 2 * c * 2 + m * c,
                 {"f32": 8 * m * c})


def mlp_bound(m, c, hid, dtype):
    """The fused MLP's bound on [m, c] rows: bf16 x in and out; bf16
    weights and biases and two products at the bf16 rate, or (dtype
    torch.int8) int8 weights, float32 scale and bias vectors and the two
    inverse act scales and the products at the int8 rate."""
    if dtype == torch.int8:
        return bound(f"mlp_fused_int8 M={m}", 2 * m * c * 2 + 2 * c * hid
                     + 2 * (hid + c) * 4 + 8, {"int8": 4 * m * c * hid})
    return bound(f"mlp_fused bf16 M={m}", 2 * m * c * 2 + 2 * c * hid * 2
                 + (hid + c) * 2, {"bf16": 4 * m * c * hid})


def block_bound(b, n, heads, dh):
    """The block kernel's bound, bf16 rollout: bf16 xn and tokens, the qkv
    and proj weights and biases, f32 bg and the f32 joint in; bf16 tokens
    and cls row and the f32 joint out.  The qkv and proj GEMMs, QK^T and PV
    at the bf16 rate, hm @ J f32 (the streamed design's K / V scratch is
    not the function's: not counted)."""
    c, m = heads * dh, b * n
    qk = 2 * b * heads * n * n * dh          # one of the attention products
    return bound(f"attention_block_fused bf16 rollout B={b} N={n} C={c}",
                 3 * m * c * 2 + 4 * c * c * 2 + 4 * c * 2 + m * 4
                 + 2 * b * n * n * 4 + m * 2,
                 {"bf16": 2 * m * c * 4 * c + 2 * qk, "f32": 2 * b * n ** 3})


def kernel_bounds(b=64, n=197, heads=12):
    """Bounds of the kernels at the shapes ``time_kernels`` and
    ``time_attention_bwd`` time them at (each input read once, each output
    written once)."""
    c, m = heads * 64, b * n
    qk = 2 * b * heads * n * n * 64          # one of the attention products
    bounds = {
        # the training path's forward: bf16 qkv and bg in, bf16 out and cls row
        "masked_attention_fused[bf16 plain, training]": bound(
            "masked_attention_fused bf16 plain (the training forward)",
            m * 3 * c * 2 + m * 2 + m * c * 2 + m * 2, {"bf16": 2 * qk}),
        # int8_io rollout variant: int8 qkv, f32 bg, the scales and the f32
        # joint in; int8 out, bf16 cls row and the f32 joint out.  QK^T on
        # int8, PV in bf16, the rollout product hm @ J in f32
        "masked_attention_fused": bound(
            "masked_attention_fused int8_io rollout",
            m * 3 * c + m * 4 + (3 * heads + 1) * 4 + 2 * b * n * n * 4
            + m * c + m * 2,
            {"int8": qk, "bf16": qk, "f32": 2 * b * n ** 3}),
        "ln_quant": ln_quant_bound(m, c),
        # bf16 qkv, dO and f32 bg in, bf16 d_qkv out; five products
        "masked_attention_bwd": bound("masked_attention_bwd bf16",
                                      7 * m * c * 2 + m * 4,
                                      {"bf16": 5 * qk}),
        # the backward at ViT-H/14's and ViT-L/16@512's training shapes, as
        # time_attention_bwd times it
        BWD80: bwd_bound(*BWD_TIMED[2]),
        BWD1025: bwd_bound(*BWD_TIMED[3]),
    }
    # the other variants time_kernels times (row 1 of the kernel table):
    # bf16 head mean (bf16 hm out), the float32 variants (float32 in and out,
    # products at the f32 peak of the FMA design), int8_out rollout (bf16 qkv
    # in, int8 out); and the int8 rollout variants at ViT-L/16@384's N = 577
    f32_ops = {"f32": 2 * qk}
    for name, nbytes, ops in (
            ("bf16 headmean", m * 3 * c * 2 + m * 2 + m * c * 2 + m * 2
             + b * n * n * 2, {"bf16": 2 * qk}),
            ("f32 plain", m * 3 * c * 4 + m * 4 + m * c * 4 + m * 4, f32_ops),
            ("f32 headmean", m * 3 * c * 4 + m * 4 + m * c * 4 + m * 4
             + b * n * n * 4, f32_ops),
            ("f32 rollout", m * 3 * c * 4 + m * 4 + 2 * b * n * n * 4
             + m * c * 4 + m * 4, {"f32": 2 * qk + 2 * b * n ** 3}),
            ("int8_out rollout", m * 3 * c * 2 + m * 2 + 4
             + 2 * b * n * n * 4 + m * c + m * 2,
             {"bf16": 2 * qk, "f32": 2 * b * n ** 3})):
        bounds[f"masked_attention_fused[{name}]"] = bound(
            f"masked_attention_fused {name}", nbytes, ops)
    lb, ln, lh = 16, 577, 16
    lm, lc, lqk = lb * ln, lh * 64, 2 * lb * lh * ln * ln * 64
    bounds["masked_attention_fused[int8_io rollout, N=577]"] = bound(
        "masked_attention_fused int8_io rollout B=16 N=577 H=16",
        lm * 3 * lc + lm * 4 + (3 * lh + 1) * 4 + 2 * lb * ln * ln * 4
        + lm * lc + lm * 2,
        {"int8": lqk, "bf16": lqk, "f32": 2 * lb * ln ** 3})
    bounds["masked_attention_fused[int8_out rollout, N=577]"] = bound(
        "masked_attention_fused int8_out rollout B=16 N=577 H=16",
        lm * 3 * lc * 2 + lm * 2 + 4 + 2 * lb * ln * ln * 4 + lm * lc
        + lm * 2, {"bf16": 2 * lqk, "f32": 2 * lb * ln ** 3})
    # kernel 1 at head width 80 as time_attention_w80 times it (ViT-H/14's
    # bf16 serving launch: B=64, N=257, 16 heads of 80)
    bounds[W80] = attention_bound(64, 257, 16, 80, "bf16")
    hid = 4 * c
    bounds.update({
        # the bf16 serving path's launch: bf16 qkv and bg and the f32 joint
        # in; bf16 out and cls row and the f32 joint out
        "masked_attention_fused[bf16 rollout, serving]": bound(
            "masked_attention_fused bf16 rollout (the bf16 serving path)",
            m * 3 * c * 2 + m * 2 + 2 * b * n * n * 4 + m * c * 2 + m * 2,
            {"bf16": 2 * qk, "f32": 2 * b * n ** 3}),
        "mlp_fused": mlp_bound(m, c, hid, torch.bfloat16),
        "mlp_fused_int8": mlp_bound(m, c, hid, torch.int8),
        # at the wide widths as time_mlp times them (MLP_TIMED): the
        # function's 4 M C HID operations (the kernel computes fc1 once per
        # column group, 1.5x that)
        **{MLP_W[wc]: mlp_bound(*MLP_TIMED[wc], 4 * wc, torch.bfloat16)
           for wc in MLP_W},
        **{MLP8_W[wc]: mlp_bound(*MLP_TIMED[wc], 4 * wc, torch.int8)
           for wc in MLP8_W},
        # the block kernel at ViT-B/16's shape, and its streamed design at
        # the shapes time_block_streamed times
        "attention_block_fused": block_bound(b, n, heads, 64),
        **{BLOCK_W[dh]: block_bound(*BLOCK_TIMED[dh], dh) for dh in BLOCK_W},
    })
    # the five GEMMs as the int8 path calls them: x (bf16 for the patch
    # embed, else int8), the int8 weight, float32 scale and bias vectors;
    # out bf16, or int8 after a requant / GELU-requant epilogue
    total, kinds = 0.0, set()
    for shape, (k, n_out) in GEMM_SHAPES.items():
        x_size = 2 if shape == "patch" else 1
        out_size = 1 if shape in ("qkv", "fc1") else 2
        t, kind = bound(f"linear_int8 {shape}",
                        m * k * x_size + n_out * k + 3 * n_out * 4
                        + m * n_out * out_size, {"int8": 2 * m * k * n_out})
        total += t
        kinds.add(kind)
    bounds["linear_int8_fused"] = (total, kinds.pop() if len(kinds) == 1
                                   else "operations")
    # the sequence-parallel kernel as time_attention_seq times it on one
    # rank (ViT-L/16@384: B=16, NQ = Np = 577, C=1024, 16 heads): bf16 q and
    # K | V and the two f32 bg rows in; bf16 out and row0 and the f32 head
    # mean [B, NQ, Np] out; both products at the bf16 rate
    sb, sn, sc, sh = 16, 577, 1024, 16
    bounds["masked_attention_seq_local"] = bound(
        "masked_attention_seq_local bf16, f32 head mean",
        sb * sn * sc * 2 + sb * sn * 2 * sc * 2 + 2 * sb * sn * 4
        + sb * sn * sc * 2 + sb * sn * 2 + sb * sn * sn * 4,
        {"bf16": 4 * sb * sh * sn * sn * 64})
    # the split-tensor kernel as time_attention_v1 times it (no head mean):
    # bf16 q, k, v and the f32 bg in, bf16 out and cls row out
    bounds["masked_attention"] = bound(
        "masked_attention (v1) bf16", 4 * m * c * 2 + m * 4 + m * 2,
        {"bf16": 2 * qk})
    # the ablation kernels at the script's shape (B=512): bf16 qkv, f32 bg
    # and joint in; bf16 out and cls row and the f32 joint out; a product in
    # its int8 form counts at the int8 rate
    vb = 512
    vm, vqk = vb * n, 2 * vb * heads * n * n * 64
    nbytes = vm * 3 * c * 2 + vm * 4 + 2 * vb * n * n * 4 + vm * c * 2 + vm * 2
    hmj = {"f32": 2 * vb * n ** 3}
    for variant, ops in (("int8qk", {"int8": vqk, "bf16": vqk}),
                         ("int8pv", {"int8": vqk, "bf16": vqk}),
                         ("int8both", {"int8": 2 * vqk})):
        bounds[f"attn_variants[{variant}]"] = bound(
            f"attn_variants {variant} B={vb}", nbytes, dict(ops, **hmj))
    for variant in ("full", "noexp", "matmul-only", "nomask", "headbatch"):
        bounds[f"attn_variants[{variant}]"] = bound(
            f"attn_variants {variant} B={vb}", nbytes,
            dict({"bf16": 2 * vqk}, **hmj))
    return bounds


class MemoryLoader:
    """An in-memory loader of seeded batches (numpy image / label arrays),
    standing in for ``data.loader.BatchLoader``."""

    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def seeded_batch(b, seed, size=224, classes=20):
    """Images ~N(0, 1) and multi-hot labels (about 10 % on, at least one per
    image) from a numpy seed."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, size, size, 3), dtype=np.float32)
    y = (rng.random((b, classes)) < 0.1).astype(np.float32)
    y[np.arange(b), rng.integers(0, classes, b)] = 1.0
    return {"image": x, "label": y}


def train_model(impl, dtype=torch.bfloat16, remat=True):
    """ViT-B/16 (the VOC head) with float32 masters and ``dtype`` compute,
    weights from torch.Generator seed 0."""
    from vision_transformer_cam_tpu_torch import configs
    from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
    cfg = configs.vit_base_patch16_224_in21k(num_classes=20).replace(
        representation_size=None, dtype=dtype, attn_impl=impl, remat=remat)
    return ViTCAM(cfg, device="cuda",
                  generator=torch.Generator().manual_seed(0))


def _cuda(batch):
    return (torch.from_numpy(batch["image"]).cuda(),
            torch.from_numpy(batch["label"]).cuda())


def _expect_counts(label, fwd, bwd):
    counts = read_counts()
    say(f"train path {label}: launches forward kernel "
        f"{counts['masked_attention_fused']} (expected {fwd}), backward "
        f"kernel {counts['masked_attention_bwd']} (expected {bwd})")
    if (counts["masked_attention_fused"], counts["masked_attention_bwd"]) \
            != (fwd, bwd) or any(
                v for k, v in counts.items() if k not in
                ("masked_attention_fused", "masked_attention_bwd")):
        raise AssertionError(f"{label}: launch counts {counts}")
    return counts


def train_path(batch=64):
    """The training path at full width and depth: mixed precision (float32
    masters, bf16 compute), attn_impl="kernel", remat on.  Returns the launch
    counts of the whole path."""
    import math
    from vision_transformer_cam_tpu_torch import configs
    from vision_transformer_cam_tpu_torch.train import loop, state as statelib
    from vision_transformer_cam_tpu_torch.train import step as steplib

    # no warm-up, so that the first steps move the loss; 5 steps per epoch
    ocfg = configs.OptimConfig(lr=1e-4, warmup_epochs=0, epochs=10,
                               linear_lr_scaling=False, clip_grad=1.0)
    spe = 5
    model = train_model("kernel")
    depth = model.cfg.depth
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt, schedule = statelib.make_optimizer(model, ocfg, batch, spe)
    state = statelib.create_train_state(model, opt)
    loader = MemoryLoader([seeded_batch(batch, 100 + i) for i in range(spe)])
    totals = {}

    def phase(label, steps_fwd, steps_bwd):
        for k, v in _expect_counts(label, steps_fwd * depth,
                                   steps_bwd * depth).items():
            totals[k] = totals.get(k, 0) + v
        reset_counts()

    reset_counts()
    t0 = time.perf_counter()
    state, means = loop.train_one_epoch(state, loader, 0, 0, log_every=1)
    torch.cuda.synchronize()
    say(f"train path: one epoch of {spe} steps x {batch} images in "
        f"{time.perf_counter() - t0:.2f} s (first includes warm-up); mean "
        f"loss {means['loss']:.4f}, f1 {means['f1']:.4f}")
    # per step with remat: the forward kernel runs in the forward and again
    # in the recompute, the backward kernel once, per layer
    phase("train_one_epoch", 2 * spe, spe)
    if state.step != spe or not math.isfinite(means["loss"]):
        raise AssertionError(f"epoch: step {state.step}, loss {means}")

    x, y = _cuda(seeded_batch(batch, 7))
    losses = []
    for _ in range(5):
        state, metrics = steplib.train_step(state, x, y, 0)
        losses.append(float(metrics["loss"]))
    say(f"train path: 5 steps on one fixed batch, losses "
        + ", ".join(f"{v:.4f}" for v in losses))
    phase("5 x train_step", 10, 5)
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")

    state, metrics = steplib.train_step_accum(state, x, y, 0, accum_steps=2)
    say(f"train path: train_step_accum (2 microbatches) loss "
        f"{float(metrics['loss']):.4f}")
    phase("train_step_accum", 4, 2)
    if not math.isfinite(float(metrics["loss"])):
        raise AssertionError("train_step_accum: loss not finite")

    # step count and learning rate: 11 steps taken, 5 per epoch, so the next
    # step is in epoch 2 of 10 on the cosine
    want_lr = ocfg.min_lr + 0.5 * (ocfg.lr - ocfg.min_lr) * (
        1.0 + math.cos(math.pi * 2 / 10))
    say(f"train path: step {state.step}, optimizer count {opt.count}, lr "
        f"{schedule(state.step):.6e} (expected {want_lr:.6e}); epoch 0 lr "
        f"{schedule(0):.6e}")
    if (state.step, opt.count) != (11, 11) or schedule(0) != ocfg.lr \
            or abs(schedule(state.step) - want_lr) > 1e-12:
        raise AssertionError("step count or learning rate off the schedule")

    res = loop.evaluate(model, MemoryLoader(
        [seeded_batch(batch, 200), seeded_batch(batch // 2, 201)]))
    say(f"train path: evaluate {res}")
    phase("evaluate", 2, 0)
    if res["n_samples"] != batch + batch // 2 or not all(
            0.0 <= res[k] <= 1.0 for k in ("mAP_196patch", "mAP_16patch")):
        raise AssertionError(f"evaluate: {res}")

    stuck = [k for k, v in model.state_dict().items()
             if torch.equal(v, before[k])]
    if stuck:
        raise AssertionError(f"parameters that did not move: {stuck}")
    del state, opt, model

    # freeze_backbone: only the heads move
    model = train_model("kernel")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    mask = statelib.trainable_mask(model, True)
    opt, _ = statelib.make_optimizer(model, ocfg, batch, spe,
                                     freeze_mask=mask)
    state = statelib.create_train_state(model, opt)
    for _ in range(2):
        state, metrics = steplib.train_step(state, x, y, 0)
    phase("2 x train_step, frozen backbone", 4, 2)
    after = model.state_dict()
    moved = {k for k in after if not torch.equal(after[k], before[k])}
    heads = {k for k, t in mask.items() if t}
    say(f"train path, freeze_backbone: moved {sorted(moved)}")
    if moved != heads or not math.isfinite(float(metrics["loss"])):
        raise AssertionError(f"freeze: moved {sorted(moved)}, trainable "
                             f"{sorted(heads)}")
    return totals


# kernel path vs eager path, one float32 step from the same state, batch 8:
# the two sum in another order through 12 layers and their backward; the CPU
# tests hold the same pair to atol 2e-5 on gradients at a tiny width, and the
# full width adds the rtol
TRAIN_TOL = {"loss": 1e-5, "grad": (2e-5, 1e-3)}


def train_kernel_vs_eager(batch=8):
    x, y = _cuda(seeded_batch(batch, 9))
    kernel_vs_eager_step(lambda impl: train_model(impl, dtype=torch.float32),
                         x, y, "ViT-B/16")


def kernel_vs_eager_step(build, x, y, label, tol=TRAIN_TOL):
    """One float32 step's loss and every gradient from ``build("kernel")``
    against ``build("eager")`` (the same seeded weights), held to ``tol``.
    Returns (loss difference, worst gradient error)."""
    from vision_transformer_cam_tpu_torch.train import step as steplib
    got = {}
    for impl in ("kernel", "eager"):
        model = build(impl)
        loss, _ = steplib.loss_fn(model, x, y, None)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        got[impl] = (float(loss.detach()), dict(zip(
            (n for n, _ in model.named_parameters()), grads)))
        del model, loss, grads
    d_loss = abs(got["kernel"][0] - got["eager"][0])
    atol, rtol = tol["grad"]
    worst, bad = 0.0, []
    for name, g in got["kernel"][1].items():
        ref = got["eager"][1][name]
        err = (g - ref).abs()
        worst = max(worst, float(err.max()))
        if float((err - atol - rtol * ref.abs()).max()) > 0 \
                or not torch.isfinite(g).all():
            bad.append(name)
    say(f"f32 train step {label}, kernel vs eager (B={x.shape[0]}): loss "
        f"{got['kernel'][0]:.6f} vs {got['eager'][0]:.6f} (diff {d_loss:.3e}"
        f", tol {tol['loss']}), gradients max abs err {worst:.3e} "
        f"(atol {atol}, rtol {rtol})")
    if d_loss > tol["loss"] or bad:
        raise AssertionError(f"{label}: kernel and eager train steps "
                             f"disagree: loss diff {d_loss:.3e}, gradients "
                             f"of {bad}")
    return d_loss, worst


def train_throughput(batch=64, steps=20, build=train_model, label="ViT-B/16",
                     size=224):
    """img/s of the training step, kernel and eager attention path, mixed
    precision, remat on, in turns; host clock around synchronised steps.
    Each reading also records the device memory a step takes above the two
    resident train states (peak less the allocation before it).  Returns
    {path: (mean img/s, peak GiB of a step)}."""
    from vision_transformer_cam_tpu_torch import configs
    from vision_transformer_cam_tpu_torch.train import state as statelib
    from vision_transformer_cam_tpu_torch.train import step as steplib
    x, y = _cuda(seeded_batch(batch, 11, size=size))
    states = {}
    for impl in ("kernel", "eager"):
        model = build(impl)
        opt, _ = statelib.make_optimizer(model, configs.OptimConfig(), batch,
                                         100)
        states[impl] = statelib.create_train_state(model, opt)

    def rate(impl):
        states[impl], _ = steplib.train_step(states[impl], x, y, 0)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        for _ in range(steps):
            states[impl], _ = steplib.train_step(states[impl], x, y, 0)
        torch.cuda.synchronize()
        r = batch * steps / (time.perf_counter() - t)
        return r, (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    rates, peaks = {}, {}
    for impl in ("kernel", "eager", "eager", "kernel"):
        r, peak = rate(impl)
        rates.setdefault(impl, []).append(r)
        peaks[impl] = max(peaks.get(impl, 0.0), peak)
    resident = torch.cuda.memory_allocated() / 2 ** 30
    for impl, r in rates.items():
        say(f"train throughput {label}, {impl} attention path, batch {batch}"
            f", mixed precision, remat, {steps} steps per reading: "
            f"{np.mean(r):.1f} img/s ({r[0]:.1f}, {r[1]:.1f}; spread "
            f"{100 * abs(r[0] - r[1]) / np.mean(r):.1f} %); a step's peak "
            f"{peaks[impl]:.2f} GiB above the {resident:.2f} GiB of the two "
            f"resident train states")
    del states
    return {impl: (float(np.mean(r)), peaks[impl])
            for impl, r in rates.items()}


# the quality protocol on trained weights (scripts.quality_eval): the TPU
# record's run, ViT-B/16 fine-tuned 600 steps at batch 64 with blocks 0-3
# frozen, scored on 256 held-out images.  The gates catch a broken path, not
# a tuned one: the TPU record reads truth mAP 1.0000, truth mIoU 74.03,
# sabotaged 59.33 (-14.7), every serving mode within 0.22 mIoU of the truth
# and a top-16 overlap of 0.992-0.996.
QUALITY_PARAMS = "build/quality/vit_base_s0_f4_600.pt"
QUALITY_STEPS, QUALITY_FREEZE = 600, 4
QUALITY_GATES = {"truth_map": 0.95, "truth_miou": 50.0, "sabotage_drop": 5.0,
                 "map": 0.02, "miou": 3.0, "top16": 0.95,
                 # the ladder's highest rungs against the float32 CPU
                 # reference: the BASELINE parity class, and the JAX package's
                 # Pallas-vs-XLA tolerance
                 "ladder_cam": 1e-5}


@contextlib.contextmanager
def counted_calls(module, name, log, label=None):
    """Within the block, each call of ``module.name`` appends (``label``, or
    its first argument where that is a string, else ``name``; the launches
    the call made) to ``log``."""
    orig = getattr(module, name)

    def counted(*args, **kw):
        before = read_counts()
        out = orig(*args, **kw)
        after = read_counts()
        tag = label or (args[0] if args and isinstance(args[0], str)
                        else name)
        log.append((tag, {k: after[k] - before[k] for k in after}))
        return out

    setattr(module, name, counted)
    try:
        yield
    finally:
        setattr(module, name, orig)


def _expect(label, want, counts=None, phase="quality path"):
    """The launch counts since the last reset (or ``counts``) must be
    ``want`` (a kernel it does not name: 0); returns them."""
    counts = read_counts() if counts is None else counts
    full = {k: want.get(k, 0) for k in counts}
    say(f"{phase} {label}: launches {counts} (expected {full})")
    if counts != full:
        raise AssertionError(f"{label}: launch counts {counts}, expected "
                             f"{full}")
    return counts


def quality_path():
    """The quality protocol on weights fine-tuned on the card: quality_eval
    (fine-tune, truth, sabotage and the four serving rows), three more rows
    on the same weights and eval set, seg_diagnose on the saved weights, and
    the precision ladder.  Returns the launch counts to add to the kernels
    line, by row name."""
    import math
    from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
    from vision_transformer_cam_tpu_torch.scripts import precision_ladder
    from vision_transformer_cam_tpu_torch.scripts import quality_eval as qe
    from vision_transformer_cam_tpu_torch.scripts import seg_diagnose
    g = QUALITY_GATES
    path = os.path.join(REPO, QUALITY_PARAMS)
    # fine-tune afresh, so that every run trains; compute the ladder's CPU
    # references afresh too
    for f in [path] + [os.path.join(precision_ladder.BUILD, f) for f in (
            os.listdir(precision_ladder.BUILD)
            if os.path.isdir(precision_ladder.BUILD) else ())
            if f.startswith("ladder_ref_")]:
        if os.path.exists(f):
            os.remove(f)
    t = time.perf_counter()
    qe.make_batch(1000, 64)
    say(f"quality path: one batch of 64 drawn on the host in "
        f"{time.perf_counter() - t:.3f} s (quality_eval draws "
        f"{qe.PREFETCH} ahead in threads)")
    t_phase = time.perf_counter()
    # the launches of the fine-tune and of each row, each read around its
    # own call
    calls = []
    reset_counts()
    with counted_calls(qe, "finetune", calls), \
            counted_calls(qe, "eval_mode", calls):
        res = qe.main(["--sabotage", "--steps", str(QUALITY_STEPS),
                       "--freeze", str(QUALITY_FREEZE), "--params", path])
    torch.cuda.synchronize()
    total = read_counts()
    depth = qe.base_config(res["model"]).depth
    fwd_int8 = {"masked_attention_fused": depth,    # 49 int8 GEMMs a forward
                "linear_int8_fused": 1 + 4 * depth}
    want = {"finetune": {"masked_attention_fused": QUALITY_STEPS * 2 * depth,
                         "masked_attention_bwd": QUALITY_STEPS * depth},
            "f32 exact (truth)": {}, "f32 + SABOTAGED bg gate": {},
            "bf16+kernel+tanh+clamp (serving)": {
                "masked_attention_fused": depth},
            "int8_hifi (W8A8, float attn, int8-OUT)": fwd_int8,
            "int8 + attn I/O per-head (default)": fwd_int8,
            "int8 + attn I/O per-tensor (r2)": fwd_int8}
    if [label for label, _ in calls] != list(want):
        raise AssertionError(f"quality_eval calls {[c for c, _ in calls]}")
    for label, counts in calls:
        _expect(label, want[label], counts)
    # nothing launched outside those calls
    _expect("quality_eval", {k: sum(c[k] for _, c in calls) for k in total},
            total)
    parts = dict(calls)
    rows = [c for label, c in calls if label != "finetune"]
    fine = parts["finetune"]
    add = {"masked_attention_fused[bf16 plain, training]":
           fine["masked_attention_fused"],
           "masked_attention_fused[bf16 rollout, serving]":
           parts["bf16+kernel+tanh+clamp (serving)"]["masked_attention_fused"],
           "masked_attention_bwd": fine["masked_attention_bwd"],
           "masked_attention_fused":
           sum(c["masked_attention_fused"] for c in rows),
           "linear_int8_fused": sum(c["linear_int8_fused"] for c in rows)}
    rate = QUALITY_STEPS * 64 / res["finetune_s"]
    say(f"quality path: fine-tune {QUALITY_STEPS} steps x 64 images in "
        f"{res['finetune_s']:.1f} s, {rate:.1f} img/s; quality_eval "
        f"{time.perf_counter() - t_phase:.1f} s in all")

    # b. gates
    losses = [h[1] for h in res["history"]]
    say(f"quality path: printed losses {[round(v, 4) for v in losses]}")
    if len(losses) < 10 or not all(math.isfinite(v) for v in losses) or \
            not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"fine-tune losses: {losses}")
    init = ViTCAM(qe.train_config(res["model"]), device="cpu",
                  generator=torch.Generator().manual_seed(0)).state_dict()
    trained = torch.load(path, map_location="cpu", weights_only=True)

    def block(k):
        return int(k.split(".")[1]) if k.startswith("blocks.") else None
    frozen_moved = [k for k, v in trained.items()
                    if block(k) is not None and block(k) < QUALITY_FREEZE
                    and not torch.equal(v, init[k])]
    stuck = [k for k, v in trained.items()
             if block(k) is not None and block(k) >= QUALITY_FREEZE
             and torch.equal(v, init[k])]
    say(f"quality path: blocks 0-{QUALITY_FREEZE - 1} moved: "
        f"{frozen_moved or 'none'}; blocks {QUALITY_FREEZE}-{depth - 1} "
        f"stuck: {stuck or 'none'}")
    if frozen_moved or stuck:
        raise AssertionError("the freeze mask: frozen parameters moved or "
                             "trained ones stayed")
    truth, bad = res["truth"], res["sabotaged"]
    say(f"quality path: truth mAP_196 {truth['mAP_196patch']:.4f} (gate "
        f">= {g['truth_map']}), mIoU {truth['miou']:.2f} (gate >= "
        f"{g['truth_miou']}); sabotaged mIoU {bad['miou']:.2f} (gate <= "
        f"truth - {g['sabotage_drop']})")
    if not (truth["mAP_196patch"] >= g["truth_map"]
            and truth["miou"] >= g["truth_miou"]
            and bad["miou"] <= truth["miou"] - g["sabotage_drop"]):
        raise AssertionError("the truth row or the sabotage failed its gate")
    failed = []
    for r in res["rows"][1:]:
        ok = (abs(r["mAP_196patch"] - truth["mAP_196patch"]) <= g["map"]
              and abs(r["mAP_16patch"] - truth["mAP_16patch"]) <= g["map"]
              and abs(r["miou"] - truth["miou"]) <= g["miou"]
              and r["top16_overlap"] >= g["top16"])
        if not ok:
            failed.append(r["mode"])
    say(f"quality path: serving rows within mAP {g['map']}, mIoU "
        f"{g['miou']} and a top-16 overlap >= {g['top16']} of the truth; "
        f"failed: {failed or 'none'}")
    if failed:
        for r in res["rows"][1:]:
            say(qe.format_row(r))
        raise AssertionError(f"serving rows off the truth: {failed}")

    # c. more rows on the same weights and eval set (recorded; finite, mAP
    # within the gate)
    m32, images, labels, seg = (res["model_f32"], res["images"], res["labels"],
                                res["seg_gt"])
    base = qe.base_config(res["model"])
    bf = qe.bf16_config(base)
    fused = dict(mlp_fusion=True, attn_block_fusion=True)
    extra = []
    reset_counts()
    extra.append(qe.eval_mode("bf16 fused", qe.with_config(
        m32, bf.replace(**fused)), images, labels, truth, seg))
    for k, v in _expect("bf16 fused", {"attention_block_fused": depth,
                                       "mlp_fused": depth}).items():
        add[k] = add.get(k, 0) + v
    calib, _ = qe.make_batch(777, 16, img=base.img_size)
    _, int8, _ = qe.int8_models(qe.with_config(m32, bf), bf, calib.cuda())
    int8.cfg = int8.cfg.replace(ln_quant_fusion=True, int8_fused_gemm=True,
                                **fused)
    reset_counts()
    extra.append(qe.eval_mode("int8 fused", int8, images, labels, truth, seg))
    for k, v in _expect("int8 fused", {
            "masked_attention_fused": depth,
            "linear_int8_fused": 1 + 2 * depth, "ln_quant": depth,
            "mlp_fused_int8": depth}).items():
        add[k] = add.get(k, 0) + v
    reset_counts()
    extra.append(qe.eval_mode("f32 high (TF32 GEMMs)", qe.with_config(
        m32, qe.truth_config(base).replace(matmul_precision="high")), images,
        labels, truth, seg))
    _expect("f32 high", {})
    say(qe.HEADER)
    for r in [truth, bad] + res["rows"][1:] + extra:
        say(qe.format_row(r))
    bad_extra = [r["mode"] for r in extra if not (
        np.isfinite(r["cam"]).all()
        and abs(r["mAP_196patch"] - truth["mAP_196patch"]) <= g["map"]
        and abs(r["mAP_16patch"] - truth["mAP_16patch"]) <= g["map"])]
    if bad_extra:
        raise AssertionError(f"recorded rows not finite or off the truth's "
                             f"mAP: {bad_extra}")
    del int8, res, m32

    # d. the pseudo-seg chain stage by stage on the saved weights
    diag = seg_diagnose.main(["--load_state", path, "--eval", "64"])
    late = [m[0] for m in diag["masked_frac"][QUALITY_FREEZE:]]
    say(f"quality path: seg_diagnose masked fractions (mean) by block "
        f"{[round(m[0], 3) for m in diag['masked_frac']]}; mIoU "
        f"{diag['miou']:.2f}")
    if not max(late) > 0:
        raise AssertionError("the background mask never engages in blocks "
                             f"{QUALITY_FREEZE}-{depth - 1}")

    # e. the precision ladder (seeded random weights, as the TPU script)
    ladder = {}
    for ref, extra_argv in (("f32", ["--batch", "256"]),
                            ("f64", ["--no-throughput"])):
        reset_counts()
        ladder[ref] = precision_ladder.main(
            ["--dev-batch", "4", "--hybrid", "--ref", ref] + extra_argv)
        for k, v in read_counts().items():
            add[k] = add.get(k, 0) + v
    highest = [r for r in ladder["f32"]
               if r["precision"] == "highest" and "int8" not in r["impl"]]
    worst = max(r["cam_max_dev_vs_f32"] for r in highest)
    say(f"quality path: ladder highest rungs against the float32 CPU "
        f"reference, CAM max dev {worst:.3e} (gate {g['ladder_cam']})")
    if len(highest) != 2 or not worst <= g["ladder_cam"]:
        raise AssertionError(f"ladder highest rungs: {highest}")
    say(f"quality path: {time.perf_counter() - t_phase:.1f} s in all")
    return add


# phase 17, the user path on the fine-tuned ViT-B/16 of phase 16.  Predict,
# kernel path against eager: the port's float32 kernel-vs-eager gates (the
# JAX package's Pallas-vs-XLA tolerances) on the CAMs and head1's
# probabilities (logits 2e-4 as on the main path); token_sim is the cosine
# similarity of unit-normalized token vectors (a sum over C = 768 products
# of the block outputs, which carry the two paths' float32 rounding), held
# to 1e-4
USER_GATES = {"per_block_cams": 1e-5, "rollout_cam": 1e-5,
              "probs_head1": 2e-4, "logits": 2e-4, "token_sim": 1e-4}
PREDICT_ARRAYS = ("per_block_cams", "rollout_cam", "token_sim", "probs_head1")


def synthetic_png(path, seed=4242, img=224):
    """One quality_eval image (a textured square over noise) as the uint8
    RGB PNG whose decode and normalization give it back to a quantum."""
    import PIL.Image
    from vision_transformer_cam_tpu_torch.scripts import quality_eval as qe
    images, labels = qe.make_batch(seed, 1, img=img)
    mean = np.asarray((0.485, 0.456, 0.406), np.float32)
    std = np.asarray((0.229, 0.224, 0.225), np.float32)
    u8 = np.clip(np.rint((images[0].numpy() * std + mean) * 255), 0, 255)
    PIL.Image.fromarray(u8.astype(np.uint8)).save(path)
    return int(np.flatnonzero(labels[0].numpy())[0])


def user_path():
    """Phase 17: tools convert (.pt -> .npz -> .pth, bit for bit), predict
    on the kernel and the eager path, e2e_bench at BASELINE config #3 and
    the quickstart at its defaults, each through the entry point a user
    calls, with its launch counts held.  Returns the launch counts to add
    to the kernels line."""
    import importlib.util
    import tempfile

    from vision_transformer_cam_tpu_torch import configs
    from vision_transformer_cam_tpu_torch.cli import export as ecli
    from vision_transformer_cam_tpu_torch.cli import predict as pcli
    from vision_transformer_cam_tpu_torch.cli import tools
    from vision_transformer_cam_tpu_torch.cli import train as tcli
    from vision_transformer_cam_tpu_torch.cli import validate as vcli
    from vision_transformer_cam_tpu_torch.examples import (quickstart,
                                                           serve_artifact)
    from vision_transformer_cam_tpu_torch.io import weights as wio
    from vision_transformer_cam_tpu_torch.scripts import e2e_bench
    phase = "user path"
    t_phase = time.perf_counter()
    src = os.path.join(REPO, QUALITY_PARAMS)
    depth = 12
    total = {}

    def added(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)          # the CLIs write their logs here
        try:
            # a. convert: the fine-tuned .pt -> .npz -> .pth
            npz, pth = (os.path.join(work, f"vit_b16_ft.{e}")
                        for e in ("npz", "pth"))
            t0 = time.perf_counter()
            reset_counts()
            tools.main(["convert", "--weights", src, "--out", npz])
            tools.main(["convert", "--weights", npz, "--out", pth])
            _expect("convert", {}, phase=phase)
            cfg = configs.resolve_model("vit_base_patch16_224_in21k")(
                num_classes=20).replace(representation_size=None)
            sds = {"pt": torch.load(src, map_location="cpu",
                                    weights_only=True),
                   "npz": wio.state_dict_from_jax_params(
                       wio.load_npz(npz), cfg),
                   "pth": torch.load(pth, map_location="cpu",
                                     weights_only=True)}
            ref = sds["pt"]
            for kind, sd in sds.items():
                if set(sd) != set(ref) or not all(
                        sd[k].dtype == ref[k].dtype and torch.equal(sd[k],
                                                                    ref[k])
                        for k in ref):
                    raise AssertionError(f"convert: the {kind} state dict "
                                         "is not the .pt's bit for bit")
            say(f"{phase}: convert .pt -> .npz -> .pth in "
                f"{time.perf_counter() - t0:.1f} s, {len(ref)} tensors bit "
                f"for bit in all three")

            # b. predict on one synthetic image of the fine-tune's kind
            img = os.path.join(work, "synthetic_0.png")
            cls = synthetic_png(img)
            figure = importlib.util.find_spec("matplotlib") is not None
            if not figure:
                say(f"{phase}: matplotlib is not installed on this machine: "
                    "the predict grid is not rendered (--no_figure); the "
                    "arrays and their gates run")
            arts, walls = {}, {}
            for run, weights, impl, want in (
                    ("kernel npz", npz, "kernel",
                     {"masked_attention_fused": depth}),
                    ("kernel pth", pth, "kernel",
                     {"masked_attention_fused": depth}),
                    ("eager npz", npz, "eager", {})):
                reset_counts()
                t0 = time.perf_counter()
                arts[run] = pcli.main(
                    ["--img_name", img, "--dataset_path", work, "--weights",
                     weights, "--attn_impl", impl, "--model_name",
                     "vit_base_patch16_224_in21k", "--out",
                     os.path.join(work, "predict_" + impl)]
                    + ([] if figure else ["--no_figure"]))
                torch.cuda.synchronize()
                walls[run] = time.perf_counter() - t0
                added(_expect(f"predict {run}", want, phase=phase))
                if not all(np.isfinite(v).all() for v in arts[run].values()):
                    raise AssertionError(f"predict {run}: not finite")
            k, p, e = arts["kernel npz"], arts["kernel pth"], \
                arts["eager npz"]
            if k["per_block_cams"].shape != (depth, 14, 14) or \
                    k["token_sim"].shape != (depth, 197, 197) or \
                    k["rollout_cam"].shape != (14, 14):
                raise AssertionError("predict: wrong shapes")
            # a .pth drops head.*, which keeps its seeded init: every array
            # but logits (head's) is the .npz run's bit for bit
            same = [n for n in PREDICT_ARRAYS if not np.array_equal(k[n],
                                                                    p[n])]
            if same:
                raise AssertionError(f"predict .npz vs .pth differ: {same}")
            devs = {n: float(np.abs(k[n] - e[n]).max()) for n in USER_GATES}
            say(f"{phase}: predict kernel vs eager, max abs dev "
                f"{ {n: f'{v:.3e}' for n, v in devs.items()} } (gates "
                f"{USER_GATES}); wall per image {walls}; top class "
                f"{int(np.argmax(k['probs_head1']))} (drawn {cls}); "
                f"per-block CAM cells at 0 in the last block "
                f"{int((k['per_block_cams'][-1] == 0).sum())} of 196")
            over = [n for n, v in devs.items() if not v <= USER_GATES[n]]
            if over:
                raise AssertionError(f"predict kernel vs eager: {over}")
            if figure and not os.listdir(os.path.join(work,
                                                      "predict_kernel")):
                raise AssertionError("predict: no grid written")

            # c. e2e_bench, BASELINE config #3: 128 images of 500x375, int8
            reset_counts()
            line, _ = _capture(e2e_bench.main, [
                "--n", "128", "--batch", "64", "--serving", "int8",
                "--img", "500x375"])
            torch.cuda.synchronize()
            # two int8 forwards of 64; the calibration forward launches none
            added(_expect("e2e_bench", {"masked_attention_fused": 2 * depth,
                                        "linear_int8_fused": 2 * 49},
                          phase=phase))
            if line["seg_pngs"] != 128 or line["cam_files"] != 128 or \
                    not all(np.isfinite(line[k]) for k in ("value", "mAP",
                                                           "mIoU")):
                raise AssertionError(f"e2e_bench: {line}")
            say(f"{phase}: e2e_bench warm {line['value']} img/s, "
                f"{line['img_per_s_incl_compile']} img/s with the first "
                f"batch, wall {line['wall_s_total']} s")

            # d. the quickstart at its defaults
            qa = quickstart.parse_args([])
            q_depth, bs = 6, max(qa.n_train // 4, 1)
            steps = qa.epochs * (qa.n_train // bs)
            val_batches = qa.epochs * -(-qa.n_val // bs)
            want = {"tools": {},
                    # remat: the forward kernel in the forward and in the
                    # recompute; one evaluation a epoch
                    "train": {"masked_attention_fused":
                              (2 * steps + val_batches) * q_depth,
                              "masked_attention_bwd": steps * q_depth},
                    "validate": {"masked_attention_fused": q_depth},
                    "validate int8": {"masked_attention_fused": q_depth,
                                      "linear_int8_fused": 1 + 4 * q_depth},
                    "predict": {"masked_attention_fused": q_depth},
                    # --check runs the artifact and the live function
                    "export": {"masked_attention_fused": 2 * q_depth,
                               "linear_int8_fused": 2 * (1 + 4 * q_depth)},
                    "serve": {"masked_attention_fused": q_depth,
                              "linear_int8_fused": 1 + 4 * q_depth}}
            # every attention launch at the JAX tiny config's head width, 16
            for w in want.values():
                w[FWD_W[16]] = w.get("masked_attention_fused", 0)
                w[BWD_W[16]] = w.get("masked_attention_bwd", 0)
            calls = []
            reset_counts()
            t0 = time.perf_counter()
            with counted_calls(tools, "main", calls, "tools"), \
                    counted_calls(tcli, "main", calls, "train"), \
                    counted_calls(vcli, "main", calls, "validate"), \
                    counted_calls(pcli, "main", calls, "predict"), \
                    counted_calls(ecli, "main", calls, "export"), \
                    counted_calls(serve_artifact, "main", calls, "serve"):
                rc, text = _capture(quickstart.main, [
                    "--workdir", os.path.join(work, "quickstart")])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            labels = [c for c, _ in calls]
            if rc != 0 or labels != ["tools", "train", "validate",
                                     "validate", "predict", "export",
                                     "serve"]:
                raise AssertionError(f"quickstart: rc {rc}, calls {labels}")
            calls[3] = ("validate int8", calls[3][1])
            for label, counts in calls:
                added(_expect(f"quickstart {label}", want[label], counts,
                              phase=phase))
            _expect("quickstart", {k: sum(c.get(k, 0) for _, c in calls)
                                   for k in read_counts()}, phase=phase)
            seg = [os.listdir(os.path.join(work, "quickstart", d))
                   for d in ("seg_parity", "seg_int8", "served_cams")]
            if any(len(s) != qa.n_val for s in seg):
                raise AssertionError(f"quickstart: PNGs {seg}")
            say(f"{phase}: quickstart (--epochs {qa.epochs} --n_train "
                f"{qa.n_train} --n_val {qa.n_val}) in {wall:.1f} s")
        finally:
            os.chdir(cwd)
    say(f"{phase}: {time.perf_counter() - t_phase:.1f} s in all; launches "
        f"{total}")
    return total


# phase 18, the serving artifact on the fine-tuned ViT-B/16 of phase 16: the
# four exports (cli.export through main, the fused configurations through
# build_fn's overrides), each with its launches per forward
EXPORT_BATCH, SERVE_IMAGES = 64, 70
EXPORT_RUNS = (   # label, serving mode, build_fn overrides, launches per fwd
    ("int8", "int8", None, {"masked_attention_fused": 12,
                            "linear_int8_fused": 49}),
    ("bf16", "bf16", None, {"masked_attention_fused": 12}),
    ("int8 fused", "int8", dict(ln_quant_fusion=True, int8_fused_gemm=True,
                                mlp_fusion=True),
     {"masked_attention_fused": 12, "linear_int8_fused": 25, "ln_quant": 12,
      "mlp_fused_int8": 12}),
    ("bf16 fused", "bf16", dict(mlp_fusion=True, attn_block_fusion=True),
     {"attention_block_fused": 12, "mlp_fused": 12}),
)


def served_lines(probs, names, threshold=0.9):
    """``serve_artifact``'s printed class lines for sigmoid probabilities
    [n, classes] (float64) of the images ``names``."""
    lines = []
    for name, p in zip(names, probs):
        pred = np.nonzero(p >= threshold)[0]
        top = ", ".join(f"{c}:{p[c]:.2f}" for c in pred) or \
            f"(none >= {threshold}; max {p.argmax()}:{p.max():.2f})"
        lines.append(f"  {name}: {top}")
    return lines


def export_path(weights=QUALITY_PARAMS):
    """Phase 18: ``cli.export`` of the fine-tuned ViT-B/16 in int8 and bf16
    at batch 64 with ``--check`` (bit for bit), and of the two fused
    configurations through ``build_fn``'s overrides; the launches of one
    artifact call held to the live forward's; artifact and live img/s in
    turns; ``serve_artifact`` over 70 generated JPEGs (a padded tail) with
    the live model's classes.  ``weights`` None: the seeded random init.
    Returns the launch counts to add to the kernels line."""
    import tempfile

    import PIL.Image
    from vision_transformer_cam_tpu_torch.cli import export as ecli
    from vision_transformer_cam_tpu_torch.data.transforms import (
        load_and_preprocess)
    from vision_transformer_cam_tpu_torch.examples import serve_artifact
    from vision_transformer_cam_tpu_torch.models.vit import matmul_precision
    from vision_transformer_cam_tpu_torch.scripts import quality_eval as qe
    phase = "export path"
    t_phase = time.perf_counter()
    total = {}

    def added(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    built = {}

    def capture(args, **kw):
        built["fn"] = orig(args, **kw)
        return built["fn"]

    orig = ecli.build_fn
    mean = np.asarray((0.485, 0.456, 0.406), np.float32)
    std = np.asarray((0.229, 0.224, 0.225), np.float32)
    with tempfile.TemporaryDirectory() as work:
        calib = os.path.join(work, "calib.npy")
        # the quality phase's calibration batch (held out of the fine-tune)
        np.save(calib, qe.make_batch(777, 16)[0].numpy())
        x = torch.from_numpy(np.random.default_rng(21).standard_normal(
            (EXPORT_BATCH, 224, 224, 3), dtype=np.float32)).cuda()
        fns = {}
        for label, mode, knobs, per_fwd in EXPORT_RUNS:
            out = os.path.join(work, label.replace(" ", "_") + ".pt2")
            argv = ["--serving", mode, "--batch", str(EXPORT_BATCH),
                    "--calib_npy", calib, "--out", out, "--check"] + (
                ["--weights", os.path.join(REPO, weights)] if weights
                else [])
            reset_counts()
            t0 = time.perf_counter()
            if knobs is None:
                ecli.build_fn = capture
                try:
                    _, text = _capture(ecli.main, argv)
                finally:
                    ecli.build_fn = orig
                fn, cfg, _ = built["fn"]
            else:
                args = ecli.build_parser().parse_args(argv)
                fn, cfg, prov = ecli.build_fn(args, **knobs)
                _, text = _capture(ecli.write_artifact, args, fn, cfg, prov)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            # the check runs the artifact and the live function once each
            added(_expect(f"{label} export --check",
                          {k: 2 * v for k, v in per_fwd.items()},
                          phase=phase))
            if "bit-identical" not in text:
                raise AssertionError(f"{label}: no --check line")
            exported = torch.export.load(out)
            program = exported.module()
            calls = [str(n.target) for n in exported.graph.nodes
                     if n.op == "call_function"]
            nodes = sorted({t for t in calls if "vitcam" in t})
            with matmul_precision(cfg), torch.no_grad():
                for name, f in (("artifact", program), ("live", fn)):
                    reset_counts()
                    res = f(x)
                    torch.cuda.synchronize()
                    added(_expect(f"{label} one {name} call", per_fwd,
                                  phase=phase))
                    if tuple(res[2].shape) != (EXPORT_BATCH, 14, 14) or \
                            not all(torch.isfinite(r.float()).all()
                                    for r in res):
                        raise AssertionError(f"{label} {name}: outputs")
            export_s = re.search(r"([0-9.]+) s\)", text).group(1)
            say(f"{phase}: {label}: export + save {export_s} s, "
                f"{os.path.getsize(out) / 1e6:.1f} MB, with --check "
                f"{wall:.1f} s in all; ops {nodes}; {len(calls)} calls in "
                f"the graph, {calls.count('aten.to.dtype')} aten.to.dtype "
                f"and {calls.count('aten._assert_tensor_metadata.default')} "
                "aten._assert_tensor_metadata")
            fns[label] = (program, fn, cfg)
            if label == "int8":
                int8_out, int8_fn = out, fn

        # img/s at batch 64, artifact and live in turns
        def rate(f, cfg, iters=10):
            with matmul_precision(cfg), torch.no_grad():
                for _ in range(2):
                    f(x)
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(iters):
                    f(x)
                torch.cuda.synchronize()
            return EXPORT_BATCH * iters / (time.perf_counter() - t)
        # the host's part: the time one call takes to return after a
        # synchronise (every launch enqueued, none waited for), the median of
        # 5, which is what the call costs the host
        def host_ms(f, cfg, iters=5):
            ts = []
            with matmul_precision(cfg), torch.no_grad():
                for _ in range(iters):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    f(x)
                    ts.append(time.perf_counter() - t)
                torch.cuda.synchronize()
            return 1e3 * float(np.median(ts))
        for label, (program, fn, cfg) in fns.items():
            reset_counts()
            r = [rate(program, cfg), rate(fn, cfg), rate(fn, cfg),
                 rate(program, cfg)]
            h = [host_ms(program, cfg), host_ms(fn, cfg), host_ms(fn, cfg),
                 host_ms(program, cfg)]
            added(read_counts())
            say(f"{phase}: {label} img/s at batch {EXPORT_BATCH}, in turns: "
                f"artifact {(r[0] + r[3]) / 2:.1f} ({r[0]:.1f}, {r[3]:.1f}), "
                f"live {(r[1] + r[2]) / 2:.1f} ({r[1]:.1f}, {r[2]:.1f}), "
                f"artifact / live {(r[0] + r[3]) / (r[1] + r[2]):.4f}; host "
                f"ms a call: artifact {(h[0] + h[3]) / 2:.3f} ({h[0]:.3f}, "
                f"{h[3]:.3f}), live {(h[1] + h[2]) / 2:.3f} ({h[1]:.3f}, "
                f"{h[2]:.3f})")
        fns.clear()

        # the host time of one op call against the wrapper called directly:
        # linear_int8 at batch 1's qkv GEMM, where the host work is most of
        # the call; timing launches, not added to the kernels line
        from vision_transformer_cam_tpu_torch.kernels import gemm, ops
        g = torch.Generator().manual_seed(5)
        xg = torch.randn((197, 768), generator=g).to("cuda", torch.bfloat16)
        wq = torch.randint(-127, 128, (2304, 768), generator=g,
                           dtype=torch.int8).cuda()
        cs = torch.full((2304,), 1e-3, device="cuda")
        bias = torch.zeros(2304, device="cuda")
        inv_a = torch.tensor(40.0, device="cuda")

        def per_call(f, n=3000):
            with torch.inference_mode():
                for _ in range(200):
                    f(xg, wq, cs, bias, inv_a, route="fused",
                      out_dtype=torch.bfloat16)
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(n):
                    f(xg, wq, cs, bias, inv_a, route="fused",
                      out_dtype=torch.bfloat16)
                torch.cuda.synchronize()
            return (time.perf_counter() - t) / n * 1e6
        us = [per_call(f) for f in (gemm.linear_int8, ops.linear_int8,
                                    ops.linear_int8, gemm.linear_int8)]
        reset_counts()
        say(f"{phase}: host time of one linear_int8 call [197, 768] x "
            f"[2304, 768]^T (inference mode, kernel included), in turns: "
            f"the wrapper {(us[0] + us[3]) / 2:.2f} us ({us[0]:.2f}, "
            f"{us[3]:.2f}), through vitcam::linear_int8 "
            f"{(us[1] + us[2]) / 2:.2f} us ({us[1]:.2f}, {us[2]:.2f})")

        # serve 70 generated JPEGs from the int8 artifact
        jpegs = os.path.join(work, "jpegs")
        os.makedirs(jpegs)
        images, _ = qe.make_batch(9999, SERVE_IMAGES)
        names = [f"img_{i:03d}" for i in range(SERVE_IMAGES)]
        for name, img in zip(names, images.numpy()):
            u8 = np.clip(np.rint((img * std + mean) * 255), 0, 255)
            PIL.Image.fromarray(u8.astype(np.uint8)).save(
                os.path.join(jpegs, name + ".jpg"), quality=95)
        served = os.path.join(work, "served")
        reset_counts()
        t0 = time.perf_counter()
        rc, text = _capture(serve_artifact.main, [
            "--artifact", int8_out, "--images", jpegs, "--out", served])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_calls = -(-SERVE_IMAGES // EXPORT_BATCH)
        added(_expect("serve_artifact", {"masked_attention_fused":
                                         12 * n_calls,
                                         "linear_int8_fused": 49 * n_calls},
                      phase=phase))
        # the live int8 function on the same batches, zero-padded alike
        xs = np.zeros((n_calls * EXPORT_BATCH, 224, 224, 3), np.float32)
        for i, name in enumerate(names):
            xs[i] = load_and_preprocess(os.path.join(jpegs, name + ".jpg"),
                                        224, mean, std)
        probs = []
        with torch.no_grad():
            for lo in range(0, len(xs), EXPORT_BATCH):
                h1 = int8_fn(torch.from_numpy(xs[lo:lo + EXPORT_BATCH])
                             .cuda())[1]
                probs.append(1.0 / (1.0 + np.exp(
                    -h1.float().cpu().numpy().astype(np.float64))))
        want = served_lines(np.concatenate(probs)[:SERVE_IMAGES], names)
        got = [line for line in text.splitlines()
               if line.startswith("  img_")]
        overlays = sorted(os.listdir(served))
        say(f"{phase}: serve_artifact {SERVE_IMAGES} JPEGs in {wall:.1f} s "
            f"({n_calls} calls of {EXPORT_BATCH}), {len(overlays)} overlays, "
            f"classes printed for {len(got)}; e.g. {got[:2]}")
        if rc != 0 or len(overlays) != SERVE_IMAGES or got != want:
            raise AssertionError(f"serve_artifact: rc {rc}, {len(overlays)} "
                                 f"overlays, printed classes equal the live "
                                 f"model's: {got == want}")
    say(f"{phase}: {time.perf_counter() - t_phase:.1f} s in all; launches "
        f"{total}")
    return total


SEQ_GATES = {"cam": 5e-2, "logits": 5e-2}


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def seq_path(batch=16, requests=3):
    """The sequence-parallel main path at the full size of ViT-L/16@384;
    returns the launch counts of its three requests."""
    import torch.distributed as dist
    from vision_transformer_cam_tpu_torch import configs, serving
    from vision_transformer_cam_tpu_torch.io.weights import load_state_dict
    from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
    from vision_transformer_cam_tpu_torch.ops.rollout import (
        cam_from_rollout_row)
    from vision_transformer_cam_tpu_torch.parallel import mesh as pmesh
    from vision_transformer_cam_tpu_torch.parallel.worker import run_forward

    def sized(factory):
        return factory(num_classes=20).replace(representation_size=None)

    cfg = sized(configs.vit_large_patch16_384)
    small = ViTCAM(sized(configs.vit_large_patch16_224), device="cuda",
                   generator=torch.Generator().manual_seed(0))
    sd = {k: v.clone() for k, v in small.state_dict().items()}
    del small
    model = ViTCAM(cfg, device="cuda",
                   generator=torch.Generator().manual_seed(1))
    load_state_dict(model, sd)
    pe = model.pos_embed
    if tuple(pe.shape) != (1, 577, 1024) or not torch.isfinite(pe).all() \
            or not torch.equal(pe[:, 0], sd["pos_embed"][:, 0]):
        raise AssertionError("224 -> 384 pos-embed interpolation failed")
    say(f"seq path: ViT-L/16@384, depth {cfg.depth}, C={cfg.embed_dim}, "
        f"{cfg.num_heads} heads, N={cfg.seq_len}; 224 weights loaded, "
        f"pos_embed {tuple(sd['pos_embed'].shape)} -> {tuple(pe.shape)}")
    rng = np.random.default_rng(0)

    def images(b):
        return torch.from_numpy(rng.standard_normal(
            (b, cfg.img_size, cfg.img_size, 3), dtype=np.float32)).cuda()

    mesh = one_rank_seq_mesh()
    say(f"seq path: process group {dist.get_backend()}, world "
        f"{dist.get_world_size()}, mesh {mesh.shape}")

    # float32, batch 2: the sequence-parallel kernel path against the
    # unsharded kernel path at the CPU tests' tolerances
    seq_vs_unsharded("ViT-L/16@384", model, images(2), mesh, "seq path")

    state_bf16 = {k: v.detach().to(torch.bfloat16) if v.is_floating_point()
                  else v.detach() for k, v in model.state_dict().items()}
    serving.apply_serving_mode(model, "bf16")
    kcfg = model.cfg
    sp_cfg = pmesh.apply_seq_parallel(kcfg)
    g = cfg.grid_size
    reqs = [images(batch) for _ in range(requests)]
    model.cfg = sp_cfg
    with pmesh.set_mesh(mesh):
        outs_sp, counts = serve(model, reqs, {"masked_attention_seq_local":
                                              cfg.depth}, "seq bf16")
    model.cfg = kcfg
    refs = []
    for x in reqs:
        ref = model(x, need_rollout=True)
        refs.append((ref, cam_from_rollout_row(ref.rollout_row, g)))
    d_cam, d_logit, ov = deviation(outs_sp, refs)
    say(f"seq bf16 vs unsharded bf16 kernel path: CAM max abs dev {d_cam:.3e} "
        f"(tol {SEQ_GATES['cam']}), logits max abs dev {d_logit:.3e} (tol "
        f"{SEQ_GATES['logits']}), top-16 overlap {ov:.4f}")
    if not (d_cam <= SEQ_GATES["cam"] and d_logit <= SEQ_GATES["logits"]):
        raise AssertionError("sequence-parallel bf16 path disagrees with the "
                             "unsharded kernel path")

    # throughput at one fixed batch, in turns
    served = {"seq": sp_cfg, "kernel": kcfg,
              "kernel, rollout carry": kcfg.replace(rollout_post=False),
              "eager": kcfg.replace(attn_impl="eager")}
    xb = reqs[0]

    def rate(mode, iters=3):
        model.cfg = served[mode]
        with pmesh.set_mesh(mesh):
            cam_from_rollout_row(model(xb, need_rollout=True).rollout_row, g)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(iters):
                cam_from_rollout_row(
                    model(xb, need_rollout=True).rollout_row, g)
            torch.cuda.synchronize()
        return batch * iters / (time.perf_counter() - t)
    order = list(served) + list(served)[::-1]
    rates = {}
    for mode in order:
        rates.setdefault(mode, []).append(rate(mode))
    model.cfg = kcfg
    for mode, r in rates.items():
        say(f"ViT-L/16@384 {mode} CAM throughput, batch {batch}: "
            f"{np.mean(r):.1f} img/s ({r[0]:.1f}, {r[1]:.1f})")

    # two ranks that share this card: NCCL refuses two ranks on one device,
    # so gloo carries the collectives and CUDA tensors are staged through
    # host memory; the kernels run on the card in both processes
    t0 = time.perf_counter()
    ranks = run_forward(cfg, state_bf16, reqs[0].cpu(), world=2, n_seq=2,
                        device="cuda", backend="gloo", serving_mode="bf16",
                        fwd_kw=dict(need_rollout=True), timeout=400)
    ref_out, ref_cam = outs_sp[0]
    for rank, res in enumerate(ranks):
        cam = cam_from_rollout_row(res["rollout_row"], g)
        d_cam = float((cam - ref_cam.cpu()).abs().max())
        d_logit = float((res["logits"].float()
                         - ref_out.logits.float().cpu()).abs().max())
        say(f"two ranks on one card, rank {rank}: transport "
            f"{res['transport']}; {res['seq_launches']} seq-kernel launches; "
            f"vs the one-rank run: CAM max abs dev {d_cam:.3e} (tol "
            f"{SEQ_GATES['cam']}), logits max abs dev {d_logit:.3e} (tol "
            f"{SEQ_GATES['logits']})")
        if res["seq_launches"] != cfg.depth or not (
                d_cam <= SEQ_GATES["cam"] and d_logit <= SEQ_GATES["logits"]):
            raise AssertionError(f"two-rank run, rank {rank}: disagrees with "
                                 "the one-rank run or did not run the kernel")
    say(f"two ranks on one card: {time.perf_counter() - t0:.1f} s with the "
        "processes' start")
    dist.destroy_process_group()
    del model
    torch.cuda.empty_cache()
    return counts


def fake_voc_tree(root, n=12, seed=0):
    """A VOC-shaped tree of ``n`` seeded random images of differing sizes
    with segmentation PNGs and annotation XMLs; returns the split file."""
    import PIL.Image
    rng = np.random.default_rng(seed)
    for d in ("JPEGImages", "SegmentationClass", "Annotations"):
        os.makedirs(os.path.join(root, d))
    cats = ["dog", "cat", "person", "car", "bird", "sofa"]
    names = [f"2008_{i:06d}" for i in range(n)]
    for i, name in enumerate(names):
        h, w = 300 + 17 * (i % 7), 500 - 23 * (i % 5)
        # smooth blocks, so the JPEG is not pure noise
        arr = np.kron(rng.integers(0, 256, size=(h // 20 + 1, w // 20 + 1, 3),
                                   dtype=np.uint8),
                      np.ones((20, 20, 1), np.uint8))[:h, :w]
        PIL.Image.fromarray(arr).save(
            os.path.join(root, "JPEGImages", f"{name}.jpg"))
        seg = np.kron(rng.integers(0, 21, size=(h // 50 + 1, w // 50 + 1)),
                      np.ones((50, 50), np.int64))[:h, :w].astype(np.uint8)
        PIL.Image.fromarray(seg, mode="P").save(
            os.path.join(root, "SegmentationClass", f"{name}.png"))
        with open(os.path.join(root, "Annotations", f"{name}.xml"), "w") as f:
            f.write("<annotation>" + "".join(
                f"<object><name>{c}</name></object>"
                for c in (cats[i % 6], cats[(i + 2) % 6])) + "</annotation>")
    split = os.path.join(root, "split.txt")
    with open(split, "w") as f:
        f.write("".join(f"/JPEGImages/{name}.jpg /SegmentationClass/{name}.png"
                        "\n" for name in names))
    return split, names


def validate_path(n_images=12, batch=4):
    """cli.validate on the card: ViT-L/16@384, bf16 serving, --seq_parallel 1,
    pseudo-seg PNGs, rollout-CAM overlays and scores on a faked VOC tree."""
    import tempfile

    import PIL.Image
    from vision_transformer_cam_tpu_torch.cli import validate as vcli
    with tempfile.TemporaryDirectory() as root:
        split, names = fake_voc_tree(root, n_images)
        seg_dir, cam_dir = os.path.join(root, "seg"), os.path.join(root, "cam")
        cwd = os.getcwd()
        os.chdir(root)        # the CLI writes its log into the working directory
        reset_counts()
        t0 = time.perf_counter()
        try:
            res = vcli.main(["--model_name", "vit_large_patch16_384",
                             "--dataset_path", root, "--val_img_name_path",
                             split, "--batch_size", str(batch), "--serving",
                             "bf16", "--seq_parallel", "1", "--seg_pred_dir",
                             seg_dir, "--ori_cam_path", cam_dir])
        finally:
            os.chdir(cwd)
        torch.cuda.synchronize()
        counts = read_counts()
        say(f"validate: {res}; {time.perf_counter() - t0:.1f} s; launches "
            f"{counts}")
        n_batches = -(-n_images // batch)
        if counts["masked_attention_seq_local"] != 24 * n_batches or \
                counts["masked_attention_fused"]:
            raise AssertionError("validate did not go through the sequence-"
                                 "parallel kernel")
        if res["n_images"] != n_images or not all(
                np.isfinite(res[k]) for k in ("mAP", "mIoU", "global_acc")):
            raise AssertionError(f"validate results not finite: {res}")
        for name in names:
            png = PIL.Image.open(os.path.join(seg_dir, f"{name}.png"))
            src = PIL.Image.open(os.path.join(root, "JPEGImages",
                                              f"{name}.jpg"))
            cam = PIL.Image.open(os.path.join(cam_dir,
                                              f"{name}_rollout_cam.jpg"))
            if png.size != src.size or cam.size != src.size or \
                    png.getpalette()[:6] != [0, 0, 0, 128, 0, 0]:
                raise AssertionError(f"validate artifacts of {name} are wrong")
        say(f"validate: {n_images} pseudo-seg PNGs (VOC palette, source "
            f"sizes) and {n_images} rollout-CAM overlays written")
    return counts


DP_WORLD = 2
DP_STEPS, DP_TIMED = 5, 3


def _dp_validate_rank(argvs):
    """One rank of ``cli.validate --data_parallel`` (spawned by
    ``parallel.worker.launch``) for each argv of ``argvs`` in turn, in one
    process (the first run joins the process group, the next ones find it):
    [(its scores, its kernel launches)] in argvs' order."""
    from vision_transformer_cam_tpu_torch.cli import validate as vcli
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    got = []
    for argv in argvs:
        reset_counts()
        res = vcli.main(argv)
        torch.cuda.synchronize()
        got.append((res, read_counts()))
    return got


def _time_in_turns(par, one, rows, collective, iters):
    """img/s of a parallel step ``par(n)`` (n steps on every rank) and of
    one rank alone ``one(n)`` (n steps on one rank, the others waiting),
    each at ``rows`` images a step: one warm call each, then in turns par,
    one, one, par of ``iters`` steps; and the ms of ``collective()``, the
    collectives of one step alone on tensors of their shapes."""
    import torch.distributed as dist
    rates = {"par": [], "one": []}

    def sync():
        torch.cuda.synchronize()
        dist.barrier()
    par(1)
    one(1)
    for kind, fn in (("par", par), ("one", one), ("one", one), ("par", par)):
        sync()
        t0 = time.perf_counter()
        fn(iters)
        sync()
        rates[kind].append(rows * iters / (time.perf_counter() - t0))
    collective()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        collective()
    sync()
    rates["collective_ms"] = 1e3 * (time.perf_counter() - t0) / iters
    return rates


def _dp_train_rank(workdir, batch32, batch):
    """One training rank of phase 21 (spawned by ``parallel.worker.launch``),
    every run from the weights in ``workdir``: the float32 DP step, the
    ZeRO-1 step and accumulation 2 on the float32 batch, then DP_STEPS
    mixed-precision steps and their img/s in turns.  Returns each run's
    result (``scripts.dryrun_multichip.train_steps``), with the final
    parameters of the float32 runs on data rank 0."""
    from vision_transformer_cam_tpu_torch.parallel import mesh as meshlib
    from vision_transformer_cam_tpu_torch.scripts.dryrun_multichip import (
        train_steps)
    from vision_transformer_cam_tpu_torch.train.step import (average_grads,
                                                             train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    meshlib.distributed_init("cuda")
    mesh = meshlib.make_mesh((-1,), ("data",))
    d = torch.load(os.path.join(workdir, "dp_inputs.pt"), weights_only=False)
    out = {"transport": mesh.transport("cuda")}
    for name, kw in (("f32", {}), ("zero1", dict(zero1=True)),
                     ("accum2", dict(accum_steps=2))):
        state, res = train_steps(d["cfg"], d["before"], d["f32"], mesh,
                                 optim=d["optim"], global_batch=batch32,
                                 device="cuda", **kw)
        if mesh.data_rank == 0:
            res["state"] = {k: v.detach().cpu()
                            for k, v in state.model.state_dict().items()}
        out[name] = res
        del state
        gc_cuda()
    state, res = train_steps(
        d["cfg"].replace(dtype=torch.bfloat16, remat=True), d["before"],
        d["mixed"], mesh, optim=d["mixed_optim"], global_batch=batch,
        device="cuda")
    full = tuple(t.cuda() for t in d["mixed"][0])
    local = tuple(meshlib.shard_batch(mesh, t) for t in full)
    grads = [torch.zeros_like(p) for p in state.model.parameters()]

    def par(n):     # the DP step, every rank its rows
        nonlocal state
        with meshlib.set_mesh(mesh):
            for _ in range(n):
                state, _ = train_step(state, *local)

    def one(n):     # data rank 0 alone on the whole global batch, no mesh
        nonlocal state
        if mesh.data_rank == 0:
            for _ in range(n):
                state, _ = train_step(state, *full)
    res["img_per_s"] = _time_in_turns(
        par, one, full[0].shape[0], lambda: average_grads(grads, mesh),
        DP_TIMED)
    out["mixed"] = res
    return out


def dp_prepare(work, batch32=8, batch=64, n_images=11, val_batch=4):
    """Phase 21's part in this process, before its ranks (``_dp_train_rank``,
    then ``_dp_validate_rank``) run in ``parallel_path``'s spawn: the
    one-rank float32 step and the ranks' inputs saved into ``work``, a faked
    VOC tree there, the one-rank ``cli.validate`` runs in bf16 and int8 and
    the ranks' batches and argvs (``dp_ranks.pt``).  Returns the check of the ranks'
    results, ``check(ranks) -> launch counts``.

    Phase 21, data parallelism on one card: two gloo ranks share the card
    (NCCL refuses two ranks on one device; CUDA tensors are staged through
    host memory), ViT-B/16 at full width on the kernel path.  For
    correctness: the img/s of two ranks sharing one card is no scaling
    figure."""
    from vision_transformer_cam_tpu_torch import configs
    from vision_transformer_cam_tpu_torch.scripts.dryrun_multichip import (
        OPTIM, delta_excess)
    from vision_transformer_cam_tpu_torch.train import state as statelib
    from vision_transformer_cam_tpu_torch.train import step as steplib
    t_phase = time.perf_counter()
    gc_cuda()
    # the float32 reference: one rank on the card, in this process.  AdamW
    # with eps 1, lr 1 and no decay makes the first step's change -g / (|g|
    # + 1), so TRAIN_TOL on the changes holds the gradients to it
    optim = configs.OptimConfig(**OPTIM)
    model = train_model("kernel", dtype=torch.float32, remat=False)
    cfg32 = model.cfg
    before = {k: v.detach().cpu().clone()
              for k, v in model.state_dict().items()}
    b32 = seeded_batch(batch32, 31)
    x32, y32 = torch.from_numpy(b32["image"]), torch.from_numpy(b32["label"])
    opt, _ = statelib.make_optimizer(model, optim, batch32, 100)
    state = statelib.create_train_state(model, opt)
    state, m = steplib.train_step(state, x32.cuda(), y32.cuda())
    one = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    one_loss = float(m["loss"])
    del model, opt, state
    gc_cuda()

    # the ranks' inputs; the mixed-precision steps take train_path's
    # optimizer
    inputs = dict(
        cfg=cfg32, before=before, optim=optim, f32=[(x32, y32)],
        mixed=[tuple(torch.from_numpy(b[k]) for k in ("image", "label"))
               for b in (seeded_batch(batch, 40 + i)
                         for i in range(DP_STEPS))],
        mixed_optim=configs.OptimConfig(lr=1e-4, warmup_epochs=0, epochs=10,
                                        linear_lr_scaling=False,
                                        clip_grad=1.0))
    torch.save(inputs, os.path.join(work, "dp_inputs.pt"))
    del inputs
    # cli.validate --data_parallel against the one-rank run, bf16 and int8:
    # the one-rank runs in this process, the ranks' after their training
    modes = ("bf16", "int8")
    root = os.path.join(work, "voc")
    os.makedirs(root)
    split, names = fake_voc_tree(root, n_images)
    argvs, dirs, want = {}, {}, {}
    for mode in modes:
        argvs[mode] = ["--model_name", "vit_base_patch16_224_in21k",
                       "--dataset_path", root, "--val_img_name_path",
                       split, "--batch_size", str(val_batch),
                       "--serving", mode]
        dirs[mode] = {k: os.path.join(root, f"{mode}_{k}")
                      for k in ("one", "dp")}
        cwd = os.getcwd()
        os.chdir(root)
        try:
            want[mode], = _dp_validate_rank(
                [argvs[mode] + ["--seg_pred_dir", dirs[mode]["one"]]])
        finally:
            os.chdir(cwd)
    torch.save({"batch32": batch32, "batch": batch, "root": root,
                "argvs": [argvs[m] + ["--seg_pred_dir", dirs[m]["dp"],
                                      "--data_parallel"] for m in modes]},
               os.path.join(work, "dp_ranks.pt"))
    say(f"dp path: set up in {time.perf_counter() - t_phase:.1f} s")

    def check(ranks):
        """Phase 21's gates on its ranks' results."""
        say(f"dp path: {DP_WORLD} training ranks on one card, transport "
            f"{ranks[0]['train']['transport']}")
        val = [r["validate"] for r in ranks]
        ranks = [r["train"] for r in ranks]
        fails = []
        for name in ("f32", "zero1", "accum2", "mixed"):
            same = all(r[name]["digests"] == ranks[0][name]["digests"]
                       and [x["loss"] for x in r[name]["metrics"]]
                       == [x["loss"] for x in ranks[0][name]["metrics"]]
                       for r in ranks)
            say(f"dp path {name}: parameters bit for bit equal on every rank "
                f"after each of {len(ranks[0][name]['digests'])} step(s): "
                f"{same}; losses "
                + ", ".join(f"{x['loss']:.6f}"
                            for x in ranks[0][name]["metrics"]))
            if not same:
                fails.append(f"{name}: the ranks differ")

        # float32: the two ranks' step against the one-rank step
        atol, rtol = TRAIN_TOL["grad"]
        d_loss = abs(ranks[0]["f32"]["metrics"][0]["loss"] - one_loss)
        worst, bad = delta_excess(ranks[0]["f32"]["state"], one, before,
                                  (atol, rtol))
        say(f"dp path f32 (B={batch32}, {batch32 // DP_WORLD} a rank) vs one "
            f"rank: loss {d_loss:.3e} (tol {TRAIN_TOL['loss']}), parameter "
            f"changes max abs dev {worst:.3e} (atol {atol}, rtol {rtol})")
        if d_loss > TRAIN_TOL["loss"] or bad:
            fails.append(f"f32 dp step vs one rank: loss {d_loss}, {bad}")
        for name in ("zero1", "accum2"):
            worst, bad = delta_excess(ranks[0][name]["state"],
                                      ranks[0]["f32"]["state"], before,
                                      (atol, rtol))
            d = abs(ranks[0][name]["metrics"][0]["loss"]
                    - ranks[0]["f32"]["metrics"][0]["loss"])
            say(f"dp path {name} vs the dp step: parameter changes max abs dev "
                f"{worst:.3e}, loss {d:.3e}")
            if bad or d > TRAIN_TOL["loss"]:
                fails.append(f"{name} vs the dp step: loss {d}, {bad}")
        full = ranks[0]["f32"]["moment_bytes"]
        say("dp path zero1: moment bytes a rank "
            + ", ".join(str(r["zero1"]["moment_bytes"]) for r in ranks)
            + f" against {full} unsharded")
        if sum(r["zero1"]["moment_bytes"] for r in ranks) != full:
            fails.append("zero1 moments are not a partition")

        # mixed precision: launches, losses, img/s in turns
        depth = cfg32.depth
        train_row = "masked_attention_fused[bf16 plain, training]"
        counts = {train_row: 0, "masked_attention_bwd": 0}
        for rank, r in enumerate(ranks):
            steps = r["mixed"]["launches"]
            say(f"dp path mixed, rank {rank}: launches in one step: kernel 1 "
                f"{steps[0]['masked_attention_fused']} (expected {2 * depth}), "
                f"backward {steps[0]['masked_attention_bwd']} (expected {depth})")
            for st in steps:
                counts[train_row] += st["masked_attention_fused"]
                counts["masked_attention_bwd"] += st["masked_attention_bwd"]
                if (st["masked_attention_fused"], st["masked_attention_bwd"]) \
                        != (2 * depth, depth):
                    fails.append(f"mixed rank {rank}: launches {st}")
            if not all(np.isfinite(x["loss"]) for x in r["mixed"]["metrics"]):
                fails.append(f"mixed rank {rank}: loss not finite")
        rates = ranks[0]["mixed"]["img_per_s"]
        say(f"dp path img/s, ViT-B/16 mixed precision, remat, global batch "
            f"{batch}, {DP_TIMED} steps a reading, in turns (dp, one, one, "
            f"dp): two ranks sharing one card {np.mean(rates['par']):.1f} "
            f"({rates['par'][0]:.1f}, {rates['par'][1]:.1f}); one rank alone on "
            f"the whole batch {np.mean(rates['one']):.1f} ({rates['one'][0]:.1f}"
            f", {rates['one'][1]:.1f}); the gradient all-reduce alone "
            f"{rates['collective_ms']:.1f} ms a step; NOT a scaling figure: both "
            f"ranks share the card, and gloo stages every all-reduce through "
            f"host memory")

        for i, mode in enumerate(modes):
            got = [r[i] for r in val]
            ref, one_counts = want[mode]
            png = {k: [open(os.path.join(d, f"{n}.png"), "rb").read()
                       for n in names] for k, d in dirs[mode].items()}
            same = png["one"] == png["dp"]
            scores = all(r[k] == ref[k] for r, _ in got
                         for k in ("mAP", "mIoU", "n_images"))
            for rank, (_, c) in enumerate(got):
                for k, v in c.items():
                    counts[k] = counts.get(k, 0) + v
                say(f"dp path validate {mode}, rank {rank}: launches "
                    f"{ {k: v for k, v in c.items() if v} }")
            say(f"dp path validate {mode}, {DP_WORLD} ranks vs one rank: "
                f"{n_images} PNGs byte for byte equal: {same}; mAP "
                f"{got[0][0]['mAP']:.6f} vs {ref['mAP']:.6f}, mIoU "
                f"{got[0][0]['mIoU']:.4f} vs {ref['mIoU']:.4f}; one-rank "
                f"launches { {k: v for k, v in one_counts.items() if v} }")
            if not (same and scores):
                fails.append(f"validate {mode}: PNGs equal {same}, scores "
                             f"equal {scores}")
            if not got[0][1]["masked_attention_fused"] or (
                    mode == "int8" and not got[0][1]["linear_int8_fused"]):
                fails.append(f"validate {mode}: the ranks launched no "
                             "kernel")
        if fails:
            raise AssertionError("dp path: " + "; ".join(fails))
        return counts
    return check


TP_STEPS, TP_TIMED = 5, 3
HUGE = "vit_huge_patch14_224_in21k"
TP_GATES = {"cam": 5e-2, "logits": 5e-2, "row32": 1e-5, "logits32": 2e-4}


def _tp_counts():
    """The launch counts, read after one section of a rank of phase 22."""
    torch.cuda.synchronize()
    return read_counts()


def _tp_rank(workdir):
    """One rank of phase 22 (spawned by ``parallel.worker.launch``): on the
    (1, 2) ('data', 'model') mesh, ViT-B/16 sharded over both ranks: the
    float32 step, TP_STEPS mixed-precision steps and their img/s in turns,
    the bf16 and float32 CAM forwards; ViT-H/14's mixed step and its
    float32 step (held on model rank 0 to the one-rank step); then on the
    (1, 2) ('data', 'stage') mesh the float32 pipeline forwards and step.
    Every section's launch counts are set to 0 before it and read after
    it.  Returns each section's results; the float32 parameters gathered to
    the one-rank layout."""
    from vision_transformer_cam_tpu_torch import serving
    from vision_transformer_cam_tpu_torch.io.weights import load_state_dict
    from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
    from vision_transformer_cam_tpu_torch.ops.rollout import (
        cam_from_rollout_row)
    from vision_transformer_cam_tpu_torch.parallel import mesh as meshlib
    from vision_transformer_cam_tpu_torch.parallel import pipeline
    from vision_transformer_cam_tpu_torch.scripts.dryrun_multichip import (
        delta_excess, heads_seen, host_state, param_digest, train_steps)
    from vision_transformer_cam_tpu_torch.train import state as statelib
    from vision_transformer_cam_tpu_torch.train import step as steplib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    meshlib.distributed_init("cuda")
    mesh = meshlib.make_mesh((1, 2), ("data", "model"))
    d = torch.load(os.path.join(workdir, "tp_inputs.pt"), weights_only=False)
    out = {"transport": mesh.transport("cuda")}
    main = mesh.inner_rank == 0

    # train_steps sets the launch counts to 0 before each step, reads them
    # after it, and records the head counts
    state, res = train_steps(d["cfg"], d["before"], d["f32"], mesh,
                             optim=d["optim"], global_batch=d["b32"],
                             device="cuda")
    res["state"] = host_state(meshlib.full_state_dict(state.model))
    if not main:
        del res["state"]
    out["f32"] = res
    del state
    gc_cuda()

    cfg_mixed = d["cfg"].replace(dtype=torch.bfloat16, remat=True)
    state, res = train_steps(cfg_mixed, d["before"], d["mixed"], mesh,
                             optim=d["mixed_optim"], global_batch=d["b16"],
                             device="cuda")
    one = None
    if main:
        model = ViTCAM(cfg_mixed, device="cuda")
        load_state_dict(model, d["before"])
        opt, _ = statelib.make_optimizer(model, d["mixed_optim"], d["b16"],
                                         100)
        one = statelib.create_train_state(model, opt)
    batch = tuple(t.cuda() for t in d["mixed"][0])
    act = torch.zeros((batch[0].shape[0], cfg_mixed.seq_len,
                       cfg_mixed.embed_dim), dtype=cfg_mixed.dtype,
                      device="cuda")

    def par(n):     # the tensor-parallel step, both ranks
        nonlocal state
        with meshlib.set_mesh(mesh):
            for _ in range(n):
                state, _ = steplib.train_step(state, *batch)

    def alone(n):   # model rank 0 alone on the unsharded model
        nonlocal one
        if main:
            for _ in range(n):
                one, _ = steplib.train_step(one, *batch)

    def allreduces():
        # a step's activation all-reduces: two a layer in the forward, two
        # in the remat forward, two in the backward
        for _ in range(6 * cfg_mixed.depth):
            mesh.inner_sum(act)
    res["img_per_s"] = _time_in_turns(par, alone, batch[0].shape[0],
                                      allreduces, TP_TIMED)
    out["mixed"] = res
    del state, one, act
    gc_cuda()

    for name, mode, x in (("cam_bf16", "bf16", d["x32"]),
                          ("cam_f32", "off", d["x4"])):
        model = ViTCAM(d["cfg"], device="cuda")
        load_state_dict(model, d["before"])
        meshlib.shard_params(mesh, model, "model")
        serving.apply_serving_mode(model, mode)
        reset_counts()
        with meshlib.set_mesh(mesh), heads_seen() as heads:
            o = model(x.cuda(), need_rollout=True)
        out[name] = {"counts": _tp_counts(), "heads": sorted(heads),
                     "logits": o.logits.float().cpu(),
                     "rollout_row": o.rollout_row.float().cpu(),
                     "cam": cam_from_rollout_row(
                         o.rollout_row, model.cfg.grid_size).float().cpu()}
        del model, o
        gc_cuda()

    def huge(dtype):
        m = torch.load(os.path.join(workdir, "tp_huge.pt"),
                       map_location="cuda", weights_only=False)
        m.cfg = m.cfg.replace(dtype=dtype)
        return m

    model = huge(torch.bfloat16)
    full_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    meshlib.shard_params(mesh, model, "model")
    opt, _ = statelib.make_optimizer(model, d["mixed_optim"], d["bh"], 100)
    state = statelib.create_train_state(model, opt)
    xh, yh = (t.cuda() for t in d["huge"])
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with meshlib.set_mesh(mesh), heads_seen() as heads:
        state, m = steplib.train_step(state, xh, yh)
        loss = float(m["loss"])
    out["huge"] = {"counts": _tp_counts(), "heads": sorted(heads),
                   "loss": loss,
                   "peak": torch.cuda.max_memory_allocated(),
                   "param_bytes": sum(p.numel() * p.element_size()
                                      for p in model.parameters()),
                   "full_param_bytes": full_bytes,
                   "whole_digest": param_digest(model, whole_only=True)}
    del model, opt, state
    gc_cuda()

    # ViT-H/14 at float32: the tensor-parallel step, then on model rank 0
    # the one-rank step from the same seeded weights (a copy of the whole
    # model, taken before the cut), held to it
    model = huge(torch.float32)
    one = copy.deepcopy(model) if main else None
    meshlib.shard_params(mesh, model, "model")
    opt, _ = statelib.make_optimizer(model, d["optim"], d["bh32"], 100)
    state = statelib.create_train_state(model, opt)
    xh, yh = (t.cuda() for t in d["huge32"])
    reset_counts()
    with meshlib.set_mesh(mesh), heads_seen() as heads:
        state, m = steplib.train_step(state, xh, yh)
        res = {"loss": float(m["loss"])}
    res.update(counts=_tp_counts(), heads=sorted(heads))
    after = meshlib.full_state_dict(model)
    del model, opt, state
    gc_cuda()
    if main:
        after = {k: v.cuda() for k, v in after.items()}
        before = {k: v.detach().clone() for k, v in one.state_dict().items()}
        opt, _ = statelib.make_optimizer(one, d["optim"], d["bh32"], 100)
        state = statelib.create_train_state(one, opt)
        state, m = steplib.train_step(state, xh, yh)
        res["one_loss"] = float(m["loss"])
        res["worst"], res["bad"] = delta_excess(
            after, one.state_dict(), before, TRAIN_TOL["grad"])
        del opt, state, before
    out["huge32"] = res
    del after, one
    gc_cuda()

    pmesh = meshlib.make_mesh((1, 2), ("data", "stage"))
    pcfg = d["cfg"].replace(attn_impl="eager", per_sample_mask_norm=True)
    model = ViTCAM(pcfg, device="cuda")
    load_state_dict(model, d["before"])
    x8, y8 = (t.cuda() for t in d["f32"][0])
    res = {}
    reset_counts()
    for m_ in (2, 4):
        o = pipeline.pipeline_forward(model, x8, pcfg, pmesh,
                                      microbatches=m_, need_rollout=True)
        res[f"fwd{m_}"] = {"logits": o.logits.cpu(),
                           "rollout_row": o.rollout_row.cpu()}
    pipeline.stage_shard_params(pmesh, model)
    gc_cuda()
    res["blocks"] = sorted({int(n.split(".")[1]) for n, _ in
                            model.named_parameters()
                            if n.startswith("blocks.")})
    res["block_bytes"] = sum(p.numel() * p.element_size() for n, p in
                             model.named_parameters()
                             if n.startswith("blocks."))
    opt, _ = statelib.make_optimizer(model, d["optim"], d["b32"], 100)
    state = statelib.create_train_state(model, opt)
    with meshlib.set_mesh(pmesh):
        state, m = pipeline.pipeline_train_step(state, x8, y8, pmesh,
                                                microbatches=2)
    res["loss"] = float(m["loss"])
    res["counts"] = _tp_counts()
    res["state"] = host_state(meshlib.full_state_dict(model))
    if not main:
        del res["state"]
    out["pipeline"] = res
    return out


def tp_prepare(work, batch32=8, batch=16, cam_batch=32, huge_batch=8,
               huge32=4):
    """Phase 22's part in this process, before its ranks (``_tp_rank``) run
    in ``parallel_path``'s spawn: the one-rank references, the ranks' inputs
    and ViT-H/14's seeded model saved into ``work``.  Returns the check of
    the ranks' results, ``check(ranks) -> launch counts``.

    Phase 22, tensor parallelism and the pipeline on one card: two gloo
    ranks share the card (CUDA tensors staged through host memory), each
    holding half of ViT-B/16's heads and MLP hidden units (the kernel path:
    kernel 1 and the backward at 6 heads of 64 a rank), half of ViT-H/14's
    (8 heads of 80: a mixed step, and a float32 step held to one rank's),
    and as pipeline stages 6 of ViT-B/16's 12 blocks (the
    eager path, as JAX runs its XLA path there).  Each result is held to one
    rank on the card.  For correctness: the img/s of two ranks sharing one
    card is no scaling figure."""
    from vision_transformer_cam_tpu_torch import configs, serving
    from vision_transformer_cam_tpu_torch.io.weights import load_state_dict
    from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
    from vision_transformer_cam_tpu_torch.ops.rollout import (
        cam_from_rollout_row)
    from vision_transformer_cam_tpu_torch.scripts.dryrun_multichip import (
        OPTIM, delta_excess)
    from vision_transformer_cam_tpu_torch.train import state as statelib
    from vision_transformer_cam_tpu_torch.train import step as steplib
    t_phase = time.perf_counter()
    gc_cuda()
    optim = configs.OptimConfig(**OPTIM)
    mixed_optim = configs.OptimConfig(lr=1e-4, warmup_epochs=0, epochs=10,
                                      linear_lr_scaling=False, clip_grad=1.0)
    model = train_model("kernel", dtype=torch.float32, remat=False)
    cfg32 = model.cfg
    before = {k: v.detach().cpu().clone()
              for k, v in model.state_dict().items()}
    full_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    b32 = seeded_batch(batch32, 61)
    x8, y8 = torch.from_numpy(b32["image"]), torch.from_numpy(b32["label"])
    x32 = torch.from_numpy(seeded_batch(cam_batch, 62)["image"])
    x4 = torch.from_numpy(seeded_batch(4, 63)["image"])

    def one_step(cfg, x, y):
        m_ = ViTCAM(cfg, device="cuda")
        load_state_dict(m_, before)
        opt, _ = statelib.make_optimizer(m_, optim, batch32, 100)
        st = statelib.create_train_state(m_, opt)
        st, met = steplib.train_step(st, x.cuda(), y.cuda())
        return {k: v.detach().cpu() for k, v in m_.state_dict().items()}, \
            float(met["loss"])

    def forward(cfg, mode, x):
        m_ = ViTCAM(cfg, device="cuda")
        load_state_dict(m_, before)
        serving.apply_serving_mode(m_, mode)
        o = m_(x.cuda(), need_rollout=True)
        return {"logits": o.logits.float().cpu(),
                "rollout_row": o.rollout_row.float().cpu(),
                "cam": cam_from_rollout_row(o.rollout_row, cfg.grid_size)
                .float().cpu()}
    del model
    gc_cuda()
    one, one_loss = one_step(cfg32, x8, y8)
    pcfg = cfg32.replace(attn_impl="eager", per_sample_mask_norm=True)
    p_one, p_loss = one_step(pcfg, x8, y8)
    ref = {"cam_bf16": forward(cfg32, "bf16", x32),
           "cam_f32": forward(cfg32, "off", x4),
           "pipeline": forward(pcfg, "off", x8)}
    gc_cuda()
    # ViT-H/14 alone on this process: its mixed step and peak memory
    bh = seeded_batch(huge_batch, 64)
    huge = tuple(torch.from_numpy(bh[k]) for k in ("image", "label"))
    hm = zoo_train_model("vit_huge_patch14_224_in21k", "kernel")
    # the ranks load this copy of the seeded model (no init of their own)
    torch.save(hm, os.path.join(work, "tp_huge.pt"))
    opt, _ = statelib.make_optimizer(hm, mixed_optim, huge_batch, 100)
    st = statelib.create_train_state(hm, opt)
    torch.cuda.reset_peak_memory_stats()
    st, met = steplib.train_step(st, *(t.cuda() for t in huge))
    huge_one = (float(met["loss"]), torch.cuda.max_memory_allocated())
    del hm, opt, st
    gc_cuda()

    inputs = dict(
        cfg=cfg32, before=before, optim=optim, mixed_optim=mixed_optim,
        f32=[(x8, y8)], b32=batch32, b16=batch, bh=huge_batch, huge=huge,
        bh32=huge32, huge32=tuple(torch.from_numpy(seeded_batch(huge32, 65)[k])
                                  for k in ("image", "label")),
        x32=x32, x4=x4,
        mixed=[tuple(torch.from_numpy(b[k]) for k in ("image", "label"))
               for b in (seeded_batch(batch, 70 + i)
                         for i in range(TP_STEPS))])
    torch.save(inputs, os.path.join(work, "tp_inputs.pt"))
    del inputs
    say(f"tp path: set up in {time.perf_counter() - t_phase:.1f} s")

    def check(ranks):
        """Phase 22's gates on its ranks' results."""
        ranks = [r["tp"] for r in ranks]
        fails, counts = [], {}
        say(f"tp path: 2 ranks on one card, transport "
            f"{ranks[0]['transport']}")

        def add(c, rename=None):
            for k, v in c.items():
                k = (rename or {}).get(k, k)
                counts[k] = counts.get(k, 0) + v

        depth = cfg32.depth
        atol, rtol = TRAIN_TOL["grad"]
        # the float32 step against one rank
        d_loss = abs(ranks[0]["f32"]["metrics"][0]["loss"] - one_loss)
        worst, bad = delta_excess(ranks[0]["f32"]["state"], one, before,
                                  (atol, rtol))
        say(f"tp path f32 (B={batch32}, 6 heads a rank) vs one rank: loss "
            f"{d_loss:.3e} (tol {TRAIN_TOL['loss']}), parameter changes max "
            f"abs dev {worst:.3e} (atol {atol}, rtol {rtol}); heads "
            f"{ranks[0]['f32']['heads']}")
        if d_loss > TRAIN_TOL["loss"] or bad:
            fails.append(f"f32 tp step vs one rank: loss {d_loss}, {bad}")
        # the mixed steps: launches, heads, whole leaves bit-equal
        train_row = "masked_attention_fused[bf16 plain, training]"
        for rank, r in enumerate(ranks):
            mx = r["mixed"]
            # train_steps sets the counts to 0 before each step and reads them
            # after it
            add({train_row: sum(st["masked_attention_fused"]
                                for st in mx["launches"]),
                 "masked_attention_bwd": sum(st["masked_attention_bwd"]
                                             for st in mx["launches"])})
            steps_ok = all(st == {"masked_attention_fused": 2 * depth,
                                  "masked_attention_bwd": depth}
                           for st in mx["launches"]) and all(
                h == [cfg32.num_heads // 2] for h in mx["heads"])
            say(f"tp path mixed, rank {rank}: launches a step "
                f"{mx['launches'][0]} (expected {2 * depth} / {depth}) at "
                f"heads {mx['heads'][0]}, held over {TP_STEPS} steps: "
                f"{steps_ok}; "
                f"losses " + ", ".join(f"{x['loss']:.6f}"
                                       for x in mx["metrics"])
                + f"; parameter bytes {mx['param_bytes']} against "
                f"{full_bytes} unsharded")
            if not steps_ok:
                fails.append(f"mixed rank {rank}: launches or heads "
                             f"{mx['launches']} {mx['heads']}")
            if not all(np.isfinite(x["loss"]) for x in mx["metrics"]):
                fails.append(f"mixed rank {rank}: loss not finite")
            if not mx["param_bytes"] < full_bytes:
                fails.append(f"mixed rank {rank}: holds the whole model")
        same = ranks[0]["mixed"]["whole_digests"] == \
            ranks[1]["mixed"]["whole_digests"]
        say(f"tp path mixed: the leaves both ranks hold whole bit for bit "
            f"equal after each of {TP_STEPS} steps: {same}")
        if not same:
            fails.append("mixed: the replicated leaves differ between ranks")
        rates = ranks[0]["mixed"]["img_per_s"]
        say(f"tp path img/s, ViT-B/16 mixed precision, remat, batch {batch}, "
            f"{TP_TIMED} steps a reading, in turns (tp, one, one, tp): two "
            f"ranks sharing one card {np.mean(rates['par']):.1f} "
            f"({rates['par'][0]:.1f}, {rates['par'][1]:.1f}); one rank alone "
            f"{np.mean(rates['one']):.1f} "
            f"({rates['one'][0]:.1f}, {rates['one'][1]:.1f}); the {6 * depth} "
            f"activation all-reduces of a step alone "
            f"{rates['collective_ms']:.1f} ms; NOT a scaling figure: both "
            "ranks share the card, and gloo stages every all-reduce through "
            "host memory")
        # the CAM forwards
        for name, gate in (("cam_bf16", ("cam", "logits")),
                           ("cam_f32", ("row32", "logits32"))):
            want = ref[name]
            for rank, r in enumerate(ranks):
                got = r[name]
                add(got["counts"])
                kinds = ("cam", "logits") if name == "cam_bf16" \
                    else ("rollout_row", "logits")
                devs = [float((got[k] - want[k]).abs().max()) for k in kinds]
                ok = all(dv <= TP_GATES[g] for dv, g in zip(devs, gate)) and \
                    got["counts"]["masked_attention_fused"] == depth and \
                    got["heads"] == [cfg32.num_heads // 2]
                say(f"tp path {name}, rank {rank}: {kinds[0]} {devs[0]:.3e} "
                    f"(gate {TP_GATES[gate[0]]}), logits {devs[1]:.3e} (gate "
                    f"{TP_GATES[gate[1]]}); kernel-1 launches "
                    f"{got['counts']['masked_attention_fused']} (head-mean "
                    f"variant, expected {depth}) at heads {got['heads']}")
                if not ok:
                    fails.append(f"{name} rank {rank}: {devs}, "
                                 f"{got['counts']}, {got['heads']}")
        # ViT-H/14
        hh = [r["huge"] for r in ranks]
        for rank, h in enumerate(hh):
            add(h["counts"])
            ok = h["counts"]["masked_attention_fused"] == 64 and \
                h["counts"]["masked_attention_bwd"] == 32 and \
                h["counts"][W80] == 64 and h["counts"][BWD80] == 32 and \
                h["heads"] == [8] and np.isfinite(h["loss"])
            say(f"tp path ViT-H/14 mixed step, rank {rank} (B={huge_batch}): "
                f"loss {h['loss']:.6f} (one rank {huge_one[0]:.6f}); kernel 1 "
                f"{h['counts'][W80]} and backward {h['counts'][BWD80]} at "
                f"head width 80, {h['heads']} heads a rank (expected 64 / 32, "
                f"[8]); "
                f"peak {h['peak'] / 2**30:.2f} GiB (one rank alone "
                f"{huge_one[1] / 2**30:.2f}); parameter bytes "
                f"{h['param_bytes']} of {h['full_param_bytes']}")
            if not ok:
                fails.append(f"ViT-H/14 rank {rank}: {h['counts']}, "
                             f"{h['heads']}, loss {h['loss']}")
        if hh[0]["whole_digest"] != hh[1]["whole_digest"]:
            fails.append("ViT-H/14: the replicated leaves differ between "
                         "ranks")
        h32 = ranks[0]["huge32"]
        for r in ranks:
            add(r["huge32"]["counts"])
        d_loss = abs(h32["loss"] - h32["one_loss"])
        launches_ok = all(
            r["huge32"]["counts"]["masked_attention_fused"] == 64
            and r["huge32"]["counts"]["masked_attention_bwd"] == 32
            and r["huge32"]["counts"][W80] == 64
            and r["huge32"]["counts"][BWD80] == 32
            and r["huge32"]["heads"] == [8] for r in ranks)
        say(f"tp path ViT-H/14 f32 step (B={huge32}, 8 heads of 80 a rank) vs "
            f"one rank: loss {h32['loss']:.6f} vs {h32['one_loss']:.6f} (diff "
            f"{d_loss:.3e}, tol {TRAIN_TOL['loss']}), parameter changes max "
            f"abs dev {h32['worst']:.3e} (atol {atol}, rtol {rtol}); launches "
            f"a rank {h32['counts'][W80]} / {h32['counts'][BWD80]} at width "
            f"80 (expected 64 / 32) held on both ranks: {launches_ok}")
        if d_loss > TRAIN_TOL["loss"] or h32["bad"] or not launches_ok:
            fails.append(f"ViT-H/14 f32 tp step vs one rank: loss {d_loss}, "
                         f"{h32['bad']}, launches "
                         f"{[r['huge32']['counts'] for r in ranks]}")
        # the pipeline
        pp = [r["pipeline"] for r in ranks]
        for m_ in (2, 4):
            devs = [max(float((p[f"fwd{m_}"][k] - ref["pipeline"][k]).abs()
                              .max()) for p in pp)
                    for k in ("rollout_row", "logits")]
            say(f"pipeline path, 2 stages, M = {m_}, f32 B={batch32} vs one "
                f"rank (per-sample norm): rollout row {devs[0]:.3e} (gate "
                f"{TP_GATES['row32']}), logits {devs[1]:.3e} (gate "
                f"{TP_GATES['logits32']})")
            if devs[0] > TP_GATES["row32"] or devs[1] > TP_GATES["logits32"]:
                fails.append(f"pipeline_forward M={m_}: {devs}")
        d_loss = abs(pp[0]["loss"] - p_loss)
        worst, bad = delta_excess(pp[0]["state"], p_one, before, (atol, rtol))
        launched = sum(v for p in pp for v in p["counts"].values())
        say(f"pipeline path pipeline_train_step (M = 2) vs one-rank "
            f"train_step: loss {d_loss:.3e}, parameter changes max abs dev "
            f"{worst:.3e}; blocks a stage {pp[0]['blocks']} / "
            f"{pp[1]['blocks']}, block bytes {pp[0]['block_bytes']} / "
            f"{pp[1]['block_bytes']}; kernel "
            f"launches {launched} (expected 0: the eager path)")
        if d_loss > TRAIN_TOL["loss"] or bad or launched or \
                [len(p["blocks"]) for p in pp] != [depth // 2] * 2:
            fails.append(f"pipeline step: loss {d_loss}, {bad}, launches "
                         f"{launched}, blocks {[p['blocks'] for p in pp]}")
        if fails:
            raise AssertionError("tp path: " + "; ".join(fails))
        return counts
    return check


# phase 23, sequence-parallel training of ViT-L/16@384 and the batch-sharded
# serving artifact: two gloo ranks share the card on a (1, 2) grid
SP_MIXED_STEPS = 3
SP_EXPORT_RUNS = (   # serving mode, launches a rank and call
    ("int8", {"masked_attention_fused": 12, "linear_int8_fused": 49}),
    ("bf16", {"masked_attention_fused": 12}))
# the data-parallel artifact against the one-rank artifact, CAM and logits
SP_EXPORT_GATES = {"int8": {"cam": 1e-3, "logits": 1e-1},
                   "bf16": {"cam": 5e-2, "logits": 5e-2}}


def _sp_timed(meshlib, steplib, tm):
    """Wrap the sequence group's collectives of a train step with
    synchronising host timers that add to ``tm`` (ms): the all-gathers (K
    and V of every block, again in the remat recompute, and the tokens
    before the heads), the group sums (dK, dV in the backward and the
    gradient sum) and the gradient sum alone.  Returns the undo."""
    orig = (meshlib.SeqMesh.all_gather, meshlib.SeqMesh.inner_sum,
            steplib.seq_sum_grads)

    def timed(fn, key):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            tm[key] = tm.get(key, 0.0) + 1e3 * (time.perf_counter() - t0)
            tm[key + "_calls"] = tm.get(key + "_calls", 0) + 1
            return r
        return call
    meshlib.SeqMesh.all_gather = timed(orig[0], "gathers")
    meshlib.SeqMesh.inner_sum = timed(orig[1], "sums")
    steplib.seq_sum_grads = timed(orig[2], "grad_sum")

    def undo():
        meshlib.SeqMesh.all_gather, meshlib.SeqMesh.inner_sum, \
            steplib.seq_sum_grads = orig
    return undo


def _sp_rank(workdir):
    """One rank of phase 23 (spawned by ``parallel.worker.launch``) on the
    (1, 2) ('data', 'seq') grid: ViT-L/16@384 (copied from the seeded model
    the parent built) takes a float32 step, then SP_MIXED_STEPS
    mixed-precision steps and one more with its collectives timed; the
    trained weights are served in bf16 by the sequence-parallel kernel
    (sequence rank 0 also runs the unsharded kernel path alone); then on
    the ('data',) mesh of both ranks ``cli.export --data_parallel`` of
    ViT-B/16 in int8 and bf16 with ``--check``, each artifact called on the
    rank's rows, and ``serve_artifact`` of the int8 one.  Launch counts are
    set to 0 before each section and read after it."""
    from vision_transformer_cam_tpu_torch import serving
    from vision_transformer_cam_tpu_torch.cli import export as ecli
    from vision_transformer_cam_tpu_torch.examples import serve_artifact
    from vision_transformer_cam_tpu_torch.kernels import ops as kops
    from vision_transformer_cam_tpu_torch.ops.rollout import (
        cam_from_rollout_row)
    from vision_transformer_cam_tpu_torch.parallel import mesh as meshlib
    from vision_transformer_cam_tpu_torch.scripts.dryrun_multichip import (
        host_state, param_digest)
    from vision_transformer_cam_tpu_torch.train import state as statelib
    from vision_transformer_cam_tpu_torch.train import step as steplib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    meshlib.distributed_init("cuda")
    mesh = meshlib.make_mesh((1, 2), ("data", "seq"))
    d = torch.load(os.path.join(workdir, "sp_inputs.pt"), weights_only=False)
    out = {"transport": mesh.transport("cuda")}
    main = mesh.inner_rank == 0

    def fresh(cfg, optim, batch):
        m = torch.load(os.path.join(workdir, "sp_model.pt"),
                       map_location="cuda", weights_only=False)
        m.cfg = cfg
        opt, _ = statelib.make_optimizer(m, optim, batch, 100)
        return statelib.create_train_state(m, opt)

    # (a) the float32 step against one rank's
    state = fresh(d["cfg32"], d["optim"], 2)
    x, y = (t.cuda() for t in d["f32"])
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with meshlib.set_mesh(mesh):
        state, m = steplib.train_step(state, x, y)
        res = {"loss": float(m["loss"])}
    res.update(counts=read_counts(), peak=torch.cuda.max_memory_allocated(),
               digest=param_digest(state.model))
    if main:
        res["state"] = host_state(state.model.state_dict())
    out["f32"] = res
    del state
    gc_cuda()

    # (a) the mixed-precision steps on one batch (the last one's wall, ended
    # by the loss read, is the step's time), then one timed by collective
    state = fresh(d["cfg_mixed"], d["mixed_optim"], 4)
    x, y = (t.cuda() for t in d["mixed"])
    res = {"loss": [], "digests": [], "counts": []}
    torch.cuda.reset_peak_memory_stats()
    with meshlib.set_mesh(mesh):
        for _ in range(SP_MIXED_STEPS):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = steplib.train_step(state, x, y)
            res["loss"].append(float(m["loss"]))
            res["step_ms"] = 1e3 * (time.perf_counter() - t0)
            res["counts"].append(read_counts())
            res["digests"].append(param_digest(state.model))
        res["peak"] = torch.cuda.max_memory_allocated()
        tm = {}
        undo = _sp_timed(meshlib, steplib, tm)
        try:
            t0 = time.perf_counter()
            state, m = steplib.train_step(state, x, y)
            float(m["loss"])
            res["timed_step_ms"] = 1e3 * (time.perf_counter() - t0)
        finally:
            undo()
    res["collectives"] = tm
    out["mixed"] = res

    # (b) the trained weights served by the seq kernel, bf16
    model = state.model
    del state
    gc_cuda()
    model.requires_grad_(False)
    serving.apply_serving_mode(model, "bf16")
    model.cfg = meshlib.apply_seq_parallel(model.cfg)
    xc = d["cam_x"].cuda()
    reset_counts()
    with meshlib.set_mesh(mesh):
        o = model(xc, need_rollout=True)
    torch.cuda.synchronize()
    res = {"counts": read_counts()}
    if main:
        model.cfg = model.cfg.replace(seq_axis=None, data_axis=None)
        reset_counts()
        want = model(xc, need_rollout=True)
        torch.cuda.synchronize()
        res["one_counts"] = read_counts()
        grid = model.cfg.grid_size
        res["cam_dev"] = float((cam_from_rollout_row(o.rollout_row, grid)
                                - cam_from_rollout_row(want.rollout_row,
                                                       grid)).abs().max())
        res["logits_dev"] = float((o.logits.float() - want.logits.float())
                                  .abs().max())
        res["finite"] = bool(torch.isfinite(o.logits.float()).all())
    out["serve"] = res
    del model, o
    gc_cuda()

    # (c) cli.export --data_parallel on both ranks, ViT-B/16
    x64 = d["x64"]
    local = x64.shape[0] // meshlib.get_world_size()
    rows = x64[meshlib.get_rank() * local:(meshlib.get_rank() + 1) * local]
    for mode, _ in SP_EXPORT_RUNS:
        art = os.path.join(workdir, f"dp_{mode}.pt2")
        argv = ["--serving", mode, "--batch", str(x64.shape[0]),
                "--calib_npy", d["calib"], "--out", art, "--check",
                "--data_parallel"] + d["weights_argv"]
        reset_counts()
        t0 = time.perf_counter()
        _, text = _capture(ecli.main, argv)
        torch.cuda.synchronize()
        res = {"wall": time.perf_counter() - t0, "text": text,
               "check_counts": read_counts()}
        with open(art + ".json") as f:
            res["meta"] = json.load(f)
        program = kops.load_program(art, "cuda").module()
        with torch.no_grad():
            reset_counts()
            got = program(rows.cuda())
            torch.cuda.synchronize()
        res["counts"] = read_counts()
        res["out"] = [g.float().cpu() for g in got]
        out[f"export_{mode}"] = res
        gc_cuda()
    reset_counts()
    rc, text = _capture(serve_artifact.main, [
        "--artifact", os.path.join(workdir, "dp_int8.pt2"), "--images",
        d["jpegs"], "--out", os.path.join(workdir, "served_dp")])
    torch.cuda.synchronize()
    out["serve_artifact"] = {"rc": rc, "text": text, "counts": read_counts()}
    return out


def sp_prepare(work, batch32=2, batch=4, cam_batch=4, weights=QUALITY_PARAMS):
    """Phase 23's part in this process, before its ranks (``_sp_rank``) run
    in ``parallel_path``'s spawn: ViT-L/16@384 built once and its one-rank
    steps, the export inputs, the ranks' inputs saved into ``work``.
    Returns the check of the ranks' results, ``check(ranks) -> launch
    counts``.

    Phase 23: sequence-parallel training of ViT-L/16@384 at full width
    and depth (24 layers, C = 1024, N = 577 over two ranks: 289 and 288
    rows, padded to 578) on the eager path, two gloo ranks sharing the card:
    a float32 step at batch 2 against one rank's (TRAIN_TOL), three
    mixed-precision steps at batch 4 (float32 masters, remat: losses finite
    and falling, every leaf bit-equal on both ranks after each), each
    rank's peak memory beside one rank's, the ms of the K/V gathers and of
    the gradient sum; the trained weights served in bf16 by the
    sequence-parallel kernel (24 launches a rank and forward) against one
    rank's unsharded kernel path (SEQ_GATES); ``cli.export --data_parallel``
    of ViT-B/16 (phase 16's weights where that phase ran) at global batch
    64 in int8 and bf16 by the two ranks (``--check`` bit for bit on each,
    the sidecar's ``nr_devices`` 2, each rank's launches a call), against
    the one-rank artifact at batch 64, and ``serve_artifact`` of the int8
    one on both ranks."""
    import PIL.Image
    from vision_transformer_cam_tpu_torch import configs
    from vision_transformer_cam_tpu_torch.cli import export as ecli
    from vision_transformer_cam_tpu_torch.data.transforms import (
        load_and_preprocess)
    from vision_transformer_cam_tpu_torch.kernels import ops as kops
    from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
    from vision_transformer_cam_tpu_torch.scripts import quality_eval as qe
    from vision_transformer_cam_tpu_torch.scripts.dryrun_multichip import (
        OPTIM, delta_excess)
    from vision_transformer_cam_tpu_torch.train import state as statelib
    from vision_transformer_cam_tpu_torch.train import step as steplib
    phase = "seq train path"
    t_phase = time.perf_counter()
    gc_cuda()
    optim = configs.OptimConfig(**OPTIM)
    mixed_optim = configs.OptimConfig(lr=1e-4, warmup_epochs=0, epochs=10,
                                      linear_lr_scaling=False, clip_grad=1.0)
    cfg = configs.vit_large_patch16_384(num_classes=20).replace(
        representation_size=None, attn_impl="eager")
    seq = dict(data_axis="data", seq_axis="seq")
    cfg32 = cfg.replace(remat=False)
    cfg_mixed = cfg.replace(dtype=torch.bfloat16, remat=True)
    weights_argv = ["--weights", os.path.join(REPO, weights)] \
        if weights and os.path.exists(os.path.join(REPO, weights)) else []
    counts = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    # the one-rank peaks are read net of what the earlier phases left
    # allocated in this process (a rank starts empty)
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = ViTCAM(cfg32, device="cuda",
                   generator=torch.Generator().manual_seed(0))
    torch.save(model, os.path.join(work, "sp_model.pt"))
    before = {k: v.detach().cpu().clone()
              for k, v in model.state_dict().items()}
    build_s = time.perf_counter() - t0
    b32, bm = seeded_batch(batch32, 81, size=384), \
        seeded_batch(batch, 82, size=384)
    f32 = tuple(torch.from_numpy(b32[k]) for k in ("image", "label"))
    mixed = tuple(torch.from_numpy(bm[k]) for k in ("image", "label"))
    # one rank: the float32 step, and a mixed step's peak memory
    opt, _ = statelib.make_optimizer(model, optim, batch32, 100)
    st = statelib.create_train_state(model, opt)
    torch.cuda.reset_peak_memory_stats()
    st, met = steplib.train_step(st, *(t.cuda() for t in f32))
    one = {"loss": float(met["loss"]),
           "peak": torch.cuda.max_memory_allocated() - held,
           "state": {k: v.detach().cpu() for k, v in
                     model.state_dict().items()}}
    del st, opt, model
    gc_cuda()
    model = torch.load(os.path.join(work, "sp_model.pt"),
                       map_location="cuda", weights_only=False)
    model.cfg = cfg_mixed
    opt, _ = statelib.make_optimizer(model, mixed_optim, batch, 100)
    st = statelib.create_train_state(model, opt)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    st, met = steplib.train_step(st, *(t.cuda() for t in mixed))
    one["mixed_loss"] = float(met["loss"])
    one["mixed_ms"] = 1e3 * (time.perf_counter() - t1)
    one["mixed_peak"] = torch.cuda.max_memory_allocated() - held
    del st, opt, model
    gc_cuda()

    # the export inputs: quality_eval's calibration batch, 64 seeded
    # images, 70 generated JPEGs
    calib = os.path.join(work, "calib.npy")
    np.save(calib, qe.make_batch(777, 16)[0].numpy())
    x64 = torch.from_numpy(np.random.default_rng(23).standard_normal(
        (EXPORT_BATCH, 224, 224, 3), dtype=np.float32))
    jpegs = os.path.join(work, "jpegs")
    os.makedirs(jpegs)
    images, _ = qe.make_batch(9998, SERVE_IMAGES)
    names = [f"img_{i:03d}" for i in range(SERVE_IMAGES)]
    mean = np.asarray((0.485, 0.456, 0.406), np.float32)
    std = np.asarray((0.229, 0.224, 0.225), np.float32)
    for name, img in zip(names, images.numpy()):
        u8 = np.clip(np.rint((img * std + mean) * 255), 0, 255)
        PIL.Image.fromarray(u8.astype(np.uint8)).save(
            os.path.join(jpegs, name + ".jpg"), quality=95)
    torch.save(dict(cfg32=cfg32.replace(**seq),
                    cfg_mixed=cfg_mixed.replace(**seq), optim=optim,
                    mixed_optim=mixed_optim, f32=f32, mixed=mixed,
                    cam_x=torch.from_numpy(seeded_batch(
                        cam_batch, 83, size=384)["image"]),
                    x64=x64, calib=calib, jpegs=jpegs,
                    weights_argv=weights_argv),
               os.path.join(work, "sp_inputs.pt"))
    say(f"{phase}: ViT-L/16@384 ({cfg.depth} layers, C={cfg.embed_dim}, "
        f"N={cfg.seq_len}: {-(-cfg.seq_len // 2)} + "
        f"{cfg.seq_len - -(-cfg.seq_len // 2)} rows over 2 ranks, padded "
        f"to {2 * -(-cfg.seq_len // 2)}) built once on the host in "
        f"{build_s:.1f} s; one rank: float32 step B={batch32} loss "
        f"{one['loss']:.6f}, peak {one['peak'] / 2**30:.2f} GiB; mixed "
        f"step B={batch} {one['mixed_ms']:.1f} ms, peak "
        f"{one['mixed_peak'] / 2**30:.2f} GiB")
    say(f"{phase}: set up in {time.perf_counter() - t_phase:.1f} s")

    def check(ranks):
        """Phase 23's gates on its ranks' results."""
        ranks = [r["sp"] for r in ranks]
        say(f"{phase}: transport {ranks[0]['transport']}")
        fails = []

        # (a) the float32 step
        r32 = [r["f32"] for r in ranks]
        d_loss = abs(r32[0]["loss"] - one["loss"])
        worst, bad = delta_excess(r32[0]["state"], one["state"], before,
                                  TRAIN_TOL["grad"])
        say(f"{phase} (a) f32 step B={batch32} vs one rank: loss "
            f"{r32[0]['loss']:.6f} vs {one['loss']:.6f} (diff {d_loss:.3e}, "
            f"tol {TRAIN_TOL['loss']}), parameter changes max abs dev "
            f"{worst:.3e} (atol, rtol {TRAIN_TOL['grad']}); peak a rank "
            f"{r32[0]['peak'] / 2**30:.2f} / {r32[1]['peak'] / 2**30:.2f} "
            f"GiB (one rank {one['peak'] / 2**30:.2f}); both ranks' "
            f"parameters bit-equal: {r32[0]['digest'] == r32[1]['digest']}")
        if d_loss > TRAIN_TOL["loss"] or bad or \
                r32[0]["digest"] != r32[1]["digest"]:
            fails.append(f"f32 seq step vs one rank: loss {d_loss}, {bad}")
        # (a) the mixed steps
        mx = [r["mixed"] for r in ranks]
        losses = mx[0]["loss"]
        same = mx[0]["digests"] == mx[1]["digests"] and \
            mx[0]["loss"] == mx[1]["loss"]
        launched = sum(v for r in ranks for c in r["mixed"]["counts"]
                       for v in c.values()) + sum(
            v for r in r32 for v in r["counts"].values())
        tm = mx[0]["collectives"]
        say(f"{phase} (a) mixed B={batch}, {SP_MIXED_STEPS} steps: losses "
            + ", ".join(f"{v:.6f}" for v in losses) + f" (one rank's first "
            f"{one['mixed_loss']:.6f}); every leaf bit-equal on both ranks "
            f"after every step: {same}; kernel launches {launched} (the "
            f"eager path: 0); peak a rank {mx[0]['peak'] / 2**30:.2f} / "
            f"{mx[1]['peak'] / 2**30:.2f} GiB (one rank "
            f"{one['mixed_peak'] / 2**30:.2f}); the last step "
            f"{mx[0]['step_ms']:.1f} ms (one rank alone, its first step, "
            f"{one['mixed_ms']:.1f}); in a step timed by "
            f"collective ({mx[0]['timed_step_ms']:.1f} ms with the "
            f"synchronisations): all-gathers {tm.get('gathers', 0):.1f} ms in "
            f"{tm.get('gathers_calls', 0)} calls (K and V of 24 blocks, "
            f"again in the remat recompute, the tokens), group sums of dK, "
            f"dV {tm.get('sums', 0) - tm.get('grad_sum', 0):.1f} ms, the "
            f"gradient sum {tm.get('grad_sum', 0):.1f} ms; NOT a scaling "
            "figure: both ranks share the card and gloo stages every "
            "collective through host memory")
        if not same or launched or not all(np.isfinite(losses)) or \
                not losses[-1] < losses[0]:
            fails.append(f"mixed seq steps: losses {losses}, bit-equal "
                         f"{same}, launches {launched}")
        # (b) the seq kernel on the trained weights
        sv = [r["serve"] for r in ranks]
        for s in sv:
            add(s["counts"])
        seq_ok = all(s["counts"]["masked_attention_seq_local"] == cfg.depth
                     and s["counts"]["masked_attention_fused"] == 0
                     for s in sv) and \
            sv[0]["one_counts"]["masked_attention_fused"] == cfg.depth
        say(f"{phase} (b) bf16 serving of the trained weights, B={cam_batch}, "
            f"seq kernel vs one rank's unsharded kernel path: CAM "
            f"{sv[0]['cam_dev']:.3e} (gate {SEQ_GATES['cam']}), logits "
            f"{sv[0]['logits_dev']:.3e} (gate {SEQ_GATES['logits']}); seq "
            f"launches a rank {[s['counts']['masked_attention_seq_local'] for s in sv]}"
            f" (expected {cfg.depth} each), kernel 1 alone "
            f"{sv[0]['one_counts']['masked_attention_fused']}")
        if sv[0]["cam_dev"] > SEQ_GATES["cam"] or \
                sv[0]["logits_dev"] > SEQ_GATES["logits"] or not seq_ok or \
                not sv[0]["finite"]:
            fails.append(f"seq serving: {sv[0]}, launches ok {seq_ok}")

        # (c) the data-parallel artifact against the one-rank artifact
        programs = {}
        for mode, per_fwd in SP_EXPORT_RUNS:
            one_out = os.path.join(work, f"one_{mode}.pt2")
            args = ["--serving", mode, "--batch", str(EXPORT_BATCH),
                    "--calib_npy", calib, "--out", one_out] + weights_argv
            _capture(ecli.main, args)
            programs[mode] = kops.load_program(one_out, "cuda").module()
            with torch.no_grad():
                want = [w.float().cpu() for w in programs[mode](x64.cuda())]
            got = [torch.cat(parts) for parts in zip(
                *(r[f"export_{mode}"]["out"] for r in ranks))]
            devs = {k: float((got[i] - want[i]).abs().max())
                    for k, i in (("logits", 0), ("cam", 2))}
            devs["head1"] = float((got[1] - want[1]).abs().max())
            ex = [r[f"export_{mode}"] for r in ranks]
            checks = [f"bit-identical) on rank {i}'s rows" in e["text"]
                      for i, e in enumerate(ex)]
            want_check = {k: 2 * v for k, v in per_fwd.items()}
            counts_ok = all(
                {k: v for k, v in e["check_counts"].items() if v}
                == want_check and {k: v for k, v in e["counts"].items()
                                   if v} == per_fwd for e in ex)
            for e in ex:
                add(e["check_counts"])
                add(e["counts"])
            gate = SP_EXPORT_GATES[mode]
            say(f"{phase} (c) export --data_parallel {mode}, global batch "
                f"{EXPORT_BATCH} ({EXPORT_BATCH // 2} a rank; weights "
                f"{'phase 16' if weights_argv else 'seeded'}): --check "
                f"bit for bit on each rank {checks}, export + check "
                f"{ex[0]['wall']:.1f} / {ex[1]['wall']:.1f} s; sidecar "
                f"nr_devices {ex[0]['meta']['nr_devices']}, batch "
                f"{ex[0]['meta']['batch']}; launches a rank and call "
                f"{ex[0]['counts']} / {ex[1]['counts']} (expected "
                f"{per_fwd}); vs the one-rank artifact at batch "
                f"{EXPORT_BATCH}: CAM {devs['cam']:.3e} (gate {gate['cam']}), "
                f"logits {devs['logits']:.3e} (gate {gate['logits']}), head1 "
                f"{devs['head1']:.3e}")
            if not all(checks) or ex[0]["meta"]["nr_devices"] != 2 or \
                    not counts_ok or devs["cam"] > gate["cam"] or \
                    devs["logits"] > gate["logits"]:
                fails.append(f"export --data_parallel {mode}: checks "
                             f"{checks}, counts ok {counts_ok}, {devs}")
        # serve_artifact on both ranks: rank 0 writes and prints
        sa = [r["serve_artifact"] for r in ranks]
        n_calls = -(-SERVE_IMAGES // EXPORT_BATCH)
        for s in sa:
            add(s["counts"])
        sa_counts_ok = all(
            {k: v for k, v in s["counts"].items() if v} ==
            {k: v * n_calls for k, v in SP_EXPORT_RUNS[0][1].items()}
            for s in sa)
        xs = np.zeros((n_calls * EXPORT_BATCH, 224, 224, 3), np.float32)
        for i, name in enumerate(names):
            xs[i] = load_and_preprocess(os.path.join(jpegs, name + ".jpg"),
                                        224, mean, std)
        probs = []
        with torch.no_grad():
            for lo in range(0, len(xs), EXPORT_BATCH):
                h1 = programs["int8"](torch.from_numpy(
                    xs[lo:lo + EXPORT_BATCH]).cuda())[1]
                probs.append(1.0 / (1.0 + np.exp(
                    -h1.float().cpu().numpy().astype(np.float64))))
        del programs
        gc_cuda()
        want_lines = served_lines(np.concatenate(probs)[:SERVE_IMAGES], names)
        got_lines = [ln for ln in sa[0]["text"].splitlines()
                     if ln.startswith("  img_")]
        overlays = len(os.listdir(os.path.join(work, "served_dp")))
        say(f"{phase} (c) serve_artifact of the int8 artifact on 2 ranks: "
            f"{SERVE_IMAGES} JPEGs, rc {[s['rc'] for s in sa]}, {overlays} "
            f"overlays, rank 1 printed {len(sa[1]['text'].splitlines())} "
            f"lines; launches a rank {sa[0]['counts']} (held: "
            f"{sa_counts_ok}); rank 0's classes equal the one-rank "
            f"artifact's: {got_lines == want_lines}")
        if any(s["rc"] for s in sa) or overlays != SERVE_IMAGES or \
                len(got_lines) != SERVE_IMAGES or not sa_counts_ok:
            fails.append(f"serve_artifact on 2 ranks: rc "
                         f"{[s['rc'] for s in sa]}, {overlays} overlays, "
                         f"{len(got_lines)} lines, counts ok {sa_counts_ok}")
        say(f"{phase}: launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        if fails:
            raise AssertionError(f"{phase}: " + "; ".join(fails))
        return counts
    return check


def _parallel_rank(workdir):
    """One rank of phases 21, 22 and 23, all run by one spawn of two ranks
    on one process group: phase 21's training sections
    (``_dp_train_rank``) and its ``cli.validate --data_parallel`` runs
    (``_dp_validate_rank``, in the faked tree), phase 22's sections
    (``_tp_rank``), then phase 23's (``_sp_rank``).  Returns every result
    and each phase's wall time."""
    t = [time.perf_counter()]
    dp = torch.load(os.path.join(workdir, "dp_ranks.pt"))
    train = _dp_train_rank(workdir, dp["batch32"], dp["batch"])
    gc_cuda()
    cwd = os.getcwd()
    os.chdir(dp["root"])
    try:
        validate = _dp_validate_rank(dp["argvs"])
    finally:
        os.chdir(cwd)
    gc_cuda()
    t.append(time.perf_counter())
    tp = _tp_rank(workdir)
    gc_cuda()
    t.append(time.perf_counter())
    sp = _sp_rank(workdir)
    t.append(time.perf_counter())
    return {"train": train, "validate": validate, "tp": tp, "sp": sp,
            "seconds": [b - a for a, b in zip(t, t[1:])]}


def parallel_path():
    """Phases 21 (data parallelism), 22 (tensor parallelism and the
    pipeline) and 23 (sequence-parallel training and the batch-sharded
    artifact) in one spawn of two gloo ranks sharing the card, with every
    check, gate, depth and width each phase has (``dp_prepare``,
    ``tp_prepare``, ``sp_prepare``): the parent sets up the three, the
    ranks run their sections in turn, the parent checks the three.  Returns
    each phase's launch counts."""
    import tempfile

    from vision_transformer_cam_tpu_torch.parallel.worker import launch
    with tempfile.TemporaryDirectory() as work:
        t = [time.perf_counter()]
        checks = []
        for prepare in (dp_prepare, tp_prepare, sp_prepare):
            checks.append(prepare(work))
            t.append(time.perf_counter())
        ranks = launch(_parallel_rank, (work,), world=2, timeout=1200)
        t.append(time.perf_counter())
        secs = ranks[0]["seconds"]
        say(f"phases 21-23: set-up {t[1] - t[0]:.1f} / {t[2] - t[1]:.1f} / "
            f"{t[3] - t[2]:.1f} s; one spawn of 2 ranks {t[4] - t[3]:.1f} s "
            f"with the processes' start, rank 0's sections {secs[0]:.1f} / "
            f"{secs[1]:.1f} / {secs[2]:.1f} s (21 / 22 / 23)")
        counts = [check(ranks) for check in checks]
        say(f"phases 21-23: the checks {time.perf_counter() - t[4]:.1f} s")
    return counts


def v1_inputs(b, n, heads, dtype, seed, bg_kind="30%", dh=64, grid=False):
    """Split q, k, v [B, H, N, dh] with hot query rows 1-3 (logits of order
    1e2) and a background of the given kind; the cls column may be
    background too, the pair mask has no special column.  With ``grid`` the
    normals are rounded to multiples of 1/8 first, so that every dot
    product of QK^T is exact in float32 whatever the order of its sums."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((b, heads, n, dh), generator=g, device="cuda")
               for _ in range(3))
    if grid:
        q, k, v = (torch.round(t * 8.0) / 8.0 for t in (q, k, v))
    q[:, :, 1:4] *= 40.0
    share = {"none": 0.0, "30%": 0.3, "all": 1.1}[bg_kind]
    bg = (torch.rand((b, n), generator=g, device="cuda") < share).float()
    return tuple(t.to(dtype).contiguous() for t in (q, k, v)), bg


def _switched(module, name, value, fn, *args, **kw):
    """``fn(*args, **kw)`` with ``module.name`` (a private design switch) set
    to ``value`` for the call."""
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        return fn(*args, **kw)
    finally:
        setattr(module, name, saved)


def check_attention_v1():
    """The split-tensor kernel (masked_attention) against its plain version on
    the card, in every design that takes the dtype (bf16: the tensor-core
    design, launched twice for identical bits, and the FMA design it ran
    before; float32: the FMA design): with and without the head mean, 30 %
    background, none and all; B=8 N=197, a ragged B=3 N=37, and B=2 N=577.
    Returns the worst error of the bf16 cases at N=197 without the head mean
    in the tensor-core design."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    failures, kept = [], 0.0
    for (b, n) in ((8, 197), (3, 37), (2, 577)):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            for bi, bg_kind in enumerate(("30%", "none", "all")):
                (q, k, v), bg = v1_inputs(b, n, 12, dtype, 7 * n + bi, bg_kind)
                for hm in (False, True):
                    kw = dict(scale=64 ** -0.5, with_headmean=hm)
                    want = ka.masked_attention_ref(q, k, v, bg, **kw)
                    tols = [TOL[(dtype, "out")], TOL[(dtype, "prob")],
                            TOL[(dtype, "prob")]]
                    for design in fwd_designs(dtype):
                        got = _switched(ka, "_v1_bf16_design", design,
                                        ka.masked_attention, q, k, v, bg, **kw)
                        torch.cuda.synchronize()
                        case = (f"attention v1 {design:11s} {name:8s} "
                                f"hm={hm!s:5s} bg={bg_kind:4s} B={b} N={n}")
                        err = _compare(case, got, want, tols, failures)
                        if design == "tensor-core":
                            again = ka.masked_attention(q, k, v, bg, **kw)
                            if not all(torch.equal(x, y)
                                       for x, y in zip(got, again)):
                                failures.append(f"{case}: a second launch "
                                                "gave other bits")
                            if n == 197 and not hm:
                                kept = max(kept, err)
    if failures:
        raise AssertionError("split-tensor attention kernel != plain version:"
                             "\n" + "\n".join(failures))
    return kept


def time_attention_v1(b=64, n=197, heads=12, dh=64):
    """The split-tensor kernel at B, N, heads of ``dh`` (B=64 N=197 12 of 64
    by default) bf16, with and without the head mean, in turns: the
    tensor-core design and the plain version (the FMA design it replaced no
    longer changes and is not timed); beside them the fused kernel's plain
    variant on the same values packed (no clamp) and
    F.scaled_dot_product_attention with the additive [B, 1, N, N] pair mask
    (out only, neither cls row nor head mean: the yardstick for the shape,
    timed only).  Returns ({with_headmean: (kernel ms, plain ms)}, the SDPA
    ms)."""
    import torch.nn.functional as F
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    (q, k, v), bg = v1_inputs(b, n, heads, torch.bfloat16, 5, dh=dh)
    times = {}
    for hm in (False, True):
        kw = dict(scale=dh ** -0.5, with_headmean=hm)
        fns = {"tensor-core": lambda: _switched(
            ka, "_v1_bf16_design", "tensor-core", ka.masked_attention, q, k,
            v, bg, **kw)}
        fns["plain"] = lambda: ka.masked_attention_ref(q, k, v, bg, **kw)
        ms = round_robin(fns)
        times[hm] = (ms["tensor-core"], ms["plain"])
    qkv = torch.stack([q, k, v]).permute(1, 3, 0, 2, 4).reshape(
        b, n, 3 * heads * dh).contiguous()
    fused = time_ms(lambda: ka.masked_attention_fused(
        qkv, bg, num_heads=heads, scale=dh ** -0.5))
    pair = (torch.clamp_max(bg[:, :, None] + bg[:, None, :], 1.0)
            * -100.0)[:, None].to(torch.bfloat16)
    sdpa = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=pair, scale=dh ** -0.5))
    say(f"time attention v1 bf16 B={b} N={n} {heads} heads of {dh}, in "
        f"turns: tensor-core "
        f"{times[False][0]:.4f} ms, "
        f"plain {times[False][1]:.4f} ms; with the head mean tensor-core "
        f"{times[True][0]:.4f} ms, plain "
        f"{times[True][1]:.4f} ms; the fused kernel's plain variant on the "
        f"packed values {fused:.4f} ms; F.scaled_dot_product_attention (out "
        f"only) {sdpa:.4f} ms")
    return times, sdpa


# Kernel 1 at head width 80 (ViT-H/14: 16 heads of 80), the shapes its
# phase holds it at: ViT-H's N = 257, a ragged N = 37, and N = 577
W80_SHAPES = ((8, 257), (3, 37), (2, 577))
# a tensor-parallel rank's share of ViT-H/14 at m = 2, in the float dtypes
# its training and CAMs run: B = 8, N = 257, 8 heads of 80
W80_TP_CASE = (8, 257, 8)


def _w80_scales(opt, sc):
    """The scales vector of an int8 option at 16 heads."""
    if opt == "per_head":
        return torch.cat([sc, torch.tensor([20.0], device="cuda")])
    if opt == "per_tensor":
        return torch.tensor([0.3, 0.02, 0.02, 20.0], device="cuda")
    if opt == "int8_out":
        return torch.tensor([20.0], device="cuda")
    return None


def kernel1_case(b, n, h, dh, kinds, failures, seed, on_tc=None):
    """Kernel 1 at [B, N, H x dh] against its plain version: each (dtype,
    int8 option) of ``kinds``, each variant, clamp off and on, in every
    design that takes the dtype (the tensor-core design launched twice for
    identical bits), at the width-80 gates (TOL, TOL_JOINT, int8 within one
    step).  ``on_tc(case, variant, clamp, got, call)`` runs after each
    tensor-core check.  Returns {(kind, variant, clamp, design): worst
    error}."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    errs = {}
    for dtype, opt in kinds:
        qkv, bg, joint, sc = attention_inputs(b, n, h, dtype, seed=seed,
                                              dh=dh)
        scales = _w80_scales(opt, sc)
        fdt = torch.bfloat16 if dtype == torch.int8 else dtype
        kind = opt or str(dtype).split(".")[-1]
        for variant in VARIANTS:
            for clamp in (False, True):
                want = _call(ka.masked_attention_fused_ref, variant, qkv, bg,
                             joint, h, clamp, scales)
                tols = [None if scales is not None else TOL[(fdt, "out")],
                        TOL[(fdt, "prob")],
                        TOL_JOINT if variant == "rollout"
                        else TOL[(fdt, "prob")]]

                def call(**extra):
                    return _call(ka.masked_attention_fused, variant, qkv, bg,
                                 joint, h, clamp, scales, **extra)
                for design in fwd_designs(dtype):
                    got = _fwd_design(design, call)
                    torch.cuda.synchronize()
                    case = f"attention dh={dh} {design:11s} {kind:10s} " \
                           f"{variant:8s} clamp={clamp!s:5s} B={b} N={n} " \
                           f"H={h}"
                    errs[(kind, variant, clamp, design)] = _compare(
                        case, got, want, tols, failures)
                    if design != "tensor-core":
                        continue
                    if not all(torch.equal(x, y)
                               for x, y in zip(got, call())):
                        failures.append(f"{case}: a second launch gave "
                                        "other bits")
                    if on_tc is not None:
                        on_tc(case, variant, clamp, got, call)
        del qkv, joint
    return errs


# kernel 1's dtypes and int8 options at a width: bf16, float32, int8_io with
# per-head and per-tensor scales, int8_out
KERNEL1_KINDS = ((torch.bfloat16, None), (torch.float32, None),
                 (torch.int8, "per_head"), (torch.int8, "per_tensor"),
                 (torch.bfloat16, "int8_out"))


def check_attention_w80(heads=16):
    """Kernel 1 at head width 80 against its plain version, as
    check_attention holds it at 64: float32 (the FMA design), bf16 (the
    tensor-core design, launched twice for identical bits, and the FMA
    design behind ``_fwd_bf16_design``), int8_io with per-head and per-tensor
    scales and int8_out, each variant, clamp on and off, at W80_SHAPES, and
    bf16 and float32 at W80_TP_CASE's 8 heads; the tensor-core design's
    q_block 32 (two m16 tiles) bit for bit its 16 at N = 257; at N = 1025
    q_block 16 against the plain version and a forced 32 refused with the
    bytes it needs; head width 48 refused naming the compiled widths.
    Returns {(kind, variant, clamp, n): worst error} of the path's design
    at ``heads``."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    errs, failures = {}, []
    cases = [(b, n, heads, KERNEL1_KINDS) for (b, n) in W80_SHAPES] + \
        [(*W80_TP_CASE, KERNEL1_KINDS[:2])]
    for (b, n, h, case_kinds) in cases:

        def q_block_32(case, variant, clamp, got, call, n=n, h=h):
            if n != 257 or not clamp or h != heads:
                return
            wide = call(q_block=32)
            torch.cuda.synchronize()
            same = [torch.equal(x, y) for x, y in zip(got, wide)]
            d3 = float((got[-1].float() - wide[-1].float()).abs().max())
            say(f"check {case}: q_block 32 vs 16 bit-identical {same} "
                f"(third max abs dev {d3:.2e})")
            if not (same[0] and same[1]) or d3 > 1e-6 or (
                    variant == "headmean" and not same[2]):
                failures.append(f"{case}: q_block 32 != 16")
        got = kernel1_case(b, n, h, 80, case_kinds, failures, seed=n,
                           on_tc=q_block_32)
        if h == heads:
            for (kind, variant, clamp, design), err in got.items():
                dtype = torch.float32 if kind == "float32" else torch.int8 \
                    if kind.startswith("per_") else torch.bfloat16
                if design == fwd_designs(dtype)[0]:
                    errs[(kind, variant, clamp, n)] = err
    # past the FMA design's [32, N] tiles: q_block 16 holds, 32 is refused
    refused = ""
    for dtype in (torch.bfloat16, torch.float32):
        qkv, bg, joint, _ = attention_inputs(1, 1025, heads, dtype, seed=63,
                                             dh=80)
        name = str(dtype).split(".")[-1]
        want = _call(ka.masked_attention_fused_ref, "rollout", qkv, bg, joint,
                     heads, True)
        got = _call(ka.masked_attention_fused, "rollout", qkv, bg, joint,
                    heads, True, q_block=16)
        torch.cuda.synchronize()
        _compare(f"attention dh=80 q_block=16 {name:8s} rollout B=1 N=1025",
                 got, want, [TOL[(dtype, "out")], TOL[(dtype, "prob")],
                             TOL_JOINT], failures)
        try:
            _call(ka.masked_attention_fused, "rollout", qkv, bg, joint, heads,
                  True, q_block=32)
            failures.append(f"q_block=32 at N=1025, head width 80, {name}: "
                            "not refused")
        except RuntimeError as e:
            refused = str(e)
    say(f"check q_block=32 at N=1025, head width 80 is refused: "
        f"{refused[:200]}")
    qkv, bg, _, _ = attention_inputs(2, 37, 4, torch.bfloat16, seed=64, dh=48)
    try:
        _call(ka.masked_attention_fused, "plain", qkv, bg, None, 4, True)
        failures.append("head width 48 was not refused")
    except ValueError as e:
        say(f"check head width 48 is refused: {e}")
        if "64, 80" not in str(e):
            failures.append(f"head width 48: the message names no widths: {e}")
    if failures:
        raise AssertionError("attention kernel at head width 80 != plain "
                             "version:\n" + "\n".join(failures))
    return errs


def attention_occupancy(cases=((197, 64, 12), (257, 80, 16))):
    """Kernel 1's occupancy on this card for the rollout instance a launch
    takes at (N, head width): every design and dtype that runs it (blocks an
    SM at once, registers and local memory per thread, shared memory per
    block), with the ptxas spill stores of its translation unit from
    build.log.  Returns {(design, dtype name, n, dh): info tuple}."""
    import ctypes

    from vision_transformer_cam_tpu_torch.kernels import _build
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    lib, got = _build.load(), {}
    log = (_build.lib_path().parent / "build.log").read_text()
    for part in re.split(r"^== ", log, flags=re.M)[1:]:
        name, _, body = part.partition("\n")
        if name.startswith("masked_attention"):
            spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                                 body)]
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", body)]
            say(f"occupancy {name}: {len(regs)} entries, registers "
                f"{min(regs)}-{max(regs)}, {sum(1 for x in spills if x)} "
                f"entries spill (max {max(spills, default=0)} bytes)")
    for n, dh, heads in cases:
        for dtype in (torch.bfloat16, torch.int8, torch.float32):
            for design in fwd_designs(dtype):
                info = (ctypes.c_int * 4)()
                err = lib.vitcam_masked_attention_occupancy(
                    n, ka._ROLLOUT, ka._DTYPE_CODES[dtype],
                    ka.FWD_DESIGNS[design], dh, info)
                if err:
                    raise RuntimeError(
                        f"attention occupancy ({design}, {dtype}, N={n}, "
                        f"dh={dh}): cudaError {err} "
                        f"({lib.vitcam_cuda_error_string(err).decode()})")
                name = str(dtype).split(".")[-1]
                got[(design, name, n, dh)] = tuple(info)
                say(f"occupancy attention {design:11s} {name:8s} rollout "
                    f"N={n} dh={dh}: {info[0]} blocks an SM, {info[1]} "
                    f"registers, {info[2]} bytes of local memory per thread, "
                    f"{info[3]} bytes of shared memory per block")
    return got


def attention_bound(b, n, heads, dh, kind, variant="rollout"):
    """Kernel 1's bound at [B, N, H x dh] (each input read once, each output
    written once): ``kind`` bf16 (bf16 qkv, out and cls row), int8_io (int8
    qkv and out, per-head scales, bf16 cls row) or int8_out (bf16 qkv, int8
    out); the rollout variant reads and writes the f32 joint, the head-mean
    one writes the bf16 head mean.  QK^T at the int8 rate under int8_io,
    else bf16, P V at bf16, hm @ J at f32."""
    c, m = heads * dh, b * n
    qk = 2 * b * heads * n * n * dh
    nbytes = m * 4 + m * 2 + {"bf16": m * 3 * c * 2 + m * c * 2,
                              "int8_io": m * 3 * c + (3 * heads + 1) * 4
                              + m * c,
                              "int8_out": m * 3 * c * 2 + 4 + m * c}[kind]
    ops = {"bf16": 2 * qk} if kind != "int8_io" else {"int8": qk, "bf16": qk}
    if variant == "rollout":
        nbytes += 2 * b * n * n * 4
        ops["f32"] = 2 * b * n ** 3
    elif variant == "headmean":
        nbytes += b * n * n * 2
    return bound(f"masked_attention_fused {kind} {variant} B={b} N={n} "
                 f"H={heads} dh={dh}", nbytes, ops)


def time_attention_w80(b=64, n=257, heads=16, dh=80):
    """Kernel 1 at ViT-H/14's shape (B=64, N=257, 16 heads of 80), or at
    [B, N, heads x dh]: bf16 and int8_io rollout (clamp on, the serving
    path's), the tensor-core design and the plain version in turns (the FMA
    design bf16 and int8 ran before no longer changes and is not timed),
    beside the bound and the occupancy.  Returns {kind: (tensor-core ms,
    plain ms, bound ms, bound by)}."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    got = {}
    for kind, dtype in (("bf16", torch.bfloat16), ("int8_io", torch.int8)):
        qkv, bg, joint, sc = attention_inputs(b, n, heads, dtype, seed=5,
                                              dh=dh)
        scales = _w80_scales("per_head" if kind == "int8_io" else None, sc)
        fns = {d: (lambda d=d: _fwd_design(
            d, _call, ka.masked_attention_fused, "rollout", qkv, bg, joint,
            heads, True, scales)) for d in fwd_designs(dtype)[:1]}
        fns["plain"] = lambda: _call(ka.masked_attention_fused_ref, "rollout",
                                     qkv, bg, joint, heads, True, scales)
        ms = round_robin(fns, iters=10)
        t_bound, by = attention_bound(b, n, heads, dh, kind)
        got[kind] = (ms["tensor-core"], ms["plain"], t_bound, by)
        say(f"time attention dh={dh} {kind:8s} rollout B={b} N={n} H={heads}: "
            + ", ".join(f"{d} {t:.4f} ms" for d, t in ms.items())
            + f"; bound {t_bound:.4f} ms ({by}), the tensor-core design at "
              f"{100 * t_bound / ms['tensor-core']:.1f} % of the bound's "
              "rate")
        del qkv, joint
    return got


def time_int8_route(b=32, n=1025, heads=16):
    """The int8 tier's two attention routes at ViT-L/16@512's N = 1025 (16
    heads of 64), the head-mean variant that the model's rollout_post path
    launches there: int8_io (int8 qkv, per-head scales) against int8_out
    (bf16 qkv, int8 out), each held to its plain version, in turns.
    Recorded, not routed: serving.py keeps int8_out past 640 tokens.
    Returns {kind: (ms, bound ms)}."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    inputs, fns, failures = {}, {}, []
    for kind, dtype in (("int8_io", torch.int8), ("int8_out", torch.bfloat16)):
        qkv, bg, _, sc = attention_inputs(b, n, heads, dtype, seed=6)
        scales = _w80_scales("per_head" if kind == "int8_io" else "int8_out",
                             sc)
        inputs[kind] = (qkv, bg, scales)
        one = [t[:1] for t in (qkv, bg)]
        _compare(f"attention {kind} headmean clamp B=1 N={n} H={heads}",
                 _call(ka.masked_attention_fused, "headmean", *one, None,
                       heads, True, scales),
                 _call(ka.masked_attention_fused_ref, "headmean", *one, None,
                       heads, True, scales),
                 [None, TOL[(torch.bfloat16, "prob")],
                  TOL[(torch.bfloat16, "prob")]], failures)
        fns[kind] = (lambda q=qkv, g=bg, s_=scales: _call(
            ka.masked_attention_fused, "headmean", q, g, None, heads, True,
            s_))
    if failures:
        raise AssertionError("int8 routes at N=1025:\n" + "\n".join(failures))
    ms = round_robin(fns, iters=10)
    got = {}
    for kind in fns:
        got[kind] = (ms[kind], attention_bound(b, n, heads, 64, kind,
                                               "headmean")[0])
    say(f"time int8 routes headmean B={b} N={n} H={heads}: " + ", ".join(
        f"{k} {t:.4f} ms (bound {bd:.4f} ms)" for k, (t, bd) in got.items()))
    return got


# Phase 24, kernel 1 and the backward at head widths 16, 32 and 40: the JAX
# kernel tests' fuzz shapes (tests/test_kernel_fuzz.py, B = 2) and the JAX
# quickstart's N = 65 with 4 heads of 16, (B, N, heads, head width)
WIDTH_CASES = ((2, 130, 4, 32), (2, 147, 3, 40), (2, 513, 2, 32),
               (2, 1025, 2, 32), (2, 65, 4, 16))
# each width's timed shape: the quickstart's at B = 64, and the fuzz shapes
# of 32 (N = 1025) and 40 at B = 16 and 64
WIDTH_TIMED = {16: (64, 65, 4, 16), 32: (16, 1025, 2, 32),
               40: (64, 147, 3, 40)}
# the models each width's main path runs through bench.main: the JAX
# quickstart's tiny ViT (16), and ViT-B/16's token grid at C = 128 and 120
WIDTH_MODELS = {
    16: dict(img_size=64, patch_size=8, embed_dim=64, depth=6, num_heads=4,
             mask_from=2, top_k_patches=4),
    32: dict(img_size=224, patch_size=16, embed_dim=128, depth=4,
             num_heads=4, mask_from=2),
    40: dict(img_size=224, patch_size=16, embed_dim=120, depth=4,
             num_heads=3, mask_from=2)}


def check_attention_widths():
    """Kernel 1 (every dtype, int8 option, variant, clamp and design) and
    the backward (every design, both dtypes, both backgrounds, clamp off and
    on) at WIDTH_CASES against their plain versions, at the gates of the
    width-80 rows; head widths 24 and 48 refused by both, naming the
    compiled widths.  Returns ({dh: worst error of kernel 1's bf16 rollout
    serving case}, {dh: worst error of the bf16 tensor-core backward})."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    failures, fwd, bwd = [], {}, {}
    for (b, n, h, dh) in WIDTH_CASES:
        errs = kernel1_case(b, n, h, dh, KERNEL1_KINDS, failures, seed=n)
        fwd[dh] = max(fwd.get(dh, 0.0),
                      errs[("bfloat16", "rollout", True, "tensor-core")])
        for key, err in bwd_case(b, n, h, dh, failures).items():
            if key[0] == "bfloat16" and key[5] == "tensor-core":
                bwd[dh] = max(bwd.get(dh, 0.0), err)
    for dh in (24, 48):
        qkv, bg, d_out = bwd_inputs(1, 37, 2, torch.bfloat16, seed=2, dh=dh)
        for label, call in (
                ("kernel 1", lambda: _call(ka.masked_attention_fused, "plain",
                                           qkv, bg, None, 2, True)),
                ("the backward", lambda: _bwd_call(
                    ka.masked_attention_bwd, qkv, bg, d_out, 2, False))):
            try:
                call()
                failures.append(f"{label} at head width {dh}: not refused")
            except ValueError as e:
                say(f"check {label} at head width {dh} is refused: {e}")
                if "16, 32, 40, 64, 80" not in str(e):
                    failures.append(f"{label} at head width {dh}: {e}")
    if failures:
        raise AssertionError("kernel 1 or the backward at head widths 16, "
                             "32, 40 != plain version:\n"
                             + "\n".join(failures))
    return fwd, bwd


def time_widths():
    """Each new width at WIDTH_TIMED: kernel 1's bf16 and int8_io rollout and
    the plain version (time_attention_w80), and the bf16 backward, the plain
    version and the SDPA backward with the same mask (time_attention_bwd),
    in turns, beside their bounds.
    Returns ({dh: (ms, plain ms, bound ms, bound by)} of kernel 1's bf16
    rollout, {dh: (ms, plain ms, SDPA ms, bound ms, bound by)} of the
    backward)."""
    fwd, bwd = {}, {}
    for dh, (b, n, h, _) in WIDTH_TIMED.items():
        fwd[dh] = time_attention_w80(b, n, h, dh)["bf16"]
        r = time_attention_bwd(((b, n, h, dh),))[(b, n, h, dh)]
        bwd[dh] = (r[0], r[1], r[2], *bwd_bound(b, n, h, dh))
    return fwd, bwd


def widths_main_path():
    """Each new width's model (WIDTH_MODELS, seeded random weights) through
    bench.main: served in bf16 at batch 64 and trained (--train --mixed, remat
    on) at batch 32, its launch counts set to 0 before each run and held
    after it: per forward one kernel-1 launch a layer, per step two (the
    forward and the recompute) and one backward launch a layer, all at the
    model's width.  Returns the summed launch counts."""
    from vision_transformer_cam_tpu_torch import configs
    totals = {}
    for dh, fields in WIDTH_MODELS.items():
        name = f"width{dh}_smoke"
        configs.MODEL_ZOO[name] = lambda num_classes=20, has_logits=False, \
            f=fields: configs.ViTCAMConfig(num_classes=num_classes, **f)
        depth = fields["depth"]
        try:
            for argv, per, times in (
                    (["--model", name, "--batch", "64", "--bf16"],
                     {"masked_attention_fused": depth, FWD_W[dh]: depth},
                     BENCH_FWD),
                    (["--model", name, "--train", "--mixed", "--batch",
                      "32"],
                     {"masked_attention_fused": 2 * depth,
                      FWD_W[dh]: 2 * depth, "masked_attention_bwd": depth,
                      BWD_W[dh]: depth}, BENCH_STEPS)):
                counts = bench_run(argv, {k: v * times
                                          for k, v in per.items()})
                for k, v in counts.items():
                    totals[k] = totals.get(k, 0) + v
        finally:
            del configs.MODEL_ZOO[name]
    return totals


def widths_seq_path(requests=3, batch=64, f32_batch=2):
    """Each new width's model (WIDTH_MODELS, seeded random weights) under
    apply_seq_parallel on a one-rank NCCL process group, as phase 9 serves
    on: float32 at ``f32_batch`` against its unsharded kernel path
    (seq_vs_unsharded), then in bf16 ``requests`` requests of ``batch``
    against its unsharded bf16 kernel path within SEQ_GATES, the launches
    held at the model's width (a seq-kernel launch a layer and forward, none
    of kernel 1; kernel 1's on the unsharded path).  Each model also with
    ``attn_block_fusion`` (the block kernel's streamed design at its
    width): float32 at ``f32_batch`` against its eager path
    (block_vs_eager), bf16 over the same requests against its bf16 kernel
    path and img/s of the two in turns (block_fused_served), a block launch
    a layer and forward.  Returns the summed launch counts."""
    import torch.distributed as dist
    from vision_transformer_cam_tpu_torch import configs, serving
    from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
    from vision_transformer_cam_tpu_torch.parallel import mesh as pmesh
    t0, totals = time.perf_counter(), {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    mesh = one_rank_seq_mesh()
    try:
        for dh, fields in WIDTH_MODELS.items():
            cfg = configs.ViTCAMConfig(num_classes=20, **fields)
            model = ViTCAM(cfg, device="cuda",
                           generator=torch.Generator().manual_seed(dh))
            label, depth = f"width-{dh} model", cfg.depth
            rng = np.random.default_rng(dh)
            reqs = [torch.from_numpy(rng.standard_normal(
                (batch, cfg.img_size, cfg.img_size, 3),
                dtype=np.float32)).cuda() for _ in range(requests)]
            add(seq_vs_unsharded(label, model, reqs[0][:f32_batch], mesh,
                                 "widths"))
            add(block_vs_eager(label, model, reqs[0][:f32_batch]))
            serving.apply_serving_mode(model, "bf16")
            kcfg = model.cfg
            refs, counts = serve(model, reqs, {"masked_attention_fused": depth,
                                               FWD_W[dh]: depth},
                                 f"{label} bf16")
            add(counts)
            add(block_fused_served(label, model, kcfg, reqs, refs)[0])
            model.cfg = pmesh.apply_seq_parallel(kcfg)
            with pmesh.set_mesh(mesh):
                outs, counts = serve(
                    model, reqs, {"masked_attention_seq_local": depth,
                                  SEQ_W[dh]: depth}, f"{label} bf16 seq")
            add(counts)
            d_cam, d_logit, ov = deviation(outs, refs)
            say(f"{label} bf16 seq vs unsharded bf16 kernel path: CAM max "
                f"abs dev {d_cam:.3e} (tol {SEQ_GATES['cam']}), logits max "
                f"abs dev {d_logit:.3e} (tol {SEQ_GATES['logits']}), "
                f"top-{cfg.top_k_patches} overlap {ov:.4f}")
            if not (d_cam <= SEQ_GATES["cam"]
                    and d_logit <= SEQ_GATES["logits"]):
                raise AssertionError(f"{label}: bf16 sequence-parallel path "
                                     "disagrees with the unsharded kernel "
                                     "path")
            del model, refs, outs
    finally:
        dist.destroy_process_group()
    say(f"widths seq path: {time.perf_counter() - t0:.1f} s")
    return totals


# The split-tensor kernel (v1) at head widths 16, 32, 40 and 80: the JAX fuzz
# shapes of phase 24 (WIDTH_CASES), the JAX kernel test's own shape (B=2,
# N=37, 4 heads of 16) and ViT-H/14's (B=64, N=257, 16 heads of 80); each
# width timed at phase 24's shape, width 80 at ViT-H/14's
V1_WIDTH_CASES = WIDTH_CASES + ((2, 37, 4, 16), (64, 257, 16, 80))
V1_TIMED = {**{dh: shape[:3] for dh, shape in WIDTH_TIMED.items()},
            80: (64, 257, 16)}
# the block kernel at the width models' shapes (WIDTH_MODELS: N 65 in 4
# heads of 16, N 197 in 4 of 32 and in 3 of 40), checked at B = 2 and 64,
# timed at 64.  Its bf16 rollout update is held at the bf16 probability
# tolerance, as tests/test_torch_tensor_core_cuda.py holds the cluster
# design's: the kernel forms qkv itself, summing in another order than the
# plain version before both round it to bf16, and an ulp of qkv moves P by
# ~1e-3 relative; over B = 64 images the update read 1.72e-6 to 5.85e-6
# from the plain version (an NVIDIA H100 80GB HBM3), past TOL_JOINT's 1e-6
# + 1e-4 |J'| (B = 2: within it).  float32 keeps TOL_JOINT.
BLOCK_WIDTH_SHAPES = {16: (65, 4), 32: (197, 4), 40: (197, 3)}
BLOCK_WIDTH_CASES = tuple((b, n, h, dh) for dh, (n, h)
                          in BLOCK_WIDTH_SHAPES.items() for b in (2, 64))


def v1_case(b, n, heads, dh, failures, seed):
    """The split-tensor kernel at one shape against its plain version, in
    every design that takes the dtype (bf16: the tensor-core design,
    launched twice for identical bits, and the FMA design; float32: the FMA
    design), with and without the head mean, background none, 30 % and all,
    at check_attention_v1's gates.  float32 inputs lie on a grid of 1/8
    (v1_inputs): without the clamp the hot rows' logits reach |S| ~ 150,
    one float32 ulp of which (1.5e-5), summed over 80 products in another
    order than the plain version's, moved out by up to 1.07e-4 at ViT-H/14's
    B=64 N=257 (an NVIDIA H100 80GB HBM3), past TOL's 5e-5 + 1e-4 |out|;
    on the grid S is exact on both sides and the gate holds what follows it
    (exp, the softmax sums, P V), as tests/test_torch_seq_width.py holds
    the seq kernel at width 80.  Returns the worst error of the bf16
    tensor-core cases."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for bi, bg_kind in enumerate(("none", "30%", "all")):
            (q, k, v), bg = v1_inputs(b, n, heads, dtype, seed + bi, bg_kind,
                                      dh=dh, grid=dtype == torch.float32)
            for hm in (False, True):
                kw = dict(scale=dh ** -0.5, with_headmean=hm)
                want = ka.masked_attention_ref(q, k, v, bg, **kw)
                tols = [TOL[(dtype, "out")], TOL[(dtype, "prob")],
                        TOL[(dtype, "prob")]]
                for design in fwd_designs(dtype):
                    got = _switched(ka, "_v1_bf16_design", design,
                                    ka.masked_attention, q, k, v, bg, **kw)
                    torch.cuda.synchronize()
                    case = (f"attention v1 {design:11s} {name:8s} hm={hm!s:5s} "
                            f"bg={bg_kind:4s} B={b} N={n} H={heads} dh={dh}")
                    err = _compare(case, got, want, tols, failures)
                    if design == "tensor-core":
                        worst = max(worst, err)
                        again = ka.masked_attention(q, k, v, bg, **kw)
                        if not all(torch.equal(x, y)
                                   for x, y in zip(got, again)):
                            failures.append(f"{case}: a second launch gave "
                                            "other bits")
    return worst


def check_attention_v1_widths():
    """The split-tensor kernel at head widths 16, 32, 40 and 80 against its
    plain version (v1_case at V1_WIDTH_CASES); width 40's tail on the last
    row of the last slab, with NaN past the tensors' ends (a 48-column read
    of K there would make S NaN); each width at V1_MAX_N and one key past it
    refused, naming the bytes; widths 24 and 48 refused, naming the compiled
    widths.  Returns {dh: worst error of the bf16 tensor-core cases}."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    failures, errs = [], {}
    for (b, n, h, dh) in V1_WIDTH_CASES:
        err = v1_case(b, n, h, dh, failures, seed=3 * n + dh)
        errs[dh] = max(errs.get(dh, 0.0), err)
    # width 40: q, k and v the heads of tensors followed by NaN
    for dtype in (torch.bfloat16, torch.float32):
        (q, k, v), bg = v1_inputs(2, 37, 3, dtype, 9, dh=40)
        ends = []
        for t in (q, k, v):
            buf = torch.full((t.numel() + 64,), float("nan"), dtype=dtype,
                             device="cuda")
            buf[:t.numel()] = t.reshape(-1)
            ends.append(buf[:t.numel()].view(t.shape))
        kw = dict(scale=40 ** -0.5, with_headmean=True)
        want = ka.masked_attention_ref(q, k, v, bg, **kw)
        for design in fwd_designs(dtype):
            got = _switched(ka, "_v1_bf16_design", design,
                            ka.masked_attention, *ends, bg, **kw)
            torch.cuda.synchronize()
            _compare(f"attention v1 {design} {dtype} dh=40, NaN past the "
                     "tensors", got, want,
                     [TOL[(dtype, "out")], TOL[(dtype, "prob")],
                      TOL[(dtype, "prob")]], failures)
    for dh in V1_WIDTHS + (64,):
        for n in (ka.V1_MAX_N[dh], ka.V1_MAX_N[dh] + 1):
            (q, k, v), bg = v1_inputs(1, n, 1, torch.bfloat16, 2, dh=dh)
            for dtype in (torch.bfloat16, torch.float32):
                try:
                    ka.masked_attention(q.to(dtype), k.to(dtype),
                                        v.to(dtype), bg, scale=0.125,
                                        with_headmean=True)
                    torch.cuda.synchronize()
                    if n > ka.V1_MAX_N[dh]:
                        failures.append(f"v1 width {dh} N={n}: not refused")
                except ValueError as e:
                    if n <= ka.V1_MAX_N[dh] or "bytes" not in str(e):
                        failures.append(f"v1 width {dh} N={n}: {e}")
    for dh in (24, 48):
        (q, k, v), bg = v1_inputs(1, 37, 2, torch.bfloat16, 2, dh=dh)
        try:
            ka.masked_attention(q, k, v, bg, scale=0.125)
            failures.append(f"v1 at head width {dh}: not refused")
        except ValueError as e:
            say(f"check v1 at head width {dh} is refused: {e}")
            if "16, 32, 40, 64, 80" not in str(e):
                failures.append(f"v1 at head width {dh}: {e}")
    if failures:
        raise AssertionError("split-tensor attention kernel at head widths "
                             "16, 32, 40, 80 != plain version:\n"
                             + "\n".join(failures))
    say(f"check attention v1 widths: worst bf16 tensor-core errors {errs}")
    return errs


def v1_bits(root, out):
    """SHA-256 of the split-tensor kernel's output bytes (out, cls row, head
    mean) at head width 64, B=2, 12 heads, N = 37, 197, 577 and 1025 (the
    FMA design's 32-row and, with the head mean at 1025, 16-row tiles), in
    every design (float32: fma; bf16: tensor-core and fma), background
    (none, 30 %, all) and with the head mean or without: 72 cases, from the
    port of the checkout at ``root``, as ``bwd_bits`` does (and compared by
    ``compare_bits``)."""
    import hashlib
    sys.path.insert(0, os.path.abspath(root))
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    got = {}
    for n in (37, 197, 577, 1025):
        for dtype in (torch.float32, torch.bfloat16):
            designs = ("fma",) if dtype == torch.float32 else \
                ("tensor-core", "fma")
            for bi, bg_kind in enumerate(("none", "30%", "all")):
                (q, k, v), bg = v1_inputs(2, n, 12, dtype, 11 * n + bi,
                                          bg_kind)
                for hm in (False, True):
                    for design in designs:
                        res = _switched(ka, "_v1_bf16_design", design,
                                        ka.masked_attention, q, k, v, bg,
                                        scale=0.125, with_headmean=hm)
                        digest = hashlib.sha256()
                        for t in res:
                            digest.update(t.contiguous().view(torch.uint8)
                                          .cpu().numpy().tobytes())
                        got[f"{design} {dtype} N={n} bg={bg_kind} hm={hm}"] = \
                            digest.hexdigest()
    with open(out, "w") as f:
        json.dump(got, f, indent=1, sort_keys=True)
    say(f"v1_bits: {len(got)} cases from {ka.__file__} -> {out}")
    return got


def v1_occupancy(cases=tuple((n, dh) for dh, (_, n, _) in V1_TIMED.items())):
    """For the split-tensor kernel's instances at (N, head width) ``cases``,
    with the head mean: the tensor-core instance (bf16) and the FMA instance
    (float32) at the tile it picks: blocks an SM, registers and local
    memory a thread, shared memory a block (held to ``v1_smem_bytes``).
    Returns {(design, n, dh): info}."""
    import ctypes

    from vision_transformer_cam_tpu_torch.kernels import _build
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    lib, got = _build.load(), {}
    for n, dh in cases:
        for design, dtype in (("tensor-core", torch.bfloat16),
                              ("fma", torch.float32)):
            info = (ctypes.c_int * 4)()
            err = lib.vitcam_masked_attention_v1_occupancy(
                n, 1, ka._DTYPE_CODES[dtype], ka.V1_DESIGNS[design], dh, info)
            if err:
                raise RuntimeError(
                    f"v1 occupancy ({design}, N={n}, dh={dh}): cudaError "
                    f"{err} ({lib.vitcam_cuda_error_string(err).decode()})")
            want = ka.v1_smem_bytes(design, dtype, n, dh)
            if info[3] != want:
                raise AssertionError(f"v1 {design} N={n} dh={dh}: the kernel "
                                     f"takes {info[3]} bytes of shared "
                                     f"memory, the Python formula {want}")
            got[(design, n, dh)] = tuple(info)
            say(f"occupancy attention v1 {design:11s} head mean N={n} "
                f"dh={dh}: {info[0]} blocks an SM, {info[1]} registers, "
                f"{info[2]} bytes of local memory per thread, {info[3]} "
                f"bytes of shared memory per block")
    return got


def v1_bound(b, n, heads, dh):
    """The split-tensor kernel's bound as time_attention_v1 times it (bf16,
    no head mean): bf16 q, k, v and the float32 bg in, bf16 out and cls row
    out; both products at the bf16 rate."""
    m, c = b * n, heads * dh
    return bound(f"masked_attention (v1) bf16 B={b} N={n} H={heads} dh={dh}",
                 4 * m * c * 2 + m * 4 + m * 2,
                 {"bf16": 4 * b * heads * n * n * dh})


def time_attention_v1_widths():
    """Each width of V1_TIMED through ``time_attention_v1`` (the tensor-core
    design and the plain version in turns, SDPA with the additive pair mask
    beside them), with its bound.  Returns {dh: ({with_headmean: (kernel ms,
    plain ms)}, SDPA ms, (bound ms, bound by))}."""
    return {dh: (*time_attention_v1(b, n, h, dh), v1_bound(b, n, h, dh))
            for dh, (b, n, h) in V1_TIMED.items()}


def v1_widths_path():
    """The split-tensor kernel's path at the new widths, as the JAX package
    runs its kernel (only its tests do: no model path runs it): each width's
    ``masked_attention`` at its V1_TIMED shape, bf16 and float32, with and
    without the head mean, the launch counts set to 0 before and read after
    (four launches at the width, none at another), each result finite,
    its cls row and head-mean rows summing to 1.  Returns {row: launches}."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    reset_counts()
    for dh, (b, n, h) in V1_TIMED.items():
        for dtype in (torch.bfloat16, torch.float32):
            (q, k, v), bg = v1_inputs(b, n, h, dtype, 17, dh=dh)
            for hm in (False, True):
                res = ka.masked_attention(q, k, v, bg, scale=dh ** -0.5,
                                          with_headmean=hm)
                rows = res[1:]
                if not all(torch.isfinite(t).all() for t in res) or \
                        tuple(res[0].shape) != (b, h, n, dh) or \
                        any(float((r.float().sum(-1) - 1).abs().max())
                            > 2e-2 for r in rows):
                    raise AssertionError(f"v1 path dh={dh} {dtype} hm={hm}: "
                                         "an output is off")
    torch.cuda.synchronize()
    counts = {V1_W[dh]: ka.v1_width_launches[dh] for dh in V1_WIDTHS}
    say(f"v1 widths path: launches {counts} (expected 4 a width)")
    if set(counts.values()) != {4} or ka.v1_width_launches[64] != 0:
        raise AssertionError(f"v1 widths path: launch counts {counts}")
    return counts


def block_vs_eager(label, model, x):
    """The float32 model on the kernel path with ``attn_block_fusion`` (the
    block kernel's streamed design, its FMA core) against its eager path on
    ``x``, at main_path's float32 gates (rollout row 1e-5, logits 2e-4), a
    block launch a layer at the model's head width.  Returns the launch
    counts."""
    cfg = model.cfg
    model.cfg = cfg.replace(attn_impl="eager")
    want = model(x, need_rollout=True)
    model.cfg = cfg.replace(attn_impl="kernel", attn_block_fusion=True)
    reset_counts()
    try:
        got = model(x, need_rollout=True)
        torch.cuda.synchronize()
    finally:
        model.cfg = cfg
    counts = _expect(f"{label} f32 block fused (B={x.shape[0]})",
                     {BLOCK_NW[cfg.head_dim]: cfg.depth}, phase="widths")
    d_roll = float((got.rollout_row - want.rollout_row).abs().max())
    d_logit = float((got.logits - want.logits).abs().max())
    say(f"{label} f32 block fused vs eager (B={x.shape[0]}): rollout row "
        f"{d_roll:.3e} (tol 1e-5), logits {d_logit:.3e} (tol 2e-4)")
    if not (d_roll <= 1e-5 and d_logit <= 2e-4):
        raise AssertionError(f"{label}: f32 block-fused path disagrees with "
                             "the eager path")
    return counts


def block_fused_served(label, model, kcfg, reqs, refs):
    """The bf16 model (``kcfg``, its kernel path) with ``attn_block_fusion``
    over ``reqs`` against the same requests' bf16 kernel-path outputs
    ``refs`` within ZOO_BF16_GATES, a block launch a layer and forward at the
    model's head width and none of kernel 1; then img/s at the requests'
    batch of the two paths in turns.  Returns (launch counts, {path:
    img/s})."""
    from vision_transformer_cam_tpu_torch.ops.rollout import (
        cam_from_rollout_row)
    depth, dh = kcfg.depth, kcfg.head_dim
    fcfg = kcfg.replace(attn_block_fusion=True)
    model.cfg = fcfg
    try:
        outs, counts = serve(model, reqs, {BLOCK_NW[dh]: depth},
                             f"{label} bf16 block fused")
    finally:
        model.cfg = kcfg
    d_cam, d_logit, ov = deviation(outs, refs)
    say(f"{label} bf16 block fused vs bf16 kernel path: CAM max abs dev "
        f"{d_cam:.3e} (tol {ZOO_BF16_GATES['cam']}), logits max abs dev "
        f"{d_logit:.3e} (tol {ZOO_BF16_GATES['logits']}), "
        f"top-{kcfg.top_k_patches} overlap {ov:.4f}")
    if not (d_cam <= ZOO_BF16_GATES["cam"]
            and d_logit <= ZOO_BF16_GATES["logits"]):
        raise AssertionError(f"{label}: bf16 block-fused path disagrees "
                             "with the bf16 kernel path")
    g, xb = kcfg.grid_size, reqs[0]

    def rate(mcfg, iters=5):
        model.cfg = mcfg
        for _ in range(2):
            cam_from_rollout_row(model(xb, need_rollout=True).rollout_row, g)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            cam_from_rollout_row(model(xb, need_rollout=True).rollout_row, g)
        torch.cuda.synchronize()
        return xb.shape[0] * iters / (time.perf_counter() - t)
    paths = {"bf16": kcfg, "bf16 block fused": fcfg}
    rates = {}
    try:
        for name in list(paths) + list(paths)[::-1]:
            rates.setdefault(name, []).append(rate(paths[name]))
    finally:
        model.cfg = kcfg
    for name, r in rates.items():
        say(f"{label} {name} CAM throughput, batch {xb.shape[0]}: "
            f"{np.mean(r):.1f} img/s ({r[0]:.1f}, {r[1]:.1f})")
    return counts, {name: float(np.mean(r)) for name, r in rates.items()}


def time_block_widths():
    """The block kernel's streamed design at each width model's shape (B =
    64; WIDTH_MODELS) through ``time_block_streamed``, with its bound.
    Returns {dh: (kernel ms, plain ms, unfused ms, (bound ms, bound by))}."""
    return {dh: (*time_block_streamed(64, n, h, dh), block_bound(64, n, h, dh))
            for dh, (n, h) in BLOCK_WIDTH_SHAPES.items()}


def widths_path():
    """Phase 24: kernel 1, the backward, the split-tensor kernel (v1) and the
    block kernel at head widths 16, 32 and 40 (v1 also at 80) against their
    plain versions, their occupancy read, timed, each width's model through
    bench.main, under sequence parallelism and with attn_block_fusion, and
    v1's path.  Returns (launch counts, the checks' worst errors (kernel 1,
    the backward, v1, the block kernel), the timings (the same four))."""
    t0 = time.perf_counter()
    errs = check_attention_widths()
    v1_errs = check_attention_v1_widths()
    block_errs = check_attention_block(
        BLOCK_WIDTH_CASES, bf16_joint=TOL[(torch.bfloat16, "prob")])
    attention_occupancy(cases=tuple((n, dh, h) for dh, (_, n, h, _)
                                    in WIDTH_TIMED.items()))
    bwd_occupancy(cases=tuple((n, dh) for dh, (_, n, _, _)
                              in WIDTH_TIMED.items()))
    v1_occupancy()
    streamed_occupancy(tuple((2, n, h, dh) for dh, (n, h)
                             in BLOCK_WIDTH_SHAPES.items()))
    times = time_widths()
    v1_ms = time_attention_v1_widths()
    block_ms = time_block_widths()
    launches = widths_main_path()
    for k, v in widths_seq_path().items():
        launches[k] = launches.get(k, 0) + v
    launches.update(v1_widths_path())
    say(f"widths path: {time.perf_counter() - t0:.1f} s")
    return launches, (*errs, v1_errs, block_errs), (*times, v1_ms, block_ms)


# Phase 25, the CNN-CAM demo: the archs at full width, the gates of the card
# against the CPU at float32 with TF32 off (cuDNN's and the CPU's
# convolutions sum in other orders): logits and features within CNN_REL of
# their largest magnitude, the uint8 CAMs within one step on at most
# CNN_CAM_FRAC of the pixels, the same top classes
CNN_ARCHS = ("resnet18", "squeezenet1_1", "densenet161")
CNN_REL, CNN_CAM_FRAC = 1e-4, 1e-2


def cnn_path():
    """Phase 25: cli.cnn_cam_demo through ``main`` for each arch at full
    width and 224 x 224, seeded weights, on the card (the default device)
    and with ``--device cpu``: the top classes, probabilities and uint8
    CAMs of the two runs held together, and the arch's module on the card
    against the same module on the CPU (logits, features), TF32 off; then
    the warm img/s of the card's forward at batch 1 and 64 (CUDA events, TF32
    off).  Returns {arch: (img/s at 1, img/s at 64)}."""
    import tempfile

    from vision_transformer_cam_tpu_torch.cli import cnn_cam_demo as demo
    from vision_transformer_cam_tpu_torch.data.transforms import (
        preprocess_array)
    t0 = time.perf_counter()
    rates, failures = {}, []
    with tempfile.TemporaryDirectory() as work:
        img = os.path.join(work, "cnn_demo.png")
        synthetic_png(img, seed=77)
        import PIL.Image
        x = preprocess_array(np.asarray(PIL.Image.open(img).convert("RGB")),
                             224, (0.485, 0.456, 0.406),
                             (0.229, 0.224, 0.225))
        for arch in CNN_ARCHS:
            runs = {}
            for dev in ("cuda", "cpu"):
                out = os.path.join(work, f"{arch}_{dev}")
                argv = ["--image", img, "--arch", arch, "--out", out]
                t1 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    runs[dev] = demo.main(argv + (["--device", "cpu"]
                                                  if dev == "cpu" else []))
                if len(os.listdir(out)) != 5:
                    failures.append(f"{arch} {dev}: {os.listdir(out)}")
                say(f"cnn {arch} demo on {dev}: {time.perf_counter() - t1:.1f} "
                    f"s, top {runs[dev]['top'].tolist()}")
            card, host = runs["cuda"], runs["cpu"]
            d_prob = float(np.abs(card["probs"] - host["probs"]).max())
            d_cam = np.abs(card["cams"].astype(int) - host["cams"].astype(int))
            say(f"check cnn {arch} card vs CPU: probs {d_prob:.2e}, CAM "
                f"{int(d_cam.max())} step on {float((d_cam > 0).mean()):.2e} "
                f"of the pixels, top-5 {card['top'].tolist()} / "
                f"{host['top'].tolist()}")
            # a rank may swap only between classes tied within the
            # probabilities' deviation; its CAMs are then of other classes
            same = card["top"] == host["top"]
            tied = np.abs(host["probs"][card["top"]]
                          - host["probs"][host["top"]]) <= 2 * d_prob
            d_cam = d_cam[same]
            if not (same | tied).all() or int(d_cam.max(initial=0)) > 1 or \
                    (d_cam > 0).mean() > CNN_CAM_FRAC:
                failures.append(f"{arch}: top {card['top']} vs {host['top']}"
                                f", CAM {int(d_cam.max(initial=0))} steps")
            models = {dev: demo.build_model(arch, device=dev)
                      for dev in ("cuda", "cpu")}
            with torch.no_grad(), demo.no_tf32():
                got = models["cuda"](torch.from_numpy(x[None]).cuda())
                want = models["cpu"](torch.from_numpy(x[None]))
            for name, g_, w_ in zip(("logits", "features"), got, want):
                err = float((g_.cpu() - w_).abs().max())
                scale = float(w_.abs().max())
                say(f"check cnn {arch} {name} card vs CPU: max abs dev "
                    f"{err:.3e} of {scale:.3e} ({err / scale:.2e})")
                if not torch.isfinite(g_).all() or err > CNN_REL * scale:
                    failures.append(f"{arch} {name}: {err:.3e} of {scale:.3e}")
            model = models["cuda"]
            del models
            rates[arch] = []
            for b in (1, 64):
                xb = torch.from_numpy(np.repeat(x[None], b, 0)).cuda()
                with torch.no_grad(), demo.no_tf32():
                    ms = time_ms(lambda: model(xb), iters=20 if b == 1 else 10)
                rates[arch].append(1e3 * b / ms)
                say(f"time cnn {arch} forward B={b}: {ms:.4f} ms, "
                    f"{1e3 * b / ms:.1f} img/s (TF32 off, warm)")
            del model
            gc_cuda()
    if failures:
        raise AssertionError("CNN-CAM demo on the card:\n"
                             + "\n".join(failures))
    say(f"cnn path: {time.perf_counter() - t0:.1f} s")
    return rates


# The zoo's widest and longest models served (phase 19): label, zoo name,
# requests x batch through serve(), the throughput batch, the batch of the
# card-vs-CPU whole-path check
ZOO_MODELS = (("ViT-H/14", "vit_huge_patch14_224_in21k", 3, 32, 64, 2),
              ("ViT-L/16@512", "vit_large_patch16_512", 2, 16, 32, 1))
# The bf16 kernel path against the eager path, as main_path holds ViT-B/16
ZOO_BF16_GATES = {"cam": 5e-2, "logits": 5e-2}


def zoo_model(name):
    """The zoo model at full width and depth with seeded random weights, on
    the card, float32.  ViT-H/14 keeps its pre-logits layer (1280).
    ViT-L/16@512 takes the seeded weights of ViT-L/16 (224) through the
    pos-embed interpolation of ``io.weights.load_state_dict``."""
    from vision_transformer_cam_tpu_torch import configs
    from vision_transformer_cam_tpu_torch.io.weights import load_state_dict
    from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
    cfg = configs.resolve_model(name)(num_classes=20)
    if name != "vit_large_patch16_512":
        return ViTCAM(cfg, device="cuda",
                      generator=torch.Generator().manual_seed(0))
    small = ViTCAM(configs.vit_large_patch16_224(num_classes=20),
                   device="cuda", generator=torch.Generator().manual_seed(0))
    sd = {k: v.clone() for k, v in small.state_dict().items()}
    del small
    model = ViTCAM(cfg, device="cuda",
                   generator=torch.Generator().manual_seed(1))
    load_state_dict(model, sd)
    pe = model.pos_embed
    if tuple(pe.shape) != (1, 1025, 1024) or not torch.isfinite(pe).all() \
            or not torch.equal(pe[:, 0], sd["pos_embed"][:, 0]):
        raise AssertionError("224 -> 512 pos-embed interpolation failed")
    return model


def one_rank_seq_mesh():
    """A one-rank NCCL process group, as phase 9 serves on, and the ('data',
    'seq') mesh over it; the caller destroys the group."""
    import torch.distributed as dist
    from vision_transformer_cam_tpu_torch.parallel import mesh as pmesh
    dist.init_process_group("nccl",
                            init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    return pmesh.seq_parallel_mesh(1)


def seq_vs_unsharded(label, model, x, mesh, phase):
    """The float32 model on the sequence-parallel kernel path against its
    unsharded kernel path on ``x``, at phase 9's gates (rollout row 1e-5,
    logits 2e-4), a seq-kernel launch a layer at the model's head width and
    none of kernel 1.  Returns the seq path's launch counts."""
    from vision_transformer_cam_tpu_torch.parallel import mesh as pmesh
    cfg = model.cfg
    model.cfg = cfg.replace(attn_impl="kernel")
    want = model(x, need_rollout=True)
    model.cfg = pmesh.apply_seq_parallel(model.cfg)
    reset_counts()
    try:
        with pmesh.set_mesh(mesh):
            got = model(x, need_rollout=True)
        torch.cuda.synchronize()
    finally:
        model.cfg = cfg
    per_fwd = {"masked_attention_seq_local": cfg.depth}
    if cfg.head_dim in SEQ_W:
        per_fwd[SEQ_W[cfg.head_dim]] = cfg.depth
    counts = _expect(f"{label} f32 seq (B={x.shape[0]})", per_fwd,
                     phase=phase)
    d_roll = float((got.rollout_row - want.rollout_row).abs().max())
    d_logit = float((got.logits - want.logits).abs().max())
    say(f"{label} f32 seq path vs unsharded kernel path (B={x.shape[0]}): "
        f"rollout row {d_roll:.3e} (tol 1e-5), logits {d_logit:.3e} (tol "
        "2e-4)")
    if not (d_roll <= 1e-5 and d_logit <= 2e-4):
        raise AssertionError(f"{label}: f32 sequence-parallel path disagrees "
                             "with the unsharded kernel path")
    return counts


def zoo_seq(label, base, model, kcfg, reqs, outs_bf16, f32_batch=2):
    """Phase 19's ViT-H/14 (its float32 build ``base``, and ``model`` served
    in bf16 by ``kcfg``) under apply_seq_parallel on a one-rank NCCL
    process group, as phase 9 serves ViT-L/16@384: float32 at ``f32_batch``
    against the unsharded kernel path (seq_vs_unsharded), then bf16 over
    ``reqs`` against the unsharded kernel path's outputs ``outs_bf16``
    within ZOO_BF16_GATES, a seq-kernel launch a layer and forward at the
    model's head width and none of kernel 1.  Returns (the mesh, the launch
    counts); the caller destroys the process group."""
    from vision_transformer_cam_tpu_torch.parallel import mesh as pmesh
    t0 = time.perf_counter()
    mesh = one_rank_seq_mesh()
    cfg = base.cfg
    totals = dict(seq_vs_unsharded(label, base, reqs[0][:f32_batch], mesh,
                                   "zoo"))
    model.cfg = pmesh.apply_seq_parallel(kcfg)
    try:
        with pmesh.set_mesh(mesh):
            outs, counts = serve(
                model, reqs, {"masked_attention_seq_local": cfg.depth,
                              SEQ_W[cfg.head_dim]: cfg.depth},
                f"{label} bf16 seq")
    finally:
        model.cfg = kcfg
    for k, v in counts.items():
        totals[k] += v
    d_cam, d_logit, ov = deviation(outs, outs_bf16)
    say(f"{label} bf16 seq vs unsharded bf16 kernel path: CAM max abs dev "
        f"{d_cam:.3e} (tol {ZOO_BF16_GATES['cam']}), logits max abs dev "
        f"{d_logit:.3e} (tol {ZOO_BF16_GATES['logits']}), "
        f"top-{cfg.top_k_patches} overlap {ov:.4f}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not (d_cam <= ZOO_BF16_GATES["cam"]
            and d_logit <= ZOO_BF16_GATES["logits"]):
        raise AssertionError(f"{label}: bf16 sequence-parallel path "
                             "disagrees with the unsharded kernel path")
    return mesh, totals


def zoo_serve(label, name, requests, batch, bench_batch, whole_b):
    """One zoo model at full width served through apply_serving_mode: bf16
    (held to the eager path), int8 and int8_hifi (ln_quant_fusion and
    int8_fused_gemm on, as main_path; each held to the same quantized model
    on the CPU), with ``mlp_fusion`` (the fused MLP kernels in two column
    groups at these widths): bf16 fused (held to the bf16 kernel path within
    ZOO_BF16_GATES) and int8 fused (held within WHOLE_TOL to the same
    model's unfused int8 path on the card: its rows are held to the plain
    versions by check_mlp_int8 at these widths, bit for bit), and in bf16
    with both fusions (``mlp_fusion`` and ``attn_block_fusion``: the block
    kernel's streamed design, BLOCK_W; the rollout carried through the
    layers, ``rollout_post`` off; held to the eager path within
    ZOO_BF16_GATES); ``requests`` requests of ``batch`` images with the
    rollout CAM and their launch counts (the fused MLP kernels' under the
    wide rows, MLP_W / MLP8_W); then img/s at ``bench_batch`` in turns
    (bf16, bf16 eager, int8, int8_hifi, bf16 fused, int8 fused, bf16 both
    fused); ViT-H/14 also under sequence parallelism (zoo_seq), its img/s
    in the same turns ("bf16 seq").  Returns (launch counts, {mode:
    img/s})."""
    import torch.distributed as dist
    from vision_transformer_cam_tpu_torch import serving
    from vision_transformer_cam_tpu_torch.parallel import mesh as pmesh
    from vision_transformer_cam_tpu_torch.ops.rollout import (
        cam_from_rollout_row)
    t_phase = time.perf_counter()
    base = zoo_model(name)
    cfg = base.cfg
    depth, g, size = cfg.depth, cfg.grid_size, cfg.img_size
    say(f"zoo {label}: depth {depth}, C={cfg.embed_dim}, {cfg.num_heads} "
        f"heads of {cfg.head_dim}, N={cfg.seq_len}, representation_size "
        f"{cfg.representation_size}; built in "
        f"{time.perf_counter() - t_phase:.1f} s")
    rng = np.random.default_rng(0)

    def images(b):
        return torch.from_numpy(rng.standard_normal(
            (b, size, size, 3), dtype=np.float32)).cuda()

    reqs = [images(batch) for _ in range(requests)]
    totals, served = {}, {}
    c = cfg.embed_dim
    wide = {"mlp_fused": MLP_W[c], "mlp_fused_int8": MLP8_W[c]}

    def add(counts):
        for k, v in counts.items():
            k = wide.get(k, k)
            totals[k] = totals.get(k, 0) + v

    model = serving.apply_serving_mode(copy.deepcopy(base), "bf16")
    kcfg = model.cfg
    w80 = depth if cfg.head_dim == 80 else 0
    outs_bf16, counts = serve(model, reqs, {"masked_attention_fused": depth,
                                            W80: w80}, f"{label} bf16")
    add(counts)
    model.cfg = kcfg.replace(attn_impl="eager")
    refs = []
    for x in reqs:
        ref = model(x, need_rollout=True)
        refs.append((ref, cam_from_rollout_row(ref.rollout_row, g)))
    model.cfg = kcfg
    d_cam, d_logit, ov = deviation(outs_bf16, refs)
    say(f"{label} bf16 kernel vs eager: CAM max abs dev {d_cam:.3e} (tol "
        f"{ZOO_BF16_GATES['cam']}), logits max abs dev {d_logit:.3e} (tol "
        f"{ZOO_BF16_GATES['logits']}), top-{cfg.top_k_patches} overlap "
        f"{ov:.4f}")
    if not (d_cam <= ZOO_BF16_GATES["cam"]
            and d_logit <= ZOO_BF16_GATES["logits"]):
        raise AssertionError(f"{label}: bf16 kernel path disagrees with the "
                             "eager path")
    mesh = None
    if name == HUGE:
        mesh, counts = zoo_seq(label, base, model, kcfg, reqs, outs_bf16)
        add(counts)
        served["bf16 seq"] = (model, pmesh.apply_seq_parallel(kcfg))
    # the bf16 path with both fusions: the block kernel's streamed design
    # and the fused MLP kernel on every layer, no kernel-1 launch.  The
    # rollout is carried through the layers (rollout_post off): past N =
    # 512 its default forms the rollout row after the layers from each
    # layer's head mean, which the block kernel does not emit, and the
    # layers then run kernel 1 (as the JAX package's forward does)
    model.cfg = kcfg.replace(mlp_fusion=True, attn_block_fusion=True,
                             rollout_post=False)
    outs, counts = serve(model, reqs, {"mlp_fused": depth,
                                       BLOCK_W[cfg.head_dim]: depth},
                         f"{label} bf16 both fused")
    add(counts)
    served["bf16 both fused"] = (model, model.cfg)
    model.cfg = kcfg
    d_cam, d_logit, ov = deviation(outs, refs)
    say(f"{label} bf16 both fused vs eager: CAM max abs dev {d_cam:.3e} "
        f"(tol {ZOO_BF16_GATES['cam']}), logits max abs dev {d_logit:.3e} "
        f"(tol {ZOO_BF16_GATES['logits']}), top-{cfg.top_k_patches} overlap "
        f"{ov:.4f}")
    if not (d_cam <= ZOO_BF16_GATES["cam"]
            and d_logit <= ZOO_BF16_GATES["logits"]):
        raise AssertionError(f"{label}: bf16 path with both fusions "
                             "disagrees with the eager path")
    del refs, outs
    served["bf16"] = (model, kcfg)
    served["bf16 eager"] = (model, kcfg.replace(attn_impl="eager"))
    # the bf16 fused path: the fused MLP kernel on every layer
    model.cfg = kcfg.replace(mlp_fusion=True)
    outs, counts = serve(model, reqs, {"masked_attention_fused": depth,
                                       W80: w80, "mlp_fused": depth},
                         f"{label} bf16 fused")
    add(counts)
    served["bf16 fused"] = (model, model.cfg)
    model.cfg = kcfg
    d_cam, d_logit, ov = deviation(outs, outs_bf16)
    say(f"{label} bf16 fused vs bf16 kernel path: CAM max abs dev "
        f"{d_cam:.3e} (tol {ZOO_BF16_GATES['cam']}), logits max abs dev "
        f"{d_logit:.3e} (tol {ZOO_BF16_GATES['logits']}), "
        f"top-{cfg.top_k_patches} overlap {ov:.4f}")
    if not (d_cam <= ZOO_BF16_GATES["cam"]
            and d_logit <= ZOO_BF16_GATES["logits"]):
        raise AssertionError(f"{label}: bf16 fused path disagrees with the "
                             "bf16 kernel path")
    del outs
    calib = np.random.default_rng(1).standard_normal(
        (16, size, size, 3), dtype=np.float32)
    for mode in ("int8", "int8_hifi"):
        qm = serving.apply_serving_mode(copy.deepcopy(base), mode,
                                        calib_images=calib)
        qm.cfg = qm.cfg.replace(ln_quant_fusion=True, int8_fused_gemm=True)
        route = "int8_io" if qm.cfg.int8_attn_io else "int8_out"
        per_fwd = {"masked_attention_fused": depth, W80: w80,
                   "linear_int8_fused": 1 + 4 * depth,
                   "ln_quant": (2 if qm.cfg.int8_attn_io else 1) * depth}
        outs, counts = serve(qm, reqs, per_fwd, f"{label} {mode} ({route})")
        add(counts)
        whole_path_check(qm, f"{label} {mode}", g, cases=((whole_b, 21),))
        d_cam, d_logit, ov = deviation(outs, outs_bf16)
        say(f"{label} {mode} vs bf16 kernel path (recorded, not gated): CAM "
            f"max abs dev {d_cam:.3e}, logits max abs dev {d_logit:.3e}, "
            f"top-{cfg.top_k_patches} overlap {ov:.4f}")
        served[mode] = (qm, qm.cfg)
        if mode != "int8":
            continue
        # the int8 fused path: the same model with mlp_fusion on, the fused
        # int8 MLP kernel in place of fc1, fc2 and the second ln_quant
        qm.cfg = qm.cfg.replace(mlp_fusion=True)
        outs_f, counts = serve(
            qm, reqs, {"masked_attention_fused": depth, W80: w80,
                       "linear_int8_fused": 1 + 2 * depth,
                       "ln_quant": depth if qm.cfg.int8_attn_io else 0,
                       "mlp_fused_int8": depth}, f"{label} int8 fused")
        add(counts)
        d_cam, d_logit, ov = deviation(outs_f, outs)
        say(f"{label} int8 fused vs the same model's int8 path on the card: "
            f"CAM max abs dev {d_cam:.3e} (tol {WHOLE_TOL['cam']}), logits "
            f"max abs dev {d_logit:.3e} (tol {WHOLE_TOL['logits']}), "
            f"top-{cfg.top_k_patches} overlap {ov:.4f}")
        if not (d_cam <= WHOLE_TOL["cam"] and d_logit <= WHOLE_TOL["logits"]):
            raise AssertionError(f"{label}: int8 fused path disagrees with "
                                 "the int8 path")
        served["int8 fused"] = (qm, qm.cfg)
        qm.cfg = served["int8"][1]
        del outs_f
    del base, outs_bf16, outs
    torch.cuda.empty_cache()
    xb = images(bench_batch)

    def rate(mode, iters=5):
        m, mcfg = served[mode]
        m.cfg = mcfg
        with pmesh.set_mesh(mesh if mode == "bf16 seq" else None):
            for _ in range(2):
                cam_from_rollout_row(m(xb, need_rollout=True).rollout_row, g)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(iters):
                cam_from_rollout_row(m(xb, need_rollout=True).rollout_row, g)
            torch.cuda.synchronize()
        return bench_batch * iters / (time.perf_counter() - t)
    order = tuple(mode for mode in (
        "bf16", "bf16 eager", "int8", "int8_hifi", "bf16 fused", "int8 fused",
        "bf16 both fused", "bf16 seq") if mode in served)
    rates = {}
    for mode in order + order[::-1]:
        rates.setdefault(mode, []).append(rate(mode))
    model.cfg = kcfg
    if mesh is not None:
        dist.destroy_process_group()
    for mode, r in rates.items():
        say(f"{label} {mode} CAM throughput, batch {bench_batch}: "
            f"{np.mean(r):.1f} img/s ({r[0]:.1f}, {r[1]:.1f})")
    say(f"zoo {label}: {time.perf_counter() - t_phase:.1f} s")
    return totals, {mode: float(np.mean(r)) for mode, r in rates.items()}


def zoo_entry_points():
    """The entry points on the zoo's two models: bench.main at ViT-H/14
    (int8 and --bf16, batch 64) and ViT-L/16@512 (int8, batch 32), one JSON
    line each with its launch counts held, and cli.predict at ViT-H/14 on one
    generated PNG (--no_figure: the card's machine has no matplotlib; 32
    launches of kernel 1's float32 rollout variant).  Returns the launch
    counts."""
    import tempfile

    from vision_transformer_cam_tpu_torch.cli import predict as pcli
    fwd = 2 + 10 * 3                        # forwards of a bench run
    vith = ["--model", "vit_huge_patch14_224_in21k", "--batch", "64"]
    runs = [
        (vith, {"masked_attention_fused": 32, W80: 32,
                "linear_int8_fused": 129}),
        (vith + ["--bf16"], {"masked_attention_fused": 32, W80: 32}),
        (["--model", "vit_large_patch16_512", "--batch", "32"],
         {"masked_attention_fused": 24, "linear_int8_fused": 97}),
    ]
    totals = {}
    for argv, per in runs:
        counts = bench_run(argv, {k: v * fwd for k, v in per.items()})
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)
        try:
            img = os.path.join(work, "synthetic_h14.png")
            synthetic_png(img)
            reset_counts()
            t0 = time.perf_counter()
            arts = pcli.main(["--img_name", img, "--dataset_path", work,
                              "--model_name", "vit_huge_patch14_224_in21k",
                              "--no_figure", "--out",
                              os.path.join(work, "predict")])
            torch.cuda.synchronize()
            counts = _expect("predict ViT-H/14", {"masked_attention_fused":
                                                  32, W80: 32}, phase="zoo")
        finally:
            os.chdir(cwd)
    if arts["per_block_cams"].shape != (32, 16, 16) or \
            arts["rollout_cam"].shape != (16, 16) or \
            arts["token_sim"].shape != (32, 257, 257) or \
            not all(np.isfinite(v).all() for v in arts.values()):
        raise AssertionError("predict ViT-H/14: wrong shapes or not finite")
    say(f"zoo predict ViT-H/14: {time.perf_counter() - t0:.1f} s, top class "
        f"{int(np.argmax(arts['probs_head1']))}")
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v
    return totals


def zoo_f32_fused(f32_batch=4):
    """ViT-H/14 at float32 (serving off) with ``mlp_fusion`` (the FMA design
    in two column groups) and ``attn_block_fusion`` (the block kernel's
    streamed design, its FMA core) against the eager path at ``f32_batch``,
    at main_path's float32 gates (rollout row 1e-5, logits 2e-4), 32
    launches of each kernel held.  Returns the launch counts."""
    from vision_transformer_cam_tpu_torch import configs
    from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
    cfg = configs.resolve_model(HUGE)(num_classes=20)
    model = ViTCAM(cfg, device="cuda",
                   generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (f32_batch, cfg.img_size, cfg.img_size, 3), dtype=np.float32)).cuda()
    want = model(x, need_rollout=True)
    model.cfg = cfg.replace(attn_impl="kernel", mlp_fusion=True,
                            attn_block_fusion=True)
    reset_counts()
    got = model(x, need_rollout=True)
    torch.cuda.synchronize()
    counts = read_counts()
    d_roll = float((got.rollout_row - want.rollout_row).abs().max())
    d_logit = float((got.logits - want.logits).abs().max())
    say(f"zoo ViT-H/14 f32 kernel path with both fusions vs eager "
        f"(B={f32_batch}): rollout row {d_roll:.3e} (tol 1e-5), logits "
        f"{d_logit:.3e} (tol 2e-4); launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    del model, got, want
    gc_cuda()
    if not (d_roll <= 1e-5 and d_logit <= 2e-4) or \
            (counts["mlp_fused"], counts[BLOCK_W[80]]) != (32, 32):
        raise AssertionError("ViT-H/14 f32 fused kernel path disagrees with "
                             "the eager path, or did not run its kernels")
    return counts


def wide_entry_points(f32_batch=4, export_batch=8):
    """The entry points that reach the fused MLP kernels at the zoo's wide
    widths, each on the card without a refusal (not a phase of ``main``;
    run it after ``build_kernels``): ``bench --mlp-fusion`` at ViT-H/14
    (int8 and --bf16, batch 64) and at ViT-L/16@512 (int8, batch 32), their
    launch counts held; ``zoo_f32_fused`` at ``f32_batch``; ``cli.export``
    of ViT-H/14 in bf16 with ``mlp_fusion`` through ``build_fn``'s overrides
    at ``export_batch``, ``--check`` bit for bit and one artifact call's
    launches.  Returns the launch counts."""
    import tempfile

    from vision_transformer_cam_tpu_torch.cli import export as ecli
    fwd = 2 + 10 * 3                        # forwards of a bench run
    vith = ["--model", HUGE, "--batch", "64", "--mlp-fusion"]
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    for argv, per in (
            (vith, {"masked_attention_fused": 32, W80: 32,
                    "linear_int8_fused": 65, "mlp_fused_int8": 32}),
            (vith + ["--bf16"], {"masked_attention_fused": 32, W80: 32,
                                 "mlp_fused": 32}),
            (["--model", "vit_large_patch16_512", "--batch", "32",
              "--mlp-fusion"],
             {"masked_attention_fused": 24, "linear_int8_fused": 49,
              "mlp_fused_int8": 24})):
        add(bench_run(argv, {k: v * fwd for k, v in per.items()}))
    add(zoo_f32_fused(f32_batch))
    # the serving artifact of the bf16 fused configuration
    with tempfile.TemporaryDirectory() as work:
        out = os.path.join(work, "vith_bf16_fused.pt2")
        args = ecli.build_parser().parse_args([
            "--model_name", HUGE, "--serving", "bf16", "--batch",
            str(export_batch), "--out", out, "--check"])
        reset_counts()
        t0 = time.perf_counter()
        fn, cfg, prov = ecli.build_fn(args, mlp_fusion=True)
        _, text = _capture(ecli.write_artifact, args, fn, cfg, prov)
        torch.cuda.synchronize()
        per_fwd = {"masked_attention_fused": 32, W80: 32, "mlp_fused": 32}
        add(_expect("ViT-H/14 bf16 fused export --check",
                    {k: 2 * v for k, v in per_fwd.items()}, phase="wide"))
        if "bit-identical" not in text:
            raise AssertionError("ViT-H/14 bf16 fused export: no --check "
                                 "line")
        program = torch.export.load(out).module()
        xe = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (export_batch, 224, 224, 3), dtype=np.float32)).cuda()
        with torch.no_grad():
            reset_counts()
            res = program(xe)
            torch.cuda.synchronize()
        add(_expect("ViT-H/14 bf16 fused artifact call", per_fwd,
                    phase="wide"))
        if not all(torch.isfinite(r.float()).all() for r in res):
            raise AssertionError("ViT-H/14 bf16 fused artifact: outputs")
        say(f"wide entry points: ViT-H/14 bf16 fused export + --check "
            f"{time.perf_counter() - t0:.1f} s, "
            f"{os.path.getsize(out) / 1e6:.1f} MB")
    return totals


def zoo_path():
    """Phase 19: kernel 1 at head width 80 against its plain version, timed,
    its occupancy read; ViT-H/14 and ViT-L/16@512 served; ViT-H/14 at
    float32 with both fusions against the eager path (zoo_f32_fused); the
    int8 tier's two attention routes at N = 1025; the entry points.
    Returns (launch counts, worst error of the width-80 bf16 rollout case,
    times, throughputs)."""
    t0 = time.perf_counter()
    w80_errs = check_attention_w80()
    attention_occupancy()
    w80_ms = time_attention_w80()
    launches, rates = {}, {}
    for label, name, requests, batch, bench_batch, whole_b in ZOO_MODELS:
        counts, rates[label] = zoo_serve(label, name, requests, batch,
                                         bench_batch, whole_b)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        gc_cuda()
    zoo_f32_fused()
    route_ms = time_int8_route()
    for k, v in zoo_entry_points().items():
        launches[k] = launches.get(k, 0) + v
    say(f"zoo path: {time.perf_counter() - t0:.1f} s")
    return (launches, w80_errs[("bfloat16", "rollout", True, 257)], w80_ms,
            rates, route_ms)


# The zoo trained (phase 20): label, zoo name, the training batch, the batch
# of the float32 kernel-vs-eager step
ZOO_TRAIN = (("ViT-H/14", "vit_huge_patch14_224_in21k", 64, 4),
             ("ViT-L/16@512", "vit_large_patch16_512", 16, 2))


# the seeded zoo models of zoo_train_model, built once a process and kept on
# the host: the seeded init on the host is most of a build's time
_ZOO_TRAIN_BASE = {}


def zoo_train_model(name, impl, dtype=torch.bfloat16):
    """A zoo model as cli.train and bench --train build it (no pre-logits
    layer), float32 masters with ``dtype`` compute, remat on, on the card,
    seeded weights; ViT-L/16@512 takes ViT-L/16 (224)'s through the pos-embed
    interpolation, as ``zoo_model``.  The weights are built on the card once
    a process, and each call copies them."""
    from vision_transformer_cam_tpu_torch import configs
    from vision_transformer_cam_tpu_torch.io.weights import load_state_dict
    from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
    if name not in _ZOO_TRAIN_BASE:
        cfg = configs.resolve_model(name)(num_classes=20)
        if cfg.has_logits:
            cfg = cfg.replace(representation_size=None)
        if name != "vit_large_patch16_512":
            model = ViTCAM(cfg, device="cuda",
                           generator=torch.Generator().manual_seed(0))
        else:
            small = ViTCAM(configs.vit_large_patch16_224(num_classes=20),
                           device="cuda",
                           generator=torch.Generator().manual_seed(0))
            sd = {k: v.clone() for k, v in small.state_dict().items()}
            del small
            model = ViTCAM(cfg, device="cuda",
                           generator=torch.Generator().manual_seed(1))
            load_state_dict(model, sd)
        _ZOO_TRAIN_BASE[name] = model.cpu()
    base = _ZOO_TRAIN_BASE[name]
    model = copy.deepcopy(base).cuda()
    model.cfg = base.cfg.replace(dtype=dtype, attn_impl=impl, remat=True)
    return model


def zoo_train_launches(steps_fwd, steps_bwd, depth, dh):
    """What a zoo model's training launches: per step and layer kernel 1
    twice (forward and remat recompute) and the backward once, all at the
    model's head width; nothing else."""
    want = {"masked_attention_fused": steps_fwd * depth,
            "masked_attention_bwd": steps_bwd * depth}
    if dh == 80:
        want.update({W80: steps_fwd * depth, BWD80: steps_bwd * depth})
    return want


def zoo_train(label, name, batch, f32_batch):
    """One zoo model trained at full width and depth on the kernel path:
    ``train_one_epoch`` over 3 in-memory batches, then 5 ``train_step`` calls
    on one fixed batch (finite, falling losses; every parameter moved), the
    launch counts held after each; one float32 step against the eager path;
    training img/s of both paths in turns.  Returns (launch counts, {path:
    (img/s, peak GiB)}, (loss diff, worst gradient error))."""
    import math

    from vision_transformer_cam_tpu_torch import configs
    from vision_transformer_cam_tpu_torch.train import loop
    from vision_transformer_cam_tpu_torch.train import state as statelib
    from vision_transformer_cam_tpu_torch.train import step as steplib
    t_phase = time.perf_counter()
    ocfg = configs.OptimConfig(lr=1e-4, warmup_epochs=0, epochs=10,
                               linear_lr_scaling=False, clip_grad=1.0)
    spe = 3
    model = zoo_train_model(name, "kernel")
    cfg = model.cfg
    depth, dh, size = cfg.depth, cfg.head_dim, cfg.img_size
    say(f"zoo train {label}: depth {depth}, C={cfg.embed_dim}, "
        f"{cfg.num_heads} heads of {dh}, N={cfg.seq_len}, batch {batch}, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
        f"parameters; built in {time.perf_counter() - t_phase:.1f} s")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt, _ = statelib.make_optimizer(model, ocfg, batch, spe)
    state = statelib.create_train_state(model, opt)
    loader = MemoryLoader([seeded_batch(batch, 300 + i, size=size)
                           for i in range(spe)])
    totals = {}

    def held(part, steps_fwd, steps_bwd):
        counts = _expect(f"{label} {part}", zoo_train_launches(
            steps_fwd, steps_bwd, depth, dh), phase="zoo train")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        reset_counts()

    reset_counts()
    t0 = time.perf_counter()
    state, means = loop.train_one_epoch(state, loader, 0, 0, log_every=1)
    torch.cuda.synchronize()
    say(f"zoo train {label}: one epoch of {spe} steps x {batch} images in "
        f"{time.perf_counter() - t0:.2f} s (first includes warm-up); mean "
        f"loss {means['loss']:.4f}")
    held("train_one_epoch", 2 * spe, spe)
    if state.step != spe or not math.isfinite(means["loss"]):
        raise AssertionError(f"{label} epoch: step {state.step}, {means}")
    x, y = _cuda(seeded_batch(batch, 17, size=size))
    losses = []
    for _ in range(5):
        state, metrics = steplib.train_step(state, x, y, 0)
        losses.append(float(metrics["loss"]))
    say(f"zoo train {label}: 5 steps on one fixed batch, losses "
        + ", ".join(f"{v:.4f}" for v in losses))
    held("5 x train_step", 10, 5)
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: the loss did not fall: {losses}")
    stuck = [k for k, v in model.state_dict().items()
             if torch.equal(v, before[k])]
    if stuck:
        raise AssertionError(f"{label}: parameters that did not move: "
                             f"{stuck}")
    say(f"zoo train {label}: every one of {len(before)} parameter tensors "
        f"moved; peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
        f" GiB")
    del state, opt, model, before, loader, x, y
    gc_cuda()
    fx, fy = _cuda(seeded_batch(f32_batch, 19, size=size))
    f32 = kernel_vs_eager_step(
        lambda impl: zoo_train_model(name, impl, dtype=torch.float32), fx, fy,
        label)
    reset_counts()
    del fx, fy
    gc_cuda()
    rates = train_throughput(batch, steps=5, build=lambda impl:
                             zoo_train_model(name, impl), label=label,
                             size=size)
    reset_counts()
    gc_cuda()
    say(f"zoo train {label}: {time.perf_counter() - t_phase:.1f} s")
    return totals, rates, f32


def zoo_train_entry_points():
    """bench.main --train --mixed at ViT-H/14 (batch 64) and ViT-L/16@512
    (batch 16), one JSON line each, their launch counts held.  Returns
    {label: launch counts}."""
    steps = 2 + 5 * 3                       # training steps of a run
    got = {}
    for label, name, batch, _ in ZOO_TRAIN:
        depth, dh = (32, 80) if label == "ViT-H/14" else (24, 64)
        got[label] = bench_run(
            ["--train", "--mixed", "--model", name, "--batch", str(batch)],
            zoo_train_launches(2 * steps, steps, depth, dh))
        gc_cuda()
    return got


def zoo_train_path():
    """Phase 20: ViT-H/14 and ViT-L/16@512 trained at full width and depth
    on the kernel path, then their bench --train runs.  Returns (launch
    counts, the launches of the backward at N = 1025, {label: (rates, f32
    step)})."""
    t0 = time.perf_counter()
    launches, info = {}, {}
    long_calls = 0
    for label, name, batch, f32_batch in ZOO_TRAIN:
        counts, rates, f32 = zoo_train(label, name, batch, f32_batch)
        info[label] = (rates, f32)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        if label == "ViT-L/16@512":
            long_calls += counts["masked_attention_bwd"]
    for label, counts in zoo_train_entry_points().items():
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        if label == "ViT-L/16@512":
            long_calls += counts["masked_attention_bwd"]
    say(f"zoo train path: {time.perf_counter() - t0:.1f} s")
    return launches, long_calls, info


def gc_cuda():
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def check_q_block():
    """The fused attention kernel with q_block 16 against 32 at B=8 N=197
    (head-mean and rollout variants: out, cls row and head mean must be equal
    bit for bit, the joint within 1e-6), q_block 16 alone at N=1025 against
    the plain version, and a forced q_block 32 there must be refused."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    failures, refused = [], ""
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        qkv, bg, joint, _ = attention_inputs(8, 197, 12, dtype, seed=61)
        for variant in ("headmean", "rollout"):
            kw = dict(num_heads=12, scale=64 ** -0.5, clamp_softmax=True,
                      with_headmean=variant == "headmean")
            j = joint if variant == "rollout" else None
            r16 = ka.masked_attention_fused(qkv, bg, j, q_block=16, **kw)
            r32 = ka.masked_attention_fused(qkv, bg, j, q_block=32, **kw)
            torch.cuda.synchronize()
            same = [torch.equal(a, b_) for a, b_ in zip(r16, r32)]
            d3 = float((r16[2].float() - r32[2].float()).abs().max())
            say(f"check q_block 16 vs 32 {name:8s} {variant:8s} B=8 N=197: "
                f"bit-identical out {same[0]}, cls {same[1]}, third "
                f"{same[2]} (max abs dev {d3:.2e})")
            if not (same[0] and same[1]) or d3 > 1e-6 or \
                    (variant == "headmean" and not same[2]):
                failures.append(f"q_block 16 vs 32 {name} {variant}")
        qkv, bg, joint, _ = attention_inputs(2, 1025, 16, dtype, seed=62)
        for variant in ("headmean", "rollout"):
            kw = dict(num_heads=16, scale=64 ** -0.5, clamp_softmax=True,
                      with_headmean=variant == "headmean")
            j = joint if variant == "rollout" else None
            got = ka.masked_attention_fused(qkv, bg, j, q_block=16, **kw)
            auto = ka.masked_attention_fused(qkv, bg, j, **kw)
            want = ka.masked_attention_fused_ref(qkv, bg, j, **kw)
            torch.cuda.synchronize()
            tols = [TOL[(dtype, "out")], TOL[(dtype, "prob")],
                    TOL_JOINT if variant == "rollout"
                    else TOL[(dtype, "prob")]]
            _compare(f"attention q_block=16 {name:8s} {variant:8s} B=2 "
                     f"N=1025", got, want, tols, failures)
            if not all(torch.equal(a, b_) for a, b_ in zip(got, auto)):
                failures.append(f"q_block auto != 16 at N=1025 {name}")
            try:
                ka.masked_attention_fused(qkv, bg, j, q_block=32, **kw)
                failures.append("q_block=32 at N=1025 was not refused")
            except RuntimeError as e:
                refused = str(e)
    say(f"check q_block=32 at N=1025 is refused: {refused[:160]}")
    if failures:
        raise AssertionError("q_block: " + "; ".join(failures))


# The ablation variants against their plain versions.  float32 and bf16 as the
# attention kernel (TOL); noexp divides by a row sum of logits, so its inputs
# have q and k of mean 0.5 (row sums of order 1e2, away from 0) and its
# float32 outputs get rtol 1e-3.  The int8 products are exact in both, and
# the quantized operands come from the same float32 divisions, but P differs
# in its last bit (another summation order), so a value of P * 127 next to a
# .5 boundary may round to the other int8: that moves one term of P V by a
# whole step of V (max|v| / 127); such elements may make up 0.1 % of out.
VARIANT_RTOL_NOEXP = 1e-3


def variant_inputs(b, n, heads, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = heads * 64
    qkv = torch.randn((b, n, 3 * c), generator=g, device="cuda")
    qkv[:, :, :2 * c] += 0.5
    bg = (torch.rand((b, n), generator=g, device="cuda") < 0.3).float()
    bg[:, 0] = 0.0
    joint = torch.softmax(torch.randn((b, n, n), generator=g, device="cuda"),
                          dim=-1)
    return qkv.to(dtype).contiguous(), bg, joint


def _kernel1_rollout(qkv, bg, joint):
    """Kernel 1's rollout variant as the bf16 serving path launches it (clamp,
    mask -100), at the ablation script's scale: what ``full`` computes."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    from vision_transformer_cam_tpu_torch.scripts import attn_variants as av
    return ka.masked_attention_fused(qkv, bg, joint, num_heads=av.H,
                                     scale=av.SCALE, clamp_softmax=True)


def check_attn_variants():
    """The eight ablation kernels against run_ref on the card, in every design
    that takes the dtype (bf16: the tensor-core design, launched twice for
    identical bits, and the FMA design it ran before; float32: the FMA
    design): B=8 N=197 and a ragged B=3 N=37; and the tensor-core ``full``
    bit for bit against kernel 1's bf16 rollout variant on the same inputs.
    Returns {variant: worst error of the bf16 case at N=197 in the
    tensor-core design}."""
    from vision_transformer_cam_tpu_torch.scripts import attn_variants as av
    failures, errs = [], {}
    for (b, n) in ((8, 197), (3, 37)):
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            qkv, bg, joint = variant_inputs(b, n, 12, dtype, seed=70 + n)
            step = float(qkv[:, :, 2 * 768:].float().abs().max()) / 127.0
            for variant in av._VARIANTS:
                want = av.run_ref(qkv, bg, joint, variant)
                atol, rtol = TOL[(dtype, "out")]
                if variant == "noexp":
                    rtol = max(rtol, VARIANT_RTOL_NOEXP)
                tols = [(atol, rtol), (TOL[(dtype, "prob")][0], rtol),
                        (TOL_JOINT[0], max(TOL_JOINT[1], rtol))]
                for design in fwd_designs(dtype):
                    got = _switched(av, "_variants_bf16_design", design,
                                    av.run, qkv, bg, joint, variant)
                    torch.cuda.synchronize()
                    case = (f"attn_variants {variant:11s} {design:11s} "
                            f"{name:8s} B={b} N={n}")
                    if variant in ("int8pv", "int8both"):
                        # out: within the tolerance but for the share that a
                        # rounding flip of P moved by at most a step of V
                        err = (got[0].float() - want[0].float()).abs()
                        over = err > atol + rtol * want[0].float().abs()
                        share, worst = float(over.float().mean()), \
                            float(err.max())
                        say(f"check {case}: out max abs err {worst:.2e}, "
                            f"{share:.2e} of the elements past the tolerance "
                            f"(a step of V is {step:.2e})")
                        if share > I8_FRAC or worst > 2 * step + atol or \
                                not torch.isfinite(got[0].float()).all():
                            failures.append(f"{case} out: {worst:.3e} on "
                                            f"{share:.2e}")
                        e = _compare(case, got[1:], want[1:], tols[1:],
                                     failures)
                        e = max(e, worst)
                    else:
                        e = _compare(case, got, want, tols, failures)
                    if design == "tensor-core":
                        again = av.run(qkv, bg, joint, variant)
                        if not all(torch.equal(x, y)
                                   for x, y in zip(got, again)):
                            failures.append(f"{case}: a second launch gave "
                                            "other bits")
                    if n == 197 and design == fwd_designs(dtype)[0] \
                            and dtype == torch.bfloat16:
                        errs[variant] = e
            if dtype == torch.bfloat16:
                full = av.run(qkv, bg, joint, "full")
                k1 = _kernel1_rollout(qkv, bg, joint)
                torch.cuda.synchronize()
                same = [torch.equal(x, y) for x, y in zip(full, k1)]
                say(f"check attn_variants full (tensor-core) vs kernel 1's "
                    f"bf16 rollout variant B={b} N={n}: bit for bit out "
                    f"{same[0]}, cls {same[1]}, joint {same[2]}")
                if not all(same):
                    failures.append(f"full != kernel 1 rollout B={b} N={n}: "
                                    f"{same}")
    if failures:
        raise AssertionError("ablation kernel != plain version:\n"
                             + "\n".join(failures))
    return errs


def time_attn_variants(b=512):
    """``attn_variants --all`` at the script's batch on the tensor-core design
    (eight ms/layer lines and the differences, through its own ``main``; the
    launch counts are set to 0 before and read after), then each variant in
    turns: the tensor-core design and the plain version (the FMA design it
    replaced no longer changes and is not timed), and with ``full`` kernel
    1's bf16 rollout variant on the same inputs.  Returns ({variant: (kernel
    ms, plain ms)}, {row name: launches}, kernel 1's ms)."""
    from vision_transformer_cam_tpu_torch.scripts import attn_variants as av
    reset_counts()
    ms = av.main(["--all", "--batch", str(b)])
    counts = {k: v for k, v in read_new_counts().items()
              if k.startswith("attn_variants")}
    say(f"attn_variants --all: launches {counts}")
    if set(ms) != set(av._VARIANTS) or any(v != 62 for v in counts.values()):
        raise AssertionError(f"attn_variants --all: {ms}, launches {counts}")
    qkv, bg, joint = av.inputs(b, "cuda")
    times, k1 = {}, None
    with torch.inference_mode():
        for variant in av._VARIANTS:
            fns = {"tensor-core": lambda: _switched(
                av, "_variants_bf16_design", "tensor-core", av.run, qkv, bg,
                joint, variant)}
            fns["plain"] = lambda: av.run_ref(qkv, bg, joint, variant)
            if variant == "full":
                fns["kernel 1"] = lambda: _kernel1_rollout(qkv, bg, joint)
            got = round_robin(fns, iters=3)
            times[variant] = (got["tensor-core"], got["plain"])
            k1 = got.get("kernel 1", k1)
            say(f"time attn_variants {variant:11s} bf16 B={b} N=197, in turns: "
                + ", ".join(f"{k} {v:.4f} ms" for k, v in got.items()))
        # is the mask's cost its own arithmetic, or what masked logits do to exp
        # and the division (exp(-100) is a float32 denormal)?  The same
        # kernels on the same qkv without any background token, in turns
        zero = torch.zeros_like(bg)
        for variant in ("full", "nomask", "noexp", "int8qk"):
            with_bg, without = in_turns(
                lambda: av.run(qkv, bg, joint, variant),
                lambda: av.run(qkv, zero, joint, variant), iters=5)
            say(f"time attn_variants {variant:11s} bf16 B={b} N=197, 30 % "
                f"background {with_bg:.4f} ms, no background {without:.4f} "
                f"ms")
    return times, counts, k1


def _capture(fn, *args, **kw):
    """fn's return value and what it printed (printed again here)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*args, **kw)
    text = buf.getvalue()
    sys.stdout.write(text)
    sys.stdout.flush()
    return res, text


# the forwards of a bench.main serving run and the steps of a training run
BENCH_FWD, BENCH_STEPS = 2 + 10 * 3, 2 + 5 * 3


def bench_run(argv, want):
    """``bench.main(argv)`` with the launch counts set to 0 before and read
    after: its one JSON line must be well formed and name this card, and the
    counts must be ``want`` (a kernel it does not name: 0).  Returns the
    counts."""
    from vision_transformer_cam_tpu_torch import bench
    reset_counts()
    t0 = time.perf_counter()
    line, text = _capture(bench.main, argv)
    counts = read_counts()
    full = {k: want.get(k, 0) for k in counts}
    say(f"bench {' '.join(argv) or '(default, int8)'}: "
        f"{time.perf_counter() - t0:.1f} s, launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    printed = json.loads(text.strip().splitlines()[-1])
    if printed != line or set(line) != {"metric", "value", "unit", "device"} \
            or not line["metric"].startswith("torch_") \
            or not np.isfinite(line["value"]) or line["value"] <= 0 \
            or line["device"] != card_line():
        raise AssertionError(f"bench {argv}: bad line {text!r}")
    if counts != full:
        raise AssertionError(f"bench {argv}: launch counts {counts}, "
                             f"expected {full}")
    return counts


def bench_path():
    """The bench entry point, one JSON line per run through ``bench.main``,
    with the launch counts set to 0 before each and read after it.  Returns
    the summed launch counts."""
    fwd, lat, steps = BENCH_FWD, 2 + 10 * 15, BENCH_STEPS
    int8 = {"masked_attention_fused": 12, "linear_int8_fused": 49}
    runs = [   # argv, {kernel: launches per forward or step}, how many
        ([], int8, fwd),
        (["--bf16"], {"masked_attention_fused": 12}, fwd),
        (["--int8-hifi"], int8, fwd),
        (["--bf16", "--xla"], {}, fwd),
        (["--no-cam"], int8, fwd),
        (["--latency"], int8, lat),
        (["--mlp-fusion"], {"masked_attention_fused": 12,
                            "linear_int8_fused": 25, "mlp_fused_int8": 12},
         fwd),
        # remat: the forward kernel runs in the forward and in the recompute
        (["--train", "--mixed", "--batch", "64"],
         {"masked_attention_fused": 24, "masked_attention_bwd": 12}, steps),
        (["--model", "vit_large_patch16_384", "--batch", "16", "--bf16"],
         {"masked_attention_fused": 24}, fwd),
        (["--f32", "--precision", "high", "--batch", "64"],
         {"masked_attention_fused": 12}, fwd),
        (["--f32", "--batch", "64"], {"masked_attention_fused": 12}, fwd),
    ]
    totals = {}
    for argv, per, times in runs:
        counts = bench_run(argv, {k: v * times for k, v in per.items()})
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    if torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("--precision high was not restored")
    return totals


def scripts_path():
    """microbench (the two split-tensor variants, attn-rollout, model) at the
    script's batch and qblock_sweep at the ViT-L/16@384 shape, through their
    ``main``; returns the split-tensor kernel's launch count."""
    from vision_transformer_cam_tpu_torch.scripts import microbench, qblock_sweep
    reset_counts()
    for variant in ("attn-v1", "attn-v1-headmean", "attn-rollout", "model"):
        line = microbench.main([variant])
        if not line.startswith(variant) or "not a device time" in line:
            raise AssertionError(f"microbench {variant}: {line!r}")
    v1 = read_new_counts()["masked_attention"]
    fused = read_counts()["masked_attention_fused"]
    say(f"microbench: launches masked_attention {v1} (expected 124), "
        f"masked_attention_fused {fused} (expected {62 + 12 * 32})")
    if v1 != 2 * 62 or fused != 62 + 12 * 32:
        raise AssertionError("microbench: launch counts are off")
    res = qblock_sweep.main(["--batch", "16", "--seq", "577", "--bf16",
                             "--post"])
    if set(res) != {16, 32} or not all(res.values()):
        raise AssertionError(f"qblock_sweep: {res}")
    # the same sweep at the ViT-B/16 serving shape (bf16, rollout variant)
    say("qblock_sweep --batch 256 --seq 197 --heads 12 --bf16:")
    res = qblock_sweep.main(["--batch", "256", "--seq", "197", "--heads",
                             "12", "--bf16"])
    if set(res) != {16, 32} or not all(res.values()):
        raise AssertionError(f"qblock_sweep: {res}")
    return v1


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    card = card_line()
    say(card)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")
    sys.path.insert(0, REPO)
    # float32 paths run in full float32: no TF32 in GEMMs or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_run = time.perf_counter()

    def lap(what):
        say(f"elapsed {time.perf_counter() - t_run:.1f} s after {what}")
    build_kernels()
    lap("the build")
    attn_errs = check_attention()
    check_attention_bwd()
    bwd_occupancy()
    gemm_err = check_gemm()
    ln_err = check_ln_quant()
    mlp_err = check_mlp()
    mlp8_err = check_mlp_int8()
    mlp_occupancy()
    block_errs = check_attention_block()
    block_occupancy()
    seq_err = check_attention_seq()
    seq_w_errs = check_attention_seq_widths()
    seq_occupancy()
    v1_err = check_attention_v1()
    check_q_block()
    variant_errs = check_attn_variants()
    lap("the kernel-vs-plain checks")
    seq_ms = time_attention_seq()
    seq_w_ms = time_attention_seq_widths()
    v1_ms, v1_sdpa = time_attention_v1()
    times = time_kernels()
    fused_ms = time_fused()
    bwd_ms = time_attention_bwd()
    time_training_forward()
    lap("the kernel timings")
    launches = main_path()
    lap("phase 4")
    # phase 19, the zoo's widest and longest models, right after the main path
    zoo_launches, w80_err, w80_ms, _, _ = zoo_path()
    for name, count in zoo_launches.items():
        launches[name] = launches.get(name, 0) + count
    lap("phase 19")
    # phase 20, the zoo trained, right after it
    zoo_train_counts, launches[BWD1025], _ = zoo_train_path()
    for name, count in zoo_train_counts.items():
        launches[name] = launches.get(name, 0) + count
    lap("phase 20")
    # phase 24, kernel 1, the backward, the split-tensor and the block kernel
    # at head widths 16, 32 and 40 (the split-tensor kernel also at 80)
    width_counts, width_errs, width_ms = widths_path()
    for name, count in width_counts.items():
        launches[name] = launches.get(name, 0) + count
    lap("phase 24")
    # phase 25, the CNN-CAM demo (cuDNN convolutions: no kernel of its own)
    cnn_path()
    lap("phase 25")
    train_launches = train_path()
    launches["masked_attention_fused[bf16 plain, training]"] = \
        train_launches["masked_attention_fused"]
    launches["masked_attention_bwd"] += train_launches["masked_attention_bwd"]
    train_kernel_vs_eager()
    train_throughput()
    lap("phases 6-7")
    for name, count in quality_path().items():
        launches[name] = launches.get(name, 0) + count
    lap("phase 16")
    # the user path on the weights phase 16 leaves
    for name, count in user_path().items():
        launches[name] = launches.get(name, 0) + count
    # the serving artifact on the same weights
    for name, count in export_path().items():
        launches[name] = launches.get(name, 0) + count
    lap("phases 17-18")
    launches["masked_attention_seq_local"] = \
        seq_path()["masked_attention_seq_local"]
    validate_path()
    lap("phases 9-10")
    # phase 21, data parallelism, phase 22, tensor parallelism and the
    # pipeline, and phase 23, sequence-parallel training and the
    # batch-sharded artifact: one spawn of two ranks sharing the card; their
    # launches
    for counts in parallel_path():
        for name, count in counts.items():
            launches[name] = launches.get(name, 0) + count
    lap("phases 21-23")
    # the measurement entry points: the launch counts of every run are set to
    # 0 before it and read after it
    variant_ms, variant_launches, _ = time_attn_variants()
    launches.update(variant_launches)
    for name, count in bench_path().items():
        launches[name] = launches.get(name, 0) + count
    launches["masked_attention"] = scripts_path()
    lap("phases 13-15")
    # the GEMMs' device time out of a CUDA graph: the shortest of them take
    # less than the wrapper's host work, which the event timing reads instead
    gemm_ms = sum(times[("gemm_graph", s)] for s in GEMM_SHAPES)
    gemm_plain = sum(times[("gemm", s)][1] for s in GEMM_SHAPES)
    stats = {   # name: (max abs err, kernel ms, plain ms)
        "masked_attention_fused": (
            attn_errs[("per_head", "rollout", True, 197)],
            *times[("attention", "int8_io", "rollout")]),
        "masked_attention_fused[bf16 plain, training]": (
            attn_errs[("bfloat16", "plain", False, 197)],
            *times[("attention", "bf16 no clamp", "plain")]),
        "linear_int8_fused": (gemm_err, gemm_ms, gemm_plain),
        # device time out of a CUDA graph at the B=64 rows (12608)
        "ln_quant": (float(ln_err), times[("ln_quant_graph", 64 * 197)],
                     times[("ln_quant", 64 * 197)][1]),
        # the error at the training path's shape (B=64, N=197, bf16)
        "masked_attention_bwd": (bwd_ms[BWD_TIMED[0]][3],
                                 *bwd_ms[BWD_TIMED[0]][:2]),
        # ViT-H/14's shape (B=64, N=257, 16 heads of 80) and ViT-L/16@512's
        # (B=16, N=1025, 16 heads of 64)
        BWD80: (bwd_ms[BWD_TIMED[2]][3], *bwd_ms[BWD_TIMED[2]][:2]),
        BWD1025: (bwd_ms[BWD_TIMED[3]][3], *bwd_ms[BWD_TIMED[3]][:2]),
        "masked_attention_fused[bf16 rollout, serving]": (
            attn_errs[("bfloat16", "rollout", True, 197)],
            *times[("attention", "bf16", "rollout")]),
        # bf16 rollout at ViT-H/14's B=64 N=257, 16 heads of 80
        W80: (w80_err, *w80_ms["bf16"][:2]),
        # the new widths: the worst error of their checks, the time at
        # WIDTH_TIMED (kernel 1's bf16 rollout, the bf16 backward)
        **{FWD_W[dh]: (width_errs[0][dh], *width_ms[0][dh][:2])
           for dh in NEW_WIDTHS},
        **{BWD_W[dh]: (width_errs[1][dh], *width_ms[1][dh][:2])
           for dh in NEW_WIDTHS},
        "mlp_fused": (mlp_err[768], *fused_ms["mlp_fused"][:2]),
        "mlp_fused_int8": (mlp8_err[768], *fused_ms["mlp_fused_int8"][:2]),
        # the wide widths: the worst error of their checks (bf16; int8 at
        # float32 out), the time at MLP_TIMED
        **{MLP_W[c]: (mlp_err[c], *fused_ms[("mlp_fused", f"C={c}")][:2])
           for c in MLP_W},
        **{MLP8_W[c]: (mlp8_err[c],
                       *fused_ms[("mlp_fused_int8", f"C={c}")][:2])
           for c in MLP8_W},
        "attention_block_fused": (
            block_errs[("bfloat16", True, True, 197, "30% bg")],
            *fused_ms["attention_block_fused"][:2]),
        # the streamed design: the worst error over its zoo shape's checks
        # (B=2, both dtypes and every variant), the time at BLOCK_TIMED
        **{BLOCK_W[dh]: (block_errs[("zoo", BLOCK_TIMED[dh][1], dh)],
                         *fused_ms[("attention_block_fused", dh)][:2])
           for dh in BLOCK_W},
        # the streamed design at the new widths: the worst error over the
        # width model's shape's checks (B=2 and 64), the time at B=64
        **{BLOCK_NW[dh]: (width_errs[3][("zoo", BLOCK_WIDTH_SHAPES[dh][0],
                                         dh)], *width_ms[3][dh][:2])
           for dh in NEW_WIDTHS},
        # the error over the bf16, clamp, float32-head-mean cases at N=577,
        # the time on one rank at B=16 N=577
        "masked_attention_seq_local": (seq_err, *seq_ms[1][:2]),
        # the other widths: the worst error of their bf16, clamp, float32
        # head-mean checks (at 80: at N=257), the time on one rank at
        # SEQ_TIMED
        **{SEQ_W[dh]: (seq_w_errs[dh], *seq_w_ms[dh][1][:2])
           for dh in SEQ_WIDTHS},
        # the bf16 cases at N=197 without the head mean; the time at B=64
        "masked_attention": (v1_err, *v1_ms[False]),
        # the other widths: the worst error of their bf16 tensor-core checks,
        # the time (bf16, no head mean) at V1_TIMED
        **{V1_W[dh]: (width_errs[2][dh], *width_ms[2][dh][0][False])
           for dh in V1_WIDTHS},
        # the bf16 case at B=8 N=197 (an int8 P V out: the largest deviation,
        # a rounding flip of P); the time at the script's B=512
        **{f"attn_variants[{v}]": (variant_errs[v], *variant_ms[v])
           for v in variant_ms},
    }
    # one PyTorch call that computes the same function: only the backward has
    # one (the backward of scaled_dot_product_attention).  The forward also
    # returns the cls row and the rollout update, ln_quant the int8 rows of a
    # LayerNorm, and the int8 GEMM quantizes and requantizes around the
    # product: no single call gives those.  Nor does one call give an MLP
    # (two GEMMs around a GELU) or the attention sub-block: their unfused
    # routes of several calls are timed as yardsticks in time_fused
    # The sequence-parallel kernel's products are those of
    # scaled_dot_product_attention with the same additive mask, which returns
    # neither row0 nor the head mean: its time is the yardstick for the shape
    # Likewise for the split-tensor kernel (SDPA with the additive pair mask
    # gives out, neither the cls row nor the head mean).  No call computes an
    # ablation variant.
    library = {"masked_attention_bwd": bwd_ms[BWD_TIMED[0]][2],
               BWD80: bwd_ms[BWD_TIMED[2]][2],
               BWD1025: bwd_ms[BWD_TIMED[3]][2],
               **{BWD_W[dh]: width_ms[1][dh][2] for dh in NEW_WIDTHS},
               "masked_attention_seq_local": seq_ms[1][2],
               **{SEQ_W[dh]: seq_w_ms[dh][1][2] for dh in SEQ_WIDTHS},
               "masked_attention": v1_sdpa,
               **{V1_W[dh]: width_ms[2][dh][1] for dh in V1_WIDTHS}}
    bounds = kernel_bounds()
    bounds.update({FWD_W[dh]: width_ms[0][dh][2:4] for dh in NEW_WIDTHS})
    bounds.update({BWD_W[dh]: width_ms[1][dh][3:5] for dh in NEW_WIDTHS})
    bounds.update({SEQ_W[dh]: seq_bound(*SEQ_TIMED[dh], dh)
                   for dh in SEQ_WIDTHS})
    bounds.update({V1_W[dh]: width_ms[2][dh][2] for dh in V1_WIDTHS})
    bounds.update({BLOCK_NW[dh]: width_ms[3][dh][3] for dh in NEW_WIDTHS})
    idle = [name for name in KERNELS if not launches.get(name)]
    if idle:
        raise AssertionError(f"kernels the run's paths never launched: {idle}")
    say(json.dumps({"kernels": [
        {"name": name, "route": route, "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": stats[name][0],
         "ms": stats[name][1], "plain_ms": stats[name][2],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": library.get(name)}
        for name, (route, src, rep) in KERNELS.items()]}))
    # every launch above was followed by a synchronisation: a last one, with a
    # read back, shows that the card is still answering
    torch.cuda.synchronize()
    if float(torch.ones(8, device="cuda").sum()) != 8.0:
        raise AssertionError("the card does not answer after the run")
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of kronfluence_tpu_torch's main path on one CUDA card.

Run from the root of a checkout, with no arguments: `python3 chip_smoke.py`.
It imports the port, torch and numpy only (no JAX), and runs these phases,
each of which raises on failure:

  1. device: requires a CUDA card, prints its name and power limit, turns
     TF32 off for fp32 matmuls and convolutions;
  2. build: compiles the hand-written kernels in kronfluence_tpu_torch/csrc/
     with nvcc (sm_90a; one object per source, each source whose object is
     missing compiled in its own process, all started together; one link)
     and loads them; the wgmma syrk kernels' SASS (bf16 and fp16) and FFW's
     must hold HGMMA and UTMALDG (FFW's registers, spills and CTAs an SM
     printed beside), and FF's, FFH's, F2H's, F3H's, F2W's and F3W's HMMA
     and LDSM (cuobjdump; their registers, spills and CTAs an SM printed
     beside); FFH, FFW, F2W and F3W must show no local loads or stores (no
     spills); F2S's, F3S's,
     F2SH's, F3SH's, F2SW's, F3SW's and FFS's (at D 128 and D 256) SASS must
     hold FFMA and
     128-bit shared loads and no HMMA, local loads or stores (their FFMA,
     shared loads by width, local loads and stores, barriers, registers,
     spills and CTAs an SM printed); so must K1's fp32 ring kernel (16-byte
     and 4-byte copies), and its reduction must not spill; so must FFS64's,
     and it must fit two CTAs an SM;
  3. K3 probe: the build-and-launch check against its plain version, timed
     like for like: launch + synchronize + exactness check against
     torch.add + synchronize + the same check on the host clock, and the bare
     launch against torch.add with CUDA events;
  4. K1 syrk: the triangle kernels against their plain version at the main
     path's gram shapes and at ragged ones, in bf16, fp16 and fp32, and on a
     positive-mean bf16 input (|normal|) at the main shapes, and in bf16 at
     phase 15's Llama grams (widths 4096 and 14336); exact symmetry
     required; the 16-bit route (wgmma with TMA, or wmma) checked at each
     shape by the rule and the launch counters; a planted fault (the plain version
     with one 64-row slab left out) must read above the limit at each main
     shape; median times beside the library call and the bound. The fp32
     route also at (777, 1539): at every fp32 shape the same bits on a second
     call and one reduction a call exactly where `f32_plan` splits the rows;
     at the main shapes its device time in turns (kernel, torch.mm(a.T, a),
     torch.mm, kernel; fp32, TF32 off) with the bound, the share of the fp32
     peak on the triangle and the plan's split;
  5. main path: GPT-2 small at full width (vocab 50,257, 12 layers, 12
     heads, d 768, seq 512) in bf16 with random weights from a seeded
     generator, through covariance -> eigendecomposition -> lambda ->
     pairwise with the bf16 "smart low precision" EK-FAC recipe and the naive
     attention form. Every kernel count is zeroed before and read after; K1
     must launch 36 times per covariance batch, all on the wgmma kernel,
     F1-F3 never;
  6. reference: a small fp32 GPT-2 runs the same slice on the card and on
     the CPU (plain versions, host LAPACK); covariances, eigenvalues, lambda
     and scores must agree;
  7. K2 jacobi: the pivot-rotation kernels against their plain version on
     the route `jacobi_route` gives each case (the register kernel at the
     Jacobi path's launch shapes, m 64, Y 780 / 432 / 294, and at an odd Y;
     the generic kernel at m 32; sweeps 1 and 2), the route counters proving
     which ran; the generic kernel also at the three m 64 shapes through its
     own C entry point; a planted fault (one pair's rotation left out of one
     round) must read above the limit at Y 294; the two kernels timed in
     turns (CUDA events and torch.profiler device time) beside the plain
     version, the bound and `torch.linalg.eigh` on the same batch as a
     yardstick;
  8. Jacobi path: phase 5's covariance factors through
     `perform_eigendecomposition` with `eigendecomposition_solver="jacobi"`
     (K2 must launch once per blocked-Jacobi round, sweeps x rounds summed
     over chunks, every launch on the register route), then lambda and
     pairwise on that eigenbasis; the solver's fp32 eigenpairs are held
     against cuSOLVER's on all 96 matrices and against fp64 LAPACK, where a
     solve at block_size 16 also runs K2's generic route;
  9. flash kernels: F1 (forward), F2 (dK, dV) and F3 (dQ) against their
     plain versions at every position of O, dQ, dK, dV: at the flash path's
     shape (B 16, H 12, T 512, D 64, bf16, padded mask), at D 128 and 256 in
     bf16, in fp32 at D 64 and 256, and at T 128 without padding; FF (the pipelined
     forward: O, l, m) and FB (the fused backward, dQ, dK and dV in one
     launch) against their plain versions at the bf16 D 64 cases, where
     `forward_route` and `backward_route` take them; two planted faults (a
     dropped block of P; the segment mask left off one tile) must read above
     the limit; median times beside the plain versions,
     F.scaled_dot_product_attention (the library yardstick; for FB its
     backward alone), the naive form and the bound, FF against F1 and FB
     against F2+F3 in turns; then F1 and F2+F3 at the shapes their routes
     serve (phase 15's Llama heads, bf16 at D 128 after the GQA repeat;
     fp32 at D 64; bf16 at D 128 over GPT-2's width) in turns against SDPA's
     forward and backward, and F1-F3 at the Llama shape against their plain
     versions at every position. F2H and F3H (the bf16 D 128 backward,
     `backward_route` "split_h") against F2's and F3's plain versions at
     every position at the bf16 D 128 cases (Llama's, padded and not), two
     calls bitwise equal, the dropped-block fault planted at Llama's shape;
     F2H + F3H timed in turns against F2 + F3 and SDPA's backward at both
     bf16 D 128 route cases (it must beat F2 + F3 by device time), and the
     Function's backward split by device time into di and the kernels. FFH
     (the bf16 D 128 forward, `forward_route` "pipelined_h") against F1's
     plain version at every position of O, l and m at the bf16 D 128 cases
     ((8, 12, 512, 128) padded, Llama's padded and not, (16, 6, 512, 128)),
     two calls bitwise equal, both planted faults (the dropped block; the
     mask left off a tile) at Llama's shape; FFH timed in turns against F1
     and SDPA's forward at both bf16 D 128 route cases (it must beat F1 by
     device time), and the Function's forward split by device time into the
     operands' .contiguous() copies and FFH. F2S and F3S (the fp32 D 64
     backward, `backward_route` "split_f32") against F2's and F3's plain
     versions at every position at the fp32 D 64 case (1e-5 of max), two
     calls bitwise equal, the dropped-block fault planted there (it must
     read above 1e-5); F2S + F3S timed in turns against F2 + F3 and SDPA's
     backward alone at phase 10's fp32 shape (B 16, H 12, T 512, D 64,
     padded; it must beat F2 + F3 by device time), the Function's backward
     split into di and the kernels, and SDPA's kernel names logged. F2SH
     and F3SH (the fp32 D 128 backward, `backward_route` "split_f32_h") the
     same at the fp32 D 128 case (B 16, H 6, T 512, padded): against F2's
     and F3's plain versions within 1e-5 of max, two calls bitwise equal,
     the dropped-block fault planted there; timed in turns against F2 + F3
     and SDPA's backward alone (they must beat F2 + F3 by device time), the
     Function's backward split into di and the kernels. F2SW and F3SW (the
     fp32 D 256 backward, `backward_route` "split_f32_w") the same at
     FLASH_CASES' fp32 D 256 case and at the fp32 D 256 route case (B 16, H
     3, T 512, padded), with a second planted fault there (the segment mask
     left off a tile). F2W and F3W (the bf16 D 256 backward,
     `backward_route` "split_w") against F2's and F3's plain versions at
     every position at the bf16 D 256 route case (B 4, H 8, T 512,
     padded) and at phase 16's attention shape (GEMMA_BATCH, H 8, T 512,
     unpadded). Every split pair is held at each of its route cases by
     one check (`split_pair_checks`): its limit (bf16 units, or 1e-5 of
     max in fp32), two calls bitwise equal, finite, and two planted
     faults (the dropped block; the segment mask left off a tile where
     padded, the causal mask left off a diagonal tile where not). F2W and
     F3W are timed in turns against F2 + F3, which run on no route now and
     stay the yardstick, and SDPA's backward alone at both (they must beat F2 + F3 by
     device time), the Function's backward split into di and the kernels.
     FFW (the bf16 D 256 forward, `forward_route` "wgmma_w") at the same
     two cases: O within 8 bf16 units of F1's plain version, l and m within
     1e-5, two calls bitwise equal and finite, three planted faults (the
     dropped block; the segment mask left off a tile where padded; the
     causal mask left off a diagonal tile) above the limit; timed in turns
     against F1, which runs on no route at bf16 D 256 now and stays the
     yardstick, and SDPA's forward (it must beat F1 by device time), and the
     Function's forward split into the operands' .contiguous() copies and
     FFW. FFS (the fp32
     forward at D 128 and 256, `forward_route` "tiled_f32") against F1's
     plain version at FLASH_CASES' fp32 D 256 case and at the fp32 D 128
     and D 256 route cases (B 16, H 6 and 3, T 512, padded): O within 1e-5
     of max, l and m within 1e-5, two calls bitwise equal and finite, both
     planted faults (the dropped block; the mask left off a tile) above the
     limit; timed in turns against F1 and SDPA's forward at both route
     cases (it must beat F1 by device time). FFS64 (the fp32 D 64 forward,
     `forward_route` "tiled_f32_64") the same at FLASH_CASES' fp32 D 64 case
     and at phase 10's fp32 shape (B 16, H 12, T 512, D 64, padded): O within
     1e-5 of max, l and m within 1e-5, two calls bitwise equal and finite,
     both planted faults above the limit, timed in turns against F1, which
     runs on no route now and stays the yardstick, and SDPA's forward (it
     must beat F1 by device time). F1 and F2 + F3 also timed in turns
     against SDPA at bf16 and fp32 D 256 (where SDPA raises, logged and timed
     without it);
 10. flash path: phase 5's model, weights and data with attention="flash"
     through all four stages, scoring with fp8 (e4m3fn) query blocks and the
     auto-sized query block (`query_gradient_accumulation_steps=None`). FF
     must launch 12 times per model forward (passes and discovery forwards),
     FB 12 times per forward+backward pass, F1, F2, F3, FFH, FFW, FFS, FFS64, F2H,
     F3H, F2W, F3W, F2S, F3S, F2SH, F3SH, F2SW, F3SW and the naive form never, K1 36 times per covariance batch on the wgmma kernel; the
     covariance factors are held against phase 5's and the scores' Pearson r
     against phase 5's bf16 scores; covariance and lambda are timed in turns
     with the naive form; its artifacts stay for phase 19 (a);
 11. reference, flash: phase 6 again with attention="flash" (T 128, padded
     data), in fp32, three times: at head_dim 64 (8 heads) exactly FFS64,
     F2S and F3S (the tiled_f32_64 forward and the split_f32 backward; F1
     never) launch on the card, at head_dim 128 (4 heads) exactly FFS, F2SH
     and F3SH (the tiled_f32 forward and the split_f32_h backward), at
     head_dim 256 (2 heads) exactly FFS, F2SW and F3SW (the split_f32_w
     backward); the plain versions on the CPU; the kernels line reads
     FFS64's, F2S's and F3S's launches from the first run (F1's, 0, too),
     F2SH's and F3SH's from the second, F2SW's and F3SW's from the third
     (F2's and F3's, 0, too), FFS's from the second and third.
 12. analyzer path: phase 5's model, recipe and data through the public
     entry point, `kronfluence_tpu_torch.Analyzer` on cuda:0 with its
     artifacts in a temporary directory: `fit_all_factors`, then
     `compute_pairwise_scores` (phase 5's 16 queries x 64 train) and
     `compute_self_scores` (use_measurement_for_self_influence) on the 64
     train examples. K1 must launch 36 times per covariance batch, all on
     the wgmma kernel, K3 at least once, K2 and the flash kernels never.
     Every artifact is read back from disk: the covariance factors, counts
     and eigenpairs equal phase 5's bit for bit, lambda and the pairwise
     scores the stage functions' on the same data from phase 5's factors;
     the self scores match the pairwise diagonal with the train set as
     queries. The same calls again on the finished directory must launch no
     kernel and change no file. It prints the stage seconds beside phase
     5's, the bytes written, the write and load seconds and the peak device
     memory; the directory is deleted at the end.
 13. stage options: phase 5's model and recipe through the Analyzer again,
     artifacts in a temporary directory. (a) covariance, lambda and pairwise
     (16 queries) on 256 examples and self scores on 64, with every batch size
     left to the memory model: each stage's estimated batch (and the batch JAX's
     terms alone would pick), its planned bytes, its budget and its measured
     peak; the peak must stay within the budget and the data must not set
     the batch; K1 launches 36 times a covariance batch, and the fp32
     model's covariance (summed in fp64) at the estimated batch matches the
     one at batch 16. (b) every stage with
     offload_activations_to_cpu=True and without, on phase 5's data: the
     results agree (the sampled-Fisher lambda too) and each stage's peak is
     lower with it; one covariance on the flash path, where the recompute
     launches FF once more per layer and pass. (c) covariance and lambda
     under fp16 autocast with loss scale 2^10, held against the bf16
     factors, and a covariance with fp16 covariance dtypes, whose fp16
     operands reach K1 (counted) and are held against its plain version. (d)
     the covariance through a list of 72 dict rows with collate_fn, two
     prefetch workers and drop_last, bit for bit the column store's over the
     64 kept.
 14. score features: on phase 12's factors, model and recipe, through its
     Analyzer. (a) pairwise 16 x 64 with low-rank query blocks at rank 32
     (randomized and full SVD) and rank 64, each timed (query gradients,
     train pass) beside the dense and fp8 recipes and correlated with phase
     12's dense scores; per module on the query step's output, the full
     SVD's error must equal the optimal tail and the randomized one stay
     within 1.5x of it; the low-rank contraction must equal the dense form
     on the rebuilt block; the block's bytes must equal the memory model's;
     with the block sized by the memory model the stage's peak must stay
     within the sizer's plan (its terms, with the autograd and held-factor
     terms it takes on the card, and its budget fraction's headroom); the
     sizer's blocks at the bench's 481 x 4,656; one rank-32
     call on the flash model (FF and FB counted). (b) aggregated query,
     train and both against the sums of phase 12's scores, and bitwise equal
     under offload_activations_to_cpu. (c) tests/test_lds.py's ridge problem
     on the card through the Analyzer, retrains solved on the card: the
     ekfac LDS above 0.35 and the identity one's; mismatched measurements
     raise.
 15. Llama at Llama-3-8B width (models/llama.py: RMSNorm, interleaved RoPE,
     GQA, SwiGLU; d_model 4096, d_mlp 14336, 32 heads, 8 KV heads, vocab
     128,256, T 512, bf16, attention="flash"; reduced: 2 of 32 layers) with
     seeded random weights, through the Analyzer with the openwebtext recipe
     (the port's example task, examples/openwebtext/task.py; MLP-only tracking, extreme reduce memory with 3 module partitions,
     sampled Fisher, every batch size left to the memory model, "auto"
     eigendecomposition) on 32 train and 8 query examples: each stage's
     estimated batch, plan and budget beside its measured peak (within it);
     FFH once per attention forward and F2H, F3H once per attention backward
     (counted by hooks on the attention layers), F1, F2, F3, FF, FB, FFW,
     FFS, FFS64, F2W, F3W, F2S, F3S, F2SH, F3SH, F2SW, F3SW, K2 and the naive form never, K1 on every covariance gram, all wgmma, K3 once per
     covariance fit; the six 14336-dim factors solved one at a time by
     `eigh_large` (the stage's peak within what was resident plus one
     matrix and its solve; the checkpoints present while it runs and gone
     after), each held in fp64 on the card (residual and orthogonality); a
     rerun with two checkpoints planted solves the other four and gives the
     same bits; the partitioned covariance and lambda bit for bit an
     unpartitioned fit's on the same batches; rank-64 scores against dense
     bf16 scores on the same factors (Pearson r); one covariance with the
     smart-low-precision recipe (K1 12 a batch); and the covariance against
     the same weights with attention="naive" (phase 10's limit).
 16. Llama at Gemma-2B's widths (d_model 2048, d_mlp 16384, 8 heads, 1 KV
     head, head_dim 256, vocab 256,000, RoPE theta 10,000, RMS eps 1e-6, T
     512, bf16, attention="flash"; reduced: 2 of 18 layers, attention-only
     tracking, Llama's architecture for Gemma's) with seeded random weights,
     through the Analyzer: the four attention projections of both layers
     tracked, phase 15's covariance recipe (one module partition), fp32
     "auto" eigendecomposition, lambda and dense pairwise scores on 32 train
     and 8 query examples, every batch from the memory model (each stage's
     plan, budget and peak). F2W and F3W once per attention backward, and
     every backward reaches both layers; FFW once per attention forward and
     per recomputed one; F1, F2, F3, every other flash kernel, K2 and the naive
     form never; the scores finite; the flash form's covariance against the
     naive form's on the same weights and batches (phase 10's limit).
 17. CIFAR (the conv path): first a small fp32 SmallCNN (bias, stride 2, a
     grouped conv, 32x32), and fp32 ResNet-9 on four tracked layers (stem,
     res1/block_0/conv, layer3/conv, classifier), through the four stages
     and pairwise and self scores on the card and on the CPU, within phase
     6's limit (K1 4 times each, fp32); then bench_cifar.py's workload at
     full width through the Analyzer: ResNet-9 (10 classes, 32x32x3) in bf16
     with seeded random weights and BatchNorm statistics, the
     smart-low-precision EK-FAC recipe (empirical Fisher, fp32
     eigendecomposition), 2048 self scores and 16 x 64 pairwise scores on
     synthetic images, every batch from the memory model (the self stage in
     several), each stage's peak within its plan and its budget; factors and
     scores finite, self scores within 2^-5 of the pairwise diagonal (with a
     planted fault), K1 3 times a covariance batch (the im2col grams of
     layer3 and res2, bf16), K3 once a covariance fit.
 18. ImageNet (the conv path): ResNet-50 at full width and depth (1000
     classes, 224x224x3, fp32) with seeded random weights and BatchNorm
     statistics, through the Analyzer with examples/imagenet's recipe (EK-FAC,
     true Fisher; the eigendecomposition in fp32), dense and rank-32 pairwise
     scores, every batch from the memory model: K1 16 times a covariance
     batch (the count the shapes give), all on its fp32 route, K3 once a
     fit, every eigendecomposition by cuSOLVER (largest 4608), factors and
     scores finite, peaks within plan and budget, rank 32 against dense by
     Pearson r and each module's share of the dense scores (printed), K1's
     fp32 reductions counted by stage (some in the covariance stage, at most
     one a gram, none elsewhere); then K1's fp32 route at stage 3's grams
     (rows batch x 49, widths 2048 and 4608) and stage 2's (rows batch x 196,
     width 2304), each within phase 4's limit, exactly symmetric and the
     same bits twice, against torch.mm and its bound, device time in turns.
 19. the remaining model forms. (a) Right after phase 10, on its weights,
     data and recipe: the scanned GPT-2 (models/transformer.py:
     scanned_lm_apply over stack_layer_params of the seed-0 weights, bound
     by FunctionalModel; its projections tagged ops under scan_layers) at
     full width with attention="flash" through the four stage functions,
     each stage's seconds beside phase 10's. Its 48 tracked names and specs
     are the module form's; K1, K3, FF, FB and every other counted kernel
     launch as many times as in phase 10 (K2 and the other flash kernels 0,
     the naive form never); the activation covariance and the counts equal
     phase 10's bit for bit (FF is deterministic), the gradient covariance
     and, in phase 10's eigenbasis, lambda and the scores within 1e-2 of max
     (FB's dQ atomics are not bitwise), the scores' Pearson r at least 0.999
     in both eigenbases. With attention="naive", one covariance batch and
     its lambda equal the module form's bit for bit, and remat=True (each
     block a checkpoint_block) equals remat=False bit for bit with lower
     covariance and lambda peaks (both printed). (b) After phase 18:
     examples/uci's MLP (8, 64, 64, 1) and a RepeatedMLP at its widths, and
     (c) examples/dailymail's encoder-decoder (d 128, 4 heads, 2 layers, seq
     32, vocab 1024) with a half-masked encoder and its dict masks, each fp32
     with seeded weights through the stage functions on the card against
     the CPU port within phase 6's limit, K3 once and K2 and the flash
     kernels never on the card side; the encoder-decoder's token counts on
     the card equal the mask sums.
 20. the data mesh (parallel/), right after phase 8, on phase 5's model,
     data, recipe and batches: (a) in this process, an NCCL group of one
     rank on cuda:0 through the stage functions on its mesh (one all-reduce
     of the factor sums a stage, the scores assembled through the group):
     covariance, eigenpairs, lambda and scores equal phase 5's bit for bit,
     K1 36 a covariance batch, all wgmma, K3 once; (b) two gloo ranks on
     cuda:0 (NCCL will not put two ranks on one card), each a subprocess of
     this script (`--distributed-rank`), each taking half of every global
     batch: against a control, one process at the ranks' batches (half of
     phase 5's, so the same per-example bits; its scores' Pearson r against
     phase 5's printed), the activation and gradient covariance within one
     bf16 step of max|C| where stored in bf16 (1e-5 of max in fp32), counts
     equal, lambda in the control's eigenbasis within 2e-3 of max, the
     scores from the control's factors at Pearson r at least 0.9999;
     factors, eigenpairs and scores equal bit for bit on the two ranks;
     lambda and scores from the ranks' own eigenpairs printed; K1 144
     launches on each rank, all wgmma, K3 once a fit on each; each rank's
     stage seconds, peak memory and the seconds of its all-reduces and score
     assembly printed, and which collectives gloo runs on CUDA tensors; (c)
     where two cards are visible, the same two ranks on NCCL, one a card.
 21. the example pipelines (kronfluence_tpu_torch/examples/), through their
     entry points, after phase 19 (b, c). (a) openwebtext: fit_factors, then
     compute_scores, at Llama-3-8B's widths (d_model 4096, d_mlp 14336, 32
     heads, 8 KV heads, vocab 128,256, T 512, bf16, attention flash, seed-0
     weights; reduced: 1 of 32 layers), 16 train and 4 query examples, the
     script's recipe (extreme reduce memory, 2 module x 2 data partitions,
     fp32 "jacobi"): the three 14336-dim factors through the host-loop
     Jacobi one at a time (`eigh_large`), each held in fp64 on the card
     (residual and orthogonality under n u) and its eigenvalues within 1e-3
     of max|lambda| of cuSOLVER's fp32 eigh of the same matrix, with each
     solve's seconds, sweeps and off-norms and each sweep's split by CUDA
     events (pivot eigh, rotation GEMMs, gathers, the rest); the 4096-dim
     group through the batched Jacobi, K2 on its register route once a
     round; FFH once per attention forward, F2H and F3H never (one layer:
     no attention backward), K1 on every covariance gram (all wgmma), K3
     once a covariance fit; the scores finite. (b) wikitext: train, two
     AdamW steps of 16 at GPT-2 small's width (d 768, 12 heads, vocab
     50,257, T 512; reduced: 4 of 12 layers; fp32 weights, seed 1004), its
     losses finite and its checkpoint written; then analyze with --low_precision (the bf16
     recipe) on 32 train and 8 query examples, scores finite, and its K1
     and K3 launches equal to those of the covariance stage called
     directly on the same seed-0 model, data, batch and recipe (K1 12 a
     covariance batch, all wgmma; K3 once).
 22. the cifar, imagenet and uci example pipelines through their entry
     points, after phase 21: (a) cifar at ResNet-9's full width (32x32x3, 10
     classes): train (two AdamW steps of 64, BatchNorm in training mode),
     detect_mislabeled_dataset on 512 synthetic images with 10% of the
     labels corrupted (its top-10% and top-20% recall printed),
     inspect_factors on detect's factors, half_precision_analysis (fp32 and
     bf16 fits; its Pearson, Spearman and top-10% overlap printed); (b)
     imagenet at ResNet-50's (224x224x3, 1000 classes), 48 train and 8
     query examples in batches of 16: analyze (rank-32 query blocks),
     query_batching_analysis (full rank against rank 32, printed; it finds
     analyze's fit in its output directory, as a rerun would) and
     ddp_analyze as one process with no group, held against analyze at the
     same arguments (bit for bit, else within DDP_ALONE_RTOL of max and
     Pearson r DDP_ALONE_PEARSON_MIN); (c) uci's train, analyze and
     run_counterfactual at their own arguments. Each script's K1 launches
     (and its wgmma share) and K3 launches equal those of the covariance
     stage called directly on its model, data, batch and recipe, once a fit
     (K1 held to the shapes' count, `k1_grams_per_batch`: 3 a batch on
     ResNet-9, fp32 FFMA route for fp32, wgmma for bf16; 16 a batch on
     ResNet-50, fp32; none on the MLP), K2 and the flash kernels never;
     every score finite and of its shape.
 23. the glue, swag and dailymail example pipelines through their entry
     points, after phase 22. Each script first at tests/test_examples.py's
     arguments (the JAX scripts fix the model at d 128: no gram reaches
     K1). (a) glue: train, analyze, half_precision_analysis,
     run_counterfactual and evaluate_lds, then analyze's recipe at
     BERT-base's widths (d 768, 12 heads, T 128, vocab 30,522, 2 classes;
     reduced: 4 of 12 layers; 256 train and 16 query sequences, batch 32)
     and half_precision_analysis's bf16 recipe against it (it finds
     analyze's fit and scores as its fp32 pass; bf16 against fp32 Pearson
     and Spearman printed); (b) swag: train, analyze (rank 4),
     influence_analysis (on analyze's factors) and evaluate_lds, then
     analyze's recipe at RoBERTa-base's widths (vocab 50,265, 4 choices;
     reduced: 4 of 12 layers; 128 train and 8 query examples, batch 16)
     with rank-16 query blocks, and a second pairwise call at full rank on
     the same fit (Pearson and Spearman printed); (c) dailymail: train,
     analyze (on train's checkpoint) and inspect_examples, then analyze's
     recipe at T5-small's widths (d 512, 8 heads, MLP 2048, vocab 32,128, 6
     + 6 layers, 512 tokens on both sides; 128 train and 8 query pairs,
     batch 16; the blocks' projections tracked, lm_head not) and
     inspect_examples reading its scores. Each script's K1 (by route) and
     K3 launches equal those of the covariance stage called directly on its
     model's shapes, data, batch and recipe, once a fit: K1 0 at d 128; at
     the published widths the fp32 FFMA route in every fp32 fit and the
     wgmma route in glue's bf16 fit; K2 and the flash kernels never; every
     score finite and of its shape.

It prints each phase's seconds and the total, then one JSON line with the
kernels' results before the last line, and ends with
`{"ok": true, "device": {...}}`. Without a CUDA card, or when the
package is not beside this file, it exits non-zero without a result line.

`python3 chip_smoke.py --profile-eigh` instead fits phase 5's covariance and
times the eigendecomposition stage with each solver (cuSOLVER, Jacobi,
Jacobi, cuSOLVER; the first of each is its first run in the process), then
profiles one more run of each with torch.profiler and prints their kernel
tables, K2's launches and device time by route and its share of the Jacobi
stage. First it times the register K2 as built (4 warps) in turns against
copies of csrc/jacobi_m64.cu built alone (8 warps; 8 warps capped for 3
CTAs an SM; 4 warps capped for 4 CTAs an SM), at the three launch shapes of
the Jacobi path, and counts each one's SASS instructions.

`python3 chip_smoke.py --profile-k1` instead times phase 5's covariance
stage (cold, then warm), profiles one more warm run with torch.profiler (K1's
device time and share, the device's busy share), and times the wgmma syrk
kernel as built (kStages 4, one CTA an SM) in turns against copies of
csrc/syrk.cu built alone with kStages 3 (two CTAs an SM, and one) and, for
timing only, one whose every tile loads a single stripe as a diagonal tile
does (its results are wrong; it shows what the stripe loads cost).

`python3 chip_smoke.py --profile-flash` instead times FB as built (64-key
tile, 4 warps) in turns against copies of csrc/flash_backward.cu built alone
with a 128-key tile (held to the same bf16 limit first) and, for timing only,
without the dQ atomics (its dQ is wrong; it shows what the atomics cost),
against F2+F3 and against the wrapper's zeroing and cast of the fp32 dQ sum
alone, at the flash path's shape; then FF as built (64-query tile, 4 warps)
in turns against copies of csrc/flash_forward.cu with a 128-query tile (8
warps) and with registers capped for 4 CTAs an SM (each held to the bf16
limit first), and against F1; then FFH at Llama's heads (B 30, H 32, T 512,
D 128) and at (16, 6, 512, 128) as built (128-query tile, 8 warps, Q's
fragments in registers) against copies of csrc/flash_forward.cu with a
64-query tile of 4 warps, and with that tile reloading Q's fragments from
shared memory every key tile, each held to the bf16 limit first, with each
kernel's SASS counts, registers, spills and CTAs an SM, and against F1;
then F2H and F3H at Llama's heads (B 30, H
32, T 512, D 128) as built (4 warps of 16 keys over all of D, 32-query
steps, a 2-stage ring) against copies of csrc/flash_backward_d128.cu with the
other register layout (8 warps, two a 16-key group, P^T and dS^T through
shared memory), a 3-stage query ring and 64-query steps, each held to the bf16 limit
first, with each kernel's SASS counts (HMMA, LDSM, local LDL/STL), registers
a thread and CTAs an SM, and against F2 and F3; then F2SH and F3SH at the
fp32 D 128 case (B 16, H 6, T 512, padded) as built (every product loop
unrolled whole) against a copy of csrc/flash_backward_f32_d128.cu whose
product loops unroll 8 steps at a time (the same sums in the same order:
held to the built kernels' bits first), with each kernel's SASS counts,
registers, spills and CTAs an SM; then FFS at the same case as built (64-key
steps at D 128, one CTA an SM) against a copy of csrc/flash_forward_f32.cu
with 32-key steps at two CTAs an SM (each held to the plain version within
1e-5 of max and to its own bits; the key step moves the rescales, so the
copy's bits differ from the built kernel's), with each kernel's SASS counts,
registers, spills and CTAs an SM, and against F1; then FFS64 at the fp32 D 64
case (B 16, H 12, T 512, padded) as built (4 x 8 thread tiles, 8 warps, two
CTAs an SM) against a copy of csrc/flash_forward_f32_d64.cu with 8 x 8 thread
tiles (4 warps) and a copy of csrc/flash_forward_f32.cu instanced at D 64
(FFS's own body: 4 x 4 thread tiles, 8 warps, a 64-query tile), each held to
the plain version within 1e-5 of max and to its own bits, with each kernel's
SASS counts, registers, spills and CTAs an SM, and against F1; then F3SW at the fp32 D 256
case (B 16, H 3, T 512, padded) as built (head_dim split between the two
warp groups for S and dP, 4 x 4 thread tiles) against a copy of
csrc/flash_backward_f32_d256.cu without the split (group 0 sums S and group
1 dP over all of head_dim on 2 x 4 tiles; held to the plain version within
1e-5 of max and to its own bits), with each kernel's SASS counts, registers,
spills and CTAs an SM, and against F2SW and F3.

`python3 chip_smoke.py --distributed-rank RANK WORLD BACKEND RENDEZVOUS OUTDIR`
is one rank of phase 20, started by it: it runs phase 5's slice on the data
mesh and writes its results to OUTDIR.
"""

import copy
import ctypes
import dataclasses
import datetime
import functools
import gc
import json
import math
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import warnings
import weakref
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
SEQ = 512
COV_N, COV_BATCH = 64, 16
LAMBDA_N, LAMBDA_BATCH = 64, 16
QUERY_N, QUERY_BATCH = 16, 8
TRAIN_N, TRAIN_BATCH = 64, 16
QUERY_ACC = 2
# Phases 4 and 9 hold K1 and F1-F3 at phase 15's shapes: its covariance
# batch (the memory model's estimate on an H100 80GB HBM3; phase 15 prints
# its own) x T 512 rows at widths 4096 and 14336, and (batch, 32 heads after
# the GQA repeat, 512, 128).
LLAMA_BATCH = 30
# K1 operands on the main path: rows = batch x seq = 16 x 512; 2304 is the
# c_attn output gradient, 3072 the c_fc output gradient and the mlp/c_proj
# input activation. The ragged shapes exercise the masked edges.
SYRK_MAIN_SHAPES = ((8192, 2304), (8192, 3072))
SYRK_RAGGED_SHAPES = ((1000, 2000), (300, 1001), (777, 1539))
# K1 vs its plain version: both sum exact fp32 products (bf16 x bf16 is exact
# in fp32) in fp32, in different orders, so the gap is a few fp32 ulps of the
# partial sums: |kernel - plain| <= 1e-4 * max|C| + 1e-4 * |plain|.
SYRK_RTOL = 1e-4
SYRK_ATOL_SCALE = 1e-4
# The 16-bit kernel (bf16 and fp16) each shape must take: TMA describes
# n % 8 == 0 (torch's allocations are 16-byte aligned); 1001 and 1539
# columns take the wmma kernel.
SYRK_BF16_ROUTES = {(8192, 2304): "wgmma", (8192, 3072): "wgmma", (1000, 2000): "wgmma",
                    (300, 1001): "wmma", (777, 1539): "wmma"}
# Phase 15's grams (bf16 only, as the recipe runs them): the activation of
# gate and up and the output gradient of down at 4096, the others at 14336.
SYRK_LLAMA_SHAPES = ((LLAMA_BATCH * SEQ, 4096), (LLAMA_BATCH * SEQ, 14336))
SYRK_BF16_ROUTES.update({shape: "wgmma" for shape in SYRK_LLAMA_SHAPES})
# The planted fault: the plain version without these rows, one 64-row slab
# (one ring stage of the wgmma kernel) of the main shapes' 8,192.
SYRK_FAULT_ROWS = (4096, 4160)
# Small-input reference: the card (fp32 K1, device eigh) vs the CPU (plain
# versions, host LAPACK), on the same weights, data and eigenvectors. Both are
# fp32 with sums in different orders; the preconditioner (heuristic damping)
# amplifies those by its condition number, well under 1e3.
REFERENCE_RTOL = 1e-3
# K2 launch shapes of the Jacobi path (Y pivot blocks of m = 64, the register
# route), then an odd Y, and m = 32 (the generic route) with one sweep. Both
# kernels repeat the plain version's IEEE operations in the same order
# (explicitly rounded intrinsics, no FMA), so they agree to 1e-5 (bit for bit,
# so far). 126 rounds of fp32 rotations leave V orthogonal to ~1e-5: limit 1e-4.
JACOBI_MAIN_Y = (780, 432, 294)
JACOBI_CASES = tuple((y, 64, 2) for y in JACOBI_MAIN_Y) + ((77, 64, 1), (300, 32, 2), (5, 32, 1))
JACOBI_ATOL = 1e-5
JACOBI_ORTH = 1e-4
# The planted fault: the plain version with one pair's rotation left out of
# one round (c = 1, s = 0), at Y 294.
JACOBI_FAULT = {"y": 294, "round": 40, "pair": 7}
# The Jacobi path's chunks (padded n, matrices), in solve order, for GPT-2
# small's merged groups 3073 (24 matrices), 2304 (12) and 769 (60), under the
# 64e6-element budget; and its limits against cuSOLVER, per matrix, relative to max|lambda|.
# The fine phase stops at a relative off-norm of max(1e-6, 8 eps sqrt(n)),
# 5.3e-5 at n = 3136, and the Rayleigh quotients are second order in it; the
# reconstruction is first order in the remaining off-diagonal, whose largest
# entry is far below its Frobenius norm; orthogonality is restored by one
# Newton-Schulz step. 1e-4 for each.
JACOBI_CHUNKS = [(3136, 6)] * 4 + [(2304, 12), (832, 60)]
JACOBI_EIG_RTOL = 1e-4
JACOBI_RECON_RTOL = 1e-4
JACOBI_ORTH_ATOL = 1e-4
# Peak rates of one H100 SXM at 700 W (NVIDIA's data sheet): the bounds in
# the kernels line are max(bytes / HBM rate, operations / peak rate).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
# F1-F3 against their plain versions, which share the kernels' semantics, at
# every position of O, dQ, dK and dV. In bf16 the kernels round P (and dS) to
# bf16 against the running row max while the plain version rounds against the
# final one, sum in another order, and both round the outputs to bf16: each
# element is off by a few bf16 unit roundoffs (u = 2^-8) of its own row's
# scale, a row being one query's D values of O and dQ and one key's of dK and
# dV. So a bf16 error is counted in units of u (|plain| + max |plain| of its
# row) + u^2 max |plain| (the floor covers rows that are zero in exact
# arithmetic: query 0 sees only key 0, so its dQ is fp32 noise), limit 8
# units. The same check on the plain version with one 64 x 64 block of P left
# out, what a kernel that skipped one tile would return, must read above the
# limit for each of O, dQ, dK and dV at the flash path's shape. In fp32 the
# sums run in another order: 1e-5 of the largest plain value. The row
# statistics l and m are fp32 on both sides: 1e-5.
FLASH_BF16_UNITS = 8.0
FLASH_FP32_TOL = 1e-5
FLASH_STATS_TOL = 1e-5
# The planted fault's block (query rows, key columns), below the diagonal at
# T 512: 64 of the 385-448 keys those rows see.
FLASH_FAULT_BLOCK = (slice(384, 448), slice(192, 256))
# The second planted fault, against FF's masking decision: the plain O with
# the segment mask left off one 64 x 64 tile below the diagonal whose query
# rows cross a padding boundary (example 1 keeps 475 tokens): its padded
# rows then attend to valid keys.
FLASH_MASK_FAULT_BLOCK = (slice(448, 512), slice(384, 448))
# The third planted fault, for an unpadded shape, where no tile crosses a
# padding boundary: the causal mask left off one 64 x 64 tile on the
# diagonal, what a backward kernel that took its diagonal tile for one
# below it would return.
FLASH_DIAG_FAULT_BLOCK = (slice(448, 512), slice(448, 512))
# Phase 16 (Llama at Gemma-2B's widths, 2 of 18 layers): its covariance
# stage's estimated batch on an H100 80GB (22 of 32), at which phase 9 holds
# F2W and F3W at phase 16's attention shape.
GEMMA_BATCH = 22
# The device bytes the collector may free as phase 16 starts: more means an
# earlier phase left a reference cycle holding tensors on the card.
GC_SLACK_BYTES = 64 * 2**20
# (B, H, T, D, dtype, padded): the flash path's shape first.
FLASH_CASES = (
    (16, 12, 512, 64, torch.bfloat16, True),
    (8, 12, 512, 128, torch.bfloat16, True),
    (4, 8, 512, 256, torch.bfloat16, True),
    (8, 12, 512, 64, torch.float32, True),
    (16, 12, 128, 64, torch.bfloat16, False),
    (LLAMA_BATCH, 32, 512, 128, torch.bfloat16, True),
    (4, 4, 512, 256, torch.float32, True),
)
# The shapes F1, F2 and F3 serve or served since FF and FB took bf16 at D 64
# (B, H, T, D, dtype, padded), each timed with the kernels that took it over:
# Llama's, phase 15's path, unpadded as its data are (FFH, F2H, F3H); fp32 at
# GPT-2 small's width, the route of phase 11's first run, at phase 10's batch
# and length (F1, F2S, F3S); bf16 at D 128 over the same 768 model width
# (FFH, F2H, F3H); bf16 at D 256, FLASH_CASES' (F1, F2W, F3W; F2 and F3 the
# yardstick); fp32 at D 128
# over the 768 width, the route of phase 11's second run (FFS, F2SH, F3SH);
# fp32 at D 256 over the 768 width, the route of phase 11's third run (FFS,
# F2, F3); bf16 at D 256 at phase 16's attention shape (Gemma-2B's heads after
# the MQA repeat, unpadded: F1, F2W, F3W).
GENERIC_ROUTE_CASES = {
    "Llama bf16 D 128": (LLAMA_BATCH, 32, 512, 128, torch.bfloat16, False),
    "Gemma bf16 D 256": (GEMMA_BATCH, 8, 512, 256, torch.bfloat16, False),
    "fp32 D 64": (16, 12, 512, 64, torch.float32, True),
    "bf16 D 128": (16, 6, 512, 128, torch.bfloat16, True),
    "bf16 D 256": (4, 8, 512, 256, torch.bfloat16, True),
    "fp32 D 128": (16, 6, 512, 128, torch.float32, True),
    "fp32 D 256": (16, 3, 512, 256, torch.float32, True),
}
# The flash path against phase 5's naive path, same bf16 weights and data. The
# two forms round differently in bf16 (fp32 softmax and P rounded before P V,
# against bf16 scores and probabilities), a few bf16 steps per attention
# output, carried through 12 layers into the covariance sums: limit 5e-2 of
# each factor's max|C|. Scores: fp8 query blocks against phase 5's bf16 dense
# blocks, Pearson r at least 0.97, the JAX package's weakest fp8 certificate.
FLASH_FACTOR_RTOL = 5e-2
FLASH_PEARSON_MIN = 0.97
# Phase 12: K1's launches per covariance batch on GPT-2 small (48 tracked
# linears: the 2304- and 3072-wide gradient grams and the 3073-wide bordered
# activation gram pass the shape rule, 36 of the 96 grams a batch).
SYRK_LAUNCHES_PER_COV_BATCH = 36
# Self scores against the pairwise diagonal, both bf16. Each side rounds each
# of its 48 per-module scores to bf16 and sums them in bf16 (47 more
# roundings of partial sums up to the largest score), from contractions taken
# in another order (self: preconditioned gradient . gradient; pairwise: the
# query block against the train tokens). Limit 8 bf16 units (2^-8 each) of
# max |diagonal|: 2^-5. On an H100 80GB HBM3 it read 8.7e-3, 2.2 units.
# A planted fault, the same check against the first superdiagonal (each
# example's influence on its neighbour), must read above it.
SELF_DIAGONAL_RTOL = 2.0 ** -5
# Phase 13 (stage options). (a) The estimated-batch fits run on 256 examples
# (self scores on the first 64), more than any stage's estimate at GPT-2
# small on 80 GB, so that the estimate sets the batch; the covariance of the fp32 model summed in fp64 at
# the estimated batch against batch 16 differs by the order of the fp32
# forward's GEMMs and of the fp64 sums only: 1e-5 of max|C|. (b)
# Rematerialisation recomputes the same operations on the same inputs: 1e-6
# of max (bit for bit, where the kernels are deterministic; FB's dQ atomics are
# not, and the flash path is held to phase 10's limit). (d) 72 rows in
# batches of 16 with drop_last keep 64.
OPTIONS_N = 256
OPTIONS_SELF_N = 64
OPTIONS_BATCH_RTOL = 1e-5
REMAT_RTOL = 1e-6
LOADER_N = 72
# Phase 14 (score features). (a) Low-rank query blocks at ranks 32 and 64, all
# 16 queries one chunk, so every module takes `lowrank_route`'s order (at q 16
# c_attn, c_fc and mlp/c_proj project the tokens, attn/c_proj rebuilds). The
# SVD is held on the query step's fp32 output before the cast to the score
# dtype, for the first SVD_CHECK_QUERIES queries: the full SVD's relative Frobenius error equals the optimal tail
# (Eckart-Young, singular values in fp64) up to fp32 rounding, 1e-3 relative;
# the randomized one (oversample 8, two power iterations) within 1.5x of it.
# The contraction is held in fp32 (per-sample-gradient and score dtypes), on the
# call's own bf16 factors: the low-rank route against the dense form on the
# rebuilt block sum the same products in another order, 1e-3 of max|score|;
# the call's bf16 scores against that fp32 route carry bf16 roundings only,
# phase 12's limit of 8 bf16 units of the max, 2^-5. (b) Aggregated scores
# against the row and column sums of phase 12's bf16 dense scores: the same
# sums taken before the contraction instead of after, in bf16, 2^-5 of
# max|sum|. (c) tests/test_lds.py's ridge problem on the card, with its bars.
LOWRANK_RANKS = (32, 64)
SVD_TAIL_RTOL = 1e-3
SVD_CHECK_QUERIES = 2
RANDOMIZED_TAIL_FACTOR = 1.5
CONTRACTION_RTOL = 1e-3
FEATURES_BF16_RTOL = 2.0 ** -5
BENCH_QUERIES, BENCH_TRAIN = 481, 4656
LDS_D, LDS_TRAIN, LDS_QUERY, LDS_SUBSETS, LDS_SEED, LDS_RIDGE = 6, 64, 8, 48, 3, 1e-3
LDS_MIN = 0.35
# Phase 15 (Llama at Llama-3-8B width, 2 of 32 layers; the JAX package's own
# 8B-width run: tests/test_llama_scale.py:297-313): the openwebtext recipe
# (extreme reduce memory, 3 module partitions, rank-64 query blocks) on 32
# train and 8 query examples. Two of the six 14336-dim factors are planted
# as checkpoints for the rerun. Scores: rank-64 and dense blocks, each in the
# recipe's bf16 and with fp32 preconditioning; the bf16 recipe against its
# fp32 twin at Pearson r 0.99 or more, rank 64 against dense reported with
# the optimal rank-64 tail that bounds it (at these random weights the
# preconditioned gradients are far from rank 64, where GPT-2's were not:
# phase 14 read r 0.9997). The eigenpairs' limits are stated where they are
# checked.
LLAMA_LAYERS = 2
LLAMA_TRAIN_N, LLAMA_QUERY_N = 32, 8
LLAMA_MODULE_PARTITIONS = 3
LLAMA_RANK = 64
LLAMA_PLANTED = 2
LLAMA_PRECISION_PEARSON_MIN = 0.99
LLAMA_SCORE_VARIANTS = (
    ("lowrank", LLAMA_RANK, {}),
    ("dense", None, {}),
    ("lowrank fp32", LLAMA_RANK, {"precondition_dtype": "float32", "score_dtype": "float32"}),
    ("dense fp32", None, {"precondition_dtype": "float32", "score_dtype": "float32"}),
)
# Phase 16 (Llama at Gemma-2B's widths): 2 of 18 layers, the attention
# projections tracked; the data, the task and the recipe are phase 15's
# (LLAMA_TRAIN_N train and LLAMA_QUERY_N query examples, dense scores).
GEMMA_LAYERS = 2
# The low-rank path held at Llama's shapes on the first queries' blocks: the
# randomized SVD within phase 14's 1.5x of the optimal rank-64 tail, and the
# low-rank contraction against the dense form on the rebuilt block in fp32
# (phase 14's 1e-3 of max|score|), over train batches of 8.
LLAMA_CHECK_QUERIES, LLAMA_CHECK_BATCH = 2, 8
# Phase 21 (a): the openwebtext example's entry points at Llama-3-8B's widths,
# one layer, the script's default batch and partitions; (b) the wikitext
# example's train (two steps) and analyze at GPT-2 small's width, 4 of 12
# layers (cut from 12 to keep the run within its time limit beside phase 23:
# the analyze's fp64 host eigendecomposition took 60 s at 12 layers, and
# phase 23's BERT-base-width fits cover the same widths, 768, 2304 and
# 3072). K1 3 a layer and covariance batch: c_attn's 2304 and c_fc's 3072
# gradient grams and mlp/c_proj's 3073 activation gram.
OWT_LAYERS = 1
OWT_WIDTHS = dict(d_model=4096, d_mlp=14336, num_heads=32, num_kv_heads=8, vocab=128256)
GPT2_WIDTHS = dict(num_layers=4, d_model=768, num_heads=12, vocab=50257)
WIKITEXT_K1_PER_BATCH = 3 * GPT2_WIDTHS["num_layers"]
OWT_TRAIN_N, OWT_QUERY_N = 16, 4
OWT_BATCH, OWT_MODULE_PARTITIONS, OWT_DATA_PARTITIONS = 4, 2, 2
# Host-loop eigenvalues against cuSOLVER's fp32 eigh of the same matrix, of max|lambda|.
HOSTLOOP_EIG_RTOL = 1e-3
# The factor of phase 15 that phase 21 solves with the host-loop Jacobi.
HOSTLOOP_MODULE = "layers_0/mlp/gate_proj"
WIKITEXT_TRAIN_N, WIKITEXT_QUERY_N, WIKITEXT_BATCH = 32, 8, 16
# Phase 22: the cifar, imagenet and uci examples' entry points. (a) cifar:
# ResNet-9 at 32 x 32 and 10 classes; train takes CIFAR_TRAIN_STEPS AdamW
# steps of CIFAR_EXAMPLE_BATCH, detect_mislabeled_dataset and
# half_precision_analysis train on CIFAR_EXAMPLE_N synthetic images (10% of
# the labels corrupted) for their scripts' default epochs and fit and score in
# batches of CIFAR_EXAMPLE_BATCH; (b) imagenet: ResNet-50 at phase 18's shape
# (224 x 224, 1000 classes) on IMAGENET_N train and IMAGENET_QUERY_N query
# examples in batches of IMAGENET_EXAMPLE_BATCH, rank-IMAGENET_RANK query
# blocks; (c) uci: the scripts' own arguments.
CIFAR_EXAMPLE_N, CIFAR_EXAMPLE_BATCH, CIFAR_TRAIN_STEPS = 512, 64, 2
IMAGENET_EXAMPLE_BATCH = 16
# ddp_analyze as one process against analyze at the same arguments: bit for
# bit where every kernel on the path is deterministic; where not, within
# this share of max|score| and at this Pearson r at least (3.879e-8 and
# 1.00000000 on an H100 80GB HBM3 at 700 W: the conv backward is not bitwise
# reproducible).
DDP_ALONE_RTOL, DDP_ALONE_PEARSON_MIN = 1e-6, 0.999999
# Phase 17 (CIFAR): bench_cifar.py's ResNet-9 workload (its counts 6144 /
# 4096 / 4096) cut to CIFAR_COV_N covariance, CIFAR_LAMBDA_N lambda and
# CIFAR_SELF_N self-score examples and CIFAR_QUERY_N x CIFAR_TRAIN_N pairs.
# CIFAR_SELF_N is large enough that the memory model splits the self stage
# into batches, so its plan binds. K1 a covariance batch, from the shapes
# (`k1_grams_per_batch`): the im2col activation grams of layer3/conv (2304
# wide) and res2's two convs (4608), on the bf16 route.
CIFAR_SIZE = 32
CIFAR_COV_N, CIFAR_LAMBDA_N, CIFAR_SELF_N = 512, 512, 2048
CIFAR_QUERY_N, CIFAR_TRAIN_N = 16, 64
CIFAR_K1_PER_BATCH = 3
# Phase 17's card-against-CPU checks: a small SmallCNN whole, and ResNet-9 at
# full width on a tracked subset with convs of 128 channels (res1/block_0,
# im2col 1152 wide) and 256 (layer3, 2304 wide: K1's fp32 route once a
# covariance batch), CIFAR_REFERENCE_N examples a factor stage.
CIFAR_REFERENCE_TRACKED = ("stem/conv", "res1/block_0/conv", "layer3/conv", "classifier")
CIFAR_REFERENCE_N = 64
# Phase 18 (ImageNet): ResNet-50 at full width and depth on IMAGENET_N examples
# a factor stage and IMAGENET_QUERY_N x IMAGENET_TRAIN_N pairs, dense and at
# rank IMAGENET_RANK (examples/imagenet/analyze.py's default). K1 a covariance
# batch, from the shapes (`k1_grams_per_batch`): the im2col activation grams
# of stage 2's six conv2 (2304 wide) and stage 3's three conv2 (4608), the
# activation grams of stage 3's blocks 1 and 2 conv1 (C_in 2048) and of the
# classifier (2048), the gradient grams of stage 3's three conv3 and its proj
# (C_out 2048). K1's fp32 route is timed at those three grams: (positions an
# example, width) of stage 3's 7 x 7 maps at 2048 and 4608 and stage 2's
# 14 x 14 maps at 2304, rows the covariance batch times the positions.
# Phase 19 (a): the scanned GPT-2 against phase 10's module form. FB's dQ
# atomics are not bitwise reproducible, so what the gradient reaches is held
# within 1e-2 of max, and the scores' Pearson r at 0.999; the activation
# covariance (FF is deterministic) and the naive form's factors bit for bit.
SCAN_RTOL = 1e-2
SCAN_PEARSON_MIN = 0.999
# Phase 10's fp8 query blocks turn last-bit differences into fp8 rounding
# steps: there the scanned form is held to this many times the module form's
# own run-to-run gap and 1 - r (the module form's pairwise stage read 2.85e-2
# and r 0.99853 against itself on an H100 80GB HBM3 at 700 W).
SCAN_NOISE_FACTOR = 3.0
# Phase 19 (b): examples/uci's MLP widths (8 features, two hidden layers of
# 64; RepeatedMLP's shared 64-wide layer three times a forward), fp32.
UCI_IN, UCI_HIDDEN = 8, 64
UCI_N, UCI_BATCH = 256, 64
# Phase 19 (c): examples/dailymail's EncDecLM (construct_seq2seq's defaults).
DAILYMAIL = dict(vocab_size=1024, max_seq_len=32, num_layers=2, num_heads=4, d_model=128)
DAILYMAIL_N = 64

# Phase 23: the glue, swag and dailymail examples' entry points, each at
# tests/test_examples.py's arguments (the JAX scripts fix the model at d 128,
# where no gram reaches K1), then analyze's recipe at a published model's
# widths through the pipeline's own constructor, at the scripts' own counts:
# (a) BERT-base (arXiv 1810.04805: d 768, 12 heads, vocab 30,522; T 128, 2
# classes), fp32 and half_precision_analysis's bf16, 256 train and 16 query
# examples, batch 32; (b) RoBERTa-base (arXiv 1907.11692: vocab 50,265), T
# 128, 4 choices, 128 train and 8 query examples, batch 16, rank 16; (c)
# T5-small (arXiv 1910.10683: d 512, 8 heads, MLP 2048, vocab 32,128, 6 + 6
# layers), 512 tokens on both sides, 128 train and 8 query pairs, batch 16.
# Reduced: BERT-base and RoBERTa-base 4 of 12 layers.
BERT_BASE = dict(seq_len=128, vocab=30522, num_layers=4, num_heads=12, d_model=768)
ROBERTA_BASE = dict(seq_len=128, vocab=50265, num_layers=4, num_heads=12, d_model=768)
T5_SMALL = dict(seq_len=512, vocab=32128, num_layers=6, num_heads=8, d_model=512)
GLUE_N, GLUE_QUERY_N, GLUE_BATCH = 256, 16, 32
SWAG_N, SWAG_QUERY_N, SWAG_BATCH, SWAG_RANK = 128, 8, 16, 16
DAILYMAIL_FULL_N, DAILYMAIL_QUERY_N, DAILYMAIL_BATCH = 128, 8, 16

IMAGENET_SIZE = 224
IMAGENET_N = 48
IMAGENET_QUERY_N, IMAGENET_TRAIN_N = 8, 32
IMAGENET_RANK = 32
IMAGENET_K1_PER_BATCH = 16
IMAGENET_K1_GRAMS = ((49, 2048), (49, 4608), (196, 2304))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def roofline(nbytes: float, ops: float, peak: float):
    """The least time (ms) the card could take: the larger of the bytes over
    the HBM rate and the operations over the peak rate, and which it is."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops else "operations")


def median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# Spin kernels that open each device_ms window (about 1 us each).
PRIMER_KERNELS = 64


def device_ms(fn, names=None, calls: int = 20, tries: int = 5) -> float:
    """Device time per call of the kernels whose names hold one of `names`,
    or of every kernel the call launches (torch.profiler's CUDA activity).
    The profiler loses a window's first kernels once `--profile-*` has
    loaded kernel libraries of its own (on an H100: 19 of 20 recorded after
    two, 3 of 20 behind 16 spin kernels after seven), now and then all of a
    window's (0 of 20), or hands some to the next window (24 of 20). So a
    window opens with PRIMER_KERNELS spin kernels, not counted, and each
    kernel name counts as its mean time times the launches a call makes:
    its count over `calls`, rounded. A name whose count is more than a
    quarter of `calls` off that multiple, or a window with no kernel of the
    call, is profiled again, at most `tries` times in all; a name with too
    few events for one a call came late from an earlier window."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PRIMER_KERNELS):
                torch.cuda._sleep(1000)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.key
                  and (names is None or any(n in e.key for n in names))]
        us, whole = 0.0, True
        for e in events:
            per_call = round(e.count / calls)
            if per_call:
                whole = whole and abs(e.count - per_call * calls) <= calls / 4
                us += per_call * e.self_device_time_total / e.count
        if whole and us > 0:
            return us / 1e3
        log(f"torch.profiler recorded {[(e.key[:40], e.count) for e in events]} for {calls} "
            f"calls{f' of kernels named {names}' if names else ''}: profiling again")
    raise RuntimeError(f"torch.profiler kept losing device events of {names or 'the call'}")


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("No CUDA device: chip_smoke.py runs the port on a GPU only.")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(
        f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}; "
        f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}"
    )
    return card


def phase_build() -> None:
    from kronfluence_tpu_torch.ops.kernels import build

    prebuilt = build.library_path().exists()
    compiled = [src for src in build.SOURCES if not build.object_path(src).exists()]
    t0 = time.perf_counter()
    build.build_library()
    built_s = time.perf_counter() - t0
    build.load_library()
    log(f"build: {'reused' if prebuilt else 'linked'} {build.library_path().name} in "
        f"{built_s:.2f} s; compiled {compiled or 'nothing'}, reused the objects of "
        f"{[src for src in build.SOURCES if src not in compiled] or 'nothing'}")
    log_path = build.build_log_path()
    if log_path.exists():
        for line in log_path.read_text().splitlines():
            if line.startswith("== ") or "Compiling entry" in line:
                log(f"  {line.split(':', 1)[-1].strip()}")
            elif "Used" in line or "spill" in line:
                log(f"    ptxas: {line.split(':', 1)[-1].strip()}")
    for kernel in ("syrk_bf16_wgmma_kernel", "syrk_f16_wgmma_kernel"):
        counts = sass_counts(build.library_path(), kernel, ("HGMMA", "UTMALDG"))
        log(f"SASS of {kernel}: {counts}")
        if not all(counts.values()):
            raise RuntimeError(f"{kernel} lacks wgmma or TMA instructions: {counts}")
    lib = build.load_library()
    counts = sass_counts(build.library_path(), FFW_KERNEL, FFW_OPCODES)
    occ = occupancy(lib, FFW_OCCUPANCY, 0)
    log(f"SASS of {FFW_KERNEL}: {counts}; {occ}")
    if not (counts["HGMMA"] and counts["UTMALDG"]):
        raise RuntimeError(f"{FFW_KERNEL} lacks wgmma or TMA instructions: {counts}")
    if counts["LDL"] or counts["STL"] or occ["local_bytes"]:
        raise RuntimeError(f"FFW spills: {counts}, {occ}")
    for which, kernel in enumerate(D128_KERNELS):
        counts = sass_counts(build.library_path(), kernel, D128_OPCODES)
        log(f"SASS of {kernel}: {counts}; {occupancy(lib, D128_OCCUPANCY, which)}")
        if not (counts["HMMA"] and counts["LDSM"]):
            raise RuntimeError(f"{kernel} lacks mma.sync or ldmatrix instructions: {counts}")
    for which, kernel in enumerate(D256_KERNELS):
        counts = sass_counts(build.library_path(), kernel, D128_OPCODES)
        occ = occupancy(lib, D256_OCCUPANCY, which)
        log(f"SASS of {kernel}: {counts}; {occ}")
        if not (counts["HMMA"] and counts["LDSM"]):
            raise RuntimeError(f"{kernel} lacks mma.sync or ldmatrix instructions: {counts}")
        if counts["LDL"] or counts["STL"] or occ["local_bytes"]:
            raise RuntimeError(f"{kernel} spills: {counts}, {occ}")
    for which, kernel in enumerate(FWD_KERNELS):
        counts = sass_counts(build.library_path(), kernel, D128_OPCODES)
        occ = occupancy(lib, FWD_OCCUPANCY, which)
        log(f"SASS of {kernel}: {counts}; {occ}")
        if not (counts["HMMA"] and counts["LDSM"]):
            raise RuntimeError(f"{kernel} lacks mma.sync or ldmatrix instructions: {counts}")
        if kernel == FWD_KERNELS[1] and (counts["LDL"] or counts["STL"] or occ["local_bytes"]):
            raise RuntimeError(f"FFH spills: {counts}, {occ}")
    for kernels, entry in ((F32_KERNELS, F32_OCCUPANCY), (F32_D128_KERNELS, F32_D128_OCCUPANCY),
                           (F32_D256_KERNELS, F32_D256_OCCUPANCY), (FFS_KERNELS, FFS_OCCUPANCY),
                           ((FFS64_KERNEL,), FFS64_OCCUPANCY)):
        for which, kernel in enumerate(kernels):
            counts = sass_counts(build.library_path(), kernel, F32_OPCODES)
            occ = occupancy(lib, entry, which)
            log(f"SASS of {kernel}: {counts}; {occ}")
            # Every product an fp32 FMA fed by 128-bit shared loads; no
            # tensor-core (TF32) instruction.
            if not (counts["FFMA"] and counts["LDS.128"]) or counts["HMMA"]:
                raise RuntimeError(f"{kernel} is not the register-tiled FFMA kernel: {counts}")
            if counts["LDL"] or counts["STL"] or occ["local_bytes"]:
                raise RuntimeError(f"{kernel} spills: {counts}, {occ}")
    # FFS64's design runs two CTAs of 8 warps an SM.
    occ = occupancy(lib, FFS64_OCCUPANCY, 0)
    if occ["ctas_per_sm"] < 2:
        raise RuntimeError(f"FFS64 fits {occ['ctas_per_sm']} CTA an SM, built for 2: {occ}")
    for which, kernel in enumerate(SYRK_F32_KERNELS):
        counts = sass_counts(build.library_path(), kernel, F32_OPCODES)
        occ = occupancy(lib, SYRK_F32_OCCUPANCY, which)
        log(f"SASS of {kernel}: {counts}; {occ}")
        ring = kernel != SYRK_F32_KERNELS[2]
        if ring and (not (counts["FFMA"] and counts["LDS.128"]) or counts["HMMA"]):
            raise RuntimeError(f"{kernel} is not the register-tiled FFMA kernel: {counts}")
        if counts["LDL"] or counts["STL"] or occ["local_bytes"]:
            raise RuntimeError(f"{kernel} spills: {counts}, {occ}")


# F2H and F3H (csrc/flash_backward_d128.cu), and FF and FFH
# (csrc/flash_forward.cu), in the order of their occupancy entry's `which`,
# and the SASS opcodes counted for them (LDL and STL are local loads and
# stores: spills).
D128_KERNELS = ("flash_bwd_dkv_d128_kernel", "flash_bwd_dq_d128_kernel")
D128_OCCUPANCY = "kf_flash_bwd_d128_occupancy"
# F2W and F3W (csrc/flash_backward_d256.cu), likewise.
D256_KERNELS = ("flash_bwd_dkv_d256_kernel", "flash_bwd_dq_d256_kernel")
D256_OCCUPANCY = "kf_flash_bwd_d256_occupancy"
FWD_KERNELS = ("flash_fwd_pipelined_kernel", "flash_fwd_d128_kernel")
FWD_OCCUPANCY = "kf_flash_fwd_occupancy"
# FFW (csrc/flash_forward_d256.cu), its occupancy entry, and its SASS
# opcodes: wgmma (HGMMA), TMA loads (UTMALDG), local loads and stores.
FFW_KERNEL = "flash_fwd_d256_kernel"
FFW_OCCUPANCY = "kf_flash_fwd_d256_occupancy"
FFW_OPCODES = ("HGMMA", "UTMALDG", "LDL", "STL", "MUFU.EX2", "BAR", "instructions")
D128_OPCODES = ("HMMA", "LDSM", "LDL", "STL", "MUFU.EX2", "instructions")
# F2S and F3S (csrc/flash_backward_f32.cu), in the order of their occupancy
# entry's `which`, and the SASS opcodes counted for them ("LDS" counts the
# shared loads of every width).
F32_KERNELS = ("flash_bwd_dkv_f32_kernel", "flash_bwd_dq_f32_kernel")
F32_OCCUPANCY = "kf_flash_bwd_f32_occupancy"
# F2SH and F3SH (csrc/flash_backward_f32_d128.cu), likewise.
F32_D128_KERNELS = ("flash_bwd_dkv_f32_d128_kernel", "flash_bwd_dq_f32_d128_kernel")
F32_D128_OCCUPANCY = "kf_flash_bwd_f32_d128_occupancy"
# F2SW and F3SW (csrc/flash_backward_f32_d256.cu), likewise.
F32_D256_KERNELS = ("flash_bwd_dkv_f32_d256_kernel", "flash_bwd_dq_f32_d256_kernel")
F32_D256_OCCUPANCY = "kf_flash_bwd_f32_d256_occupancy"
# FFS (csrc/flash_forward_f32.cu) at D 128 and D 256, likewise: the
# templated kernel's names hold its head dim.
FFS_KERNELS = ("flash_fwd_f32_kernelILi128", "flash_fwd_f32_kernelILi256")
FFS_OCCUPANCY = "kf_flash_fwd_f32_occupancy"
# FFS's kernel as torch.profiler names it (both head dims).
FFS_PROFILED = ("flash_fwd_f32_kernel",)
# FFS64 (csrc/flash_forward_f32_d64.cu), its occupancy entry, and its kernel
# as torch.profiler names it.
FFS64_KERNEL = "flash_fwd_f32_d64_kernel"
FFS64_OCCUPANCY = "kf_flash_fwd_f32_d64_occupancy"
FFS64_PROFILED = (FFS64_KERNEL,)
# K1's fp32 ring kernel (16-byte and 4-byte copies) and its reduction
# (csrc/syrk.cu), in the order of their occupancy entry's `which`.
SYRK_F32_KERNELS = ("syrk_f32_ring_kernelILb1E", "syrk_f32_ring_kernelILb0E",
                    "syrk_f32_reduce_kernel")
SYRK_F32_OCCUPANCY = "kf_syrk_f32_occupancy"
F32_OPCODES = ("FFMA", "HMMA", "LDS", "LDS.64", "LDS.128", "LDL", "STL", "BAR", "instructions")


def occupancy(lib, entry: str, which: int) -> dict:
    """Registers a thread, local (spill) bytes a thread and CTAs an SM of the
    kernel `which` of the occupancy entry point `entry` in `lib`, as the CUDA
    runtime reports them."""
    regs, local, ctas = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = getattr(lib, entry)(which, ctypes.byref(regs), ctypes.byref(local), ctypes.byref(ctas))
    if err:
        raise RuntimeError(f"{entry} failed with CUDA error {err}")
    return {"registers": regs.value, "local_bytes": local.value, "ctas_per_sm": ctas.value}


@functools.lru_cache(maxsize=None)
def library_sass(library: Path) -> str:
    """The SASS of every kernel in the library (cuobjdump), read once a library."""
    from kronfluence_tpu_torch.ops.kernels import build

    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    return subprocess.run([str(cuobjdump), "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def sass_counts(library: Path, kernel: str, opcodes) -> dict:
    """How often each opcode appears in `kernel`'s SASS in the library;
    "instructions" counts them all."""
    sass = library_sass(Path(library))
    body = "".join(part for part in re.split(r"\n\s*Function : ", sass)
                   if kernel in part.split("\n", 1)[0])
    return {op: len(re.findall(r"/\*[0-9a-f]{4,}\*/" if op == "instructions"
                               else rf"\b{re.escape(op)}\b", body)) for op in opcodes}


def phase_probe() -> dict:
    from kronfluence_tpu_torch.ops.kernels.build import load_library
    from kronfluence_tpu_torch.ops.kernels.probe import (
        PROBE_SHAPE,
        launch_probe,
        probe,
        probe_reference,
    )

    src = torch.zeros(PROBE_SHAPE, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    got = probe("cuda")
    err = float((got - probe_reference(src)).abs().max())
    if err != 0.0:
        raise RuntimeError(f"K3 probe disagrees with src + 1: max |err| {err}")

    def library_checked():
        out = torch.add(src, 1.0)
        torch.cuda.synchronize()
        if not bool(torch.all(out == 1.0)):
            raise RuntimeError("torch.add(src, 1) returned wrong values")

    def host_median(fn) -> float:
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    # Like for like on the host clock: each call launches, synchronizes and
    # checks every element. Then the bare launches with CUDA events.
    lib = load_library()
    host_ms = host_median(lambda: probe("cuda"))
    library_host_ms = host_median(library_checked)
    ms = median_ms(lambda: launch_probe(lib, src, dst))
    plain_ms = median_ms(lambda: probe_reference(src))
    library_ms = median_ms(lambda: torch.add(src, 1.0))
    # 4 KB in, 4 KB out, 1,024 adds: the bound is far below one launch.
    bound_ms, bound_by = roofline(2 * src.numel() * 4, src.numel(), FP32_FLOPS)
    log(f"K3 probe: exact; host clock (launch + sync + check): probe {host_ms:.4f} ms, "
        f"torch.add {library_host_ms:.4f} ms; CUDA events (bare launch): K3 {ms:.4f} ms, "
        f"plain src+1 {plain_ms:.4f} ms, torch.add {library_ms:.4f} ms; "
        f"bound {bound_ms:.2e} ms ({bound_by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, "host_ms": host_ms,
            "library_host_ms": library_host_ms}


def syrk_units(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| in units of its limit, SYRK_ATOL_SCALE max|want|
    + SYRK_RTOL |want|: the check passes at <= 1."""
    bound = SYRK_ATOL_SCALE * want.abs().max() + SYRK_RTOL * want.abs()
    return float(((got - want).abs() / bound).max())


def phase_syrk(card: str) -> dict:
    from kronfluence_tpu_torch.ops.kernels.syrk import (
        TILE,
        bf16_route,
        f32_plan,
        syrk,
        syrk_reference,
        triangle_tiles,
        wgmma_smem_bytes,
    )

    gen = torch.Generator("cuda").manual_seed(0)
    smem = wgmma_smem_bytes()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst = 0.0
    timing = {}
    cases = []
    for rows, n in SYRK_MAIN_SHAPES + SYRK_RAGGED_SHAPES:
        cases += [(rows, n, torch.bfloat16, "normal"), (rows, n, torch.float32, "normal"),
                  (rows, n, torch.float16, "normal")]
        if (rows, n) in SYRK_MAIN_SHAPES:
            cases.append((rows, n, torch.bfloat16, "|normal|"))
    cases += [(rows, n, torch.bfloat16, "normal") for rows, n in SYRK_LLAMA_SHAPES]
    timed = SYRK_MAIN_SHAPES + SYRK_LLAMA_SHAPES
    for rows, n, dtype, kind in cases:
        a = torch.randn(rows, n, generator=gen, device="cuda")
        a = (a.abs() if kind == "|normal|" else a).to(dtype)
        name = f"{rows}x{n} {str(dtype).split('.')[-1]} {kind}"
        before, f16_before = syrk.wgmma_launches, syrk.f16_launches
        reduce_before = syrk.f32_reduce_launches
        got = syrk(a)
        want = syrk_reference(a)
        torch.cuda.synchronize()
        if syrk.f16_launches != f16_before + (dtype == torch.float16):
            raise RuntimeError(f"K1's fp16 launch count is off at {name}")
        if dtype in (torch.bfloat16, torch.float16):
            route = "wgmma" if syrk.wgmma_launches == before + 1 else "wmma"
            if not route == bf16_route(n, a.data_ptr()) == SYRK_BF16_ROUTES[(rows, n)]:
                raise RuntimeError(f"K1 at {name} took {route}; the rule says "
                                   f"{bf16_route(n, a.data_ptr())}, want {SYRK_BF16_ROUTES[(rows, n)]}")
            tiles = triangle_tiles(n, TILE)
            route += f" ({tiles} tiles" + (f", {smem} B dynamic smem)" if route == "wgmma" else ")")
        else:
            plan = f32_plan(rows, n, sms)
            if syrk.f32_reduce_launches != reduce_before + (plan.splits > 1):
                raise RuntimeError(f"K1's fp32 reduction launched "
                                   f"{syrk.f32_reduce_launches - reduce_before} times at {name}, "
                                   f"the plan splitting the rows {plan.splits} ways")
            if not torch.equal(got, syrk(a)):
                raise RuntimeError(f"K1's fp32 route gave other bits on a second call at {name}")
            route = (f"ring ({plan.tiles} tiles x {plan.splits} row range(s) of {plan.span}"
                     + (", reduced)" if plan.splits > 1 else ")") + ", bitwise twice")
        if not torch.equal(got, got.T):
            raise RuntimeError(f"K1 result is not exactly symmetric at {name}")
        units = syrk_units(got, want)
        err = float((got - want).abs().max())
        if not units <= 1.0:
            raise RuntimeError(
                f"K1 disagrees with its plain version at {name}: {units:.3f} units of the "
                f"limit, max |err| {err:.3e}, max |C| {float(want.abs().max()):.3e}"
            )
        worst = max(worst, err)
        line = (f"K1 {name}: {route}; max |err| {err:.3e} of max |C| "
                f"{float(want.abs().max()):.3e}, {units:.4f} units of the limit, symmetric")
        if (rows, n) in timed and dtype == torch.bfloat16:
            r0, r1 = SYRK_FAULT_ROWS
            fault = syrk_units(syrk_reference(torch.cat([a[:r0], a[r1:]])), want)
            if not fault > 1.0:
                raise RuntimeError(f"the planted fault (rows {r0}-{r1 - 1} left out) reads "
                                   f"{fault:.3f} units at {name}: the limit cannot see it")
            line += f"; planted fault (rows {r0}-{r1 - 1} left out) {fault:.2f} units"
        # The lower triangle with its diagonal: rows x n(n+1)/2 dot
        # products; A read once, C written once.
        flops = float(rows) * n * (n + 1)
        if (rows, n) in timed and dtype == torch.float32:
            # The plain version is torch.mm(a.T, a) in fp32 (TF32 off), the
            # library call itself. Device time in turns: kernel, library,
            # library, kernel; the kernel's time holds its reduction's.
            k1 = device_ms(lambda: syrk(a))
            l1 = device_ms(lambda: torch.mm(a.T, a))
            l2 = device_ms(lambda: torch.mm(a.T, a))
            k2 = device_ms(lambda: syrk(a))
            kernel_ms, lib = (k1 + k2) / 2, (l1 + l2) / 2
            bound, bound_by = roofline(rows * n * 4 + n * n * 4, flops, FP32_FLOPS)
            peak_pct = 100 * flops / kernel_ms / 1e9 / (FP32_FLOPS / 1e12)
            timing[(rows, n, dtype)] = {"ms": kernel_ms, "plain_ms": lib, "bound_ms": bound,
                                        "bound_by": bound_by, "library_ms": lib,
                                        "splits": plan.splits, "fp32_peak_pct": peak_pct}
            line += (
                f"; device time kernel {kernel_ms:.4f} ms ({k1:.4f}, {k2:.4f}), torch.mm(a.T, a) "
                f"fp32 {lib:.4f} ms ({l1:.4f}, {l2:.4f}), kernel/library {kernel_ms / lib:.3f}; "
                f"bound {bound:.4f} ms ({bound_by}); kernel {flops / kernel_ms / 1e9:.1f} TFLOP/s "
                f"on the triangle, {peak_pct:.1f}% of the fp32 peak; plan s {plan.splits} [{card}]"
            )
        elif (rows, n) in timed and kind == "normal":
            # Alternate plain, kernel, kernel, plain against drift.
            p1 = median_ms(lambda: syrk_reference(a))
            k1 = median_ms(lambda: syrk(a))
            k2 = median_ms(lambda: syrk(a))
            p2 = median_ms(lambda: syrk_reference(a))
            mm = median_ms(lambda: torch.matmul(a.T, a))
            # One library call with the same semantics (fp32 sums, fp32 out).
            lib = median_ms(lambda: torch.mm(a.T, a, out_dtype=torch.float32))
            kernel_ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            bound, bound_by = roofline(rows * n * a.element_size() + n * n * 4, flops, BF16_FLOPS)
            timing[(rows, n, dtype)] = {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound,
                                        "bound_by": bound_by, "library_ms": lib}
            line += (
                f"; kernel {kernel_ms:.4f} ms ({k1:.4f}, {k2:.4f}), plain fp32 "
                f"{plain_ms:.3f} ms ({p1:.3f}, {p2:.3f}), torch.matmul(flat.T, flat) in "
                f"{str(dtype).split('.')[-1]} {mm:.4f} ms, same-semantics library call "
                f"{lib:.4f} ms; bound {bound:.4f} ms ({bound_by}); kernel "
                f"{flops / kernel_ms / 1e9:.1f} TFLOP/s on the triangle [{card}]"
            )
        log(line)

    return {"max_abs_err": worst, **timing[(8192, 3072, torch.bfloat16)],
            "timings_ms": {f"{rows}x{n}": timing[(rows, n, torch.bfloat16)] for rows, n in timed},
            "timings_ms_fp16": {f"{rows}x{n}": timing[(rows, n, torch.float16)]
                                for rows, n in SYRK_MAIN_SHAPES},
            "timings_ms_fp32": {f"{rows}x{n}": timing[(rows, n, torch.float32)]
                                for rows, n in SYRK_MAIN_SHAPES},
            "tiles": triangle_tiles(3072, TILE), "smem_bytes": smem}


def wikitext_style_task(num_layers: int):
    """The bench's task: summed token cross-entropy on fp32 logits under the
    attention mask, tracking the four projections of every block."""
    from kronfluence_tpu_torch.task import Task

    class WikitextStyleTask(Task):
        def compute_train_loss(self, batch, model, sample=False, generator=None):
            logits = model(batch["input_ids"], batch["attention_mask"])[:, :-1].float()
            mask = batch["attention_mask"][:, 1:].to(torch.float32)
            vocab = logits.shape[-1]
            if sample:
                probs = torch.softmax(logits.detach().reshape(-1, vocab), dim=-1)
                labels = torch.multinomial(probs, 1, generator=generator).reshape(mask.shape)
            else:
                labels = batch["input_ids"][:, 1:].long()
            losses = F.cross_entropy(
                logits.reshape(-1, vocab), labels.reshape(-1), reduction="none"
            ).reshape(mask.shape)
            return torch.sum(losses * mask)

        def compute_measurement(self, batch, model):
            return self.compute_train_loss(batch, model)

        def get_influence_tracked_modules(self):
            return [
                f"h_{i}/{name}"
                for i in range(num_layers)
                for name in ("attn/c_attn", "attn/c_proj", "mlp/c_fc", "mlp/c_proj")
            ]

        def get_attention_mask(self, batch):
            return batch["attention_mask"]

    return WikitextStyleTask()


def make_tokens(n: int, seq: int, vocab: int, seed: int, device, padded: bool = False) -> dict:
    """Synthetic tokens from a numpy seed, uploaded once (the bench's make_data);
    `padded` masks the tail of every other example."""
    rng = np.random.default_rng(seed)
    host = {
        "input_ids": rng.integers(1, vocab, size=(n, seq)).astype(np.int32),
        "attention_mask": np.ones((n, seq), dtype=np.int32),
    }
    if padded:
        for i in range(1, n, 2):
            host["attention_mask"][i, seq - seq // 4 - i % (seq // 4):] = 0
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


def run_slice(model, task, data, factor_args, score_args, device, batches, mesh=None):
    """covariance -> eigendecomposition -> lambda -> pairwise; returns the
    artifacts and each stage's seconds (host clock, synchronized). On a data
    `mesh` the batches are global and each rank loads its half."""
    from kronfluence_tpu_torch.factor.covariance import fit_covariance_matrices_with_loader
    from kronfluence_tpu_torch.factor.eigen import (
        fit_lambda_matrices_with_loader,
        perform_eigendecomposition,
    )
    from kronfluence_tpu_torch.score.pairwise import compute_pairwise_scores_with_loaders
    from kronfluence_tpu_torch.utils.dataset import BatchLoader

    cov_b, lam_b, query_b, train_b = batches

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    seconds = {}
    t0 = time.perf_counter()
    cov = fit_covariance_matrices_with_loader(
        model, task, BatchLoader(data["cov"], cov_b, device=device, mesh=mesh), factor_args,
        mesh=mesh,
    )
    sync()
    seconds["covariance"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eigen = perform_eigendecomposition(cov, factor_args)
    sync()
    seconds["eigendecomposition"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lam = fit_lambda_matrices_with_loader(
        model, task, BatchLoader(data["lambda"], lam_b, device=device, mesh=mesh), factor_args,
        eigen_factors=eigen, mesh=mesh,
    )
    sync()
    seconds["lambda"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scores = compute_pairwise_scores_with_loaders(
        model, task,
        BatchLoader(data["query"], query_b, device=device, mesh=mesh),
        BatchLoader(data["train"], train_b, device=device, mesh=mesh),
        {**cov, **eigen, **lam}, factor_args, score_args, mesh=mesh,
    )
    sync()
    seconds["pairwise"] = time.perf_counter() - t0
    return cov, eigen, lam, scores, seconds


def check_artifacts(cov, eigen, lam, scores, tokens_per_module, examples, score_shape) -> None:
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk_supported
    from kronfluence_tpu_torch.utils.constants import (
        ACTIVATION_COVARIANCE_MATRIX_NAME,
        ALL_MODULE_NAME,
        GRADIENT_COVARIANCE_MATRIX_NAME,
        NUM_ACTIVATION_COVARIANCE_PROCESSED,
        NUM_GRADIENT_COVARIANCE_PROCESSED,
        NUM_LAMBDA_PROCESSED,
    )

    for group in (cov, eigen, lam):
        for factor_name, per_module in group.items():
            for name, t in per_module.items():
                if not bool(torch.isfinite(t.float()).all()):
                    raise RuntimeError(f"non-finite {factor_name} for {name}")
    for factor_name in (ACTIVATION_COVARIANCE_MATRIX_NAME, GRADIENT_COVARIANCE_MATRIX_NAME):
        for name, c in cov[factor_name].items():
            if syrk_supported(c.shape[0], torch.float32) or syrk_supported(c.shape[0] - 1, torch.float32):
                # Sums of the kernel's exactly symmetric grams (plus the
                # symmetric bias border): exactly symmetric.
                if not torch.equal(c, c.T):
                    raise RuntimeError(f"{factor_name} of {name} is not exactly symmetric")
            else:
                gap = float((c.float() - c.float().T).abs().max())
                if gap > 1e-2 * float(c.float().abs().max()):
                    raise RuntimeError(f"{factor_name} of {name} is not symmetric (gap {gap})")
    for count_name in (NUM_ACTIVATION_COVARIANCE_PROCESSED, NUM_GRADIENT_COVARIANCE_PROCESSED):
        for name, count in cov[count_name].items():
            if int(count.item()) != tokens_per_module:
                raise RuntimeError(f"{count_name} of {name}: {int(count.item())} != {tokens_per_module}")
    for name, count in lam[NUM_LAMBDA_PROCESSED].items():
        if int(count.item()) != examples:
            raise RuntimeError(f"lambda count of {name}: {int(count.item())} != {examples}")
    got = scores[ALL_MODULE_NAME]
    if tuple(got.shape) != score_shape or not bool(torch.isfinite(got.float()).all()):
        raise RuntimeError(f"scores: shape {tuple(got.shape)} (want {score_shape}) or non-finite")


def setup_main_path(device: torch.device = torch.device("cuda", 0)) -> dict:
    """GPT-2 small at full width in bf16 with seeded random weights, the bench
    recipe, and the four stages' data, on `device`."""
    from kronfluence_tpu_torch.models.transformer import gpt2_small, init_transformer
    from kronfluence_tpu_torch.prepare import prepare_model
    from kronfluence_tpu_torch.utils.common.factor_arguments import (
        smart_low_precision_factor_arguments,
    )
    from kronfluence_tpu_torch.utils.common.score_arguments import (
        smart_low_precision_score_arguments,
    )

    config = gpt2_small(max_seq_len=SEQ, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    task = wikitext_style_task(config.num_layers)
    model = prepare_model(init_transformer(config, seed=0, device=device), task)
    torch.cuda.synchronize(device)
    log(f"main path: GPT-2 small bf16 ({sum(p.numel() for p in model.module.parameters()):,} "
        f"params) initialised in {time.perf_counter() - t0:.2f} s")

    factor_args = smart_low_precision_factor_arguments(strategy="ekfac")
    factor_args.use_empirical_fisher = True
    factor_args.eigendecomposition_dtype = "float32"
    score_args = smart_low_precision_score_arguments()
    score_args.query_gradient_storage_dtype = None
    score_args.query_gradient_accumulation_steps = QUERY_ACC

    data = {
        "cov": make_tokens(COV_N, SEQ, config.vocab_size, 1, device),
        "lambda": make_tokens(LAMBDA_N, SEQ, config.vocab_size, 3, device),
        "query": make_tokens(QUERY_N, SEQ, config.vocab_size, 5, device),
        "train": make_tokens(TRAIN_N, SEQ, config.vocab_size, 6, device),
    }
    return dict(model=model, task=task, data=data, factor_args=factor_args,
                score_args=score_args, device=device)


def flash_kernels():
    from kronfluence_tpu_torch.ops.kernels.flash import (
        flash_backward,
        flash_backward_dkv,
        flash_backward_dkv_d128,
        flash_backward_dkv_d256,
        flash_backward_dkv_f32,
        flash_backward_dkv_f32_d128,
        flash_backward_dkv_f32_d256,
        flash_backward_dq,
        flash_backward_dq_d128,
        flash_backward_dq_d256,
        flash_backward_dq_f32,
        flash_backward_dq_f32_d128,
        flash_backward_dq_f32_d256,
        flash_forward,
        flash_forward_d128,
        flash_forward_d256,
        flash_forward_f32,
        flash_forward_f32_d64,
        flash_forward_pipelined,
    )

    return {"F1": flash_forward, "F2": flash_backward_dkv, "F3": flash_backward_dq,
            "FF": flash_forward_pipelined, "FB": flash_backward, "FFH": flash_forward_d128,
            "FFW": flash_forward_d256, "FFS": flash_forward_f32, "FFS64": flash_forward_f32_d64,
            "F2H": flash_backward_dkv_d128, "F3H": flash_backward_dq_d128,
            "F2W": flash_backward_dkv_d256, "F3W": flash_backward_dq_d256,
            "F2S": flash_backward_dkv_f32, "F3S": flash_backward_dq_f32,
            "F2SH": flash_backward_dkv_f32_d128, "F3SH": flash_backward_dq_f32_d128,
            "F2SW": flash_backward_dkv_f32_d256, "F3SW": flash_backward_dq_f32_d256}


def phase_main_path(card: str) -> dict:
    from kronfluence_tpu_torch.ops.attention import naive_attention
    from kronfluence_tpu_torch.ops.kernels.jacobi import jacobi_pivot_rotations
    from kronfluence_tpu_torch.ops.kernels.probe import probe
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk

    ctx = setup_main_path()
    model, task, data = ctx["model"], ctx["task"], ctx["data"]
    factor_args, score_args, device = ctx["factor_args"], ctx["score_args"], ctx["device"]
    torch.cuda.reset_peak_memory_stats()
    syrk.launches = syrk.wgmma_launches = probe.launches = jacobi_pivot_rotations.launches = 0
    for fn in flash_kernels().values():
        fn.launches = 0
    naive_attention.calls = 0
    cov, eigen, lam, scores, seconds = run_slice(
        model, task, data, factor_args, score_args, device,
        (COV_BATCH, LAMBDA_BATCH, QUERY_BATCH, TRAIN_BATCH),
    )
    launches = {"syrk": syrk.launches, "probe": probe.launches}
    wgmma_launches = syrk.wgmma_launches
    naive_calls = naive_attention.calls
    if jacobi_pivot_rotations.launches:
        raise RuntimeError("K2 launched on the cuSOLVER path (eigendecomposition_solver='auto')")
    if any(fn.launches for fn in flash_kernels().values()) or naive_calls == 0:
        raise RuntimeError("the main path (attention='naive') launched a flash kernel or "
                           "never ran the naive form")
    cov_batches = -(-COV_N // COV_BATCH)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"main path stage seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
        + f"; peak device memory {peak:.2f} GiB; naive attention calls {naive_calls}, "
        f"flash launches 0 [{card}]")
    log(f"main path kernel launches: syrk {launches['syrk']}, {wgmma_launches} of them the "
        f"wgmma kernel (want 36 x {cov_batches} covariance batches = {36 * cov_batches}, all "
        f"wgmma), probe {launches['probe']}")
    if not launches["syrk"] == wgmma_launches == 36 * cov_batches:
        raise RuntimeError(f"K1 launched {launches['syrk']} times, {wgmma_launches} on the "
                           f"wgmma kernel; want {36 * cov_batches}, all wgmma")
    if launches["probe"] < 1:
        raise RuntimeError("K3 was not launched on the main path")
    check_artifacts(cov, eigen, lam, scores, COV_N * SEQ, LAMBDA_N, (QUERY_N, TRAIN_N))
    from kronfluence_tpu_torch.utils.constants import ALL_MODULE_NAME

    s = scores[ALL_MODULE_NAME].float()
    log(f"main path: {len(cov['activation_covariance'])} modules; scores {tuple(s.shape)} "
        f"{scores[ALL_MODULE_NAME].dtype}, finite, |s| max {float(s.abs().max()):.4e}, "
        f"mean {float(s.mean()):.4e}")
    # Phase 12 holds its artifacts against these; kept on the host so that the
    # phases between hold no more device memory than before.
    eigen_host = {k: {n: t.cpu() for n, t in v.items()} for k, v in eigen.items()}
    lam_host = {k: {n: t.cpu() for n, t in v.items()} for k, v in lam.items()}
    return dict(ctx, launches=launches, cov=cov, eigen_host=eigen_host, lam_host=lam_host,
                scores=scores,
                seconds=seconds, peak=peak)


# Phase 20: the data mesh. NCCL will not put two ranks on one card, so the two
# ranks of (b) share cuda:0 through gloo (with CUDA tensors); each takes half
# of every one of phase 5's global batches.
DIST_RANKS = 2
# Each rank's own limit, its start and the kernel library's load included; a
# hung collective fails the phase instead of the run.
DIST_RANK_TIMEOUT = 240
# The ranks against one process at their batch (the same terms, summed per
# rank and then over the ranks): factors stored in fp32 within 1e-5 of max;
# stored in bf16, those fp32 sums may round to neighbouring bf16 values, one
# step apart at most at max|C|. A bf16 step moves the eigenvectors of close
# eigenvalues, so lambda is held in the control's eigenbasis, and the scores
# are taken from the control's factors.
DIST_COV_RTOL_FP32 = 1e-5
DIST_LAMBDA_RTOL = 2e-3
DIST_PEARSON_MIN = 0.9999
# Collectives tried on CUDA tensors under gloo, to record which it runs. Each
# either runs or is refused on both ranks before anything is sent.
GLOO_CUDA_OPS = ("all_reduce", "broadcast", "barrier", "all_gather", "all_gather_into_tensor",
                 "reduce_scatter_tensor", "all_to_all_single", "gather", "reduce")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def bf16_step(x: float) -> float:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def gloo_cuda_ops(mesh) -> dict:
    """Which of GLOO_CUDA_OPS gloo runs on CUDA tensors ("ran") or refuses
    (its error's first line)."""
    import torch.distributed as dist

    x = torch.ones(DIST_RANKS * 4, device=mesh.device)
    many = [torch.empty_like(x) for _ in range(mesh.data)]
    calls = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "broadcast": lambda: dist.broadcast(x.clone(), src=0),
        "barrier": lambda: dist.barrier(),
        "all_gather": lambda: dist.all_gather(many, x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(mesh.data * x.numel(), device=mesh.device), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(x.numel() // mesh.data, device=mesh.device), x),
        "all_to_all_single": lambda: dist.all_to_all_single(torch.empty_like(x), x),
        "gather": lambda: dist.gather(x, many if mesh.rank == 0 else None, dst=0),
        "reduce": lambda: dist.reduce(x.clone(), dst=0),
    }
    ran = {}
    for name in GLOO_CUDA_OPS:
        try:
            calls[name]()
            torch.cuda.synchronize(mesh.device)
            ran[name] = "ran"
        except (RuntimeError, ValueError) as exc:  # recorded: which ops gloo refuses
            ran[name] = str(exc).splitlines()[0][:160]
    return ran


def distributed_rank(args: list) -> None:
    """One rank of phase 20 (`--distributed-rank RANK WORLD BACKEND RENDEZVOUS
    OUTDIR`): gloo ranks share cuda:0, NCCL rank r takes cuda:r."""
    rank, world, backend = int(args[0]), int(args[1]), args[2]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", rank if backend == "nccl" else 0)
    rank_slice(rank, world, backend, args[3], Path(args[4]), device)


def rank_slice(rank: int, world: int, backend: str, rendezvous: str, outdir: Path,
               device: torch.device) -> None:
    """Phase 5's slice on the data mesh as one rank, against the one-process
    control in OUTDIR/control.pt, each stage apart: the covariance; its
    eigendecomposition; lambda in the control's eigenbasis; the scores from
    the control's factors; then lambda and scores from this mesh's own
    eigenpairs, for the record. Writes to OUTDIR each factor's gap to the
    control, digests of the factors (the ranks must agree bit for bit), the
    scores, the kernel counts, stage seconds, peak memory and collective
    seconds."""
    import hashlib

    from kronfluence_tpu_torch.factor import covariance as covariance_stage
    from kronfluence_tpu_torch.factor import eigen as eigen_stage
    from kronfluence_tpu_torch.ops.attention import naive_attention
    from kronfluence_tpu_torch.ops.kernels.build import load_library
    from kronfluence_tpu_torch.ops.kernels.probe import probe
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk
    from kronfluence_tpu_torch.parallel import distributed
    from kronfluence_tpu_torch.parallel.mesh import make_mesh
    from kronfluence_tpu_torch.score import pairwise as pairwise_stage
    from kronfluence_tpu_torch.utils.dataset import BatchLoader

    start = time.perf_counter()
    distributed.initialize(backend, init_method=f"file://{rendezvous}", world_size=world,
                           rank=rank, local_rank=device.index,
                           timeout=datetime.timedelta(seconds=DIST_RANK_TIMEOUT))
    mesh = make_mesh(device=device)
    on_card = device.type == "cuda"
    if on_card:
        with torch.cuda.device(device):
            load_library()  # built by phase 2; its own K3 check launches here, before the counts
    ctx = setup_main_path(device)
    model, task, data = ctx["model"], ctx["task"], ctx["data"]
    factor_args, score_args = ctx["factor_args"], ctx["score_args"]
    control = torch.load(outdir / "control.pt", weights_only=False)
    on_device = {k: {n: t.to(device) for n, t in v.items()}
                 for k, v in {**control["cov"], **control["eigen"], **control["lam"]}.items()}
    control_eigen = {k: on_device[k] for k in control["eigen"]}
    collective = {"all_reduce": 0.0, "score_assembly": 0.0}

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    def timed(fn, key):
        def wrapper(*a, **kw):
            sync()
            t = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            collective[key] += time.perf_counter() - t
            return out
        return wrapper

    covariance_stage.all_reduce_tree = timed(covariance_stage.all_reduce_tree, "all_reduce")
    eigen_stage.all_reduce_tree = timed(eigen_stage.all_reduce_tree, "all_reduce")
    pairwise_stage.gather_rows = timed(pairwise_stage.gather_rows, "score_assembly")

    def loader(key, batch):
        return BatchLoader(data[key], batch, device=device, mesh=mesh)

    def lambda_stage(eigen):
        return eigen_stage.fit_lambda_matrices_with_loader(
            model, task, loader("lambda", LAMBDA_BATCH), factor_args, eigen_factors=eigen,
            mesh=mesh)

    def pairwise(factors):
        return pairwise_stage.compute_pairwise_scores_with_loaders(
            model, task, loader("query", QUERY_BATCH), loader("train", TRAIN_BATCH), factors,
            factor_args, score_args, mesh=mesh)

    seconds = {}

    def stage(name, fn, *args):
        sync()
        t = time.perf_counter()
        out = fn(*args)
        sync()
        seconds[name] = time.perf_counter() - t
        return out

    ready = time.perf_counter() - start
    syrk.launches = syrk.wgmma_launches = probe.launches = 0
    naive_attention.calls = 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    cov = stage("covariance", covariance_stage.fit_covariance_matrices_with_loader, model, task,
                loader("cov", COV_BATCH), factor_args, None, mesh)
    eigen = stage("eigendecomposition", eigen_stage.perform_eigendecomposition, cov, factor_args)
    lam = stage("lambda", lambda_stage, control_eigen)
    scores = stage("pairwise", pairwise, on_device)
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if on_card else 0.0
    launches = {"syrk": syrk.launches, "wgmma": syrk.wgmma_launches, "probe": probe.launches,
                "naive_attention": naive_attention.calls}
    own_lam = lambda_stage(eigen)
    own_scores = pairwise({**cov, **eigen, **own_lam})
    ops = gloo_cuda_ops(mesh) if backend == "gloo" and on_card else None

    def gaps(got, want):
        return {k: {n: (float((t.float() - want[k][n].float()).abs().max()),
                        float(want[k][n].float().abs().max()), str(want[k][n].dtype),
                        torch.equal(t, want[k][n]))
                    for n, t in v.items()} for k, v in got.items()}

    def digests(group):
        return {k: {n: hashlib.sha256(t.detach().contiguous().view(-1).view(torch.uint8)
                                      .cpu().numpy()).hexdigest() for n, t in v.items()}
                for k, v in group.items()}

    torch.save(dict(
        gaps={**gaps(cov, on_device), **gaps(lam, on_device)},
        own_lambda_gaps=gaps(own_lam, on_device),
        digests=digests({**cov, **eigen, **lam, **own_lam}),
        scores=scores, own_scores=own_scores, seconds=seconds, peak=peak, launches=launches,
        collective=collective, ready=ready, backend=mesh.backend, device=str(device), ops=ops,
    ), outdir / f"rank{rank}.pt")
    distributed.sync_global_devices("saved")
    distributed.shutdown()
    log(f"rank {rank} of {world} ({backend}, {device}): done in {time.perf_counter() - start:.1f} s")


def run_ranks(backend: str, control: dict, timeout: int = DIST_RANK_TIMEOUT) -> list:
    """Starts DIST_RANKS ranks of this script on `backend`, each held to
    `control`, and returns what each wrote; fails if any fails or outlasts
    `timeout`."""
    workdir = Path(tempfile.mkdtemp(prefix="kf_chip_smoke_mesh_"))
    try:
        torch.save(control, workdir / "control.pt")
        procs = [
            subprocess.Popen(
                [sys.executable, str(REPO / "chip_smoke.py"), "--distributed-rank", str(rank),
                 str(DIST_RANKS), backend, str(workdir / "rendezvous"), str(workdir)],
                cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for rank in range(DIST_RANKS)
        ]
        try:
            outputs = [p.communicate(timeout=timeout)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for rank, (p, out) in enumerate(zip(procs, outputs)):
            if p.returncode != 0:
                raise RuntimeError(f"{backend} rank {rank} failed ({p.returncode}):\n{out[-4000:]}")
        return [torch.load(workdir / f"rank{rank}.pt", weights_only=False)
                for rank in range(DIST_RANKS)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def check_mesh_launches(label: str, k1: int, wgmma: int, k3: int, cov_batches: int) -> None:
    """K1 36 times a covariance batch of the rank's rows, all wgmma; K3 once
    a fit."""
    want = SYRK_LAUNCHES_PER_COV_BATCH * cov_batches
    if not k1 == wgmma == want:
        raise RuntimeError(f"{label}: K1 launched {k1} times, {wgmma} on the wgmma kernel; "
                           f"want {want}, all wgmma")
    if k3 != 1:
        raise RuntimeError(f"{label}: K3 launched {k3} times in one fit")


def worst_gaps(gaps: dict) -> dict:
    """Per factor, the largest max|diff| / max over modules."""
    return {k: max(err / top if top else err for err, top, _, _ in v.values())
            for k, v in gaps.items() if not k.startswith("num_")}


def check_ranks(card: str, label: str, ranks: list, control: dict, cov_batches: int) -> dict:
    """Each rank against the one-process control (covariance within one bf16
    step of max, or 1e-5 of max in fp32; counts equal; lambda in the
    control's eigenbasis within 2e-3 of max; the scores from the control's
    factors at Pearson r >= 0.9999), the ranks against each other bit for
    bit, and K1's and K3's launches."""
    from kronfluence_tpu_torch.utils.constants import ALL_MODULE_NAME, LAMBDA_MATRIX_NAME

    control_scores = control["scores"][ALL_MODULE_NAME].float().flatten()
    for rank, got in enumerate(ranks):
        for factor_name, modules in got["gaps"].items():
            for name, (err, top, dtype, equal) in modules.items():
                if factor_name.startswith("num_"):
                    if not equal:
                        raise RuntimeError(f"{label} rank {rank}: {factor_name} of {name} differs")
                    continue
                if factor_name == LAMBDA_MATRIX_NAME:
                    limit = DIST_LAMBDA_RTOL * top
                elif dtype == str(torch.bfloat16):
                    limit = bf16_step(top)
                else:
                    limit = DIST_COV_RTOL_FP32 * top
                if err > limit:
                    raise RuntimeError(f"{label} rank {rank}: {factor_name} of {name} off by "
                                       f"{err:.3e} (limit {limit:.3e}, max {top:.3e})")
        r = pearson(got["scores"][ALL_MODULE_NAME].float().flatten(), control_scores)
        if r < DIST_PEARSON_MIN:
            raise RuntimeError(f"{label} rank {rank}: scores' Pearson r {r:.7f} < {DIST_PEARSON_MIN}")
        k1, k3 = got["launches"]["syrk"], got["launches"]["probe"]
        check_mesh_launches(f"{label} rank {rank}", k1, got["launches"]["wgmma"], k3,
                            cov_batches)
        log(f"{label} rank {rank} on {got['device']} ({got['backend']}): stage seconds "
            + ", ".join(f"{k} {v:.3f}" for k, v in got["seconds"].items())
            + f"; all-reduce {got['collective']['all_reduce']:.3f} s, score assembly "
            f"{got['collective']['score_assembly']:.3f} s (own-eigenbasis lambda and scores "
            f"included); peak device memory {got['peak']:.2f} GiB; start to first batch "
            f"{got['ready']:.1f} s; K1 {k1} (all wgmma), K3 {k3}, naive attention calls "
            f"{got['launches']['naive_attention']} [{card}]")
    first, second = ranks
    unequal = [f"{k} {n}" for k, v in first["digests"].items() for n, d in v.items()
               if second["digests"][k][n] != d]
    unequal += [f"scores {k}" for group in ("scores", "own_scores")
                for k, t in first[group].items() if not torch.equal(second[group][k], t)]
    if unequal:
        raise RuntimeError(f"{label}: the ranks' results differ: {unequal[:4]}")
    own_r = pearson(first["own_scores"][ALL_MODULE_NAME].float().flatten(), control_scores)
    log(f"{label}: against one process, per factor max|diff| / max: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst_gaps(first["gaps"]).items())
        + f" (lambda in the control's eigenbasis); scores from the control's factors: Pearson r "
        f"{pearson(first['scores'][ALL_MODULE_NAME].float().flatten(), control_scores):.7f}; "
        f"factors, eigenpairs and scores equal bit for bit on both ranks. From the mesh's own "
        f"eigenpairs (not held): lambda {worst_gaps(first['own_lambda_gaps'])[LAMBDA_MATRIX_NAME]:.3e} "
        f"of max, scores' Pearson r {own_r:.7f}")
    return {"K1": [g["launches"]["syrk"] for g in ranks],
            "K3": [g["launches"]["probe"] for g in ranks]}


def phase_distributed(card: str, ctx: dict) -> dict:
    from kronfluence_tpu_torch.ops.kernels.probe import probe
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk
    from kronfluence_tpu_torch.parallel import distributed
    from kronfluence_tpu_torch.parallel.mesh import make_mesh
    from kronfluence_tpu_torch.utils.constants import ALL_MODULE_NAME

    model, task, data, device = ctx["model"], ctx["task"], ctx["data"], ctx["device"]
    factor_args, score_args = ctx["factor_args"], ctx["score_args"]
    cov_batches = -(-COV_N // COV_BATCH)
    batches = (COV_BATCH, LAMBDA_BATCH, QUERY_BATCH, TRAIN_BATCH)
    # (a) One NCCL rank in this process.
    syrk.launches = syrk.wgmma_launches = probe.launches = 0
    distributed.initialize("nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1,
                           rank=0, local_rank=device.index)
    try:
        mesh = make_mesh(device=device)
        backend = mesh.backend
        cov, eigen, lam, scores, seconds = run_slice(
            model, task, data, factor_args, score_args, device, batches, mesh=mesh)
    finally:
        distributed.shutdown()
    nccl_one = {"K1": syrk.launches, "K3": probe.launches}
    unequal = [f"{k} {n}" for got, want in
               ((cov, ctx["cov"]), (eigen, ctx["eigen_host"]), (lam, ctx["lam_host"]))
               for k, v in want.items() for n, t in v.items()
               if not torch.equal(got[k][n].cpu(), t.cpu())]
    unequal += [k for k, t in ctx["scores"].items() if not torch.equal(scores[k], t)]
    log(f"mesh (a): {backend} group of one on {mesh.device}: stage seconds "
        + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
        + f"; K1 {syrk.launches} ({syrk.wgmma_launches} wgmma), K3 {probe.launches}; "
        f"unequal to phase 5 in {len(unequal)} tensors (bit for bit required) [{card}]")
    if unequal:
        raise RuntimeError(f"an NCCL group of one differs from phase 5: {unequal[:4]}")
    check_mesh_launches("mesh (a)", syrk.launches, syrk.wgmma_launches, probe.launches,
                        cov_batches)

    del cov, eigen, lam

    def host(group):
        return {k: {n: t.cpu() for n, t in v.items()} for k, v in group.items()}

    # The one-process control runs at the ranks' batches, half of phase 5's:
    # its GEMMs take the ranks' shapes, so every example's gradients are the
    # ranks' bits and the ranks differ from it only in the order of the sums.
    # Against phase 5's batches the bf16 recipe itself moves the scores.
    half = tuple(b // DIST_RANKS for b in batches)
    half_cov, half_eigen, half_lam, half_scores, _ = run_slice(
        model, task, data, factor_args, score_args, device, half)
    control = {"cov": host(half_cov), "eigen": host(half_eigen), "lam": host(half_lam),
               "scores": half_scores}
    del half_cov, half_eigen, half_lam
    half_r = pearson(half_scores[ALL_MODULE_NAME].float().flatten(),
                     scores[ALL_MODULE_NAME].float().flatten())
    log(f"mesh: the control, one process at batches {half}, against phase 5's {batches}: "
        f"scores' Pearson r {half_r:.7f} (the bf16 recipe's own spread across batch shapes; "
        "not held)")

    # (b) Two gloo ranks on this card.
    t0 = time.perf_counter()
    ranks = run_ranks("gloo", control)
    log(f"mesh (b): two gloo ranks on cuda:0 ran in {time.perf_counter() - t0:.1f} s; gloo on "
        "CUDA tensors: " + ", ".join(f"{op}: {how}" for op, how in
                                     (ranks[0]["ops"] or {}).items()))
    result = {"nccl_one_rank": nccl_one,
              "gloo_two_ranks": check_ranks(card, "mesh (b), gloo", ranks, control, cov_batches)}

    # (c) Two NCCL ranks, one a card, where two cards are visible.
    if torch.cuda.device_count() >= DIST_RANKS:
        result["nccl_two_ranks"] = check_ranks(card, "mesh (c), nccl", run_ranks("nccl", control),
                                               control, cov_batches)
    else:
        log(f"mesh (c): NCCL across two cards not run: {torch.cuda.device_count()} card visible; "
            "ran: (a) NCCL, one rank; (b) gloo, two ranks on cuda:0")
    return result


def sym_blocks(y: int, m: int, seed: int) -> torch.Tensor:
    base = np.random.default_rng(seed).standard_normal((y, m, m)).astype(np.float32)
    return torch.from_numpy(base + base.transpose(0, 2, 1)).cuda()


def jacobi_generic(s: torch.Tensor, sweeps: int) -> torch.Tensor:
    """The generic kernel (csrc/jacobi.cu) through its own C entry point at any m;
    the wrapper takes it only where `jacobi_route` says "generic"."""
    from kronfluence_tpu_torch.ops.kernels.build import check_launch, load_library
    from kronfluence_tpu_torch.ops.kernels.jacobi import _EPS

    y, m, _ = s.shape
    v = torch.empty_like(s)
    err = load_library().kf_jacobi_pivot_rotations(
        s.data_ptr(), v.data_ptr(), y, m, sweeps, ctypes.c_float(_EPS),
        torch.cuda.current_stream().cuda_stream)
    check_launch(err, "jacobi (generic)")
    return v


def jacobi_skipped_rotation(s: torch.Tensor, sweeps: int, skip_round: int, skip_pair: int):
    """The plain version with pair `skip_pair`'s rotation left out of round
    `skip_round`: what a kernel that lost one pair's coefficients once returns."""
    from kronfluence_tpu_torch.ops.kernels.jacobi import _EPS, _round_tables, rotation_coefficients

    y, m, _ = s.shape
    rows, cols, seats, col_seats, sign = (torch.from_numpy(x).to(s.device) for x in _round_tables(m))
    a, v = s.clone(), torch.eye(m, device=s.device).expand(y, m, m)

    def gather(x, flat):
        return x.reshape(y, m * m).index_select(1, flat).view(y, m, m)

    for r in range(sweeps * (m - 1)):
        d = a.diagonal(dim1=1, dim2=2)
        c, sn = rotation_coefficients(d[:, 0::2], d[:, 1::2], a[:, 0::2, 1::2].diagonal(dim1=1, dim2=2), _EPS)
        if r == skip_round:
            c[:, skip_pair], sn[:, skip_pair] = 1.0, 0.0
        c, sn = c.repeat_interleave(2, dim=1), sn.repeat_interleave(2, dim=1) * sign
        a = c[:, :, None] * a - sn[:, :, None] * gather(a, rows)
        a = c[:, None, :] * a - sn[:, None, :] * gather(a, cols)
        a = gather(a, seats)
        v = gather(c[:, None, :] * v - sn[:, None, :] * gather(v, cols), col_seats)
    return v


def phase_jacobi_kernel(card: str) -> tuple:
    from kronfluence_tpu_torch.ops.kernels.jacobi import (
        jacobi_pivot_rotations,
        jacobi_pivot_rotations_reference,
        jacobi_route,
    )

    worst = {"registers": 0.0, "generic": 0.0}
    timing = {}
    kernel_names = {"registers": ["jacobi_registers_kernel"], "generic": ["jacobi_kernel"]}
    for y, m, sweeps in JACOBI_CASES:
        s = sym_blocks(y, m, seed=y * m + sweeps)
        route = jacobi_route(m)
        jacobi_pivot_rotations.registers_launches = jacobi_pivot_rotations.generic_launches = 0
        got = jacobi_pivot_rotations(s, sweeps)
        counts = (jacobi_pivot_rotations.registers_launches, jacobi_pivot_rotations.generic_launches)
        if counts != ((1, 0) if route == "registers" else (0, 1)):
            raise RuntimeError(f"K2 at m {m} took routes (registers, generic) {counts}, want {route}")
        want = jacobi_pivot_rotations_reference(s, sweeps)
        checked = {route: got}
        if y in JACOBI_MAIN_Y:
            checked["generic"] = jacobi_generic(s, sweeps)
        torch.cuda.synchronize()
        eye = torch.eye(m, device="cuda")

        def off_mass(v):
            d = v.transpose(1, 2) @ s @ v
            return float((d - d * eye).square().sum().sqrt() / (s - s * eye).square().sum().sqrt())

        plain_ratio = off_mass(want)
        line = f"K2 Y {y} m {m} sweeps {sweeps}, route {route}"
        for name, v in checked.items():
            err = float((v - want).abs().max())
            orth = float((v.transpose(1, 2) @ v - eye).abs().max())
            ratio = off_mass(v)
            part = (f"{name}: max |V - plain| {err:.3e}, bitwise equal {bool(torch.equal(v, want))}, "
                    f"max |V^T V - I| {orth:.2e}, off-diagonal mass ratio {ratio:.4f} (plain "
                    f"{plain_ratio:.4f})")
            line += "; " + part
            if not (err <= JACOBI_ATOL and orth <= JACOBI_ORTH and ratio < 0.75
                    and abs(ratio - plain_ratio) <= 1e-3 * plain_ratio):
                raise RuntimeError(f"K2 disagrees with its plain version: {line}")
            worst[name] = max(worst[name], err)
        if y == JACOBI_FAULT["y"] and m == 64:
            fault = jacobi_skipped_rotation(s, sweeps, JACOBI_FAULT["round"], JACOBI_FAULT["pair"])
            fault_err = float((got - fault).abs().max())
            line += (f"; planted fault (pair {JACOBI_FAULT['pair']}'s rotation left out of round "
                     f"{JACOBI_FAULT['round']}) reads {fault_err:.3e} (limit {JACOBI_ATOL:g})")
            if not fault_err > JACOBI_ATOL:
                raise RuntimeError(f"K2's check misses a planted fault: {line}")
        if y in JACOBI_MAIN_Y:
            fns = {"registers": (lambda: jacobi_pivot_rotations(s, sweeps), kernel_names["registers"]),
                   "generic": (lambda: jacobi_generic(s, sweeps), kernel_names["generic"])}
            turns = turns_ms(fns)
            p1 = median_ms(lambda: jacobi_pivot_rotations_reference(s, sweeps), iters=5, warmup=1)
            eigh_ms = median_ms(lambda: torch.linalg.eigh(s), iters=5, warmup=1)
            rounds = sweeps * (m - 1)
            # Per round and block: rows, columns and V, 3 m^2 operations each;
            # the blocks read once and V written once.
            bound, bound_by = roofline(2 * y * m * m * 4, 9.0 * m * m * rounds * y, FP32_FLOPS)
            timing[y] = {name: dict(ms=float(np.mean([e for e, _ in tt])),
                                    device_ms=float(np.mean([d for _, d in tt])), turns=tt)
                         for name, tt in turns.items()}
            timing[y].update(plain_ms=p1, bound_ms=bound, bound_by=bound_by, eigh_ms=eigh_ms)
            line += (f"; in turns (registers, generic, generic, registers), events / device ms: "
                     + ", ".join(f"{name} " + " / ".join(f"{e:.4f}, {d:.4f}" for e, d in tt)
                                 for name, tt in turns.items())
                     + f"; plain {p1:.3f} ms, bound {bound:.4f} ms ({bound_by}); yardstick "
                     f"torch.linalg.eigh on the same batch {eigh_ms:.3f} ms (exact pivots, the JAX "
                     f"package's pivot=\"eigh\", ops/eigh.py:467-475; not the same function) [{card}]")
        log(line)

    def result(route: str) -> dict:
        main = timing[JACOBI_MAIN_Y[-1]]
        return {"max_abs_err": worst[route], "ms": main[route]["ms"],
                "device_ms": main[route]["device_ms"], "plain_ms": main["plain_ms"],
                "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None,
                "exact_pivot_eigh_ms": main["eigh_ms"], "main_shape": f"Y{JACOBI_MAIN_Y[-1]} m64 sweeps2",
                "by_launch_shape": {f"Y{y} m64 sweeps2": {
                    "ms": t[route]["ms"], "device_ms": t[route]["device_ms"], "plain_ms": t["plain_ms"],
                    "bound_ms": t["bound_ms"]} for y, t in timing.items()}}

    return result("registers"), result("generic")


def padded_segments(b: int, t: int, padded: bool, device) -> torch.Tensor:
    """int32 (B, T) segment ids: example i keeps T - (37 i mod T/2) tokens."""
    seg = torch.ones(b, t, dtype=torch.int32, device=device)
    if padded:
        for i in range(b):
            seg[i, t - (37 * i) % (t // 2):] = 0
    return seg


def flash_work(seg: torch.Tensor, heads: int, d: int, itemsize: int):
    """(query-key pairs the mask keeps, F1 / FF / F2 / F3 / FB bytes and FLOPs)
    of one call: every operand read once and every output written once (FB's
    dQ in the operands' type, as the function returns it; the fp32 sum FB adds
    into is its design's cost, not the function's); QK^T and P V take 4 D FLOPs a kept pair
    (F1 and FF), F2 8 D (S^T, dP^T, dV, dK), F3 6 D (S, dP, dQ), FB 10 D (S, dP, dV,
    dK, dQ, each once)."""
    b, t = seg.shape
    causal = torch.ones(t, t, dtype=torch.bool, device=seg.device).tril()
    pairs = heads * int((causal & (seg[:, :, None] == seg[:, None, :])).sum())
    block = b * heads * t * d * itemsize  # one (B, H, T, D) operand
    stat = b * heads * t * 4  # one fp32 (B, H, T) statistic
    segb = b * t * 4
    forward = (3 * block + block + 2 * stat + segb, 4.0 * d * pairs)
    return pairs, {
        "F1": forward,
        "FF": forward,
        "F2": (4 * block + 3 * stat + segb + 2 * block, 8.0 * d * pairs),
        "F3": (4 * block + 3 * stat + segb + block, 6.0 * d * pairs),
        "FB": (4 * block + 3 * stat + segb + 3 * block, 10.0 * d * pairs),
    }


def bf16_units(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / (u (|want| + max |want| of its row) + u^2 max |want|), u = 2^-8."""
    got, want = got.float(), want.float()
    size = want.abs()
    unit = 2.0 ** -8 * (size + size.amax(-1, keepdim=True)) + 2.0 ** -16 * size.max()
    return float(((got - want).abs() / unit).max())


def relative_to_max(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


def dropped_block(q, k, v, seg, l, m, do, di, scale, block) -> dict:
    """The plain O, dQ, dK and dV with one block of P (query rows, key
    columns) left out: what a kernel that skipped one tile would return. The
    forward renormalises without the block; the backward keeps the sound
    run's l and m, as F2 and F3 take them."""
    from kronfluence_tpu_torch.ops.kernels.flash import MASK_VALUE

    f, t = torch.float32, q.shape[2]
    keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    keep = (keep & (seg[:, :, None] == seg[:, None, :]))[:, None].clone()
    keep[:, :, block[0], block[1]] = False
    s = torch.matmul(q.to(f), k.to(f).transpose(-1, -2)) * scale
    s = torch.where(keep, s, s + MASK_VALUE)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.matmul(p.to(v.dtype).to(f), v.to(f)) / p.sum(-1, keepdim=True)
    p = torch.exp(s - m[..., None]) / l[..., None]
    dv = torch.matmul(p.to(do.dtype).to(f).transpose(-1, -2), do.to(f))
    ds = p * (torch.matmul(do.to(f), v.to(f).transpose(-1, -2)) - di[..., None]) * scale
    ds = ds.to(q.dtype).to(f)
    dk = torch.matmul(ds.transpose(-1, -2), q.to(f))
    dq = torch.matmul(ds, k.to(f))
    return {name: x.to(q.dtype) for name, x in (("O", o), ("dQ", dq), ("dK", dk), ("dV", dv))}


def unmasked_tile(q, k, v, seg, scale, block, causal_too=False) -> torch.Tensor:
    """The plain O with the segment mask left off one block (query rows, key
    columns) below the diagonal, the causal mask kept: what a kernel that
    took that tile for one segment would return. With `causal_too` the causal
    mask is left off the block as well (a diagonal tile taken for one below
    it)."""
    from kronfluence_tpu_torch.ops.kernels.flash import MASK_VALUE

    f, t = torch.float32, q.shape[2]
    causal = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    keep = (causal & (seg[:, :, None] == seg[:, None, :]))[:, None].clone()
    keep[:, :, block[0], block[1]] = True if causal_too else causal[block[0], block[1]]
    s = torch.matmul(q.to(f), k.to(f).transpose(-1, -2)) * scale
    s = torch.where(keep, s, s + MASK_VALUE)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return (torch.matmul(p.to(v.dtype).to(f), v.to(f)) / p.sum(-1, keepdim=True)).to(q.dtype)


def unmasked_tile_backward(q, k, v, seg, l, m, do, di, scale, block, causal_too=False) -> dict:
    """The plain dQ, dK and dV with the segment mask left off one block
    (query rows, key columns) below the diagonal, the causal mask and the
    sound run's l and m kept: what a backward kernel that took that tile for
    one segment would return. With `causal_too` the causal mask is left off
    the block as well (a diagonal tile taken for one below it)."""
    from kronfluence_tpu_torch.ops.kernels.flash import MASK_VALUE

    f, t = torch.float32, q.shape[2]
    causal = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    keep = (causal & (seg[:, :, None] == seg[:, None, :]))[:, None].clone()
    keep[:, :, block[0], block[1]] = True if causal_too else causal[block[0], block[1]]
    s = torch.matmul(q.to(f), k.to(f).transpose(-1, -2)) * scale
    p = torch.exp(torch.where(keep, s, s + MASK_VALUE) - m[..., None]) / l[..., None]
    dv = torch.matmul(p.transpose(-1, -2), do.to(f))
    ds = p * (torch.matmul(do.to(f), v.to(f).transpose(-1, -2)) - di[..., None]) * scale
    return {"dQ": torch.matmul(ds, k.to(f)), "dK": torch.matmul(ds.transpose(-1, -2), q.to(f)),
            "dV": dv}


def forward_checked(name: str, fn, q, k, v, seg, scale, shape) -> tuple:
    """A forward kernel's (O, l, m) through its wrapper `fn` (FFH or FFS),
    after a second call has given the same bits and every value has been
    found finite."""
    out = fn(q, k, v, seg, scale)
    again = fn(q, k, v, seg, scale)
    bitwise = [torch.equal(x, y) for x, y in zip(out, again)]
    finite = all(bool(torch.isfinite(x).all()) for x in out)
    log(f"flash {name} at {shape}: two calls bitwise equal (O, l, m) {bitwise}; finite {finite}")
    if not (all(bitwise) and finite):
        raise RuntimeError(f"{name} is not bitwise reproducible or not finite at {shape}")
    return out


def forward_faults(name: str, args, plain_o, err: float, label: str, padded: bool = True,
                   diagonal: bool = False) -> None:
    """The limit of the forward kernel `name` (8 bf16 units in bf16, 1e-5 of
    max in fp32) must catch planted faults against its plain version, O from
    the backward's operands `args`: one 64 x 64 block of P left out; where
    padded, the segment mask left off one tile whose query rows cross a
    padding boundary; with `diagonal`, the causal mask left off one diagonal
    tile."""
    q, k, v, seg, scale = args[0], args[1], args[2], args[3], args[-1]
    if q.dtype == torch.bfloat16:
        measure, limit, how = bf16_units, FLASH_BF16_UNITS, "bf16 units"
    else:
        measure, limit, how = relative_to_max, FLASH_FP32_TOL, "max |fault - plain| / max |plain|"
    faults = {"dropped block": dropped_block(*args, FLASH_FAULT_BLOCK)["O"]}
    where = ["one 64 x 64 block of P left out, rows 384-447, keys 192-255"]
    if padded:
        faults["unmasked tile"] = unmasked_tile(q, k, v, seg, scale, FLASH_MASK_FAULT_BLOCK)
        where.append("the segment mask left off rows 448-511, keys 384-447")
    if diagonal:
        faults["unmasked diagonal tile"] = unmasked_tile(q, k, v, seg, scale,
                                                         FLASH_DIAG_FAULT_BLOCK, causal_too=True)
        where.append("the causal mask left off the diagonal tile of rows and keys 448-511")
    errs = {what: measure(fault, plain_o) for what, fault in faults.items()}
    log(f"flash {label}: planted faults against {name}'s plain version ({'; '.join(where)}), "
        f"{how} of O: " + ", ".join(f"{k_} {v_:.3g}" for k_, v_ in errs.items())
        + f"; {name} here {err:.3g}; limit {limit:g}")
    if not min(errs.values()) > limit:
        raise RuntimeError(f"the limit {limit:g} does not catch {name}'s planted faults: {errs}")


def phase_flash_kernels(card: str) -> dict:
    from kronfluence_tpu_torch.ops.attention import FlashAttention, naive_attention, output_dot
    from kronfluence_tpu_torch.ops.kernels.flash import (
        backward_route,
        flash_backward,
        flash_backward_dkv,
        flash_backward_dkv_d128,
        flash_backward_dkv_f32,
        flash_backward_dkv_f32_d256,
        flash_backward_dkv_reference,
        flash_backward_dq,
        flash_backward_dq_d128,
        flash_backward_dq_f32,
        flash_backward_dq_f32_d256,
        flash_backward_dq_reference,
        flash_backward_reference,
        flash_forward,
        flash_forward_d128,
        flash_forward_f32,
        flash_forward_f32_d64,
        flash_forward_pipelined,
        flash_forward_reference,
        forward_route,
    )

    abs_errs = {"F1": 0.0, "F2": 0.0, "F3": 0.0, "FF": 0.0, "FB": 0.0, "FFH": 0.0, "FFW": 0.0,
                "FFS": 0.0, "FFS64": 0.0,
                "F2H": 0.0, "F3H": 0.0, "F2W": 0.0, "F3W": 0.0, "F2S": 0.0, "F3S": 0.0,
                "F2SW": 0.0, "F3SW": 0.0}
    owner = {"O": "F1", "dK": "F2", "dV": "F2", "dQ": "F3", "FF O": "FF", "FFH O": "FFH",
             "FFS O": "FFS", "FFS64 O": "FFS64",
             "FB dQ": "FB", "FB dK": "FB", "FB dV": "FB",
             "F2H dK": "F2H", "F2H dV": "F2H", "F3H dQ": "F3H",
             "F2S dK": "F2S", "F2S dV": "F2S", "F3S dQ": "F3S",
             "F2SW dK": "F2SW", "F2SW dV": "F2SW", "F3SW dQ": "F3SW"}
    for b, h, t, d, dtype, padded in FLASH_CASES:
        gen = torch.Generator("cuda").manual_seed(b * t + d)
        q, k, v, do = (torch.randn(b, h, t, d, generator=gen, device="cuda").to(dtype)
                       for _ in range(4))
        seg = padded_segments(b, t, padded, "cuda")
        scale = d ** -0.5
        o, l, m = flash_forward(q, k, v, seg, scale)
        di = output_dot(o, do)
        dk, dv = flash_backward_dkv(q, k, v, seg, l, m, do, di, scale)
        dq = flash_backward_dq(q, k, v, seg, l, m, do, di, scale)
        ro, rl, rm = flash_forward_reference(q, k, v, seg, scale)
        rdk, rdv = flash_backward_dkv_reference(q, k, v, seg, l, m, do, di, scale)
        rdq = flash_backward_dq_reference(q, k, v, seg, l, m, do, di, scale)
        got = {"O": o, "dQ": dq, "dK": dk, "dV": dv}
        want = {"O": ro, "dQ": rdq, "dK": rdk, "dV": rdv}
        stats = [("l", l, rl), ("m", m, rm)]
        pipelined = forward_route(dtype, d) == "pipelined"
        if pipelined:
            # FF against the plain forward (the same one F1 is held to).
            fo, fl, fm = flash_forward_pipelined(q, k, v, seg, scale)
            got["FF O"], want["FF O"] = fo, ro
            stats += [("FF l", fl, rl), ("FF m", fm, rm)]
        pipelined_h = forward_route(dtype, d) == "pipelined_h"
        if pipelined_h:
            # FFH against the plain forward; a second call must give the same bits.
            fo, fl, fm = forward_checked("FFH", flash_forward_d128, q, k, v, seg, scale,
                                         (b, h, t, d))
            got["FFH O"], want["FFH O"] = fo, ro
            stats += [("FFH l", fl, rl), ("FFH m", fm, rm)]
        # FFS (fp32 at D 128 and 256) or FFS64 (fp32 at D 64) against the
        # plain forward; a second call must give the same bits.
        f32_forward = {"tiled_f32": ("FFS", flash_forward_f32),
                       "tiled_f32_64": ("FFS64", flash_forward_f32_d64)}.get(
                           forward_route(dtype, d))
        if f32_forward:
            fname, ffn = f32_forward
            fo, fl, fm = forward_checked(fname, ffn, q, k, v, seg, scale, (b, h, t, d))
            got[f"{fname} O"], want[f"{fname} O"] = fo, ro
            stats += [(f"{fname} l", fl, rl), (f"{fname} m", fm, rm)]
        fused = backward_route(dtype, d) == "fused"
        if fused:
            # FB against its own plain version (computed on the same inputs).
            for name, x, y in zip(("dQ", "dK", "dV"),
                                  flash_backward(q, k, v, seg, l, m, do, di, scale),
                                  flash_backward_reference(q, k, v, seg, l, m, do, di, scale)):
                got[f"FB {name}"], want[f"FB {name}"] = x, y
        split_h = backward_route(dtype, d) == "split_h"
        split_f32 = backward_route(dtype, d) == "split_f32"
        split_f32_w = backward_route(dtype, d) == "split_f32_w"
        if split_h or split_f32 or split_f32_w:
            # F2H and F3H (bf16 D 128), F2S and F3S (fp32 D 64) or F2SW and
            # F3SW (fp32 D 256) against F2's and F3's plain versions (the
            # same inputs); a second call must give the same bits. F2W and
            # F3W are held at this bf16 D 256 shape in time_generic_routes.
            n2, n3, dkv_fn, dq_fn = (
                ("F2H", "F3H", flash_backward_dkv_d128, flash_backward_dq_d128) if split_h
                else ("F2S", "F3S", flash_backward_dkv_f32, flash_backward_dq_f32) if split_f32
                else ("F2SW", "F3SW", flash_backward_dkv_f32_d256, flash_backward_dq_f32_d256))
            pair = (*dkv_fn(q, k, v, seg, l, m, do, di, scale), dq_fn(q, k, v, seg, l, m, do, di, scale))
            again = (*dkv_fn(q, k, v, seg, l, m, do, di, scale), dq_fn(q, k, v, seg, l, m, do, di, scale))
            bitwise = [torch.equal(x, y) for x, y in zip(pair, again)]
            log(f"flash {n2}, {n3} at {(b, h, t, d)}: two calls bitwise equal (dK, dV, dQ) {bitwise}")
            if not all(bitwise):
                raise RuntimeError(f"{n2}/{n3} are not bitwise reproducible at {(b, h, t, d)}")
            del again
            for name, x, y in zip((f"{n2} dK", f"{n2} dV", f"{n3} dQ"), pair, (rdk, rdv, rdq)):
                got[name], want[name] = x, y
        torch.cuda.synchronize()
        bf16 = dtype == torch.bfloat16
        measure, tol = (bf16_units, FLASH_BF16_UNITS) if bf16 else (relative_to_max, FLASH_FP32_TOL)
        errs = {}
        for name, x, ref, check, limit in (
            *((n, got[n], want[n], measure, tol) for n in got),
            *((n, x_, r_, relative_to_max, FLASH_STATS_TOL) for n, x_, r_ in stats),
        ):
            if not bool(torch.isfinite(x.float()).all()):
                raise RuntimeError(f"flash {name} is not finite at {(b, h, t, d, dtype)}")
            errs[name] = check(x, ref)
            if name in owner:
                abs_errs[owner[name]] = max(abs_errs[owner[name]],
                                            float((x.float() - ref.float()).abs().max()))
            if not errs[name] <= limit:
                raise RuntimeError(f"flash {name} off its plain version at {(b, h, t, d, dtype)}: "
                                   f"{errs[name]:.3e} (limit {limit:g})")
        label = f"B {b} H {h} T {t} D {d} {str(dtype).split('.')[-1]}{' padded' if padded else ''}"
        how = "bf16 units of the row scale" if bf16 else "max |kernel - plain| / max |plain|"
        log(f"flash {label}: {', '.join(got)} in {how}, l, m relative to max: "
            + ", ".join(f"{k_} {v_:.3g}" for k_, v_ in errs.items())
            + f" (limits {tol:g}; l, m {FLASH_STATS_TOL:g}); forward route "
            f"{forward_route(dtype, d)}, backward route {backward_route(dtype, d)}")
        if split_h and b == LLAMA_BATCH:
            # The check must catch a skipped tile of FFH, F2H and F3H at
            # Llama's shape: the plain version without one block of P; and a
            # wrong masking decision of FFH: one tile taken for one segment.
            fault = dropped_block(q, k, v, seg, l, m, do, di, scale, FLASH_FAULT_BLOCK)
            mask_fault = unmasked_tile(q, k, v, seg, scale, FLASH_MASK_FAULT_BLOCK)
            ffh_faults = {"dropped block": bf16_units(fault["O"], want["FFH O"]),
                          "unmasked tile": bf16_units(mask_fault, want["FFH O"])}
            log(f"flash {label}: planted faults against FFH's plain version (one 64 x 64 block "
                f"of P left out, rows 384-447, keys 192-255; the segment mask left off rows "
                f"448-511, keys 384-447), bf16 units of O: " + ", ".join(
                    f"{k_} {v_:.3g}" for k_, v_ in ffh_faults.items())
                + f"; FFH here {errs['FFH O']:.3g}; limit {tol:g}")
            if not min(ffh_faults.values()) > tol:
                raise RuntimeError(f"the bf16 limit {tol:g} does not catch FFH's planted faults: "
                                   f"{ffh_faults}")
            del mask_fault
            names = ("F2H dK", "F2H dV", "F3H dQ")
            fault_units = {n: bf16_units(fault[n.split()[-1]], want[n]) for n in names}
            log(f"flash {label}: planted fault (one 64 x 64 block of P left out, rows 384-447, "
                f"keys 192-255) against F2H's and F3H's plain versions, bf16 units: " + ", ".join(
                    f"{k_} {v_:.3g}" for k_, v_ in fault_units.items())
                + f"; the kernels here {max(errs[n] for n in names):.3g}; limit {tol:g}")
            if not min(fault_units.values()) > tol:
                raise RuntimeError(f"the bf16 limit {tol:g} does not catch a skipped tile of F2H "
                                   f"or F3H: {fault_units}")
            del fault
        if f32_forward:
            forward_faults(fname, (q, k, v, seg, l, m, do, di, scale), want[f"{fname} O"],
                           errs[f"{fname} O"], label)
        if split_f32:
            # The fp32 limit must catch a skipped tile of F2S and F3S: the
            # plain version without one block of P.
            fault = dropped_block(q, k, v, seg, l, m, do, di, scale, FLASH_FAULT_BLOCK)
            names = ("F2S dK", "F2S dV", "F3S dQ")
            fault_rel = {n: relative_to_max(fault[n.split()[-1]], want[n]) for n in names}
            log(f"flash {label}: planted fault (one 64 x 64 block of P left out, rows 384-447, "
                f"keys 192-255) against F2S's and F3S's plain versions, max |fault - plain| / "
                f"max |plain|: " + ", ".join(f"{k_} {v_:.3g}" for k_, v_ in fault_rel.items())
                + f"; the kernels here {max(errs[n] for n in names):.3g}; limit {tol:g}")
            if not min(fault_rel.values()) > tol:
                raise RuntimeError(f"the fp32 limit {tol:g} does not catch a skipped tile of F2S "
                                   f"or F3S: {fault_rel}")
            del fault
        if (b, h, t, d, dtype) != (16, 12, 512, 64, torch.bfloat16):
            continue

        # The check must catch a skipped tile: the plain version without one
        # block of P, held to the same limit, must fail it for every output,
        # against F1-F3's plain versions and against FB's.
        fault = dropped_block(q, k, v, seg, l, m, do, di, scale, FLASH_FAULT_BLOCK)
        fault_units = {name: bf16_units(fault[name.split()[-1]], want[name]) for name in want}
        sound_worst = max(errs[name] for name in want)
        log(f"flash {label}: planted fault (one 64 x 64 block of P left out, rows 384-447, keys "
            f"192-255) against the plain versions, bf16 units: " + ", ".join(
                f"{k_} {v_:.3g}" for k_, v_ in fault_units.items())
            + f"; the kernels' worst here {sound_worst:.3g}; limit {tol:g}")
        if not min(fault_units.values()) > tol:
            raise RuntimeError(f"the bf16 limit {tol:g} does not catch a skipped tile: {fault_units}")
        del fault
        # And a wrong masking decision: one tile taken for one segment.
        mask_fault = unmasked_tile(q, k, v, seg, scale, FLASH_MASK_FAULT_BLOCK)
        mask_units = {name: bf16_units(mask_fault, want[name]) for name in ("O", "FF O")}
        log(f"flash {label}: planted fault (segment mask left off rows 448-511, keys 384-447) "
            f"against the plain forward, bf16 units: " + ", ".join(
                f"{k_} {v_:.3g}" for k_, v_ in mask_units.items())
            + f"; F1 and FF here {errs['O']:.3g}, {errs['FF O']:.3g}; limit {tol:g}")
        if not min(mask_units.values()) > tol:
            raise RuntimeError(f"the bf16 limit {tol:g} does not catch an unmasked tile: {mask_units}")
        del mask_fault

        # Times at the flash path's shape: plain, kernel, kernel, plain; FF
        # against F1 and FB against the split route F2 + F3 in turns.
        def f1():
            return flash_forward(q, k, v, seg, scale)

        def ff():
            return flash_forward_pipelined(q, k, v, seg, scale)

        def f2():
            return flash_backward_dkv(q, k, v, seg, l, m, do, di, scale)

        def f3():
            return flash_backward_dq(q, k, v, seg, l, m, do, di, scale)

        def fb():
            return flash_backward(q, k, v, seg, l, m, do, di, scale)

        def split():
            return f2(), f3()

        def bwd_split():
            d_i = output_dot(o, do)
            flash_backward_dkv(q, k, v, seg, l, m, do, d_i, scale)
            flash_backward_dq(q, k, v, seg, l, m, do, d_i, scale)

        def bwd():  # what FlashAttention.backward runs at this shape
            flash_backward(q, k, v, seg, l, m, do, output_dot(o, do), scale)

        leaves = [x.detach().requires_grad_() for x in (q, k, v)]

        def fwd_bwd():
            out = FlashAttention.apply(*leaves, seg, scale)
            torch.autograd.grad(out, leaves, do)

        keep = (seg[:, :, None] == seg[:, None, :]) & torch.ones(
            t, t, dtype=torch.bool, device="cuda").tril()
        mask4 = keep[:, None]

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask4, scale=scale)

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(*leaves, attn_mask=mask4, scale=scale)
            torch.autograd.grad(out, leaves, do)

        sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask4, scale=scale)

        def sdpa_bwd():  # SDPA's backward alone, on one retained forward
            torch.autograd.grad(sdpa_out, leaves, do, retain_graph=True)

        att = (seg > 0).to(torch.int32)

        def naive_fwd_bwd():
            out = naive_attention(*leaves, att)
            torch.autograd.grad(out, leaves, do)

        plain = {
            "F1": lambda: flash_forward_reference(q, k, v, seg, scale),
            "FF": lambda: flash_forward_reference(q, k, v, seg, scale),
            "F2": lambda: flash_backward_dkv_reference(q, k, v, seg, l, m, do, di, scale),
            "F3": lambda: flash_backward_dq_reference(q, k, v, seg, l, m, do, di, scale),
            "FB": lambda: flash_backward_reference(q, k, v, seg, l, m, do, di, scale),
        }
        kernel = {"F1": f1, "F2": f2, "F3": f3, "FF": ff, "FB": fb}
        pairs, work = flash_work(seg, h, d, q.element_size())
        timing = {}
        # The forwards in turns: plain, F1, FF, FF, F1, plain.
        p1 = median_ms(plain["F1"], iters=5, warmup=1)
        g1, k1, k2, g2 = (median_ms(fn) for fn in (f1, ff, ff, f1))
        p2 = median_ms(plain["F1"], iters=5, warmup=1)
        for name, (r1, r2) in (("F1", (g1, g2)), ("FF", (k1, k2))):
            bound, bound_by = roofline(*work[name], BF16_FLOPS)
            timing[name] = dict(ms=(r1 + r2) / 2, plain_ms=(p1 + p2) / 2, bound_ms=bound,
                                bound_by=bound_by, device_ms=device_ms(kernel[name]),
                                runs=(r1, r2, p1, p2))
        for name in ("F2", "F3", "FB"):
            p1 = median_ms(plain[name], iters=5, warmup=1)
            s1 = median_ms(split) if name == "FB" else None
            k1 = median_ms(kernel[name])
            k2 = median_ms(kernel[name])
            s2 = median_ms(split) if name == "FB" else None
            p2 = median_ms(plain[name], iters=5, warmup=1)
            bound, bound_by = roofline(*work[name], BF16_FLOPS)
            timing[name] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, bound_ms=bound,
                                bound_by=bound_by, device_ms=device_ms(kernel[name]),
                                runs=(k1, k2, p1, p2))
            if name == "FB":
                timing[name]["split_ms"] = (s1 + s2) / 2
                timing[name]["split_runs"] = (s1, s2)
                timing[name]["split_device_ms"] = device_ms(split)
                timing[name]["kernel_device_ms"] = device_ms(fb, ("flash_bwd_fused_kernel",))
        extra = {
            "F2+F3 with torch di": median_ms(bwd_split),
            "FB with torch di (the Function's backward)": median_ms(bwd),
            "flash fwd+bwd (autograd Function: FF + FB)": median_ms(fwd_bwd),
            "flash fwd+bwd, device": device_ms(fwd_bwd),
            "SDPA fwd": median_ms(sdpa),
            "SDPA fwd, device": device_ms(sdpa),
            "SDPA bwd alone": median_ms(sdpa_bwd),
            "SDPA bwd alone, device": device_ms(sdpa_bwd),
            "SDPA fwd+bwd": median_ms(sdpa_fwd_bwd),
            "SDPA fwd+bwd, device": device_ms(sdpa_fwd_bwd),
            "naive fwd+bwd": median_ms(naive_fwd_bwd, iters=10),
        }
        del sdpa_out
        extra["host gap: Function fwd+bwd - (FF + FB with torch di)"] = (
            extra["flash fwd+bwd (autograd Function: FF + FB)"] - timing["FF"]["ms"]
            - extra["FB with torch di (the Function's backward)"])
        nbytes = work["FF"][0] + work["FB"][0]
        flops = work["FF"][1] + work["FB"][1]
        extra["bound fwd+bwd"] = roofline(nbytes, flops, BF16_FLOPS)[0]
        for name, tm in timing.items():
            log(f"flash {name} at {label}: kernel {tm['ms']:.4f} ms ({tm['runs'][0]:.4f}, "
                f"{tm['runs'][1]:.4f}; device {tm['device_ms']:.4f}), plain {tm['plain_ms']:.3f} ms ({tm['runs'][2]:.3f}, "
                f"{tm['runs'][3]:.3f}), bound {tm['bound_ms']:.4f} ms ({tm['bound_by']}: "
                f"{work[name][0] / 1e6:.1f} MB, {work[name][1] / 1e9:.2f} GFLOP over {pairs:,} "
                f"kept pairs) [{card}]")
        ff_t, f1_t = timing["FF"], timing["F1"]
        log(f"flash FF against F1 in turns (plain, F1, FF, FF, F1, plain) at {label}: F1 "
            f"{f1_t['runs'][0]:.4f} / {f1_t['runs'][1]:.4f} ms, FF {ff_t['runs'][0]:.4f} / "
            f"{ff_t['runs'][1]:.4f} ms (CUDA events around one call); device time per call "
            f"(torch.profiler): F1 {f1_t['device_ms']:.4f} ms, FF {ff_t['device_ms']:.4f} ms [{card}]")
        fb_t = timing["FB"]
        log(f"flash FB against F2+F3 in turns (plain, F2+F3, FB, FB, F2+F3, plain) at {label}: "
            f"F2+F3 {fb_t['split_runs'][0]:.4f} / {fb_t['split_runs'][1]:.4f} ms, FB "
            f"{fb_t['runs'][0]:.4f} / {fb_t['runs'][1]:.4f} ms (CUDA events around one call; FB "
            f"includes the wrapper's zeroing of the fp32 dQ sum and its cast to bf16); device "
            f"time per call (torch.profiler): F2+F3 {fb_t['split_device_ms']:.4f} ms, FB with "
            f"the zeroing and cast {fb_t['device_ms']:.4f} ms, the FB kernel alone "
            f"{fb_t['kernel_device_ms']:.4f} ms [{card}]")
        log(f"flash at {label}: " + ", ".join(f"{k_} {v_:.4f} ms" for k_, v_ in extra.items())
            + f" (CUDA-event medians; SDPA with the same boolean mask) [{card}]")
        timing["F1"]["library_ms"] = timing["FF"]["library_ms"] = extra["SDPA fwd"]
        timing["FB"]["library_ms"] = extra["SDPA bwd alone"]
        timing["F2"]["library_ms"] = timing["F3"]["library_ms"] = None
        for tm in timing.values():
            tm.pop("runs")
            tm.pop("split_runs", None)
        timing["extra"] = extra
    # FFH, F2H and F3H report phase 15's shape (Llama); FFW, F2W and F3W
    # phase 16's (Gemma-2B's heads), with the bf16 D 256 route case beside; F1,
    # F2S and F3S fp32 at D 64 (phase 11's first run); FFS, F2SH and F3SH fp32
    # at D 128 (the route of its second run), FFS also at D 256 beside; F2SW
    # and F3SW fp32 at D 256 (the route of its third run); F2 and F3 bf16 at
    # D 256, where F2W and F3W took their place and they are timed as the
    # yardstick. Their other shapes, and the bf16 D 64 times of F1-F3 (the
    # turns against FF and FB above), stay beside.
    routes = time_generic_routes(card)
    llama_shape = f"B {LLAMA_BATCH} H 32 T 512 D 128 bf16 (phase 15's heads after the GQA repeat)"
    fp32_d64 = "B 16 H 12 T 512 D 64 fp32 padded (phase 11's first run: FFS64, F2S, F3S)"
    fp32_d128 = ("B 16 H 6 T 512 D 128 fp32 padded (the route of phase 11's second run: FFS, F2SH, "
                 "F3SH)")
    fp32_d256 = ("B 16 H 3 T 512 D 256 fp32 padded (the route of phase 11's third run: FFS, F2SW, "
                 "F3SW)")
    bf16_d256 = ("B 4 H 8 T 512 D 256 bf16 padded (F2's and F3's route until F2W and F3W took it; "
                 "they run on no route, timed as the yardstick)")
    f1_bf16_d256 = {c: routes["F1"][c] for c in ("Gemma bf16 D 256", "bf16 D 256")}
    gemma_shape = (f"B {GEMMA_BATCH} H 8 T 512 D 256 bf16 (phase 16's heads after the MQA repeat, "
                   f"unpadded)")
    at_d64 = {name: {k: timing[name][k] for k in ("ms", "device_ms", "bound_ms")}
              for name in ("F1", "F2", "F3")}
    main_case = {"F1": ("fp32 D 64", fp32_d64 + ", timed as FFS64's yardstick"),
                 "F2": ("bf16 D 256", bf16_d256), "F3": ("bf16 D 256", bf16_d256)}
    for name, (case, shape) in main_case.items():
        timing[name] = dict(routes[name][case], shape=shape, at_bf16_d64=at_d64[name], **{
            f"at {other}": routes[name][other] for other in GENERIC_ROUTE_CASES if other != case})
    timing["F2"]["pair (F2+F3)"] = routes["F2+F3"]
    for name in ("FFH", "F2H", "F3H"):
        timing[name] = dict(routes[name]["Llama bf16 D 128"], shape=llama_shape,
                            at_bf16_d128_h6=routes[name]["bf16 D 128"])
    timing["F2H"]["pair_at_llama"] = routes["F2H+F3H"]["Llama bf16 D 128"]
    timing["F2H"]["pair_at_bf16_d128_h6"] = routes["F2H+F3H"]["bf16 D 128"]
    timing["F2H"]["f2_f3_at_llama"] = routes["F2+F3"]["Llama bf16 D 128"]
    for name in ("F2W", "F3W"):
        timing[name] = dict(routes[name]["Gemma bf16 D 256"], shape=gemma_shape,
                            at_bf16_d256=routes[name]["bf16 D 256"])
        abs_errs[name] = max(abs_errs[name], routes[name]["bf16 D 256"]["max_abs_err"])
    for case, key in (("Gemma bf16 D 256", "at_gemma"), ("bf16 D 256", "at_bf16_d256")):
        timing["F2W"][f"pair_{key}"] = routes["F2W+F3W"][case]
        timing["F2W"][f"f2_f3_{key}"] = routes["F2+F3"][case]
    # F1 at bf16 D 256 runs on no route since FFW took it: timed as its yardstick.
    timing["FFW"] = dict(routes["FFW"]["Gemma bf16 D 256"], shape=gemma_shape,
                         at_bf16_d256=routes["FFW"]["bf16 D 256"],
                         f1_in_the_same_turns=f1_bf16_d256)
    abs_errs["FFW"] = max(abs_errs["FFW"], routes["FFW"]["bf16 D 256"]["max_abs_err"])
    ffs_cases = ("fp32 D 128", "fp32 D 256")
    timing["FFS"] = dict(routes["FFS"]["fp32 D 128"], shape=fp32_d128,
                         at_fp32_d256=dict(routes["FFS"]["fp32 D 256"], shape=fp32_d256),
                         f1_in_the_same_turns={c: routes["F1"][c] for c in ffs_cases})
    abs_errs["FFS"] = max(abs_errs["FFS"], routes["FFS"]["fp32 D 256"]["max_abs_err"])
    # F1 at fp32 D 64 runs on no route since FFS64 took it: timed as its yardstick.
    timing["FFS64"] = dict(routes["FFS64"]["fp32 D 64"], shape=fp32_d64,
                           f1_in_the_same_turns=routes["F1"]["fp32 D 64"])
    for n2, n3, case, shape in (("F2S", "F3S", "fp32 D 64", fp32_d64),
                                ("F2SH", "F3SH", "fp32 D 128", fp32_d128),
                                ("F2SW", "F3SW", "fp32 D 256", fp32_d256)):
        for name in (n2, n3):
            timing[name] = dict(routes[name][case], shape=shape)
        timing[n2]["pair"] = routes[f"{n2}+{n3}"][case]
        timing[n2]["f2_f3_in_the_same_turns"] = routes["F2+F3"][case]
    # F2S, F3S, F2SW and F3SW are also held at their route's case in
    # time_generic_routes, F2SH and F3SH there alone.
    out = {}
    for name in ("F1", "F2", "F3", "FF", "FB", "FFH", "FFW", "FFS", "FFS64", "F2H", "F3H", "F2W",
                 "F3W", "F2S", "F3S", "F2SH", "F3SH", "F2SW", "F3SW"):
        err = max(abs_errs.get(name, 0.0), timing[name].pop("max_abs_err", 0.0))
        out[name] = dict(timing[name], max_abs_err=err)
    out["extra"] = timing["extra"]
    return out


def kernel_names(fn) -> list:
    """The names of the CUDA kernels one call of `fn` launches (torch.profiler;
    the window opens with uncounted spin kernels, as in `device_ms`)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PRIMER_KERNELS):
            torch.cuda._sleep(1000)
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.key})


def split_pair_checks(case: str, split, args, padded: bool, abs_err: dict) -> None:
    """A split backward pair (F2H + F3H, F2W + F3W or an fp32 pair) at a
    GENERIC_ROUTE_CASES case: within the limit of their plain versions (bf16
    units in bf16, max |kernel - plain| / max |plain| in fp32), finite, two
    calls bitwise equal, and the limit must catch two planted faults against
    the plain versions: one 64 x 64 block of P left out, and a wrong masking
    decision (padded: the segment mask left off a tile whose rows cross a
    padding boundary; unpadded: the causal mask left off a diagonal tile).
    Records the largest absolute errors."""
    from kronfluence_tpu_torch.ops.kernels.flash import (
        flash_backward_dkv_reference,
        flash_backward_dq_reference,
    )

    if args[0].dtype == torch.bfloat16:
        measure, limit, how = bf16_units, FLASH_BF16_UNITS, "bf16 units"
    else:
        measure, limit, how = relative_to_max, FLASH_FP32_TOL, "max |kernel - plain| / max |plain|"
    n2, n3, dkv_fn, dq_fn = split[:4]
    got = (*dkv_fn(*args), dq_fn(*args))
    again = (*dkv_fn(*args), dq_fn(*args))
    want = (*flash_backward_dkv_reference(*args), flash_backward_dq_reference(*args))
    errs = [measure(x, y) for x, y in zip(got, want)]
    bitwise = [torch.equal(x, y) for x, y in zip(got, again)]
    finite = all(bool(torch.isfinite(x.float()).all()) for x in got)
    abs_errs = [float((x.float() - y.float()).abs().max()) for x, y in zip(got, want)]
    abs_err.update({n2: max(abs_errs[:2]), n3: abs_errs[2]})
    log(f"flash {n2}, {n3} at {case} ({tuple(args[0].shape)}): dK, dV, dQ in {how} "
        f"{[f'{e:.3g}' for e in errs]} (limit {limit:g}); two calls bitwise equal {bitwise}; "
        f"finite {finite}")
    if not (max(errs) <= limit and all(bitwise) and finite):
        raise RuntimeError(f"{n2}/{n3} off their plain versions at {case}: {errs}, {bitwise}")
    del got, again
    faults = {"dropped block": dropped_block(*args, FLASH_FAULT_BLOCK)}
    if padded:
        faults["unmasked tile"] = unmasked_tile_backward(*args, FLASH_MASK_FAULT_BLOCK)
        where = "the segment mask left off rows 448-511, keys 384-447"
    else:
        faults["unmasked diagonal tile"] = unmasked_tile_backward(*args, FLASH_DIAG_FAULT_BLOCK,
                                                                  causal_too=True)
        where = "the causal mask left off the diagonal tile of rows and keys 448-511"
    fault_errs = {f"{what} {n}": measure(fault[n], y) for what, fault in faults.items()
                  for n, y in zip(("dK", "dV", "dQ"), want)}
    log(f"flash {case}: planted faults (one 64 x 64 block of P left out, rows 384-447, keys "
        f"192-255; {where}) against {n2}'s and {n3}'s plain versions, {how}: "
        + ", ".join(f"{k_} {v_:.3g}" for k_, v_ in fault_errs.items())
        + f"; the kernels here {max(errs):.3g}; limit {limit:g}")
    if not min(fault_errs.values()) > limit:
        raise RuntimeError(f"the limit {limit:g} does not catch a planted fault of {n2} or {n3}: "
                           f"{fault_errs}")


def time_generic_routes(card: str) -> dict:
    """F1 and F2 + F3 at GENERIC_ROUTE_CASES, and where `forward_route` gives
    "pipelined_h" (bf16 D 128), "wgmma_w" (bf16 D 256) or "tiled_f32" (fp32
    D 128 and 256) and `backward_route` "split_h" (bf16 D 128), "split_w"
    (bf16 D 256), "split_f32" (fp32 D 64), "split_f32_h" (fp32 D 128) or
    "split_f32_w" (fp32 D 256), FFH, FFW, FFS, F2H + F3H, F2W + F3W, F2S +
    F3S, F2SH + F3SH and F2SW + F3SW too, in turns against SDPA's forward and
    its backward alone with the same boolean mask: CUDA events around one
    call (median), torch.profiler device time, the plain version and the
    bound; SDPA's kernel names are logged, and where SDPA raises the case is
    logged and timed without it. There FFH, FFW, FFS and the split pair are
    first held against their plain versions (each forward twice, bitwise;
    FFW with three planted faults and FFS, within 1e-5 of max, with two,
    `forward_faults`; each split pair by `split_pair_checks`); FFH, FFW and
    FFS must beat F1, and each split pair F2 + F3, by device time; the
    Function's forward (the operands' .contiguous() copies, then FFH or FFW)
    is split by device time into the copies and the kernel, and its backward
    (di, then the split pair) into di and the kernels. {kernel: {case:
    numbers}}, kernel in F1, FFH, FFW, FFS, F2, F3, F2+F3, F2H, F3H,
    F2H+F3H, F2W, F3W, F2W+F3W, F2S, F3S, F2S+F3S, F2SH, F3SH, F2SH+F3SH,
    F2SW, F3SW, F2SW+F3SW; FFW's, FFS's and each split pair's kernels also
    carry `max_abs_err` against their plain versions."""
    from kronfluence_tpu_torch.ops.attention import FlashAttention, output_dot
    from kronfluence_tpu_torch.ops.kernels.flash import (
        backward_route,
        flash_backward_dkv,
        flash_backward_dkv_d128,
        flash_backward_dkv_d256,
        flash_backward_dkv_f32,
        flash_backward_dkv_f32_d128,
        flash_backward_dkv_f32_d256,
        flash_backward_dkv_reference,
        flash_backward_dq,
        flash_backward_dq_d128,
        flash_backward_dq_d256,
        flash_backward_dq_f32,
        flash_backward_dq_f32_d128,
        flash_backward_dq_f32_d256,
        flash_backward_dq_reference,
        flash_forward,
        flash_forward_d128,
        flash_forward_d256,
        flash_forward_f32,
        flash_forward_f32_d64,
        flash_forward_reference,
        forward_route,
    )

    # Each fp32 forward route: its kernel's name, wrapper and CUDA kernel names.
    f32_forwards = {"tiled_f32": ("FFS", flash_forward_f32, FFS_PROFILED),
                    "tiled_f32_64": ("FFS64", flash_forward_f32_d64, FFS64_PROFILED)}
    # Each bf16 forward route of its own: its kernel's name, wrapper and CUDA
    # kernel names.
    bf16_forwards = {"pipelined_h": ("FFH", flash_forward_d128, (FWD_KERNELS[1],)),
                     "wgmma_w": ("FFW", flash_forward_d256, (FFW_KERNEL,))}
    # Each split backward route: its two kernels' names, wrappers and CUDA
    # kernel names.
    split_routes = {
        "split_h": ("F2H", "F3H", flash_backward_dkv_d128, flash_backward_dq_d128,
                    ("flash_bwd_dkv_d128_kernel",), ("flash_bwd_dq_d128_kernel",)),
        "split_w": ("F2W", "F3W", flash_backward_dkv_d256, flash_backward_dq_d256,
                    (D256_KERNELS[0],), (D256_KERNELS[1],)),
        "split_f32": ("F2S", "F3S", flash_backward_dkv_f32, flash_backward_dq_f32,
                      (F32_KERNELS[0],), (F32_KERNELS[1],)),
        "split_f32_h": ("F2SH", "F3SH", flash_backward_dkv_f32_d128, flash_backward_dq_f32_d128,
                        (F32_D128_KERNELS[0],), (F32_D128_KERNELS[1],)),
        "split_f32_w": ("F2SW", "F3SW", flash_backward_dkv_f32_d256, flash_backward_dq_f32_d256,
                        (F32_D256_KERNELS[0],), (F32_D256_KERNELS[1],)),
    }
    out = {"F1": {}, "FFH": {}, "FFW": {}, "FFS": {}, "FFS64": {}, "F2": {}, "F3": {},
           "F2+F3": {}}
    for n2, n3, *_ in split_routes.values():
        out.update({n2: {}, n3: {}, f"{n2}+{n3}": {}})
    for case, (b, h, t, d, dtype, padded) in GENERIC_ROUTE_CASES.items():
        gen = torch.Generator("cuda").manual_seed(b * t + d + h + 1)
        q, k, v, do = (torch.randn(b, h, t, d, generator=gen, device="cuda").to(dtype)
                       for _ in range(4))
        seg = padded_segments(b, t, padded, "cuda")
        scale = d ** -0.5
        o, l, m = flash_forward(q, k, v, seg, scale)
        di = output_dot(o, do)
        args = (q, k, v, seg, l, m, do, di, scale)
        route = backward_route(dtype, d)
        split = split_routes.get(route)
        bf16_forward = bf16_forwards.get(forward_route(dtype, d))
        abs_err = {}
        if bf16_forward:
            fname, ffn, _ = bf16_forward
            got = forward_checked(fname, ffn, q, k, v, seg, scale, case)
            want = flash_forward_reference(q, k, v, seg, scale)
            errs = [bf16_units(got[0], want[0])] + [relative_to_max(x, y)
                                                    for x, y in zip(got[1:], want[1:])]
            log(f"flash {fname} at {case} (B {b} H {h} T {t} D {d}): O in bf16 units, l, m "
                f"relative to max {[f'{e:.3g}' for e in errs]} (limits {FLASH_BF16_UNITS:g}; "
                f"{FLASH_STATS_TOL:g})")
            if not (errs[0] <= FLASH_BF16_UNITS and max(errs[1:]) <= FLASH_STATS_TOL):
                raise RuntimeError(f"{fname} off its plain version at {case}: {errs}")
            if fname == "FFW":
                abs_err["FFW"] = float((got[0].float() - want[0].float()).abs().max())
                forward_faults("FFW", args, want[0], errs[0], case, padded=padded, diagonal=True)
            del got, want
        f32_forward = f32_forwards.get(forward_route(dtype, d))
        if f32_forward:
            fname, ffn, _ = f32_forward
            got = forward_checked(fname, ffn, q, k, v, seg, scale, case)
            want = flash_forward_reference(q, k, v, seg, scale)
            errs = [relative_to_max(x, y) for x, y in zip(got, want)]
            abs_err[fname] = float((got[0] - want[0]).abs().max())
            log(f"flash {fname} at {case} (B {b} H {h} T {t} D {d}): O, l, m max |kernel - "
                f"plain| / max |plain| {[f'{e:.3g}' for e in errs]} (limits {FLASH_FP32_TOL:g}; "
                f"{FLASH_STATS_TOL:g})")
            if not (errs[0] <= FLASH_FP32_TOL and max(errs[1:]) <= FLASH_STATS_TOL):
                raise RuntimeError(f"{fname} off its plain version at {case}: {errs}")
            forward_faults(fname, args, want[0], errs[0], case, padded=padded)
            del got, want
        if split:
            split_pair_checks(case, split, args, padded, abs_err)
        keep = (seg[:, :, None] == seg[:, None, :]) & torch.ones(
            t, t, dtype=torch.bool, device="cuda").tril()
        mask4 = keep[:, None]
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        fns = {
            "F1": (lambda: flash_forward(q, k, v, seg, scale), ("flash_fwd_kernel",)),
            **({bf16_forward[0]: (lambda: bf16_forward[1](q, k, v, seg, scale), bf16_forward[2])}
               if bf16_forward else {}),
            **({f32_forward[0]: (lambda: f32_forward[1](q, k, v, seg, scale), f32_forward[2])}
               if f32_forward else {}),
            "F2": (lambda: flash_backward_dkv(*args), ("flash_bwd_dkv_kernel",)),
            "F3": (lambda: flash_backward_dq(*args), ("flash_bwd_dq_kernel",)),
            "F2+F3": (lambda: (flash_backward_dkv(*args), flash_backward_dq(*args)),
                      ("flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")),
        }
        sdpa_names, sdpa_out = {}, None
        try:
            def sdpa_fwd():
                return F.scaled_dot_product_attention(q, k, v, attn_mask=mask4, scale=scale)

            sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask4, scale=scale)

            def sdpa_bwd():  # SDPA's backward alone, on one retained forward
                return torch.autograd.grad(sdpa_out, leaves, do, retain_graph=True)

            sdpa_bwd()
            sdpa_names = {"SDPA fwd": kernel_names(sdpa_fwd), "SDPA bwd alone": kernel_names(sdpa_bwd)}
            fns.update({"SDPA fwd": (sdpa_fwd, None), "SDPA bwd alone": (sdpa_bwd, None)})
        except RuntimeError as err:
            log(f"flash generic routes, {case}: SDPA with the boolean mask raised, so this case "
                f"has no library time: {str(err)[:300]}")
        if split:
            n2, n3, dkv_fn, dq_fn, dkv_k, dq_k = split
            pair_name = f"{n2}+{n3}"
            fns.update({
                n2: (lambda: dkv_fn(*args), dkv_k),
                n3: (lambda: dq_fn(*args), dq_k),
                pair_name: (lambda: (dkv_fn(*args), dq_fn(*args)), dkv_k + dq_k),
            })
        times = turns_ms(fns)
        plain = {
            "F1": median_ms(lambda: flash_forward_reference(q, k, v, seg, scale), 5, 1),
            "F2": median_ms(lambda: flash_backward_dkv_reference(*args), 5, 1),
            "F3": median_ms(lambda: flash_backward_dq_reference(*args), 5, 1),
        }
        plain["F2+F3"] = plain["F2"] + plain["F3"]
        # FFH's, FFW's, FFS's and FFS64's plain version is F1's; each split
        # pair's are F2's and F3's.
        pairs, work = flash_work(seg, h, d, q.element_size())
        work["F2+F3"] = work["FB"]  # dQ, dK, dV written once
        for name in ("FFH", "FFW", "FFS", "FFS64"):
            plain[name], work[name] = plain["F1"], work["F1"]
        library = {"F1": "SDPA fwd", "FFH": "SDPA fwd", "FFW": "SDPA fwd", "FFS": "SDPA fwd",
                   "FFS64": "SDPA fwd", "F2+F3": "SDPA bwd alone"}
        for n2, n3, *_ in split_routes.values():
            for name, like in ((n2, "F2"), (n3, "F3"), (f"{n2}+{n3}", "F2+F3")):
                plain[name], work[name] = plain[like], work[like]
            library[f"{n2}+{n3}"] = "SDPA bwd alone"
        peak = FP32_FLOPS if dtype == torch.float32 else BF16_FLOPS
        for name in out:
            if name not in times:
                continue
            bound, bound_by = roofline(*work[name], peak)
            lib = library.get(name) if library.get(name) in times else None
            out[name][case] = dict(
                ms=float(np.mean([e for e, _ in times[name]])),
                device_ms=float(np.mean([dv for _, dv in times[name]])),
                runs=[list(x) for x in times[name]],
                plain_ms=plain[name], bound_ms=bound, bound_by=bound_by,
                library_ms=float(np.mean([e for e, _ in times[lib]])) if lib else None,
                library_device_ms=float(np.mean([dv for _, dv in times[lib]])) if lib else None,
                **({"library_kernels": sdpa_names[lib]} if lib else {}),
                **({"max_abs_err": abs_err[name]} if name in abs_err else {}))
        extra = ""
        if bf16_forward:
            # The Function's forward at this shape (FlashAttention.forward):
            # .contiguous() on the operands, then FFH or FFW. Llama's
            # attention hands it contiguous operands (RoPE's stack,
            # repeat_interleave), as here.
            def function_forward():
                with torch.no_grad():
                    FlashAttention.apply(q, k, v, seg, scale)

            fname, _, fkernels = bf16_forward
            whole, kernel = device_ms(function_forward), device_ms(function_forward, fkernels)
            out[fname][case].update(function_forward_device_ms=whole, kernel_device_ms=kernel,
                                    copies_device_ms=whole - kernel)
            extra += (f"; the Function's forward {whole:.4f} ms by device time: the "
                      f".contiguous() copies {whole - kernel:.4f}, {fname} {kernel:.4f}")
        if split:
            # The Function's backward at this shape (FlashAttention.backward):
            # di = rowsum(O * dO) in torch ops, then the route's split pair.
            n2, n3, dkv, dq, dkv_k, dq_k = split
            pair_name = f"{n2}+{n3}"

            def function_backward():
                d_i = output_dot(o, do)
                dkv(q, k, v, seg, l, m, do, d_i, scale)
                dq(q, k, v, seg, l, m, do, d_i, scale)

            whole, kernels = device_ms(function_backward), device_ms(function_backward, dkv_k + dq_k)
            pair = out[pair_name][case]
            pair.update(function_backward_device_ms=whole, kernels_device_ms=kernels,
                        di_device_ms=whole - kernels,
                        split_floor_ms=(work["F2"][0] + work["F3"][0]) / HBM_BYTES_PER_S * 1e3)
            extra += (f"; the Function's backward {whole:.4f} ms by device time: di "
                      f"{whole - kernels:.4f}, {pair_name} {kernels:.4f}; the split pair's byte "
                      f"floor {pair['split_floor_ms']:.4f} ms")
        del sdpa_out
        log(f"flash generic routes, {case}, at B {b} H {h} T {t} D {d}"
            f"{' padded' if padded else ''} ({pairs:,} "
            f"kept pairs), in turns there and back, ms (CUDA events around one call, "
            f"torch.profiler device time): " + "; ".join(
                f"{name} " + " / ".join(f"({e:.4f}, {dv:.4f})" for e, dv in ts)
                for name, ts in times.items()) + "; bounds " + ", ".join(
                f"{name} {out[name][case]['bound_ms']:.4f} ({out[name][case]['bound_by']})"
                for name in out if case in out[name]) + "; plain " + ", ".join(
                f"{name} {v:.3f}" for name, v in plain.items() if name in times) + extra
            + f"; SDPA's kernels {sdpa_names or 'none (it raised)'} [{card}]")
        for name in ("FFH", "FFW", "FFS", "FFS64"):
            if case in out[name] and not (out[name][case]["device_ms"]
                                          < out["F1"][case]["device_ms"]):
                raise RuntimeError(f"{name} is not faster than F1 at {case}: "
                                   f"{out[name][case]['device_ms']:.4f} against "
                                   f"{out['F1'][case]['device_ms']:.4f} ms by device time")
        for pair_name in (f"{n2}+{n3}" for n2, n3, *_ in split_routes.values()):
            if case in out[pair_name] and not (out[pair_name][case]["device_ms"]
                                               < out["F2+F3"][case]["device_ms"]):
                raise RuntimeError(f"{pair_name} are not faster than F2 + F3 at {case}: "
                                   f"{out[pair_name][case]['device_ms']:.4f} against "
                                   f"{out['F2+F3'][case]['device_ms']:.4f} ms by device time")
    return out


def _to_fp32(factors: dict) -> dict:
    return {k: {n: t.float() if t.is_floating_point() else t for n, t in v.items()}
            for k, v in factors.items()}


def _stage(fn, *args):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def compare_eigenpairs(cov32: dict, got: dict, want: dict) -> dict:
    """Per matrix, relative to cuSOLVER's max|lambda|: max |dlambda|, max
    |Q L Q^T - A| for both solvers, and max |Q^T Q - I| of `got`."""
    from kronfluence_tpu_torch.factor.eigen import _FACTOR_PAIRS

    worst = {"eigenvalues": 0.0, "reconstruction": 0.0, "orthogonality": 0.0,
             "cusolver_reconstruction": 0.0}
    for cov_name, count_name, evec_name, eval_name in _FACTOR_PAIRS:
        for name, c in cov32[cov_name].items():
            a = c / cov32[count_name][name].float().reshape(())
            a = 0.5 * (a + a.T)
            lam, q = got[eval_name][name], got[evec_name][name]
            ref_lam, ref_q = want[eval_name][name], want[evec_name][name]
            scale = float(ref_lam.abs().max())
            eye = torch.eye(a.shape[0], device=a.device)
            worst["eigenvalues"] = max(worst["eigenvalues"], float((lam - ref_lam).abs().max()) / scale)
            worst["reconstruction"] = max(
                worst["reconstruction"], float(((q * lam) @ q.T - a).abs().max()) / scale)
            worst["cusolver_reconstruction"] = max(
                worst["cusolver_reconstruction"],
                float(((ref_q * ref_lam) @ ref_q.T - a).abs().max()) / scale)
            worst["orthogonality"] = max(worst["orthogonality"], float((q.T @ q - eye).abs().max()))
    return worst


def phase_jacobi_path(card: str, ctx: dict) -> tuple:
    from kronfluence_tpu_torch.factor.eigen import (
        fit_lambda_matrices_with_loader,
        perform_eigendecomposition,
    )
    from kronfluence_tpu_torch.ops.eigh import eigh_batched
    from kronfluence_tpu_torch.ops.kernels.jacobi import jacobi_pivot_rotations, jacobi_route
    from kronfluence_tpu_torch.ops.kernels.probe import probe
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk
    from kronfluence_tpu_torch.score.pairwise import compute_pairwise_scores_with_loaders
    from kronfluence_tpu_torch.utils.constants import ALL_MODULE_NAME
    from kronfluence_tpu_torch.utils.dataset import BatchLoader

    model, task, data, cov = ctx["model"], ctx["task"], ctx["data"], ctx["cov"]
    device, score_args = ctx["device"], ctx["score_args"]
    jacobi_args = copy.deepcopy(ctx["factor_args"])
    jacobi_args.eigendecomposition_solver = "jacobi"

    torch.cuda.reset_peak_memory_stats()
    eigh_batched.chunks.clear()
    jacobi_pivot_rotations.launches = syrk.launches = probe.launches = 0
    jacobi_pivot_rotations.registers_launches = jacobi_pivot_rotations.generic_launches = 0
    eigen, eig_s = _stage(perform_eigendecomposition, cov, jacobi_args)
    launches = jacobi_pivot_rotations.launches
    by_route = {"registers": jacobi_pivot_rotations.registers_launches,
                "generic": jacobi_pivot_rotations.generic_launches}
    eig_peak = torch.cuda.max_memory_allocated() / 2**30
    lam, lam_s = _stage(
        fit_lambda_matrices_with_loader, model, task,
        BatchLoader(data["lambda"], LAMBDA_BATCH, device=device), jacobi_args, eigen,
    )
    scores, pair_s = _stage(
        compute_pairwise_scores_with_loaders, model, task,
        BatchLoader(data["query"], QUERY_BATCH, device=device),
        BatchLoader(data["train"], TRAIN_BATCH, device=device),
        {**cov, **eigen, **lam}, jacobi_args, score_args,
    )
    chunks = list(eigh_batched.chunks)
    want = sum(c["sweeps"] * c["rounds_per_sweep"] for c in chunks)
    log(f"Jacobi path: eigendecomposition {eig_s:.3f} s (first Jacobi run in the process), "
        f"lambda {lam_s:.3f} s, pairwise {pair_s:.3f} s; peak device memory "
        f"{eig_peak:.2f} GiB in the eigendecomposition, "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB in all [{card}]")
    log("Jacobi path chunks (padded n, matrices, sweeps, rounds per sweep): "
        + ", ".join(f"({c['n']}, {c['matrices']}, {c['sweeps']}, {c['rounds_per_sweep']})" for c in chunks))
    route = jacobi_route(64)  # the pivot block of the default block_size 32
    log(f"Jacobi path kernel launches: jacobi {launches} (want sum of sweeps x rounds = {want}, "
        f"all on jacobi_route(64) = {route!r}), by route {by_route}, syrk {syrk.launches}, "
        f"probe {probe.launches}")
    if [(c["n"], c["matrices"]) for c in chunks] != JACOBI_CHUNKS:
        raise RuntimeError(f"Jacobi path chunks {chunks}, want (n, matrices) {JACOBI_CHUNKS}")
    if launches != want or launches == 0 or by_route[route] != launches:
        raise RuntimeError(f"K2 launched {launches} times on the Jacobi path ({by_route}), want "
                           f"{want}, all on the {route} route")
    check_artifacts(cov, eigen, lam, scores, COV_N * SEQ, LAMBDA_N, (QUERY_N, TRAIN_N))
    s_j = scores[ALL_MODULE_NAME].float().flatten()
    s_c = ctx["scores"][ALL_MODULE_NAME].float().flatten()
    pearson = float(torch.corrcoef(torch.stack([s_j, s_c]))[0, 1])
    log(f"Jacobi path: scores {tuple(scores[ALL_MODULE_NAME].shape)} finite; Pearson r against "
        f"the cuSOLVER path's scores {pearson:.6f} (EK-FAC fits lambda in the eigenbasis, and "
        f"the solvers pick different bases for close eigenvalues)")

    # Accuracy: the stage's fp32 eigenpairs (the bf16 recipe stores them in
    # bf16) from both solvers, on the same fp32 covariance factors.
    cov32 = _to_fp32(cov)
    auto_args = copy.deepcopy(jacobi_args)
    auto_args.eigendecomposition_solver = "auto"
    eigh_batched.chunks.clear()
    jacobi32, warm_s = _stage(perform_eigendecomposition, cov32, jacobi_args)
    cusolver32, cus_s = _stage(perform_eigendecomposition, cov32, auto_args)
    same = [(c["n"], c["sweeps"]) for c in eigh_batched.chunks] == [(c["n"], c["sweeps"]) for c in chunks]
    worst = compare_eigenpairs(cov32, jacobi32, cusolver32)
    log(f"Jacobi vs cuSOLVER, fp32, worst of 96 matrices: eigenvalues {worst['eigenvalues']:.3e} "
        f"(limit {JACOBI_EIG_RTOL:g}), reconstruction {worst['reconstruction']:.3e} (limit "
        f"{JACOBI_RECON_RTOL:g}; cuSOLVER's own {worst['cusolver_reconstruction']:.3e}), "
        f"orthogonality {worst['orthogonality']:.3e} (limit {JACOBI_ORTH_ATOL:g}); "
        f"stage seconds on fp32 factors: jacobi {warm_s:.3f} (second run, same sweeps as the "
        f"bf16 run: {same}), cuSOLVER {cus_s:.3f} [{card}]")
    if not (worst["eigenvalues"] <= JACOBI_EIG_RTOL and worst["reconstruction"] <= JACOBI_RECON_RTOL
            and worst["orthogonality"] <= JACOBI_ORTH_ATOL):
        raise RuntimeError(f"the Jacobi path's eigenpairs are off cuSOLVER's: {worst}")
    generic, generic_m32 = ground_truth(card, cov32, jacobi32, cusolver32)
    return by_route, generic, generic_m32


def ground_truth(card: str, cov32: dict, jacobi32: dict, cusolver32: dict) -> int:
    """Eigenvalues of both solvers against fp64 host LAPACK, relative to
    max|lambda|: four GPT-2 factors of width 769/768 from the Jacobi path, and
    three seeded 500 x 500 Wishart matrices (g g^T / 500, condition ~1e6)
    solved here, by the Jacobi solver at its default block_size 32 and at 16
    (K2's generic route). The Jacobi solver is held to 5e-5, the JAX package's
    bound against LAPACK (tests/test_eigh.py); cuSOLVER's error is printed.
    Returns the generic route's launches, and its time at their most common
    launch shape (m 32): CUDA events and device time of one launch on seeded
    symmetric blocks of that shape, the plain version's time and the bound."""
    from kronfluence_tpu_torch.ops import eigh as eigh_mod
    from kronfluence_tpu_torch.ops.eigh import eigh_batched
    from kronfluence_tpu_torch.ops.kernels.jacobi import jacobi_pivot_rotations
    from kronfluence_tpu_torch.utils.constants import (
        ACTIVATION_COVARIANCE_MATRIX_NAME as ACT,
        ACTIVATION_EIGENVALUES_NAME as ACT_EVALS,
        GRADIENT_COVARIANCE_MATRIX_NAME as GRAD,
        GRADIENT_EIGENVALUES_NAME as GRAD_EVALS,
        NUM_ACTIVATION_COVARIANCE_PROCESSED as ACT_COUNT,
        NUM_GRADIENT_COVARIANCE_PROCESSED as GRAD_COUNT,
    )

    def rel(got, a):
        ref = np.linalg.eigh(a.double().cpu().numpy())[0]
        return float(np.abs(got.double().cpu().numpy() - ref).max() / np.abs(ref).max())

    rows = []
    for cov_name, count_name, eval_name, name in (
        (ACT, ACT_COUNT, ACT_EVALS, "h_0/attn/c_attn"),
        (ACT, ACT_COUNT, ACT_EVALS, "h_11/mlp/c_fc"),
        (GRAD, GRAD_COUNT, GRAD_EVALS, "h_0/attn/c_proj"),
        (GRAD, GRAD_COUNT, GRAD_EVALS, "h_11/mlp/c_proj"),
    ):
        a = cov32[cov_name][name] / cov32[count_name][name].float().reshape(())
        a = 0.5 * (a + a.T)
        rows.append((f"{name} {cov_name.split('_')[0]} {a.shape[0]}",
                     rel(jacobi32[eval_name][name], a), rel(cusolver32[eval_name][name], a)))
    g = np.random.default_rng(0).standard_normal((3, 500, 500)).astype(np.float32)
    wishart = torch.from_numpy(g @ g.transpose(0, 2, 1) / 500).cuda()
    jac, cus = eigh_batched(wishart)[0], torch.linalg.eigh(wishart)[0]
    # block_size 16: 32 x 32 pivot blocks, K2's generic route.
    jacobi_pivot_rotations.registers_launches = jacobi_pivot_rotations.generic_launches = 0
    eigh_batched.chunks.clear()
    shapes = {}

    def recording(s, sweeps, *rest):
        key = (*s.shape, sweeps)
        shapes[key] = shapes.get(key, 0) + 1
        return jacobi_pivot_rotations(s, sweeps, *rest)

    eigh_mod.jacobi_pivot_rotations = recording
    try:
        jac16 = eigh_batched(wishart, block_size=16)[0]
    finally:
        eigh_mod.jacobi_pivot_rotations = jacobi_pivot_rotations
    torch.cuda.synchronize()
    generic = jacobi_pivot_rotations.generic_launches
    want = sum(c["sweeps"] * c["rounds_per_sweep"] for c in eigh_batched.chunks)
    for i in range(3):
        rows.append((f"Wishart 500 #{i}", rel(jac[i], wishart[i]), rel(cus[i], wishart[i])))
        rows.append((f"Wishart 500 #{i} block_size 16", rel(jac16[i], wishart[i]), rel(cus[i], wishart[i])))
    log("eigenvalues vs fp64 host LAPACK, max |dlambda| / max |lambda|: " + "; ".join(
        f"{label}: jacobi {j:.2e}, cuSOLVER {c:.2e}" for label, j, c in rows) + f" [{card}]")
    log(f"block_size 16 on the Wishart matrices: K2 launches {generic} on the generic route (want "
        f"{want}), {jacobi_pivot_rotations.registers_launches} on the register route (want 0)")
    bad = [label for label, j, _ in rows if not j <= 5e-5]
    if bad:
        raise RuntimeError(f"the Jacobi solver is off fp64 LAPACK by more than 5e-5 on {bad}")
    if generic != want or generic == 0 or jacobi_pivot_rotations.registers_launches:
        raise RuntimeError("block_size 16 did not run every K2 launch on the generic route")
    from kronfluence_tpu_torch.ops.kernels.jacobi import jacobi_pivot_rotations_reference

    (y, m, _, sweeps), count = max(shapes.items(), key=lambda kv: kv[1])
    blocks = sym_blocks(y, m, seed=y * m + sweeps)
    rounds = sweeps * (m - 1)
    bound, bound_by = roofline(2 * y * m * m * 4, 9.0 * m * m * rounds * y, FP32_FLOPS)
    timing = dict(shape=f"Y{y} m{m} sweeps{sweeps}", launches_at_shape=count,
                  launch_shapes={f"Y{a} m{b} sweeps{c}": n for (a, b, _, c), n in shapes.items()},
                  ms=median_ms(lambda: jacobi_pivot_rotations(blocks, sweeps)),
                  device_ms=device_ms(lambda: jacobi_pivot_rotations(blocks, sweeps), ["jacobi_kernel"]),
                  plain_ms=median_ms(lambda: jacobi_pivot_rotations_reference(blocks, sweeps), 5, 1),
                  bound_ms=bound, bound_by=bound_by)
    log(f"K2 generic route at phase 8's launch shape {timing['shape']} ({count} of its {generic} "
        f"launches; shapes {timing['launch_shapes']}): {timing['ms']:.4f} ms by CUDA events, device "
        f"{timing['device_ms']:.4f} ms, plain {timing['plain_ms']:.3f} ms, bound "
        f"{bound:.4f} ms ({bound_by}) [{card}]")
    return generic, timing


def phase_flash_path(card: str, ctx: dict) -> dict:
    """Phase 5's model, weights, data and factor recipe with attention="flash",
    scored with fp8 query blocks and the auto-sized block."""
    from kronfluence_tpu_torch.factor.covariance import fit_covariance_matrices_with_loader
    from kronfluence_tpu_torch.factor.eigen import fit_lambda_matrices_with_loader
    from kronfluence_tpu_torch.models.transformer import gpt2_small, init_transformer
    from kronfluence_tpu_torch.ops.attention import naive_attention
    from kronfluence_tpu_torch.ops.kernels.jacobi import jacobi_pivot_rotations
    from kronfluence_tpu_torch.ops.kernels.probe import probe
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk
    from kronfluence_tpu_torch.prepare import prepare_model
    from kronfluence_tpu_torch.score.pairwise import compute_pairwise_scores_with_loaders
    from kronfluence_tpu_torch.utils.constants import (
        ACTIVATION_COVARIANCE_MATRIX_NAME,
        ALL_MODULE_NAME,
        GRADIENT_COVARIANCE_MATRIX_NAME,
    )
    from kronfluence_tpu_torch.utils.dataset import BatchLoader

    device, task, data = ctx["device"], ctx["task"], ctx["data"]
    config = gpt2_small(max_seq_len=SEQ, dtype=torch.bfloat16, attention="flash")
    model = prepare_model(init_transformer(config, seed=0, device=device), task)
    same = all(torch.equal(a, b) for a, b in zip(model.module.state_dict().values(),
                                                 ctx["model"].module.state_dict().values()))
    if not same:
        raise RuntimeError("the flash path's seed-0 weights differ from phase 5's")
    score_args = copy.deepcopy(ctx["score_args"])
    score_args.query_gradient_storage_dtype = "float8_e4m3fn"
    score_args.query_gradient_accumulation_steps = None

    kernels = flash_kernels()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in (*kernels.values(), syrk, probe, jacobi_pivot_rotations):
        fn.launches = 0
    syrk.wgmma_launches = 0
    naive_attention.calls = 0
    cov, eigen, lam, scores, seconds = run_slice(
        model, task, data, ctx["factor_args"], score_args, device,
        (COV_BATCH, LAMBDA_BATCH, QUERY_BATCH, TRAIN_BATCH),
    )
    launches = {name: fn.launches for name, fn in kernels.items()}
    launches.update(syrk=syrk.launches, probe=probe.launches, jacobi=jacobi_pivot_rotations.launches)
    wgmma_launches = syrk.wgmma_launches
    naive_calls = naive_attention.calls
    peak = torch.cuda.max_memory_allocated() / 2**30
    run = compute_pairwise_scores_with_loaders.last_run

    # Model passes, from the loaders: a forward+backward per covariance and
    # lambda batch, per query batch, and per train batch of every query
    # block; a forward alone for each stage's module discovery (covariance,
    # lambda, pairwise) and two for the block sizer (its module probe and,
    # on the card, its probe of what autograd keeps).
    cov_b, lam_b = -(-COV_N // COV_BATCH), -(-LAMBDA_N // LAMBDA_BATCH)
    query_b, train_b = -(-QUERY_N // QUERY_BATCH), -(-TRAIN_N // TRAIN_BATCH)
    passes = cov_b + lam_b + query_b + run["blocks"] * train_b
    forwards_only = 3 + 2
    layers = config.num_layers
    # bf16 at head_dim 64: the forward takes FF, the backward FB; F1, F2, F3,
    # FFH, FFW, FFS, FFS64, F2H, F3H, F2W, F3W, F2S, F3S, F2SH, F3SH, F2SW and
    # F3SW never.
    want = {"F1": 0, "F2": 0, "F3": 0, "FF": layers * (passes + forwards_only),
            "FB": layers * passes, "FFH": 0, "FFW": 0, "FFS": 0, "FFS64": 0, "F2H": 0, "F3H": 0,
            "F2W": 0,
            "F3W": 0,
            "F2S": 0, "F3S": 0, "F2SH": 0, "F3SH": 0, "F2SW": 0, "F3SW": 0}
    log(f"flash path stage seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
        + f"; peak device memory {peak:.2f} GiB; phase 5 (naive, bf16 dense blocks, "
        f"{QUERY_ACC} accumulation steps): " + ", ".join(
            f"{k} {v:.3f}" for k, v in ctx["seconds"].items()) + f"; peak {ctx['peak']:.2f} GiB [{card}]")
    log(f"flash path: query_gradient_accumulation_steps=None resolved to {run['accumulation']} "
        f"({run['blocks']} block(s) of {QUERY_N} queries); block formats {run['formats']}")
    log(f"flash path kernel launches: " + ", ".join(f"{k} {v}" for k, v in launches.items())
        + f"; want FF {want['FF']} (12 x ({passes} forward+backward passes + {forwards_only} "
        f"forwards)), FB {want['FB']}, the other flash kernels 0; naive attention calls {naive_calls}; syrk on "
        f"the wgmma kernel {wgmma_launches} (want {36 * cov_b})")
    for name in kernels:
        if launches[name] != want[name]:
            raise RuntimeError(f"{name} launched {launches[name]} times, want {want[name]}")
    if naive_calls:
        raise RuntimeError(f"the flash path ran the naive form {naive_calls} times")
    if not launches["syrk"] == wgmma_launches == 36 * cov_b:
        raise RuntimeError(f"K1 launches off on the flash path: {launches['syrk']}, "
                           f"{wgmma_launches} on the wgmma kernel; want {36 * cov_b}, all wgmma")
    if launches["probe"] < 1 or launches["jacobi"]:
        raise RuntimeError(f"K2/K3 launches off on the flash path: {launches}")
    if run["formats"] != ["QuantizedGradient[torch.float8_e4m3fn]"]:
        raise RuntimeError(f"the query blocks are not fp8: {run['formats']}")
    if run["accumulation"] != query_b:
        raise RuntimeError(f"the sizer resolved {run['accumulation']} steps; 80 GB holds all "
                           f"{query_b} query batches")
    check_artifacts(cov, eigen, lam, scores, COV_N * SEQ, LAMBDA_N, (QUERY_N, TRAIN_N))

    factor_gap = 0.0
    for factor_name in (ACTIVATION_COVARIANCE_MATRIX_NAME, GRADIENT_COVARIANCE_MATRIX_NAME):
        factor_gap = max(factor_gap, _max_rel(cov[factor_name], ctx["cov"][factor_name]))
    s_f = scores[ALL_MODULE_NAME].float().flatten()
    s_n = ctx["scores"][ALL_MODULE_NAME].float().flatten()
    pearson = float(torch.corrcoef(torch.stack([s_f, s_n]))[0, 1])
    log(f"flash path vs phase 5: covariance factors max |flash - naive| / max |naive| "
        f"{factor_gap:.3e} (limit {FLASH_FACTOR_RTOL:g}); scores finite, Pearson r against "
        f"phase 5's bf16 scores {pearson:.6f} (limit {FLASH_PEARSON_MIN})")
    if not factor_gap <= FLASH_FACTOR_RTOL:
        raise RuntimeError(f"flash path covariance factors off phase 5's: {factor_gap:.3e}")
    if not pearson >= FLASH_PEARSON_MIN:
        raise RuntimeError(f"flash path scores correlate with phase 5's at r {pearson:.4f}")

    # The covariance and lambda stages in turns on the same data and
    # eigenbasis, the naive model and the flash model (FF and FB): naive,
    # flash, flash, naive. Phase 5 ran first in the process, so its stage
    # seconds above are not a like-for-like comparison.
    forms = ("naive", "flash")
    turns = {form: {"covariance": [], "lambda": []} for form in forms}
    for form in ("naive", "flash", "flash", "naive"):
        m_ = ctx["model"] if form == "naive" else model
        _, sec = _stage(fit_covariance_matrices_with_loader, m_, task,
                        BatchLoader(data["cov"], COV_BATCH, device=device), ctx["factor_args"])
        turns[form]["covariance"].append(sec)
        _, sec = _stage(fit_lambda_matrices_with_loader, m_, task,
                        BatchLoader(data["lambda"], LAMBDA_BATCH, device=device),
                        ctx["factor_args"], eigen)
        turns[form]["lambda"].append(sec)
    log("stage seconds in turns (naive, flash, flash, naive): " + "; ".join(f"{stage} " + ", ".join(
            f"{form} {turns[form][stage][0]:.4f}/{turns[form][stage][1]:.4f}" for form in forms)
            for stage in ("covariance", "lambda")) + f" [{card}]")
    # Phase 19 holds the scanned form against these, then drops them.
    ctx["flash_path"] = dict(model=model, cov=cov, eigen=eigen, lam=lam, scores=scores,
                             seconds=seconds,
                             peak=peak, launches=launches, score_args=score_args,
                             turns={stage: turns["flash"][stage] for stage in ("covariance",
                                                                                "lambda")})
    return launches


def artifact_bytes(root: Path) -> dict:
    """Bytes on disk under `root`, by stage: the factor files of each stage
    (partition-free names), the score files, and everything else (arguments,
    metadata, profiler tables)."""
    from kronfluence_tpu_torch.utils.constants import (
        COVARIANCE_FACTOR_NAMES,
        EIGENDECOMPOSITION_FACTOR_NAMES,
        LAMBDA_FACTOR_NAMES,
    )

    groups = {"covariance": COVARIANCE_FACTOR_NAMES,
              "eigendecomposition": EIGENDECOMPOSITION_FACTOR_NAMES,
              "lambda": LAMBDA_FACTOR_NAMES}
    out = {key: 0 for key in (*groups, "scores", "other")}
    for path in root.rglob("*"):
        if not path.is_file():
            continue
        key = next((g for g, names in groups.items() if path.stem in names), None)
        if key is None:
            key = "scores" if path.name.endswith("scores.safetensors") else "other"
        out[key] += path.stat().st_size
    return out


def mount_of(path: Path) -> str:
    """The mount point and file system type that hold `path` (/proc/self/mounts)."""
    best = ("", "unknown")
    for line in Path("/proc/self/mounts").read_text().splitlines():
        fields = line.split()
        mount, fstype = fields[1], fields[2]
        if str(path).startswith(mount.rstrip("/") + "/") and len(mount) > len(best[0]):
            best = (mount, fstype)
    return f"{best[0]} ({best[1]})"


def check_analyzer_launches(launches: dict, wgmma: int, naive_calls: int, cov_batches: int) -> None:
    """Phase 12's kernel launches: K1 36 times a covariance batch, all on the
    wgmma kernel, K3 at least once, K2 and the flash kernels never (naive
    attention, the cuSOLVER eigendecomposition)."""
    want = SYRK_LAUNCHES_PER_COV_BATCH * cov_batches
    if not launches["syrk"] == wgmma == want:
        raise RuntimeError(f"K1 launched {launches['syrk']} times through the Analyzer, {wgmma} "
                           f"on the wgmma kernel; want {want}, all wgmma")
    if launches["probe"] < 1:
        raise RuntimeError("K3 was not launched through the Analyzer")
    others = {k: v for k, v in launches.items() if k not in ("syrk", "probe") and v}
    if others or naive_calls == 0:
        raise RuntimeError(f"the Analyzer path launched {others} or never ran the naive form")


def phase_analyzer(card: str, ctx: dict, root: Path) -> tuple:
    """Phase 5's model, recipe and data through the public entry point:
    `Analyzer.fit_all_factors`, `compute_pairwise_scores` and
    `compute_self_scores`, every artifact written to and read back from disk
    under `root`, then the same calls again on the finished directory
    (resume). Its artifacts stay under `root` for phase 14. Returns the
    launches."""
    from kronfluence_tpu_torch import Analyzer
    from kronfluence_tpu_torch.factor import io as factor_io
    from kronfluence_tpu_torch.factor.eigen import fit_lambda_matrices_with_loader
    from kronfluence_tpu_torch.ops.attention import naive_attention
    from kronfluence_tpu_torch.ops.kernels.jacobi import jacobi_pivot_rotations
    from kronfluence_tpu_torch.ops.kernels.probe import probe
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk
    from kronfluence_tpu_torch.score.pairwise import compute_pairwise_scores_with_loaders
    from kronfluence_tpu_torch.utils.constants import ALL_MODULE_NAME
    from kronfluence_tpu_torch.utils.dataset import BatchLoader

    model, task, data, device = ctx["model"], ctx["task"], ctx["data"], ctx["device"]
    factor_args, score_args = ctx["factor_args"], ctx["score_args"]
    kernels = dict(flash_kernels(), syrk=syrk, probe=probe, jacobi=jacobi_pivot_rotations)

    def zero_counts():
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        syrk.wgmma_launches = 0
        naive_attention.calls = 0

    def counts():
        return {name: fn.launches for name, fn in kernels.items()}

    def timed(fn, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    start = time.perf_counter()
    log(f"analyzer path: artifacts under {root}, on {mount_of(root)}")
    cov_batches = -(-COV_N // COV_BATCH)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    # The public entry point, with explicit batch sizes; it moves the
    # model to cuda:0 (where it is already).
    analyzer = Analyzer("chip_smoke", model, task, output_dir=str(root), profile=True)
    if analyzer.device != device or next(model.module.parameters()).device != device:
        raise RuntimeError(f"the Analyzer runs on {analyzer.device}, not on {device}")
    wall = {}
    _, wall["fit_all_factors"] = timed(
        analyzer.fit_all_factors, "ekfac", data["cov"], per_device_batch_size=COV_BATCH,
        factor_args=factor_args)
    _, wall["compute_pairwise_scores"] = timed(
        analyzer.compute_pairwise_scores, "pairwise", "ekfac", data["query"], data["train"],
        per_device_query_batch_size=QUERY_BATCH, per_device_train_batch_size=TRAIN_BATCH,
        score_args=score_args)
    stage_rows = {name: (sec, calls) for name, sec, calls in analyzer.profiler.rows()}
    self_args = copy.deepcopy(score_args)
    self_args.use_measurement_for_self_influence = True
    _, wall["compute_self_scores"] = timed(
        analyzer.compute_self_scores, "self", "ekfac", data["train"],
        per_device_train_batch_size=TRAIN_BATCH, score_args=self_args)
    # The train set as queries: the pairwise diagonal is each example's
    # self-influence (the task's measurement is its train loss).
    diag_args = copy.deepcopy(score_args)
    diag_args.query_gradient_accumulation_steps = TRAIN_N // QUERY_BATCH
    _, wall["compute_pairwise_scores (train x train)"] = timed(
        analyzer.compute_pairwise_scores, "train_x_train", "ekfac", data["train"],
        data["train"], per_device_query_batch_size=QUERY_BATCH,
        per_device_train_batch_size=TRAIN_BATCH, score_args=diag_args)
    launches, wgmma, naive_calls = counts(), syrk.wgmma_launches, naive_attention.calls
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"analyzer path kernel launches: " + ", ".join(f"{k} {v}" for k, v in launches.items())
        + f"; syrk on the wgmma kernel {wgmma} (want {SYRK_LAUNCHES_PER_COV_BATCH} x "
        f"{cov_batches} covariance batches = {SYRK_LAUNCHES_PER_COV_BATCH * cov_batches}, "
        f"all wgmma); naive attention calls {naive_calls}")
    check_analyzer_launches(launches, wgmma, naive_calls, cov_batches)

    sizes = artifact_bytes(root)
    log(f"analyzer path: bytes written " + ", ".join(f"{k} {v:,}" for k, v in sizes.items())
        + f"; total {sum(sizes.values()):,} [{card}]")
    stages = {
        "covariance": ("Fit Covariance", "covariance"),
        "eigendecomposition": ("Perform Eigendecomposition", "eigendecomposition"),
        "lambda": ("Fit Lambda", "lambda"),
        "pairwise": ("Compute Pairwise Score", "pairwise"),
    }
    log("analyzer path stage seconds (profiler, synchronized; the first pairwise call): "
        + ", ".join(f"{k} {stage_rows[row][0]:.3f}" for k, (row, _) in stages.items())
        + "; phase 5's stage functions: " + ", ".join(
            f"{k} {ctx['seconds'][key]:.3f}" for k, (_, key) in stages.items())
        + f"; calls: " + ", ".join(f"{k} {v:.3f}" for k, v in wall.items())
        + f"; peak device memory {peak:.2f} GiB [{card}]")
    io_rows = {name: (sec, calls) for name, sec, calls in analyzer.profiler.rows()
               if name.startswith(("Save", "Load"))}
    log("analyzer path write and load seconds (profiler; the eigendecomposition write runs on "
        "a background thread beside the lambda stage): " + ", ".join(
            f"{name} {sec:.3f} ({calls} call{'s' if calls > 1 else ''})"
            for name, (sec, calls) in io_rows.items()) + f" [{card}]")

    # Every artifact read back from disk onto the card, against phase 5's
    # in-memory results.
    fdir = analyzer.factors_output_dir("ekfac")
    cov, load_cov = timed(factor_io.load_covariance_matrices, fdir, device=device)
    eigen, load_eig = timed(factor_io.load_eigendecomposition, fdir, device=device)
    lam, load_lam = timed(factor_io.load_lambda_matrices, fdir, device=device)
    read = sizes["covariance"] + sizes["eigendecomposition"] + sizes["lambda"]
    log(f"analyzer path: factors read back onto the card in {load_cov:.3f} + {load_eig:.3f} + "
        f"{load_lam:.3f} s ({read / (load_cov + load_eig + load_lam) / 1e9:.2f} GB/s) [{card}]")
    unequal = [f"{factor} {name}" for factor, tensors in ctx["cov"].items()
               for name, t in tensors.items() if not torch.equal(cov[factor][name], t)]
    if unequal or cov.keys() != ctx["cov"].keys():
        raise RuntimeError(f"covariance read back differs from phase 5's: {unequal[:4]}")
    # The bf16 recipe stores the eigenpairs in bf16, so their
    # reconstruction is ~2^-8 off the covariance and the Jacobi path's
    # fp32 limits do not apply to them; the same cuSOLVER solve of the same
    # covariance is held bit for bit instead, with the worst gaps printed.
    eigen5 = {k: {n: t.to(device) for n, t in v.items()} for k, v in ctx["eigen_host"].items()}
    unequal = [f"{k} {n}" for k, v in eigen5.items() for n, t in v.items()
               if not torch.equal(eigen[k][n], t)]
    worst = compare_eigenpairs(_to_fp32(ctx["cov"]), _to_fp32(eigen), _to_fp32(eigen5))
    log("analyzer path vs phase 5: covariance and counts equal bit for bit; eigenpairs "
        f"unequal in {len(unequal)} tensors (bit for bit required); per matrix relative to "
        "max|lambda|: " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + " (bf16 eigenpairs)")
    if unequal or eigen.keys() != eigen5.keys():
        raise RuntimeError(f"eigenpairs read back differ from phase 5's: {unequal[:4]}")
    # fit_all_factors takes one dataset for both stages, where phase 5
    # fitted lambda on other examples: the reference lambda and scores are
    # the stage functions on phase 12's data with phase 5's covariance and
    # eigenpairs, in the same batches and order.
    ref_lam = fit_lambda_matrices_with_loader(
        model, task, BatchLoader(data["cov"], COV_BATCH, device=device), factor_args,
        eigen_factors=eigen5)
    ref_scores = compute_pairwise_scores_with_loaders(
        model, task, BatchLoader(data["query"], QUERY_BATCH, device=device),
        BatchLoader(data["train"], TRAIN_BATCH, device=device),
        {**ctx["cov"], **eigen5, **ref_lam}, factor_args, score_args)
    unequal = [f"{factor} {name}" for factor, tensors in ref_lam.items()
               for name, t in tensors.items() if not torch.equal(lam[factor][name], t)]
    scores = analyzer.load_pairwise_scores("pairwise")
    gap = float((scores[ALL_MODULE_NAME].float() - ref_scores[ALL_MODULE_NAME].float())
                .abs().max())
    log(f"analyzer path vs the stage functions: lambda and counts unequal in {len(unequal)} "
        f"tensors; pairwise scores {tuple(scores[ALL_MODULE_NAME].shape)} "
        f"{scores[ALL_MODULE_NAME].dtype} through the disk, max |disk - memory| {gap:.3e} "
        "(both required bit for bit)")
    if unequal:
        raise RuntimeError(f"lambda read back differs from the stage function's: {unequal[:4]}")
    if not torch.equal(scores[ALL_MODULE_NAME], ref_scores[ALL_MODULE_NAME]):
        raise RuntimeError(f"pairwise scores through the disk differ: {gap:.3e}")

    self_scores = analyzer.load_self_scores("self")[ALL_MODULE_NAME].float()
    if tuple(self_scores.shape) != (TRAIN_N,) or not bool(torch.isfinite(self_scores).all()):
        raise RuntimeError(f"self scores: shape {tuple(self_scores.shape)} or non-finite")
    train_x_train = analyzer.load_pairwise_scores("train_x_train")[ALL_MODULE_NAME].float()
    diagonal = torch.diagonal(train_x_train)
    scale = float(diagonal.abs().max())
    self_gap = float((self_scores - diagonal).abs().max()) / scale
    fault = float((self_scores[:-1] - torch.diagonal(train_x_train, 1)).abs().max()) / scale
    log(f"analyzer path: self scores (use_measurement_for_self_influence=True) against the "
        f"pairwise diagonal of train x train: max |self - diagonal| / max |diagonal| "
        f"{self_gap:.3e} (limit {SELF_DIAGONAL_RTOL:g}); planted fault (against the first "
        f"superdiagonal) {fault:.3e}; |self| max {float(self_scores.abs().max()):.4e}")
    if not self_gap <= SELF_DIAGONAL_RTOL:
        raise RuntimeError(f"self scores off the pairwise diagonal: {self_gap:.3e}")
    if not fault > SELF_DIAGONAL_RTOL:
        raise RuntimeError(f"the self-score check passes a planted fault: {fault:.3e}")

    # Resume: the same calls on the finished directory run no stage.
    mtimes = {p: p.stat().st_mtime_ns for p in root.rglob("*") if p.is_file()}
    zero_counts()
    _, resume_fit = timed(analyzer.fit_all_factors, "ekfac", data["cov"],
                          per_device_batch_size=COV_BATCH, factor_args=factor_args)
    _, resume_pairwise = timed(
        analyzer.compute_pairwise_scores, "pairwise", "ekfac", data["query"], data["train"],
        per_device_query_batch_size=QUERY_BATCH, per_device_train_batch_size=TRAIN_BATCH,
        score_args=score_args)
    resumed = counts()
    touched = mtimes != {p: p.stat().st_mtime_ns for p in root.rglob("*") if p.is_file()}
    log(f"analyzer path resume: fit_all_factors {resume_fit:.3f} s (it reads the "
        f"eigendecomposition back), compute_pairwise_scores {resume_pairwise:.3f} s; "
        f"launches " + ", ".join(f"{k} {v}" for k, v in resumed.items())
        + f"; files changed: {touched} [{card}]")
    if any(resumed.values()) or touched:
        raise RuntimeError(f"the resume ran a stage or wrote a file: {resumed}, {touched}")
    log(f"analyzer path: phase 12 took {time.perf_counter() - start:.1f} s [{card}]")
    return launches, wgmma


def peak_of(fn, *args, **kwargs):
    """(result, peak device bytes, seconds) of one call, the peak counter
    reset just before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated(), time.perf_counter() - t0


def _max_rel_all(got: dict, want: dict, names) -> float:
    return max(_max_rel(got[name], want[name]) for name in names)


def _bitwise(got: dict, want: dict, names) -> bool:
    return all(torch.equal(got[f][m].cpu(), want[f][m].cpu()) for f in names for m in want[f])


def stage_options_estimates(card: str, ctx: dict, analyzer, kernels: dict) -> dict:
    """Phase 13 (a): covariance and lambda (fit_all_factors), pairwise and
    self scores with every batch size left to the memory model, each stage's
    planned bytes beside its budget and its measured peak; then covariance
    again at batch 16."""
    from kronfluence_tpu_torch.factor.covariance import fit_covariance_matrices_with_loader
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk
    from kronfluence_tpu_torch.utils.constants import COVARIANCE_FACTOR_NAMES
    from kronfluence_tpu_torch.utils.dataset import BatchLoader

    model, task, device = ctx["model"], ctx["task"], ctx["device"]
    vocab = model.module.config.vocab_size
    data = make_tokens(OPTIONS_N, SEQ, vocab, 11, device)
    query = make_tokens(QUERY_N, SEQ, vocab, 5, device)
    factor_args, score_args = ctx["factor_args"], copy.deepcopy(ctx["score_args"])
    estimates, rows = {}, []

    def run(stage, fn, *args, **kwargs):
        for k in kernels.values():
            k.launches = 0
        analyzer.last_batch_estimate = None
        _, peak, sec = peak_of(fn, *args, **kwargs)
        est = dict(analyzer.last_batch_estimate, peak_bytes=peak, seconds=sec,
                   syrk=syrk.launches, probe=kernels["probe"].launches)
        planned = est["static_bytes"] + est["reserved_bytes"] + est["batch_size"] * (
            est["per_example_bytes"] + est["untracked_bytes"] + est["precondition_bytes"])
        jax_only = max(1, min(est["attempt"], int(
            (est["budget_bytes"] - est["static_bytes"]) // est["per_example_bytes"])))
        est.update(planned_bytes=planned, jax_model_batch=jax_only)
        estimates[stage] = est
        rows.append(f"{stage}: batch {est['batch_size']} (JAX's terms alone {jax_only}), "
                    f"planned {planned / 2**30:.3f} GiB = static {est['static_bytes'] / 2**30:.3f}"
                    f" + reserved {est['reserved_bytes'] / 2**30:.3f} + {est['batch_size']} x "
                    f"({est['per_example_bytes'] / 2**20:.1f} + autograd "
                    f"{est['untracked_bytes'] / 2**20:.1f} + precondition "
                    f"{est['precondition_bytes'] / 2**20:.1f} MiB), budget "
                    f"{est['budget_bytes'] / 2**30:.3f} GiB, measured peak {peak / 2**30:.3f} GiB, "
                    f"{sec:.3f} s")
        return est

    # fit_all_factors estimates covariance and lambda separately: the
    # profiler rows give each stage's seconds, the peaks come from running
    # the stages one by one with the same arguments.
    run("covariance", analyzer.fit_covariance_matrices, "est", data, factor_args=factor_args)
    cov_batches = -(-OPTIONS_N // estimates["covariance"]["batch_size"])
    eigen = analyzer.perform_eigendecomposition("est", factor_args=factor_args,
                                                return_in_memory=True)
    run("lambda", analyzer.fit_lambda_matrices, "est", data, factor_args=factor_args,
        eigen_factors=eigen)
    del eigen
    run("pairwise", analyzer.compute_pairwise_scores, "est", "est", query, data,
        per_device_query_batch_size=QUERY_BATCH, score_args=score_args)
    run("self", analyzer.compute_self_scores, "est_self", "est", data, score_args=score_args,
        train_indices=np.arange(OPTIONS_SELF_N))
    for row in rows:
        log(f"stage options (a) estimated batch, {row} [{card}]")
    for stage, est in estimates.items():
        if not est["batch_size"] < est["attempt"]:
            raise RuntimeError(f"{stage}: the data ({est['attempt']} examples) set the batch, "
                               "not the estimate")
        if not est["peak_bytes"] <= est["budget_bytes"]:
            raise RuntimeError(f"{stage}: measured peak {est['peak_bytes']:,} B over the budget "
                               f"{est['budget_bytes']:,.0f} B")
    want = SYRK_LAUNCHES_PER_COV_BATCH * cov_batches
    if estimates["covariance"]["syrk"] != want:
        raise RuntimeError(f"K1 launched {estimates['covariance']['syrk']} times in the estimated "
                           f"covariance fit; want {want}")
    # The covariance estimate under remat, beside the one without.
    remat_args = copy.deepcopy(factor_args)
    remat_args.offload_activations_to_cpu = True
    analyzer._find_executable_batch_size(data, OPTIONS_N, 4096, stage="covariance",
                                         factor_args=remat_args)
    remat_est = dict(analyzer.last_batch_estimate)
    estimates["covariance"]["remat"] = remat_est
    log(f"stage options (a): the covariance batch under remat {remat_est['batch_size']} "
        f"({remat_est['per_example_bytes'] / 2**20:.1f} + autograd "
        f"{remat_est['untracked_bytes'] / 2**20:.1f} MiB an example) against "
        f"{estimates['covariance']['batch_size']} without [{card}]")
    # What the port's terms are for: the covariance at the batch the JAX
    # package's terms alone would pick (measured, not checked).
    def fit(batch, args):  # the stage function: no artifacts written
        return fit_covariance_matrices_with_loader(
            model, task, BatchLoader(data, batch, device=device), args)

    cov_est = estimates["covariance"]
    _, jax_peak, _ = peak_of(fit, cov_est["jax_model_batch"], factor_args)
    log(f"stage options (a): covariance at the batch JAX's terms alone pick, "
        f"{cov_est['jax_model_batch']}: measured peak {jax_peak / 2**30:.3f} GiB against the "
        f"budget {cov_est['budget_bytes'] / 2**30:.3f} GiB [{card}]")
    cov_est["jax_model_peak_bytes"] = jax_peak

    # The recipe's covariance at batch 16, for K1's count and beside the
    # estimated batch's. The two differ by more than the order of fp32 sums:
    # the bf16 forward is not batch-invariant on the card (cuBLAS takes other
    # kernels at other row counts, and a bf16 output rounds differently when
    # its fp32 sum does), and the recipe stores bf16 covariances. So the
    # limit holds the fp32 model (amp_dtype float32) summed in fp64, where
    # only the fp32 forward's GEMM order and the fp64 sums' order differ.
    for k in kernels.values():
        k.launches = 0
    recipe_16 = fit(COV_BATCH, factor_args)
    want16 = SYRK_LAUNCHES_PER_COV_BATCH * -(-OPTIONS_N // COV_BATCH)
    if syrk.launches != want16:
        raise RuntimeError(f"K1 launched {syrk.launches} times at batch {COV_BATCH}; want {want16}")
    est_batch = estimates["covariance"]["batch_size"]
    pairs = {"recipe": (analyzer.load_covariance_matrices("est"),
                        {k: {n: t.cpu() for n, t in v.items()} for k, v in recipe_16.items()})}
    exact = copy.deepcopy(factor_args)
    exact.amp_dtype = "float32"
    exact.activation_covariance_dtype = exact.gradient_covariance_dtype = "float64"
    pairs["fp32"] = (fit(est_batch, exact), fit(COV_BATCH, exact))
    gaps = {}
    for key, (est_cov, b16_cov) in pairs.items():
        gaps[key] = _max_rel_all(est_cov, b16_cov, COVARIANCE_FACTOR_NAMES[:2])
        if not all(torch.equal(est_cov[f][m], b16_cov[f][m])
                   for f in COVARIANCE_FACTOR_NAMES[2:] for m in b16_cov[f]):
            raise RuntimeError(f"the covariance counts change with the batch size ({key})")
    log(f"stage options (a): covariance at the estimated batch {est_batch} ({cov_batches} "
        f"batches, K1 {estimates['covariance']['syrk']} launches) against batch {COV_BATCH} "
        f"(K1 {want16}), counts equal: max |diff| / max |C| of the fp32 model summed in fp64 "
        f"{gaps['fp32']:.3e} (limit {OPTIONS_BATCH_RTOL:g}); of the bf16 recipe {gaps['recipe']:.3e} "
        f"[{card}]")
    if not gaps["fp32"] <= OPTIONS_BATCH_RTOL:
        raise RuntimeError(f"covariance differs with the batch size: {gaps['fp32']:.3e}")
    estimates["covariance"]["batch_gaps"] = gaps
    return estimates


def stage_options_remat(card: str, ctx: dict, analyzer, kernels: dict) -> dict:
    """Phase 13 (b): every stage with offload_activations_to_cpu=True (the
    rematerialisation) and without, on phase 5's data at batch 16; sampled
    lambda both ways; one covariance on the flash path both ways."""
    from kronfluence_tpu_torch.factor.covariance import fit_covariance_matrices_with_loader
    from kronfluence_tpu_torch.models.transformer import gpt2_small, init_transformer
    from kronfluence_tpu_torch.prepare import prepare_model
    from kronfluence_tpu_torch.utils.constants import (
        ALL_MODULE_NAME,
        COVARIANCE_FACTOR_NAMES,
        LAMBDA_FACTOR_NAMES,
    )
    from kronfluence_tpu_torch.utils.dataset import BatchLoader

    device, task, data = ctx["device"], ctx["task"], ctx["data"]
    out, peaks, seconds, gaps, bitwise = {}, {}, {}, {}, {}
    eigen = None
    for remat in (False, True):
        fargs = copy.deepcopy(ctx["factor_args"])
        sargs = copy.deepcopy(ctx["score_args"])
        fargs.offload_activations_to_cpu = sargs.offload_activations_to_cpu = remat
        name = "remat" if remat else "plain"
        res = {}

        def measured(stage, fn, *args, **kwargs):
            _, peaks[name, stage], seconds[name, stage] = peak_of(fn, *args, **kwargs)

        measured("covariance", analyzer.fit_covariance_matrices, name, data["cov"],
                 per_device_batch_size=COV_BATCH, factor_args=fargs)
        if eigen is None:  # both runs' lambda and scores in the first run's eigenbasis
            eigen = analyzer.perform_eigendecomposition(name, factor_args=fargs,
                                                        return_in_memory=True)
        measured("lambda", analyzer.fit_lambda_matrices, name, data["cov"],
                 per_device_batch_size=COV_BATCH, factor_args=fargs, eigen_factors=eigen)
        measured("pairwise", analyzer.compute_pairwise_scores, name, "plain", data["query"],
                 data["train"], per_device_query_batch_size=QUERY_BATCH,
                 per_device_train_batch_size=TRAIN_BATCH, score_args=sargs)
        measured("self", analyzer.compute_self_scores, name + "_self", "plain", data["train"],
                 per_device_train_batch_size=TRAIN_BATCH, score_args=sargs)
        # The sampled Fisher: labels drawn from the stage's explicit generator.
        sampled = copy.deepcopy(fargs)
        sampled.use_empirical_fisher = False
        analyzer.fit_lambda_matrices(name + "_sampled", data["cov"],
                                     per_device_batch_size=COV_BATCH, factor_args=sampled,
                                     eigen_factors=eigen)
        res["covariance"] = analyzer.load_covariance_matrices(name)
        res["lambda"] = analyzer.load_lambda_matrices(name)
        res["sampled"] = analyzer.load_lambda_matrices(name + "_sampled")
        res["pairwise"] = analyzer.load_pairwise_scores(name)
        res["self"] = analyzer.load_self_scores(name + "_self")
        out[name] = res
    del eigen
    plain, remat = out["plain"], out["remat"]
    for key, names in (("covariance", COVARIANCE_FACTOR_NAMES[:2]),
                       ("lambda", LAMBDA_FACTOR_NAMES[:1]), ("sampled", LAMBDA_FACTOR_NAMES[:1])):
        gaps[key] = _max_rel_all(remat[key], plain[key], names)
        bitwise[key] = _bitwise(remat[key], plain[key], plain[key])
    for key in ("pairwise", "self"):
        gaps[key] = _max_rel({ALL_MODULE_NAME: remat[key][ALL_MODULE_NAME]},
                             {ALL_MODULE_NAME: plain[key][ALL_MODULE_NAME]})
        bitwise[key] = torch.equal(remat[key][ALL_MODULE_NAME], plain[key][ALL_MODULE_NAME])
    log("stage options (b) remat against none, max |diff| / max |plain| (limit "
        f"{REMAT_RTOL:g}): " + ", ".join(f"{k} {v:.3e} (bitwise {bitwise[k]})"
                                         for k, v in gaps.items()))
    log("stage options (b) peak device memory and seconds of the Analyzer calls (their artifact "
        "writes included), remat against none: " + ", ".join(
        f"{stage} {peaks['remat', stage] / 2**30:.3f} / {peaks['plain', stage] / 2**30:.3f} GiB, "
        f"{seconds['remat', stage]:.3f} / {seconds['plain', stage]:.3f} s"
        for stage in ("covariance", "lambda", "pairwise", "self")) + f" [{card}]")
    for key, gap in gaps.items():
        if not gap <= REMAT_RTOL:
            raise RuntimeError(f"remat changes {key}: {gap:.3e}")
    for stage in ("covariance", "lambda", "pairwise", "self"):
        if not peaks["remat", stage] < peaks["plain", stage]:
            raise RuntimeError(f"remat does not lower the {stage} stage's peak: "
                               f"{peaks['remat', stage]:,} >= {peaks['plain', stage]:,}")

    # The stage alone, without the Analyzer's artifact writes, warm and in
    # turns: what the recompute costs.
    warm = {}
    for remat in (True, False, False, True):
        fargs = copy.deepcopy(ctx["factor_args"])
        fargs.offload_activations_to_cpu = remat
        _, _, sec = peak_of(fit_covariance_matrices_with_loader, ctx["model"], task,
                            BatchLoader(data["cov"], COV_BATCH, device=device), fargs)
        warm.setdefault(remat, []).append(sec)
    log(f"stage options (b) covariance stage function in turns (remat, none, none, remat): "
        f"remat {warm[True][0]:.3f} / {warm[True][1]:.3f} s, none {warm[False][0]:.3f} / "
        f"{warm[False][1]:.3f} s [{card}]")

    # One covariance on the flash path (FF, FB) with remat and without.
    config = gpt2_small(max_seq_len=SEQ, dtype=torch.bfloat16, attention="flash")
    flash = prepare_model(init_transformer(config, seed=0, device=device), task)
    flash_cov, ff = {}, {}
    batches = -(-COV_N // COV_BATCH)
    for remat in (False, True):
        fargs = copy.deepcopy(ctx["factor_args"])
        fargs.offload_activations_to_cpu = remat
        for k in kernels.values():
            k.launches = 0
        flash_cov[remat] = fit_covariance_matrices_with_loader(
            flash, task, BatchLoader(data["cov"], COV_BATCH, device=device), fargs)
        torch.cuda.synchronize()
        ff[remat] = (kernels["FF"].launches, kernels["FB"].launches)
    del flash
    flash_gap = _max_rel_all(flash_cov[True], flash_cov[False], COVARIANCE_FACTOR_NAMES[:2])
    # One more forward a pass under remat: the recompute of each attention.
    want_ff = ff[False][0] + config.num_layers * batches
    log(f"stage options (b) flash path covariance, remat against none: max |diff| / max |C| "
        f"{flash_gap:.3e} (limit {FLASH_FACTOR_RTOL:g}); FF launches {ff[True][0]} against "
        f"{ff[False][0]} (want {want_ff}: 12 more a pass, the recompute), FB {ff[True][1]} "
        f"against {ff[False][1]}")
    if not flash_gap <= FLASH_FACTOR_RTOL:
        raise RuntimeError(f"remat changes the flash path's covariance: {flash_gap:.3e}")
    if ff[True][0] != want_ff or ff[True][1] != ff[False][1] or ff[False][1] == 0:
        raise RuntimeError(f"flash launches under remat {ff[True]}, without {ff[False]}")
    return dict(peaks={f"{k[1]}_{k[0]}": v for k, v in peaks.items()}, gaps=gaps,
                FF=ff[True][0], FB=ff[True][1], plain_covariance=plain["covariance"],
                plain_lambda=plain["lambda"])


def stage_options_fp16(card: str, ctx: dict, analyzer, kernels: dict, remat: dict) -> dict:
    """Phase 13 (c): covariance and lambda under fp16 autocast with loss
    scaling, against the bf16 factors; one covariance with fp16 covariance
    dtypes, whose operands reach K1 in fp16."""
    from kronfluence_tpu_torch.ops import covariance as covariance_ops
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk, syrk_reference
    from kronfluence_tpu_torch.utils.constants import (
        COVARIANCE_FACTOR_NAMES,
        LAMBDA_FACTOR_NAMES,
    )

    data = ctx["data"]
    fargs = copy.deepcopy(ctx["factor_args"])
    fargs.amp_dtype, fargs.amp_scale = "float16", 2.0 ** 10
    analyzer.fit_covariance_matrices("fp16", data["cov"], per_device_batch_size=COV_BATCH,
                                     factor_args=fargs)
    # Lambda in the bf16 run's eigenbasis, so the two are comparable entry by entry.
    analyzer.fit_lambda_matrices("fp16", data["cov"], per_device_batch_size=COV_BATCH,
                                 factor_args=fargs, load_from_factors_name="plain")
    cov16 = analyzer.load_covariance_matrices("fp16")
    lam16 = analyzer.load_lambda_matrices("fp16")
    finite = all(bool(torch.isfinite(t.float()).all()) for group in (cov16, lam16)
                 for per in group.values() for t in per.values())
    cov_gap = _max_rel_all(cov16, {k: {n: t.cpu() for n, t in v.items()}
                                   for k, v in ctx["cov"].items()}, COVARIANCE_FACTOR_NAMES[:2])
    lam_gap = _max_rel_all(lam16, remat["plain_lambda"], LAMBDA_FACTOR_NAMES[:1])

    # fp16 covariance dtypes: record one K1 operand of each width as it is
    # launched, then hold the kernel against its plain version on it.
    f16 = copy.deepcopy(fargs)
    f16.activation_covariance_dtype = f16.gradient_covariance_dtype = "float16"
    seen = {}
    real = covariance_ops.syrk

    def recording(flat, accum_dtype=torch.float32):
        if flat.dtype == torch.float16:
            seen.setdefault(flat.shape[1], flat.clone())
        return real(flat, accum_dtype)

    for k in kernels.values():
        k.launches = 0
    syrk.f16_launches = 0
    covariance_ops.syrk = recording
    try:
        analyzer.fit_covariance_matrices("fp16_dtypes", data["cov"],
                                         per_device_batch_size=COV_BATCH, factor_args=f16)
    finally:
        covariance_ops.syrk = real
    launches, f16_launches = syrk.launches, syrk.f16_launches
    want = SYRK_LAUNCHES_PER_COV_BATCH * -(-COV_N // COV_BATCH)
    cov16d = analyzer.load_covariance_matrices("fp16_dtypes")
    finite16 = all(bool(torch.isfinite(t.float()).all()) for per in cov16d.values()
                   for t in per.values())
    errs = {}
    for n, flat in sorted(seen.items()):
        got, ref = syrk(flat), syrk_reference(flat, torch.float32)
        errs[n] = float(((got - ref).abs() - SYRK_RTOL * ref.abs()).max() / ref.abs().max())
    log(f"stage options (c) fp16 autocast with loss scale 2^10: factors finite {finite}; "
        f"covariance against phase 5's bf16 max |diff| / max |C| {cov_gap:.3e}, lambda against "
        f"the bf16 lambda in the same eigenbasis {lam_gap:.3e} (limit {FLASH_FACTOR_RTOL:g}); "
        f"fp16 covariance dtypes: K1 launches {launches} (want {want}), {f16_launches} on fp16 "
        f"operands, fp16 factors finite {finite16}; K1 against its fp32 plain version on the recorded fp16 operands, "
        f"max (|diff| - {SYRK_RTOL:g} |plain|) / max |plain| by width: "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + f" (limit {SYRK_ATOL_SCALE:g}) [{card}]")
    if not finite:
        raise RuntimeError("fp16 autocast gave non-finite factors")
    if not cov_gap <= FLASH_FACTOR_RTOL or not lam_gap <= FLASH_FACTOR_RTOL:
        raise RuntimeError(f"fp16 factors off the bf16 ones: {cov_gap:.3e}, {lam_gap:.3e}")
    if not launches == f16_launches == want or sorted(errs) != [2304, 3072]:
        raise RuntimeError(f"K1 on fp16 operands: {launches} launches, {f16_launches} fp16, "
                           f"widths {sorted(errs)}; want {want}, all fp16, 2304 and 3072")
    if not all(e <= SYRK_ATOL_SCALE for e in errs.values()):
        raise RuntimeError(f"K1 off its plain version on fp16 operands: {errs}")
    return dict(syrk=launches, f16=f16_launches, errs=errs)


def stage_options_loader(card: str, ctx: dict, analyzer, remat: dict) -> None:
    """Phase 13 (d): the covariance of phase 5's data through a dataset of
    rows with collate_fn, a prefetch thread and drop_last."""
    from kronfluence_tpu_torch.utils.constants import COVARIANCE_FACTOR_NAMES
    from kronfluence_tpu_torch.utils.dataset import DataLoaderKwargs

    host = {k: v.cpu().numpy() for k, v in ctx["data"]["cov"].items()}
    extra = make_tokens(LOADER_N - COV_N, SEQ, ctx["model"].module.config.vocab_size, 13, "cpu")
    rows = [{k: v[i] for k, v in host.items()} for i in range(COV_N)]
    rows += [{k: v[i].numpy() for k, v in extra.items()} for i in range(LOADER_N - COV_N)]

    def collate(batch_rows):
        return {k: np.stack([r[k] for r in batch_rows]) for k in batch_rows[0]}

    kwargs = DataLoaderKwargs(collate_fn=collate, num_workers=2, drop_last=True)
    analyzer.fit_covariance_matrices("rows", rows, per_device_batch_size=COV_BATCH,
                                     dataloader_kwargs=kwargs, factor_args=ctx["factor_args"])
    got = analyzer.load_covariance_matrices("rows")
    same = _bitwise(got, remat["plain_covariance"], COVARIANCE_FACTOR_NAMES)
    log(f"stage options (d) a list of {LOADER_N} dict rows with collate_fn, num_workers 2 and "
        f"drop_last (the last {LOADER_N - COV_N} dropped): covariance and counts equal to the "
        f"column store's over the first {COV_N}, bit for bit: {same}")
    if not same:
        raise RuntimeError("the loader knobs changed the covariance")


def phase_stage_options(card: str, ctx: dict) -> dict:
    """Phase 5's model and recipe through the public Analyzer with the stage
    options: estimated batches, rematerialisation, fp16 loss scaling and the
    loader knobs. Returns each kernel's launches in the phase."""
    from kronfluence_tpu_torch import Analyzer
    from kronfluence_tpu_torch.ops.kernels.probe import probe
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk

    start = time.perf_counter()
    kernels = dict(flash_kernels(), syrk=syrk, probe=probe)
    root = Path(tempfile.mkdtemp(prefix="kf_chip_smoke_options_"))
    try:
        log(f"stage options: artifacts under {root}")
        analyzer = Analyzer("chip_smoke_options", ctx["model"], ctx["task"], output_dir=str(root))
        parts = [time.perf_counter()]
        estimates = stage_options_estimates(card, ctx, analyzer, kernels)
        parts.append(time.perf_counter())
        remat = stage_options_remat(card, ctx, analyzer, kernels)
        parts.append(time.perf_counter())
        fp16 = stage_options_fp16(card, ctx, analyzer, kernels, remat)
        parts.append(time.perf_counter())
        stage_options_loader(card, ctx, analyzer, remat)
        parts.append(time.perf_counter())
        log(f"stage options: phase 13 took {time.perf_counter() - start:.1f} s, (a) to (d) "
            + ", ".join(f"{b - a:.1f}" for a, b in zip(parts, parts[1:])) + f" s [{card}]")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # The launches of the runs whose counts phase 13 checks.
    return {
        "syrk": {"estimated_covariance": estimates["covariance"]["syrk"],
                 "fp16_covariance": fp16["syrk"]},
        "probe": {"estimated_covariance": estimates["covariance"]["probe"]},
        "FF": {"flash_covariance_remat": remat["FF"]},
        "FB": {"flash_covariance_remat": remat["FB"]},
    }


def profiled_pairwise(analyzer, name: str, query, train, query_batch: int, score_args) -> tuple:
    """(all-module scores as read back from disk, {query, train, call} seconds):
    one `compute_pairwise_scores` call, its query-gradient and train-pass
    seconds from the Analyzer's profiler regions (CUDA-synchronized)."""
    from kronfluence_tpu_torch.utils.constants import ALL_MODULE_NAME

    before = {row: sec for row, sec, _ in analyzer.profiler.rows()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    analyzer.compute_pairwise_scores(
        name, "ekfac", query, train, per_device_query_batch_size=query_batch,
        per_device_train_batch_size=TRAIN_BATCH, score_args=score_args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = {row: sec for row, sec, _ in analyzer.profiler.rows()}
    seconds = {key: after.get(row, 0.0) - before.get(row, 0.0) for key, row in (
        ("query", "Pairwise: query gradients"), ("train", "Pairwise: train pass"))}
    seconds["call"] = wall
    return analyzer.load_pairwise_scores(name)[ALL_MODULE_NAME], seconds


def pearson(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.corrcoef(torch.stack([a.double().flatten(), b.double().flatten()]))[0, 1])


def score_features_lowrank(card: str, ctx: dict, analyzer) -> dict:
    """Phase 14 (a): low-rank query blocks through the Analyzer on phase 12's
    factors, the SVD and the contraction held per module, the block's bytes
    against the memory model, the sized stage's peak, and one call on the
    flash model. Returns FF's and FB's launches in that call."""
    from kronfluence_tpu_torch import Analyzer
    from kronfluence_tpu_torch.models.transformer import gpt2_small, init_transformer
    from kronfluence_tpu_torch.ops.scores import lowrank_route, rebuild
    from kronfluence_tpu_torch.ops.svd import lowrank_factors_full, lowrank_factors_randomized
    from kronfluence_tpu_torch.prepare import prepare_model
    from kronfluence_tpu_torch.score import pairwise
    from kronfluence_tpu_torch.score.common import prepare_precondition_states
    from kronfluence_tpu_torch.utils import memory
    from kronfluence_tpu_torch.utils.constants import ALL_MODULE_NAME
    from kronfluence_tpu_torch.utils.dataset import BatchLoader

    model, task, data, device = ctx["model"], ctx["task"], ctx["data"], ctx["device"]
    factor_args, recipe = ctx["factor_args"], ctx["score_args"]
    dense = analyzer.load_pairwise_scores("pairwise")[ALL_MODULE_NAME]

    def args_with(**fields):
        args = copy.deepcopy(recipe)
        for field, value in fields.items():
            setattr(args, field, value)
        return args

    # Like-for-like stage seconds: phase 12's dense recipe and phase 10's fp8
    # recipe (sized block) again, then the low-rank calls, all 16 queries in
    # one chunk.
    calls = {
        "dense bf16 (phase 12)": (QUERY_BATCH, recipe),
        "fp8 dense, sized (phase 10)": (QUERY_BATCH, args_with(
            query_gradient_storage_dtype="float8_e4m3fn", query_gradient_accumulation_steps=None)),
        "rank 32": (QUERY_N, args_with(query_gradient_low_rank=32,
                                       query_gradient_accumulation_steps=1)),
        "rank 32 full SVD": (QUERY_N, args_with(query_gradient_low_rank=32, use_full_svd=True,
                                                query_gradient_accumulation_steps=1)),
        "rank 64": (QUERY_N, args_with(query_gradient_low_rank=64,
                                       query_gradient_accumulation_steps=1)),
    }
    # Each call's query block as the train pass received it, kept for the
    # checks below (a wrapper around the stage's block collection).
    recorded = {}
    collect = pairwise._collect_blocks

    def recording(blocks):
        out = collect(blocks)
        if current.startswith("rank"):
            recorded.setdefault(current, []).append({n: list(c) for n, c in out.items()})
        return out

    results = {}
    pairwise._collect_blocks = recording
    try:
        for i, (label, (qbs, args)) in enumerate(calls.items()):
            current = label
            scores, sec = profiled_pairwise(analyzer, f"features_{i}", data["query"],
                                            data["train"], qbs, args)
            if (tuple(scores.shape) != (QUERY_N, TRAIN_N)
                    or not bool(torch.isfinite(scores.float()).all())):
                raise RuntimeError(f"{label}: scores {tuple(scores.shape)} or non-finite")
            results[label] = (scores, sec)
    finally:
        pairwise._collect_blocks = collect
    log(f"score features (a) pairwise {QUERY_N} x {TRAIN_N} through the Analyzer, seconds (query "
        "gradients, train pass, call) and Pearson r against phase 12's dense scores: " + "; ".join(
            f"{label} {sec['query']:.3f}, {sec['train']:.3f}, {sec['call']:.3f}, r "
            f"{pearson(scores, dense):.6f}" for label, (scores, sec) in results.items())
        + f" [{card}]")
    if not torch.equal(results["dense bf16 (phase 12)"][0], dense):
        raise RuntimeError("phase 12's dense call, run again, changed its scores")

    # The SVD, on the query step's fp32 output (the SVD's input) for the
    # first SVD_CHECK_QUERIES queries: per-sample gradients do not depend on
    # the rest of the batch. fp64 singular values cost about 3 s a query at
    # GPT-2 small's 48 modules, the full SVD 2 s.
    batch, valid = next(iter(BatchLoader(
        {k: v[:SVD_CHECK_QUERIES] for k, v in data["query"].items()}, SVD_CHECK_QUERIES,
        device=device)))
    factors = analyzer.load_all_factors("ekfac")
    held_factors = memory.factor_bytes_on(factors, device)  # what a score call holds
    names = sorted(next(iter(factors.values())))
    states = prepare_precondition_states(factors, factor_args.strategy, recipe, names)
    del factors
    grads = pairwise._build_query_step(model, task, args_with(score_dtype="float32"), "ekfac")(
        batch, valid, states, 0)
    del states
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    norms, tails = {}, {}
    for name, g in grads.items():
        sq = torch.linalg.svdvals(g.double()) ** 2  # (q, min(o, i))
        norms[name] = sq.sum(-1).sqrt()
        tails[name] = {r: sq[:, r:].sum(-1).sqrt() / norms[name] for r in LOWRANK_RANKS}
    torch.cuda.synchronize()
    log(f"score features (a): fp64 singular values of the query step's {len(grads)} modules x "
        f"{SVD_CHECK_QUERIES} queries in {time.perf_counter() - t0:.2f} s")

    def svd_pass(rank, full):
        """Relative Frobenius errors (module -> (q,)) and the seconds of the
        factorisations alone, as the query step runs them (fp32 factors)."""
        errs, seconds = {}, 0.0
        for name, g in grads.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if full:
                left, right = lowrank_factors_full(g, rank, torch.float32)
            else:
                gen = torch.Generator(device=device).manual_seed(0)
                left, right = lowrank_factors_randomized(g, rank, torch.float32, gen)
            torch.cuda.synchronize()
            seconds += time.perf_counter() - t0
            errs[name] = (g.double() - rebuild(left, right).double()).flatten(1).norm(dim=1) / norms[name]
        return errs, seconds

    svd_seconds = {}
    worst = {}
    for label, rank, full in (("randomized 32", 32, False), ("full 32", 32, True),
                              ("randomized 64", 64, False), ("randomized 32 again", 32, False)):
        errs, svd_seconds[label] = svd_pass(rank, full)
        ratio = torch.stack([errs[n] / tails[n][rank] for n in grads])  # (modules, q)
        if full:
            worst[label] = float((ratio - 1).abs().max())
            if not worst[label] <= SVD_TAIL_RTOL:
                raise RuntimeError(f"the full SVD's error is off the optimal tail: {worst[label]:.3e}")
        else:
            worst[label] = float(ratio.max())
            if not worst[label] <= RANDOMIZED_TAIL_FACTOR:
                raise RuntimeError(f"the randomized SVD's error is {worst[label]:.3f}x the optimal")
    tail_range = {r: (min(float(t[r].min()) for t in tails.values()),
                      max(float(t[r].max()) for t in tails.values())) for r in LOWRANK_RANKS}
    log("score features (a) SVD per module on the query step's output (fp32 factors): optimal "
        "relative tail " + ", ".join(f"rank {r} {lo:.4f}-{hi:.4f}" for r, (lo, hi) in tail_range.items())
        + f"; full SVD max |error / tail - 1| {worst['full 32']:.3e} (limit {SVD_TAIL_RTOL:g}); "
        f"randomized max error / tail: rank 32 {worst['randomized 32']:.4f}, rank 64 "
        f"{worst['randomized 64']:.4f} (limit {RANDOMIZED_TAIL_FACTOR}); seconds for the "
        f"{len(grads)} modules x {SVD_CHECK_QUERIES} queries, in turns: " + ", ".join(
            f"{k} {v:.3f}" for k, v in svd_seconds.items()) + f" [{card}]")
    # Which cuSOLVER routine torch.linalg.svd took, at c_fc's shape.
    big = max(grads, key=lambda n: grads[n].shape[1] * grads[n].shape[2])
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.linalg.svd(grads[big], full_matrices=False)
        torch.cuda.synchronize()
    kernels = sorted(((e.self_device_time_total, e.key) for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    log(f"score features (a) torch.linalg.svd of {big} {tuple(grads[big].shape)} fp32, its "
        f"kernels by device time: " + "; ".join(f"{k[:70]} {us / 1e3:.2f} ms" for us, k in kernels[:6]))
    shapes = {name: g.shape[1:] for name, g in grads.items()}
    del grads

    # The contraction, per call, on the block the call scored with: its
    # bytes, then the low-rank route against the dense form on the rebuilt
    # block in fp32.
    probes = memory.probe_modules(model, task, batch, SVD_CHECK_QUERIES)
    loader = BatchLoader(data["train"], TRAIN_BATCH, device=device)
    for label in ("rank 32", "rank 32 full SVD", "rank 64"):
        args = calls[label][1]
        (block,) = recorded[label]
        nbytes = sum(t.nbytes for chunks in block.values() for pair in chunks for t in pair)
        planned = memory.query_block_bytes(probes, args, QUERY_N)
        if nbytes != planned:
            raise RuntimeError(f"{label}: the block holds {nbytes:,} B, the memory model "
                               f"plans {planned:,.0f}")
        fp32 = copy.deepcopy(args)
        fp32.per_sample_gradient_dtype = fp32.score_dtype = "float32"
        apply = pairwise._make_train_apply(model, task, fp32, False)
        lowrank_block = {n: [(l.float(), r.float())] for n, ((l, r),) in block.items()}
        dense_block = {n: [rebuild(l, r, torch.float32)] for n, ((l, r),) in block.items()}
        del block, recorded[label]
        got = torch.cat([apply(b, v, lowrank_block)[ALL_MODULE_NAME] for b, v in loader], dim=1)
        want = torch.cat([apply(b, v, dense_block)[ALL_MODULE_NAME] for b, v in loader], dim=1)
        del dense_block, lowrank_block
        scale = float(want.abs().max())
        gap = float((got - want).abs().max()) / scale
        call_gap = float((results[label][0].float() - got.cpu()).abs().max()) / scale
        log(f"score features (a) {label}: block {nbytes:,} B = the memory model's "
            f"query_block_bytes; fp32 contraction, low-rank route against the dense form on the "
            f"rebuilt block, max |diff| / max|score| {gap:.3e} (limit {CONTRACTION_RTOL:g}); the "
            f"call's bf16 scores against it {call_gap:.3e} (limit {FEATURES_BF16_RTOL:g})")
        if not gap <= CONTRACTION_RTOL:
            raise RuntimeError(f"{label}: the low-rank contraction is off the dense form: {gap:.3e}")
        if not call_gap <= FEATURES_BF16_RTOL:
            raise RuntimeError(f"{label}: the call's scores are off its fp32 contraction: {call_gap:.3e}")
    log(f"score features (a) contraction routes at {QUERY_N} queries x {TRAIN_BATCH} train "
        f"examples x {SEQ} tokens: " + ", ".join(
            f"{name.split('/', 1)[1]} {lowrank_route(QUERY_N, o, i, r, TRAIN_BATCH, SEQ)} at rank {r}"
            for name, (o, i) in sorted(shapes.items())[:4] for r in LOWRANK_RANKS))

    # The sizer's blocks at the bench's query and train counts, on the card
    # (autograd's bytes an example included, as the stage plans them).
    dense_bytes = memory.query_block_bytes(probes, recipe, 1)
    per_example_autograd = memory.autograd_bytes(model, task, batch, SVD_CHECK_QUERIES,
                                                 amp_dtype=recipe.amp_dtype)
    blocks = {}
    for label, args in (("bf16 dense", recipe),
                        ("fp8 dense", args_with(query_gradient_storage_dtype="float8_e4m3fn")),
                        ("rank 32", args_with(query_gradient_low_rank=32)),
                        ("rank 64", args_with(query_gradient_low_rank=64))):
        block_q = memory.max_queries_per_block(
            probes, args, params=model.module, train_batch_size=TRAIN_BATCH, num_train=BENCH_TRAIN,
            query_batch_size=QUERY_BATCH, device=device, untracked_bytes=per_example_autograd)
        blocks[label] = (block_q, memory.query_block_bytes(probes, args, 1))
    log(f"score features (a) the sizer at the bench's {BENCH_QUERIES} x {BENCH_TRAIN} (train batch "
        f"{TRAIN_BATCH}, query batch {QUERY_BATCH}): queries a block (a query's block bytes): "
        + ", ".join(f"{k} {min(q, BENCH_QUERIES)} of {q} ({b:,.0f} B, {dense_bytes / b:.1f}x "
                    f"smaller than bf16 dense)" for k, (q, b) in blocks.items()) + f" [{card}]")
    # The sized stage: its peak over what was resident before it (the
    # parameters, phase 5's factors and data), while the query steps build
    # the block and during the train pass, against the sizer's plan for the
    # block it resolved (the terms it sizes against PAIRWISE_BUDGET_FRACTION
    # of the card).
    sized = args_with(query_gradient_low_rank=32, query_gradient_accumulation_steps=None)
    peaks = {}

    def peak_at_block(blocks):
        torch.cuda.synchronize()
        peaks["query steps"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        return collect(blocks)

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    pairwise._collect_blocks = peak_at_block
    try:
        _, peak, sec = peak_of(profiled_pairwise, analyzer, "features_sized", data["query"],
                               data["train"], QUERY_BATCH, sized)
    finally:
        pairwise._collect_blocks = collect
    peaks["train pass"] = peak
    run = pairwise.compute_pairwise_scores_with_loaders.last_run
    q_block = run["accumulation"] * QUERY_BATCH
    params = sum(p.numel() * p.element_size() for p in model.module.parameters())
    plan = held_factors + memory.pairwise_plan_bytes(
        probes, sized, q_block, params=model.module, train_batch_size=TRAIN_BATCH,
        num_train=TRAIN_N, query_batch_size=QUERY_BATCH, device=device,
        untracked_bytes=per_example_autograd)
    own = {k: v - resident for k, v in peaks.items()}
    log(f"score features (a) rank 32 with query_gradient_accumulation_steps=None: resolved "
        f"{run['accumulation']} steps ({run['blocks']} block of {q_block} queries, "
        f"{run['formats']}), {sec:.3f} s; peak over the {resident / 2**30:.3f} GiB resident "
        f"before it: " + ", ".join(f"{k} {v / 2**30:.3f} GiB" for k, v in own.items())
        + f"; the sizer's plan for this block, less the {params / 2**30:.3f} GiB of parameters "
        f"already resident, {(plan - params) / 2**30:.3f} GiB (the factors the call holds "
        f"{held_factors / 2**30:.3f} GiB, autograd {per_example_autograd / 2**20:.1f} MiB an "
        f"example; the limit) [{card}]")
    if not max(own.values()) <= plan - params:
        raise RuntimeError(f"the sized low-rank stage's peak {max(own.values()):,} B is over its "
                           f"plan {plan - params:,.0f} B")
    if run["formats"] != ["LowRank[torch.bfloat16]"]:
        raise RuntimeError(f"the sized call's blocks are not low-rank bf16: {run['formats']}")

    # One rank-32 call on phase 10's flash model (FF and FB).
    config = gpt2_small(max_seq_len=SEQ, dtype=torch.bfloat16, attention="flash")
    flash_model = prepare_model(init_transformer(config, seed=0, device=device), task)
    flash_analyzer = Analyzer(analyzer.name, flash_model, task,
                              output_dir=str(analyzer.output_dir.parent), profile=True)
    kernels = flash_kernels()
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    flash_scores, flash_sec = profiled_pairwise(flash_analyzer, "features_flash", data["query"],
                                                data["train"], QUERY_N, calls["rank 32"][1])
    launches = {name: fn.launches for name, fn in kernels.items()}
    passes = config.num_layers * (1 + TRAIN_N // TRAIN_BATCH)  # a query batch, the train batches
    log(f"score features (a) rank 32 on the flash model: {flash_sec['query']:.3f}, "
        f"{flash_sec['train']:.3f}, {flash_sec['call']:.3f} s, Pearson r against phase 12's dense "
        f"{pearson(flash_scores, dense):.6f}, against the naive rank-32 call "
        f"{pearson(flash_scores, results['rank 32'][0]):.6f}; launches " + ", ".join(
            f"{k} {v}" for k, v in launches.items()) + f" (want FB {passes}, FF a multiple of "
        f"{config.num_layers} above it, the other flash kernels 0) [{card}]")
    if (launches["FB"] != passes or launches["FF"] <= launches["FB"]
            or launches["FF"] % config.num_layers):
        raise RuntimeError(f"the flash low-rank call launched {launches}")
    if any(n for k, n in launches.items() if k not in ("FF", "FB")):
        raise RuntimeError(f"the flash low-rank call took the generic or D 128 routes: {launches}")
    if not pearson(flash_scores, dense) >= FLASH_PEARSON_MIN:
        raise RuntimeError("the flash low-rank scores do not follow the dense ones")
    del flash_analyzer, flash_model
    return {"FF": launches["FF"], "FB": launches["FB"]}


def score_features_aggregated(card: str, ctx: dict, analyzer) -> None:
    """Phase 14 (b): aggregated query and train gradients against the sums
    of phase 12's dense scores, and bitwise under rematerialisation."""
    from kronfluence_tpu_torch.utils.constants import ALL_MODULE_NAME

    data = ctx["data"]
    dense = analyzer.load_pairwise_scores("pairwise")[ALL_MODULE_NAME].float()
    modes = {
        "query": (dict(aggregate_query_gradients=True), dense.sum(0, keepdim=True)),
        "train": (dict(aggregate_train_gradients=True), dense.sum(1, keepdim=True)),
        "both": (dict(aggregate_query_gradients=True, aggregate_train_gradients=True),
                 dense.sum().reshape(1, 1)),
    }
    rows = []
    for mode, (fields, want) in modes.items():
        got = {}
        for remat in (False, True):
            args = copy.deepcopy(ctx["score_args"])
            args.offload_activations_to_cpu = remat
            for field, value in fields.items():
                setattr(args, field, value)
            got[remat] = profiled_pairwise(analyzer, f"aggregated_{mode}_{remat}", data["query"],
                                           data["train"], QUERY_BATCH, args)
        scores, sec = got[False]
        gap = float((scores.float() - want).abs().max() / want.abs().max())
        same = torch.equal(scores, got[True][0])
        rows.append(f"{mode} {tuple(scores.shape)} max |diff| / max|sum| {gap:.3e}, "
                    f"{sec['call']:.3f} s, remat bitwise {same} ({got[True][1]['call']:.3f} s)")
        if tuple(scores.shape) != tuple(want.shape) or not gap <= FEATURES_BF16_RTOL:
            raise RuntimeError(f"aggregated {mode}: shape {tuple(scores.shape)}, gap {gap:.3e}")
        if not same:
            raise RuntimeError(f"aggregated {mode}: remat changed the scores")
    log(f"score features (b) aggregated gradients against the sums of phase 12's dense scores "
        f"(limit {FEATURES_BF16_RTOL:g}): " + "; ".join(rows) + f" [{card}]")


def score_features_lds(card: str, root: Path, device: torch.device) -> dict:
    """Phase 14 (c): tests/test_lds.py's ridge problem on the card through the
    Analyzer, the retrains solved in closed form on the card. Returns the
    launches of K1, K2 and K3 in its two `fit_all_factors` calls."""
    from collections import OrderedDict

    from kronfluence_tpu_torch import Analyzer, FactorArguments, ScoreArguments, Task, prepare_model
    from kronfluence_tpu_torch import evaluate
    from kronfluence_tpu_torch.ops.kernels.jacobi import jacobi_pivot_rotations
    from kronfluence_tpu_torch.ops.kernels.probe import probe
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk

    class RegressionTask(Task):
        def compute_train_loss(self, batch, model, sample=False, generator=None):
            return 0.5 * torch.sum((model(batch["x"]) - batch["y"]) ** 2)

        def compute_measurement(self, batch, model):
            return self.compute_train_loss(batch, model)

    rng = np.random.default_rng(0)  # tests/test_lds.py:_make_problem
    w_true = rng.standard_normal((LDS_D, 1))
    x_train = rng.standard_normal((LDS_TRAIN, LDS_D))
    y_train = x_train @ w_true + 0.3 * rng.standard_normal((LDS_TRAIN, 1))
    x_query = rng.standard_normal((LDS_QUERY, LDS_D))
    y_query = x_query @ w_true + 0.3 * rng.standard_normal((LDS_QUERY, 1))
    xt, yt, xq, yq = (torch.from_numpy(a).to(device) for a in (x_train, y_train, x_query, y_query))
    eye = LDS_RIDGE * torch.eye(LDS_D, dtype=torch.float64, device=device)

    def solve(idx):
        xs, ys = xt[idx], yt[idx]
        return torch.linalg.solve(xs.T @ xs + eye, xs.T @ ys)

    task = RegressionTask()
    sa = ScoreArguments(damping_factor=1e-3, per_sample_gradient_dtype="float64",
                        precondition_dtype="float64", score_dtype="float64",
                        query_gradient_svd_dtype="float64")
    scores = {}
    kernels = {"syrk": syrk, "probe": probe, "jacobi": jacobi_pivot_rotations}
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    for strategy in ("ekfac", "identity"):
        fc = torch.nn.Linear(LDS_D, 1, bias=False, dtype=torch.float64, device=device)
        with torch.no_grad():
            fc.weight.copy_(solve(torch.arange(LDS_TRAIN, device=device)).T)
        model = prepare_model(torch.nn.Sequential(OrderedDict(fc=fc)), task)
        analyzer = Analyzer(f"lds_{strategy}", model, task, output_dir=str(root / "lds"))
        fa = FactorArguments(
            strategy=strategy, use_empirical_fisher=True,
            activation_covariance_dtype="float64", gradient_covariance_dtype="float64",
            eigendecomposition_dtype="float64", per_sample_gradient_dtype="float64",
            lambda_dtype="float64")
        train, query = {"x": xt, "y": yt}, {"x": xq, "y": yq}
        analyzer.fit_all_factors("f", train, per_device_batch_size=16, factor_args=fa)
        analyzer.compute_pairwise_scores("s", "f", query, train, per_device_query_batch_size=8,
                                         per_device_train_batch_size=16, score_args=sa)
        scores[strategy] = analyzer.load_pairwise_scores("s")["all_modules"]
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}

    def train_fn(idx, seed):
        return solve(torch.from_numpy(idx).to(device))

    def measure_fn(w):
        return -0.5 * ((xq @ w - yq) ** 2).sum(dim=1)

    masks = evaluate.sample_subset_masks(LDS_TRAIN, LDS_SUBSETS, 0.5, LDS_SEED)
    measurements = evaluate.collect_subset_measurements(train_fn, measure_fn, masks)
    lds = {s: evaluate.evaluate_lds(scores[s], train_fn, measure_fn, LDS_TRAIN, masks=masks,
                                    measurements=measurements)[0] for s in scores}
    try:
        evaluate.linear_datamodeling_score(scores["ekfac"], measurements[:-1], masks)
    except ValueError:
        mismatch_raises = True
    else:
        mismatch_raises = False
    log(f"score features (c) LDS on the card ({LDS_TRAIN} train, {LDS_QUERY} queries, "
        f"{LDS_SUBSETS} retrains solved on the card, masks seed {LDS_SEED}): ekfac "
        f"{lds['ekfac']:.6f}, identity {lds['identity']:.6f} (bars: ekfac > {LDS_MIN} and >= "
        f"identity - 1e-6); {LDS_SUBSETS - 1} measurement rows for {LDS_SUBSETS} masks raise "
        f"ValueError: {mismatch_raises}; kernel launches " + ", ".join(
            f"{k} {v}" for k, v in launches.items()) + f" (want K3 at least 1) [{card}]")
    if not launches["probe"]:
        raise RuntimeError(f"the LDS problem's covariance stage launched no K3: {launches}")
    if not (lds["ekfac"] > LDS_MIN and lds["ekfac"] > lds["identity"] - 1e-6):
        raise RuntimeError(f"LDS off the JAX test's bars: {lds}")
    if not mismatch_raises:
        raise RuntimeError("mismatched measurements did not raise")
    return launches


def phase_score_features(card: str, ctx: dict, root: Path) -> dict:
    """Low-rank query blocks, aggregated gradients and the LDS harness on
    phase 12's factors, model and recipe, read from phase 12's directory
    through an Analyzer of this phase. Returns the launches of each kernel
    that phase 14 counts."""
    from kronfluence_tpu_torch import Analyzer

    start = time.perf_counter()
    parts = [start]
    analyzer = Analyzer("chip_smoke", ctx["model"], ctx["task"], output_dir=str(root),
                        profile=True)
    log(f"score features: {torch.cuda.memory_allocated() / 2**30:.3f} GiB in use on the card "
        "as phase 14 starts")
    launches = score_features_lowrank(card, ctx, analyzer)
    parts.append(time.perf_counter())
    score_features_aggregated(card, ctx, analyzer)
    parts.append(time.perf_counter())
    launches.update(score_features_lds(card, root, ctx["device"]))
    parts.append(time.perf_counter())
    log(f"score features: phase 14 took {parts[-1] - start:.1f} s, (a) to (c) "
        + ", ".join(f"{b - a:.1f}" for a, b in zip(parts, parts[1:])) + f" s [{card}]")
    return launches


def openwebtext_task(num_layers: int, tracked=None):
    """The openwebtext workload's task, the port's example's
    (kronfluence_tpu_torch/examples/openwebtext/task.py: LlamaMLPOnlyTask):
    the summed token cross-entropy on fp32 logits over the shifted mask,
    labels sampled from the explicit generator by Gumbel-max (as
    `jax.random.categorical` draws them; one fp32 noise tensor the size of
    the logits), the margin measurement (the label's logit against the
    logsumexp of the others), tracking the MLP projections of every layer
    (or the modules `tracked` names)."""
    from kronfluence_tpu_torch.examples.openwebtext.task import LlamaMLPOnlyTask

    if tracked is None:
        return LlamaMLPOnlyTask(num_layers)

    class TrackedTask(LlamaMLPOnlyTask):
        def get_influence_tracked_modules(self):
            return list(tracked)

    return TrackedTask(num_layers)


class PassCounter:
    """While the block runs: model forwards (a pre-hook on the root module:
    the probes', the discovery forwards' and every pass's), backward passes
    (`torch.autograd.grad` calls), and each attention layer's forwards and
    backwards (hooks on its output: a backward is counted where the output's
    gradient is computed), beside every kernel's launch count, all set to 0
    as it starts. With `module` None (a model an entry point builds inside
    the block) the hooks are global: every LlamaLM's forwards and every
    LlamaAttention's."""

    def __init__(self, module, kernels: dict):
        self.module, self.kernels = module, kernels
        self.counts = {}

    def __enter__(self):
        from kronfluence_tpu_torch.models.llama import LlamaAttention
        from kronfluence_tpu_torch.ops.attention import naive_attention
        from kronfluence_tpu_torch.ops.kernels.syrk import syrk

        for fn in self.kernels.values():
            fn.launches = 0
        syrk.wgmma_launches = 0
        naive_attention.calls = 0
        counts = self.counts = {"forwards": 0, "backwards": 0, "attention forwards": {},
                                "attention backwards": {}}

        def bump(key, sub=None):
            if sub is None:
                counts[key] += 1
            else:
                counts[key][sub] = counts[key].get(sub, 0) + 1

        def attention_hook(name):
            def hook(_module, _args, output):
                bump("attention forwards", name)
                if output.requires_grad:
                    output.register_hook(lambda grad: bump("attention backwards", name))
            return hook

        if self.module is None:
            from kronfluence_tpu_torch.models.llama import LlamaLM
            from torch.nn.modules import module as nn_module

            names = {}

            def any_forward(m, _args):
                if isinstance(m, LlamaLM):
                    bump("forwards")

            def any_attention(m, args, output):
                if isinstance(m, LlamaAttention):
                    attention_hook(names.setdefault(id(m), f"attention {len(names)}"))(
                        m, args, output)

            self._handles = [nn_module.register_module_forward_pre_hook(any_forward),
                             nn_module.register_module_forward_hook(any_attention)]
        else:
            self._handles = [
                self.module.register_forward_pre_hook(lambda *_: bump("forwards"))] + [
                m.register_forward_hook(attention_hook(name))
                for name, m in self.module.named_modules() if isinstance(m, LlamaAttention)]
        self._grad = torch.autograd.grad

        def grad(*args, **kwargs):
            bump("backwards")
            return self._grad(*args, **kwargs)

        torch.autograd.grad = grad
        return self

    def __exit__(self, *exc):
        from kronfluence_tpu_torch.ops.attention import naive_attention
        from kronfluence_tpu_torch.ops.kernels.syrk import syrk

        torch.autograd.grad = self._grad
        for handle in self._handles:
            handle.remove()
        self.counts.update({name: fn.launches for name, fn in self.kernels.items()},
                           wgmma=syrk.wgmma_launches, naive=naive_attention.calls)
        return False


def check_llama_launches(stage: str, counts: dict, layers: int, covariance_fits: int = 0,
                         cov_batches: int = 0) -> None:
    """FFH (bf16 at D 128: the "pipelined_h" route) once per attention layer
    and model forward; F2H and F3H (the "split_h" route) once per attention
    backward (MLP-only tracking with frozen weights: an attention layer has a
    backward only above a tracked projection, so the first layer never has
    one, and a model of one layer has none); F1, F2, F3, FF, FB, FFW, FFS, FFS64, F2W, F3W,
    F2S, F3S, F2SH, F3SH, F2SW, F3SW, K2 and the naive form never; in a covariance stage K1 on every gram (two per
    projection, 6 a layer and batch), all wgmma, and K3 once per covariance
    fit (one per module partition)."""
    fwd = sum(counts["attention forwards"].values())
    bwd = sum(counts["attention backwards"].values())
    want = {"FFH": fwd, "F2H": bwd, "F3H": bwd, "F1": 0, "F2": 0, "F3": 0, "FF": 0, "FB": 0,
            "FFW": 0, "FFS": 0, "FFS64": 0, "F2W": 0, "F3W": 0, "F2S": 0, "F3S": 0, "F2SH": 0,
            "F3SH": 0,
            "F2SW": 0, "F3SW": 0, "jacobi": 0, "naive": 0}
    if covariance_fits:
        want.update(syrk=6 * layers * cov_batches, wgmma=6 * layers * cov_batches,
                    probe=covariance_fits)
    else:
        want.update(syrk=0, probe=0)
    off = {k: (counts[k], v) for k, v in want.items() if counts[k] != v}
    if fwd != layers * counts["forwards"] or bwd > (layers - 1) * counts["backwards"]:
        off["attention passes"] = (fwd, bwd, counts["forwards"], counts["backwards"])
    if counts["backwards"] and layers > 1 and not bwd:
        off["no attention backward"] = counts["attention backwards"]
    if off:
        raise RuntimeError(f"Llama {stage}: launches off (got, want): {off}")


def watch_estimates(analyzer) -> list:
    """Records each batch estimate the Analyzer makes, with the peak device
    memory of what ran after it until the next (its partition's stage). The
    wrapper reaches the Analyzer by a weak reference: a strong one from the
    Analyzer's own attribute would be a reference cycle, which keeps the
    Analyzer and its model on the card after the caller drops them, until the
    collector next runs."""
    records = []
    ref = weakref.ref(analyzer)
    real = type(analyzer)._find_executable_batch_size

    def estimate(*args, **kwargs):
        close_estimate(records)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fit = real(ref(), *args, **kwargs)
        est = dict(ref().last_batch_estimate)
        est["planned_bytes"] = est["static_bytes"] + est["reserved_bytes"] + est["batch_size"] * (
            est["per_example_bytes"] + est["untracked_bytes"] + est["precondition_bytes"])
        records.append(est)
        return fit

    analyzer._find_executable_batch_size = estimate
    return records


def close_estimate(records: list) -> None:
    if records and "peak_bytes" not in records[-1]:
        torch.cuda.synchronize()
        records[-1]["peak_bytes"] = torch.cuda.max_memory_allocated()


def log_estimates(card: str, stage: str, records: list, within_plan: bool = False) -> None:
    """Prints each estimate's plan beside its measured peak; raises where the
    peak is over the budget or, with `within_plan`, over the plan."""
    for i, est in enumerate(records):
        log(f"{stage} estimate {i + 1}/{len(records)}: batch {est['batch_size']} of "
            f"{est['attempt']}, planned {est['planned_bytes'] / 2**30:.3f} GiB = static "
            f"{est['static_bytes'] / 2**30:.3f} + reserved {est['reserved_bytes'] / 2**30:.3f} + "
            f"{est['batch_size']} x ({est['per_example_bytes'] / 2**20:.1f} + autograd "
            f"{est['untracked_bytes'] / 2**20:.1f} + precondition "
            f"{est['precondition_bytes'] / 2**20:.1f} MiB), budget "
            f"{est['budget_bytes'] / 2**30:.3f} GiB, measured peak "
            f"{est['peak_bytes'] / 2**30:.3f} GiB [{card}]")
        if not est["peak_bytes"] <= est["budget_bytes"]:
            raise RuntimeError(f"{stage}: measured peak {est['peak_bytes']:,} B over the "
                               f"budget {est['budget_bytes']:,.0f} B")
        if within_plan and not est["peak_bytes"] <= est["planned_bytes"]:
            raise RuntimeError(f"{stage}: measured peak {est['peak_bytes']:,} B over the "
                               f"plan {est['planned_bytes']:,.0f} B")


def watch_large_solves(scratch: Path) -> dict:
    """Wraps the eigendecomposition's `eigh_large`: each large matrix's
    seconds from the start of its build to its result, a host copy of its
    fp32 eigenpairs (for the residuals after the stage; the copy's seconds
    apart), the seconds of the callback (the cast and the checkpoint's
    write), and the scratch directory's files after its checkpoint; and
    each batched cuSOLVER group's (dimension, matrices, seconds)."""
    from kronfluence_tpu_torch.factor import eigen as eigen_mod

    record = {"real": eigen_mod.eigh_large, "real_group": eigen_mod._cusolver_group,
              "solves": [], "host": [], "files": [], "copy_s": 0.0, "result_s": 0.0,
              "calls": [], "groups": []}

    def timed_group(covariance_factors, eigen_factors, entries):
        torch.cuda.synchronize()
        t = time.perf_counter()
        record["real_group"](covariance_factors, eigen_factors, entries)
        torch.cuda.synchronize()
        record["groups"].append((entries[0][1], len(entries), time.perf_counter() - t))

    def watched(matrices, on_result, solve=None):
        record["calls"].append(len(matrices))
        clock = [time.perf_counter()]

        def landed(i, evals, evecs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            record["solves"].append(t - clock[0])
            record["host"].append((evals.cpu(), evecs.cpu()))
            t1 = time.perf_counter()
            record["copy_s"] += t1 - t
            on_result(i, evals, evecs)  # the cast and the checkpoint's write
            torch.cuda.synchronize()
            record["result_s"] += time.perf_counter() - t1
            record["files"].append(sorted(p.name for p in scratch.iterdir())
                                   if scratch.exists() else [])
            clock[0] = time.perf_counter()

        return record["real"](matrices, landed, solve)

    eigen_mod.eigh_large = watched
    eigen_mod._cusolver_group = timed_group
    return record


def unwatch_large_solves(record: dict) -> None:
    from kronfluence_tpu_torch.factor import eigen as eigen_mod

    eigen_mod.eigh_large = record["real"]
    eigen_mod._cusolver_group = record["real_group"]


def eigen_residuals(cov: dict, record: dict, order: list, device) -> list:
    """Per large matrix, in fp64 on the card: ‖C − QΛQᵀ‖_F / ‖C‖_F and
    ‖QᵀQ − I‖_max of the solver's fp32 eigenpairs, C the normalized,
    symmetrized covariance the solver was given."""
    from kronfluence_tpu_torch.factor.eigen import _FACTOR_PAIRS

    out = []
    for (pair_idx, name), (evals, evecs) in zip(order, record["host"]):
        cov_name, count_name = _FACTOR_PAIRS[pair_idx][:2]
        c = cov[cov_name][name].to(device, torch.float64) / float(cov[count_name][name])
        c = 0.5 * (c + c.T)
        q = evecs.to(device, torch.float64)
        lam = evals.to(device, torch.float64)
        residual = float(torch.linalg.matrix_norm(c - (q * lam) @ q.T) / torch.linalg.matrix_norm(c))
        eye = torch.eye(q.shape[0], dtype=torch.float64, device=device)
        orth = float((q.T @ q - eye).abs().max())
        out.append(dict(module=name, factor=cov_name, n=q.shape[0], residual=residual,
                        orthogonality=orth))
        del c, q, lam, eye
    torch.cuda.empty_cache()
    return out


def llama_lowrank_checks(card: str, analyzer, model, task, query, train, device,
                         recorded: list) -> dict:
    """Phase 15's low-rank path at Llama's shapes, on the first
    LLAMA_CHECK_QUERIES queries: (1) the randomized SVD of the query step's
    output (the recipe's bf16 preconditioning, in fp32 as the SVD takes it)
    against the optimal rank-64 tail, from the fp64 eigenvalues of each
    gradient's smaller Gram matrix; (2) the recorded rank-64 block's
    contraction with the train examples against the dense form on the
    rebuilt block, both in fp32."""
    from kronfluence_tpu_torch.ops.scores import rebuild
    from kronfluence_tpu_torch.ops.svd import lowrank_factors_randomized
    from kronfluence_tpu_torch.score import pairwise
    from kronfluence_tpu_torch.score.common import prepare_precondition_states
    from kronfluence_tpu_torch.utils.common.score_arguments import (
        extreme_reduce_memory_score_arguments,
    )
    from kronfluence_tpu_torch.utils.constants import ALL_MODULE_NAME
    from kronfluence_tpu_torch.utils.dataset import BatchLoader

    dense_args = extreme_reduce_memory_score_arguments()
    dense_args.score_dtype = "float32"
    batch, valid = next(iter(BatchLoader(
        {k: v[:LLAMA_CHECK_QUERIES] for k, v in query.items()}, LLAMA_CHECK_QUERIES,
        device=device)))
    factors = analyzer.load_all_factors("ekfac")
    names = sorted(next(iter(factors.values())))
    states = prepare_precondition_states(factors, "ekfac", dense_args, names)
    del factors
    grads = pairwise._build_query_step(model, task, dense_args, "ekfac")(batch, valid, states, 0)
    del states
    tails, ratios = {}, {}
    for name, g in grads.items():
        g64 = g.double()
        gram = g64 @ g64.transpose(1, 2) if g.shape[1] <= g.shape[2] else \
            g64.transpose(1, 2) @ g64
        sq = torch.linalg.eigvalsh(gram).flip(-1).clamp_min(0)  # squared singular values
        norm = sq.sum(-1).sqrt()
        tails[name] = sq[:, LLAMA_RANK:].sum(-1).sqrt() / norm
        gen = torch.Generator(device=device).manual_seed(0)
        left, right = lowrank_factors_randomized(g, LLAMA_RANK, torch.float32, gen)
        err = (g64 - rebuild(left, right).double()).flatten(1).norm(dim=1) / norm
        ratios[name] = err / tails[name]
        del g64, gram, left, right
    del grads
    worst_ratio = max(float(r.max()) for r in ratios.values())
    log(f"Llama low-rank SVD on {LLAMA_CHECK_QUERIES} queries' preconditioned gradients: optimal "
        f"rank-{LLAMA_RANK} relative tail by module " + ", ".join(
            f"{n} {float(t.min()):.4f}-{float(t.max()):.4f}" for n, t in tails.items())
        + f"; randomized SVD error / optimal at most {worst_ratio:.4f} (limit "
        f"{RANDOMIZED_TAIL_FACTOR}) [{card}]")
    if not worst_ratio <= RANDOMIZED_TAIL_FACTOR:
        raise RuntimeError(f"Llama: the randomized SVD's error is {worst_ratio:.3f}x the optimal")

    block = {n: c for part in recorded for n, c in part.items()}
    fp32 = extreme_reduce_memory_score_arguments(query_gradient_low_rank=LLAMA_RANK)
    fp32.per_sample_gradient_dtype = fp32.score_dtype = "float32"
    apply = pairwise._make_train_apply(model, task, fp32, False)
    loader = BatchLoader(train, LLAMA_CHECK_BATCH, device=device)
    lowrank_block = {n: [(l.float(), r.float()) for l, r in c] for n, c in block.items()}
    got = torch.cat([apply(b, v, lowrank_block)[ALL_MODULE_NAME] for b, v in loader], dim=1)
    del lowrank_block
    dense_block = {n: [rebuild(l, r, torch.float32) for l, r in c] for n, c in block.items()}
    want = torch.cat([apply(b, v, dense_block)[ALL_MODULE_NAME] for b, v in loader], dim=1)
    del dense_block, block
    gap = float((got - want).abs().max()) / float(want.abs().max())
    log(f"Llama low-rank contraction ({len(recorded)} module partitions' blocks, "
        f"{LLAMA_CHECK_QUERIES} queries x {LLAMA_TRAIN_N} train, fp32): low-rank route against "
        f"the dense form on the rebuilt block, max |diff| / max|score| {gap:.3e} (limit "
        f"{CONTRACTION_RTOL:g}) [{card}]")
    if not gap <= CONTRACTION_RTOL:
        raise RuntimeError(f"Llama: the low-rank contraction is off the dense form: {gap:.3e}")
    torch.cuda.empty_cache()
    return dict(tails={n: t.tolist() for n, t in tails.items()}, svd_ratio=worst_ratio,
                contraction_gap=gap)


def phase_llama(card: str, device=torch.device("cuda", 0)) -> dict:
    """Phase 15: Llama at Llama-3-8B width, 2 of 32 layers, through the
    Analyzer with the openwebtext recipe on `device`; returns the launches
    and numbers for the kernels line."""
    from kronfluence_tpu_torch import Analyzer, prepare_model
    from kronfluence_tpu_torch.factor import eigen as eigen_mod
    from kronfluence_tpu_torch.factor.covariance import fit_covariance_matrices_with_loader
    from kronfluence_tpu_torch.factor.eigen import (
        _FACTOR_PAIRS,
        _checkpoint_path,
        fit_lambda_matrices_with_loader,
        perform_eigendecomposition,
    )
    from kronfluence_tpu_torch.models import llama as llama_mod
    from kronfluence_tpu_torch.score import pairwise
    from kronfluence_tpu_torch.ops.kernels.jacobi import jacobi_pivot_rotations
    from kronfluence_tpu_torch.ops.kernels.probe import probe
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk
    from kronfluence_tpu_torch.utils.common.factor_arguments import (
        extreme_reduce_memory_factor_arguments,
        smart_low_precision_factor_arguments,
    )
    from kronfluence_tpu_torch.utils.common.score_arguments import (
        extreme_reduce_memory_score_arguments,
    )
    from kronfluence_tpu_torch.utils.constants import (
        ALL_MODULE_NAME,
        COVARIANCE_FACTOR_NAMES,
        EIGENDECOMPOSITION_FACTOR_NAMES,
        LAMBDA_FACTOR_NAMES,
    )
    from kronfluence_tpu_torch.utils.dataset import BatchLoader
    from kronfluence_tpu_torch.utils.save import save_file

    start = time.perf_counter()
    config = llama_mod.llama3_8b_config(num_layers=LLAMA_LAYERS, max_seq_len=SEQ,
                                        dtype=torch.bfloat16, attention="flash")
    layers = config.num_layers
    task = openwebtext_task(layers)
    t0 = time.perf_counter()
    module = llama_mod.init_llama(config, seed=0, device=device)
    torch.cuda.synchronize()
    params = sum(p.numel() for p in module.parameters())
    log(f"Llama: Llama-3-8B widths (d_model {config.d_model}, d_mlp {config.d_mlp}, "
        f"{config.num_heads} heads, {config.num_kv_heads} KV heads, head_dim {config.head_dim}, "
        f"vocab {config.vocab_size:,}, T {SEQ}), bf16, flash attention; reduced: {layers} of 32 "
        f"layers; {params:,} parameters initialised from seed 0 in "
        f"{time.perf_counter() - t0:.2f} s; {LLAMA_TRAIN_N} train and {LLAMA_QUERY_N} query "
        f"examples of synthetic tokens [{card}]")
    train = make_tokens(LLAMA_TRAIN_N, SEQ, config.vocab_size, 21, device)
    query = make_tokens(LLAMA_QUERY_N, SEQ, config.vocab_size, 22, device)
    recipe = extreme_reduce_memory_factor_arguments(
        strategy="ekfac", module_partitions=LLAMA_MODULE_PARTITIONS)
    recipe.eigendecomposition_dtype = "float32"
    recipe.eigendecomposition_solver = "auto"
    kernels = dict(flash_kernels(), syrk=syrk, probe=probe, jacobi=jacobi_pivot_rotations)
    root = Path(tempfile.mkdtemp(prefix="kf_chip_smoke_llama_"))
    out = {"seconds": {}, "launches": {}}
    try:
        analyzer = Analyzer("llama", prepare_model(module, task), task, profile=True,
                            output_dir=str(root), cpu=device.type == "cpu")
        model = analyzer.model
        factors_dir = analyzer.factors_output_dir("ekfac")

        # (a) Covariance: 3 module partitions, each estimating its batch.
        estimates = watch_estimates(analyzer)
        with PassCounter(module, kernels) as counter:
            _, _, sec = peak_of(analyzer.fit_covariance_matrices, "ekfac", train,
                                factor_args=recipe)
        close_estimate(estimates)
        cov_estimates = list(estimates)
        batches = {e["batch_size"] for e in cov_estimates}
        if len(batches) != 1 or len(cov_estimates) != LLAMA_MODULE_PARTITIONS:
            raise RuntimeError(f"Llama covariance: estimates {cov_estimates}")
        cov_batch = batches.pop()
        cov_batches = -(-LLAMA_TRAIN_N // cov_batch)
        log_estimates(card, "Llama covariance", cov_estimates)
        check_llama_launches("covariance", counter.counts, layers,
                             covariance_fits=LLAMA_MODULE_PARTITIONS,
                             cov_batches=cov_batches)
        out["seconds"]["covariance"] = sec
        out["launches"]["covariance"] = dict(counter.counts)
        log(f"Llama covariance: {sec:.3f} s, batch {cov_batch} ({cov_batches} batches a "
            f"partition; phases 4 and 9 held K1, FFH, F2H and F3H at batch {LLAMA_BATCH}), launches "
            f"{counter.counts} [{card}]")
        if not cov_batch < LLAMA_TRAIN_N:
            raise RuntimeError(f"Llama covariance: the data ({LLAMA_TRAIN_N}) set the batch")

        # (a) Eigendecomposition: "auto", the 14336 group one matrix at a time.
        cov = analyzer.load_covariance_matrices("ekfac")
        cov_bytes = sum(t.nbytes for k in COVARIANCE_FACTOR_NAMES[:2] for t in cov[k].values())
        large = [((p, name), t.shape[0]) for p, (cname, *_rest) in enumerate(_FACTOR_PAIRS)
                 for name, t in cov[cname].items() if t.shape[0] >= eigen_mod.LARGE_EIGH_DIM]
        order = [key for key, _ in large]
        n = large[0][1]
        if sorted({d for _, d in large}) != [config.d_mlp] or len(large) != 3 * layers:
            raise RuntimeError(f"Llama: large factors {large}")
        scratch = factors_dir / "eigendecomposition_scratch"
        # One matrix's solve, measured alone: the device bytes torch.linalg.eigh
        # (cuSOLVER's syevd) takes beyond its fp32 input.
        pair_idx, name = order[0]
        c_name, n_name = _FACTOR_PAIRS[pair_idx][:2]
        one = cov[c_name][name].to(device, torch.float32) / float(cov[n_name][name])
        one = 0.5 * (one + one.T)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        _, solve_peak, solve_sec = peak_of(torch.linalg.eigh, one)
        solve_bytes = solve_peak - before
        del one
        torch.cuda.empty_cache()
        record = watch_large_solves(scratch)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        try:
            with PassCounter(module, kernels) as counter:
                _, peak, sec = peak_of(analyzer.perform_eigendecomposition, "ekfac",
                                       factor_args=recipe)
        finally:
            unwatch_large_solves(record)
        eigen = analyzer.load_eigendecomposition("ekfac")
        result_bytes = sum(t.nbytes for k in EIGENDECOMPOSITION_FACTOR_NAMES
                           for t in eigen[k].values())
        if any(counter.counts[k] for k in kernels) or counter.counts["forwards"]:
            raise RuntimeError(f"Llama eigendecomposition launched {counter.counts}")
        if record["calls"] != [3 * layers]:
            raise RuntimeError(f"Llama: eigh_large calls {record['calls']}")
        if [len(f) for f in record["files"]] != list(range(1, 3 * layers + 1)):
            raise RuntimeError(f"Llama: scratch files as each solve landed {record['files']}")
        if scratch.exists():
            raise RuntimeError("Llama: the eigendecomposition scratch outlived the stage")
        # What was resident (the model, the data, the covariance the stage
        # loads, the results as they accumulate), plus one matrix (its fp32
        # input and its build's fp32 temporary), plus its solve as measured
        # alone above. The group stacked would hold the other five inputs too.
        matrix_bytes = 2 * n * n * 4
        limit = resident + cov_bytes + result_bytes + matrix_bytes + solve_bytes
        groups_s = sum(t for _, _, t in record["groups"])
        rest = sec - sum(record["solves"]) - record["copy_s"] - record["result_s"] - groups_s
        # The stage a user waits for leaves out this script's host copies of
        # each large solve's eigenpairs (for the residual check below).
        stage_sec = sec - record["copy_s"]
        log(f"Llama eigendecomposition: {stage_sec:.3f} s without the residual check's host "
            f"copies ({sec:.3f} s watched), peak {peak / 2**30:.3f} GiB against the "
            f"per-matrix limit {limit / 2**30:.3f} GiB = resident {resident / 2**30:.3f} + "
            f"covariance {cov_bytes / 2**30:.3f} + results {result_bytes / 2**30:.3f} + one "
            f"matrix {matrix_bytes / 2**30:.3f} + its solve {solve_bytes / 2**30:.3f} (one "
            f"{n} torch.linalg.eigh alone: {solve_sec:.3f} s); the other "
            f"{len(large) - 1} inputs stacked beside it would add "
            f"{(len(large) - 1) * n * n * 4 / 2**30:.3f} GiB; each {n} solve (build and "
            f"eigh), s: " + ", ".join(f"{s:.3f}" for s in record["solves"])
            + f"; casts and checkpoint writes {record['result_s']:.3f} s; host copies for the "
            f"residual check {record['copy_s']:.3f} s; batched groups " + ", ".join(
                f"{m} x {d} {t:.3f} s" for d, m, t in record["groups"])
            + f"; the covariance load and the artifact write {rest:.3f} s; scratch files as each landed "
            f"{[len(f) for f in record['files']]}, none after [{card}]")
        if not peak <= limit:
            raise RuntimeError(f"Llama eigendecomposition peak {peak:,} B over the per-matrix "
                               f"limit {limit:,} B")
        residuals = eigen_residuals(cov, record, order, device)
        limit_res = n * 2.0 ** -24
        for r in residuals:
            log(f"Llama eigenpairs {r['factor']} {r['module']} (n {r['n']}): "
                f"||C - Q L Q^T||_F / ||C||_F {r['residual']:.3e}, ||Q^T Q - I||_max "
                f"{r['orthogonality']:.3e} (limits n u = {limit_res:.3e}) [{card}]")
            if not (r["residual"] <= limit_res and r["orthogonality"] <= limit_res):
                raise RuntimeError(f"Llama eigenpairs off: {r}")
        out["seconds"]["eigendecomposition"] = stage_sec
        out["eigen"] = dict(solves=record["solves"], peak_bytes=peak, limit_bytes=limit,
                            solve_bytes=solve_bytes, residuals=residuals,
                            checkpoint_s=record["result_s"], groups=record["groups"],
                            rest_s=rest)
        del record

        # A rerun of the stage with two checkpoints planted (from the saved
        # eigenpairs) solves the other four, and gives the same bits.
        rerun = root / "rerun_scratch"
        for (pair_idx, name) in order[:LLAMA_PLANTED]:
            _c, _n, vec_name, val_name = _FACTOR_PAIRS[pair_idx]
            save_file({"evals": eigen[val_name][name], "evecs": eigen[vec_name][name]},
                      _checkpoint_path(rerun, val_name, name))
        record = watch_large_solves(rerun)
        cov_dev = {k: {m: t.to(device) for m, t in v.items()} for k, v in cov.items()}
        try:
            t0 = time.perf_counter()
            again = perform_eigendecomposition(cov_dev, recipe, scratch_dir=rerun)
            torch.cuda.synchronize()
            rerun_sec = time.perf_counter() - t0
        finally:
            unwatch_large_solves(record)
        del cov_dev
        solved = len(record["solves"])
        same = all(torch.equal(again[k][m].cpu(), eigen[k][m]) for k in eigen for m in eigen[k])
        log(f"Llama eigendecomposition rerun with {LLAMA_PLANTED} checkpoints planted: "
            f"{solved} of {len(large)} large matrices solved in {rerun_sec:.3f} s ("
            + ", ".join(f"{s:.3f}" for s in record["solves"]) + f" s), eigenpairs bitwise equal "
            f"to the first call's: {same} [{card}]")
        if solved != len(large) - LLAMA_PLANTED or not same:
            raise RuntimeError("Llama: the checkpointed rerun solved the planted matrices again "
                               "or changed the eigenpairs")
        del again, record
        shutil.rmtree(rerun)

        # (a) Lambda: partitions as the covariance.
        estimates.clear()
        with PassCounter(module, kernels) as counter:
            _, _, sec = peak_of(analyzer.fit_lambda_matrices, "ekfac", train, factor_args=recipe)
        close_estimate(estimates)
        lam_estimates = list(estimates)
        log_estimates(card, "Llama lambda", lam_estimates)
        check_llama_launches("lambda", counter.counts, layers)
        lam_batches = {e["batch_size"] for e in lam_estimates}
        if len(lam_batches) != 1:
            raise RuntimeError(f"Llama lambda: estimates {lam_estimates}")
        lam_batch = lam_batches.pop()
        out["seconds"]["lambda"] = sec
        out["launches"]["lambda"] = dict(counter.counts)
        log(f"Llama lambda: {sec:.3f} s, batch {lam_batch}, launches {counter.counts} [{card}]")

        # (a) Pairwise 8 x 32: rank-64 query blocks, then dense bf16 blocks,
        # then both with fp32 preconditioning. The rank-64 call's block is
        # recorded as the train pass received it (the module partitions' in
        # turn) for the contraction check below.
        scores, score_estimates, recorded = {}, {}, []
        collect = pairwise._collect_blocks

        def recording(blocks):
            out_blocks = collect(blocks)
            if current == "lowrank":
                recorded.append({n: [(l[:LLAMA_CHECK_QUERIES].clone(),
                                      r[:LLAMA_CHECK_QUERIES].clone()) for l, r in c]
                                 for n, c in out_blocks.items()})
            return out_blocks

        pairwise._collect_blocks = recording
        for name, rank, changes in LLAMA_SCORE_VARIANTS:
            current = name
            score_args = extreme_reduce_memory_score_arguments(query_gradient_low_rank=rank)
            for field, value in changes.items():
                setattr(score_args, field, value)
            estimates.clear()
            before = {row: s for row, s, _ in analyzer.profiler.rows()}
            with PassCounter(module, kernels) as counter:
                _, _, sec = peak_of(analyzer.compute_pairwise_scores, name, "ekfac", query,
                                    train, per_device_query_batch_size=LLAMA_QUERY_N,
                                    score_args=score_args)
            close_estimate(estimates)
            after = {row: s for row, s, _ in analyzer.profiler.rows()}
            parts = {key: after.get(row, 0.0) - before.get(row, 0.0) for key, row in (
                ("query gradients", "Pairwise: query gradients"),
                ("train pass", "Pairwise: train pass"))}
            log_estimates(card, f"Llama pairwise ({name})", estimates)
            check_llama_launches(f"pairwise ({name})", counter.counts, layers)
            scores[name] = analyzer.load_pairwise_scores(name)[ALL_MODULE_NAME].float()
            score_estimates[name] = list(estimates)
            out["seconds"][f"pairwise {name}"] = dict(parts, call=sec)
            out["launches"][f"pairwise {name}"] = dict(counter.counts)
            log(f"Llama pairwise {LLAMA_QUERY_N} x {LLAMA_TRAIN_N}, {name}: {sec:.3f} s "
                f"(query gradients {parts['query gradients']:.3f}, train pass "
                f"{parts['train pass']:.3f}), launches {counter.counts} [{card}]")
        pairwise._collect_blocks = collect
        for name, s in scores.items():
            if (tuple(s.shape) != (LLAMA_QUERY_N, LLAMA_TRAIN_N)
                    or not bool(torch.isfinite(s).all())):
                raise RuntimeError(f"Llama scores {name}: shape {tuple(s.shape)} or not finite")
        names = list(scores)
        rs = {f"{a} ~ {b}": pearson(scores[a], scores[b])
              for i, a in enumerate(names) for b in names[i + 1:]}
        log("Llama scores, Pearson r between variants: " + "; ".join(
            f"{k} {v:.6f}" for k, v in rs.items()) + f" (limit {LLAMA_PRECISION_PEARSON_MIN} "
            f"for each recipe against its fp32 twin) [{card}]")
        for pair in ("lowrank ~ lowrank fp32", "dense ~ dense fp32"):
            if not rs[pair] >= LLAMA_PRECISION_PEARSON_MIN:
                raise RuntimeError(f"Llama scores: {pair} r {rs[pair]:.6f}")
        out["pearson"] = rs
        out["lowrank_checks"] = llama_lowrank_checks(
            card, analyzer, model, task, query, train, device, recorded)
        del recorded
        written = artifact_bytes(root)
        log(f"Llama artifacts: {sum(written.values()):,} bytes written ("
            + ", ".join(f"{k} {v:,}" for k, v in written.items()) + ")")
        del scores

        # Partitions: the module-partitioned factors against unpartitioned
        # fits on the same batches (the stage functions, no artifacts).
        plain = copy.deepcopy(recipe)
        plain.covariance_module_partitions = plain.lambda_module_partitions = 1
        plain_cov = fit_covariance_matrices_with_loader(
            model, task, BatchLoader(train, cov_batch, device=device), plain)
        plain_lam = fit_lambda_matrices_with_loader(
            model, task, BatchLoader(train, lam_batch, device=device), plain,
            eigen_factors={k: {m: t.to(device) for m, t in v.items()} for k, v in eigen.items()})
        lam = analyzer.load_lambda_matrices("ekfac")
        gaps = {}
        for what, got, want, names in (("covariance", cov, plain_cov, COVARIANCE_FACTOR_NAMES),
                                       ("lambda", lam, plain_lam, LAMBDA_FACTOR_NAMES)):
            bitwise = _bitwise(got, want, names)
            gaps[what] = 0.0 if bitwise else _max_rel_all(
                {k: got[k] for k in names[:1]}, {k: want[k] for k in names[:1]}, names[:1])
            log(f"Llama {what}: {LLAMA_MODULE_PARTITIONS} module partitions against one fit on "
                f"the same batches: bitwise equal {bitwise} (max |diff| / max {gaps[what]:.3e}) "
                f"[{card}]")
            if not bitwise:
                raise RuntimeError(f"Llama {what}: partitioned and unpartitioned fits differ")
        del plain_lam, lam, eigen

        # (b) One covariance stage with the smart-low-precision recipe (no
        # partitions, no remat), its batch estimated too.
        smart = smart_low_precision_factor_arguments(strategy="ekfac")
        estimates.clear()
        with PassCounter(module, kernels) as counter:
            _, _, sec = peak_of(analyzer.fit_covariance_matrices, "smart", train,
                                factor_args=smart)
        close_estimate(estimates)
        log_estimates(card, "Llama covariance (smart low precision)", estimates)
        smart_batches = -(-LLAMA_TRAIN_N // estimates[0]["batch_size"])
        check_llama_launches("covariance (smart low precision)", counter.counts, layers,
                             covariance_fits=1, cov_batches=smart_batches)
        out["seconds"]["covariance smart"] = sec
        out["launches"]["covariance smart"] = dict(counter.counts)
        log(f"Llama covariance, smart low precision: {sec:.3f} s, batch "
            f"{estimates[0]['batch_size']}, K1 {counter.counts['syrk']} launches "
            f"({counter.counts['wgmma']} wgmma) = 12 x {smart_batches} batches [{card}]")
        out["estimates"] = dict(covariance=cov_estimates, lambda_=lam_estimates,
                                smart=list(estimates), **score_estimates)
        del analyzer

        # Flash against naive: the same weights with attention="naive", the
        # dataset's labels on both sides (as phase 10): labels sampled from
        # near-uniform logits flip where the two forms round differently.
        empirical = copy.deepcopy(plain)
        empirical.use_empirical_fisher = True
        del plain_cov
        flash_cov = fit_covariance_matrices_with_loader(
            model, task, BatchLoader(train, cov_batch, device=device), empirical)
        naive_module = llama_mod.init_llama(dataclasses.replace(config, attention="naive"),
                                            seed=0, device=device)
        naive_model = prepare_model(naive_module, task)
        naive_cov = fit_covariance_matrices_with_loader(
            naive_model, task, BatchLoader(train, cov_batch, device=device), empirical)
        worst = {}
        for factor_name in COVARIANCE_FACTOR_NAMES[:2]:
            for name, want in flash_cov[factor_name].items():
                worst[f"{factor_name} {name}"] = relative_to_max(naive_cov[factor_name][name], want)
        gap = max(worst.values())
        log(f"Llama covariance, flash against naive attention on the same weights and batches: "
            f"max |diff| / max |C| {gap:.3e} (limit {FLASH_FACTOR_RTOL:g}) [{card}]")
        if not gap <= FLASH_FACTOR_RTOL:
            raise RuntimeError(f"Llama flash against naive: {worst}")
        out["flash_vs_naive"] = gap
        # Phase 21 (a) solves this factor with the host-loop Jacobi.
        out["hostloop_matrix"] = (
            cov[COVARIANCE_FACTOR_NAMES[1]][HOSTLOOP_MODULE],
            float(cov[COVARIANCE_FACTOR_NAMES[3]][HOSTLOOP_MODULE]))
        del naive_module, naive_model, naive_cov, flash_cov, cov
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del module, model
    torch.cuda.empty_cache()
    out["batch"] = cov_batch
    out["peak_bytes"] = max([out["eigen"]["peak_bytes"]] + [
        e["peak_bytes"] for records in out["estimates"].values() for e in records])
    log(f"Llama: phase 15 took {time.perf_counter() - start:.1f} s; peak device memory "
        f"{out['peak_bytes'] / 2**30:.3f} GiB (the largest stage peak) [{card}]")
    return out


def gemma2b_config():
    """Gemma-2B's widths in the Llama class (the Gemma report, arXiv 2403.08295,
    Table 1, and the published google/gemma-2b config): d_model 2048, 8 heads
    and 1 KV head (head_dim 256), d_mlp 16384, vocabulary 256,000, RoPE theta
    10,000, RMS eps 1e-6; bf16 with flash attention; cut to GEMMA_LAYERS of 18
    layers. Llama's architecture, not Gemma's: SwiGLU for GeGLU, RMSNorm
    without the +1 offset, no sqrt(d) embedding scale, an untied head."""
    from kronfluence_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(d_model=2048, d_mlp=16384, num_heads=8, num_kv_heads=1,
                       vocab_size=256000, rope_theta=10000.0, rms_eps=1e-6,
                       num_layers=GEMMA_LAYERS, max_seq_len=SEQ, dtype=torch.bfloat16,
                       attention="flash")


def check_gemma_launches(stage: str, counts: dict, layers: int) -> None:
    """FFW (bf16 at D 256: the "wgmma_w" forward) once per attention layer
    and model forward, and at most once more per attention backward, where
    the recipe's rematerialisation recomputes an attention module (each holds
    tracked projections; the recomputation runs no forward hook); F2W and F3W (the
    "split_w" route) once per attention backward, and with attention
    tracking every backward pass reaches both layers; F1, F2, F3 and every
    other flash kernel, K2 and the naive form never."""
    fwd = sum(counts["attention forwards"].values())
    bwd = sum(counts["attention backwards"].values())
    want = {name: 0 for name in ("F1", "F2", "F3", "FF", "FB", "FFH", "FFS", "FFS64", "F2H", "F3H",
                                 "F2S", "F3S", "F2SH", "F3SH", "F2SW", "F3SW", "jacobi",
                                 "naive")}
    want.update(F2W=bwd, F3W=bwd)
    off = {k: (counts[k], v) for k, v in want.items() if counts[k] != v}
    if not fwd <= counts["FFW"] <= fwd + bwd:
        off["FFW"] = (counts["FFW"], (fwd, fwd + bwd))
    if fwd != layers * counts["forwards"] or bwd != layers * counts["backwards"]:
        off["attention passes"] = (fwd, bwd, counts["forwards"], counts["backwards"])
    if counts["backwards"] and layers > 1 and not bwd:
        off["no attention backward"] = counts["attention backwards"]
    if off:
        raise RuntimeError(f"Gemma {stage}: launches off (got, want): {off}")


def phase_gemma(card: str, device=torch.device("cuda", 0)) -> dict:
    """Phase 16: Llama at Gemma-2B's widths, GEMMA_LAYERS of 18 layers,
    through the Analyzer: the four attention projections of every layer
    tracked, the openwebtext recipe's covariance (its batch estimated),
    fp32 "auto" eigendecomposition, lambda and dense pairwise scores (one
    module partition, so that every backward reaches layer 0) for
    LLAMA_QUERY_N x LLAMA_TRAIN_N examples of synthetic tokens, every batch
    from the memory model. Every stage's backward runs F2W and F3W in both
    layers (the lowest tracked projection is in layer 0), and FFW every
    forward; F1, F2 and F3 never.
    The flash form's covariance is held against the naive form's on the
    same weights and batches. Returns the launches for the kernels line."""
    from kronfluence_tpu_torch import Analyzer, prepare_model
    from kronfluence_tpu_torch.factor.covariance import fit_covariance_matrices_with_loader
    from kronfluence_tpu_torch.models import llama as llama_mod
    from kronfluence_tpu_torch.ops.kernels.jacobi import jacobi_pivot_rotations
    from kronfluence_tpu_torch.ops.kernels.probe import probe
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk
    from kronfluence_tpu_torch.utils.common.factor_arguments import (
        extreme_reduce_memory_factor_arguments,
    )
    from kronfluence_tpu_torch.utils.common.score_arguments import (
        extreme_reduce_memory_score_arguments,
    )
    from kronfluence_tpu_torch.utils.constants import ALL_MODULE_NAME, COVARIANCE_FACTOR_NAMES
    from kronfluence_tpu_torch.utils.dataset import BatchLoader

    start = time.perf_counter()
    # What earlier phases left on the card counts in every stage's measured
    # peak but in no plan. Reference counting frees what a phase drops; only
    # a reference cycle waits for the collector, and none may hold device
    # memory: the collector's garbage is listed, and more than
    # GC_SLACK_BYTES freed by it fails the phase.
    before = torch.cuda.memory_allocated()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        gc.collect()
        garbage = list(gc.garbage)
        gc.garbage.clear()
    finally:
        gc.set_debug(0)
    with warnings.catch_warnings():  # isinstance on deprecated module attributes warns
        warnings.simplefilter("ignore")
        held = sorted(((x.nbytes, tuple(x.shape), str(x.dtype)) for x in garbage
                       if isinstance(x, torch.Tensor) and x.is_cuda), reverse=True)
        kinds = {}
        for x in garbage:
            if not isinstance(x, (dict, list, tuple, set, type(gc), torch.Tensor)):
                kinds[type(x).__qualname__] = kinds.get(type(x).__qualname__, 0) + 1
    del garbage
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    common = sorted(kinds.items(), key=lambda kv: -kv[1])[:12]
    log(f"Gemma: {before / 2**30:.3f} GiB allocated on the card as phase 16 starts, "
        f"{resident / 2**30:.3f} GiB after gc.collect(); the collector's garbage held "
        f"{len(held)} device tensors {held[:8]}, most common objects {common} [{card}]")
    if before - resident > GC_SLACK_BYTES:
        raise RuntimeError(f"Gemma: earlier phases left {(before - resident) / 2**30:.3f} GiB on "
                           f"the card in reference cycles: tensors {held[:8]}, objects {common}")
    config = gemma2b_config()
    layers = config.num_layers
    tracked = [f"layers_{i}/attn/{proj}" for i in range(layers)
               for proj in ("q_proj", "k_proj", "v_proj", "o_proj")]
    task = openwebtext_task(layers, tracked)
    module = llama_mod.init_llama(config, seed=0, device=device)
    torch.cuda.synchronize()
    params = sum(p.numel() for p in module.parameters())
    log(f"Gemma: Gemma-2B widths (d_model {config.d_model}, d_mlp {config.d_mlp}, "
        f"{config.num_heads} heads, {config.num_kv_heads} KV head, head_dim {config.head_dim}, "
        f"vocab {config.vocab_size:,}, T {SEQ}, RoPE theta {config.rope_theta:g}, RMS eps "
        f"{config.rms_eps:g}) in the Llama class, bf16, flash attention (forward route "
        f"wgmma_w: FFW; backward route split_w: F2W + F3W); reduced: {layers} of 18 layers, the "
        f"{len(tracked)} attention projections tracked, SwiGLU, RMSNorm without +1, no embedding "
        f"scale, untied head; {params:,} parameters from seed 0; {LLAMA_TRAIN_N} train and "
        f"{LLAMA_QUERY_N} query examples of synthetic tokens [{card}]")
    train = make_tokens(LLAMA_TRAIN_N, SEQ, config.vocab_size, 31, device)
    query = make_tokens(LLAMA_QUERY_N, SEQ, config.vocab_size, 32, device)
    recipe = extreme_reduce_memory_factor_arguments(strategy="ekfac")
    recipe.eigendecomposition_dtype = "float32"
    recipe.eigendecomposition_solver = "auto"
    kernels = dict(flash_kernels(), syrk=syrk, probe=probe, jacobi=jacobi_pivot_rotations)
    root = Path(tempfile.mkdtemp(prefix="kf_chip_smoke_gemma_"))
    out = {"seconds": {}, "launches": {}}
    try:
        analyzer = Analyzer("gemma", prepare_model(module, task), task, profile=True,
                            output_dir=str(root), cpu=device.type == "cpu")
        estimates = watch_estimates(analyzer)
        stages = (
            ("covariance", lambda: analyzer.fit_covariance_matrices("ekfac", train,
                                                                    factor_args=recipe)),
            ("eigendecomposition", lambda: analyzer.perform_eigendecomposition(
                "ekfac", factor_args=recipe)),
            ("lambda", lambda: analyzer.fit_lambda_matrices("ekfac", train, factor_args=recipe)),
            ("pairwise", lambda: analyzer.compute_pairwise_scores(
                "dense", "ekfac", query, train, per_device_query_batch_size=LLAMA_QUERY_N,
                score_args=extreme_reduce_memory_score_arguments(module_partitions=1))),
        )
        for stage, run in stages:
            estimates.clear()
            with PassCounter(module, kernels) as counter:
                _, _, sec = peak_of(run)
            close_estimate(estimates)
            log_estimates(card, f"Llama (Gemma) {stage}", estimates)
            if stage == "eigendecomposition":
                if counter.counts["forwards"] or any(counter.counts[k] for k in kernels):
                    raise RuntimeError(f"Gemma eigendecomposition launched {counter.counts}")
            else:
                check_gemma_launches(stage, counter.counts, layers)
            if stage == "covariance":
                out["batch"] = estimates[0]["batch_size"]
                if out["batch"] != GEMMA_BATCH:
                    raise RuntimeError(f"Gemma covariance: the memory model's batch "
                                       f"{out['batch']} is not GEMMA_BATCH ({GEMMA_BATCH}), at "
                                       f"which phase 9 holds and times F2W and F3W")
            out["seconds"][stage] = sec
            out["launches"][stage] = dict(counter.counts)
            log(f"Gemma {stage}: {sec:.3f} s, batch "
                f"{[e['batch_size'] for e in estimates] or '-'}, launches {counter.counts} [{card}]")
        scores = analyzer.load_pairwise_scores("dense")[ALL_MODULE_NAME].float()
        if (tuple(scores.shape) != (LLAMA_QUERY_N, LLAMA_TRAIN_N)
                or not bool(torch.isfinite(scores).all())):
            raise RuntimeError(f"Gemma scores: shape {tuple(scores.shape)} or not finite")
        log(f"Gemma pairwise scores {tuple(scores.shape)}, all finite; max |score| "
            f"{float(scores.abs().max()):.4g} [{card}]")
        model = analyzer.model
        del analyzer, scores

        # Flash against naive: the same weights with attention="naive", the
        # dataset's labels on both sides (phase 15's comparison).
        empirical = copy.deepcopy(recipe)
        empirical.use_empirical_fisher = True
        empirical.covariance_module_partitions = 1
        batch = out["batch"]
        flash_cov = fit_covariance_matrices_with_loader(
            model, task, BatchLoader(train, batch, device=device), empirical)
        naive_module = llama_mod.init_llama(dataclasses.replace(config, attention="naive"),
                                            seed=0, device=device)
        naive_cov = fit_covariance_matrices_with_loader(
            prepare_model(naive_module, task), task, BatchLoader(train, batch, device=device),
            empirical)
        worst = {f"{factor_name} {name}": relative_to_max(naive_cov[factor_name][name], want)
                 for factor_name in COVARIANCE_FACTOR_NAMES[:2]
                 for name, want in flash_cov[factor_name].items()}
        gap = max(worst.values())
        log(f"Gemma covariance, flash against naive attention on the same weights and batches: "
            f"max |diff| / max |C| {gap:.3e} over {len(worst)} factors (limit "
            f"{FLASH_FACTOR_RTOL:g}) [{card}]")
        if not gap <= FLASH_FACTOR_RTOL:
            raise RuntimeError(f"Gemma flash against naive: {worst}")
        out["flash_vs_naive"] = gap
        del naive_module, naive_cov, flash_cov, model
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del module
    torch.cuda.empty_cache()
    out["total"] = {key: sum(c[key] for c in out["launches"].values())
                    for key in ("F1", "F2", "F3", "FFW", "F2W", "F3W")}
    log(f"Gemma: phase 16 took {time.perf_counter() - start:.1f} s; launches over its stages "
        f"{out['total']} [{card}]")
    return out


def classification_task():
    """bench_cifar.py's task: summed cross-entropy on fp32 logits (images
    cast to the model's dtype), the model's own labels drawn for the true
    Fisher; the measurement is the train loss."""
    from kronfluence_tpu_torch.task import Task

    class ClassificationTask(Task):
        def compute_train_loss(self, batch, model, sample=False, generator=None):
            x = batch["x"].to(next(model.parameters()).dtype)
            logits = model(x).float()
            if sample:
                probs = torch.softmax(logits.detach(), dim=-1)
                labels = torch.multinomial(probs, 1, generator=generator).squeeze(-1)
            else:
                labels = batch["y"]
            return F.cross_entropy(logits, labels, reduction="sum")

        def compute_measurement(self, batch, model):
            return self.compute_train_loss(batch, model)

    return ClassificationTask()


def make_images(n: int, size: int, classes: int, seed: int, device) -> dict:
    """Synthetic NCHW images (standard normal, fp32) and labels, drawn on
    `device` from a seeded generator."""
    gen = torch.Generator(device).manual_seed(seed)
    return {"x": torch.randn(n, 3, size, size, generator=gen, device=device),
            "y": torch.randint(0, classes, (n,), generator=gen, device=device)}


def k1_grams_per_batch(specs: dict, act_accum, grad_accum) -> int:
    """K1 launches a covariance batch makes, from the layer shapes: each gram
    whose width passes `syrk_supported` (a bordered activation gram is taken
    at its width without the bias column; a conv's activation gram is that
    of its im2col patches)."""
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk_supported

    return sum(syrk_supported(spec.in_dim, act_accum) + syrk_supported(spec.out_dim, grad_accum)
               for spec in specs.values())


def check_vision_launches(label: str, stage: str, counts: dict, k1: int, k3: int) -> None:
    """In a vision model's stage: K1 `k1` times (none on a 16-bit kernel
    where `k1` counts fp32 grams), K3 `k3` times, K2, the flash kernels and
    the naive attention form never."""
    want = {name: 0 for name in counts if name not in ("forwards", "backwards",
                                                      "attention forwards",
                                                      "attention backwards", "wgmma")}
    want.update(syrk=k1, probe=k3)
    off = {k: (counts[k], v) for k, v in want.items() if counts[k] != v}
    if off:
        raise RuntimeError(f"{label} {stage}: launches off (got, want): {off}")


def check_finite_factors(label: str, analyzer, name: str, device) -> int:
    """Every factor the Analyzer wrote for `name`, read back onto the card,
    is finite; returns how many tensors were read."""
    from kronfluence_tpu_torch.factor import io as factor_io

    fdir = analyzer.factors_output_dir(name)
    tensors = 0
    for load in (factor_io.load_covariance_matrices, factor_io.load_eigendecomposition,
                 factor_io.load_lambda_matrices):
        for factor, per_module in load(fdir, device=device).items():
            for module, t in per_module.items():
                tensors += 1
                if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                    raise RuntimeError(f"{label}: {factor} of {module} is not finite")
    return tensors


def stages_card_against_cpu(module, task, host: dict, batch: int, tracked=None,
                            device=torch.device("cuda", 0), cpu_dtype=None) -> dict:
    """`module` (fp32) through the stage functions on the CPU and then on
    `device`, on the same host data ("cov", "lambda", "query", "train"
    columns): covariances, eigenvalues, lambda (on the CPU's eigenvectors),
    pairwise and self scores, each side's max |card - CPU| / max |CPU|, with
    the heuristic damping; EK-FAC fits lambda in the eigenbasis, and the two
    solvers may pick different bases for close eigenvalues. `cpu_dtype`
    float64 runs the CPU side on a float64 copy with float64 factors and
    scores: the exact answer the card's fp32 is held to. Returns the gaps,
    the card side's covariance factors and its K1 launches (and those on a
    16-bit route)."""
    from kronfluence_tpu_torch.arguments import FactorArguments, ScoreArguments
    from kronfluence_tpu_torch.factor.covariance import fit_covariance_matrices_with_loader
    from kronfluence_tpu_torch.factor.eigen import (
        fit_lambda_matrices_with_loader,
        perform_eigendecomposition,
    )
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk
    from kronfluence_tpu_torch.prepare import prepare_model
    from kronfluence_tpu_torch.score.pairwise import compute_pairwise_scores_with_loaders
    from kronfluence_tpu_torch.score.self_scores import compute_self_scores_with_loaders
    from kronfluence_tpu_torch.utils.constants import (
        ACTIVATION_COVARIANCE_MATRIX_NAME,
        ACTIVATION_EIGENVALUES_NAME,
        GRADIENT_COVARIANCE_MATRIX_NAME,
        GRADIENT_EIGENVALUES_NAME,
        LAMBDA_MATRIX_NAME,
    )
    from kronfluence_tpu_torch.utils.dataset import BatchLoader

    card_device = device
    args = {None: (FactorArguments(strategy="ekfac", use_empirical_fisher=True,
                                   eigendecomposition_dtype="float32"),
                   ScoreArguments(damping_factor=None))}
    if cpu_dtype is not None:
        name = str(cpu_dtype).removeprefix("torch.")
        args[cpu_dtype] = (
            FactorArguments(strategy="ekfac", use_empirical_fisher=True,
                            eigendecomposition_dtype=name, activation_covariance_dtype=name,
                            gradient_covariance_dtype=name, per_sample_gradient_dtype=name,
                            lambda_dtype=name),
            ScoreArguments(damping_factor=None, score_dtype=name, per_sample_gradient_dtype=name,
                           precondition_dtype=name))
    out, eig_cpu = {}, None
    for side in ("cpu", "card"):
        device = torch.device("cpu") if side == "cpu" else card_device
        dtype = cpu_dtype if side == "cpu" else None
        factor_args, score_args = args[dtype]

        def cast(t):
            return t.to(dtype) if dtype is not None and t.is_floating_point() else t

        side_module = module if dtype is None else copy.deepcopy(module).to(dtype)
        model = prepare_model(side_module.to(device), task)
        data = {k: {c: cast(v).to(device) for c, v in cols.items()} for k, cols in host.items()}
        before, f16 = syrk.launches, syrk.f16_launches
        cov = fit_covariance_matrices_with_loader(
            model, task, BatchLoader(data["cov"], batch, device=device), factor_args,
            tracked_names=tracked)
        eig = perform_eigendecomposition(cov, factor_args)
        eig_cpu = eig if eig_cpu is None else eig_cpu
        shared = {k: {m: t.to(device=device, dtype=eig[k][m].dtype) for m, t in v.items()}
                  for k, v in eig_cpu.items()}
        lam = fit_lambda_matrices_with_loader(
            model, task, BatchLoader(data["lambda"], batch, device=device), factor_args,
            eigen_factors=shared, tracked_names=tracked)
        factors = {**cov, **shared, **lam}
        pairwise = compute_pairwise_scores_with_loaders(
            model, task, BatchLoader(data["query"], 4, device=device),
            BatchLoader(data["train"], batch, device=device), factors, factor_args, score_args,
            tracked_names=tracked)
        self_scores = compute_self_scores_with_loaders(
            model, task, BatchLoader(data["train"], batch, device=device), factors, factor_args,
            score_args, tracked_names=tracked)
        out[side] = (cov, eig, lam, pairwise, self_scores, syrk.launches - before,
                     syrk.f16_launches - f16)
    cov_c, eig_c, lam_c, pair_c, self_c, _, _ = out["cpu"]
    cov_g, eig_g, lam_g, pair_g, self_g, k1_launches, k1_f16 = out["card"]
    diffs = {
        "covariance": max(_max_rel(cov_g[k], cov_c[k])
                          for k in (ACTIVATION_COVARIANCE_MATRIX_NAME,
                                    GRADIENT_COVARIANCE_MATRIX_NAME)),
        "eigenvalues": max(_max_rel(eig_g[k], eig_c[k])
                           for k in (ACTIVATION_EIGENVALUES_NAME, GRADIENT_EIGENVALUES_NAME)),
        "lambda": _max_rel(lam_g[LAMBDA_MATRIX_NAME], lam_c[LAMBDA_MATRIX_NAME]),
        "pairwise": _max_rel(pair_g, pair_c),
        "self": _max_rel(self_g, self_c),
    }
    return dict(diffs=diffs, cov=cov_g, k1=k1_launches, k1_f16=k1_f16)


def vision_reference(card: str, label: str, module, k1_per_batch: int, tracked=None,
                     device=torch.device("cuda", 0)) -> dict:
    """One fp32 vision model (32x32 images, 10 classes; `tracked` names its
    tracked layers, all by default) through the stage functions on the card
    and on the CPU, as phase 6 does for GPT-2 (`stages_card_against_cpu`):
    covariances, eigenvalues, lambda, pairwise and self scores within
    REFERENCE_RTOL of max; K1 `k1_per_batch` times a covariance batch on the
    card side, on its fp32 route."""
    from kronfluence_tpu_torch.utils.constants import ACTIVATION_COVARIANCE_MATRIX_NAME

    n, batch = CIFAR_REFERENCE_N, 16
    host = {k: make_images(count, 32, 10, seed, "cpu")
            for k, count, seed in (("cov", n, 41), ("lambda", n, 42), ("query", 8, 43),
                                   ("train", 32, 44))}
    run = stages_card_against_cpu(module, classification_task(), host, batch, tracked, device)
    diffs, k1_launches, k1_f16 = run["diffs"], run["k1"], run["k1_f16"]
    k1_want = k1_per_batch * -(-n // batch)
    log(f"CIFAR reference, {label}: card vs CPU, max |diff| / max |ref|: "
        + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items())
        + f" (limit {REFERENCE_RTOL:g}); {len(run['cov'][ACTIVATION_COVARIANCE_MATRIX_NAME])} "
        f"tracked layers; K1 launches on the card side {k1_launches} (want {k1_want}: {k1_per_batch} in each "
        f"of {-(-n // batch)} covariance batches), {k1_f16} on a 16-bit route [{card}]")
    if k1_launches != k1_want or k1_f16:
        raise RuntimeError(f"CIFAR reference, {label}: K1 launched {k1_launches} times, "
                           f"{k1_f16} on a 16-bit route")
    bad = {k: v for k, v in diffs.items() if not v <= REFERENCE_RTOL}
    if bad:
        raise RuntimeError(f"CIFAR reference, {label}: card disagrees with the CPU: {bad}")
    return diffs


def cifar_reference(card: str) -> dict:
    """Phase 17 (a): `vision_reference` on a small SmallCNN (channels 16 and
    32, bias, stride 2, the second conv in 4 groups; its head's 2048-wide
    activation gram takes K1), then on ResNet-9 at full width on
    CIFAR_REFERENCE_TRACKED (layer3/conv's 2304-wide im2col gram takes K1)."""
    from kronfluence_tpu_torch.models.cnn import SmallCNN
    from kronfluence_tpu_torch.models.resnet import ResNet9, init_vision

    small = init_vision(
        SmallCNN(num_classes=10, channels=(16, 32), use_bias=True, strides=(2, 2), groups=4,
                 image_size=(32, 32)), seed=0, device="cpu")
    resnet9 = init_vision(ResNet9(num_classes=10), seed=1, device="cpu")
    return {
        "smallcnn": vision_reference(
            card, "small fp32 SmallCNN (channels 16 and 32, bias, stride 2, 4 groups)", small, 1),
        "resnet9": vision_reference(card, "fp32 ResNet-9 on a tracked subset", resnet9, 1,
                                    tracked=CIFAR_REFERENCE_TRACKED),
    }


def phase_cifar(card: str, device=torch.device("cuda", 0)) -> dict:
    """Phase 17: (a) `cifar_reference`; (b) bench_cifar.py's workload at full
    width through the Analyzer: ResNet-9 (10 classes, 32x32x3) in bf16 with
    seeded random weights and BatchNorm statistics, the smart-low-precision
    EK-FAC recipe with the empirical Fisher and an fp32 eigendecomposition,
    smart-low-precision self scores, and CIFAR_QUERY_N x CIFAR_TRAIN_N
    pairwise scores whose queries are the first train examples, so that the
    diagonal is their self-influence; every batch from the memory model, and
    each stage's measured peak within what its estimate planned. K1 as many
    times a covariance batch as the shapes give (`k1_grams_per_batch`: 3),
    K3 once a covariance fit. Returns the stages' launches and the checks'
    numbers."""
    from kronfluence_tpu_torch import Analyzer, prepare_model
    from kronfluence_tpu_torch.factor.covariance import discover_stage_specs
    from kronfluence_tpu_torch.models.resnet import ResNet9, init_vision
    from kronfluence_tpu_torch.ops.kernels.jacobi import jacobi_pivot_rotations
    from kronfluence_tpu_torch.ops.kernels.probe import probe
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk
    from kronfluence_tpu_torch.utils.common.factor_arguments import (
        smart_low_precision_factor_arguments,
    )
    from kronfluence_tpu_torch.utils.common.score_arguments import (
        smart_low_precision_score_arguments,
    )
    from kronfluence_tpu_torch.utils.constants import ALL_MODULE_NAME

    start = time.perf_counter()
    out = {"reference": cifar_reference(card), "seconds": {}, "launches": {}, "batches": {},
           "peaks": {}}
    task = classification_task()
    module = init_vision(ResNet9(num_classes=10), seed=0, device=device).to(torch.bfloat16)
    sizes = {"covariance": CIFAR_COV_N, "lambda": CIFAR_LAMBDA_N, "self": CIFAR_SELF_N,
             "pairwise": f"{CIFAR_QUERY_N} x {CIFAR_TRAIN_N}"}
    log(f"CIFAR: ResNet-9 (10 classes, 32x32x3), bf16, {sum(p.numel() for p in module.parameters()):,} "
        f"parameters and BatchNorm statistics from seed 0; examples a stage {sizes} (cut from "
        f"bench_cifar.py's 6144 / 4096 / 4096); synthetic images [{card}]")
    cov_data = make_images(CIFAR_COV_N, CIFAR_SIZE, 10, 51, device)
    lambda_data = make_images(CIFAR_LAMBDA_N, CIFAR_SIZE, 10, 52, device)
    self_data = make_images(CIFAR_SELF_N, CIFAR_SIZE, 10, 53, device)
    query = {k: v[:CIFAR_QUERY_N] for k, v in self_data.items()}
    train = {k: v[:CIFAR_TRAIN_N] for k, v in self_data.items()}
    recipe = smart_low_precision_factor_arguments(strategy="ekfac")
    recipe.use_empirical_fisher = True
    recipe.eigendecomposition_dtype = "float32"
    score_args = smart_low_precision_score_arguments()
    kernels = dict(flash_kernels(), syrk=syrk, probe=probe, jacobi=jacobi_pivot_rotations)
    model = prepare_model(module, task)
    specs = discover_stage_specs(model, task, {k: v[:2] for k, v in cov_data.items()})
    k1_per_batch = k1_grams_per_batch(specs, torch.float32, torch.float32)
    log(f"CIFAR: {len(specs)} tracked layers; K1 grams a covariance batch from the shapes "
        f"{k1_per_batch} (want {CIFAR_K1_PER_BATCH}) [{card}]")
    if k1_per_batch != CIFAR_K1_PER_BATCH:
        raise RuntimeError(f"CIFAR: the shapes give {k1_per_batch} K1 grams a batch, not "
                           f"{CIFAR_K1_PER_BATCH}")
    root = Path(tempfile.mkdtemp(prefix="kf_chip_smoke_cifar_"))
    try:
        analyzer = Analyzer("cifar", model, task, profile=True,
                            output_dir=str(root), cpu=device.type == "cpu")
        estimates = watch_estimates(analyzer)
        stages = (
            ("covariance", lambda: analyzer.fit_covariance_matrices(
                "ekfac", cov_data, factor_args=recipe)),
            ("eigendecomposition", lambda: analyzer.perform_eigendecomposition(
                "ekfac", factor_args=recipe)),
            ("lambda", lambda: analyzer.fit_lambda_matrices(
                "ekfac", lambda_data, factor_args=recipe)),
            ("self", lambda: analyzer.compute_self_scores(
                "self", "ekfac", self_data, score_args=score_args)),
            ("pairwise", lambda: analyzer.compute_pairwise_scores(
                "pairwise", "ekfac", query, train, per_device_query_batch_size=CIFAR_QUERY_N,
                score_args=score_args)),
        )
        for stage, run in stages:
            estimates.clear()
            with PassCounter(module, kernels) as counter:
                _, peak, sec = peak_of(run)
            close_estimate(estimates)
            log_estimates(card, f"CIFAR {stage}", estimates, within_plan=True)
            batches = [e["batch_size"] for e in estimates]
            k1 = k1_per_batch * -(-CIFAR_COV_N // batches[0]) if stage == "covariance" else 0
            check_vision_launches("CIFAR", stage, counter.counts, k1,
                                  1 if stage == "covariance" else 0)
            out["seconds"][stage], out["peaks"][stage] = sec, peak
            out["launches"][stage], out["batches"][stage] = dict(counter.counts), batches
            if stage == "covariance":
                out["k1_per_covariance_batch"] = (
                    counter.counts["syrk"] / -(-CIFAR_COV_N // batches[0]))
            log(f"CIFAR {stage}: {sec:.3f} s, batch {batches or '-'}, peak "
                f"{peak / 2**30:.3f} GiB, launches {counter.counts} (K1 want {k1}) [{card}]")
        if not out["batches"]["self"][0] < CIFAR_SELF_N:
            raise RuntimeError(f"CIFAR self: the estimate took all {CIFAR_SELF_N} examples in "
                               f"one batch ({out['batches']['self']}); its plan never bound")
        tensors = check_finite_factors("CIFAR", analyzer, "ekfac", device)
        self_scores = analyzer.load_self_scores("self")[ALL_MODULE_NAME].float()
        pairwise = analyzer.load_pairwise_scores("pairwise")[ALL_MODULE_NAME].float()
        if (tuple(self_scores.shape) != (CIFAR_SELF_N,)
                or tuple(pairwise.shape) != (CIFAR_QUERY_N, CIFAR_TRAIN_N)
                or not bool(torch.isfinite(self_scores).all() & torch.isfinite(pairwise).all())):
            raise RuntimeError(f"CIFAR scores: shapes {tuple(self_scores.shape)}, "
                               f"{tuple(pairwise.shape)} or not finite")
        diagonal = torch.diagonal(pairwise)
        scale = float(diagonal.abs().max())
        self_gap = float((self_scores[:CIFAR_QUERY_N] - diagonal).abs().max()) / scale
        fault = float((self_scores[:CIFAR_QUERY_N] - torch.diagonal(pairwise, 1)).abs().max()
                      ) / scale
        log(f"CIFAR: {tensors} factor tensors read back, all finite; self scores against the "
            f"pairwise diagonal: max |self - diagonal| / max |diagonal| {self_gap:.3e} (limit "
            f"{SELF_DIAGONAL_RTOL:g}); planted fault (the first superdiagonal) {fault:.3e}; "
            f"|self| max {float(self_scores.abs().max()):.4e} [{card}]")
        if not self_gap <= SELF_DIAGONAL_RTOL:
            raise RuntimeError(f"CIFAR self scores off the pairwise diagonal: {self_gap:.3e}")
        if not fault > SELF_DIAGONAL_RTOL:
            raise RuntimeError(f"CIFAR: the self-score check passes a planted fault: {fault:.3e}")
        out["self_vs_diagonal"] = self_gap
        del analyzer
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del model, module, cov_data, lambda_data, self_data, query, train
    torch.cuda.empty_cache()
    out["total"] = {key: sum(c[key] for c in out["launches"].values())
                    for key in ("syrk", "probe")}
    log(f"CIFAR: phase 17 took {time.perf_counter() - start:.1f} s; stage seconds "
        f"{out['seconds']}; launches over its stages {out['total']} [{card}]")
    return out


def watch_cusolver_groups() -> tuple:
    """Wraps the eigendecomposition's batched cuSOLVER group: records each
    group's (dimension, matrices)."""
    from kronfluence_tpu_torch.factor import eigen as eigen_mod

    real, groups = eigen_mod._cusolver_group, []

    def recorded(covariance_factors, eigen_factors, entries):
        groups.append((entries[0][1], len(entries)))
        return real(covariance_factors, eigen_factors, entries)

    eigen_mod._cusolver_group = recorded
    return real, groups


def time_k1_fp32(card: str, rows: int, n: int) -> dict:
    """K1's fp32 route (the ring kernel on `f32_plan`'s split, and its
    reduction) at (rows, n) against `torch.mm(a.T, a)` (fp32, TF32 off; the
    plain version is that same product), by torch.profiler device time in
    turns (kernel, library, library, kernel), held first to the plain version
    (phase 4's limit), to exact symmetry and to its own bits on a second
    call, beside the bound."""
    from kronfluence_tpu_torch.ops.kernels.syrk import f32_plan, syrk, syrk_reference

    gen = torch.Generator("cuda").manual_seed(7)
    a = torch.randn(rows, n, generator=gen, device="cuda")
    got, again, want = syrk(a), syrk(a), syrk_reference(a)
    units = syrk_units(got, want)
    if not units <= 1.0:
        raise RuntimeError(f"K1 fp32 at {rows} x {n}: {units:.3f} units of the limit")
    if not torch.equal(got, got.T):
        raise RuntimeError(f"K1 fp32 at {rows} x {n} is not exactly symmetric")
    if not torch.equal(got, again):
        raise RuntimeError(f"K1 fp32 at {rows} x {n} gave other bits on a second call")
    plan = f32_plan(rows, n, torch.cuda.get_device_properties(0).multi_processor_count)
    k1 = device_ms(lambda: syrk(a))
    lib1 = device_ms(lambda: torch.mm(a.T, a))
    lib2 = device_ms(lambda: torch.mm(a.T, a))
    k2 = device_ms(lambda: syrk(a))
    flops = float(rows) * n * (n + 1)
    bound, bound_by = roofline(rows * n * 4 + n * n * 4, flops, FP32_FLOPS)
    kernel_ms, lib_ms = (k1 + k2) / 2, (lib1 + lib2) / 2
    peak_pct = 100 * flops / kernel_ms / 1e9 / (FP32_FLOPS / 1e12)
    log(f"K1 fp32 at a ResNet-50 gram, {rows} x {n}: kernel {kernel_ms:.4f} ms "
        f"({k1:.4f}, {k2:.4f}), torch.mm(a.T, a) fp32 {lib_ms:.4f} ms ({lib1:.4f}, {lib2:.4f}), "
        f"kernel/library {kernel_ms / lib_ms:.3f}; bound {bound:.4f} ms ({bound_by}); "
        f"{units:.4f} units of the limit, symmetric, bitwise twice; kernel "
        f"{flops / kernel_ms / 1e9:.1f} TFLOP/s on the triangle, {peak_pct:.1f}% of the fp32 "
        f"peak; plan s {plan.splits} x {plan.span} rows; device time [{card}]")
    return {"rows": rows, "n": n, "ms": kernel_ms, "plain_ms": lib_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": lib_ms, "splits": plan.splits,
            "fp32_peak_pct": peak_pct, "max_abs_err": float((got - want).abs().max())}


def phase_imagenet(card: str, device=torch.device("cuda", 0)) -> dict:
    """Phase 18: ResNet-50 at full width and depth ((3, 4, 6, 3), 1000
    classes, 224x224x3, fp32) with seeded random weights and BatchNorm
    statistics (init's bn3 scale of 0 would zero every residual branch),
    through the Analyzer with examples/imagenet/analyze.py's recipe:
    FactorArguments(strategy="ekfac") (true Fisher) with an fp32
    eigendecomposition, dense pairwise scores and rank-32 ones, on
    IMAGENET_N examples a factor stage and IMAGENET_QUERY_N x IMAGENET_TRAIN_N
    pairs, every batch from the memory model. K1 on its fp32 route as many
    times a covariance batch as the shapes give (`k1_grams_per_batch`: 16),
    K3 once a covariance fit, every eigendecomposition by cuSOLVER, the
    factors and scores finite, each stage's peak within its budget and its
    plan; rank 32 against dense by Pearson r, printed, and the modules that
    carry the dense scores (per-module scores, summed for the total). Then
    K1's fp32 time at stage 3's gram widths (`time_k1_fp32`)."""
    from kronfluence_tpu_torch import Analyzer, FactorArguments, ScoreArguments, prepare_model
    from kronfluence_tpu_torch.factor import eigen as eigen_mod
    from kronfluence_tpu_torch.factor.covariance import discover_stage_specs
    from kronfluence_tpu_torch.models.resnet import init_vision, resnet50
    from kronfluence_tpu_torch.ops.kernels.jacobi import jacobi_pivot_rotations
    from kronfluence_tpu_torch.ops.kernels.probe import probe
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk
    from kronfluence_tpu_torch.utils.constants import ALL_MODULE_NAME

    start = time.perf_counter()
    task = classification_task()
    module = init_vision(resnet50(num_classes=1000), seed=0, device=device)
    cov_data = make_images(IMAGENET_N, IMAGENET_SIZE, 1000, 61, device)
    lambda_data = make_images(IMAGENET_N, IMAGENET_SIZE, 1000, 62, device)
    train = make_images(IMAGENET_TRAIN_N, IMAGENET_SIZE, 1000, 63, device)
    query = make_images(IMAGENET_QUERY_N, IMAGENET_SIZE, 1000, 64, device)
    model = prepare_model(module, task)
    specs = discover_stage_specs(model, task, {k: v[:2] for k, v in cov_data.items()})
    k1_per_batch = k1_grams_per_batch(specs, torch.float32, torch.float32)
    widest = max(max(s.activation_dim, s.gradient_dim) for s in specs.values())
    log(f"ImageNet: ResNet-50 ((3, 4, 6, 3), 1000 classes, 224x224x3), fp32, "
        f"{sum(p.numel() for p in module.parameters()):,} parameters, weights and BatchNorm "
        f"statistics from seed 0; {len(specs)} tracked layers, widest factor {widest}; K1 grams "
        f"a covariance batch from the shapes {k1_per_batch} (want {IMAGENET_K1_PER_BATCH}); "
        f"{IMAGENET_N} examples a factor stage, {IMAGENET_QUERY_N} x {IMAGENET_TRAIN_N} pairs; "
        f"synthetic images [{card}]")
    if k1_per_batch != IMAGENET_K1_PER_BATCH:
        raise RuntimeError(f"ImageNet: the shapes give {k1_per_batch} K1 grams a batch, not "
                           f"{IMAGENET_K1_PER_BATCH}")
    recipe = FactorArguments(strategy="ekfac")
    recipe.eigendecomposition_dtype = "float32"
    kernels = dict(flash_kernels(), syrk=syrk, probe=probe, jacobi=jacobi_pivot_rotations)
    out = {"seconds": {}, "launches": {}, "batches": {}, "peaks": {}, "f32_reduce_launches": {}}
    root = Path(tempfile.mkdtemp(prefix="kf_chip_smoke_imagenet_"))
    real_group, groups = watch_cusolver_groups()
    try:
        analyzer = Analyzer("imagenet", model, task, profile=True, output_dir=str(root),
                            cpu=device.type == "cpu")
        estimates = watch_estimates(analyzer)
        stages = (
            ("covariance", lambda: analyzer.fit_covariance_matrices(
                "ekfac", cov_data, factor_args=recipe)),
            ("eigendecomposition", lambda: analyzer.perform_eigendecomposition(
                "ekfac", factor_args=recipe)),
            ("lambda", lambda: analyzer.fit_lambda_matrices(
                "ekfac", lambda_data, factor_args=recipe)),
            ("pairwise dense", lambda: analyzer.compute_pairwise_scores(
                "dense", "ekfac", query, train, per_device_query_batch_size=IMAGENET_QUERY_N,
                score_args=ScoreArguments(compute_per_module_scores=True))),
            (f"pairwise rank {IMAGENET_RANK}", lambda: analyzer.compute_pairwise_scores(
                "lowrank", "ekfac", query, train, per_device_query_batch_size=IMAGENET_QUERY_N,
                score_args=ScoreArguments(query_gradient_low_rank=IMAGENET_RANK))),
        )
        for stage, run in stages:
            estimates.clear()
            f16, reductions = syrk.f16_launches, syrk.f32_reduce_launches
            with PassCounter(module, kernels) as counter:
                _, peak, sec = peak_of(run)
            close_estimate(estimates)
            log_estimates(card, f"ImageNet {stage}", estimates, within_plan=True)
            batches = [e["batch_size"] for e in estimates]
            k1 = k1_per_batch * -(-IMAGENET_N // batches[0]) if stage == "covariance" else 0
            check_vision_launches("ImageNet", stage, counter.counts, k1,
                                  1 if stage == "covariance" else 0)
            if counter.counts["wgmma"] or syrk.f16_launches != f16:
                raise RuntimeError(f"ImageNet {stage}: K1 left its fp32 route: {counter.counts}")
            # The fp32 route's reductions: one a gram whose rows the plan
            # splits (at a covariance batch of 48, every gram's but the
            # classifier's activation gram, 48 rows).
            reduced = syrk.f32_reduce_launches - reductions
            if device.type == "cuda" and not (0 < reduced <= k1 if k1 else reduced == 0):
                raise RuntimeError(f"ImageNet {stage}: K1's fp32 reduction launched {reduced} "
                                   f"times over {k1} grams")
            out["f32_reduce_launches"][stage] = reduced
            out["seconds"][stage], out["peaks"][stage] = sec, peak
            out["launches"][stage], out["batches"][stage] = dict(counter.counts), batches
            if stage == "covariance":
                out["k1_per_covariance_batch"] = (
                    counter.counts["syrk"] / -(-IMAGENET_N // batches[0]))
            log(f"ImageNet {stage}: {sec:.3f} s, batch {batches or '-'}, peak "
                f"{peak / 2**30:.3f} GiB, launches {counter.counts} (K1 want {k1}), K1's fp32 "
                f"reductions {reduced} [{card}]")
        solved = sum(count for _, count in groups)
        largest = max((dim for dim, _ in groups), default=0)
        log(f"ImageNet eigendecomposition: cuSOLVER groups (dimension, matrices) "
            f"{sorted(groups, reverse=True)}; {solved} matrices of {2 * len(specs)}, largest "
            f"{largest} [{card}]")
        if solved != 2 * len(specs) or largest != widest:
            raise RuntimeError(f"ImageNet: cuSOLVER solved {solved} matrices, not every one")
        tensors = check_finite_factors("ImageNet", analyzer, "ekfac", device)
        per_module = {name: t.float()
                      for name, t in analyzer.load_pairwise_scores("dense").items()}
        dense = sum(per_module.values())
        lowrank = analyzer.load_pairwise_scores("lowrank")[ALL_MODULE_NAME].float()
        shape = (IMAGENET_QUERY_N, IMAGENET_TRAIN_N)
        if (tuple(dense.shape) != shape or tuple(lowrank.shape) != shape
                or not bool(torch.isfinite(dense).all() & torch.isfinite(lowrank).all())):
            raise RuntimeError(f"ImageNet scores: shapes {tuple(dense.shape)}, "
                               f"{tuple(lowrank.shape)} or not finite")
        out["pearson_rank_vs_dense"] = pearson(lowrank, dense)
        # Each module's share of the dense scores' squared sum, largest first.
        total = sum(float(t.square().sum()) for t in per_module.values())
        shares = sorted(((float(t.square().sum()) / total, name)
                         for name, t in per_module.items()), reverse=True)
        out["dense_module_shares"] = {name: share for share, name in shares[:5]}
        log(f"ImageNet: {tensors} factor tensors read back, all finite; scores {shape} finite; "
            f"rank {IMAGENET_RANK} against dense: Pearson r {out['pearson_rank_vs_dense']:.6f} "
            f"(no bar); max |dense| {float(dense.abs().max()):.4e}; {len(per_module)} modules, "
            f"the largest shares of the dense scores' squared sum: "
            + ", ".join(f"{name} {share:.4f}" for share, name in shares[:5]) + f" [{card}]")
        del analyzer, dense, lowrank, per_module
    finally:
        eigen_mod._cusolver_group = real_group
        shutil.rmtree(root, ignore_errors=True)
    del module, model, cov_data, lambda_data, train, query
    torch.cuda.empty_cache()
    batch = out["batches"]["covariance"][0]
    out["k1_fp32"] = {f"{batch * positions}x{n}": time_k1_fp32(card, batch * positions, n)
                      for positions, n in IMAGENET_K1_GRAMS}
    out["total"] = {key: sum(c[key] for c in out["launches"].values())
                    for key in ("syrk", "probe")}
    log(f"ImageNet: phase 18 took {time.perf_counter() - start:.1f} s; stage seconds "
        f"{out['seconds']}; launches over its stages {out['total']} [{card}]")
    return out


def scanned_gpt2(ctx: dict, attention: str, remat: bool = False):
    """Phase 5's seed-0 GPT-2 weights (phase 10's too), stacked, under
    `scanned_lm_apply` with `attention`, prepared with the bench's task."""
    from kronfluence_tpu_torch.models.transformer import (
        gpt2_small,
        scanned_lm_apply,
        stack_layer_params,
    )
    from kronfluence_tpu_torch.prepare import FunctionalModel, prepare_model

    config = gpt2_small(max_seq_len=SEQ, dtype=torch.bfloat16, attention=attention)
    if "stacked" not in ctx:
        ctx["stacked"] = stack_layer_params(ctx["model"].module.state_dict(), config.num_layers)
    return prepare_model(FunctionalModel(scanned_lm_apply(config, remat), ctx["stacked"]),
                         ctx["task"])


def check_scanned_launches(launches: dict, want: dict, wgmma: int, naive_calls: int) -> None:
    """Phase 19 (a)'s launches: each kernel as many times as in phase 10's
    run of the same stages and batches (K1 on the wgmma kernel, K2 and the
    flash kernels off GPT-2's route 0 there), FF, FB, K1 and K3 at least
    once, the naive form never."""
    log("scanned GPT-2 launches against phase 10's, same stages and batches: " + ", ".join(
        f"{k} {launches[k]}/{want[k]}" for k in launches)
        + f"; K1 on the wgmma kernel {wgmma}; naive attention calls {naive_calls}")
    off = {k: (v, want[k]) for k, v in launches.items() if v != want[k]}
    if off or naive_calls or wgmma != launches["syrk"]:
        raise RuntimeError(f"scanned GPT-2 launches off phase 10's (got, want): {off}; naive "
                           f"calls {naive_calls}, wgmma {wgmma} of {launches['syrk']}")
    if not (launches["FF"] and launches["FB"] and launches["syrk"] and launches["probe"]):
        raise RuntimeError(f"the scanned GPT-2 missed a kernel of its path: {launches}")


def phase_scanned(card: str, ctx: dict) -> dict:
    """Phase 19 (a): the scanned GPT-2 at full width through the four stage
    functions with phase 10's recipe and data, against phase 10's module
    form: its tracked names, launches, factors and scores; the naive form's
    covariance and lambda on one batch bit for bit the module form's;
    remat=True bit for bit remat=False with a lower peak."""
    from kronfluence_tpu_torch.factor.covariance import (
        discover_stage_specs,
        fit_covariance_matrices_with_loader,
    )
    from kronfluence_tpu_torch.factor.eigen import fit_lambda_matrices_with_loader
    from kronfluence_tpu_torch.ops.attention import naive_attention
    from kronfluence_tpu_torch.ops.kernels.jacobi import jacobi_pivot_rotations
    from kronfluence_tpu_torch.ops.kernels.probe import probe
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk
    from kronfluence_tpu_torch.score.pairwise import compute_pairwise_scores_with_loaders
    from kronfluence_tpu_torch.utils.constants import (
        ACTIVATION_COVARIANCE_MATRIX_NAME,
        ALL_MODULE_NAME,
        COVARIANCE_FACTOR_NAMES,
        GRADIENT_COVARIANCE_MATRIX_NAME,
        LAMBDA_FACTOR_NAMES,
        LAMBDA_MATRIX_NAME,
        NUM_ACTIVATION_COVARIANCE_PROCESSED,
        NUM_GRADIENT_COVARIANCE_PROCESSED,
    )
    from kronfluence_tpu_torch.utils.dataset import BatchLoader

    device, task, data, fargs = ctx["device"], ctx["task"], ctx["data"], ctx["factor_args"]
    ref = ctx.pop("flash_path")
    try:
        model = scanned_gpt2(ctx, "flash")
        probe_batch = {k: v[:2] for k, v in data["cov"].items()}
        scanned_specs = discover_stage_specs(model, task, probe_batch)
        module_specs = discover_stage_specs(ctx["model"], task, probe_batch)
        names = list(scanned_specs)
        log(f"scanned GPT-2: {len(names)} tracked names from the tagged ops, the module form's "
            f"{len(module_specs)}; first {names[:4]}, last {names[-1]}")
        if (names != list(module_specs) or scanned_specs != module_specs
                or len(names) != len(task.get_influence_tracked_modules())):
            raise RuntimeError(f"the scanned form's tracked names or specs differ from the "
                               f"module form's: {names} against {list(module_specs)}")

        kernels = flash_kernels()
        counted = {**kernels, "syrk": syrk, "probe": probe, "jacobi": jacobi_pivot_rotations}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counted.values():
            fn.launches = 0
        syrk.wgmma_launches = 0
        naive_attention.calls = 0
        cov, eigen, lam, scores, seconds = run_slice(
            model, task, data, fargs, ref["score_args"], device,
            (COV_BATCH, LAMBDA_BATCH, QUERY_BATCH, TRAIN_BATCH),
        )
        launches = {name: fn.launches for name, fn in counted.items()}
        wgmma, naive_calls = syrk.wgmma_launches, naive_attention.calls
        peak = torch.cuda.max_memory_allocated() / 2**30
        log("scanned GPT-2 stage seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
            + f"; peak {peak:.2f} GiB; phase 10's module form: " + ", ".join(
                f"{k} {v:.3f}" for k, v in ref["seconds"].items())
            + f"; peak {ref['peak']:.2f} GiB (phase 10's warm flash turns: covariance "
            + "/".join(f"{v:.4f}" for v in ref["turns"]["covariance"]) + ", lambda "
            + "/".join(f"{v:.4f}" for v in ref["turns"]["lambda"]) + f") [{card}]")
        check_scanned_launches(launches, ref["launches"], wgmma, naive_calls)
        check_artifacts(cov, eigen, lam, scores, COV_N * SEQ, LAMBDA_N, (QUERY_N, TRAIN_N))

        # FF is deterministic: the activation covariance is the module form's
        # bits. The gradient reaches FB, whose dQ sums by atomics: what it
        # reaches is held within SCAN_RTOL. Lambda and the scores are held in
        # phase 10's eigenbasis: two eigensolves of covariances that differ
        # in the last bits may pick different bases for close eigenvalues,
        # which moves EK-FAC's lambda by more than the form does.
        act_same = _bitwise(cov, ref["cov"], (ACTIVATION_COVARIANCE_MATRIX_NAME,
                                              NUM_ACTIVATION_COVARIANCE_PROCESSED,
                                              NUM_GRADIENT_COVARIANCE_PROCESSED))
        lam_shared = fit_lambda_matrices_with_loader(
            model, task, BatchLoader(data["lambda"], LAMBDA_BATCH, device=device), fargs,
            eigen_factors=ref["eigen"])

        def pairwise(m, factors, score_args):
            return compute_pairwise_scores_with_loaders(
                m, task, BatchLoader(data["query"], QUERY_BATCH, device=device),
                BatchLoader(data["train"], TRAIN_BATCH, device=device), factors, fargs,
                score_args)[ALL_MODULE_NAME]

        def gap_and_r(got, want):
            return (_max_rel({ALL_MODULE_NAME: got}, {ALL_MODULE_NAME: want}),
                    pearson(got.float(), want.float()))

        shared = {**ref["cov"], **ref["eigen"], **lam_shared}
        ref_factors = {**ref["cov"], **ref["eigen"], **ref["lam"]}
        # Phase 5's dense query blocks, the scores kept in fp32: the module
        # form's on phase 10's factors against the scanned form's on its
        # lambda. (Rounded to bf16, the module form against itself read up to
        # 8.4e-3 of max: one bf16 step of a score near the max is 3.9e-3.)
        dense_args = copy.deepcopy(ctx["score_args"])
        dense_args.score_dtype = "float32"
        dense_ref = pairwise(ref["model"], ref_factors, dense_args)
        dense = gap_and_r(pairwise(model, shared, dense_args), dense_ref)
        gaps = {
            "gradient covariance": _max_rel(cov[GRADIENT_COVARIANCE_MATRIX_NAME],
                                            ref["cov"][GRADIENT_COVARIANCE_MATRIX_NAME]),
            "lambda": _max_rel(lam_shared[LAMBDA_MATRIX_NAME], ref["lam"][LAMBDA_MATRIX_NAME]),
            "scores (dense blocks, fp32 scores)": dense[0],
        }
        # Phase 10's fp8 blocks: a last-bit change of a query gradient moves
        # its fp8 rounding (steps of about 3% at damping 1e-8), so the fp8
        # scores are held against the module form's own noise: its pairwise
        # stage run again on the same factors.
        fp8 = {"own eigenbasis": gap_and_r(scores[ALL_MODULE_NAME], ref["scores"][ALL_MODULE_NAME]),
               "phase 10's eigenbasis": gap_and_r(pairwise(model, shared, ref["score_args"]),
                                                  ref["scores"][ALL_MODULE_NAME])}
        control = gap_and_r(pairwise(ref["model"], ref_factors, ref["score_args"]),
                            ref["scores"][ALL_MODULE_NAME])
        log(f"scanned GPT-2 against phase 10's module form (flash): activation covariance and "
            f"counts bit for bit {act_same}; max |diff| / max in phase 10's eigenbasis: " + ", ".join(
                f"{k} {v:.3e}" for k, v in gaps.items()) + f" (limit {SCAN_RTOL:g}), dense scores' "
            f"Pearson r {dense[1]:.6f} (limit {SCAN_PEARSON_MIN}); lambda in its own eigenbasis "
            f"{_max_rel(lam[LAMBDA_MATRIX_NAME], ref['lam'][LAMBDA_MATRIX_NAME]):.3e}")
        log("scanned GPT-2, phase 10's fp8 scores: " + ", ".join(
            f"{k} max |diff| / max {g:.3e}, r {r:.6f}" for k, (g, r) in fp8.items())
            + f"; the module form's pairwise stage again on its own factors {control[0]:.3e}, r "
            f"{control[1]:.6f} (limit: {SCAN_NOISE_FACTOR:g} x the module form's own gap and 1 - r)")
        bad = {k: v for k, v in gaps.items() if not v <= SCAN_RTOL}
        noisy = {k: v for k, v in fp8.items()
                 if not (v[0] <= SCAN_NOISE_FACTOR * control[0]
                         and 1 - v[1] <= SCAN_NOISE_FACTOR * (1 - control[1]))}
        if not act_same or bad or not dense[1] >= SCAN_PEARSON_MIN or noisy:
            raise RuntimeError(f"the scanned GPT-2 is off the module form: bitwise {act_same}, "
                               f"{bad}, dense r {dense[1]:.6f}, fp8 {noisy} against {control}")
        del lam_shared, shared, ref_factors, dense_ref, ref, lam, scores, cov

        # Naive attention: one covariance batch and its lambda, bit for bit
        # the module form's; then each block checkpointed (remat=True).
        one = {k: v[:COV_BATCH] for k, v in data["cov"].items()}

        def fit(m):
            c, c_peak, _ = peak_of(fit_covariance_matrices_with_loader, m, task,
                                   BatchLoader(one, COV_BATCH, device=device), fargs)
            l, l_peak, _ = peak_of(fit_lambda_matrices_with_loader, m, task,
                                   BatchLoader(one, COV_BATCH, device=device), fargs,
                                   eigen_factors=eigen)
            return {**c, **l}, (c_peak, l_peak)

        factor_names = COVARIANCE_FACTOR_NAMES + LAMBDA_FACTOR_NAMES
        module_form, _ = fit(ctx["model"])
        naive, plain_peaks = fit(scanned_gpt2(ctx, "naive"))
        remat, remat_peaks = fit(scanned_gpt2(ctx, "naive", remat=True))
        naive_same = _bitwise(naive, module_form, factor_names)
        remat_same = _bitwise(remat, naive, factor_names)
        log(f"scanned GPT-2, naive attention, one covariance batch of {COV_BATCH} and its "
            f"lambda: bit for bit the module form's {naive_same}; remat=True bit for bit "
            f"remat=False {remat_same}; peaks remat / plain: covariance "
            f"{remat_peaks[0] / 2**30:.3f} / {plain_peaks[0] / 2**30:.3f} GiB, lambda "
            f"{remat_peaks[1] / 2**30:.3f} / {plain_peaks[1] / 2**30:.3f} GiB [{card}]")
        if not (naive_same and remat_same):
            raise RuntimeError(f"scanned GPT-2 (naive) not bitwise: module form {naive_same}, "
                               f"remat {remat_same}")
        if not all(r < p for r, p in zip(remat_peaks, plain_peaks)):
            raise RuntimeError(f"remat does not lower the scanned GPT-2's peaks: {remat_peaks} "
                               f"against {plain_peaks}")
    finally:
        ctx.pop("stacked", None)
    return dict(launches=launches, seconds=seconds, peak=peak,
                remat_peaks_gib=[p / 2**30 for p in remat_peaks],
                plain_peaks_gib=[p / 2**30 for p in plain_peaks])


def regression_task():
    """examples/uci's task: summed squared error (the model's own noisy
    prediction as the label for the true Fisher); the measurement is the
    train loss."""
    from kronfluence_tpu_torch.task import Task

    class RegressionTask(Task):
        def compute_train_loss(self, batch, model, sample=False, generator=None):
            preds = model(batch["x"])
            if not sample:
                return torch.sum((preds - batch["y"]) ** 2)
            noise = torch.randn(preds.shape, generator=generator, dtype=preds.dtype,
                                device=preds.device)
            return torch.sum((preds - (preds.detach() + noise)) ** 2)

        def compute_measurement(self, batch, model):
            return self.compute_train_loss(batch, model)

    return RegressionTask()


def seq2seq_task(num_layers: int):
    """examples/dailymail's task (its dict masks, lm_head tracked) with the
    loss on logits of at least fp32: the float64 reference keeps its logits
    in float64, where the pipeline's task casts them to fp32 as the JAX
    example does; on the card's fp32 the two are the same function."""
    from kronfluence_tpu_torch.examples.common import sample_labels
    from kronfluence_tpu_torch.examples.dailymail.pipeline import SummarizationTask

    class ExactSummarizationTask(SummarizationTask):
        def compute_train_loss(self, batch, model, sample=False, generator=None):
            logits = model(batch["input_ids"], batch["decoder_input_ids"],
                           batch["attention_mask"], batch["decoder_attention_mask"])[:, :-1]
            logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
            mask = batch["decoder_attention_mask"][:, 1:].to(logits.dtype)
            if sample:
                labels = sample_labels(logits, generator)
            else:
                labels = batch["decoder_input_ids"][:, 1:].long()
            losses = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
                                     reduction="none").reshape(mask.shape)
            return torch.sum(losses * mask)

    return ExactSummarizationTask(num_layers)


def t5_blocks_task(num_layers: int):
    """examples/dailymail's task tracking the blocks' projections and not
    lm_head, the reference's T5 set: at T5-small's vocabulary lm_head's
    gradient factor is 32,128 wide, a host fp64 eigh of 8 GiB."""
    from kronfluence_tpu_torch.examples.dailymail.pipeline import SummarizationTask

    class BlocksSummarizationTask(SummarizationTask):
        def get_influence_tracked_modules(self):
            return [name for name, _ in self._streams() if name != "lm_head"]

        def get_attention_mask(self, batch):
            masks = super().get_attention_mask(batch)
            del masks["lm_head"]
            return masks

    return BlocksSummarizationTask(num_layers)


def regression_rows(n: int, seed: int) -> dict:
    """examples/uci's synthetic Concrete shape: 8 features, one target."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, UCI_IN, generator=gen)
    w = torch.randn(UCI_IN, 1, generator=gen)
    return {"x": x, "y": torch.tanh(x @ w) + 0.1 * torch.randn(n, 1, generator=gen)}


def seq2seq_rows(n: int, seed: int) -> dict:
    """examples/dailymail's synthetic pairs, the encoder half-masked."""
    t, vocab = DAILYMAIL["max_seq_len"], DAILYMAIL["vocab_size"]
    gen = torch.Generator().manual_seed(seed)
    enc_mask = torch.ones(n, t, dtype=torch.int64)
    enc_mask[:, t // 2:] = 0
    return {"input_ids": torch.randint(1, vocab, (n, t), generator=gen) * enc_mask,
            "decoder_input_ids": torch.randint(1, vocab, (n, t), generator=gen),
            "attention_mask": enc_mask,
            "decoder_attention_mask": torch.ones(n, t, dtype=torch.int64)}


def check_small_model_launches(label: str, launches: dict, naive_calls: int) -> None:
    """Phase 19 (b) and (c), the card side: K3 once (its covariance fit), K2
    and the flash kernels never; the encoder-decoder's attention is the
    naive form, which GPT-2's counter does not see."""
    if launches != {"probe": 1} or naive_calls:
        raise RuntimeError(f"{label}: launches off on the card side: {launches}, GPT-2's naive "
                           f"form {naive_calls} times")


def phase_small_models(card: str, device=torch.device("cuda", 0)) -> dict:
    """Phase 19 (b) and (c): examples/uci's MLP and a RepeatedMLP at its
    widths, and examples/dailymail's encoder-decoder with a half-masked
    encoder and the example's task (its loss on fp32 logits on both sides,
    on the card, float64 logits on the CPU), each fp32 with seeded weights through the
    stage functions on the card against the CPU port in float64 (`stages_card_against_cpu`,
    within REFERENCE_RTOL of max): these are ReLU nets, and a pre-activation
    within fp32 rounding of 0 (-1.34e-7 at one token of the encoder-
    decoder's decoder_1/mlp/wi) flips its ReLU between two fp32 runs, which
    moves that module's gradient covariance by 1.1e-3 of its max; the
    float64 side does not round there. The encoder-decoder's token counts on
    the card equal the mask sums; K2 and the flash kernels never, K3 once a
    fit."""
    from kronfluence_tpu_torch.models.encoder_decoder import EncDecConfig, init_encdec
    from kronfluence_tpu_torch.models.mlp import MLP, RepeatedMLP
    from kronfluence_tpu_torch.models.transformer import init_flax_scales_
    from kronfluence_tpu_torch.ops.attention import naive_attention
    from kronfluence_tpu_torch.ops.kernels.jacobi import jacobi_pivot_rotations
    from kronfluence_tpu_torch.ops.kernels.probe import probe
    from kronfluence_tpu_torch.utils.constants import (
        NUM_ACTIVATION_COVARIANCE_PROCESSED,
        NUM_GRADIENT_COVARIANCE_PROCESSED,
    )

    def seeded(module, seed):
        init_flax_scales_(module, torch.Generator().manual_seed(seed))
        return module

    uci = {k: regression_rows(n, seed) for k, n, seed in
           (("cov", UCI_N, 51), ("lambda", UCI_N, 52), ("query", 32, 53), ("train", 128, 54))}
    seq2seq = {k: seq2seq_rows(n, seed) for k, n, seed in
               (("cov", DAILYMAIL_N, 61), ("lambda", DAILYMAIL_N, 62), ("query", 8, 63),
                ("train", 32, 64))}
    cases = {
        "MLP (8, 64, 64, 1)": (seeded(MLP(UCI_IN, (UCI_HIDDEN, UCI_HIDDEN), 1), 0),
                               regression_task(), uci, UCI_BATCH),
        "RepeatedMLP (8, 64 x 3 shared, 1)": (
            seeded(RepeatedMLP(UCI_IN, UCI_HIDDEN, 1, num_repeats=3), 1), regression_task(),
            uci, UCI_BATCH),
        "EncDecLM (dailymail: d 128, 4 heads, 2 layers, seq 32, vocab 1024)": (
            init_encdec(EncDecConfig(**DAILYMAIL), seed=0, device="cpu"),
            seq2seq_task(DAILYMAIL["num_layers"]), seq2seq, 16),
    }
    counted = {**flash_kernels(), "probe": probe, "jacobi": jacobi_pivot_rotations}
    result, runs = {}, {}
    for label, (module, task, host, batch) in cases.items():
        for fn in counted.values():
            fn.launches = 0
        calls = naive_attention.calls
        run = runs[label] = stages_card_against_cpu(module, task, host, batch, device=device,
                                                    cpu_dtype=torch.float64)
        launches = {k: fn.launches for k, fn in counted.items() if fn.launches}
        diffs = run["diffs"]
        log(f"{label}: card vs CPU, max |diff| / max |ref|: "
            + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items())
            + f" (limit {REFERENCE_RTOL:g}); launches on the card side {launches}, K1 {run['k1']} "
            f"[{card}]")
        bad = {k: v for k, v in diffs.items() if not v <= REFERENCE_RTOL}
        if bad:
            raise RuntimeError(f"{label}: card disagrees with the CPU port: {bad}")
        check_small_model_launches(label, launches, naive_attention.calls - calls)
        result[label] = dict(diffs, k1=run["k1"], launches=launches)
    # The encoder-decoder's rows on the card: the unmasked article tokens for
    # the encoder and the cross-attention's keys and values, every summary
    # token for the rest.
    enc = int(seq2seq["cov"]["attention_mask"].sum())
    dec = int(seq2seq["cov"]["decoder_attention_mask"].sum())
    off = {}
    encdec = runs[next(label for label in cases if label.startswith("EncDecLM"))]
    for count in (NUM_ACTIVATION_COVARIANCE_PROCESSED, NUM_GRADIENT_COVARIANCE_PROCESSED):
        for name, got in encdec["cov"][count].items():
            want = enc if (name.startswith("encoder_") or name.endswith(("cross_attn/k",
                                                                         "cross_attn/v"))) else dec
            if int(got.item()) != want:
                off[count, name] = (int(got.item()), want)
    log(f"EncDecLM token counts on the card: encoder modules and cross-attention k/v {enc} "
        f"(the article mask's sum), the rest {dec} (the summary mask's); mismatches {off}")
    if off:
        raise RuntimeError(f"EncDecLM token counts off the mask sums: {off}")
    return result


class SweepSplit:
    """While the block runs, each host-loop sweep's (`ops/eigh.py:
    _hostloop_sweep`) wall time on the synchronized host clock and its split
    by CUDA events on the sweep's stream: the pivot solves
    (`exact_pivot_rotations`, its side streams' work inside the pair), the
    rotation GEMMs (`torch.matmul`) and the gathers (`Tensor.index_select`),
    each event pair around one call; "other" is the rest of the sweep (the
    reshape copies, the re-symmetrization, the off-norm). Only calls inside
    a sweep are timed."""

    def __init__(self):
        self.sweeps = []

    def __enter__(self):
        from kronfluence_tpu_torch.ops import eigh as eigh_mod

        self.parts = {"pivot eigh": (eigh_mod, "exact_pivot_rotations"),
                      "rotation GEMMs": (torch, "matmul"),
                      "gathers": (torch.Tensor, "index_select")}
        self._mod, self._sweep = eigh_mod, eigh_mod._hostloop_sweep
        self._real = {part: getattr(owner, name) for part, (owner, name) in self.parts.items()}
        active = [None]

        def timed(part, fn):
            def wrapper(*args, **kwargs):
                if active[0] is None:
                    return fn(*args, **kwargs)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kwargs)
                end.record()
                active[0][part].append((start, end))
                return out
            return wrapper

        def sweep(*args, **kwargs):
            active[0] = {part: [] for part in self.parts}
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                out = self._sweep(*args, **kwargs)
            finally:
                events, active[0] = active[0], None
            torch.cuda.synchronize()
            split = {"wall_ms": (time.perf_counter() - t) * 1e3}
            split.update({part: sum(a.elapsed_time(b) for a, b in pairs)
                          for part, pairs in events.items()})
            split["other"] = split["wall_ms"] - sum(split[part] for part in self.parts)
            self.sweeps.append(split)
            return out

        eigh_mod._hostloop_sweep = sweep
        for part, (owner, name) in self.parts.items():
            setattr(owner, name, timed(part, self._real[part]))
        return self

    def __exit__(self, *exc):
        self._mod._hostloop_sweep = self._sweep
        for part, (owner, name) in self.parts.items():
            setattr(owner, name, self._real[part])
        return False


def cli_args(widths: dict, device) -> list:
    """An example script's arguments from a dict ({"num_train": 24} gives
    --num_train 24), and --cpu off the card."""
    args = [item for key, value in widths.items() for item in (f"--{key}", str(value))]
    return args + (["--cpu"] if device.type == "cpu" else [])


def check_openwebtext_launches(stage: str, counts: dict, layers: int, covariance_fits: int,
                               cov_batches: int, jacobi: int) -> None:
    """Phase 15's rule (check_llama_launches) over a whole entry point's run:
    FFH once per attention forward, F2H and F3H once per attention backward,
    the other flash kernels and the naive form never, K1 on every covariance
    gram (all wgmma) and K3 once per covariance fit, and K2 `jacobi` times
    (the eigendecomposition's batched Jacobi rounds), all on its register
    route."""
    from kronfluence_tpu_torch.ops.kernels.jacobi import jacobi_pivot_rotations

    registers = jacobi_pivot_rotations.registers_launches
    if counts["jacobi"] != jacobi or registers != jacobi:
        raise RuntimeError(f"openwebtext {stage}: K2 {counts['jacobi']} launches, {registers} "
                           f"on the register route; want {jacobi}")
    check_llama_launches(stage, dict(counts, jacobi=0), layers, covariance_fits, cov_batches)


def hostloop_solve(card: str, matrix: tuple, device) -> dict:
    """Phase 21 (a): phase 15's gate_proj gradient covariance (Llama-3-8B's
    widths, 32 examples: full rank) through `eigh_large`'s "jacobi" route,
    the host-loop Jacobi at block 128; held in fp64 on the card and against
    cuSOLVER's fp32 eigh of the same matrix."""
    from kronfluence_tpu_torch.ops import eigh as eigh_mod

    total, count = matrix
    n = total.shape[0]
    got = {}

    def build():
        c = total.to(device, torch.float32) / count
        return (c + c.T).mul_(0.5)

    eigh_mod.eigh_jacobi_hostloop.solves.clear()
    with SweepSplit() as split:
        _, _, sec = peak_of(eigh_mod.eigh_large, [build],
                            lambda i, evals, evecs: got.update(evals=evals, evecs=evecs),
                            solve=eigh_mod.jacobi_hostloop_solve)
    (solve,) = eigh_mod.eigh_jacobi_hostloop.solves
    c = build().double()
    q, lam = got["evecs"].double(), got["evals"].double()
    residual = float(torch.linalg.matrix_norm(c - (q * lam) @ q.T) / torch.linalg.matrix_norm(c))
    orth = float((q.T @ q - torch.eye(n, dtype=torch.float64, device=device)).abs().max())
    del c, q, lam
    ref = torch.linalg.eigh(build())[0]
    gap = float((got["evals"] - ref).abs().max() / ref.abs().max())
    del got, ref
    torch.cuda.empty_cache()
    limit = n * 2.0 ** -24
    parts = ("pivot eigh", "rotation GEMMs", "gathers", "other")
    share = {part: sum(x[part] for x in split.sweeps) / sum(x["wall_ms"] for x in split.sweeps)
             for part in parts}
    log(f"examples (a) host-loop Jacobi on phase 15's {HOSTLOOP_MODULE} gradient covariance (n "
        f"{n}, block {eigh_mod.LARGE_EIGH_BLOCK}, exact pivots over {eigh_mod.PIVOT_STREAMS} "
        f"streams) through eigh_large: {sec:.3f} s, {solve['sweeps']} sweeps of "
        f"{solve['rounds_per_sweep']} rounds, relative off-norm by sweep "
        + ", ".join(f"{o:.3e}" for o in solve["off"])
        + f"; ||C - Q L Q^T||_F / ||C||_F {residual:.3e}, ||Q^T Q - I||_max {orth:.3e} (limits n u "
        f"= {limit:.3e}); eigenvalues against cuSOLVER fp32 {gap:.3e} of max|lambda| (limit "
        f"{HOSTLOOP_EIG_RTOL:g}); share of the sweeps' wall: " + ", ".join(
            f"{part} {share[part]:.3f}" for part in parts)
        + "; per sweep, ms (wall: pivot eigh / rotation GEMMs / gathers / other): " + "; ".join(
            f"{x['wall_ms']:.1f}: " + " / ".join(f"{x[part]:.1f}" for part in parts)
            for x in split.sweeps) + f" [{card}]")
    if not (residual <= limit and orth <= limit and gap <= HOSTLOOP_EIG_RTOL):
        raise RuntimeError(f"host-loop eigenpairs off: residual {residual}, orthogonality {orth}, "
                           f"cuSOLVER gap {gap}")
    return dict(seconds=sec, sweeps=solve["sweeps"], off=solve["off"], residual=residual,
                orthogonality=orth, cusolver_gap=gap, share=share, split=split.sweeps)


def examples_openwebtext(card: str, root: Path, device) -> dict:
    """Phase 21 (a): the port's openwebtext fit_factors and compute_scores
    entry points at Llama-3-8B's widths, one layer, the script's "jacobi"
    recipe, with the 14336-dim factors' solve taken by cuSOLVER (as "auto"
    takes it): one host-loop solve there takes minutes (`hostloop_solve`
    holds one). The 4096-dim group runs the batched Jacobi, K2 a round."""
    from kronfluence_tpu_torch.examples.openwebtext import compute_scores, fit_factors
    from kronfluence_tpu_torch.factor import eigen as eigen_mod
    from kronfluence_tpu_torch.ops import eigh as eigh_mod
    from kronfluence_tpu_torch.ops.kernels.jacobi import jacobi_pivot_rotations
    from kronfluence_tpu_torch.ops.kernels.probe import probe
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk

    config = ["--arch", "llama", "--num_layers", str(OWT_LAYERS), "--seq_len", str(SEQ),
              "--num_train", str(OWT_TRAIN_N), "--attention", "flash",
              "--output_dir", str(root / "openwebtext")] + cli_args(OWT_WIDTHS, device)
    kernels = dict(flash_kernels(), syrk=syrk, probe=probe, jacobi=jacobi_pivot_rotations)
    out = {"seconds": {}, "launches": {}}
    scratch = root / "openwebtext" / "openwebtext" / "factors_ekfac" / "eigendecomposition_scratch"
    eigh_mod.eigh_batched.chunks.clear()
    eigh_mod.eigh_jacobi_hostloop.solves.clear()
    jacobi_pivot_rotations.registers_launches = jacobi_pivot_rotations.generic_launches = 0
    record = watch_large_solves(scratch)
    hostloop = eigen_mod.jacobi_hostloop_solve
    eigen_mod.jacobi_hostloop_solve = None  # eigh_large's default solve, cuSOLVER
    try:
        with PassCounter(None, kernels) as counter:
            analyzer, peak, sec = peak_of(fit_factors.main, config)
    finally:
        eigen_mod.jacobi_hostloop_solve = hostloop
        unwatch_large_solves(record)
    chunks = list(eigh_mod.eigh_batched.chunks)
    fits = OWT_MODULE_PARTITIONS * OWT_DATA_PARTITIONS
    rounds = sum(c["sweeps"] * c["rounds_per_sweep"] for c in chunks)
    check_openwebtext_launches("fit_factors", counter.counts, OWT_LAYERS, fits,
                               OWT_TRAIN_N // OWT_BATCH, rounds)
    large = 3 * OWT_LAYERS
    if record["calls"] != [large] or eigh_mod.eigh_jacobi_hostloop.solves \
            or [len(f) for f in record["files"]] != list(range(1, large + 1)):
        raise RuntimeError(f"openwebtext: eigh_large calls {record['calls']}, checkpoints "
                           f"{record['files']}, host-loop solves "
                           f"{eigh_mod.eigh_jacobi_hostloop.solves}")
    eigen = analyzer.load_eigendecomposition("ekfac")
    if not all(bool(torch.isfinite(t).all()) for d in eigen.values() for t in d.values()):
        raise RuntimeError("openwebtext: eigenpairs not finite")
    out["seconds"]["fit_factors"] = sec
    out["launches"]["fit_factors"] = dict(counter.counts)
    log(f"examples (a) openwebtext fit_factors at Llama-3-8B widths ({OWT_LAYERS} layer, "
        f"{OWT_TRAIN_N} train examples, batch {OWT_BATCH}, {OWT_MODULE_PARTITIONS} module x "
        f"{OWT_DATA_PARTITIONS} data partitions, flash, fp32 \"jacobi\", the {large} factors of "
        f"dim {OWT_WIDTHS['d_mlp']} by cuSOLVER through eigh_large, each solve (build and eigh) "
        + ", ".join(f"{t:.3f}" for t in record["solves"]) + f" s): {sec:.3f} s, peak "
        f"{peak / 2**30:.3f} GiB; launches {counter.counts}; batched Jacobi chunks "
        f"{[(c['n'], c['matrices'], c['sweeps']) for c in chunks]} (n, matrices, sweeps: K2 "
        f"{rounds} launches, all on the register route) [{card}]")
    del record, eigen, analyzer
    torch.cuda.empty_cache()

    with PassCounter(None, kernels) as counter:
        scores, peak, sec = peak_of(compute_scores.main, config + ["--num_query", str(OWT_QUERY_N)])
    check_llama_launches("compute_scores", counter.counts, OWT_LAYERS)
    out["seconds"]["compute_scores"] = sec
    out["launches"]["compute_scores"] = dict(counter.counts)
    if tuple(scores.shape) != (OWT_QUERY_N, OWT_TRAIN_N) or not bool(torch.isfinite(scores).all()):
        raise RuntimeError(f"openwebtext scores: shape {tuple(scores.shape)} or not finite")
    log(f"examples (a) openwebtext compute_scores ({OWT_QUERY_N} x {OWT_TRAIN_N}, rank-64 query "
        f"blocks): {sec:.3f} s, peak {peak / 2**30:.3f} GiB, scores finite, launches "
        f"{counter.counts} [{card}]")
    del scores
    torch.cuda.empty_cache()
    return out


def examples_wikitext(card: str, root: Path, device) -> dict:
    """Phase 21 (b): the port's wikitext train (two steps) and analyze (the
    bf16 recipe) at GPT-2 small's width, 4 of 12 layers; analyze's K1 and
    K3 launches against the covariance stage called directly on the same
    model, data and recipe."""
    from kronfluence_tpu_torch import prepare_model
    from kronfluence_tpu_torch.examples.wikitext import analyze, train
    from kronfluence_tpu_torch.examples.wikitext.pipeline import (
        LanguageModelingTask,
        construct_gpt2,
        get_wikitext_dataset,
    )
    from kronfluence_tpu_torch.factor.covariance import fit_covariance_matrices_with_loader
    from kronfluence_tpu_torch.ops.kernels.jacobi import jacobi_pivot_rotations
    from kronfluence_tpu_torch.ops.kernels.probe import probe
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk
    from kronfluence_tpu_torch.utils.common.factor_arguments import (
        all_low_precision_factor_arguments,
    )
    from kronfluence_tpu_torch.utils.dataset import BatchLoader

    width = ["--seq_len", str(SEQ)] + cli_args(GPT2_WIDTHS, device)
    kernels = dict(flash_kernels(), syrk=syrk, probe=probe, jacobi=jacobi_pivot_rotations)
    out = {"seconds": {}, "launches": {}}
    (model, train_loss, eval_loss), _, sec = peak_of(
        train.main, width + ["--num_train", str(WIKITEXT_TRAIN_N), "--num_eval", "8",
                             "--epochs", "1", "--batch_size", str(WIKITEXT_BATCH),
                             "--checkpoint_dir", str(root / "wikitext_checkpoint")])
    steps = WIKITEXT_TRAIN_N // WIKITEXT_BATCH
    saved = (root / "wikitext_checkpoint" / "model.safetensors").exists()
    out["seconds"]["train"] = sec
    log(f"examples (b) wikitext train at GPT-2 small's width ({steps} steps of "
        f"{WIKITEXT_BATCH}): {sec:.3f} s, train loss {train_loss:.4f}, eval loss {eval_loss:.4f} "
        f"a token, checkpoint written {saved} [{card}]")
    if not (math.isfinite(train_loss) and math.isfinite(eval_loss) and saved):
        raise RuntimeError("wikitext train: a loss is not finite or no checkpoint")
    del model
    torch.cuda.empty_cache()

    with PassCounter(None, kernels) as counter:
        (analyzer, scores), peak, sec = peak_of(
            analyze.main, width + ["--num_train", str(WIKITEXT_TRAIN_N), "--num_query",
                                   str(WIKITEXT_QUERY_N), "--train_batch_size", str(WIKITEXT_BATCH),
                                   "--low_precision", "--output_dir", str(root / "wikitext")])
    got = dict(counter.counts)
    out["seconds"]["analyze"] = sec
    out["launches"]["analyze"] = got
    if tuple(scores.shape) != (WIKITEXT_QUERY_N, WIKITEXT_TRAIN_N) \
            or not bool(torch.isfinite(scores).all()):
        raise RuntimeError(f"wikitext scores: shape {tuple(scores.shape)} or not finite")
    del analyzer, scores
    torch.cuda.empty_cache()

    # The covariance stage called directly: the same seed-0 model, data, batch and recipe.
    g = GPT2_WIDTHS
    task = LanguageModelingTask(g["num_layers"])
    module = construct_gpt2(g["num_layers"], g["d_model"], g["num_heads"], SEQ, g["vocab"],
                            device=device)
    data = get_wikitext_dataset("train", WIKITEXT_TRAIN_N, SEQ, g["vocab"])
    with PassCounter(None, kernels) as counter:
        fit_covariance_matrices_with_loader(
            prepare_model(module, task), task, BatchLoader(data, WIKITEXT_BATCH, device=device),
            all_low_precision_factor_arguments("ekfac"))
        torch.cuda.synchronize()
    direct = dict(counter.counts)
    del module
    torch.cuda.empty_cache()
    log(f"examples (b) wikitext analyze (all low precision, {WIKITEXT_QUERY_N} x "
        f"{WIKITEXT_TRAIN_N}): {sec:.3f} s, peak {peak / 2**30:.3f} GiB, scores finite; K1 "
        f"{got['syrk']} ({got['wgmma']} wgmma), K3 {got['probe']}, K2 {got['jacobi']}, naive "
        f"attention {got['naive']}; the covariance stage called directly: K1 {direct['syrk']} "
        f"({direct['wgmma']} wgmma), K3 {direct['probe']} (want K1 "
        f"{WIKITEXT_K1_PER_BATCH * steps}) [{card}]")
    check_wikitext_launches(got, direct, WIKITEXT_K1_PER_BATCH * steps)
    return out


def check_wikitext_launches(got: dict, direct: dict, k1: int) -> None:
    """analyze's K1 and K3 launches are the covariance stage's called
    directly: K1 `k1` times, all wgmma, K3 once; K2 never."""
    if not (got["syrk"] == got["wgmma"] == direct["syrk"] == direct["wgmma"] == k1
            and got["probe"] == direct["probe"] == 1 and got["jacobi"] == 0):
        raise RuntimeError(f"wikitext analyze launches {got} against the stage's {direct}")


def phase_examples(card: str, hostloop_matrix: tuple, device=torch.device("cuda", 0)) -> dict:
    """Phase 21: the host-loop Jacobi on phase 15's `hostloop_matrix` (its
    sum and count), then the port's example pipelines through their entry
    points."""
    start = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="kf_chip_smoke_examples_"))
    try:
        out = {"hostloop": hostloop_solve(card, hostloop_matrix, device)}
        del hostloop_matrix
        out["openwebtext"] = examples_openwebtext(card, root, device)
        t = time.perf_counter()
        out["wikitext"] = examples_wikitext(card, root, device)
        out["seconds"] = {"openwebtext": t - start, "wikitext": time.perf_counter() - t}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"examples: phase 21 took {time.perf_counter() - start:.1f} s ((a) with the host-loop "
        f"solve {out['seconds']['openwebtext']:.1f}, (b) {out['seconds']['wikitext']:.1f}) "
        f"[{card}]")
    return out


def example_kernels() -> dict:
    """Every counted kernel wrapper, as PassCounter takes them."""
    from kronfluence_tpu_torch.ops.kernels.jacobi import jacobi_pivot_rotations
    from kronfluence_tpu_torch.ops.kernels.probe import probe
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk

    return dict(flash_kernels(), syrk=syrk, probe=probe, jacobi=jacobi_pivot_rotations)


def direct_covariance(card: str, label: str, module, task, data: dict, batch: int, recipe,
                      device) -> dict:
    """The covariance stage called directly on an example's model, data,
    batch and recipe: its K1 (by route) and K3 launches, K1's held to the
    count the layer shapes give (`k1_grams_per_batch`)."""
    from kronfluence_tpu_torch import prepare_model
    from kronfluence_tpu_torch.factor.covariance import (
        discover_stage_specs,
        fit_covariance_matrices_with_loader,
    )
    from kronfluence_tpu_torch.utils.dataset import BatchLoader

    model = prepare_model(module, task)
    loader = BatchLoader(data, batch, device=device)
    with PassCounter(None, example_kernels()) as counter:
        fit_covariance_matrices_with_loader(model, task, loader, recipe)
        torch.cuda.synchronize()
    specs = discover_stage_specs(model, task, loader.probe()[0])
    num = len(next(iter(data.values())))
    batches = -(-num // batch)
    shapes = k1_grams_per_batch(specs, torch.float32, torch.float32) * batches
    got = {"K1": counter.counts["syrk"], "wgmma": counter.counts["wgmma"],
           "K3": counter.counts["probe"]}
    log(f"examples {label}: the covariance stage called directly ({num} "
        f"examples, batch {batch}, {len(specs)} tracked layers): K1 {got['K1']} ({got['wgmma']} "
        f"wgmma), K3 {got['K3']}; K1 from the shapes {shapes} [{card}]")
    check_direct_covariance(label, got, shapes)
    return got


def check_direct_covariance(label: str, got: dict, shapes: int) -> None:
    """One covariance fit: K1 as many times as the shapes give, K3 once."""
    if got["K1"] != shapes or got["K3"] != 1:
        raise RuntimeError(f"{label}: the covariance stage launched {got}, the shapes give K1 "
                           f"{shapes}")


def check_example_launches(label: str, counts: dict, fits: list, naive_ok: bool = False) -> dict:
    """An entry point's launches are those of its covariance fits, each the
    stage's called directly (`fits`): K1 and its wgmma share summed, K3 once
    a fit; K2, the flash kernels and (unless `naive_ok`: a model whose
    attention is the naive form) the naive form never. Returns K1 (by route)
    and K3."""
    k1 = sum(f["K1"] for f in fits)
    wgmma = sum(f["wgmma"] for f in fits)
    check_vision_launches(label, "entry point", dict(counts, naive=0) if naive_ok else counts,
                          k1, len(fits))
    if counts["wgmma"] != wgmma:
        raise RuntimeError(f"{label}: K1 took the wgmma route {counts['wgmma']} times, the "
                           f"stages called directly {wgmma}")
    return {"K1": counts["syrk"], "wgmma": counts["wgmma"], "K3": counts["probe"]}


def run_example(card: str, label: str, fn, argv: list, fits: list, out: dict,
                naive_ok: bool = False):
    """One entry point under PassCounter: its result, with its seconds, peak
    and launches (held to `fits`; `naive_ok` as check_example_launches takes
    it) recorded in `out`."""
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk

    f16 = syrk.f16_launches
    with PassCounter(None, example_kernels()) as counter:
        result, peak, sec = peak_of(fn, argv)
    out["seconds"][label], out["peaks"][label] = sec, peak
    out["launches"][label] = check_example_launches(label, counter.counts, fits, naive_ok)
    if syrk.f16_launches != f16:
        raise RuntimeError(f"{label}: K1 took fp16 operands")
    log(f"examples {label}: {sec:.3f} s, peak {peak / 2**30:.3f} GiB, launches "
        f"{out['launches'][label]} (want K1 {sum(f['K1'] for f in fits)}, wgmma "
        f"{sum(f['wgmma'] for f in fits)}, K3 {len(fits)}) [{card}]")
    return result


def finite_scores(label: str, scores: torch.Tensor, shape: tuple) -> torch.Tensor:
    if tuple(scores.shape) != shape or not bool(torch.isfinite(scores).all()):
        raise RuntimeError(f"{label}: scores of shape {tuple(scores.shape)} (want {shape}) or "
                           f"not finite")
    return scores


def examples_cifar(card: str, root: Path, device) -> dict:
    """Phase 22 (a): the cifar example's train, detect_mislabeled_dataset,
    inspect_factors (detect's factors) and half_precision_analysis at
    ResNet-9's full width (32 x 32, 10 classes)."""
    from kronfluence_tpu_torch import FactorArguments
    from kronfluence_tpu_torch.examples.cifar import (
        detect_mislabeled_dataset,
        half_precision_analysis,
        inspect_factors,
        train,
    )
    from kronfluence_tpu_torch.examples.cifar.pipeline import (
        ClassificationTask,
        construct_resnet9,
        get_cifar10_dataset,
    )
    from kronfluence_tpu_torch.utils.common.factor_arguments import (
        all_low_precision_factor_arguments,
    )

    cpu = cli_args({}, device)
    out = {"seconds": {}, "peaks": {}, "launches": {}}
    data, corrupt_idx = get_cifar10_dataset("train", CIFAR_EXAMPLE_N, corrupt_frac=0.1)
    module = construct_resnet9(device=device)
    log(f"examples 22 (a) cifar: ResNet-9 (10 classes, 32x32x3), "
        f"{sum(p.numel() for p in module.parameters()):,} parameters; {CIFAR_EXAMPLE_N} "
        f"synthetic images, {len(corrupt_idx)} labels corrupted, batches of "
        f"{CIFAR_EXAMPLE_BATCH} [{card}]")
    task = ClassificationTask()
    fp32 = direct_covariance(card, "cifar fp32", module, task, data, CIFAR_EXAMPLE_BATCH,
                             FactorArguments(strategy="ekfac"), device)
    bf16 = direct_covariance(card, "cifar bf16", module, task, data, CIFAR_EXAMPLE_BATCH,
                             all_low_precision_factor_arguments("ekfac"), device)
    del module
    if fp32["wgmma"] or bf16["wgmma"] != bf16["K1"]:
        raise RuntimeError(f"cifar: K1 off its routes: fp32 {fp32}, bf16 {bf16}")

    sized = ["--num_train", str(CIFAR_EXAMPLE_N), "--batch_size", str(CIFAR_EXAMPLE_BATCH)] + cpu
    checkpoint = root / "cifar_checkpoint"
    trained, _ = run_example(
        card, "cifar train", train.main,
        ["--num_train", str(CIFAR_TRAIN_STEPS * CIFAR_EXAMPLE_BATCH), "--batch_size",
         str(CIFAR_EXAMPLE_BATCH), "--epochs", "1", "--checkpoint_dir", str(checkpoint)] + cpu,
        [], out)
    if not ((checkpoint / "model.safetensors").exists()
            and all(bool(torch.isfinite(t).all()) for t in trained.state_dict().values()
                    if t.is_floating_point())):
        raise RuntimeError("cifar train: no checkpoint, or weights not finite")
    del trained

    analyzer, scores, recalls = run_example(
        card, "cifar detect_mislabeled_dataset", detect_mislabeled_dataset.main,
        sized + ["--output_dir", str(root / "cifar")], [fp32], out)
    finite_scores("cifar detect", scores, (CIFAR_EXAMPLE_N,))
    out["recall"] = {f"top {int(100 * frac)}%": r for frac, r in recalls.items()}
    del analyzer, scores
    summaries = inspect_factors.main(["--output_dir", str(root / "cifar")] + cpu)
    values = [v for s in summaries.values() for d in s.values() for v in d.values()]
    if len(summaries) != 9 or not all(math.isfinite(v) for v in values):
        raise RuntimeError(f"cifar inspect_factors: {len(summaries)} modules, or a value not "
                           f"finite")
    out["half_precision"] = run_example(
        card, "cifar half_precision_analysis", half_precision_analysis.main,
        sized + ["--output_dir", str(root / "cifar_half")], [fp32, bf16], out)
    if not all(math.isfinite(v) for v in out["half_precision"].values()):
        raise RuntimeError(f"cifar half_precision_analysis: {out['half_precision']}")
    torch.cuda.empty_cache()
    log(f"examples 22 (a) cifar: mislabeled-example recall by self-influence {out['recall']}; "
        f"inspect_factors read {len(summaries)} modules; bf16 against fp32 self-influence "
        f"{out['half_precision']} [{card}]")
    return out


def examples_imagenet(card: str, root: Path, device) -> dict:
    """Phase 22 (b): the imagenet example's analyze, query_batching_analysis
    and ddp_analyze (one process, no group: a mesh of one) at ResNet-50's
    full width (224 x 224, 1000 classes), ddp_analyze held against analyze
    at the same arguments. query_batching_analysis finds analyze's fit (the
    same model, data, batch and recipe) in its output directory, as a rerun
    would, and launches no K1 or K3: the script's fp64 host
    eigendecomposition takes 42 s a fit."""
    from kronfluence_tpu_torch import FactorArguments
    from kronfluence_tpu_torch.examples.imagenet import (
        analyze,
        ddp_analyze,
        query_batching_analysis,
    )
    from kronfluence_tpu_torch.examples.imagenet.pipeline import (
        construct_resnet,
        synthetic_imagenet,
    )

    cpu = cli_args({}, device)
    out = {"seconds": {}, "peaks": {}, "launches": {}}
    model, task = construct_resnet("resnet50", 1000, device=device)
    log(f"examples 22 (b) imagenet: ResNet-50 (1000 classes, 224x224x3), "
        f"{sum(p.numel() for p in model.module.parameters()):,} parameters; {IMAGENET_N} train "
        f"and {IMAGENET_QUERY_N} query examples, batches of {IMAGENET_EXAMPLE_BATCH}, rank "
        f"{IMAGENET_RANK} [{card}]")
    fit = direct_covariance(card, "imagenet", model.module, task,
                            synthetic_imagenet(IMAGENET_N, IMAGENET_SIZE, 1000, 0),
                            IMAGENET_EXAMPLE_BATCH, FactorArguments(strategy="ekfac"), device)
    del model
    if fit["wgmma"]:
        raise RuntimeError(f"imagenet: K1 left its fp32 route: {fit}")
    shape = ["--arch", "resnet50", "--image_size", str(IMAGENET_SIZE), "--num_classes", "1000",
             "--num_train", str(IMAGENET_N), "--num_query", str(IMAGENET_QUERY_N),
             "--query_gradient_low_rank", str(IMAGENET_RANK)] + cpu
    batch = ["--per_device_batch_size", str(IMAGENET_EXAMPLE_BATCH)]
    analyzer, want = run_example(
        card, "imagenet analyze", analyze.main,
        shape + ["--train_batch_size", str(IMAGENET_EXAMPLE_BATCH), "--query_batch_size",
                 str(IMAGENET_QUERY_N), "--output_dir", str(root / "imagenet")], [fit], out)
    finite_scores("imagenet analyze", want, (IMAGENET_QUERY_N, IMAGENET_N))
    del analyzer
    shutil.copytree(root / "imagenet" / "imagenet" / "factors_ekfac",
                    root / "imagenet_qb" / "imagenet_qb" / "factors_ekfac")
    rank_rho, rank_r = run_example(
        card, "imagenet query_batching_analysis", query_batching_analysis.main,
        shape + batch + ["--output_dir", str(root / "imagenet_qb")], [], out)
    out["rank_vs_full"] = {"spearman": rank_rho, "pearson": rank_r}
    if not (math.isfinite(rank_rho) and math.isfinite(rank_r)):
        raise RuntimeError(f"imagenet query_batching_analysis: {out['rank_vs_full']}")
    analyzer, got = run_example(
        card, "imagenet ddp_analyze", ddp_analyze.main,
        shape + batch + ["--output_dir", str(root / "imagenet_ddp")], [fit], out)
    if analyzer.mesh.data != 1 or analyzer.mesh.group is not None:
        raise RuntimeError(f"imagenet ddp_analyze: not one process: {analyzer.mesh}")
    finite_scores("imagenet ddp_analyze", got, (IMAGENET_QUERY_N, IMAGENET_N))
    del analyzer
    bitwise = torch.equal(got, want)
    gap = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    r = pearson(got.float(), want.float())
    out["ddp_vs_analyze"] = {"bitwise": bitwise, "max_rel": gap, "pearson": r}
    torch.cuda.empty_cache()
    log(f"examples 22 (b) imagenet: rank {IMAGENET_RANK} against full rank (query_batching_"
        f"analysis): Spearman {rank_rho:.6f}, Pearson {rank_r:.6f}; ddp_analyze as one process "
        f"against analyze at the same arguments: bit for bit {bitwise}, max |diff| / max|score| "
        f"{gap:.3e} (limit {DDP_ALONE_RTOL:g} unless bitwise), Pearson r {r:.8f} "
        f"(limit {DDP_ALONE_PEARSON_MIN}) [{card}]")
    if not bitwise and not (gap <= DDP_ALONE_RTOL and r >= DDP_ALONE_PEARSON_MIN):
        raise RuntimeError(f"imagenet ddp_analyze against analyze: {out['ddp_vs_analyze']}")
    return out


def examples_uci(card: str, root: Path, device) -> dict:
    """Phase 22 (c): the uci example's train, analyze and run_counterfactual
    at the scripts' own arguments (the 8 -> 64 -> 64 -> 1 MLP)."""
    from kronfluence_tpu_torch import FactorArguments
    from kronfluence_tpu_torch.examples.uci import analyze, run_counterfactual, train
    from kronfluence_tpu_torch.examples.uci.pipeline import (
        RegressionTask,
        construct_regression_mlp,
        get_regression_dataset,
    )

    cpu = cli_args({}, device)
    out = {"seconds": {}, "peaks": {}, "launches": {}}
    fit = direct_covariance(card, "uci", construct_regression_mlp(device=device),
                            RegressionTask(), get_regression_dataset("train"), 64,
                            FactorArguments(strategy="ekfac", use_empirical_fisher=True), device)
    model = run_example(card, "uci train",
                        train.main, ["--checkpoint_dir", str(root / "uci_checkpoint")] + cpu, [],
                        out)
    if not all(bool(torch.isfinite(t).all()) for t in model.state_dict().values()):
        raise RuntimeError("uci train: weights not finite")
    analyzer, scores = run_example(card, "uci analyze", analyze.main,
                                   ["--output_dir", str(root / "uci")] + cpu, [fit], out)
    finite_scores("uci analyze", scores, (16, 512))
    del analyzer
    out["counterfactual"] = run_example(
        card, "uci run_counterfactual", run_counterfactual.main,
        ["--output_dir", str(root / "uci_cf")] + cpu, [fit], out)
    if not all(math.isfinite(m) for m, _ in out["counterfactual"].values()):
        raise RuntimeError(f"uci run_counterfactual: {out['counterfactual']}")
    log(f"examples 22 (c) uci: counterfactual query losses (mean, std over 3 seeds) "
        f"{out['counterfactual']} [{card}]")
    return out


def phase_example_pipelines(card: str, device=torch.device("cuda", 0)) -> dict:
    """Phase 22: the port's cifar, imagenet and uci example pipelines through
    their entry points at full width, each script's launches held to the
    covariance stage called directly."""
    start = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="kf_chip_smoke_examples_"))
    out, seconds = {}, {}
    try:
        for name, run in (("cifar", examples_cifar), ("imagenet", examples_imagenet),
                          ("uci", examples_uci)):
            t = time.perf_counter()
            out[name] = run(card, root, device)
            seconds[name] = time.perf_counter() - t
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"examples 22: phase 22 took {time.perf_counter() - start:.1f} s (" + ", ".join(
        f"{name} {sec:.1f}" for name, sec in seconds.items()) + "); scripts' seconds " + ", ".join(
        f"{label} {sec:.3f}" for part in out.values() for label, sec in part["seconds"].items())
        + f" [{card}]")
    return out


def text_fits(card: str, label: str, module, task, data: dict, batch: int, device,
              recipes=("fp32",)) -> dict:
    """The covariance stage called directly on a text example's seed-0 model,
    data and batch under each recipe ("fp32": the scripts' EK-FAC; "bf16":
    the all-low-precision recipe); the launches depend on the shapes and the
    recipe, not on the weights, so one call stands for every script that
    fits at those shapes."""
    from kronfluence_tpu_torch import FactorArguments
    from kronfluence_tpu_torch.utils.common.factor_arguments import (
        all_low_precision_factor_arguments,
    )

    made = {"fp32": lambda: FactorArguments(strategy="ekfac"),
            "bf16": lambda: all_low_precision_factor_arguments("ekfac", "bfloat16")}
    return {name: direct_covariance(card, f"{label} {name}", module, task, data, batch,
                                    made[name](), device)
            for name in recipes}


def log_stages(card: str, label: str, analyzer, out: dict) -> None:
    """A full-width analyze's stage seconds, from its Analyzer's profiler
    (the scripts run with profile=True; nested regions after their parent)."""
    rows = analyzer.profiler.rows()
    out["stages"][label] = {name: sec for name, sec, _ in rows}
    log(f"examples {label}: stage seconds " + ", ".join(
        f"{name} {sec:.3f} ({calls}x)" for name, sec, calls in rows) + f" [{card}]")


def check_text_routes(label: str, fits: dict) -> None:
    """At a published width K1 runs: its fp32 route under the fp32 recipe,
    its wgmma route under the bf16 one."""
    for name, fit in fits.items():
        on_route = fit["wgmma"] == 0 if name == "fp32" else fit["wgmma"] == fit["K1"]
        if not (fit["K1"] > 0 and on_route):
            raise RuntimeError(f"{label} {name}: K1 off its route: {fit}")


def examples_glue(card: str, root: Path, device) -> dict:
    """Phase 23 (a): glue's five scripts at the smoke test's arguments, then
    analyze's recipe and half_precision_analysis's bf16 recipe against it
    at BERT-base's widths through the pipeline's own constructor."""
    from kronfluence_tpu_torch.examples.glue import (
        analyze,
        evaluate_lds,
        half_precision_analysis,
        run_counterfactual,
        train,
    )
    from kronfluence_tpu_torch.examples.glue.pipeline import (
        construct_classifier,
        get_sst2_dataset,
    )

    out = {"seconds": {}, "peaks": {}, "launches": {}, "stages": {}}
    run = functools.partial(run_example, card, naive_ok=True)
    small = dict(num_train=24, num_query=4, batch_size=8)
    tiny = text_fits(card, "glue d 128", *construct_classifier(device=device),
                     get_sst2_dataset("train", 24), 8, device, recipes=("fp32", "bf16"))
    run("glue train", train.main, cli_args(dict(num_train=24, epochs=1, batch_size=8,
                                                  checkpoint_dir=root / "glue_ckpt"), device),
        [], out)
    _, scores = run("glue analyze", analyze.main,
                    cli_args(dict(small, output_dir=root / "glue"), device), [tiny["fp32"]],
                    out)
    finite_scores("glue analyze", scores, (4, 24))
    run("glue half_precision_analysis", half_precision_analysis.main,
        cli_args(dict(small, output_dir=root / "glue_half"), device),
        [tiny["fp32"], tiny["bf16"]], out)
    run("glue run_counterfactual", run_counterfactual.main,
        cli_args(dict(small, remove=4, epochs=1, seeds=1, output_dir=root / "glue_cf"), device),
        [tiny["fp32"]], out)
    # The identity strategy fits the covariance too, as the JAX package's does.
    lds = run("glue evaluate_lds", evaluate_lds.main,
              cli_args(dict(small, num_subsets=3, epochs=1, output_dir=root / "glue_lds"),
                         device) + ["--strategies", "identity"], [tiny["fp32"]], out)
    del scores
    torch.cuda.empty_cache()

    module, task = construct_classifier(**BERT_BASE, device=device)
    train_data = get_sst2_dataset("train", GLUE_N, BERT_BASE["seq_len"], BERT_BASE["vocab"])
    query_data = get_sst2_dataset("eval", GLUE_QUERY_N, BERT_BASE["seq_len"], BERT_BASE["vocab"],
                                  seed=1)
    log(f"examples 23 (a) glue: EncoderClassifier at BERT-base's widths ({BERT_BASE}), "
        f"{sum(p.numel() for p in module.parameters()):,} parameters; {GLUE_N} train and "
        f"{GLUE_QUERY_N} query sequences, {int(train_data['attention_mask'].sum())} kept train "
        f"tokens, batches of {GLUE_BATCH} [{card}]")
    full = text_fits(card, "glue BERT-base", module, task, train_data, GLUE_BATCH, device,
                     recipes=("fp32", "bf16"))
    check_text_routes("glue BERT-base", full)
    analyzer, fp32 = run("glue analyze (BERT-base)",
                         lambda _: analyze.analyze(module, task, train_data, query_data,
                                                   GLUE_BATCH, str(root / "glue_bert")),
                         None, [full["fp32"]], out)
    finite_scores("glue analyze (BERT-base)", fp32, (GLUE_QUERY_N, GLUE_N))
    log_stages(card, "glue analyze (BERT-base)", analyzer, out)
    del analyzer, fp32
    # half_precision_analysis's fp32 pass is analyze's fit and scores (the
    # same model, data, batch and recipe): it finds them, as a rerun would,
    # and runs its bf16 pass alone.
    half = root / "glue_bert_half" / "glue_half"
    shutil.copytree(root / "glue_bert" / "glue" / "factors_ekfac", half / "factors_fp32")
    shutil.copytree(root / "glue_bert" / "glue" / "scores_pairwise", half / "scores_fp32")
    out["bf16_vs_fp32"] = run(
        "glue half_precision_analysis (BERT-base)",
        lambda _: half_precision_analysis.compare(module, task, train_data, query_data,
                                                  GLUE_BATCH, str(root / "glue_bert_half")),
        None, [full["bf16"]], out)
    del module
    torch.cuda.empty_cache()
    if not all(math.isfinite(v) for v in list(out["bf16_vs_fp32"].values()) + list(lds.values())):
        raise RuntimeError(f"glue: {out['bf16_vs_fp32']}, LDS {lds}")
    log(f"examples 23 (a) glue at BERT-base's widths: bf16 against fp32 pairwise scores "
        f"Pearson {out['bf16_vs_fp32']['pearson']:.6f}, Spearman "
        f"{out['bf16_vs_fp32']['spearman']:.6f}; d 128 LDS {lds} [{card}]")
    return out


def examples_swag(card: str, root: Path, device) -> dict:
    """Phase 23 (b): swag's four scripts at the smoke test's arguments, then
    analyze's recipe at RoBERTa-base's widths through the pipeline's own
    constructor, rank 16 against full rank (a second pairwise call on the
    same fit)."""
    from kronfluence_tpu_torch import ScoreArguments
    from kronfluence_tpu_torch.evaluate import spearman_correlation
    from kronfluence_tpu_torch.examples.swag import (
        analyze,
        evaluate_lds,
        influence_analysis,
        train,
    )
    from kronfluence_tpu_torch.examples.swag.pipeline import (
        construct_choice_model,
        synthetic_swag,
    )

    out = {"seconds": {}, "peaks": {}, "launches": {}, "stages": {}}
    run = functools.partial(run_example, card, naive_ok=True)
    small = dict(num_train=16, num_query=4, batch_size=4)
    tiny = text_fits(card, "swag d 128", *construct_choice_model(device=device),
                     synthetic_swag(16), 4, device)["fp32"]
    run("swag train", train.main, cli_args(dict(num_train=16, epochs=1, batch_size=4,
                                                  checkpoint_dir=root / "swag_ckpt"), device),
        [], out)
    _, scores = run("swag analyze", analyze.main,
                    cli_args(dict(small, query_gradient_low_rank=4, output_dir=root / "swag"),
                               device), [tiny], out)
    finite_scores("swag analyze", scores, (4, 16))
    # In analyze's output directory influence_analysis finds analyze's factors.
    got, _ = run("swag influence_analysis", influence_analysis.main,
                 cli_args(dict(small, query_gradient_low_rank=4, top_k=2,
                                 output_dir=root / "swag"), device), [], out)
    finite_scores("swag influence_analysis", torch.from_numpy(got), (4, 16))
    lds = run("swag evaluate_lds", evaluate_lds.main,
              cli_args(dict(small, num_subsets=4, epochs=1, output_dir=root / "swag_lds"),
                         device), [tiny, tiny], out)  # its ekfac and identity fits
    del scores
    torch.cuda.empty_cache()

    module, task = construct_choice_model(**ROBERTA_BASE, device=device)
    train_data = synthetic_swag(SWAG_N, seq_len=ROBERTA_BASE["seq_len"],
                                vocab=ROBERTA_BASE["vocab"], seed=0)
    query_data = synthetic_swag(SWAG_QUERY_N, seq_len=ROBERTA_BASE["seq_len"],
                                vocab=ROBERTA_BASE["vocab"], seed=1)
    log(f"examples 23 (b) swag: ChoiceScorer at RoBERTa-base's widths ({ROBERTA_BASE}), "
        f"{sum(p.numel() for p in module.parameters()):,} parameters; {SWAG_N} train and "
        f"{SWAG_QUERY_N} query examples of 4 choices, batches of {SWAG_BATCH} ("
        f"{4 * SWAG_BATCH} sequences), rank {SWAG_RANK} [{card}]")
    full = text_fits(card, "swag RoBERTa-base", module, task, train_data, SWAG_BATCH, device)
    check_text_routes("swag RoBERTa-base", full)
    analyzer, lowrank = run(
        "swag analyze (RoBERTa-base)",
        lambda _: analyze.analyze(module, task, train_data, query_data, SWAG_BATCH, SWAG_RANK,
                                  str(root / "swag_roberta")),
        None, [full["fp32"]], out)
    finite_scores("swag analyze (RoBERTa-base)", lowrank, (SWAG_QUERY_N, SWAG_N))
    log_stages(card, "swag analyze (RoBERTa-base)", analyzer, out)

    def full_rank(_):
        analyzer.compute_pairwise_scores(
            "pairwise_full", "ekfac", query_data, train_data,
            per_device_query_batch_size=SWAG_QUERY_N, per_device_train_batch_size=SWAG_BATCH,
            score_args=ScoreArguments())
        return analyzer.load_pairwise_scores("pairwise_full")["all_modules"]

    dense = finite_scores("swag full rank (RoBERTa-base)",
                          run("swag full rank (RoBERTa-base)", full_rank, None, [], out),
                          (SWAG_QUERY_N, SWAG_N))
    out["rank_vs_full"] = {
        "pearson": pearson(lowrank.float(), dense.float()),
        "spearman": float(np.mean(spearman_correlation(lowrank, dense))),
    }
    del analyzer, module, lowrank, dense
    torch.cuda.empty_cache()
    if not all(math.isfinite(v) for v in list(out["rank_vs_full"].values()) + list(lds.values())):
        raise RuntimeError(f"swag: {out['rank_vs_full']}, LDS {lds}")
    log(f"examples 23 (b) swag at RoBERTa-base's widths: rank {SWAG_RANK} against full rank "
        f"Pearson {out['rank_vs_full']['pearson']:.6f}, Spearman (per query) "
        f"{out['rank_vs_full']['spearman']:.6f}; d 128 LDS {lds} [{card}]")
    return out


def examples_dailymail(card: str, root: Path, device) -> dict:
    """Phase 23 (c): dailymail's three scripts at the smoke test's arguments
    (analyze loading train's checkpoint), then analyze's recipe at
    T5-small's widths through the pipeline's own constructor, tracking the
    blocks' projections (`t5_blocks_task`), and inspect_examples reading
    that run's scores."""
    from kronfluence_tpu_torch.examples.dailymail import analyze, inspect_examples, train
    from kronfluence_tpu_torch.examples.dailymail.pipeline import (
        construct_seq2seq,
        get_dailymail_dataset,
    )

    out = {"seconds": {}, "peaks": {}, "launches": {}, "stages": {}}
    run = functools.partial(run_example, card)
    small = dict(num_train=16, num_query=4)
    tiny = text_fits(card, "dailymail d 128", *construct_seq2seq(device=device),
                     get_dailymail_dataset("train", 16), 4, device)["fp32"]
    checkpoint = root / "dailymail_ckpt"
    run("dailymail train", train.main, cli_args(dict(num_train=16, epochs=1, batch_size=4,
                                                       checkpoint_dir=checkpoint), device),
        [], out)
    _, scores = run("dailymail analyze", analyze.main,
                    cli_args(dict(small, batch_size=4, checkpoint_dir=checkpoint,
                                    output_dir=root / "dailymail"), device), [tiny], out)
    finite_scores("dailymail analyze", scores, (4, 16))
    top, _ = run("dailymail inspect_examples", inspect_examples.main,
                 cli_args(dict(small, eval_idx=1, output_dir=root / "dailymail"), device),
                 [], out)
    if top != int(torch.argmax(scores[1].float())):
        raise RuntimeError(f"dailymail inspect_examples: top {top} is not analyze's")
    del scores
    torch.cuda.empty_cache()

    t5 = T5_SMALL
    module, _ = construct_seq2seq(**t5, device=device)
    task = t5_blocks_task(t5["num_layers"])
    train_data = get_dailymail_dataset("train", DAILYMAIL_FULL_N, t5["seq_len"], t5["seq_len"],
                                       t5["vocab"])
    query_data = get_dailymail_dataset("valid", DAILYMAIL_QUERY_N, t5["seq_len"], t5["seq_len"],
                                       t5["vocab"], seed=1)
    log(f"examples 23 (c) dailymail: EncDecLM at T5-small's widths ({t5}, MLP "
        f"{4 * t5['d_model']}), {sum(p.numel() for p in module.parameters()):,} parameters; "
        f"{DAILYMAIL_FULL_N} train and {DAILYMAIL_QUERY_N} query pairs, "
        f"{int(train_data['attention_mask'].sum())} kept article and "
        f"{int(train_data['decoder_attention_mask'].sum())} summary tokens, batches of "
        f"{DAILYMAIL_BATCH} [{card}]")
    full = text_fits(card, "dailymail T5-small", module, task, train_data, DAILYMAIL_BATCH,
                     device)
    check_text_routes("dailymail T5-small", full)
    analyzer, scores = run(
        "dailymail analyze (T5-small)",
        lambda _: analyze.analyze(module, task, train_data, query_data, DAILYMAIL_BATCH,
                                  str(root / "dailymail_t5")),
        None, [full["fp32"]], out)
    finite_scores("dailymail analyze (T5-small)", scores, (DAILYMAIL_QUERY_N, DAILYMAIL_FULL_N))
    log_stages(card, "dailymail analyze (T5-small)", analyzer, out)
    del analyzer, module
    torch.cuda.empty_cache()
    top, score = inspect_examples.main(
        ["--num_train", str(DAILYMAIL_FULL_N), "--num_query", str(DAILYMAIL_QUERY_N),
         "--eval_idx", "1", "--output_dir", str(root / "dailymail_t5")] + cli_args({}, device))
    if top != int(torch.argmax(scores[1].float())) or score != float(scores[1].float().max()):
        raise RuntimeError(f"dailymail inspect_examples at T5-small: {top}, {score}")
    log(f"examples 23 (c) dailymail at T5-small's widths: inspect_examples read analyze's "
        f"scores: query 1's top train pair #{top}, score {score:.6e} [{card}]")
    return out


def phase_text_pipelines(card: str, device=torch.device("cuda", 0)) -> dict:
    """Phase 23: the port's glue, swag and dailymail example pipelines
    through their entry points, each script's launches held to the
    covariance stage called directly."""
    start = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="kf_chip_smoke_text_"))
    out, seconds = {}, {}
    try:
        for name, run in (("glue", examples_glue), ("swag", examples_swag),
                          ("dailymail", examples_dailymail)):
            t = time.perf_counter()
            out[name] = run(card, root, device)
            seconds[name] = time.perf_counter() - t
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"examples 23: phase 23 took {time.perf_counter() - start:.1f} s (" + ", ".join(
        f"{name} {sec:.1f}" for name, sec in seconds.items()) + "); scripts' seconds " + ", ".join(
        f"{label} {sec:.3f}" for part in out.values() for label, sec in part["seconds"].items())
        + f" [{card}]")
    return out


def profile_eigh(card: str) -> None:
    """Cold and warm eigendecomposition seconds of both solvers on phase 5's
    covariance factors, and a torch.profiler kernel table of a warm run."""
    from torch.profiler import ProfilerActivity, profile

    from kronfluence_tpu_torch.factor.covariance import fit_covariance_matrices_with_loader
    from kronfluence_tpu_torch.factor.eigen import perform_eigendecomposition
    from kronfluence_tpu_torch.utils.dataset import BatchLoader

    profile_k2_variants(card)
    ctx = setup_main_path()
    cov = fit_covariance_matrices_with_loader(
        ctx["model"], ctx["task"], BatchLoader(ctx["data"]["cov"], COV_BATCH, device=ctx["device"]),
        ctx["factor_args"],
    )
    args = {}
    for solver in ("auto", "jacobi"):
        args[solver] = copy.deepcopy(ctx["factor_args"])
        args[solver].eigendecomposition_solver = solver
    for solver in ("auto", "jacobi", "jacobi", "auto"):
        _, sec = _stage(perform_eigendecomposition, cov, args[solver])
        log(f"eigendecomposition {solver}: {sec:.4f} s [{card}]")
    for solver in ("auto", "jacobi"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, sec = _stage(perform_eigendecomposition, cov, args[solver])
        kernels = kernel_table(prof, sec, f"eigendecomposition {solver}", card)
        log(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=15))
        if solver == "jacobi":
            total = sum(e.self_device_time_total for e in kernels)
            for name in ("jacobi_registers_kernel", "jacobi_kernel"):
                k2 = [e for e in kernels if name in e.key]
                us = sum(e.self_device_time_total for e in k2)
                log(f"K2 {name}: {sum(e.count for e in k2)} launches, device time {us / 1e6:.4f} s, "
                    f"{us / total:.3f} of the Jacobi stage's kernel time, {us / 1e6 / sec:.3f} of its "
                    f"wall {sec:.4f} s [{card}]")


# Copies of csrc/jacobi_m64.cu for `--profile-eigh`: name -> text replacements.
_K2_WARPS = ("constexpr int kWarps = 4;", "constexpr int kWarps = 8;")
_K2_BOUNDS = "__launch_bounds__(kThreads)"
K2_VARIANTS = {
    "8 warps": (_K2_WARPS,),
    "8 warps, registers capped for 3 CTAs an SM": (
        _K2_WARPS, (_K2_BOUNDS, "__launch_bounds__(kThreads, 3)")),
    "4 warps, registers capped for 4 CTAs an SM": ((_K2_BOUNDS, "__launch_bounds__(kThreads, 4)"),),
}
K2_SASS_OPS = ("instructions", "FMUL", "FADD", "SHFL", "SEL", "MOV", "STS", "LDS")


def profile_k2_variants(card: str) -> None:
    """The register K2 as built (4 warps, 8 column pairs a thread) against
    K2_VARIANTS, each built alone, its SASS counted and held bit for bit to
    the plain version first, in turns at the Jacobi path's three launch
    shapes."""
    from kronfluence_tpu_torch.ops.kernels import build
    from kronfluence_tpu_torch.ops.kernels.jacobi import (
        _EPS,
        jacobi_pivot_rotations,
        jacobi_pivot_rotations_reference,
    )

    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    log(f"SASS of jacobi_registers_kernel as built: "
        f"{sass_counts(build.library_path(), 'jacobi_registers_kernel', K2_SASS_OPS)}")
    fns = {"4 warps (as built)": lambda s: jacobi_pivot_rotations(s, 2)}
    for index, (name, replacements) in enumerate(K2_VARIANTS.items()):
        lib = build_variant("jacobi_m64.cu", index, replacements,
                            {"kf_jacobi_pivot_rotations_m64": [ptr, ptr, i32, i32, ctypes.c_float, ptr]})
        log(f"SASS of jacobi_registers_kernel, {name}: "
            f"{sass_counts(Path(lib._name), 'jacobi_registers_kernel', K2_SASS_OPS)}")

        def launch(s, lib=lib, name=name):
            v = torch.empty_like(s)
            build.check_launch(lib.kf_jacobi_pivot_rotations_m64(
                s.data_ptr(), v.data_ptr(), s.shape[0], 2, ctypes.c_float(_EPS),
                torch.cuda.current_stream().cuda_stream), f"jacobi ({name})")
            return v

        fns[name] = launch
    for y in JACOBI_MAIN_Y:
        s = sym_blocks(y, 64, seed=y * 64 + 2)
        want = jacobi_pivot_rotations_reference(s, 2)
        for name, fn in fns.items():
            if not torch.equal(fn(s), want):
                raise RuntimeError(f"K2 {name} is not bitwise equal to the plain version at Y {y}")
        turns = turns_ms({name: ((lambda fn=fn: fn(s)), ["jacobi_registers"]) for name, fn in fns.items()})
        log(f"K2 variants at Y {y} m 64 sweeps 2, events / device ms there, back: " + "; ".join(
            f"{name} " + ", ".join(f"{e:.4f} / {d:.4f}" for e, d in tt) for name, tt in turns.items())
            + f" [{card}]")


def kernel_table(prof, sec: float, what: str, card: str, top: int = 6) -> list:
    """Logs a profiled run's kernel time, busy share and top kernels; returns
    the kernel events."""
    # Kernels only: an operator's self device time repeats its kernels'.
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    log(f"profiled {what}: {sec:.4f} s wall, kernel time {device_us / 1e6:.4f} s, busy share "
        f"{device_us / 1e6 / sec:.3f} [{card}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3:10.1f} ms {100 * e.self_device_time_total / device_us:5.1f}% "
            f"x{e.count:<6d} {e.key[:90]}")
    return kernels


# Copies of csrc/syrk.cu for `--profile-k1`: name -> text replacements.
_RING = "constexpr int kStages = 4;"
_BOUNDS = "__launch_bounds__(kWgThreads, 1)"
_DIAG = "const bool diag = ti == tj;\n  const int warp"
K1_VARIANTS = {
    "kStages 3, two CTAs an SM": ((_RING, "constexpr int kStages = 3;"),
                                  (_BOUNDS, "__launch_bounds__(kWgThreads, 2)")),
    "kStages 3, one CTA an SM": ((_RING, "constexpr int kStages = 3;"),),
    "one stripe a tile (timing only)": ((_DIAG, "const bool diag = true;\n  const int warp"),),
}


def build_variant(source: str, index: int, replacements, argtypes: dict) -> ctypes.CDLL:
    """csrc/<source> with `replacements` applied ((old, new) text pairs, or
    (None, a function of the whole text)), built alone into _build/variants/
    and loaded with `argtypes` ({C function: argtypes})."""
    from kronfluence_tpu_torch.ops.kernels import build

    src = (build.CSRC_DIR / source).read_text()
    for old, new in replacements:
        if old is None:  # `new` rewrites the whole text
            src = new(src)
            continue
        if old not in src:
            raise RuntimeError(f"csrc/{source} no longer holds {old!r}")
        src = src.replace(old, new)
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"{Path(source).stem}_variant_{index}.cu"
    cu.write_text(src)
    lib_path = cu.with_suffix(".so")
    done = subprocess.run([build._nvcc(), *build.COMPILE_FLAGS, "-I", str(build.CSRC_DIR), "-shared",
                           "-o", str(lib_path), str(cu)], capture_output=True, text=True, timeout=600)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on {cu.name}:\n{done.stdout[-3000:]}{done.stderr[-3000:]}")
    for line in (done.stdout + done.stderr).splitlines():
        if "Used" in line or "spill" in line:
            log(f"    ptxas ({cu.name}): {line.split(':', 1)[-1].strip()}")
    lib = ctypes.CDLL(str(lib_path))
    for name, types in argtypes.items():
        getattr(lib, name).argtypes = types
        getattr(lib, name).restype = ctypes.c_int
    return lib


def profile_k1(card: str) -> None:
    """Covariance-stage seconds (cold, warm) on phase 5's model and data, a
    torch.profiler table of one warm run with K1's device time and share, and
    the wgmma kernel as built against K1_VARIANTS, in turns."""
    from torch.profiler import ProfilerActivity, profile

    from kronfluence_tpu_torch.factor.covariance import fit_covariance_matrices_with_loader
    from kronfluence_tpu_torch.ops.kernels.build import check_launch
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk, syrk_reference
    from kronfluence_tpu_torch.utils.dataset import BatchLoader

    ctx = setup_main_path()

    def covariance():
        return fit_covariance_matrices_with_loader(
            ctx["model"], ctx["task"], BatchLoader(ctx["data"]["cov"], COV_BATCH, device=ctx["device"]),
            ctx["factor_args"],
        )

    for run in ("cold", "warm", "warm"):
        _, sec = _stage(covariance)
        log(f"covariance {run}: {sec:.4f} s [{card}]")
    torch.cuda.synchronize()
    syrk.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, sec = _stage(covariance)
    kernels = kernel_table(prof, sec, "covariance (4 batches)", card, top=8)
    device_us = sum(e.self_device_time_total for e in kernels)
    k1 = [e for e in kernels if "syrk" in e.key]
    k1_us = sum(e.self_device_time_total for e in k1)
    log(f"K1 in the profiled covariance stage: {k1_us / 1e3:.2f} ms, "
        f"{100 * k1_us / device_us:.1f}% of kernel time, {sum(e.count for e in k1)} kernel "
        f"launches ({syrk.launches} by its counter): " + ", ".join(e.key[:60] for e in k1))

    p, i32 = ctypes.c_void_p, ctypes.c_int
    variants = {name: build_variant("syrk.cu", i, repl, {"kf_syrk_bf16_wgmma": [p, p, i32, i32, p]})
                for i, (name, repl) in enumerate(K1_VARIANTS.items())}
    gen = torch.Generator("cuda").manual_seed(0)
    for rows, n in SYRK_MAIN_SHAPES:
        a = torch.randn(rows, n, generator=gen, device="cuda").to(torch.bfloat16)
        want = syrk_reference(a)

        def launch(lib):
            out = torch.empty((n, n), dtype=torch.float32, device="cuda")
            check_launch(lib.kf_syrk_bf16_wgmma(a.data_ptr(), out.data_ptr(), rows, n,
                                                torch.cuda.current_stream().cuda_stream),
                         "syrk variant")
            return out

        times = {"as built (kStages 4, one CTA an SM)": [], **{name: [] for name in variants}}
        for name, lib in variants.items():
            if "timing only" not in name and not syrk_units(launch(lib), want) <= 1.0:
                raise RuntimeError(f"the K1 variant '{name}' disagrees at {rows}x{n}")
        for turn in (0, 1):
            order = list(times) if turn == 0 else list(reversed(times))
            for name in order:
                fn = (lambda: syrk(a)) if name.startswith("as built") else \
                    (lambda lib=variants[name]: launch(lib))
                times[name].append(median_ms(fn))
        lib_ms = median_ms(lambda: torch.mm(a.T, a, out_dtype=torch.float32))
        log(f"K1 {rows}x{n} bf16 in turns (there and back): " + "; ".join(
            f"{name} {t[0]:.4f} / {t[1]:.4f} ms" for name, t in times.items())
            + f"; torch.mm(..., out_dtype=fp32) {lib_ms:.4f} ms [{card}]")


# Copies of csrc/flash_backward.cu for `--profile-flash`: name -> text replacements.
_FB_ATOMICS = """      atomicAdd(reinterpret_cast<float2*>(dq_rows + n * 8), make_float2(dq_acc[n][0], dq_acc[n][1]));
      atomicAdd(reinterpret_cast<float2*>(dq_rows + 8 * kD + n * 8),
                make_float2(dq_acc[n][2], dq_acc[n][3]));"""
FB_VARIANTS = {
    "128-key tile (8 warps, no register cap)": (
        ("constexpr int kKeyTile = 64;", "constexpr int kKeyTile = 128;"),
        ("__global__ void __launch_bounds__(kThreads, 3)", "__global__ void __launch_bounds__(kThreads)")),
    # dQ is computed but never added (one store no input reaches): what the
    # atomics cost.
    "no dQ atomics (timing only)": ((_FB_ATOMICS, """      if (dq_acc[n][0] + dq_acc[n][1] + dq_acc[n][2] + dq_acc[n][3] == 1.0e38f) dq_rows[n * 8] = 0.f;"""),),
}


# Copies of csrc/flash_forward.cu for `--profile-flash`: name -> text
# replacements, FF's (D 64) and FFH's (D 128).
_FF_BOUNDS = "__global__ void __launch_bounds__(FF::kThreads)\n    flash_fwd_pipelined_kernel"
_FFH_SHAPE = "using FFH = Shape<128, 128, true>;"
FF_VARIANTS = {
    "128-query tile (8 warps)": (("using FF = Shape<64, 64, true>;",
                                  "using FF = Shape<64, 128, true>;"),),
    "registers capped for 4 CTAs an SM": (
        (_FF_BOUNDS, _FF_BOUNDS.replace("(FF::kThreads)", "(FF::kThreads, 4)")),),
}
FFH_VARIANTS = {
    "64-query tile (4 warps)": ((_FFH_SHAPE, "using FFH = Shape<128, 64, true>;"),),
    "64-query tile (4 warps), Q's fragments reloaded from shared memory every key tile": (
        (_FFH_SHAPE, "using FFH = Shape<128, 64, false>;"),),
}


# Copies of csrc/flash_backward_d128.cu for `--profile-flash`: name -> text
# replacements (F2H's other register layout, its buffering and its query
# step; F3H is left as built).
D128_VARIANTS = {
    "F2H with paired warps (8 warps, 64-query steps, P^T and dS^T through shared memory)": (
        ("constexpr bool kPairedWarps = false;", "constexpr bool kPairedWarps = true;"),),
    "F2H with a 3-stage query ring": (("constexpr int kDkvStages = 2;",
                                       "constexpr int kDkvStages = 3;"),),
    "F2H with 64-query steps": (("constexpr int kDkvQueries = kPairedWarps ? 64 : 32;",
                                 "constexpr int kDkvQueries = 64;"),),
}


# Copies of csrc/flash_backward_f32_d128.cu for `--profile-flash`: name ->
# text replacements. Unrolled whole, F3SH's code is 8,272 instructions (132
# KB), F2SH's 5,592.
_NT_LOOP = "#pragma unroll\n  for (int d = 0; d < kD; d += 4) {"
_NN_LOOP = "#pragma unroll\n  for (int k = 0; k < kK; ++k) {"
F32_D128_VARIANTS = {
    "product loops unrolled 8 steps at a time": (
        (_NT_LOOP, _NT_LOOP.replace("unroll", "unroll 8")),
        (_NN_LOOP, _NN_LOOP.replace("unroll", "unroll 8"))),
}


# A copy of csrc/flash_forward_f32.cu for `--profile-flash`: FFS at D 128 with
# the other key step, 32 keys a step at two CTAs an SM (registers capped at
# 128), against 64 keys at one CTA as built.
FFS_VARIANTS = {
    "32-key steps, two CTAs an SM": (("constexpr int kD128Keys = 64;",
                                      "constexpr int kD128Keys = 32;"),),
}

# Copies for `--profile-flash` against FFS64 as built (4 x 8 thread tiles):
# name -> (source, C entry, kernel name in the SASS, occupancy entry, kernel
# names for torch.profiler, text replacements). FFS64 with 8 x 8 thread tiles
# (kRowsPerThread 8: 4 warps, 128 accumulators); FFS's own body
# (csrc/flash_forward_f32.cu) instanced at D 64 with 64-key steps (Ffs<64,
# 64>: 4 x 4 thread tiles, 8 warps, a 64-query tile, no diagonal skip).
FFS64_VARIANTS = {
    "8 x 8 thread tiles, 4 warps": (
        "flash_forward_f32_d64.cu", "kf_flash_fwd_f32_d64", FFS64_KERNEL, FFS64_OCCUPANCY,
        FFS64_PROFILED,
        (("constexpr int kRowsPerThread = 4;", "constexpr int kRowsPerThread = 8;"),)),
    "FFS's body at D 64 (Ffs<64, 64>)": (
        "flash_forward_f32.cu", "kf_flash_fwd_f32", "flash_fwd_f32_kernelILi64", FFS_OCCUPANCY,
        FFS_PROFILED,
        (("    case 256: return launch<256, 32>(",
          "    case 64: return launch<64, 64>(q, k, v, seg, o, l, m, B, H, T_len, scale, s);\n"
          "    case 256: return launch<256, 32>("),
         ("return which == 0 ? occupancy<128, kD128Keys>(regs, local_bytes, ctas)",
          "return which == 0 ? occupancy<64, 64>(regs, local_bytes, ctas)"))),
}

# A copy of csrc/flash_backward_f32_d256.cu for `--profile-flash`: F3SW with
# no D split. Warp group 0 sums S and group 1 dP over all 256 columns on 2 x 4
# thread tiles (rows r + 16 i, r < 16), with no partial sums to trade; group 0
# writes P^T, and after a CTA-wide barrier group 1 writes dS^T over it (F3SH's
# order). As built, each pair of warps sums one product over one half of D on
# 4 x 4 tiles, and group 1 adds group 0's partials.
_F3SW_NO_SPLIT_LOOP = """    float sp[2][4];  // S (group 0) or dP (group 1) over all of D
    zero(sp);
    nt_full(sp, a_nt, r, g ? vs : ks, c);
    if (g == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r + 16 * i;
        const float m_r = rows[row], rl = rows[kTile + row];
        const int seg_r = reinterpret_cast<const int*>(rows)[3 * kTile + row];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c + 8 * j;
          const bool keep = k0 + col <= q0 + row && seg_k[col] == seg_r;
          pt[col * kLdP + row] = keep ? expf(sp[i][j] * scale - m_r) * rl : 0.f;
        }
      }
    }
    __syncthreads();
    if (g == 1) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r + 16 * i;
        const float di_r = rows[2 * kTile + row];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* x = pt + (c + 8 * j) * kLdP + row;
          *x = *x * (sp[i][j] - di_r) * scale;
        }
      }
    }
    __syncthreads();
    nn_product<1>(dq_acc, pt, 4 * rq, ks, 4 * cq);
"""
_NT_FULL = """// NT form over all of D on a 2 x 4 tile: acc[i][j] += sum over d < 256 of
// A[ra + 16 i][d] * B[rb + 8 j][d].
__device__ __forceinline__ void nt_full(float (&acc)[2][4], const float* a, int ra, const float* b,
                                        int rb) {
#pragma unroll
  for (int d = 0; d < kD; d += 4) {
    float4 x[2], y[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) x[i] = ld4(a + (ra + 16 * i) * kLd + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = ld4(b + (rb + 8 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}

// NN form:"""


def f3sw_no_split(src: str) -> str:
    """csrc/flash_backward_f32_d256.cu with F3SW's D split taken out."""
    start = src.index("    float sp[4][4];  // this half's S or dP")
    end = src.index("    nn_product<1>(dq_acc, pt, 4 * rq, ks, 4 * cq);\n")
    end += len("    nn_product<1>(dq_acc, pt, 4 * rq, ks, 4 * cq);\n")
    return src[:start] + _F3SW_NO_SPLIT_LOOP + src[end:]


F32_D256_VARIANTS = {
    "F3SW without the D split (2 x 4 S and dP tiles)": (
        ("// NN form:", _NT_FULL),
        ("  const int g = warp >> 2, pr = (warp >> 1) & 1;\n"
         "  const int r = 4 * (warp & 1) + (lane >> 3), c = lane & 7;\n"
         "  const int rq = tid >> 5, cq = tid & 31;",
         "  const int g = warp >> 2;\n"
         "  const int r = 4 * (warp & 3) + (lane >> 3), c = lane & 7;\n"
         "  const int rq = tid >> 5, cq = tid & 31;"),
        ("  const float* a_nt = fsm + (pr ? kDqSmemDo : kDqSmemQ) / 4 + kHalf * g;\n"
         "  float* xs = reinterpret_cast<float*>(smem + kDqSmemX + pr * kXBytes);\n",
         "  const float* a_nt = fsm + (g ? kDqSmemDo : kDqSmemQ) / 4;\n"),
        (None, f3sw_no_split)),
}


def turns_ms(fns: dict) -> dict:
    """{name: [(event ms, device ms) there, (...) back]} for {name: (fn,
    kernel names)}, timed in turns, there and back."""
    times = {name: [] for name in fns}
    for order in (list(fns), list(reversed(fns))):
        for name in order:
            fn, kernels = fns[name]
            times[name].append((median_ms(fn), device_ms(fn, kernels)))
    return times


def profile_flash(card: str) -> None:
    """FB as built (64-key tile) against FB_VARIANTS and F2+F3, then FF as
    built (64-query tile) against FF_VARIANTS and F1, at the flash path's
    shape, in turns, after holding each variant to the bf16 limit; then FFH
    and F2H + F3H at Llama's (profile_ffh, profile_d128), F2SH and F3SH
    (profile_f32_d128) and FFS (profile_ffs) at the fp32 D 128 case, FFS64
    (profile_ffs64) at the fp32 D 64 case, and
    F3SW (profile_f32_d256) at the fp32 D 256 case."""
    from kronfluence_tpu_torch.ops.attention import output_dot
    from kronfluence_tpu_torch.ops.kernels.build import check_launch
    from kronfluence_tpu_torch.ops.kernels.flash import (
        flash_backward,
        flash_backward_dkv,
        flash_backward_dq,
        flash_backward_reference,
        flash_forward,
        flash_forward_pipelined,
        flash_forward_reference,
    )

    p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    variants = {name: build_variant("flash_backward.cu", i, repl,
                                    {"kf_flash_bwd_fused": [*[p] * 11, i32, i32, i32, i32, f32, p]})
                for i, (name, repl) in enumerate(FB_VARIANTS.items())}
    b, h, t, d = FLASH_CASES[0][:4]
    gen = torch.Generator("cuda").manual_seed(b * t + d)
    q, k, v, do = (torch.randn(b, h, t, d, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    seg = padded_segments(b, t, True, "cuda")
    scale = d ** -0.5
    o, l, m = flash_forward(q, k, v, seg, scale)
    di = output_dot(o, do)
    want = flash_backward_reference(q, k, v, seg, l, m, do, di, scale)

    def launch(lib):
        dq = torch.zeros((b, h, t, d), dtype=torch.float32, device="cuda")
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        check_launch(lib.kf_flash_bwd_fused(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), l.data_ptr(), m.data_ptr(),
            do.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, t, d,
            float(scale), torch.cuda.current_stream().cuda_stream), "FB variant")
        return dq.to(torch.bfloat16), dk, dv

    for name, lib in variants.items():
        if "timing only" in name:
            continue
        units = [bf16_units(x, y) for x, y in zip(launch(lib), want)]
        log(f"FB variant '{name}': dQ, dK, dV in bf16 units {[round(u, 3) for u in units]}")
        if not max(units) <= FLASH_BF16_UNITS:
            raise RuntimeError(f"the FB variant '{name}' disagrees with the plain version")
    fb_kernel, split_kernels = ("flash_bwd_fused_kernel",), ("flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")
    fns = {"as built (64-key tile, 4 warps, 3 CTAs an SM)": (lambda: flash_backward(q, k, v, seg, l, m, do, di, scale),
                                               fb_kernel),
           **{name: (lambda lib=lib: launch(lib), fb_kernel) for name, lib in variants.items()},
           "F2+F3": (lambda: (flash_backward_dkv(q, k, v, seg, l, m, do, di, scale),
                              flash_backward_dq(q, k, v, seg, l, m, do, di, scale)), split_kernels)}
    # What the wrapper adds around the kernel: zeroing the fp32 dQ sum and
    # casting it to bf16.
    dq_sum = torch.zeros((b, h, t, d), dtype=torch.float32, device="cuda")
    fns["wrapper's dQ zeroing + cast alone"] = (
        lambda: (dq_sum.zero_(), dq_sum.to(torch.bfloat16)), ("fill", "elementwise", "copy"))
    times = turns_ms(fns)
    log(f"FB at B {b} H {h} T {t} D {d} bf16 padded, in turns (there and back); ms per call: "
        f"one call between CUDA events (median), and the device time of the kernels named "
        f"(torch.profiler): " + "; ".join(
            f"{name} " + " / ".join(f"({a:.4f}, {c:.4f})" for a, c in ts)
            for name, ts in times.items()) + f" [{card}]")

    ff_variants = {name: build_variant("flash_forward.cu", i, repl,
                                       {"kf_flash_fwd_pipelined": [*[p] * 7, i32, i32, i32, i32, f32, p]})
                   for i, (name, repl) in enumerate(FF_VARIANTS.items())}
    want_fwd = flash_forward_reference(q, k, v, seg, scale)

    def launch_ff(lib):
        out = torch.empty_like(q)
        l_, m_ = (torch.empty((b, h, t), dtype=torch.float32, device="cuda") for _ in range(2))
        check_launch(lib.kf_flash_fwd_pipelined(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), out.data_ptr(),
            l_.data_ptr(), m_.data_ptr(), b, h, t, d, float(scale),
            torch.cuda.current_stream().cuda_stream), "FF variant")
        return out, l_, m_

    for name, lib in ff_variants.items():
        o_, l_, m_ = launch_ff(lib)
        errs = (bf16_units(o_, want_fwd[0]), relative_to_max(l_, want_fwd[1]),
                relative_to_max(m_, want_fwd[2]))
        log(f"FF variant '{name}': O in bf16 units, l, m relative to max {[f'{e:.3g}' for e in errs]}")
        if not (errs[0] <= FLASH_BF16_UNITS and max(errs[1:]) <= FLASH_STATS_TOL):
            raise RuntimeError(f"the FF variant '{name}' disagrees with the plain version")
    ff_kernel = ("flash_fwd_pipelined_kernel",)
    fns = {"as built (64-query tile, 4 warps)": (lambda: flash_forward_pipelined(q, k, v, seg, scale),
                                                 ff_kernel),
           **{name: (lambda lib=lib: launch_ff(lib), ff_kernel) for name, lib in ff_variants.items()},
           "F1": (lambda: flash_forward(q, k, v, seg, scale), ("flash_fwd_kernel",))}
    times = turns_ms(fns)
    log(f"FF at B {b} H {h} T {t} D {d} bf16 padded, in turns (there and back); ms per call: "
        f"one call between CUDA events (median), and the device time of the kernels named "
        f"(torch.profiler): " + "; ".join(
            f"{name} " + " / ".join(f"({a:.4f}, {c:.4f})" for a, c in ts)
            for name, ts in times.items()) + f" [{card}]")
    profile_ffh(card)
    profile_d128(card)
    profile_f32_d128(card)
    profile_ffs(card)
    profile_ffs64(card)
    profile_f32_d256(card)


def profile_ffh(card: str) -> None:
    """FFH as built against copies of csrc/flash_forward.cu (FFH_VARIANTS)
    with each kernel's SASS counts, registers, spills and CTAs an SM; then,
    at both bf16 D 128 cases of GENERIC_ROUTE_CASES, each held to the bf16
    limit and all of them and F1 timed in turns."""
    from kronfluence_tpu_torch.ops.kernels.build import check_launch, library_path, load_library
    from kronfluence_tpu_torch.ops.kernels.flash import flash_forward, flash_forward_reference

    p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    argtypes = {"kf_flash_fwd_d128": [*[p] * 7, i32, i32, i32, i32, f32, p],
                "kf_flash_fwd_occupancy": [i32, p, p, p]}
    libs = {"as built (128-query tile, 8 warps, Q in registers)": (load_library(), library_path())}
    for i, (name, repl) in enumerate(FFH_VARIANTS.items()):
        lib = build_variant("flash_forward.cu", len(FF_VARIANTS) + i, repl, argtypes)
        libs[name] = (lib, Path(lib._name))
    kernel = FWD_KERNELS[1]
    for name, (lib, path) in libs.items():
        log(f"FFH '{name}': SASS {sass_counts(path, kernel, D128_OPCODES)}; "
            f"{occupancy(lib, FWD_OCCUPANCY, 1)}")
    for case in ("Llama bf16 D 128", "bf16 D 128"):
        b, h, t, d, dtype, padded = GENERIC_ROUTE_CASES[case]
        gen = torch.Generator("cuda").manual_seed(b * t + d)
        q, k, v = (torch.randn(b, h, t, d, generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        seg = padded_segments(b, t, padded, "cuda")
        scale = d ** -0.5

        def launch(lib):
            out = torch.empty_like(q)
            l_, m_ = (torch.empty((b, h, t), dtype=torch.float32, device="cuda") for _ in range(2))
            check_launch(lib.kf_flash_fwd_d128(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), out.data_ptr(),
                l_.data_ptr(), m_.data_ptr(), b, h, t, d, float(scale),
                torch.cuda.current_stream().cuda_stream), "FFH copy")
            return out, l_, m_

        want = flash_forward_reference(q, k, v, seg, scale)
        for name, (lib, _) in libs.items():
            o_, l_, m_ = launch(lib)
            errs = (bf16_units(o_, want[0]), relative_to_max(l_, want[1]),
                    relative_to_max(m_, want[2]))
            log(f"FFH '{name}' at {case}: O in bf16 units, l, m relative to max "
                f"{[f'{e:.3g}' for e in errs]}")
            if not (errs[0] <= FLASH_BF16_UNITS and max(errs[1:]) <= FLASH_STATS_TOL):
                raise RuntimeError(f"the FFH copy '{name}' disagrees with the plain version")
        del want
        fns = {f"FFH {name}": (lambda lib=lib: launch(lib), (kernel,))
               for name, (lib, _) in libs.items()}
        fns["F1"] = (lambda: flash_forward(q, k, v, seg, scale), ("flash_fwd_kernel",))
        times = turns_ms(fns)
        log(f"FFH at B {b} H {h} T {t} D {d} bf16{' padded' if padded else ''}, in turns (there "
            f"and back); ms per call: one call between CUDA events (median), and the device time "
            f"of the kernels named (torch.profiler): " + "; ".join(
                f"{name} " + " / ".join(f"({a:.4f}, {c:.4f})" for a, c in ts)
                for name, ts in times.items()) + f" [{card}]")


def profile_d128(card: str) -> None:
    """F2H and F3H as built against copies of csrc/flash_backward_d128.cu
    (D128_VARIANTS), each held to the bf16 limit first, with each kernel's
    SASS counts, registers, spills and CTAs an SM; then F2H as built and its
    copies, F3H, and F2 and F3 in turns at Llama's shape."""
    from kronfluence_tpu_torch.ops.attention import output_dot
    from kronfluence_tpu_torch.ops.kernels.build import check_launch, library_path, load_library
    from kronfluence_tpu_torch.ops.kernels.flash import (
        flash_backward_dkv,
        flash_backward_dkv_reference,
        flash_backward_dq,
        flash_backward_dq_reference,
        flash_forward,
    )

    p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    argtypes = {"kf_flash_bwd_dkv_d128": [*[p] * 10, i32, i32, i32, i32, f32, p],
                "kf_flash_bwd_dq_d128": [*[p] * 9, i32, i32, i32, i32, f32, p],
                "kf_flash_bwd_d128_occupancy": [i32, p, p, p]}
    libs = {"as built": (load_library(), library_path())}
    for i, (name, repl) in enumerate(D128_VARIANTS.items()):
        lib = build_variant("flash_backward_d128.cu", i, repl, argtypes)
        libs[name] = (lib, Path(lib._name))
    for name, (lib, path) in libs.items():
        for which, kernel in enumerate(D128_KERNELS):
            log(f"F2H/F3H '{name}', {kernel}: SASS {sass_counts(path, kernel, D128_OPCODES)}; "
                f"{occupancy(lib, D128_OCCUPANCY, which)}")
    b, h, t, d, dtype, padded = GENERIC_ROUTE_CASES["Llama bf16 D 128"]
    gen = torch.Generator("cuda").manual_seed(b * t + d)
    q, k, v, do = (torch.randn(b, h, t, d, generator=gen, device="cuda").to(dtype)
                   for _ in range(4))
    seg = padded_segments(b, t, padded, "cuda")
    scale = d ** -0.5
    o, l, m = flash_forward(q, k, v, seg, scale)
    di = output_dot(o, do)
    args = (q, k, v, seg, l, m, do, di, scale)
    ptrs = [x.data_ptr() for x in (q, k, v, seg, l, m, do, di)]

    def dkv(lib):
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        check_launch(lib.kf_flash_bwd_dkv_d128(*ptrs, dk.data_ptr(), dv.data_ptr(), b, h, t, d,
                                               float(scale), torch.cuda.current_stream().cuda_stream),
                     "F2H variant")
        return dk, dv

    def dq(lib):
        out = torch.empty_like(q)
        check_launch(lib.kf_flash_bwd_dq_d128(*ptrs, out.data_ptr(), b, h, t, d, float(scale),
                                              torch.cuda.current_stream().cuda_stream), "F3H variant")
        return out

    want = (*flash_backward_dkv_reference(*args), flash_backward_dq_reference(*args))
    for name, (lib, _) in libs.items():
        units = [bf16_units(x, y) for x, y in zip((*dkv(lib), dq(lib)), want)]
        log(f"F2H/F3H '{name}': dK, dV, dQ in bf16 units {[round(u, 3) for u in units]}")
        if not max(units) <= FLASH_BF16_UNITS:
            raise RuntimeError(f"the F2H/F3H copy '{name}' disagrees with the plain version")
    del want
    dkv_k, dq_k = (D128_KERNELS[0],), (D128_KERNELS[1],)
    fns = {f"F2H {name}": (lambda lib=lib: dkv(lib), dkv_k) for name, (lib, _) in libs.items()}
    fns["F3H as built"] = (lambda: dq(libs["as built"][0]), dq_k)
    fns["F2"] = (lambda: flash_backward_dkv(*args), ("flash_bwd_dkv_kernel",))
    fns["F3"] = (lambda: flash_backward_dq(*args), ("flash_bwd_dq_kernel",))
    times = turns_ms(fns)
    log(f"F2H and F3H at B {b} H {h} T {t} D {d} bf16, in turns (there and back); ms per call: "
        f"one call between CUDA events (median), and the device time of the kernels named "
        f"(torch.profiler): " + "; ".join(
            f"{name} " + " / ".join(f"({a:.4f}, {c:.4f})" for a, c in ts)
            for name, ts in times.items()) + f" [{card}]")


def profile_f32_d128(card: str) -> None:
    """F2SH and F3SH as built against copies of csrc/flash_backward_f32_d128.cu
    (F32_D128_VARIANTS), each held to the built kernels' bits first, with each
    kernel's SASS counts, registers, spills and CTAs an SM; then each
    kernel's builds in turns at the fp32 D 128 case."""
    from kronfluence_tpu_torch.ops.attention import output_dot
    from kronfluence_tpu_torch.ops.kernels.build import check_launch, library_path, load_library
    from kronfluence_tpu_torch.ops.kernels.flash import (
        flash_backward_dkv_f32_d128,
        flash_backward_dq_f32_d128,
        flash_forward,
    )

    p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    argtypes = {"kf_flash_bwd_dkv_f32_d128": [*[p] * 10, i32, i32, i32, i32, f32, p],
                "kf_flash_bwd_dq_f32_d128": [*[p] * 9, i32, i32, i32, i32, f32, p],
                "kf_flash_bwd_f32_d128_occupancy": [i32, p, p, p]}
    libs = {"as built": (load_library(), library_path())}
    for i, (name, repl) in enumerate(F32_D128_VARIANTS.items()):
        lib = build_variant("flash_backward_f32_d128.cu", i, repl, argtypes)
        libs[name] = (lib, Path(lib._name))
    for name, (lib, path) in libs.items():
        for which, kernel in enumerate(F32_D128_KERNELS):
            log(f"F2SH/F3SH '{name}', {kernel}: SASS {sass_counts(path, kernel, F32_OPCODES)}; "
                f"{occupancy(lib, F32_D128_OCCUPANCY, which)}")
    b, h, t, d, dtype, padded = GENERIC_ROUTE_CASES["fp32 D 128"]
    gen = torch.Generator("cuda").manual_seed(b * t + d)
    q, k, v, do = (torch.randn(b, h, t, d, generator=gen, device="cuda").to(dtype)
                   for _ in range(4))
    seg = padded_segments(b, t, padded, "cuda")
    scale = d ** -0.5
    o, l, m = flash_forward(q, k, v, seg, scale)
    di = output_dot(o, do)
    ptrs = [x.data_ptr() for x in (q, k, v, seg, l, m, do, di)]
    stream = torch.cuda.current_stream().cuda_stream

    def dkv(lib):
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        check_launch(lib.kf_flash_bwd_dkv_f32_d128(*ptrs, dk.data_ptr(), dv.data_ptr(), b, h, t,
                                                   d, float(scale), stream), "F2SH copy")
        return dk, dv

    def dq(lib):
        out = torch.empty_like(q)
        check_launch(lib.kf_flash_bwd_dq_f32_d128(*ptrs, out.data_ptr(), b, h, t, d, float(scale),
                                                  stream), "F3SH copy")
        return out

    built = (*flash_backward_dkv_f32_d128(q, k, v, seg, l, m, do, di, scale),
             flash_backward_dq_f32_d128(q, k, v, seg, l, m, do, di, scale))
    for name, (lib, _) in libs.items():
        same = [torch.equal(x, y) for x, y in zip((*dkv(lib), dq(lib)), built)]
        log(f"F2SH/F3SH '{name}': dK, dV, dQ bitwise the built kernels' {same}")
        if not all(same):
            raise RuntimeError(f"the F2SH/F3SH copy '{name}' changed the sums")
    del built
    dkv_k, dq_k = (F32_D128_KERNELS[0],), (F32_D128_KERNELS[1],)
    fns = {f"F2SH {name}": (lambda lib=lib: dkv(lib), dkv_k) for name, (lib, _) in libs.items()}
    fns.update({f"F3SH {name}": (lambda lib=lib: dq(lib), dq_k) for name, (lib, _) in libs.items()})
    times = turns_ms(fns)
    log(f"F2SH and F3SH at B {b} H {h} T {t} D {d} fp32 padded, in turns (there and back); ms "
        f"per call: one call between CUDA events (median), and the device time of the kernels "
        f"named (torch.profiler): " + "; ".join(
            f"{name} " + " / ".join(f"({a:.4f}, {c:.4f})" for a, c in ts)
            for name, ts in times.items()) + f" [{card}]")


def profile_ffs(card: str) -> None:
    """FFS as built (64-key steps at D 128, one CTA an SM) against
    FFS_VARIANTS at the fp32 D 128 case, with each kernel's SASS counts,
    registers, spills and CTAs an SM. Each build is held to the plain
    version within 1e-5 of max and to its own bits on a second call; the key
    step moves the rescales of the running sums, so a copy's bits differ
    from the built kernel's, and their largest difference is logged. Then
    the builds and F1 in turns."""
    from kronfluence_tpu_torch.ops.kernels.build import check_launch, library_path, load_library
    from kronfluence_tpu_torch.ops.kernels.flash import (
        flash_forward,
        flash_forward_f32,
        flash_forward_reference,
    )

    p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    argtypes = {"kf_flash_fwd_f32": [*[p] * 7, i32, i32, i32, i32, f32, p],
                "kf_flash_fwd_f32_occupancy": [i32, p, p, p]}
    libs = {"as built": (load_library(), library_path())}
    for i, (name, repl) in enumerate(FFS_VARIANTS.items()):
        lib = build_variant("flash_forward_f32.cu", i, repl, argtypes)
        libs[name] = (lib, Path(lib._name))
    for name, (lib, path) in libs.items():
        log(f"FFS '{name}', D 128: SASS {sass_counts(path, FFS_KERNELS[0], F32_OPCODES)}; "
            f"{occupancy(lib, FFS_OCCUPANCY, 0)}")
    b, h, t, d, dtype, padded = GENERIC_ROUTE_CASES["fp32 D 128"]
    gen = torch.Generator("cuda").manual_seed(b * t + d)
    q, k, v = (torch.randn(b, h, t, d, generator=gen, device="cuda").to(dtype) for _ in range(3))
    seg = padded_segments(b, t, padded, "cuda")
    scale = d ** -0.5
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib):
        o = torch.empty_like(q)
        l = torch.empty((b, h, t), dtype=torch.float32, device="cuda")
        m = torch.empty_like(l)
        check_launch(lib.kf_flash_fwd_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
                                          o.data_ptr(), l.data_ptr(), m.data_ptr(), b, h, t, d,
                                          float(scale), stream), "FFS copy")
        return o, l, m

    want = flash_forward_reference(q, k, v, seg, scale)
    built = flash_forward_f32(q, k, v, seg, scale)
    for name, (lib, _) in libs.items():
        got, again = launch(lib), launch(lib)
        rel = [relative_to_max(x, y) for x, y in zip(got, want)]
        bitwise = [torch.equal(x, y) for x, y in zip(got, again)]
        same = [torch.equal(x, y) for x, y in zip(got, built)]
        log(f"FFS '{name}': O, l, m max |copy - plain| / max |plain| "
            f"{[f'{e:.3g}' for e in rel]} (limit {FLASH_FP32_TOL:g}); two calls bitwise equal "
            f"{bitwise}; bitwise the built kernel's {same}, O off it by at most "
            f"{float((got[0] - built[0]).abs().max()):.3g}")
        if not (max(rel) <= FLASH_FP32_TOL and all(bitwise)):
            raise RuntimeError(f"the FFS copy '{name}' is off its plain version: {rel}, {bitwise}")
    del built, want
    fns = {f"FFS {name}": (lambda lib=lib: launch(lib), FFS_PROFILED)
           for name, (lib, _) in libs.items()}
    fns["F1"] = (lambda: flash_forward(q, k, v, seg, scale), ("flash_fwd_kernel",))
    times = turns_ms(fns)
    log(f"FFS at B {b} H {h} T {t} D {d} fp32 padded, in turns (there and back); ms per call: "
        f"one call between CUDA events (median), and the device time of the kernels named "
        f"(torch.profiler): " + "; ".join(
            f"{name} " + " / ".join(f"({a:.4f}, {c:.4f})" for a, c in ts)
            for name, ts in times.items()) + f" [{card}]")


def profile_ffs64(card: str) -> None:
    """FFS64 as built (4 x 8 thread tiles, 8 warps, two CTAs an SM) against
    FFS64_VARIANTS at the fp32 D 64 route case (B 16, H 12, T 512, padded),
    with each kernel's SASS counts, registers, spills and CTAs an SM. Each
    build is held to the plain version within 1e-5 of max and to its own bits
    on a second call; then the builds and F1 in turns."""
    from kronfluence_tpu_torch.ops.kernels.build import check_launch, library_path, load_library
    from kronfluence_tpu_torch.ops.kernels.flash import flash_forward, flash_forward_reference

    p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = {"as built (4 x 8 thread tiles, 8 warps)": (
        load_library(), library_path(), "kf_flash_fwd_f32_d64", FFS64_KERNEL, FFS64_OCCUPANCY,
        FFS64_PROFILED)}
    for i, (name, (source, entry, sass_name, occ_entry, profiled, repl)) in enumerate(
            FFS64_VARIANTS.items()):
        lib = build_variant(source, 10 + i, repl, {entry: [*[p] * 7, i32, i32, i32, i32, f32, p],
                                                   occ_entry: [i32, p, p, p]})
        libs[name] = (lib, Path(lib._name), entry, sass_name, occ_entry, profiled)
    for name, (lib, path, _, sass_name, occ_entry, _) in libs.items():
        log(f"FFS64 '{name}': SASS {sass_counts(path, sass_name, F32_OPCODES)}; "
            f"{occupancy(lib, occ_entry, 0)}")
    b, h, t, d, dtype, padded = GENERIC_ROUTE_CASES["fp32 D 64"]
    gen = torch.Generator("cuda").manual_seed(b * t + d)
    q, k, v = (torch.randn(b, h, t, d, generator=gen, device="cuda").to(dtype) for _ in range(3))
    seg = padded_segments(b, t, padded, "cuda")
    scale = d ** -0.5
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib, entry):
        o = torch.empty_like(q)
        l = torch.empty((b, h, t), dtype=torch.float32, device="cuda")
        m = torch.empty_like(l)
        check_launch(getattr(lib, entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                         seg.data_ptr(), o.data_ptr(), l.data_ptr(),
                                         m.data_ptr(), b, h, t, d, float(scale), stream),
                     "FFS64 copy")
        return o, l, m

    want = flash_forward_reference(q, k, v, seg, scale)
    for name, (lib, _, entry, *_) in libs.items():
        got, again = launch(lib, entry), launch(lib, entry)
        rel = [relative_to_max(x, y) for x, y in zip(got, want)]
        bitwise = [torch.equal(x, y) for x, y in zip(got, again)]
        log(f"FFS64 '{name}': O, l, m max |copy - plain| / max |plain| "
            f"{[f'{e:.3g}' for e in rel]} (limit {FLASH_FP32_TOL:g}); two calls bitwise equal "
            f"{bitwise}")
        if not (max(rel) <= FLASH_FP32_TOL and all(bitwise)):
            raise RuntimeError(f"the FFS64 copy '{name}' is off its plain version: {rel}, {bitwise}")
    del want
    fns = {f"FFS64 {name}": (lambda lib=lib, entry=entry: launch(lib, entry), profiled)
           for name, (lib, _, entry, _, _, profiled) in libs.items()}
    fns["F1"] = (lambda: flash_forward(q, k, v, seg, scale), ("flash_fwd_kernel",))
    times = turns_ms(fns)
    log(f"FFS64 at B {b} H {h} T {t} D {d} fp32 padded, in turns (there and back); ms per call: "
        f"one call between CUDA events (median), and the device time of the kernels named "
        f"(torch.profiler): " + "; ".join(
            f"{name} " + " / ".join(f"({a:.4f}, {c:.4f})" for a, c in ts)
            for name, ts in times.items()) + f" [{card}]")


def profile_f32_d256(card: str) -> None:
    """F2SW and F3SW as built against F32_D256_VARIANTS at the fp32 D 256
    case, with each kernel's SASS counts, registers, spills and CTAs an SM.
    Each build's F3SW is held to the plain version within 1e-5 of max and to
    its own bits on a second call; a copy that sums S and dP in another order
    has other bits than the built kernel's, and their largest difference is
    logged. Then the builds' F3SW, the built F2SW and F3 in turns."""
    from kronfluence_tpu_torch.ops.attention import output_dot
    from kronfluence_tpu_torch.ops.kernels.build import check_launch, library_path, load_library
    from kronfluence_tpu_torch.ops.kernels.flash import (
        flash_backward_dkv_f32_d256,
        flash_backward_dq,
        flash_backward_dq_f32_d256,
        flash_backward_dq_reference,
        flash_forward_f32,
    )

    p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    argtypes = {"kf_flash_bwd_dkv_f32_d256": [*[p] * 10, i32, i32, i32, i32, f32, p],
                "kf_flash_bwd_dq_f32_d256": [*[p] * 9, i32, i32, i32, i32, f32, p],
                "kf_flash_bwd_f32_d256_occupancy": [i32, p, p, p]}
    libs = {"as built": (load_library(), library_path())}
    for i, (name, repl) in enumerate(F32_D256_VARIANTS.items()):
        lib = build_variant("flash_backward_f32_d256.cu", i, repl, argtypes)
        libs[name] = (lib, Path(lib._name))
    for name, (lib, path) in libs.items():
        for which, kernel in enumerate(F32_D256_KERNELS):
            log(f"F2SW/F3SW '{name}', {kernel}: SASS {sass_counts(path, kernel, F32_OPCODES)}; "
                f"{occupancy(lib, F32_D256_OCCUPANCY, which)}")
    b, h, t, d, dtype, padded = GENERIC_ROUTE_CASES["fp32 D 256"]
    gen = torch.Generator("cuda").manual_seed(b * t + d)
    q, k, v, do = (torch.randn(b, h, t, d, generator=gen, device="cuda").to(dtype)
                   for _ in range(4))
    seg = padded_segments(b, t, padded, "cuda")
    scale = d ** -0.5
    o, l, m = flash_forward_f32(q, k, v, seg, scale)
    di = output_dot(o, do)
    args = (q, k, v, seg, l, m, do, di, scale)
    stream = torch.cuda.current_stream().cuda_stream

    def dq(lib):
        out = torch.empty_like(q)
        check_launch(lib.kf_flash_bwd_dq_f32_d256(*(x.data_ptr() for x in args[:8]),
                                                  out.data_ptr(), b, h, t, d, float(scale),
                                                  stream), "F3SW copy")
        return out

    want = flash_backward_dq_reference(*args)
    built = flash_backward_dq_f32_d256(*args)
    for name, (lib, _) in libs.items():
        got, again = dq(lib), dq(lib)
        rel = relative_to_max(got, want)
        log(f"F3SW '{name}': dQ max |copy - plain| / max |plain| {rel:.3g} (limit "
            f"{FLASH_FP32_TOL:g}); two calls bitwise equal {torch.equal(got, again)}; bitwise the "
            f"built kernel's {torch.equal(got, built)}, off it by at most "
            f"{float((got - built).abs().max()):.3g}")
        if not (rel <= FLASH_FP32_TOL and torch.equal(got, again)):
            raise RuntimeError(f"the F3SW copy '{name}' is off its plain version: {rel}")
    del built, want
    dq_k = (F32_D256_KERNELS[1],)
    fns = {f"F3SW {name}": (lambda lib=lib: dq(lib), dq_k) for name, (lib, _) in libs.items()}
    fns["F2SW as built"] = (lambda: flash_backward_dkv_f32_d256(*args), (F32_D256_KERNELS[0],))
    fns["F3"] = (lambda: flash_backward_dq(*args), ("flash_bwd_dq_kernel",))
    times = turns_ms(fns)
    log(f"F2SW and F3SW at B {b} H {h} T {t} D {d} fp32 padded, in turns (there and back); ms "
        f"per call: one call between CUDA events (median), and the device time of the kernels "
        f"named (torch.profiler): " + "; ".join(
            f"{name} " + " / ".join(f"({a:.4f}, {c:.4f})" for a, c in ts)
            for name, ts in times.items()) + f" [{card}]")


def _max_rel(got: dict, want: dict) -> float:
    """max over modules of max|got - want| / max|want| (per-module scale)."""
    worst = 0.0
    for name, w in want.items():
        w = w.double().cpu()
        g = got[name].double().cpu()
        worst = max(worst, float((g - w).abs().max() / w.abs().max().clamp_min(1e-300)))
    return worst


def phase_reference(attention: str = "naive", seq: int = 64, padded: bool = False,
                    num_heads: int = 8) -> dict:
    """A small fp32 GPT-2 (d_model 512) through the four stages on the card
    and on the CPU; returns the card side's flash launches (every count
    zeroed just before the card side runs). fp32 takes at head_dim 64 (8
    heads) the tiled_f32_64 forward, FFS64, and the split_f32 backward, F2S +
    F3S; at
    head_dim 128 (4 heads) the tiled_f32 forward, FFS, and the split_f32_h
    backward, F2SH + F3SH; at head_dim 256 (2 heads) FFS and the split_f32_w
    backward, F2SW + F3SW."""
    from kronfluence_tpu_torch.arguments import FactorArguments, ScoreArguments
    from kronfluence_tpu_torch.factor.covariance import fit_covariance_matrices_with_loader
    from kronfluence_tpu_torch.factor.eigen import (
        fit_lambda_matrices_with_loader,
        perform_eigendecomposition,
    )
    from kronfluence_tpu_torch.models.transformer import init_transformer, tiny_config
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk
    from kronfluence_tpu_torch.prepare import prepare_model
    from kronfluence_tpu_torch.score.pairwise import compute_pairwise_scores_with_loaders
    from kronfluence_tpu_torch.utils.constants import (
        ACTIVATION_COVARIANCE_MATRIX_NAME,
        ACTIVATION_EIGENVALUES_NAME,
        ALL_MODULE_NAME,
        GRADIENT_COVARIANCE_MATRIX_NAME,
        GRADIENT_EIGENVALUES_NAME,
        LAMBDA_MATRIX_NAME,
    )
    from kronfluence_tpu_torch.utils.dataset import BatchLoader

    # d_model 512: the c_fc gradient (2048) and mlp/c_proj activation (2048)
    # grams pass the K1 shape rule, so the card runs the fp32 kernel. 8 heads
    # of 64, 4 of 128 or 2 of 256: head dims the flash kernels take.
    head_dim = 512 // num_heads
    config = tiny_config(
        vocab_size=512, max_seq_len=seq, num_layers=2, num_heads=num_heads, d_model=512,
        dtype=torch.float32, attention=attention,
    )
    task = wikitext_style_task(config.num_layers)
    factor_args = FactorArguments(
        strategy="ekfac", use_empirical_fisher=True, eigendecomposition_dtype="float32"
    )
    score_args = ScoreArguments(damping_factor=None, query_gradient_accumulation_steps=2)
    module = init_transformer(config, seed=0, device="cpu")
    host = {
        k: make_tokens(n, config.max_seq_len, config.vocab_size, seed, "cpu", padded)
        for k, n, seed in (("cov", 32, 11), ("lambda", 32, 13), ("query", 8, 15), ("train", 24, 16))
    }
    flash = flash_kernels()
    out = {}
    eig_cpu = None
    for device in (torch.device("cpu"), torch.device("cuda", 0)):
        model = prepare_model(module.to(device), task)
        data = {k: {c: v.to(device) for c, v in cols.items()} for k, cols in host.items()}
        before = syrk.launches
        for fn in flash.values():
            fn.launches = 0
        cov = fit_covariance_matrices_with_loader(
            model, task, BatchLoader(data["cov"], 8, device=device), factor_args
        )
        eig = perform_eigendecomposition(cov, factor_args)
        if eig_cpu is None:
            eig_cpu = eig
        # EK-FAC fits lambda in the eigenbasis, and the two solvers may pick
        # different bases for close eigenvalues: both sides take the CPU's
        # eigenvectors from here on, and the card's own are held by eigenvalue.
        shared = {k: {n: t.to(device) for n, t in v.items()} for k, v in eig_cpu.items()}
        lam = fit_lambda_matrices_with_loader(
            model, task, BatchLoader(data["lambda"], 8, device=device), factor_args,
            eigen_factors=shared,
        )
        scores = compute_pairwise_scores_with_loaders(
            model, task, BatchLoader(data["query"], 4, device=device),
            BatchLoader(data["train"], 8, device=device), {**cov, **shared, **lam},
            factor_args, score_args,
        )
        flash_launches = {name: fn.launches for name, fn in flash.items()}
        out[device.type] = (cov, eig, lam, scores, syrk.launches - before, flash_launches)
    cov_c, eig_c, lam_c, sc_c, _, cpu_flash = out["cpu"]
    cov_g, eig_g, lam_g, sc_g, k1_launches, card_flash = out["cuda"]
    diffs = {
        "covariance": max(
            _max_rel(cov_g[k], cov_c[k])
            for k in (ACTIVATION_COVARIANCE_MATRIX_NAME, GRADIENT_COVARIANCE_MATRIX_NAME)
        ),
        "eigenvalues": max(
            _max_rel(eig_g[k], eig_c[k])
            for k in (ACTIVATION_EIGENVALUES_NAME, GRADIENT_EIGENVALUES_NAME)
        ),
        "lambda": _max_rel(lam_g[LAMBDA_MATRIX_NAME], lam_c[LAMBDA_MATRIX_NAME]),
        "scores": _max_rel(sc_g, sc_c),
    }
    log(
        f"reference ({attention} attention, T {seq}, head_dim {head_dim}"
        f"{', padded' if padded else ''}): small fp32 "
        "GPT-2, card vs CPU, max |diff| / max |ref|: "
        + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items())
        + f" (limit {REFERENCE_RTOL:g}); K1 launches on the card side {k1_launches}; "
        f"flash launches on the card side {card_flash}, on the CPU side {cpu_flash}; "
        f"scores {tuple(sc_g[ALL_MODULE_NAME].shape)}"
    )
    if k1_launches == 0:
        raise RuntimeError("the reference run did not reach K1 on the card")
    # fp32 takes, by head_dim, FFS64 and the split_f32 route, FFS and the
    # split_f32_h route, or FFS and the split_f32_w route.
    kernels = {64: {"FFS64", "F2S", "F3S"}, 128: {"FFS", "F2SH", "F3SH"},
               256: {"FFS", "F2SW", "F3SW"}}[head_dim]
    split = kernels if attention == "flash" else set()
    if any(cpu_flash.values()) or {name for name, n in card_flash.items() if n} != split:
        raise RuntimeError(f"flash launches off: card {card_flash} (want exactly "
                           f"{sorted(split)} launched), CPU {cpu_flash}")
    bad = {k: v for k, v in diffs.items() if not v <= REFERENCE_RTOL}
    if bad:
        raise RuntimeError(f"card disagrees with the CPU reference: {bad}")
    return card_flash


def main() -> None:
    start = time.perf_counter()
    if not (REPO / "kronfluence_tpu_torch" / "__init__.py").exists():
        raise SystemExit("chip_smoke.py runs from a checkout: kronfluence_tpu_torch/ is missing.")
    sys.path.insert(0, str(REPO))
    if sys.argv[1:2] == ["--distributed-rank"]:
        distributed_rank(sys.argv[2:])
        return
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk

    seconds, reductions = {}, {}

    def phase(name, fn, *args, **kwargs):
        t, before = time.perf_counter(), syrk.f32_reduce_launches
        result = fn(*args, **kwargs)
        seconds[name] = time.perf_counter() - t
        reductions[name] = syrk.f32_reduce_launches - before
        return result

    card = phase("1 device", phase_device)
    phase("2 build", phase_build)
    if sys.argv[1:] == ["--profile-eigh"]:
        profile_eigh(card)
        return
    if sys.argv[1:] == ["--profile-k1"]:
        profile_k1(card)
        return
    if sys.argv[1:] == ["--profile-flash"]:
        profile_flash(card)
        return
    if sys.argv[1:]:
        raise SystemExit(f"usage: python3 chip_smoke.py [--profile-eigh | --profile-k1 | "
                         f"--profile-flash]; got {sys.argv[1:]}")
    probe_result = phase("3 probe", phase_probe)
    syrk_result = phase("4 syrk", phase_syrk, card)
    jacobi_result, jacobi_generic_result = phase("7 jacobi kernels", phase_jacobi_kernel, card)
    flash_result = phase("9 flash kernels", phase_flash_kernels, card)
    ctx = phase("5 main path", phase_main_path, card)
    jacobi_by_route, jacobi_generic_launches, jacobi_generic_m32 = phase(
        "8 jacobi path", phase_jacobi_path, card, ctx)
    mesh_launches = phase("20 data mesh", phase_distributed, card, ctx)
    launches = dict(ctx["launches"], jacobi=sum(jacobi_by_route.values()))
    # Each flash kernel's launches are those of its own path: FF and FB from
    # phase 10 (bf16, head_dim 64); FFS64, F2S, F3S, F2SH, F3SH, FFS, F2SW
    # and F3SW from phase 11 (fp32), below.
    flash_path = phase("10 flash path", phase_flash_path, card, ctx)
    launches.update(FF=flash_path["FF"], FB=flash_path["FB"])
    scanned = phase("19 scanned GPT-2", phase_scanned, card, ctx)
    # Phase 12's artifacts stay on disk for phase 14, which reads them through
    # an Analyzer of its own: phase 13 starts with nothing of phase 12's on the card.
    root = Path(tempfile.mkdtemp(prefix="kf_chip_smoke_"))
    try:
        analyzer_launches, analyzer_wgmma = phase("12 analyzer", phase_analyzer, card, ctx, root)
        options_launches = phase("13 stage options", phase_stage_options, card, ctx)
        features_launches = phase("14 score features", phase_score_features, card, ctx, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del ctx
    phase("6 reference", phase_reference)
    split_path = phase("11 reference flash, head_dim 64", phase_reference,
                       attention="flash", seq=128, padded=True)
    split_path_d128 = phase("11 reference flash, head_dim 128", phase_reference,
                            attention="flash", seq=128, padded=True, num_heads=4)
    split_path_d256 = phase("11 reference flash, head_dim 256", phase_reference,
                            attention="flash", seq=128, padded=True, num_heads=2)
    llama = phase("15 llama", phase_llama, card)
    llama_launches = {key: sum(c[key] for c in llama["launches"].values())
                      for key in ("FFH", "F2H", "F3H", "syrk", "probe")}
    gemma = phase("16 gemma", phase_gemma, card)
    cifar = phase("17 cifar", phase_cifar, card)
    imagenet = phase("18 imagenet", phase_imagenet, card)
    phase("19 MLP and encoder-decoder", phase_small_models, card)
    examples = phase("21 examples", phase_examples, card, llama.pop("hostloop_matrix"))
    examples_launches = {
        key: {stage: counts[key] for part in ("openwebtext", "wikitext")
              for stage, counts in examples[part]["launches"].items()}
        for key in ("syrk", "probe", "jacobi", "FFH")}
    pipelines = phase("22 example pipelines", phase_example_pipelines, card)
    pipeline_launches = {
        key: {label: counts[key] for part in pipelines.values()
              for label, counts in part["launches"].items()}
        for key in ("K1", "wgmma", "K3")}
    text = phase("23 text example pipelines", phase_text_pipelines, card)
    text_launches = {
        key: {label: counts[key] for part in text.values()
              for label, counts in part["launches"].items()}
        for key in ("K1", "wgmma", "K3")}
    # FFH, F2H and F3H from phase 15 (Llama, bf16 D 128); FFW, F2W and F3W
    # from phase 16 (Gemma-2B's widths, bf16 D 256); FFS64, F2S and F3S from
    # phase 11's first run (fp32 D 64: the tiled_f32_64 forward and the
    # split_f32 route), F2SH and F3SH from its second (fp32 D 128: the
    # split_f32_h route), F2SW and F3SW from its third (fp32 D 256: the
    # split_f32_w route), FFS from its second and third (the tiled_f32
    # forward). F1, F2 and F3 serve no route: phase 11's first run and phase
    # 16, where F1 ran until FFS64 and FFW took its forwards, must leave F1 at
    # 0, phase 11's third run and phase 16 F2 and F3, and phase 9 alone holds
    # them.
    launches.update(FFH=llama_launches["FFH"], F2H=llama_launches["F2H"],
                    F3H=llama_launches["F3H"], FFW=gemma["total"]["FFW"],
                    F2W=gemma["total"]["F2W"],
                    F3W=gemma["total"]["F3W"], F1=split_path["F1"] + gemma["total"]["F1"],
                    FFS64=split_path["FFS64"],
                    F2=split_path_d256["F2"] + gemma["total"]["F2"],
                    F3=split_path_d256["F3"] + gemma["total"]["F3"],
                    F2S=split_path["F2S"], F3S=split_path["F3S"],
                    F2SH=split_path_d128["F2SH"], F3SH=split_path_d128["F3SH"],
                    F2SW=split_path_d256["F2SW"], F3SW=split_path_d256["F3SW"],
                    FFS=split_path_d128["FFS"] + split_path_d256["FFS"])
    flash_result["FF"]["timings_ms"] = flash_result.pop("extra")
    # The repo's function that reaches the TPU kernels, each Pallas kernel in
    # JAX's own package (jax/experimental/pallas/ops/tpu/flash_attention.py),
    # the CUDA source, and the phase whose run the launches are read from.
    replaced = {
        "F1": ("flash_forward", ["flash_attention.py:589"], "flash_attention.cu",
               "no route: phase 11's first run (fp32 D 64) and phase 16 (bf16 D 256) take FFS64 "
               "and FFW and must leave F1 at 0 (fp32_reference_launches, "
               "gemma_launches_by_stage); phase 9 holds F1 against its plain version and times "
               "it as their yardstick"),
        "F2": ("flash_backward_dkv", ["flash_attention.py:941"], "flash_attention.cu",
               "no route: phase 11's third run (fp32 D 256) and phase 16 (bf16 D 256) take "
               "F2SW and F2W and must leave F2 at 0; phase 9 alone holds F2 against its plain "
               "version and times it as the yardstick"),
        "F3": ("flash_backward_dq", ["flash_attention.py:1287"], "flash_attention.cu",
               "no route: phase 11's third run (fp32 D 256) and phase 16 (bf16 D 256) take "
               "F3SW and F3W and must leave F3 at 0; phase 9 alone holds F3 against its plain "
               "version and times it as the yardstick"),
        "FF": ("flash_forward_pipelined", ["flash_attention.py:589"], "flash_forward.cu",
               "phase 10 (flash path, bf16: pipelined forward)"),
        "FB": ("flash_backward", ["flash_attention.py:941", "flash_attention.py:1287"],
               "flash_backward.cu", "phase 10 (flash path, bf16: fused route)"),
        "FFH": ("flash_forward_d128", ["flash_attention.py:589"], "flash_forward.cu",
                "phase 15 (Llama, bf16 D 128: pipelined_h forward), all stages"),
        "FFW": ("flash_forward_d256", ["flash_attention.py:589"], "flash_forward_d256.cu",
                "phase 16 (Llama at Gemma-2B's widths, bf16 D 256: wgmma_w forward), all "
                "stages"),
        "FFS": ("flash_forward_f32", ["flash_attention.py:589"], "flash_forward_f32.cu",
                "phase 11's second and third runs (reference, fp32 D 128 and D 256: tiled_f32 "
                "forward)"),
        "FFS64": ("flash_forward_f32_d64", ["flash_attention.py:589"], "flash_forward_f32_d64.cu",
                  "phase 11's first run (reference, fp32 D 64: tiled_f32_64 forward)"),
        "F2H": ("flash_backward_dkv_d128", ["flash_attention.py:941"], "flash_backward_d128.cu",
                "phase 15 (Llama, bf16 D 128: split_h route), all stages"),
        "F3H": ("flash_backward_dq_d128", ["flash_attention.py:1287"], "flash_backward_d128.cu",
                "phase 15 (Llama, bf16 D 128: split_h route), all stages"),
        "F2W": ("flash_backward_dkv_d256", ["flash_attention.py:941"], "flash_backward_d256.cu",
                "phase 16 (Llama at Gemma-2B's widths, bf16 D 256: split_w route), all stages"),
        "F3W": ("flash_backward_dq_d256", ["flash_attention.py:1287"], "flash_backward_d256.cu",
                "phase 16 (Llama at Gemma-2B's widths, bf16 D 256: split_w route), all stages"),
        "F2S": ("flash_backward_dkv_f32", ["flash_attention.py:941"], "flash_backward_f32.cu",
                "phase 11's first run (reference, fp32 D 64: split_f32 route)"),
        "F3S": ("flash_backward_dq_f32", ["flash_attention.py:1287"], "flash_backward_f32.cu",
                "phase 11's first run (reference, fp32 D 64: split_f32 route)"),
        "F2SH": ("flash_backward_dkv_f32_d128", ["flash_attention.py:941"],
                 "flash_backward_f32_d128.cu",
                 "phase 11's second run (reference, fp32 D 128: split_f32_h route)"),
        "F3SH": ("flash_backward_dq_f32_d128", ["flash_attention.py:1287"],
                 "flash_backward_f32_d128.cu",
                 "phase 11's second run (reference, fp32 D 128: split_f32_h route)"),
        "F2SW": ("flash_backward_dkv_f32_d256", ["flash_attention.py:941"],
                 "flash_backward_f32_d256.cu",
                 "phase 11's third run (reference, fp32 D 256: split_f32_w route)"),
        "F3SW": ("flash_backward_dq_f32_d256", ["flash_attention.py:1287"],
                 "flash_backward_f32_d256.cu",
                 "phase 11's third run (reference, fp32 D 256: split_f32_w route)"),
    }
    kernels = [
        {
            "name": "syrk",
            "route": "cuda",
            "source": "kronfluence_tpu_torch/csrc/syrk.cu",
            "replaces": "kronfluence_tpu/ops/pallas/syrk.py:44",
            "launches": launches["syrk"],
            "analyzer_launches": analyzer_launches["syrk"],
            "analyzer_wgmma_launches": analyzer_wgmma,
            "stage_options_launches": options_launches["syrk"],
            "score_features_launches": features_launches["syrk"],
            "llama_launches": llama_launches["syrk"],
            "examples_launches": examples_launches["syrk"],
            "example_pipelines_launches": pipeline_launches["K1"],
            "example_pipelines_wgmma_launches": pipeline_launches["wgmma"],
            "text_pipelines_launches": text_launches["K1"],
            "text_pipelines_wgmma_launches": text_launches["wgmma"],
            "scanned_gpt2_launches": scanned["launches"]["syrk"],
            "data_mesh_launches": {k: v["K1"] for k, v in mesh_launches.items()},
            "cifar_launches": cifar["total"]["syrk"],
            "cifar_launches_per_covariance_batch": cifar["k1_per_covariance_batch"],
            "imagenet_launches": imagenet["total"]["syrk"],
            "imagenet_launches_per_covariance_batch": imagenet["k1_per_covariance_batch"],
            "imagenet_fp32": imagenet["k1_fp32"],
            "imagenet_f32_reduce_launches_by_stage": imagenet["f32_reduce_launches"],
            # K1's fp32 reductions in each phase that ran any; phases 4 and
            # 18 count their checks' and timings' calls too.
            "f32_reduce_launches_by_phase": {name: count for name, count in reductions.items()
                                             if count},
            **syrk_result,
        },
        {
            "name": "probe",
            "route": "cuda",
            "source": "kronfluence_tpu_torch/csrc/probe.cu",
            "replaces": "kronfluence_tpu/utils/platform.py:55",
            "launches": launches["probe"],
            "analyzer_launches": analyzer_launches["probe"],
            "stage_options_launches": options_launches["probe"],
            "score_features_launches": features_launches["probe"],
            "llama_launches": llama_launches["probe"],
            "examples_launches": examples_launches["probe"],
            "example_pipelines_launches": pipeline_launches["K3"],
            "text_pipelines_launches": text_launches["K3"],
            "scanned_gpt2_launches": scanned["launches"]["probe"],
            "data_mesh_launches": {k: v["K3"] for k, v in mesh_launches.items()},
            "cifar_launches": cifar["total"]["probe"],
            "imagenet_launches": imagenet["total"]["probe"],
            **probe_result,
        },
        {
            "name": "jacobi",
            "route": "cuda",
            "source": "kronfluence_tpu_torch/csrc/jacobi_m64.cu",
            "replaces": "kronfluence_tpu/ops/pallas/jacobi.py:66",
            "launches": launches["jacobi"],
            "launches_by_route": jacobi_by_route,
            "launches_from": "phase 8 (Jacobi path, m 64: register route)",
            "score_features_launches": features_launches["jacobi"],
            "examples_launches": examples_launches["jacobi"],
            **jacobi_result,
        },
        {
            "name": "jacobi_generic",
            "route": "cuda",
            "source": "kronfluence_tpu_torch/csrc/jacobi.cu",
            "replaces": "kronfluence_tpu/ops/pallas/jacobi.py:66",
            "launches": jacobi_generic_launches,
            "launches_from": "phase 8 (eigh_batched block_size 16 on the Wishart matrices, m 32: "
                             "generic route)",
            **jacobi_generic_result,
            "at_phase8_launch_shape": jacobi_generic_m32,
        },
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": f"kronfluence_tpu_torch/csrc/{source}",
            "replaces": "kronfluence_tpu/ops/attention.py:227",
            "pallas_kernel": [f"jax/experimental/pallas/ops/tpu/{w}" for w in where],
            "launches": launches[fid],
            "launches_from": path,
            **({"stage_options_launches": options_launches[fid]} if fid in options_launches else {}),
            **({"score_features_launches": features_launches[fid]}
               if fid in features_launches else {}),
            **({"fp32_reference_launches": {"head_dim 64": split_path[fid],
                                            "head_dim 128": split_path_d128[fid],
                                            "head_dim 256": split_path_d256[fid]}}
               if fid in ("F1", "F2", "F3", "FFS", "FFS64", "F2S", "F3S", "F2SH", "F3SH", "F2SW",
                          "F3SW")
               else {}),
            **({"llama_launches_by_stage": {stage: c[fid] for stage, c in llama["launches"].items()}}
               if fid in ("FFH", "F2H", "F3H") else {}),
            **({"examples_launches": examples_launches[fid]} if fid == "FFH" else {}),
            **({"gemma_launches_by_stage": {stage: c[fid] for stage, c in gemma["launches"].items()}}
               if fid in ("F1", "F2", "F3", "FFW", "F2W", "F3W") else {}),
            **({"scanned_gpt2_launches": scanned["launches"][fid]} if fid in ("FF", "FB") else {}),
            **flash_result[fid],
        }
        for fid, (name, where, source, path) in replaced.items()
    ]
    log("chip_smoke.py: phase seconds, in the order they ran: " + ", ".join(
        f"{name} {sec:.1f}" for name, sec in seconds.items()))
    log(f"chip_smoke.py: all phases passed in {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()

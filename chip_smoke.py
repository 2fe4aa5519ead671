#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`renderih_tpu_torch/`) on one NVIDIA H100.

    python3 chip_smoke.py [--json PATH] [--profile]
    python3 chip_smoke.py --bf16_ab 600

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit (`nvcc`). Phases; any failure exits non-zero and prints no result
line:

1. Build: compiles the port's CUDA kernels from `renderih_tpu_torch/csrc/`
   with nvcc for sm_90a (one nvcc per source, in parallel) and prints
   `-Xptxas -v` (registers, shared memory, spills); B2's `conv3x3_wgmma`
   and `conv3x3_tf32x3`, B1's `mha_mma_kernel` and B3's `sdf_kernel` must
   spill nothing; each
   B1 instance's registers and dynamic shared memory. Then the card's
   name and power limit.
2. Kernels against their plain versions on the card, at every shape the
   flagship path gives them at batch 256: B2 (3x3 conv) in bf16 and f32,
   B1 (fused attention) in f32 and bf16. B2 must take its `wgmma` route in
   bf16 and its `tf32x3` route in f32. Each line has max|Δ| and its
   tolerance (and its worst element's share of it), the kernel's time (CUDA events after warm-up; for B1 and
   SDPA beside it the device time of 20 calls replayed from a CUDA graph,
   since B1's wrapper costs the host more than its kernel costs the card
   at the short shapes, and also B1's eager time, host included), the
   plain version's, one library call's (cuDNN `F.conv2d`,
   `F.scaled_dot_product_attention`; a yardstick the port never calls) and
   the bound: the largest of the bytes moved (inputs read once, output
   written once) over 3.35 TB/s, the FLOPs over the peak of the unit that
   does them (H100 SXM data sheet: 989 TFLOP/s bf16 and 495 TF32 on tensor
   cores, 67 f32 on CUDA cores; B1 and B2 are held to the tensor cores'
   peak for their dtype, f32 to one TF32 pass on every route, though
   3xTF32 runs three and `simt` runs on CUDA cores; B3 to the CUDA
   cores') and, for B1, the exponentials over the MUFU rate (16 a
   clock per SM at 1.98 GHz). B1's and B2's f32 lines also print the
   CUDA-core yardstick, the FLOPs over the CUDA-core f32 peak;
   B2's f32 lines cuDNN with TF32 on (PyTorch's default: a less accurate
   function, not the yardstick) and `conv3x3_simt`'s time on the same
   input one float off 16-byte alignment (which the launcher sends to the
   CUDA-core kernel), held too.
3. The flagship path: `Config()` (ResNet-50, bf16 encoder, f32 decoder)
   on synthetic assets with seeded random weights. First B2 in bf16 (on
   `wgmma`) and B1 in f32 at every shape of a forward at each of the
   engine's buckets (1, 8, 32, 128) against their plain versions on
   random inputs, at phase 2's tolerances (below 4 images an 8² map fills
   part of B2's 4-image tile); `serve_phase`, which every served path
   runs. Then served through `InferenceEngine` + `BatchingServer` (64
   single-image requests), one `predict` at each smaller bucket and three
   of 256 images. The launch counters must rise by exactly 13
   (B2) and 24 (B1) per forward, and every B2 launch must take the
   `wgmma` route. Then, in f32 with TF32 off, the card's
   outputs are held against the same engine run on the CPU (the plain
   versions) on the same weights and images.
4. B3 (SDF voxeliser) against its plain version on the card, on the
   synthetic left hand posed at a seeded pose and on the unit cube, at
   G = 16, 24, 32: phi equal bit for bit (`torch.equal`; the kernel's
   lane reductions are exact), bbox and scale equal, kernel and plain
   times (the kernel's launch alone, and with the wrapper's torch bbox
   setup) and the bound (80 FLOP per (voxel, face) at 67 TFLOP/s, bytes
   4·(3G³ + 9F + G³) at 3.35 TB/s: the Pallas kernel's cost estimate). No
   single PyTorch call computes this field: library "none".
5. The synthetic-data path: `synth_gen.main` on the card, 32 samples in
   one batch of 32, each refined with 60 Adam iterations (4 attempts of
   15, SDF grid 16). B3 must launch exactly 128 times per refined sample;
   the dataset files must hold every label at its shape, finite; and the
   mean SDF penetration of the samples that started interpenetrating (the
   same seed generated without refinement) must fall. Prints refined
   samples/s and generated images/s.
6. Card against CPU on that path: one anchor-mode `optimize_two_hands`
   (4 attempts of 3 iterations, G=16, f32, TF32 off) from one numpy-made
   start on both: the objective and its gradient at the start tightly,
   the final parameters, objective and weighted terms loosely (the
   objective is piecewise smooth; `refine_parity_phase` states why).
7. B2's backward at every training shape (batch 64, bf16 and f32): dx
   through B2 (`wgmma` in bf16, `tf32x3` in f32) against the plain autograd
   and against cuDNN's `conv2d_input` (the library yardstick) within
   `CONV_TOL`, dw (cuDNN `conv2d_weight`) against the plain one; the
   forward, dx (with its weight flip), plain, cuDNN and dw device times
   (CUDA-graph replay, as B1's: at batch 64 a B2 call costs the host about
   what its kernel costs the card), the eager times and the bound as in
   phase 2, and their sums over a training step (13 forward + 13 dx).
8. The training path: `apps.train.main` on the card, flagship `Config()`
   at batch 64, `--synthetic --synth_n 256 --steps 21` (4 steps an epoch,
   a checkpoint at epoch 5, step 20, then the in-training eval of the
   64-sample held-out split, EMA off, with its overlays). Exactly 26 B2
   launches a training step, all on `wgmma`; no B1 in training; the eval's
   forwards (one a batch of the held-out split, one for the overlays) add
   13 B2 and 24 B1 each. Every loss term finite at every step; the eval
   summary finite; the checkpoint holds the steps taken (20). Then that
   checkpoint alone in a new directory and `--resume auto` to step 21:
   its terms against the uninterrupted step 21 (the same state, batch and
   random draws) within 1e-4, and its final checkpoint against the
   uninterrupted one: the parameters within `RESUME_TOL` of the step's
   own largest move, the Adam moments and the BatchNorm statistics within
   `RESUME_TOL` of each tensor's largest value, the same step counters
   (one step from one state parts only by the order in which cuDNN's dw
   and the index backward add). A planted fault shows that the check can
   fail: from the same checkpoint with its optimizer state dropped, the
   parameters and the moments must land outside those limits. 10 AdamW steps on one fixed batch lower the
   loss. Prints training images/s (the median of steps 4-21; each step
   ends at the NaN guard's host sync) and ms a step; with `--profile`, one
   step's device time by kernel.
9. Card against CPU on that path: one SGD step of `Config()` in f32 (TF32
   off, dropout 0, batch 4) from `init_model`'s weights with the
   encoder's BatchNorm biases raised by 3, at two (init, batch) seed pairs
   (`TRAIN_PARITY_SEEDS`), the CPU taking the card's branch at every ReLU
   and max-pool (`utils/branches.py`). The raised biases let nearly every
   ReLU after a BatchNorm pass, so that no channel of a batch-4 BatchNorm
   is nearly dead and amplifies rounding: from `init_model`'s own biases the
   loss terms part by up to 3.3e-4 on shared branches. Held: the loss terms
   within 1e-4 relative, the BatchNorm statistics within 1e-5, every
   parameter's gradient within 2e-2 of its tensor's scale and 95% of the
   tensors within 3e-3 (`GRAD_TOL`). Without shared branches a ReLU input
   or max-pool runner-up within rounding of its kink goes one way on the
   card and the other on the CPU at most draws, and the gradients can part
   by more than a planted fault does (printed, not held: the CPU's step on
   its own branches); with them only rounding is left, and the limits hold
   at every draw tried (tests/test_torch_branches.py,
   tests/test_torch_cuda.py). A planted fault, the 2-D term's weight 10%
   off on the same branches, must land outside them (it moves the worst
   tensor by ~0.10).
10. The eval path. First its kernels at the batches it runs them at, 512
   and the CLI's 64: B2 in bf16 (on `wgmma`) and B1 in f32, the flagship's
   dtypes, at every shape of a forward against their plain versions on
   random inputs, at phase 2's tolerances. Then `evaluate_packed` on the
   card, flagship `Config()` with seed-0 weights, on a synthetic split of
   `EVAL_N` (1024) images at batch `EVAL_BATCH` (512, the JAX CLI's
   `--bs`), the split cached on the device. Exactly 13 B2 (all `wgmma`) and 24 B1 launches a forward, two
   forwards. Prints images/s (the second batch: the first is untimed),
   the cache upload, and the metrics' share of a batch (forward and
   metrics timed apart with CUDA events). The metrics must be equal bit
   for bit with TF32 allowed in cuBLAS (they use no matmul: ground-truth
   vertices in the camera frame put TF32's rounding of −2ab above the
   3 mm contact threshold). Then, in f32 with TF32 off, card against CPU
   on 10 images at batch 4 (samples 0-4 with the right hand moved onto the
   left, so CDev has contact): every per-sample metric within
   1e-4·max|verts3d| (the CPU tests' bar against JAX) with the same NaN
   pattern. Then `apps.eval_interhand.main(["--synthetic", "--bs", "64",
   "--json"])` once (256 images, 4 forwards, their launches counted).
11. From-scratch recipe training: `apps.train --cfg configs/convergence_r5d.yaml
   --synthetic --synth_render --synth_n 256 --steps 20` on the card
   (`Config()`'s ResNet-50, bf16 encoder, f32 decoder, with the recipe's
   aux heads, zero-init heads, normal from epoch 16, camera 10, theta
   ±30, batch 128; 2 steps an epoch, so its in-training eval runs at steps
   8 and 16; checkpoints under build/). First B2 forward and dx in bf16
   at every shape of batch 128 as phase 7, and B2 and B1 as phase 10 at
   that batch. Held: exactly phase 8's 26 B2 launches a step, all on
   `wgmma` (the heads' convolutions are stock ones), plus 13 B2 and 24 B1
   for each eval forward; every loss term finite at every step, `aux_hms`
   > 0; the eval summaries finite; 10 AdamW steps on one fixed batch of
   128 lower the loss. Prints images/s, ms a step, and the aux heads'
   share of a step's device time: one profiled step on the fixed batch
   with the heads and one without (the same model and state, its heads
   not run), busy time under torch.profiler.
12. The `decoder="mano"` variant: `apps.train` on `Config()` with
   `decoder: mano` at batch 64, `--synthetic --steps 6` (the split carries
   MANO pose and shape labels). Held: 26 B2 launches a step, all on
   `wgmma`; `mano_pose` finite and > 0 and every term finite at every step.
13. Card against CPU on one f32 step of `Config()` with the aux heads and
   the MANO decoder, as phase 9 (one seed pair, batch 4, stored aux
   targets and MANO labels, the CPU on the card's ReLU, max-pool and
   hard-swish branches), with phase 9's limits over every parameter, the
   heads' included; a planted fault, the heatmap term's weight 10% off,
   must land outside them; the CPU on its own branches is printed.
14. The engine's buckets (1, 8, 32, 128), which phases 3, 14 and 15
   serve at (phase 3 holds the kernels at each). Every B2 and B1 call of
   one `Config()` forward
   (seed-0 weights) at batch 128, on its own activations: against its
   plain version at those tolerances, and on its first 1, 8 and 32
   images equal bit for bit to the whole batch's result (each kernel's
   result for an image does not depend on the batch). Then image 0
   served at bucket 1 and at 128 with a hook on every trunk module: the
   first module whose output parts must not be a B2 call (printed: which
   one, and the gap at each stage and output); with every stock
   convolution run one image at a time, every trunk module's output
   must be equal bit for bit at both buckets. Printed, not held: the
   kernels' forward against the plain B2 and B1's at each bucket, and the
   f32 engine across buckets. Then serving a model trained with the aux
   heads: `InferenceEngine` on the recipe config with phase 11's final
   weights, one bucket of 32 images.
   Held: 13 B2 and 24 B1 launches a forward and no forward of either aux
   head (the serve forward never asks for them); the outputs equal, within
   1e-6 of each output's largest value, those of an engine built without
   the heads on the same trunk and decoder weights.
15. HTTP: `serve_http.HandPoseHTTPServer` on 127.0.0.1 at an ephemeral
   port over the flagship engine (seed-0 weights): `/healthz`; three
   waves of 64 concurrent single-image npy requests (through the batcher),
   one npy batch of 32 (straight to `predict`) and one JSON request. Held:
   13 B2 and 24 B1 launches a forward, every B2 on `wgmma`; each response
   equal, within phase 3's 1e-4 of each output's largest value, to
   `engine.predict` of the same images batched as the server batched them
   (the batcher's calls are recorded; printed beside it, unheld, each
   single response against one predict of all 64, which runs another
   bucket: phase 14 traces that gap to cuDNN). Prints requests/s and p50/p99 latency of the last wave, with
   the card's name and power limit.
16. The ViT path, `configs/vitpose_base.yaml` as it is (ViT-B/16, decoder
   mano, bf16 encoder, f32 decoder, batch 32). First B1 at its new shapes
   (the blocks' N = M = 256, 12 heads, D = 64; the pooled-KV block's
   N = 64, M = 256, 8 heads, D = 96; and `vit_large`'s 16-head D = 64 and
   D = 128) in f32 and bf16 at batch 256, held and timed as in phase 2.
   Every shape and launch count of a path comes from its model built
   (`kernel_shapes`: the model run on the meta device, its kernels' call
   sites recording). Then `InferenceEngine` on the config as phase 3
   (B1 held at every shape of a forward at each bucket, in the dtype the
   path gives it, then one predict at each bucket below 128 and three of
   256 images, two forwards of 128 each); exactly 37 B1 launches
   a forward (12 blocks, the pooled-KV block, 24 in the decoder) and no
   B2; images/s. Card vs CPU in f32 (TF32 off) within `PATH_RTOL`.
   `apps.train` on the config, `--synthetic --steps 10`: every term finite
   (the mano terms among them), no kernel launch (the ViT has no B2, and
   training keeps the plain attention); images/s. One card-vs-CPU f32 SGD
   step as phase 9 (one seed pair; the CPU on the card's ReLU and
   hard-swish branches; GELU has none). Then `vit_large` served at one
   bucket of 32 as phase 3 (B1 held at every shape of its forward at 32;
   49 B1 launches a forward).
17. The HRNet path, `Config()` with `encoder: hrnet_w32` (bf16 encoder,
   batch 64): B2 at its five shapes (64²x32, 32²x64, 16²x128, 8²x256 and
   64²x64; Cout = 32 takes `wgmma` with a 64-wide channel tile half
   filled) in bf16 and f32 at batch 256 as phase 2, and forward and dx in
   bf16 at batch 64 as phase 7; served as phase 3 (B2 in bf16 and B1 in
   f32 held at every shape of a forward at each bucket, 1 to 128), 256
   images: exactly 216 B2 launches a forward, all `wgmma`, and 24 B1;
   card vs CPU in f32;
   `apps.train --synthetic --steps 6` at batch 64: 432 B2 launches a step,
   all `wgmma`, no B1, every term finite; images/s of both.
18. The decoder variants on `Config()`'s ResNet-50 (bf16 encoder, f32
   decoder): `use_cheby` (Chebyshev blocks on each stage's Laplacians),
   then `use_cheby` with `paired_lr` (the port builds the same trunk under
   it: the same kernel calls, from `kernel_shapes`, and the same
   state_dict keys, both held). Each served as phase 3 (B2 and B1 held at
   every shape of a forward at each bucket; three predicts of 256; exact
   launch counts), card vs CPU in f32 within `PATH_RTOL`, and
   `apps.train --synthetic --steps 6` at batch 64 as phase 17 (26 B2 a
   step, all `wgmma`, no B1, every term finite). The paired model also
   against the unpaired one on the card, loaded from its state_dict (f32,
   `PATH_RTOL`). Each run's final checkpoint: every block's norm1, which
   no gradient reaches, moved by AdamW's weight decay alone (each weight
   prod(1 - lr_t·wd), each bias 0), as optax moves it.
19. The library modules outside `HandNet`. First B1 at `InterPoint`'s
   shapes (8 heads at the decoder's widths 256/128/64 on 61/122/244
   vertices: D = 32, 16 and the new 8) in f32 and bf16 at batch 256, held
   and timed as phase 2, and the three `InterPoint`s run once each on the
   card at batch 256 with the counts set to 0 just before: exactly 6 B1
   launches, at those shapes. Then on the card (f32, TF32 off) against the same
   module on the CPU, within `PATH_RTOL` of each output's largest value,
   batch `LIB_BATCH` (2 for the conv nets at a ResNet-50 pyramid's
   widths): `InterPoint` and `LinearCrossAttention` at each width (B1 at
   D = 32/16/8 and 64/32/16: exactly 12 launches), `KTDHead` on the
   2048-d feature and `ktd_mano_outputs`, `FPN`, `CBAM`, `HourglassHead`,
   `CrossHandInjection`, `PoseDiscriminator` (and its gradients),
   focal and dice losses with their gradients, `domain_adaptation_loss`
   with its gradients, and `gradient_reversal` (the features' gradient
   -lam times the plain loss's, within 1e-6).
20. The GAN pose prior: phase 5 with `--prior gan` (the port's copy of the
   trained discriminator): 128 B3 launches a refined sample, penetration
   falling. The prior's energy and gradient on 8 seeded poses, card vs
   CPU within 1e-5. Then `tools/train_pose_prior.py --steps 300` on the
   card: the LSGAN loss of the last 50 steps below half that of the first
   10, plausible poses scoring above randomized ones.
21. Data parallelism (`parallel/`). `torchrun --standalone
   --nproc_per_node 1 -m renderih_tpu_torch.apps.train --multihost
   --synthetic --steps 9` on `Config()` at batch 64: world 1 through the
   NCCL group, ZeRO-1 (`train.zero1`) and the BatchNorm's group dispatch,
   B2 forward and dx; this phase's training runs all take a new process's
   TF32 settings (cuDNN on, cuBLAS off), as the torchrun child does. The
   child process prints its launches over its steps: exactly 26
   B2 a step, all on `wgmma`, no B1. Its final checkpoint against the same
   run of the plain trainer (no `--multihost`): every tensor (model,
   optimizer, EMA) within 1e-5 of its largest value, the gap and the share
   of tensors equal bit for bit printed (with TF32 off in cuDNN two runs of
   the plain trainer part; with the defaults both are bit for bit), the
   step counters and optimizer group equal; step 1's terms of both
   printed. Its epoch_2 checkpoint (step 8) resumed by the plain trainer
   for step 9 against its own step 9 (terms within 1e-4, the state within
   `RESUME_TOL` as phase 8 holds a resume). Prints training images/s of
   both runs (medians of steps 4-9; steps 5 and 9 carry the epoch
   checkpoints' saves); with `--profile`, one step with no group and one
   in a one-rank group, in this process. Then B2
   and B1 held against their plain versions at batch 64, 32 and 128;
   `eval_interhand --synthetic --bs 64 --mesh_data 1` against no mesh and
   `InferenceEngine(mesh=make_mesh(1))` against `mesh=None` (160 images,
   buckets 128 and 32): equal bit for bit, launches 13 B2 and 24 B1 a
   forward. Then two ranks on the one card, both on `cuda:0` over gloo
   (which carries the port's all_reduce and broadcast on CUDA tensors):
   one SGD step of `Config()` in f32 (TF32 off, dropout 0, the encoder's
   BatchNorm biases +3, batch 4 a rank) against world 1 at batch 8, at
   the CPU tests' limits (tests/test_torch_parallel.py): the terms within
   1e-4, the BatchNorm statistics within 1e-5, every gradient within
   1.5e-3 of its tensor's scale and 80% within 1e-4; the two ranks equal.
22. The dataset tools (`tools/`, `data/image_io.py`, `data/native_reader.py`,
   `mano/ik.py`), on a machine without cv2: (a) `imread_rgb` on every
   committed JPEG of `tests/data/torch_codec/` equal bit for bit to the
   stored cv2 decode, and the decode rate (compressed MB/s, megapixels/s);
   (b) a fake official InterHand2.6M tree of `DATA_FRAMES` interacting
   frames at 480x640 (PNGs and npy written here, MANO npz from the
   synthetic MANO), packed by `tools.dataset_gen.interhand_gen` on the card
   and again with `--device cpu`: the images equal bit for bit, every
   label within 1e-5 of its largest magnitude (1e-4 for v2d/j2d), packed
   frames/s of each; (c) `handdict_gen --from_joints` on `DATA_IK_HANDS`
   joints-only right hands (layout B, 64x64 images resized to 256²) at the
   default 200 IK steps in one `--ik_batch 256` chunk on the card: the
   mean joint residual below the CPU tests' 1.5 mm, fitted hands/s;
   (d) `PackedInterHand.load(use_native=True)` on (b)'s split: its native
   gathers equal the memmap's; (e) `apps.train --data` (b)'s split, 3
   steps at batch 32 on `Config()`: exactly 26 B2 launches a step, all on
   `wgmma`, no B1, every term finite; (f) `apps.eval_interhand --data` the
   same split at `--bs 32`: 13 B2 (all `wgmma`) and 24 B1 launches a
   forward, the summary finite.
23. The background corpus and synthetic data (`data/image_io.py`,
   `render/backgrounds.py:BackgroundCorpus`): (a) `resize_area_u8` on the
   committed INTER_AREA fixtures of `tests/data/torch_codec/` (the integer
   factor, the area tables, upscaling) and `imread_rgb` on its BMPs (8-bit
   palette, 24-bit, 32-bit top-down), equal bit for bit to the stored cv2
   results; (b) `imwrite`'s JPEG of each stored source of `jpeg_encode.npz`
   decodes as cv2's stored file does, bit for bit (the files equal byte for
   byte are counted); (c) a corpus of `CORPUS_IMAGES` images (JPEG and PNG
   written here by `imwrite`, 120-720 px a side, and the BMP fixtures) plus
   one unreadable file, skipped: the stack on the card equal to the CPU's,
   a sample on the same draws equal, the load rate (images/s, MB/s of
   files) and the JPEG encode rate; (d) `synth_gen --backgrounds DIR --n 32
   --batch 32 --optimize`: exactly 128 B3 launches a refined sample, no B1
   or B2, the split finite; refined samples/s.
24. Perspective, densepose and mask IoU: `render_rgb_perspective` (with
   Blinn-Phong, AO and soft shadow), `render_mask_perspective` and
   `render_densepose` at batch `PERSP_BATCH`, 256², on the card, their
   first `PERSP_CPU` scenes against the CPU at
   `tests/test_torch_render.py:_compare_images`' bar (masks agree on
   >= 99.9% of pixels, within 1e-4 where they agree). Then `MASKIOU_N`
   handdicts with `camera` (JPEGs written by `imwrite`) packed by
   `tools.pack_data` (the split carries `camera_in`), `tools.compute_maskiou`
   on the card and the CPU (pinhole, 64²): each IoU within 2/64²; then
   `apps.eval_interhand --iou` on the card's vector at `--bs 32`: 13 B2
   (all `wgmma`) and 24 B1 launches a forward, the bucketed metrics finite.
25. The demo: `apps.demo` on `Config()` with seed-0 weights on
   `DEMO_IMAGES` non-square images (JPEG and PNG) with `--other_view 60`:
   every output decodes to 256², 13 B2 (all `wgmma`) and 24 B1 launches a
   forward, one forward an image; images/s (model, overlay, novel view,
   files). The same on `DEMO_CPU_IMAGES` of them (a JPEG and a PNG) with
   `--device cpu`: the card's outputs, decoded, within 1 grey level of the
   CPU's on >= 99% of their pixels (pooled; each output's share printed: a
   JPEG spreads a pixel that bf16 rounding moves over its 8x8 block).
26. The path tracer: `synth_gen --renderer pathtrace --spp 8 --bounces 2
   --n 8` at 256² on the card: images/s, the peak memory above what was
   allocated before, the hit mask against the rasteriser's on the same
   inputs on >= 99.9% of pixels, and one intersection pass of the batch's
   primary rays timed. Then card against CPU on the same draws
   (`PT_PARITY`: 2 scenes at 64², spp 2, 2 bounces) at the CPU test's bar:
   hit masks equal, RGB within 1e-4 on >= 99.5% of pixels.
27. The bf16 decoder: `InferenceEngine(decoder_bf16=True)` against an
   engine on `decoder_f32=False`, 32 images: equal bit for bit, the
   caller's config untouched, 13 B2 and 24 B1 launches a forward. Then
   `tools.validate_bf16_decoder` at `BF16_STEPS` steps, batch 64, on the
   card: exactly 26 B2 a training step (all `wgmma`, no B1) and 13 B2 and
   24 B1 in each of its 4 eval forwards; its JSON line.
28. The upstream recipe's precision at full width: B2's forward and dx in
   f32 at every training shape at batch 128, held and timed as phase 7.
   Then `apps.train --cfg configs/probe_f32.yaml --synthetic --synth_n 256
   --steps 12` (flagship `Config()`, the whole encoder in f32, batch 128;
   checkpoints under build/; stock convolutions in TF32 by PyTorch's
   default, B2 at float32 accuracy): exactly 26 B2 launches a step, all
   on `tf32x3`, no B1; every loss term finite; images/s (the median of
   steps 4-12), ms a step and B2's share of it (its CUDA-graph device time
   a step over the step's wall time); 10 AdamW steps on one fixed batch
   lower the loss (phase 8's check); with `--profile`, one step's device
   time by kernel. Then an f32 `InferenceEngine` (TF32 off) serving 256
   images as `serve_phase` does, 13 B2 a forward, all `tf32x3`. Then
   HRNet-W18 in f32, whose 18- and 36-channel branches no tensor-core
   route takes: its B2 at every shape of a forward at 256 (phase 2's
   f32 rows, `simt` where the launcher's rule says) and served, each B2
   launch on the route its shape's rule gives.
29. The result: a `{"kernels": [...]}` line (B1/B2 per flagship forward at
   batch 256 in the flagship's dtypes, B2 per training step at batch 64
   and per recipe training step at batch 128, B3 per refined sample; B1
   per ViT-B forward in its dtypes, B2 per HRNet-W32 forward and training
   step; B1 in f32 over one forward of each of `InterPoint`'s three
   widths at batch 256, two launches each; B2 per step of the torchrun
   world-1 run at batch 64: its launches are the child's count over its
   steps, which `apps.train` sets to 0 before the first, and its times
   are phase 7's bf16 rows, the same shapes at the same batch, as the
   `train` row's are; B3 per refined sample of phase 23's corpus run and
   B2 per training step of phase 27's, their times phase 4's and phase
   7's rows; B2 in f32: per training step of phase 28's run at batch 128
   and per forward of its engine at 256 on `tf32x3`, and per HRNet-W18
   forward on `simt`, its `simt` launches; each B2 entry names its CUDA
   kernel), and as the last line `{"ok": true, "device": {...}}`.

With `--bf16_ab STEPS` the script runs only the trained bf16-decoder A/B
(`validate_bf16_decoder` at STEPS steps, batch 64, 256 samples) and the
bucket gap on its trained weights against seed-0 weights (images 0-7
served at bucket 1 and inside a bucket of 128; each output's max|Δ| over
its largest value, and the vertices' in mm).

All f32 comparisons run with TF32 off in cuDNN and cuBLAS
(`torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32
= False`). Every f32 run of a ResNet or HRNet-W32 on the card (phases 3,
9, 10, 13, 16-18 and 21's card-against-CPU checks, 28) must have every B2
launch on `tf32x3`.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "tfloat32": 495e12, "float32": 67e12}
MUFU_EXP_PER_S = 132 * 16 * 1.98e9  # ex2: 16 a clock on each of 132 SMs at 1.98 GHz
BATCH = 256
N_REQUESTS = 64
CONV_TOL = {"bfloat16": (1e-2, 1.6e-2), "float32": (1e-4, 1e-4)}  # atol, rtol
MHA_TOL = (1e-4, 1e-4)
PATH_RTOL = 1e-4  # card vs CPU, relative to each output's max |value|
SDF_GRIDS = (16, 24, 32)
SDF_FLOP_PER_PAIR = 80  # the Pallas kernel's cost estimate (sdf_pallas.py:164)
SYNTH_N, SYNTH_ITERS, SYNTH_GRID = 32, 60, 16
REFINE_SCHEDULE = ((1.0, 1.0, 3), (0.1, 15.0, 3), (30.0, 0.1, 3), (1.0, 5.0, 3))
REFINE_LR = 1e-2
DEVICE = "cuda"  # the card; a CPU rehearsal of phases 2, 4-6, 8-10 and 16-17 may set "cpu"
TRAIN_BATCH = 64  # the flagship's batch a card
TRAIN_SYNTH_N = 256
TRAIN_STEPS = 21
RESUME_TOL = 1e-3  # resumed vs uninterrupted step (phase 8)
GRAD_TOL = (2e-2, 3e-3, 0.95)  # card vs CPU: every tensor, the tier, its share (phase 9)
FIXED_BATCH_STEPS = 10
PARITY_BATCH = 4
TRAIN_PARITY_SEEDS = ((0, 2), (7, 1))  # (init, batch) seeds of phase 9
BN_BIAS_SHIFT = 3.0  # phase 9: the encoder's BatchNorm biases, raised
EVAL_N, EVAL_BATCH = 1024, 512
EVAL_CLI_BATCH = 64  # phase 10's run of apps.eval_interhand
EVAL_PARITY_N, EVAL_PARITY_BATCH = 10, 4
EVAL_RTOL = 1e-4  # card vs CPU per-sample metrics, relative to max|verts3d|
RECIPE_YAML = "configs/convergence_r5d.yaml"  # phase 11's recipe (batch 128)
RECIPE_SYNTH_N, RECIPE_STEPS = 256, 20  # 2 steps an epoch: evals at steps 8 and 16
MANO_STEPS = 6
RECIPE_PARITY_SEEDS = ((0, 2),)  # (init, batch) seeds of phase 13
AUX_SERVE_N = 32  # one bucket
AUX_SERVE_RTOL = 1e-6  # engines with and without the aux heads: the same computation
HTTP_REQUESTS, HTTP_BATCH, HTTP_WAVES = 64, 32, 3
VIT_YAML = "configs/vitpose_base.yaml"  # phase 16: ViT-B/16, decoder mano, bf16, batch 32
VIT_TRAIN_STEPS = 10
VIT_LARGE_BUCKET = 32
HRNET_ENCODER = "hrnet_w32"  # phase 17, on Config()'s decoder, bf16, batch 64
HRNET_TRAIN_STEPS = 6
VARIANT_TRAIN_STEPS = 6  # phase 18: the variants' training at batch 64
LIB_BATCH = 8  # phase 19: PointAttn's (B, V, V, F) tensors are 3.9 GB at 256 and V = 244
PRIOR_STEPS = 300  # phase 20: train_pose_prior on the card
DDP_STEPS = 9  # phase 21: torchrun world 1 against the plain trainer, batch 64
DATA_FRAMES = 64  # phase 22: interacting frames of the fake official tree, 480x640
DATA_IK_HANDS = 256  # phase 22: joints-only hands fitted in one --ik_batch chunk
DATA_STEPS, DATA_BATCH = 3, 32  # phase 22: apps.train and apps.eval_interhand on the split
DATA_LABEL_RTOL = {"v2d": 1e-4, "j2d": 1e-4}  # else 1e-5, of each label's largest |value|
DATA_IK_MEAN_RESIDUAL = 1.5e-3  # tests/test_ik.py's bar (template scale, metres)
WORLD2_BATCH = 4  # phase 21: a rank's batch of the two ranks on one card (global 8)
CORPUS_IMAGES = 64  # phase 23: background images (JPEG, PNG, BMP) of the corpus
PERSP_BATCH, PERSP_CPU = 32, 2  # phase 24: scenes rendered on the card, and on the CPU
MASKIOU_N = 64  # phase 24: frames of the packed split with camera_in
DEMO_IMAGES, DEMO_CPU_IMAGES = 8, 2  # phase 25: images on the card, and on the CPU
PT_N, PT_SPP, PT_BOUNCES = 8, 8, 2  # phase 26: synth_gen --renderer pathtrace at 256²
PT_PARITY = (64, 2, 2, 2)  # phase 26 card vs CPU: size, scenes, spp, bounces
BF16_STEPS = 100  # phase 27: validate_bf16_decoder's training steps at batch 64
F32_YAML = "configs/probe_f32.yaml"  # phase 28: the upstream recipe's float32, batch 128
F32_TRAIN_STEPS = 12
F32_SIMT_ENCODER = "hrnet_w18"  # phase 28: 18- and 36-channel branches, B2 on simt


def _gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, iters: int = 20) -> float:
    """Device time of one call of `fn`: `iters` calls captured in one CUDA
    graph and replayed, so that the host's cost of a call (Python, ctypes,
    allocation), which exceeds a short kernel's time, is left out."""
    import torch

    side = torch.cuda.Stream()  # warm-up off the capturing stream, as capture asks
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    ms = _time_ms(graph.replay, iters=5, warmup=1) / iters
    del graph
    return ms


def _bound(n_bytes: int, flops: int, dtype_name: str, exps: int = 0) -> dict:
    """The least time for this work: bytes over the HBM rate, FLOPs over
    the peak for the type (`PEAK_FLOPS`) or exponentials over the MUFU
    rate, whichever is largest."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_exps = exps / MUFU_EXP_PER_S * 1e3
    bound = max(t_bytes, t_ops, t_exps)
    return dict(bytes_ms=t_bytes, ops_ms=t_ops, exps_ms=t_exps, bound_ms=bound,
                bound_by="bytes" if t_bytes >= bound else "operations")


def _check(name: str, got, want, atol: float, rtol: float) -> float:
    import torch

    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    max_err = float(err.max())
    if bool(bad.any()):
        raise AssertionError(f"{name}: max|Δ| {max_err:.3e} outside atol "
                             f"{atol:g} + rtol {rtol:g}·|ref| "
                             f"({int(bad.sum())} elements)")
    return max_err


NO_SPILLS = {"conv3x3": ("conv3x3_wgmma", "conv3x3_tf32x3"),
             "fused_attention": ("mha_mma_kernel",), "sdf": ("sdf_kernel",)}  # source: kernels


def check_spills(logs: dict) -> None:
    """Fail if ptxas reports spills in a kernel of NO_SPILLS, or no report
    for one whose source was built."""
    spills, seen, fn = [], set(), ""
    for name, log in logs.items():
        for line in log.splitlines():
            if "Function properties for" in line:
                fn = line.rsplit(" ", 1)[-1]
            elif "spill stores" in line:
                for kernel in NO_SPILLS.get(name, ()):
                    if kernel not in fn:
                        continue
                    seen.add(kernel)
                    # "N bytes stack frame, N bytes spill stores, N bytes spill loads"
                    if any(int(tok) for tok in line.replace(",", " ").split()[3:]
                           if tok.isdigit()):
                        spills.append(f"{name}: {fn}: {line.strip()}")
    if spills:
        raise AssertionError("ptxas spills:\n" + "\n".join(spills))
    missing = [k for n in NO_SPILLS if n in logs for k in NO_SPILLS[n] if k not in seen]
    if missing:
        raise AssertionError(f"no ptxas report for {missing}")
    print(f"[build] no spills in {sorted(seen)}", flush=True)


def print_mha_resources(log: str) -> None:
    """B1's registers (ptxas) and dynamic shared memory (the library's own
    `fused_mha_smem_bytes`) for each (dtype, D) instance."""
    import ctypes
    import re

    from renderih_tpu_torch.kernels import _build

    lib = ctypes.CDLL(str(_build.library_path("fused_attention")))
    lib.fused_mha_smem_bytes.argtypes = (ctypes.c_int, ctypes.c_int)
    lib.fused_mha_smem_bytes.restype = ctypes.c_int
    inst = None
    for line in log.splitlines():
        m = re.search(r"mha_mma_kernelI(f|13__nv_bfloat16)Li(\d+)E", line)
        if "Function properties for" in line and m:
            inst = ("bfloat16" if m.group(1) != "f" else "float32", int(m.group(2)))
        elif inst and "registers" in line:
            dtype, d = inst
            smem = lib.fused_mha_smem_bytes(int(dtype == "bfloat16"), d)
            print(f"[build] mha_mma_kernel<{dtype}, D={d}>: "
                  f"{line.split(':', 1)[1].strip()}; {smem} B dynamic shared memory", flush=True)
            inst = None


def _routes() -> dict:
    from renderih_tpu_torch.kernels import conv3x3

    return {name: c.value for name, c in conv3x3.routes.items()}


def _check_f32_routes(label: str, before: dict, has_b2: bool = True) -> int:
    """An f32 run on the card since `before` (a `_routes()`): every B2
    launch on `tf32x3`, none on `simt` or `wgmma`, and some if the model
    has B2 (`has_b2`). Returns the `tf32x3` launches."""
    delta = {k: v - before[k] for k, v in _routes().items()}
    if delta["simt"] or delta["wgmma"] or bool(delta["tf32x3"]) != has_b2:
        raise AssertionError(f"{label}: B2 routes {delta} in an f32 run; expected every launch "
                             f"on tf32x3" + ("" if has_b2 else " (none: no B2 in this model)"))
    return delta["tf32x3"]


_SHAPES: dict = {}


def kernel_shapes(cfg, assets) -> dict:
    """Every B2 and B1 call of one forward of `cfg`'s model, from the model
    built: `HandNet` on the meta device (no weights, no arithmetic), its
    kernels' call sites recording. {"conv3x3": [(side, cin, cout, dtype,
    calls a forward)], "fused_mha": [(N, M, heads, D, dtype, calls)]}, dtype
    the one the path runs the kernel in."""
    import collections
    from unittest import mock

    import torch

    from renderih_tpu_torch.kernels.conv3x3 import conv3x3_reference
    from renderih_tpu_torch.kernels.fused_attention import mha_reference
    from renderih_tpu_torch.models import attention, build_model, model_call_kwargs, resnet

    key = repr((cfg.model, cfg.train.precision))
    if key not in _SHAPES:
        calls = {"conv3x3": collections.Counter(), "fused_mha": collections.Counter()}
        dname = lambda t: str(t.dtype).split(".")[1]

        def conv(x, w):
            calls["conv3x3"][(x.shape[1], x.shape[3], w.shape[3], dname(x))] += 1
            return conv3x3_reference(x, w)

        def mha(q, k, v):
            calls["fused_mha"][(q.shape[1], k.shape[1], q.shape[2], q.shape[3], dname(q))] += 1
            return mha_reference(q, k, v)

        with torch.device("meta"):
            model = build_model(cfg, assets).eval()
        size = cfg.model.img_size
        with mock.patch.object(resnet, "conv3x3_same", conv), \
                mock.patch.object(attention, "fused_mha", mha), torch.no_grad():
            model(torch.zeros(1, size, size, 3, device="meta"),
                  **model_call_kwargs(assets, "meta"))
        _SHAPES[key] = {name: [(*k, n) for k, n in sorted(c.items())]
                        for name, c in calls.items()}
    return _SHAPES[key]


def per_forward(cfg, assets) -> dict:
    """B2 and B1 launches a forward of `cfg`'s model."""
    return {name: sum(s[-1] for s in shapes)
            for name, shapes in kernel_shapes(cfg, assets).items()}


def shape_counts(cfg, assets, kernel: str) -> dict:
    """{shape without dtype: calls a forward} of one kernel."""
    out: dict = {}
    for *shape, _, n in kernel_shapes(cfg, assets)[kernel]:
        out[tuple(shape)] = out.get(tuple(shape), 0) + n
    return out


def path_routes(cfg, assets) -> dict:
    """B2 launches a forward of `cfg`'s model on each route."""
    import torch

    from renderih_tpu_torch.kernels import conv3x3

    out = {"simt": 0, "wgmma": 0, "tf32x3": 0}
    for _, cin, cout, dname, n in kernel_shapes(cfg, assets)["conv3x3"]:
        out[conv3x3.route(getattr(torch, dname), cin, cout)] += n
    return out


def hold_conv(x, w, label: str, route: str | None = None):
    """B2 on (x, w) against its plain version at `CONV_TOL`, on `route`
    (default: the one the launcher's rule gives aligned tensors,
    `conv3x3.route`): (y, max|Δ|, route, the worst element's share of its
    limit)."""
    import torch

    from renderih_tpu_torch.kernels import conv3x3

    dname = str(x.dtype).split(".")[1]
    route = route or conv3x3.route(x.dtype, x.shape[3], w.shape[3])
    before = _routes()
    y = conv3x3.conv3x3_same(x, w)
    torch.cuda.synchronize()
    want_routes = dict(before, **{route: before[route] + 1})
    if _routes() != want_routes:
        raise AssertionError(f"{label}: routes {_routes()}, expected {want_routes}")
    atol, rtol = CONV_TOL[dname]
    ref = conv3x3.conv3x3_reference(x, w).float()
    err = _check(label, y, ref, atol, rtol)
    share = float(((y.float() - ref).abs() / (atol + rtol * ref.abs())).max())
    return y, err, route, share


def hold_mha(q, k, v, label: str):
    """B1 on (q, k, v) against the float32 plain version on the same
    (rounded) inputs, at `MHA_TOL` in f32 and `CONV_TOL` in bf16:
    (out, max|Δ|)."""
    import torch

    from renderih_tpu_torch.kernels import fused_attention

    tol = MHA_TOL if q.dtype == torch.float32 else CONV_TOL[str(q.dtype).split(".")[1]]
    out = fused_attention.fused_mha(q, k, v)
    torch.cuda.synchronize()
    ref = fused_attention.mha_reference(q.float(), k.float(), v.float())
    return out, _check(label, out, ref, *tol)


def hold_path_kernels(cfg, assets, batch: int, seed: int) -> dict:
    """B2 and B1 at every shape of a forward of `cfg` at `batch`, each in
    the dtype its path runs it in (the flagship: B2 bf16, B1 f32), against
    their plain versions on random inputs: the largest max|Δ| of each."""
    import torch

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed)
    worst = {"conv3x3": 0.0, "fused_mha": 0.0}
    shapes = kernel_shapes(cfg, assets)
    for side, cin, cout, dname, _ in shapes["conv3x3"]:
        dtype = getattr(torch, dname)
        x = torch.randn(batch, side, side, cin, device=dev, generator=g).to(dtype)
        w = (torch.randn(3, 3, cin, cout, device=dev, generator=g) / (9 * cin) ** 0.5).to(dtype)
        err = hold_conv(x, w, f"conv3x3 {dname} batch {batch} {side}²x{cin}->{cout}")[1]
        worst["conv3x3"] = max(worst["conv3x3"], err)
        del x, w
    for n, m, heads, d, dname, _ in shapes["fused_mha"]:
        dtype = getattr(torch, dname)
        q = torch.randn(batch, n, heads, d, device=dev, generator=g).to(dtype)
        k, v = (torch.randn(batch, m, heads, d, device=dev, generator=g).to(dtype)
                for _ in range(2))
        err = hold_mha(q, k, v, f"fused_mha {dname} batch {batch} N={n} M={m} H={heads} D={d}")[1]
        worst["fused_mha"] = max(worst["fused_mha"], err)
        del q, k, v
    torch.cuda.empty_cache()
    return worst


def kernel_phase(cfg, assets, skip: dict | None = None, label: str = "flagship",
                 dtypes: tuple = ("bfloat16", "float32")) -> dict:
    """B2 and B1 at every shape of a forward of `cfg` at batch `BATCH`, B2
    in `dtypes`, held and timed (the module docstring, phase 2); shapes in
    `skip` ({kernel: set of shapes}, measured already) are left out."""
    import torch
    import torch.nn.functional as F

    from renderih_tpu_torch.kernels import conv3x3

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(0)
    rows = {"conv3x3": [], "fused_mha": []}
    skip = skip or {}

    for dtype in (getattr(torch, d) for d in dtypes):
        dname = str(dtype).split(".")[1]
        f32 = dtype == torch.float32
        atol, rtol = CONV_TOL[dname]
        for (side, cin, cout), per_fwd in shape_counts(cfg, assets, "conv3x3").items():
            if (side, cin, cout) in skip.get("conv3x3", ()):
                continue
            x = torch.randn(BATCH, side, side, cin, device=dev, generator=g).to(dtype)
            w = (torch.randn(3, 3, cin, cout, device=dev, generator=g)
                 / (9 * cin) ** 0.5).to(dtype)
            y, err, route, share = hold_conv(x, w, f"conv3x3 {dname} {side}²x{cin}->{cout}")
            x_lib = x.permute(0, 3, 1, 2)  # NCHW view, channels_last
            w_lib = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            n_bytes = (x.numel() + w.numel() + y.numel()) * x.element_size()
            flops = 2 * BATCH * side * side * cin * cout * 9
            conv_lib = lambda: F.conv2d(x_lib, w_lib, padding=1)
            # f32 on either route: the TF32 tensor-core yardstick, as B1's
            bound = _bound(n_bytes, flops, "tfloat32" if f32 else dname)
            row = dict(
                dtype=dname, shape=[BATCH, side, side, cin, cout], launches_per_forward=per_fwd,
                route=route,
                max_abs_err=err, atol=atol, rtol=rtol, limit_share=share,
                ms=_time_ms(lambda: conv3x3.conv3x3_same(x, w)),
                plain_ms=_time_ms(lambda: conv3x3.conv3x3_reference(x, w)),
                library_ms=_time_ms(conv_lib), **bound)
            extra = ""
            if f32:
                # the CUDA-core yardstick, FLOPs over the f32 FMA peak; cuDNN
                # in TF32 (PyTorch's default), a less accurate function, not
                # the yardstick; and `simt` on this input: on a tf32x3 row the
                # same input one float off 16-byte alignment, which the
                # launcher sends to `simt` (phase 2's comparison of the two
                # routes in one run), on a simt row the row itself
                row["cuda_core_bound_ms"] = _bound(n_bytes, flops, "float32")["bound_ms"]
                with _tf32_defaults():
                    row["library_tf32_ms"] = _time_ms(conv_lib)
                if route == "simt":
                    row["simt_max_abs_err"], row["simt_ms"] = err, row["ms"]
                else:
                    x_off = torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape)
                    x_off.copy_(x)
                    row["simt_max_abs_err"] = hold_conv(
                        x_off, w, f"conv3x3 f32 misaligned {side}²x{cin}->{cout}",
                        route="simt")[1]
                    row["simt_ms"] = _time_ms(lambda: conv3x3.conv3x3_same(x_off, w), iters=5)
                    del x_off
                extra = (f" cuda_core_bound_ms={row['cuda_core_bound_ms']:.4f} "
                         f"library_tf32_ms={row['library_tf32_ms']:.4f} (cuDNN, TF32: less "
                         f"accurate) simt_ms={row['simt_ms']:.4f} ("
                         + ("this row" if route == "simt" else "misaligned input")
                         + f", max|Δ| {row['simt_max_abs_err']:.3e})")
            rows["conv3x3"].append(row)
            print(f"[B2] conv3x3 {dname} x({BATCH},{side},{side},{cin}) w(3,3,{cin},{cout}): "
                  f"max|Δ|={err:.3e} (atol {atol:g}, rtol {rtol:g}; worst element at "
                  f"{share:.3f} of its limit)  "
                  f"kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                  f"library_ms={row['library_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
                  f"({row['bound_by']}){extra}  launches/forward={per_fwd} route={route}",
                  flush=True)
            del x, w, y, x_lib, w_lib
        fwd = [r for r in rows["conv3x3"] if r["dtype"] == dname]
        if fwd:
            total = {key: sum(r[key] * r["launches_per_forward"] for r in fwd)
                     for key in ("ms", "plain_ms", "library_ms", "bound_ms", "cuda_core_bound_ms",
                                 "library_tf32_ms", "simt_ms") if key in fwd[0]}
            print(f"[B2] conv3x3 {dname} per {label} forward at {BATCH}, these shapes "
                  f"({sum(r['launches_per_forward'] for r in fwd)} launches): "
                  + ", ".join(f"{key} {val:.4f}" for key, val in total.items()), flush=True)

    rows["fused_mha"] = mha_rows(shape_counts(cfg, assets, "fused_mha"), g,
                                 skip.get("fused_mha", ()), label)
    return rows


def mha_rows(counts: dict, g, skip=(), label: str = "flagship") -> list:
    """B1 at each (N, M, heads, D) of `counts` ({shape: launches a forward}),
    but those in `skip`, at batch `BATCH` in f32 and bf16 from generator
    `g`: held and timed as phase 2 says; prints each dtype's sum over a
    forward of `label`."""
    import torch
    import torch.nn.functional as F

    from renderih_tpu_torch.kernels import fused_attention

    dev = torch.device(DEVICE)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        f32 = dtype == torch.float32
        atol, rtol = MHA_TOL if f32 else CONV_TOL[dname]
        for (n, m, heads, d), per_fwd in counts.items():
            if (n, m, heads, d) in skip:
                continue
            q = torch.randn(BATCH, n, heads, d, device=dev, generator=g).to(dtype)
            k, v = (torch.randn(BATCH, m, heads, d, device=dev, generator=g).to(dtype)
                    for _ in range(2))
            out, err = hold_mha(q, k, v, f"fused_mha {dname} N={n} M={m} H={heads} D={d}")
            ql, kl, vl = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            n_bytes = (q.numel() + k.numel() + v.numel() + out.numel()) * q.element_size()
            flops = 4 * BATCH * heads * n * m * d
            # tensor cores: TF32 (3xTF32 runs three passes of it) or bf16
            bound = _bound(n_bytes, flops, "tfloat32" if f32 else dname,
                           exps=BATCH * heads * n * m)
            row = dict(
                dtype=dname, shape=[BATCH, n, m, heads, d],
                launches_per_forward=per_fwd, max_abs_err=err, atol=atol, rtol=rtol,
                ms=_graph_ms(lambda: fused_attention.fused_mha(q, k, v)),
                eager_ms=_time_ms(lambda: fused_attention.fused_mha(q, k, v)),
                plain_ms=_time_ms(lambda: fused_attention.mha_reference(q, k, v)),
                library_ms=_graph_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl)),
                **bound)
            old = ""
            if f32:  # PR 1-3's yardstick: FLOPs over the CUDA-core f32 peak
                row["cuda_core_bound_ms"] = _bound(n_bytes, flops, "float32")["bound_ms"]
                old = f" cuda_core_bound_ms={row['cuda_core_bound_ms']:.4f}"
            rows.append(row)
            print(f"[B1] fused_mha {dname} q({BATCH},{n},{heads},{d}) k,v({BATCH},{m},{heads},{d}): "
                  f"max|Δ|={err:.3e} (atol {atol:g}, rtol {rtol:g})  "
                  f"kernel_ms={row['ms']:.4f} (eager {row['eager_ms']:.4f}) "
                  f"plain_ms={row['plain_ms']:.4f} "
                  f"library_ms={row['library_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
                  f"({row['bound_by']}: bytes {row['bytes_ms']:.4f}, ops "
                  f"{row['ops_ms']:.4f}, exps {row['exps_ms']:.4f}){old}  "
                  f"launches/forward={per_fwd}", flush=True)
            del q, k, v, out, ql, kl, vl
        fwd = [r for r in rows if r["dtype"] == dname]
        if not fwd:
            continue
        total = {key: sum(r[key] * r["launches_per_forward"] for r in fwd)
                 for key in ("ms", "eager_ms", "plain_ms", "library_ms", "bound_ms",
                             "cuda_core_bound_ms") if key in fwd[0]}
        print(f"[B1] fused_mha {dname} per {label} forward, these shapes "
              f"({sum(r['launches_per_forward'] for r in fwd)} launches): "
              + ", ".join(f"{key} {val:.4f}" for key, val in total.items()), flush=True)
    return rows


def profile_phase(label: str, fn, top: int = 30) -> dict:
    """Device time by kernel over one call of `fn` (torch.profiler): only
    device-side events count (kernels, memcpy, memset), and the busy time
    is the union of their intervals. Prints the `top` kernels by time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        ms, count = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (ms + (ev.time_range.end - ev.time_range.start) / 1e3,
                            count + 1)
    busy_us, last_end = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > last_end:
            busy_us += end - max(start, last_end)
            last_end = end
    rows = sorted(((ms, c, n) for n, (ms, c) in by_name.items()), reverse=True)
    busy_ms = busy_us / 1e3
    print(f"[profile] {label} under the profiler: wall {wall_ms:.2f} ms, "
          f"device busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"{len(spans)} device events" + ("; by kernel:" if top else ""), flush=True)
    for ms, count, name in rows[:top]:
        print(f"[profile] {ms:9.3f} ms {count:5d}x  {name[:110]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "device_events": len(spans),
            "kernels": [dict(ms=ms, count=c, name=n) for ms, c, n in rows]}


def parity_phase(cfg, assets, tag: str = "parity") -> dict:
    import copy

    import numpy as np

    from renderih_tpu_torch.serve import InferenceEngine

    cfg32 = copy.deepcopy(cfg)
    cfg32.train.precision = "f32"
    n = 4
    rng = np.random.default_rng(1)
    size = cfg.model.img_size
    images = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    before = _routes()
    gpu = InferenceEngine(cfg32, assets=assets, device=DEVICE, buckets=(n,), seed=0)
    out_gpu = gpu.predict(images)
    b2 = _check_f32_routes(tag, before, per_forward(cfg32, assets)["conv3x3"] > 0)
    cpu = InferenceEngine(cfg32, assets=assets, device="cpu", buckets=(n,), seed=0)
    out_cpu = cpu.predict(images)
    errs = {}
    for key, ref in out_cpu.items():
        scale = max(float(np.abs(ref).max()), 1e-6)
        rel = float(np.abs(out_gpu[key] - ref).max()) / scale
        errs[key] = rel
        if not rel <= PATH_RTOL:
            raise AssertionError(f"{key}: card vs CPU rel max|Δ| {rel:.3e} > {PATH_RTOL:g}")
    print(f"[{tag}] {cfg.model.encoder} f32, TF32 off, {n} images: card (kernels; {b2} B2 "
          f"launches, all tf32x3) vs CPU (plain), "
          f"max|Δ| / max|ref| per output: "
          + ", ".join(f"{k}={v:.2e}" for k, v in errs.items())
          + f" (limit {PATH_RTOL:g})", flush=True)
    return errs


def _posed_hand(assets, device):
    """The synthetic left hand posed by `mano_forward` at a seeded pose."""
    import numpy as np
    import torch

    from renderih_tpu_torch.mano.layer import mano_forward
    from renderih_tpu_torch.ops.rotation import rodrigues

    rng = np.random.default_rng(0)
    pose = torch.from_numpy(rng.normal(0, 0.4, (1, 45)).astype(np.float32))
    root = torch.from_numpy(rng.normal(0, 0.8, (1, 3)).astype(np.float32))
    v, _ = mano_forward(assets.left.mano, rodrigues(root), pose, torch.zeros(1, 10),
                        center_idx=None, use_pca=False)
    return v[0].to(device), assets.left.mano.faces.to(device)


def _cube(device):
    import torch

    v = torch.tensor([[x, y, z] for z in (-.5, .5) for y in (-.5, .5) for x in (-.5, .5)])
    f = torch.tensor([[0, 3, 1], [0, 2, 3], [4, 5, 7], [4, 7, 6], [0, 1, 5], [0, 5, 4],
                      [3, 2, 6], [3, 6, 7], [1, 3, 7], [1, 7, 5], [0, 4, 6], [0, 6, 2]])
    return v.to(device), f.to(device)


def sdf_kernel_phase(assets) -> list:
    """B3 against its plain version on the card (see the module docstring)."""
    import torch

    from renderih_tpu_torch.kernels import sdf

    dev = torch.device(DEVICE)
    rows = []
    for mesh, (verts, faces) in (("hand", _posed_hand(assets, dev)), ("cube", _cube(dev))):
        n_faces = faces.shape[0]
        for g in SDF_GRIDS:
            phi, bmin, scale = sdf.sdf_grid(verts, faces, g)
            torch.cuda.synchronize()
            ref, ref_bmin, ref_scale = sdf.sdf_grid_reference(verts, faces, g)
            name = f"sdf_grid {mesh} G={g}"
            err = float((phi - ref).abs().max())
            flips = int(((phi > 0) != (ref > 0)).sum())
            if not torch.equal(phi, ref) or not torch.equal(bmin, ref_bmin) \
                    or not torch.equal(scale, ref_scale):
                raise AssertionError(f"{name}: phi not bit-equal (max|Δ| {err:.3e}, {flips} "
                                     f"inside flags differ), or bbox/scale differ "
                                     f"({bmin.tolist()} {float(scale)} vs "
                                     f"{ref_bmin.tolist()} {float(ref_scale)})")
            n_vox = g ** 3
            row = dict(mesh=mesh, grid=g, faces=n_faces, max_abs_err=err,
                       inside=int((ref > 0).sum()), inside_flips=flips,
                       ms=_time_ms(lambda: sdf.launch_sdf(verts, faces, bmin, scale, g)),
                       wrapper_ms=_time_ms(lambda: sdf.sdf_grid(verts, faces, g)),
                       plain_ms=_time_ms(lambda: sdf.sdf_grid_reference(verts, faces, g),
                                         iters=5, warmup=1),
                       library_ms=None,
                       **_bound(4 * (3 * n_vox + 9 * n_faces + n_vox),
                                SDF_FLOP_PER_PAIR * n_vox * n_faces, "float32"))
            rows.append(row)
            print(f"[B3] {name} F={n_faces}: phi bit-equal to the plain version, "
                  f"inside {row['inside']}/{n_vox}, bbox and scale equal  "
                  f"kernel_ms={row['ms']:.4f} (with the torch "
                  f"bbox setup: {row['wrapper_ms']:.4f}) "
                  f"plain_ms={row['plain_ms']:.4f} library_ms=none "
                  f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})", flush=True)
    return rows


def _penetration(labels: dict, assets, grid: int):
    """Per sample, the SDF penetration of each hand into the other in the
    label frame (both hands shifted alike by the refinement's frame map)."""
    import torch

    from renderih_tpu_torch.ops.sdf import sdf_penetration_loss

    dev = torch.device(DEVICE)
    v_l = torch.from_numpy(labels["v3d_left"]).to(dev)
    v_r = torch.from_numpy(labels["v3d_right"]).to(dev)
    f_l, f_r = assets.left.mano.faces.to(dev), assets.right.mano.faces.to(dev)
    return [float(sdf_penetration_loss(v_l[i:i + 1], v_r[i:i + 1], f_l, grid)
                  + sdf_penetration_loss(v_r[i:i + 1], v_l[i:i + 1], f_r, grid))
            for i in range(v_l.shape[0])]


def synth_phase(assets, gpu_line: str, profile: bool = False, prior: str = "gaussian",
                tag: str = "synth") -> dict:
    """The synthetic-data path on the card with the naturalness prior
    `prior` (`synth_gen --prior`; see the module docstring)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from renderih_tpu_torch.assets import manos_to
    from renderih_tpu_torch.data.interhand import LABEL_KEYS, _label_shape
    from renderih_tpu_torch.kernels import _build, conv3x3, fused_attention, sdf
    from renderih_tpu_torch.tools import synth_gen

    per_attempt = SYNTH_ITERS // 4
    per_sample = 4 * (2 * per_attempt + 2)  # 2 fields per loss evaluation: 128
    common = ["--n", str(SYNTH_N), "--batch", str(SYNTH_N), "--seed", "0", "--device", DEVICE]
    os.makedirs(_build.BUILD_DIR.parent, exist_ok=True)  # build/, git-ignored
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
        refined_dir, start_dir = os.path.join(tmp, "refined"), os.path.join(tmp, "start")
        for counter in (conv3x3.launches, fused_attention.launches, sdf.launches,
                        *conv3x3.routes.values()):
            counter.reset()
        stats = synth_gen.main(["--out", refined_dir, *common, "--optimize",
                                "--opt_iters", str(SYNTH_ITERS), "--prior", prior])
        launches = {"conv3x3": conv3x3.launches.value,
                    "fused_mha": fused_attention.launches.value,
                    "sdf_grid": sdf.launches.value}
        want = {"conv3x3": 0, "fused_mha": 0, "sdf_grid": SYNTH_N * per_sample}
        print(f"[{tag}] synth_gen --n {SYNTH_N} --batch {SYNTH_N} --optimize --opt_iters "
              f"{SYNTH_ITERS} --prior {prior}: launches {launches} (expected {want})", flush=True)
        if launches != want:
            raise AssertionError(f"{tag}: kernel launches {launches} != {want}")

        labels = dict(np.load(os.path.join(refined_dir, "train_labels.npz")))
        images = np.memmap(os.path.join(refined_dir, "train_images.u8"), dtype=np.uint8,
                           mode="r")
        if images.size != SYNTH_N * 256 * 256 * 3 or images.std() < 1:
            raise AssertionError(f"images: {images.size} bytes, std {images.std():.2f}")
        for key in LABEL_KEYS:
            if labels[key].shape != (SYNTH_N,) + _label_shape(key) \
                    or not np.isfinite(labels[key]).all():
                raise AssertionError(f"{key}: shape {labels[key].shape} or non-finite")
        # the same seed without refinement: the samples as they started
        synth_gen.main(["--out", start_dir, *common])
        start = dict(np.load(os.path.join(start_dir, "train_labels.npz")))
    pen0 = np.asarray(_penetration(start, assets, SYNTH_GRID))
    pen1 = np.asarray(_penetration(labels, assets, SYNTH_GRID))
    hit = pen0 > 0
    if not hit.any() or not pen1[hit].mean() < pen0[hit].mean():
        raise AssertionError(f"{tag}: penetration did not fall: {pen0[hit].mean() if hit.any() else 0:.4e}"
                             f" -> {pen1[hit].mean() if hit.any() else 0:.4e} over "
                             f"{int(hit.sum())} interpenetrating samples")
    print(f"[{tag}] {int(hit.sum())}/{SYNTH_N} samples started interpenetrating: mean SDF "
          f"penetration (G={SYNTH_GRID}) {pen0[hit].mean():.4e} -> {pen1[hit].mean():.4e}; "
          f"{int((pen1[hit] > 0).sum())} of them still interpenetrate", flush=True)
    print(f"[{tag}] {stats['refined_samples_per_s']:.3f} refined samples/s "
          f"({stats['refine_seconds']:.2f} s refining {SYNTH_N}), "
          f"{stats['images_per_s']:.3f} generated images/s end to end "
          f"({stats['seconds']:.2f} s) on {gpu_line}", flush=True)
    result = dict(launches=launches, per_sample=per_sample,
                  refine_seconds=stats["refine_seconds"], seconds=stats["seconds"],
                  refined_samples_per_s=stats["refined_samples_per_s"],
                  images_per_s=stats["images_per_s"], pen_start=pen0.tolist(),
                  pen_refined=pen1.tolist())
    if profile:
        device = torch.device(DEVICE)
        refine = synth_gen._make_refine(manos_to(assets, device), SYNTH_ITERS, device, prior)
        with torch.no_grad():
            raw = synth_gen._sample_raw(torch.Generator(device=device).manual_seed(1), 1)
        result["profile"] = profile_phase(
            f"one refined sample ({SYNTH_ITERS} iterations)",
            lambda: refine({k: v.clone() for k, v in raw.items()}, 0))
    return result


def refine_parity_phase(assets) -> dict:
    """Card against CPU: one anchor-mode refinement from one numpy start.

    Gradients tightly, the trajectory loosely. At the start the objective
    agrees within 1e-4 relative and its gradient within 1e-4 relative plus
    1e-5 of its largest component (float32 sums in another order). The
    objective is piecewise smooth: the SDF gradient jumps when a vertex
    crosses a cell of the other hand's grid, the repulsion at its clamp and
    the nearest neighbours when they switch, so differences of 1e-7 grow
    along the run. After 4 attempts of 3 Adam steps the parameters must lie
    within 2·lr·steps of each other (Adam moves a component by at most ~lr
    a step), each weighted term within 5% of the final objective, and the
    objectives within 5% of each other."""
    import numpy as np
    import torch

    from renderih_tpu_torch.optimize.anchors import make_synthetic_anchors
    from renderih_tpu_torch.optimize.geo import (
        GeoWeights,
        HandVars,
        hand_forward,
        make_gaussian_pose_prior,
        make_refine_loss,
        optimize_two_hands,
    )

    rng = np.random.default_rng(5)
    draw = {k: rng.normal(0, s, n).astype(np.float32) for k, s, n in (
        ("root_l", 0.8, 3), ("pose_l", 0.4, 45), ("shape_l", 0.6, 10),
        ("root_r", 0.8, 3), ("pose_r", 0.4, 45), ("shape_r", 0.6, 10), ("offset", 0.02, 3))}
    prior_poses = (rng.normal(size=(256, 45)) * 0.4).astype(np.float32)
    specs = tuple(make_synthetic_anchors(m.faces.numpy(), m.v_template.numpy())
                  for m in (assets.left.mano, assets.right.mano))
    rep_mult, con_mult, _ = REFINE_SCHEDULE[-1]
    w = GeoWeights()
    weight = dict(contact=w.contact * con_mult, repulsion=w.repulsion * rep_mult, sdf=w.sdf,
                  edge=w.edge, pose_reg=w.pose_reg, shape_reg=w.shape_reg,
                  angle=w.angle_limit, prior=w.prior)

    def start(device):
        hands = []
        for side, mano in (("l", assets.left.mano), ("r", assets.right.mano)):
            t = {k: torch.from_numpy(draw[f"{k}_{side}"]) for k in ("pose", "shape", "root")}
            hv = HandVars(t["pose"], t["shape"], torch.zeros(3), t["root"])
            with torch.no_grad():
                j9 = hand_forward(mano, hv)[1][9]
            trans = -j9 + (torch.from_numpy(draw["offset"]) if side == "r" else 0.0)
            hands.append(HandVars(*(x.to(device) for x in hv._replace(trans=trans))))
        return hands

    res = {}
    for device in (DEVICE, "cpu"):
        left, right = start(device)
        prior = make_gaussian_pose_prior(torch.from_numpy(prior_poses).to(device))
        loss_fn, match_fn = make_refine_loss(assets, left, right, sdf_grid_size=SYNTH_GRID,
                                             pose_prior_fn=prior, anchors=specs)
        leaves = [t.clone().requires_grad_() for hv in (left, right) for t in hv]
        params = (HandVars(*leaves[:4]), HandVars(*leaves[4:]))
        total0, _ = loss_fn(params, match_fn(params), con_mult, rep_mult)
        total0.backward()
        l2, r2, terms = optimize_two_hands(
            assets, left, right, lr=REFINE_LR, sdf_grid_size=SYNTH_GRID, pose_prior_fn=prior,
            anchors=specs, schedule=REFINE_SCHEDULE)
        terms = {k: float(v) * weight[k] for k, v in terms.items()}
        res[device] = dict(
            total0=total0.item(), total=sum(terms.values()), terms=terms,
            grad=np.concatenate([t.grad.cpu().numpy().ravel() for t in leaves]),
            params=np.concatenate([t.cpu().numpy().ravel() for hv in (l2, r2) for t in hv]))
    card, cpu = res[DEVICE], res["cpu"]
    steps = sum(n for _, _, n in REFINE_SCHEDULE)
    grad_err = np.abs(card["grad"] - cpu["grad"])
    grad_tol = 1e-4 * np.abs(cpu["grad"]) + 1e-5 * np.abs(cpu["grad"]).max()
    start_rel = abs(card["total0"] - cpu["total0"]) / abs(cpu["total0"])
    param_err = float(np.abs(card["params"] - cpu["params"]).max())
    term_err = max(abs(card["terms"][k] - v) for k, v in cpu["terms"].items()) / cpu["total"]
    total_rel = abs(card["total"] - cpu["total"]) / cpu["total"]
    print(f"[refine-parity] anchor mode, G={SYNTH_GRID}, f32, TF32 off, card vs CPU: at the "
          f"start objective {card['total0']:.6g}/{cpu['total0']:.6g} (rel {start_rel:.2e}, "
          f"limit 1e-4), gradient max|Δ| {grad_err.max():.3e} (max|g| "
          f"{np.abs(cpu['grad']).max():.4g}; {int((grad_err > grad_tol).sum())} components "
          f"outside 1e-4·|g| + 1e-5·max|g|); after {len(REFINE_SCHEDULE)}x3 steps params "
          f"max|Δ| {param_err:.3e} (limit {2 * REFINE_LR * steps:g}), objective "
          f"{card['total']:.6g}/{cpu['total']:.6g} (rel {total_rel:.2e}, limit 0.05), weighted "
          f"terms max|Δ| {term_err:.2e} of the objective (limit 0.05): "
          + ", ".join(f"{k}={card['terms'][k]:.5g}/{cpu['terms'][k]:.5g}"
                      for k in sorted(cpu["terms"])), flush=True)
    if not (start_rel <= 1e-4 and (grad_err <= grad_tol).all()
            and param_err <= 2 * REFINE_LR * steps and total_rel <= 0.05 and term_err <= 0.05):
        raise AssertionError("card and CPU refinements disagree")
    return dict(start_rel=start_rel, grad_max_abs_err=float(grad_err.max()),
                params_max_abs_err=param_err, total_rel=total_rel, term_err=term_err)


def conv_backward_phase(cfg, assets, batch: int = TRAIN_BATCH,
                        dtypes: tuple = ("bfloat16", "float32"), seed: int = 1) -> list:
    """B2's backward at every training shape of `cfg` at `batch`, in
    `dtypes` (see the module docstring, phase 7; phase 11 at the recipe's
    batch, phase 17 on HRNet-W32). Every B2 site maps C channels to C."""
    import torch
    import torch.nn.functional as F

    from renderih_tpu_torch.kernels import conv3x3

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    for dtype in (getattr(torch, d) for d in dtypes):
        dname = str(dtype).split(".")[1]
        atol, rtol = CONV_TOL[dname]
        for (side, c, cout), per_fwd in shape_counts(cfg, assets, "conv3x3").items():
            assert c == cout, (side, c, cout)
            route = conv3x3.route(dtype, c, c)
            shape = (batch, side, side, c)
            x = torch.randn(*shape, device=dev, generator=g).to(dtype)
            w = (torch.randn(3, 3, c, c, device=dev, generator=g) / (9 * c) ** 0.5).to(dtype)
            gy = torch.randn(*shape, device=dev, generator=g).to(dtype)
            xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
            before = _routes()
            conv3x3.conv3x3_same(xk, wk).backward(gy)
            torch.cuda.synchronize()
            want_routes = dict(before, **{route: before[route] + 2})  # forward, dx
            if _routes() != want_routes:
                raise AssertionError(f"conv3x3 backward {dname} {side}²x{c}: routes "
                                     f"{_routes()}, expected {want_routes}")
            xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
            conv3x3.conv3x3_reference(xp, wp).backward(gy)
            name = f"conv3x3 backward {dname} {side}²x{c}"
            w_t = w.flip(0, 1).transpose(2, 3).contiguous()
            nchw = lambda t: t.permute(0, 3, 1, 2)
            w_oihw = w.permute(3, 2, 0, 1).contiguous()
            dx_lib = F.grad.conv2d_input(nchw(x).shape, w_oihw, nchw(gy), padding=1)
            err_dx = _check(f"{name} dx vs plain", xk.grad, xp.grad, atol, rtol)
            err_lib = _check(f"{name} dx vs cuDNN", xk.grad, dx_lib.permute(0, 2, 3, 1), atol,
                             rtol)
            share = float(((xk.grad.float() - xp.grad.float()).abs()
                           / (atol + rtol * xp.grad.float().abs())).max())
            # dw sums B·H·W products: relative to its largest element
            ref = wp.grad.float()
            err_dw = float((wk.grad.float() - ref).abs().max() / ref.abs().max())
            if not err_dw <= (1e-5 if dtype == torch.float32 else 1e-2):
                raise AssertionError(f"{name} dw: max|Δ|/max|ref| {err_dw:.3e}")
            n_bytes = (x.numel() + w.numel() + x.numel()) * x.element_size()
            flops = 2 * batch * side * side * c * c * 9
            dx = lambda: conv3x3.conv3x3_same(gy, w.flip(0, 1).transpose(2, 3).contiguous())
            row = dict(
                dtype=dname, shape=[batch, side, side, c, c],
                launches_per_step=2 * per_fwd, route=route,
                max_abs_err=max(err_dx, err_lib), dw_rel_err=err_dw, atol=atol, rtol=rtol,
                limit_share=share,
                fwd_ms=_graph_ms(lambda: conv3x3.conv3x3_same(x, w)),
                dx_ms=_graph_ms(dx),
                eager_fwd_ms=_time_ms(lambda: conv3x3.conv3x3_same(x, w)),
                eager_dx_ms=_time_ms(dx),
                plain_fwd_ms=_graph_ms(lambda: conv3x3.conv3x3_reference(x, w)),
                plain_dx_ms=_graph_ms(lambda: conv3x3.conv3x3_reference(gy, w_t)),
                library_fwd_ms=_graph_ms(lambda: F.conv2d(nchw(x), w_oihw, padding=1)),
                library_dx_ms=_graph_ms(lambda: F.grad.conv2d_input(
                    nchw(x).shape, w_oihw, nchw(gy), padding=1)),
                dw_ms=_graph_ms(lambda: F.grad.conv2d_weight(
                    nchw(x), w_oihw.shape, nchw(gy), padding=1)),
                **_bound(n_bytes, flops, "tfloat32" if dname == "float32" else dname))
            if dname == "float32":  # as phase 2's f32 rows
                row["cuda_core_bound_ms"] = _bound(n_bytes, flops, "float32")["bound_ms"]
            rows.append(row)
            print(f"[B2-bwd] {name} x({batch},{side},{side},{c}): dx max|Δ| "
                  f"{err_dx:.3e} vs plain (worst element at {share:.3f} of its limit), "
                  f"{err_lib:.3e} vs cuDNN conv2d_input (atol {atol:g}, "
                  f"rtol {rtol:g}); dw (cuDNN) rel {err_dw:.2e}  device ms (CUDA graph): "
                  f"fwd {row['fwd_ms']:.4f}, dx {row['dx_ms']:.4f} (with the weight flip), "
                  f"plain fwd/dx {row['plain_fwd_ms']:.4f}/{row['plain_dx_ms']:.4f}, cuDNN "
                  f"fwd/dx {row['library_fwd_ms']:.4f}/{row['library_dx_ms']:.4f}, dw "
                  f"{row['dw_ms']:.4f}; eager fwd/dx {row['eager_fwd_ms']:.4f}/"
                  f"{row['eager_dx_ms']:.4f}; bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
                  + (f"cuda_core_bound_ms={row['cuda_core_bound_ms']:.4f} "
                     if "cuda_core_bound_ms" in row else "")
                  + f"each; launches/step={2 * per_fwd} route={route}", flush=True)
            del x, w, gy, xk, wk, xp, wp, dx_lib
        per_step = [r for r in rows if r["dtype"] == dname]
        tot = lambda key: sum(r[key] * r["launches_per_step"] / 2 for r in per_step)
        n_fwd = sum(r["launches_per_step"] for r in per_step) // 2
        print(f"[B2-bwd] {dname} per training step ({n_fwd} forward + {n_fwd} dx launches), "
              f"device ms: "
              f"B2 {tot('fwd_ms') + tot('dx_ms'):.3f} (fwd {tot('fwd_ms'):.3f}, dx "
              f"{tot('dx_ms'):.3f}), plain {tot('plain_fwd_ms') + tot('plain_dx_ms'):.3f}, "
              f"cuDNN {tot('library_fwd_ms') + tot('library_dx_ms'):.3f}, bound "
              f"{2 * tot('bound_ms'):.3f}; dw by cuDNN {tot('dw_ms'):.3f}; eager (host "
              f"included) B2 {tot('eager_fwd_ms') + tot('eager_dx_ms'):.3f}", flush=True)
    torch.cuda.empty_cache()
    return rows


def _train_yaml(cfg, root: str, name: str, **train) -> str:
    """A config file for one `apps.train` run: `cfg` with its own
    checkpoint directory and these train settings."""
    import copy
    import os

    from renderih_tpu_torch.config import dump_config

    cfg = copy.deepcopy(cfg)
    cfg.train.checkpoint_dir = os.path.join(root, name)
    for key, val in train.items():
        setattr(cfg.train, key, val)
    path = os.path.join(root, f"{name}.yaml")
    dump_config(cfg, path)
    return path


def _state_gap(path_a: str, path_b: str, path_before: str) -> dict:
    """How far checkpoint b is from checkpoint a, the same step of two
    runs that left `path_before`: the largest parameter difference over
    the step's own largest move (max|a − before|), the Adam moments' and
    the BatchNorm statistics' largest difference relative to each
    tensor's largest value, and whether the step counters agree."""
    import torch

    load = lambda p: torch.load(f"{p}/state.pt", weights_only=True, map_location="cpu")
    a, b, before = load(path_a), load(path_b), load(path_before)

    def rel(x, y):  # y the reference
        err, scale = float((x - y).abs().max()), float(y.abs().max())
        return err / scale if scale > 0 else (0.0 if err == 0 else float("inf"))

    is_bn = lambda k: k.endswith(("running_mean", "running_var"))
    params = [k for k, v in a["model"].items() if v.is_floating_point() and not is_bn(k)]
    move = max(float((a["model"][k] - before["model"][k]).abs().max()) for k in params)
    p_gap = max(float((b["model"][k] - a["model"][k]).abs().max()) for k in params) / move
    bn_gap = max(rel(b["model"][k], a["model"][k]) for k in a["model"] if is_bn(k))
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    m_gap = float("inf") if sa.keys() != sb.keys() else max(
        rel(sb[i][key], sa[i][key]) for i in sa for key in ("exp_avg", "exp_avg_sq"))
    steps_equal = (a["step"] == b["step"] and sa.keys() == sb.keys()
                   and all(float(sa[i]["step"]) == float(sb[i]["step"]) for i in sa))
    return dict(params=p_gap, moments=m_gap, bn=bn_gap, steps_equal=steps_equal)


def train_phase(cfg, assets, gpu_line: str, profile: bool = False) -> dict:
    """The training path on the card (see the module docstring, phase 8)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from renderih_tpu_torch.apps import train as train_app
    from renderih_tpu_torch.kernels import _build, conv3x3, fused_attention, sdf

    per_fwd_b2, per_fwd_b1 = per_forward(cfg, assets).values()  # 13, 24
    per_step = 2 * per_fwd_b2  # 13 forward + 13 dx
    common = ["--synthetic", "--synth_n", str(TRAIN_SYNTH_N), "--device", DEVICE,
              "--steps", str(TRAIN_STEPS)]
    spe = TRAIN_SYNTH_N // cfg.train.batch_size
    cut_epoch = (TRAIN_STEPS - 1) // spe  # the last whole epoch before the end
    yaml = lambda root, name: _train_yaml(cfg, root, name, log_every=1, save_gap=cut_epoch,
                                          eval_every=cut_epoch, seed=0)
    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)  # build/, git-ignored
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as root:
        counters = (conv3x3.launches, fused_attention.launches, sdf.launches,
                    *conv3x3.routes.values())
        for counter in counters:
            counter.reset()
        a = train_app.main(["--cfg", yaml(root, "straight"), *common])
        launches = {"conv3x3": conv3x3.launches.value,
                    "fused_mha": fused_attention.launches.value, "sdf_grid": sdf.launches.value}
        routes = _routes()
        n_steps = a["final_step"]
        if [e["step"] for e in a["evals"]] != [cut_epoch * spe]:
            raise AssertionError(f"evals at steps {[e['step'] for e in a['evals']]}, expected "
                                 f"one (EMA off) at step {cut_epoch * spe}")
        (ev,) = a["evals"]
        # the eval's forwards: one a batch of the held-out split, one for the overlays
        n_eval_fwd = -(-ev["summary"]["num_samples"] // cfg.train.batch_size) + 1
        want = {"conv3x3": per_step * n_steps + per_fwd_b2 * n_eval_fwd,
                "fused_mha": per_fwd_b1 * n_eval_fwd, "sdf_grid": 0}
        print(f"[train] apps.train --synthetic --synth_n {TRAIN_SYNTH_N} --steps {TRAIN_STEPS}, "
              f"Config() at batch {cfg.train.batch_size}: {n_steps} steps and {n_eval_fwd} eval "
              f"forwards, launches {launches} (expected {want}), B2 routes {routes}", flush=True)
        if launches != want:
            raise AssertionError(f"kernel launches {launches} != {want}")
        if routes != {"simt": 0, "wgmma": want["conv3x3"], "tf32x3": 0}:
            raise AssertionError(f"B2 routes {routes}: every launch must be wgmma")
        for step, terms in a["logged"]:
            if not all(np.isfinite(v) for v in terms.values()) or terms["skipped_nonfinite"]:
                raise AssertionError(f"step {step}: terms {terms}")
        first, last = a["logged"][0][1], a["logged"][-1][1]
        print(f"[train] loss {first['total']:.4f} -> {last['total']:.4f} over {n_steps} steps "
              f"(warmup lr), every term finite, none skipped", flush=True)
        metrics = {k: v for k, v in ev["summary"].items() if k.endswith("_mm")}
        if not all(np.isfinite(v) for k, v in metrics.items() if not k.startswith("cdev")):
            raise AssertionError(f"eval summary not finite: {metrics}")
        print(f"[train] eval at epoch {cut_epoch} (step {ev['step']}) of the "
              f"{ev['summary']['num_samples']}-sample held-out split at batch "
              f"{cfg.train.batch_size}: {ev['seconds']:.2f} s (the overlays not included); "
              + ", ".join(f"{k} {v:.2f}" for k, v in metrics.items()), flush=True)
        taken = torch.load(f"{root}/straight/epoch_{cut_epoch}/state.pt", weights_only=True,
                           map_location="cpu").get("steps_taken")
        if taken != cut_epoch * spe:
            raise AssertionError(f"epoch_{cut_epoch} holds steps_taken {taken}, "
                                 f"expected {cut_epoch * spe}")

        # The run's epoch_<cut> checkpoint in a directory of its own, then
        # --resume auto there to the last step: its terms and final state
        # against the uninterrupted run's; then the same with the
        # checkpoint's optimizer state dropped, which the check must see.
        cut, step0 = f"epoch_{cut_epoch}", cut_epoch * spe

        def resume(name: str, drop_moments: bool = False) -> tuple:
            shutil.copytree(f"{root}/straight/_synth_data", f"{root}/{name}/_synth_data")
            shutil.copytree(f"{root}/straight/{cut}", f"{root}/{name}/{cut}")
            if drop_moments:
                blob = torch.load(f"{root}/{name}/{cut}/state.pt", weights_only=True)
                blob["optimizer"]["state"] = {}
                torch.save(blob, f"{root}/{name}/{cut}/state.pt")
            out = train_app.main(["--cfg", yaml(root, name), *common, "--resume", "auto"])
            if out["logged"][0][0] != step0 + 1 or out["final_step"] != n_steps:
                raise AssertionError(f"the resumed run did not continue at step {step0 + 1}")
            ref = dict(a["logged"])[step0 + 1]
            terms = max(abs(out["logged"][0][1][k] - v) / max(abs(v), 1e-12)
                        for k, v in ref.items())
            return terms, _state_gap(a["checkpoint"], out["checkpoint"], f"{root}/straight/{cut}")

        diff, gap = resume("resumed")
        _, fault = resume("dropped_moments", drop_moments=True)
        within = lambda g: (g["steps_equal"] and g["params"] <= RESUME_TOL
                            and g["moments"] <= RESUME_TOL and g["bn"] <= RESUME_TOL)
        show = lambda g: (f"parameters {g['params']:.3e} of the step's largest move, moments "
                          f"{g['moments']:.3e}, BatchNorm statistics {g['bn']:.3e}, steps "
                          f"{'equal' if g['steps_equal'] else 'differ'}")
        print(f"[train] --resume auto from {cut} (step {step0}) to step {n_steps}: terms vs the "
              f"uninterrupted run rel max|Δ| {diff:.3e} (limit 1e-4); final state: {show(gap)} "
              f"(limit {RESUME_TOL:g}); planted fault, the checkpoint's optimizer state "
              f"dropped: {show(fault)}", flush=True)
        if not (diff <= 1e-4 and within(gap)):
            raise AssertionError("the resumed run left the uninterrupted one")
        if fault["params"] <= RESUME_TOL or fault["moments"] <= RESUME_TOL:
            raise AssertionError("the resume check did not see a checkpoint without its moments")

        ips = a["images_per_s"]
        steady = a["step_seconds"][train_app.WARMUP_STEPS:]
        print(f"[train] flagship training bf16 encoder + f32 decoder, batch "
              f"{cfg.train.batch_size}: {ips:.1f} images/s, {1e3 * np.median(steady):.1f} ms a step "
              f"(median of steps {train_app.WARMUP_STEPS + 1}-{n_steps}; each step ends at its "
              f"NaN-guard sync) on {gpu_line}", flush=True)

        losses, state, step, batch = _fixed_batch_run(cfg, assets, f"{root}/straight", "train")
        result = dict(steps=n_steps, launches=launches, launches_per_step=per_step,
                      routes=routes, images_per_s=ips, eval_summary=ev["summary"],
                      eval_seconds=ev["seconds"],
                      step_ms=1e3 * float(np.median(steady)), step_seconds=a["step_seconds"],
                      loss_first=first["total"], loss_last=last["total"],
                      resume_terms_rel=diff, resume_state=gap, resume_fault=fault,
                      fixed_batch_losses=losses)
        if profile:
            result["profile"] = profile_phase(
                f"one training step at batch {cfg.train.batch_size}",
                lambda: float(step(state, batch)["total"]))
    del state, batch
    torch.cuda.empty_cache()
    return result


def _fixed_batch_run(cfg, assets, run_dir: str, tag: str) -> tuple:
    """`FIXED_BATCH_STEPS` AdamW steps (lr 1e-3, no warmup) of `cfg` from
    seed-0 weights on the first batch of the synthetic split an `apps.train`
    run left in `run_dir`: the loss must be finite and fall. Returns (losses,
    state, step, batch), the last three for a profile of one more step."""
    import copy

    import numpy as np
    import torch

    from renderih_tpu_torch.data.interhand import PackedInterHand
    from renderih_tpu_torch.data.pipeline import device_augment
    from renderih_tpu_torch.models import init_model
    from renderih_tpu_torch.train.state import create_train_state
    from renderih_tpu_torch.train.trainer import make_train_step

    fcfg = copy.deepcopy(cfg)
    fcfg.train.warmup_epochs, fcfg.train.lr = 0, 1e-3
    data = PackedInterHand.load(f"{run_dir}/_synth_data", "train")
    raw = {k: torch.from_numpy(v).to(DEVICE)
           for k, v in data.batch(np.arange(cfg.train.batch_size)).items()}
    batch = device_augment(raw, torch.Generator(device=DEVICE).manual_seed(0),
                           img_size=cfg.model.img_size)
    model = init_model(fcfg, assets, torch.Generator().manual_seed(0))
    state = create_train_state(fcfg, model.to(DEVICE, memory_format=torch.channels_last),
                               steps_per_epoch=1000)
    step = make_train_step(fcfg, assets, 1000, DEVICE)
    losses = [float(step(state, batch, torch.Generator(device=DEVICE).manual_seed(1))["total"])
              for _ in range(FIXED_BATCH_STEPS)]
    print(f"[{tag}] {FIXED_BATCH_STEPS} AdamW steps (lr 1e-3, no warmup) on one fixed batch: "
          f"loss {' '.join(f'{v:.2f}' for v in losses)}", flush=True)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{tag}: loss did not fall on a fixed batch: {losses}")
    return losses, state, step, batch


def f32_train_phase(assets, gpu_line: str, profile: bool = False) -> dict:
    """The upstream recipe's precision at full width (see the module
    docstring, phase 28): B2's forward and dx in float32 at the recipe's
    batch, `apps.train` on `F32_YAML`, the fixed-batch check, an f32 engine
    on it, and `F32_SIMT_ENCODER` served in f32 (B2's `simt` route)."""
    import copy
    import tempfile

    import numpy as np
    import torch

    from renderih_tpu_torch.apps import train as train_app
    from renderih_tpu_torch.config import load_config
    from renderih_tpu_torch.kernels import _build

    cfg = load_config(F32_YAML)
    batch = cfg.train.batch_size
    per_step = 2 * per_forward(cfg, assets)["conv3x3"]  # 13 forward + 13 dx
    bwd = conv_backward_phase(cfg, assets, batch=batch, dtypes=("float32",), seed=28)
    b2_ms = sum((r["fwd_ms"] + r["dx_ms"]) * r["launches_per_step"] / 2 for r in bwd)
    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)  # build/, git-ignored
    # stock convolutions in TF32 as PyTorch has it by default (what a user
    # of apps.train gets); B2 stays at float32 accuracy
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as root, _tf32_defaults():
        yaml = _train_yaml(cfg, root, "f32", log_every=1, eval_every=1000, save_gap=1000)
        for counter in _counters():
            counter.reset()
        run = train_app.main(["--cfg", yaml, "--synthetic", "--synth_n", str(TRAIN_SYNTH_N),
                              "--steps", str(F32_TRAIN_STEPS), "--device", DEVICE])
        launches = _launches()
        n_steps = run["final_step"]
        want = {"conv3x3": per_step * n_steps, "fused_mha": 0, "sdf_grid": 0}
        _check_run_launches("f32 training", launches, want,
                            routes={"simt": 0, "wgmma": 0, "tf32x3": want["conv3x3"]})
        for step_i, terms in run["logged"]:
            if not all(np.isfinite(v) for v in terms.values()) or terms["skipped_nonfinite"]:
                raise AssertionError(f"f32 training step {step_i}: terms {terms}")
        first, last = run["logged"][0][1], run["logged"][-1][1]
        step_ms = 1e3 * float(np.median(run["step_seconds"][train_app.WARMUP_STEPS:]))
        print(f"[f32-train] apps.train --cfg {F32_YAML} --synthetic --synth_n {TRAIN_SYNTH_N} "
              f"--steps {F32_TRAIN_STEPS} ({cfg.model.encoder}, {cfg.train.precision}, batch "
              f"{batch}; stock convolutions in TF32, PyTorch's default): {n_steps} steps, "
              f"launches {launches} ({per_step} B2 a step, all on tf32x3, no B1); every term "
              f"finite (total {first['total']:.4f} -> {last['total']:.4f}); "
              f"{run['images_per_s']:.1f} images/s, {step_ms:.1f} ms a step (median of steps "
              f"{train_app.WARMUP_STEPS + 1}-{n_steps}); B2 {b2_ms:.2f} ms of device time a step "
              f"(CUDA graphs, the rows above) = {100 * b2_ms / step_ms:.1f}% of it, on "
              f"{gpu_line}", flush=True)
        losses, state, step, fixed = _fixed_batch_run(cfg, assets, f"{root}/f32", "f32-train")
        result = dict(steps=n_steps, launches=launches, routes=_routes(),
                      images_per_s=run["images_per_s"], step_ms=step_ms, b2_step_ms=b2_ms,
                      b2_share=b2_ms / step_ms, first=first, last=last,
                      fixed_batch_losses=losses, conv_backward=bwd)
        if profile:
            result["profile"] = profile_phase(f"one f32 training step at batch {batch}",
                                              lambda: float(step(state, fixed)["total"]))
        del state, step, fixed
    torch.cuda.empty_cache()
    # serving in f32 (TF32 off: the engine's kernels are held against cuDNN)
    result["serve"] = serve_phase(cfg, assets, gpu_line, "f32-serve", buckets=(BATCH,))
    w18 = copy.deepcopy(cfg)
    w18.model.encoder = F32_SIMT_ENCODER
    result["simt_rows"] = kernel_phase(w18, assets, skip={"fused_mha": set(shape_counts(
        cfg, assets, "fused_mha"))}, label=F32_SIMT_ENCODER, dtypes=("float32",))["conv3x3"]
    result["simt_serve"] = serve_phase(w18, assets, gpu_line, f"{F32_SIMT_ENCODER}-f32-serve",
                                       buckets=(BATCH,))
    return result


def _two_d_weight_off(cfg) -> str:
    cfg.loss.label_2d *= 1.1
    return "the 2-D term's weight 10% off"


def train_parity_phase(cfg, assets, seeds=TRAIN_PARITY_SEEDS, tag="train-parity",
                       plant=_two_d_weight_off, make_batch=None) -> list:
    """Card against CPU: one SGD step of `cfg` in f32, the CPU on the
    card's branches (see the module docstring, phases 9 and 13), at each
    (init, batch) seed pair; `plant` puts a fault into a copy of the
    config, which must land outside the limits at the first pair;
    `make_batch(seed)` makes a batch (default: `synthetic_batch`)."""
    import contextlib
    import copy

    import torch

    from renderih_tpu_torch.data.synthetic import synthetic_batch
    from renderih_tpu_torch.models import init_model
    from renderih_tpu_torch.models.layers import BatchNorm2d
    from renderih_tpu_torch.train.state import create_train_state
    from renderih_tpu_torch.train.trainer import make_train_step
    from renderih_tpu_torch.utils.branches import gradient_gaps, record_branches, take_branches

    pcfg = copy.deepcopy(cfg)
    pcfg.train.optimizer, pcfg.train.precision, pcfg.train.lr = "sgd", "f32", 1.0
    pcfg.train.warmup_epochs, pcfg.model.dropout = 0, 0.0
    fault = copy.deepcopy(pcfg)
    fault_name = plant(fault)
    if make_batch is None:
        make_batch = lambda seed: synthetic_batch(
            assets, torch.Generator().manual_seed(seed), PARITY_BATCH, cfg.model.img_size)

    def step(run_cfg, dev, init_seed, batch, branches):
        model = init_model(run_cfg, assets, torch.Generator().manual_seed(init_seed))
        with torch.no_grad():
            for mod in model.encoder.modules():
                if isinstance(mod, BatchNorm2d):
                    mod.bias += BN_BIAS_SHIFT
        model = model.to(dev, memory_format=torch.channels_last)
        state = create_train_state(run_cfg, model, 10)
        with branches as taken:
            terms = make_train_step(run_cfg, assets, 10, dev)(
                state, {k: v.to(dev) for k, v in batch.items()})
        return dict(terms={k: float(v) for k, v in terms.items()},
                    grads={k: p.grad.cpu() for k, p in model.named_parameters()
                           if p.grad is not None},
                    bn={k: v.cpu() for k, v in model.state_dict().items()
                        if k.endswith(("running_mean", "running_var"))}), taken

    def share(gaps):
        return {t: sum(e <= t for e in gaps.values()) / len(gaps)
                for t in (1e-4, 1e-3, 3e-3, 1e-2)}

    def line(gaps):
        worst = sorted(gaps, key=gaps.get, reverse=True)[:3]
        sh = share(gaps)
        return (f"worst {', '.join(f'{gaps[k]:.2e} ({k})' for k in worst)}; of {len(gaps)} "
                f"tensors {100 * sh[1e-4]:.1f}% within 1e-4, {100 * sh[1e-3]:.1f}% within "
                f"1e-3, {100 * sh[3e-3]:.1f}% within 3e-3, {100 * sh[1e-2]:.1f}% within 1e-2")

    def within(gaps):
        return max(gaps.values()) <= GRAD_TOL[0] and share(gaps)[GRAD_TOL[1]] >= GRAD_TOL[2]

    rows, ok = [], True
    for init_seed, batch_seed in seeds:
        with torch.no_grad():
            batch = make_batch(batch_seed)
        before = _routes()
        card, taken = step(pcfg, DEVICE, init_seed, batch, record_branches())
        b2 = _check_f32_routes(f"{tag} card step", before,
                               per_forward(pcfg, assets)["conv3x3"] > 0)
        cpu, _ = step(pcfg, "cpu", init_seed, batch, take_branches(taken))
        if card["grads"].keys() != cpu["grads"].keys():
            raise AssertionError("card and CPU trained different parameters")
        term_err = max(abs(card["terms"][k] - v) / max(abs(v), 1e-12)
                       for k, v in cpu["terms"].items())
        gaps = gradient_gaps(card["grads"], cpu["grads"])
        bn_err = max((float((card["bn"][k] - v).abs().max() / v.abs().max())
                      for k, v in cpu["bn"].items()), default=0.0)  # none in a ViT
        row = dict(init_seed=init_seed, batch_seed=batch_seed, branches=len(taken),
                   terms_rel=term_err, grad_rel=gaps, grad_share=share(gaps), bn_rel=bn_err)
        print(f"[{tag}] one SGD step, {cfg.model.encoder} at {cfg.model.img_size}² (aux heads "
              f"{'on' if cfg.model.with_aux_heads else 'off'}, decoder {cfg.model.decoder}) in "
              f"f32, TF32 off, dropout 0, batch "
              f"{PARITY_BATCH} ({b2} B2 launches on the card, all tf32x3), init_model seed "
              f"{init_seed}"
              + (f" with the encoder's BatchNorm biases +{BN_BIAS_SHIFT:g}" if cpu["bn"] else "")
              + f", batch seed {batch_seed}, the CPU "
              f"on the card's branches ({len(taken)} ReLU, max-pool and hard-swish calls): loss terms rel "
              f"max|Δ| {term_err:.2e} (limit 1e-4); gradients, max|Δ| over each tensor's "
              f"scale: {line(gaps)} (limits: every tensor {GRAD_TOL[0]:g}, "
              f"{100 * GRAD_TOL[2]:g}% within {GRAD_TOL[1]:g}); BatchNorm statistics "
              f"{bn_err:.2e} (limit 1e-5)", flush=True)
        ok &= term_err <= 1e-4 and within(gaps) and bn_err <= 1e-5
        free, _ = step(pcfg, "cpu", init_seed, batch, contextlib.nullcontext())
        free_gaps = gradient_gaps(card["grads"], free["grads"])
        print(f"[{tag}] the same, the CPU on its own branches (not held): "
              f"{line(free_gaps)}", flush=True)
        row.update(free_grad_rel=max(free_gaps.values()), free_share=share(free_gaps))
        del free
        if not rows:  # a planted fault on the same branches must land outside
            wrong, _ = step(fault, "cpu", init_seed, batch, take_branches(taken))
            fault_gaps = gradient_gaps(wrong["grads"], cpu["grads"])
            print(f"[{tag}] planted fault, {fault_name}, on the CPU: "
                  f"{line(fault_gaps)}", flush=True)
            row.update(fault_grad_rel=max(fault_gaps.values()), fault_share=share(fault_gaps))
            if within(fault_gaps):
                raise AssertionError("the gradient limits do not see a planted fault")
        rows.append(row)
        del card, cpu, taken
        torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("card and CPU training steps disagree")
    return rows


def _contact_split(root: str, assets, n: int, seed: int):
    """A synthetic packed split whose samples 0-4 have the right hand moved
    onto the left (ground-truth contact, so CDev is a number there)."""
    import numpy as np

    from renderih_tpu_torch.data.interhand import PackedInterHand, make_synthetic_packed

    make_synthetic_packed(root, "test", assets, n=n, seed=seed)
    labels = dict(np.load(f"{root}/test_labels.npz"))
    rng = np.random.default_rng(seed)
    labels["v3d_right"][:5] = (labels["v3d_left"][:5] + [0.002, 0.0, 0.0]
                               + rng.normal(0, 0.001, (5, 778, 3))).astype(np.float32)
    np.savez(f"{root}/test_labels.npz", **labels)
    return PackedInterHand.load(root, "test")


def eval_phase(cfg, assets, gpu_line: str, profile: bool = False) -> dict:
    """The eval path on the card (see the module docstring, phase 10)."""
    import copy
    import tempfile

    import numpy as np
    import torch

    from renderih_tpu_torch.apps import eval_interhand
    from renderih_tpu_torch.data.interhand import make_synthetic_packed
    from renderih_tpu_torch.eval.evaluator import (
        eval_mode,
        evaluate_packed,
        evaluate_vectors,
        make_eval_fn,
    )
    from renderih_tpu_torch.eval.metrics import two_hand_metrics
    from renderih_tpu_torch.kernels import _build, conv3x3, fused_attention, sdf
    from renderih_tpu_torch.models import HandNet, init_model, model_call_kwargs
    from renderih_tpu_torch.ops.image import normalize_imagenet

    dev = torch.device(DEVICE)
    counters = (conv3x3.launches, fused_attention.launches, sdf.launches,
                *conv3x3.routes.values())
    per_fwd = dict(per_forward(cfg, assets), sdf_grid=0)  # 13 B2, 24 B1

    def counted(fn):
        """fn()'s result, the forwards of a `HandNet` it ran and its kernel
        launches, which must be per_fwd a forward with every B2 on wgmma."""
        forwards = [0]
        hook = torch.nn.modules.module.register_module_forward_pre_hook(
            lambda mod, args: forwards.__setitem__(0, forwards[0] + isinstance(mod, HandNet)))
        for counter in counters:
            counter.reset()
        try:
            out = fn()
        finally:
            hook.remove()
        launches = {"conv3x3": conv3x3.launches.value,
                    "fused_mha": fused_attention.launches.value, "sdf_grid": sdf.launches.value}
        want = {k: n * forwards[0] for k, n in per_fwd.items()}
        if forwards[0] == 0 or launches != want or _routes() != {
                "simt": 0, "wgmma": want["conv3x3"], "tf32x3": 0}:
            raise AssertionError(f"{forwards[0]} forwards: launches {launches}, B2 routes "
                                 f"{_routes()}; expected {want}, all B2 on wgmma")
        return out, forwards[0], launches

    held = {}
    for seed, batch in enumerate((EVAL_BATCH, EVAL_CLI_BATCH)):
        held[batch] = hold_path_kernels(cfg, assets, batch, seed=10 + seed)
        print(f"[eval] the path's kernels at batch {batch} against their plain versions, "
              f"every shape of a forward: B2 bfloat16 (wgmma) max|Δ| "
              f"{held[batch]['conv3x3']:.3e} (atol/rtol {CONV_TOL['bfloat16']}), B1 float32 "
              f"max|Δ| {held[batch]['fused_mha']:.3e} (atol/rtol {MHA_TOL})", flush=True)

    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)  # build/, git-ignored
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as root:
        t0 = time.perf_counter()
        data = make_synthetic_packed(f"{root}/split", "test", assets, n=EVAL_N, seed=0)
        make_s = time.perf_counter() - t0
        model = init_model(cfg, assets, torch.Generator().manual_seed(0))
        model = model.to(dev, memory_format=torch.channels_last)
        summary, n_fwd, launches = counted(lambda: evaluate_packed(
            cfg, model, assets, data, batch_size=EVAL_BATCH, device=dev))
        if not summary["device_cache"] or n_fwd != -(-EVAL_N // EVAL_BATCH):
            raise AssertionError(f"device cache {summary['device_cache']}, {n_fwd} forwards")
        metrics = {k: v for k, v in summary.items() if k.endswith("_mm")}
        if not all(np.isfinite(v) for k, v in metrics.items() if not k.startswith("cdev")):
            raise AssertionError(f"eval summary not finite: {metrics}")
        print(f"[eval] evaluate_packed, Config() seed-0 weights, {EVAL_N} synthetic images "
              f"(written in {make_s:.1f} s) at batch {EVAL_BATCH}: {n_fwd} forwards, launches "
              f"{launches}, B2 all wgmma; {summary['images_per_sec']:.1f} images/s (batches "
              f"after the first), device cache upload {summary['cache_upload_s']:.3f} s; "
              + ", ".join(f"{k} {v:.2f}" for k, v in metrics.items())
              + f" on {gpu_line}", flush=True)

        # one batch: forward and metrics timed apart; the metrics with TF32
        # allowed must be bit-equal (no matmul in them)
        img_u8, v3l, v3r = (torch.from_numpy(data.batch(np.arange(EVAL_BATCH))[k]).to(dev)
                            for k in ("img_u8", "v3d_left", "v3d_right"))
        kw = model_call_kwargs(assets, dev)
        j_reg = {h: getattr(assets, h).j_reg_21.to(dev) for h in ("left", "right")}
        with eval_mode(model):
            img = normalize_imagenet(img_u8.float() / 255.0)
            verts = model(img, **kw).verts3d
            metric = lambda: two_hand_metrics(verts, {"left": v3l, "right": v3r}, j_reg)
            fwd_ms = _time_ms(lambda: model(img, **kw), iters=5, warmup=1)
            met_ms = _time_ms(metric, iters=5, warmup=1)
            strict = metric()
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                loose = metric()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        same = lambda a, b: bool(((a == b) | (a.isnan() & b.isnan())).all())
        if not all(same(strict[k], loose[k]) for k in strict):
            raise AssertionError("the eval metrics move with TF32: a matmul is in them")
        print(f"[eval] one batch of {EVAL_BATCH}: forward {fwd_ms:.2f} ms, metrics "
              f"{met_ms:.2f} ms ({100 * met_ms / (fwd_ms + met_ms):.1f}% of the batch; CUDA "
              f"events, 5 calls); metrics bit-equal with TF32 allowed", flush=True)
        result = dict(held=held, summary=summary, forwards=n_fwd, launches=launches,
                      make_s=make_s,
                      forward_ms=fwd_ms, metrics_ms=met_ms,
                      metrics_share=met_ms / (fwd_ms + met_ms))
        if profile:
            fn = make_eval_fn(model, assets, dev)
            with eval_mode(model):
                result["profile"] = profile_phase(
                    f"one eval batch of {EVAL_BATCH} (forward and metrics)",
                    lambda: float(fn(img_u8, v3l, v3r)["mpjpe_left"].sum()))
        del model, img_u8, v3l, v3r, img, verts, strict, loose
        torch.cuda.empty_cache()

        # card against CPU, f32, TF32 off
        cfg32 = copy.deepcopy(cfg)
        cfg32.train.precision = "f32"
        small = _contact_split(f"{root}/parity", assets, EVAL_PARITY_N, seed=3)
        vec = {}
        before = _routes()
        for d in (DEVICE, "cpu"):
            m = init_model(cfg32, assets, torch.Generator().manual_seed(0))
            m = m.to(d, memory_format=torch.channels_last)
            vec[d], _ = evaluate_vectors(cfg32, m, assets, small, batch_size=EVAL_PARITY_BATCH,
                                         device=d)
            if d == DEVICE:
                b2 = _check_f32_routes("eval-parity", before)
                with eval_mode(m):
                    out = m(normalize_imagenet(torch.from_numpy(np.array(small.images)).to(d)
                                               .float() / 255.0), **model_call_kwargs(assets, d))
                scale = max(float(v.abs().max()) for v in out.verts3d.values())
            del m
        errs = {}
        for k, ref in vec["cpu"].items():
            got = vec[DEVICE][k]
            if not np.array_equal(np.isnan(got), np.isnan(ref)):
                raise AssertionError(f"{k}: NaN pattern card {np.isnan(got)} vs CPU {np.isnan(ref)}")
            ok = ~np.isnan(ref)
            errs[k] = float(np.abs(got[ok] - ref[ok]).max(initial=0.0))
        worst = max(errs, key=errs.get)
        n_contact = int(np.isfinite(vec["cpu"]["cdev"]).sum())
        print(f"[eval-parity] f32, TF32 off, {EVAL_PARITY_N} images at batch "
              f"{EVAL_PARITY_BATCH} ({b2} B2 launches on the card, all tf32x3): card vs CPU "
              f"per-sample metrics, worst {worst} "
              f"{errs[worst]:.3e} m (limit {EVAL_RTOL:g}·max|verts3d| = "
              f"{EVAL_RTOL * scale:.3e}); cdev NaN pattern equal ({n_contact} samples in "
              f"contact)", flush=True)
        if errs[worst] > EVAL_RTOL * scale or n_contact < 5:
            raise AssertionError("card and CPU eval metrics disagree")
        result.update(parity_errs=errs, parity_limit=EVAL_RTOL * scale)

        # the CLI once
        t0 = time.perf_counter()
        cli, cli_fwd, cli_launches = counted(lambda: eval_interhand.main(
            ["--synthetic", "--bs", str(EVAL_CLI_BATCH), "--json"]))
        if cli_fwd != 256 // EVAL_CLI_BATCH or not np.isfinite(cli["mpjpe_mm"]):
            raise AssertionError(f"eval_interhand: {cli_fwd} forwards, mpjpe {cli['mpjpe_mm']}")
        print(f"[eval] apps.eval_interhand --synthetic --bs {EVAL_CLI_BATCH} --json: {cli_fwd} "
              f"forwards, "
              f"launches {cli_launches}, B2 all wgmma, mpjpe {cli['mpjpe_mm']:.2f} mm, "
              f"{cli['images_per_sec']:.1f} images/s, {time.perf_counter() - t0:.1f} s in all",
              flush=True)
        result.update(cli=cli, cli_launches=cli_launches)
    torch.cuda.empty_cache()
    return result


def _official_tree(root: str, n: int, seed: int) -> str:
    """A fake official InterHand2.6M release (`tests/test_interhand_gen.py`'s
    layout) of `n` interacting frames at 480x640, noise PNGs, with the
    synthetic MANO's npz files; returns the split name."""
    import json
    import os

    import numpy as np

    from renderih_tpu_torch.data.image_io import png_bytes
    from renderih_tpu_torch.mano.params import MANO_PARENTS, make_synthetic_mano

    split, rng = "train", np.random.default_rng(seed)
    ann_dir = os.path.join(root, "annotations", split)
    os.makedirs(ann_dir)
    images, annotations, mano = [], [], {}
    for i in range(n):
        cap, frame = i % 4, 100 + i
        fname = f"Capture{cap}/cam400002/image{frame}.png"
        path = os.path.join(root, "images", split, fname)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(png_bytes(rng.integers(0, 255, (480, 640, 3), np.uint8)))
        images.append({"id": i, "file_name": fname, "width": 640, "height": 480,
                       "capture": cap, "camera": 400002, "frame_idx": frame})
        annotations.append({"id": 10 * i, "image_id": i, "hand_type": "interacting"})
        mano.setdefault(str(cap), {})[str(frame)] = {
            hand: {"pose": rng.normal(0.0, 0.15, 48).tolist(),
                   "shape": rng.normal(0.0, 0.5, 10).tolist(),
                   "trans": [float(rng.normal(0.0, 0.01)), float(rng.normal(0.0, 0.01)), dz]}
            for hand, dz in (("right", 0.02), ("left", -0.02))}
    cam = {"campos": {"400002": [0.0, 0.0, -600.0]}, "camrot": {"400002": np.eye(3).tolist()},
           "focal": {"400002": [500.0, 500.0]}, "princpt": {"400002": [320.0, 240.0]}}
    for name, obj in (("data", {"images": images, "annotations": annotations}),
                      ("camera", {str(c): cam for c in range(4)}),
                      ("MANO_NeuralAnnot", mano)):
        with open(os.path.join(ann_dir, f"InterHand2.6M_{split}_{name}.json"), "w") as f:
            json.dump(obj, f)
    for hand in ("left", "right"):
        m = make_synthetic_mano(seed=0, is_right=hand == "right")
        np.savez(os.path.join(root, f"mano_{hand}.npz"),
                 **{k: getattr(m, k).numpy() for k in (
                     "v_template", "shapedirs", "posedirs", "J_regressor", "weights",
                     "hands_components", "hands_mean")},
                 faces=m.faces.numpy().astype(np.int32),
                 kintree_parents=np.asarray(MANO_PARENTS, np.int32),
                 is_right=np.asarray(hand == "right"))
    return split


def dataset_tools_phase(cfg, assets, gpu_line: str) -> dict:
    """The dataset tools on the card machine (see the module docstring,
    phase 22)."""
    import glob
    import os
    import tempfile

    import numpy as np
    import torch

    from renderih_tpu_torch.apps import eval_interhand
    from renderih_tpu_torch.apps import train as train_app
    from renderih_tpu_torch.data.image_io import imread_rgb
    from renderih_tpu_torch.data.interhand import PackedInterHand
    from renderih_tpu_torch.kernels import _build
    from renderih_tpu_torch.mano import ik
    from renderih_tpu_torch.mano.layer import mano_forward
    from renderih_tpu_torch.mano.params import make_synthetic_mano, to_device
    from renderih_tpu_torch.models import HandNet
    from renderih_tpu_torch.ops.rotation import rodrigues
    from renderih_tpu_torch.tools.dataset_gen import handdict_gen, interhand_gen

    result = {}
    # (a) the committed JPEGs against cv2's stored decode, and the rate
    paths = sorted(glob.glob(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                          "tests", "data", "torch_codec", "*.jpg")))
    if len(paths) < 6:
        raise AssertionError(f"codec fixtures missing: {paths}")
    for path in paths:
        if not np.array_equal(imread_rgb(path), np.load(path[:-4] + ".npz")["rgb"]):
            raise AssertionError(f"imread_rgb({path}) differs from cv2's decode")
    n_bytes = sum(os.path.getsize(p) for p in paths)
    n_px = sum(np.load(p[:-4] + ".npz")["rgb"].shape[0] * np.load(p[:-4] + ".npz")["rgb"]
               .shape[1] for p in paths)
    reps, t0 = 20, time.perf_counter()
    for _ in range(reps):
        for path in paths:
            imread_rgb(path)
    dt = (time.perf_counter() - t0) / reps
    result["decode"] = dict(files=len(paths), mb_per_s=n_bytes / dt / 1e6, mpx_per_s=n_px / dt / 1e6)
    print(f"[data] (a) imread_rgb on {len(paths)} committed JPEGs ({n_bytes / 1e3:.1f} kB; "
          f"4:2:0, 4:2:2, 4:4:4, grey, restart markers): bit for bit the stored cv2 decode; "
          f"{result['decode']['mb_per_s']:.1f} MB/s compressed, "
          f"{result['decode']['mpx_per_s']:.1f} Mpx/s (one host thread)", flush=True)

    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)  # build/, git-ignored
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as root:
        # (b) the official tree packed on the card and on the CPU
        tree = os.path.join(root, "official")
        split = _official_tree(tree, DATA_FRAMES, seed=22)
        argv = ["--data", tree, "--split", split, "--mano-left", f"{tree}/mano_left.npz",
                "--mano-right", f"{tree}/mano_right.npz"]
        packed, seconds = {}, {}
        for dev in (DEVICE, "cpu"):
            out = os.path.join(root, f"packed_{dev}")
            t0 = time.perf_counter()
            if interhand_gen.main(argv + ["--out", out, "--device", dev]) != DATA_FRAMES:
                raise AssertionError(f"interhand_gen on {dev} packed the wrong frame count")
            seconds[dev], packed[dev] = time.perf_counter() - t0, out
        card, cpu = (PackedInterHand.load(packed[d], split, use_native=False)
                     for d in (DEVICE, "cpu"))
        if not np.array_equal(np.asarray(card.images), np.asarray(cpu.images)):
            diff = np.abs(np.asarray(card.images, np.int16) - np.asarray(cpu.images))
            raise AssertionError(f"card and CPU packs differ: max {diff.max()} on "
                                 f"{(diff > 0).mean():.2e} of bytes")
        gaps = {}
        for k, ref in cpu.labels.items():
            scale = max(float(np.abs(ref).max()), 1e-30)
            gaps[k] = float(np.abs(card.labels[k].astype(np.float64) - ref).max()) / scale
            if gaps[k] > DATA_LABEL_RTOL.get(k.split("_")[0], 1e-5):
                raise AssertionError(f"{k}: card vs CPU {gaps[k]:.3e} of its largest |value|")
        if not np.asarray(card.images).any():
            raise AssertionError("interhand_gen cropped all-black images")
        worst = max(gaps, key=gaps.get)
        result["interhand_gen"] = dict(frames=DATA_FRAMES, seconds=seconds, label_gaps=gaps,
                                       frames_per_s={d: DATA_FRAMES / t for d, t in seconds.items()})
        print(f"[data] (b) interhand_gen, {DATA_FRAMES} interacting 480x640 frames: images "
              f"bit for bit card vs CPU; labels: worst {worst} {gaps[worst]:.3e} of its largest "
              f"|value|; {DATA_FRAMES / seconds[DEVICE]:.1f} frames/s with MANO on the card, "
              f"{DATA_FRAMES / seconds['cpu']:.1f} on the CPU (decode, MANO, crop; one host "
              f"thread) on {gpu_line}", flush=True)

        # (c) joints-only hands fitted on the card
        rng = np.random.default_rng(23)
        m_right = make_synthetic_mano(seed=0, is_right=True)
        n = DATA_IK_HANDS
        with torch.no_grad():
            root_r = rodrigues(torch.from_numpy(rng.normal(0, 0.5, (n, 3)).astype(np.float32)))
            _, j_gt = mano_forward(
                m_right, root_r, torch.from_numpy(rng.normal(0, 0.4, (n, 45)).astype(np.float32)),
                torch.from_numpy(rng.normal(0, 0.5, (n, 10)).astype(np.float32)),
                center_idx=None, use_pca=False)
        j_gt = j_gt.numpy() + rng.normal(0, 0.2, (n, 1, 3)).astype(np.float32)
        hd_dir = os.path.join(root, "handdict", "all")
        os.makedirs(hd_dir)
        for i in range(n):
            left = {"joints3d": rng.normal(0, 0.05, (21, 3)).astype(np.float32),
                    "verts3d": rng.normal(0, 0.05, (778, 3)).astype(np.float32)}
            np.save(os.path.join(hd_dir, f"{i}.npy"), {
                "img": rng.integers(0, 255, (64, 64, 3), np.uint8), "left": left,
                "right": {"joints3d": j_gt[i]}})
        fit_s = []

        def timed_fit(*a, **kw):
            t = time.perf_counter()
            handdict_gen_fit(*a, **kw)  # ends on the card's results, copied to the host
            fit_s.append(time.perf_counter() - t)

        handdict_gen_fit = handdict_gen.fit_joints_only
        handdict_gen.fit_joints_only = timed_fit
        try:
            hd_out = os.path.join(root, "handdict_packed")
            handdict_gen.main(["--data", os.path.join(root, "handdict"), "--split", "test",
                               "--out", hd_out, "--from_joints", "--ik_batch", str(n),
                               "--device", DEVICE])
        finally:
            handdict_gen.fit_joints_only = handdict_gen_fit
        lab = np.load(os.path.join(hd_out, "test_labels.npz"))
        dev = torch.device(DEVICE)
        with torch.no_grad():
            residual = ik._joint_residual(
                to_device(m_right, dev), torch.as_tensor(lab["pose_right"][:, :3], device=dev),
                torch.as_tensor(lab["pose_right"][:, 3:], device=dev),
                torch.as_tensor(lab["shape_right"], device=dev),
                torch.as_tensor(j_gt, device=dev)).cpu().numpy()
        if not (np.isfinite(residual).all() and residual.mean() < DATA_IK_MEAN_RESIDUAL
                and np.isfinite(lab["v3d_right"]).all() and lab["v3d_right"].any()):
            raise AssertionError(f"IK fit: mean joint residual {residual.mean():.3e}")
        result["ik"] = dict(hands=n, seconds=fit_s[0], hands_per_s=n / fit_s[0],
                            mean_residual=float(residual.mean()),
                            max_residual=float(residual.max()))
        print(f"[data] (c) handdict_gen --from_joints, {n} joints-only hands in one --ik_batch "
              f"{n} chunk, 200 IK steps on the card: mean joint residual "
              f"{1e3 * residual.mean():.3f} mm (max {1e3 * residual.max():.3f}; limit "
              f"{1e3 * DATA_IK_MEAN_RESIDUAL:g} mm) at template scale; {n / fit_s[0]:.1f} "
              f"hands/s ({fit_s[0]:.2f} s) on {gpu_line}", flush=True)

        # (d) the native reader against the memmap
        native = PackedInterHand.load(packed[DEVICE], split, use_native=True)
        if native.reader is None:
            raise AssertionError("use_native=True did not take the native reader")
        idx = np.random.default_rng(24).integers(0, DATA_FRAMES, 4 * DATA_BATCH)
        got, want = native.batch(idx), card.batch(idx)
        if not all(np.array_equal(got[k], want[k]) for k in want):
            raise AssertionError("the native reader's gather differs from the memmap's")
        t0 = time.perf_counter()
        for _ in range(20):
            native.batch(idx)
        gather_ms = (time.perf_counter() - t0) / 20 * 1e3
        result["native_gather_ms"] = gather_ms
        print(f"[data] (d) PackedInterHand.load(use_native=True): {len(idx)} random samples "
              f"gathered through csrc/packed_reader.cpp equal the memmap's; {gather_ms:.2f} ms a "
              f"gather", flush=True)

        # (e) training on the packed split
        per_fwd = per_forward(cfg, assets)
        yaml = _train_yaml(cfg, root, "data22", batch_size=DATA_BATCH, log_every=1,
                           eval_every=1000, save_gap=1000)
        for counter in _counters():
            counter.reset()
        run = train_app.main(["--cfg", yaml, "--data", packed[DEVICE], "--steps",
                              str(DATA_STEPS), "--device", DEVICE])
        launches = _launches()
        want = {"conv3x3": 2 * per_fwd["conv3x3"] * run["final_step"], "fused_mha": 0,
                "sdf_grid": 0}
        if run["final_step"] != DATA_STEPS:
            raise AssertionError(f"apps.train took {run['final_step']} steps")
        _check_run_launches("dataset-tools training", launches, want)
        for step, terms in run["logged"]:
            if not all(np.isfinite(v) for v in terms.values()) or terms["skipped_nonfinite"]:
                raise AssertionError(f"dataset-tools training step {step}: terms {terms}")
        result["train"] = dict(steps=run["final_step"], launches=launches,
                               last=run["logged"][-1][1])
        print(f"[data] (e) apps.train --data (b)'s split, Config() at batch {DATA_BATCH}, "
              f"{DATA_STEPS} steps: launches {launches} ({2 * per_fwd['conv3x3']} B2 a step, "
              f"all on wgmma, no B1); every term finite (total "
              f"{run['logged'][-1][1]['total']:.4f} at step {run['logged'][-1][0]})", flush=True)

        # (f) evaluation of the packed split
        forwards = [0]
        hook = torch.nn.modules.module.register_module_forward_pre_hook(
            lambda mod, args: forwards.__setitem__(0, forwards[0] + isinstance(mod, HandNet)))
        for counter in _counters():
            counter.reset()
        try:
            summary = eval_interhand.main(["--cfg", yaml, "--data", packed[DEVICE], "--split",
                                           split, "--bs", str(DATA_BATCH), "--device", DEVICE,
                                           "--json"])
        finally:
            hook.remove()
        launches = _launches()
        want = {"conv3x3": per_fwd["conv3x3"] * forwards[0],
                "fused_mha": per_fwd["fused_mha"] * forwards[0], "sdf_grid": 0}
        if forwards[0] != DATA_FRAMES // DATA_BATCH:
            raise AssertionError(f"apps.eval_interhand ran {forwards[0]} forwards")
        _check_run_launches("dataset-tools eval", launches, want,
                            must_launch=("conv3x3", "fused_mha"))
        metrics = {k: v for k, v in summary.items() if k.endswith("_mm") and not
                   k.startswith("cdev")}
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"eval summary not finite: {metrics}")
        result["eval"] = dict(forwards=forwards[0], launches=launches, metrics=metrics)
        print(f"[data] (f) apps.eval_interhand --data (b)'s split --bs {DATA_BATCH}: "
              f"{forwards[0]} forwards, launches {launches} ({per_fwd['conv3x3']} B2, all on "
              f"wgmma, and {per_fwd['fused_mha']} B1 a forward); mpjpe "
              f"{summary['mpjpe_mm']:.2f} mm, every metric finite", flush=True)
        del card, cpu, native
    torch.cuda.empty_cache()
    return result


def _smooth_noise(rng, h: int, w: int):
    """A smooth colour pattern with a little noise, uint8 (h, w, 3): a
    stand-in for a photograph's compressibility."""
    import numpy as np

    y, x = np.mgrid[0:h, 0:w]
    f = rng.uniform(5.0, 40.0, 3)
    img = np.stack([128 + 90 * np.sin(x / f[k] + k) * np.cos(y / f[(k + 1) % 3]) for k in range(3)],
                   -1) + rng.normal(0.0, 8.0, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def corpus_phase(gpu_line: str) -> dict:
    """Background corpus and synthetic data on the card machine (see the
    module docstring, phase 23)."""
    import glob
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from renderih_tpu_torch.data.image_io import encode_jpeg, imread_rgb, imwrite, resize_area_u8
    from renderih_tpu_torch.kernels import _build
    from renderih_tpu_torch.render.backgrounds import BackgroundCorpus
    from renderih_tpu_torch.tools import synth_gen

    codec = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                         "torch_codec")
    # (a) cv2's INTER_AREA in its three regimes and cv2's BMP decodes
    areas = sorted(glob.glob(os.path.join(codec, "area_*.npz")))
    bmps = sorted(glob.glob(os.path.join(codec, "*.bmp")))
    if len(areas) < 4 or len(bmps) < 3:
        raise AssertionError(f"codec fixtures missing: {areas} {bmps}")
    for path in areas:
        f = np.load(path)
        if not np.array_equal(resize_area_u8(f["src"], f["out"].shape[1::-1]), f["out"]):
            raise AssertionError(f"resize_area_u8 differs from cv2's INTER_AREA ({path})")
    for path in bmps:
        if not np.array_equal(imread_rgb(path), np.load(path[:-4] + ".npz")["rgb"]):
            raise AssertionError(f"imread_rgb({path}) differs from cv2's decode")
    print(f"[corpus] (a) resize_area_u8 on {len(areas)} stored cv2 INTER_AREA results (integer "
          f"factor, area tables, upscaling) and imread_rgb on {len(bmps)} BMPs (8-bit palette, "
          f"24-bit, 32-bit top-down): bit for bit cv2's", flush=True)

    result = {}
    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)  # build/, git-ignored
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as root:
        # (b) the JPEG encoder against cv2's stored files
        enc = np.load(os.path.join(codec, "jpeg_encode.npz"))
        n_enc = len([k for k in enc.files if k.startswith("src_")])
        same_bytes = 0
        for i in range(n_enc):
            got, want = encode_jpeg(enc[f"src_{i}"]), enc[f"jpg_{i}"].tobytes()
            for name, data in (("port.jpg", got), ("cv2.jpg", want)):
                with open(os.path.join(root, name), "wb") as f:
                    f.write(data)
            if not np.array_equal(imread_rgb(os.path.join(root, "port.jpg")),
                                  imread_rgb(os.path.join(root, "cv2.jpg"))):
                raise AssertionError(f"imwrite's JPEG of source {i} decodes otherwise than "
                                     "cv2's file")
            same_bytes += got == want
        print(f"[corpus] (b) imwrite's JPEG of {n_enc} stored sources decodes bit for bit as "
              f"cv2's file of each; {same_bytes} of {n_enc} files equal byte for byte",
              flush=True)

        # (c) a corpus of CORPUS_IMAGES images written here, BMPs and one
        # unreadable file among them
        rng = np.random.default_rng(23)
        corpus_dir = os.path.join(root, "backgrounds")
        os.makedirs(corpus_dir)
        n_written = CORPUS_IMAGES - len(bmps)
        enc_s = enc_px = 0.0
        for i in range(n_written):
            h, w = (int(v) for v in rng.integers(120, 721, 2))
            img = _smooth_noise(rng, h, w)
            path = os.path.join(corpus_dir, f"bg{i:03d}.{'jpg' if i % 2 == 0 else 'png'}")
            t0 = time.perf_counter()
            imwrite(path, img)
            if i % 2 == 0:
                enc_s += time.perf_counter() - t0
                enc_px += h * w
        for path in bmps:
            shutil.copy(path, corpus_dir)
        with open(os.path.join(corpus_dir, "broken.jpg"), "w") as f:
            f.write("not an image")
        n_bytes = sum(os.path.getsize(os.path.join(corpus_dir, f)) for f in os.listdir(corpus_dir))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        corpus = BackgroundCorpus(corpus_dir, 256, device=DEVICE)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        cpu = BackgroundCorpus(corpus_dir, 256, device="cpu")
        if corpus.images.shape != (CORPUS_IMAGES, 256, 256, 3) or not torch.equal(
                corpus.images.cpu(), cpu.images):
            raise AssertionError(f"corpus on the card {tuple(corpus.images.shape)} differs from "
                                 "the CPU's")
        gen = torch.Generator().manual_seed(3)
        idx = torch.randint(0, CORPUS_IMAGES, (SYNTH_N,), generator=gen)
        flip = torch.rand((SYNTH_N,), generator=gen) < 0.5
        gain = torch.rand((SYNTH_N, 1, 1, 1), generator=gen) * 0.5 + 0.7
        dev = torch.device(DEVICE)
        if not torch.equal(corpus.transform(idx.to(dev), flip.to(dev), gain.to(dev)).cpu(),
                           cpu.transform(idx, flip, gain)):
            raise AssertionError("corpus sampling on the card differs from the CPU's")
        result["corpus"] = dict(images=CORPUS_IMAGES, files_mb=n_bytes / 1e6, load_s=load_s,
                                images_per_s=CORPUS_IMAGES / load_s,
                                mb_per_s=n_bytes / 1e6 / load_s,
                                jpeg_encode_mpx_per_s=enc_px / enc_s / 1e6)
        print(f"[corpus] (c) BackgroundCorpus of {CORPUS_IMAGES} images ({n_written} written "
              f"here by imwrite, JPEG and PNG, 120-720 px a side; the {len(bmps)} BMPs) and one "
              f"unreadable file, skipped: loaded in {load_s:.3f} s, "
              f"{CORPUS_IMAGES / load_s:.1f} images/s, {n_bytes / 1e6 / load_s:.1f} MB/s of "
              f"files (decode, centre crop, INTER_AREA to 256², upload; one host thread); the "
              f"stack and a sample on the card equal the CPU's; JPEG encode "
              f"{enc_px / enc_s / 1e6:.1f} Mpx/s (one host thread) on {gpu_line}", flush=True)

        # (d) synth_gen over the corpus, with the refinement
        per_sample = 4 * (2 * (SYNTH_ITERS // 4) + 2)
        out = os.path.join(root, "synth")
        for counter in _counters():
            counter.reset()
        stats = synth_gen.main(["--out", out, "--n", str(SYNTH_N), "--batch", str(SYNTH_N),
                                "--seed", "0", "--optimize", "--opt_iters", str(SYNTH_ITERS),
                                "--backgrounds", corpus_dir, "--device", DEVICE])
        launches = _launches()
        want = {"conv3x3": 0, "fused_mha": 0, "sdf_grid": SYNTH_N * per_sample}
        if launches != want:
            raise AssertionError(f"synth_gen --backgrounds: launches {launches} != {want}")
        images = np.memmap(os.path.join(out, "train_images.u8"), dtype=np.uint8, mode="r")
        labels = dict(np.load(os.path.join(out, "train_labels.npz")))
        if images.size != SYNTH_N * 256 * 256 * 3 or images.std() < 1 or not all(
                np.isfinite(v).all() for v in labels.values()):
            raise AssertionError("synth_gen --backgrounds wrote a blank or non-finite split")
        del images
        result["synth"] = dict(launches=launches, per_sample=per_sample,
                               refined_samples_per_s=stats["refined_samples_per_s"],
                               images_per_s=stats["images_per_s"], seconds=stats["seconds"])
        print(f"[corpus] (d) synth_gen --backgrounds ({CORPUS_IMAGES} images) --n {SYNTH_N} "
              f"--batch {SYNTH_N} --optimize: launches {launches} ({per_sample} B3 a refined "
              f"sample); {stats['refined_samples_per_s']:.3f} refined samples/s, "
              f"{stats['images_per_s']:.3f} images/s end to end ({stats['seconds']:.2f} s) on "
              f"{gpu_line}", flush=True)
        del corpus, cpu
    torch.cuda.empty_cache()
    return result


def _compare_renders(label: str, got, mask, want, want_mask) -> dict:
    """`tests/test_torch_render.py:_compare_images`' bar: the masks agree on
    >= 99.9% of pixels, the colours (attributes) within 1e-4 where they do,
    the coverage between 2% and 90%."""
    import numpy as np

    got, mask, want, want_mask = (np.asarray(a) for a in (got, mask, want, want_mask))
    agree = mask == want_mask
    err = float(np.abs(got[agree] - want[agree]).max())
    if agree.mean() < 0.999 or err > 1e-4 or not 0.02 < want_mask.mean() < 0.9:
        raise AssertionError(f"{label}: masks agree on {agree.mean():.5f}, max|Δ| {err:.3e}, "
                             f"coverage {want_mask.mean():.3f}")
    return dict(mask_agree=float(agree.mean()), max_abs_err=err, coverage=float(want_mask.mean()))


def _posed_pair(assets, n: int, seed: int, depth: float):
    """n posed synthetic two-hand scenes from numpy draws, the hands side by
    side at `depth` (metres, camera space)."""
    import numpy as np
    import torch

    from renderih_tpu_torch.mano.layer import mano_forward
    from renderih_tpu_torch.ops.rotation import rodrigues

    rng = np.random.default_rng(seed)
    out = []
    for mano, dx in ((assets.left.mano, -0.06), (assets.right.mano, 0.06)):
        root = torch.from_numpy(rng.normal(0, 0.6, (n, 3)).astype(np.float32))
        pose = torch.from_numpy(rng.normal(0, 0.4, (n, 45)).astype(np.float32))
        with torch.no_grad():
            v, j = mano_forward(mano, rodrigues(root), pose, torch.zeros(n, 10),
                                center_idx=None, use_pca=False)
        shift = torch.tensor([dx, 0.0, depth]) + torch.from_numpy(
            rng.normal(0, 0.02, (n, 1, 3)).astype(np.float32))
        out += [v + shift, j + shift]
    return out, rng


def perspective_phase(cfg, assets, gpu_line: str) -> dict:
    """Perspective and densepose renders, and the mask-IoU tool (see the
    module docstring, phase 24)."""
    import os
    import pickle
    import tempfile

    import numpy as np
    import torch

    from renderih_tpu_torch.apps import eval_interhand
    from renderih_tpu_torch.data.image_io import imwrite
    from renderih_tpu_torch.kernels import _build
    from renderih_tpu_torch.models import HandNet
    from renderih_tpu_torch.ops.projection import pinhole_project
    from renderih_tpu_torch.render.renderer import TwoHandRenderer
    from renderih_tpu_torch.tools import compute_maskiou, pack_data

    dev, n, k = torch.device(DEVICE), PERSP_BATCH, PERSP_CPU
    (vl, jl, vr, jr), rng = _posed_pair(assets, n, seed=24, depth=0.45)
    K = np.zeros((n, 3, 3), np.float32)
    f = rng.uniform(150.0, 250.0, n)
    K[:, 0, 0], K[:, 1, 1], K[:, 2, 2] = f, f * rng.uniform(0.95, 1.05, n), 1.0
    K[:, :2, 2] = 128.0 + rng.uniform(-12, 12, (n, 2))
    K = torch.from_numpy(K)
    light = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    light[:, 2] = -light[:, 2].abs() - 0.5
    light = light / light.norm(dim=1, keepdim=True)
    lit = dict(albedo=torch.from_numpy(rng.uniform(0.2, 1.0, (n, 2 * 778, 3)).astype(np.float32)),
               light_dir=light,
               light_color=torch.from_numpy(rng.uniform(0.5, 1.1, (n, 3)).astype(np.float32)),
               ambient=torch.from_numpy(rng.uniform(0.15, 0.45, (n, 3)).astype(np.float32)))
    cams = ({"left": torch.full((n,), 1.6), "right": torch.full((n,), 1.6)},
            {"left": torch.from_numpy(rng.uniform(-0.35, -0.1, (n, 2)).astype(np.float32)),
             "right": torch.from_numpy(rng.uniform(0.05, 0.3, (n, 2)).astype(np.float32))})
    dense = torch.from_numpy(rng.uniform(0, 1, (2 * 778, 3)).astype(np.float32))
    orth_l, orth_r = vl - torch.tensor([0, 0, 0.45]), vr - torch.tensor([0, 0, 0.45])

    def render(device, sl):
        to = lambda t: t[sl].to(device)
        r = TwoHandRenderer(assets, 256, device=device)
        with torch.no_grad():
            rgb, mask = r.render_rgb_perspective(to(K), to(vl), to(vr),
                                                 **{a: to(b) for a, b in lit.items()},
                                                 specular=0.15, ao=0.5, soft_shadow=0.5)
            mask_only = r.render_mask_perspective(to(K), to(vl), to(vr))
            attr, dmask = r.render_densepose(*({h: to(v) for h, v in c.items()} for c in cams),
                                             to(orth_l), to(orth_r), dense.to(device))
        return [t.cpu() for t in (rgb, mask, mask_only, attr, dmask)]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = render(dev, slice(0, n))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu = render(torch.device("cpu"), slice(0, k))
    result = {"rgb": _compare_renders("render_rgb_perspective", card[0][:k], card[1][:k],
                                      cpu[0], cpu[1]),
              "densepose": _compare_renders("render_densepose", card[3][:k], card[4][:k],
                                            cpu[3], cpu[4])}
    if not torch.equal(card[1], card[2]) or (card[2][:k] == cpu[2]).float().mean() < 0.999:
        raise AssertionError("render_mask_perspective differs from render_rgb_perspective's mask "
                             "or from the CPU's")
    result["render_s"] = card_s
    print(f"[persp] render_rgb_perspective (Blinn-Phong, AO, soft shadow), "
          f"render_mask_perspective and render_densepose at batch {n}, 256²: {card_s:.3f} s on "
          f"the card; its first {k} scenes against the CPU: masks agree on "
          f"{result['rgb']['mask_agree']:.5f} / {result['densepose']['mask_agree']:.5f}, max|Δ| "
          f"{result['rgb']['max_abs_err']:.2e} / {result['densepose']['max_abs_err']:.2e} (bar: "
          f">= 0.999, 1e-4)", flush=True)

    # a packed split with per-frame intrinsics, from handdicts with `camera`
    m = MASKIOU_N
    (vl, jl, vr, jr), rng = _posed_pair(assets, m, seed=25, depth=0.5)
    pull = torch.from_numpy(rng.uniform(0.0, 0.1, (m, 1, 1)).astype(np.float32))
    vr, jr = vr - pull * torch.tensor([1.0, 0, 0]), jr - pull * torch.tensor([1.0, 0, 0])
    Km = np.zeros((m, 3, 3), np.float32)
    Km[:, 0, 0] = Km[:, 1, 1] = rng.uniform(180.0, 260.0, m)
    Km[:, 2, 2], Km[:, :2, 2] = 1.0, 128.0
    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)  # build/, git-ignored
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as root:
        tree, split = os.path.join(root, "ref"), "test"
        for d in ("img", "anno", "ori_handdict"):
            os.makedirs(os.path.join(tree, split, d))
        for i in range(m):
            imwrite(os.path.join(tree, split, "img", f"{i}.jpg"), _smooth_noise(rng, 256, 256))
            with open(os.path.join(tree, split, "anno", f"{i}.pkl"), "wb") as fh:
                pickle.dump({}, fh)
            hd = {}
            for hand, v, j in (("left", vl[i], jl[i]), ("right", vr[i], jr[i])):
                Kt = torch.from_numpy(Km[i])
                hd[hand] = {"verts3d": v.numpy(), "joints3d": j.numpy(),
                            "verts2d": pinhole_project(v, Kt)[0].numpy(),
                            "joints2d": pinhole_project(j, Kt)[0].numpy(), "camera": Km[i]}
            np.save(os.path.join(tree, split, "ori_handdict", f"{i}.npy"), hd)
        packed = os.path.join(root, "packed")
        if pack_data.main(["--data", tree, "--split", split, "--out", packed]) != m:
            raise AssertionError("pack_data packed the wrong frame count")
        if "camera_in" not in np.load(os.path.join(packed, f"{split}_labels.npz")).files:
            raise AssertionError("the packed split carries no camera_in")
        ious, secs = {}, {}
        for device in (DEVICE, "cpu"):
            t0 = time.perf_counter()
            ious[device] = compute_maskiou.main(["--data", packed, "--split", split, "--out",
                                                 os.path.join(root, f"iou_{device}.npy"),
                                                 "--device", device])
            secs[device] = time.perf_counter() - t0
        gap = float(np.abs(ious[DEVICE] - ious["cpu"]).max())
        differ = int((ious[DEVICE] != ious["cpu"]).sum())
        if gap > 2 / 64 ** 2 or not 0 <= ious[DEVICE].min() <= ious[DEVICE].max() <= 1:
            raise AssertionError(f"compute_maskiou card vs CPU: max|Δ| {gap:.3e} "
                                 f"(bar {2 / 64 ** 2:.3e})")
        if not (ious[DEVICE].min() < 0.33 and ious[DEVICE].max() >= 0.33):
            raise AssertionError(f"IoUs {ious[DEVICE].min():.3f}-{ious[DEVICE].max():.3f} do not "
                                 "spread over the interaction buckets")
        result["maskiou"] = dict(frames=m, max_abs_err=gap, samples_differing=differ,
                                 seconds=secs, mean_iou=float(ious[DEVICE].mean()))
        print(f"[persp] pack_data of {m} handdicts with `camera` (JPEGs by imwrite) -> "
              f"compute_maskiou (pinhole, 64²): card against CPU max|Δ| {gap:.3e} on {differ} "
              f"samples (bar {2 / 64 ** 2:.3e}); mean IoU {ious[DEVICE].mean():.3f}; "
              f"{secs[DEVICE]:.2f} s on the card, {secs['cpu']:.2f} s on the CPU", flush=True)

        per_fwd = per_forward(cfg, assets)
        forwards = [0]
        hook = torch.nn.modules.module.register_module_forward_pre_hook(
            lambda mod, args: forwards.__setitem__(0, forwards[0] + isinstance(mod, HandNet)))
        for counter in _counters():
            counter.reset()
        try:
            summary = eval_interhand.main(["--data", packed, "--split", split, "--bs", "32",
                                           "--iou", os.path.join(root, f"iou_{DEVICE}.npy"),
                                           "--device", DEVICE, "--json"])
        finally:
            hook.remove()
        launches = _launches()
        want = {"conv3x3": per_fwd["conv3x3"] * forwards[0],
                "fused_mha": per_fwd["fused_mha"] * forwards[0], "sdf_grid": 0}
        if forwards[0] != m // 32:
            raise AssertionError(f"eval_interhand --iou ran {forwards[0]} forwards")
        _check_run_launches("eval --iou", launches, want, must_launch=("conv3x3", "fused_mha"))
        buckets = {k: v for k, v in summary.items() if "_iou" in k}
        if not buckets or not all(np.isfinite(v) for k, v in buckets.items()
                                  if not k.startswith("cdev")):
            raise AssertionError(f"eval --iou buckets: {buckets}")
        result["eval_iou"] = dict(forwards=forwards[0], launches=launches, buckets=buckets)
        print(f"[persp] eval_interhand --iou (the card's vector) --bs 32: {forwards[0]} forwards, "
              f"launches {launches} ({per_fwd['conv3x3']} B2, all on wgmma, and "
              f"{per_fwd['fused_mha']} B1 a forward); {len(buckets)} bucketed metrics, finite",
              flush=True)
    torch.cuda.empty_cache()
    return result


def demo_phase(cfg, assets, gpu_line: str) -> dict:
    """`apps.demo` on the card and the CPU (see the module docstring, phase
    25)."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from renderih_tpu_torch.apps import demo
    from renderih_tpu_torch.data.image_io import imread_rgb, imwrite
    from renderih_tpu_torch.kernels import _build
    from renderih_tpu_torch.models import HandNet

    rng = np.random.default_rng(25)
    sizes = [(480, 640), (640, 480), (300, 500), (405, 720), (256, 200), (720, 540), (150, 151),
             (333, 222)]
    per_fwd = per_forward(cfg, assets)
    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)  # build/, git-ignored
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as root:
        src, src_cpu = os.path.join(root, "in"), os.path.join(root, "in_cpu")
        os.makedirs(src)
        os.makedirs(src_cpu)
        names = []
        for i, (h, w) in enumerate(sizes[:DEMO_IMAGES]):
            names.append(f"img{i}.{'jpg' if i % 2 == 0 else 'png'}")
            imwrite(os.path.join(src, names[-1]), _smooth_noise(rng, h, w))
        for name in names[:DEMO_CPU_IMAGES]:
            shutil.copy(os.path.join(src, name), src_cpu)
        forwards = [0]
        hook = torch.nn.modules.module.register_module_forward_pre_hook(
            lambda mod, args: forwards.__setitem__(0, forwards[0] + isinstance(mod, HandNet)))
        for counter in _counters():
            counter.reset()
        try:
            run = demo.main(["--img_path", src, "--save_path", os.path.join(root, "out"),
                             "--other_view", "60", "--device", DEVICE])
        finally:
            hook.remove()
        launches = _launches()
        want = {"conv3x3": per_fwd["conv3x3"] * forwards[0],
                "fused_mha": per_fwd["fused_mha"] * forwards[0], "sdf_grid": 0}
        if forwards[0] != DEMO_IMAGES or run["images"] != DEMO_IMAGES:
            raise AssertionError(f"apps.demo ran {forwards[0]} forwards on {run['images']} images")
        _check_run_launches("demo", launches, want, must_launch=("conv3x3", "fused_mha"))
        cpu = demo.main(["--img_path", src_cpu, "--save_path", os.path.join(root, "out_cpu"),
                         "--other_view", "60", "--device", "cpu"])
        shares, within, total = {}, 0, 0
        for path in cpu["outputs"]:
            name = os.path.basename(path)
            got = imread_rgb(os.path.join(root, "out", name))
            want_img = imread_rgb(path)
            if got.shape != (256, 256, 3):
                raise AssertionError(f"demo output {name}: shape {got.shape}")
            ok = np.abs(got.astype(np.int16) - want_img).max(-1) <= 1
            shares[name], within, total = float(ok.mean()), within + ok.sum(), total + ok.size
        for path in run["outputs"]:
            if imread_rgb(path).shape != (256, 256, 3):
                raise AssertionError(f"demo output {path} does not decode to 256²")
        share = within / total
        if share < 0.99:
            raise AssertionError(f"demo card vs CPU: within 1 grey level on {share:.4f} of the "
                                 f"outputs' pixels (bar 0.99): {shares}")
        result = dict(images=DEMO_IMAGES, outputs=len(run["outputs"]), seconds=run["seconds"],
                      images_per_s=DEMO_IMAGES / run["seconds"], launches=launches,
                      forwards=forwards[0], cpu_within_1=share, cpu_within_1_by_output=shares)
        print(f"[demo] apps.demo on Config() (seed-0 weights), {DEMO_IMAGES} non-square images "
              f"(JPEG and PNG) --other_view 60: {len(run['outputs'])} outputs, each decoding to "
              f"256²; launches {launches} over {forwards[0]} forwards ({per_fwd['conv3x3']} B2, "
              f"all on wgmma, and {per_fwd['fused_mha']} B1 a forward); "
              f"{DEMO_IMAGES / run['seconds']:.2f} images/s (model, overlay, novel view, files) "
              f"on {gpu_line}; against --device cpu on {DEMO_CPU_IMAGES} of them: within 1 grey "
              f"level on {share:.5f} of the outputs' pixels (bar 0.99; by output {shares})",
              flush=True)
    torch.cuda.empty_cache()
    return result


def pathtrace_phase(assets, gpu_line: str) -> dict:
    """The path tracer through `synth_gen --renderer pathtrace`, and card
    against CPU on the same draws (see the module docstring, phase 26)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from renderih_tpu_torch.kernels import _build
    from renderih_tpu_torch.render import pathtrace as pt
    from renderih_tpu_torch.render.renderer import TwoHandRenderer
    from renderih_tpu_torch.tools import synth_gen

    dev = torch.device(DEVICE)
    captured = []

    class Recording(pt.TwoHandPathTracer):
        def render(self, *args, **kwargs):
            out = super().render(*args, **kwargs)
            captured.append((args[:4], out[1]))
            return out

    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)  # build/, git-ignored
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as root:
        synth_gen.TwoHandPathTracer = Recording
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        try:
            stats = synth_gen.main(["--out", os.path.join(root, "pt"), "--n", str(PT_N),
                                    "--batch", str(PT_N), "--renderer", "pathtrace", "--spp",
                                    str(PT_SPP), "--bounces", str(PT_BOUNCES), "--device",
                                    DEVICE])
        finally:
            synth_gen.TwoHandPathTracer = pt.TwoHandPathTracer
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        images = np.memmap(os.path.join(root, "pt", "train_images.u8"), dtype=np.uint8, mode="r")
        if images.std() < 1:
            raise AssertionError("synth_gen --renderer pathtrace wrote blank images")
        del images
    (scale, trans2d, vl, vr), mask = captured[0]
    with torch.no_grad():
        raster = TwoHandRenderer(assets, 256, device=dev).render_mask(scale, trans2d, vl, vr)
    agree = float(((mask > 0.5) == raster).float().mean())
    if len(captured) != 1 or agree < 0.999 or not 0.01 < float(raster.float().mean()) < 0.9:
        raise AssertionError(f"path tracer's hit mask against the rasteriser's: {agree:.5f} "
                             f"(bar 0.999) over {len(captured)} renders")

    # one intersection pass of the batch's primary rays, timed
    with torch.no_grad():
        tracer = pt.TwoHandPathTracer(assets, 256, device=dev)
        scene, _ = tracer.scene(scale, trans2d, vl, vr,
                                torch.full((PT_N, tracer.num_verts, 3), 0.7, device=dev))
        xs = torch.arange(256, dtype=torch.float32, device=dev)
        py, px = torch.meshgrid(xs, xs, indexing="ij")
        o0 = torch.stack([px.reshape(-1), py.reshape(-1), torch.full_like(px.reshape(-1), -1e4)],
                         -1).expand(PT_N, -1, -1)
        d0 = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(PT_N, 256 * 256, 3)
        chunk = max(256, 8192 // PT_N)
        pass_ms = _time_ms(lambda: pt.intersect(o0, d0, scene, chunk=chunk), iters=3, warmup=1)
    passes = 1 + PT_SPP * (1 + 2 * PT_BOUNCES)
    tests = PT_N * 256 * 256 * tracer.faces.shape[0]
    result = dict(images=PT_N, seconds=stats["seconds"], images_per_s=stats["images_per_s"],
                  peak_gb=peak_gb, mask_agree=agree, pass_ms=pass_ms, passes=passes,
                  ray_triangle_tests_per_s=tests / pass_ms * 1e3)
    print(f"[pathtrace] synth_gen --renderer pathtrace --spp {PT_SPP} --bounces {PT_BOUNCES} "
          f"--n {PT_N} at 256²: {stats['images_per_s']:.3f} images/s end to end "
          f"({stats['seconds']:.2f} s), peak {peak_gb:.2f} GiB on the card above what was "
          f"allocated before; hit mask against the rasteriser's on {agree:.5f} of pixels (bar "
          f"0.999); one intersection pass of the {PT_N} scenes' primary rays (chunk {chunk}, "
          f"{tests / 1e9:.2f}G ray-triangle tests) {pass_ms:.2f} ms, {passes} passes a render, "
          f"on {gpu_line}", flush=True)

    # card against CPU on the same draws at 64²
    size, bs, spp, bounces = PT_PARITY
    (pl, _, pr, _), rng = _posed_pair(assets, bs, seed=26, depth=0.0)
    inputs = ({"left": torch.full((bs,), 2.0), "right": torch.full((bs,), 2.0)},
              {"left": torch.from_numpy(rng.uniform(-0.3, -0.1, (bs, 2)).astype(np.float32)),
               "right": torch.from_numpy(rng.uniform(0.05, 0.25, (bs, 2)).astype(np.float32))},
              pl, pr, torch.from_numpy(rng.uniform(0.3, 0.9, (bs, 2 * 778, 3)).astype(np.float32)))
    draws = pt.draw_paths(torch.Generator().manual_seed(27), bs, spp, bounces, size * size)
    light = torch.from_numpy(rng.normal(size=(bs, 3)).astype(np.float32))
    light[:, 2] = -light[:, 2].abs() - 0.5
    outs = {}
    for device in (dev, torch.device("cpu")):
        to = lambda x: {k: v.to(device) for k, v in x.items()} if isinstance(x, dict) else x.to(device)
        with torch.no_grad():
            rgb, m = pt.TwoHandPathTracer(assets, size, device=device).render(
                *(to(x) for x in inputs), draws=pt.PathDraws(*(to(d) for d in draws)),
                light_dir=to(light), spp=spp, n_bounces=bounces)
        outs[device.type] = (rgb.cpu().numpy(), m.cpu().numpy())
    (rgb_c, m_c), (rgb_h, m_h) = outs["cuda" if dev.type == "cuda" else "cpu"], outs["cpu"]
    close = float((np.abs(rgb_c - rgb_h).max(-1) <= 1e-4).mean())
    if not np.array_equal(m_c, m_h) or close < 0.995 or not 0.05 < m_h.mean() < 0.9:
        raise AssertionError(f"path tracer card vs CPU: masks equal {np.array_equal(m_c, m_h)}, "
                             f"{close:.4f} of pixels within 1e-4 (bar 0.995)")
    result.update(parity_within=close, parity_max_abs_err=float(np.abs(rgb_c - rgb_h).max()))
    print(f"[pathtrace] card against CPU on the same draws, {bs} scenes at {size}², spp {spp}, "
          f"{bounces} bounces: hit masks equal, {close:.4f} of pixels within 1e-4 (bar 0.995; "
          f"max|Δ| {result['parity_max_abs_err']:.2e})", flush=True)
    torch.cuda.empty_cache()
    return result


def bf16_decoder_phase(cfg, assets, gpu_line: str) -> dict:
    """The bf16-decoder serving knob and its accuracy tool (see the module
    docstring, phase 27)."""
    import copy

    import numpy as np
    import torch

    from renderih_tpu_torch.models import HandNet
    from renderih_tpu_torch.serve import InferenceEngine
    from renderih_tpu_torch.tools import validate_bf16_decoder

    per_fwd = per_forward(cfg, assets)
    before = copy.deepcopy(cfg)
    images = np.random.default_rng(27).integers(0, 256, (32, 256, 256, 3), np.uint8)
    off = copy.deepcopy(cfg)
    off.model.decoder_f32 = False
    outs = {}
    for name, c, kw in (("knob", cfg, dict(decoder_bf16=True)), ("decoder_f32=False", off, {})):
        engine = InferenceEngine(c, assets, buckets=(32,), device=DEVICE, **kw)
        for counter in _counters():
            counter.reset()
        outs[name] = engine.predict(images)
        _check_run_launches(f"bf16 engine ({name})", _launches(),
                            {"conv3x3": per_fwd["conv3x3"], "fused_mha": per_fwd["fused_mha"],
                             "sdf_grid": 0}, must_launch=("conv3x3", "fused_mha"))
        del engine
    if cfg != before or not cfg.model.decoder_f32:
        raise AssertionError("InferenceEngine(decoder_bf16=True) changed the caller's config")
    unequal = [k for k in outs["knob"] if not np.array_equal(outs["knob"][k],
                                                             outs["decoder_f32=False"][k])]
    if unequal:
        raise AssertionError(f"the knob's engine differs from the decoder_f32=False one: {unequal}")
    print(f"[bf16] InferenceEngine(decoder_bf16=True) on 32 images equals an engine on "
          f"decoder_f32=False bit for bit ({len(outs['knob'])} outputs); the caller's config "
          f"untouched; {per_fwd['conv3x3']} B2 and {per_fwd['fused_mha']} B1 a forward",
          flush=True)
    torch.cuda.empty_cache()

    forwards = {True: 0, False: 0}  # HandNet forwards in training / eval mode

    def count(mod, args):
        if isinstance(mod, HandNet):
            forwards[mod.training] += 1

    hook = torch.nn.modules.module.register_module_forward_pre_hook(count)
    for counter in _counters():
        counter.reset()
    try:
        report, _, _ = validate_bf16_decoder.run(cfg, BF16_STEPS, TRAIN_BATCH, 256,
                                                 torch.device(DEVICE))
    finally:
        hook.remove()
    launches = _launches()
    train_fwd, eval_fwd = forwards[True], forwards[False]
    want = {"conv3x3": 2 * per_fwd["conv3x3"] * train_fwd + per_fwd["conv3x3"] * eval_fwd,
            "fused_mha": per_fwd["fused_mha"] * eval_fwd, "sdf_grid": 0}
    if train_fwd != BF16_STEPS or eval_fwd != 4:
        raise AssertionError(f"validate_bf16_decoder: {train_fwd} training and {eval_fwd} eval "
                             "forwards (expected the steps and 4)")
    _check_run_launches("validate_bf16_decoder", launches, want,
                        must_launch=("conv3x3", "fused_mha"))
    if not all(np.isfinite(v) for v in report.values() if isinstance(v, float)):
        raise AssertionError(f"validate_bf16_decoder: {report}")
    print(f"[bf16] validate_bf16_decoder --steps {BF16_STEPS} --bs {TRAIN_BATCH}: launches "
          f"{launches} ({2 * per_fwd['conv3x3']} B2 a training step, all on wgmma, no B1; "
          f"{per_fwd['conv3x3']} B2 and {per_fwd['fused_mha']} B1 in each of {eval_fwd} eval "
          f"forwards) on {gpu_line}", flush=True)
    print(json.dumps(report), flush=True)
    torch.cuda.empty_cache()
    return dict(report=report, launches=launches, train_launches=2 * per_fwd["conv3x3"] * train_fwd)


def bf16_ab(steps: int) -> int:
    """`--bf16_ab`: the trained bf16-decoder A/B at the JAX tool's defaults
    (`steps` steps at batch 64 on 256 synthetic samples), then the bucket
    gap of ROADMAP §C on the trained weights: image 0..7 served at bucket 1
    and inside a bucket of 128, each output's max|Δ| over its largest
    value, as phase 15 prints it for seed-0 weights, also in mm."""
    import numpy as np
    import torch

    from renderih_tpu_torch.assets import make_synthetic_assets
    from renderih_tpu_torch.config import Config
    from renderih_tpu_torch.kernels import _build
    from renderih_tpu_torch.serve import InferenceEngine
    from renderih_tpu_torch.tools import validate_bf16_decoder

    if not torch.cuda.is_available():
        print("chip_smoke: no card", file=sys.stderr)
        return 2
    _build.build(["conv3x3", "fused_attention"])
    gpu_line = _gpu_line()
    print(f"[card] {gpu_line}", flush=True)
    cfg, assets = Config(), make_synthetic_assets(0)
    report, state_dict, images = validate_bf16_decoder.run(cfg, steps, TRAIN_BATCH, 256,
                                                           torch.device(DEVICE))
    print(json.dumps(report), flush=True)
    gaps = {}
    for name, sd in (("trained", state_dict), ("seed-0", None)):
        engine = InferenceEngine(cfg, assets, state_dict=sd, device=DEVICE)
        alone = [engine.predict(images[i:i + 1]) for i in range(8)]
        batch = engine.predict(images[:128])
        rel = [_rel_gaps({k: v[0] for k, v in a.items()}, {k: v[i] for k, v in batch.items()})
               for i, a in enumerate(alone)]
        mm = max(float(np.abs(a[k][0] - batch[k][i]).max()) * 1e3 for i, a in enumerate(alone)
                 for k in ("verts3d_left", "verts3d_right"))
        gaps[name] = dict(worst_rel={k: max(r[k] for r in rel) for k in rel[0]}, verts3d_mm=mm)
        print(f"[bf16-ab] {name} weights: images 0-7 at bucket 1 against inside a bucket of 128: "
              f"worst output gap {max(gaps[name]['worst_rel'].values()):.4g} of its largest value "
              f"({gaps[name]['worst_rel']}); verts3d max|Δ| {mm:.4f} mm on {gpu_line}",
              flush=True)
        del engine
        torch.cuda.empty_cache()
    print(json.dumps({"bf16_ab": report, "bucket_gap": gaps}), flush=True)
    return 0


def _counters():
    from renderih_tpu_torch.kernels import conv3x3, fused_attention, sdf

    return (conv3x3.launches, fused_attention.launches, sdf.launches,
            *conv3x3.routes.values())


def _launches() -> dict:
    from renderih_tpu_torch.kernels import conv3x3, fused_attention, sdf

    return {"conv3x3": conv3x3.launches.value, "fused_mha": fused_attention.launches.value,
            "sdf_grid": sdf.launches.value}


def _check_run_launches(label: str, launches: dict, want: dict,
                        must_launch: tuple = ("conv3x3",), routes: dict | None = None) -> None:
    """The path's launches, reset to 0 before it ran, against `want`, and
    B2's routes against `routes` (default: every B2 on `wgmma`); each
    kernel of `must_launch` (those the path runs) must have launched."""
    routes = routes or {"simt": 0, "wgmma": want["conv3x3"], "tf32x3": 0}
    if launches != want or _routes() != routes:
        raise AssertionError(f"{label}: launches {launches}, B2 routes {_routes()}; expected "
                             f"{want}, B2 routes {routes}")
    for name in must_launch:
        if not launches[name]:
            raise AssertionError(f"{label}: {name} never launched")


def recipe_config(cfg):
    """`configs/convergence_r5d.yaml` (the newest from-scratch recipe: aux
    heads, zero-init heads, normal from epoch 16, camera 10, theta ±30,
    batch 128) on `cfg`'s assets; its checkpoint directory is replaced by
    the caller."""
    import os

    from renderih_tpu_torch.config import load_config

    rc = load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), RECIPE_YAML))
    rc.assets = cfg.assets
    return rc


def recipe_train_phase(cfg, assets, gpu_line: str, profile: bool = False) -> tuple:
    """From-scratch recipe training on the card (see the module docstring,
    phase 11). Returns (result, the final checkpoint's model state_dict)."""
    import copy
    import tempfile

    import numpy as np
    import torch

    from renderih_tpu_torch.apps import train as train_app
    from renderih_tpu_torch.data.interhand import PackedInterHand
    from renderih_tpu_torch.data.pipeline import device_augment
    from renderih_tpu_torch.kernels import _build
    from renderih_tpu_torch.models import init_model
    from renderih_tpu_torch.train.state import checkpoint_state_dict, create_train_state
    from renderih_tpu_torch.train.trainer import make_train_step

    rcfg = recipe_config(cfg)
    batch = rcfg.train.batch_size
    per_fwd_b2, per_fwd_b1 = per_forward(rcfg, assets).values()  # 13, 24
    spe = RECIPE_SYNTH_N // batch
    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)  # build/, git-ignored
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as root:
        yaml = _train_yaml(rcfg, root, "recipe", log_every=1)
        for counter in _counters():
            counter.reset()
        t0 = time.perf_counter()
        run = train_app.main(["--cfg", yaml, "--synthetic", "--synth_render", "--synth_n",
                              str(RECIPE_SYNTH_N), "--steps", str(RECIPE_STEPS),
                              "--device", DEVICE])
        seconds = time.perf_counter() - t0
        launches = _launches()
        n_steps = run["final_step"]
        eval_steps = [e["step"] for e in run["evals"]]
        want_evals = [s for s in range(1, RECIPE_STEPS + 1)
                      if s % spe == 0 and (s // spe) % rcfg.train.eval_every == 0]
        if n_steps != RECIPE_STEPS or eval_steps != want_evals:
            raise AssertionError(f"{n_steps} steps, evals at {eval_steps} (expected "
                                 f"{RECIPE_STEPS}, {want_evals})")
        # each eval: one forward a batch of the held-out split, one for the overlays
        n_eval_fwd = sum(-(-e["summary"]["num_samples"] // batch) + 1 for e in run["evals"])
        want = {"conv3x3": 2 * per_fwd_b2 * n_steps + per_fwd_b2 * n_eval_fwd,
                "fused_mha": per_fwd_b1 * n_eval_fwd, "sdf_grid": 0}
        print(f"[recipe] apps.train --cfg {RECIPE_YAML} --synthetic --synth_render --synth_n "
              f"{RECIPE_SYNTH_N} --steps {RECIPE_STEPS} ({rcfg.model.encoder}, "
              f"{rcfg.train.precision} encoder, aux heads, batch {batch}): {n_steps} steps and {n_eval_fwd} eval forwards in "
              f"{seconds:.1f} s, launches {launches} (expected {want}; the aux heads' convs are "
              f"stock), B2 routes {_routes()}", flush=True)
        _check_run_launches("recipe training", launches, want)
        for step, terms in run["logged"]:
            if (not all(np.isfinite(v) for v in terms.values()) or terms["skipped_nonfinite"]
                    or not terms["aux_hms"] > 0):
                raise AssertionError(f"step {step}: terms {terms}")
        aux_hms = [t["aux_hms"] for _, t in run["logged"]]
        first, last = run["logged"][0][1], run["logged"][-1][1]
        for ev in run["evals"]:
            metrics = {k: v for k, v in ev["summary"].items() if k.endswith("_mm")}
            if not all(np.isfinite(v) for k, v in metrics.items() if not k.startswith("cdev")):
                raise AssertionError(f"eval at step {ev['step']}: not finite: {metrics}")
        steady = run["step_seconds"][train_app.WARMUP_STEPS:]
        print(f"[recipe] loss {first['total']:.4f} -> {last['total']:.4f}, aux_hms "
              f"{aux_hms[0]:.5f} -> {aux_hms[-1]:.5f} (every term finite at every step, aux_hms "
              f"> 0, none skipped); evals at steps {eval_steps}: "
              + "; ".join(f"mpjpe {e['summary']['mpjpe_mm']:.2f} mm" for e in run["evals"])
              + f"; {run['images_per_s']:.1f} images/s, {1e3 * np.median(steady):.1f} ms a step "
              f"(median of steps {train_app.WARMUP_STEPS + 1}-{n_steps}) on {gpu_line}",
              flush=True)
        state_dict = checkpoint_state_dict(run["checkpoint"])

        # 10 AdamW steps on one fixed batch lower the loss (as phase 8);
        # then one step with and one without the aux heads, profiled
        fcfg = copy.deepcopy(rcfg)
        fcfg.train.warmup_epochs, fcfg.train.lr = 0, 1e-3
        data = PackedInterHand.load(f"{root}/recipe/_synth_data", "train")
        raw = {k: torch.from_numpy(v).to(DEVICE) for k, v in data.batch(np.arange(batch)).items()}
        fixed = device_augment(raw, torch.Generator(device=DEVICE).manual_seed(0),
                               img_size=rcfg.model.img_size)
        model = init_model(fcfg, assets, torch.Generator().manual_seed(0))
        state = create_train_state(fcfg, model.to(DEVICE, memory_format=torch.channels_last),
                                   steps_per_epoch=1000)
        step = make_train_step(fcfg, assets, 1000, DEVICE)
        losses = [float(step(state, fixed, torch.Generator(device=DEVICE).manual_seed(1))["total"])
                  for _ in range(FIXED_BATCH_STEPS)]
        print(f"[recipe] {FIXED_BATCH_STEPS} AdamW steps (lr 1e-3, no warmup) on one fixed batch "
              f"of {batch}: loss {' '.join(f'{v:.2f}' for v in losses)}", flush=True)
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"loss did not fall on a fixed batch: {losses}")
        off = copy.deepcopy(fcfg)
        off.model.with_aux_heads = False  # the same model, its heads not run
        step_off = make_train_step(off, assets, 1000, DEVICE)
        prof = {name: profile_phase(f"one recipe step at batch {batch}, aux heads {name}",
                                    lambda fn=fn: float(fn(state, fixed)["total"]),
                                    top=30 if profile else 0)
                for name, fn in (("on", step), ("off", step_off))}
        share = 1.0 - prof["off"]["busy_ms"] / prof["on"]["busy_ms"]
        print(f"[recipe] the aux heads' share of a step's device time: {100 * share:.1f}% "
              f"(busy {prof['on']['busy_ms']:.2f} ms with them, {prof['off']['busy_ms']:.2f} "
              f"ms without, under the profiler) on {gpu_line}", flush=True)
        result = dict(steps=n_steps, launches=launches, routes=_routes(),
                      eval_forwards=n_eval_fwd, seconds=seconds,
                      images_per_s=run["images_per_s"], step_ms=1e3 * float(np.median(steady)),
                      step_seconds=run["step_seconds"], loss_first=first["total"],
                      loss_last=last["total"], aux_hms=aux_hms,
                      evals=[dict(step=e["step"], summary=e["summary"]) for e in run["evals"]],
                      fixed_batch_losses=losses, aux_share=share, profile=prof)
    del state, model, fixed, raw
    torch.cuda.empty_cache()
    return result, state_dict


def mano_train_phase(cfg, assets, gpu_line: str) -> dict:
    """`decoder="mano"` training on the card (see the module docstring,
    phase 12)."""
    import copy

    mcfg = copy.deepcopy(cfg)
    mcfg.model.decoder = "mano"
    run = train_run_phase(mcfg, assets, gpu_line, "mano", MANO_STEPS)
    mano = {k: [t[k] for _, t in run["logged"]] for k in ("mano_pose", "mano_shape", "total")}
    if not all(v > 0 for v in mano["mano_pose"]):
        raise AssertionError(f"mano training: mano_pose {mano['mano_pose']}")
    print(f"[mano] mano_pose {' '.join(f'{v:.4f}' for v in mano['mano_pose'])}", flush=True)
    return dict(steps=run["steps"], launches=run["launches"], terms=mano,
                images_per_s=run["images_per_s"])


def recipe_parity_phase(cfg, assets) -> list:
    """Card against CPU on one f32 step with the aux heads and the MANO
    decoder (see the module docstring, phase 13)."""
    import copy

    import numpy as np
    import torch

    from renderih_tpu_torch.data.synthetic import synthetic_batch

    pcfg = copy.deepcopy(cfg)
    pcfg.model.with_aux_heads, pcfg.model.decoder = True, "mano"

    def make_batch(seed):
        batch = synthetic_batch(assets, torch.Generator().manual_seed(seed), PARITY_BATCH,
                                cfg.model.img_size, with_aux=True)
        rng = np.random.default_rng(seed)
        for h in ("left", "right"):
            batch[f"pose_{h}"] = torch.from_numpy(
                (rng.normal(size=(PARITY_BATCH, 48)) * 0.3).astype(np.float32))
            batch[f"shape_{h}"] = torch.from_numpy(
                rng.normal(size=(PARITY_BATCH, 10)).astype(np.float32))
        return batch

    def plant(c):
        c.loss.hms *= 1.1
        return "the heatmap term's weight 10% off"

    return train_parity_phase(pcfg, assets, seeds=RECIPE_PARITY_SEEDS, tag="recipe-parity",
                              plant=plant, make_batch=make_batch)


def _trunk_trace(engine, images) -> tuple:
    """One `engine.predict(images)` with a hook on every module of the
    trunk: ([(module name, its output for image 0)] in the order the
    modules finished, the outputs for image 0)."""
    trace, handles = [], []
    for name, mod in engine.model.encoder.resnet.named_modules():
        if name:
            handles.append(mod.register_forward_hook(
                lambda m, a, out, name=name: trace.append((name, out[0].clone()))))
    try:
        out = engine.predict(images)
    finally:
        for h in handles:
            h.remove()
    return trace, {k: v[0] for k, v in out.items()}


def _rel_gaps(got: dict, ref: dict) -> dict:
    """max|Δ| / max|ref| of each output."""
    import numpy as np

    return {k: float(np.abs(got[k] - r).max() / max(np.abs(r).max(), 1e-30))
            for k, r in ref.items()}


def bucket_phase(cfg, assets) -> dict:
    """The serving engine's buckets (see the module docstring, phase 14)."""
    import copy

    import numpy as np
    import torch

    from renderih_tpu_torch.kernels import conv3x3, fused_attention
    from renderih_tpu_torch.models import attention, layers, resnet
    from renderih_tpu_torch.serve import InferenceEngine

    engine = InferenceEngine(cfg, assets=assets, device=DEVICE, seed=0)
    buckets = engine.buckets
    size = cfg.model.img_size
    images = np.random.default_rng(6).integers(0, 256, (buckets[-1], size, size, 3), np.uint8)
    # every B2 and B1 call of one forward at the largest bucket, on its own
    # activations: against the plain version, and on its first b images
    # against itself
    calls = []

    def recorded(fn, kind):
        def call(*args):
            out = fn(*args)
            calls.append((kind, args, out))
            return out
        return call

    resnet.conv3x3_same = recorded(conv3x3.conv3x3_same, "conv3x3")
    attention.fused_mha = recorded(fused_attention.fused_mha, "fused_mha")
    try:
        engine.predict(images)
    finally:
        resnet.conv3x3_same, attention.fused_mha = conv3x3.conv3x3_same, fused_attention.fused_mha
    worst = {"conv3x3": 0.0, "fused_mha": 0.0}
    variant = []
    with torch.inference_mode():
        for i, (kind, args, out) in enumerate(calls):
            label = f"{kind} call {i} of a forward at batch {buckets[-1]} {tuple(out.shape)}"
            if kind == "conv3x3":
                ref = conv3x3.conv3x3_reference(*args)
                err = _check(label, out, ref, *CONV_TOL[str(out.dtype).split(".")[1]])
                part = lambda b: conv3x3.conv3x3_same(args[0][:b], args[1])
            else:
                ref = fused_attention.mha_reference(*(a.float() for a in args))
                err = _check(label, out, ref, *MHA_TOL)
                part = lambda b: fused_attention.fused_mha(*(a[:b] for a in args))
            worst[kind] = max(worst[kind], err)
            for b in buckets[:-1]:
                if not torch.equal(part(b), out[:b]):
                    variant.append(f"{label} on its first {b} images")
            del ref
    n_calls = {k: sum(c[0] == k for c in calls) for k in worst}
    del calls
    if variant:
        raise AssertionError("a kernel's result for an image depends on the batch: "
                             + "; ".join(variant))

    # image 0 served at bucket 1 and at the largest: where the two part
    served = {b: _trunk_trace(engine, images[:b]) for b in (buckets[0], buckets[-1])}
    (trace_a, out_a), (trace_b, out_b) = served.values()
    first = next(((name, float((a.float() - b.float()).abs().max()
                               / b.float().abs().max().clamp_min(1e-30)))
                  for (name, a), (_, b) in zip(trace_a, trace_b) if not torch.equal(a, b)),
                 None)
    stages = {name: float((a.float() - b.float()).abs().max()
                          / b.float().abs().max().clamp_min(1e-30))
              for (name, a), (_, b) in zip(trace_a, trace_b) if name.count(".") == 0}
    served_gap = _rel_gaps(out_a, out_b)
    first_kind = None
    if first is not None:
        mod = engine.model.encoder.resnet.get_submodule(first[0])
        if isinstance(mod, resnet.Conv3x3) and mod.stride == (1, 1):
            raise AssertionError(f"image 0 parts between buckets first at B2 ({first[0]})")
        first_kind = (f"a stock {mod.kernel_size[0]}x{mod.kernel_size[1]} convolution, "
                      f"stride {mod.stride[0]}" if isinstance(mod, layers.Conv2d)
                      else type(mod).__name__)

    # the same with every stock convolution run one image at a time: the
    # trunk is then the same computation at both buckets, bit for bit
    stock = layers.Conv2d.forward

    def per_image(self, x):
        return torch.cat([stock(self, x[i:i + 1]) for i in range(len(x))])

    layers.Conv2d.forward = per_image
    try:
        alone = {b: _trunk_trace(engine, images[:b]) for b in (buckets[0], buckets[-1])}
    finally:
        layers.Conv2d.forward = stock
    (trace_a, out_a), (trace_b, out_b) = alone.values()
    trunk_equal = all(torch.equal(a, b) for (_, a), (_, b) in zip(trace_a, trace_b))
    alone_gap = _rel_gaps(out_a, out_b)
    del served, alone, trace_a, trace_b
    if not trunk_equal:
        raise AssertionError("with its stock convolutions one image at a time the trunk "
                             "still parts between buckets")

    # unheld: the same images through the plain B2 and B1 at each bucket,
    # and the f32 engine across buckets
    plain_gap = {}
    for b in buckets:
        got = engine.predict(images[:b])
        resnet.conv3x3_same = conv3x3.conv3x3_reference
        attention.fused_mha = fused_attention.mha_reference
        try:
            want = engine.predict(images[:b])
        finally:
            resnet.conv3x3_same = conv3x3.conv3x3_same
            attention.fused_mha = fused_attention.fused_mha
        plain_gap[b] = max(_rel_gaps(got, want).values())
    f32 = copy.deepcopy(cfg)
    f32.train.precision = "f32"
    del engine
    engine = InferenceEngine(f32, assets=assets, device=DEVICE, seed=0)
    f32_gap = _rel_gaps({k: v[0] for k, v in engine.predict(images[:1]).items()},
                        {k: v[0] for k, v in engine.predict(images).items()})
    del engine
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    fmt = lambda d: ", ".join(f"{k} {v:.2e}" for k, v in d.items())
    print(f"[buckets] Config() seed-0 engine, buckets {list(buckets)}: every B2 (bfloat16, "
          f"wgmma) and B1 (float32) call of a forward at batch {buckets[-1]} "
          f"({n_calls}) against its plain version on its own activations, max|Δ| "
          f"{worst['conv3x3']:.3e} / {worst['fused_mha']:.3e} (limits as phase 2), and on "
          f"its first {list(buckets[:-1])} images equal bit for bit to the whole batch's", flush=True)
    print(f"[buckets] image 0 served at bucket {buckets[0]} and at {buckets[-1]}, max|Δ| / "
          f"max|ref|: the trunk first parts at "
          + (f"{first[0]} ({first_kind}, {first[1]:.2e})" if first else "no module")
          + f"; the stages {fmt(stages)}; the outputs {fmt(served_gap)}", flush=True)
    print(f"[buckets] with the stock convolutions one image at a time: the trunk's every "
          f"module equal bit for bit at both buckets, the outputs (the f32 decoder's "
          f"cuBLAS left to part) {fmt(alone_gap)}", flush=True)
    print(f"[buckets] not held: at each bucket the kernels' forward against the plain B2 and "
          f"B1's on the same weights and images, the largest max|Δ| / max|ref| of an output "
          f"{fmt(plain_gap)}; the f32 engine (TF32 off), image 0 at bucket {buckets[0]} and "
          f"{buckets[-1]}: {fmt(f32_gap)}", flush=True)
    return dict(conv3x3=worst["conv3x3"], fused_mha=worst["fused_mha"],
                n_calls=n_calls, first_part=first,
                stages=stages, served=served_gap, stock_per_image=alone_gap,
                plain_vs_kernel=plain_gap, f32=f32_gap)


def aux_serve_phase(cfg, assets, state_dict: dict) -> dict:
    """Serving a model trained with the aux heads (see the module
    docstring, phase 14)."""
    import copy

    import numpy as np
    import torch

    from renderih_tpu_torch.serve import InferenceEngine

    rcfg = recipe_config(cfg)
    per_fwd = dict(per_forward(rcfg, assets), sdf_grid=0)  # 13 B2, 24 B1
    images = np.random.default_rng(4).integers(0, 256, (AUX_SERVE_N, rcfg.model.img_size,
                                                        rcfg.model.img_size, 3), np.uint8)
    engine = InferenceEngine(rcfg, assets=assets, state_dict=state_dict, device=DEVICE)
    head_calls = []
    for name in ("hms_head", "dp_head"):
        getattr(engine.model, name).register_forward_hook(
            lambda *a, name=name: head_calls.append(name))
    forwards = [0]
    engine.model.register_forward_pre_hook(
        lambda *a: forwards.__setitem__(0, forwards[0] + 1))
    for counter in _counters():
        counter.reset()
    got = engine.predict(images)
    launches = _launches()
    want = {k: n * forwards[0] for k, n in per_fwd.items()}
    _check_run_launches("aux-on serving", launches, want)
    if head_calls:
        raise AssertionError(f"the serving forward ran the aux heads: {head_calls}")
    off = copy.deepcopy(rcfg)
    off.model.with_aux_heads = False
    plain = InferenceEngine(off, assets=assets, device=DEVICE, state_dict={
        k: v for k, v in state_dict.items() if not k.startswith(("hms_head.", "dp_head."))})
    want_out = plain.predict(images)
    errs = {k: float(np.abs(got[k] - ref).max() / max(np.abs(ref).max(), 1e-6))
            for k, ref in want_out.items()}
    print(f"[aux-serve] InferenceEngine on {RECIPE_YAML} with phase 11's trained weights, "
          f"{AUX_SERVE_N} images: {forwards[0]} forwards, launches {launches} (expected {want}), "
          f"no aux-head forward; against an engine without the heads on the same trunk and "
          f"decoder weights, max|Δ| / max|ref| per output: "
          + ", ".join(f"{k}={v:.2e}" for k, v in errs.items())
          + f" (limit {AUX_SERVE_RTOL:g})", flush=True)
    if max(errs.values()) > AUX_SERVE_RTOL:
        raise AssertionError("the aux-head engine's outputs differ from the engine without heads")
    del engine, plain
    torch.cuda.empty_cache()
    return dict(launches=launches, forwards=forwards[0], rel_err=errs)


def _http_post(url: str, body: bytes, ctype: str) -> tuple:
    """POST `body` to `url`: (response body, its content type, seconds)."""
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST", headers={"Content-Type": ctype})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        data, got_type = r.read(), r.headers.get("Content-Type")
    return data, got_type, time.perf_counter() - t0


def _http_wave(url: str, bodies: list, ctype: str) -> tuple:
    """All `bodies` POSTed at once, a thread each: (wall seconds, [(body,
    content type, seconds)] in order). Runs in a client process of its own,
    so that the load does not share the server's interpreter lock."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(bodies)) as pool:
        t0 = time.perf_counter()
        res = list(pool.map(lambda b: _http_post(url, b, ctype), bodies))
    return time.perf_counter() - t0, res


def http_phase(cfg, assets, gpu_line: str) -> dict:
    """The HTTP front end on the card (see the module docstring, phase 15)."""
    import io
    import json as json_mod
    import multiprocessing
    import threading
    import urllib.request
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch

    from renderih_tpu_torch.serve import InferenceEngine
    from renderih_tpu_torch.serve_http import HandPoseHTTPServer

    size = cfg.model.img_size
    per_fwd = dict(per_forward(cfg, assets), sdf_grid=0)
    engine = InferenceEngine(cfg, assets=assets, device=DEVICE, seed=0)
    engine.warmup()
    groups, lock = [], threading.Lock()  # the batches the engine ran, and their outputs
    predict = engine.predict

    def logged_predict(images):
        out = predict(images)
        with lock:
            groups.append((np.array(images), out))
        return out

    engine.predict = logged_predict
    forwards = [0]
    engine.model.register_forward_pre_hook(lambda *a: forwards.__setitem__(0, forwards[0] + 1))
    server = HandPoseHTTPServer(engine, host="127.0.0.1", port=0)
    server.start()
    url = f"http://127.0.0.1:{server.port}"
    rng = np.random.default_rng(5)
    singles = rng.integers(0, 256, (HTTP_REQUESTS, size, size, 3), np.uint8)
    batch = rng.integers(0, 256, (HTTP_BATCH, size, size, 3), np.uint8)

    def npy(a):
        buf = io.BytesIO()
        np.save(buf, a)
        return buf.getvalue()

    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            health = json_mod.loads(r.read())
        if health != {"status": "ok", "buckets": list(engine.buckets),
                      "encoder": cfg.model.encoder}:
            raise AssertionError(f"/healthz: {health}")
        for counter in _counters():
            counter.reset()
        forwards[0] = 0
        waves = []
        bodies = [npy(img) for img in singles]
        with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as client:
            for _ in range(HTTP_WAVES):
                groups.clear()
                wall, res = client.submit(_http_wave, f"{url}/predict", bodies,
                                          "application/x-npy").result(timeout=900)
                waves.append((wall, res, list(groups)))
        served_groups = waves[-1][2]
        body, btype, batch_s = _http_post(f"{url}/predict", npy(batch), "application/x-npy")
        jbody, jtype, json_s = _http_post(
            f"{url}/predict", json_mod.dumps({"image": singles[0].tolist()}).encode(),
            "application/json")
        launches, n_fwd = _launches(), forwards[0]
    finally:
        server.close()
    engine.predict = predict
    want = {k: n * n_fwd for k, n in per_fwd.items()}
    _check_run_launches("HTTP serving", launches, want)
    if btype != "application/x-npz" or jtype != "application/json":
        raise AssertionError(f"content types {btype}, {jtype}")

    def gap(got: dict, ref: dict) -> float:
        worst = 0.0
        for k, want_v in ref.items():
            g = np.asarray(got[k], np.float32)
            if g.shape != want_v.shape:
                raise AssertionError(f"{k}: shape {g.shape}, expected {want_v.shape}")
            worst = max(worst, float(np.abs(g - want_v).max()
                                     / max(np.abs(want_v).max(), 1e-6)))
        return worst

    # each response against engine.predict of the same images, batched as
    # the server batched them (the images a batcher call coalesced, the
    # explicit batch, the JSON image alone)
    errs = {}
    index = {singles[i].tobytes(): i for i in range(HTTP_REQUESTS)}
    replies = {i: dict(np.load(io.BytesIO(data))) for i, (data, _, _) in enumerate(waves[-1][1])}
    worst_single, rows = 0.0, 0
    for images, _ in served_groups:
        ref = engine.predict(images)
        for j, img in enumerate(images):
            worst_single = max(worst_single, gap(replies[index[img.tobytes()]],
                                                 {k: v[j] for k, v in ref.items()}))
            rows += 1
    if rows != HTTP_REQUESTS:
        raise AssertionError(f"the batcher's calls hold {rows} images, not {HTTP_REQUESTS}")
    errs["single"] = worst_single
    errs["batch"] = gap(dict(np.load(io.BytesIO(body))), engine.predict(batch))
    errs["json"] = gap({k: np.asarray(v) for k, v in json_mod.loads(jbody).items()},
                       {k: v[0] for k, v in engine.predict(singles[:1]).items()})
    # unheld: each single response against one predict of all of them (another bucket)
    whole = engine.predict(singles)
    across = max(gap(replies[i], {k: v[i] for k, v in whole.items()})
                 for i in range(HTTP_REQUESTS))
    wall, res, _ = waves[-1]
    lat = np.array([r[2] for r in res]) * 1e3
    rps = HTTP_REQUESTS / wall
    sizes = sorted(len(images) for images, _ in served_groups)
    print(f"[http] serve_http on 127.0.0.1:{server.port}, Config() seed-0 weights: /healthz "
          f"{health}; {HTTP_WAVES} waves of {HTTP_REQUESTS} concurrent single-image npy "
          f"requests from a client process (the last: {rps:.1f} requests/s, latency p50 "
          f"{np.percentile(lat, 50):.1f} ms, p99 {np.percentile(lat, 99):.1f} ms, batcher "
          f"calls of {sizes} images; earlier waves "
          + ", ".join(f"{HTTP_REQUESTS / w[0]:.1f}" for w in waves[:-1])
          + f" requests/s), one npy batch of {HTTP_BATCH} ({1e3 * batch_s:.1f} ms), one JSON "
          f"request ({1e3 * json_s:.1f} ms); launches {launches} (expected {want}), every B2 "
          f"on wgmma; responses vs engine.predict of the same images as batched, max|Δ| / "
          f"max|ref|: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (limit {PATH_RTOL:g}); singles vs one predict of all {HTTP_REQUESTS} (not "
          f"held: another bucket, another cuDNN plan for the stock convolutions, phase 14) "
          f"{across:.2e}; on "
          f"{gpu_line}", flush=True)
    if max(errs.values()) > PATH_RTOL:
        raise AssertionError("an HTTP response differs from engine.predict")
    del engine
    torch.cuda.empty_cache()
    return dict(requests_per_s=rps, latency_ms_p50=float(np.percentile(lat, 50)),
                latency_ms_p99=float(np.percentile(lat, 99)),
                waves=[dict(seconds=w[0], batcher_calls=sorted(len(g[0]) for g in w[2]))
                       for w in waves],
                batch_ms=1e3 * batch_s, json_ms=1e3 * json_s, launches=launches,
                rel_err=errs, across_buckets_rel=across)


def serve_phase(cfg, assets, gpu_line: str, tag: str, n_images: int = BATCH,
                buckets: tuple | None = None, requests: int = 0,
                profile: bool = False) -> dict:
    """`InferenceEngine` on `cfg` (seed-0 weights) on the card. First the
    path's B2 and B1 at every shape of a forward at each of the engine's
    buckets, against their plain versions on random inputs
    (`hold_path_kernels`). Then, counted from 0: `requests` single-image
    requests through `BatchingServer`, one `predict` at each bucket below
    the largest, and three of `n_images`. Held: exactly the model's B2 and
    B1 calls a forward (`kernel_shapes`), each B2 on its route (`conv3x3.route`:
    bf16 `wgmma`, float32 `tf32x3` at the trunks' widths); outputs of
    their shapes, finite. Prints images/s, the median of the three, and a
    served request against the same image in the big batch (not held:
    cuDNN may pick other algorithms at other batch sizes)."""
    import numpy as np
    import torch

    from renderih_tpu_torch.serve import DEFAULT_BUCKETS, BatchingServer, InferenceEngine

    engine = InferenceEngine(cfg, assets=assets, device=DEVICE, seed=0,
                             buckets=buckets or DEFAULT_BUCKETS)
    held = {b: hold_path_kernels(cfg, assets, b, seed=20 + i)
            for i, b in enumerate(engine.buckets)}
    dtypes = {kernel: "/".join(sorted({s[-2] for s in shapes}))
              for kernel, shapes in kernel_shapes(cfg, assets).items()}
    print(f"[{tag}] the path's kernels at each bucket against their plain versions on random "
          f"inputs, max|Δ| B2 {dtypes['conv3x3'] or '-'} / B1 {dtypes['fused_mha'] or '-'}: "
          + ", ".join(f"batch {b} {h['conv3x3']:.3e} / {h['fused_mha']:.3e}"
                      for b, h in held.items()), flush=True)
    engine.warmup()
    forwards = [0]
    hook = engine.model.register_forward_pre_hook(
        lambda mod, args: forwards.__setitem__(0, forwards[0] + 1))
    size = cfg.model.img_size
    images = np.random.default_rng(6).integers(0, 256, (n_images, size, size, 3), dtype=np.uint8)
    for counter in _counters():
        counter.reset()
    served = []
    if requests:
        server = BatchingServer(engine)
        try:
            futs = [server.submit(images[i]) for i in range(requests)]
            served = [f.result(timeout=600) for f in futs]
        finally:
            server.close()
    for b in engine.buckets[:-1]:
        engine.predict(images[:b])
    rates = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.predict(images)
        rates.append(n_images / (time.perf_counter() - t0))
    launches, routes = _launches(), _routes()
    hook.remove()
    per_fwd = dict(per_forward(cfg, assets), sdf_grid=0)
    want = {k: n * forwards[0] for k, n in per_fwd.items()}
    _check_run_launches(tag, launches, want,
                        must_launch=tuple(k for k, n in per_fwd.items() if n),
                        routes={k: n * forwards[0] for k, n in path_routes(cfg, assets).items()})
    for i, res in enumerate(served):
        if res["verts3d_left"].shape != (778, 3):
            raise AssertionError(f"{tag} request {i}: shape {res['verts3d_left'].shape}")
    for key, val in out.items():
        exp = {"verts3d": (n_images, 778, 3), "verts2d": (n_images, 778, 2),
               "scale": (n_images,), "trans2d": (n_images, 2)}[key.rsplit("_", 1)[0]]
        if val.shape != exp or not np.isfinite(val).all():
            raise AssertionError(f"{tag} {key}: shape {val.shape} (want {exp}) or non-finite")
    rate = sorted(rates)[1]
    wave = gap_note = ""
    if served:
        ref = out["verts3d_left"][0]
        gap = np.abs(served[0]["verts3d_left"] - ref).max() / max(np.abs(ref).max(), 1e-6)
        wave = f"{requests} requests through BatchingServer, then "
        gap_note = f"; served-vs-batched rel max|Δ| {gap:.2e}"
    print(f"[{tag}] InferenceEngine, {cfg.model.encoder} ({cfg.train.precision}), buckets "
          f"{engine.buckets}: {forwards[0]} forwards ({wave}one predict at each smaller "
          f"bucket, then 3 of {n_images}), launches {launches} = {per_fwd} a forward, B2 "
          f"routes {routes}; {rate:.1f} images/s (median of "
          f"{', '.join(f'{r:.1f}' for r in rates)}; upload and copy back included) on "
          f"{gpu_line}{gap_note}", flush=True)
    result = dict(held=held, launches=launches, conv3x3_routes=routes, forwards=forwards[0],
                  per_forward=per_fwd, images_per_s=rate, images_per_s_runs=rates)
    if profile:
        batch = images[:engine.buckets[-1]]
        result["profile"] = profile_phase(f"predict({len(batch)})",
                                          lambda: engine.predict(batch))
    del engine
    torch.cuda.empty_cache()
    return result


def train_run_phase(cfg, assets, gpu_line: str, tag: str, steps: int, check=None) -> dict:
    """`apps.train` on `cfg`, `--synthetic`, `steps` steps on the card (no
    eval, no checkpoint between). Held: exactly 2x the model's B2 calls a
    forward a step (forward and dx), all on `wgmma`, and no B1 (training
    keeps the plain attention, as JAX does); every logged term finite, none
    skipped; and `check(run)`, given the app's result while its final
    checkpoint (`run["checkpoint"]`) exists. Prints images/s (the train
    app's median)."""
    import tempfile

    import numpy as np
    import torch

    from renderih_tpu_torch.apps import train as train_app
    from renderih_tpu_torch.kernels import _build

    per_step = 2 * per_forward(cfg, assets)["conv3x3"]
    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)  # build/, git-ignored
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as root:
        yaml = _train_yaml(cfg, root, tag, log_every=1, eval_every=1000, save_gap=1000)
        for counter in _counters():
            counter.reset()
        run = train_app.main(["--cfg", yaml, "--synthetic", "--synth_n", str(TRAIN_SYNTH_N),
                              "--steps", str(steps), "--device", DEVICE])
        launches = _launches()
        if check is not None:
            check(run)
    n_steps = run["final_step"]
    want = {"conv3x3": per_step * n_steps, "fused_mha": 0, "sdf_grid": 0}
    _check_run_launches(f"{tag} training", launches, want,
                        must_launch=("conv3x3",) if per_step else ())
    for step, terms in run["logged"]:
        if not all(np.isfinite(v) for v in terms.values()) or terms["skipped_nonfinite"]:
            raise AssertionError(f"{tag} step {step}: terms {terms}")
    first, last = run["logged"][0][1], run["logged"][-1][1]
    print(f"[{tag}] apps.train, {cfg.model.encoder} ({cfg.train.precision}), decoder "
          f"{cfg.model.decoder}, batch {cfg.train.batch_size}, --synthetic --steps {steps}: "
          f"{n_steps} steps, launches {launches} (expected {want}: {per_step} B2 a step, "
          f"all on wgmma, no B1); every term finite at every step ("
          + ", ".join(f"{k} {first[k]:.4f} -> {last[k]:.4f}" for k in sorted(last)
                      if k != "skipped_nonfinite")
          + f"); {run['images_per_s']:.1f} images/s on {gpu_line}", flush=True)
    torch.cuda.empty_cache()
    return dict(steps=n_steps, launches=launches, first=first, last=last,
                logged=run["logged"], images_per_s=run["images_per_s"])


def vit_path_phase(assets, gpu_line: str, flagship_cfg) -> tuple:
    """The ViT path (see the module docstring, phase 16): (kernel rows,
    result)."""
    import copy

    from renderih_tpu_torch.config import load_config

    cfg = load_config(VIT_YAML)
    large = copy.deepcopy(cfg)
    large.model.encoder = "vit_large"
    done = {k: set(shape_counts(flagship_cfg, assets, k)) for k in ("conv3x3", "fused_mha")}
    rows = kernel_phase(cfg, assets, skip=done, label="vit_base")
    calls = shape_counts(cfg, assets, "fused_mha")
    large_rows = kernel_phase(large, assets, skip={"fused_mha": done["fused_mha"] | set(calls)},
                              label="vit_large")
    serve = serve_phase(cfg, assets, gpu_line, "vit-serve")
    errs = parity_phase(cfg, assets, tag="vit-parity")
    train = train_run_phase(cfg, assets, gpu_line, "vit-train", VIT_TRAIN_STEPS)
    if not {"mano_pose", "mano_shape"} <= set(train["last"]):
        raise AssertionError(f"vit-train: no mano terms in {sorted(train['last'])}")
    train_parity = train_parity_phase(cfg, assets, seeds=((0, 2),), tag="vit-train-parity")
    large_serve = serve_phase(large, assets, gpu_line, "vit-large-serve",
                              n_images=VIT_LARGE_BUCKET, buckets=(VIT_LARGE_BUCKET,))
    return ({"fused_mha": rows["fused_mha"] + large_rows["fused_mha"]},
            dict(serve=serve, parity=errs, train=train, train_parity=train_parity,
                 large_serve=large_serve))


def hrnet_path_phase(assets, gpu_line: str, flagship_cfg) -> tuple:
    """The HRNet path (see the module docstring, phase 17): (kernel rows,
    backward rows, result)."""
    import copy

    cfg = copy.deepcopy(flagship_cfg)
    cfg.model.encoder = HRNET_ENCODER
    rows = kernel_phase(cfg, assets, skip={"fused_mha": set(shape_counts(
        flagship_cfg, assets, "fused_mha"))}, label=HRNET_ENCODER)
    bwd = conv_backward_phase(cfg, assets, dtypes=("bfloat16",), seed=17)
    serve = serve_phase(cfg, assets, gpu_line, "hrnet-serve")
    errs = parity_phase(cfg, assets, tag="hrnet-parity")
    train = train_run_phase(cfg, assets, gpu_line, "hrnet-train", HRNET_TRAIN_STEPS)
    return rows, bwd, dict(serve=serve, parity=errs, train=train)


def _norm1_decayed(cfg):
    """A `train_run_phase` check for the Chebyshev trunk: no gradient reaches
    a block's norm1 (the reference computes it and drops it), so AdamW
    moves it by weight decay alone, as optax does: every norm1 weight of
    the final checkpoint equals one factor, prod over the steps of
    (1 - lr_t·wd) (the trunk's init is 1), every bias stays 0."""
    from renderih_tpu_torch.train.state import checkpoint_state_dict, make_schedule

    def check(run):
        sd = checkpoint_state_dict(run["checkpoint"])
        sched = make_schedule(cfg, TRAIN_SYNTH_N // cfg.train.batch_size)
        want = 1.0
        for step in range(run["final_step"]):
            want *= 1.0 - sched(step) * cfg.train.weight_decay
        names = [k for k in sd if ".GCN_blocks." in k and ".norm1." in k]
        if not names:
            raise AssertionError("no Chebyshev norm1 in the checkpoint")
        # the decay moves each weight by (1 - want), some tens of float32
        # steps at 1: held to 5% of that (rounding of the step-by-step product)
        if not 1.0 - want > 1e-6:
            raise AssertionError(f"the run's decay moves norm1 by {1.0 - want:.3e} only")
        for name in names:
            t = sd[name]
            if name.endswith("bias"):
                bad = bool(t.any())
            else:
                bad = float(((1.0 - t) - (1.0 - want)).abs().max()) > 0.05 * (1.0 - want)
            if bad:
                raise AssertionError(f"{name}: {t.min():.8f}..{t.max():.8f}, expected decay "
                                     f"alone: weights {want:.8f}, biases 0")
        print(f"[norm1] {len(names)} norm1 tensors of the Chebyshev blocks after "
              f"{run['final_step']} AdamW steps: weights all {want:.8f} = prod(1 - lr_t·wd), "
              f"biases 0 (decay alone, as optax)", flush=True)

    return check


def paired_parity_phase(cfg, assets, tag: str) -> dict:
    """The `paired_lr` model of `cfg` and the unpaired one on the card, f32
    (TF32 off), the paired one loaded from the unpaired one's state_dict:
    outputs within `PATH_RTOL` of each output's largest value on 4
    images."""
    import copy

    import numpy as np

    from renderih_tpu_torch.serve import InferenceEngine

    cfg32 = copy.deepcopy(cfg)
    cfg32.train.precision = "f32"
    unpaired_cfg = copy.deepcopy(cfg32)
    unpaired_cfg.model.paired_lr = False
    n = 4
    size = cfg.model.img_size
    images = np.random.default_rng(3).integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    unpaired = InferenceEngine(unpaired_cfg, assets=assets, device=DEVICE, buckets=(n,), seed=0)
    state = {k: v.cpu() for k, v in unpaired.model.state_dict().items()}
    # another seed: the paired weights must come from the state_dict
    paired = InferenceEngine(cfg32, assets=assets, state_dict=state, device=DEVICE,
                             buckets=(n,), seed=1)
    if set(paired.model.state_dict()) != set(state):
        raise AssertionError(f"{tag}: the paired state_dict's keys are not the unpaired ones")
    want, got = unpaired.predict(images), paired.predict(images)
    errs = {}
    for key, ref in want.items():
        errs[key] = float(np.abs(got[key] - ref).max()) / max(float(np.abs(ref).max()), 1e-6)
        if not errs[key] <= PATH_RTOL:
            raise AssertionError(f"{tag} {key}: paired vs unpaired rel max|Δ| {errs[key]:.3e}")
    print(f"[{tag}] paired vs unpaired on the card from one state_dict, f32, TF32 "
          f"off, {n} images: max|Δ| / max|ref| per output: "
          + ", ".join(f"{k}={v:.2e}" for k, v in errs.items()) + f" (limit {PATH_RTOL:g})",
          flush=True)
    return errs


def variant_path_phase(assets, gpu_line: str, flagship_cfg, profile: bool = False) -> dict:
    """The decoder variants (see the module docstring, phase 18); with
    `profile`, each served path's predict at the largest bucket under the
    profiler, as phase 3's."""
    import copy

    cheby = copy.deepcopy(flagship_cfg)
    cheby.model.use_cheby = True
    paired = copy.deepcopy(cheby)
    paired.model.paired_lr = True
    if kernel_shapes(paired, assets) != kernel_shapes(cheby, assets):
        raise AssertionError("paired_lr changed the trunk's kernel calls")
    out = {}
    for tag, cfg in (("cheby", cheby), ("paired-cheby", paired)):
        out[tag] = dict(serve=serve_phase(cfg, assets, gpu_line, f"{tag}-serve",
                                          profile=profile),
                        parity=parity_phase(cfg, assets, tag=f"{tag}-parity"),
                        train=train_run_phase(cfg, assets, gpu_line, f"{tag}-train",
                                              VARIANT_TRAIN_STEPS, check=_norm1_decayed(cfg)))
    out["paired-cheby"]["paired_parity"] = paired_parity_phase(paired, assets,
                                                               "paired-cheby-vs-unpaired")
    return out


def _flat_outputs(out) -> list:
    """A module's outputs (a tensor, or tuples, lists and dicts of them) as
    one list of tensors."""
    import torch

    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = [out[k] for k in sorted(out)]
    return [t for o in out for t in _flat_outputs(o)]


def _card_vs_cpu(label: str, module, inputs: list, grads: bool = False) -> float:
    """`module` (built on the CPU) on `inputs` on the CPU and, a copy, on the
    card: every output within `PATH_RTOL` of its largest value; with
    `grads`, also the gradient of the sum of squares of the outputs with
    respect to each input and parameter. Returns the worst relative gap."""
    import copy

    import torch

    def run(mod, xs):
        xs = [x.clone().requires_grad_(grads) if x.is_floating_point() else x for x in xs]
        outs = _flat_outputs(mod(*xs))
        if not grads:
            return [o.detach() for o in outs]
        sum(o.float().pow(2).sum() for o in outs).backward()
        return ([o.detach() for o in outs] + [x.grad for x in xs if x.requires_grad]
                + [p.grad for p in mod.parameters() if p.grad is not None])

    dev = torch.device(DEVICE)
    with torch.set_grad_enabled(grads):
        want = run(module, inputs)
        got = run(copy.deepcopy(module).to(dev), [x.to(dev) for x in inputs])
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{label} tensor {i}: shape {tuple(g.shape)} vs "
                                 f"{tuple(w.shape)}, or non-finite")
        rel = float((g.cpu() - w).abs().max()) / max(float(w.abs().max()), 1e-6)
        worst = max(worst, rel)
        if not rel <= PATH_RTOL:
            raise AssertionError(f"{label} tensor {i}: card vs CPU rel max|Δ| {rel:.3e}")
    return worst


def library_phase(assets, gpu_line: str) -> tuple:
    """The library modules outside `HandNet` (see the module docstring,
    phase 19): (B1 rows at InterPoint's shapes, result)."""
    import torch

    from renderih_tpu_torch.config import Config
    from renderih_tpu_torch.losses import adapt, focal
    from renderih_tpu_torch.mano.params import to_device
    from renderih_tpu_torch.models import aux_nets, experimental_attn, ktd
    from renderih_tpu_torch.ops.rotation import rodrigues

    dev = torch.device(DEVICE)
    m = Config().model
    widths, verts = tuple(m.gcn_out_dims), assets.left.verts_nums
    heads = 8  # InterPoint's default
    g = torch.Generator(device=dev).manual_seed(19)
    counts = {(v, v, heads, w // heads): 2 for v, w in zip(verts, widths)}
    rows = mha_rows(counts, g, label="InterPoint")
    # the rows' unit on the card: one forward of each InterPoint at BATCH
    for counter in _counters():
        counter.reset()
    with torch.no_grad():
        for w, v in zip(widths, verts):
            x = torch.randn(BATCH, v, w, device=dev, generator=g)
            experimental_attn.InterPoint(w, v, heads).to(dev).eval()(x, x)
    unit_launches = _launches()
    want = {"conv3x3": 0, "fused_mha": sum(counts.values()), "sdf_grid": 0}
    _check_run_launches(f"InterPoint at batch {BATCH} (card run)", unit_launches, want,
                        must_launch=("fused_mha",))
    print(f"[library] one InterPoint forward at each width, batch {BATCH}, on the card: "
          f"{unit_launches['fused_mha']} B1 launches (expected {want['fused_mha']}, at the "
          f"shapes timed above)", flush=True)
    del x
    torch.cuda.empty_cache()

    class _Fn(torch.nn.Module):
        """`fn(*inputs)`, or `fn(module, *inputs)`, as a module."""

        def __init__(self, fn, module=None):
            super().__init__()
            self.fn, self.module = fn, module

        def forward(self, *xs):
            return self.fn(*xs) if self.module is None else self.fn(self.module, *xs)

    torch.manual_seed(19)  # the modules' default init
    gen = torch.Generator().manual_seed(19)
    randn = lambda *shape: torch.randn(*shape, generator=gen)
    b = LIB_BATCH
    checks = {}
    for counter in _counters():
        counter.reset()
    for w, v in zip(widths, verts):
        lf, rf = randn(b, v, w), randn(b, v, w)
        checks[f"InterPoint {w}x{v}"] = _card_vs_cpu(
            f"InterPoint {w}", experimental_attn.InterPoint(w, v, heads).eval(), [lf, rf])
        checks[f"LinearCrossAttention {w}x{v}"] = _card_vs_cpu(
            f"LinearCrossAttention {w}", experimental_attn.LinearCrossAttention(w).eval(),
            [lf, rf])
    attn_launches = _launches()
    want = {"conv3x3": 0, "fused_mha": 4 * len(widths), "sdf_grid": 0}
    _check_run_launches("library attention (card runs)", attn_launches, want,
                        must_launch=("fused_mha",))

    head = ktd.KTDHead(2048).eval()  # the ResNet-50 global feature
    with torch.no_grad():  # the chain's near-0 init scaled up: poses far from 0
        for lin in (head.decshape, head.deccam, *head.joint_reg):
            lin.weight.mul_(300.0)
    checks["KTDHead"] = _card_vs_cpu("KTDHead", head, [randn(b, 2048)])
    with torch.no_grad():
        pose6d, shape, cam = head(randn(b, 2048))

    class _KTDMano(torch.nn.Module):
        def __init__(self, mano):
            super().__init__()
            self.mano = mano

        def _apply(self, fn, recurse=True):  # .to(device) moves the MANO model
            self.mano = to_device(self.mano, fn(torch.zeros(1)).device)
            return self

        def forward(self, p, s, c):
            return ktd.ktd_mano_outputs(self.mano, p, s, c, m.img_size)

    checks["ktd_mano_outputs"] = _card_vs_cpu("ktd_mano_outputs", _KTDMano(assets.right.mano),
                                              [pose6d, shape, cam], grads=True)
    nb = 2  # the conv nets at a ResNet-50 pyramid's widths, 256² input
    pyramid = [randn(nb, c, 256 // s, 256 // s) for c, s in
               ((2048, 32), (1024, 16), (512, 8), (256, 4))]
    checks["FPN"] = _card_vs_cpu(
        "FPN", _Fn(lambda fpn, *maps: fpn(list(maps)), aux_nets.FPN((2048, 1024, 512, 256))),
        pyramid)
    checks["CBAM"] = _card_vs_cpu("CBAM", aux_nets.CBAM(256).eval(), [randn(nb, 256, 32, 32)])
    checks["HourglassHead"] = _card_vs_cpu("HourglassHead", aux_nets.HourglassHead(256).eval(),
                                           [randn(nb, 256, 64, 64)])
    checks["CrossHandInjection"] = _card_vs_cpu(
        "CrossHandInjection", aux_nets.CrossHandInjection(256, 256).eval(),
        [randn(nb, 256, 16, 16), randn(nb, 256, 16, 16)])
    checks["PoseDiscriminator"] = _card_vs_cpu(
        "PoseDiscriminator", aux_nets.PoseDiscriminator().eval(),
        [rodrigues(randn(b, 15, 3))], grads=True)

    hms = randn(b, 21, 64, 64) * 3
    target = (torch.rand(b, 21, 64, 64, generator=gen) > 0.9).float()
    checks["sigmoid_focal_loss"] = _card_vs_cpu(
        "sigmoid_focal_loss", _Fn(focal.sigmoid_focal_loss), [hms, target], grads=True)
    checks["dice_loss"] = _card_vs_cpu(
        "dice_loss", _Fn(lambda x, t: focal.dice_loss(torch.sigmoid(x), t)),
        [hms, target], grads=True)

    src, tgt = randn(b, 2048), randn(b, 2048)
    checks["domain_adaptation_loss"] = _card_vs_cpu(
        "domain_adaptation_loss",
        _Fn(lambda disc, s, t: adapt.domain_adaptation_loss(disc, s, t, lam=0.5),
            adapt.DomainDiscriminator(2048)), [src, tgt], grads=True)
    # the reversal on the card: the features' gradient is -lam times the
    # gradient of the same loss without it
    disc = adapt.DomainDiscriminator(2048).to(dev)
    feats = torch.cat([src, tgt]).to(dev).requires_grad_(True)
    labels = torch.cat([torch.ones(b), torch.zeros(b)]).to(dev)
    bce = lambda x: torch.nn.functional.binary_cross_entropy_with_logits(disc(x), labels)
    plain = torch.autograd.grad(bce(feats), feats)[0]
    reversed_ = torch.autograd.grad(bce(adapt.gradient_reversal(feats, 0.5)), feats)[0]
    gap = float((reversed_ + 0.5 * plain).abs().max()) / float(plain.abs().max())
    if not gap <= 1e-6:
        raise AssertionError(f"gradient_reversal: the gradient is not -0.5 x the plain one "
                             f"({gap:.3e})")
    checks["gradient_reversal"] = gap
    print(f"[library] card (f32, TF32 off) vs CPU, batch {b} (conv nets {nb}), at the "
          f"decoder's widths {widths} on {verts} vertices: worst rel max|Δ| per module "
          + ", ".join(f"{k}={v:.2e}" for k, v in checks.items())
          + f" (limit {PATH_RTOL:g}; gradient_reversal: -lam x the plain gradient, 1e-6); "
          f"B1 launches in the attention modules {attn_launches['fused_mha']} (expected "
          f"{want['fused_mha']}: D = " + "/".join(str(w // heads) for w in widths)
          + " in InterPoint, " + "/".join(str(w // 4) for w in widths)
          + f" in LinearCrossAttention) on {gpu_line}", flush=True)
    torch.cuda.empty_cache()
    return rows, dict(checks=checks, launches=attn_launches, unit_launches=unit_launches)


def gan_phase(assets, gpu_line: str) -> dict:
    """The GAN pose prior (see the module docstring, phase 20)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from renderih_tpu_torch.kernels import _build
    from renderih_tpu_torch.optimize.geo import (
        POSE_PRIOR_PATH,
        load_pose_prior,
        make_gan_pose_prior,
    )
    from renderih_tpu_torch.tools import train_pose_prior

    synth = synth_phase(assets, gpu_line, prior="gan", tag="gan-synth")
    params = load_pose_prior(POSE_PRIOR_PATH)
    priors = {d: make_gan_pose_prior(params, d) for d in ("cpu", DEVICE)}
    rng = np.random.default_rng(20)
    poses = (rng.normal(size=(8, 45)) * np.linspace(0.3, 1.5, 8)[:, None]).astype(np.float32)
    worst_e = worst_g = 0.0
    for pose in poses:
        res = {}
        for d, prior in priors.items():
            x = torch.from_numpy(pose).to(d).requires_grad_(True)
            e = prior(x)
            e.backward()
            res[d] = (float(e.detach()), x.grad.cpu().numpy())
        (e_cpu, g_cpu), (e_card, g_card) = res["cpu"], res[DEVICE]
        worst_e = max(worst_e, abs(e_card - e_cpu) / max(1.0, abs(e_cpu)))
        worst_g = max(worst_g, float(np.abs(g_card - g_cpu).max()) / max(1.0, np.abs(g_cpu).max()))
    if not (worst_e <= 1e-5 and worst_g <= 1e-5):
        raise AssertionError(f"GAN prior card vs CPU: energy {worst_e:.3e}, gradient "
                             f"{worst_g:.3e} (limit 1e-5)")
    print(f"[gan-prior] energy and gradient of the shipped discriminator's prior on 8 seeded "
          f"poses, card vs CPU (f32, TF32 off): rel max|Δ| {worst_e:.2e} / {worst_g:.2e} "
          f"(limit 1e-5)", flush=True)
    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)  # build/, git-ignored
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
        run = train_pose_prior.main(["--out", os.path.join(tmp, "prior.npz"), "--steps",
                                     str(PRIOR_STEPS), "--device", DEVICE])
    losses = run["losses"]
    if not (np.isfinite(losses).all() and losses[-50:].mean() < 0.5 * losses[:10].mean()):
        raise AssertionError(f"train_pose_prior: loss {losses[:10].mean():.4f} -> "
                             f"{losses[-50:].mean():.4f}")
    print(f"[gan-prior] train_pose_prior --steps {PRIOR_STEPS} on the card: LSGAN loss "
          f"{losses[:10].mean():.4f} (steps 1-10) -> {losses[-50:].mean():.4f} (last 50), "
          f"accuracy {run['accuracy']:.3f}; mean realism logit plausible "
          f"{run['real_logit']:.3f} > randomized {run['fake_logit']:.3f}; "
          f"{run['steps_per_s']:.1f} steps/s on {gpu_line}", flush=True)
    return dict(synth=synth, energy_gap=worst_e, grad_gap=worst_g,
                train=dict(run, losses=losses.tolist()))


def _checkpoint_gap(path_a: str, path_b: str) -> tuple:
    """Checkpoint b against a, tensor by tensor (the model, every optimizer
    state, the EMA): the largest max|Δ| over the tensor's largest |a|, the
    share of tensors equal bit for bit, and whether the step counters and
    the optimizer's param group agree."""
    import torch

    load = lambda p: torch.load(f"{p}/state.pt", weights_only=True, map_location="cpu")
    a, b = load(path_a), load(path_b)

    def tensors(blob):
        out = {f"model/{k}": v for k, v in blob["model"].items()}
        for i, st in blob["optimizer"]["state"].items():
            out.update({f"optimizer/{i}/{k}": v for k, v in st.items() if torch.is_tensor(v)})
        out.update({f"ema/{k}": v for k, v in (blob["ema"] or {}).items()})
        return out

    ta, tb = tensors(a), tensors(b)
    if ta.keys() != tb.keys():
        raise AssertionError(f"checkpoints {path_a} and {path_b} hold other tensors: "
                             f"{sorted(ta.keys() ^ tb.keys())[:4]}")
    worst, equal = 0.0, 0
    for k, va in ta.items():
        va, vb = va.double(), tb[k].double()
        err, scale = float((va - vb).abs().max()), float(va.abs().max())
        worst = max(worst, err / scale if scale > 0 else (0.0 if err == 0 else float("inf")))
        equal += bool(torch.equal(va, vb))
    groups = lambda blob: [{k: v for k, v in g.items()} for g in blob["optimizer"]["param_groups"]]
    same = ((a["step"], a["steps_taken"]) == (b["step"], b["steps_taken"])
            and groups(a) == groups(b))
    return worst, equal / len(ta), same


def _world_step(cfg, assets, batch: dict, rows, device: str, branches) -> dict:
    """One SGD step of `cfg` from `init_model`'s seed-0 weights with the
    encoder's BatchNorm biases raised by `BN_BIAS_SHIFT` (phase 9), on the
    global rows `rows` of `batch` (all of it without a group), inside
    `branches` (`utils/branches.py`): the terms, gradients and BatchNorm
    statistics, on the CPU, and what `branches` yielded."""
    import torch

    from renderih_tpu_torch.models import init_model
    from renderih_tpu_torch.models.layers import BatchNorm2d
    from renderih_tpu_torch.train.state import create_train_state
    from renderih_tpu_torch.train.trainer import make_train_step

    model = init_model(cfg, assets, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for mod in model.encoder.modules():
            if isinstance(mod, BatchNorm2d):
                mod.bias += BN_BIAS_SHIFT
    model = model.to(device, memory_format=torch.channels_last)
    state = create_train_state(cfg, model, 10)
    local = {k: (v if rows is None else v[torch.as_tensor(rows)]).to(device)
             for k, v in batch.items()}
    with branches as taken:
        terms = make_train_step(cfg, assets, 10, device)(state, local)
    return dict(terms={k: float(v) for k, v in terms.items()},
                grads={k: p.grad.cpu() for k, p in model.named_parameters()
                       if p.grad is not None},
                bn={k: v.cpu() for k, v in model.state_dict().items()
                    if k.endswith(("running_mean", "running_var"))}), taken


def _rank_branches(taken: list, rows, global_batch: int) -> list:
    """A branch record of the global batch cut to the global rows `rows`
    (every recorded tensor leads with the batch, possibly folded with the
    next axis)."""
    import torch

    rows = torch.as_tensor(rows)
    return [(kind, b.reshape(global_batch, -1, *b.shape[1:])[rows].flatten(0, 1))
            for kind, b in taken]


def _world2_rank(rank: int, workdir: str, cfg, batch: dict, device: str) -> None:
    """Rank `rank` of two on `device` (the card: `cuda:0` for both), a gloo
    group through a `file://` store: `_world_step` on its rows, written to
    `rank{rank}.pt`."""
    import torch
    import torch.distributed

    from renderih_tpu_torch.assets import make_synthetic_assets
    from renderih_tpu_torch.parallel import dist

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    device = dist.init(device, backend="gloo", init_method=f"file://{workdir}/store",
                       rank=rank, world_size=2)
    from renderih_tpu_torch.utils.branches import take_branches

    rows = dist.rank_rows(len(batch["img"]), 2, rank)
    taken = torch.load(f"{workdir}/branches{rank}.pt", weights_only=True)
    out, _ = _world_step(cfg, make_synthetic_assets(0), batch, rows, str(device),
                         take_branches(taken))
    out["routes"] = _routes()  # this process's B2 launches
    torch.save(out, f"{workdir}/rank{rank}.pt")
    torch.distributed.destroy_process_group()


def world2_phase(cfg, assets) -> dict:
    """Two ranks on the one card over gloo against world 1 at the same
    global batch (see the module docstring, phase 21)."""
    import copy
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from renderih_tpu_torch.data.synthetic import synthetic_batch
    from renderih_tpu_torch.kernels import _build
    from renderih_tpu_torch.parallel import dist
    from renderih_tpu_torch.utils.branches import gradient_gaps, record_branches

    wcfg = copy.deepcopy(cfg)
    wcfg.train.optimizer, wcfg.train.precision, wcfg.train.lr = "sgd", "f32", 1e3
    wcfg.train.warmup_epochs, wcfg.model.dropout = 0, 0.0
    with torch.no_grad():
        batch = synthetic_batch(assets, torch.Generator().manual_seed(2), 2 * WORLD2_BATCH,
                                cfg.model.img_size)
    # world 1 first: its ReLU, max-pool and hard-swish branches are the
    # ranks' (a kink within rounding would otherwise go either way)
    before = _routes()
    one, taken = _world_step(wcfg, assets, batch, None, DEVICE, record_branches())
    b2 = _check_f32_routes("world 1 step", before)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as root:
        for r in range(2):
            torch.save(_rank_branches([(k, b.cpu()) for k, b in taken],
                                      dist.rank_rows(2 * WORLD2_BATCH, 2, r), 2 * WORLD2_BATCH),
                       f"{root}/branches{r}.pt")
        del taken
        device = "cuda:0" if DEVICE == "cuda" else DEVICE
        procs = [ctx.Process(target=_world2_rank, args=(r, root, wcfg, batch, device))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(600)
        codes = [p.exitcode for p in procs]
        for p in procs:
            if p.is_alive():
                p.kill()
        if codes != [0, 0]:
            raise AssertionError(f"the two ranks on the card exited {codes}")
        ranks = [torch.load(f"{root}/rank{r}.pt", weights_only=True) for r in range(2)]
    for r, rank in enumerate(ranks):
        if rank["routes"] != {"simt": 0, "wgmma": 0, "tf32x3": b2}:
            raise AssertionError(f"rank {r}: B2 routes {rank['routes']}; expected world 1's "
                                 f"{b2} launches, all on tf32x3")
    terms = max(abs(ranks[0]["terms"][k] - v) / max(abs(v), 1e-12)
                for k, v in one["terms"].items())
    bn = max(float((ranks[0]["bn"][k] - v).abs().max() / v.abs().max())
             for k, v in one["bn"].items())
    gaps = gradient_gaps(ranks[0]["grads"], one["grads"])
    tight = sum(g <= 1e-4 for g in gaps.values()) / len(gaps)
    worst = max(gaps, key=gaps.get)
    ranks_equal = all(torch.equal(ranks[0]["grads"][k], ranks[1]["grads"][k])
                      for k in gaps) and all(torch.equal(ranks[0]["bn"][k], ranks[1]["bn"][k])
                                             for k in one["bn"])
    print(f"[world2] two ranks on one card over gloo (all_reduce, broadcast on CUDA tensors), "
          f"{cfg.model.encoder} f32, TF32 off, dropout 0, one SGD step at {WORLD2_BATCH} a rank "
          f"(global {2 * WORLD2_BATCH}), the encoder's BatchNorm biases +{BN_BIAS_SHIFT:g}, "
          f"the ranks on world 1's branches, against world 1 at batch {2 * WORLD2_BATCH} "
          f"({b2} B2 launches in each process, all tf32x3): terms rel max|Δ| {terms:.2e} (limit "
          f"1e-4), BatchNorm statistics {bn:.2e} (limit 1e-5), gradients worst {gaps[worst]:.2e} "
          f"({worst}; limit 1.5e-3), {100 * tight:.1f}% of {len(gaps)} tensors within 1e-4 "
          f"(limit 80%); the ranks' gradients and statistics "
          f"{'equal' if ranks_equal else 'DIFFER'}", flush=True)
    if not (terms <= 1e-4 and bn <= 1e-5 and gaps[worst] <= 1.5e-3 and tight >= 0.8
            and ranks_equal):
        raise AssertionError("world 2 on the card left world 1")
    return dict(terms_rel=terms, bn_rel=bn, grad_worst=gaps[worst], grad_share_1e4=tight)


@contextlib.contextmanager
def _tf32_defaults():
    """TF32 as a new process has it (cuDNN on, cuBLAS off), restored after:
    what a torchrun child runs with, beside the f32 checks' TF32 off."""
    import torch

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def ddp_phase(cfg, assets, gpu_line: str, profile: bool = False) -> dict:
    """Data-parallel training, eval and serving at world 1 on the card (see
    the module docstring, phase 21)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from renderih_tpu_torch.apps import eval_interhand
    from renderih_tpu_torch.apps import train as train_app
    from renderih_tpu_torch.kernels import _build
    from renderih_tpu_torch.parallel.mesh import make_mesh
    from renderih_tpu_torch.serve import InferenceEngine

    per_fwd = dict(per_forward(cfg, assets), sdf_grid=0)
    per_step = 2 * per_fwd["conv3x3"]
    spe = TRAIN_SYNTH_N // cfg.train.batch_size
    common = ["--synthetic", "--synth_n", str(TRAIN_SYNTH_N), "--steps", str(DDP_STEPS),
              "--device", DEVICE]
    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)  # build/, git-ignored
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as root, _tf32_defaults():
        yaml = lambda name: _train_yaml(cfg, root, name, log_every=1, eval_every=1000,
                                        save_gap=1, seed=0)
        for counter in _counters():
            counter.reset()
        plain = train_app.main(["--cfg", yaml("plain"), *common])
        _check_run_launches("plain training", _launches(),
                            {"conv3x3": per_step * DDP_STEPS, "fused_mha": 0, "sdf_grid": 0})

        # torchrun, one rank: NCCL, ZeRO-1, the BatchNorm's group path at world 1
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "1", "-m", "renderih_tpu_torch.apps.train", "--multihost",
               "--cfg", yaml("ddp"), *common]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        if proc.returncode:
            raise AssertionError(f"{' '.join(cmd)} exited {proc.returncode}:\n"
                                 f"{proc.stderr[-4000:]}")
        ddp = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])
        launches = ddp["kernel_launches"]
        want = {"conv3x3": per_step * DDP_STEPS, "conv3x3_simt": 0,
                "conv3x3_wgmma": per_step * DDP_STEPS, "conv3x3_tf32x3": 0, "fused_mha": 0,
                "sdf_grid": 0}
        if ddp["world"] != 1 or ddp["final_step"] != DDP_STEPS or launches != want:
            raise AssertionError(f"torchrun apps.train --multihost: {ddp}; expected world 1, "
                                 f"{DDP_STEPS} updates, launches {want}")
        gap, equal, same = _checkpoint_gap(f"{root}/plain/final", f"{root}/ddp/final")
        print(f"[ddp] torchrun --standalone --nproc_per_node 1 -m renderih_tpu_torch.apps.train "
              f"--multihost --synthetic --steps {DDP_STEPS}, Config() at batch "
              f"{cfg.train.batch_size} (NCCL, ZeRO-1, {wall:.1f} s with the launcher): launches "
              f"{launches} ({per_step} B2 a step, all wgmma); its final checkpoint against the "
              f"plain trainer's: worst tensor max|Δ| {gap:.3e} of its largest value (limit "
              f"1e-5), {100 * equal:.1f}% of the tensors equal bit for bit, step counters and "
              f"optimizer group {'equal' if same else 'DIFFER'}", flush=True)
        if gap > 1e-5 or not same:
            raise AssertionError("the DDP world-1 run left the plain trainer")

        # the DDP run's last epoch checkpoint, resumed by the plain trainer
        # for the last step: against the DDP run's own last step, as phase 8
        cut = (DDP_STEPS - 1) // spe
        step0 = cut * spe
        shutil.copytree(f"{root}/ddp/_synth_data", f"{root}/resumed/_synth_data")
        shutil.copytree(f"{root}/ddp/epoch_{cut}", f"{root}/resumed/epoch_{cut}")
        resumed = train_app.main(["--cfg", yaml("resumed"), *common, "--resume", "auto"])
        if resumed["logged"][0][0] != step0 + 1 or resumed["final_step"] != DDP_STEPS:
            raise AssertionError(f"the resumed run did not continue at step {step0 + 1}")
        with open(f"{root}/ddp/metrics.jsonl") as f:
            ddp_terms = {r["step"]: {k[len("train/"):]: v for k, v in r.items()
                                     if k.startswith("train/")}
                         for r in map(json.loads, f) if "train/total" in r}
        ref = ddp_terms[step0 + 1]
        terms = max(abs(resumed["logged"][0][1][k] - v) / max(abs(v), 1e-12)
                    for k, v in ref.items())
        state = _state_gap(f"{root}/ddp/final", resumed["checkpoint"], f"{root}/ddp/epoch_{cut}")
        first = max(abs(ddp_terms[1][k] - v) / max(abs(v), 1e-12)
                    for k, v in plain["logged"][0][1].items())
        print(f"[ddp] step 1's terms, torchrun against plain: rel max|Δ| {first:.3e}; the "
              f"torchrun run's epoch_{cut} checkpoint (step {step0}) resumed by the plain trainer "
              f"to step {DDP_STEPS}, against the torchrun run's step {DDP_STEPS}: terms rel max|Δ| "
              f"{terms:.3e} (limit 1e-4); final state: parameters {state['params']:.3e} of the "
              f"step's largest move, moments {state['moments']:.3e}, statistics "
              f"{state['bn']:.3e} (limit {RESUME_TOL:g}), steps "
              f"{'equal' if state['steps_equal'] else 'differ'}", flush=True)
        if not (terms <= 1e-4 and state["steps_equal"] and state["params"] <= RESUME_TOL
                and state["moments"] <= RESUME_TOL and state["bn"] <= RESUME_TOL):
            raise AssertionError("the DDP checkpoint does not resume under the plain trainer")
    print(f"[ddp] training images/s at batch {cfg.train.batch_size}: torchrun world 1 "
          f"{ddp['images_per_s']:.1f}, plain trainer {plain['images_per_s']:.1f} (medians of "
          f"steps {train_app.WARMUP_STEPS + 1}-{DDP_STEPS}) on {gpu_line}", flush=True)

    # eval and serving on a mesh of the one card, bit for bit against none
    held = {b: hold_path_kernels(cfg, assets, b, seed=40 + i)
            for i, b in enumerate((EVAL_CLI_BATCH, 32, 128))}
    print("[ddp] the eval and serving kernels against their plain versions, max|Δ| B2 "
          "bfloat16 / B1 float32: " + ", ".join(
              f"batch {b} {h['conv3x3']:.3e} / {h['fused_mha']:.3e}" for b, h in held.items()),
          flush=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as root:
        cli = ["--cfg", _train_yaml(cfg, root, "eval"), "--synthetic", "--bs",
               str(EVAL_CLI_BATCH), "--json", "--device", DEVICE]
        one = eval_interhand.main(cli)
        for counter in _counters():
            counter.reset()
        meshed = eval_interhand.main([*cli, "--mesh_data", "1"])
        eval_launches = _launches()
    n_fwd = -(-eval_interhand.SYNTHETIC_N // EVAL_CLI_BATCH)
    _check_run_launches("eval_interhand --mesh_data 1", eval_launches,
                        {k: n * n_fwd for k, n in per_fwd.items()},
                        must_launch=("conv3x3", "fused_mha"))
    timing = ("images_per_sec", "cache_upload_s")
    differ = [k for k in one if k not in timing and not np.array_equal(one[k], meshed[k])]
    print(f"[ddp] eval_interhand --synthetic --bs {EVAL_CLI_BATCH} --mesh_data 1 against no "
          f"mesh: {len(one) - len(timing) - len(differ)} summary values equal bit for bit, "
          f"{len(differ)} differ {differ[:3]}; {meshed['images_per_sec']:.1f} against "
          f"{one['images_per_sec']:.1f} images/s", flush=True)
    if differ:
        raise AssertionError("the mesh eval at 1 device left the one-device eval")
    images = np.random.default_rng(7).integers(0, 256, (160, cfg.model.img_size,
                                                        cfg.model.img_size, 3), dtype=np.uint8)
    engines = [InferenceEngine(cfg, assets=assets, device=DEVICE, seed=0),
               InferenceEngine(cfg, assets=assets, seed=0, mesh=make_mesh(1) if DEVICE == "cuda"
                               else make_mesh(1, devices=[DEVICE]))]
    ref = engines[0].predict(images)
    for counter in _counters():
        counter.reset()
    got = engines[1].predict(images)  # buckets 128 and 32
    _check_run_launches("InferenceEngine(mesh=make_mesh(1))", _launches(),
                        {k: 2 * n for k, n in per_fwd.items()}, must_launch=("conv3x3", "fused_mha"))
    differ = [k for k in ref if not np.array_equal(ref[k], got[k])]
    print(f"[ddp] InferenceEngine(mesh=make_mesh(1)) against mesh=None, 160 images (buckets 128 "
          f"and 32): {len(ref) - len(differ)} outputs equal bit for bit, {len(differ)} differ "
          f"{differ}", flush=True)
    if differ:
        raise AssertionError("the mesh engine at 1 device left the one-device engine")
    del engines
    torch.cuda.empty_cache()
    result = dict(launches=launches, images_per_s=ddp["images_per_s"],
                  plain_images_per_s=plain["images_per_s"], checkpoint_gap=gap,
                  checkpoint_equal_share=equal, resume_terms_rel=terms, resume_state=state,
                  eval_mesh_images_per_s=meshed["images_per_sec"], held=held)
    if profile:
        result["profile"] = _group_step_profiles(cfg, assets)
    return result


def _group_step_profiles(cfg, assets) -> dict:
    """One training step of `cfg` at its batch (seed-0 weights, one
    synthetic batch) under the profiler, first with no process group, then
    in a one-rank group on the card (ZeRO-1, the gradient and term
    all-reduces), the group left after."""
    import tempfile

    import torch
    import torch.distributed

    from renderih_tpu_torch.data.synthetic import synthetic_batch
    from renderih_tpu_torch.kernels import _build
    from renderih_tpu_torch.models import init_model
    from renderih_tpu_torch.parallel import dist
    from renderih_tpu_torch.train.state import create_train_state
    from renderih_tpu_torch.train.trainer import make_train_step

    with torch.no_grad():
        batch = {k: v.to(DEVICE) for k, v in synthetic_batch(
            assets, torch.Generator().manual_seed(3), cfg.train.batch_size,
            cfg.model.img_size).items()}

    def one(label):
        model = init_model(cfg, assets, torch.Generator().manual_seed(0))
        state = create_train_state(cfg, model.to(DEVICE, memory_format=torch.channels_last),
                                   1000)
        step = make_train_step(cfg, assets, 1000, DEVICE)
        return profile_phase(label, lambda: float(step(state, batch)["total"]), top=12)

    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as root, _tf32_defaults():
        out = {"no_group": one(f"one training step at batch {cfg.train.batch_size}, no group")}
        dist.init(DEVICE, init_method=f"file://{root}/store", rank=0, world_size=1)
        try:
            out["world1"] = one(f"the same in a one-rank {torch.distributed.get_backend()} "
                                "group (ZeRO-1, all-reduces)")
        finally:
            torch.distributed.destroy_process_group()
    return out


def _summary(rows: list, launches: int) -> dict:
    """One kernel's totals over the launches of one unit of its path (a
    flagship forward at batch 256; a refined sample; one forward of each
    `InterPoint` width at batch 256)."""
    def total(key):
        return sum(r[key] * r["launches_per_forward"] for r in rows)

    t_bytes, t_ops, t_exps = total("bytes_ms"), total("ops_ms"), total("exps_ms")
    bound = max(t_bytes, t_ops, t_exps)
    return dict(launches=launches, max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=total("ms"), plain_ms=total("plain_ms"),
                bound_ms=bound,
                bound_by="bytes" if t_bytes >= bound else "operations",
                library_ms=None if any(r["library_ms"] is None for r in rows)
                else total("library_ms"))


def _path_rows(rows: list, calls: list) -> list:
    """The rows of `rows` at a path's (shape, dtype) calls, each row's
    `launches_per_forward` the path's calls at it."""
    want = {(n, m, h, d, dname): count for n, m, h, d, dname, count in calls}
    out = []
    for r in rows:
        key = (*r["shape"][1:], r["dtype"])
        if key in want:
            out.append(dict(r, launches_per_forward=want.pop(key)))
    if want:
        raise AssertionError(f"no kernel row at the path's calls {sorted(want)}")
    return out


def _train_summary(rows: list, launches: int) -> dict:
    """B2 over one training step: each shape's forward and dx (a launch
    each) times its launches a forward."""
    def total(key):
        return sum(r[key] * r["launches_per_step"] / 2 for r in rows)

    t_bytes, t_ops = 2 * total("bytes_ms"), 2 * total("ops_ms")
    bound = max(t_bytes, t_ops)
    return dict(launches=launches, max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=total("fwd_ms") + total("dx_ms"),
                plain_ms=total("plain_fwd_ms") + total("plain_dx_ms"), bound_ms=bound,
                bound_by="bytes" if t_bytes >= bound else "operations",
                library_ms=total("library_fwd_ms") + total("library_dx_ms"))


def run(json_path: str | None, profile: bool) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "measures the port on the card only", file=sys.stderr)
        return 2
    try:
        from renderih_tpu_torch.assets import make_synthetic_assets
        from renderih_tpu_torch.config import Config, load_config
        from renderih_tpu_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the renderih_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    logs = _build.build(["conv3x3", "fused_attention", "sdf"], verbose=True)
    for name, log in logs.items():
        print(f"[build] nvcc {' '.join(_build.nvcc_flags(name))} {name}.cu:\n{log.strip()}")
    print(f"[build] {sorted(logs)} built in {time.perf_counter() - t0:.1f} s into "
          f"{_build.BUILD_DIR}", flush=True)
    check_spills(logs)
    if "fused_attention" in logs:  # built in this run
        print_mha_resources(logs["fused_attention"])
    gpu_line = _gpu_line()
    print(f"[card] {gpu_line}", flush=True)

    cfg = Config()
    assets = make_synthetic_assets(0)
    rows = kernel_phase(cfg, assets)
    path = serve_phase(cfg, assets, gpu_line, "path", requests=N_REQUESTS, profile=profile)
    errs = parity_phase(cfg, assets)
    rows["sdf_grid"] = sdf_kernel_phase(assets)
    synth = synth_phase(assets, gpu_line, profile)
    refine = refine_parity_phase(assets)
    on_path = [r for r in rows["sdf_grid"] if r["mesh"] == "hand" and r["grid"] == SYNTH_GRID]
    for r in on_path:
        r["launches_per_forward"] = synth["per_sample"]
    bwd_rows = conv_backward_phase(cfg, assets)
    train = train_phase(cfg, assets, gpu_line, profile)
    train_parity = train_parity_phase(cfg, assets)
    evaluation = eval_phase(cfg, assets, gpu_line, profile)
    recipe_batch = recipe_config(cfg).train.batch_size
    recipe_bwd = conv_backward_phase(cfg, assets, batch=recipe_batch, dtypes=("bfloat16",),
                                     seed=11)
    recipe_held = hold_path_kernels(cfg, assets, recipe_batch, seed=12)
    print(f"[recipe] the path's kernels at batch {recipe_batch} against their plain versions: "
          f"B2 bfloat16 (wgmma) forward and dx above, forward again max|Δ| "
          f"{recipe_held['conv3x3']:.3e}; B1 float32 (the in-training eval) max|Δ| "
          f"{recipe_held['fused_mha']:.3e}", flush=True)
    recipe, recipe_state = recipe_train_phase(cfg, assets, gpu_line, profile)
    mano = mano_train_phase(cfg, assets, gpu_line)
    recipe_parity = recipe_parity_phase(cfg, assets)
    buckets = bucket_phase(cfg, assets)
    aux_serve = aux_serve_phase(cfg, assets, recipe_state)
    http = http_phase(cfg, assets, gpu_line)
    vit_rows, vit = vit_path_phase(assets, gpu_line, cfg)
    hrnet_rows, hrnet_bwd, hrnet = hrnet_path_phase(assets, gpu_line, cfg)
    variants = variant_path_phase(assets, gpu_line, cfg, profile)
    lib_rows, library = library_phase(assets, gpu_line)
    gan = gan_phase(assets, gpu_line)
    ddp = ddp_phase(cfg, assets, gpu_line, profile)
    world2 = world2_phase(cfg, assets)
    data_tools = dataset_tools_phase(cfg, assets, gpu_line)
    corpus = corpus_phase(gpu_line)
    perspective = perspective_phase(cfg, assets, gpu_line)
    demo = demo_phase(cfg, assets, gpu_line)
    pathtrace = pathtrace_phase(assets, gpu_line)
    bf16 = bf16_decoder_phase(cfg, assets, gpu_line)
    f32 = f32_train_phase(assets, gpu_line, profile)
    per_sample_ms = 1e3 * synth["refine_seconds"] / SYNTH_N
    b3_ms = synth["per_sample"] * on_path[0]["ms"]
    print(f"[synth] B3 in a refined sample: {synth['per_sample']} launches x "
          f"{on_path[0]['ms']:.4f} ms = {b3_ms:.2f} ms of {per_sample_ms:.2f} ms "
          f"({100 * b3_ms / per_sample_ms:.1f}%)", flush=True)

    src = "renderih_tpu_torch"
    f32_rows = [r for r in rows["conv3x3"] if r["dtype"] == "float32"]
    kernels = [
        dict(name="conv3x3_same", kernel="conv3x3_wgmma", path="serve", route="cuda",
             source=f"{src}/csrc/conv3x3.cu",
             replaces="renderih_tpu/kernels/conv_pallas.py:160",
             **_summary([r for r in rows["conv3x3"] if r["dtype"] == "bfloat16"],
                        path["launches"]["conv3x3"])),
        dict(name="conv3x3_same", kernel="conv3x3_wgmma", path="train", route="cuda",
             source=f"{src}/csrc/conv3x3.cu",
             replaces="renderih_tpu/kernels/conv_pallas.py:160",
             **_train_summary([r for r in bwd_rows if r["dtype"] == "bfloat16"],
                              train["launches"]["conv3x3"])),
        dict(name="conv3x3_same", kernel="conv3x3_wgmma", path="recipe_train", route="cuda",
             source=f"{src}/csrc/conv3x3.cu", replaces="renderih_tpu/kernels/conv_pallas.py:160",
             **_train_summary(recipe_bwd, recipe["launches"]["conv3x3"])),
        dict(name="fused_mha", path="serve", route="cuda", source=f"{src}/csrc/fused_attention.cu",
             replaces="renderih_tpu/kernels/fused_attention.py:43",
             **_summary([r for r in rows["fused_mha"] if r["dtype"] == "float32"],
                        path["launches"]["fused_mha"])),
        dict(name="fused_mha", path="vit_serve", route="cuda",
             source=f"{src}/csrc/fused_attention.cu",
             replaces="renderih_tpu/kernels/fused_attention.py:43",
             **_summary(_path_rows(vit_rows["fused_mha"] + rows["fused_mha"],
                                   kernel_shapes(load_config(VIT_YAML), assets)["fused_mha"]),
                        vit["serve"]["launches"]["fused_mha"])),
        dict(name="conv3x3_same", kernel="conv3x3_wgmma", path="hrnet_serve", route="cuda",
             source=f"{src}/csrc/conv3x3.cu", replaces="renderih_tpu/kernels/conv_pallas.py:160",
             **_summary([r for r in hrnet_rows["conv3x3"] if r["dtype"] == "bfloat16"],
                        hrnet["serve"]["launches"]["conv3x3"])),
        dict(name="conv3x3_same", kernel="conv3x3_wgmma", path="hrnet_train", route="cuda",
             source=f"{src}/csrc/conv3x3.cu", replaces="renderih_tpu/kernels/conv_pallas.py:160",
             **_train_summary(hrnet_bwd, hrnet["train"]["launches"]["conv3x3"])),
        dict(name="fused_mha", path="interpoint", route="cuda",
             source=f"{src}/csrc/fused_attention.cu",
             replaces="renderih_tpu/kernels/fused_attention.py:43",
             **_summary([r for r in lib_rows if r["dtype"] == "float32"],
                        library["unit_launches"]["fused_mha"])),
        dict(name="conv3x3_same", kernel="conv3x3_wgmma", path="ddp_train", route="cuda",
             source=f"{src}/csrc/conv3x3.cu", replaces="renderih_tpu/kernels/conv_pallas.py:160",
             **_train_summary([r for r in bwd_rows if r["dtype"] == "bfloat16"],
                              ddp["launches"]["conv3x3"])),
        dict(name="sdf_grid", path="synth", route="cuda", source=f"{src}/csrc/sdf.cu",
             replaces="renderih_tpu/kernels/sdf_pallas.py:124",
             **dict(_summary(on_path, synth["launches"]["sdf_grid"]),
                    max_abs_err=max(r["max_abs_err"] for r in rows["sdf_grid"]))),
        dict(name="sdf_grid", path="synth_backgrounds", route="cuda",
             source=f"{src}/csrc/sdf.cu", replaces="renderih_tpu/kernels/sdf_pallas.py:124",
             **dict(_summary(on_path, corpus["synth"]["launches"]["sdf_grid"]),
                    max_abs_err=max(r["max_abs_err"] for r in rows["sdf_grid"]))),
        dict(name="conv3x3_same", kernel="conv3x3_wgmma", path="bf16_validate_train",
             route="cuda", source=f"{src}/csrc/conv3x3.cu",
             replaces="renderih_tpu/kernels/conv_pallas.py:160",
             **_train_summary([r for r in bwd_rows if r["dtype"] == "bfloat16"],
                              bf16["train_launches"])),
        dict(name="conv3x3_same", kernel="conv3x3_tf32x3", path="f32_train", route="cuda",
             source=f"{src}/csrc/conv3x3.cu", replaces="renderih_tpu/kernels/conv_pallas.py:160",
             **_train_summary(f32["conv_backward"], f32["launches"]["conv3x3"])),
        dict(name="conv3x3_same", kernel="conv3x3_tf32x3", path="f32_serve", route="cuda",
             source=f"{src}/csrc/conv3x3.cu", replaces="renderih_tpu/kernels/conv_pallas.py:160",
             **_summary(f32_rows, f32["serve"]["launches"]["conv3x3"])),
        dict(name="conv3x3_same", kernel="conv3x3_simt", path=f"{F32_SIMT_ENCODER}_f32_serve",
             route="cuda", source=f"{src}/csrc/conv3x3.cu",
             replaces="renderih_tpu/kernels/conv_pallas.py:160",
             **_summary([r for r in f32["simt_rows"] if r["route"] == "simt"],
                        f32["simt_serve"]["conv3x3_routes"]["simt"])),
    ]
    if json_path:
        with open(json_path, "w") as f:
            json.dump({"card": gpu_line, "torch": torch.__version__, "rows": rows,
                       "main_path": path, "parity": errs, "synth_path": synth,
                       "refine_parity": refine, "conv_backward": bwd_rows,
                       "train_path": train, "train_parity": train_parity,
                       "eval_path": evaluation, "recipe_conv_backward": recipe_bwd,
                       "recipe_held": recipe_held, "recipe_path": recipe, "mano_path": mano,
                       "recipe_parity": recipe_parity, "buckets": buckets,
                       "aux_serve": aux_serve, "http_path": http,
                       "vit_rows": vit_rows, "vit_path": vit, "hrnet_rows": hrnet_rows,
                       "hrnet_conv_backward": hrnet_bwd, "hrnet_path": hrnet,
                       "variants": variants, "interpoint_rows": lib_rows,
                       "library": library, "gan": gan, "ddp": ddp, "world2": world2,
                       "dataset_tools": data_tools, "corpus": corpus,
                       "perspective": perspective, "demo": demo, "pathtrace": pathtrace,
                       "bf16_decoder": bf16, "f32_train": f32, "kernels": kernels}, f, indent=1,
                      default=float)
    print(gpu_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--json", help="also write every measurement to this file")
    parser.add_argument("--bf16_ab", type=int, metavar="STEPS", default=None,
                        help="only the trained bf16-decoder A/B (validate_bf16_decoder at "
                             "STEPS steps, batch 64) and the bucket gap on its weights")
    parser.add_argument("--profile", action="store_true",
                        help="also print device time by kernel over one flagship "
                             "predict at the largest bucket, one refined sample, "
                             "one training step, one eval batch, one recipe step "
                             "with and without the aux heads, one predict of each "
                             "decoder variant and one training step with no process "
                             "group and in a one-rank group (torch.profiler)")
    args = parser.parse_args()
    try:
        if args.bf16_ab is not None:
            return bf16_ab(args.bf16_ab)
        return run(args.json, args.profile)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())

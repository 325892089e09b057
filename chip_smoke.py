#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cnn_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. environment: the card's name and power limit, torch and CUDA versions;
   TF32 off for every float32 product and convolution;
2. build: one ``nvcc`` per ``cnn_tpu_torch/csrc/*.cu`` for sm_90a, side by
   side; each kernel's registers, shared memory and spills (the strip,
   tiled and bf16 conv, every bf16 strip R, wgmma and tma tile, the pool
   forward's window and element kernels and the window backward in both
   dtypes, the rotation and the wide normalize kernels must not spill);
   ptxas's advisories on wgmma, if any;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the serving path's shapes with batch 64 (normalize and max-pool
   bit-exact, the pool forward through the window kernel and against the
   element kernel, the two timed alone in turns; conv within atol 1e-5 +
   rtol 1e-5), timed with CUDA events
   beside the plain version, one PyTorch library call and the bound, both
   through the wrapper (``time_ms``) and graph-timed (``graph_ms``: 20
   calls captured into one CUDA graph, no host cost); normalize through
   the wide kernel bit-exact on every byte and at B = 1, 8 and 64, beside
   the previous design, ``torch.true_divide`` and the plain version,
   graph-timed L2-warm and HBM-cold (four input/output pairs), one launch
   captured into a graph and replayed bit-exact; conv1
   through the strip kernel and conv2-4 through the tiled one, each equal
   bit for bit to the direct kernel on the same shape and timed beside it
   in turns, every strip R and every tile swept, two launches
   bit-identical; then the branches those shapes do not take (the strip
   conv at B = 1, Cin 1 and 4, Cout 8 and 32, stride 1, k = 5 and a row
   past 128 pixels, through every R; the direct conv with Cout 7, weights
   off 16-byte alignment, x off 16-byte alignment and a row of 669 floats;
   the tiled conv with an M tail, stride 1, k = 5 and Cin 8 / Cout 12,
   normalize at lengths 1, 15, 16, 17 and 1,000,003 and from every input
   byte offset 0-15 into every output float offset 0-15, through the
   variant its plan picks);
4. serving: the full-width 224 px BatchNorm AlexNet from the committed
   reference ``.model`` behind ``InferenceEngine`` (buckets 1, 8, 64, one
   CUDA graph each, captured by ``warmup()``) and ``BatchingServer``; each
   bucket's replay bit-equal to the eager forward; every kernel's launch
   count, per variant, must move as the path dictates through the replays;
   the results must match a fresh engine whose graphs are captured from
   the plain versions on the card (0 launches) and the engine on the CPU;
   the warmup's seconds and memory, each bucket's first call, and the
   bucket-64 forward through the graph beside the eager one;
5. training kernels, at the training shapes (batch 256): the pool forward
   with tap through the window kernel bit-exact against the plain version
   and the element kernel, on +-0 ties and at 7 x 9 x 8 and 5 x 4 x 4, the
   two timed alone in turns (the window kernel must not be the slower)
   beside ATen and the bound; the pool backward
   through the window kernel bit-exact against its plain version and
   against autograd through the plain forward, on 33% exact ties, its
   cropped row and column zero, and against the element kernel (the
   previous design); a 7 x 9 extent with C 8 through the window kernel and
   C 6 through the element kernel; the two timed in turns; the
   rotation on [256,256,256,3] in float32 (bit-exact) and bf16 (within one
   bf16 ulp) at 0, +-15, +-44, +-46, +-75 degrees and random angles, two
   launches bit-identical, through the tiled kernel (the wrapper), each tile
   shape of its plan's table and the previous design, then off that shape
   (B = 1, S = 40 and 100, C = 1, +-100, +-135 and 180 degrees), the tiled
   kernel timed beside the previous design in turns, and every tile; the
   conv Function's dx/dw/db for the four layers, ReLU on and off, within
   1e-5 * max(1, max|ref|) of autograd through the plain conv; the conv
   forward of each layer within atol 1e-5 + rtol 1e-5, bit-identical from
   launch to launch and to the direct kernel, timed beside the direct
   kernel, cuDNN, the plain version and its bound, with every strip R
   (conv1) or tile (conv2-4); each timed beside its plain version, a
   library call and its bound;
6. gradients at full width against the reference C++: one step at lr 1 on
   ``tests/fixtures/grad_parity_bn.npz`` through the normalize, conv and
   pool kernels; logits 1e-4, loss 1e-5, every gradient tensor
   1e-4 * max(1, max|ref|) (BN's B times), moving statistics 1e-4;
7. training: ``make_device_train_step`` on 1,024 synthetic 256 px canvases
   held on the card, full augmentation, BN AlexNet at 224 px, batch 256,
   momentum SGD on a cosine schedule, 40 steps: one step with the kernels
   against the same step on the plain versions (same weights, batch and
   drawn augmentation), finite and falling loss, the exact launch counts
   (conv1 through the strip conv kernel, conv2-4 through the tiled one,
   none through the direct one; the pool backward through the window
   kernel),
   img/s, the device time per step split by stage, and the eval accuracy on
   held-out images;
8. the bf16 conv at each AlexNet layer at batch 256 and B = 64, ReLU off
   and on: conv1 through the strip kernel (its input rows staged whole,
   ``mma.sync`` fragments read from them), conv2-3 through the wgmma kernel
   (a ring of cp.async slices, ``wgmma.mma_async`` from shared memory) and
   conv4 through the tma kernel (im2col and tiled TMA copies into
   128-byte-swizzled stages behind an mbarrier ring), each planned so,
   against the plain bf16 conv: each element within one bf16 ulp of the
   plain value plus 1e-5 x S (S the same conv of |x| and |w|), the count of
   elements that differ at all, two launches bit-identical; alone (and
   HBM-cold at batch 256: inputs taken in turn from copies 120 MB apart),
   through the wrapper, the previous design (the mma.sync kernel; for conv4
   the wgmma kernel) on the same values, plain, cuDNN bf16 beside the
   float32 kernels and cuDNN float32, every strip R, every wgmma tile of BN
   Cout and Cout / 2 and every tma tile swept at batch 256; off those
   shapes (B = 1 and 8, odd extents, Cin 3 and 64 against Cout 16 and 128,
   Cout 8, 24, 48 and 200, the strip at k*Cin 5, 6 and 12 and stride 1, k 5
   at stride 1, x off alignment) through the plan and every variant that
   takes the shape, with every strip R, wgmma, tma and mma.sync tile; then
   the tma kernel with every tile at conv4 (B = 64, 256), the padded 3x3
   and 1x1 family rows and a Cin-128 padded 3x3, and through its plan at
   every family conv with Cin % 64 == 0 (B = 64), PipeCNN's trunk conv and
   conv4 at B = 1, 8 and 256: graph-timed in turns beside the wgmma kernel
   (the tma plan must be the faster), every tile alone, cuDNN + ReLU alone;
   then the padded strips at the six families' Cin-3 stems (3 -> 16, 32,
   64 at stride 2, 3 -> 32, 64 at stride 1, k3 p1, 224 px), float32 and
   bf16 (the widened layout): planned so at B = 1, 8, 64, 256, held to the
   plain conv at B = 1, 8, 64 (float32 bit-equal to the direct kernel,
   bf16 1 ulp + 1e-5 x S) through the wrapper and every strip id that
   takes the shape, two launches bit-identical; at B = 64 graph-timed in
   turns with the kernel each replaces (the direct kernel, the gather),
   every R swept, cuDNN + ReLU alone, the bound; off those shapes (ragged
   strips, Cin 1, 2, 4, padding 2 and 3, k 2, 4, 5, rows past a chunk);
   AlexNet's bf16 conv1 on its natural layout in turns with the widened
   one;
9. the bf16 pool forward with tap and window backward at [256,111,111,16]
   and B = 64 on forced ties (the forward also on +-0 ties) and at 7 x 9 x
   8, 5 x 4 x 8 and (the element forward) 5 x 4 x 4, bit-exact against the
   plain versions, autograd and the forward's element kernel, timed beside
   the float32 kernels and ATen bf16; the window and element forwards
   alone in turns in both dtypes (the window kernel must not be the
   slower), HBM-cold at B = 64; then the forward without the tap at every
   vgg8 and vgg11 pool shape at B = 64 in both dtypes, planned on the
   window kernel, bit-exact, in turns with the element kernel, beside
   the bound;
10. the conv Function in bf16 at the four training shapes: dx/dw/db within
   2 bf16 ulps of max|ref| of autograd through the plain bf16 conv;
   forward+backward timed in bf16 and float32;
11. bf16 training: the configuration of phase 7 with
   ``compute_dtype=bf16`` and ``augment_batch(dtype=bf16)``, 40 steps:
   finite, falling loss, eval accuracy, img/s and the device split beside
   phase 7's, the exact bf16 launch counts (conv1 on the strip kernel,
   conv2-3 on the wgmma kernel, conv4 on the tma kernel; no mma.sync conv,
   no float32 conv or pool kernel), the cuBLAS reduced-precision flag;
12. bf16 serving: ``InferenceEngine(compute_dtype=bf16)`` on the committed
   checkpoint, buckets 1, 8, 64: replays bit-equal to the eager bf16
   forward, exact launch counts (conv1 on the strip kernel, conv2-3 on the
   wgmma and conv4 on the tma kernel at every bucket), labels,
   probabilities and logits against the float32 engine (logits within 5e-2
   x max(1, max|ref|), probs 5e-2), bucket-64 img/s and graph ms beside
   float32, per-layer eager times;
13. the committed ``checkpoints/alexnet_bn_device/iter_12000_*.ckpt`` read
   through ``utils/checkpoint.py:load_checkpoint``: step 12000, logits
   bit-equal to those of the ``.model`` beside it;
14. the train CLI (``cnn_tpu_torch.tools.train.main``, in-process) on 1,280
   synthetic 304 x 280 PPM images in 3 classes, split 8:1:1 (whether PIL
   imports is printed; PPM decodes without it): the flagship flags
   (device dataset, full augmentation, bf16, BN, momentum on a cosine
   schedule, batch 256) for 60 iterations, validating every 20; then
   ``--resume auto`` to iteration 80; then the host loader with the fast
   device augmentation in float32 at batch 64 for 20 iterations. Each run:
   exit code 0, "training done!", its checkpoint names, the exact launch
   counts with the counters at 0 just before it (per train step 4 conv,
   1 pool forward, 1 pool backward and, under the full policy, 1 rotation;
   per eval batch 1 normalize, 4 conv, 1 pool forward); the history's
   steps and its logged mean loss falling; the best checkpoint reloaded
   gives the logged valid accuracy, and its exported ``.model`` gives
   bit-equal logits and predictions through ``InferenceEngine``; the wall
   seconds of decode, upload, the training loop (synchronised, validation
   taken out), validation and the final test;
15. inference and Grad-CAM (``tools/infer.py``, ``tools/gradcam.py``,
   in-process) on the six photos of ``tests/fixtures/reference_parity.npz``
   written as PPM: infer from the committed ``.model`` and its ``.ckpt``
   prints dog, panda, bird twice, each probability within 1e-6 of
   ``InferenceEngine`` (bucket 1), 1 normalize, 4 conv (1 strip, 3 tiled)
   and 1 pool per image; ``--bench``'s p50 and p90; Grad-CAM at
   ``conv_layer_3`` in both modes and at ``relu_layer_1``: the PNGs read
   back equal to the heatmaps, the classes, each CAM within 1e-4 of the
   plain versions on the card, the exact launches (the tail's conv and
   pool Functions; the pool backward window kernel once per image at
   ``relu_layer_1``); a seeded AlexNet without BN at ``conv_layer_3``
   (a conv fused with its ReLU, captured) against the plain versions;
16. evaluation (``tools/evaluate.py``) on phase 14's best checkpoint and
   images: ``--split both`` in bf16 reprints the train CLI's own test line
   and confusion matrix, ``--split both`` in float32, ``--tta flips``
   (four views a batch), an ``--ensemble`` with the iteration-60
   checkpoint, each with exact launch counts; then the flagship train CLI
   with ``--dropout 0.25`` for 20 iterations: a forward hook on the
   Dropout layer holds each training step to 32 of conv4's 128 channels
   zeroed and the rest scaled by 1/0.75, eval to the identity; a finite
   logged loss. Each run's wall seconds beside the card's name and power
   limit;
17. the families served: resnet10, mobilenet and pipecnn from their
   committed ``.ckpt``, resnet18, vgg8 and vgg11 seeded (BN statistics
   from 20 training-mode forwards), each at 224 px behind
   ``InferenceEngine`` (buckets 1, 8, 64, one CUDA graph each) in float32
   and bf16: one forward launches one conv per Conv2D layer (the padded
   Cin-3 stem on a padded strip, counted by ``launches_strip_padded`` /
   ``launches_bf16_strip_padded``; none on the direct kernel or the
   gather) and one pool per MaxPool2D;
   every conv launch of a forward on the six fixture photos (and two
   mirrored) against the plain conv on the same activations (float32
   within atol 1e-5 + 1e-5 x S and bit-equal to the direct kernel, bf16
   within 1 bf16 ulp + 1e-5 x S, two launches bit-identical); each
   bucket's replay bit-equal to its eager forward; exact launches over a
   counted predict of the photos and of 64 images; float32 logits within
   1e-4 x max(1, max|ref|) of ``tests/fixtures/family_logits.npz`` (the
   checkpointed ones) or of the plain versions on the card (the seeded
   ones), the photos classified alike; bf16 within 5e-2 x max(1,
   max|f32|) of float32; bucket-64 img/s end to end, graph and eager ms;
18. the families trained: the conv Function at a padded stem, a padded
   stride-1 3x3 and a 1x1 (batch 8) against autograd through the plain
   conv (float32 against it in float64, 1e-4 x max(1, max|ref|); bf16 2
   ulps); PipeCNN's peak memory for one float32 step at batch 256 under
   remat False, 'full' and 'conv' ('conv' between the two); then
   ``tools.train --name`` at the flagship's flags on phase 14's images:
   resnet10 fresh in bf16 and float32 for 40 iterations and resumed from
   a copy of its committed checkpoint for 20, mobilenet, pipecnn (remat
   'conv') and vgg8 for 20 in bf16; each run's launches exact (one conv
   launch per Conv2D layer a step, none recomputed), its losses finite,
   the fresh resnet10 runs' last 5 below their first 5, its checkpoint
   read back equal through a fresh train state; img/s over the loop and
   device ms a step. The kernels line gains the conv rows of the five
   padded stem shapes (their launches: the padded strips' counters in
   their families' counted runs), the padded 3x3 and the 1x1, float32 and
   bf16, timed at B=64 through the wrapper and alone beside cuDNN + ReLU
   alone, and the tma kernel's row (its launches over every counted run,
   timed at conv4, B = 64);
19. the training toolbox through ``tools.train`` at the flagship's flags on
   phase 14's images (its device datasets made once and shared), 20
   iterations each in float32 and bf16: plain AlexNet; AlexNet with
   ``--optimizer adam --weight-decay 1e-4 --grad-clip 1.0 --ema 0.999
   --mixup 0.2 --cutmix 1.0 --color-jitter 0.2``; with ``--grad-accum 4
   --steps-per-call 4``; distilled from the committed resnet10 (the
   teacher's eval forward, padded stem strips included, inside the step);
   resnet10 warm-started from the committed ``resnet10_cat4_transfer`` EMA
   checkpoint with ``--num-classes 3 --freeze stem`` (the head kept fresh,
   the stem's params bit-unchanged, every other block moved). Each run:
   exit code 0, finite losses, the exact launch counts (a step: a forward
   of each model per microbatch, the student's backward, one rotation;
   none on the direct or gather conv), the device ms a step (CUDA events)
   beside the plain run's. Then the
   evaluate CLI on ``alexnet_distill`` and ``resnet10_cat4_transfer``
   (a 4th class made of the birds) and ``infer --use-ema`` on the six
   photos: "evaluating the EMA-averaged weights", the EMA models' logits
   through the kernels within 1e-4 x max(1, max|ref|) of the plain
   versions on the card, the printed probabilities within 1e-5.

20. MoECNN, AlexNet's space-to-depth convs, Grad-CAM at every family and
   in a trunk, whole-model remat: the committed MoECNN (width 64, 8
   experts, hidden 256, 224 px) served at buckets 1, 8 and 64 in float32
   and bf16 (phase 17's checks; the six photos' logits, as one batch of 6,
   within 1e-4 x max(1, max|ref|) of ``family_logits.npz``, their top-2
   router probabilities more than 1e-4 apart), a request of 5 images in
   bucket 8 bit-equal to the eager forward of the same 5 and 3 zero
   images; a seeded MoECNN with ``balance_coeff`` 0.01 through 5 train
   steps at batch 256 in each dtype (finite losses, the aux loss above 0,
   the loads printed, launches exact); ``tools.train --name moecnn
   --moe-balance 0.01`` at the flagship's flags for 20 iterations (the
   ``MoE load`` line, ``moe_load`` in the history), then ``tools.infer``
   and ``tools.gradcam --layer stem_relu4`` on its checkpoint. AlexNet
   with ``space_to_depth`` from the committed ``.model`` (its s2d convs
   run as the stride-2 convs they compute): every conv launch against the
   plain conv, one forward's launches those of the plain AlexNet, served
   at B = 64 with logits bit-equal to the plain AlexNet's, 5 train steps
   at batch 256 in each dtype; no launch of the direct kernel or the
   gather. ``tools.gradcam`` on the photos for resnet10 ``block_4``,
   pipecnn ``trunk/block_3`` and ``trunk/block_3/b_conv1`` and moecnn
   ``stem_relu4``, each CAM within 1e-4 of the plain versions on the card
   (1e-3 inside the trunk), launches six times one image's. One training
   step of AlexNet (BN, Dropout) and of MoECNN at batch 256 with
   ``remat`` True and False, cuDNN deterministic: gradients, loss, state
   and generator bit-equal, the peak memory of each. The kernels line
   gains MoECNN's 64 -> 64 stride-2 conv, float32 and bf16, timed at 112
   px; its launches are those of all three such convs (112, 56 and 28
   px), the counters telling the sizes apart no more than the stem rows
   of phase 17 do (MoECNN's 3 -> 64 stem counts on stem_64's).
21. BN folding, int8 serving, streaming, artifacts, the TCP server and the
   leftover CLIs, on the five models of ``tests/fixtures/serving_logits.npz``
   (the committed BN AlexNet ``.model`` and the newest resnet10,
   mobilenet, pipecnn and moecnn ``.ckpt``), 224 px, buckets 1, 8, 64:
   ``quant.fold_batchnorm``'s model behind ``InferenceEngine`` in float32
   and bf16 through phase 17's checks (one conv launch per folded conv, the
   stems on the padded strips, none on the direct kernel or the gather,
   every conv launch against the plain conv, replays bit-equal to the
   eager forward, exact launches), no call of a BatchNorm2D (forward hooks
   on the unfolded model's BN modules, and BN's eval function counted),
   one fused ``relu=True`` launch per conv -> ReLU pair, the photos'
   logits (one batch of 6) within 1e-4 x max(1, max|ref|) of the fixture
   with its classes (bf16 within 5e-2), and the bucket-64 graph and eager
   forward timed in turns with the unfolded model's; the int8 engine
   calibrated on the six photos: one forward launches the normalize
   kernel and the float32 pools only, each ``torch._int_mm`` accumulator
   equal to the float64 product and each depthwise one to the CPU's, the
   photos' probabilities within 1e-2 of the fixture's with its classes and
   within 0.1 of float32's, replays bit-equal, exact launches, the
   bucket-64 graph in turns with the float32 folded one and every int8
   product of a bucket-64 forward timed alone beside its bound; AlexNet's
   ``predict_stream`` over 64 images at depth 8 (float32 folded and int8)
   bit-equal to ``predict``, in order; float32, bf16 and int8 artifacts of
   AlexNet exported on the card, loaded and served by ``from_artifact``
   (each bucket's graph launching what its engine's does, predictions
   bit-equal to the engine's, or within 1e-6 with the reason printed), each
   file's size; ``serve_tcp`` on port 0 with four concurrent clients
   sending the photos as PPM frames, an undecodable frame and an oversized
   length (replies equal to ``predict``'s lines and the ERROR lines); the
   serve CLI (stdin, ``--stream``, ``--int8``, ``--artifact``),
   export_artifact, convert (the round trip's ``.model`` bytes equal to
   the original's), plot (the ASCII branch) and make_gif (phase 15's
   Grad-CAM PNGs), each run's wall seconds.
22. the host augmentation, ``--compile-cache`` and captured calls: the
   port's ``ImageAugmentor`` against ``tests/fixtures/host_augment.npz``
   (cnn_tpu's, through cv2, which this machine lacks); the host loader's
   seconds per batch on phase 14's images with and without ``augment``;
   each device-dataset call as one CUDA graph against the eager loop
   under cuDNN's deterministic mode, 4 calls of 4 steps at batch 64: every
   parameter, model state and optimizer tensor (counts included), the
   metrics of each call, the step, the generator's next draw and every
   kernel counter bit-equal, for the flagship flags in float32 and bf16,
   grad-accum 4, each sample mode, AdamW + clip + EMA + MixUp + CutMix +
   jitter, a resnet10 teacher, resnet10 with its stem frozen, MoECNN's
   balance loss and PipeCNN's block remat; device and host ms per step,
   eager against captured, for bf16 AlexNet at batch 256 and 1, 4 and 16
   steps a call, and for grad-accum 4 x 4 steps a call against the plain
   step; then ``python -m cnn_tpu_torch.tools.train``'s main in two fresh
   processes on phase 14's images at batch 64 for 20 iterations, both
   with ``--compile-cache DIR``: ``cnn_tpu``'s default host augmentation
   (the first builds the kernel library into DIR and prints its seconds)
   and ``--augment false`` (started once the library is in DIR: it loads
   it without building); finite losses, exact launches (no rotation), the
   default ``build/`` root left as it was.
23. data and tensor parallelism on ``torch.distributed``, two ranks on
   the one card over gloo: the flagship AlexNet (BN, 224 px, full device
   augmentation, momentum on a cosine schedule) in float32, one
   ``'global'``-sampling device-dataset step at batch 256 on a DP2 and on
   a TP2 mesh (two processes, ``phase23_rank``) against the one-process
   port step on the same seed (every param, BN statistic and optimizer
   leaf within 1e-4 x max(1, max|ref|), the two ranks bit-equal), then a
   sharded eval batch; each rank's counters exact (the conv per variant at
   its Cout/2 shapes under TP, pool, rotation, normalize; no direct or
   gather conv); device and wall ms per step of each mesh and of the one
   process (eager and captured); the train CLI with ``--multihost`` as two
   processes, ``--data-parallel 2`` and ``--model-parallel 2``, each 10
   iterations of the bf16 flagship: the same loss lines on both, exact
   launches per rank, one checkpoint written by process 0 alone, which
   reads back as the full tree; ``tools.multihost_smoke`` as two
   processes with the same loss on both; and a world-size-1 NCCL mesh,
   in this process, whose captured device-dataset call (the NCCL
   collectives in its graph) is bit-equal to its eager loop under cuDNN's
   deterministic mode.
24. the ``'spatial'`` and ``'expert'`` axes, two ranks on the one card over
   gloo: BN's float64-summed statistics timed against float32 means at
   conv1's training shape; the flagship's float32 ``'global'`` device
   step and an eval batch on an SP2 mesh (image rows in strips, the halo
   exchange feeding the strip, tiled and pool kernels), resnet10 at 224
   px on SP2 in float32 (the tiled kernel at its padded 3x3s and 1x1
   projections) and in bf16 (wgmma and "tma"), MoECNN at its defaults on
   EP2 (four of its eight experts a rank), one train step and one eval
   batch each (``phase24_rank`` in two processes), against the
   one-process step on the same seed: every param, BN statistic and
   optimizer leaf within 1e-4 x max(1, max|ref|) (bf16 within the bf16
   model bar, 5e-2), MoE's load within 1e-6, the eval predictions equal,
   the ranks bit-equal; each rank's launches (conv, pool and tma
   nonzero, no direct or gather conv), the halo rows a step exchanges,
   device and wall ms per step of each mesh and of one process; then the
   train CLI with ``--multihost`` as two processes, ``--spatial-parallel
   2`` (the bf16 flagship: launches per rank exactly one process's) and
   ``--expert-parallel 2 --name moecnn``, 10 iterations each: the same
   lines on both ranks, one checkpoint written by process 0 alone, which
   reads back;
25. pipeline parallelism over a ``'stage'`` axis, two ranks on the one
   card over gloo (``phase25_rank``): PipeCNN at its defaults (width 64,
   8 blocks, 224 px, BN, remat 'conv'), one float32 step at batch 64 on
   a PP2 mesh from the seeded state: GPipe at M = 1 against the
   one-process step, 1F1B and interleaved 1F1B (V = 2) at M = 4 against
   GPipe at M = 4 (every param, BN statistic and momentum leaf within
   1e-4 x max(1, max|ref|)), bf16 GPipe at M = 4 against its float32
   step (5e-2); the ranks' gathered trees bit-equal, the stage hops each
   schedule makes, each rank's launches (the padded strip, tiled, bf16
   "tma"; no direct or gather conv), device and wall ms per step beside
   one process; peak memory per rank at M = 8, 1F1B's below GPipe's on
   stage 0; the committed PipeCNN's logits through ``make_pp_forward`` at
   M = 2 within 1e-4 of ``tests/fixtures/family_logits.npz`` with its
   classes, and ``make_pp_eval_step`` with ``tta='flips'`` equal to one
   process's; then the train CLI as two processes, ``--pipeline-stages 2
   --data-parallel 1 --name pipecnn`` in bf16 with the device
   augmentation, 1F1B at M = 4 and interleaved (``--virtual-stages 2``),
   4 iterations each: finite losses, the same lines on both ranks, the
   checkpoint process 0 writes equal to both ranks' gathered trees; and
   ``tools/multihost_pp_smoke.py`` as four processes, its four OK lines.
26. the native loader: the resize kernel (``csrc/resize.cu``, cv2's
   fixed-point INTER_LINEAR for a whole batch in one launch) bit-equal to
   its plain version on 64 images of 18 shapes (phase 14's PPM size, a
   photo's 375 x 500, a pixel, a row, a column, exact 2x downscales,
   upscales) to 224 and to the 256 canvas, and to ``data/image.py``'s
   ``resize`` at 224; alone, through the wrapper and plain, beside its
   bound (no library call computes cv2's rounding); ``DataLoader(backend=
   'native')`` bit-equal to the Python path over phase 14's validation and
   test images, one launch a batch, and the seconds a batch of both
   streams; the train CLI (the host loader, batch 64) and the evaluate CLI
   with ``--backend native --cache false``, exact launches (a resize a
   batch the loaders assembled), the evaluation's lines equal to the
   Python path's; every family's FLOPs per image (``utils/flops.py``).

27. MaxPool2D at any window, the fast device augmentation, --profile-dir:
   the BN AlexNet with its pool the overlapping 3x3 stride-2 one, beside
   the flagship's 2x2 one, both from the committed ``.ckpt`` through
   ``load_jax_params``, served at buckets 1, 8 and 64 in float32 and bf16
   (each replay bit-equal to the eager forward; a counted predict of the
   3x3 model launching exactly the 2x2 model's counters less the pool's;
   its float32 logits within 1e-4 of the plain versions on the card, bf16
   within 5e-2 x max(1, max|f32|) of float32, the photos' classes equal) and
   trained 10 device-dataset steps at batch 256 with the full augmentation
   in each dtype (finite losses, the mean of the last 5 below the first 5,
   the flagship's launches less the pool's), no call of the 2x2 pool's
   plain version on a CUDA tensor throughout; ``make_device_train_step``
   with ``augment_batch_fast`` in float32 and bf16, captured against the
   eager loop under phase 22's rules; ``python -m
   cnn_tpu_torch.tools.train --profile-dir`` for 4 iterations of the
   float32 flagship in a fresh process: its ``trace.json`` names the
   port's conv, normalize and rotation kernels among its CUDA kernel
   events, whose counts are printed. The 3x3 model's SP2 eval is not run
   here: two fresh processes would cost phase 23's start-up; the CPU tests
   hold its halo path against ``cnn_tpu``.

Every phase prints one flushed line with the seconds since start. Any failed
check raises, so the exit code is not 0. Without a CUDA device it exits 1
before printing any result. The line before the last is the kernel table as
JSON; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import functools
import io
import itertools
import json
import os
import re
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import ExitStack, contextmanager, redirect_stdout
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

import cnn_tpu_torch.nn.module as nn_module
import cnn_tpu_torch.ops.pool as pool_ops
import cnn_tpu_torch.quant as quant
import cnn_tpu_torch.serving as serving
import cnn_tpu_torch.tools.convert as convert_cli
import cnn_tpu_torch.tools.evaluate as evaluate_cli
import cnn_tpu_torch.tools.export_artifact as export_artifact_cli
import cnn_tpu_torch.tools.gradcam as gradcam_cli
import cnn_tpu_torch.tools.infer as infer_cli
import cnn_tpu_torch.tools.make_gif as make_gif_cli
import cnn_tpu_torch.tools.plot as plot_cli
import cnn_tpu_torch.tools.serve as serve_cli
import cnn_tpu_torch.tools.train as train_cli
from cnn_tpu_torch.data import (DataLoader, DeviceDataset, ImageAugmentor,
                                discover_dataset, make_device_train_step,
                                split_dataset)
from cnn_tpu_torch.data.device_dataset import GraphedSteps
from cnn_tpu_torch.data.image import imread, imwrite
from cnn_tpu_torch.data.image import resize as host_resize
from cnn_tpu_torch.data.native import NativeLoader
from cnn_tpu_torch.export import ServingArtifact, export_serving_artifact
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.nn import Conv2D, Linear, MaxPool2D, ReLU, StackedBlocks
from cnn_tpu_torch.ops import augment as aug
from cnn_tpu_torch.ops.activations import relu as ops_relu
from cnn_tpu_torch.ops.batchnorm import batch_norm2d_train
from cnn_tpu_torch.ops.conv import conv2d, conv_out_size
from cnn_tpu_torch.ops.hopper import (BF16_TILES,
                                      STRIP_ROWS, TILES, TMA_TILES,
                                      WGMMA_TILES,
                                      _build, add_counters, conv2d_bias_relu,
                                      conv2d_bias_relu_fn, conv_bf16_plan,
                                      conv_tile_plan, counted_capture,
                                      launch_conv_bf16,
                                      launch_normalize, launch_pool_bwd,
                                      launch_pool_fwd, launch_rotate,
                                      max_pool2d_bwd, max_pool2d_fn,
                                      max_pool2d_fwd, normalize_plan,
                                      pool_bwd_variant, pool_fwd_variant,
                                      read_counters, reset_launches,
                                      rotate_shear, rotate_tile_plan,
                                      uint8_normalize)
from cnn_tpu_torch.ops.hopper.augment import TILES as ROTATE_TILES
from cnn_tpu_torch.ops.hopper.resize import (launch_resize, pack,
                                             resize_batch_plain,
                                             resize_linear_u8, to_device)
from cnn_tpu_torch.ops.hopper.conv import (BF16_STRIP_SMEM_MAX,
                                           BF16_STRIP_TILES, BF16_VARIANTS,
                                           PW_SMEM_MAX, PW_TILES,
                                           STRIP_SMEM_MAX, pw_grid,
                                           pw_kernel_takes, pw_smem_bytes,
                                           pw_tile_for,
                                           strip_bf16_smem_bytes,
                                           strip_bf16_takes,
                                           strip_smem_bytes, tiled_plan)
from cnn_tpu_torch.ops.losses import softmax_cross_entropy
from cnn_tpu_torch.ops.pool import max_pool2d, max_pool2d_taps
from cnn_tpu_torch.ops.pool import max_pool2d_bwd as pool_bwd_plain
from cnn_tpu_torch.ops.preprocess import uint8_to_float
from cnn_tpu_torch.optim import make_optimizer, sgd, with_ema, with_frozen
from cnn_tpu_torch.parallel import (create_train_state, make_eval_step,
                                    make_pp_eval_step, make_pp_forward,
                                    make_pp_train_step, make_train_step,
                                    shard_pp_train_state, shard_train_state)
from cnn_tpu_torch.parallel import collectives
from cnn_tpu_torch.parallel.mesh import (init_distributed, make_mesh,
                                         make_pp_mesh)
from cnn_tpu_torch.parallel.train_step import (accumulate_grads,
                                               named_params, named_state,
                                               unsharded)
from cnn_tpu_torch.quant import fold_batchnorm
from cnn_tpu_torch.utils.checkpoint import (export_reference_model,
                                            import_reference_array,
                                            load_checkpoint, load_jax_params,
                                            load_reference_model,
                                            read_checkpoint, save_checkpoint)
from cnn_tpu_torch.utils.flops import (forward_flops_per_image,
                                       train_flops_per_image)
from cnn_tpu_torch.utils.history import read_history

ROOT = Path(__file__).resolve().parent
MODEL = (ROOT / "checkpoints" / "alexnet_bn_device"
         / "iter_12000_train_0.997_valid_0.937.model")
GRAD_FIXTURE = ROOT / "tests" / "fixtures" / "grad_parity_bn.npz"
BUCKETS = (1, 8, 64)
B = 64
TRAIN_B = 256          # the training batch
CANVAS = 256           # canvas_size, cut and resized to 224
TRAIN_N = 1024         # canvases held on the card
TRAIN_STEPS = 40
GRAD_TOL = 1e-4        # per gradient tensor, times max(1, max|ref|)
CONV_GRAD_TOL = 1e-5   # conv Function against autograd, times max(1, max|ref|)
# NVIDIA H100 SXM data sheet: HBM3 rate, float32 outside the tensor cores,
# and dense bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
BF16 = torch.bfloat16
# the bf16 conv kernel against the plain bf16 conv: one bf16 ulp of the
# plain value, plus 1e-5 x S (S the same conv of |x| and |w|), the float32
# reassociation bound of a tensor-core sum taken in another order
BF16_CONV_SREL = 1e-5
# the bf16 model against the float32 one (logits, times max(1, max|f32|),
# and probabilities): the bar of the CPU tests against cnn_tpu's bf16
BF16_MODEL_TOL = 5e-2
CONV_ATOL = CONV_RTOL = 1e-5
PROB_ATOL = 1e-5
LOGIT_ATOL = 1e-4   # the logit bar cnn_tpu holds against the reference
REPLACES = {
    "uint8_normalize": "cnn_tpu/ops/pallas/normalize.py:28",
    "max_pool2d_fwd": "cnn_tpu/ops/pallas/pool.py:61",
    "max_pool2d_bwd": "cnn_tpu/ops/pallas/pool.py:82",
    "conv2d_bias_relu": "cnn_tpu/ops/pallas/conv.py:103",
    "rotate_shear": "cnn_tpu/ops/pallas/augment.py:173",
    "conv2d_bias_relu_bf16": "cnn_tpu/ops/pallas/conv.py:77",
    "conv2d_bias_relu_bf16_tma": "cnn_tpu/ops/pallas/conv.py:77",
    "max_pool2d_fwd_bf16": "cnn_tpu/ops/pallas/pool.py:61",
    "max_pool2d_bwd_bf16": "cnn_tpu/ops/pallas/pool.py:82",
    # no Pallas kernel: the cv::resize of cnn_tpu's native loader
    "resize_linear_u8": "csrc/dataloader.cpp:28",
}
SOURCES = {
    "uint8_normalize": "cnn_tpu_torch/csrc/normalize.cu",
    "max_pool2d_fwd": "cnn_tpu_torch/csrc/pool.cu",
    "max_pool2d_bwd": "cnn_tpu_torch/csrc/pool.cu",
    "conv2d_bias_relu": "cnn_tpu_torch/csrc/conv.cu",
    "rotate_shear": "cnn_tpu_torch/csrc/rotate.cu",
    "conv2d_bias_relu_bf16": "cnn_tpu_torch/csrc/conv.cu",
    "conv2d_bias_relu_bf16_tma": "cnn_tpu_torch/csrc/conv.cu",
    "max_pool2d_fwd_bf16": "cnn_tpu_torch/csrc/pool.cu",
    "max_pool2d_bwd_bf16": "cnn_tpu_torch/csrc/pool.cu",
    "resize_linear_u8": "cnn_tpu_torch/csrc/resize.cu",
}
for _key in ("stem", "stem_32", "stem_64", "stem_s1_32", "stem_s1_64",
             "padded_3x3", "1x1"):
    REPLACES[f"conv2d_bias_relu_{_key}"] = REPLACES["conv2d_bias_relu"]
    REPLACES[f"conv2d_bias_relu_{_key}_bf16"] = REPLACES[
        "conv2d_bias_relu_bf16"]
    SOURCES[f"conv2d_bias_relu_{_key}"] = SOURCES[
        f"conv2d_bias_relu_{_key}_bf16"] = "cnn_tpu_torch/csrc/conv.cu"
KERNELS = ("uint8_normalize", "max_pool2d_fwd", "max_pool2d_bwd",
           "conv2d_bias_relu", "rotate_shear")
# the bf16 rows of the kernels line: row -> (wrapper, its bf16 counter)
BF16_KERNELS = {"conv2d_bias_relu_bf16": "conv2d_bias_relu.launches_bf16",
                "max_pool2d_fwd_bf16": "max_pool2d_fwd.launches_bf16",
                "max_pool2d_bwd_bf16": "max_pool2d_bwd.launches_bf16"}

T0 = time.perf_counter()


def phase(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f}s] {msg}", flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one ``fn()`` over ``iters`` back-to-back calls."""
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


def graph_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one ``fn()`` without the host's cost: ``iters`` calls
    captured into one CUDA graph (after ``warmup`` eager calls on a side
    stream), replayed once, then one replay timed with CUDA events. The
    counters that the captured wrapper calls moved are taken back."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()

    def capture():
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()

    counted_capture(capture)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    graph.reset()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float,
             peak: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def read_extent(n: int, k: int, s: int) -> int:
    """Rows (or columns) of an extent-``n`` input that a VALID k/s window
    reads: the rest are cropped and never leave device memory."""
    return (conv_out_size(n, k, s) - 1) * s + k


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit: floats as the integers of their width (so -0.0
    and NaN payloads count), integers as they are."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        a, b = a.view(view), b.view(view)
    return bool(torch.equal(a, b))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def entry(name, launches, err, ms, plain, lib, bound) -> dict:
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib}


def synthetic_images(rng, n: int, size: int = 224) -> np.ndarray:
    """[n,size,size,3] uint8: 7x7 blocks of colour plus 25% pixel noise.

    Uniform noise alone drives the checkpoint's logits to +-200, where every
    softmax is exactly one-hot and probabilities compare nothing; these
    images give logits of tens and mixed labels."""
    lo = rng.integers(0, 256, (n, 7, 7, 3)).astype(np.float32)
    img = np.kron(lo, np.ones((1, size // 7, size // 7, 1), np.float32))
    img = 0.75 * img + 0.25 * rng.integers(0, 256, (n, size, size, 3))
    return img.astype(np.uint8)


def plain_versions():
    """Routes the engine's three kernel calls to their plain versions."""
    stack = ExitStack()
    stack.enter_context(mock.patch.object(nn_module, "conv2d_bias_relu",
                                          conv2d))
    stack.enter_context(mock.patch.object(nn_module, "max_pool2d_fwd",
                                          lambda x: max_pool2d(x)))
    stack.enter_context(mock.patch.object(serving, "uint8_normalize",
                                          uint8_to_float))
    return stack


def conv_entry(x, w, b, stride, relu, tile=None, strip=None,
               padding=0, pw=None) -> torch.Tensor:
    """The direct conv kernel (``tile``, ``strip`` and ``pw`` None), the
    tiled one with tile id ``tile``, the strip one with strip id ``strip``
    or the pointwise one with ``pw`` = (tile id, blocks), called through
    its C entry point: no plan and no count, for comparisons beside the
    wrapper."""
    bsz, h, wid, cin = x.shape
    k, cout = w.shape[0], w.shape[-1]
    out = torch.empty((bsz, conv_out_size(h, k, stride, padding),
                       conv_out_size(wid, k, stride, padding), cout),
                      device=x.device)
    args = (x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, h,
            wid, cin, cout, k, stride, padding, int(relu))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if pw is not None:
        _build.launch("cnn_conv2d_bias_relu_pw", x.device, stream, *args,
                      *pw)
    elif strip is not None:
        _build.launch("cnn_conv2d_bias_relu_strip", x.device, stream, *args,
                      strip)
    elif tile is not None:
        _build.launch("cnn_conv2d_bias_relu_tiled", x.device, stream, *args,
                      tile)
    else:
        _build.launch("cnn_conv2d_bias_relu", x.device, stream, *args)
    return out


def plan_of(x, w, stride):
    bsz, h, wid, cin = x.shape
    return conv_tile_plan(bsz, h, wid, cin, w.shape[-1], w.shape[0], stride,
                          x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


def plan_name(plan) -> str:
    if plan.variant == "direct":
        return "direct"
    if plan.variant == "strip":
        return f"strip R={plan.rows} (grid {plan.grid})"
    t = TILES[plan.tile]
    return f"tiled {t.bm}x{t.bn} ({t.tm}x{t.tn}/thread, grid {plan.grid})"


def tile_sweep(x, w, b, stride) -> str:
    """ms of every tile the plan can return, ReLU off, through the entry
    point: how far the plan's pick is from the fastest on this shape."""
    ms = {i: time_ms(lambda i=i: conv_entry(x, w, b, stride, False, i))
          for i in range(len(TILES))}
    return ", ".join(f"{t.bm}x{t.bn}/{t.tm}x{t.tn} {ms[i]:.4f}"
                     for i, t in enumerate(TILES))


def strip_sweep(x, w, b, stride, padding=0, relu=False, tiles=None,
                timer=None) -> str:
    """ms of every strip R (or the ids in ``tiles``), through the entry
    point; ``timer`` ``time_ms`` unless given (the stems: ``graph_ms``)."""
    tiles = range(len(STRIP_ROWS)) if tiles is None else tiles
    ms = [(timer or time_ms)(lambda i=i: conv_entry(
        x, w, b, stride, relu, strip=i, padding=padding)) for i in tiles]
    return ", ".join(f"R={STRIP_ROWS[i]} {t:.4f}" for i, t in zip(tiles, ms))


def in_turns(fa, fb, iters: int = 20) -> tuple[float, float]:
    """Mean ms of ``fa`` and ``fb`` timed a, b, b, a."""
    a1, b1 = time_ms(fa, iters), time_ms(fb, iters)
    b2, a2 = time_ms(fb, iters), time_ms(fa, iters)
    return (a1 + a2) / 2, (b1 + b2) / 2


def signed_ties(gen, shape, dtype=torch.float32) -> torch.Tensor:
    """ReLU output quantized to quarters, so a third of a window's first two
    taps tie exactly, with a quarter of its zeros made -0: ties of equal
    values and of +0 against -0 (the first of a tie wins, bit for bit)."""
    dev = torch.device("cuda")
    x = torch.relu(torch.round(torch.randn(shape, generator=gen, device=dev)
                               * 4) / 4)
    flip = torch.rand(shape, generator=gen, device=dev) < 0.25
    x = torch.where(flip & (x == 0), torch.full((), -0.0, device=dev), x)
    return x.to(dtype)


def check_pool_fwd(x, what: str) -> str:
    """The forward through the wrapper (its variant, counted under it), with
    and without the tap, against the plain version and the element kernel
    (values and taps, bit for bit); returns the variant."""
    b, h, w_, c = x.shape
    bf16 = x.dtype == BF16
    variant = pool_fwd_variant(b, h // 2, w_ // 2, c, bf16,
                               x.data_ptr() % 16 == 0)
    key = f"launches_bf16_{variant}" if bf16 else f"launches_{variant}"
    before = getattr(max_pool2d_fwd, key)
    y, tap = max_pool2d_fwd(x, with_tap=True)
    check(getattr(max_pool2d_fwd, key) == before + 1,
          f"{what}: the {variant} forward was not counted")
    ref, ref_tap = max_pool2d_taps(x)
    elem, elem_tap = launch_pool_fwd(x, True, "element")
    check(bits_equal(y, ref) and torch.equal(tap, ref_tap),
          f"{what} ({variant} kernel): differs from the plain version")
    check(bits_equal(y, elem) and torch.equal(tap, elem_tap),
          f"{what} ({variant} kernel): differs from the element kernel")
    check(bits_equal(max_pool2d_fwd(x), ref), f"{what} ({variant} kernel): "
          "differs without the tap")
    return variant


def pool_fwd_turns(x, with_tap: bool) -> tuple[float, float]:
    """The window and the element forward kernels alone (``graph_ms``), in
    turns window, element, element, window."""
    return in_turns_graph(lambda: launch_pool_fwd(x, with_tap, "window"),
                          lambda: launch_pool_fwd(x, with_tap, "element"))


def in_turns_graph(fa, fb) -> tuple[float, float]:
    """Mean ``graph_ms`` of ``fa`` and ``fb`` timed a, b, b, a."""
    a1, b1 = graph_ms(fa), graph_ms(fb)
    b2, a2 = graph_ms(fb), graph_ms(fa)
    return (a1 + a2) / 2, (b1 + b2) / 2


def pool_fwd_bound(x, with_tap: bool) -> tuple[float, str]:
    """The forward's bound: x's covered rows and columns read, y (and the
    tap) written once; three comparisons an output."""
    b, h, w_, c = x.shape
    out = b * (h // 2) * (w_ // 2) * c
    return bound_ms(x.element_size() * (b * (h // 2 * 2) * (w_ // 2 * 2) * c
                                        + out) + (out if with_tap else 0),
                    3 * out)


def check_same_as_direct(x, w, b, stride, what) -> None:
    """The wrapper's kernel equal bit for bit to the direct kernel, ReLU off
    and on: the three conv kernels sum in one order."""
    for relu in (False, True):
        check(bits_equal(conv2d_bias_relu(x, w, b, stride, relu),
                         conv_entry(x, w, b, stride, relu)),
              f"{what} relu={relu}: differs from the direct kernel")


def check_conv(x, w, b, stride, what, conv=conv2d_bias_relu) -> float:
    """``conv`` (the wrapper) against the plain conv, ReLU off and on,
    within atol 1e-5 + rtol 1e-5, and two launches bit-identical; max
    |dev|."""
    err = 0.0
    for relu in (False, True):
        y, ref = conv(x, w, b, stride, relu), conv2d(x, w, b, stride, relu)
        dev_ = (y - ref).abs()
        check(bool((dev_ <= CONV_ATOL + CONV_RTOL * ref.abs()).all()),
              f"{what} relu={relu}: max deviation {dev_.max().item():.3g} "
              "over atol/rtol 1e-5")
        check(bits_equal(y, conv(x, w, b, stride, relu)),
              f"{what} relu={relu}: two launches differ")
        err = max(err, dev_.max().item())
    return err


def normalize_graph_check(x: torch.Tensor) -> None:
    """One ``uint8_normalize`` captured alone into a CUDA graph (the kernel
    is launched through the ctypes library, a second CUDA runtime beside
    PyTorch's): the replay on new input equals the plain version."""
    static = torch.zeros_like(x)
    graph = torch.cuda.CUDAGraph()

    def capture():
        with torch.cuda.graph(graph):
            return uint8_normalize(static)

    y, delta = counted_capture(capture)
    check(delta == {"uint8_normalize.launches": 1,
                    "uint8_normalize.launches_wide": 1},
          f"normalize capture counted {delta}")
    static.copy_(x)
    graph.replay()
    check(bits_equal(y, uint8_to_float(x)),
          "normalize replayed from a CUDA graph differs from the plain version")
    graph.reset()


def normalize_phase(gen) -> tuple:
    """The normalize kernel at the serving shapes: bit-exact on every byte
    and at B = 1, 8, 64, two launches bit-identical, the previous design
    bit-equal, one launch captured and replayed; times through the wrapper
    and graph-timed (L2-warm on one input, HBM-cold over four input/output
    pairs, 193 MB), the previous design in turns; the kernels line's row."""
    dev = torch.device("cuda")
    every = torch.arange(256, dtype=torch.uint8, device=dev)
    want = np.arange(256, dtype=np.float32) / np.float32(255.0)
    check(np.array_equal(uint8_normalize(every).cpu().numpy().view(np.int32),
                         want.view(np.int32)), "normalize: not IEEE x/255")
    for bsz in (1, 8, B):
        x = torch.randint(0, 256, (bsz, 224, 224, 3), generator=gen,
                          device=dev, dtype=torch.uint8)
        before = uint8_normalize.launches_wide
        y, ref = uint8_normalize(x), uint8_to_float(x)
        check(uint8_normalize.launches_wide == before + 1,
              f"normalize B={bsz}: not the wide variant")
        check(bits_equal(y, ref), f"normalize B={bsz}: differs from the plain "
              "version")
    check(bits_equal(y, uint8_normalize(x)), "normalize: two launches differ")
    check(bits_equal(launch_normalize(x, direct=True)[0], ref),
          "normalize: the previous design differs")
    normalize_graph_check(x)
    plan = normalize_plan(x.numel(), x.data_ptr(), y.data_ptr())
    err = (y - ref).abs().max().item()

    ms, direct = in_turns(lambda: uint8_normalize(x),
                          lambda: launch_normalize(x, direct=True))
    plain = time_ms(lambda: uint8_to_float(x))
    lib = time_ms(lambda: torch.true_divide(x, 255.0))
    bound = bound_ms(nbytes(x, y), x.numel())

    # graph-timed: L2-warm (one pair, back to back) and HBM-cold (four
    # pairs in turn, 4 x 48.2 MB, beyond the 50 MB L2)
    xs = [x] + [torch.randint(0, 256, x.shape, generator=gen, device=dev,
                              dtype=torch.uint8) for _ in range(3)]
    ys = [torch.empty(x.shape, device=dev) for _ in xs]
    turn = itertools.count()

    def cold(fn):
        def call():
            i = next(turn) % len(xs)
            fn(xs[i], ys[i])
        return call

    fns = {
        "kernel": lambda a, b: launch_normalize(a, b),
        "previous": lambda a, b: launch_normalize(a, b, direct=True),
        "true_divide": lambda a, b: torch.true_divide(a, 255.0, out=b),
        "plain": lambda a, b: uint8_to_float(a),
    }
    warm, hbm = {}, {}
    for order in (list(fns), list(fns)[::-1]):   # in turns: a, b, ..., b, a
        for k in order:
            warm.setdefault(k, []).append(
                graph_ms(lambda f=fns[k]: f(xs[0], ys[0])))
            hbm.setdefault(k, []).append(graph_ms(cold(fns[k])))
    warm = {k: sum(v) / 2 for k, v in warm.items()}
    hbm = {k: sum(v) / 2 for k, v in hbm.items()}
    phase(f"normalize [64,224,224,3] u8->f32, {plan.variant} variant "
          f"({plan.blocks} blocks of 256, head {plan.head}, tail "
          f"{plan.tail}): bit-exact on every byte and at B = 1, 8, 64, two "
          f"launches bit-identical, the previous design bit-equal, a captured "
          f"launch replays bit-exact; through the wrapper ms: kernel "
          f"{ms:.4f}, previous design {direct:.4f}, plain {plain:.4f}, "
          f"true_divide {lib:.4f}; graph-timed L2-warm ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in warm.items())
          + "; graph-timed HBM-cold ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in hbm.items())
          + f"; bound {bound[0]:.4f} ({bound[1]}); kernel HBM-cold at "
          f"{bound[0] / hbm['kernel']:.3f} of the bound")
    del xs, ys
    return err, ms, plain, lib, bound


def kernel_phase(model) -> dict:
    """Each kernel against its plain version at the serving shapes, B = 64."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}

    out["uint8_normalize"] = normalize_phase(gen)

    # max pool: ReLU output quantized to quarters, so exact ties are common
    # (zeros and equal positives); value and tap index bit for bit
    x = torch.randn((B, 111, 111, 16), generator=gen, device=dev)
    x = torch.relu(torch.round(x * 4) / 4)
    check(check_pool_fwd(x, "max pool [64,111,111,16]") == "window",
          "max pool: not planned on the window kernel")
    ref = max_pool2d_taps(x)[0]
    bsz, h, w_, c = x.shape
    ties = (x[:, :110:2, :110:2] == x[:, :110:2, 1:110:2]).float().mean().item()
    y = max_pool2d_fwd(x)
    out["max_pool2d_fwd"] = (
        (y - ref).abs().max().item(), time_ms(lambda: max_pool2d_fwd(x)),
        time_ms(lambda: max_pool2d(x)),
        time_ms(lambda: F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2)),
        bound_ms(4 * bsz * read_extent(h, 2, 2) * read_extent(w_, 2, 2) * c
                 + nbytes(y), 3 * y.numel()))
    alone = pool_fwd_turns(x, False)
    graphed = (graph_ms(lambda: max_pool2d_fwd(x)),
               graph_ms(lambda: F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2)))
    phase(f"max pool [64,111,111,16] (tie share {ties:.3f}), window kernel: "
          f"value and tap exact against the plain version and the element "
          f"kernel; ms (wrapper, plain, ATen)={out['max_pool2d_fwd'][1:4]}; "
          f"graph-timed wrapper {graphed[0]:.4f}, ATen {graphed[1]:.4f}; "
          f"alone in turns: window {alone[0]:.4f}, element {alone[1]:.4f}; "
          f"bound {out['max_pool2d_fwd'][4][0]:.4f}")

    # conv: the four layers with the checkpoint's weights, ReLU off (the BN
    # path) and on (the fused path); times are for ReLU off, as served. The
    # row's bound is the sum of the layers' own bounds, labelled by the kind
    # that bounds the larger share of it.
    sums = [0.0, 0.0, 0.0, 0.0, 0.0]
    by = {"bytes": 0.0, "operations": 0.0}
    worst = 0.0
    tiled = [0.0, 0.0, 0.0]   # conv2-4: tiled kernel, direct kernel, cuDNN
    graphed = [0.0, 0.0]      # conv2-4 graph-timed: tiled kernel, cuDNN
    h = 224
    for i, cin in enumerate((3, 16, 32, 64), start=1):
        layer = model.net[f"conv_layer_{i}"]
        w, b = layer.w.detach(), layer.b.detach()
        if i == 1:
            x = torch.rand((B, h, h, cin), generator=gen, device=dev)
        else:
            x = torch.relu(torch.randn((B, h, h, cin), generator=gen, device=dev))
        plan = plan_of(x, w, 2)
        check(plan.variant == ("strip" if i == 1 else "tiled"),
              f"conv_layer_{i}: planned {plan}")
        err = check_conv(x, w, b, 2, f"conv_layer_{i}")
        worst = max(worst, err)
        y = conv2d_bias_relu(x, w, b, 2, False)
        ho = conv_out_size(h, 3, 2)
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        ms, direct = in_turns(lambda: conv2d_bias_relu(x, w, b, 2, False),
                              lambda: conv_entry(x, w, b, 2, False))
        ms_relu = time_ms(lambda: conv2d_bias_relu(x, w, b, 2, True))
        plain = time_ms(lambda: conv2d(x, w, b, 2, False))
        lib = time_ms(lambda: F.conv2d(x.permute(0, 3, 1, 2), w_oihw, b, 2))
        g_ms = graph_ms(lambda: conv2d_bias_relu(x, w, b, 2, False))
        g_lib = graph_ms(lambda: F.conv2d(x.permute(0, 3, 1, 2), w_oihw, b, 2))
        m = B * ho * ho
        flops = 2 * m * layer.out_channels * 9 * cin + m * layer.out_channels
        r = read_extent(h, 3, 2)
        bnd = bound_ms(4 * B * r * r * cin + nbytes(w, b, y), flops)
        for j, v in enumerate((ms, plain, lib, bnd[0], ms_relu)):
            sums[j] += v
        by[bnd[1]] += bnd[0]
        if i > 1:
            for j, v in enumerate((ms, direct, lib)):
                tiled[j] += v
            graphed[0] += g_ms
            graphed[1] += g_lib
            same = (f"bits equal to the direct kernel's: "
                    f"{bits_equal(y, conv_entry(x, w, b, 2, False))}; every "
                    f"tile (ms): {tile_sweep(x, w, b, 2)}")
        else:
            check_same_as_direct(x, w, b, 2, f"conv_layer_{i}")
            strip = (ms, direct, lib, bnd[0], g_ms, g_lib)
            same = (f"equal to the direct kernel bit for bit; every R (ms): "
                    f"{strip_sweep(x, w, b, 2)}")
        phase(f"conv_layer_{i} [{B},{h},{h},{cin}]->[{B},{ho},{ho},"
              f"{layer.out_channels}] {plan_name(plan)}: max|dev| {err:.3g}, "
              f"two launches bit-identical, {same}; ms={ms:.4f} "
              f"(relu {ms_relu:.4f}) direct={direct:.4f} plain={plain:.4f} "
              f"library={lib:.4f} bound={bnd[0]:.4f} ({bnd[1]}); graph-timed "
              f"kernel {g_ms:.4f}, cuDNN {g_lib:.4f}")
        h = ho if i > 1 else conv_out_size(ho, 2, 2)
    out["conv2d_bias_relu"] = (worst, sums[0], sums[1], sums[2],
                               (sums[3], max(by, key=by.get)))
    phase(f"conv, 4 layers per batch: ms={sums[0]:.4f} (relu {sums[4]:.4f}) "
          f"plain={sums[1]:.4f} library={sums[2]:.4f} bound={sums[3]:.4f} "
          f"(bytes {by['bytes']:.4f} + operations {by['operations']:.4f}); "
          f"conv1 strip {strip[0]:.4f}, direct {strip[1]:.4f}, cuDNN "
          f"{strip[2]:.4f}, bound {strip[3]:.4f}, graph-timed {strip[4]:.4f} "
          f"(cuDNN {strip[5]:.4f}); conv2-4 tiled {tiled[0]:.4f}, direct "
          f"{tiled[1]:.4f}, cuDNN {tiled[2]:.4f}, graph-timed {graphed[0]:.4f} "
          f"(cuDNN {graphed[1]:.4f})")
    return out


def off_path_phase() -> None:
    """The kernels' branches that the serving shapes do not take, against
    the plain versions: the strip conv at B = 1, Cin 1 and 4, Cout 8 and 32
    (a partial and a second pass of 16 channels), stride 1, k = 5 and a row
    of more than 128 pixels, through the plan's R and every R; the direct
    conv on the shapes the plan keeps from the strip kernel (a row of W*Cin
    floats that is no multiple of 4, x off 16-byte alignment) and its scalar
    path (Cout not a multiple of 4, or weights not 16-byte aligned), the
    tiled conv at an M tail, stride 1, k = 5 and the smallest channels it
    takes (Cin 8, Cout 12, an N tail), and normalize off the serving
    shapes (``normalize_off_path``)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = []
    x = torch.randn((4, 33, 20, 5), generator=gen, device=dev)
    w = torch.randn((3, 3, 5, 7), generator=gen, device=dev)
    b = torch.randn((7,), generator=gen, device=dev)
    cases.append(("Cout 7, stride 1", x, w, b, 1))
    x = torch.relu(torch.randn((4, 27, 27, 32), generator=gen, device=dev))
    buf = torch.randn((3 * 3 * 32 * 64 + 1,), generator=gen, device=dev)
    w = buf[1:].view(3, 3, 32, 64)   # contiguous, 4 bytes past 16-alignment
    check(w.is_contiguous() and w.data_ptr() % 16 != 0, "misaligned weights")
    b = torch.randn((64,), generator=gen, device=dev)
    cases.append(("weights off 16-byte alignment", x, w, b, 2))
    strip_cases = [   # (what, B, H, W, Cin, Cout, k, stride)
        ("B 1, conv1", 1, 224, 224, 3, 16, 3, 2),
        ("Cin 1", 2, 40, 44, 1, 16, 3, 2),
        ("Cin 4", 2, 27, 28, 4, 16, 3, 2),
        ("Cout 8", 2, 36, 36, 3, 8, 3, 2),
        ("Cout 32", 2, 36, 36, 3, 32, 3, 2),
        ("stride 1", 2, 20, 24, 3, 16, 3, 1),
        ("k 5", 2, 33, 36, 2, 12, 5, 2),
        ("a row of 298 pixels", 1, 9, 300, 1, 8, 3, 1),
    ]
    strip_worst, strip_seen = 0.0, []
    for what, bsz, h, wid, cin, cout, k, stride in strip_cases:
        x = torch.rand((bsz, h, wid, cin), generator=gen, device=dev)
        w = torch.randn((k, k, cin, cout), generator=gen, device=dev) * 0.3
        b = torch.randn((cout,), generator=gen, device=dev) * 0.1
        plan = plan_of(x, w, stride)
        check(plan.variant == "strip", f"strip conv ({what}): planned {plan}")
        strip_seen.append(plan.rows)
        strip_worst = max(strip_worst,
                          check_conv(x, w, b, stride, f"strip conv ({what})"))
        check_same_as_direct(x, w, b, stride, f"strip conv ({what})")
        for i, r in enumerate(STRIP_ROWS):
            strip_worst = max(strip_worst, check_conv(
                x, w, b, stride, f"strip conv ({what}) R={r}",
                lambda *a, i=i: conv_entry(*a, strip=i)))
    w1 = torch.randn((3, 3, 3, 16), generator=gen, device=dev) * 0.3
    b1 = torch.randn((16,), generator=gen, device=dev) * 0.1
    cases.append(("conv1, a row of 669 floats",
                  torch.rand((2, 223, 223, 3), generator=gen, device=dev),
                  w1, b1, 2))
    buf = torch.rand((2 * 224 * 224 * 3 + 1,), generator=gen, device=dev)
    x = buf[1:].view(2, 224, 224, 3)   # contiguous, 4 bytes past alignment
    check(x.is_contiguous() and x.data_ptr() % 16 != 0, "misaligned x")
    cases.append(("conv1, x off 16-byte alignment", x, w1, b1, 2))
    worst = 0.0
    for what, x, w, b, stride in cases:
        check(plan_of(x, w, stride).variant == "direct",
              f"conv scalar path ({what}): not planned on the direct kernel")
        for relu in (False, True):
            y, ref = (conv2d_bias_relu(x, w, b, stride, relu),
                      conv2d(x, w, b, stride, relu))
            dev_ = (y - ref).abs()
            check(bool((dev_ <= CONV_ATOL + CONV_RTOL * ref.abs()).all()),
                  f"conv scalar path ({what}, relu={relu}): max deviation "
                  f"{dev_.max().item():.3g} over atol/rtol 1e-5")
            worst = max(worst, dev_.max().item())
    tiled_cases = [   # (what, B, H, W, Cin, Cout, k, stride)
        ("M tail: B 3, 13x13x32 -> 6x6x64, 108 rows", 3, 13, 13, 32, 64, 3, 2),
        ("stride 1", 2, 15, 17, 16, 32, 3, 1),
        ("k 5", 2, 29, 23, 32, 64, 5, 2),
        ("Cin 8, Cout 12", 3, 21, 19, 8, 12, 3, 2),
    ]
    tiled_worst, seen = 0.0, []
    for what, bsz, h, wid, cin, cout, k, stride in tiled_cases:
        x = torch.relu(torch.randn((bsz, h, wid, cin), generator=gen, device=dev))
        w = torch.randn((k, k, cin, cout), generator=gen, device=dev) * 0.1
        b = torch.randn((cout,), generator=gen, device=dev)
        plan = plan_of(x, w, stride)
        check(plan.variant == "tiled", f"tiled conv ({what}): planned {plan}")
        seen.append(plan.tile)
        tiled_worst = max(tiled_worst,
                          check_conv(x, w, b, stride, f"tiled conv ({what})"))
        # and every tile the plan can return, through the entry point
        for tile, t in enumerate(TILES):
            tiled_worst = max(tiled_worst, check_conv(
                x, w, b, stride, f"tiled conv ({what}) tile {t}",
                lambda *a, tile=tile: conv_entry(*a, tile=tile)))
    normalized = normalize_off_path(gen)
    phase(f"off the serving shapes: strip conv ("
          + "; ".join(c[0] for c in strip_cases) + f"; planned R {strip_seen}"
          f", then all {len(STRIP_ROWS)}) max|dev| {strip_worst:.3g}, "
          f"launches bit-identical and equal to the direct kernel; direct "
          f"conv (Cout 7 at stride 1; misaligned weights; conv1 with a row "
          f"of 669 floats; conv1 with x misaligned) max|dev| {worst:.3g}; "
          f"tiled conv (M tail, "
          f"stride 1, k 5, Cin 8 / Cout 12; planned tiles {seen}, then "
          f"all {len(TILES)}) max|dev| "
          f"{tiled_worst:.3g}, launches bit-identical; normalize {normalized}")


def normalize_off_path(gen) -> str:
    """normalize at lengths 1, 15, 16, 17 and 1,000,003 through the wrapper,
    then at 4,099 and 1,000,003 elements from every input offset 0-15 bytes
    into every output offset 0-15 floats (a float32 tensor starts on a
    multiple of 4 bytes) through ``launch_normalize``, the output filled
    with NaN first: each bit-exact, its variant the plan's rule, a
    misaligned launch repeated bit-identical, and plans the entry point
    must refuse refused."""
    dev = torch.device("cuda")
    big = 1_000_003
    buf = torch.randint(0, 256, (big + 16,), generator=gen, device=dev,
                        dtype=torch.uint8)
    out_buf = torch.empty(big + 16, device=dev)
    for n in (1, 15, 16, 17, big):
        check(bits_equal(uint8_normalize(buf[:n]), uint8_to_float(buf[:n])),
              f"normalize length {n}: differs from the plain version")
    seen = {"wide": 0, "bytes": 0}
    for n in (4099, big):
        for xo in range(16):
            x = buf[xo:xo + n]
            ref = uint8_to_float(x)
            for yo in range(16):
                y = out_buf[yo:yo + n].fill_(float("nan"))
                _, variant = launch_normalize(x, y)
                want = ("wide" if (4 * x.data_ptr() - y.data_ptr()) % 16 == 0
                        else "bytes")
                check(variant == want and bits_equal(y, ref),
                      f"normalize n={n}, x +{xo} bytes, y +{yo} floats: "
                      f"{variant} variant (rule: {want}) differs")
                seen[variant] += 1
    x, y = buf[3:3 + big], out_buf[1:1 + big]
    check(bits_equal(launch_normalize(x, y)[0].clone(),
                     launch_normalize(x, y)[0]),
          "normalize misaligned: two launches differ")
    # the entry point refuses a plan its variant cannot run aligned
    stream = torch.cuda.current_stream(dev).cuda_stream
    for what, plan in (("wide chunks off 16 bytes", (0, 1, 1)),
                       ("variant 2", (2, 1, 0)), ("no blocks", (0, 0, 0))):
        try:
            _build.launch("cnn_normalize_u8", dev, stream, buf.data_ptr(),
                          out_buf.data_ptr(), 4099, *plan)
        except RuntimeError:
            continue
        raise AssertionError(f"normalize entry point took {what}")
    return (f"lengths 1, 15, 16, 17, {big} bit-exact; every input offset "
            f"0-15 bytes x output offset 0-15 floats at 4,099 and {big} "
            f"elements bit-exact ({seen['wide']} wide, {seen['bytes']} bytes "
            f"variant launches, each the plan's rule); misaligned, "
            f"unknown and empty plans refused")


SERVING_KERNELS = ("uint8_normalize", "max_pool2d_fwd", "conv2d_bias_relu")


def serving_counts() -> dict:
    """The counters of the serving path's wrappers, per variant."""
    return {k: v for k, v in read_counters().items()
            if k.split(".")[0] in SERVING_KERNELS}


def serving_want(calls: int) -> dict:
    """Those counters after ``calls`` bucket calls: normalize through the
    wide kernel, conv1 through the strip kernel, conv2-4 through the tiled
    one, one pool forward through the window kernel."""
    return {"uint8_normalize.launches": calls,
            "uint8_normalize.launches_wide": calls,
            "uint8_normalize.launches_bytes": 0,
            "max_pool2d_fwd.launches": calls,
            "max_pool2d_fwd.launches_window": calls,
            "max_pool2d_fwd.launches_element": 0,
            "max_pool2d_fwd.launches_bf16": 0,
            "max_pool2d_fwd.launches_bf16_window": 0,
            "max_pool2d_fwd.launches_bf16_element": 0,
            "conv2d_bias_relu.launches": 4 * calls,
            "conv2d_bias_relu.launches_strip": calls,
            "conv2d_bias_relu.launches_tiled": 3 * calls,
            "conv2d_bias_relu.launches_pw": 0,
            "conv2d_bias_relu.launches_direct": 0,
            "conv2d_bias_relu.launches_bf16": 0,
            "conv2d_bias_relu.launches_bf16_gather": 0,
            "conv2d_bias_relu.launches_bf16_vec": 0,
            "conv2d_bias_relu.launches_bf16_strip": 0,
            "conv2d_bias_relu.launches_bf16_wgmma": 0,
            "conv2d_bias_relu.launches_bf16_tma": 0,
            "conv2d_bias_relu.launches_padded": 0,
            "conv2d_bias_relu.launches_1x1": 0,
            "conv2d_bias_relu.launches_bf16_padded": 0,
            "conv2d_bias_relu.launches_bf16_1x1": 0,
            "conv2d_bias_relu.launches_strip_padded": 0,
            "conv2d_bias_relu.launches_bf16_strip_padded": 0}


def same_arrays(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def serving_phase(model) -> dict:
    """The serving path through all three kernels, one CUDA graph per
    bucket, with launch counts."""
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held0 = torch.cuda.memory_reserved()
    engine = serving.InferenceEngine(model, buckets=BUCKETS, device="cuda")
    t = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    torch.cuda.empty_cache()    # what stays reserved is the graphs'
    held = (torch.cuda.memory_reserved() - held0) / 2 ** 20
    check(engine.ready_buckets == BUCKETS, f"ready after warmup: "
          f"{engine.ready_buckets}")
    want1 = {k: v for k, v in serving_want(1).items() if v}
    for b in BUCKETS:
        check(engine._ready[b].launches == want1, f"bucket {b}'s capture "
              f"recorded {engine._ready[b].launches}, expected {want1}")

    # the first call of each bucket after warmup, host clock, synchronised
    first = {}
    for b in BUCKETS:
        batch = synthetic_images(rng, b)
        t = time.perf_counter()
        engine.predict(batch)
        first[b] = (time.perf_counter() - t) * 1e3

    # each bucket's replay against the eager forward on the same padded
    # batch, bit for bit: a full chunk and a padded one
    for b in BUCKETS:
        for n in sorted({b, max(1, b - 3)}):
            chunk = synthetic_images(rng, n)
            labels, probs = engine.predict(chunk)
            batch = np.zeros((b, 224, 224, 3), np.uint8)
            batch[:n] = chunk
            with torch.no_grad():
                ep, el = engine._forward(torch.from_numpy(batch).to(dev))
            check(same_arrays(labels, el[:n].int().cpu().numpy())
                  and same_arrays(probs, ep[:n].cpu().numpy()),
                  f"bucket {b}, {n} images: the replay differs from the "
                  "eager forward")

    sizes = (1, 5, 64, 100)
    imgs = {n: synthetic_images(rng, n) for n in sizes}
    calls = sum(-(-n // BUCKETS[-1]) for n in sizes)   # 1 + 1 + 1 + 2

    reset_launches()
    results = {n: engine.predict(imgs[n]) for n in sizes}
    torch.cuda.synchronize()
    check(serving_counts() == serving_want(calls),
          f"predict launches {serving_counts()}, expected "
          f"{serving_want(calls)}")
    for n, (labels, probs) in results.items():
        check(labels.shape == (n,) and probs.shape == (n, 3), f"shape at {n}")
        check(bool(np.isfinite(probs).all()), f"non-finite probs at {n}")
        check(bool(np.allclose(probs.sum(-1), 1.0, atol=1e-5)), f"sum at {n}")
        check(bool((labels == probs.argmax(-1)).all()), f"argmax at {n}")

    # the server (its start finds every bucket ready: no capture, no call)
    with serving.BatchingServer(engine) as srv, ThreadPoolExecutor(16) as pool:
        futs = list(pool.map(srv.submit, imgs[64][:16]))
        answers = [f.result(timeout=120) for f in futs]
    torch.cuda.synchronize()
    served = uint8_normalize.launches - calls
    check(served >= 1 and serving_counts() == serving_want(calls + served),
          f"server launches {serving_counts()} after {served} calls")
    launches = {k: serving_counts()[f"{k}.launches"] for k in SERVING_KERNELS}
    labels64, probs64 = results[64]
    for i, (label, probs) in enumerate(answers):
        check(label == labels64[i], f"server label {i}")
        check(bool(np.allclose(probs, probs64[i], rtol=0, atol=PROB_ATOL)),
              f"server probs {i}")
    phase(f"warmup captured buckets {engine.ready_buckets} in {warm_s:.2f} s "
          f"({held:.1f} MiB of device memory held by the graphs' pool and "
          f"buffers); first call after warmup (ms): "
          + ", ".join(f"bucket {b} {v:.3f}" for b, v in first.items())
          + f"; replays equal to the eager forward bit for bit at every "
          f"bucket, full and padded; served {sum(sizes)} images in {calls} "
          f"bucket calls and 16 concurrent submits in {served}; launches "
          f"{serving_counts()} (exact, replays included)")

    # a fresh engine on the plain versions, on the card, its graphs captured
    # from them: no kernel may run
    x = torch.from_numpy(imgs[64]).cuda()
    with torch.inference_mode():
        logits = engine.model(uint8_normalize(x))
    reset_launches()
    with plain_versions():
        plain_engine = serving.InferenceEngine(model, buckets=BUCKETS,
                                               device="cuda")
        plain_engine.warmup()
        plain = {n: plain_engine.predict(imgs[n]) for n in sizes}
        with torch.inference_mode():
            plain_logits = engine.model(uint8_to_float(x))
    torch.cuda.synchronize()
    check(not any(read_counters().values()),
          f"the plain run launched a kernel: {read_counters()}")
    del plain_engine
    worst = 0.0
    for n in sizes:
        check(np.array_equal(results[n][0], plain[n][0]), f"labels at {n}")
        worst = max(worst, float(np.abs(results[n][1] - plain[n][1]).max()))
    check(worst <= PROB_ATOL, f"probs vs plain on the card: {worst:.3g}")
    logit_dev = (logits - plain_logits).abs().max().item()
    check(logit_dev <= LOGIT_ATOL, f"logits vs plain on the card: {logit_dev:.3g}")

    # and the plain versions on the CPU, on 5 images
    cpu = get_model("alexnet", num_classes=3, batch_norm=True, image_size=224,
                    device="cpu")
    load_reference_model(cpu, MODEL)
    cl, cp = serving.InferenceEngine(cpu, buckets=BUCKETS,
                                     device="cpu").predict(imgs[5])
    cpu_dev = float(np.abs(cp - results[5][1]).max())
    check(np.array_equal(cl, results[5][0]) and cpu_dev <= PROB_ATOL,
          f"probs vs the CPU: {cpu_dev:.3g}")
    phase(f"plain run on the card (a fresh engine, its graphs captured from "
          f"the plain versions): 0 launches; probs max|dev| vs plain on the "
          f"card {worst:.3g}, vs the CPU {cpu_dev:.3g} (atol {PROB_ATOL}); "
          f"labels equal; logits at bucket 64 (|logit| <= "
          f"{logits.abs().max().item():.1f}) max|dev| vs plain "
          f"{logit_dev:.3g} (atol {LOGIT_ATOL}); labels "
          f"{np.bincount(results[100][0], minlength=3).tolist()} over 100")

    # bucket 64: end to end (host arrays in, host arrays out), and the
    # device forward through the graph beside the eager one, in turns
    engine.predict(imgs[64])
    torch.cuda.synchronize()
    t = time.perf_counter()
    reps = 20
    for _ in range(reps):
        engine.predict(imgs[64])
    e2e = reps * 64 / (time.perf_counter() - t)
    replay = engine._ready[64].graph.replay
    with torch.no_grad():
        graphed, eager = in_turns(replay, lambda: engine._forward(x))
        split = layer_times(engine.model, uint8_normalize(x))
    phase(f"bucket 64: {e2e:.1f} img/s end to end; device forward through "
          f"the graph {graphed:.4f} ms = {64e3 / graphed:.1f} img/s, eager "
          f"{eager:.4f} ms = {64e3 / eager:.1f} img/s ({graphed / eager:.3f} "
          f"of it); per layer, eager (ms): "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    return launches


def layer_times(model, x, compute_dtype=None) -> dict:
    """Device ms of each step of the model's eval forward, fused conv+ReLU
    counted under the conv's name, as ``Sequential.forward`` runs them (a
    conv's or the linear layer's casts to ``compute_dtype`` in its time)."""
    layers, out, i = list(model.net), {}, 0
    while i < len(layers):
        fuse = (isinstance(layers[i], Conv2D) and i + 1 < len(layers)
                and isinstance(layers[i + 1], ReLU))
        kw = {"relu": True} if fuse else {}
        if compute_dtype is not None and isinstance(layers[i],
                                                    (Conv2D, Linear)):
            kw["compute_dtype"] = compute_dtype
        step = (lambda l=layers[i], x=x, kw=kw: l(x, **kw))
        out[layers[i].name] = time_ms(step)
        x = step()
        i += 2 if fuse else 1
    return out

def launch_counts() -> dict:
    return {name: globals()[name].launches for name in KERNELS}


def scaled_dev(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """max |got - ref| and the bar's scale max(1, max |ref|)."""
    return ((got.double() - ref.double()).abs().max().item(),
            max(1.0, ref.abs().max().item()))


def rotate_ops(b: int, s: int, c: int) -> int:
    """Float operations of the three shears: a blend is 1 - a, two products
    and a sum, over the S x L padded rows twice and the S x S*C window."""
    lane = aug.geometry(s, c).lane
    return 4 * b * (2 * s * lane + s * s * c)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, float32 or bf16."""
    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        torch.equal(a.view(view), b.view(view)))


def direct_rotate(imgs, theta):
    """The previous rotation design through its entry point; no count."""
    return launch_rotate(imgs, theta, direct=True)


def check_rotation(imgs, theta, what, fn=rotate_shear) -> tuple[float, int]:
    """``fn`` against ``rotate_shear_plain`` on float32 ``imgs`` (bit-exact)
    and on their bf16 cast (within one bf16 ulp), two launches bit-identical
    in each; max |dev| in float32 and the bf16 elements 1 ulp off."""
    y, ref = fn(imgs, theta), aug.rotate_shear_plain(imgs, theta)
    check(bits_equal(y, ref), f"rotation f32 ({what}): differs from the plain "
          f"version: max |dev| {(y - ref).abs().max().item():.3g}")
    check(bits_equal(y, fn(imgs, theta)), f"rotation f32 ({what}): two "
          "launches differ")
    hb = imgs.bfloat16()
    yb, rb = fn(hb, theta), aug.rotate_shear_plain(hb, theta)
    ulps = (yb.view(torch.int16).int() - rb.view(torch.int16).int()).abs()
    check(ulps.max().item() <= 1, f"rotation bf16 ({what}): "
          f"{ulps.max().item()} ulp from the plain version")
    check(same_bits(yb, fn(hb, theta)), f"rotation bf16 ({what}): two "
          "launches differ")
    return (y - ref).abs().max().item(), int((ulps > 0).sum().item())


def rotation_checks(gen) -> tuple:
    """The rotation at the training shape: the tiled kernel (the wrapper)
    and the previous design against the plain version, the cases off the
    training shape, both designs timed in this run, every tile of the
    plan's table timed; the kernel table's row."""
    dev = torch.device("cuda")
    # fixed angles around the 45-degree turn of the shears, the rest random
    # in +-75 degrees
    fixed = torch.tensor([0, 15, -15, 44, -44, 46, -46, 75, -75],
                         dtype=torch.float32, device=dev)
    rand = (torch.rand(TRAIN_B - fixed.numel(), generator=gen, device=dev)
            * 2 - 1) * 75
    theta = torch.deg2rad(torch.cat([fixed, rand]))
    imgs = torch.rand((TRAIN_B, CANVAS, CANVAS, 3), generator=gen, device=dev)
    err, off = check_rotation(imgs, theta, "training batch")
    check_rotation(imgs, theta, "training batch, previous design",
                   direct_rotate)
    y = rotate_shear(imgs, theta)
    check(bits_equal(y, direct_rotate(imgs, theta)),
          "rotation f32: the two designs differ")
    for tile in range(len(ROTATE_TILES)):
        check_rotation(imgs[:16], theta[:16], f"tile {ROTATE_TILES[tile]}",
                       lambda i, t, tile=tile: launch_rotate(i, t, tile))

    # off the training shape: one image, canvases that no tile divides,
    # one channel, and angles past 90 degrees (the per-element branch)
    wide = torch.tensor([100, -100, 135, -135, 180], dtype=torch.float32,
                        device=dev)
    cases = [("B=1, 75 deg", imgs[7:8], theta[7:8])]
    for s, c, n in ((40, 3, 24), (100, 3, 24), (CANVAS, 1, 24),
                    (CANVAS, 3, 0), (100, 1, 0)):
        deg = torch.cat([fixed, wide, (torch.rand(n, generator=gen, device=dev)
                                       * 2 - 1) * 75])
        cases.append((f"S={s}, C={c}, {deg.numel()} angles incl. +-100, "
                      "+-135, 180 deg",
                      torch.rand((deg.numel(), s, s, c), generator=gen,
                                 device=dev), torch.deg2rad(deg)))
    for what, x, t in cases:
        check_rotation(x, t, what)
        for tile in range(len(ROTATE_TILES)):
            check_rotation(x, t, f"{what}, tile {ROTATE_TILES[tile]}",
                           lambda i, t_, tile=tile: launch_rotate(i, t_, tile))
        check_rotation(x, t, f"{what}, previous design", direct_rotate)

    # times: the tiled kernel beside the previous design, in turns
    hb = imgs.bfloat16()
    ms = {}
    for key, x, fn in (("f32", imgs, rotate_shear), ("bf16", hb, rotate_shear),
                       ("f32 direct", imgs, direct_rotate),
                       ("bf16 direct", hb, direct_rotate)):
        ms[key] = [time_ms(lambda: fn(x, theta))]
    for key, x, fn in (("bf16 direct", hb, direct_rotate),
                       ("f32 direct", imgs, direct_rotate),
                       ("bf16", hb, rotate_shear), ("f32", imgs, rotate_shear)):
        ms[key].append(time_ms(lambda: fn(x, theta)))
    ms = {k: sum(v) / len(v) for k, v in ms.items()}
    plain = time_ms(lambda: aug.rotate_shear_plain(imgs, theta), iters=5)
    plain_b = time_ms(lambda: aug.rotate_shear_plain(hb, theta), iters=5)
    vecs = aug.shift_vectors(theta, CANVAS, 3)
    ops = rotate_ops(TRAIN_B, CANVAS, 3)
    bnd = bound_ms(nbytes(imgs, y, *vecs), ops)
    bnd_b = bound_ms(2 * nbytes(hb) + nbytes(*vecs), ops)
    sweep = {}
    for tile, t in enumerate(ROTATE_TILES):
        sweep[t] = [time_ms(lambda tile=tile: launch_rotate(x, theta, tile))
                    for x in (imgs, hb)]
    plans = ", ".join(
        f"{name} {p.rows}x{p.pixels} tiles, {p.grid[0]} per image, "
        f"{p.smem_bytes} B shared memory" for name, p in (
            ("f32", rotate_tile_plan(CANVAS, 3, torch.float32)),
            ("bf16", rotate_tile_plan(CANVAS, 3, torch.bfloat16))))
    phase(f"rotation [{TRAIN_B},{CANVAS},{CANVAS},3], tiled kernel ({plans}"
          f"): f32 bit-exact, bf16 {off} elements 1 ulp off, two launches "
          f"bit-identical; previous design the same, and equal to the tiled "
          f"kernel bit for bit; off the training shape ("
          + "; ".join(w for w, _, _ in cases) + f") every tile of "
          f"{len(ROTATE_TILES)} and the previous design bit-exact in f32, "
          f"within 1 ulp in bf16")
    phase(f"rotation ms (mean of two turns): f32 {ms['f32']:.4f} (previous "
          f"design {ms['f32 direct']:.4f}, {ms['f32'] / ms['f32 direct']:.3f} "
          f"of it) plain={plain:.4f} bound={bnd[0]:.4f}; bf16 "
          f"{ms['bf16']:.4f} (previous design {ms['bf16 direct']:.4f}, "
          f"{ms['bf16'] / ms['bf16 direct']:.3f} of it) plain={plain_b:.4f} "
          f"bound={bnd_b[0]:.4f}; every tile (f32, bf16 ms): "
          + ", ".join(f"{t.rows}x{t.pixels} {a:.4f} {b:.4f}"
                      for t, (a, b) in sweep.items()))
    return err, ms["f32"], plain, None, bnd


def train_kernel_phase() -> dict:
    """The two new kernels and the conv Function at the training shapes."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    out = {}

    # pool backward: the tap of a forward on ReLU output quantized to
    # quarters (a third of the first two taps tie exactly)
    x = torch.randn((TRAIN_B, 111, 111, 16), generator=gen, device=dev)
    x = torch.relu(torch.round(x * 4) / 4)
    y, tap = max_pool2d_fwd(x, with_tap=True)
    # the forward: the window kernel bit-exact against the plain version and
    # the element kernel, here, on +-0 ties and at odd small extents
    check(check_pool_fwd(x, "pool forward [256,111,111,16]") == "window",
          "pool forward: not planned on the window kernel")
    check_pool_fwd(signed_ties(gen, x.shape), "pool forward "
                   "[256,111,111,16] with +-0")
    for shape in ((3, 7, 9, 8), (2, 5, 4, 4)):
        check(check_pool_fwd(signed_ties(gen, shape), f"pool forward "
                             f"{shape}") == "window",
              f"pool forward {shape}: not planned on the window kernel")
    xn = x.permute(0, 3, 1, 2)
    fwd = (time_ms(lambda: max_pool2d_fwd(x, with_tap=True)),
           time_ms(lambda: max_pool2d_taps(x)),
           time_ms(lambda: F.max_pool2d(xn, 2, 2, return_indices=True)),
           pool_fwd_bound(x, True))
    alone = pool_fwd_turns(x, True)
    aten = graph_ms(lambda: F.max_pool2d(xn, 2, 2, return_indices=True))
    check(alone[0] <= alone[1], f"pool forward [256,111,111,16]: the window "
          f"kernel ({alone[0]:.4f} ms) is slower than the element kernel "
          f"({alone[1]:.4f})")
    phase(f"pool forward with tap [256,111,111,16] (training), window "
          f"kernel: bit-exact against the plain version and the element "
          f"kernel, with +-0 ties, and at 7x9x8 and 5x4x4; ms (wrapper, "
          f"plain, ATen)={fwd[:3]}; alone in turns: window {alone[0]:.4f}, "
          f"element {alone[1]:.4f} ({alone[0] / alone[1]:.3f} of it), ATen "
          f"with indices {aten:.4f}; bound={fwd[3][0]:.4f}, window at "
          f"{fwd[3][0] / alone[0]:.3f} of it")
    g = torch.randn((TRAIN_B, 55, 55, 16), generator=gen, device=dev)
    check(pool_bwd_variant(TRAIN_B, 55, 55, 16, True) == "window",
          "pool backward: not planned on the window kernel")
    dx, ref = max_pool2d_bwd(tap, g, 111, 111), pool_bwd_plain(tap, g, 111, 111)
    check(bits_equal(dx, ref), "pool backward: differs from the plain version")
    check(not dx[:, 110].any().item() and not dx[:, :, 110].any().item(),
          "pool backward: the cropped row or column is not zero")
    xa = x.clone().requires_grad_(True)
    (auto,) = torch.autograd.grad(max_pool2d(xa), xa, g)
    check(bits_equal(dx, auto),
          "pool backward: differs from autograd through the plain forward")
    check(bits_equal(dx, launch_pool_bwd(tap, g, 111, 111, "element")),
          "pool backward: the window and element kernels differ")
    ties = (x[:, :110:2, :110:2] == x[:, :110:2, 1:110:2]).float().mean().item()
    # off the training shape: an odd small extent through the window
    # kernel, and C 6 through the element kernel, both against the plain
    # version and autograd, cropped rows and columns zero
    for (bsz, h, w_, c), variant in (((3, 7, 9, 8), "window"),
                                     ((3, 7, 9, 6), "element")):
        xs = torch.relu(torch.round(torch.randn(
            (bsz, h, w_, c), generator=gen, device=dev) * 4) / 4)
        _, ts = max_pool2d_fwd(xs, with_tap=True)
        gs = torch.randn((bsz, h // 2, w_ // 2, c), generator=gen, device=dev)
        check(pool_bwd_variant(bsz, h // 2, w_ // 2, c, True) == variant,
              f"pool backward {h}x{w_}x{c}: not planned on the {variant} "
              "kernel")
        before = getattr(max_pool2d_bwd, f"launches_{variant}")
        got = max_pool2d_bwd(ts, gs, h, w_)
        check(getattr(max_pool2d_bwd, f"launches_{variant}") == before + 1,
              f"pool backward {h}x{w_}x{c}: the {variant} kernel did not run")
        xa = xs.clone().requires_grad_(True)
        (auto,) = torch.autograd.grad(max_pool2d(xa), xa, gs)
        check(bits_equal(got, pool_bwd_plain(ts, gs, h, w_))
              and bits_equal(got, auto)
              and not got[:, h - 1].any().item()
              and not got[:, :, w_ - 1].any().item(),
              f"pool backward {h}x{w_}x{c} ({variant} kernel): differs")
    xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    _, ind = F.max_pool2d(xn, 2, 2, return_indices=True)
    lib = time_ms(lambda: torch.ops.aten.max_pool2d_with_indices_backward(
        gn, xn, [2, 2], [2, 2], [0, 0], [1, 1], False, ind))
    ms, prev = in_turns(lambda: max_pool2d_bwd(tap, g, 111, 111),
                        lambda: launch_pool_bwd(tap, g, 111, 111, "element"))
    out["max_pool2d_bwd"] = (
        (dx - ref).abs().max().item(), ms,
        time_ms(lambda: pool_bwd_plain(tap, g, 111, 111)), lib,
        bound_ms(nbytes(tap, g, dx), 0))
    phase(f"pool backward [256,55,55,16]->[256,111,111,16] (tie share "
          f"{ties:.3f}), window kernel: bit-exact against the plain version, "
          f"autograd and the element kernel, cropped row and column zero; "
          f"7x9x8 (window) and 7x9x6 (element) bit-exact; ms (window, plain, "
          f"ATen)={out['max_pool2d_bwd'][1:4]}, element kernel {prev:.4f} "
          f"({ms / prev:.3f} of it), bound="
          f"{out['max_pool2d_bwd'][4][0]:.4f}")

    out["rotate_shear"] = rotation_checks(gen)

    # the conv Function against autograd through the plain conv, and the
    # training-shape forward: parity, the tiled kernel beside the direct
    # one, cuDNN and the plain version
    h = 224
    tiled = [0.0, 0.0, 0.0, 0.0]   # conv2-4: tiled, direct, cuDNN, bound
    for i, (cin, cout) in enumerate([(3, 16), (16, 32), (32, 64), (64, 128)],
                                    start=1):
        x = torch.rand((TRAIN_B, h, h, cin), generator=gen, device=dev)
        w = torch.randn((3, 3, cin, cout), generator=gen, device=dev) * 0.1
        b = torch.randn((cout,), generator=gen, device=dev) * 0.1
        ho = conv_out_size(h, 3, 2)
        g = torch.randn((TRAIN_B, ho, ho, cout), generator=gen, device=dev)
        worst, flips = 0.0, 0
        for relu in (False, True):
            leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
            got = torch.autograd.grad(
                conv2d_bias_relu_fn(*leaves, 2, relu), leaves, g)
            # the reference takes the Function's own ReLU mask: where the
            # kernel's and the plain sums straddle 0 (they differ by
            # ~1e-6), the two masks differ and route whole cotangents
            gm = g
            if relu:
                pre = conv2d_bias_relu(x, w, b, 2, False)
                gm = torch.where(pre > 0, g, torch.zeros_like(g))
                flips = int(((pre > 0) != (conv2d(x, w, b, 2, False) > 0))
                            .sum().item())
            leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
            ref = torch.autograd.grad(conv2d(*leaves, 2, False), leaves, gm)
            for what, a, r in zip(("dx", "dw", "db"), got, ref):
                d, scale = scaled_dev(a, r)
                check(d <= CONV_GRAD_TOL * scale,
                      f"conv_layer_{i} relu={relu} {what}: max |dev| {d:.3g} "
                      f"over {CONV_GRAD_TOL} * {scale:.3g}")
                worst = max(worst, d / scale)
        # the gradients training asks for: no dx of the first layer's images
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
        wrt = leaves if i > 1 else leaves[1:]

        def train_fn():
            torch.autograd.grad(conv2d_bias_relu_fn(*leaves, 2, False), wrt, g)

        def train_plain():
            torch.autograd.grad(conv2d(*leaves, 2, False), wrt, g)

        xn, wn = leaves[0].permute(0, 3, 1, 2), leaves[1].permute(3, 2, 0, 1)

        def train_lib():
            torch.autograd.grad(F.conv2d(xn, wn, leaves[2], 2), wrt,
                                g.permute(0, 3, 1, 2))

        plan = plan_of(x, w, 2)
        check(plan.variant == ("strip" if i == 1 else "tiled"),
              f"conv_layer_{i} at batch {TRAIN_B}: planned {plan}")
        fwd_err = check_conv(x, w, b, 2, f"conv_layer_{i} at batch {TRAIN_B}")
        check_same_as_direct(x, w, b, 2, f"conv_layer_{i} at batch {TRAIN_B}")
        fwd, fwd_direct = in_turns(
            lambda: conv2d_bias_relu(x, w, b, 2, False),
            lambda: conv_entry(x, w, b, 2, False))
        fwd_lib = time_ms(lambda: F.conv2d(x.permute(0, 3, 1, 2),
                                           w.permute(3, 2, 0, 1), b, 2))
        fwd_plain = time_ms(lambda: conv2d(x, w, b, 2, False), iters=5)
        m = TRAIN_B * ho * ho
        r = read_extent(h, 3, 2)
        fwd_bnd = bound_ms(4 * TRAIN_B * r * r * cin + nbytes(w, b) + 4 * m * cout,
                           2 * m * cout * 9 * cin + m * cout)
        if i > 1:
            for j, v in enumerate((fwd, fwd_direct, fwd_lib, fwd_bnd[0])):
                tiled[j] += v
            sweep = f"; every tile (ms): {tile_sweep(x, w, b, 2)}"
        else:
            sweep = f"; every R (ms): {strip_sweep(x, w, b, 2)}"
            conv1 = (fwd, fwd_direct, fwd_lib, fwd_bnd[0])
        phase(f"conv_layer_{i} [{TRAIN_B},{h},{h},{cin}]->[{TRAIN_B},{ho},"
              f"{ho},{cout}]: Function dx/dw/db max |dev| {worst:.3g} x "
              f"max(1,|ref|) ({flips} ReLU mask elements differ between the "
              f"kernel's and the plain sums); forward {plan_name(plan)} "
              f"max|dev| {fwd_err:.3g}, two launches bit-identical and equal "
              f"to the direct kernel, {fwd:.4f} ms, direct kernel "
              f"{fwd_direct:.4f} ({fwd / fwd_direct:.3f} of it), cuDNN "
              f"{fwd_lib:.4f}, plain {fwd_plain:.4f}, bound {fwd_bnd[0]:.4f} "
              f"({fwd_bnd[1]}){sweep}; forward+backward: "
              f"Function {time_ms(train_fn, iters=10):.4f} plain "
              f"{time_ms(train_plain, iters=5):.4f} cuDNN "
              f"{time_ms(train_lib, iters=10):.4f} ms")
        h = ho if i > 1 else conv_out_size(ho, 2, 2)
    phase(f"conv1 forward at batch {TRAIN_B}: strip {conv1[0]:.4f} ms, "
          f"direct {conv1[1]:.4f} ({conv1[0] / conv1[1]:.3f} of it), cuDNN "
          f"{conv1[2]:.4f}, bound {conv1[3]:.4f} ({conv1[3] / conv1[0]:.3f} "
          f"of the strip kernel's time); conv2-4 forward: tiled "
          f"{tiled[0]:.4f} ms, direct {tiled[1]:.4f} ({tiled[0] / tiled[1]:.3f}"
          f" of it), cuDNN {tiled[2]:.4f}, bound {tiled[3]:.4f}")
    return out


def grad_parity_phase() -> None:
    """One step at lr 1 on the reference C++'s fixture, at full width."""
    fx = np.load(GRAD_FIXTURE)
    model = get_model("alexnet", num_classes=3, batch_norm=True,
                      image_size=224, device="cuda")
    p0, s0 = import_reference_array(fx["before"], model.net)
    p1, s1 = import_reference_array(fx["after_lr1"], model.net)
    load_jax_params(model, p0, s0)
    x = torch.from_numpy(fx["images_u8"]).cuda()
    y = torch.from_numpy(fx["labels"].astype(np.int64)).cuda()
    bsz = x.shape[0]
    probe = copy.deepcopy(model).train()   # the forward moves BN's stats
    with torch.no_grad():
        logits = probe(uint8_normalize(x)).cpu().numpy()
    logit_dev = float(np.abs(logits - fx["logits"]).max())
    check(logit_dev <= 1e-4, f"grad parity: logits {logit_dev:.3g} over 1e-4")
    opt = sgd(1.0)
    ts = create_train_state(model, opt)
    before = {k: v.detach().clone() for k, v in named_params(model).items()}
    ts, m = make_train_step(model, opt)(ts, x, y)
    loss_dev = abs(m["loss"].item() - float(fx["loss"]))
    check(loss_dev <= 1e-5 + 1e-5 * abs(float(fx["loss"])),
          f"grad parity: loss {loss_dev:.3g}")
    worst = {}
    for name, p in named_params(model).items():
        layer, key = name.split(".")
        ours = (before[name] - p.detach()).double().cpu().numpy()
        ref = np.float64(p0[layer][key]) - np.float64(p1[layer][key])
        if layer.startswith("bn"):
            ours = bsz * ours     # the reference sums BN's grads over B
        if layer.startswith("conv") and key == "b":
            # a conv bias feeding BN has an analytically zero gradient
            check(np.abs(ref).max() < 5e-4 and np.abs(ours).max() < 5e-4,
                  f"grad parity: {name} is not noise-small")
            continue
        d = float(np.abs(ours - ref).max())
        worst[name] = d / max(1.0, float(np.abs(ref).max()))
        check(d <= GRAD_TOL * max(1.0, float(np.abs(ref).max())),
              f"grad parity: {name} max |dev| {d:.3g}")
    for layer, st in s1.items():
        for key in ("mean", "var"):
            d = float(np.abs(getattr(model.net[layer], key).cpu().numpy()
                             - st[key]).max())
            check(d <= 1e-4, f"grad parity: {layer}.{key} {d:.3g}")
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    phase(f"grad parity (4 images, lr 1, BN AlexNet 224 px, kernels): "
          f"logits max |dev| {logit_dev:.3g}, loss {loss_dev:.3g}; worst "
          f"gradients x max(1,|ref|): "
          + ", ".join(f"{k} {v:.3g}" for k, v in top)
          + "; moving statistics within 1e-4")


def synthetic_canvases(rng, n: int, size: int, width: int | None = None,
                       lift: float = 90):
    """[n,size,width,3] uint8 (width: size unless given) in 8x8 blocks of
    colour whose label's channel is raised by ``lift``, plus 25% pixel
    noise; labels [n] in 0..2."""
    width = width or size
    labels = rng.integers(0, 3, n)
    lo = rng.integers(0, 160, (n, 8, 8, 3)).astype(np.float32)
    lo += lift * np.eye(3, dtype=np.float32)[labels][:, None, None, :]
    img = np.kron(lo, np.ones((1, size // 8, width // 8, 1), np.float32))
    img = 0.75 * img + 0.25 * rng.integers(0, 256, (n, size, width, 3))
    return img.astype(np.uint8), labels


def snapshot(ts) -> dict:
    """The train state of a momentum run on a schedule: its optimizer
    state is optax's (TraceState, ScaleByScheduleState)."""
    trace, sched = ts.opt_state
    return {"model": copy.deepcopy(ts.model.state_dict()),
            "trace": {k: v.clone() for k, v in trace.trace.items()},
            "count": int(sched.count), "step": ts.step,
            "rng": ts.rng.get_state()}


def restore(ts, snap: dict) -> None:
    ts.model.load_state_dict(snap["model"])
    trace, sched = ts.opt_state
    for k, v in trace.trace.items():
        v.copy_(snap["trace"][k])
    sched.count.fill_(snap["count"])
    ts.step = snap["step"]
    ts.rng.set_state(snap["rng"])


def plain_training():
    """Routes the training step's kernel calls to the plain versions (which
    autograd differentiates)."""
    stack = ExitStack()
    stack.enter_context(mock.patch.object(nn_module, "conv2d_bias_relu_fn",
                                          conv2d))
    stack.enter_context(mock.patch.object(nn_module, "max_pool2d_fn",
                                          max_pool2d))
    return stack


class Decisions:
    """The ReLU masks and pool taps of one training step: recorded on the
    kernel step, replayed on the plain step.

    At batch 256 a few dozen of the 50M post-BN activations lie within
    1e-6 of 0 or of their pool window's runner-up; the kernel's and the
    plain conv's float32 sums differ by that much, so the two steps route
    those cotangents to different places. Replaying the kernel step's
    decisions holds everything else to the bars; the differing decisions
    are counted and the unreplayed deviation is reported beside."""

    def __init__(self):
        self.masks, self.taps = [], []
        self.mask_flips = self.tap_flips = 0

    def record(self):
        def relu(x):
            self.masks.append(x.detach() > 0)
            return ops_relu(x)

        def pool(x):
            self.taps.append(max_pool2d_taps(x.detach())[1])
            return max_pool2d_fn(x)

        return self._patch(relu, pool)

    def replay(self):
        masks, taps = iter(self.masks), iter(self.taps)

        def relu(x):
            m = next(masks)
            self.mask_flips += int((m != (x.detach() > 0)).sum().item())
            return torch.where(m, x, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))

        def pool(x):
            tap = next(taps)
            self.tap_flips += int((tap != max_pool2d_taps(x.detach())[1])
                                  .sum().item())
            h2, w2 = x.shape[1] // 2, x.shape[2] // 2
            win = torch.stack([x[:, dy:2 * h2:2, dx:2 * w2:2]
                               for dy in (0, 1) for dx in (0, 1)], dim=-1)
            return win.gather(-1, tap.long().unsqueeze(-1)).squeeze(-1)

        return self._patch(relu, pool)

    @staticmethod
    def _patch(relu, pool):
        stack = ExitStack()
        stack.enter_context(mock.patch.object(nn_module, "relu", relu))
        stack.enter_context(mock.patch.object(nn_module, "max_pool2d_fn",
                                              pool))
        return stack


def plain_augment(gen, images):
    return aug.augment_batch(gen, images, rotate=aug.rotate_shear_plain)


def state_tensors(ts) -> dict:
    out = {f"param {k}": v.detach().clone()
           for k, v in named_params(ts.model).items()}
    out.update({f"grad {k}": v.clone()
                for k, v in ts.opt_state[0].trace.items()})
    return out


def bn_stats(model) -> dict:
    return {f"{l.name}.{k}": getattr(l, k).clone() for l in model.net
            if hasattr(l, "var") for k in ("mean", "var")}


def training_phase() -> dict:
    """The slice: full-augmentation training at batch 256 on the card."""
    rng = np.random.default_rng(3)
    imgs, labels = synthetic_canvases(rng, TRAIN_N, CANVAS)
    held, held_labels = synthetic_canvases(rng, 2 * TRAIN_B, 224)
    ds = DeviceDataset.from_arrays(imgs, labels, device="cuda")
    held = torch.from_numpy(held).cuda()
    held_labels = torch.from_numpy(held_labels).cuda()
    model = get_model("alexnet", num_classes=3, batch_norm=True,
                      image_size=224, device="cuda",
                      generator=torch.Generator().manual_seed(5))
    opt = make_optimizer("momentum", 1.5e-2, schedule="cosine",
                         total_steps=TRAIN_STEPS)
    ts = create_train_state(model, opt, seed=7)
    step = make_device_train_step(model, opt, ds, TRAIN_B,
                                  augment_fn=aug.augment_batch)

    # one step on the kernels against the same step on the plain versions
    # (same weights, batch and drawn augmentation: the generator is
    # restored); the first step's momentum trace is its gradient
    snap = snapshot(ts)
    decisions = Decisions()
    with decisions.record():
        ts, mk = step(ts)
    got, got_bn = state_tensors(ts), bn_stats(model)
    plain_step = make_device_train_step(model, opt, ds, TRAIN_B,
                                        augment_fn=plain_augment, eager=True)
    restore(ts, snap)
    with plain_training():
        ts, _ = plain_step(ts)
    free = state_tensors(ts)
    free_worst = max(d / scale for d, scale in
                     (scaled_dev(got[k], free[k]) for k in free))
    restore(ts, snap)
    reset_launches()
    with plain_training(), decisions.replay():
        ts, mp = plain_step(ts)
    torch.cuda.synchronize()
    check(not any(launch_counts().values()),
          f"the plain training step launched a kernel: {launch_counts()}")
    ref, ref_bn = state_tensors(ts), bn_stats(model)
    loss_k, loss_p = mk["loss"].item(), mp["loss"].item()
    check(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p),
          f"train step: loss {loss_k} against plain {loss_p}")
    worst = 0.0
    for name in ref:
        d, scale = scaled_dev(got[name], ref[name])
        check(d <= GRAD_TOL * scale, f"train step: {name} max |dev| {d:.3g}")
        worst = max(worst, d / scale)
    worst_bn = 0.0
    for name in ref_bn:
        d, scale = scaled_dev(got_bn[name], ref_bn[name])
        check(d <= 1e-5 * scale, f"train step: {name} max |dev| {d:.3g}")
        worst_bn = max(worst_bn, d / scale)
    phase(f"train step, kernels against plain versions on the card: loss "
          f"{loss_k:.6f} / {loss_p:.6f}; gradients and new params max |dev| "
          f"{worst:.3g} x max(1,|ref|) with the kernel step's ReLU masks and "
          f"pool taps replayed ({decisions.mask_flips} mask and "
          f"{decisions.tap_flips} tap decisions differ), {free_worst:.3g} "
          f"without; BN moving statistics {worst_bn:.3g}")

    # the counted run: TRAIN_STEPS steps from the same start, then eval
    restore(ts, snap)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    losses = []
    for _ in range(TRAIN_STEPS):
        ts, m = step(ts)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eval_step = make_eval_step(model)
    correct = 0
    for i in range(0, held.shape[0], TRAIN_B):
        correct += eval_step(held[i:i + TRAIN_B],
                             held_labels[i:i + TRAIN_B])["correct"].item()
    counts = launch_counts()
    variants = (conv2d_bias_relu.launches_strip,
                conv2d_bias_relu.launches_tiled,
                conv2d_bias_relu.launches_direct)
    pool_variants = (max_pool2d_bwd.launches_window,
                     max_pool2d_bwd.launches_element)
    fwd_variants = (max_pool2d_fwd.launches_window,
                    max_pool2d_fwd.launches_element)
    n_eval = -(-held.shape[0] // TRAIN_B)
    want = {"uint8_normalize": n_eval, "max_pool2d_fwd": TRAIN_STEPS + n_eval,
            "max_pool2d_bwd": TRAIN_STEPS,
            "conv2d_bias_relu": 4 * (TRAIN_STEPS + n_eval),
            "rotate_shear": TRAIN_STEPS}
    check(counts == want, f"training launches {counts}, expected {want}")
    want_variants = (TRAIN_STEPS + n_eval, 3 * (TRAIN_STEPS + n_eval), 0)
    check(variants == want_variants, f"training conv launches strip/tiled/"
          f"direct {variants}, expected {want_variants}")
    check(pool_variants == (TRAIN_STEPS, 0), f"training pool backward "
          f"launches window/element {pool_variants}, expected "
          f"{(TRAIN_STEPS, 0)}")
    check(fwd_variants == (TRAIN_STEPS + n_eval, 0), f"training pool "
          f"forward launches window/element {fwd_variants}, expected "
          f"{(TRAIN_STEPS + n_eval, 0)}")
    losses = torch.stack(losses).cpu()
    check(bool(torch.isfinite(losses).all()), f"non-finite loss: {losses}")
    first, last = losses[:5].mean().item(), losses[-5:].mean().item()
    check(last < first, f"loss did not fall: first 5 {first}, last 5 {last}")
    acc = correct / held.shape[0]
    phase(f"trained {TRAIN_STEPS} steps at batch {TRAIN_B}: loss "
          f"{losses[0].item():.4f} -> {losses[-1].item():.4f} (mean of the "
          f"first 5 {first:.4f}, last 5 {last:.4f}); "
          f"{TRAIN_STEPS * TRAIN_B / wall:.1f} img/s end to end "
          f"({1e3 * wall / TRAIN_STEPS:.2f} ms per step); eval accuracy "
          f"{acc:.4f} on {held.shape[0]} held-out images; launches {counts}; "
          f"conv strip {variants[0]}, tiled {variants[1]}, direct "
          f"{variants[2]}; pool forward window {fwd_variants[0]}, element "
          f"{fwd_variants[1]}; pool backward window {pool_variants[0]}, "
          f"element {pool_variants[1]}")
    split = step_split(ts, ds, opt)
    phase("device ms per step (mean of 5): " + ", ".join(
        f"{k} {v:.4f}" for k, v in split.items())
        + f"; sum {sum(split.values()):.4f}")
    return counts, {"img_s": TRAIN_STEPS * TRAIN_B / wall, "split": split,
                    "acc": acc}


def step_split(ts, ds, opt, reps: int = 5, dtype=torch.float32) -> dict:
    """Device time of each stage of ``make_device_train_step``'s step, the
    stages run as the step runs them (in ``dtype``, the augmentation's and
    the compute dtype), with CUDA events between."""
    names = ("sample", "place", "rotate", "crop", "forward", "backward",
             "update")
    total = dict.fromkeys(names, 0.0)
    model = ts.model.train()
    params = named_params(model)
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
        ev[0].record()
        images, labels = ds.sample(ts.rng, TRAIN_B)
        ev[1].record()
        p = aug.draw_full(ts.rng, TRAIN_B)
        j = aug.place(aug.to_unit(images, dtype), p)
        ev[2].record()
        j = rotate_shear(j, p.angle)
        ev[3].record()
        x = aug.crop_full(j, p, dtype=dtype)
        ev[4].record()
        logits = model(x, compute_dtype=dtype).float()
        loss = softmax_cross_entropy(logits, labels)
        ev[5].record()
        grads = torch.autograd.grad(loss, list(params.values()))
        ev[6].record()
        opt.update(dict(zip(params, grads)), ts.opt_state, params)
        ts.step += 1
        ev[7].record()
        ev[7].synchronize()
        for k, name in enumerate(names):
            total[name] += ev[k].elapsed_time(ev[k + 1]) / reps
    return total


# ---------------------------------------------------------------------------
# bf16: the three bf16 kernels, the bf16 conv Function, bf16 training and
# bf16 serving
# ---------------------------------------------------------------------------

def bf16_ulp(ref: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each (bf16) value, as float32; 0 at 0."""
    r = ref.float().abs()
    _, e = torch.frexp(r)
    return torch.where(r > 0, torch.ldexp(torch.ones_like(r), e - 8),
                       torch.zeros_like(r))


def same16(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype == BF16 and bool(
        torch.equal(a.view(torch.int16), b.view(torch.int16)))


def check_conv_bf16(x, w, b, stride, what, conv=conv2d_bias_relu,
                    padding=0):
    """``conv`` on bf16 against the plain bf16 conv, ReLU off and on: every
    element within one bf16 ulp of the plain value plus BF16_CONV_SREL x S,
    two launches bit-identical. Returns (max |dev|, max |dev| / bar,
    elements that differ at all, elements)."""
    s_abs = conv2d(x.float().abs(), w.float().abs(),
                   torch.zeros_like(b, dtype=torch.float32), stride, False,
                   padding)
    worst = [0.0, 0.0, 0, 0]
    for relu in (False, True):
        y = conv(x, w, b, stride, relu, padding=padding)
        ref = conv2d(x, w, b, stride, relu, padding)
        check(y.dtype == BF16 and y.shape == ref.shape,
              f"{what} relu={relu}: {y.dtype} {tuple(y.shape)}")
        dev_ = (y.float() - ref.float()).abs()
        bar = bf16_ulp(ref) + BF16_CONV_SREL * s_abs
        check(bool((dev_ <= bar).all()), f"{what} relu={relu}: max deviation "
              f"{dev_.max().item():.3g}, {(dev_ / bar).max().item():.3g} x "
              "the bar (1 bf16 ulp + 1e-5 S)")
        check(same16(y, conv(x, w, b, stride, relu, padding=padding)),
              f"{what} relu={relu}: two launches differ")
        worst[0] = max(worst[0], dev_.max().item())
        worst[1] = max(worst[1], (dev_ / bar).max().item())
        worst[2] += int((y.view(torch.int16) != ref.view(torch.int16))
                        .sum().item())
        worst[3] += y.numel()
    return tuple(worst)


def bf16_conv_inputs(gen, bsz, h, wid, cin, cout):
    dev = torch.device("cuda")
    x = torch.rand((bsz, h, wid, cin), generator=gen, device=dev) if cin == 3 \
        else torch.relu(torch.randn((bsz, h, wid, cin), generator=gen,
                                    device=dev))
    w = torch.randn((3, 3, cin, cout), generator=gen, device=dev) * 0.1
    b = torch.randn((cout,), generator=gen, device=dev) * 0.1
    return x.to(BF16), w.to(BF16), b.to(BF16)


def cold_ms(fn, x, footprint: int) -> float:
    """``graph_ms`` of ``fn(x_i)`` over copies of ``x`` taken in turn, as
    many as put 120 MB (beyond the 50 MB L2) between two reads of one copy:
    each call finds its input in device memory. ``footprint``: the bytes
    one call reads and writes."""
    copies = [x.clone() for _ in range(max(2, -(-120_000_000 // footprint)))]
    turn = itertools.cycle(copies)
    return graph_ms(lambda: fn(next(turn)))


def bf16_variants_taking(bsz, h, wid, cin, cout, k, stride, aligned):
    """The variants of the bf16 entry point whose plan takes this shape."""
    out = []
    for v in BF16_VARIANTS:
        try:
            conv_bf16_plan(bsz, h, wid, cin, cout, k, stride, aligned, v)
        except ValueError:
            continue
        out.append(v)
    return out


def bf16_conv_phase(gen) -> tuple:
    """The bf16 conv at each AlexNet layer at batch 256 and B = 64 (conv1
    through the strip kernel, conv2-3 through the wgmma kernel, conv4
    through the tma kernel), then off those shapes through every variant
    that takes them, against the plain bf16 conv; times beside the previous
    design (the mma.sync kernel, for conv4 the wgmma kernel), cuDNN and the
    float32 kernels on the same values; the kernels line's row."""
    rows, layers = {}, [(3, 16, 224), (16, 32, 55), (32, 64, 27),
                        (64, 128, 13)]
    worst = [0.0, 0.0, 0, 0]
    for bsz in (TRAIN_B, B):
        sums = dict.fromkeys(("ms", "graph", "cold", "old", "plain", "lib",
                              "bound", "f32_ms", "f32_graph", "lib32"), 0.0)
        by = {"bytes": 0.0, "operations": 0.0}
        for i, (cin, cout, h) in enumerate(layers, start=1):
            x, w, b = bf16_conv_inputs(gen, bsz, h, h, cin, cout)
            plan = conv_bf16_plan(bsz, h, h, cin, cout, 3, 2,
                                  x.data_ptr() % 16 == 0)
            check(plan.variant == {1: "strip", 4: "tma"}.get(i, "wgmma"),
                  f"bf16 conv_layer_{i}: planned {plan}")
            got = check_conv_bf16(x, w, b, 2, f"bf16 conv_layer_{i} B={bsz}")
            worst = [max(worst[0], got[0]), max(worst[1], got[1]),
                     worst[2] + got[2], worst[3] + got[3]]
            x32, w32, b32 = x.float(), w.float(), b.float()
            xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous()
            xn32, wn32 = xn.float(), wn.float()
            ho = conv_out_size(h, 3, 2)
            m = bsz * ho * ho
            r = read_extent(h, 3, 2)
            io = 2 * bsz * r * r * cin + nbytes(w, b) + 2 * m * cout
            bnd = bound_ms(io, 2 * m * cout * 9 * cin + m * cout,
                           BF16_FLOP_PER_S)
            # the previous design: the mma.sync kernel, for conv4 the
            # wgmma kernel
            old = {1: "gather", 4: "wgmma"}.get(i, "vec")
            t = {"ms": time_ms(lambda: conv2d_bias_relu(x, w, b, 2, False)),
                 "graph": graph_ms(lambda: conv2d_bias_relu(x, w, b, 2,
                                                            False)),
                 "cold": (cold_ms(lambda xi: conv2d_bias_relu(xi, w, b, 2,
                                                              False), x, io)
                          if bsz == TRAIN_B else 0.0),
                 "old": graph_ms(lambda: launch_conv_bf16(
                     x, w, b, 2, False, variant=old)),
                 "plain": time_ms(lambda: conv2d(x, w, b, 2, False), iters=5),
                 "lib": graph_ms(lambda: F.conv2d(xn, wn, b, 2)),
                 "f32_ms": time_ms(lambda: conv2d_bias_relu(x32, w32, b32, 2,
                                                            False)),
                 "f32_graph": graph_ms(lambda: conv2d_bias_relu(
                     x32, w32, b32, 2, False)),
                 "lib32": graph_ms(lambda: F.conv2d(xn32, wn32, b32, 2)),
                 "bound": bnd[0]}
            for k, v in t.items():
                sums[k] += v
            by[bnd[1]] += bnd[0]
            sweep = ""
            if bsz == TRAIN_B:   # each R, or each tile of BN Cout and Cout/2
                if plan.variant == "strip":
                    cands = {strip_tile_name(j, BF16): j for j in
                             strip_tiles(bsz, h, h, cin, cout, 3, 2, 0,
                                         BF16)}
                elif plan.variant == "tma":
                    cands = {"x".join(map(str, tt)): j
                             for j, tt in enumerate(TMA_TILES)}
                else:
                    cands = {"x".join(map(str, tt)): j
                             for j, tt in enumerate(WGMMA_TILES)
                             if tt[0] in (cout, cout // 2)}
                times = {name: graph_ms(lambda j=j: launch_conv_bf16(
                    x, w, b, 2, False, tile=j, variant=plan.variant))
                    for name, j in cands.items()}
                label = {1: "R", 4: "BN x BM x stages x consumers"}.get(
                    i, "BN x MT x BK x stages x split x A-via-L1")
                sweep = (f"; {label} sweep alone (ms): " + ", ".join(
                             f"{k} {v:.4f}" for k, v in times.items()))
            tile = (strip_tile_name(plan.tile, BF16) if i == 1 else
                    "x".join(map(str, (TMA_TILES if i == 4 else WGMMA_TILES)
                                 [plan.tile])))
            phase(f"bf16 conv_layer_{i} [{bsz},{h},{h},{cin}]->[{bsz},{ho},"
                  f"{ho},{cout}] {plan.variant} {tile} (grid {plan.grid}, K "
                  f"{9 * cin} -> {plan.k_pad}): max|dev| {got[0]:.3g} "
                  f"({got[1]:.3g} of the bar), {got[2]} of {got[3]} elements "
                  f"differ from the plain version, two launches "
                  f"bit-identical; ms alone {t['graph']:.4f}"
                  + (f" (HBM-cold {t['cold']:.4f})" if t["cold"] else "")
                  + f", the previous design ({old}) alone {t['old']:.4f}, "
                  f"float32 kernel {t['f32_graph']:.4f}; through the wrapper "
                  f"{t['ms']:.4f} (float32 {t['f32_ms']:.4f}); bound "
                  f"{bnd[0]:.4f} ({bnd[1]}); plain {t['plain']:.4f}; cuDNN "
                  f"bf16 alone {t['lib']:.4f} (float32 {t['lib32']:.4f})"
                  f"{sweep}")
        sums["bound_by"] = max(by, key=by.get)
        rows[bsz] = sums
        phase(f"bf16 conv, 4 layers at B={bsz}: alone {sums['graph']:.4f} ms "
              + (f"(HBM-cold {sums['cold']:.4f}) " if sums["cold"] else "")
              + f"against the previous designs' {sums['old']:.4f} and the "
              f"float32 kernels' {sums['f32_graph']:.4f}; through the "
              f"wrapper {sums['ms']:.4f} (float32 {sums['f32_ms']:.4f}), "
              f"bound {sums['bound']:.4f}, plain {sums['plain']:.4f}, cuDNN "
              f"bf16 {sums['lib']:.4f} (float32 {sums['lib32']:.4f})")

    # off the AlexNet shapes: the ragged M edge of the serving buckets, odd
    # extents, Cin 3 and 64 against Cout 16 and 128, Cout 8, 24, 48 and 200,
    # the strip's k*Cin 5, 6 and 12 and stride 1, k 5, x off 16-byte
    # alignment; through the plan and every variant that takes the shape,
    # every strip R, wgmma tile and mma.sync tile
    cases = []
    for bsz in (1, 8):
        for cin, cout, h in layers:
            cases.append((f"B {bsz}, {h}x{h}x{cin}->{cout}", bsz, h, h, cin,
                          cout, 3, 2))
    cases += [("odd 27x31x16->32", 2, 27, 31, 16, 32, 3, 2),
              ("Cin 3 -> Cout 128", 2, 33, 35, 3, 128, 3, 2),
              ("Cin 64 -> Cout 16", 2, 15, 13, 64, 16, 3, 2),
              ("Cout 8", 3, 17, 17, 16, 8, 3, 2),
              ("Cout 48, Cin 12", 2, 21, 19, 12, 48, 3, 2),
              ("Cout 200", 2, 15, 15, 16, 200, 3, 2),
              ("strip 19x40x3->24", 2, 19, 40, 3, 24, 3, 2),
              ("strip Cin 1, k 5", 2, 21, 48, 1, 16, 5, 2),
              ("strip Cin 2, stride 1", 2, 12, 20, 2, 8, 3, 1),
              ("strip Cin 4, stride 1, Cout 32", 1, 11, 14, 4, 32, 3, 1),
              ("k 5, stride 1", 2, 20, 24, 4, 16, 5, 1),
              ("k 5, Cin 8, stride 1", 2, 14, 13, 8, 16, 5, 1)]
    off = [0.0, 0.0, 0, 0]
    seen = set()
    for what, bsz, h, wid, cin, cout, k, stride in cases:
        x, w, b = bf16_conv_inputs(gen, bsz, h, wid, cin, cout)
        if k != 3:
            w = (torch.randn((k, k, cin, cout), generator=gen, device="cuda")
                 * 0.1).to(BF16)
        plan = conv_bf16_plan(bsz, h, wid, cin, cout, k, stride, True)
        seen.add((plan.variant, plan.tile))
        got = check_conv_bf16(x, w, b, stride, f"bf16 conv ({what})")
        tables = {"gather": range(len(BF16_TILES)),
                  "vec": range(len(BF16_TILES)),
                  "strip": strip_tiles(bsz, h, wid, cin, cout, k, stride, 0,
                                       BF16),
                  "wgmma": range(len(WGMMA_TILES)),
                  "tma": range(len(TMA_TILES))}
        for v in bf16_variants_taking(bsz, h, wid, cin, cout, k, stride, True):
            for tile in tables[v]:
                g2 = check_conv_bf16(
                    x, w, b, stride, f"bf16 conv ({what}) {v} tile {tile}",
                    lambda *a, v=v, tile=tile, **kw: launch_conv_bf16(
                        *a, tile=tile, variant=v, **kw)[0])
                got = tuple(max(p, q) for p, q in zip(got[:2], g2[:2])) \
                    + got[2:]
        off = [max(off[0], got[0]), max(off[1], got[1]), off[2] + got[2],
               off[3] + got[3]]
    buf = torch.rand((2 * 27 * 27 * 16 + 1,), generator=gen,
                     device="cuda").to(BF16)
    xm = buf[1:].view(2, 27, 27, 16)    # 2 bytes past 16-byte alignment
    wm, bm_ = bf16_conv_inputs(gen, 1, 3, 3, 16, 32)[1:]
    check(conv_bf16_plan(2, 27, 27, 16, 32, 3, 2, xm.data_ptr() % 16 == 0)
          .variant == "gather", "bf16 conv: misaligned x not on gather")
    got2 = check_conv_bf16(xm, wm, bm_, 2, "bf16 conv (x off 16-byte "
                           "alignment)")
    phase(f"bf16 conv off the AlexNet shapes (" + "; ".join(c[0] for c in cases)
          + f"; x off alignment), through the plan (variant and tile "
          f"{sorted(seen)}) and every variant that takes each shape, with "
          f"every R, wgmma tile ({len(WGMMA_TILES)}), tma tile "
          f"({len(TMA_TILES)}) and mma.sync tile "
          f"({len(BF16_TILES)}): max|dev| {max(off[0], got2[0]):.3g} "
          f"({max(off[1], got2[1]):.3g} of the bar), {off[2] + got2[2]} of "
          f"{off[3] + got2[3]} elements differ, two launches bit-identical")
    return worst, rows


def bf16_pool_phase(gen) -> tuple:
    """The bf16 pool forward with tap and the window backward at
    [256,111,111,16] and B = 64, bit-exact against the plain versions on
    forced ties (and the forward on +-0 ties against the element kernel),
    at 7 x 9 and 5 x 4 extents; times beside the float32 kernels, the
    window and element forwards alone in turns (and HBM-cold at B = 64);
    then the forward at every VGG pool shape (``vgg_pool_table``)."""
    dev = torch.device("cuda")
    out = {}
    for bsz in (TRAIN_B, B):
        x = torch.randn((bsz, 111, 111, 16), generator=gen, device=dev)
        x = torch.relu(torch.round(x * 4) / 4).to(BF16)
        check(check_pool_fwd(x, f"bf16 pool forward B={bsz}") == "window",
              f"bf16 pool forward B={bsz}: not planned on the window kernel")
        check_pool_fwd(signed_ties(gen, x.shape, BF16),
                       f"bf16 pool forward B={bsz} with +-0")
        y, tap = max_pool2d_fwd(x, with_tap=True)
        ties = (x[:, :110:2, :110:2] == x[:, :110:2, 1:110:2]).float().mean()
        g = torch.randn((bsz, 55, 55, 16), generator=gen, device=dev).to(BF16)
        dx, dref = max_pool2d_bwd(tap, g, 111, 111), pool_bwd_plain(tap, g,
                                                                   111, 111)
        check(same16(dx, dref) and not dx[:, 110].any().item()
              and not dx[:, :, 110].any().item(),
              f"bf16 pool backward B={bsz}: differs from the plain version")
        xa = x.clone().requires_grad_(True)
        (auto,) = torch.autograd.grad(max_pool2d(xa), xa, g)
        check(same16(dx, auto), "bf16 pool backward: differs from autograd "
              "through the plain forward")
        x32, g32 = x.float(), g.float()
        _, tap32 = max_pool2d_fwd(x32, with_tap=True)
        xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        _, ind = F.max_pool2d(xn, 2, 2, return_indices=True)
        win, elem = pool_fwd_turns(x, True)
        win32, elem32 = pool_fwd_turns(x32, True)
        check(win <= elem and win32 <= elem32, f"pool forward B={bsz}: the "
              f"window kernel is slower than the element kernel (bf16 "
              f"{win:.4f} / {elem:.4f}, float32 {win32:.4f} / "
              f"{elem32:.4f} ms)")
        t = {
            "fwd": (time_ms(lambda: max_pool2d_fwd(x, with_tap=True)), win,
                    time_ms(lambda: max_pool2d_taps(x)),
                    graph_ms(lambda: F.max_pool2d(xn, 2, 2,
                                                  return_indices=True)),
                    pool_fwd_bound(x, True), win32),
            "bwd": (time_ms(lambda: max_pool2d_bwd(tap, g, 111, 111)),
                    graph_ms(lambda: max_pool2d_bwd(tap, g, 111, 111)),
                    time_ms(lambda: pool_bwd_plain(tap, g, 111, 111)),
                    graph_ms(lambda: torch.ops.aten
                             .max_pool2d_with_indices_backward(
                                 gn, xn, [2, 2], [2, 2], [0, 0], [1, 1],
                                 False, ind)),
                    bound_ms(nbytes(tap, g, dx), 0),
                    graph_ms(lambda: max_pool2d_bwd(tap32, g32, 111, 111)))}
        out[bsz] = t
        # HBM-cold: x fits the 50 MB L2 at B = 64, so the launches take it
        # in turn from four copies (100 MB in bf16)
        cold = ""
        if bsz == B:
            xs = [x] + [x.clone() for _ in range(3)]
            cw, ce = in_turns_graph(
                cycling(lambda xi: launch_pool_fwd(xi, True, "window"), xs),
                cycling(lambda xi: launch_pool_fwd(xi, True, "element"), xs))
            cold = (f"; forward alone HBM-cold in turns: window {cw:.4f}, "
                    f"element {ce:.4f}")
            del xs
        phase(f"bf16 pool [{bsz},111,111,16] (tie share {ties.item():.3f}): "
              f"forward value and tap on the window kernel bit-exact against "
              f"the plain version and the element kernel (and on +-0 ties), "
              f"the window backward bit-exact against the plain version and "
              f"autograd, cropped row and column zero; " + "; ".join(
                  f"{k} ms through the wrapper {v[0]:.4f}, alone {v[1]:.4f} "
                  f"(float32 kernel {v[5]:.4f}), plain {v[2]:.4f}, ATen bf16 "
                  f"alone {v[3]:.4f}, bound {v[4][0]:.4f}"
                  for k, v in t.items())
              + f"; forward alone in turns: window {win:.4f}, element "
              f"{elem:.4f} ({win / elem:.3f} of it), window at "
              f"{t['fwd'][4][0] / win:.3f} of the bound; float32 window "
              f"{win32:.4f}, element {elem32:.4f}, bound "
              f"{pool_fwd_bound(x32, True)[0]:.4f}" + cold)
    for (bsz, h, w_, c) in ((3, 7, 9, 8), (2, 5, 4, 8), (2, 5, 4, 4)):
        xs = signed_ties(gen, (bsz, h, w_, c), BF16)
        variant = check_pool_fwd(xs, f"bf16 pool {h}x{w_}x{c}")
        check(variant == ("element" if c == 4 else "window"),
              f"bf16 pool {h}x{w_}x{c}: planned on the {variant} kernel")
        ys, ts = max_pool2d_fwd(xs, with_tap=True)
        gs = torch.randn(ys.shape, generator=gen, device=dev).to(BF16)
        got = max_pool2d_bwd(ts, gs, h, w_)
        check(same16(got, pool_bwd_plain(ts, gs, h, w_))
              and not got[:, h - 1].any().item()
              and (w_ % 2 == 0 or not got[:, :, w_ - 1].any().item()),
              f"bf16 pool {h}x{w_}x{c}: differs")
    phase("bf16 pool 7x9x8 and 5x4x8 (window forward), 5x4x4 (element "
          "forward), +-0 ties: forward bit-exact against the plain version "
          "and the element kernel, window backward bit-exact, cropped rows "
          "and columns zero")
    out["vgg"] = vgg_pool_table(gen)
    return out


# (name, the pool's input at B = 64) for every 2x2 pool of vgg8 and vgg11
# (cnn_tpu/models/vgg.py: CONFIGS, 224 px)
VGG_POOLS = (("vgg8 pool_1", (B, 224, 224, 32)),
             ("vgg8 pool_2", (B, 112, 112, 64)),
             ("vgg8 pool_4", (B, 56, 56, 128)),
             ("vgg8 pool_6", (B, 28, 28, 256)),
             ("vgg11 pool_1", (B, 224, 224, 64)),
             ("vgg11 pool_2", (B, 112, 112, 128)),
             ("vgg11 pool_4", (B, 56, 56, 256)),
             ("vgg11 pool_6", (B, 28, 28, 512)),
             ("vgg11 pool_8", (B, 14, 14, 512)))


def cycling(fn, xs):
    """``fn`` on each of ``xs`` in turn, call by call."""
    it = itertools.cycle(xs)
    return lambda: fn(next(it))


def vgg_pool_table(gen) -> dict:
    """The pool forward without the tap (as served) at every VGG pool shape
    at B = 64, in float32 and bf16: planned on the window kernel,
    bit-exact against the plain version and the element kernel on +-0
    ties, and alone in turns with the element kernel (it must not be the
    slower), beside its bound. Returns (dtype, shape) -> (window ms,
    element ms, bound ms)."""
    table = {}
    for dtype in (torch.float32, BF16):
        for name, shape in VGG_POOLS:
            x = signed_ties(gen, shape, dtype)
            check(check_pool_fwd(x, f"{name} {shape}") == "window",
                  f"{name} {shape}: not planned on the window kernel")
            win, elem = pool_fwd_turns(x, False)
            bound = pool_fwd_bound(x, False)
            check(win <= elem, f"{name} {shape} {dtype}: the window kernel "
                  f"({win:.4f} ms) is slower than the element kernel "
                  f"({elem:.4f})")
            table[str(dtype)[6:], shape] = (win, elem, bound[0])
            del x
        phase(f"pool forward without the tap at the VGG pools, B = 64, "
              f"{str(dtype)[6:]}, window kernel bit-exact against the plain "
              f"version and the element kernel; alone in turns, ms (window, "
              f"element, bound, window's share of the bound): " + "; ".join(
                  f"{name} {list(shape[1:])} {w:.4f} {e:.4f} {b:.4f} "
                  f"{b / w:.3f}" for name, shape in VGG_POOLS
                  for w, e, b in [table[str(dtype)[6:], shape]]))
    return table


def bf16_function_phase(gen) -> float:
    """The conv Function in bf16 at the four training shapes: dx/dw/db
    against autograd through the plain bf16 conv with the Function's own
    ReLU mask, within 2 bf16 ulps of max|ref| per tensor; forward and
    backward timed in bf16 and in float32."""
    worst, times = 0.0, {}
    for cin, cout, h in ((3, 16, 224), (16, 32, 55), (32, 64, 27),
                         (64, 128, 13)):
        x, w, b = bf16_conv_inputs(gen, TRAIN_B, h, h, cin, cout)
        ho = conv_out_size(h, 3, 2)
        g = torch.randn((TRAIN_B, ho, ho, cout), generator=gen,
                        device="cuda").to(BF16)
        for relu in (False, True):
            leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
            got = torch.autograd.grad(conv2d_bias_relu_fn(*leaves, 2, relu),
                                      leaves, g)
            gm = g
            if relu:
                pre = conv2d_bias_relu(x, w, b, 2, False)
                gm = torch.where(pre > 0, g, torch.zeros_like(g))
            leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
            ref = torch.autograd.grad(conv2d(*leaves, 2, False), leaves, gm)
            for what, a, r in zip(("dx", "dw", "db"), got, ref):
                check(a.dtype == r.dtype == BF16, f"bf16 Function {what} "
                      f"dtype {a.dtype}")
                top = r.float().abs().max()
                ulp = bf16_ulp(top.reshape(1))[0].item()
                d = (a.float() - r.float()).abs().max().item()
                check(d <= 2 * ulp, f"bf16 Function conv {cin}->{cout} "
                      f"relu={relu} {what}: max |dev| {d:.3g} over 2 ulps "
                      f"of {top.item():.3g}")
                worst = max(worst, d / ulp if ulp else 0.0)
        # forward + backward as training asks it (no dx of the images), in
        # bf16 and in float32 on the same values
        for dt in (BF16, torch.float32):
            leaves = [t.to(dt).requires_grad_(True) for t in (x, w, b)]
            wrt = leaves if cin > 3 else leaves[1:]
            gd = g.to(dt)
            times.setdefault(dt, []).append(time_ms(
                lambda: torch.autograd.grad(
                    conv2d_bias_relu_fn(*leaves, 2, False), wrt, gd),
                iters=10))
    phase(f"bf16 conv Function at batch {TRAIN_B}, four layers, ReLU off and "
          f"on: dx/dw/db within {worst:.3g} bf16 ulps of max|ref| (bar 2) of "
          f"autograd through the plain bf16 conv; forward+backward per layer "
          f"(ms), bf16 " + ", ".join(f"{t:.4f}" for t in times[BF16])
          + "; float32 " + ", ".join(f"{t:.4f}" for t in times[torch.float32]))
    return worst


def bf16_training_phase(f32: dict) -> dict:
    """The training configuration of the float32 run, in bf16: the same
    data, model seed, optimizer and steps, ``compute_dtype=bf16`` and the
    augmentation in bf16; exact bf16 launch counts, no float32 kernel."""
    rng = np.random.default_rng(3)
    imgs, labels = synthetic_canvases(rng, TRAIN_N, CANVAS)
    held, held_labels = synthetic_canvases(rng, 2 * TRAIN_B, 224)
    ds = DeviceDataset.from_arrays(imgs, labels, device="cuda")
    held = torch.from_numpy(held).cuda()
    held_labels = torch.from_numpy(held_labels).cuda()
    model = get_model("alexnet", num_classes=3, batch_norm=True,
                      image_size=224, device="cuda",
                      generator=torch.Generator().manual_seed(5))
    opt = make_optimizer("momentum", 1.5e-2, schedule="cosine",
                         total_steps=TRAIN_STEPS)
    ts = create_train_state(model, opt, seed=7)
    step = make_device_train_step(
        model, opt, ds, TRAIN_B, compute_dtype=BF16,
        augment_fn=lambda gen, im: aug.augment_batch(gen, im, dtype=BF16))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    losses = []
    for _ in range(TRAIN_STEPS):
        ts, m = step(ts)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eval_step = make_eval_step(model, compute_dtype=BF16)
    correct = 0
    for i in range(0, held.shape[0], TRAIN_B):
        correct += eval_step(held[i:i + TRAIN_B],
                             held_labels[i:i + TRAIN_B])["correct"].item()
    counts = {k: v for k, v in read_counters().items() if v}
    n_eval = -(-held.shape[0] // TRAIN_B)
    fwd = TRAIN_STEPS + n_eval
    want = {"uint8_normalize.launches": n_eval,
            "uint8_normalize.launches_wide": n_eval,
            "max_pool2d_fwd.launches": fwd, "max_pool2d_fwd.launches_bf16": fwd,
            "max_pool2d_fwd.launches_bf16_window": fwd,
            "max_pool2d_bwd.launches": TRAIN_STEPS,
            "max_pool2d_bwd.launches_bf16": TRAIN_STEPS,
            "conv2d_bias_relu.launches": 4 * fwd,
            "conv2d_bias_relu.launches_bf16": 4 * fwd,
            "conv2d_bias_relu.launches_bf16_strip": fwd,
            "conv2d_bias_relu.launches_bf16_wgmma": 2 * fwd,
            "conv2d_bias_relu.launches_bf16_tma": fwd,
            "rotate_shear.launches": TRAIN_STEPS}
    check(counts == want, f"bf16 training launches {counts}, expected {want}")
    losses = torch.stack(losses).cpu()
    check(bool(torch.isfinite(losses).all()), f"bf16 non-finite loss: {losses}")
    first, last = losses[:5].mean().item(), losses[-5:].mean().item()
    check(last < first, f"bf16 loss did not fall: first 5 {first}, last 5 "
          f"{last}")
    check(all(p.dtype == torch.float32 for p in model.parameters())
          and all(v.dtype == torch.float32 for v in ts.opt_state[0].trace
                  .values()), "bf16 training: a master tensor left float32")
    acc = correct / held.shape[0]
    img_s = TRAIN_STEPS * TRAIN_B / wall
    phase(f"bf16 trained {TRAIN_STEPS} steps at batch {TRAIN_B} "
          f"(allow_bf16_reduced_precision_reduction "
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}"
          f" outside the port's products): loss {losses[0].item():.4f} -> "
          f"{losses[-1].item():.4f} (mean of the first 5 {first:.4f}, last 5 "
          f"{last:.4f}); {img_s:.1f} img/s end to end (float32 "
          f"{f32['img_s']:.1f}), {1e3 * wall / TRAIN_STEPS:.2f} ms per step; "
          f"eval accuracy {acc:.4f} (float32 {f32['acc']:.4f}) on "
          f"{held.shape[0]} held-out images; launches {counts} (exact: bf16 "
          f"kernels only, conv1 on the strip kernel, conv2-3 on the wgmma "
          f"kernel and conv4 on the tma kernel; no float32 conv or pool "
          f"kernel, no mma.sync conv)")
    split = step_split(ts, ds, opt, dtype=BF16)
    phase("bf16 device ms per step (mean of 5): " + ", ".join(
        f"{k} {v:.4f} (float32 {f32['split'][k]:.4f})"
        for k, v in split.items())
        + f"; sum {sum(split.values()):.4f} (float32 "
        f"{sum(f32['split'].values()):.4f})")
    return counts


def bf16_serving_phase(model) -> dict:
    """``InferenceEngine(compute_dtype=bf16)`` on the committed checkpoint:
    each bucket's replay bit-equal to the eager bf16 forward, launch counts
    exact through the replays, against the float32 engine; bucket-64 times
    beside float32."""
    rng = np.random.default_rng(4)
    dev = torch.device("cuda")
    engine = serving.InferenceEngine(model, buckets=BUCKETS, device="cuda",
                                     compute_dtype=BF16)
    engine.warmup()
    f32 = serving.InferenceEngine(model, buckets=BUCKETS, device="cuda")
    f32.warmup()
    want1 = {"uint8_normalize.launches": 1, "uint8_normalize.launches_wide": 1,
             "max_pool2d_fwd.launches": 1, "max_pool2d_fwd.launches_bf16": 1,
             "max_pool2d_fwd.launches_bf16_window": 1,
             "conv2d_bias_relu.launches": 4,
             "conv2d_bias_relu.launches_bf16": 4,
             "conv2d_bias_relu.launches_bf16_strip": 1,
             "conv2d_bias_relu.launches_bf16_wgmma": 2,
             "conv2d_bias_relu.launches_bf16_tma": 1}
    for b in BUCKETS:
        check(engine._ready[b].launches == want1, f"bf16 bucket {b}'s "
              f"capture recorded {engine._ready[b].launches}")
        for n in sorted({b, max(1, b - 3)}):
            chunk = synthetic_images(rng, n)
            labels, probs = engine.predict(chunk)
            batch = np.zeros((b, 224, 224, 3), np.uint8)
            batch[:n] = chunk
            with torch.no_grad():
                ep, el = engine._forward(torch.from_numpy(batch).to(dev))
            check(same_arrays(labels, el[:n].int().cpu().numpy())
                  and same_arrays(probs, ep[:n].cpu().numpy()),
                  f"bf16 bucket {b}, {n} images: the replay differs from the "
                  "eager forward")
    sizes = (1, 5, 64, 100)
    imgs = {n: synthetic_images(rng, n) for n in sizes}
    calls = sum(-(-n // BUCKETS[-1]) for n in sizes)
    reset_launches()
    results = {n: engine.predict(imgs[n]) for n in sizes}
    torch.cuda.synchronize()
    counts = {k: v for k, v in read_counters().items() if v}
    want = {k: v * calls for k, v in want1.items()}
    check(counts == want, f"bf16 predict launches {counts}, expected {want}")
    ref = {n: f32.predict(imgs[n]) for n in sizes}
    agree = sum(int((results[n][0] == ref[n][0]).sum()) for n in sizes)
    pdev = max(float(np.abs(results[n][1] - ref[n][1]).max()) for n in sizes)
    x = torch.from_numpy(imgs[64]).to(dev)
    with torch.no_grad():
        l16 = model(uint8_normalize(x), compute_dtype=BF16).float()
        l32 = model(uint8_normalize(x))
    d, scale = scaled_dev(l16, l32)
    ldev = d / scale
    check(ldev <= BF16_MODEL_TOL and pdev <= BF16_MODEL_TOL,
          f"bf16 serving against float32: logits {ldev:.3g} x max(1,|ref|), "
          f"probs {pdev:.3g}")
    engine.predict(imgs[64])
    f32.predict(imgs[64])
    torch.cuda.synchronize()
    e2e = {}
    for name, eng in (("bf16", engine), ("float32", f32), ("bf16 ", engine),
                      ("float32 ", f32)):
        t = time.perf_counter()
        for _ in range(20):
            eng.predict(imgs[64])
        e2e.setdefault(name.strip(), []).append(
            20 * 64 / (time.perf_counter() - t))
    graphed = in_turns(engine._ready[64].graph.replay,
                       f32._ready[64].graph.replay)
    with torch.no_grad():
        split = layer_times(model, uint8_normalize(x), BF16)
    phase(f"bf16 serving (buckets {BUCKETS}, one graph each): replays "
          f"bit-equal to the eager bf16 forward at every bucket, full and "
          f"padded; launches {counts} (exact, bf16 kernels only, conv1 on the "
          f"strip, conv2-3 on the wgmma and conv4 on the tma kernel); "
          f"labels agree "
          f"with the float32 engine on {agree} of {sum(sizes)} images; probs "
          f"max|dev| {pdev:.3g}, bucket-64 logits max|dev| {ldev:.3g} x "
          f"max(1,|ref|) (bar {BF16_MODEL_TOL}); bucket 64 end to end "
          + ", ".join(f"{k} {v[0]:.1f} / {v[1]:.1f} img/s" for k, v in
                      e2e.items())
          + f"; the bucket-64 graph {graphed[0]:.4f} ms (float32 "
          f"{graphed[1]:.4f}); per layer, eager bf16 (ms): "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    del engine, f32
    return counts


# ---------------------------------------------------------------------------
# the train CLI, end to end
# ---------------------------------------------------------------------------

CLI_N = 1280                 # images written, 3 classes, split 8:1:1
CLI_HW = (304, 280)          # their height and width: above the canvas
CLI_LIFT = 12                # the class signal: the other phases' 90 is
                             # learnt before the first validation, 12
                             # leaves the loss falling through 80 steps
CLI_SIZES = {"--image-size": 224, "--canvas-size": CANVAS,
             "--train-batch-size": TRAIN_B, "--valid-batch-size": B}
CLI_HOST_B = B               # the host-loader run's batch
CLI_FLAGSHIP = ["--device-dataset", "true", "--augment-mode", "full",
                "--compute-dtype", "bfloat16", "--batch-norm", "true",
                "--optimizer", "momentum", "--learning-rate", "1.5e-2",
                "--lr-schedule", "cosine"]


def write_ppm_dataset(root: Path, rng) -> None:
    """``root/<category>/<i>.ppm``: ``synthetic_canvases``'s colour blocks
    at ``CLI_HW``, a class raised in its own channel."""
    h, w = CLI_HW
    for start in range(0, CLI_N, 128):
        imgs, labels = synthetic_canvases(rng, min(128, CLI_N - start), h, w,
                                          CLI_LIFT)
        for i, (img, lbl) in enumerate(zip(imgs, labels)):
            d = root / ("dog", "panda", "bird")[lbl]
            d.mkdir(exist_ok=True)
            (d / f"{start + i:05d}.ppm").write_bytes(
                f"P6\n{w} {h}\n255\n".encode()
                + np.ascontiguousarray(img[:, :, ::-1]).tobytes())


class CliTimes:
    """Wall seconds of the CLI's parts, the device synchronised around each:
    decode and upload of its ``DeviceDataset``s, the training loop (the
    ``trace`` scope, validation taken out), validation, the final test."""

    def __init__(self):
        self.s = dict.fromkeys(("decode", "upload", "loop", "valid", "test"),
                               0.0)

    def _timed(self, key, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.s[key] += time.perf_counter() - t
            return out
        return run

    def patch(self):
        times, cli = self, train_cli

        class Timed(DeviceDataset):
            def __init__(self, *args, **kwargs):
                t = time.perf_counter()
                super().__init__(*args, **kwargs)
                times.s["decode"] += time.perf_counter() - t - self.upload

            def _place(self, *args):
                t = time.perf_counter()
                super()._place(*args)
                torch.cuda.synchronize()
                self.upload = time.perf_counter() - t
                times.s["upload"] += self.upload

        real_trace = cli.trace

        @contextmanager
        def timed_trace(*args):
            with real_trace(*args):
                torch.cuda.synchronize()
                t = time.perf_counter()
                valid0 = times.s["valid"]
                yield
                torch.cuda.synchronize()
                times.s["loop"] += (time.perf_counter() - t
                                    - (times.s["valid"] - valid0))

        real_evaluate = cli.evaluate

        def host_eval(eval_step, loader, device, confusion=None):
            # the host loader's validation, or the final test
            key = "valid" if confusion is None else "test"
            return times._timed(key, real_evaluate)(eval_step, loader, device,
                                                    confusion)

        stack = ExitStack()
        stack.enter_context(mock.patch.object(cli, "DeviceDataset", Timed))
        stack.enter_context(mock.patch.object(cli, "trace", timed_trace))
        stack.enter_context(mock.patch.object(cli, "evaluate", host_eval))
        stack.enter_context(mock.patch.object(
            cli, "evaluate_device", self._timed("valid", cli.evaluate_device)))
        return stack


def run_cli(argv, what: str, want: dict, times: CliTimes) -> tuple:
    """One in-process ``main(argv)`` with the counters at 0 just before;
    exit code 0, "training done!" and the exact launch counts ``want``;
    returns its output and the counts."""
    torch.cuda.synchronize()
    reset_launches()
    out = io.StringIO()
    try:
        with times.patch(), redirect_stdout(out):
            rc = train_cli.main(argv)
    except BaseException:
        print(f"{what}: the CLI raised; its output ends "
              f"{out.getvalue()[-2000:]!r}", file=sys.stderr)
        raise
    torch.cuda.synchronize()
    counts = {k: v for k, v in read_counters().items() if v}
    text = out.getvalue()
    check(rc == 0 and "training done!" in text,
          f"{what}: exit code {rc}; output ends {text[-2000:]!r}")
    check(counts == want, f"{what}: launches {counts}, expected {want}")
    return text, counts


def cli_want(steps: int, evals: int, bf16: bool, rotate: bool) -> dict:
    """The exact counters of ``steps`` train steps and ``evals`` eval
    batches (conv1 on a strip kernel, conv2-4 on the tiled kernel; in bf16
    conv2-3 on the wgmma kernel and conv4 on the tma one; the pool forward
    and backward on the window kernels)."""
    fwd = steps + evals
    conv = ({"launches_bf16": 4 * fwd, "launches_bf16_strip": fwd,
             "launches_bf16_wgmma": 2 * fwd, "launches_bf16_tma": fwd}
            if bf16 else
            {"launches_strip": fwd, "launches_tiled": 3 * fwd})
    want = {"uint8_normalize.launches": evals,
            "uint8_normalize.launches_wide": evals,
            "max_pool2d_fwd.launches": fwd,
            "max_pool2d_bwd.launches": steps,
            "conv2d_bias_relu.launches": 4 * fwd}
    want.update({f"conv2d_bias_relu.{k}": v for k, v in conv.items()})
    if bf16:
        want.update({"max_pool2d_fwd.launches_bf16": fwd,
                     "max_pool2d_fwd.launches_bf16_window": fwd,
                     "max_pool2d_bwd.launches_bf16": steps})
    else:
        want.update({"max_pool2d_fwd.launches_window": fwd,
                     "max_pool2d_bwd.launches_window": steps})
    if rotate:
        want["rotate_shear.launches"] = steps
    return {k: v for k, v in want.items() if v}


def cli_phase(tmp: Path) -> tuple[dict, dict]:
    """The flagship command through the port's CLI on a PPM dataset written
    under ``tmp``: 60 iterations, then ``--resume auto`` to 80, then a
    host-loader run. Returns the launches of the three runs, added up, and
    what phase 16 evaluates: the dataset, the flags that size it, the best
    and the last checkpoint, the resumed run's final test lines and the
    number of valid and test batches."""
    try:
        import PIL
        pil = f"PIL {PIL.__version__} imports"
    except ImportError:
        pil = "PIL is not installed (PPM decodes without it)"
    phase(f"train CLI: {pil}")
    data, ck, host_ck = tmp / "animals", tmp / "ck", tmp / "host"
    data.mkdir()
    t = time.perf_counter()
    write_ppm_dataset(data, np.random.default_rng(21))
    write_s = time.perf_counter() - t
    sizes = [str(v) for kv in CLI_SIZES.items() for v in kv]
    common = ["--dataset-path", str(data), "--checkpoint-dir", str(ck),
              *sizes]
    splits = split_dataset(discover_dataset(str(data), ("dog", "panda",
                                                        "bird")))
    n_valid, n_test = len(splits["valid"]), len(splits["test"])
    check((len(splits["train"]), n_test, n_valid)
          == (CLI_N * 8 // 10, CLI_N // 10, CLI_N // 10),
          f"split {[len(v) for v in splits.values()]}")
    vb = CLI_SIZES["--valid-batch-size"]
    evals, tests = -(-n_valid // vb), -(-n_test // vb)

    runs = []
    times = CliTimes()
    out, counts = run_cli(CLI_FLAGSHIP + common + [
        "--total-iters", "60", "--valid-iters", "20",
        "--save-iters", "60"], "flagship, iterations 1-60",
        cli_want(60, 3 * evals + tests, True, True), times)
    runs.append(("flagship 1-60", dict(times.s), counts))
    names1 = sorted(p.name for p in ck.glob("*.ckpt"))
    check(len(names1) == 1 and names1[0].startswith("iter_60_train_"),
          f"checkpoints after 60 iterations: {names1}")
    times = CliTimes()
    out2, counts = run_cli(CLI_FLAGSHIP + common + [
        "--total-iters", "80", "--valid-iters", "20",
        "--save-iters", "20", "--resume", "auto"],
        "flagship, --resume auto to 80",
        cli_want(20, evals + tests, True, True), times)
    runs.append(("resume 61-80", dict(times.s), counts))
    check(f"resumed from {ck / names1[0]} at step 60" in out2,
          "the resumed run did not start from iteration 60's checkpoint")
    names = sorted(p.name for p in ck.glob("*.ckpt"))
    check(len(names) == 2 and names[1].startswith("iter_80_train_"),
          f"checkpoints after 80 iterations: {names}")
    hist = read_history(str(ck / "history.jsonl"))
    check([h["step"] for h in hist] == [20, 40, 60, 80],
          f"history steps {[h['step'] for h in hist]}")
    check(all(np.isfinite(h["loss"]) for h in hist)
          and hist[-1]["loss"] < hist[0]["loss"],
          f"logged mean loss did not fall: {[h['loss'] for h in hist]}")
    for line in (out + out2).splitlines():
        if line.startswith(("Valid===>", "Test===>")):
            phase(f"train CLI: {line.strip()}")
    test_lines = out2[out2.index("confusion matrix"):].splitlines()[:5]
    phase("train CLI, resumed run's final test: "
          + " | ".join(l.rstrip() for l in test_lines))

    # the best checkpoint, reloaded, reproduces its logged accuracy;
    # its .model gives the same logits through the serving engine
    best = out2.split("best checkpoint: ")[1].split(" ")[0]
    logged = next(h for h in hist if h["step"] == 80)
    size = CLI_SIZES["--image-size"]
    model = get_model("alexnet", num_classes=3, batch_norm=True,
                      image_size=size, device="cuda")
    opt = make_optimizer("momentum", 1.5e-2, schedule="cosine",
                         total_steps=80)
    ts = load_checkpoint(best, create_train_state(model, opt, seed=1))
    check(ts.step == 80, f"best checkpoint at step {ts.step}")
    valid_ds = DeviceDataset(splits["valid"], size, 2, device="cuda")
    loss, acc = train_cli.evaluate_device(
        make_eval_step(model, compute_dtype=BF16), valid_ds, vb)
    check((loss, acc) == (logged["valid_loss"], logged["valid_accuracy"]),
          f"the best checkpoint gives valid loss and accuracy "
          f"{(loss, acc)}, the run logged {logged}")
    exported = tmp / "best.model"
    export_reference_model(str(exported), model)
    twin = get_model("alexnet", num_classes=3, batch_norm=True,
                     image_size=size, device="cuda")
    load_reference_model(twin, exported)
    x = valid_ds.images[:vb]
    got = []
    for m in (model, twin):
        eng = serving.InferenceEngine(m, buckets=(vb,), device="cuda",
                                      compute_dtype=BF16)
        eng.warmup()
        with torch.no_grad():
            logits = eng.model(uint8_normalize(x),
                               compute_dtype=BF16).float()
        got.append((logits, *eng.predict(x.cpu().numpy())))
    check(bits_equal(got[0][0], got[1][0])
          and all(same_arrays(a, b) for a, b in zip(got[0][1:],
                                                    got[1][1:])),
          "the exported .model's logits differ from its checkpoint's")

    # the host loader on the card: float32, the fast device augment
    times = CliTimes()
    _, counts = run_cli(common + [
        "--checkpoint-dir", str(host_ck), "--device-augment", "true",
        "--augment-mode", "fast", "--batch-norm", "true",
        "--optimizer", "momentum", "--learning-rate", "1.5e-2",
        "--lr-schedule", "cosine", "--train-batch-size", str(CLI_HOST_B),
        "--total-iters", "20", "--valid-iters", "20",
        "--save-iters", "20"], "host loader, 20 iterations",
        cli_want(20, evals + tests, False, False), times)
    runs.append(("host loader 1-20", dict(times.s), counts))
    check(len(list(host_ck.glob("iter_20_train_*.ckpt"))) == 1,
          "the host-loader run wrote no iter_20 checkpoint")
    total = {}
    for name, s, counts in runs:
        phase(f"train CLI {name}: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in s.items()) + f"; launches {counts}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    phase(f"train CLI: wrote {CLI_N} {CLI_HW[0]}x{CLI_HW[1]} PPM images in "
          f"{write_s:.2f} s; logged mean loss at steps 20-80 "
          f"{[round(h['loss'], 6) for h in hist]}; valid loss {loss:.6f} and "
          f"accuracy {acc} reproduced from the "
          f"best checkpoint ({os.path.basename(best)}); its exported .model "
          f"bit-equal through InferenceEngine; launches exact in every run")
    return total, {"data": data, "sizes": sizes, "best": best,
                   "first": str(ck / names[0]), "test_lines": test_lines,
                   "test": [l for l in out2.splitlines()
                            if l.startswith("Test===>")][-1],
                   "valid_batches": evals, "test_batches": tests}


def committed_ckpt_phase() -> None:
    """The committed ``.ckpt`` of the serving model: its logits bit-equal
    to those of the ``.model`` beside it."""
    path = MODEL.with_suffix(".ckpt")
    model = get_model("alexnet", num_classes=3, batch_norm=True,
                      image_size=224, device="cuda")
    opt = make_optimizer("momentum", 1.5e-2, schedule="cosine",
                         total_steps=12000)
    ts = load_checkpoint(str(path), create_train_state(model, opt, seed=1))
    ref = get_model("alexnet", num_classes=3, batch_norm=True,
                    image_size=224, device="cuda")
    load_reference_model(ref, MODEL)
    x = uint8_normalize(torch.from_numpy(synthetic_images(
        np.random.default_rng(4), B)).cuda())
    with torch.no_grad():
        a, b = model.eval()(x), ref.eval()(x)
    check(ts.step == 12000 and bits_equal(a, b),
          f"{path.name}: step {ts.step}, logits against the .model max|dev| "
          f"{(a - b).abs().max().item():.3g}")
    phase(f"committed checkpoint {path.name}: step {ts.step}, logits "
          "bit-equal to the .model beside it")


# ---------------------------------------------------------------------------
# inference, Grad-CAM and evaluation through the port's CLIs
# ---------------------------------------------------------------------------

PHOTOS = ROOT / "tests" / "fixtures" / "reference_parity.npz"
PHOTO_CLASSES = ["dog", "panda", "bird"] * 2
INFER_PROB_ATOL = 1e-6  # printed to 6 places: 5e-7 of it is the rounding
CAM_ATOL = 1e-4         # the kernel path's CAM against the plain path's
# the same inside a trunk: a capture at PipeCNN's block 3 of 8 carries the
# float32 reassociation of the two paths' sums through 16 64-channel convs
# forward and 10 backward before the range normalisation (1.85e-4 measured
# at trunk/block_3/b_conv1 on the H100)
CAM_TRUNK_ATOL = 1e-3
DROPOUT_P = 0.25
PRED_LINE = re.compile(r"^(.*)===> \[classification: (\w+)\] "
                       r"\[prob: ([\d.]+)\]$")


def counted_run(what: str, main, argv, want) -> tuple:
    """One in-process ``main(argv)`` with the counters at 0 just before:
    exit code 0 and exactly the launch counts ``want`` (a dict, or a
    function giving it after the run); returns its output, the counts and
    its wall seconds (the device synchronised)."""
    torch.cuda.synchronize()
    reset_launches()
    out = io.StringIO()
    t = time.perf_counter()
    try:
        with redirect_stdout(out):
            rc = main(argv)
    except BaseException:
        print(f"{what}: raised; its output ends {out.getvalue()[-2000:]!r}",
              file=sys.stderr)
        raise
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    counts = {k: v for k, v in read_counters().items() if v}
    text = out.getvalue()
    check(rc == 0, f"{what}: exit code {rc}; output ends {text[-2000:]!r}")
    if callable(want):      # counts known only once the run has ended
        want = want()
    check(counts == want, f"{what}: launches {counts}, expected {want}")
    return text, counts, seconds


def f32_want(norm=0, strip=0, tiled=0, pool=0, pool_bwd=0) -> dict:
    """The float32 counters of that many launches of each kernel (the
    normalize through its wide variant, the pool forward and backward
    through the window kernels)."""
    want = {"uint8_normalize.launches": norm,
            "uint8_normalize.launches_wide": norm,
            "conv2d_bias_relu.launches": strip + tiled,
            "conv2d_bias_relu.launches_strip": strip,
            "conv2d_bias_relu.launches_tiled": tiled,
            "max_pool2d_fwd.launches": pool,
            "max_pool2d_fwd.launches_window": pool,
            "max_pool2d_bwd.launches": pool_bwd,
            "max_pool2d_bwd.launches_window": pool_bwd}
    return {k: v for k, v in want.items() if v}


def eval_want(batches: int, forwards: int, bf16: bool = False) -> dict:
    """``batches`` normalized batches and ``forwards`` eval forwards."""
    if bf16:
        want = cli_want(0, forwards, True, False)
        want["uint8_normalize.launches"] = batches
        want["uint8_normalize.launches_wide"] = batches
        return want
    return f32_want(batches, forwards, 3 * forwards, forwards)


def add_up(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def write_photos(root: Path) -> tuple[list, list]:
    """The six fixture photos (224 px, BGR) as binary PPM under ``root``;
    returns the arrays and the paths."""
    fx = np.load(PHOTOS)
    imgs = [fx[f"image_u8_{i}"] for i in range(6)]
    paths = []
    for i, img in enumerate(imgs):
        paths.append(str(root / f"{i}.ppm"))
        Path(paths[-1]).write_bytes(b"P6\n224 224\n255\n"
                                    + img[:, :, ::-1].tobytes())
    return imgs, paths


def predictions(text: str) -> list:
    """(path, class, printed probability) of each classified image."""
    return [(m.group(1), m.group(2), float(m.group(3)))
            for m in map(PRED_LINE.match, text.splitlines()) if m]


def plain_cam(model, x, layer, mode):
    """``compute_cam`` on the plain versions, on the card."""
    with plain_versions(), plain_training():
        return gradcam_cli.compute_cam(model, x, layer, mode)


def inference_phase(smi: str, tmp: Path) -> dict:
    """Phase 15: the infer and Grad-CAM CLIs on the committed BN checkpoint
    and the six fixture photos; returns their launches, added up."""
    imgs, paths = write_photos(tmp)
    total = {}
    model = get_model("alexnet", num_classes=3, batch_norm=True,
                      image_size=224, device="cuda")
    load_reference_model(model, MODEL)
    engine = serving.InferenceEngine(model, buckets=(1,), device="cuda")
    engine.warmup()
    served = [engine.predict(img[None]) for img in imgs]
    per_image = f32_want(1, 1, 3, 1)
    infer_s = {}
    for ckpt in (MODEL, MODEL.with_suffix(".ckpt")):
        text, counts, infer_s[ckpt.suffix] = counted_run(
            f"infer {ckpt.name}", infer_cli.main,
            ["--checkpoint", str(ckpt), "--batch-norm", *paths],
            {k: 6 * v for k, v in per_image.items()})
        add_up(total, counts)
        rows = predictions(text)
        check([r[0] for r in rows] == paths
              and [r[1] for r in rows] == PHOTO_CLASSES,
              f"infer {ckpt.name}: printed {rows}")
        for i, ((_, _, p), (label, probs)) in enumerate(zip(rows, served)):
            check(int(label[0]) == i % 3
                  and abs(p - float(probs[0, label[0]])) <= INFER_PROB_ATOL,
                  f"infer {ckpt.name}: probability {p} against the engine's "
                  f"{float(probs[0, label[0]])}")
    phase(f"infer CLI ({MODEL.name} and its .ckpt): {PHOTO_CLASSES}, "
          f"probabilities within {INFER_PROB_ATOL} of InferenceEngine "
          f"{[round(r[2], 6) for r in rows]}; per image 1 normalize, 4 conv "
          f"(1 strip, 3 tiled), 1 pool; wall s .model "
          f"{infer_s['.model']:.3f}, .ckpt {infer_s['.ckpt']:.3f} ({smi})")

    text, counts, bench_s = counted_run(
        "infer --bench", infer_cli.main,
        ["--checkpoint", str(MODEL), "--batch-norm", "--bench", paths[0]],
        {k: 51 * v for k, v in per_image.items()})
    add_up(total, counts)
    lat = re.search(r"p50 latency: ([\d.]+) ms \(p90 ([\d.]+) ms\)", text)
    check(lat is not None, f"infer --bench printed {text!r}")
    phase(f"infer --bench, one image at batch 1, 50 forwards synchronised: "
          f"p50 {lat.group(1)} ms, p90 {lat.group(2)} ms ({smi})")

    # Grad-CAM: per image the captured forward, and in gradcam mode the
    # tail's replay (its conv and pool Functions) and their backward
    cams = []
    cases = {("conv_layer_3", "gradcam"): f32_want(0, 1, 4, 1),
             ("conv_layer_3", "reference"): f32_want(0, 1, 3, 1),
             ("relu_layer_1", "gradcam"): f32_want(0, 1, 6, 2, 1)}
    real_cam, real_render = gradcam_cli.compute_cam, gradcam_cli.render_heatmap
    for (layer, mode), want in cases.items():
        got, rendered = [], []

        def cam(*args, **kwargs):
            got.append(real_cam(*args, **kwargs))
            return got[-1]

        def render(*args):
            rendered.append(real_render(*args))
            return rendered[-1]
        out_dir = tmp / f"cam_{layer}_{mode}"
        with mock.patch.object(gradcam_cli, "compute_cam", cam), \
                mock.patch.object(gradcam_cli, "render_heatmap", render):
            text, counts, cam_s = counted_run(
                f"gradcam {layer} {mode}", gradcam_cli.main,
                ["--checkpoint", str(MODEL), "--batch-norm", "--layer",
                 layer, "--mode", mode, "--output-dir", str(out_dir),
                 *paths], {k: 6 * v for k, v in want.items()})
        add_up(total, counts)
        check([r[1] for r in predictions(text)] == PHOTO_CLASSES,
              f"gradcam {layer} {mode}: printed {predictions(text)}")
        worst = 0.0
        for i, img in enumerate(imgs):
            check(np.array_equal(imread(str(out_dir / f"{i}.png")),
                                 rendered[i]),
                  f"gradcam {layer} {mode}: {i}.png does not decode to the "
                  "heatmap")
            x = uint8_to_float(torch.from_numpy(img[None]).cuda())
            ref, probs = plain_cam(model, x, layer, mode)
            worst = max(worst, float(np.abs(got[i][0] - ref).max()))
            check(int(got[i][1].argmax()) == int(probs.argmax()) == i % 3,
                  f"gradcam {layer} {mode}: image {i}'s class")
        check(worst <= CAM_ATOL, f"gradcam {layer} {mode}: CAM against the "
              f"plain versions max|dev| {worst:.3g}")
        cams.append(f"{layer} {mode}: {got[0][0].shape}, max|dev| "
                    f"{worst:.3g}, {cam_s:.3f} s")
    phase("gradcam CLI, six photos each, CAMs against the plain versions "
          "on the card, PNGs read back equal, exact launches (the pool "
          "backward window kernel once an image at relu_layer_1): "
          + "; ".join(cams) + f" ({smi})")

    # a conv fused with its ReLU, captured: run relu=False, ReLU after
    net = get_model("alexnet", num_classes=3, batch_norm=False,
                    image_size=224, device="cuda",
                    generator=torch.Generator().manual_seed(15))
    x = uint8_to_float(torch.from_numpy(imgs[0][None]).cuda())
    torch.cuda.synchronize()
    reset_launches()
    got = gradcam_cli.compute_cam(net, x, "conv_layer_3", "gradcam")
    torch.cuda.synchronize()
    counts = {k: v for k, v in read_counters().items() if v}
    check(counts == f32_want(0, 1, 4, 1),
          f"fused-pair capture: launches {counts}")
    add_up(total, counts)
    with torch.no_grad():
        _, captured = net(x, capture=("conv_layer_3",))
    ref = plain_cam(net, x, "conv_layer_3", "gradcam")
    dev = float(np.abs(got[0] - ref[0]).max())
    check(bool((captured["conv_layer_3"] < 0).any()) and dev <= CAM_ATOL,
          f"fused-pair capture: CAM max|dev| {dev:.3g}")
    phase(f"Grad-CAM at a fused conv (no BN, seeded): conv_layer_3 captured "
          f"before its ReLU, CAM against the plain versions max|dev| "
          f"{dev:.3g}")
    return total


def dropout_hook(seen: dict):
    """A forward hook on the Dropout layer: in training exactly
    ``int(p*C)`` channels zeroed and the rest scaled by ``1/(1-p)`` in the
    activation's dtype; in eval the identity."""
    def hook(module, args, out):
        x = args[0]
        if not module.training:
            check(torch.equal(out, x), "eval-mode dropout is not the identity")
            seen["eval"] += 1
            return
        c = x.shape[-1]
        zero = (out == 0).flatten(0, 2).all(dim=0)
        n_drop = int(DROPOUT_P * c)
        scale = (torch.ones((), dtype=x.dtype, device=x.device)
                 / torch.tensor(1.0 - n_drop / c, dtype=x.dtype,
                                device=x.device))
        check(int(zero.sum()) == n_drop
              and torch.equal(out[..., ~zero], x[..., ~zero] * scale),
              f"training-mode dropout zeroed {int(zero.sum())} of {c} "
              f"channels, not {n_drop}, or scaled the rest by another "
              "factor")
        seen["train"] += 1
    return hook


def evaluation_phase(smi: str, tmp: Path, cli: dict) -> dict:
    """Phase 16: the evaluate CLI on phase 14's checkpoints and images, and
    a train CLI run with dropout; returns their launches, added up."""
    total = {}
    nv, nt = cli["valid_batches"], cli["test_batches"]
    base = ["--dataset-path", str(cli["data"]), *cli["sizes"]]
    runs = [
        ("--split both, bf16", ["--resume", cli["best"], "--split", "both",
                                "--compute-dtype", "bfloat16"],
         eval_want(nv + nt, nv + nt, bf16=True)),
        ("--split both", ["--resume", cli["best"], "--split", "both"],
         eval_want(nv + nt, nv + nt)),
        ("--tta flips", ["--resume", cli["best"], "--split", "test",
                         "--tta", "flips"], eval_want(nt, 4 * nt)),
        ("--ensemble", ["--ensemble", f"alexnet:{cli['best']},alexnet:"
                        f"{cli['first']}", "--split", "test"],
         eval_want(nt, 2 * nt)),
    ]
    lines = []
    for name, argv, want in runs:
        text, counts, secs = counted_run(f"evaluate {name}",
                                         evaluate_cli.main, base + argv, want)
        add_up(total, counts)
        tests = [l for l in text.splitlines() if l.startswith("Test===>")]
        check(len(tests) == 1, f"evaluate {name}: {text[-2000:]!r}")
        if name == "--split both, bf16":
            # the train CLI's own final test of this checkpoint, in bf16
            got = text[text.index("Test===>"):].splitlines()[:6]
            check(got == [cli["test"]] + cli["test_lines"],
                  f"evaluate {name}: {got}, the train CLI printed "
                  f"{[cli['test']] + cli['test_lines']}")
        lines.append(f"{name}: {tests[0]}, {secs:.3f} s")
    phase("evaluate CLI on the flagship run's best checkpoint ("
          f"{os.path.basename(cli['best'])}), exact launches; the bf16 "
          "test line and confusion matrix equal to the train CLI's: "
          + "; ".join(lines) + f" ({smi})")

    seen = {"train": 0, "eval": 0}
    real_get_model = train_cli.get_model

    def get_model_hooked(*args, **kwargs):
        model = real_get_model(*args, **kwargs)
        model.net["dropout_layer_1"].register_forward_hook(dropout_hook(seen))
        return model
    drop_ck = tmp / "dropout"
    times = CliTimes()
    t = time.perf_counter()
    # the hook checks each training forward on the host, which a captured
    # call does not run: this run keeps the eager loop (phase 22 holds a
    # captured dropout step to it)
    eager_steps = functools.partial(train_cli.make_device_train_step,
                                    eager=True)
    with mock.patch.object(train_cli, "get_model", get_model_hooked), \
            mock.patch.object(train_cli, "make_device_train_step",
                              eager_steps):
        _, counts = run_cli(CLI_FLAGSHIP + base + [
            "--checkpoint-dir", str(drop_ck), "--dropout", str(DROPOUT_P),
            "--total-iters", "20", "--valid-iters", "20",
            "--save-iters", "20"], f"train CLI --dropout {DROPOUT_P}",
            cli_want(20, nv + nt, True, True), times)
    secs = time.perf_counter() - t
    add_up(total, counts)
    hist = read_history(str(drop_ck / "history.jsonl"))
    check(seen["train"] == 20 and seen["eval"] == nv + nt
          and all(np.isfinite(h["loss"]) for h in hist),
          f"dropout run: hooks {seen}, history {hist}")
    phase(f"train CLI --dropout {DROPOUT_P}, flagship flags, 20 iterations: "
          f"loss {hist[-1]['loss']:.6f}, each step {int(DROPOUT_P * 128)} of "
          f"conv4's 128 channels zeroed and the rest scaled by 1/"
          f"{1 - DROPOUT_P}, eval the identity; {secs:.3f} s ({smi})")
    return total


# ---------------------------------------------------------------------------
# the ResNet, VGG, MobileNet and PipeCNN families: served (phase 17) and
# trained through the train CLI (phase 18)
# ---------------------------------------------------------------------------

FAMILY_FIXTURE = ROOT / "tests" / "fixtures" / "family_logits.npz"
# family -> whether it loads its committed checkpoint (resnet18's 65 MB one
# stays off the copy sent to the card: it is seeded here, as the VGGs are)
FAMILIES = {"resnet10": True, "resnet18": False, "mobilenet": True,
            "pipecnn": True, "vgg8": False, "vgg11": False}
FAMILY_SEED = 3
# the families' float32 conv shapes against the plain conv: atol 1e-5 plus
# 1e-5 x S (S the same conv of |x| and |w|, plus |b|), the float32
# reassociation bound that grows with K (4,608 products in VGG11's
# 512-channel layers, where two float32 orders of unit-scale values differ
# by up to 5e-5); every float32 kernel is also held bit for bit to the
# direct kernel, which sums in the same order
FAMILY_CONV_SREL = 1e-5
# the six families' padded Cin-3 stems: row key -> (H, Cin, Cout, k,
# stride, padding) and the families whose first conv it is
STEMS = {"stem": ((224, 3, 16, 3, 2, 1), ("resnet10",)),
         "stem_32": ((224, 3, 32, 3, 2, 1), ("resnet18", "mobilenet")),
         "stem_64": ((224, 3, 64, 3, 2, 1), ("pipecnn", "moecnn")),
         "stem_s1_32": ((224, 3, 32, 3, 1, 1), ("vgg8",)),
         "stem_s1_64": ((224, 3, 64, 3, 1, 1), ("vgg11",))}
# (B, H, Cin, Cout, k, stride, padding) of each family kernel row, at the
# serving batch: the stems, PipeCNN's trunk conv (a padded stride-1 3x3),
# MobileNet's pw_2 (a 1x1)
FAMILY_ROWS = {**{key: (B, *shape) for key, (shape, _) in STEMS.items()},
               "padded_3x3": (B, 56, 64, 64, 3, 1, 1),
               "1x1": (B, 56, 64, 128, 1, 1, 0)}
# the padded strips' counters, kept per family in the phases' totals
STRIP_PADDED = ("launches_strip_padded", "launches_bf16_strip_padded")
FAMILY_TRAIN_STEPS = 40     # the fresh resnet10 runs; the others take 20
FAMILY_GRAD_TOL = 1e-4      # the families' conv Function, the model's bar


def family_model(name: str, fixture) -> torch.nn.Module:
    """``name`` at 224 px on the card in eval mode: its committed checkpoint
    where ``FAMILIES`` says so, else seeded."""
    model = get_model(name, num_classes=3, image_size=224, batch_norm=True,
                      device="cuda",
                      generator=torch.Generator().manual_seed(FAMILY_SEED))
    if FAMILIES[name]:
        payload = read_checkpoint(str(ROOT / str(
            fixture[f"{name}_checkpoint"])))
        load_jax_params(model, payload["params"], payload["state"])
    else:
        # BN's moving statistics from 20 training-mode forwards on
        # synthetic images (88% of the way from their init), so that the
        # seeded net's eval sees normalised activations and O(1) logits
        rng = np.random.default_rng(FAMILY_SEED)
        model.train()
        with torch.no_grad():
            for _ in range(20):
                model(uint8_normalize(torch.from_numpy(
                    synthetic_images(rng, 8)).cuda()))
    return model.eval()


def n_convs(model) -> int:
    """The model's Conv2D layers, a StackedBlocks' n_blocks times over."""
    n = 0
    for layer in model.modules():
        if isinstance(layer, StackedBlocks):
            n += layer.n_blocks * sum(isinstance(m, Conv2D)
                                      for m in layer.block.modules())
        elif isinstance(layer, Conv2D):
            n += 1
    return n


def pointwise_convs(model, dtype=None) -> tuple[int, int]:
    """Of one forward of ``model`` in ``dtype``: the float32 1x1 conv
    launches that the plan sends to the pointwise kernel (Cout >= 64), and
    all its float32 1x1 launches (StackedBlocks' layers n_blocks times)."""
    if dtype is not None:
        return 0, 0
    pw = f32 = 0
    for layer in model.modules():
        n = layer.n_blocks if isinstance(layer, StackedBlocks) else 1
        convs = (layer.block.modules() if isinstance(layer, StackedBlocks)
                 else [layer] if isinstance(layer, Conv2D) else [])
        for conv in convs:
            if isinstance(conv, Conv2D) and conv.kernel_size == 1:
                f32 += n
                pw += n * (conv.out_channels >= 64)
    return pw, f32


def forward_counts(model, dtype=None) -> dict:
    """The non-zero counters of one eager eval forward (no normalize), and
    under ``"F.conv2d"`` its calls of ATen's convolution."""
    x = torch.zeros((2, 224, 224, 3), device="cuda")
    aten = []
    real = F.conv2d

    def counting(*args, **kwargs):
        aten.append(1)
        return real(*args, **kwargs)
    torch.cuda.synchronize()
    reset_launches()
    with mock.patch.object(F, "conv2d", counting), torch.no_grad():
        model(x, compute_dtype=dtype)
    torch.cuda.synchronize()
    counts = {k: v for k, v in read_counters().items() if v}
    return counts, len(aten)


def conv_bar_f32(x, w, b, stride, padding, y, ref, what) -> float:
    """A float32 family conv against its plain version: within atol 1e-5 +
    FAMILY_CONV_SREL x S; returns max |dev| / bar."""
    s_abs = conv2d(x.abs(), w.abs(), b.abs(), stride, False, padding)
    dev_ = (y - ref).abs()
    bar = CONV_ATOL + FAMILY_CONV_SREL * s_abs
    check(bool((dev_ <= bar).all()), f"{what}: max deviation "
          f"{dev_.max().item():.3g}, {(dev_ / bar).max().item():.3g} x the "
          "bar (1e-5 + 1e-5 S)")
    return (dev_ / bar).max().item()


def check_family_convs(model, dtype, x) -> tuple[int, float]:
    """Every conv launch of one eval forward on ``x``, on the activations
    the forward gives it, against the plain conv on the card: float32
    within 1e-5 + 1e-5 x S and bit-equal to the direct kernel; bf16
    within 1 bf16 ulp + 1e-5 x S; each bit-identical from launch to
    launch. Returns the distinct shapes checked and the worst dev / bar."""
    seen, worst = {}, 0.0
    real = nn_module.conv2d_bias_relu

    def rec(x, w, b, stride, relu, padding=0):
        y = real(x, w, b, stride, relu, padding)
        key = (tuple(x.shape), tuple(w.shape), stride, padding, relu)
        if key not in seen:
            seen[key] = (x, w, b, y)
        return y

    with mock.patch.object(nn_module, "conv2d_bias_relu", rec), \
            torch.no_grad():
        model(x, compute_dtype=dtype)
    with torch.no_grad():    # the weights need no gradient here
        for (xs, ws, stride, padding, relu), (xx, w, b, y) in seen.items():
            what = (f"{type(model).__name__} conv {xs}x{ws} s{stride} "
                    f"p{padding} relu={relu} {y.dtype}")
            ref = conv2d(xx, w, b, stride, relu, padding)
            again = conv2d_bias_relu(xx, w, b, stride, relu, padding)
            check(torch.equal(y, again), f"{what}: two launches differ")
            if y.dtype == BF16:
                s_abs = conv2d(xx.float().abs(), w.float().abs(),
                               b.float().abs(), stride, False, padding)
                dev_ = (y.float() - ref.float()).abs()
                bar = bf16_ulp(ref) + BF16_CONV_SREL * s_abs
                check(bool((dev_ <= bar).all()), f"{what}: max deviation "
                      f"{dev_.max().item():.3g}, "
                      f"{(dev_ / bar).max().item():.3g} x the bar "
                      "(1 bf16 ulp + 1e-5 S)")
                worst = max(worst, (dev_ / bar).max().item())
            else:
                worst = max(worst, conv_bar_f32(xx, w, b, stride, padding,
                                                y, ref, what))
                check(bits_equal(y, conv_entry(xx, w, b, stride, relu,
                                               padding=padding)),
                      f"{what}: differs from the direct kernel")
    return len(seen), worst


def family_photos() -> np.ndarray:
    fx = np.load(ROOT / "tests" / "fixtures" / "reference_parity.npz")
    return np.stack([fx[f"image_u8_{i}"] for i in range(6)])


def serve_family(name: str, model, dtype, rng, photos: np.ndarray,
                 imgs64: np.ndarray, ref, stems: int = 1) -> tuple:
    """``model`` (family ``name``, with one padded Cin-3 stem) behind
    ``InferenceEngine`` (buckets 1, 8, 64, one CUDA graph each) in
    ``dtype``: one forward's launches (one conv per Conv2D layer, ``stems``
    of them on a padded strip (the stem; AlexNet has none), none on the
    direct kernel or the gather, one pool
    per MaxPool2D, on the window kernel, ATen's conv only for a depthwise
    conv), every conv
    launch against the plain conv (``check_family_convs``), each bucket's
    replay bit-equal to its eager forward (``rng``'s images), a counted
    predict of the six ``photos`` and of ``imgs64``, the photos' eager
    logits (one batch of 6)
    against ``ref`` = (float32 reference logits, what they are, bar x
    max(1, max|ref|)). Returns the counts of the predicts, the logits, the
    engine and a line for the log."""
    tag = f"{name} {'bf16' if dtype else 'float32'}"
    x6 = torch.from_numpy(photos).cuda()
    x8 = uint8_normalize(torch.cat([x6, torch.flip(x6[:2], dims=(2,))]))
    per_fwd, aten = forward_counts(model, dtype)
    convs = n_convs(model)
    pools = sum(isinstance(m, nn_module.MaxPool2D) for m in model.modules())
    check(per_fwd.get("conv2d_bias_relu.launches") == convs
          and per_fwd.get("max_pool2d_fwd.launches", 0) == pools
          and per_fwd.get("max_pool2d_fwd.launches_"
                          + ("bf16_window" if dtype else "window"), 0)
          == pools
          and sum(per_fwd.get(f"conv2d_bias_relu.{c}", 0)
                  for c in STRIP_PADDED) == stems
          and per_fwd.get("conv2d_bias_relu.launches_direct", 0)
          + per_fwd.get("conv2d_bias_relu.launches_bf16_gather", 0)
          == 0, f"{tag}: one forward launched {per_fwd}; it has "
          f"{convs} convs ({stems} a padded Cin-3 stem, on a strip) and "
          f"{pools} pools")
    depthwise = sum(type(m).__name__ == "DepthwiseConv2D"
                    for m in model.modules())
    check(aten == depthwise, f"{tag}: one forward called ATen's "
          f"conv {aten} times; only its {depthwise} depthwise convs may")
    pw, f32_1x1 = pointwise_convs(model, dtype)
    check(per_fwd.get("conv2d_bias_relu.launches_pw", 0) == pw
          and per_fwd.get("conv2d_bias_relu.launches_1x1", 0)
          - per_fwd.get("conv2d_bias_relu.launches_bf16_1x1", 0) == f32_1x1,
          f"{tag}: one forward launched {per_fwd}; its float32 1x1s are "
          f"{f32_1x1}, {pw} of them (Cout >= 64) for the pointwise kernel")
    shapes, worst = check_family_convs(model, dtype, x8)
    want1 = dict(per_fwd, **{"uint8_normalize.launches": 1,
                             "uint8_normalize.launches_wide": 1})
    engine = serving.InferenceEngine(model, buckets=BUCKETS, device="cuda",
                                     compute_dtype=dtype)
    t = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    for b in BUCKETS:
        check(engine._ready[b].launches == want1, f"{tag} bucket "
              f"{b}'s capture recorded {engine._ready[b].launches}, "
              f"expected {want1}")
        chunk = synthetic_images(rng, b)
        labels, probs = engine.predict(chunk)
        with torch.no_grad():
            ep, el = engine._forward(torch.from_numpy(chunk).cuda())
        check(same_arrays(labels, el.int().cpu().numpy())
              and same_arrays(probs, ep.cpu().numpy()),
              f"{tag} bucket {b}: the replay differs from the eager "
              "forward")
    torch.cuda.synchronize()
    reset_launches()
    labels, probs = engine.predict(photos)
    engine.predict(imgs64)
    torch.cuda.synchronize()
    counts = {k: v for k, v in read_counters().items() if v}
    want = {k: 2 * v for k, v in want1.items()}
    check(counts == want, f"{tag}: predict launches {counts}, "
          f"expected {want}")
    # the photos padded with zero images to the bucket, as the engine runs
    # them (MoECNN's expert capacity is the bucket's), and as one batch
    bucket = torch.zeros((BUCKETS[1], *x6.shape[1:]), dtype=torch.uint8,
                         device="cuda")
    bucket[:len(x6)] = x6
    with torch.no_grad():
        padded = engine.model(uint8_normalize(bucket),
                              compute_dtype=dtype)[:len(x6)].float()
        logits = engine.model(uint8_normalize(x6),
                              compute_dtype=dtype).float()
    check(np.array_equal(labels, padded.argmax(-1).cpu().numpy()),
          f"{tag}: the engine's labels are not its logits' argmax")
    ref_logits, what, tol = ref
    dev_, scale = scaled_dev(logits, ref_logits)
    check(dev_ <= tol * scale, f"{tag}: logits {dev_:.3g} from {what} (bar "
          f"{tol * scale:.3g})")
    if dtype is None:
        check(np.array_equal(logits.argmax(-1).cpu().numpy(),
                             ref_logits.argmax(-1).cpu().numpy()),
              f"{tag}: labels {logits.argmax(-1).cpu().numpy()}, {what}'s "
              f"{ref_logits.argmax(-1).cpu().numpy()}")
    engine.predict(imgs64)
    torch.cuda.synchronize()
    t = time.perf_counter()
    reps = 10
    for _ in range(reps):
        engine.predict(imgs64)
    e2e = reps * 64 / (time.perf_counter() - t)
    xb = torch.from_numpy(imgs64).cuda()
    with torch.no_grad():
        graphed, eager = in_turns(engine._ready[64].graph.replay,
                                  lambda: engine._forward(xb), 10)
    line = (f"{tag}: {e2e:.1f} img/s at bucket 64, graph {graphed:.4f} ms, "
            f"eager {eager:.4f} ms; warmup {warm_s:.2f} s; logits max|dev| "
            f"{dev_:.3g} from {what}; labels {labels.tolist()}; {shapes} "
            f"conv shapes at {worst:.3f} of their bar")
    return counts, logits, engine, line


def families_serving_phase(smi: str) -> dict:
    """Phase 17: each family behind ``InferenceEngine`` (buckets 1, 8, 64,
    one CUDA graph each), float32 and bf16 (``serve_family``); returns the
    launches of its counted runs, added up."""
    fixture = np.load(FAMILY_FIXTURE)
    rng = np.random.default_rng(17)
    photos = family_photos()
    x6 = torch.from_numpy(photos).cuda()
    imgs64 = synthetic_images(rng, 64)
    total, lines = {}, []
    for name in FAMILIES:
        model = family_model(name, fixture)
        f32_logits = None
        for dtype in (None, BF16):
            if dtype is not None:
                ref = (f32_logits, "float32", BF16_MODEL_TOL)
            elif FAMILIES[name]:
                ref = (torch.from_numpy(fixture[f"{name}_logits"]).cuda(),
                       "the fixture", LOGIT_ATOL)
            else:
                with plain_versions(), torch.no_grad():
                    ref = (model(uint8_to_float(x6)),
                           "the plain versions on the card", LOGIT_ATOL)
            counts, logits, engine, line = serve_family(
                name, model, dtype, rng, photos, imgs64, ref)
            if dtype is None:
                f32_logits = logits
            add_up(total, counts)
            add_up(total, stem_counts(name, counts))
            lines.append(line)
            del engine
            torch.cuda.empty_cache()
    for line in lines:
        phase(f"family serving, {line}")
    phase(f"family serving ({smi}): six families, float32 and bf16, "
          "replays bit-equal to the eager forward, launches exact, the "
          "checkpointed logits within 1e-4 x max(1, max|ref|) of "
          "family_logits.npz")
    return total


def stem_counts(name: str, counts: dict) -> dict:
    """The padded strips' launches of a counted run of family ``name``,
    keyed ``"<name>.<counter>"`` (the stem rows' launches)."""
    return {f"{name}.{c}": counts.get(f"conv2d_bias_relu.{c}", 0)
            for c in STRIP_PADDED}


def strip_tiles(bsz, h, wid, cin, cout, k, stride, padding, dtype):
    """The strip ids whose kernel takes the shape: float32, the R of
    ``STRIP_ROWS`` that fit 96 KB; bf16, the (R, layout) of
    ``BF16_STRIP_TILES`` whose layout takes it and that fit 96 KB."""
    ho = conv_out_size(h, k, stride, padding)
    if dtype is None:
        return [i for i, r in enumerate(STRIP_ROWS) if strip_smem_bytes(
            min(r, ho), wid, cin, cout, k, stride, padding)
            <= STRIP_SMEM_MAX]
    return [j for j, (r, wide) in enumerate(BF16_STRIP_TILES)
            if strip_bf16_takes(wid, cin, cout, k, stride, padding, wide)
            and strip_bf16_smem_bytes(min(r, ho), wid, cin, cout, k, stride,
                                      padding, wide) <= BF16_STRIP_SMEM_MAX]


def strip_tile_name(j: int, dtype) -> str:
    if dtype is None:
        return f"R {STRIP_ROWS[j]}"
    r, wide = BF16_STRIP_TILES[j]
    return f"R {r} {'widened' if wide else 'natural'}"


def stem_inputs(gen, bsz, h, wid, cin, cout, k, dtype=None):
    dev = torch.device("cuda")
    x = torch.rand((bsz, h, wid, cin), generator=gen, device=dev)
    w = torch.randn((k, k, cin, cout), generator=gen, device=dev) * 0.1
    b = torch.randn((cout,), generator=gen, device=dev) * 0.1
    if dtype is not None:
        x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
    return x, w, b


def check_strip(x, w, b, stride, padding, what, tiles=None) -> float:
    """A padded strip conv, float32 or bf16, ReLU off and on, through the
    wrapper and every strip id in ``tiles``: against the plain conv
    (float32 within 1e-5 + 1e-5 x S and bit-equal to the direct kernel;
    bf16 within 1 bf16 ulp + 1e-5 x S), two launches bit-identical.
    Returns the worst max |dev| / bar."""
    worst = 0.0
    if x.dtype == BF16:
        worst = check_conv_bf16(x, w, b, stride, what, padding=padding)[1]
        for j in tiles or ():
            worst = max(worst, check_conv_bf16(
                x, w, b, stride, f"{what} {strip_tile_name(j, BF16)}",
                lambda *a, j=j, **kw: launch_conv_bf16(
                    *a, tile=j, variant="strip", **kw)[0],
                padding=padding)[1])
        return worst
    convs = [(what, lambda relu: conv2d_bias_relu(x, w, b, stride, relu,
                                                  padding))]
    convs += [(f"{what} {strip_tile_name(i, None)}",
               lambda relu, i=i: conv_entry(x, w, b, stride, relu, strip=i,
                                            padding=padding))
              for i in tiles or ()]
    for relu in (False, True):
        ref = conv2d(x, w, b, stride, relu, padding)
        direct = conv_entry(x, w, b, stride, relu, padding=padding)
        for name, conv in convs:
            y = conv(relu)
            worst = max(worst, conv_bar_f32(x, w, b, stride, padding, y, ref,
                                            f"{name} relu={relu}"))
            check(bits_equal(y, direct), f"{name} relu={relu}: differs from "
                  "the direct kernel")
            check(bits_equal(y, conv(relu)), f"{name} relu={relu}: two "
                  "launches differ")
    return worst


# off the stems' shapes: (what, B, H, W, Cin, Cout, k, stride, padding) for
# the float32 padded strip and the bf16 widened one
STRIP_OFF_F32 = [("ragged: 25 x 28, Ho 13", 2, 25, 28, 3, 16, 3, 2, 1),
                 ("Cin 1, k 5, pad 2", 2, 30, 32, 1, 8, 5, 1, 2),
                 ("Cin 2, Cout 24", 1, 17, 18, 2, 24, 3, 1, 1),
                 ("Cin 4, pad 2, Cout 12", 2, 21, 22, 4, 12, 3, 2, 2),
                 ("a row past 128 pixels", 1, 9, 300, 3, 64, 3, 1, 1)]
STRIP_OFF_BF16 = [("ragged: 27 x 24, Ho 14", 2, 27, 24, 3, 16, 3, 2, 1),
                  ("pad 2, stride 1, Cout 8", 2, 19, 16, 3, 8, 3, 1, 2),
                  ("pad 3, stride 3, Cout 24", 1, 28, 32, 3, 24, 3, 3, 3),
                  ("k 2, Cout 56", 2, 17, 24, 3, 56, 2, 1, 1),
                  ("k 4, Cout 40", 1, 20, 48, 3, 40, 4, 2, 1),
                  ("a row past 16 chunks", 1, 9, 296, 3, 64, 3, 1, 1)]


def stem_phase(gen) -> None:
    """The padded strips at the six families' Cin-3 stems (k3 p1 at 224 px;
    3 -> 16, 32, 64 at stride 2, 3 -> 32, 64 at stride 1), float32 and
    bf16: planned onto the strip (bf16: the widened layout) at B = 1, 8,
    64 and 256; held against the plain conv (float32 bit-equal to the
    direct kernel) through the wrapper at B = 1, 8 and 64, and through
    every strip id that takes the shape at B = 64; at B = 64 each graph-timed
    in turns with the kernel it replaces (the direct kernel; the gather),
    every R swept, cuDNN + ReLU alone and the bound; then off those shapes
    (ragged strips, Cin 1, 2, 4, padding 2 and 3, k 2, 4 and 5, rows past a
    chunk); then AlexNet's conv1 (bf16, B = 64 and 256) on its natural
    layout in turns with the widened one."""
    lines = []
    for key, ((h, cin, cout, k, s, p), fams) in STEMS.items():
        for dtype in (None, BF16):
            tag = f"{key}{'_bf16' if dtype else ''} {fams}"
            for bsz in (1, 8, B, TRAIN_B):
                f32 = conv_tile_plan(bsz, h, h, cin, cout, k, s, True, p)
                bf = conv_bf16_plan(bsz, h, h, cin, cout, k, s, True, None, p)
                check(f32.variant == "strip" and bf.variant == "strip"
                      and BF16_STRIP_TILES[bf.tile][1],
                      f"{tag} B={bsz}: planned {f32} / {bf}")
            worst = 0.0
            for bsz in (1, 8, B):
                x, w, b = stem_inputs(gen, bsz, h, h, cin, cout, k, dtype)
                tiles = (strip_tiles(bsz, h, h, cin, cout, k, s, p, dtype)
                         if bsz == B else None)
                worst = max(worst, check_strip(x, w, b, s, p,
                                               f"{tag} B={bsz}", tiles))
            if dtype is None:
                sweep = strip_sweep(x, w, b, s, p, True, tiles, graph_ms)
            else:
                sweep = ", ".join(f"{strip_tile_name(j, dtype)} {t:.4f}"
                                  for j, t in ((j, graph_ms(
                                      lambda j=j: launch_conv_bf16(
                                          x, w, b, s, True, tile=j,
                                          variant="strip", padding=p)))
                                      for j in tiles))
            old = ((lambda: conv_entry(x, w, b, s, True, padding=p))
                   if dtype is None else
                   (lambda: launch_conv_bf16(x, w, b, s, True,
                                             variant="gather", padding=p)))
            new_ms, old_ms = graph_turns(
                lambda: conv2d_bias_relu(x, w, b, s, True, p), old)
            xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
            lib = graph_ms(lambda: torch.relu(F.conv2d(xn, wn, b, s, p)))
            ho = conv_out_size(h, k, s, p)
            y = conv2d_bias_relu(x, w, b, s, True, p)
            bound = bound_ms(nbytes(x, w, b, y),
                             2.0 * B * ho * ho * cout * k * k * cin,
                             FP32_FLOP_PER_S if dtype is None
                             else BF16_FLOP_PER_S)
            lines.append(
                f"{tag} [{B},{h},{h},{cin}]->{cout} s{s} p{p}: alone "
                f"{new_ms:.4f} ms in turns with the "
                f"{'direct kernel' if dtype is None else 'gather'} "
                f"{old_ms:.4f} ({old_ms / new_ms:.2f}x), cuDNN + ReLU "
                f"{lib:.4f}, bound {bound[0]:.4f} ({bound[1]}, "
                f"{bound[0] / new_ms:.2f} of it); sweep: {sweep}; worst "
                f"{worst:.3f} of the bar")
    off = 0.0
    for what, bsz, h, wid, cin, cout, k, s, p in STRIP_OFF_F32:
        x, w, b = stem_inputs(gen, bsz, h, wid, cin, cout, k)
        check(conv_tile_plan(bsz, h, wid, cin, cout, k, s, True,
                             p).variant == "strip", f"{what}: not a strip")
        off = max(off, check_strip(x, w, b, s, p, f"float32 strip ({what})",
                                   strip_tiles(bsz, h, wid, cin, cout, k, s,
                                               p, None)))
    for what, bsz, h, wid, cin, cout, k, s, p in STRIP_OFF_BF16:
        x, w, b = stem_inputs(gen, bsz, h, wid, cin, cout, k, BF16)
        plan = conv_bf16_plan(bsz, h, wid, cin, cout, k, s, True, None, p)
        check(plan.variant == "strip" and BF16_STRIP_TILES[plan.tile][1],
              f"{what}: planned {plan}")
        off = max(off, check_strip(x, w, b, s, p, f"bf16 strip ({what})",
                                   strip_tiles(bsz, h, wid, cin, cout, k, s,
                                               p, BF16)))
    conv1 = []
    for bsz in (B, TRAIN_B):
        x, w, b = stem_inputs(gen, bsz, 224, 224, 3, 16, 3, BF16)
        plan = conv_bf16_plan(bsz, 224, 224, 3, 16, 3, 2, True)
        check(plan.variant == "strip" and not BF16_STRIP_TILES[plan.tile][1],
              f"bf16 conv1 B={bsz}: planned {plan}")
        wide = BF16_STRIP_TILES.index((BF16_STRIP_TILES[plan.tile][0], True))
        off = max(off, check_strip(x, w, b, 2, 0, f"bf16 conv1 B={bsz}",
                                   [wide]))
        nat, wid_ms = graph_turns(
            lambda: conv2d_bias_relu(x, w, b, 2, False),
            lambda: launch_conv_bf16(x, w, b, 2, False, tile=wide,
                                     variant="strip"))
        conv1.append(f"B={bsz} natural {nat:.4f}, widened {wid_ms:.4f} ms")
    for line in lines:
        phase(f"padded strip, {line}")
    phase("padded strips off the stems' shapes (float32: "
          + "; ".join(c[0] for c in STRIP_OFF_F32) + "; bf16: "
          + "; ".join(c[0] for c in STRIP_OFF_BF16) + f") through every "
          f"strip id that takes each: worst {off:.3f} of the bar, float32 "
          f"bit-equal to the direct kernel; bf16 conv1 in turns, alone: "
          + "; ".join(conv1))


# the families' float32 1x1s, the pointwise kernel's shapes: name -> (H,
# Cin, Cout, stride) at 224 px (MobileNet's pw_1-pw_6, the projections of
# resnet10's and resnet18's stride-2 blocks)
PW_SHAPES = {"pw_1": (112, 32, 64, 1), "pw_2": (56, 64, 128, 1),
             "pw_3": (56, 128, 128, 1), "pw_4": (28, 128, 256, 1),
             "pw_5": (28, 256, 256, 1), "pw_6": (14, 256, 512, 1),
             "r10_proj_2": (112, 16, 32, 2), "r10_proj_3": (56, 32, 64, 2),
             "r10_proj_4": (28, 64, 128, 2), "r18_proj_2": (112, 32, 64, 2),
             "r18_proj_3": (56, 64, 128, 2),
             "r18_proj_4": (28, 128, 256, 2)}


def pw_phase(gen) -> None:
    """The float32 1x1s of the families (``PW_SHAPES``) at B = 1, 8 and
    64: planned onto "pw" where ``pw_tile_for`` finds a tile (Cout >= 64),
    else onto the tiled kernel; through the wrapper bit-equal to the
    direct kernel (ReLU off and on), within atol 1e-5 + 1e-5 x S of the
    plain conv, two launches bit-identical; through every tile of
    ``PW_TILES`` that fits, bit-equal to the direct kernel too. Each timed
    alone: the plan's kernel through the wrapper (L2-warm, and L2-cold
    over copies of x), the tiled kernel at the tile its plan gives the
    shape and the pointwise kernel at every tile (through their entry
    points, for the record), cuDNN + ReLU, and the bound (x's bytes: the
    pixels a stride-s 1x1 reads)."""
    dev = torch.device("cuda")
    lines = []
    for name, (h, cin, cout, s) in PW_SHAPES.items():
        for bsz in (1, 8, B):
            x = torch.relu(torch.randn((bsz, h, h, cin), generator=gen,
                                       device=dev))
            w = torch.randn((1, 1, cin, cout), generator=gen,
                            device=dev) * 0.1
            b = torch.randn((cout,), generator=gen, device=dev) * 0.1
            what = f"{name} [{bsz},{h},{h},{cin}]->{cout} s{s}"
            ho = conv_out_size(h, 1, s)
            m = bsz * ho * ho
            plan = plan_of(x, w, s)
            check(pw_kernel_takes(cin, cout, 1, s, 0, True)
                  and plan.variant == ("tiled" if pw_tile_for(
                      m, cin, cout) is None else "pw"),
                  f"{what}: planned {plan}")
            check_same_as_direct(x, w, b, s, what)
            for relu in (False, True):
                y = conv2d_bias_relu(x, w, b, s, relu)
                conv_bar_f32(x, w, b, s, 0, y, conv2d(x, w, b, s, relu),
                             f"{what} relu={relu}")
                check(bits_equal(y, conv2d_bias_relu(x, w, b, s, relu)),
                      f"{what} relu={relu}: two launches differ")
            tiles = [t for t in range(len(PW_TILES))
                     if pw_smem_bytes(t, cin) <= PW_SMEM_MAX]
            for t in tiles:
                blocks = pw_grid(m, cout, t)[0]
                for relu in (False, True):
                    check(bits_equal(
                        conv_entry(x, w, b, s, relu, pw=(t, blocks)),
                        conv_entry(x, w, b, s, relu)),
                        f"{what} pw tile {PW_TILES[t]} relu={relu}: "
                        "differs from the direct kernel")
            tiled = tiled_plan(m, cout).tile
            xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
            row = {
                "ms": graph_ms(lambda: conv2d_bias_relu(x, w, b, s, True)),
                "cold": cold_ms(lambda xi: conv2d_bias_relu(
                    xi, w, b, s, True), x, nbytes(x, y)),
                "tiled": graph_ms(lambda: conv_entry(x, w, b, s, True,
                                                     tile=tiled)),
                "pw": {t: graph_ms(lambda t=t: conv_entry(
                    x, w, b, s, True, pw=(t, pw_grid(m, cout, t)[0])))
                    for t in tiles},
                "lib": graph_ms(lambda: torch.relu(F.conv2d(xn, wn, b, s))),
                "bound": bound_ms(4 * m * cin + nbytes(w, b, y),
                                  2.0 * m * cout * cin)}
            tile = (f"tile {'x'.join(map(str, PW_TILES[plan.tile]))}, grid "
                    f"{plan.grid}" if plan.variant == "pw" else
                    plan_name(plan))
            lines.append(
                f"{what}: {row['ms']:.4f} ms alone (L2-cold "
                f"{row['cold']:.4f}; {tile}); tiled {row['tiled']:.4f}, "
                f"pw " + ", ".join(f"{'x'.join(map(str, PW_TILES[t]))} "
                                  f"{v:.4f}" for t, v in row["pw"].items())
                + f"; cuDNN + ReLU {row['lib']:.4f}; bound "
                f"{row['bound'][0]:.4f} ({row['bound'][1]}, "
                f"{row['bound'][0] / row['ms']:.2f} of it)")
    for line in lines:
        phase(f"pointwise, {line}")


PW_STEP_REPS = 5           # timed float32 MobileNet steps at TRAIN_B


def pw_models_phase(smi: str) -> dict:
    """The models whose 1x1s the pointwise kernel runs, float32:
    MobileNet and resnet18 behind single-bucket engines (64), unfolded
    and BN-folded, their captures' pointwise launches exact and the two
    graphs timed in turns; then an eager float32 MobileNet train step at
    batch ``TRAIN_B`` on synthetic images, one step counted (one launch
    per conv, its six 1x1s on the pointwise kernel) and ``PW_STEP_REPS``
    timed with CUDA events. Returns the counted runs' launches."""
    fixture = np.load(FAMILY_FIXTURE)
    total, lines = {}, []
    for name in ("mobilenet", "resnet18"):
        model = family_model(name, fixture)
        pw = pointwise_convs(model)[0]
        graphs = {}
        for tag, net in (("unfolded", model), ("folded",
                                                fold_batchnorm(model))):
            engine = serving.InferenceEngine(net, buckets=(B,),
                                             device="cuda")
            engine.warmup()
            got = engine._ready[B].launches
            check(got.get("conv2d_bias_relu.launches_pw", 0) == pw
                  and got.get("conv2d_bias_relu.launches_direct", 0) == 0,
                  f"{name} {tag}: the bucket-{B} capture launches {got}; "
                  f"{pw} of its 1x1s take the pointwise kernel")
            graphs[tag] = engine
        with torch.no_grad():
            g_fold, g_unf = in_turns(graphs["folded"]._ready[B].graph.replay,
                                     graphs["unfolded"]._ready[B].graph
                                     .replay, 10)
        lines.append(f"{name} float32 bucket {B}: graph {g_unf:.4f} ms "
                     f"unfolded / {g_fold:.4f} folded (in turns), {pw} "
                     "pointwise launches a forward")
        del graphs, model
        torch.cuda.empty_cache()
    rng = np.random.default_rng(26)
    x = torch.from_numpy(synthetic_images(rng, TRAIN_B)).cuda()
    y = torch.from_numpy(rng.integers(0, 3, TRAIN_B)).cuda()
    model = get_model("mobilenet", num_classes=3, image_size=224,
                      batch_norm=True, device="cuda",
                      generator=torch.Generator().manual_seed(FAMILY_SEED))
    opt = make_optimizer("momentum", 1.5e-2, schedule="cosine",
                         total_steps=64)
    ts = create_train_state(model, opt, seed=7)
    step = make_train_step(model, opt)
    for _ in range(2):
        ts, m = step(ts, x, y)
    (ts, m), counts = counted(lambda: step(ts, x, y))
    pw, convs = pointwise_convs(model)[0], n_convs(model)
    check(counts.get("conv2d_bias_relu.launches") == convs
          and counts.get("conv2d_bias_relu.launches_pw") == pw == 6
          and counts.get("conv2d_bias_relu.launches_tiled", 0) == 0
          and counts.get("conv2d_bias_relu.launches_direct", 0) == 0
          and bool(torch.isfinite(m["loss"])),
          f"mobilenet float32 train step: launches {counts}, loss "
          f"{m['loss']}; {convs} convs, {pw} of them 1x1s")
    add_up(total, counts)
    a = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(PW_STEP_REPS):
        ts, m = step(ts, x, y)
    e.record()
    e.synchronize()
    lines.append(f"mobilenet float32 train step at batch {TRAIN_B} (eager): "
                 f"{a.elapsed_time(e) / PW_STEP_REPS:.3f} ms device (CUDA "
                 f"events, mean of {PW_STEP_REPS}), one step {counts}")
    del ts, step, model
    torch.cuda.empty_cache()
    for line in lines:
        phase(f"pointwise models ({smi}), {line}")
    return total


def family_row(shape: tuple, dtype, gen) -> tuple:
    """A kernel row at a family conv ``shape`` (B, H, Cin, Cout, k,
    stride, padding): (max |dev| vs plain, ms through the wrapper, plain
    ms, cuDNN ms, (bound ms, by), ms alone, cuDNN + ReLU alone)."""
    bsz, h, cin, cout, k, s, p = shape
    dev = torch.device("cuda")
    x = torch.relu(torch.randn((bsz, h, h, cin), generator=gen, device=dev)) \
        if cin > 3 else torch.rand((bsz, h, h, cin), generator=gen,
                                   device=dev)
    w = torch.randn((k, k, cin, cout), generator=gen, device=dev) * 0.1
    b = torch.randn((cout,), generator=gen, device=dev) * 0.1
    if dtype is not None:
        x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
    y = conv2d_bias_relu(x, w, b, s, True, p)
    ref = conv2d(x, w, b, s, True, p)
    err = (y.float() - ref.float()).abs().max().item()
    if dtype is None:
        conv_bar_f32(x, w, b, s, p, y, ref, f"row {shape}")
    ms = time_ms(lambda: conv2d_bias_relu(x, w, b, s, True, p))
    plain = time_ms(lambda: conv2d(x, w, b, s, True, p), iters=5)
    xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    lib = time_ms(lambda: torch.relu(F.conv2d(xn, wn, b, s, p)))
    alone = graph_ms(lambda: conv2d_bias_relu(x, w, b, s, True, p))
    lib_alone = graph_ms(lambda: torch.relu(F.conv2d(xn, wn, b, s, p)))
    ho = conv_out_size(h, k, s, p)
    flops = 2.0 * bsz * ho * ho * cout * k * k * cin
    bound = bound_ms(nbytes(x, w, b, y), flops,
                     FP32_FLOP_PER_S if dtype is None else BF16_FLOP_PER_S)
    return err, ms, plain, lib, bound, alone, lib_alone


def family_rows(gen, counts: dict) -> list:
    """The kernels line's rows of the families' conv shapes, each with its
    launches in phases 17-18 (``counts``)."""
    c = {k.split(".")[1]: v for k, v in counts.items()
         if k.startswith("conv2d_bias_relu.")}
    # each stem row: the padded strips' launches in its families' runs
    launches = {key + suffix: sum(counts.get(f"{name}.{counter}", 0)
                                  for name in fams)
                for key, (_, fams) in STEMS.items()
                for suffix, counter in zip(("", "_bf16"), STRIP_PADDED)}
    launches.update({
        "padded_3x3": c.get("launches_padded", 0)
        - c.get("launches_bf16_padded", 0)
        - c.get("launches_strip_padded", 0),
        "padded_3x3_bf16": c.get("launches_bf16_padded", 0)
        - c.get("launches_bf16_strip_padded", 0),
        # the float32 1x1s on the pointwise kernel (resnet10's 16 -> 32
        # projection stays on the tiled kernel)
        "1x1": c.get("launches_pw", 0),
        "1x1_bf16": c.get("launches_bf16_1x1", 0),
    })
    rows, lines = [], []
    for key in FAMILY_ROWS:
        for dtype, suffix in ((None, ""), (BF16, "_bf16")):
            err, ms, plain, lib, bound, alone, lib_alone = family_row(
                FAMILY_ROWS[key], dtype, gen)
            name = f"conv2d_bias_relu_{key}{suffix}"
            rows.append(entry(name, launches[key + suffix], err, ms, plain,
                              lib, bound))
            lines.append(f"{name} {FAMILY_ROWS[key]}: {ms:.4f} ms (plain "
                         f"{plain:.4f}, cuDNN {lib:.4f}, bound "
                         f"{bound[0]:.4f} by {bound[1]}), alone {alone:.4f} "
                         f"(cuDNN + ReLU alone {lib_alone:.4f}), max|dev| "
                         f"{err:.3g}, {launches[key + suffix]} launches")
    phase("family conv rows: " + "; ".join(lines))
    return rows


def graph_turns(fa, fb) -> tuple[float, float]:
    """Mean ``graph_ms`` of ``fa`` and ``fb`` timed a, b, b, a."""
    a1, b1 = graph_ms(fa), graph_ms(fb)
    b2, a2 = graph_ms(fb), graph_ms(fa)
    return (a1 + a2) / 2, (b1 + b2) / 2


def family_tma_shapes() -> list:
    """(H, Cin, Cout, k, stride, padding) of every conv of the six families
    at 224 px with Cin % 64 == 0 (the shapes the plan sends to the tma
    kernel), in the order a bf16 forward of each first meets them."""
    seen = []

    def rec(x, w, b, stride, relu, padding=0):
        key = (x.shape[1], x.shape[3], w.shape[-1], w.shape[0], stride,
               padding)
        if x.shape[3] % 64 == 0 and key not in seen:
            seen.append(key)
        return conv2d_bias_relu(x, w, b, stride, relu, padding)

    for name in FAMILIES:
        model = get_model(name, num_classes=3, image_size=224,
                          batch_norm=True, device="cuda").eval()
        with mock.patch.object(nn_module, "conv2d_bias_relu", rec), \
                torch.no_grad():
            model(torch.zeros((1, 224, 224, 3), device="cuda"),
                  compute_dtype=BF16)
    return seen


def tma_inputs(gen, bsz, h, cin, cout, k):
    dev = torch.device("cuda")
    x = torch.relu(torch.randn((bsz, h, h, cin), generator=gen, device=dev))
    w = torch.randn((k, k, cin, cout), generator=gen, device=dev) * 0.1
    b = torch.randn((cout,), generator=gen, device=dev) * 0.1
    return x.to(BF16), w.to(BF16), b.to(BF16)


def tma_phase(gen) -> dict:
    """The bf16 tma kernel. Held against the plain bf16 conv (each element
    within 1 bf16 ulp + 1e-5 x S, two launches bit-identical) with every
    tile of ``TMA_TILES`` at AlexNet's conv4 (B = 64 and 256), the padded
    3x3 and 1x1 family rows and a Cin-128 padded 3x3 (resnet18's, VGG's);
    then through the plan at every family conv shape it takes (B = 64),
    PipeCNN's trunk conv and conv4 at B = 1, 8 and 256: graph-timed in
    turns beside the wgmma kernel's plan (the tma plan must be the faster),
    every tile alone, cuDNN + ReLU alone, and the tma plan through the
    wrapper. This sweep sets ``tma_tile_for``'s rule. Returns the kernels
    line's tma row: conv4 at B = 64."""
    held = {"conv4 B=64": (B, 13, 64, 128, 3, 2, 0),
            "conv4 B=256": (TRAIN_B, 13, 64, 128, 3, 2, 0),
            "padded 3x3": FAMILY_ROWS["padded_3x3"],
            "1x1": FAMILY_ROWS["1x1"],
            "Cin 128 padded 3x3": (B, 28, 128, 128, 3, 1, 1)}
    worst = [0.0, 0.0, 0, 0]
    for what, (bsz, h, cin, cout, k, s, p) in held.items():
        x, w, b = tma_inputs(gen, bsz, h, cin, cout, k)
        for tile in range(len(TMA_TILES)):
            got = check_conv_bf16(
                x, w, b, s, f"tma {what} tile {TMA_TILES[tile]}",
                lambda *a, tile=tile, **kw: launch_conv_bf16(
                    *a, tile=tile, variant="tma", **kw)[0], padding=p)
            worst = [max(worst[0], got[0]), max(worst[1], got[1]),
                     worst[2] + got[2], worst[3] + got[3]]
    phase(f"tma conv held at {', '.join(held)} with each of the "
          f"{len(TMA_TILES)} tiles: max|dev| {worst[0]:.3g} ({worst[1]:.3g} "
          f"of the bar), {worst[2]} of {worst[3]} elements differ from the "
          "plain version, two launches bit-identical")

    sweep = [(B, *shape) for shape in family_tma_shapes()]
    sweep += [(n, 56, 64, 64, 3, 1, 1) for n in (1, 8, TRAIN_B)]
    sweep += [(n, 13, 64, 128, 3, 2, 0) for n in (1, 8, B, TRAIN_B)]
    lines, row, gains = [], None, []
    for bsz, h, cin, cout, k, s, p in sweep:
        x, w, b = tma_inputs(gen, bsz, h, cin, cout, k)
        plan = conv_bf16_plan(bsz, h, h, cin, cout, k, s, True, None, p)
        check(plan.variant == "tma", f"tma sweep {bsz}x{h}x{h}x{cin}: "
              f"planned {plan}")
        got = check_conv_bf16(x, w, b, s, f"tma plan {bsz}x{h}x{h}x{cin}->"
                              f"{cout} k{k} s{s} p{p}", padding=p)
        worst = [max(worst[0], got[0]), max(worst[1], got[1]),
                 worst[2] + got[2], worst[3] + got[3]]
        new, old = graph_turns(
            lambda: conv2d_bias_relu(x, w, b, s, True, p),
            lambda: launch_conv_bf16(x, w, b, s, True, variant="wgmma",
                                     padding=p))
        check(new < old, f"tma {bsz}x{h}x{h}x{cin}->{cout} k{k} s{s} p{p}: "
              f"the plan's tile {TMA_TILES[plan.tile]} {new:.4f} ms is not "
              f"faster than the wgmma kernel's {old:.4f}")
        gains.append(old / new)
        tiles = [graph_ms(lambda j=j: launch_conv_bf16(
            x, w, b, s, True, tile=j, variant="tma", padding=p)[0])
            for j in range(len(TMA_TILES))]
        xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
        lib = graph_ms(lambda: torch.relu(F.conv2d(xn, wn, b, s, p)))
        wrapped = time_ms(lambda: conv2d_bias_relu(x, w, b, s, True, p))
        ho = conv_out_size(h, k, s, p)
        bound = bound_ms(2 * (x.numel() + w.numel() + bsz * ho * ho * cout)
                         + nbytes(b), 2.0 * bsz * ho * ho * cout * k * k * cin,
                         BF16_FLOP_PER_S)
        best = min(range(len(tiles)), key=tiles.__getitem__)
        lines.append(
            f"B={bsz} {h}x{h}x{cin}->{cout} k{k} s{s} p{p}: tma "
            f"{'x'.join(map(str, TMA_TILES[plan.tile]))} {new:.4f} ms alone "
            f"(wrapper {wrapped:.4f}), wgmma {old:.4f}, cuDNN + ReLU "
            f"{lib:.4f}, bound {bound[0]:.4f} ({bound[1]}); tiles "
            + " ".join(f"{v:.4f}" for v in tiles)
            + f" (fastest {'x'.join(map(str, TMA_TILES[best]))})")
        if (bsz, h, cin, cout) == (B, 13, 64, 128):
            plain = time_ms(lambda: conv2d(x, w, b, s, True, p), iters=5)
            row = {"err": got[0], "ms": wrapped, "plain": plain,
                   "lib": time_ms(lambda: torch.relu(F.conv2d(
                       xn, wn, b, s, p))), "bound": bound, "alone": new,
                   "old": old, "lib_alone": lib}
    for line in lines:
        phase(f"tma sweep, {line}")
    phase(f"tma plan at {len(sweep)} shapes: within the bar everywhere "
          f"(max|dev| {worst[0]:.3g}, {worst[1]:.3g} of it), faster than the "
          f"wgmma kernel at each ({min(gains):.2f}-{max(gains):.2f}x); tiles "
          f"in the order {['x'.join(map(str, t)) for t in TMA_TILES]}")
    return row


def family_function_phase(gen) -> None:
    """The conv Function (forward and backward) at one padded stem, one
    padded stride-1 3x3 and one 1x1 of the families, batch 8, ReLU on,
    against autograd through the plain conv on the card with the
    Function's own ReLU mask: float32 dx/dw/db within FAMILY_GRAD_TOL x
    max(1, max|ref|) of the plain conv taken in float64 (cuDNN's float32
    dw sums 25,000 products a weight at these shapes and lands up to
    2.1e-5 x max|ref| from the exact sum, over the AlexNet shapes' 1e-5),
    bf16 within 2 bf16 ulps of max|ref| of the plain bf16 conv. Prints
    each dev / max(1, max|ref|)."""
    worst = {}
    for key in ("stem", "padded_3x3", "1x1"):
        _, h, cin, cout, k, s, p = FAMILY_ROWS[key]
        bsz = 8
        x = torch.randn((bsz, h, h, cin), generator=gen, device="cuda")
        w = torch.randn((k, k, cin, cout), generator=gen, device="cuda") * 0.1
        b = torch.randn((cout,), generator=gen, device="cuda") * 0.1
        ho = conv_out_size(h, k, s, p)
        g = torch.randn((bsz, ho, ho, cout), generator=gen, device="cuda")
        for dtype in (torch.float32, BF16):
            xs, ws, bs, gs = (t.to(dtype) for t in (x, w, b, g))
            leaves = [t.clone().requires_grad_(True) for t in (xs, ws, bs)]
            got = torch.autograd.grad(
                conv2d_bias_relu_fn(*leaves, s, True, p), leaves, gs)
            with torch.no_grad():
                pre = conv2d_bias_relu(xs, ws, bs, s, False, p)
            gm = torch.where(pre > 0, gs, torch.zeros_like(gs))
            ref_dt = torch.float64 if dtype == torch.float32 else BF16
            leaves = [t.to(ref_dt).requires_grad_(True)
                      for t in (xs, ws, bs)]
            ref = torch.autograd.grad(conv2d(*leaves, s, False, p), leaves,
                                      gm.to(ref_dt))
            tag = f"{key} {'bf16' if dtype == BF16 else 'f32'}"
            for what, a, r in zip(("dx", "dw", "db"), got, ref):
                top = r.abs().max().float()
                d = (a.double() - r.double()).abs().max().item()
                if dtype == BF16:
                    unit = bf16_ulp(top.reshape(1))[0].item()
                    bar = 2 * unit
                else:
                    unit = max(1.0, top.item())
                    bar = FAMILY_GRAD_TOL * unit
                check(d <= bar, f"family conv Function {tag} {what}: max "
                      f"|dev| {d:.3g} over {bar:.3g}")
                worst[tag] = max(worst.get(tag, 0.0), d / unit)
    phase("family conv Function, forward and backward against autograd "
          "through the plain conv on the card, batch 8 (float32: max "
          "dev / max(1, max|ref|) against float64, bar 1e-4; bf16: in "
          "bf16 ulps of max|ref|, bar 2): " + ", ".join(
              f"{k} {v:.3g}" for k, v in worst.items()))


def pipecnn_memory_phase(smi: str) -> dict:
    """PipeCNN (width 64, 8 blocks) at batch 256, 224 px, float32: one
    training step's peak device memory under remat False, 'full' and
    'conv'; 'conv' must lie between the other two."""
    peak = {}
    x = torch.rand((TRAIN_B, 224, 224, 3), device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(5))
    y = torch.arange(TRAIN_B, device="cuda") % 3
    for remat in (False, "full", "conv"):
        model = get_model("pipecnn", num_classes=3, remat=remat,
                          device="cuda").train()
        params = list(named_params(model).values())
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss = softmax_cross_entropy(model(x).float(), y)
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        peak[remat] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        check(bool(torch.isfinite(loss)) and len(grads) == len(params),
              f"pipecnn remat={remat}: loss {loss.item()}")
        del model, params, loss, grads
    check(peak["full"] < peak["conv"] < peak[False],
          f"pipecnn peak MiB by remat: {peak}")
    phase(f"PipeCNN (64 wide, 8 blocks) one float32 training step at batch "
          f"{TRAIN_B}, peak device memory above the weights (MiB): remat "
          f"False {peak[False]:.1f}, 'full' {peak['full']:.1f}, 'conv' "
          f"{peak['conv']:.1f} ({smi})")
    return peak


def family_train_want(per_fwd: dict, steps: int, evals: int) -> dict:
    """The counters of ``steps`` train steps (full augmentation: one
    rotation each) and ``evals`` eval batches of a family whose eval
    forward launches ``per_fwd``."""
    want = {k: v * (steps + evals) for k, v in per_fwd.items()}
    pools = per_fwd.get("max_pool2d_fwd.launches", 0)
    if pools:
        want["max_pool2d_bwd.launches"] = pools * steps
        bf16 = "max_pool2d_fwd.launches_bf16" in per_fwd
        want["max_pool2d_bwd.launches_bf16" if bf16
             else "max_pool2d_bwd.launches_window"] = pools * steps
    want.update({"uint8_normalize.launches": evals,
                 "uint8_normalize.launches_wide": evals,
                 "rotate_shear.launches": steps})
    return want


def families_training_phase(smi: str, tmp: Path, cli: dict) -> dict:
    """Phase 18: ``tools.train --name <family>`` at the flagship's flags on
    phase 14's images: resnet10 fresh in bf16 and float32 for 40
    iterations, then resumed from a copy of its committed checkpoint for
    20; mobilenet, pipecnn (remat 'conv') and vgg8 for 20 in bf16. Each
    run's launches exact, its losses finite (falling over the fresh
    runs), its checkpoint read back equal. Returns the launches, added
    up."""
    fixture = np.load(FAMILY_FIXTURE)
    nv, nt = cli["valid_batches"], cli["test_batches"]
    base = ["--dataset-path", str(cli["data"]), *cli["sizes"]]
    f32_flags = [f for f in CLI_FLAGSHIP if f not in ("--compute-dtype",
                                                      "bfloat16")]
    resume = tmp / "resnet10_start.ckpt"
    shutil.copy(ROOT / str(fixture["resnet10_checkpoint"]), resume)
    start = int(read_checkpoint(str(resume))["step"])
    runs = [("resnet10", "bf16", CLI_FLAGSHIP, 0, FAMILY_TRAIN_STEPS),
            ("resnet10", "float32", f32_flags, 0, FAMILY_TRAIN_STEPS),
            ("resnet10", "bf16, resumed", CLI_FLAGSHIP, start, 20),
            ("mobilenet", "bf16", CLI_FLAGSHIP, 0, 20),
            ("pipecnn", "bf16", CLI_FLAGSHIP, 0, 20),
            ("vgg8", "bf16", CLI_FLAGSHIP, 0, 20)]
    total, lines = {}, []
    for name, what, flags, first, steps in runs:
        dtype = BF16 if "--compute-dtype" in flags else None
        probe = get_model(name, num_classes=3, image_size=224,
                          batch_norm=True, device="cuda").eval()
        per_fwd = forward_counts(probe, dtype)[0]
        del probe
        end = first + steps
        ck = tmp / f"{name}_{what.replace(', ', '_')}"
        argv = flags + base + ["--name", name, "--checkpoint-dir", str(ck),
                               "--total-iters", str(end), "--valid-iters",
                               "20", "--save-iters", "20"]
        if first:
            argv += ["--resume", str(resume)]
        evals = (steps // 20) * nv + nt
        losses, step_ms = [], []
        real_make = train_cli.make_device_train_step

        def recording(*args, **kwargs):
            step = real_make(*args, **kwargs)

            def wrapped(ts):
                a = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                a.record()
                ts, m = step(ts)
                e.record()
                losses.append(m["loss"].detach().float())
                step_ms.append((a, e))
                return ts, m
            return wrapped
        times = CliTimes()
        t = time.perf_counter()
        with mock.patch.object(train_cli, "make_device_train_step",
                               recording):
            text, counts = run_cli(argv, f"train CLI --name {name} {what}",
                                   family_train_want(per_fwd, steps, evals),
                                   times)
        secs = time.perf_counter() - t
        add_up(total, counts)
        add_up(total, stem_counts(name, counts))
        if first:
            check(f"resumed from {resume} at step {start}" in text,
                  f"{name} {what}: did not resume from step {start}")
        loss = torch.stack(losses).cpu()
        check(len(loss) == steps and bool(torch.isfinite(loss).all()),
              f"{name} {what}: {len(loss)} losses, {loss}")
        first5, last5 = loss[:5].mean().item(), loss[-5:].mean().item()
        if not first and name == "resnet10":
            check(last5 < first5, f"{name} {what}: the mean loss of the last "
                  f"5 steps {last5:.4f} is not below the first 5's "
                  f"{first5:.4f}")
        dev_ms = [a.elapsed_time(e) for a, e in step_ms[-10:]]
        # the checkpoint it wrote, through a fresh train state and back
        path = sorted(ck.glob(f"iter_{end}_*.ckpt"))
        check(len(path) == 1, f"{name} {what}: checkpoints "
              f"{sorted(p.name for p in ck.glob('*.ckpt'))}")
        model = get_model(name, num_classes=3, image_size=224,
                          batch_norm=True, device="cuda")
        opt = make_optimizer("momentum", 1.5e-2, schedule="cosine",
                             total_steps=end)
        ts = load_checkpoint(str(path[0]), create_train_state(model, opt))
        again = tmp / "again.ckpt"
        save_checkpoint(str(again), ts)
        a, b = read_checkpoint(str(path[0])), read_checkpoint(str(again))
        check(ts.step == end and same_trees(a["params"], b["params"])
              and same_trees(a["state"], b["state"])
              and same_trees(a["opt_state"][0].trace,
                             b["opt_state"][0].trace),
              f"{name} {what}: the checkpoint does not read back equal")
        test = [l for l in text.splitlines() if l.startswith("Test===>")]
        lines.append(f"{name} {what}, iterations {first + 1}-{end}: "
                     f"{TRAIN_B * steps / times.s['loop']:.1f} img/s over the "
                     f"loop ({times.s['loop']:.3f} s), device "
                     f"{float(np.mean(dev_ms)):.3f} ms a step (CUDA events, "
                     f"last 10); loss first 5 {first5:.4f}, last 5 "
                     f"{last5:.4f}; {test[-1] if test else ''}; {secs:.1f} s")
    for line in lines:
        phase(f"family training, {line}")
    phase(f"family training ({smi}): launches exact in every run (per step "
          "one conv launch per Conv2D layer, PipeCNN's remat='conv' "
          "recomputing none), checkpoints read back equal")
    return total


# ---------------------------------------------------------------------------
# the training toolbox through the train, evaluate and infer CLIs (phase 19)
# ---------------------------------------------------------------------------

TOOLBOX_STEPS = 20
TEACHER = ROOT / "checkpoints" / "resnet10" / (
    "iter_15000_train_0.997_valid_0.970.ckpt")
TRANSFER = ROOT / "checkpoints" / "resnet10_cat4_transfer" / (
    "iter_12000_train_0.976_valid_0.873.ckpt")
DISTILLED = ROOT / "checkpoints" / "alexnet_distill" / (
    "iter_17000_train_0.992_valid_0.930.ckpt")
# run -> (its model, the flags beside the flagship's)
TOOLBOX_RUNS = {
    "plain": ("alexnet", []),
    "adamw+clip+ema+mixup+cutmix+jitter": ("alexnet", [
        "--optimizer", "adam", "--learning-rate", "1e-3",
        "--weight-decay", "1e-4", "--grad-clip", "1.0", "--ema", "0.999",
        "--mixup", "0.2", "--cutmix", "1.0", "--color-jitter", "0.2"]),
    "grad-accum 4, steps-per-call 4": ("alexnet", [
        "--grad-accum", "4", "--steps-per-call", "4"]),
    "distilled from resnet10": ("alexnet", [
        "--distill-from", str(TEACHER), "--distill-model", "resnet10"]),
    "resnet10 warm-started, stem frozen": ("resnet10", [
        "--init-from", str(TRANSFER), "--num-classes", "3",
        "--freeze", "stem"]),
}
def toolbox_want(models, dtype, steps: int, accum: int, evals: int) -> dict:
    """The exact counters of a run of ``models`` (the student, then any
    teachers): ``steps`` train steps of ``accum`` microbatches, each a
    forward of every model and the student's backward (its pool backward
    once per pool), one rotation a step; ``evals`` normalized eval
    batches, each a forward of the student. A model's forward launches
    what ``forward_counts`` finds; no fallback conv is among them (phases
    17-18 hold that)."""
    fwd = [forward_counts(m, dtype)[0] for m in models]
    passes = steps * accum
    want = {k: v * (passes + evals) for k, v in fwd[0].items()}
    for f in fwd[1:]:
        for k, v in f.items():
            want[k] = want.get(k, 0) + v * passes
    pools = fwd[0].get("max_pool2d_fwd.launches", 0) * passes
    want["max_pool2d_bwd.launches"] = pools
    want["max_pool2d_bwd.launches_bf16" if dtype is not None
         else "max_pool2d_bwd.launches_window"] = pools
    want["rotate_shear.launches"] = steps
    want["uint8_normalize.launches"] = evals
    want["uint8_normalize.launches_wide"] = evals
    return {k: v for k, v in want.items() if v}


@contextmanager
def shared_device_datasets():
    """The train CLI's ``DeviceDataset``s made once per (samples, size) and
    reused by every later run of the phase (the data is only read)."""
    made = {}
    real = train_cli.DeviceDataset

    def cached(samples, size, *args, **kwargs):
        key = (tuple(samples), size)
        if key not in made:
            made[key] = real(samples, size, *args, **kwargs)
        return made[key]
    with mock.patch.object(train_cli, "DeviceDataset", cached):
        yield


def ema_logits_check(model, photos, what: str) -> float:
    """The EMA model's float32 logits on the photos through the kernels
    against the plain versions on the card: within LOGIT_ATOL x max(1,
    max|ref|); returns the scaled deviation."""
    x = uint8_to_float(torch.from_numpy(photos).cuda())
    model.eval()
    with torch.no_grad():
        got = model(x).float()
        with plain_versions():
            ref = model(x).float()
    dev = float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))
    check(dev <= LOGIT_ATOL and bool(torch.equal(got.argmax(-1),
                                                 ref.argmax(-1))),
          f"{what}: EMA logits against the plain versions, scaled max|dev| "
          f"{dev:.3g}")
    return dev


def toolbox_phase(smi: str, tmp: Path, cli: dict) -> tuple[dict, dict]:
    """Phase 19: the training toolbox through the train CLI at the
    flagship's flags on phase 14's images, 20 iterations each in float32
    and bf16 (``TOOLBOX_RUNS``), the evaluate CLI on two committed EMA
    checkpoints and ``infer --use-ema`` on the six photos. Returns the
    launches of the AlexNet-only runs and of the runs with a resnet10,
    each added up."""
    nv, nt = cli["valid_batches"], cli["test_batches"]
    base = ["--dataset-path", str(cli["data"]), *cli["sizes"]]
    f32_flags = [f for f in CLI_FLAGSHIP if f not in ("--compute-dtype",
                                                      "bfloat16")]
    alex, fam, lines, step_ms = {}, {}, [], {}
    with shared_device_datasets():
        for dtype in (None, BF16):
            tag = "bf16" if dtype is not None else "float32"
            flags = CLI_FLAGSHIP if dtype is not None else f32_flags
            for run, (name, more) in TOOLBOX_RUNS.items():
                models = [get_model(name, num_classes=3, image_size=224,
                                    batch_norm=True, device="cuda")]
                if "--distill-from" in more:
                    models.append(get_model("resnet10", num_classes=3,
                                            image_size=224, batch_norm=True,
                                            device="cuda"))
                accum = (int(more[more.index("--grad-accum") + 1])
                         if "--grad-accum" in more else 1)
                want = toolbox_want(models, dtype, TOOLBOX_STEPS, accum,
                                    nv + nt)
                del models
                ck = tmp / f"toolbox_{tag}_{len(lines)}"
                argv = flags + base + [
                    "--name", name, "--checkpoint-dir", str(ck),
                    "--total-iters", str(TOOLBOX_STEPS), "--valid-iters",
                    "20", "--save-iters", "20", *more]
                spc = (int(more[more.index("--steps-per-call") + 1])
                       if "--steps-per-call" in more else 1)
                losses, events = [], []
                real_make = train_cli.make_device_train_step

                def recording(*args, **kwargs):
                    step = real_make(*args, **kwargs)

                    def wrapped(ts):
                        a = torch.cuda.Event(enable_timing=True)
                        e = torch.cuda.Event(enable_timing=True)
                        a.record()
                        ts, m = step(ts)
                        e.record()
                        losses.append(m["loss"].detach().float())
                        events.append((a, e))
                        return ts, m
                    return wrapped
                with mock.patch.object(train_cli, "make_device_train_step",
                                       recording):
                    text, counts, secs = counted_run(
                        f"toolbox {run} ({tag})", train_cli.main, argv, want)
                loss = torch.stack(losses).cpu()
                check(len(loss) * spc == TOOLBOX_STEPS
                      and bool(torch.isfinite(loss).all())
                      and "training done!" in text and "Test===>" in text,
                      f"toolbox {run} ({tag}): losses {loss}; output ends "
                      f"{text[-1500:]!r}")
                ms = float(np.mean([a.elapsed_time(e) for a, e in
                                    events[len(events) // 2:]])) / spc
                step_ms[(run, tag)] = ms
                (path,) = ck.glob(f"iter_{TOOLBOX_STEPS}_*.ckpt")
                saved = read_checkpoint(str(path))
                extra = toolbox_checks(run, text, saved)
                add_up(fam if name == "resnet10" or "--distill-from" in more
                       else alex, counts)
                if name == "resnet10" or "--distill-from" in more:
                    add_up(fam, stem_counts("resnet10", counts))
                test = [l for l in text.splitlines()
                        if l.startswith("Test===>")][-1]
                lines.append(f"{run} ({tag}): device {ms:.3f} ms a step "
                             f"(CUDA events, second half), loss first "
                             f"{loss[0].item():.4f} last {loss[-1].item():.4f}"
                             f"; {test}; {extra}; {secs:.1f} s")
    for line in lines:
        phase(f"toolbox, {line}")

    # evaluate on two committed EMA checkpoints (legacy: no EMA'd BN
    # state), the second a 4-class resnet10 on the images with a 4th class
    # made of the birds
    cat4 = tmp / "animals4"
    cat4.mkdir()
    for c in ("dog", "panda", "bird"):
        (cat4 / c).symlink_to(Path(cli["data"]) / c)
    (cat4 / "cat").symlink_to(Path(cli["data"]) / "bird")
    photos = family_photos()
    evals = [("alexnet_distill", DISTILLED, "alexnet", 3, cli["data"],
              "dog,panda,bird"),
             ("resnet10_cat4_transfer", TRANSFER, "resnet10", 4, cat4,
              "dog,panda,bird,cat")]
    ev_lines = []
    for what, path, name, nc, data, cats in evals:
        probe = get_model(name, num_classes=nc, image_size=224,
                          batch_norm=True, device="cuda")
        n_test = len(split_dataset(discover_dataset(
            str(data), tuple(cats.split(","))))["test"])
        want = toolbox_want([probe], None, 0, 1, -(-n_test // B))
        del probe
        argv = ["--dataset-path", str(data), "--categories", cats,
                "--image-size", "224", "--valid-batch-size", str(B),
                "--resume", str(path), "--name", name, "--num-classes",
                str(nc), "--split", "test"]
        text, counts, secs = counted_run(f"evaluate {what}",
                                         evaluate_cli.main, argv, want)
        add_up(alex if name == "alexnet" else fam, counts)
        if name == "resnet10":
            add_up(fam, stem_counts("resnet10", counts))
        check(f"{path}: evaluating the EMA-averaged weights" in text,
              f"evaluate {what}: {text[-1500:]!r}")
        test = [l for l in text.splitlines() if l.startswith("Test===>")]
        model = evaluate_cli.load_model(str(path), name, "cuda",
                                        announce=False, num_classes=nc,
                                        image_size=224)
        dev = ema_logits_check(model, photos, f"evaluate {what}")
        ev_lines.append(f"{what}: {test[0]}, EMA logits against the plain "
                        f"versions scaled max|dev| {dev:.3g}, {secs:.3f} s")

    paths = write_photos(tmp)[1]
    want = toolbox_want([get_model("alexnet", num_classes=3,
                                   image_size=224, batch_norm=True,
                                   device="cuda")], None, 0, 1, len(paths))
    text, counts, secs = counted_run(
        "infer --use-ema", infer_cli.main,
        ["--checkpoint", str(DISTILLED), "--batch-norm", "--use-ema",
         *paths], want)
    add_up(alex, counts)
    rows = predictions(text)
    model = get_model("alexnet", num_classes=3, image_size=224,
                      batch_norm=True, device="cuda")
    infer_cli.load_params(str(DISTILLED), model, use_ema=True)
    dev = ema_logits_check(model, photos, "infer --use-ema")
    x = uint8_to_float(torch.from_numpy(photos).cuda())
    with torch.no_grad(), plain_versions():
        probs = torch.softmax(model(x).float(), dim=-1).cpu()
    check(len(rows) == 6 and all(
        abs(p - float(probs[i].max())) <= PROB_ATOL
        and r == ("dog", "panda", "bird")[int(probs[i].argmax())]
        for i, (_, r, p) in enumerate(rows)),
        f"infer --use-ema printed {rows}, the plain versions give "
        f"{probs.max(-1)}")
    ev_lines.append(f"infer --use-ema ({DISTILLED.parent.name}): "
                    f"{[r[1] for r in rows]}, probabilities within "
                    f"{PROB_ATOL} of the plain versions', logits scaled "
                    f"max|dev| {dev:.3g}, {secs:.3f} s")
    for line in ev_lines:
        phase(f"toolbox, {line}")
    phase(f"training toolbox ({smi}): launches exact in every run (per "
          "step and microbatch a forward of each model and the student's "
          "backward, one rotation a step; none on a fallback conv); device "
          "ms a step, plain AlexNet against each run: " + "; ".join(
              f"{run} {tag} {ms:.3f}" for (run, tag), ms in step_ms.items()))
    return alex, fam


def toolbox_checks(run: str, text: str, saved: dict) -> str:
    """What each run must show beyond its launches and losses; returns a
    note for its line."""
    opt = saved["opt_state"]
    if "--ema" in TOOLBOX_RUNS[run][1]:
        check("weight EMA: decay 0.999" in text
              and type(opt).__name__ == "EmaState"
              and int(opt.count) == TOOLBOX_STEPS
              and opt.mstate is not None,
              f"{run}: the EMA state {type(opt).__name__}")
        return (f"EMA count {int(opt.count)}, inner "
                f"{[type(s).__name__ for s in opt.inner]}")
    if "--grad-accum" in TOOLBOX_RUNS[run][1]:
        check(saved["step"] == TOOLBOX_STEPS,
              f"{run}: step {saved['step']}")
        return f"{TOOLBOX_STEPS // 4} calls of 4 steps, 4 microbatches each"
    if "--distill-from" in TOOLBOX_RUNS[run][1]:
        check("distilling from 1 teacher(s)" in text, f"{run}: {text[:600]!r}")
        return "teacher resnet10 in eval mode"
    if "--init-from" in TOOLBOX_RUNS[run][1]:
        line = next(l for l in text.splitlines()
                    if l.startswith("warm start from"))
        check(line.endswith("kept fresh: /linear_1/w (shape (128, 4) vs "
                            "(128, 3)), /linear_1/b (shape (4,) vs (3,))"),
              f"{run}: {line}")
        src = read_checkpoint(str(TRANSFER))["params"]
        got = saved["params"]
        frozen = {k: same_trees(got[k], src[k]) for k in got
                  if k.startswith("stem")}
        moved = {k: not same_trees(got[k], src[k]) for k in got
                 if not k.startswith(("stem", "linear_1"))}
        check(frozen and all(frozen.values()) and all(moved.values()),
              f"{run}: stem unchanged {frozen}, others moved {moved}")
        return (f"{line.split(': ')[1]}; stem bit-unchanged, "
                f"{len(moved)} other subtrees moved")
    return "momentum, no toolbox flag"


# ---------------------------------------------------------------------------
# MoECNN, AlexNet's space-to-depth convs, Grad-CAM at every family and inside
# a trunk, whole-model remat (phase 20)
# ---------------------------------------------------------------------------

MOE_STEPS = 5            # training steps at the training batch, each dtype
MOE_BALANCE = 0.01       # --moe-balance of the training runs
MOE_CLI_STEPS = 20
# MoECNN's 64 -> 64 stride-2 padded 3x3s, a kernel row timed at the first
# extent (112); its launches are those of all three (112, 56 and 28)
MOE_ROWS = {"s2_64": (B, 112, 64, 64, 3, 2, 1)}
# Grad-CAM through the CLI: (family, its committed checkpoint, layer)
CAM_CASES = (("resnet10", "block_4"), ("pipecnn", "trunk/block_3"),
             ("pipecnn", "trunk/block_3/b_conv1"), ("moecnn", "stem_relu4"))
for _key in MOE_ROWS:
    for _sfx in ("", "_bf16"):
        REPLACES[f"conv2d_bias_relu_{_key}{_sfx}"] = REPLACES[
            "conv2d_bias_relu" + _sfx]
        SOURCES[f"conv2d_bias_relu_{_key}{_sfx}"] = \
            "cnn_tpu_torch/csrc/conv.cu"


def counted(fn) -> tuple:
    """``fn()`` with the counters at 0 just before; its result and the
    non-zero counters just after."""
    torch.cuda.synchronize()
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in read_counters().items() if v}


def normalize_counts(images, dtype) -> dict:
    """The counters of one normalize of ``images`` into ``dtype``."""
    return counted(lambda: uint8_normalize(images, dtype or torch.float32))[1]


def no_fallback(counts: dict, what: str) -> None:
    """No launch of the direct conv kernel or of the bf16 gather."""
    check(counts.get("conv2d_bias_relu.launches_direct", 0)
          + counts.get("conv2d_bias_relu.launches_bf16_gather", 0) == 0,
          f"{what}: the direct kernel or the gather launched: {counts}")


def router_gap(model, x) -> float:
    """The least gap between an image's two best router probabilities."""
    with torch.no_grad():
        _, feats = model(x, capture=("gap",))
        probs = torch.softmax(feats["gap"].float()
                              @ model.net["moe"].router, -1)
    top2 = probs.sort(dim=-1).values[:, -2:]
    return float((top2[:, 1] - top2[:, 0]).min())


def moecnn_serving(smi: str) -> tuple[dict, list]:
    """The committed MoECNN (width 64, 8 experts, hidden 256, 224 px)
    through ``serve_family`` in float32 (the six photos' logits against
    ``family_logits.npz``) and bf16 (against float32); then a request of 5
    images in bucket 8 against the eager forward of the same 5 padded with
    3 zero images. Returns the counts and the log lines."""
    fixture = np.load(FAMILY_FIXTURE)
    model = get_model("moecnn", num_classes=3, image_size=224,
                      batch_norm=True, device="cuda")
    payload = read_checkpoint(str(ROOT / str(fixture["moecnn_checkpoint"])))
    load_jax_params(model, payload["params"], payload["state"])
    model.eval()
    rng = np.random.default_rng(20)
    photos = family_photos()
    imgs64 = synthetic_images(rng, 64)
    gap = router_gap(model, uint8_normalize(torch.from_numpy(photos).cuda()))
    check(gap > 1e-4, f"moecnn: the photos' top-2 router gap {gap:.3g}")
    total, lines, f32 = {}, [], None
    for dtype in (None, BF16):
        ref = ((torch.from_numpy(fixture["moecnn_logits"]).cuda(),
                "the fixture", LOGIT_ATOL) if dtype is None
               else (f32, "float32", BF16_MODEL_TOL))
        counts, logits, engine, line = serve_family(
            "moecnn", model, dtype, rng, photos, imgs64, ref)
        add_up(total, counts)
        if dtype is None:
            f32 = logits
        five = np.zeros((8, 224, 224, 3), np.uint8)
        five[:5] = imgs64[:5]
        (labels, probs), c5 = counted(lambda: engine.predict(imgs64[:5]))
        check(c5 == engine._ready[8].launches, f"moecnn 5 in bucket 8: "
              f"launches {c5}, the graph's {engine._ready[8].launches}")
        add_up(total, c5)
        with torch.no_grad():
            ep, el = engine._forward(torch.from_numpy(five).cuda())
        check(same_arrays(probs, ep[:5].cpu().numpy())
              and same_arrays(labels, el[:5].int().cpu().numpy()),
              "moecnn: 5 images in bucket 8 differ from the eager forward "
              "of the same 5 and 3 zero images")
        lines.append(line + "; 5 images in bucket 8 bit-equal to the eager "
                     "zero-padded forward")
        del engine
        torch.cuda.empty_cache()
    lines.append(f"the photos' least top-2 router gap {gap:.4g} ({smi})")
    return total, lines


def moecnn_training(smi: str) -> tuple[dict, list, dict]:
    """MoECNN seeded with ``--moe-balance`` 0.01, ``make_train_step`` for
    ``MOE_STEPS`` steps at the training batch on synthetic uint8 images, in
    float32 and bf16: finite losses, the aux loss above 0, the loads
    printed, the launches exact (per step the normalize and one conv per
    Conv2D layer, none on the direct kernel or the gather). Returns the
    counts, the log lines and the device ms a step per dtype."""
    rng = np.random.default_rng(22)
    x = torch.from_numpy(synthetic_images(rng, TRAIN_B)).cuda()
    y = torch.arange(TRAIN_B, device="cuda") % 3
    total, lines, step_ms = {}, [], {}
    for dtype in (None, BF16):
        tag = "bf16" if dtype else "float32"
        model = get_model("moecnn", num_classes=3, image_size=224,
                          batch_norm=True, balance_coeff=MOE_BALANCE,
                          device="cuda",
                          generator=torch.Generator().manual_seed(20))
        per_fwd = forward_counts(model.eval(), dtype)[0]
        opt = make_optimizer("momentum", 1.5e-2, schedule="cosine",
                             total_steps=MOE_STEPS)
        ts = create_train_state(model, opt, seed=20)
        step = make_train_step(model, opt, compute_dtype=dtype)
        events, losses = [], []

        def train():
            for _ in range(MOE_STEPS):
                a = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                a.record()
                _, m = step(ts, x, y)
                e.record()
                events.append((a, e))
                losses.append(m["loss"].detach())
        _, counts = counted(train)
        want = {k: v * MOE_STEPS for k, v in {
            **per_fwd, **normalize_counts(x, dtype)}.items()}
        check(counts == want, f"moecnn {tag} training: launches {counts}, "
              f"expected {want}")
        add_up(total, counts)
        loss = torch.stack(losses).float().cpu()
        moe = model.net["moe"]
        aux = float(moe.aux_loss)
        check(bool(torch.isfinite(loss).all()) and aux > 0.0,
              f"moecnn {tag} training: losses {loss.tolist()}, aux {aux}")
        step_ms[tag] = float(np.mean([a.elapsed_time(e)
                                      for a, e in events[1:]]))
        load = moe.load.cpu().numpy().round(4).tolist()
        lines.append(f"{tag}: {MOE_STEPS} steps at batch {TRAIN_B}, losses "
                     f"{[round(v, 4) for v in loss.tolist()]}, aux_loss "
                     f"{aux:.5f}, load {load}, device {step_ms[tag]:.3f} ms "
                     f"a step (steps 2-{MOE_STEPS}, CUDA events; {smi})")
    return total, lines, step_ms


def gradcam_case(name, ckpt, layer, paths, imgs, out_dir) -> tuple:
    """``tools.gradcam --model name --layer layer`` on ``paths`` through a
    counted run: the launches six times those of one image's
    ``compute_cam`` (none on the direct kernel or the gather), each CAM
    within ``CAM_ATOL`` of ``compute_cam`` on the plain versions on the
    card and the same class. Returns the counts, the worst CAM deviation
    and the run's seconds."""
    model = get_model(name, num_classes=3, image_size=224, batch_norm=True,
                      device="cuda")
    payload = read_checkpoint(str(ckpt))
    load_jax_params(model, payload["params"], payload["state"])
    x = [uint8_to_float(torch.from_numpy(img[None]).cuda()) for img in imgs]
    _, one = counted(lambda: gradcam_cli.compute_cam(model, x[0], layer))
    no_fallback(one, f"gradcam {name} {layer}")
    got = []
    real = gradcam_cli.compute_cam

    def cam(*args, **kwargs):
        got.append(real(*args, **kwargs))
        return got[-1]
    with mock.patch.object(gradcam_cli, "compute_cam", cam):
        _, counts, secs = counted_run(
            f"gradcam --model {name} --layer {layer}", gradcam_cli.main,
            ["--checkpoint", str(ckpt), "--model", name, "--batch-norm",
             "--layer", layer, "--output-dir", str(out_dir), *paths],
            {k: len(paths) * v for k, v in one.items()})
    worst = 0.0
    for i, xi in enumerate(x):
        with plain_everywhere():
            ref, probs = gradcam_cli.compute_cam(model, xi, layer)
        worst = max(worst, float(np.abs(got[i][0] - ref).max()))
        check(int(got[i][1].argmax()) == int(probs.argmax()),
              f"gradcam {name} {layer}: image {i}'s class")
        check((out_dir / f"{i}.png").exists(), f"gradcam {name} {layer}: "
              f"no {i}.png")
    bar = CAM_TRUNK_ATOL if "/" in layer else CAM_ATOL
    check(worst <= bar, f"gradcam {name} {layer}: CAM against the plain "
          f"versions max|dev| {worst:.3g} (bar {bar})")
    return counts, worst, secs


def plain_everywhere():
    """Every conv and pool call of a layer (the wrappers, the autograd
    Functions, the custom op) and the normalize on their plain versions."""
    stack = plain_versions()
    stack.enter_context(plain_training())
    stack.enter_context(mock.patch.object(nn_module, "conv2d_bias_relu_op",
                                          conv2d))
    return stack


def moecnn_cli(smi: str, tmp: Path, cli: dict) -> tuple[dict, list]:
    """``tools.train --name moecnn --moe-balance 0.01`` at the flagship's
    flags on phase 14's images for ``MOE_CLI_STEPS`` iterations (launches
    exact, the ``MoE load [moe]`` line and ``moe_load`` in the history),
    then ``tools.infer --model moecnn`` and ``tools.gradcam --layer
    stem_relu4`` on the checkpoint it wrote. Returns the counts and the
    log lines."""
    nv, nt = cli["valid_batches"], cli["test_batches"]
    probe = get_model("moecnn", num_classes=3, image_size=224,
                      batch_norm=True, device="cuda").eval()
    per_fwd = forward_counts(probe, BF16)[0]
    per_f32 = forward_counts(probe, None)[0]
    del probe
    ck = tmp / "moecnn_cli"
    argv = CLI_FLAGSHIP + ["--dataset-path", str(cli["data"]), *cli["sizes"],
                           "--name", "moecnn", "--moe-balance",
                           str(MOE_BALANCE), "--checkpoint-dir", str(ck),
                           "--total-iters", str(MOE_CLI_STEPS),
                           "--valid-iters", "20", "--save-iters", "20"]
    times = CliTimes()
    t = time.perf_counter()
    text, total = run_cli(argv, "train CLI --name moecnn",
                          family_train_want(per_fwd, MOE_CLI_STEPS,
                                            (MOE_CLI_STEPS // 20) * nv + nt),
                          times)
    secs = time.perf_counter() - t
    loads = [ln for ln in text.splitlines() if ln.startswith("MoE load [moe]")]
    hist = read_history(str(ck / "history.jsonl"))
    check(len(loads) == 1 and hist and "moe_load" in hist[-1],
          f"train CLI --name moecnn: load lines {loads}, history {hist}")
    path = sorted(ck.glob(f"iter_{MOE_CLI_STEPS}_*.ckpt"))
    check(len(path) == 1 and "aux_loss" in read_checkpoint(
        str(path[0]))["state"]["moe"], f"train CLI --name moecnn: {path}")
    imgs, paths = write_photos(tmp)
    text_i, counts, infer_s = counted_run(
        "infer --model moecnn", infer_cli.main,
        ["--checkpoint", str(path[0]), "--model", "moecnn", "--batch-norm",
         *paths],
        {k: 6 * v for k, v in dict(per_f32, **{
            "uint8_normalize.launches": 1,
            "uint8_normalize.launches_wide": 1}).items()})
    add_up(total, counts)
    check(len(predictions(text_i)) == 6, f"infer --model moecnn: {text_i!r}")
    counts, worst, cam_s = gradcam_case(
        "moecnn", path[0], "stem_relu4", paths, imgs, tmp / "cam_moecnn_cli")
    add_up(total, counts)
    return total, [
        f"train CLI --name moecnn --moe-balance {MOE_BALANCE}, bf16, "
        f"{MOE_CLI_STEPS} iterations: {loads[0]}; {secs:.1f} s "
        f"({TRAIN_B * MOE_CLI_STEPS / times.s['loop']:.1f} img/s over the "
        f"loop); infer on its checkpoint {infer_s:.3f} s; gradcam "
        f"stem_relu4 CAMs within {worst:.3g} of the plain versions "
        f"({cam_s:.3f} s; {smi})"]


def gradcam_families(smi: str, tmp: Path) -> tuple[dict, list]:
    """``tools.gradcam`` on the six photos for each of ``CAM_CASES`` from
    the committed checkpoints (``gradcam_case``)."""
    fixture = np.load(FAMILY_FIXTURE)
    imgs, paths = write_photos(tmp)
    total, lines = {}, []
    for name, layer in CAM_CASES:
        ckpt = ROOT / str(fixture[f"{name}_checkpoint"])
        out = tmp / f"cam_{name}_{layer.replace('/', '_')}"
        counts, worst, secs = gradcam_case(name, ckpt, layer, paths, imgs,
                                           out)
        add_up(total, counts)
        lines.append(f"--model {name} --layer {layer}: CAMs within "
                     f"{worst:.3g} of the plain versions, {secs:.3f} s")
    return total, [f"gradcam CLI, six photos each ({smi}): "
                   + "; ".join(lines)]


def s2d_phase(smi: str) -> tuple[dict, list]:
    """AlexNet with ``space_to_depth`` from the committed ``.model``, whose
    s2d convs run as the stride-2 convs they compute: every conv launch
    against the plain conv (``check_family_convs``), one forward's
    launches those of the plain AlexNet; served at B = 64 in float32 and
    bf16, the replay bit-equal to the eager forward and to the plain
    AlexNet's; 5 train steps at the training batch in each dtype; no
    launch of the direct kernel or the gather anywhere. Returns the counts
    and the log lines."""
    model = get_model("alexnet", num_classes=3, batch_norm=True,
                      image_size=224, space_to_depth=True, device="cuda")
    load_reference_model(model, MODEL)
    flat = get_model("alexnet", num_classes=3, batch_norm=True,
                     image_size=224, device="cuda")
    load_reference_model(flat, MODEL)
    check([l.s2d for l in model.net if isinstance(l, Conv2D)]
          == [True, True, False, False], "s2d AlexNet: the flagged convs")
    rng = np.random.default_rng(23)
    imgs = synthetic_images(rng, B)
    xb = uint8_normalize(torch.from_numpy(imgs).cuda())
    total, lines = {}, []
    for dtype in (None, BF16):
        tag = f"s2d AlexNet {'bf16' if dtype else 'float32'}"
        per_fwd = forward_counts(model.eval(), dtype)[0]
        no_fallback(per_fwd, tag)
        flat_fwd = forward_counts(flat.eval(), dtype)[0]
        check(per_fwd == flat_fwd, f"{tag}: one forward launched {per_fwd},"
              f" the plain AlexNet {flat_fwd}")
        shapes, worst = check_family_convs(model, dtype, xb[:8])
        engine = serving.InferenceEngine(model, buckets=(B,), device="cuda",
                                         compute_dtype=dtype)
        engine.warmup()
        (labels, probs), counts = counted(lambda: engine.predict(imgs))
        check(counts == engine._ready[B].launches, f"{tag} serving: "
              f"launches {counts}, the graph's {engine._ready[B].launches}")
        no_fallback(counts, tag)
        add_up(total, counts)
        with torch.no_grad():
            ep, el = engine._forward(torch.from_numpy(imgs).cuda())
            logits = model(xb, compute_dtype=dtype)
            ref = flat(xb, compute_dtype=dtype)
        check(same_arrays(probs, ep.cpu().numpy()), f"{tag}: the replay "
              "differs from the eager forward")
        # bf16 -> float32 is exact, so the float32 bits compare bf16 ones
        check(bits_equal(logits.float(), ref.float()), f"{tag}: logits "
              "differ from the plain AlexNet's")
        graphed = time_ms(engine._ready[B].graph.replay, iters=5)
        del engine
        # training: normalize, 4 convs, pool forward and backward a step
        train_model = get_model("alexnet", num_classes=3, batch_norm=True,
                                image_size=224, space_to_depth=True,
                                device="cuda")
        load_reference_model(train_model, MODEL)
        opt = make_optimizer("momentum", 1.5e-2)
        ts = create_train_state(train_model, opt, seed=23)
        step = make_train_step(train_model, opt, compute_dtype=dtype)
        xt = torch.from_numpy(synthetic_images(rng, TRAIN_B)).cuda()
        yt = torch.arange(TRAIN_B, device="cuda") % 3
        losses = []

        def train():
            for _ in range(MOE_STEPS):
                losses.append(step(ts, xt, yt)[1]["loss"].detach())
        _, counts = counted(train)
        no_fallback(counts, f"{tag} training")
        pool = "launches_bf16" if dtype else "launches_window"
        want = {k: v * MOE_STEPS for k, v in {
            **per_fwd, **normalize_counts(xt, dtype),
            "max_pool2d_bwd.launches": 1, f"max_pool2d_bwd.{pool}": 1}.items()}
        check(counts == want, f"{tag} training: launches {counts}, "
              f"expected {want}")
        add_up(total, counts)
        loss = torch.stack(losses).float().cpu()
        check(bool(torch.isfinite(loss).all()), f"{tag}: losses {loss}")
        lines.append(f"{tag}: one forward {per_fwd}, as the plain "
                     f"AlexNet's; {shapes} conv shapes at {worst:.3f} of "
                     f"their bar; bucket {B} graph {graphed:.4f} ms, logits "
                     f"bit-equal to the plain AlexNet's; {MOE_STEPS} steps "
                     f"at batch {TRAIN_B}, losses "
                     f"{[round(v, 4) for v in loss.tolist()]}")
    lines.append(f"({smi})")
    return total, lines


def remat_phase(smi: str) -> list:
    """One training step (``accumulate_grads``) of AlexNet (BN, Dropout
    0.25) and of MoECNN (balance 0.01) at the training batch in float32,
    with ``remat`` False and True from the same weights, batch and
    generator, cuDNN deterministic: the loss, every gradient, the new
    state and the generator bit-equal; the peak device memory of each."""
    rng = np.random.default_rng(24)
    x = uint8_normalize(torch.from_numpy(synthetic_images(rng, TRAIN_B))
                        .cuda())
    y = torch.arange(TRAIN_B, device="cuda") % 3
    kinds = {"alexnet": dict(dropout=0.25),
             "moecnn": dict(balance_coeff=MOE_BALANCE)}
    lines = []
    for name, kw in kinds.items():
        runs, peak = {}, {}
        for remat in (False, True):
            model = get_model(name, num_classes=3, batch_norm=True,
                              image_size=224, device="cuda",
                              generator=torch.Generator().manual_seed(24),
                              **kw)
            ts = create_train_state(model, sgd(0.1), seed=24)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                            deterministic=True,
                                            allow_tf32=False):
                grads, loss, _ = accumulate_grads(ts, x, y, remat=remat)
            torch.cuda.synchronize()
            peak[remat] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
            runs[remat] = (loss, grads, {k: v.clone() for k, v in
                                         named_state(model).items()},
                           ts.rng.get_state())
            del model, ts, grads
        (l0, g0, s0, r0), (l1, g1, s1, r1) = runs[False], runs[True]
        check(bits_equal(l0, l1) and sorted(g0) == sorted(g1)
              and all(bits_equal(g0[k], g1[k]) for k in g0)
              and all(bits_equal(s0[k], s1[k]) for k in s0)
              and torch.equal(r0, r1), f"{name}: remat=True differs from "
              "remat=False")
        lines.append(f"{name} (batch {TRAIN_B}, float32): gradients, loss, "
                     f"state and generator bit-equal; peak device memory "
                     f"above the weights remat False {peak[False]:.1f} MiB, "
                     f"True {peak[True]:.1f} MiB")
    return [f"remat ({smi}): " + "; ".join(lines)]


def phase20(smi: str, tmp: Path, cli: dict, gen) -> tuple[dict, dict,
                                                          list]:
    """Phase 20: MoECNN served, trained and through the CLIs; AlexNet's
    s2d convs; Grad-CAM at the families and in a trunk; whole-model
    remat. Returns every counted run's launches, added up, MoECNN's runs'
    alone, and the kernel rows of MoECNN's 64 -> 64 stride-2 conv."""
    total, lines, rows = {}, [], []
    counts, ln = moecnn_serving(smi)
    moe = dict(counts)
    lines += [f"MoECNN serving, {x}" for x in ln]
    counts, ln, step_ms = moecnn_training(smi)
    add_up(moe, counts)
    lines += [f"MoECNN training, {x}" for x in ln]
    counts, ln = moecnn_cli(smi, tmp, cli)
    add_up(moe, counts)
    lines += ln
    add_up(total, moe)
    counts, ln = s2d_phase(smi)
    add_up(total, counts)
    lines += [f"space-to-depth, {x}" for x in ln]
    counts, ln = gradcam_families(smi, tmp)
    add_up(total, counts)
    lines += ln
    lines += remat_phase(smi)
    # MoECNN's 64 -> 64 stride-2 convs at 112, 56 and 28: its padded
    # launches off the strip
    c = {k.split(".")[1]: v for k, v in moe.items()
         if k.startswith("conv2d_bias_relu.")}
    launches = {"": c.get("launches_padded", 0)
                - c.get("launches_bf16_padded", 0)
                - c.get("launches_strip_padded", 0),
                "_bf16": c.get("launches_bf16_padded", 0)
                - c.get("launches_bf16_strip_padded", 0)}
    for key, shape in MOE_ROWS.items():
        for dtype, sfx in ((None, ""), (BF16, "_bf16")):
            err, ms, plain, lib, bound, alone, lib_alone = family_row(
                shape, dtype, gen)
            name = f"conv2d_bias_relu_{key}{sfx}"
            rows.append(entry(name, launches[sfx], err, ms, plain, lib,
                              bound))
            lines.append(f"{name} {shape}: {ms:.4f} ms (plain {plain:.4f}, "
                         f"cuDNN {lib:.4f}, bound {bound[0]:.4f} by "
                         f"{bound[1]}), alone {alone:.4f} (cuDNN + ReLU "
                         f"alone {lib_alone:.4f}), max|dev| {err:.3g}, "
                         f"{launches[sfx]} launches")
    for row in rows:
        check(row["launches"] > 0, f"{row['name']}: no launch in phase 20's "
              "counted runs")
    for line in lines:
        phase(f"phase 20: {line}")
    phase(f"phase 20 ({smi}): MoECNN step ms {step_ms}")
    return total, moe, rows


# ------------------------------------------------------------- phase 21 ----

SERVING_FIXTURE = ROOT / "tests" / "fixtures" / "serving_logits.npz"
SERVE_MODELS = ("alexnet", "resnet10", "mobilenet", "pipecnn", "moecnn")
# int8 probabilities against the fixture's (cnn_tpu's int8 on the photos),
# absolute: each side calibrates from its own float32 activations, whose
# absmaxes can sit an ulp apart and flip a level (the CPU tests measured
# 1.24e-4 at most, PipeCNN's trunk)
INT8_PROB_TOL = 1e-2
# int8 against float32 probabilities: cnn_tpu's task bar, where cnn_tpu
# itself meets it on the photos; its own int8 MoECNN lies 0.2347 from its
# float32 (the fixture), so a model's bar is the larger of 0.1 and the
# fixture's own gap plus INT8_PROB_TOL, with float32's classes
INT8_TASK_TOL = 0.1
ARTIFACT_TOL = 1e-6      # the bar of an artifact that is not bit-equal
INT8_OP_PER_S = 1979e12  # dense int8 tensor-core peak of the H100 SXM
STREAM_N, STREAM_DEPTH = 64, 8
TCP_CLIENTS = 4
CATEGORIES = ["dog", "panda", "bird"]


def serving_model(name: str, fixture) -> torch.nn.Module:
    """``name`` at 224 px on the card in eval mode, from the fixture's
    checkpoint (AlexNet: the committed BN ``.model``)."""
    model = get_model(name, num_classes=3, image_size=224, batch_norm=True,
                      device="cuda")
    path = ROOT / str(fixture[f"{name}_checkpoint"])
    if name == "alexnet":
        load_reference_model(model, path)
    else:
        payload = read_checkpoint(str(path))
        load_jax_params(model, payload["params"], payload["state"])
    return model.eval()


def relu_pairs(layers) -> int:
    """Conv2D -> ReLU pairs of a layer list, a trunk's n_blocks times over,
    residual bodies included: the fused launches of one forward."""
    n = 0
    for i, layer in enumerate(layers):
        if isinstance(layer, StackedBlocks):
            n += layer.n_blocks * relu_pairs(list(layer.block.body))
        elif isinstance(layer, nn_module.ResidualBlock):
            n += relu_pairs(list(layer.body))
        elif (isinstance(layer, Conv2D) and i + 1 < len(layers)
              and isinstance(layers[i + 1], ReLU)):
            n += 1
    return n


def bn_calls(model, folded, x) -> tuple[int, int, int]:
    """Forward hooks on ``model``'s BatchNorm2D modules and a count of the
    BN eval function: (hooked calls in an unfolded forward, hooked calls
    and BN evaluations in a folded forward)."""
    calls = []
    hooks = [m.register_forward_hook(lambda *a: calls.append(1))
             for m in model.modules()
             if isinstance(m, nn_module.BatchNorm2D)]
    real = nn_module.batch_norm2d_eval
    evals = []

    def counting(*args):
        evals.append(1)
        return real(*args)
    try:
        with torch.no_grad():
            model(x)
            unfolded = len(calls)
            calls.clear()
            with mock.patch.object(nn_module, "batch_norm2d_eval", counting):
                folded(x)
    finally:
        for h in hooks:
            h.remove()
    return unfolded, len(calls), len(evals)


def relu_flags(model, dtype) -> list:
    """The ``relu`` flag of each conv launch of one eager forward."""
    flags = []
    real = nn_module.conv2d_bias_relu

    def rec(x, w, b, stride, relu, padding=0):
        flags.append(relu)
        return real(x, w, b, stride, relu, padding)
    with mock.patch.object(nn_module, "conv2d_bias_relu", rec), \
            torch.no_grad():
        model(torch.zeros((2, 224, 224, 3), device="cuda"),
              compute_dtype=dtype)
    return flags


def replays_match_eager(engine, rng, tag: str) -> None:
    """Each bucket's replay bit-equal to the eager forward."""
    for b in engine.buckets:
        chunk = synthetic_images(rng, b)
        labels, probs = engine.predict(chunk)
        with torch.no_grad():
            ep, el = engine._forward(torch.from_numpy(chunk).cuda())
        check(same_arrays(labels, el.int().cpu().numpy())
              and same_arrays(probs, ep.cpu().numpy()),
              f"{tag} bucket {b}: the replay differs from the eager forward")


def folded_serving(name, model, fixture, rng, photos, imgs64) -> tuple:
    """The folded model (float32, bf16) behind ``InferenceEngine`` through
    ``serve_family`` (one conv launch per folded conv, the photos' logits
    against ``serving_logits.npz``), no BN call, one fused launch per
    conv -> ReLU pair, and its bucket-64 graph and eager forward timed in
    turns with the unfolded model's. Returns the counts, the float32
    folded engine, the photos' float32 probabilities and the log lines."""
    folded = fold_batchnorm(model)
    check(not any(isinstance(m, nn_module.BatchNorm2D)
                  for m in folded.modules()), f"{name}: a BN survived")
    x6 = torch.from_numpy(photos).cuda()
    unfolded_bn, folded_bn, bn_evals = bn_calls(model, folded,
                                                uint8_normalize(x6))
    check(unfolded_bn > 0 and folded_bn == 0 and bn_evals == 0,
          f"{name}: BN forwards unfolded {unfolded_bn}, folded {folded_bn} "
          f"(BN evaluations {bn_evals})")
    ref = torch.from_numpy(fixture[f"{name}_folded_logits"]).cuda()
    stems = 0 if name == "alexnet" else 1
    total, lines, keep, f32_probs = {}, [], None, None
    xb = torch.from_numpy(imgs64).cuda()
    for dtype in (None, BF16):
        tag = f"{name} folded {'bf16' if dtype else 'float32'}"
        flags = relu_flags(folded, dtype)
        check(len(flags) == n_convs(folded)
              and sum(flags) == relu_pairs(list(folded.net)),
              f"{tag}: {sum(flags)} fused of {len(flags)} conv launches; "
              f"{relu_pairs(list(folded.net))} conv -> ReLU pairs")
        bar = LOGIT_ATOL if dtype is None else BF16_MODEL_TOL
        counts, logits, engine, line = serve_family(
            f"{name} folded", folded, dtype, rng, photos, imgs64,
            (ref, "serving_logits.npz", bar), stems=stems)
        add_up(total, counts)
        unf = serving.InferenceEngine(model, buckets=(64,), device="cuda",
                                      compute_dtype=dtype)
        unf.warmup()
        with torch.no_grad():
            g_fold, g_unf = in_turns(engine._ready[64].graph.replay,
                                     unf._ready[64].graph.replay, 10)
            e_fold, e_unf = in_turns(lambda: engine._forward(xb),
                                     lambda: unf._forward(xb), 10)
        lines.append(f"{line}; {sum(flags)} of {len(flags)} conv launches "
                     f"fused; bucket 64 in turns: graph {g_fold:.4f} ms "
                     f"folded / {g_unf:.4f} unfolded, eager {e_fold:.4f} / "
                     f"{e_unf:.4f}")
        del unf
        if dtype is None:
            keep, f32_probs = engine, torch.softmax(logits, -1)
        else:
            del engine
        torch.cuda.empty_cache()
    return total, keep, f32_probs, lines


def int8_serving(name, model, fixture, rng, photos, imgs64, f32_engine,
                 f32_probs) -> tuple:
    """``InferenceEngine(int8_calib=photos)``: one forward launches the
    normalize kernel and the float32 pools and no conv kernel; every
    ``_int_mm`` accumulator equal to a float64 product (exact at these
    magnitudes) and every depthwise one to the CPU's; the photos'
    probabilities (one batch of 6) within 1e-2 of the fixture's with its
    classes and within 0.1 of float32's; replays bit-equal to the eager
    forward; exact launches over a counted predict; the bucket-64 graph
    in turns with the float32 folded one, and each ``_int_mm`` call of a
    bucket-64 forward alone. Returns the counts, the engine, the log line
    and the per-layer product rows."""
    tag = f"{name} int8"
    t = time.perf_counter()
    engine = serving.InferenceEngine(model, buckets=BUCKETS, device="cuda",
                                     int8_calib=photos)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t
    x6 = torch.from_numpy(photos).cuda()
    pools = sum(isinstance(m, nn_module.MaxPool2D) for m in model.modules())
    want1 = {"uint8_normalize.launches": 1, "uint8_normalize.launches_wide": 1}
    if pools:
        want1["max_pool2d_fwd.launches"] = pools
        want1["max_pool2d_fwd.launches_window"] = pools
    mm, dw = [], []
    real_mm, real_dw = torch._int_mm, quant._depthwise_s32

    def rec_mm(a, b):
        out = real_mm(a, b)
        mm.append((a, b, out))
        return out

    def rec_dw(qx, w, stride, padding):
        out = real_dw(qx, w, stride, padding)
        dw.append((qx, w, stride, padding, out))
        return out

    with mock.patch.object(torch, "_int_mm", rec_mm), \
            mock.patch.object(quant, "_depthwise_s32", rec_dw), \
            torch.no_grad():
        (probs6, _), c = counted(lambda: engine._forward(x6))
    check(c == want1, f"{tag}: one forward launched {c}, expected {want1}")
    check(len(mm) == n_convs(engine.model.folded) + 1,
          f"{tag}: {len(mm)} int8 products for "
          f"{n_convs(engine.model.folded)} convs and the head")
    for a, b, out in mm:
        check(a.dtype == b.dtype == torch.int8 and out.dtype == torch.int32
              and torch.equal(out.double(), a.double() @ b.double()),
              f"{tag}: _int_mm {tuple(a.shape)} x {tuple(b.shape)} is not "
              "the exact product")
    for qx, w, stride, padding, out in dw:
        check(torch.equal(out.cpu(), real_dw(qx.cpu(), w.cpu(), stride,
                                              padding)),
              f"{tag}: depthwise {tuple(qx.shape)} differs from the CPU's")
    want = torch.from_numpy(fixture[f"{name}_int8_probs"]).cuda()
    dev_fx = (probs6 - want).abs().max().item()
    dev_f32 = (probs6 - f32_probs).abs().max().item()
    check(dev_fx <= INT8_PROB_TOL and torch.equal(probs6.argmax(-1),
                                                  want.argmax(-1)),
          f"{tag}: probabilities {dev_fx:.3g} from the fixture, classes "
          f"{probs6.argmax(-1).tolist()} against {want.argmax(-1).tolist()}")
    ref_logits = torch.from_numpy(fixture[f"{name}_folded_logits"]).cuda()
    task = max(INT8_TASK_TOL, (want - torch.softmax(ref_logits, -1)).abs()
               .max().item() + INT8_PROB_TOL)
    check(dev_f32 <= task and torch.equal(probs6.argmax(-1),
                                          f32_probs.argmax(-1)),
          f"{tag}: {dev_f32:.3g} from float32 (bar {task:.3g}), classes "
          f"{probs6.argmax(-1).tolist()} against "
          f"{f32_probs.argmax(-1).tolist()}")
    engine.warmup()
    for b in BUCKETS:
        check(engine._ready[b].launches == want1, f"{tag} bucket {b}'s "
              f"capture recorded {engine._ready[b].launches}")
    replays_match_eager(engine, rng, tag)
    torch.cuda.synchronize()
    reset_launches()
    engine.predict(photos)
    engine.predict(imgs64)
    torch.cuda.synchronize()
    counts = {k: v for k, v in read_counters().items() if v}
    check(counts == {k: 2 * v for k, v in want1.items()},
          f"{tag}: predict launches {counts}")
    xb = torch.from_numpy(imgs64).cuda()
    with torch.no_grad():
        g_int8, g_f32 = in_turns(engine._ready[64].graph.replay,
                                 f32_engine._ready[64].graph.replay, 10)
        mm.clear()
        with mock.patch.object(torch, "_int_mm", rec_mm):
            engine._forward(xb)
    rows = []
    for a, b, out in mm:
        ms = graph_ms(lambda a=a, b=b: torch._int_mm(a, b))
        ops = 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
        bound = bound_ms(nbytes(a, b, out), ops, INT8_OP_PER_S)
        rows.append((tuple(a.shape), b.shape[1], ms, bound))
    mm_ms = sum(r[2] for r in rows)
    line = (f"{tag}: quantized in {quant_s:.2f} s; probabilities "
            f"{dev_fx:.3g} from the fixture, {dev_f32:.3g} from float32 "
            f"(bar {task:.3g}); "
            f"classes {probs6.argmax(-1).tolist()}; {len(rows)} exact int8 "
            f"products a forward ({len(dw)} depthwise); bucket 64 graph "
            f"{g_int8:.4f} ms int8 / {g_f32:.4f} float32 folded (in turns), "
            f"the _int_mm calls alone {mm_ms:.4f} ms")
    return counts, engine, line, rows


def stream_check(engine, imgs, tag: str) -> tuple[dict, str]:
    """``predict_stream`` over ``imgs`` at depth 8 against ``predict`` of
    each image alone, bit for bit and in order; one replay of bucket 1's
    graph per image."""
    want = [engine.predict(img[None]) for img in imgs]
    t = time.perf_counter()
    got, counts = counted(lambda: list(engine.predict_stream(
        iter(imgs), depth=STREAM_DEPTH)))
    stream_s = time.perf_counter() - t
    check(len(got) == len(imgs) and all(
        label == int(wl[0]) and same_arrays(probs, wp[0])
        for (label, probs), (wl, wp) in zip(got, want)),
        f"{tag}: the stream differs from predict")
    per = engine._ready[engine.buckets[0]].launches
    check(counts == {k: len(imgs) * v for k, v in per.items()},
          f"{tag}: stream launches {counts}")
    t = time.perf_counter()
    for img in imgs:
        engine.predict(img[None])
    seq_s = time.perf_counter() - t
    return counts, (f"{tag}: {len(imgs)} streamed at depth {STREAM_DEPTH} "
                    f"bit-equal to predict, in order; "
                    f"{len(imgs) / stream_s:.1f} img/s streamed, "
                    f"{len(imgs) / seq_s:.1f} one predict at a time")


def artifact_checks(model, photos, imgs64, tmp: Path, engines: dict,
                    rng) -> tuple[dict, list]:
    """Float32 and bf16 artifacts of the folded AlexNet and an int8 one
    (calibrated on the photos), exported on the card, loaded, served by
    ``from_artifact``: each bucket's graph launches what the source
    engine's does, and the predictions equal the source engine's bit for
    bit (or, where not, within 1e-6, with the reason printed)."""
    total, lines = {}, []
    folded = fold_batchnorm(model)
    kinds = {"float32": (folded, None, None), "bf16": (folded, BF16, None),
             "int8": (model, None, photos)}
    for kind, (src, dtype, calib) in kinds.items():
        path = tmp / f"alexnet_{kind}.ctsa"
        t = time.perf_counter()
        meta = export_serving_artifact(src, str(path), compute_dtype=dtype,
                                       int8_calib=calib,
                                       class_names=CATEGORIES)
        export_s = time.perf_counter() - t
        t = time.perf_counter()
        art = ServingArtifact.load(str(path))
        load_s = time.perf_counter() - t
        check(meta["int8"] == (calib is not None)
              and art.device.type == "cuda", f"artifact {kind}: {meta}")
        eng = serving.InferenceEngine.from_artifact(art, buckets=BUCKETS)
        eng.warmup()
        source = engines[kind]
        for b in BUCKETS:
            check(eng._ready[b].launches == source._ready[b].launches,
                  f"artifact {kind} bucket {b}: its graph launches "
                  f"{eng._ready[b].launches}, the engine's "
                  f"{source._ready[b].launches}")
        replays_match_eager(eng, rng, f"artifact {kind}")
        (got, counts) = counted(lambda: (eng.predict(photos),
                                         eng.predict(imgs64)))
        add_up(total, counts)
        want = (source.predict(photos), source.predict(imgs64))
        exact = all(same_arrays(g, w) for gw in zip(got, want)
                    for g, w in zip(*gw))
        note = "bit-equal to its engine"
        if not exact:
            dev_ = max(float(np.abs(g[1] - w[1]).max())
                       for g, w in zip(got, want))
            labels_ok = all(np.array_equal(g[0], w[0])
                            for g, w in zip(got, want))
            note = (f"NOT bit-equal to its engine: probabilities {dev_:.3g} "
                    f"apart (the exported program runs its aten ops, not "
                    f"the eager layers' calls), held to {ARTIFACT_TOL}")
            check(labels_ok and dev_ <= ARTIFACT_TOL, f"artifact {kind}: "
                  + note)
        lines.append(f"{kind}: {path.stat().st_size / 1e6:.3f} MB, exported "
                     f"in {export_s:.2f} s, loaded in {load_s:.2f} s, "
                     f"{note}")
        del eng, art
        torch.cuda.empty_cache()
    return total, lines


def ppm_bytes(img: np.ndarray) -> bytes:
    h, w, _ = img.shape
    return (f"P6\n{w} {h}\n255\n".encode()
            + np.ascontiguousarray(img[:, :, ::-1]).tobytes())


def tcp_reply(conn) -> str:
    head = b""
    while len(head) < 4:
        chunk = conn.recv(4 - len(head))
        check(bool(chunk), "tcp: the server closed mid-reply")
        head += chunk
    (n,) = struct.unpack(">I", head)
    body = b""
    while len(body) < n:
        body += conn.recv(n - len(body))
    return body.decode()


def tcp_check(engine, photos) -> tuple[dict, str]:
    """``serve_tcp`` on port 0 in a thread: four concurrent clients send
    the six photos as PPM frames, then an undecodable frame and an
    oversized length; the replies equal ``predict``'s lines, then
    ``ERROR\\tundecodable`` and ``ERROR\\tframe too large``, and the server
    hangs up. The server batches whatever requests are waiting, so a
    photo is served in bucket 1 or 8 as the clients' timing falls; its
    reply must equal ``predict``'s line through one of them (the linear
    layer's product sums in another order at another batch, which can
    move the sixth decimal)."""
    def lines(labels, probs):
        return [f"{CATEGORIES[l]}\t{p[l]:.6f}" for l, p in zip(labels, probs)]
    want = lines(*engine.predict(photos))
    alone = [lines(*engine.predict(img[None]))[0] for img in photos]
    ready, stop, port = threading.Event(), threading.Event(), []
    torch.cuda.synchronize()
    reset_launches()
    server = threading.Thread(target=serve_cli.serve_tcp, args=(
        engine, 0, 224, CATEGORIES, 64, 2.0), kwargs=dict(
        ready_event=ready, stop_event=stop, port_out=port), daemon=True)
    quiet = redirect_stdout(io.StringIO())    # its "serving on" line
    quiet.__enter__()
    server.start()
    check(ready.wait(60), "tcp: the server did not start")

    def client(_):
        with socket.create_connection(("127.0.0.1", port[0]),
                                      timeout=60) as conn:
            out = []
            for img in photos:
                payload = ppm_bytes(img)
                conn.sendall(struct.pack(">I", len(payload)) + payload)
                out.append(tcp_reply(conn))
            conn.sendall(struct.pack(">I", 12) + b"not an image")
            out.append(tcp_reply(conn))
            conn.sendall(struct.pack(">I", serve_cli.MAX_FRAME_BYTES + 1))
            out.append(tcp_reply(conn))
            out.append(conn.recv(1))
            return out

    t = time.perf_counter()
    try:
        with ThreadPoolExecutor(TCP_CLIENTS) as pool:
            results = list(pool.map(client, range(TCP_CLIENTS)))
    finally:
        stop.set()
        server.join(30)
        quiet.__exit__(None, None, None)
    tcp_s = time.perf_counter() - t
    torch.cuda.synchronize()
    counts = {k: v for k, v in read_counters().items() if v}
    check(not server.is_alive(), "tcp: the server did not stop")
    for out in results:
        check(all(o in (w, a) for o, w, a in zip(out, want, alone))
              and out[len(want):] == ["ERROR\tundecodable",
                                      "ERROR\tframe too large", b""],
              f"tcp: replies {out}, expected {want} (bucket 8) or {alone} "
              "(bucket 1)")
    no_fallback(counts, "tcp")
    return counts, (f"TCP: {TCP_CLIENTS} clients x 6 photos (PPM frames) "
                    f"in {tcp_s:.3f} s, replies equal to predict's lines, "
                    "the undecodable and oversized frames answered "
                    f"ERROR; {counts.get('uint8_normalize.launches', 0)} "
                    "bucket calls")


def cli_run(what: str, main, argv, stdin: str | None = None,
            **patches) -> tuple[str, dict, float]:
    """One in-process CLI run with the counters at 0 just before: exit code
    0, no fallback conv; returns its output, counts and wall seconds."""
    torch.cuda.synchronize()
    reset_launches()
    out = io.StringIO()
    t = time.perf_counter()
    with ExitStack() as stack:
        stack.enter_context(redirect_stdout(out))
        if stdin is not None:
            stack.enter_context(mock.patch.object(sys, "stdin",
                                                  io.StringIO(stdin)))
        for target, value in patches.items():
            stack.enter_context(mock.patch.dict(sys.modules,
                                                {target: value}))
        try:
            rc = main(argv)
        except BaseException:
            print(f"{what}: raised; its output ends "
                  f"{out.getvalue()[-2000:]!r}", file=sys.stderr)
            raise
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    counts = {k: v for k, v in read_counters().items() if v}
    check(rc == 0, f"{what}: exit code {rc}")
    no_fallback(counts, what)
    return out.getvalue(), counts, seconds


def served_rows(text: str) -> list:
    return [tuple(line.split("\t")) for line in text.splitlines()
            if line.count("\t") == 2]


def check_served(text: str, paths, labels, probs, what: str) -> None:
    """The serve CLI's lines: each path with the engine's class and its
    probability within 1e-6 (printed to 6 places)."""
    rows = served_rows(text)
    check([r[0] for r in rows] == list(paths), f"{what}: printed {rows}")
    for (_, cat, p), label, pr in zip(rows, labels, probs):
        check(cat == CATEGORIES[label]
              and abs(float(p) - float(pr[label])) <= INFER_PROB_ATOL,
              f"{what}: {cat} {p} against {CATEGORIES[label]} "
              f"{pr[label]:.6f}")


def cli_checks(photos, tmp: Path, engines: dict) -> tuple:
    """The serve CLI in stdin, ``--stream``, ``--int8`` and ``--artifact``
    modes, then export_artifact, convert (a round trip whose ``.model``
    bytes are the original's), plot (the ASCII branch) and make_gif (on
    phase 15's Grad-CAM PNGs). Returns the counts and the log line."""
    total, parts = {}, []
    root = tmp / "p21"
    root.mkdir(exist_ok=True)
    paths = []
    for i, img in enumerate(photos):
        paths.append(str(root / f"{i}.ppm"))
        Path(paths[-1]).write_bytes(ppm_bytes(img))
    stdin = "\n".join(paths) + "\n"
    base = ["--checkpoint", str(MODEL), "--batch-norm"]
    f32 = engines["unfolded"].predict(photos)
    single = [engines["unfolded"].predict(img[None]) for img in photos]
    single = (np.concatenate([s[0] for s in single]),
              np.concatenate([s[1] for s in single]))
    int8 = engines["int8"].predict(photos)
    runs = {"serve": (base, f32), "serve --stream": (base + ["--stream"],
                                                     single),
            "serve --int8": (base + ["--int8"], int8)}
    for what, (argv, (labels, probs)) in runs.items():
        text, counts, s = cli_run(what, serve_cli.main, argv, stdin)
        check_served(text, paths, labels, probs, what)
        add_up(total, counts)
        parts.append(f"{what} {s:.2f} s")
    art = str(root / "alexnet.ctsa")
    text, counts, s = cli_run("export_artifact", export_artifact_cli.main,
                              [str(MODEL), art, "--batch-norm", "true"])
    check(text.startswith(f"exported {MODEL} -> {art} (")
          and "platforms=['cuda', 'cpu'], int8=False)" in text,
          f"export_artifact printed {text!r}")
    add_up(total, counts)
    parts.append(f"export_artifact {s:.2f} s "
                 f"({Path(art).stat().st_size / 1e6:.2f} MB)")
    text, counts, s = cli_run("serve --artifact", serve_cli.main,
                              ["--artifact", art], stdin)
    check_served(text, paths, *f32, "serve --artifact")
    add_up(total, counts)
    parts.append(f"serve --artifact {s:.2f} s")
    ck, back = str(root / "a.ckpt"), str(root / "a.model")
    _, counts, s1 = cli_run("convert .model", convert_cli.main,
                            [str(MODEL), ck, "--batch-norm", "true"])
    _, counts, s2 = cli_run("convert .ckpt", convert_cli.main,
                            [ck, back, "--batch-norm", "true"])
    check(Path(back).read_bytes() == MODEL.read_bytes(),
          "convert: the round trip's .model differs from the original")
    parts.append(f"convert round trip {s1 + s2:.2f} s (.model bytes equal)")
    history_file = MODEL.parent / "history.jsonl"
    text, _, s = cli_run("plot", plot_cli.main, [str(history_file)],
                         matplotlib=None)
    check("--- loss ---" in text and "max " in text and "*" in text,
          f"plot printed {text[:300]!r}")
    parts.append(f"plot (ASCII) {s:.2f} s")
    frames = tmp / "cam_conv_layer_3_gradcam"
    if not frames.is_dir():      # phase 15 did not run: the photos as PNG
        frames = root / "frames"
        frames.mkdir()
        for i, img in enumerate(photos):
            imwrite(str(frames / f"{i}.png"), img)
    gif = str(root / "cams.gif")
    text, _, s = cli_run("make_gif", make_gif_cli.main, [str(frames), gif])
    from PIL import Image
    pngs = sorted(frames.glob("*.png"))
    first = imread(str(pngs[0]))
    with Image.open(gif) as im:
        n_frames, size = im.n_frames, im.size
    check(n_frames == len(pngs) and size == (first.shape[1], first.shape[0]),
          f"make_gif: {n_frames} frames of {size}, from {len(pngs)} PNGs of "
          f"{first.shape}")
    parts.append(f"make_gif {s:.2f} s ({n_frames} frames of {frames.name})")
    return total, "CLIs: " + "; ".join(parts)


def phase21(smi: str, tmp: Path) -> tuple[dict, dict, dict]:
    """Phase 21: BN folding, int8 serving, streaming, artifacts, the TCP
    server and the leftover CLIs. Returns the launches of every counted
    run, added up, those of AlexNet's runs alone, and the families' conv
    counters (MoECNN's stem only) with their stem strips keyed by
    family."""
    fixture = np.load(SERVING_FIXTURE)
    rng = np.random.default_rng(21)
    photos = family_photos()
    imgs64 = synthetic_images(rng, 64)
    total, alex, fam, lines, mm_lines = {}, {}, {}, [], []
    engines = {}
    for name in SERVE_MODELS:
        model = serving_model(name, fixture)
        counts, f32_engine, f32_probs, ln = folded_serving(
            name, model, fixture, rng, photos, imgs64)
        lines += ln
        c8, int8_engine, ln8, rows = int8_serving(
            name, model, fixture, rng, photos, imgs64, f32_engine, f32_probs)
        add_up(counts, c8)
        lines.append(ln8)
        mm_lines.append(f"{name}: " + ", ".join(
            f"{m}x{k}x{n} {ms:.4f} ms (bound {bd[0]:.4f} by {bd[1]})"
            for (m, k), n, ms, bd in rows))
        for line in lines:
            phase(f"phase 21 ({smi}): {line}")
        lines.clear()
        if name == "alexnet":
            add_up(alex, counts)
            engines.update(float32=f32_engine, int8=int8_engine)
        else:
            add_up(total, counts)
            # MoECNN's convs other than its stem have rows of their own
            if name != "moecnn":
                add_up(fam, {k: v for k, v in counts.items()
                             if k.startswith("conv2d_bias_relu.")})
            add_up(fam, stem_counts(name, counts))
            del f32_engine, int8_engine
        torch.cuda.empty_cache()
    alexnet = serving_model("alexnet", fixture)
    engines["bf16"] = serving.InferenceEngine(
        fold_batchnorm(alexnet), buckets=BUCKETS, device="cuda",
        compute_dtype=BF16)
    engines["unfolded"] = serving.InferenceEngine(alexnet, buckets=BUCKETS,
                                                  device="cuda")
    engines["bf16"].warmup()
    engines["unfolded"].warmup()
    for kind in ("float32", "int8"):
        counts, line = stream_check(engines[kind], imgs64[:STREAM_N],
                                    f"AlexNet {kind} stream")
        add_up(alex, counts)
        phase(f"phase 21 ({smi}): {line}")
    counts, art_lines = artifact_checks(alexnet, photos, imgs64, tmp,
                                        engines, rng)
    add_up(alex, counts)
    phase(f"phase 21 ({smi}): artifacts: " + "; ".join(art_lines))
    counts, line = tcp_check(engines["float32"], photos)
    add_up(alex, counts)
    phase(f"phase 21 ({smi}): {line}")
    counts, line = cli_checks(photos, tmp, engines)
    add_up(alex, counts)
    phase(f"phase 21 ({smi}): {line}")
    add_up(total, alex)
    for line in mm_lines:
        phase(f"phase 21: int8 products alone at bucket 64 ({smi}), "
              f"M x K x N: {line}")
    phase(f"phase 21 ({smi}): five models folded (float32 within 1e-4 x "
          "max(1, max|ref|) of serving_logits.npz, bf16 within 5e-2) and "
          "int8 (probabilities within 1e-2 of the fixture, 0.1 of float32), "
          "streaming, artifacts, TCP and the CLIs")
    del engines
    torch.cuda.empty_cache()
    return total, alex, fam


# ---------------------------------------------------------------------------
# phase 22: the host augmentation, --compile-cache, and each device-dataset
# call as one CUDA graph
# ---------------------------------------------------------------------------

HOST_AUG_FIXTURE = ROOT / "tests" / "fixtures" / "host_augment.npz"
GRAPH_N = 200          # canvases of the graph cases (batches straddle epochs)
GRAPH_B = B            # the batch of the bit-equality cases
GRAPH_K = 4            # steps a call
GRAPH_CALLS = 4        # the eager first call, the capture's, two replays
P22_ITERS = 20         # iterations of each CLI run
P22_B = B              # their batch
# the train CLI's main in a fresh process, its kernel counters printed last
CHILD = ("import json, sys\n"
         "from cnn_tpu_torch.ops.hopper import read_counters\n"
         "from cnn_tpu_torch.tools import train\n"
         "rc = train.main(sys.argv[1:])\n"
         "print('child launches: ' + json.dumps("
         "{k: v for k, v in read_counters().items() if v}))\n"
         "sys.exit(rc)\n")
# case -> (model, its kwargs, compute dtype, make_device_train_step's
# options, the optimizer's): phase 19's options, the sample modes,
# MoECNN's balance loss and PipeCNN's block remat
GRAPH_CASES = {
    "flagship float32": ("alexnet", {}, None, {}, {}),
    "flagship bf16": ("alexnet", {}, BF16, {}, {}),
    "dropout 0.25": ("alexnet", {"dropout": DROPOUT_P}, BF16, {}, {}),
    "grad-accum 4": ("alexnet", {}, BF16, {"grad_accum": 4}, {}),
    "sample global": ("alexnet", {}, BF16, {"sample_mode": "global"}, {}),
    "sample epoch": ("alexnet", {}, BF16, {"sample_mode": "epoch"}, {}),
    "sample epoch_fixed": ("alexnet", {}, BF16,
                           {"sample_mode": "epoch_fixed"}, {}),
    "adamw+clip+ema+mixup+cutmix+jitter": (
        "alexnet", {}, BF16, {"mixup": 0.2, "cutmix": 1.0, "jitter": 0.2},
        {"name": "adam", "lr": 1e-3, "weight_decay": 1e-4, "clip": 1.0,
         "ema": 0.999}),
    "distilled from resnet10": ("alexnet", {}, BF16, {"teacher": True}, {}),
    "resnet10, stem frozen": ("resnet10", {}, BF16, {}, {"freeze": "stem"}),
    "moecnn, balance 0.01": ("moecnn", {"balance_coeff": MOE_BALANCE}, BF16,
                             {}, {}),
    "pipecnn, remat conv": ("pipecnn", {"remat": "conv"}, BF16, {}, {}),
}


def fixture_phase() -> str:
    """The port's ``ImageAugmentor`` on the fixture's images and
    generators against cnn_tpu's outputs stored there (bit-equal: the
    file was written where cv2 runs the build the warp follows)."""
    sys.path.insert(0, str(ROOT / "tests" / "fixtures"))
    try:
        import make_host_augment as mk
    finally:
        sys.path.pop(0)
    fx = np.load(HOST_AUG_FIXTURE)
    imgs = [fx[f"img{i}"] for i in range(len(mk.SHAPES))]
    ours = mk.augmented(ImageAugmentor(), imgs)
    check(sorted(ours) == sorted(fx.files), f"fixture keys {fx.files}")
    bad = [k for k, v in ours.items() if not same_arrays(v, fx[k])]
    check(not bad, f"host augmentation differs from the fixture at {bad}")
    rotated = sum(ours[k].shape != fx[k.replace("out", "img")
                                      .split("_")[0]].shape
                  for k in ours if k.startswith("out"))
    return (f"ImageAugmentor bit-equal to cnn_tpu's (cv2) on "
            f"{len(ours) - len(imgs)} outputs of {len(imgs)} images "
            f"({rotated} resized by a crop or an expanding rotation), "
            f"numpy {np.__version__}")


def loader_seconds(samples, augment: bool, batches: int = 4) -> float:
    """Seconds per batch of the train CLI's host loader at its defaults
    (2 workers, prefetch 4, the decode cache) at ``P22_B``, after its
    first batch: decode (the cache fills over an epoch), augmentation,
    resize."""
    dl = DataLoader(samples, P22_B, augment=augment, image_size=224,
                    num_workers=2, prefetch=4, cache=True)
    try:
        dl.generate_batch()
        t = time.perf_counter()
        for _ in range(batches):
            images, _ = dl.generate_batch()
        secs = (time.perf_counter() - t) / batches
    finally:
        dl.close()
    check(images.shape == (P22_B, 224, 224, 3), f"loader {images.shape}")
    return secs


def graph_dataset() -> DeviceDataset:
    imgs, labels = synthetic_canvases(np.random.default_rng(22), GRAPH_N,
                                      CANVAS)
    return DeviceDataset.from_arrays(imgs, labels, device="cuda")


def graph_run(case: str, ds, eager: bool, batch: int = GRAPH_B,
              steps: int = GRAPH_K):
    """A fresh, seeded train state of ``case`` and its device step:
    ``(ts, step)``."""
    name, kwargs, dtype, opts, ospec = (GRAPH_CASES | P27_GRAPH_CASES)[case]
    model = get_model(name, num_classes=3, image_size=224, batch_norm=True,
                      device="cuda", generator=torch.Generator().manual_seed(
                          FAMILY_SEED), **kwargs)
    opt = make_optimizer(ospec.get("name", "momentum"),
                         ospec.get("lr", 1.5e-2), schedule="cosine",
                         total_steps=64,
                         weight_decay=ospec.get("weight_decay", 0.0),
                         grad_clip=ospec.get("clip", 0.0))
    if "freeze" in ospec:
        opt = with_frozen(opt, [ospec["freeze"]])
    if "ema" in ospec:
        opt = with_ema(opt, ospec["ema"])
    ts = create_train_state(model, opt, seed=7)
    adt = dtype or torch.float32
    jitter = opts.get("jitter", 0.0)

    augment = (aug.augment_batch_fast if opts.get("augment") == "fast"
               else aug.augment_batch)

    def augment_fn(gen, im):
        x = augment(gen, im, dtype=adt)
        return aug.color_jitter(gen, x, jitter) if jitter else x

    distill = None
    if opts.get("teacher"):
        teacher = get_model("resnet10", num_classes=3, image_size=224,
                            batch_norm=True, device="cuda",
                            generator=torch.Generator().manual_seed(4))
        distill = (teacher, 4.0, 0.5)
    step = make_device_train_step(
        model, opt, ds, batch, compute_dtype=dtype, augment_fn=augment_fn,
        sample_mode=opts.get("sample_mode", "local"), steps_per_call=steps,
        grad_accum=opts.get("grad_accum", 1), mixup=opts.get("mixup", 0.0),
        cutmix=opts.get("cutmix", 0.0), distill=distill, eager=eager)
    check(isinstance(step, GraphedSteps) != eager,
          f"{case}: eager={eager} gave {type(step).__name__}")
    return ts, step


def train_tensors(ts) -> dict:
    """Every tensor a train step changes, by name: the parameters, the
    model state, each leaf of the optimizer state (its counts among
    them)."""
    out = {f"param {k}": v for k, v in named_params(ts.model).items()}
    out.update({f"state {k}": v for k, v in named_state(ts.model).items()})

    def walk(tree, path):
        if isinstance(tree, torch.Tensor):
            out[f"opt {path}"] = tree
        elif isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], f"{path}/{k}")
        elif isinstance(tree, tuple):
            names = getattr(tree, "_fields", None) or range(len(tree))
            for k, v in zip(names, tree):
                walk(v, f"{path}/{k}")
    walk(ts.opt_state, "")
    return out


def graph_case(case: str, ds) -> tuple[dict, str]:
    """``GRAPH_CALLS`` calls of the eager loop and of the captured step
    from one seeded start, under cuDNN's deterministic mode: every tensor
    of ``train_tensors``, each call's metrics, the step, the generator's
    next draw and the kernel counters bit-equal. Returns the captured
    run's counters."""
    runs = []
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        for eager in (True, False):
            ts, step = graph_run(case, ds, eager)
            torch.cuda.synchronize()
            reset_launches()
            metrics = []
            for _ in range(GRAPH_CALLS):
                ts, m = step(ts)
                metrics.append((m["loss"].clone(), m["correct"].clone(),
                                m["batch"]))
            torch.cuda.synchronize()
            counts = {k: v for k, v in read_counters().items() if v}
            tensors = {k: v.detach().clone() for k, v in
                       train_tensors(ts).items()}
            draw = torch.rand(16, generator=ts.rng, device="cuda")
            runs.append((tensors, metrics, counts, ts.step, draw))
            del ts, step
    (te, me, ce, se, de), (tg, mg, cg, sg, dg) = runs
    diff = [k for k in te if not bits_equal(te[k], tg[k])]
    check(sorted(te) == sorted(tg) and not diff,
          f"graph {case}: tensors differ from the eager loop's: {diff[:8]}")
    check(all(bits_equal(a[0], b[0]) and bits_equal(a[1], b[1])
              and a[2] == b[2] for a, b in zip(me, mg)),
          f"graph {case}: metrics {me} against eager {mg}")
    check(se == sg == GRAPH_CALLS * GRAPH_K, f"graph {case}: steps {se} {sg}")
    check(bits_equal(de, dg), f"graph {case}: the generator's next draw "
          "differs")
    check(ce == cg, f"graph {case}: counters {cg} against eager {ce}")
    check(all(bool(torch.isfinite(m[0])) for m in mg),
          f"graph {case}: non-finite loss {mg}")
    losses = [round(float(m[0]), 4) for m in mg]
    return cg, (f"{case}: {len(te)} tensors, losses {losses}, "
                f"{sum(cg.values())} counted launches")


def graph_time(case: str, ds, steps: int, eager: bool, batch: int = TRAIN_B,
               total: int = 16) -> tuple[float, float]:
    """Device and host wall ms per step of ``total`` steps, ``steps`` a
    call, after the first call (and the capture: the second), with the
    counters put back."""
    ts, step = graph_run(case, ds, eager, batch, steps)
    before = read_counters()
    for _ in range(1 if eager else 2):
        ts, _m = step(ts)
    torch.cuda.synchronize()
    a, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t = time.perf_counter()
    a.record()
    for _ in range(total // steps):
        ts, m = step(ts)
    e.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    check(bool(torch.isfinite(m["loss"])), f"timed {case}: loss {m}")
    reset_launches()
    add_counters(before)
    return a.elapsed_time(e) / total, 1e3 * wall / total


def graph_timings(ds, smi: str) -> list:
    """bf16 AlexNet at the flagship's flags, batch 256: eager against
    captured at 1, 4 and 16 steps a call, and grad-accum 4 at 4 steps a
    call against the plain step, in turns (eager, captured, captured,
    eager), each the mean of the two."""
    lines = []
    for case, ks in (("flagship bf16", (1, 4, 16)), ("grad-accum 4", (4,))):
        for k in ks:
            got = {}
            for eager in (True, False, False, True):
                dev_ms, host_ms = graph_time(case, ds, k, eager)
                d, h = got.get(eager, (0.0, 0.0))
                got[eager] = (d + dev_ms / 2, h + host_ms / 2)
            (ed, eh), (gd, gh) = got[True], got[False]
            lines.append(f"{case}, {k} steps a call ({smi}): eager device "
                         f"{ed:.3f} ms / host {eh:.3f} ms per step, captured "
                         f"device {gd:.3f} / host {gh:.3f}")
            if case == "flagship bf16" and k == 1:
                plain = gh
            if case == "grad-accum 4":
                lines[-1] += (f"; captured {gh / plain:.2f}x the plain "
                              f"captured step's host ms ({plain:.3f})")
    torch.cuda.empty_cache()
    return lines


def fresh_train(argv, what: str):
    """``CHILD`` with ``argv`` from the checkout: a running process."""
    return subprocess.Popen([sys.executable, "-c", CHILD, *argv], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def fresh_result(proc, what: str, want: dict, timeout: float = 600):
    """The fresh process's output and counters; exit 0, "training done!",
    finite logged losses and exactly ``want``."""
    out, err = proc.communicate(timeout=timeout)
    check(proc.returncode == 0 and "training done!" in out,
          f"{what}: exit {proc.returncode}; output ends {out[-1500:]!r}; "
          f"errors end {err[-1500:]!r}")
    counts = json.loads(out.rsplit("child launches: ", 1)[1].splitlines()[0])
    check(counts == want, f"{what}: launches {counts}, expected {want}")
    losses = [float(x) for x in re.findall(r"\[loss ([-+\w.]+)\]", out)]
    check(losses and all(np.isfinite(losses)), f"{what}: losses {losses}")
    return out, counts


def build_root_listing() -> dict:
    root = _build.BUILD_ROOT
    return ({str(p.relative_to(root)): p.stat().st_mtime_ns
             for p in root.rglob("*")} if root.exists() else {})


def phase22(smi: str, tmp: Path, cli: dict) -> tuple[dict, dict]:
    """Phase 22: the fixture, the host loader's seconds per batch, the
    captured calls against the eager loop and their times, then the train
    CLI in two fresh processes with ``--compile-cache``. Returns the
    launches of the AlexNet runs and of the families', each added up."""
    alex, fam = {}, {}
    phase(f"phase 22: {fixture_phase()}")
    samples = split_dataset(discover_dataset(str(cli["data"]), (
        "dog", "panda", "bird")))["train"]
    with_aug = loader_seconds(samples, True)
    without = loader_seconds(samples, False)
    phase(f"phase 22: host loader, batch {P22_B} of phase 14's "
          f"{CLI_HW[0]}x{CLI_HW[1]} PPMs at 224 px, 2 workers, after its "
          f"first batch: {with_aug:.4f} s a batch with augment "
          f"({P22_B / with_aug:.1f} img/s), {without:.4f} s without "
          f"({P22_B / without:.1f} img/s)")

    ds = graph_dataset()
    for line in graph_timings(ds, smi):
        phase(f"phase 22: {line}")

    # the first CLI run builds into the cache while the cases run
    cache = tmp / "compile_cache"
    listing = build_root_listing()
    nv, nt = cli["valid_batches"], cli["test_batches"]
    base = ["--dataset-path", str(cli["data"]), *cli["sizes"],
            "--train-batch-size", str(P22_B), "--total-iters",
            str(P22_ITERS), "--valid-iters", str(P22_ITERS),
            "--save-iters", str(P22_ITERS), "--compile-cache", str(cache)]
    want = cli_want(P22_ITERS, nv + nt, False, False)
    for key in ("uint8_normalize.launches", "uint8_normalize.launches_wide"):
        want[key] += P22_ITERS      # the host loader's batches
    t0 = time.perf_counter()
    first = fresh_train(base + ["--checkpoint-dir", str(tmp / "p22_aug")],
                        "host augmentation")
    for case in GRAPH_CASES:
        counts, line = graph_case(case, ds)
        name = GRAPH_CASES[case][0]
        if name == "alexnet":
            add_up(alex, counts)
        elif name != "moecnn":      # MoECNN's convs have rows of their own
            add_up(fam, counts)
            add_up(fam, stem_counts(name, counts))
        phase(f"phase 22: captured calls bit-equal to the eager loop, "
              f"{line}")
    del ds
    torch.cuda.empty_cache()
    # the second run starts once the library is in the cache
    deadline = time.perf_counter() + 300
    while not list(cache.glob("cnn_tpu_torch/*/libcnn_tpu_torch.so")):
        check(first.poll() is None and time.perf_counter() < deadline,
              "the first --compile-cache run wrote no library")
        time.sleep(0.5)
    second = fresh_train(base + ["--checkpoint-dir", str(tmp / "p22_plain"),
                                 "--augment", "false"], "no augmentation")
    out1, c1 = fresh_result(first, "train CLI, host augmentation", want)
    s1 = time.perf_counter() - t0
    out2, c2 = fresh_result(second, "train CLI, --augment false", want)
    s2 = time.perf_counter() - t0
    lib = [l for l in out1.splitlines() if l.startswith("kernel library:")]
    check(len(lib) == 1 and lib[0].startswith("kernel library: built in ")
          and str(cache) in lib[0], f"first run: {lib}")
    lib2 = [l for l in out2.splitlines() if l.startswith("kernel library:")]
    check(len(lib2) == 1 and lib2[0].startswith(
        "kernel library: already built, loaded from ")
        and str(cache) in lib2[0], f"second run: {lib2}")
    check(build_root_listing() == listing,
          "the default build root changed under --compile-cache")
    add_up(alex, c1)
    add_up(alex, c2)
    for what, out in (("augment", out1), ("no augment", out2)):
        for line in out.splitlines():
            if line.startswith(("Valid===>", "Test===>")):
                phase(f"phase 22: train CLI ({what}): {line.strip()}")
    phase(f"phase 22: train CLI in fresh processes, {P22_ITERS} iterations "
          f"at batch {P22_B}: {lib[0]} (done {s1:.1f} s after its start); "
          f"{lib2[0]} (done at {s2:.1f} s); launches exact, no rotation "
          f"({c1}); the default build root unchanged")
    return alex, fam


# ---------------------------------------------------------------------------
# phase 23: data and tensor parallelism
# ---------------------------------------------------------------------------

P23_N = 512            # canvases of the step parity (2 shards, no padding)
P23_MESHES = {"dp2": (2, 1), "tp2": (1, 2)}
P23_TOL = 1e-4         # times max(1, max|ref|)
P23_STEPS = 5          # timed steps of each mesh
P23_ITERS = 10         # iterations of each two-process CLI run
P23_TP_SHARDS = ["conv_layer_3.w", "conv_layer_4.w", "linear_1.w"]


def p23_run(mesh=None, dtype=None, batch: int = TRAIN_B, steps: int = 1,
            eager: bool = True, sample_mode: str = "global"):
    """The seeded flagship AlexNet (BN, 224 px, momentum on a cosine
    schedule), its train state (sharded on ``mesh``) and a device step
    with the full augmentation on ``P23_N`` seeded canvases (on
    ``mesh``): ``(model, ts, step)``."""
    model = get_model("alexnet", num_classes=3, image_size=224,
                      batch_norm=True, device="cuda",
                      generator=torch.Generator().manual_seed(FAMILY_SEED))
    opt = make_optimizer("momentum", 1.5e-2, schedule="cosine",
                         total_steps=64)
    ts = create_train_state(model, opt, seed=7)
    if mesh is not None:
        shard_train_state(ts, mesh, model)
    imgs, labels = synthetic_canvases(np.random.default_rng(23), P23_N,
                                      CANVAS)
    ds = DeviceDataset.from_arrays(imgs, labels, mesh=mesh, device="cuda")
    adt = dtype or torch.float32
    step = make_device_train_step(
        model, opt, ds, batch, compute_dtype=dtype, mesh=mesh,
        augment_fn=lambda g, im: aug.augment_batch(g, im, dtype=adt),
        sample_mode=sample_mode, steps_per_call=steps, eager=eager)
    return model, ts, step


def p23_eval(model, mesh=None) -> dict:
    """One eval batch of 256 uint8 images (the normalize kernel)."""
    rng = np.random.default_rng(24)
    x = torch.from_numpy(synthetic_images(rng, TRAIN_B))
    y = torch.from_numpy(rng.integers(0, 3, TRAIN_B))
    if mesh is None:
        x, y = x.cuda(), y.cuda()
    return make_eval_step(model, mesh=mesh)(x, y)


def p23_time(ts, step, n: int = P23_STEPS) -> tuple[float, float]:
    """Device (CUDA events) and wall ms per step over ``n`` steps, the
    counters put back."""
    before = read_counters()
    torch.cuda.synchronize()
    a, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t = time.perf_counter()
    a.record()
    for _ in range(n):
        ts, m = step(ts)
    e.record()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t) / n
    check(bool(torch.isfinite(m["loss"])), f"timed steps: loss {m}")
    reset_launches()
    add_counters(before)
    return a.elapsed_time(e) / n, wall


def phase23_rank(tmp: str, port: int, rank: int) -> None:
    """One of the two ranks of phase 23's step parity: on each mesh of
    ``P23_MESHES``, one ``'global'`` device step from the seeded state and
    one eval batch with the counters from 0, the full tensors saved to
    ``tmp``, then the timed steps; prints its report as one JSON line."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(f"localhost:{port}", 2, rank, "cuda")
    report = {"backend": dist.get_backend(), "device": str(
        torch.cuda.current_device())}
    for tag, shape in P23_MESHES.items():
        mesh = make_mesh(*shape)
        model, ts, step = p23_run(mesh)
        torch.cuda.synchronize()
        reset_launches()
        ts, m = step(ts)
        ev = p23_eval(model, mesh)
        torch.cuda.synchronize()
        counts = {k: v for k, v in read_counters().items() if v}
        with unsharded(ts):
            torch.save({k: v.detach().cpu() for k, v in
                        train_tensors(ts).items()},
                       os.path.join(tmp, f"p23_{tag}_{rank}.pt"))
        dev_ms, wall_ms = p23_time(ts, step)
        report[tag] = {"counts": counts, "loss": float(m["loss"]),
                       "eval_loss": float(ev["loss"]),
                       "eval_correct": int(ev["correct"]),
                       "shards": sorted(ts.shards), "ms": dev_ms,
                       "wall_ms": wall_ms}
        del model, ts, step
        torch.cuda.empty_cache()
    print("p23 rank: " + json.dumps(report), flush=True)
    dist.destroy_process_group()


def p23_spawn(argv: list, code: str | None = None) -> list:
    """Two processes of ``argv`` (``{rank}`` and ``{port}`` filled in)
    under ``python -c code`` or ``python -m``; running."""
    port = free_port()
    procs = []
    for r in range(2):
        args = [a.format(rank=r, port=port) for a in argv]
        cmd = ([sys.executable, "-c", code, *args] if code is not None
               else [sys.executable, "-m", *args])
        procs.append(subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    return procs


def p23_outputs(procs, what: str, timeout: float = 600) -> list:
    """Each process's output; every one exits 0."""
    outs = []
    for r, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        check(p.returncode == 0, f"{what}, rank {r}: exit {p.returncode}; "
              f"output ends {out[-1500:]!r}; errors end {err[-2500:]!r}")
        outs.append(out)
    return outs


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def p23_step_want() -> dict:
    """One float32 step (the rotation) and one eval batch (the normalize)
    of the flagship: on every rank, TP's Cout/2 convs on the same kernels
    as the full ones."""
    return cli_want(1, 1, False, True)


def p23_parity(tmp: Path, smi: str) -> tuple[dict, list]:
    """The two-process step parity against this process's step; returns
    the ranks' launches, added up, and the report's lines."""
    procs = p23_spawn([str(tmp), "{port}", "{rank}"], code=(
        "import sys, chip_smoke as c\n"
        "c.phase23_rank(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))\n"))
    # meanwhile the one-process reference on the same seed
    model, ts, step = p23_run()
    ts, m = step(ts)
    ref = {k: v.detach().cpu().clone() for k, v in
           train_tensors(ts).items()}
    ref_loss = float(m["loss"])
    outs = p23_outputs(procs, "phase 23 step parity")
    reports = [json.loads(o.rsplit("p23 rank: ", 1)[1].splitlines()[0])
               for o in outs]
    one_ms = p23_time(ts, step)
    _, gts, gstep = p23_run(eager=False)
    for _ in range(2):                 # the eager call, the capture's
        gts, _m = gstep(gts)
    graph_one = p23_time(gts, gstep)
    del model, ts, step, gts, gstep
    torch.cuda.empty_cache()
    total, lines = {}, []
    want = p23_step_want()
    for tag in P23_MESHES:
        got = [torch.load(tmp / f"p23_{tag}_{r}.pt") for r in range(2)]
        check(sorted(got[0]) == sorted(ref),
              f"{tag}: tensors {sorted(set(got[0]) ^ set(ref))[:6]}")
        check(all(bits_equal(got[0][k], got[1][k]) for k in ref),
              f"{tag}: the two ranks' tensors differ")
        worst, where = 0.0, ""
        for k, want_t in ref.items():
            d = float((got[0][k].double() - want_t.double()).abs().max())
            d /= max(1.0, float(want_t.double().abs().max()))
            if d > worst:
                worst, where = d, k
        check(worst <= P23_TOL, f"{tag}: {where} off the one-process step "
              f"by {worst:.3e} x max(1, max|ref|)")
        shards = P23_TP_SHARDS if tag == "tp2" else []
        for r, rep in enumerate(reports):
            part = rep[tag]
            check(rep["backend"] == "gloo", f"{tag}: backend {rep}")
            check(part["shards"] == shards, f"{tag} rank {r}: shards "
                  f"{part['shards']}")
            check(part["counts"] == want, f"{tag} rank {r}: launches "
                  f"{part['counts']}, expected {want}")
            check(abs(part["loss"] - ref_loss) <= P23_TOL * max(
                1.0, abs(ref_loss)), f"{tag}: loss {part['loss']} against "
                f"{ref_loss}")
            add_up(total, part["counts"])
        ms = [rep[tag]["ms"] for rep in reports]
        walls = [rep[tag]["wall_ms"] for rep in reports]
        lines.append(
            f"{tag}: one step within {worst:.3e} x max(1, max|ref|) of the "
            f"one-process step (worst {where}), the ranks bit-equal, "
            f"launches exact on each; {P23_STEPS} steps at global batch "
            f"{TRAIN_B}, float32: device {ms[0]:.3f} / {ms[1]:.3f} ms per "
            f"step, wall {walls[0]:.3f} / {walls[1]:.3f} (ranks 0 / 1, "
            f"{smi})")
    lines.append(f"one process, the same step: device {one_ms[0]:.3f} ms "
                 f"per step, wall {one_ms[1]:.3f} (eager); captured device "
                 f"{graph_one[0]:.3f}, wall {graph_one[1]:.3f} ({smi})")
    return total, lines


P23_LOSS = re.compile(r"\[loss ([-+\w.]+)\]")


def p23_cli(cli: dict, tmp: Path) -> tuple[dict, list]:
    """The two-process train CLI runs (DP2, TP2) and multihost_smoke, all
    started at once; returns the CLI ranks' launches and the lines."""
    nv, nt = cli["valid_batches"], cli["test_batches"]
    base = CLI_FLAGSHIP + [
        "--dataset-path", str(cli["data"]), *cli["sizes"],
        "--total-iters", str(P23_ITERS), "--valid-iters", str(P23_ITERS),
        "--save-iters", str(P23_ITERS), "--multihost", "true",
        "--coordinator", "localhost:{port}", "--num-processes", "2",
        "--process-id", "{rank}"]
    runs = {"dp2": ["--data-parallel", "2"], "tp2": ["--model-parallel", "2"]}
    procs = {tag: p23_spawn(base + flags + ["--checkpoint-dir",
                                            str(tmp / f"p23_{tag}")],
                            code=CHILD)
             for tag, flags in runs.items()}
    smoke = p23_spawn(["cnn_tpu_torch.tools.multihost_smoke",
                       "--coordinator", "localhost:{port}",
                       "--num-processes", "2", "--process-id", "{rank}"])
    nccl_line, nccl_counts = p23_nccl()
    want = cli_want(P23_ITERS, nv + nt, True, True)
    total, lines = {}, [nccl_line]
    add_up(total, nccl_counts)
    for tag in runs:
        outs = p23_outputs(procs[tag], f"phase 23 CLI {tag}")
        shape = {"dp2": "{'data': 2, 'model': 1}",
                 "tp2": "{'data': 1, 'model': 2}"}[tag]
        logged = []
        for r, out in enumerate(outs):
            counts = json.loads(out.rsplit("child launches: ", 1)[1]
                                .splitlines()[0])
            check(counts == want, f"CLI {tag} rank {r}: launches {counts}, "
                  f"expected {want}")
            add_up(total, counts)
            check(f"mesh: {shape}" in out and "training done!" in out
                  and f"multihost: process {r}/2" in out,
                  f"CLI {tag} rank {r}: output ends {out[-1500:]!r}")
            logged.append([re.sub(r"\[[\d.]+ img/s\]", "", ln)
                           for ln in re.split(r"[\r\n]", out)
                           if ln.startswith(("Train===>", "Valid===>",
                                             "Test===>"))])
        check(logged[0] == logged[1] and logged[0],
              f"CLI {tag}: the ranks logged {logged}")
        losses = [float(x) for x in P23_LOSS.findall(outs[0])]
        check(losses and all(np.isfinite(losses)), f"CLI {tag}: {losses}")
        saved = [out.count("weights have been saved to") for out in outs]
        check(saved == [1, 0], f"CLI {tag}: saves per rank {saved}")
        cks = sorted((tmp / f"p23_{tag}").glob("*.ckpt"))
        check(len(cks) == 1, f"CLI {tag}: checkpoints {cks}")
        payload = read_checkpoint(str(cks[0]))
        check(payload["step"] == P23_ITERS and tuple(
            payload["params"]["conv_layer_3"]["w"].shape) == (3, 3, 32, 64)
            and tuple(payload["params"]["linear_1"]["w"].shape) == (4608, 3),
            f"CLI {tag}: the checkpoint's step {payload['step']}, shapes")
        back = get_model("alexnet", num_classes=3, image_size=224,
                         batch_norm=True, device="cuda")
        load_checkpoint(str(cks[0]), create_train_state(
            back, make_optimizer("momentum", 1.5e-2, schedule="cosine",
                                 total_steps=P23_ITERS)))
        test = [ln for ln in logged[0] if ln.startswith("Test===>")]
        lines.append(f"train CLI --multihost, {tag} ({shape}), {P23_ITERS} "
                     f"iterations of the bf16 flagship at global batch "
                     f"{TRAIN_B}: the same lines on both ranks (losses "
                     f"{losses}; {test[0].strip() if test else 'no test'}), "
                     f"launches exact per rank, {cks[0].name} written by "
                     "process 0 alone and read back")
    outs = p23_outputs(smoke, "phase 23 multihost_smoke")
    oks = [next((ln for ln in o.splitlines()
                 if ln.startswith("MULTIHOST OK")), None) for o in outs]
    check(oks[0] is not None and oks[0] == oks[1],
          f"multihost_smoke: {oks}")
    lines.append(f"tools.multihost_smoke, two processes: {oks[0]} on both")
    return total, lines


def p23_nccl() -> tuple[str, dict]:
    """A world-size-1 NCCL process group in this process: the bf16
    flagship's device call on its 1 x 1 mesh captured (the NCCL
    all-reduces of BN's statistics, the gradients and the metrics in the
    graph) against the eager loop, ``GRAPH_CALLS`` calls of ``GRAPH_K``
    steps at batch ``GRAPH_B`` under cuDNN's deterministic mode: every
    tensor, metric, the step, the generator's next draw and the counters
    bit-equal. Returns its line and the captured run's counters."""
    init_distributed(f"localhost:{free_port()}", 1, 0, "cuda")
    try:
        check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
        mesh = make_mesh(1, 1)
        runs = []
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            for eager in (True, False):
                _, ts, step = p23_run(mesh, BF16, GRAPH_B, GRAPH_K, eager,
                                      "local")
                check(isinstance(step, GraphedSteps) != eager,
                      f"NCCL mesh: eager={eager} gave {type(step).__name__}")
                torch.cuda.synchronize()
                reset_launches()
                metrics = []
                for _ in range(GRAPH_CALLS):
                    ts, m = step(ts)
                    metrics.append((m["loss"].clone(), m["correct"].clone()))
                torch.cuda.synchronize()
                counts = {k: v for k, v in read_counters().items() if v}
                tensors = {k: v.detach().clone()
                           for k, v in train_tensors(ts).items()}
                draw = torch.rand(16, generator=ts.rng, device="cuda")
                runs.append((tensors, metrics, counts, ts.step, draw))
                del ts, step
    finally:
        dist.destroy_process_group()
    (te, me, ce, se, de), (tg, mg, cg, sg, dg) = runs
    diff = [k for k in te if not bits_equal(te[k], tg[k])]
    check(sorted(te) == sorted(tg) and not diff,
          f"NCCL mesh: the captured call's tensors differ: {diff[:8]}")
    check(all(bits_equal(a[0], b[0]) and bits_equal(a[1], b[1])
              for a, b in zip(me, mg)), f"NCCL mesh: metrics {me} {mg}")
    check(se == sg == GRAPH_CALLS * GRAPH_K and bits_equal(de, dg),
          "NCCL mesh: the step or the generator differs")
    check(ce == cg, f"NCCL mesh: counters {cg} against eager {ce}")
    torch.cuda.empty_cache()
    return (f"a world-size-1 NCCL mesh: {GRAPH_CALLS} captured calls of "
            f"{GRAPH_K} bf16 steps at batch {GRAPH_B} (NCCL all-reduces in "
            f"the graph) bit-equal to the eager loop: {len(te)} tensors, "
            f"losses {[round(float(m[0]), 4) for m in mg]}"), cg


def phase23(smi: str, tmp: Path, cli: dict) -> dict:
    """Phase 23: the step parity, then the CLI runs, multihost_smoke and
    the NCCL mesh. Returns every counted launch, added up."""
    t0 = time.perf_counter()
    total, lines = p23_parity(tmp, smi)
    got, more = p23_cli(cli, tmp)
    add_up(total, got)
    for line in lines + more:
        phase(f"phase 23: {line}")
    phase(f"phase 23: {time.perf_counter() - t0:.1f} s")
    return total


# ---------------------------------------------------------------------------
# phase 24: the 'spatial' and 'expert' axes
# ---------------------------------------------------------------------------

P24_TOL = 1e-4         # times max(1, max|ref|), as phase 23
P24_LOAD_TOL = 1e-6    # MoE's load
P24_B = B              # resnet10's and MoECNN's batch
P24_STEPS = 3          # timed steps of each mesh
P24_EP = ["moe.b1", "moe.b2", "moe.w1", "moe.w2"]
# tag -> (family, compute dtype, mesh sizes (data, model, spatial,
# expert)); the flagship AlexNet's SP2 step is phase 23's device step
P24_CASES = {"resnet10 sp2": ("resnet10", None, (1, 1, 2, 1)),
             "resnet10 sp2 bf16": ("resnet10", BF16, (1, 1, 2, 1)),
             "moecnn ep2": ("moecnn", None, (1, 1, 1, 2))}


def p24_batch() -> tuple[torch.Tensor, torch.Tensor]:
    """``P24_B`` seeded uint8 images at 224 px and their labels (CPU)."""
    rng = np.random.default_rng(25)
    return (torch.from_numpy(synthetic_images(rng, P24_B)),
            torch.from_numpy(rng.integers(0, 3, P24_B)))


def p24_run(family: str, dtype=None, mesh=None):
    """A seeded ``family`` at 224 px (MoECNN at its defaults: width 64, 8
    experts, hidden 256), its train state (sharded on ``mesh``) and its
    train and eval steps on uint8 batches: ``(model, ts, step, ev)``."""
    model = get_model(family, num_classes=3, image_size=224, device="cuda",
                      generator=torch.Generator().manual_seed(FAMILY_SEED))
    opt = make_optimizer("momentum", 1e-2, schedule="cosine",
                         total_steps=64)
    ts = create_train_state(model, opt, seed=7)
    if mesh is not None:
        shard_train_state(ts, mesh, model)
    return (model, ts,
            make_train_step(model, opt, compute_dtype=dtype, mesh=mesh),
            make_eval_step(model, compute_dtype=dtype, mesh=mesh))


def p24_time(fn, n: int = P24_STEPS) -> tuple[float, float]:
    """Device (CUDA events) and wall ms per call of ``fn`` over ``n``
    calls, the counters put back."""
    before = read_counters()
    torch.cuda.synchronize()
    a, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t = time.perf_counter()
    a.record()
    for _ in range(n):
        fn()
    e.record()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t) / n
    reset_launches()
    add_counters(before)
    return a.elapsed_time(e) / n, wall


def p24_counted(run) -> tuple[object, dict, int]:
    """``run()`` with the kernels' counters and the halo exchange's row
    count from 0: its result, its launches and the rows exchanged."""
    torch.cuda.synchronize()
    reset_launches()
    rows = collectives.counts["halo_rows"]
    out = run()
    torch.cuda.synchronize()
    return (out, {k: v for k, v in read_counters().items() if v},
            collectives.counts["halo_rows"] - rows)


def phase24_rank(tmp: str, port: int, rank: int) -> None:
    """One of the two ranks of phase 24: the flagship AlexNet's float32
    ``'global'`` device step and an eval batch on an SP2 mesh, then each
    case of ``P24_CASES`` (one train step and one eval batch), each with
    the counters from 0 and the full tensors saved to ``tmp``, then its
    timed steps; prints its report as one JSON line."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(f"localhost:{port}", 2, rank, "cuda")
    report = {"backend": dist.get_backend()}
    mesh = make_mesh(1, 1, 2)
    model, ts, step = p23_run(mesh)
    (ts, m), counts, rows = p24_counted(lambda: step(ts))
    ev, ev_counts, ev_rows = p24_counted(lambda: p23_eval(model, mesh))
    with unsharded(ts):
        torch.save({k: v.detach().cpu() for k, v in
                    train_tensors(ts).items()},
                   os.path.join(tmp, f"p24_alexnet_{rank}.pt"))
    ms = p23_time(ts, step, P24_STEPS)
    report["alexnet sp2"] = {
        "shape": repr(mesh.shape), "counts": counts, "eval": ev_counts,
        "rows": rows, "eval_rows": ev_rows, "loss": float(m["loss"]),
        "eval_loss": float(ev["loss"]), "shards": sorted(ts.shards),
        "ms": ms}
    del model, ts, step
    x, y = p24_batch()
    for tag, (family, dtype, sizes) in P24_CASES.items():
        mesh = make_mesh(*sizes)
        model, ts, step, evs = p24_run(family, dtype, mesh)
        (ts, m), counts, rows = p24_counted(lambda: step(ts, x, y))
        ev, ev_counts, ev_rows = p24_counted(lambda: evs(x, y))
        with unsharded(ts):
            torch.save({k: v.detach().cpu() for k, v in
                        train_tensors(ts).items()},
                       os.path.join(tmp, f"p24_{tag}_{rank}.pt"))
        ms = p24_time(lambda: step(ts, x, y))
        report[tag] = {"shape": repr(mesh.shape), "counts": counts,
                       "eval": ev_counts, "rows": rows, "eval_rows": ev_rows,
                       "loss": float(m["loss"]),
                       "eval_loss": float(ev["loss"]),
                       "pred": ev["pred"].tolist(),
                       "shards": sorted(ts.shards), "ms": ms}
        del model, ts, step, evs
        torch.cuda.empty_cache()
    print("p24 rank: " + json.dumps(report), flush=True)
    dist.destroy_process_group()


def p24_worst(got: dict, ref: dict) -> tuple[float, str]:
    """The largest deviation of ``got``'s tensors from ``ref``'s, times
    max(1, max|ref|), and where (with the next five, for the record)."""
    devs = []
    for k, want in ref.items():
        d = float((got[k].double() - want.double()).abs().max())
        devs.append((d / max(1.0, float(want.double().abs().max())), k))
    devs.sort(reverse=True)
    return devs[0][0], "; ".join(f"{k} {d:.3e}" for d, k in devs[:6])


def p24_parity(tmp: Path, smi: str) -> tuple[dict, dict, list]:
    """The two ranks against this process's steps on the same seeds;
    returns AlexNet's and the families' launches (every rank's, added up)
    and the report's lines."""
    procs = p23_spawn([str(tmp), "{port}", "{rank}"], code=(
        "import sys, chip_smoke as c\n"
        "c.phase24_rank(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))\n"))
    # meanwhile the one-process references
    refs, ref_ms = {}, {}
    model, ts, step = p23_run()
    ts, m = step(ts)
    refs["alexnet sp2"] = ({k: v.detach().cpu().clone() for k, v in
                            train_tensors(ts).items()}, float(m["loss"]),
                           None)
    ref_ms["alexnet sp2"] = p23_time(ts, step, P24_STEPS)
    del model, ts, step
    x, y = p24_batch()
    for tag, (family, dtype, _) in P24_CASES.items():
        model, ts, step, evs = p24_run(family, dtype)
        ts, m = step(ts, x.cuda(), y.cuda())
        ev = evs(x.cuda(), y.cuda())
        refs[tag] = ({k: v.detach().cpu().clone() for k, v in
                      train_tensors(ts).items()}, float(m["loss"]),
                     ev["pred"].tolist())
        ref_ms[tag] = p24_time(lambda: step(ts, x.cuda(), y.cuda()))
        del model, ts, step, evs
        torch.cuda.empty_cache()
    outs = p23_outputs(procs, "phase 24 parity")
    reports = [json.loads(o.rsplit("p24 rank: ", 1)[1].splitlines()[0])
               for o in outs]
    alex, fam, lines = {}, {}, []
    for tag, (ref, ref_loss, ref_pred) in refs.items():
        name = "alexnet" if tag == "alexnet sp2" else tag
        got = [torch.load(tmp / f"p24_{name}_{r}.pt") for r in range(2)]
        check(sorted(got[0]) == sorted(ref),
              f"{tag}: tensors {sorted(set(got[0]) ^ set(ref))[:6]}")
        check(all(bits_equal(got[0][k], got[1][k]) for k in ref),
              f"{tag}: the two ranks' tensors differ")
        bf16 = tag.endswith("bf16")
        bar = BF16_MODEL_TOL if bf16 else P24_TOL
        worst, where = p24_worst(got[0], ref)
        check(worst <= bar, f"{tag}: {where} off the one-process step by "
              f"{worst:.3e} x max(1, max|ref|) (bar {bar})")
        loads = [k for k in ref if k.endswith(".load")]
        load_dev = max((float((got[0][k] - ref[k]).abs().max())
                        for k in loads), default=0.0)
        check(load_dev <= P24_LOAD_TOL, f"{tag}: MoE load off by "
              f"{load_dev:.3e}")
        launches = []
        for r, rep in enumerate(reports):
            part = rep[tag]
            check(rep["backend"] == "gloo", f"{tag}: backend {rep}")
            check(part["shards"] == (P24_EP if "ep2" in tag else []),
                  f"{tag} rank {r}: shards {part['shards']}")
            check(abs(part["loss"] - ref_loss) <= bar * max(
                1.0, abs(ref_loss)), f"{tag}: loss {part['loss']} against "
                f"{ref_loss}")
            if ref_pred is not None and not bf16:
                check(part["pred"] == ref_pred, f"{tag} rank {r}: preds")
            both = dict(part["counts"])
            add_up(both, part["eval"])
            want = ["conv2d_bias_relu.launches"] + (
                ["max_pool2d_fwd.launches", "max_pool2d_bwd.launches"]
                if name == "alexnet" else []) + (
                ["conv2d_bias_relu.launches_bf16_tma"] if bf16 else [])
            check(all(both.get(k, 0) > 0 for k in want) and not any(
                both.get(f"conv2d_bias_relu.launches_{v}", 0)
                for v in ("direct", "bf16_gather")),
                f"{tag} rank {r}: launches {both}")
            if "sp2" in tag:
                check(part["rows"] > 0, f"{tag} rank {r}: no halo rows")
            # MoECNN's convs have rows of their own (phase 20)
            if name == "alexnet":
                add_up(alex, both)
            elif tag.startswith("resnet10"):
                add_up(fam, both)
                add_up(fam, stem_counts("resnet10", both))
            launches.append(both)
        dev = [rep[tag]["ms"][0] for rep in reports]
        wall = [rep[tag]["ms"][1] for rep in reports]
        p = reports[0][tag]
        lines.append(
            f"{tag} {p['shape']}: one step within {worst:.3e} x max(1, "
            f"max|ref|) of the one-process step (worst {where}; bar {bar}"
            + (f"; MoE load within {load_dev:.2e}" if loads else "")
            + f"), eval preds {'equal' if not bf16 else 'not compared'}, "
            f"the ranks bit-equal; halo rows exchanged per step "
            f"{p['rows']} (its eval batch {p['eval_rows']}); launches per "
            f"rank {launches}; device {dev[0]:.3f} / {dev[1]:.3f} ms per "
            f"step, wall {wall[0]:.3f} / {wall[1]:.3f} (ranks 0 / 1), one "
            f"process device {ref_ms[tag][0]:.3f}, wall "
            f"{ref_ms[tag][1]:.3f} ({smi})")
    return alex, fam, lines


def p24_cli(cli: dict, tmp: Path) -> tuple[dict, dict, list]:
    """The two-process train CLI runs, ``--spatial-parallel 2`` (the bf16
    flagship) and ``--expert-parallel 2`` (MoECNN at its defaults, bf16),
    started at once; returns AlexNet's and MoECNN's launches and the
    lines."""
    nv, nt = cli["valid_batches"], cli["test_batches"]
    base = CLI_FLAGSHIP + [
        "--dataset-path", str(cli["data"]), *cli["sizes"],
        "--total-iters", str(P23_ITERS), "--valid-iters", str(P23_ITERS),
        "--save-iters", str(P23_ITERS), "--multihost", "true",
        "--coordinator", "localhost:{port}", "--num-processes", "2",
        "--process-id", "{rank}"]
    runs = {"sp2": (["--spatial-parallel", "2"],
                    "{'data': 1, 'model': 1, 'spatial': 2}"),
            "ep2": (["--expert-parallel", "2", "--name", "moecnn"],
                    "{'data': 1, 'model': 1, 'expert': 2}")}
    procs = {tag: p23_spawn(base + flags + ["--checkpoint-dir",
                                            str(tmp / f"p24_{tag}")],
                            code=CHILD)
             for tag, (flags, _) in runs.items()}
    # each rank runs every conv on its strip: the counts of one process
    want = cli_want(P23_ITERS, nv + nt, True, True)
    alex, moe, lines = {}, {}, []
    for tag, (_, shape) in runs.items():
        outs = p23_outputs(procs[tag], f"phase 24 CLI {tag}")
        logged, launches = [], []
        for r, out in enumerate(outs):
            counts = json.loads(out.rsplit("child launches: ", 1)[1]
                                .splitlines()[0])
            if tag == "sp2":
                check(counts == want, f"CLI {tag} rank {r}: launches "
                      f"{counts}, expected {want}")
            else:
                check(counts.get("conv2d_bias_relu.launches_bf16_tma", 0)
                      > 0 and counts.get("uint8_normalize.launches", 0) > 0,
                      f"CLI {tag} rank {r}: launches {counts}")
            add_up(alex if tag == "sp2" else moe, counts)
            launches.append(counts)
            check(f"mesh: {shape}" in out and "training done!" in out
                  and f"multihost: process {r}/2" in out,
                  f"CLI {tag} rank {r}: output ends {out[-1500:]!r}")
            logged.append([re.sub(r"\[[\d.]+ img/s\]", "", ln)
                           for ln in re.split(r"[\r\n]", out)
                           if ln.startswith(("Train===>", "Valid===>",
                                             "Test===>", "MoE load"))])
        check(logged[0] == logged[1] and logged[0],
              f"CLI {tag}: the ranks logged {logged}")
        losses = [float(v) for v in P23_LOSS.findall(outs[0])]
        check(losses and all(np.isfinite(losses)), f"CLI {tag}: {losses}")
        saved = [out.count("weights have been saved to") for out in outs]
        check(saved == [1, 0], f"CLI {tag}: saves per rank {saved}")
        cks = sorted((tmp / f"p24_{tag}").glob("*.ckpt"))
        check(len(cks) == 1, f"CLI {tag}: checkpoints {cks}")
        payload = read_checkpoint(str(cks[0]))
        if tag == "ep2":
            check(tuple(payload["params"]["moe"]["w1"].shape)
                  == (8, 64, 256), "CLI ep2: the checkpoint's experts")
        family = "alexnet" if tag == "sp2" else "moecnn"
        back = get_model(family, num_classes=3, image_size=224,
                         batch_norm=True, device="cuda")
        load_checkpoint(str(cks[0]), create_train_state(
            back, make_optimizer("momentum", 1.5e-2, schedule="cosine",
                                 total_steps=P23_ITERS)))
        test = [ln for ln in logged[0] if ln.startswith("Test===>")]
        lines.append(f"train CLI --multihost, {tag} ({shape}), {P23_ITERS} "
                     f"iterations of the bf16 {family} at global batch "
                     f"{TRAIN_B}: the same lines on both ranks (losses "
                     f"{losses}; {test[0].strip() if test else 'no test'}), "
                     f"launches per rank {launches}"
                     + (" (exact: one process's)" if tag == "sp2" else "")
                     + f", {cks[0].name} written by process 0 alone and "
                     "read back")
    return alex, moe, lines


def p24_bn_cost(smi: str) -> str:
    """BN's training statistics from float64 sums (``ops/batchnorm.py``,
    which a split batch or image reproduces bit for bit) against the
    float32 means they replaced, forward and backward at conv1's training
    shape, timed in turns; the line."""
    x = torch.randn(TRAIN_B, 111, 111, 16, device="cuda",
                    requires_grad=True)
    g = torch.randn_like(x)
    gamma, beta = torch.ones(16, device="cuda"), torch.zeros(16,
                                                             device="cuda")
    mean, var = torch.zeros(16, device="cuda"), torch.ones(16, device="cuda")

    def f64():
        y, _, _ = batch_norm2d_train(x, gamma, beta, mean, var)
        torch.autograd.grad(y, x, g)

    def f32():
        m = x.mean(dim=(0, 1, 2))
        v = torch.clamp(x.square().mean(dim=(0, 1, 2)) - m.square(), min=0.0)
        inv = gamma * torch.reciprocal(torch.sqrt(v + 1e-5))
        torch.autograd.grad(x * inv + (beta - m * inv), x, g)

    a, b = in_turns(f64, f32, 10)
    return (f"BN forward + backward at [{TRAIN_B},111,111,16] float32: "
            f"float64 sums {a:.4f} ms against float32 means {b:.4f} "
            f"(in turns, through the wrappers; {smi})")


def phase24(smi: str, tmp: Path, cli: dict) -> tuple[dict, dict]:
    """Phase 24: the SP2 and EP2 steps against one process, then the CLI
    runs. Returns the AlexNet runs' launches and resnet10's (MoECNN's
    convs have rows of their own), each added up."""
    t0 = time.perf_counter()
    bn = p24_bn_cost(smi)
    alex, fam, lines = p24_parity(tmp, smi)
    got, _, more = p24_cli(cli, tmp)
    add_up(alex, got)
    for line in [bn] + lines + more:
        phase(f"phase 24: {line}")
    phase(f"phase 24: {time.perf_counter() - t0:.1f} s")
    return alex, fam


# ---------------------------------------------------------------------------
# phase 25: pipeline parallelism over a 'stage' axis
# ---------------------------------------------------------------------------

P25_TOL = 1e-4         # times max(1, max|ref|), as phases 23-24
P25_B = B              # PipeCNN's batch in the step parity
P25_STEPS = 2          # timed steps of each schedule
P25_ITERS = 4          # iterations of each two-process CLI run
P25_CLI_B = B          # their global batch
# tag -> (microbatches, schedule, virtual stages, compute dtype) of the
# ranks' steps, each one step from the same seeded state
P25_RUNS = {"gpipe m1": (1, "gpipe", 1, None),
            "gpipe m4": (4, "gpipe", 1, None),
            "1f1b m4": (4, "1f1b", 1, None),
            "interleaved m4": (4, "1f1b", 2, None),
            "gpipe m4 bf16": (4, "gpipe", 1, BF16)}
P25_TIMED = ("gpipe m4", "1f1b m4", "interleaved m4")
P25_STAGED = sorted(f"trunk/body/{layer}.{key}" for layer, keys in (
    ("b_conv1", "wb"), ("b_bn1", ("gamma", "beta", "mean", "var")),
    ("b_conv2", "wb"), ("b_bn2", ("gamma", "beta", "mean", "var")))
    for key in keys)
# the conv variants PipeCNN's float32 and bf16 steps at 224 px run: the
# padded strip (stem_conv1), the tiled kernel, the bf16 widened strip and
# "tma"; the direct and gather fallbacks must not run
P25_FALLBACKS = ("direct", "bf16_gather")


def p25_model(dtype=None):
    """PipeCNN at its defaults (width 64, 8 blocks, 224 px, BN, remat
    'conv'), seeded, its momentum optimizer and a fresh train state."""
    model = get_model("pipecnn", num_classes=3, image_size=224,
                      device="cuda",
                      generator=torch.Generator().manual_seed(FAMILY_SEED))
    opt = make_optimizer("momentum", 1e-2, 0.9)
    return model, opt, create_train_state(model, opt, seed=7)


def p25_batch() -> tuple[torch.Tensor, torch.Tensor]:
    """``P25_B`` seeded uint8 images at 224 px and their labels (CPU)."""
    rng = np.random.default_rng(26)
    return (torch.from_numpy(synthetic_images(rng, P25_B)),
            torch.from_numpy(rng.integers(0, 3, P25_B)))


def p25_counted(run) -> tuple[object, dict, int]:
    """``run()`` with the kernels' counters from 0: its result, its
    launches and the stage hops it made."""
    torch.cuda.synchronize()
    reset_launches()
    hops = collectives.counts["stage_hops"]
    out = run()
    torch.cuda.synchronize()
    return (out, {k: v for k, v in read_counters().items() if v},
            collectives.counts["stage_hops"] - hops)


def phase25_rank(tmp: str, port: int, rank: int) -> None:
    """One of the two ranks of phase 25 on a PP2 ``('data', 'stage')``
    mesh: each step of ``P25_RUNS`` from the seeded state with the
    counters from 0, the gathered tensors saved to ``tmp``, the timed
    steps of ``P25_TIMED``; GPipe's and 1F1B's peak memory at M = 8; the
    committed PipeCNN's logits and TTA eval; prints its report as one JSON
    line."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(f"localhost:{port}", 2, rank, "cuda")
    mesh = make_pp_mesh(1, 2)
    report = {"backend": dist.get_backend(), "shape": repr(mesh.shape)}
    x, y = p25_batch()
    for tag, (m, schedule, v, dtype) in P25_RUNS.items():
        model, opt, ts = p25_model()
        shard_pp_train_state(ts, mesh, model, v)
        step = make_pp_train_step(model, opt, mesh, n_microbatches=m,
                                  schedule=schedule, virtual_stages=v,
                                  compute_dtype=dtype)
        (ts, met), counts, hops = p25_counted(lambda: step(ts, x, y))
        with unsharded(ts):
            torch.save({k: v.detach().cpu() for k, v in
                        train_tensors(ts).items()},
                       os.path.join(tmp, f"p25_{tag}_{rank}.pt"))
        ms = (p24_time(lambda: step(ts, x, y)) if tag in P25_TIMED
              else None)
        report[tag] = {"counts": counts, "hops": hops,
                       "loss": float(met["loss"]),
                       "shards": sorted(ts.shards), "ms": ms}
        del model, ts, step
        torch.cuda.empty_cache()
    peak = {}
    for schedule in ("gpipe", "1f1b"):
        model, opt, ts = p25_model()
        shard_pp_train_state(ts, mesh, model)
        step = make_pp_train_step(model, opt, mesh, n_microbatches=8,
                                  schedule=schedule)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ts, met = step(ts, x, y)
        torch.cuda.synchronize()
        peak[schedule] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        del model, ts, step
        torch.cuda.empty_cache()
    report["peak_mib"] = peak
    fixture = np.load(FAMILY_FIXTURE)
    model = family_model("pipecnn", fixture)
    ts = create_train_state(model, make_optimizer("momentum", 1e-2, 0.9),
                            seed=7)
    shard_pp_train_state(ts, mesh, model)
    photos = torch.from_numpy(family_photos())
    labels = torch.from_numpy(fixture["pipecnn_logits"].argmax(-1))
    (logits, ev), counts, hops = p25_counted(lambda: (
        make_pp_forward(model, mesh, n_microbatches=2)(photos),
        make_pp_eval_step(model, mesh, n_microbatches=2, tta="flips")(
            photos, labels)))
    report["eval"] = {"logits": logits.cpu().tolist(),
                      "pred": ev["pred"].tolist(), "loss": float(ev["loss"]),
                      "counts": counts, "hops": hops}
    print("p25 rank: " + json.dumps(report), flush=True)
    dist.destroy_process_group()


def p25_hops(m: int, v: int, schedule: str, stages: int = 2) -> int:
    """The stage hops of one step: GPipe's ``M + S - 2`` forward and as
    many backward; 1F1B's ``2 (C - 1) + 2 (M V - S (V - 1))``, ``C = V
    S``."""
    if schedule == "gpipe":
        return 2 * (m + stages - 2)
    return 2 * (v * stages - 1) + 2 * (m * v - stages * (v - 1))


def p25_parity(tmp: Path, smi: str) -> tuple[dict, list]:
    """The two ranks against this process's step and each other; returns
    their launches, added up, and the report's lines."""
    procs = p23_spawn([str(tmp), "{port}", "{rank}"], code=(
        "import sys, chip_smoke as c\n"
        "c.phase25_rank(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))\n"))
    # meanwhile the one-process step on the same seed, and its eval
    x, y = p25_batch()
    model, opt, ts = p25_model()
    step = make_train_step(model, opt)
    ts, m = step(ts, x.cuda(), y.cuda())
    ref = {k: v.detach().cpu().clone() for k, v in train_tensors(ts).items()}
    ref_loss = float(m["loss"])
    one_ms = p24_time(lambda: step(ts, x.cuda(), y.cuda()))
    del model, ts, step
    fixture = np.load(FAMILY_FIXTURE)
    model = family_model("pipecnn", fixture)
    photos = torch.from_numpy(family_photos()).cuda()
    want_logits = torch.from_numpy(fixture["pipecnn_logits"])
    labels = want_logits.argmax(-1)
    tta = make_eval_step(model, tta="flips")(photos, labels.cuda())
    del model
    torch.cuda.empty_cache()
    outs = p23_outputs(procs, "phase 25 step parity")
    reports = [json.loads(o.rsplit("p25 rank: ", 1)[1].splitlines()[0])
               for o in outs]
    got = {tag: [torch.load(tmp / f"p25_{tag}_{r}.pt") for r in range(2)]
           for tag in P25_RUNS}
    total, lines = {}, []
    for tag, (mb, schedule, v, dtype) in P25_RUNS.items():
        check(sorted(got[tag][0]) == sorted(ref),
              f"{tag}: tensors {sorted(set(got[tag][0]) ^ set(ref))[:6]}")
        check(all(bits_equal(got[tag][0][k], got[tag][1][k]) for k in ref),
              f"{tag}: the two ranks' tensors differ")
        # M = 1 is the unpipelined step; the other schedules are GPipe's
        # at M = 4, and bf16 is held to its float32 step
        against, bar = {"gpipe m1": (ref, P25_TOL),
                        "gpipe m4 bf16": (got["gpipe m4"][0],
                                          BF16_MODEL_TOL)}.get(
            tag, (got["gpipe m4"][0], P25_TOL))
        worst, where = p24_worst(got[tag][0], against)
        if tag != "gpipe m4":
            check(worst <= bar, f"{tag}: {where} off by {worst:.3e} x "
                  f"max(1, max|ref|) (bar {bar})")
        launches = []
        for r, rep in enumerate(reports):
            part = rep[tag]
            check(rep["backend"] == "gloo" and rep["shape"]
                  == "{'data': 1, 'stage': 2}", f"{tag}: mesh {rep}")
            check(part["shards"] == P25_STAGED, f"{tag} rank {r}: shards "
                  f"{part['shards']}")
            check(part["hops"] == p25_hops(mb, v, schedule),
                  f"{tag} rank {r}: {part['hops']} stage hops, expected "
                  f"{p25_hops(mb, v, schedule)}")
            c = part["counts"]
            want = ["conv2d_bias_relu.launches"] + (
                ["conv2d_bias_relu.launches_bf16_tma"] if dtype else
                ["conv2d_bias_relu.launches_tiled"]) + (
                ["conv2d_bias_relu.launches_strip_padded"]
                if r == 0 and not dtype else [])
            check(all(c.get(k, 0) > 0 for k in want) and not any(
                c.get(f"conv2d_bias_relu.launches_{f}", 0)
                for f in P25_FALLBACKS), f"{tag} rank {r}: launches {c}")
            check(np.isfinite(part["loss"]), f"{tag}: loss {part['loss']}")
            add_up(total, c)
            launches.append(c)
        check(reports[0][tag]["loss"] == reports[1][tag]["loss"],
              f"{tag}: the ranks' losses differ")
        if tag == "gpipe m1":
            check(abs(reports[0][tag]["loss"] - ref_loss) <= P25_TOL * max(
                1.0, abs(ref_loss)), f"{tag}: loss {reports[0][tag]['loss']}"
                f" against {ref_loss}")
        times = ""
        if tag in P25_TIMED:
            dev = [rep[tag]["ms"][0] for rep in reports]
            wall = [rep[tag]["ms"][1] for rep in reports]
            times = (f"; device {dev[0]:.3f} / {dev[1]:.3f} ms per step, "
                     f"wall {wall[0]:.3f} / {wall[1]:.3f} (ranks 0 / 1)")
        what = {"gpipe m1": "the one-process step",
                "gpipe m4 bf16": "GPipe's float32 step at M = 4"}.get(
            tag, "GPipe's step at M = 4")
        lines.append(
            f"PP2 {tag} at batch {P25_B}: "
            + (f"within {worst:.3e} x max(1, max|ref|) of {what} (worst "
               f"{where}; bar {bar}), " if tag != "gpipe m4" else "")
            + f"the ranks bit-equal, {reports[0][tag]['hops']} stage hops "
            f"a step, launches per rank {launches}{times}")
    lines.append(f"one process, the same float32 step: device "
                 f"{one_ms[0]:.3f} ms per step, wall {one_ms[1]:.3f} "
                 f"({smi}; the ranks time-slice the card over gloo)")
    peaks = [rep["peak_mib"] for rep in reports]
    check(peaks[0]["1f1b"] < peaks[0]["gpipe"],
          f"M = 8: stage 0's peak MiB {peaks[0]}")
    lines.append(
        f"peak device memory per rank at M = 8, float32, batch {P25_B} "
        f"(MiB above the weights): GPipe {peaks[0]['gpipe']:.1f} / "
        f"{peaks[1]['gpipe']:.1f}, 1F1B {peaks[0]['1f1b']:.1f} / "
        f"{peaks[1]['1f1b']:.1f} (stages 0 / 1; {smi})")
    for r, rep in enumerate(reports):
        ev = rep["eval"]
        logits = torch.tensor(ev["logits"])
        dev = float((logits - want_logits).abs().max()) / max(
            1.0, float(want_logits.abs().max()))
        check(dev <= P25_TOL and torch.equal(logits.argmax(-1), labels),
              f"eval rank {r}: logits {dev:.3e} off family_logits.npz")
        check(ev["pred"] == tta["pred"].tolist() and abs(
            ev["loss"] - float(tta["loss"])) <= P25_TOL * max(
            1.0, abs(float(tta["loss"]))),
              f"eval rank {r}: TTA {ev['pred']} {ev['loss']} against one "
              f"process's {tta['pred'].tolist()} {float(tta['loss'])}")
        check(not any(ev["counts"].get(f"conv2d_bias_relu.launches_{f}", 0)
                      for f in P25_FALLBACKS), f"eval rank {r}: "
              f"{ev['counts']}")
        add_up(total, ev["counts"])
    lines.append(
        f"the committed PipeCNN (iter_11000) through make_pp_forward at M "
        f"= 2 on the six photos: logits within {dev:.3e} x max(1, |ref|) "
        f"of family_logits.npz, the same classes; make_pp_eval_step with "
        f"tta='flips' at M = 2: predictions and loss equal to one "
        f"process's ({reports[0]['eval']['hops']} hops)")
    return total, lines


# the train CLI in a fresh process (``CHILD``'s), each rank also saving
# its gathered tree beside every checkpoint it helps write, and printing
# its stage hops
P25_CHILD = (
    "import json, sys, torch\n"
    "import torch.distributed as dist\n"
    "from cnn_tpu_torch.ops.hopper import read_counters\n"
    "from cnn_tpu_torch.parallel.collectives import counts\n"
    "from cnn_tpu_torch.parallel.train_step import (named_params,\n"
    "    named_state, unsharded)\n"
    "from cnn_tpu_torch.tools import train\n"
    "real = train.save_checkpoint\n"
    "def save(path, ts):\n"
    "    real(path, ts)\n"
    "    with unsharded(ts):\n"
    "        tree = {k: v.detach().cpu().clone() for k, v in\n"
    "                {**named_params(ts.model),\n"
    "                 **named_state(ts.model)}.items()}\n"
    "    torch.save(tree, path + f'.rank{dist.get_rank()}')\n"
    "train.save_checkpoint = save\n"
    "rc = train.main(sys.argv[1:])\n"
    "print('child launches: ' + json.dumps(\n"
    "    {k: v for k, v in read_counters().items() if v}))\n"
    "print('child hops: ' + str(counts['stage_hops']))\n"
    "sys.exit(rc)\n")


def p25_flat(tree: dict, path: tuple = ()) -> dict:
    """A checkpoint's nested tree by ``leaf_name``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(p25_flat(v, path + (k,)))
        else:
            out["/".join(path) + "." + k] = np.asarray(v)
    return out


def p25_smoke() -> list:
    """``multihost_pp_smoke`` as four processes; running."""
    port = free_port()
    return [subprocess.Popen(
        [sys.executable, "-m", "cnn_tpu_torch.tools.multihost_pp_smoke",
         "--coordinator", f"localhost:{port}", "--num-processes", "4",
         "--process-id", str(r)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(4)]


def p25_cli(cli: dict, tmp: Path, smoke: list) -> tuple[dict, list]:
    """The two-process pipelined train CLI runs (1F1B at M = 4, and
    interleaved with two chunks a stage), started at once, then the
    output of ``smoke`` (``p25_smoke``); returns the CLI ranks' launches
    and the lines."""
    base = CLI_FLAGSHIP + [
        "--dataset-path", str(cli["data"]), *cli["sizes"],
        "--train-batch-size", str(P25_CLI_B), "--name", "pipecnn",
        "--total-iters", str(P25_ITERS), "--valid-iters", str(P25_ITERS),
        "--save-iters", str(P25_ITERS), "--multihost", "true",
        "--coordinator", "localhost:{port}", "--num-processes", "2",
        "--process-id", "{rank}", "--pipeline-stages", "2",
        "--data-parallel", "1", "--pipeline-schedule", "1f1b",
        "--microbatches", "4"]
    runs = {"1f1b": [], "interleaved": ["--virtual-stages", "2"]}
    procs = {tag: p23_spawn(base + flags + ["--checkpoint-dir",
                                            str(tmp / f"p25_{tag}")],
                            code=P25_CHILD)
             for tag, flags in runs.items()}
    total, lines = {}, []
    for tag in runs:
        outs = p23_outputs(procs[tag], f"phase 25 CLI {tag}")
        logged, launches, hops = [], [], []
        for r, out in enumerate(outs):
            counts = json.loads(out.rsplit("child launches: ", 1)[1]
                                .splitlines()[0])
            hops.append(int(out.rsplit("child hops: ", 1)[1].split()[0]))
            check(counts.get("conv2d_bias_relu.launches_bf16_tma", 0) > 0
                  and counts.get("rotate_shear.launches", 0) > 0
                  and not any(counts.get(f"conv2d_bias_relu.launches_{f}", 0)
                              for f in P25_FALLBACKS),
                  f"CLI {tag} rank {r}: launches {counts}")
            add_up(total, counts)
            launches.append(counts)
            check("pipeline mesh: {'data': 1, 'stage': 2} (microbatches 4, "
                  "schedule 1f1b)" in out and "training done!" in out
                  and f"multihost: process {r}/2" in out,
                  f"CLI {tag} rank {r}: output ends {out[-1500:]!r}")
            logged.append([re.sub(r"\[[\d.]+ img/s\]", "", ln)
                           for ln in re.split(r"[\r\n]", out)
                           if ln.startswith(("Train===>", "Valid===>",
                                             "Test===>"))])
        check(logged[0] == logged[1] and logged[0],
              f"CLI {tag}: the ranks logged {logged}")
        losses = [float(v) for v in P23_LOSS.findall(outs[0])]
        check(losses and all(np.isfinite(losses)), f"CLI {tag}: {losses}")
        saved = [out.count("weights have been saved to") for out in outs]
        check(saved == [1, 0], f"CLI {tag}: saves per rank {saved}")
        cks = sorted((tmp / f"p25_{tag}").glob("*.ckpt"))
        check(len(cks) == 1, f"CLI {tag}: checkpoints {cks}")
        payload = read_checkpoint(str(cks[0]))
        tree = {**p25_flat(payload["params"]), **p25_flat(payload["state"])}
        for r in range(2):
            ranks = torch.load(str(cks[0]) + f".rank{r}")
            check(sorted(ranks) == sorted(tree) and all(
                np.array_equal(ranks[k].numpy(), tree[k]) for k in tree),
                f"CLI {tag}: the checkpoint differs from rank {r}'s tree")
        check(tree["trunk/body/b_conv1.w"].shape == (8, 3, 3, 64, 64),
              f"CLI {tag}: trunk {tree['trunk/body/b_conv1.w'].shape}")
        back = get_model("pipecnn", num_classes=3, image_size=224,
                         device="cuda")
        load_checkpoint(str(cks[0]), create_train_state(
            back, make_optimizer("momentum", 1.5e-2, schedule="cosine",
                                 total_steps=P25_ITERS)))
        test = [ln for ln in logged[0] if ln.startswith("Test===>")]
        lines.append(
            f"train CLI --multihost --pipeline-stages 2, {tag} 1F1B at M = "
            f"4, {P25_ITERS} iterations of the bf16 PipeCNN at global "
            f"batch {P25_CLI_B} with the full device augmentation: the "
            f"same lines on both ranks (losses {losses}; "
            f"{test[0].strip() if test else 'no test'}), stage hops per "
            f"rank {hops}, launches per rank {launches}, {cks[0].name} "
            "written by process 0 alone, equal to both ranks' gathered "
            "trees and read back")
    outs = p23_outputs(smoke, "phase 25 multihost_pp_smoke")
    oks = [[ln for ln in o.splitlines()
            if ln.split(" ", 1)[0] in ("PP", "PP-1F1B", "PP3", "EPOCH")]
           for o in outs]
    losses = {tuple(ln.split("loss=")[1].split()[0] for ln in ok
                    if "loss=" in ln) for ok in oks}
    check(all(len(ok) == 4 for ok in oks) and len(losses) == 1,
          f"multihost_pp_smoke: {oks}")
    lines.append("tools.multihost_pp_smoke, four processes (DP2 x PP2, DP1 "
                 f"x PP2 x TP2): {oks[0]} on every one")
    return total, lines


def phase25(smi: str, tmp: Path, cli: dict) -> dict:
    """Phase 25: the pipelined steps against one process and each other,
    the memory of GPipe and 1F1B, the pipelined eval of the committed
    PipeCNN, then the CLI runs and multihost_pp_smoke. Returns every
    PipeCNN launch, added up (the families' rows)."""
    t0 = time.perf_counter()
    # the small smoke starts first: its four processes import while the
    # step parity runs
    smoke = p25_smoke()
    total, lines = p25_parity(tmp, smi)
    t1 = time.perf_counter()
    got, more = p25_cli(cli, tmp, smoke)
    add_up(total, got)
    for line in lines + more:
        phase(f"phase 25: {line}")
    phase(f"phase 25: {time.perf_counter() - t0:.1f} s (the step parity "
          f"{t1 - t0:.1f} s)")
    return total


# ---------------------------------------------------------------------------
# phase 26: the native loader (the batched resize kernel), --backend native
# in the CLIs, and the FLOP counts
# ---------------------------------------------------------------------------

# the resize kernel's batch: phase 14's PPM size and a photo's, a pixel, a
# row and a column, exact 2x downscales (cv2 runs them as INTER_AREA) to
# 224 and to the 256 canvas, upscales, the output's own sizes
P26_SHAPES = ([CLI_HW] * 24 + [(375, 500)] * 24
              + [(1, 1), (1, 500), (375, 1), (448, 448), (512, 512),
                 (112, 112), (100, 150), (224, 224), (256, 256), (7, 300),
                 (300, 7), (223, 225), (129, 257), (2, 2), (33, 47),
                 (640, 480)])
P26_SIZES = (224, CANVAS)
P26_FAMILIES = ("alexnet", "resnet10", "resnet18", "vgg8", "vgg11",
                "mobilenet", "pipecnn", "moecnn")
P26_LOADER_BATCHES = 4     # timed batches of each host loader, after one
# integer operations a resized channel takes (two rows: 2 products and a
# sum, a shift; then 2 products, 2 shifts and a sum; the rounding)
RESIZE_OPS = 14


def resize_bytes(p) -> int:
    """Bytes the resize of ``p`` must move: each source pixel that a tap
    reads, once, the tables and ``meta``, and the output."""
    xt, yt = p.xtab.cpu().numpy(), p.ytab.cpu().numpy()
    touched = sum(len(np.unique(y[:2])) * len(np.unique(x[:2])) * 3
                  for x, y in zip(xt, yt))
    n, s = p.meta.shape[0], p.size
    return touched + nbytes(p.xtab, p.ytab, p.meta) + n * s * s * 3


def resize_phase() -> tuple[tuple, str]:
    """The kernel against ``resize_batch_plain`` on the card, bit for bit,
    on P26_SHAPES to 224 and to the canvas (and against ``data/image.py``'s
    ``resize`` on the host at 224), two launches bit-identical; timed at
    224 alone (graph), through the wrapper and plain. Returns the row's
    (err, ms, plain, library, bound) and a line."""
    rng = np.random.default_rng(26)
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in P26_SHAPES]
    check(len(imgs) == B, f"{len(imgs)} images")
    for size in P26_SIZES:
        p = to_device(pack(imgs, size), "cuda")
        got, again = launch_resize(p), launch_resize(p)
        ref = resize_batch_plain(p)
        torch.cuda.synchronize()
        check(bits_equal(got, ref) and bits_equal(got, again),
              f"resize to {size}: the kernel differs from its plain version "
              f"at {int((got != ref).sum())} bytes")
        if size == 224:
            host = np.stack([host_resize(im, (size, size)) for im in imgs])
            check(same_arrays(got.cpu().numpy(), host),
                  "resize: the kernel differs from data/image.py's resize")
            p224, out = p, torch.empty_like(got)
    ms = graph_ms(lambda: launch_resize(p224, out))
    wrapped = time_ms(lambda: resize_linear_u8(p224, out))
    plain = time_ms(lambda: resize_batch_plain(p224), iters=3, warmup=1)
    resize_linear_u8.launches = 0    # the comparisons count nothing
    nb = resize_bytes(p224)
    bound = bound_ms(nb, RESIZE_OPS * B * 224 * 224 * 3)
    return (0.0, ms, plain, None, bound), (
        f"resize kernel bit-equal to resize_batch_plain on {B} images "
        f"({len(set(P26_SHAPES))} shapes) to {P26_SIZES} and to "
        f"data/image.py's resize at 224, two launches bit-identical; at "
        f"224 alone {ms:.4f} ms (graph), through the wrapper {wrapped:.4f} "
        f"ms, plain {plain:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}, "
        f"{nb / 1e6:.2f} MB); library: none (F.interpolate's bilinear is "
        f"float arithmetic, not cv2's 11-bit fixed point, so it computes "
        f"another function)")


def loader_batch_seconds(samples, backend: str) -> float:
    """Seconds a batch of the host loader's stream at ``B`` without cache
    or augmentation (2 workers, prefetch 4), after its first batch."""
    dl = DataLoader(samples, B, image_size=224, num_workers=2, prefetch=4,
                    backend=backend, cache=False, device="cuda")
    try:
        dl.generate_batch()
        t = time.perf_counter()
        for _ in range(P26_LOADER_BATCHES):
            images, _ = dl.generate_batch()
        secs = (time.perf_counter() - t) / P26_LOADER_BATCHES
    finally:
        dl.close()
    check(images.shape == (B, 224, 224, 3), f"loader {images.shape}")
    return secs


def native_loader_phase(cli: dict) -> tuple[int, str]:
    """``DataLoader(backend='native')`` against ``backend='python'`` on
    phase 14's images: one epoch of the validation and test splits
    bit-equal, one resize launch a batch; then seconds a batch of each
    stream. Returns the epoch's resize launches and a line."""
    splits = split_dataset(discover_dataset(str(cli["data"]),
                                            ("dog", "panda", "bird")))
    samples = splits["valid"] + splits["test"]
    kw = dict(batch_size=B, shuffle=False, image_size=224, num_workers=2)
    native = DataLoader(samples, backend="native", device="cuda", **kw)
    python = DataLoader(samples, backend="python", **kw)
    reset_launches()
    batches = 0
    for (ni, nl), (pi, pl) in zip(native, python):
        check(same_arrays(ni, pi) and same_arrays(nl, pl),
              f"native loader batch {batches} differs from the Python path")
        batches += 1
    launches = resize_linear_u8.launches
    check(batches == -(-len(samples) // B) and launches == batches
          and read_counters()["resize_linear_u8.launches"] == launches,
          f"native epoch: {batches} batches, {launches} resize launches")
    turns = [(b, loader_batch_seconds(splits["train"], b))
             for b in ("python", "native", "native", "python")]
    # one batch's two steps apart: the decode in 2 threads, then the
    # native engine's resize call (pack, copy in, kernel, copy out)
    paths = [path for path, _ in splits["train"][:B]]
    engine = NativeLoader(224, device="cuda")
    split = {"decode": 0.0, "resize": 0.0}
    for _ in range(3):
        t = time.perf_counter()
        with ThreadPoolExecutor(max_workers=2) as pool:
            imgs = list(pool.map(imread, paths))
        split["decode"] += (time.perf_counter() - t) / 3
        t = time.perf_counter()
        engine.resize(imgs)
        split["resize"] += (time.perf_counter() - t) / 3
    reset_launches()
    return launches, (
        f"DataLoader(backend='native') bit-equal to backend='python' over "
        f"{len(samples)} of phase 14's {CLI_HW[0]}x{CLI_HW[1]} PPM images "
        f"({batches} batches, one resize launch each); seconds a batch of "
        f"{B} at 224 px (2 workers, prefetch 4, no cache, no augmentation, "
        f"after the first), in turns: "
        + ", ".join(f"{b} {t:.4f}" for b, t in turns)
        + f"; one native batch apart (mean of 3): decode in 2 threads "
        f"{split['decode']:.4f} s, the resize call {split['resize']:.4f} s")


def counted_train_loaders():
    """``train_cli.DataLoader`` as a subclass that records each batch its
    native engine resizes (in the producer thread or the caller's)."""
    resized = []

    class Counted(DataLoader):
        def _assemble(self, *args):
            out = super()._assemble(*args)
            if self._native_batch:
                resized.append(self.image_size)
            return out

    return mock.patch.object(train_cli, "DataLoader", Counted), resized


def native_cli_phase(smi: str, tmp: Path, cli: dict) -> tuple[dict, list]:
    """``--backend native --cache false``: the train CLI's host-loader run
    (float32, the fast device augmentation, batch 64, 20 iterations), then
    the evaluate CLI on phase 14's best checkpoint, beside the same
    evaluation on the Python path (the same printed lines). Exact launches:
    a resize a batch the loaders assembled (train batches at the canvas,
    the prefetch beyond the 20 consumed included; validation and test at
    224). Returns the launches, added up, and the lines."""
    nv, nt = cli["valid_batches"], cli["test_batches"]
    base = ["--dataset-path", str(cli["data"]), *cli["sizes"],
            "--cache", "false"]
    total, lines = {}, []
    patch, resized = counted_train_loaders()
    t = time.perf_counter()
    with patch:
        text, counts, _ = counted_run(
            "train CLI --backend native", train_cli.main, base + [
                "--backend", "native", "--checkpoint-dir",
                str(tmp / "native"), "--device-augment", "true",
                "--augment-mode", "fast", "--batch-norm", "true",
                "--optimizer", "momentum", "--learning-rate", "1.5e-2",
                "--lr-schedule", "cosine", "--train-batch-size", str(B),
                "--total-iters", "20", "--valid-iters", "20",
                "--save-iters", "20"],
            lambda: {**cli_want(20, nv + nt, False, False),
                     "resize_linear_u8.launches": len(resized)})
    secs = time.perf_counter() - t
    train_batches = resized.count(CANVAS)
    check("training done!" in text and 20 <= train_batches <= 20 + 4 + 1
          and len(resized) - train_batches == nv + nt,
          f"train CLI --backend native: {train_batches} train batches "
          f"resized, {len(resized) - train_batches} eval batches; output "
          f"ends {text[-1500:]!r}")
    add_up(total, counts)
    test = [l for l in text.splitlines() if l.startswith("Test===>")]
    lines.append(f"train CLI --backend native --cache false, 20 iterations "
                 f"at batch {B}: {test[-1]}; resize launches "
                 f"{counts['resize_linear_u8.launches']} ({train_batches} "
                 f"train batches at {CANVAS} px, {nv + nt} eval); "
                 f"{secs:.3f} s ({smi})")
    argv = base + ["--resume", cli["best"], "--split", "both"]
    out = {}
    for backend in ("python", "native"):
        want = eval_want(nv + nt, nv + nt)
        if backend == "native":
            want["resize_linear_u8.launches"] = nv + nt
        text, counts, secs = counted_run(
            f"evaluate --backend {backend}", evaluate_cli.main,
            argv + ["--backend", backend], want)
        add_up(total, counts)
        out[backend] = (text, secs)
    check(out["native"][0] == out["python"][0],
          "evaluate --backend native printed other lines than the Python "
          f"path: {out['native'][0][-1500:]!r}")
    lines.append(f"evaluate --split both --backend native --cache false: the "
                 f"Python path's lines ({nv + nt} resize launches), "
                 f"{out['native'][1]:.3f} s against {out['python'][1]:.3f} s")
    return total, lines


def flops_line() -> str:
    """Every family's analytic FLOPs per image at 224 px (utils/flops.py),
    and PipeCNN at width 256 (the deep MFU model)."""
    figures = []
    for name, kw in [(n, {}) for n in P26_FAMILIES] + [
            ("pipecnn", {"width": 256, "n_blocks": 8})]:
        model = get_model(name, num_classes=3, device="cuda", **kw)
        fwd, train = (forward_flops_per_image(model),
                      train_flops_per_image(model))
        check(0 < fwd < train, f"{name} flops {fwd}, {train}")
        figures.append(f"{name}{'@w256' if kw else ''} {fwd:.0f} / "
                       f"{train:.0f}")
    return "FLOPs per image, forward / train step: " + "; ".join(figures)


def phase26(smi: str, tmp: Path, cli: dict) -> tuple[int, tuple, dict]:
    """Phase 26: the resize kernel, the native loader, ``--backend
    native`` through the train and evaluate CLIs, the FLOP counts. Returns
    the resize launches of its counted runs, the resize row's numbers and
    every launch of the CLI runs (AlexNet's rows)."""
    t0 = time.perf_counter()
    row, line = resize_phase()
    phase(f"phase 26: {line}")
    epoch_launches, line = native_loader_phase(cli)
    phase(f"phase 26: {line}")
    total, lines = native_cli_phase(smi, tmp, cli)
    for line in lines:
        phase(f"phase 26: {line}")
    phase(f"phase 26: {flops_line()}")
    phase(f"phase 26: {time.perf_counter() - t0:.1f} s")
    resize = total.pop("resize_linear_u8.launches") + epoch_launches
    return resize, row, total


# ---------------------------------------------------------------------------
# phase 27: MaxPool2D at any window (the flagship AlexNet with the
# overlapping 3x3 stride-2 pool), the fast device augmentation captured,
# --profile-dir
# ---------------------------------------------------------------------------

CKPT = MODEL.with_suffix(".ckpt")     # the same weights as a cnn_tpu tree
P27_STEPS = 10         # train steps of the 3x3/2 AlexNet in each dtype
P27_N = 512            # canvases of its device dataset
P27_ITERS = 4          # iterations of the --profile-dir run
P27_POOL_KEYS = ("max_pool2d_fwd.", "max_pool2d_bwd.")
# the captured calls of make_device_train_step with augment_batch_fast
P27_GRAPH_CASES = {
    "fast augmentation float32": ("alexnet", {}, None, {"augment": "fast"},
                                  {}),
    "fast augmentation bf16": ("alexnet", {}, BF16, {"augment": "fast"}, {}),
}


def pool33_model(window: int) -> torch.nn.Module:
    """The BN AlexNet at 224 px on the card with ``max_pool_1`` the
    ``window`` x ``window`` stride-2 pool (2: the flagship; 3: the
    overlapping pool), the committed ``.ckpt``'s trees loaded through
    ``load_jax_params``; 111 rows pool to 55 either way."""
    model = get_model("alexnet", num_classes=3, batch_norm=True,
                      image_size=224, device="cuda")
    if window != 2:
        model.net.layers["max_pool_1"] = MaxPool2D("max_pool_1", window, 2)
    payload = read_checkpoint(str(CKPT))
    load_jax_params(model, payload["params"], payload["state"])
    return model


def without_pool(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if not k.startswith(P27_POOL_KEYS)}


@contextmanager
def taps_on_the_card():
    """Counts the calls of the 2x2 pool's plain version
    (``ops/pool.py:max_pool2d_taps``) on a CUDA tensor: none may happen."""
    real, seen = pool_ops.max_pool2d_taps, []

    def spy(x):
        if x.is_cuda:
            seen.append(tuple(x.shape))
        return real(x)

    with mock.patch.object(pool_ops, "max_pool2d_taps", spy):
        yield seen


def pool33_serving(models: dict, rng) -> tuple[dict, list]:
    """Both models behind ``InferenceEngine`` (buckets 1, 8, 64, one CUDA
    graph each) in float32 and bf16: each bucket's replay bit-equal to the
    eager forward; a counted predict of 5 and of 64 images launching, for
    the 3x3 model, exactly the 2x2 model's counters less the pool's (4
    convs a call, none on the direct kernel or the gather); the 3x3 model's
    float32 logits within 1e-4 of the plain versions on the card, bf16
    within 5e-2 x max(1, max|f32|) of float32 with its argmax."""
    imgs5, imgs64 = synthetic_images(rng, 5), synthetic_images(rng, 64)
    x = torch.from_numpy(imgs64).cuda()
    total, lines, logits = {}, [], {}
    for dtype in (None, BF16):
        tag = "bf16" if dtype else "float32"
        counts = {}
        for window, model in models.items():
            engine = serving.InferenceEngine(model, buckets=BUCKETS,
                                             device="cuda",
                                             compute_dtype=dtype)
            engine.warmup()
            replays_match_eager(engine, rng, f"{window}x{window} {tag}")
            (got, counts[window]) = counted(lambda: (engine.predict(imgs5),
                                                     engine.predict(imgs64)))
            add_up(total, counts[window])
            for (labels, probs), n in zip(got, (5, 64)):
                check(labels.dtype == np.int32 and labels.shape == (n,)
                      and bool(np.isfinite(probs).all())
                      and bool((labels == probs.argmax(-1)).all()),
                      f"{window}x{window} {tag}: labels {labels.dtype} "
                      f"{labels.shape}")
            del engine
        c2, c3 = counts[2], counts[3]
        check(any(k.startswith(P27_POOL_KEYS) for k in c2)
              and not any(k.startswith(P27_POOL_KEYS) for k in c3)
              and c3 == without_pool(c2)
              and c3["conv2d_bias_relu.launches"] == 4 * 2,
              f"{tag}: the 3x3 model's launches {c3} against the 2x2 "
              f"model's {c2}")
        no_fallback(c3, f"3x3 {tag} serving")
        with torch.no_grad():
            logits[tag] = models[3](uint8_normalize(x),
                                    compute_dtype=dtype).float()
        lines.append(f"{tag}: replays bit-equal at buckets {BUCKETS}; "
                     f"launches of 2 bucket calls {c3}, the 2x2 model's "
                     f"less its {c2['max_pool2d_fwd.launches']} pool "
                     f"launches")
    with torch.no_grad(), plain_versions():
        plain = models[3](uint8_to_float(x))
    dev_plain = (logits["float32"] - plain).abs().max().item()
    check(dev_plain <= LOGIT_ATOL, f"3x3 logits against the plain versions "
          f"on the card: {dev_plain:.3g}")
    d16, scale = scaled_dev(logits["bf16"], logits["float32"])
    check(d16 <= BF16_MODEL_TOL * scale, f"3x3 bf16 logits against float32: "
          f"{d16:.3g} (scale {scale:.3g})")
    # the classes on the six photos, as phase 17 holds the families; on
    # the synthetic images a near tie may flip, counted with its margin
    photos = torch.from_numpy(family_photos()).cuda()
    with torch.no_grad():
        p32, p16 = (models[3](uint8_normalize(photos), compute_dtype=dt)
                    .argmax(-1) for dt in (None, BF16))
    check(bool((p32 == p16).all()), f"3x3 bf16 classes of the photos "
          f"{p16.tolist()} against float32's {p32.tolist()}")
    flips = logits["bf16"].argmax(-1) != logits["float32"].argmax(-1)
    top2 = logits["float32"].topk(2, dim=-1).values
    margins = (top2[:, 0] - top2[:, 1])[flips].tolist()
    lines.append(f"float32 logits (|logit| <= "
                 f"{logits['float32'].abs().max().item():.1f}) max|dev| "
                 f"{dev_plain:.3g} from the plain versions on the card (atol "
                 f"{LOGIT_ATOL}); bf16 {d16 / scale:.3g} x max(1, max|f32|) "
                 f"from float32; the photos' classes {p32.tolist()} in both; "
                 f"{len(margins)} of 64 synthetic images change class in "
                 f"bf16, float32 top-2 margins {margins}")
    return total, lines


def pool33_training(smi: str) -> tuple[dict, list]:
    """The 3x3 model, from the committed weights, ``P27_STEPS`` device-
    dataset steps at batch 256 with the full augmentation, momentum on a
    cosine schedule, in float32 and bf16: finite losses, the mean of the
    last 5 below the first 5, exactly the flagship's launches less the
    pool's (``cli_want``: 4 convs and one rotation a step)."""
    imgs, labels = synthetic_canvases(np.random.default_rng(27), P27_N,
                                      CANVAS)
    ds = DeviceDataset.from_arrays(imgs, labels, device="cuda")
    total, lines = {}, []
    for dtype in (None, BF16):
        tag = "bf16" if dtype else "float32"
        model = pool33_model(3).train()
        opt = make_optimizer("momentum", 1.5e-2, schedule="cosine",
                             total_steps=P27_STEPS)
        ts = create_train_state(model, opt, seed=7)
        adt = dtype or torch.float32
        step = make_device_train_step(
            model, opt, ds, TRAIN_B, compute_dtype=dtype,
            augment_fn=lambda g, im: aug.augment_batch(g, im, dtype=adt))
        torch.cuda.synchronize()
        reset_launches()
        t = time.perf_counter()
        losses = []
        for _ in range(P27_STEPS):
            ts, m = step(ts)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = {k: v for k, v in read_counters().items() if v}
        add_up(total, counts)
        want = without_pool(cli_want(P27_STEPS, 0, dtype is not None, True))
        check(counts == want, f"3x3 {tag} training: launches {counts}, "
              f"expected {want}")
        losses = torch.stack(losses).float().cpu()
        first, last = losses[:5].mean().item(), losses[-5:].mean().item()
        check(bool(torch.isfinite(losses).all()) and last < first,
              f"3x3 {tag} training: losses {losses.tolist()}")
        lines.append(f"{tag}: loss {losses[0].item():.4f} -> "
                     f"{losses[-1].item():.4f} (mean of the first 5 "
                     f"{first:.4f}, last 5 {last:.4f}); "
                     f"{P27_STEPS * TRAIN_B / wall:.1f} img/s over the "
                     f"{P27_STEPS} steps, the first call's capture included "
                     f"({smi}); launches {counts}")
        del model, ts, step
    del ds
    torch.cuda.empty_cache()
    return total, lines


def port_kernel_names() -> set:
    """The ``__global__`` functions of ``cnn_tpu_torch/csrc``."""
    names = set()
    for src in (ROOT / "cnn_tpu_torch" / "csrc").glob("*.cu"):
        names |= set(re.findall(r"__global__[^;{]*?\b(\w+_kernel)\s*\(",
                                src.read_text()))
    return names


def profile_run(cli: dict, tmp: Path):
    """``python -m cnn_tpu_torch.tools.train`` in a fresh process with
    ``--profile-dir``: ``P27_ITERS`` iterations of the float32 flagship
    (device dataset, full augmentation) at batch 64 on phase 14's images,
    validating once; a running process."""
    argv = ["--dataset-path", str(cli["data"]), *cli["sizes"],
            "--checkpoint-dir", str(tmp / "p27_ck"), "--device-dataset",
            "true", "--augment-mode", "full", "--batch-norm", "true",
            "--optimizer", "momentum", "--learning-rate", "1.5e-2",
            "--train-batch-size", str(B), "--total-iters", str(P27_ITERS),
            "--valid-iters", str(P27_ITERS), "--save-iters", str(P27_ITERS),
            "--profile-dir", str(tmp / "p27_trace")]
    return subprocess.Popen(
        [sys.executable, "-m", "cnn_tpu_torch.tools.train", *argv],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def profile_result(proc, tmp: Path) -> str:
    """The run exits 0 after "training done!"; its ``trace.json`` holds
    CUDA kernel events naming the port's conv, normalize and rotation
    kernels. Returns their counts by kernel."""
    out, err = proc.communicate(timeout=600)
    check(proc.returncode == 0 and "training done!" in out,
          f"--profile-dir run: exit {proc.returncode}; output ends "
          f"{out[-1500:]!r}; errors end {err[-1500:]!r}")
    path = tmp / "p27_trace" / "trace.json"
    check(path.is_file(), f"--profile-dir wrote no {path}")
    events = json.loads(path.read_text())["traceEvents"]
    names = port_kernel_names()
    seen: dict = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        for n in set(re.findall(r"\w+_kernel", e.get("name", ""))) & names:
            seen[n] = seen.get(n, 0) + 1
    kinds = {k: sum(v for n, v in seen.items() if n.startswith(k))
             for k in ("conv2d_", "normalize_u8_", "rotate_shear_")}
    check(all(kinds.values()), f"the trace's CUDA kernels name the port's "
          f"{seen}, missing {[k for k, v in kinds.items() if not v]}")
    n_kernels = sum(e.get("cat") == "kernel" for e in events)
    return (f"--profile-dir: {path.stat().st_size} bytes of trace, "
            f"{n_kernels} CUDA kernel events, the port's by kernel {seen}")


def phase27(smi: str, tmp: Path, cli: dict) -> dict:
    """Phase 27: the 3x3/2 AlexNet served and trained beside the 2x2 one,
    no call of the 2x2 pool's plain version on the card, the fast device
    augmentation captured against the eager loop, and the train CLI's
    ``--profile-dir`` (in a fresh process, started first). Returns every
    launch of its counted runs (AlexNet's rows)."""
    t0 = time.perf_counter()
    proc = profile_run(cli, tmp)
    total = {}
    rng = np.random.default_rng(27)
    with taps_on_the_card() as seen:
        models = {w: pool33_model(w).eval() for w in (2, 3)}
        counts, lines = pool33_serving(models, rng)
        add_up(total, counts)
        for line in lines:
            phase(f"phase 27: 3x3/2 AlexNet served, {line}")
        del models
        counts, lines = pool33_training(smi)
        add_up(total, counts)
        for line in lines:
            phase(f"phase 27: 3x3/2 AlexNet trained {P27_STEPS} steps at "
                  f"batch {TRAIN_B}, full augmentation, {line}")
    check(not seen, f"the 2x2 pool's plain version ran on the card: {seen}")
    ds = graph_dataset()
    for case in P27_GRAPH_CASES:
        counts, line = graph_case(case, ds)
        add_up(total, counts)
        phase(f"phase 27: captured calls bit-equal to the eager loop, {line}")
    del ds
    torch.cuda.empty_cache()
    phase(f"phase 27: {profile_result(proc, tmp)}")
    phase(f"phase 27: {time.perf_counter() - t0:.1f} s ({smi})")
    return total


def same_trees(a, b) -> bool:
    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a) == sorted(b)
                and all(same_trees(a[k], b[k]) for k in a))
    return np.array_equal(np.asarray(a), np.asarray(b))


def ptxas_report(log: str) -> dict:
    """kernel -> (its ``Used ... registers ... smem`` line, its spills) from
    ``-Xptxas -v``; a template's arguments are kept, shortened, in the name."""
    out, name = {}, None
    spills = ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            # _Z[N] <len><namespace> <len><name> I<template args>E ...
            rest, base = re.sub(r"^_ZN?", "", mangled), mangled
            while (hit := re.match(r"(\d+)", rest)):
                n, rest = int(hit.group(1)), rest[len(hit.group(1)):]
                base, rest = rest[:n], rest[n:]
            targs = rest.split("EEv")[0]
            args = "x".join(re.findall(r"L[ib](\d+)E", targs)) or {
                "If": "f32", "I13__nv_bfloat16": "bf16"}.get(targs, "")
            name = base.replace("_kernel", "") + (f"<{args}>" if args else "")
        elif name and "spill stores" in ln:
            spills = ("" if ln.strip().startswith("0 bytes stack frame, 0 "
                                                  "bytes spill stores, 0 bytes"
                                                  " spill loads")
                      else ln.strip())
        elif name and "Used" in ln and "registers" in ln:
            out[name] = (ln.split("info    :")[-1].strip(), spills)
            name = None
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one NVIDIA GPU",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase(f"environment: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; TF32 off; "
          f"allow_bf16_reduced_precision_reduction "
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}"
          " (the port turns it off around its own bf16 products)")

    _build.load()
    report = ptxas_report(_build.build_log)
    if _build.build_seconds is not None:
        new = [f"conv2d_strip<{r}x{pad}x{k3}>" for r in STRIP_ROWS
               for pad in (0, 1) for k3 in (0, 1)] + [
            "maxpool2x2_bwd_window<f32>", "maxpool2x2_bwd_window<bf16>",
            "maxpool2x2_fwd<bf16>", "maxpool2x2_fwd_window<f32>",
            "maxpool2x2_fwd_window<bf16>", "normalize_u8_wide<1>",
            "normalize_u8_wide<0>", "resize_linear_u8"] + [
            f"conv2d_bf16<{mt}x{nt}x{v}>" for mt, nt in BF16_TILES
            for v in (0, 1)] + [
            f"conv2d_bf16_strip<{r}x{int(wide)}x{nt}>"
            for r, wide in BF16_STRIP_TILES for nt in (2, 4, 8)] + [
            f"conv2d_bf16_wgmma<{'x'.join(map(str, t))}>"
            for t in WGMMA_TILES] + [
            f"conv2d_bf16_tma<{'x'.join(map(str, t))}>" for t in TMA_TILES] + [
            f"conv2d_pw<{'x'.join(map(str, t))}x{full}>" for t in PW_TILES
            for full in (0, 1)]
        check(all(n in report for n in new), f"ptxas reported no "
              f"{[n for n in new if n not in report]}: {sorted(report)}")
    for name, (regs, spills) in report.items():
        check(not (name.startswith(("conv2d_tiled", "conv2d_strip",
                                     "conv2d_pw",
                                     "conv2d_bf16", "maxpool2x2_fwd",
                                     "maxpool2x2_bwd_window", "rotate_shear",
                                     "normalize_u8_wide", "resize_linear_u8"))
                   and spills), f"{name} spills: {spills}")
    # ptxas's advisories on wgmma (e.g. a pipeline it serializes)
    advice = [ln.strip() for ln in _build.build_log.splitlines()
              if "wgmma" in ln and "Compiling entry" not in ln
              and "Function properties" not in ln]
    phase(f"build: wgmma advisories from ptxas: {advice or 'none'}")
    phase(f"build: {_build.library_path()} "
          + (f"built in {_build.build_seconds:.1f}s; " + " | ".join(
              f"{name}: {regs}, {spills or 'no spills'}"
              for name, (regs, spills) in report.items())
             if _build.build_seconds is not None else "(already built)"))

    model = get_model("alexnet", num_classes=3, batch_norm=True,
                      image_size=224, device="cuda")
    load_reference_model(model, MODEL)
    model.eval()
    measured = kernel_phase(model)
    off_path_phase()
    launches = serving_phase(model)
    measured.update(train_kernel_phase())
    grad_parity_phase()
    trained, f32_stats = training_phase()

    gen = torch.Generator(device="cuda").manual_seed(11)
    conv16, conv16_ms = bf16_conv_phase(gen)
    tma = tma_phase(gen)
    stem_phase(gen)
    pw_phase(gen)
    pool16 = bf16_pool_phase(gen)
    bf16_function_phase(gen)
    counts16 = bf16_training_phase(f32_stats)
    served16 = bf16_serving_phase(model)
    committed_ckpt_phase()
    with tempfile.TemporaryDirectory() as tmp:
        cli, flagship = cli_phase(Path(tmp))
        add_up(cli, inference_phase(smi, Path(tmp)))
        add_up(cli, evaluation_phase(smi, Path(tmp), flagship))
        # the families (phases 17-18), each counted run with the counters
        # at 0 just before it
        fam = families_serving_phase(smi)
        add_up(fam, pw_models_phase(smi))
        family_function_phase(gen)
        pipecnn_memory_phase(smi)
        add_up(fam, families_training_phase(smi, Path(tmp), flagship))
        # the training toolbox (phase 19): the AlexNet-only runs count on
        # the CLIs' rows, those with a resnet10 on the families'
        tool_alex, tool_fam = toolbox_phase(smi, Path(tmp), flagship)
        add_up(cli, tool_alex)
        add_up(fam, tool_fam)
        # phase 20: its normalize, pool and tma launches count on those
        # rows, MoECNN's convs on rows of their own (its stem on stem_64's)
        p20, moe20, rows20 = phase20(smi, Path(tmp), flagship, gen)
        add_up(fam, stem_counts("moecnn", moe20))
        # phase 21: every run's normalize and pool launches count on those
        # rows, AlexNet's convs on its conv rows, the families' convs on
        # theirs (fam21: conv counters and stem strips only)
        p21, alex21, fam21 = phase21(smi, Path(tmp))
        add_up(fam, fam21)
        # phase 22: AlexNet's runs count on the CLIs' rows, resnet10's and
        # PipeCNN's on the families'
        alex22, fam22 = phase22(smi, Path(tmp), flagship)
        add_up(cli, alex22)
        add_up(fam, fam22)
        # phase 23: every rank's launches count on AlexNet's rows
        add_up(cli, phase23(smi, Path(tmp), flagship))
        # phase 24: the AlexNet runs' launches count on its rows,
        # resnet10's on the families'
        alex24, fam24 = phase24(smi, Path(tmp), flagship)
        add_up(cli, alex24)
        add_up(fam, fam24)
        # phase 25: every PipeCNN launch counts on the families' rows
        fam25 = phase25(smi, Path(tmp), flagship)
        add_up(fam, fam25)
        add_up(fam, stem_counts("pipecnn", fam25))
        # phase 26: the CLI runs' launches count on AlexNet's rows, the
        # resize launches on the resize row
        resize_n, resize_row, alex26 = phase26(smi, Path(tmp), flagship)
        add_up(cli, alex26)
        # phase 27: every launch counts on AlexNet's rows
        add_up(cli, phase27(smi, Path(tmp), flagship))

    # the CLIs' launches (phases 14-16): float32 ones on the float32 rows,
    # the rotation in either dtype on its one row
    cli_f32 = {name: cli.get(f"{name}.launches", 0)
               - cli.get(f"{name}.launches_bf16", 0) for name in KERNELS}
    # the families' float32 launches of the kernels they share with AlexNet
    # (normalize, pool, rotation); their convs have rows of their own
    fam_f32 = {name: alex21.get(f"{name}.launches", 0)
               - alex21.get(f"{name}.launches_bf16", 0)
               if name == "conv2d_bias_relu" else
               fam.get(f"{name}.launches", 0)
               - fam.get(f"{name}.launches_bf16", 0)
               + p20.get(f"{name}.launches", 0)
               - p20.get(f"{name}.launches_bf16", 0)
               + p21.get(f"{name}.launches", 0)
               - p21.get(f"{name}.launches_bf16", 0) for name in KERNELS}
    kernels = [entry(name, launches.get(name, 0) + trained[name]
                     + cli_f32[name] + fam_f32[name], *measured[name])
               for name in KERNELS]
    # the bf16 rows, as the float32 ones: the conv's four layers and the
    # pool forward at B = 64 (the serving shapes), the pool backward at the
    # training batch; through the wrapper
    c64 = conv16_ms[B]
    rows16 = {
        "conv2d_bias_relu_bf16": (conv16[0], c64["ms"], c64["plain"],
                                  c64["lib"], (c64["bound"],
                                               c64["bound_by"])),
        "max_pool2d_fwd_bf16": (0.0, pool16[B]["fwd"][0], pool16[B]["fwd"][2],
                                pool16[B]["fwd"][3], pool16[B]["fwd"][4]),
        "max_pool2d_bwd_bf16": (0.0, pool16[TRAIN_B]["bwd"][0],
                                pool16[TRAIN_B]["bwd"][2],
                                pool16[TRAIN_B]["bwd"][3],
                                pool16[TRAIN_B]["bwd"][4]),
    }
    kernels += [entry(name, counts16.get(counter, 0)
                      + served16.get(counter, 0) + cli.get(counter, 0)
                      + (alex21.get(counter, 0)
                         if name == "conv2d_bias_relu_bf16"
                         else fam.get(counter, 0) + p20.get(counter, 0)
                         + p21.get(counter, 0)),
                      *rows16[name])
                for name, counter in BF16_KERNELS.items()]
    # the tma kernel's row: its launches over every counted run, timed at
    # AlexNet's conv4 at B = 64
    tma_key = "conv2d_bias_relu.launches_bf16_tma"
    kernels.append(entry("conv2d_bias_relu_bf16_tma", sum(
        c.get(tma_key, 0) for c in (counts16, served16, cli, fam, p20, p21))
        - fam21.get(tma_key, 0),
        tma["err"], tma["ms"], tma["plain"], tma["lib"], tma["bound"]))
    kernels += family_rows(gen, fam) + rows20
    kernels.append(entry("resize_linear_u8", resize_n, *resize_row))
    phase("all checks passed")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and fail loudly.

    python3 chip_smoke.py [--seed N] [--requests N] [--clients N]
                          [--train-steps N] [--json PATH] [--phase N]

``--phase N`` runs phases 1-3 and then phase N alone (16 and 17 also
phase 9, whose decoder they read), and prints no kernel table; without
it every phase runs.

Phases (none catches its own failure; there is no CPU path):

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
2. build every kernel of the serving and training paths from
   ``mxnet_tpu_torch/csrc`` (one ``nvcc`` per source, all at once) and
   print ptxas' register and shared-memory lines;
3. kernels against their plain PyTorch versions on the card, in float32
   and bfloat16, with kernel, plain and library times beside the least
   time the card could take: K1 ``fu_mm_fwd`` (with and without
   statistics), K2 ``fu_mm_skip_fwd``, K3 ``fu_c3_fwd2d`` and K4
   ``fu_c3_fwd4d`` (with and without statistics) at the four ResNet-50
   stage shapes at batch 8; K5 ``fu_mm_bwd`` (conv3's final and conv1's
   deferred shapes), K6 ``fu_c3_bwd2d`` and K7 ``fu_c3_bwd4d`` at the four
   stage shapes and K8 ``nn_conv1x1_bwd`` at its three 224x224 sites, at
   batch 32; each also launched twice on the same inputs to show equal
   bits, and its TFLOP/s logged (all on the tensor cores: K1, K2, K3, K5,
   K6 and K8 on ``csrc/fu_mma.cuh``, K4 and K7 on its halo-resident form
   ``csrc/fu_halo.cuh``); K2-K8 and their library calls also timed with
   the L2 cache flushed before each call;
4. serve: ResNet-50 (224x224, 1000 classes, NHWC, fused units, weights
   from ``--seed``) saved as a checkpoint, loaded by
   ``ServingEngine.from_checkpoint`` on cuda:0, warmed up, and sent
   ``--requests`` requests from ``--clients`` threads, once with the
   units' 3x3 in the row layout (K3) and once under
   MXNET_FUSED_UNIT_C3=4d (K4); every answer is held against the same
   graph run through the kernels' plain versions, and the forward
   kernels of the mode must have launched 12 times (the 12 fused units)
   per dispatched batch and every other kernel not at all;
5. train: the same ResNet-50 through ``Module.fit`` on cuda:0 for
   ``--train-steps`` SGD steps at batch 32 on one seeded batch with random
   labels, with MXNET_CONV1X1_FUSED_BWD=1, once per mode.  The main path
   (cuDNN free to choose) must launch K1 12, K2 12, K3 12, K5 24, K6 12 and
   K8 3 times per step (4d: K4 and K7 in place of K3 and K6), keep every
   loss and parameter finite and lower the loss; it gives the step time,
   images/s, peak memory and one profiled step.  Then, with cuDNN
   deterministic, runs from the same weights through the kernels,
   MXNET_FUSED_UNIT_C3=xla, the plain versions on the batch reversed and
   five faults planted at K5's, K6's, K7's and K8's launch are each held
   against the plain versions' run by the losses and step 1's gradients
   (the two main-path runs too): every sound run must pass and every fault
   must fail;
6. bench: ``bench.py``'s training step (ResNet-50 224x224, NHWC, stem
   ``fused``, bfloat16 parameters, f32 aux states, uint8 input scaled in
   the step, SGD at lr 0.05, batch 256, weights from ``--seed``) through
   ``bench_step.TrainStep`` on cuda:0, one warm-up and five timed steps on
   one seeded batch, in three configurations: ``bench`` (bench.py's own
   ``unit_impl="plain"``: cuDNN and cuBLAS, no hand-written kernel),
   ``fused2d`` (fused units, MXNET_CONV1X1_FUSED_BWD=1: K1, K2, K3, K5
   twice, K6 and K8) and ``fused4d`` (also MXNET_FUSED_UNIT_C3=4d: K4 and
   K7 in place of K3 and K6).  Each gives its step time, images/s, peak
   memory, one profiled step and its launches per step, which must be
   the table's; its losses must be finite and fall, and step 1's loss
   must be within 2e-2 of one f32 forward of the same weights.  For the
   fused configs, step 1's gradients through the kernels, in bf16 and
   from the same weights in f32 (each bf16 kernel call also held against
   its plain version on the same inputs), are held against the same step
   through the plain versions, beside two controls (the batch reversed,
   conv0_weight one step away) from which the limits come; a fault
   planted at K2's launch (its residual dropped) must fail.  First, the
   fused stem is held against BatchNorm + Convolution in f32 at batch
   256, and with its dbeta zeroed (a planted fault) must fail that;
7. ImageNet: ``examples/train_imagenet.py``'s path (``examples/common.py``'s
   ``fit``) at full width.  512 training and 256 validation records of
   random uint8 pixels at 256x256 (bench.py's ``_make_raw_rec``, through
   the port's ``recordio``, in a temporary directory); the example's
   ``ImageRecordIter`` (224x224 NHWC, its mean and std, raw records, one
   thread per host core; random crop, mirror and shuffle for training)
   timed alone in uint8 (bench.py's ``pipeline_images_per_sec``) and
   float32, and over JPEG records where cv2 or PIL is installed; then
   ``Module.fit`` of ResNet-50 in f32 at batch 256 for 2 epochs of 2
   steps (SGD at lr 0.05, momentum 0.9, wd 1e-4, a MultiFactorScheduler
   decaying 10x after update 2, Xavier from ``--seed``, validation and a
   checkpoint each epoch), with the example's ``unit_impl="plain"``
   (cuDNN only) and with the fused units and MXNET_CONV1X1_FUSED_BWD=1
   (K1, K2, K3, K5 twice, K6, K8 a step; K1-K3 a validation batch), each
   counted, timed, profiled and its peak memory read.  Checks: the first
   8 images of the first batch each equal a 224x224 window of their own
   record, mirrored or not (every offset, normalized in numpy, 1e-5) with
   the record's label; the rate 0.05 at updates 1-2 and 0.005 at 3-4;
   finite losses and validation accuracy; the fused fit's step-1 loss
   within 1e-3 of the plain fit's; the checkpoint files, checkpoint 2
   equal to the parameters bit for bit, and a fit resumed from checkpoint
   1 (begin_epoch=1) running its epoch; each kernel call of one fused step,
   and of the same step with the 3x3 on 4D tiles (K4, K7), and its plain
   version against the plain version in f64 (the kernel
   within 1e-4 of the plain version, and within 4x the plain version's
   error of the f64 value, or 2e-6 where that is smaller); an image
   flipped vertically and a scheduler
   decaying one update early are planted faults that must fail.  Last,
   bench.py's step (config ``bench``) on a resident batch and fed each
   step by a new uint8 batch from the pipeline, copied to the card;
8. the KV-cache writes K9 ``cache_write_row`` and K10 ``cache_write_rows``
   against their plain versions at 8 and 64 slots, max_len 128 and 2048,
   d 200, in float32, float16 and bfloat16, with edge positions, windows
   straddling the end and counts 0..5: the whole cache bit-identical, and
   untouched outside the written rows; timed beside the one-hot blend they
   replace, one ``index_put_`` and their bound;
9. decode: the attention decoder of ``perf/decode_bench.py``
   (``build_spec_models``, copied here: vocab 10000, d 200, 6 blocks,
   max_len 128, weights from ``--seed``) served by ``DecodeEngine`` on
   cuda:0 with 8 slots, 64 requests (geometric lengths of mean 16, 8 with
   4-16-token prompts) at k = 0, 2 and 4 (the 1-block draft).  Every
   stream must equal the k=0 engine's, ``greedy_decode``'s through the
   kernels, the engine's with the plain scatter and with selection off;
   the served graph must hold 12 ``_cache_write_row`` and no ``one_hot``,
   and K9 and K10 must launch exactly as the graphs imply per step.  Each
   engine's step and draft verdicts must be row-local and its selections
   (step, draft and commit) adopted through the optimizer's verdict gate
   (``SELECT_OPT_PASSES``).
   Tokens/s, step p50/p99, accept rate and tokens per step, and one
   profiled step at k = 0 and 4;
10. the imperative path: ``mt.nd._contrib_FusedBottleneckUnit`` at the
   four stage shapes at batch 32 under ``autograd.record()`` and
   ``backward()`` in 4d mode: K1, K2, K4, K5 (twice) and K7 once per
   unit, and the output and ten gradients bit-equal to the same unit
   through ``Symbol.bind`` and ``Executor.backward``;
11. rtc (K11): CUDA C++ written at run time (``RTC_SOURCE``) compiled by
   ``rtc.CudaModule`` and installed by ``rtc.register_kernel_op``:
   ``add_one`` over 16M float32 through ``mt.nd``, a bound symbol and a
   second thread, bit-equal to ``x + 1``, and a swish pair registered
   with ``vjp=`` whose gradient through ``Executor.backward`` is held
   against torch autograd on the formula; timed beside ``x + 1``;
12. MNIST: ``examples/train_mnist.py``'s path (``examples/common.py``'s
   ``fit``) on cuda:0: LeNet at its published widths over the example's
   synthetic stand-in (made in numpy as the example makes it), SGD at
   batch 64 for 5 epochs with validation; each epoch's training accuracy,
   the final validation accuracy (within 0.02 of the JAX package's on the
   same run), the step time and the device idle share.  Then every
   optimizer the port registers (SGD and its fourteen others, RMSProp
   also centered) for one epoch of 28 steps from the same host weights,
   on the card and on the CPU in the same process, held against each
   other by the losses and step 1's parameters (the sign optimizers by
   the share of agreeing elements) within limits from a float64 control,
   the loss falling; Adam without its bias correction and NAG as plain
   momentum are planted faults that must fail.  A checkpoint with the
   optimizer's states after epoch 1, resumed by ``Module.load`` in a fresh
   module, must give the uninterrupted run's epoch 2 bit for bit (cuDNN
   deterministic for this step only), and ``fit(monitor=Monitor(1,
   ".*"))`` the CPU's stats.  No hand-written kernel runs on this path;
13. Gluon: ``gluon.model_zoo.vision.resnet50_v2(classes=1000)`` (224x224
   NCHW, weights from ``--seed`` through ``convert.gluon_params_from_numpy``)
   trained through ``Trainer`` (SGD 0.05, momentum 0.9, wd 1e-4) and
   ``SoftmaxCrossEntropyLoss`` at batch 64 for 3 steps imperatively and 3
   hybridized (``CachedOp``) on the same batches: step 1's loss, every
   gradient and the moving statistics after each step equal bit for bit
   (cuDNN deterministic), and step 1's gradients again through the net's
   symbol bound by ``Module``; each mode's median step, images/s, peak
   memory and one profiled step.  Then the fused symbolic ResNet-50 as a
   ``SymbolBlock``: a batch-8 forward equal to ``Predictor``'s bit for bit
   in both 3x3 modes (K1, K2 and K3, or K4, 12 launches each), and one
   batch-32 training step under ``autograd.record()`` with
   MXNET_CONV1X1_FUSED_BWD=1 equal to the Executor's gradients bit for
   bit (K1/K2/K3/K5/K6/K8 12/12/12/24/12/3); K5 with its dW zeroed is a
   planted fault that must fail;
14. RNN: ``examples/rnn_ptb.py``'s path on cuda:0 at the example's
   widths (hidden 200, embed 200, 2 layers, batch 32, buckets 10-40, SGD
   at lr 1.0, Xavier, ``Perplexity(ignore_label=0)``) over its synthetic
   corpus (copied here): ``BucketingModule`` over two unrolled LSTMCells
   for 2 epochs (cut from 10); perplexity must fall and step 1's
   gradients be within 1e-3 (relative L2) of the port's CPU run from the
   same weights and batch.  Then PTB's vocabulary (10000) through
   ``models/lstm_lm.py``'s fused RNN op for one epoch over a seeded Zipf
   corpus of 2000 sentences of 6-40 tokens; one batch of bucket 40 fused
   against the example's unrolled cells with the weights carried by
   ``FusedRNNCell.unpack_weights`` (loss within 1e-5 relative, every
   gradient within 1e-4 relative L2), and with layer 0's i and f gate
   blocks swapped in the blob, a planted fault that must fail.  Then
   ``gluon.rnn.LSTM(200, num_layers=2)`` on (40, 32, 200) TNC:
   hybridized equal to imperative bit for bit, and the same weights as
   LSTMCells (imperative and hybridized, bit for bit) within 1e-5.  Step
   ms by bucket, non-padding tokens/s, one profiled step's idle share and
   peak memory for both models.  No hand-written kernel runs here (the
   JAX op is a ``lax.scan``, no Pallas kernel); the counters must read 0;
15. SSD: ``examples/train_ssd.py``'s path on cuda:0 at its published
   widths: ``vgg16_reduced`` (ceil-mode pool3, atrous fc6) with 20 classes
   and background, 300x300, 6 scales, 8040 anchors, 25,167,662
   parameters in float32.  256 seeded JPEG records of 320-400 pixels a
   side, each with 1-8 boxes filled in their class's colour (labels by
   ``pack_det_label``, padded to 24), read by ``io.ImageDetRecordIter``
   with the example's arguments (batch 32, mirror, crop with probability
   0.5, shuffle, its means, the threaded pool); Xavier weights from
   ``--seed`` carried by ``convert.params_from_numpy``; ``Module.fit``
   with its settings (SGD, lr 0.004, momentum 0.9, wd 1e-4, kvstore
   local) for 3 epochs of 8 steps, ``eval_metric`` ``Loss`` over
   loc_loss_output (the default "acc" raises).  The median step,
   images/s, one profiled step, peak memory and the masked class
   cross-entropy, which must fall.  Step 1 of the first batch's first 4
   images on the card against the port on the CPU from the same weights:
   the gradients within 10x a control (the CPU's f32 step against its
   f64 step), MultiBoxTarget's cls_target and loc_mask equal apart from
   the printed anchors flipped by mining ties, loc_target within 1e-5;
   ``_encode_box`` with x and y swapped on the card is a planted fault
   that must fail.  Then the detect graph with the trained weights
   through ``Predictor`` at batch 32, nms_topk 400: output (32, 8040,
   6), ms a batch, MultiBoxDetection's ms and its NMS loop's share, peak
   memory, and the kept detections of 2 images equal to the CPU
   ``Predictor``'s (class ids equal, scores and boxes within 1e-5).  No
   hand-written kernel runs here (the JAX ops are ``jnp`` code and VGG's
   convolutions were never Pallas kernels); the counters must read 0;
16. analysis (``mxnet_tpu_torch.analysis`` and the gates it drives):
   (a) the fused ResNet-50 of phase 4 (224x224, NHWC) served as one batch
   of 32 seeded requests by ``ServingEngine`` on cuda:0 (``max_batch``
   32) with ``MXNET_SERVE_OPTIMIZE`` on and off: the preflight's batch
   verdict must be row-local, the optimizer's plan accepted with no
   crash or rejection warning, the two runs' probabilities equal bit for
   bit and K1-K3 launched 12 times a batch; the plan's actions and the
   report's counts are printed.  The fused ResNet gives the default
   passes nothing to rewrite, so a second graph does: ResNet-50's
   classifier over 2048 pooled features with a per-class scale built from
   creation ops and a duplicated ``tanh`` (``folding_head``), served the
   same way; its plan must fold, merge and sweep, the baked scale must be
   the card's ``exp``, and its bits must agree on against off.  (b) the
   decoder's verdicts and gated selections, held in phase 9's runs, are
   reported here.  (c)
   ``count_flops`` of ``bench_step.TrainStep``'s ResNet-50 step on its
   plain graph (conv7 stem, plain units) at 224x224, batch 256,
   bfloat16, against ``FlopCounterMode`` over one eager step of it on
   the card: within 10%.  (d) ``predict_peak_bytes`` of (a)'s forward
   and (c)'s step beside ``torch.cuda.max_memory_allocated`` over the
   same runs (the ratio is printed, not held); ``device_memory_budget``
   positive and at most the card's memory.  (e) planted faults: a served
   softmax over the batch axis raises ``AnalysisError`` under
   ``MXNET_ANALYSIS_STRICT=1``, and without it serves at ``max_batch=1``
   with a warning, each answer bit for bit a batch-1 ``Predictor``'s; a
   decode step summing its state over the slot axis raises under strict.
   One JSON line ``{"analysis": {...}}`` sums it up;
17. serving: (a) phase 4's fused ResNet-50 (224x224) under
   ``overload_policy="shed-oldest"`` with ``max_queue`` 4: 32 requests
   staged on a stopped engine, 28 shed with ``ServerOverloadError``, none
   rejected, the 4 survivors against the plain versions' Predictor (phase
   4's tolerance) and K1-K3 12 times a batch; the memory preflight's
   watermark for each warm program beside ``max_memory_allocated``,
   nothing refused; ``MXNET_SERVE_PAD_CHECK=1`` silent on ResNet-50 (K1-K3
   24 times a batch: two dispatches) and failing ``softmax(axis=0)``
   with "contamination" (analysis off).  (b) ``models/lstm_lm.py``'s
   model at PTB's widths (vocab 10000, 200, 200, 2 layers; begin states
   from ``_begin_state``, ``FullyConnected(flatten=False)``, softmax)
   served per request with ``seq_axis=0`` and ``examples/rnn_ptb.py``'s
   buckets (10, 20, 30, 40), ``max_batch`` 8, 32 requests of lengths
   3-40: the padding pass gives the JAX package's verdicts (cross-position
   along batch and seq), so the engine serves exact lengths one at a
   time, each within 1e-6 of a Predictor ``reshape``d to its length; the
   seq-axis softmax over (T, 200) served from the grid through the
   masking repair (``MXNET_SERVE_REPAIR=1``, at most 16 programs, all
   built at warmup) and at exact lengths without it, within 1e-6 of the
   exact softmax.  (c) phase 9's decoder under ``TemperatureSampler(0.8,
   top_k=40, seed=--seed)`` at k = 0, 2 and 4 (32 of phase 9's
   requests): two engines replay every stream bit for bit, K9 and K10
   launch as the graphs imply, the target as its own draft at k = 2
   accepts every proposal, ``top_k=1`` at k = 2 gives phase 9's greedy
   streams; tokens/s, accept rate, tokens per step.  (d)
   ``perf/decode_bench.py``'s ``build_prefill_model`` (copied here) at
   vocab 10000, d 200, 8 slots, 32 requests with 4-24-token prompts:
   coalesced, serial (``MXNET_DECODE_COALESCE_PREFILL=0``) and
   teacher-forced give the same tokens, prefill with spec k = 2 gives
   ``greedy_decode``'s, fewer step dispatches with prefill; the decode
   memory preflight beside ``max_memory_allocated``.  One JSON line
   ``{"serving": {...}}`` sums it up;
18. telemetry (``mxnet_tpu_torch.telemetry`` and ``profiler``): (a) phase
   4's fused ResNet-50 (224x224) served by a ``ServingEngine`` built with
   telemetry off (its 32 staged requests must move no instrument) and
   one with it on, the HTTP server on port 0: every route answers 200
   (``/events`` opens its stream), the request and batch counters and
   the latency histogram's count equal ``stats()``, a served request's
   span tree is queue-wait, coalesce, pad, dispatch, unpad, the measured
   memory-peak gauge equals ``max_memory_allocated``, the fused graph is
   left unpriced (an empty FLOPs ledger, every dispatch counted under
   ``mxnet_serve_unpriced_dispatches_total``) while the plain graph of
   the same model, served one batch of 8, has a ledger equal to
   ``count_flops`` of its served graph, K1-K3 launch 12 times a batch
   and the probabilities equal the telemetry-off engine's bit for bit.
   (b) phase 5's fit (batch 32, MXNET_CONV1X1_FUSED_BWD=1, cuDNN
   deterministic) for 16 steps with telemetry on: the phases' self-times
   cover at least 95% of the step wall, the fused graph is left unpriced (its units fall to
   ``count_flops``'s default rule, so no step FLOPs or MFU gauge), MFU is
   ``count_flops(..., training=True)`` of the plain graph of the same
   model against ``peak_flops_for`` (989 TFLOP/s on the H100 SXM), the
   program-build counter is flat after step 1, one step compiles,
   K1/K2/K3/K5/K6/K8 launch 12/12/12/24/12/3 a step, and every fit of
   (e) gives the same parameters bit for bit.  (c) phase 9's decoder at
   k = 0 (an untimed run, then the pairs of (e)) and k = 2: the token and
   step counters equal ``stats()`` (0 with telemetry off), K9/K10 launch
   as the graphs imply, every request's tokens equal the untimed run's.
   (d) ``start_xla_trace``/``stop_xla_trace`` around one served batch
   hold CUDA events of ``fmma::mma_kernel`` for K1-K3's launches, and
   ``dump_profile()`` after one Executor step holds its ``forward``,
   ``forward_backward`` and ``update`` spans.  (e) telemetry on against
   off in 10 pairs of turns, the order alternating, each turn on an engine
   or Module of its own and with telemetry off no thread of the plane
   alive and no instrument moved: serving latency p50/p99 and images/s
   (bursts of 128 requests from 4 clients, 6 a turn), decode tokens/s
   (the jobs 3 times a turn) and the fit's step ms (steps 2-16); each
   setting's median, each pair's difference, and whether a sign test
   over the pairs resolves it (p < 0.05).  One JSON line
   ``{"telemetry": {...}}`` sums it up;
19. the kernel table (K1-K11) as one JSON line, then the result line
   ``{"ok": true, "device": {...}}``.

TF32 is off throughout (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``), so float32 means float32 on both
sides of every comparison; K1-K8 compute their float32 products on the
tensor cores through 3xTF32, which keeps float32's accuracy (the same
tolerances hold them).  ``--json`` also writes every measurement to a
file.
"""
import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# ResNet-50 at 224x224: per stage (rows per image, unit width C, fused units)
STAGES = [(56 * 56, 256, 2), (28 * 28, 512, 3), (14 * 14, 1024, 5),
          (7 * 7, 2048, 2)]
STAGE_HW = [56, 28, 14, 7]
BATCH = 8
TRAIN_BATCH = 32
# K8's sites at 224x224: the transition units' stride-1 1x1 convolutions
# with H*W <= 256, as (name, H*W, Ci, Co)
K8_SITES = [("stage3_unit1_conv3", 14 * 14, 256, 1024),
            ("stage4_unit1_conv1", 14 * 14, 1024, 512),
            ("stage4_unit1_conv3", 7 * 7, 512, 2048)]
# the kernels a served (eval) forward launches, 12 times a batch, with the
# unit's middle conv in its row layout (MXNET_FUSED_UNIT_C3 auto) and on
# 4D tiles (4d); every other kernel must not launch there
SERVE_KERNELS = {"2d": ("mm_fwd", "c3_fwd2d", "mm_skip_fwd"),
                 "4d": ("mm_fwd", "c3_fwd4d", "mm_skip_fwd")}
# launches of each kernel per training step: 12 fused units (K5 twice in
# each), K8's three sites; every other kernel (the other 3x3 pair, the
# cache writes, runtime kernels) none
TRAIN_LAUNCHES = {
    "2d": {"mm_fwd": 12, "mm_skip_fwd": 12, "c3_fwd2d": 12, "mm_bwd": 24,
           "c3_bwd2d": 12, "conv1x1_bwd": 3},
    "4d": {"mm_fwd": 12, "mm_skip_fwd": 12, "c3_fwd4d": 12, "mm_bwd": 24,
           "c3_bwd4d": 12, "conv1x1_bwd": 3}}
# launches of each kernel for one imperative fused unit, forward and
# backward, in 4d mode
UNIT_LAUNCHES = {"mm_fwd": 1, "c3_fwd4d": 1, "mm_skip_fwd": 1, "mm_bwd": 2,
                 "c3_bwd4d": 1}
# K11: runtime-written kernels, compiled by rtc.CudaModule: the twin of
# the reference's Pallas add_one (tests/test_custom_sparse.py) and a swish
# forward / backward pair registered with vjp=
RTC_SOURCE = r"""
extern "C" __global__ void add_one(const float* x, float* y, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] + 1.0f;
}
extern "C" __global__ void swish_fwd(const float* x, float* y, float* s,
                                     float beta, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    float v = 1.0f / (1.0f + expf(-beta * x[i]));
    s[i] = v;
    y[i] = x[i] * v;
  }
}
extern "C" __global__ void swish_bwd(const float* x, const float* s,
                                     const float* g, float* dx, float beta,
                                     int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) dx[i] = g[i] * (s[i] + beta * x[i] * s[i] * (1.0f - s[i]));
}
"""
RTC_N = 1 << 24                 # add_one over 16M float32
RTC_SWISH_SHAPE = (64, 1024)
# swish's gradient through the Executor against torch autograd on the
# formula: the same f32 expression, expf against torch's sigmoid
RTC_SWISH_RTOL = 1e-6
# The attention decoder of perf/decode_bench.py build_spec_models at the
# widths of the repo's language-model configuration (models/lstm_lm.py,
# PTB: vocab 10000, d 200), the benchmark's depth and tail scale, and the
# decode engine's default slot pool (MXNET_DECODE_SLOTS, _MAX_LEN)
DECODER = dict(vocab=10000, d=200, max_len=128, layers=6, tail_scale=0.05)
DECODE_SLOTS = 8
# traffic: decode_bench.make_jobs's recipe (1-token prompts, geometric
# output lengths of mean 16), 8 of the requests given 4-16-token prompts
DECODE_REQUESTS, DECODE_MEAN_NEW, DECODE_PROMPTED = 64, 16, 8
SPEC_KS = (2, 4)
# K9/K10 shapes: the engine's slot pool and a 64-slot one, its max_len and
# a long context, the decoder's d; K10's window is the widest, k + 1 = 5
KV_SLOTS, KV_T, KV_WINDOW = (8, 64), (128, 2048), 5
# H100 SXM peaks (NVIDIA data sheet, dense), the least time bounds take: bf16
# in the tensor cores, and HBM3 bandwidth.  float32 products at float32's
# accuracy: 3xTF32 on the tensor cores (each f32 value split into two TF32
# terms, three TF32 products per f32 product, as K1-K8 compute them),
# 495 / 3 = 165 TFLOP/s, faster than FFMA's 67; every f32 product row
# (K1-K8) is bounded at that rate, so no kernel can read above its bound
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
HBM_BYTES_S = 3.35e12
# f32: the same f32 products summed in another order.  bf16: outputs are
# rounded once to bf16 (2^-8 relative) from f32 sums that differ in their
# last bits, so they may sit one bf16 step apart.  Statistics are f32 sums
# over every row.  All relative to the largest magnitude of the reference.
TOL = {"float32": 2e-5, "bfloat16": 2.0 ** -7, "stats": 1e-4}
# backward kernels: dP / dx as the forward outputs; dW, db and dg are f32
# sums over all R rows (up to 100352) in another order, from the same
# rounded operands in both dtypes (bf16 products are exact in f32), except
# K8's dW, which is rounded to the weight's dtype
BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-3}
# each output of each kernel against its plain version on the same inputs
# in the bench phase's bf16 step, as the kernel phases hold them: y, dP and
# dx; the f32 statistics; the f32 sums dW, db and dg
_FWD_TOLS = (TOL["bfloat16"], TOL["stats"], TOL["stats"])
_BWD_TOLS = (TOL["bfloat16"],) + (BWD_TOL["bfloat16"],) * 3
BENCH_KERNEL_TOLS = {"mm_fwd": _FWD_TOLS, "c3_fwd2d": _FWD_TOLS,
                     "c3_fwd4d": _FWD_TOLS, "mm_skip_fwd": _FWD_TOLS[:1],
                     "mm_bwd": _BWD_TOLS, "c3_bwd2d": _BWD_TOLS,
                     "c3_bwd4d": _BWD_TOLS,
                     "conv1x1_bwd": (TOL["bfloat16"],) * 2}
# training: each run from the same weights is held against the plain
# versions' run (float32, cuDNN deterministic).  Step 1's loss is a forward
# only.  Step 1's gradient carries the whole backward, through
# BatchNorm+ReLU chains that amplify the rounding of another sum order:
# GRAD_RTOL holds |g - g_plain| / |g_plain| over all parameters as one
# vector, PARAM_RTOL the same ratio of the worst single parameter.  On an
# NVIDIA H100 80GB HBM3 at 700 W the sound runs (the kernels, cuDNN free,
# MXNET_FUSED_UNIT_C3=xla, the plain versions on the batch reversed) read
# at most 1.40e-2 and 1.75e-2 with the FFMA kernels and 1.54e-2 and
# 1.86e-2 with K1, K5, K6 and K8 on the tensor cores (PERF.md, Findings);
# the planted faults in K5-K7 at least 0.257 and 1.0, and K8's, which
# drops three of the 157 parameters' gradients, 4.87e-2 and 1.0:
# PARAM_RTOL is what rejects it.
# The losses of steps 2..N drift apart by up to 8.2e-3 in the sound runs
# and by no more in the faults' (2.4e-3 and 8.7e-3): LOSS_RTOL only
# bounds that drift and does not tell a fault from the rounding.
LOSS_RTOL_FIRST, LOSS_RTOL = 1e-5, 3e-2
GRAD_RTOL, PARAM_RTOL = 5e-2, 1e-1
SGD = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
# served probabilities against the plain graph: float32 through 50 layers
# whose products are summed in another order
SERVE_RTOL, SERVE_ATOL = 1e-3, 1e-6
# bench.py's step (bench.py:68-140): ResNet-50 at 224x224, NHWC, stem
# "fused", bfloat16 parameters and activations, f32 aux states and loss,
# uint8 input scaled in the step, SGD at lr 0.05, batch 256; one warm-up
# and five timed steps on one seeded batch
BENCH_BATCH, BENCH_IMAGE, BENCH_LR = 256, 224, 0.05
BENCH_WARMUP, BENCH_STEPS = 1, 5
# config -> (unit_impl, environment): "bench" is bench.py's own graph
# (cuDNN and cuBLAS through autograd, no hand-written kernel); the fused
# units with K8 on, the 3x3 in the row layout (K3/K6) or on 4D tiles
# (K4/K7)
BENCH_CONFIGS = {
    "bench": ("plain", {"MXNET_CONV1X1_FUSED_BWD": None,
                        "MXNET_FUSED_UNIT_C3": None}),
    "fused2d": ("fused", {"MXNET_CONV1X1_FUSED_BWD": "1",
                          "MXNET_FUSED_UNIT_C3": None}),
    "fused4d": ("fused", {"MXNET_CONV1X1_FUSED_BWD": "1",
                          "MXNET_FUSED_UNIT_C3": "4d"}),
}
BENCH_LAUNCHES = {"bench": {}, "fused2d": TRAIN_LAUNCHES["2d"],
                  "fused4d": TRAIN_LAUNCHES["4d"]}
# step 1's bf16 loss against one f32 forward of the same weights
BENCH_F32_RTOL = 2e-2
# step 1's gradients through the kernels against the same step through
# their plain versions (cuDNN deterministic), from the same weights in bf16
# and widened to f32: |g - g_plain| / |g_plain| over all parameters as one
# vector (BENCH_GRAD_RTOL), and in f32 also each parameter's largest
# difference over its largest magnitude (BENCH_TENSOR_RTOL).  The limits
# come from two controls through the plain versions, the batch reversed
# and conv0_weight one step of the dtype away from zero.  On an NVIDIA
# H100 80GB HBM3 at 700 W they read 0.87 and 1.20 in bf16 (the kernels
# 0.72; a bf16 step at He-scaled weights is chaotic: a bf16 rounding in
# one activation moves the gradients below every BatchNorm it reaches),
# and 1.8e-2 and 1.6e-2 in f32, 4.2e-2 for the worst parameter (the
# kernels 1.8e-2, 4.4e-2); K2 with its residual dropped reads 480 in
# both.  Each limit is 2-3x its controls: the bf16 reading rejects a
# gross fault only, the f32 reading holds the kernels' arithmetic at
# these shapes, and each bf16 kernel call is held against its plain
# version on the same inputs (the kernel phases' tolerances).
BENCH_GRAD_RTOL = {"bfloat16": 2.5, "float32": 5e-2}
BENCH_TENSOR_RTOL = 0.1
# the fused stem against BatchNorm(fix_gamma) + Convolution at full width
# in f32: tests/test_bn_stem.py's tolerances, the gradients' relative to
# their largest magnitude (sums over 3.2M products)
STEM_FWD_TOL, STEM_BWD_TOL = 2e-5, 1e-4
# examples/train_imagenet.py at full width through examples/common.py's
# fit: ResNet-50 224x224 NHWC in f32 at batch 256, from raw uint8 records
# stored at 256x256 (bench.py's _make_raw_rec, label i % 1000): 2 epochs
# of 2 batches, validation on 256 records after each, SGD at lr 0.05
# (momentum 0.9, wd 1e-4) decaying 10x after update 2
# (MultiFactorScheduler), Xavier from --seed, a checkpoint an epoch
IMAGENET_BATCH, IMAGENET_IMAGE, IMAGENET_STORED = 256, 224, 256
IMAGENET_TRAIN_RECORDS, IMAGENET_VAL_RECORDS = 512, 256
IMAGENET_EPOCHS, IMAGENET_DECAY_AT = 2, 2
IMAGENET_STEPS = IMAGENET_EPOCHS * IMAGENET_TRAIN_RECORDS // IMAGENET_BATCH
IMAGENET_VAL_BATCHES = IMAGENET_EPOCHS * -(-IMAGENET_VAL_RECORDS
                                           // IMAGENET_BATCH)
IMAGENET_MEAN = (123.68, 116.779, 103.939)
IMAGENET_STD = (58.393, 57.12, 57.375)
IMAGENET_LRS = [0.05, 0.05, 0.005, 0.005]       # at updates 1..4
# the iterator's settings that turn normalization off (uint8 batches)
UNNORMALIZED = dict(mean_r=0.0, mean_g=0.0, mean_b=0.0, std_r=1.0,
                    std_g=1.0, std_b=1.0)
# the first WINDOW_IMAGES images of the first batch, each against every
# 224x224 window of its record, mirrored or not, normalized in numpy: the
# same f32 operations, so a true window agrees to the last bit
WINDOW_IMAGES, WINDOW_TOL = 8, 1e-5
# the fused fit's step-1 loss against the plain fit's: one f32 forward of
# the same weights on the same batch, through 3xTF32 kernels against cuDNN
IMAGENET_LOSS_RTOL = 1e-3
# the forward kernels an eval forward (a validation batch) launches
VAL_LAUNCHES = {"mm_fwd": 12, "c3_fwd2d": 12, "mm_skip_fwd": 12}
# each kernel call of one fused f32 step at batch 256 and its plain
# version (cuBLAS in f32) on the same inputs, both against the plain version
# computed in f64, each output relative to its largest magnitude: the
# kernel within IMAGENET_KERNEL_RTOL of the plain version, and within
# IMAGENET_F64_FACTOR times the plain version's own error of the f64 value,
# or IMAGENET_F64_FLOOR where that is smaller (an output that f32 gets
# within a few ulps, as the y of K1's small products).  The limits hold the
# f32 kernels to f32 arithmetic: their 3xTF32 products carry about 2^-21
# of each product, and each k tile's MMAs, which round toward zero, start
# from zero and are promoted into the accumulator with a round-to-nearest
# add (csrc/fu_mma.cuh), so a sum's error does not grow with its length.
# With the running sum as every MMA's C operand the kernels read up to
# 4.1e-4 here (K5's dW; PERF.md, Findings), far outside them.  dP reads
# 0.07-0.21 against f64 in both (f64 flips ReLU masks at zero), so the
# factor is what holds it there and the plain f32 version what holds it
# tight.  K5 with its dW zeroed is a planted fault that must fail.
IMAGENET_KERNEL_RTOL, IMAGENET_F64_FACTOR, IMAGENET_F64_FLOOR = 1e-4, 4, 2e-6
# examples/train_mnist.py (BASELINE.json config 1): LeNet at its published
# widths (conv 5x5 x20, conv 5x5 x50, fc 500, fc 10, tanh, max-pool, NCHW)
# over the example's synthetic stand-in (1800 training and 200 validation
# images), batch 64, 5 epochs, lr 0.05, momentum 0.9, wd 1e-4, Xavier
MNIST_BATCH, MNIST_EPOCHS, MNIST_LR = 64, 5, 0.05
# the JAX package's final validation accuracy on the same run, on the CPU
# (commit 642b9b8: `cd examples && JAX_PLATFORMS=cpu python
# train_mnist.py --data-dir /nonexistent` prints "final validation
# accuracy: 1.0000"); the port's on the card must be within MNIST_ACC_TOL
# (one of the 200 validation images is 0.005)
MNIST_JAX_VAL_ACC, MNIST_ACC_TOL = 1.0, 0.02
# every optimizer for one epoch of 28 steps (the first 1792 training
# images in order) from the same Xavier weights drawn on the host, on the
# card and through the port on the CPU, with the example's wd 1e-4 and a
# rate of the optimizer's kind: the example's 0.05 (momentum 0.9) for the
# gradient steps, the class defaults where the step is normalized (Adam
# 0.001, RMSProp 0.001, Adamax 0.002, Nadam 0.001, Ftrl 0.1; AdaDelta has
# none), 0.001 for the sign steps and 0.01 for AdaGrad.  SGLD samples the
# posterior of the whole training set: its gradient is the set's summed
# loss's (rescale_grad 1800/64, the mean loss's N times) at lr 1e-5, so
# its noise (sqrt(lr) = 0.0032 a step) lets the loss fall; it draws the
# same noise on both sides (same_sgld_noise)
MNIST_OPT_STEPS = 28
MNIST_OPTIMIZERS = {
    "sgd": dict(learning_rate=0.05, momentum=0.9),
    "ccsgd": dict(learning_rate=0.05, momentum=0.9),
    "nag": dict(learning_rate=0.05, momentum=0.9),
    "dcasgd": dict(learning_rate=0.05, momentum=0.9),
    "sgld": dict(learning_rate=1e-5, rescale_grad=1800 / 64),
    "signsgd": dict(learning_rate=0.001),
    "signum": dict(learning_rate=0.001, momentum=0.9),
    "adam": dict(learning_rate=0.001),
    "adagrad": dict(learning_rate=0.01),
    "rmsprop": dict(learning_rate=0.001),
    "rmsprop-centered": dict(learning_rate=0.001, centered=True),
    "adadelta": dict(),
    "ftrl": dict(learning_rate=0.1),
    "adamax": dict(learning_rate=0.002),
    "nadam": dict(learning_rate=0.001),
    "test": dict(learning_rate=0.05),
}
MNIST_SIGN_OPTIMIZERS = ("signsgd", "signum")
# optimizer -> (its class, a planted fault's update, what it does)
MNIST_FAULTS = {
    "adam": ("Adam", "adam_without_bias_correction",
             "its bias correction dropped"),
    "nag": ("NAG", "nag_as_plain_momentum", "plain momentum"),
}
# Each card run is held against the CPU run, and each limit comes from a
# control: the same CPU run against itself with the executor in float64
# (what f32 rounding alone moves), run in this phase.  Readings: the
# losses' largest difference over the 28 steps relative to step 1's loss
# (the losses fall to 1e-5), the step-1 parameters' largest difference
# relative to each parameter's largest magnitude, and the share of
# step-1 parameter elements within MNIST_AGREE of it.  The card and the
# CPU both round in f32, with sums in other orders (cuDNN's convolutions,
# TF32 off), so a limit is MNIST_CONTROL_FACTOR times its control.  Run
# on a CPU with 4 threads before the first card run, the control read
# 2e-8 to 1e-6 in the losses, 5e-8 to 4e-7 in the parameters of the
# gradient steps, 1e-6 to 3.5e-5 in those of the normalized steps (Adam,
# AdaGrad, RMSProp, AdaDelta, Ftrl) and 6e-4 and 1.9e-3 in Nadam's and
# Adamax's: a step that divides by an element's own gradient turns a
# gradient that cancels to near zero into a relative error of its step.  Where the control reads 0 or rounding's own scale
# the floors hold.  The sign steps flip on gradients near zero, so they
# are held by the losses and by the share of elements that agree (a
# flipped element moves 2 lr, 0.002, far outside MNIST_AGREE), of which
# at most MNIST_AGREE_FLOOR may be off.  The loss must fall (the mean of
# the last MNIST_WINDOW steps under the first's), except Test's, whose
# update ascends.  Planted faults that must fail: Adam with its bias
# correction dropped, NAG as plain momentum.
MNIST_AGREE, MNIST_WINDOW = 1e-5, 4
MNIST_CONTROL_FACTOR = 10
MNIST_LOSS_FLOOR, MNIST_PARAM_FLOOR, MNIST_AGREE_FLOOR = 1e-6, 1e-6, 1e-3
# a Monitor's mean |softmax output| on the card against the CPU's: the
# same f32 forward with sums in another order
MNIST_MONITOR_RTOL = 1e-5
# the pipeline alone: epochs timed after one warm-up epoch; bench.py's step
# fed by it: rounds of timed steps on a resident batch, then fed, after
# warm-up steps of each
PIPELINE_EPOCHS = 5
OVERLAP_WARMUP, OVERLAP_STEPS, OVERLAP_ROUNDS = 2, 6, 3


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


# a read of 256 MB, five times the H100's 50 MB L2, evicts what a kernel
# left there
FLUSH_BYTES = 256 << 20


def time_ms(torch, fn, reps=20, rounds=3):
    """Device time of one ``fn()``: ``reps`` calls captured in a CUDA graph
    (so host launch cost does not count), replayed ``rounds`` times between
    CUDA events after a warm replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (rounds * reps)
    del graph
    return ms


def time_ms_cold(torch, fn, flush, reps=20, rounds=3):
    """Device time of one ``fn()`` that finds the L2 cache cold: ``reps``
    pairs of ``flush.sum()`` and ``fn()`` in one CUDA graph, less the same
    graph of the flushes alone, each timed as ``time_ms`` times."""
    both = time_ms(torch, lambda: (flush.sum(), fn()), reps, rounds)
    return both - time_ms(torch, flush.sum, reps, rounds)


def rel_err(got, want):
    scale = float(want.float().abs().max()) or 1.0
    return float((got.float() - want.float()).abs().max()) / scale


def c3_pairs(n, side):
    """(output row, tap) pairs of a 3x3 / pad 1 over n side x side images
    whose input lies inside the image: the products the work needs."""
    return n * (3 * side - 2) ** 2


def kernel_phase(torch, fu, device, seed):
    """Every kernel against its plain version at the stage shapes; K2, K3
    and K4 and their library calls also timed with the L2 cache flushed
    before each call."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cpu").manual_seed(seed)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=device)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    rows = []
    for stage, ((hw, c, units), side) in enumerate(zip(STAGES, STAGE_HW)):
        cq = c // 4
        r = BATCH * hw
        for dname in ("float32", "bfloat16"):
            dt = getattr(torch, dname)
            es = torch.tensor([], dtype=dt).element_size()
            x = randn(r, c).to(dt)
            y1 = randn(r, cq).to(dt)
            w1 = randn(cq, 1, 1, c, scale=(2.0 / c) ** 0.5).to(dt)
            w2 = randn(cq, 3, 3, cq, scale=(2.0 / (9 * cq)) ** 0.5).to(dt)
            w3 = randn(c, 1, 1, cq, scale=(2.0 / cq) ** 0.5).to(dt)
            sc, sh = randn(c).abs() + 0.5, randn(c, scale=0.1)
            sc2, sh2 = randn(cq).abs() + 0.5, randn(cq, scale=0.1)
            # the normalized inputs, for the library yardsticks
            a1 = fu._prologue(x, sc, sh).to(dt)
            a2 = fu._prologue(y1, sc2, sh2).to(dt)
            a2_nchw = a2.reshape(BATCH, side, side, cq).permute(0, 3, 1, 2)
            w2_oihw = w2.permute(0, 3, 1, 2)
            w1t, w3t = w1.reshape(cq, c).t(), w3.reshape(c, cq).t()
            vec = 4 * 2
            cases = [
                ("fu_mm_fwd", "stats", fu.mm_fwd, fu.mm_fwd_plain,
                 (x, w1, sc, sh, True), 2 * r * c * cq,
                 (r * c + c * cq + r * cq) * es + vec * c + vec * cq,
                 lambda: torch.matmul(a1, w1t)),
                ("fu_mm_fwd", "", fu.mm_fwd, fu.mm_fwd_plain,
                 (x, w1, sc, sh, False), 2 * r * c * cq,
                 (r * c + c * cq + r * cq) * es + vec * c,
                 lambda: torch.matmul(a1, w1t)),
                ("fu_c3_fwd2d", "", fu.c3_fwd2d, fu.c3_fwd2d_plain,
                 (y1, w2, sc2, sh2, BATCH, side, side, False),
                 2 * c3_pairs(BATCH, side) * cq * cq,
                 (2 * r * cq + 9 * cq * cq) * es + vec * cq,
                 lambda: F.conv2d(a2_nchw, w2_oihw, padding=1)),
                ("fu_mm_skip_fwd", "", fu.mm_skip_fwd, fu.mm_skip_fwd_plain,
                 (y1, w3, sc2, sh2, x), 2 * r * c * cq,
                 (r * cq + c * cq + 2 * r * c) * es + vec * cq,
                 lambda: torch.addmm(x, a2, w3t)),
            ]
            y4 = y1.reshape(BATCH, side, side, cq)
            for variant, stats in (("stats", True), ("", False)):
                cases.append((
                    "fu_c3_fwd4d", variant, fu.c3_fwd4d, fu.c3_fwd4d_plain,
                    (y4, w2, sc2, sh2, stats),
                    2 * c3_pairs(BATCH, side) * cq * cq,
                    (2 * r * cq + 9 * cq * cq) * es + vec * cq,
                    lambda: F.conv2d(a2_nchw, w2_oihw, padding=1)))
            for name, variant, kern, plain, args, flops, nbytes, lib in cases:
                got, want = kern(*args), plain(*args)
                again = kern(*args)
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                again = again if isinstance(again, tuple) else (again,)
                if not all(torch.equal(p, q) for p, q in zip(got, again)
                           if p is not None):
                    raise AssertionError("%s %s stage %d %s: two launches "
                                         "on the same inputs differ" % (
                                             name, variant, stage + 1,
                                             dname))
                err = rel_err(got[0], want[0])
                abs_err = float((got[0].float() - want[0].float()).abs().max())
                if err > TOL[dname]:
                    raise AssertionError("%s %s stage %d %s: relative error "
                                         "%.3g over %.3g" % (
                                             name, variant, stage + 1, dname,
                                             err, TOL[dname]))
                stats_err = 0.0
                if variant == "stats":
                    stats_err = max(rel_err(got[1], want[1]),
                                    rel_err(got[2], want[2]))
                    if stats_err > TOL["stats"]:
                        raise AssertionError("%s stage %d %s: statistics "
                                             "relative error %.3g" % (
                                                 name, stage + 1, dname,
                                                 stats_err))
                row = {
                    "kernel": name, "variant": variant, "stage": stage + 1,
                    "dtype": dname, "rows": r, "c": c, "cq": cq,
                    "units_per_forward": units,
                    "max_rel_err": err, "max_abs_err": abs_err,
                    "stats_rel_err": stats_err,
                    "ms": time_ms(torch, lambda: kern(*args)),
                    "plain_ms": time_ms(torch, lambda: plain(*args)),
                    "library_ms": time_ms(torch, lib),
                    "flops": flops, "bytes": nbytes,
                    "bound_ms": 1e3 * max(flops / PEAK_FLOPS[dname],
                                          nbytes / HBM_BYTES_S),
                    "bound_by": ("operations" if flops / PEAK_FLOPS[dname]
                                 >= nbytes / HBM_BYTES_S else "bytes"),
                }
                row["tflops"] = flops / row["ms"] / 1e9
                cold = ""
                if name != "fu_mm_fwd":
                    row["ms_l2_flushed"] = time_ms_cold(
                        torch, lambda: kern(*args), flush)
                    row["library_ms_l2_flushed"] = time_ms_cold(torch, lib,
                                                                flush)
                    cold = "  L2 flushed %.4f / library %.4f ms" % (
                        row["ms_l2_flushed"], row["library_ms_l2_flushed"])
                rows.append(row)
                log("  %-14s %-5s stage %d %-8s rel_err %.2e  kernel %.4f ms"
                    " (%.1f TFLOP/s)  plain %.4f ms  library %.4f ms  bound "
                    "%.4f ms (%s)%s"
                    % (name, variant, stage + 1, dname, err, row["ms"],
                       row["tflops"], row["plain_ms"], row["library_ms"],
                       row["bound_ms"], row["bound_by"], cold))
    return rows


def bwd_kernel_phase(torch, fu, nn, device, seed):
    """K5, K6, K7 and K8 against their plain versions at ResNet-50's
    training shapes (batch 32), with a bitwise repeat of each launch.  K5,
    K6 and K8 run on the tensor cores (``csrc/fu_mma.cuh``: bf16 MMA, f32
    through 3xTF32), K7 too on its halo-resident form
    (``csrc/fu_halo.cuh``).  Each kernel and its library call
    are timed warm (``time_ms``) and with the L2 cache flushed before each
    call (``time_ms_cold``)."""
    gen = torch.Generator(device="cpu").manual_seed(seed + 7)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=device)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    def vec(n):
        return randn(n).abs() + 0.5, randn(n, scale=0.1)

    cases = []      # (kernel, variant, stage, units, r, ci, co, maker)
    for stage, ((hw, c, units), side) in enumerate(zip(STAGES, STAGE_HW)):
        cq = c // 4
        r = TRAIN_BATCH * hw
        cases += [("fu_mm_bwd", "final", stage + 1, units, r, cq, c, side),
                  ("fu_mm_bwd", "deferred", stage + 1, units, r, c, cq,
                   side),
                  ("fu_c3_bwd2d", "", stage + 1, units, r, cq, cq, side),
                  ("fu_c3_bwd4d", "", stage + 1, units, r, cq, cq, side)]
    for name, hw, ci, co in K8_SITES:
        cases.append(("nn_conv1x1_bwd", name, None, 1,
                      TRAIN_BATCH * hw, ci, co, None))
    rows = []
    for kname, variant, stage, units, r, ci, co, side in cases:
        for dname in ("float32", "bfloat16"):
            dt = getattr(torch, dname)
            es = torch.tensor([], dtype=dt).element_size()
            x = randn(r, ci).to(dt)
            g = randn(r, co).to(dt)
            vecs = vec(ci) + vec(ci)            # sc, sh, xs, xh
            if kname == "nn_conv1x1_bwd":
                w = randn(co, 1, 1, ci, scale=ci ** -0.5).to(dt)
                args = (x, g, w)
                kern, plain = nn.conv1x1_bwd, nn.conv1x1_bwd_plain
                flops = 4 * r * ci * co
                nbytes = (2 * r * ci + r * co + 2 * co * ci) * es
                a, gf, w2 = x, g, w.reshape(co, ci)
                lib = lambda: (torch.matmul(gf, w2),  # noqa: E731
                               torch.matmul(gf.t(), a))
            else:
                fin = None
                # g, x, dP; sc, sh, xs, xh in and db, dg out (f32)
                nbytes = (2 * r * ci + r * co) * es + 6 * ci * 4
                if variant != "final":
                    fin = (randn(co).abs() + 0.5, randn(co, scale=0.1),
                           randn(co, scale=0.1))
                    nbytes += r * co * es + 3 * co * 4
                yraw = randn(r, co).to(dt) if fin else None
                gf = fu._finalize_g(g, yraw, fin).to(dt)
                a = fu._prologue(x, vecs[0], vecs[1]).to(dt)
                if kname == "fu_mm_bwd":
                    w = randn(co, 1, 1, ci, scale=ci ** -0.5).to(dt)
                    args = (g, yraw, fin, x, w) + vecs
                    kern, plain = fu.mm_bwd, fu.mm_bwd_plain
                    flops = 4 * r * ci * co
                    nbytes += co * ci * (es + 4)
                    w2 = w.reshape(co, ci)
                    lib = lambda: (torch.matmul(gf, w2),  # noqa: E731
                                   torch.matmul(gf.t(), a))
                else:
                    w = randn(co, 3, 3, ci, scale=(9 * ci) ** -0.5).to(dt)
                    n = TRAIN_BATCH
                    if kname == "fu_c3_bwd4d":
                        nhwc = (n, side, side, -1)
                        args = (g.reshape(nhwc), yraw.reshape(nhwc), fin,
                                x.reshape(nhwc), w) + vecs
                        kern, plain = fu.c3_bwd4d, fu.c3_bwd4d_plain
                    else:
                        args = (g, yraw, fin, x, w) + vecs + (n, side, side)
                        kern, plain = fu.c3_bwd2d, fu.c3_bwd2d_plain
                    flops = 4 * c3_pairs(n, side) * ci * co
                    nbytes += 9 * co * ci * (es + 4)
                    a4 = a.reshape(n, side, side, ci).permute(0, 3, 1, 2)
                    g4 = gf.reshape(n, side, side, co).permute(0, 3, 1, 2)
                    w4 = w.permute(0, 3, 1, 2)
                    lib = lambda: (  # noqa: E731
                        torch.nn.grad.conv2d_input(a4.shape, w4, g4,
                                                   padding=1),
                        torch.nn.grad.conv2d_weight(a4, w4.shape, g4,
                                                    padding=1))
            got, want = kern(*args), plain(*args)
            again = kern(*args)
            torch.cuda.synchronize()
            if not all(torch.equal(p, q) for p, q in zip(got, again)):
                raise AssertionError("%s %s: two launches on the same "
                                     "inputs differ" % (kname, variant))
            errs = [rel_err(p, q) for p, q in zip(got, want)]
            tols = [TOL[dname]] + [BWD_TOL[dname]] * 3
            if kname == "nn_conv1x1_bwd":
                tols = [TOL[dname]] * 2
            for i, (e, t) in enumerate(zip(errs, tols)):
                if e > t:
                    raise AssertionError(
                        "%s %s stage %s %s: output %d relative error %.3g "
                        "over %.3g" % (kname, variant, stage, dname, i, e,
                                       t))
            row = {
                "kernel": kname, "variant": variant, "stage": stage,
                "dtype": dname, "rows": r, "ci": ci, "co": co,
                "units_per_step": units, "rel_errs": errs,
                "max_abs_err": max(float((p.float() - q.float()).abs()
                                         .max()) for p, q in zip(got, want)),
                "ms": time_ms(torch, lambda: kern(*args)),
                "plain_ms": time_ms(torch, lambda: plain(*args)),
                "library_ms": time_ms(torch, lib),
                "ms_l2_flushed": time_ms_cold(torch, lambda: kern(*args),
                                              flush),
                "library_ms_l2_flushed": time_ms_cold(torch, lib, flush),
                "flops": flops, "bytes": nbytes,
                "bound_ms": 1e3 * max(flops / PEAK_FLOPS[dname],
                                      nbytes / HBM_BYTES_S),
                "bound_by": ("operations" if flops / PEAK_FLOPS[dname]
                             >= nbytes / HBM_BYTES_S else "bytes"),
            }
            row["tflops"] = flops / row["ms"] / 1e9
            rows.append(row)
            log("  %-14s %-18s %-8s rel_err %s  kernel %.4f ms (%.1f "
                "TFLOP/s), L2 flushed %.4f  plain %.4f ms  library %.4f ms, "
                "L2 flushed %.4f  bound %.4f ms (%s)"
                % (kname, variant or "stage %d" % stage, dname,
                   "/".join("%.1e" % e for e in errs), row["ms"],
                   row["tflops"], row["ms_l2_flushed"], row["plain_ms"],
                   row["library_ms"], row["library_ms_l2_flushed"],
                   row["bound_ms"], row["bound_by"]))
    return rows


@contextlib.contextmanager
def replaced(mod, name, fn):
    """``mod.name`` is ``fn`` inside the block."""
    saved = getattr(mod, name)
    setattr(mod, name, fn)
    try:
        yield
    finally:
        setattr(mod, name, saved)


def kernel_sites(fu, nn):
    """(module, wrapper name) of K1-K8; each has ``<name>_plain`` beside
    it."""
    return [(fu, "mm_fwd"), (fu, "c3_fwd2d"), (fu, "c3_fwd4d"),
            (fu, "mm_skip_fwd"), (fu, "mm_bwd"), (fu, "c3_bwd2d"),
            (fu, "c3_bwd4d"), (nn, "conv1x1_bwd")]


@contextlib.contextmanager
def plain_kernels(fu, nn):
    """Every kernel's plain version in place of its wrapper: the
    reference side of the serve, train and bench checks, and only that."""
    with contextlib.ExitStack() as stack:
        for mod, name in kernel_sites(fu, nn):
            stack.enter_context(replaced(mod, name,
                                         getattr(mod, name + "_plain")))
        yield


def send_requests(eng, xs, n_clients):
    """``n_clients`` threads submit ``xs`` between them, all at once;
    returns (futures, wall seconds until the last answer, per-request
    latency in ms from submit to answer)."""
    futures = [None] * len(xs)
    done_at = [None] * len(xs)
    sent_at = [None] * len(xs)

    def client(tid):
        for i in range(tid, len(xs), n_clients):
            sent_at[i] = time.perf_counter()
            futures[i] = eng.submit(xs[i])
            futures[i].add_done_callback(
                lambda f, i=i: done_at.__setitem__(i, time.perf_counter()))
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(t,))
               for t in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive()
    for f in futures:
        f.exception(timeout=600)              # wait for every answer
    wall = max(done_at) - t0
    lat = sorted((d - s) * 1e3 for d, s in zip(done_at, sent_at))
    return futures, wall, lat


def percentile(sorted_vals, q):
    return sorted_vals[min(len(sorted_vals) - 1,
                           int(len(sorted_vals) * q / 100.0))]


def profile_calls(torch, fn, reps):
    """Host wall and device busy time per call of ``reps`` calls of
    ``fn`` (after one warm call), from torch.profiler's CUDA activity: the
    device's idle share and where its time goes, by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side activity only (kernels, copies, sets): the operator rows
    # of key_averages() repeat their kernels' time
    by_name = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            by_name[evt.name] = (by_name.get(evt.name, 0.0)
                                 + evt.time_range.elapsed_us() / 1e3)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"reps": reps, "wall_ms": 1e3 * wall / reps,
            "device_busy_ms": busy / reps,
            "device_idle_share": (1.0 - busy / (1e3 * wall)) if busy
            else None,
            "top_device_ms": [(k, v / reps) for k, v in top]}


def kernel_wrappers(fu, nn, kv):
    """Every launch counter of the port: K1-K7, K8, K9, K10, and K11
    (``rtc.CudaKernel``, all runtime-written kernels)."""
    from mxnet_tpu_torch import rtc
    return (fu.KERNEL_WRAPPERS + (nn.conv1x1_bwd,) + kv.KERNEL_WRAPPERS
            + (rtc.CudaKernel,))


def serve_phase(torch, mt, fu, nn, kv, seed, n_requests, n_clients,
                mode="2d"):
    """Serve with the unit's middle conv as ``mode`` selects (2d: K3, 4d:
    K4; the caller sets MXNET_FUSED_UNIT_C3)."""
    import numpy as np
    shape = (224, 224, 3)
    sym = mt.models.get_resnet_symbol(
        num_classes=1000, num_layers=50, image_shape=(3, 224, 224),
        layout="NHWC", unit_impl="fused")
    n_fused = sym.tojson().count('"_contrib_FusedBottleneckUnit"')
    assert n_fused == 12, n_fused
    args, aux = mt.convert.random_params(sym, {"data": (1,) + shape},
                                         seed=seed)
    xs = np.random.default_rng(seed + 1).standard_normal(
        (n_requests,) + shape).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "resnet50")
        arg_nd, aux_nd = mt.convert.params_from_numpy(args, aux,
                                                      device=mt.cpu())
        mt.model.save_checkpoint(prefix, 0, sym, arg_nd, aux_nd)
        t0 = time.perf_counter()
        eng = mt.ServingEngine.from_checkpoint(prefix, 0, {"data": shape},
                                               ctx=mt.gpu(0))
        buckets = eng.warmup()
        torch.cuda.synchronize()
        log("  engine up and warm (%d buckets) in %.2f s"
            % (buckets, time.perf_counter() - t0))

        for k in kernel_wrappers(fu, nn, kv):
            k.launches = 0
        futures, wall, lat = send_requests(eng, xs, n_clients)
        launches = {k.__name__: k.launches
                    for k in kernel_wrappers(fu, nn, kv)}
        st = eng.stats()
        # the same traffic again on the now-used worker: steady state
        again, wall2, lat2 = send_requests(eng, xs, n_clients)
        st2 = eng.stats()
        eng.close()
    failed = [i for i, f in enumerate(futures) if f.exception() is not None]
    if failed:
        raise AssertionError("%d requests failed, first: %r" % (
            len(failed), futures[failed[0]].exception()))
    outs = np.stack([f.result() for f in futures])
    assert st["requests_served"] == n_requests, st
    for name, n in launches.items():
        want = 12 * st["batches"] if name in SERVE_KERNELS[mode] else 0
        if n != want:
            raise AssertionError("%s launched %d times for %d batches, not "
                                 "%d" % (name, n, st["batches"], want))

    # the same graph through the plain versions, on the same card
    ref_args, ref_aux = mt.convert.params_from_numpy(args, aux,
                                                     device=mt.gpu(0))
    pred = mt.Predictor(sym, ref_args, ref_aux, {"data": (BATCH,) + shape},
                        ctx=mt.gpu(0))
    refs = []
    with plain_kernels(fu, nn):
        for i in range(0, n_requests, BATCH):
            chunk = xs[i:i + BATCH]
            pad = np.zeros((BATCH - len(chunk),) + shape, np.float32)
            refs.append(pred.forward(data=np.concatenate([chunk, pad]))
                        .get_output(0)[:len(chunk)])
    refs = np.concatenate(refs)
    x8 = np.ascontiguousarray(xs[:BATCH])
    prof = profile_calls(torch, lambda: pred.forward(data=x8).get_output(0),
                         5)
    assert all(f.exception() is None for f in again)
    np.testing.assert_array_equal(np.stack([f.result() for f in again]),
                                  outs)
    assert outs.shape == (n_requests, 1000) and np.isfinite(outs).all()
    np.testing.assert_allclose(outs.sum(1), 1.0, rtol=1e-4)
    np.testing.assert_allclose(outs, refs, rtol=SERVE_RTOL, atol=SERVE_ATOL)
    np.testing.assert_array_equal(outs.argmax(1), refs.argmax(1))
    return {
        "requests": n_requests, "clients": n_clients,
        "batches": st["batches"], "batch_occupancy": st["batch_occupancy"],
        "latency_p50_ms": percentile(lat, 50),
        "latency_p99_ms": percentile(lat, 99),
        "latency_max_ms": lat[-1],
        "images_per_s": n_requests / wall, "wall_s": wall,
        "steady": {"batches": st2["batches"] - st["batches"],
                   "latency_p50_ms": percentile(lat2, 50),
                   "latency_p99_ms": percentile(lat2, 99),
                   "latency_max_ms": lat2[-1],
                   "images_per_s": n_requests / wall2, "wall_s": wall2},
        "profile_batch8": prof,
        "max_abs_err": float(np.abs(outs - refs).max()),
        "max_prob": float(outs.max()),
        "launches": launches,
    }


def build_spec_models(mt, vocab, d, max_len, layers, seed, tail_scale):
    """The attention decoder of ``perf/decode_bench.py`` build_spec_models,
    built with the port (this script cannot import the JAX package): the
    target stacks ``layers`` single-head attention blocks over per-layer
    (slots, max_len, d) K and V caches written through one-hot blends
    (``x + proj(attn(x))``, the output projections of blocks past the
    first scaled by ``tail_scale``); the draft is block 0 with the shared
    head.  The same graphs (JSON) and, drawn in the same order from
    ``seed``, the same weights, as float32 numpy arrays.  Returns
    (target, target state_info, draft, draft state_info, params)."""
    import numpy as np
    sym = mt.sym
    rng = np.random.default_rng(seed)

    def w(*shape, scale=1.0):
        return (rng.standard_normal(shape).astype(np.float32)
                * np.float32(scale))

    params = {"emb_weight": w(vocab, d)}
    tok, pos = sym.Variable("token"), sym.Variable("pos")
    steps_r = sym.reshape(sym._arange(start=0, stop=max_len),
                          shape=(1, max_len))
    mask = sym.broadcast_lesser_equal(steps_r,
                                      sym.reshape(pos, shape=(-1, 1)))

    def block(x, i, scale):
        prefix = "blk%d_" % i
        kc, vc = sym.Variable(prefix + "k"), sym.Variable(prefix + "v")
        q = sym.FullyConnected(x, num_hidden=d, no_bias=True,
                               name=prefix + "q")
        k = sym.FullyConnected(x, num_hidden=d, no_bias=True,
                               name=prefix + "kf")
        v = sym.FullyConnected(x, num_hidden=d, no_bias=True,
                               name=prefix + "vf")
        ohe = sym.expand_dims(sym.one_hot(pos, depth=max_len), axis=2)
        k_new = sym.broadcast_mul(kc, 1.0 - ohe) \
            + sym.broadcast_mul(sym.expand_dims(k, axis=1), ohe)
        v_new = sym.broadcast_mul(vc, 1.0 - ohe) \
            + sym.broadcast_mul(sym.expand_dims(v, axis=1), ohe)
        scores = sym.batch_dot(k_new, sym.expand_dims(q, axis=2))
        scores = sym.reshape(scores, shape=(0, max_len)) \
            * (1.0 / np.sqrt(d))
        scores = scores * mask + (1.0 - mask) * (-1e9)
        attn = sym.softmax(scores, axis=1)
        ctx = sym.batch_dot(sym.expand_dims(attn, axis=1), v_new)
        o = sym.FullyConnected(sym.reshape(ctx, shape=(0, d)),
                               num_hidden=d, no_bias=True, name=prefix + "o")
        for name, sc in (("q", 0.5), ("kf", 0.5), ("vf", 0.5), ("o", scale)):
            draw = w(d, d, scale=sc)
            params.setdefault(prefix + name + "_weight", draw)
        infos = [{"name": prefix + c, "shape": (max_len, d), "cache": True}
                 for c in ("k", "v")]
        return x + o, k_new, v_new, infos

    params["out_fc_weight"] = w(vocab, d)
    params["out_fc_bias"] = np.zeros((vocab,), np.float32)

    def stack(n_blocks):
        x = sym.Embedding(tok, input_dim=vocab, output_dim=d, name="emb")
        outs, infos = [], []
        for i in range(n_blocks):
            x, k_new, v_new, inf = block(x, i,
                                         1.0 if i == 0 else tail_scale)
            outs += [k_new, v_new]
            infos += inf
        logits = sym.FullyConnected(x, num_hidden=vocab, name="out_fc")
        return sym.Group([logits] + outs), infos

    target, t_info = stack(layers)
    draft, d_info = stack(1)
    return target, t_info, draft, d_info, params


def _fin_swapped(launch):
    """K6 launched with its finalize vectors u0 and u1 in each other's
    place."""
    def faulty(name, *args):
        if name == "fu_c3_bwd2d":
            args = args[:3] + (args[4], args[3]) + args[5:]
        launch(name, *args)
    return faulty


# where each backward kernel's launch passes its f32 weight gradient: K5,
# K6 and K7 take (g, y_raw, c1, u0, u1, x, w, sc, sh, xs, xh, dP,
# partials, db, dg, dW, ...), K8 (x, dy, w, dx, dW, ...)
DW_ARG = {"fu_mm_bwd": 15, "fu_c3_bwd2d": 15, "fu_c3_bwd4d": 15,
          "nn_conv1x1_bwd": 4}


def _dw_zeroed(*names):
    """The kernels ``names`` launched and their weight gradient dropped."""
    def plant(launch):
        def faulty(name, *args):
            launch(name, *args)
            if name in names:
                args[DW_ARG[name]].zero_()
        return faulty
    return plant


# known faults on the kernel path, planted where fused_unit launches K5,
# K6 or K7 and nn launches K8, each of which the train check must reject:
# the control that shows the check can fail.  name -> (plant,
# MXNET_FUSED_UNIT_C3)
PLANTED_FAULTS = {"fault: K6 u0/u1 swapped": (_fin_swapped, "auto"),
                  "fault: K6 dW zeroed": (_dw_zeroed("fu_c3_bwd2d"), "auto"),
                  "fault: K7 dW zeroed": (_dw_zeroed("fu_c3_bwd4d"), "4d"),
                  "fault: K5 dW zeroed": (_dw_zeroed("fu_mm_bwd"), "auto"),
                  "fault: K8 dW zeroed": (_dw_zeroed("nn_conv1x1_bwd"),
                                          "auto")}


@contextlib.contextmanager
def env_vars(env):
    """The environment variables of ``env`` set (a string) or unset
    (None) inside the block."""
    saved = {k: os.environ.get(k) for k in env}
    try:
        for k, v in env.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def c3_mode(mode):
    """MXNET_FUSED_UNIT_C3=mode inside the block ('auto': unset)."""
    return env_vars({"MXNET_FUSED_UNIT_C3": None if mode == "auto"
                     else mode})


def fit_run(torch, mt, sym, args, aux, x, y, steps):
    """``steps`` SGD steps of ``Module.fit`` on cuda:0 over the one batch
    (x, y); returns (per-step (loss, accuracy, host time at the step's
    end), step 1's gradient of every parameter on the host, the module)."""
    per_step, grads = [], {}

    def on_batch(param):
        torch.cuda.synchronize()
        if not per_step:
            grads.update((n, g._data.to("cpu", torch.float32, copy=True))
                         for n, g in mod._exec.grad_dict.items() if n in args)
        vals = dict(param.eval_metric.get_name_value())
        per_step.append((float(vals["cross-entropy"]),
                         float(vals["accuracy"]), time.perf_counter()))
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    arg_nd, aux_nd = mt.convert.params_from_numpy(args, aux,
                                                  device=mt.gpu(0))
    mod.fit(mt.io.NDArrayIter(x, y, batch_size=TRAIN_BATCH),
            eval_metric=["acc", "ce"], optimizer="sgd",
            optimizer_params=SGD, kvstore="local", num_epoch=steps,
            arg_params=arg_nd, aux_params=aux_nd,
            batch_end_callback=on_batch)
    return per_step, grads, mod


def train_reading(per_step, grads, ref_per_step, ref_grads):
    """One run against the plain run: the relative loss difference at each
    step, and step 1's gradient difference over all parameters as one
    vector, |g - g_plain| / |g_plain|, beside the largest such ratio of a
    single parameter and its name."""
    rel = [abs(a[0] - b[0]) / abs(b[0])
           for a, b in zip(per_step, ref_per_step)]
    diff2 = {n: float((g - ref_grads[n]).double().pow(2).sum())
             for n, g in grads.items()}
    ref2 = {n: float(g.double().pow(2).sum()) for n, g in ref_grads.items()}
    per_param = {n: (diff2[n] / ref2[n]) ** 0.5 if ref2[n] else 0.0
                 for n in diff2}
    worst = max(per_param, key=per_param.get)
    grad_err = (sum(diff2.values()) / sum(ref2.values())) ** 0.5
    return {"loss_rel_diff": rel, "grad_rel_err": grad_err,
            "param_rel_err": per_param[worst], "param_worst": worst,
            "passes": (rel[0] <= LOSS_RTOL_FIRST
                       and max(rel[1:]) <= LOSS_RTOL
                       and grad_err <= GRAD_RTOL
                       and per_param[worst] <= PARAM_RTOL)}


def _launch_check(what, launches, per_step, steps):
    """Every counter at ``per_step`` times ``steps``, 0 where not named."""
    for name, n in launches.items():
        want = per_step.get(name, 0) * steps
        if n != want:
            raise AssertionError("%s: %s launched %d times in %d steps, not "
                                 "%d per step" % (what, name, n, steps,
                                                  per_step.get(name, 0)))


def _median(vals):
    vals = sorted(vals)
    mid = len(vals) // 2
    return vals[mid] if len(vals) % 2 else 0.5 * (vals[mid - 1] + vals[mid])


def train_phase(torch, mt, fu, nn, kv, seed, steps, card):
    import numpy as np
    sym = mt.models.get_resnet_symbol(
        num_classes=1000, num_layers=50, image_shape=(3, 224, 224),
        layout="NHWC", unit_impl="fused")
    args, aux = mt.convert.random_params(sym, {"data": (1, 224, 224, 3)},
                                         seed=seed)
    rng = np.random.default_rng(seed + 2)
    x = rng.standard_normal((TRAIN_BATCH, 224, 224, 3)).astype(np.float32)
    y = rng.integers(0, 1000, TRAIN_BATCH).astype(np.float32)
    wrappers = kernel_wrappers(fu, nn, kv)
    batch = next(iter(mt.io.NDArrayIter(x, y, batch_size=TRAIN_BATCH)))
    os.environ["MXNET_CONV1X1_FUSED_BWD"] = "1"
    paths = {}
    try:
        # the main path as a user runs it, cuDNN free to choose, with the
        # unit's middle conv in its row layout (K3/K6) and on 4D tiles
        # (K4/K7, MXNET_FUSED_UNIT_C3=4d): each counted, timed and
        # profiled, its counters set to 0 just before it
        for mode in ("2d", "4d"):
            with c3_mode("4d" if mode == "4d" else "auto"):
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                for k in wrappers:
                    k.launches = 0
                t0 = time.perf_counter()
                main, main_grads, mod = fit_run(torch, mt, sym, args, aux, x,
                                                y, steps)
                launches = {k.__name__: k.launches for k in wrappers}
                peak = torch.cuda.max_memory_allocated()
                final_args, final_aux = mod.get_params()
                finite = all(bool(torch.isfinite(v._data).all())
                             for v in list(final_args.values())
                             + list(final_aux.values()))

                def step():
                    mod.forward_backward(batch)
                    mod.update()
                prof = profile_calls(torch, step, 2)
                del mod, final_args, final_aux
                torch.cuda.empty_cache()
            paths[mode] = dict(main=main, grads=main_grads,
                               launches=launches, peak=peak, finite=finite,
                               prof=prof, first_step_s=main[0][2] - t0)

        # the check: every run from the same weights with cuDNN
        # deterministic, held against the plain versions' run
        torch.backends.cudnn.deterministic = True
        runs = {}
        with plain_kernels(fu, nn):
            runs["plain"] = fit_run(torch, mt, sym, args, aux, x, y,
                                    steps)[:2]
            runs["plain, batch reversed"] = fit_run(
                torch, mt, sym, args, aux, x[::-1].copy(), y[::-1].copy(),
                steps)[:2]
        runs["kernels"] = fit_run(torch, mt, sym, args, aux, x, y,
                                  steps)[:2]
        with c3_mode("xla"):
            runs["MXNET_FUSED_UNIT_C3=xla"] = fit_run(
                torch, mt, sym, args, aux, x, y, steps)[:2]
        for name, (plant, mode) in PLANTED_FAULTS.items():
            with c3_mode(mode), replaced(fu, "launch", plant(fu.launch)), \
                    replaced(nn, "launch", plant(nn.launch)):
                runs[name] = fit_run(torch, mt, sym, args, aux, x, y,
                                     steps)[:2]
        torch.cuda.empty_cache()
    finally:
        os.environ.pop("MXNET_CONV1X1_FUSED_BWD")
        torch.backends.cudnn.deterministic = False

    ref = runs.pop("plain")
    readings = {name: train_reading(*run, *ref) for name, run in runs.items()}
    readings["main path (cuDNN free)"] = train_reading(
        paths["2d"]["main"], paths["2d"]["grads"], *ref)
    readings["MXNET_FUSED_UNIT_C3=4d (cuDNN free)"] = train_reading(
        paths["4d"]["main"], paths["4d"]["grads"], *ref)
    log("  plain run's losses %s" % fmt([s[0] for s in ref[0]]))
    for name, r in readings.items():
        log("  %-36s loss rel diff %s; step-1 gradient rel err %.3e, "
            "worst parameter %.3e (%s)"
            % (name, fmt(r["loss_rel_diff"], "%.2e"), r["grad_rel_err"],
               r["param_rel_err"], r["param_worst"]))
    out = {"steps": steps, "batch": TRAIN_BATCH,
           "plain_losses": [s[0] for s in ref[0]], "checks": readings}
    for mode, pth in paths.items():
        main = pth["main"]
        losses = [s[0] for s in main]
        step_ms = sorted(1e3 * (b[2] - a[2]) for a, b in zip(main, main[1:]))
        median = _median(step_ms)
        log("  %s path: losses %s; accuracy %s; launches in %d steps: %s"
            % (mode, fmt(losses), [s[1] for s in main], steps,
               pth["launches"]))
        log("  %s path: median step (2..%d) %.2f ms, %.1f images/s, first "
            "step %.2f s, max_memory_allocated %.2f GB [%s]" % (
                mode, steps, median, TRAIN_BATCH * 1e3 / median,
                pth["first_step_s"], pth["peak"] / 1e9, card))
        log_profile("one training step, %s" % mode, pth["prof"], card)
        _launch_check("train, %s" % mode, pth["launches"],
                      TRAIN_LAUNCHES[mode], steps)
        if not (pth["finite"] and np.isfinite(losses).all()):
            raise AssertionError("%s: non-finite loss or parameter: losses "
                                 "%s" % (mode, losses))
        if not losses[-1] < losses[0]:
            raise AssertionError("%s: the loss did not fall: %s"
                                 % (mode, losses))
        rec = {"losses": losses, "accuracies": [s[1] for s in main],
               "launches": pth["launches"], "step_ms_2_to_n": step_ms,
               "median_step_ms": median,
               "images_per_s": TRAIN_BATCH * 1e3 / median,
               "first_step_s": pth["first_step_s"],
               "max_memory_allocated": pth["peak"],
               "profile_step": pth["prof"]}
        if mode == "2d":
            out.update(rec)
        else:
            out["4d"] = rec
    for name, r in readings.items():
        if r["passes"] == name.startswith("fault"):
            raise AssertionError("%s %s the train check: %s" % (
                name, "passed" if r["passes"] else "failed", r))
    return out


@contextlib.contextmanager
def checked_kernels(fu, nn, errs):
    """Every kernel wrapper runs as usual, and each call's outputs are
    held against its plain version on the same inputs: ``errs[name]``
    gets the number of calls and the largest relative error of each
    output over them."""
    def make(name, kern, plain):
        def both(*args):
            got = kern(*args)
            want = plain(*args)
            pairs = [(g, w) for g, w in zip(
                got if isinstance(got, tuple) else (got,),
                want if isinstance(want, tuple) else (want,))
                if g is not None]
            e = [rel_err(g, w) for g, w in pairs]
            rec = errs.setdefault(name, {"calls": 0, "rel_errs": e})
            rec["calls"] += 1
            rec["rel_errs"] = [max(a, b) for a, b in zip(rec["rel_errs"], e)]
            return got
        # the wrapper bumps the counter of whatever its module's name holds
        both.launches = 0
        return both
    with contextlib.ExitStack() as stack:
        for mod, name in kernel_sites(fu, nn):
            stack.enter_context(replaced(mod, name, make(
                name, getattr(mod, name), getattr(mod, name + "_plain"))))
        yield


@contextlib.contextmanager
def widened_float(torch):
    """``Tensor.float()`` gives float64 inside the block: the plain
    versions, which compute through ``.float()``, then compute in f64 from
    f64 inputs, the exact reference of an f32 call."""
    saved = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: self.double()
    try:
        yield
    finally:
        torch.Tensor.float = saved


def rel_err64(got, want):
    scale = float(want.double().abs().max()) or 1.0
    return float((got.double() - want.double()).abs().max()) / scale


@contextlib.contextmanager
def f64_checked_kernels(torch, fu, nn, errs):
    """Every kernel wrapper runs as usual; each call's outputs and its
    plain version's (f32) on the same inputs are held against the plain
    version computed in f64 from the same values (``widened_float``).
    ``errs[name]`` gets the number of calls and, per output, the largest
    relative error (to the f64 value's largest magnitude) of the kernel
    (``kernel_f64``) and of the plain version (``plain_f64``), and the
    kernel against the plain version (``rel_errs``)."""
    def wide(a):
        if isinstance(a, (tuple, list)):
            return type(a)(wide(x) for x in a)
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            return a.double()
        return a

    def outputs(r):
        return r if isinstance(r, tuple) else (r,)

    def make(name, kern, plain):
        def both(*args):
            got = kern(*args)
            want = plain(*args)
            with widened_float(torch):
                exact = plain(*wide(args))
            trip = [(g, w, e) for g, w, e in zip(
                outputs(got), outputs(want), outputs(exact)) if g is not None]
            reading = {"rel_errs": [rel_err(g, w) for g, w, _ in trip],
                       "kernel_f64": [rel_err64(g, e) for g, _, e in trip],
                       "plain_f64": [rel_err64(w, e) for _, w, e in trip]}
            rec = errs.setdefault(name, dict(reading, calls=0))
            rec["calls"] += 1
            for k, v in reading.items():
                rec[k] = [max(a, b) for a, b in zip(rec[k], v)]
            return got
        # the wrapper bumps the counter of whatever its module's name holds
        both.launches = 0
        return both
    with contextlib.ExitStack() as stack:
        for mod, name in kernel_sites(fu, nn):
            stack.enter_context(replaced(mod, name, make(
                name, getattr(mod, name), getattr(mod, name + "_plain"))))
        yield


@contextlib.contextmanager
def stem_dbeta_zeroed(torch, nn):
    """A planted fault: the fused stem's backward returns dbeta zero."""
    cls = nn._BNStemConv
    saved = cls.__dict__["backward"]

    def faulty(ctx, *grads):
        out = list(saved.__func__(ctx, *grads))
        out[1] = torch.zeros_like(out[1])
        return tuple(out)
    cls.backward = staticmethod(faulty)
    try:
        yield
    finally:
        cls.backward = saved


def _residual_dropped(launch):
    """A planted fault: K2 launched with a zero residual."""
    def faulty(name, *args):
        if name == "fu_mm_skip_fwd":
            args = args[:4] + (args[4].new_zeros(args[4].shape),) + args[5:]
        launch(name, *args)
    return faulty


def _grad_reading(grads, ref, dtype):
    """Step 1's gradients against the reference run's: over all parameters
    as one vector, |g - g_ref| / |g_ref| (L2); each parameter's relative L2
    difference and its largest difference over its largest magnitude, the
    worst of each; and the verdict of BENCH_GRAD_RTOL (and in f32
    BENCH_TENSOR_RTOL)."""
    d2 = {n: float((g.double() - ref[n].double()).pow(2).sum())
          for n, g in grads.items()}
    r2 = {n: float(ref[n].double().pow(2).sum()) for n in grads}
    l2 = {n: (d2[n] / r2[n]) ** 0.5 if r2[n] else d2[n] ** 0.5
          for n in grads}
    rel = {n: rel_err(g, ref[n]) for n, g in grads.items()}
    worst_l2, worst = max(l2, key=l2.get), max(rel, key=rel.get)
    err = (sum(d2.values()) / sum(r2.values())) ** 0.5
    return {"grad_rel_err": err, "worst_l2": l2[worst_l2],
            "worst_l2_param": worst_l2, "worst_rel": rel[worst],
            "worst": worst,
            "passes": err <= BENCH_GRAD_RTOL[dtype] and (
                dtype != "float32" or rel[worst] <= BENCH_TENSOR_RTOL)}


def stem_check(torch, mt, seed, dev):
    """The fused stem (``_contrib_BNStemConv``) against BatchNorm
    (fix_gamma) + Convolution on the same f32 weights at bench.py's
    shapes: output, dW and dbeta for one seeded cotangent, each relative
    to the largest magnitude, and whether all three are within
    STEM_FWD_TOL and STEM_BWD_TOL."""
    gen = torch.Generator(device="cpu").manual_seed(seed + 5)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)
    n, side, nf = BENCH_BATCH, BENCH_IMAGE, 64
    data = randn(n, side, side, 3) * 2 + 1
    weight = randn(nf, 7, 7, 3, scale=(2.0 / 147) ** 0.5)
    beta = randn(3, scale=0.1)
    gamma, mm, mv = (torch.ones(3, device=dev), torch.zeros(3, device=dev),
                     torch.ones(3, device=dev))
    cot = randn(n, side // 2, side // 2, nf)
    conv = dict(num_filter=nf, kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                layout="NHWC")
    invoke = mt.ops.invoke

    def run(fused):
        b = beta.clone().requires_grad_(True)
        w = weight.clone().requires_grad_(True)
        with torch.enable_grad():
            if fused:
                out = invoke("_contrib_BNStemConv", dict(
                    conv, eps=2e-5, momentum=0.9, fix_gamma=True), data,
                    gamma, b, w, mm, mv, training=True)[0]
            else:
                bn = invoke("BatchNorm", dict(eps=2e-5, momentum=0.9,
                                              fix_gamma=True, axis=3),
                            data, gamma, b, mm, mv, training=True)[0]
                out = invoke("Convolution", dict(conv, no_bias=True), bn,
                             w)[0]
            db, dw = torch.autograd.grad(out, (b, w), cot)
        return out.detach(), dw, db
    got, want = run(True), run(False)
    torch.cuda.synchronize()
    out = {"passes": True}
    for what, g, w, tol in zip(("output", "dW", "dbeta"), got, want,
                               (STEM_FWD_TOL, STEM_BWD_TOL, STEM_BWD_TOL)):
        bound = tol * (w.abs() if what == "output" else w.abs().max()) + tol
        out[what] = rel_err(g, w)
        out["passes"] &= bool(((g - w).abs() <= bound).all())
    return out


def bench_phase(torch, mt, fu, nn, kv, seed, card):
    """bench.py's training step through ``bench_step.TrainStep`` in each
    of BENCH_CONFIGS, from the same bf16 weights; each config's main path
    counted, timed and profiled with its counters set to 0 just before
    it, then checked."""
    import numpy as np
    dev = mt.gpu(0).device
    bf16, side = torch.bfloat16, BENCH_IMAGE
    wrappers = kernel_wrappers(fu, nn, kv)
    log("  %s" % card)
    stem = {"sound": stem_check(torch, mt, seed, dev)}
    with stem_dbeta_zeroed(torch, nn):
        stem["fault: stem dbeta zeroed"] = stem_check(torch, mt, seed, dev)
    for run, r in stem.items():
        log("  fused stem against BatchNorm + Convolution, f32, batch %d, "
            "%s: output %.2e, dW %.2e, dbeta %.2e (relative to the largest "
            "magnitude)" % (BENCH_BATCH, run, r["output"], r["dW"],
                            r["dbeta"]))
    failures = ["the stem check: %s %s it: %s" % (
        run, "passed" if r["passes"] else "failed", r)
        for run, r in stem.items() if r["passes"] == run.startswith("fault")]
    syms = {name: mt.models.get_resnet_symbol(
        num_classes=1000, num_layers=50, image_shape=(3, side, side),
        layout="NHWC", stem="fused", unit_impl=impl)
        for name, (impl, _) in BENCH_CONFIGS.items()}
    args, aux = mt.convert.random_params(syms["bench"],
                                         {"data": (1, side, side, 3)},
                                         seed=seed)
    rng = np.random.default_rng(seed + 3)
    u8 = torch.from_numpy(rng.integers(
        0, 256, (BENCH_BATCH, side, side, 3), dtype=np.uint8)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 1000, BENCH_BATCH)
                              .astype(np.float32)).to(dev)
    out = {"batch": BENCH_BATCH, "image": side, "lr": BENCH_LR,
           "stem_check": stem, "configs": {}}
    for name, (impl, env) in BENCH_CONFIGS.items():
        step = mt.bench_step.TrainStep(syms[name], dtype=bf16, lr=BENCH_LR)
        params0 = tuple(torch.from_numpy(args[n]).to(dev, bf16)
                        for n in step.param_names)
        aux0 = tuple(torch.from_numpy(aux[n]).to(dev)
                     for n in step.aux_names)
        steps = BENCH_WARMUP + BENCH_STEPS
        with env_vars(env):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            for k in wrappers:
                k.launches = 0
            params, auxs, losses, secs = params0, aux0, [], []
            for _ in range(steps):
                t0 = time.perf_counter()
                loss, grads, params, auxs = step(u8, labels, params, auxs)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                losses.append(float(loss))
                del grads
            launches = {k.__name__: k.launches for k in wrappers}
            peak = torch.cuda.max_memory_allocated()
            finite = all(bool(torch.isfinite(t).all())
                         for t in params + auxs)
            prof = profile_calls(
                torch, lambda: step(u8, labels, params, auxs), 2)
            del params, auxs
            # step 1's loss against one f32 forward of the same weights
            step32 = mt.bench_step.TrainStep(syms[name], dtype=torch.float32)
            with torch.no_grad():
                loss32 = float(step32.forward_loss(
                    u8, labels, [p.float() for p in params0], aux0)[0])
            checks, kerr = {}, {}
            if impl == "fused":
                checks = bench_checks(torch, mt, fu, nn, syms[name], u8,
                                      labels, params0, aux0, kerr)
        torch.cuda.empty_cache()
        step_ms = [1e3 * t for t in secs[BENCH_WARMUP:]]
        median = _median(step_ms)
        rec = {"losses": losses, "step_ms": step_ms, "median_step_ms": median,
               "spread_ms": max(step_ms) - min(step_ms),
               "images_per_s": BENCH_BATCH * 1e3 / median,
               "first_step_s": secs[0], "max_memory_allocated": peak,
               "launches": launches,
               "launches_per_step": {k: v / steps for k, v in
                                     launches.items() if v},
               "profile_step": prof, "loss_f32": loss32,
               "loss_f32_rel_diff": abs(losses[0] - loss32) / abs(loss32),
               "checks": checks, "kernel_rel_errs": kerr}
        out["configs"][name] = rec
        log("  %s (unit_impl=%s): losses %s; f32 loss %.5f (step 1 rel diff "
            "%.2e)" % (name, impl, fmt(losses), loss32,
                       rec["loss_f32_rel_diff"]))
        log("  %s: median step (of %d after %d warm-up) %.2f ms, spread "
            "%.2f ms, %.1f images/s, first step %.2f s, "
            "max_memory_allocated %.2f GB; launches per step %s [%s]"
            % (name, BENCH_STEPS, BENCH_WARMUP, median, rec["spread_ms"],
               rec["images_per_s"], secs[0], peak / 1e9,
               rec["launches_per_step"], card))
        log_profile("one bf16 step, %s" % name, prof, card)
        for run, r in checks.items():
            log("  %s: %-40s step-1 gradient vs plain: %.3e (L2, all "
                "parameters); worst parameter L2 %.3e (%s), largest "
                "difference %.3e (%s)" % (
                    name, run, r["grad_rel_err"], r["worst_l2"],
                    r["worst_l2_param"], r["worst_rel"], r["worst"]))
        for k, v in sorted(kerr.items()):
            log("  %s: %-12s against its plain version over %d calls: %s"
                % (name, k, v["calls"], fmt(v["rel_errs"], "%.2e")))
        try:
            _launch_check("bench, %s" % name, launches, BENCH_LAUNCHES[name],
                          steps)
            if not (finite and np.isfinite(losses).all()):
                raise AssertionError("non-finite loss or parameter: %s"
                                     % losses)
            if not losses[-1] < losses[0]:
                raise AssertionError("the loss did not fall: %s" % losses)
            if rec["loss_f32_rel_diff"] > BENCH_F32_RTOL:
                raise AssertionError("step 1's loss %.5f is %.3g from the "
                                     "f32 loss %.5f" % (
                                         losses[0], rec["loss_f32_rel_diff"],
                                         loss32))
            for k, v in kerr.items():
                tols = BENCH_KERNEL_TOLS[k]
                if any(e > t for e, t in zip(v["rel_errs"], tols)):
                    raise AssertionError("%s against its plain version: %s "
                                         "over %s" % (k, v, tols))
            # the kernels and the controls must pass, the fault must fail
            for run, r in checks.items():
                if r["passes"] == ("fault:" in run):
                    raise AssertionError("%s %s the check against the plain "
                                         "versions: %s" % (
                                             run, "passed" if r["passes"]
                                             else "failed", r))
        except AssertionError as e:
            failures.append("%s: %s" % (name, e))
    if failures:
        raise AssertionError("bench: " + "; ".join(failures))
    return out


def bench_checks(torch, mt, fu, nn, sym, u8, labels, params0, aux0, kerr):
    """Step 1 from the same weights, in bf16 (bench.py's dtype) and in f32
    (the same weights widened), with cuDNN deterministic: through the
    plain versions (the reference); two controls through the plain
    versions, the batch reversed (the same function, every sum in another
    order) and conv0_weight one step of the dtype away from zero; through
    the kernels, each bf16 call held against its plain version on the
    same inputs (``kerr``); and with a planted fault, K2's residual
    dropped.  Each is read against the reference of its dtype."""
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        for dt, bits in ((torch.bfloat16, torch.int16),
                         (torch.float32, torch.int32)):
            step = mt.bench_step.TrainStep(sym, dtype=dt, lr=BENCH_LR)
            params = tuple(p.to(dt) for p in params0)

            def grads(params, rev=False):
                x, y = (u8.flip(0), labels.flip(0)) if rev else (u8, labels)
                g = step(x, y, params, aux0)[1]
                return {n: t.detach() for n, t in zip(step.param_names, g)}
            i = step.param_names.index("conv0_weight")
            moved = list(params)
            moved[i] = (params[i].view(bits) + 1).view(dt)
            with plain_kernels(fu, nn):
                ref = grads(params)
                runs = {"control: plain, batch reversed": grads(params, True),
                        "control: conv0_weight +1 step": grads(tuple(moved))}
            with checked_kernels(fu, nn, kerr if dt == torch.bfloat16
                                 else {}):
                runs["kernels"] = grads(params)
            with replaced(fu, "launch", _residual_dropped(fu.launch)):
                runs["fault: K2 residual dropped"] = grads(params)
            name = str(dt).split(".")[1]
            out.update(("%s, %s" % (name, run), _grad_reading(g, ref, name))
                       for run, g in runs.items())
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def write_raw_records(mt, prefix, n, seed):
    """bench.py's ``_make_raw_rec`` through the port's recordio: ``n``
    seeded uint8 images at IMAGENET_STORED x IMAGENET_STORED (the
    ``im2rec --encoding raw`` format), label i % 1000, with an index."""
    import numpy as np
    rio = mt.recordio
    rng = np.random.default_rng(seed)
    shape = (IMAGENET_STORED, IMAGENET_STORED, 3)
    w = rio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    try:
        for i in range(n):
            img = rng.integers(0, 256, shape, dtype=np.uint8)
            w.write_idx(i, rio.pack(rio.IRHeader(0, float(i % 1000), i, 0),
                                    img.tobytes()))
    finally:
        w.close()
    return prefix + ".rec"


def imagenet_iter(mt, rec, train, seed, **kwargs):
    """``examples/train_imagenet.py``'s ImageRecordIter over ``rec``: its
    ``common_iter`` (224x224, NHWC, the example's mean and std, raw
    records at IMAGENET_STORED, one preprocess thread per host core),
    shuffled, cropped and mirrored at random for training; ``kwargs``
    override."""
    side = IMAGENET_IMAGE
    args = dict(path_imgrec=rec, data_shape=(3, side, side),
                batch_size=IMAGENET_BATCH,
                preprocess_threads=os.cpu_count(), layout="NHWC",
                raw_shape=(IMAGENET_STORED, IMAGENET_STORED, 3), seed=seed)
    args.update(zip(("mean_r", "mean_g", "mean_b"), IMAGENET_MEAN))
    args.update(zip(("std_r", "std_g", "std_b"), IMAGENET_STD))
    if train:
        args.update(shuffle=True, rand_crop=True, rand_mirror=True)
    args.update(kwargs)
    return mt.io.ImageRecordIter(**args)


def window_reading(mt, rec, images, keys, labels):
    """Each image (HWC float32, as the iterator normalized it) against
    every 224x224 window of its own stored record, mirrored or not, each
    normalized here in numpy with the example's mean and std: the windows
    it equals within WINDOW_TOL, and its label against the record
    header's.  Passes when every image equals a window and every label
    its record's."""
    import numpy as np
    rio = mt.recordio
    mean = np.array(IMAGENET_MEAN, np.float32)
    std = np.array(IMAGENET_STD, np.float32)
    side = IMAGENET_IMAGE
    span = IMAGENET_STORED - side + 1
    rd = rio.MXIndexedRecordIO(os.path.splitext(rec)[0] + ".idx", rec, "r")
    out = []
    try:
        for img, key, label in zip(images, keys, labels):
            header, buf = rio.unpack(rd.read_idx(int(key)))
            src = np.frombuffer(buf, np.uint8).reshape(
                IMAGENET_STORED, IMAGENET_STORED, 3)
            hits = []
            for mirror in (False, True):
                for dy in range(span):
                    for dx in range(span):
                        win = src[dy:dy + side, dx:dx + side]
                        if mirror:
                            win = win[:, ::-1]
                        # the first row rules out a wrong window of random
                        # pixels; the survivors are held whole
                        row = (win[0].astype(np.float32) - mean) / std
                        if np.abs(row - img[0]).max() > WINDOW_TOL:
                            continue
                        err = float(np.abs(
                            (win.astype(np.float32) - mean) / std
                            - img).max())
                        if err <= WINDOW_TOL:
                            hits.append((dy, dx, mirror, err))
            out.append({"key": int(key), "windows": hits,
                        "label": float(label),
                        "record_label": float(header.label)})
    finally:
        rd.close()
    return {"images": out,
            "passes": all(r["windows"] and r["label"] == r["record_label"]
                          for r in out)}


def lr_reading(lrs):
    """The rates of updates 1..4 against IMAGENET_LRS."""
    return {"lrs": lrs, "passes": len(lrs) == len(IMAGENET_LRS) and all(
        abs(a - b) <= 1e-12 * b for a, b in zip(lrs, IMAGENET_LRS))}


def scheduler_lrs(mt, decay_at):
    """The rates SGD applies at updates 1..4 of one weight on cuda:0 with
    the fit's settings and a MultiFactorScheduler that decays after
    update ``decay_at``, read as the fit reads them."""
    opt = mt.optimizer.SGD(lr_scheduler=mt.lr_scheduler.MultiFactorScheduler(
        step=[decay_at], factor=0.1), **SGD)
    upd = mt.optimizer.get_updater(opt)
    w, g = mt.nd.zeros((4,), mt.gpu(0)), mt.nd.zeros((4,), mt.gpu(0))
    lrs = []
    for _ in IMAGENET_LRS:
        upd(0, g, w)
        lrs.append(opt._get_lr(0))
    return lrs


def imagenet_fit(torch, mt, sym, recs, prefix, seed, begin_epoch=0,
                 arg_params=None, aux_params=None):
    """``examples/common.py``'s ``fit`` of ``sym`` on cuda:0 over
    train_imagenet.py's iterators, Xavier from ``seed``, a checkpoint an
    epoch at ``prefix``.  Returns each step's loss (from the softmax and
    the labels), update count, rate and host time at its end; the
    validation accuracies; the first batch with a host copy of its first
    WINDOW_IMAGES images, keys and labels; the module; the start time."""
    import numpy as np
    train = imagenet_iter(mt, recs["train"], True, seed)
    val = imagenet_iter(mt, recs["val"], False, seed)
    steps, val_acc, first = [], [], {}

    def on_batch(param):
        probs = mod.get_outputs()[0]._data
        batch = param.locals["batch"]
        labels = batch.label[0]._data.to(probs.device).long()
        rows = torch.arange(probs.shape[0], device=probs.device)
        loss = float(-torch.log(probs[rows, labels] + 1e-8).mean())
        opt = mod._optimizer
        steps.append({"epoch": param.epoch, "nbatch": param.nbatch,
                      "loss": loss, "num_update": opt.num_update,
                      "lr": opt._get_lr(0), "t": time.perf_counter()})
        if not first:
            first.update(
                batch=batch,
                images=batch.data[0].asnumpy()[:WINDOW_IMAGES].copy(),
                keys=np.array(batch.index[:WINDOW_IMAGES]),
                labels=batch.label[0].asnumpy()[:WINDOW_IMAGES].copy())

    def on_eval(param):
        val_acc.append(float(dict(
            param.eval_metric.get_name_value())["accuracy"]))
    mt.random.seed(seed)
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    sched = mt.lr_scheduler.MultiFactorScheduler(step=[IMAGENET_DECAY_AT],
                                                 factor=0.1)
    t0 = time.perf_counter()
    try:
        mod.fit(train, eval_data=val, num_epoch=IMAGENET_EPOCHS,
                begin_epoch=begin_epoch, kvstore="local", optimizer="sgd",
                optimizer_params=dict(SGD, lr_scheduler=sched),
                arg_params=arg_params, aux_params=aux_params,
                initializer=mt.init.Xavier(),
                batch_end_callback=[
                    mt.callback.Speedometer(IMAGENET_BATCH, 1), on_batch],
                eval_end_callback=on_eval,
                epoch_end_callback=mt.callback.do_checkpoint(prefix))
    finally:
        train.close()
        val.close()
    return steps, val_acc, first, mod, t0


def kernel_failures(kerr):
    """The kernels of ``kerr`` (``f64_checked_kernels``' readings) whose
    outputs are not within IMAGENET_KERNEL_RTOL of the plain version's, or
    not within the larger of IMAGENET_F64_FLOOR and IMAGENET_F64_FACTOR
    times the plain version's error of the f64 value."""
    return sorted(k for k, v in kerr.items() if any(
        e > IMAGENET_KERNEL_RTOL for e in v["rel_errs"]) or any(
        e > max(IMAGENET_F64_FLOOR, IMAGENET_F64_FACTOR * p)
        for e, p in zip(v["kernel_f64"], v["plain_f64"])))


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.asnumpy().tobytes() == b.asnumpy().tobytes()


def pipeline_rate(mt, rec, seed, **kwargs):
    """The training iterator alone over ``rec``: one warm-up epoch, then
    PIPELINE_EPOCHS epochs, each timed from just before ``reset()`` (which
    submits the epoch's first batches) to its last batch;
    images/s, the median of the epochs', and the seconds between
    batches."""
    it = imagenet_iter(mt, rec, True, seed, **kwargs)
    rates, gaps = [], []
    try:
        for _ in it:
            pass
        for _ in range(PIPELINE_EPOCHS):
            t = t0 = time.perf_counter()
            it.reset()
            n = 0
            for b in it:
                now = time.perf_counter()
                gaps.append(now - t)
                t = now
                n += b.data[0].shape[0]
            rates.append(n / (t - t0))
    finally:
        it.close()
    return {"images_per_s": _median(rates), "epoch_images_per_s": rates,
            "batch_gaps_s": gaps, "threads": os.cpu_count()}


def overlap_reading(torch, mt, seed, rec, card):
    """bench.py's step (config ``bench``: unit_impl plain, stem fused,
    bf16, batch 256, weights from ``seed``) through
    ``bench_step.TrainStep`` on cuda:0, in OVERLAP_ROUNDS rounds of
    OVERLAP_STEPS steps on one uint8 batch resident on the card, then
    OVERLAP_STEPS steps each fed a new uint8 NHWC batch from the training
    iterator (random crop and mirror, not normalized: the step scales it),
    copied to the card in the step; after OVERLAP_WARMUP warm-up steps of
    each.  Images/s of each round and their medians, one fed step
    profiled, and the losses."""
    import numpy as np
    dev = mt.gpu(0).device
    side = IMAGENET_IMAGE
    sym = mt.models.get_resnet_symbol(
        num_classes=1000, num_layers=50, image_shape=(3, side, side),
        layout="NHWC", stem="fused", unit_impl="plain")
    args, aux = mt.convert.random_params(sym, {"data": (1, side, side, 3)},
                                         seed=seed)
    step = mt.bench_step.TrainStep(sym, dtype=torch.bfloat16, lr=BENCH_LR)
    state = [tuple(torch.from_numpy(args[n]).to(dev, torch.bfloat16)
                   for n in step.param_names),
             tuple(torch.from_numpy(aux[n]).to(dev) for n in step.aux_names)]
    it = imagenet_iter(mt, rec, True, seed, dtype="uint8", **UNNORMALIZED)
    losses = []

    def fetch():
        try:
            b = it.next()
        except StopIteration:
            it.reset()
            b = it.next()
        return b.data[0]._data.to(dev), b.label[0]._data.to(dev)

    def run(n, batch=None):
        """``n`` steps, on ``batch`` or each on a new one; seconds."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            x, y = batch or fetch()
            loss, grads, state[0], state[1] = step(x, y, *state)
            del grads
            losses.append(loss)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    out = {"steps": OVERLAP_STEPS, "warmup": OVERLAP_WARMUP,
           "rounds": OVERLAP_ROUNDS}
    try:
        resident = fetch()
        assert resident[0].dtype == torch.uint8 and tuple(
            resident[0].shape) == (IMAGENET_BATCH, side, side, 3)
        run(OVERLAP_WARMUP, resident)
        run(OVERLAP_WARMUP)
        rates = {"resident": [], "fed": []}
        for _ in range(OVERLAP_ROUNDS):
            for mode in ("resident", "fed"):
                secs = run(OVERLAP_STEPS,
                           resident if mode == "resident" else None)
                rates[mode].append(OVERLAP_STEPS * IMAGENET_BATCH / secs)
        for mode, r in rates.items():
            out[mode] = {"images_per_s": _median(r), "rounds_images_per_s": r,
                         "step_ms": 1e3 * IMAGENET_BATCH / _median(r)}
        out["profile_fed_step"] = profile_calls(
            torch, lambda: step(*fetch(), *state), 2)
    finally:
        it.close()
    out["losses"] = [float(v) for v in losses]
    out["finite"] = bool(np.isfinite(out["losses"]).all())
    return out


def imagenet_phase(torch, mt, fu, nn, kv, seed, card):
    """``examples/train_imagenet.py``'s path at full width (see
    IMAGENET_*): the input pipeline alone; the fit with the example's
    ``unit_impl="plain"`` and with the fused units and
    MXNET_CONV1X1_FUSED_BWD=1, each counted, timed and profiled with its
    counters set to 0 just before it, then checked (windows, rates,
    losses, checkpoints, a resumed fit, planted faults); bench.py's step
    fed by the pipeline.  Every failed check fails the phase."""
    import gc
    import importlib.util
    import numpy as np
    wrappers = kernel_wrappers(fu, nn, kv)
    side = IMAGENET_IMAGE
    syms = {impl: mt.models.get_resnet_symbol(
        num_classes=1000, num_layers=50, image_shape=(3, side, side),
        layout="NHWC", unit_impl=impl) for impl in ("plain", "fused")}
    out = {"batch": IMAGENET_BATCH, "stored": IMAGENET_STORED,
           "host_cores": os.cpu_count(), "card": card, "fits": {}}
    failures = []
    with tempfile.TemporaryDirectory(prefix="imagenet") as tmp:
        t0 = time.perf_counter()
        recs = {"train": write_raw_records(
                    mt, os.path.join(tmp, "train"), IMAGENET_TRAIN_RECORDS,
                    seed),
                "val": write_raw_records(
                    mt, os.path.join(tmp, "val"), IMAGENET_VAL_RECORDS,
                    seed + 1)}
        nbytes = sum(os.path.getsize(r) for r in recs.values())
        log("  raw records: %d train, %d val at %dx%dx3, %.1f MB, written "
            "in %.2f s" % (IMAGENET_TRAIN_RECORDS, IMAGENET_VAL_RECORDS,
                           IMAGENET_STORED, IMAGENET_STORED, nbytes / 1e6,
                           time.perf_counter() - t0))
        out["record_bytes"] = nbytes

        # the input pipeline alone: bench.py's pipeline_images_per_sec
        # (uint8, crop and mirror) and the fit's iterator (float32,
        # normalized)
        pipe = out["pipeline"] = {
            "uint8": pipeline_rate(mt, recs["train"], seed, dtype="uint8",
                                   **UNNORMALIZED),
            "float32": pipeline_rate(mt, recs["train"], seed)}
        codec = next((m for m in ("cv2", "PIL")
                      if importlib.util.find_spec(m)), None)
        if codec:
            jpeg = os.path.join(tmp, "train_jpeg")
            rio = mt.recordio
            rd = rio.MXIndexedRecordIO(os.path.join(tmp, "train.idx"),
                                       recs["train"], "r")
            w = rio.MXIndexedRecordIO(jpeg + ".idx", jpeg + ".rec", "w")
            for k in rd.keys:
                hdr, buf = rio.unpack(rd.read_idx(k))
                img = np.frombuffer(buf, np.uint8).reshape(
                    IMAGENET_STORED, IMAGENET_STORED, 3)
                w.write_idx(k, rio.pack_img(hdr, img, quality=90))
            w.close()
            rd.close()
            pipe["jpeg_uint8"] = pipeline_rate(
                mt, jpeg + ".rec", seed, dtype="uint8", raw_shape=None,
                **UNNORMALIZED)
            pipe["jpeg_uint8"]["codec"] = codec
        for name, r in pipe.items():
            log("  pipeline alone, %s: %.1f images/s (median of %d epochs "
                "of %d batches: %s), %d threads, host cores %d"
                % (name, r["images_per_s"], PIPELINE_EPOCHS,
                   IMAGENET_TRAIN_RECORDS // IMAGENET_BATCH,
                   fmt(r["epoch_images_per_s"], "%.1f"), r["threads"],
                   os.cpu_count()))
        if not codec:
            log("  the JPEG path was not run: neither cv2 nor PIL is "
                "installed on this host, and the port decodes JPEG through "
                "one of them")

        lr_fault = lr_reading(scheduler_lrs(mt, IMAGENET_DECAY_AT - 1))
        for impl, env in (("plain", {"MXNET_CONV1X1_FUSED_BWD": None,
                                     "MXNET_FUSED_UNIT_C3": None}),
                          ("fused", {"MXNET_CONV1X1_FUSED_BWD": "1",
                                     "MXNET_FUSED_UNIT_C3": None})):
            prefix = os.path.join(tmp, impl)
            with env_vars(env):
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                for k in wrappers:
                    k.launches = 0
                steps, val_acc, first, mod, t0 = imagenet_fit(
                    torch, mt, syms[impl], recs, prefix, seed)
                launches = {k.__name__: k.launches for k in wrappers}
                peak = torch.cuda.max_memory_allocated()
                args, aux = mod.get_params()
                files = ["%s-symbol.json" % prefix] + [
                    "%s-%04d.params" % (prefix, e)
                    for e in range(1, IMAGENET_EPOCHS + 1)]
                missing = [f for f in files if not os.path.exists(f)]
                _, ck_args, ck_aux = mt.model.load_checkpoint(
                    prefix, IMAGENET_EPOCHS)
                ckpt_equal = (sorted(ck_args) == sorted(args)
                              and sorted(ck_aux) == sorted(aux)
                              and all(_same_bits(ck_args[n], v)
                                      for n, v in args.items())
                              and all(_same_bits(ck_aux[n], v)
                                      for n, v in aux.items()))
                del args, aux, ck_args, ck_aux
                kerr, kfault = {}, {}
                if impl == "fused":
                    # each kernel call of one step on the fit's first batch
                    # and its plain version on the same inputs, against the
                    # plain version in f64, and of the same step with the
                    # units' 3x3 on 4D tiles (K4, K7); then with K5's dW
                    # zeroed
                    with f64_checked_kernels(torch, fu, nn, kerr):
                        mod.forward_backward(first["batch"])
                        with c3_mode("4d"):
                            mod.forward_backward(first["batch"])
                    with replaced(fu, "launch",
                                  _dw_zeroed("fu_mm_bwd")(fu.launch)), \
                            f64_checked_kernels(torch, fu, nn, kfault):
                        mod.forward_backward(first["batch"])
                    torch.cuda.synchronize()

                def step():
                    mod.forward_backward(first["batch"])
                    mod.update()
                prof = profile_calls(torch, step, 2)
                del mod
                gc.collect()
                torch.cuda.empty_cache()
            intervals = [1e3 * (b["t"] - a["t"]) for a, b in
                         zip(steps, steps[1:]) if a["epoch"] == b["epoch"]]
            median = _median(intervals)
            rec = {"losses": [s["loss"] for s in steps],
                   "num_updates": [s["num_update"] for s in steps],
                   "lr": lr_reading([s["lr"] for s in steps]),
                   "val_accuracy": val_acc, "launches": launches,
                   "step_ms_within_epochs": intervals,
                   "median_step_ms": median,
                   "images_per_s": IMAGENET_BATCH * 1e3 / median,
                   "first_step_s": steps[0]["t"] - t0,
                   "max_memory_allocated": peak, "profile_step": prof,
                   "checkpoint_files_missing": missing,
                   "checkpoint_equals_params": ckpt_equal,
                   "kernel_rel_errs": kerr, "kernel_fault": kfault,
                   "windows": window_reading(mt, recs["train"],
                                             first["images"], first["keys"],
                                             first["labels"])}
            if impl == "plain":
                rec["windows_fault_flipped"] = window_reading(
                    mt, recs["train"], first["images"][:, ::-1],
                    first["keys"], first["labels"])
            del first
            out["fits"][impl] = rec
            log("  fit, unit_impl=%s: losses %s, updates %s, rates %s, "
                "validation accuracy %s; launches %s" % (
                    impl, fmt(rec["losses"]), rec["num_updates"],
                    rec["lr"]["lrs"], val_acc,
                    {k: v for k, v in launches.items() if v}))
            log("  fit, unit_impl=%s: step within an epoch %s ms (median "
                "%.2f), %.1f images/s, first step %.2f s, "
                "max_memory_allocated %.2f GB [%s, host cores %d]" % (
                    impl, fmt(intervals, "%.2f"), median,
                    rec["images_per_s"], rec["first_step_s"], peak / 1e9,
                    card, os.cpu_count()))
            log_profile("one f32 step of the fit, unit_impl=%s" % impl, prof,
                        card)
            for k, v in sorted(kerr.items()):
                log("  fused fit: %-12s over %d calls, against the f64 "
                    "value: kernel %s, plain f32 %s; kernel against plain "
                    "%s" % (k, v["calls"], fmt(v["kernel_f64"], "%.2e"),
                            fmt(v["plain_f64"], "%.2e"),
                            fmt(v["rel_errs"], "%.2e")))
            if impl == "fused":
                log("  fused fit, K5 dW zeroed (a planted fault): kernels "
                    "failing the check %s" % kernel_failures(kfault))
            for r in rec["windows"]["images"]:
                log("  record %d: windows %s, label %s (record %s)" % (
                    r["key"], [(dy, dx, m) for dy, dx, m, _ in r["windows"]],
                    r["label"], r["record_label"]))
            # the checks of this fit
            want = {k: (IMAGENET_STEPS * TRAIN_LAUNCHES["2d"].get(k, 0)
                        + IMAGENET_VAL_BATCHES * VAL_LAUNCHES.get(k, 0))
                    if impl == "fused" else 0 for k in launches}
            if launches != want:
                failures.append("%s fit: launches %s, not %s"
                                % (impl, launches, want))
            if not rec["windows"]["passes"]:
                failures.append("%s fit: an image of the first batch is no "
                                "window of its record: %s"
                                % (impl, rec["windows"]))
            if not rec["lr"]["passes"]:
                failures.append("%s fit: rates %s, not %s"
                                % (impl, rec["lr"]["lrs"], IMAGENET_LRS))
            if not (np.isfinite(rec["losses"]).all()
                    and len(rec["losses"]) == len(IMAGENET_LRS)
                    and np.isfinite(val_acc).all()
                    and len(val_acc) == IMAGENET_EPOCHS):
                failures.append("%s fit: losses %s, validation accuracy %s"
                                % (impl, rec["losses"], val_acc))
            if missing or not ckpt_equal:
                failures.append("%s fit: checkpoint files missing %s, "
                                "checkpoint %d equals the parameters: %s"
                                % (impl, missing, IMAGENET_EPOCHS,
                                   ckpt_equal))
            if impl == "fused":
                checked = {k for mode in ("2d", "4d")
                           for k, n in TRAIN_LAUNCHES[mode].items() if n}
                if set(kerr) != checked or kernel_failures(kerr):
                    failures.append("fused fit: kernel calls against the "
                                    "plain and f64 versions: %s" % kerr)
                if "mm_bwd" not in kernel_failures(rec["kernel_fault"]):
                    failures.append("fused fit: the planted fault (K5 dW "
                                    "zeroed) passed the kernel check: %s"
                                    % rec["kernel_fault"])

        # a fit resumed from checkpoint 1 runs its epoch
        prefix = os.path.join(tmp, "plain")
        _, a1, x1 = mt.model.load_checkpoint(prefix, 1)
        steps, val_acc, _, mod, _ = imagenet_fit(
            torch, mt, syms["plain"], recs, prefix + "-resumed", seed,
            begin_epoch=1, arg_params=a1, aux_params=x1)
        del mod, a1, x1
        gc.collect()
        torch.cuda.empty_cache()
        resumed = out["resumed"] = {
            "epochs": sorted({s["epoch"] for s in steps}),
            "losses": [s["loss"] for s in steps], "val_accuracy": val_acc,
            "checkpoint": os.path.exists(
                "%s-resumed-%04d.params" % (prefix, IMAGENET_EPOCHS))}
        log("  fit resumed from checkpoint 1 (begin_epoch=1): epochs %s, "
            "losses %s, validation accuracy %s, checkpoint %d written: %s"
            % (resumed["epochs"], fmt(resumed["losses"]), val_acc,
               IMAGENET_EPOCHS, resumed["checkpoint"]))
        if not (resumed["epochs"] == [1] and len(resumed["losses"]) == 2
                and np.isfinite(resumed["losses"]).all()
                and len(val_acc) == 1 and np.isfinite(val_acc).all()
                and resumed["checkpoint"]):
            failures.append("the resumed fit: %s" % resumed)

        plain, fused = out["fits"]["plain"], out["fits"]["fused"]
        rel = abs(fused["losses"][0] - plain["losses"][0]) / abs(
            plain["losses"][0])
        out["step1_loss_rel_diff"] = rel
        log("  step 1's loss: plain %.6f, fused %.6f, rel diff %.2e "
            "(limit %.0e)" % (plain["losses"][0], fused["losses"][0], rel,
                              IMAGENET_LOSS_RTOL))
        if rel > IMAGENET_LOSS_RTOL:
            failures.append("step 1's loss: fused %r against plain %r"
                            % (fused["losses"][0], plain["losses"][0]))
        # the planted faults must fail their checks
        out["faults"] = {
            "fault: image flipped vertically":
                plain["windows_fault_flipped"]["passes"],
            "fault: rate decays one update early": lr_fault["passes"]}
        log("  planted faults: an image flipped vertically %s the window "
            "check; a scheduler decaying one update early (rates %s) %s the "
            "rate check" % (
                "passes" if out["faults"]["fault: image flipped vertically"]
                else "fails", lr_fault["lrs"],
                "passes" if lr_fault["passes"] else "fails"))
        failures.extend("%s passed its check" % name
                        for name, passed in out["faults"].items() if passed)

        # bench.py's step fed by the pipeline
        ov = out["overlap"] = overlap_reading(torch, mt, seed, recs["train"],
                                              card)
    alone = {"card (resident batch)": ov["resident"]["images_per_s"],
             "pipeline (uint8)": pipe["uint8"]["images_per_s"]}
    slower = min(alone, key=alone.get)
    fed = ov["fed"]["images_per_s"]
    ov["slower_side_alone"] = slower
    ov["fed_over_slower_side"] = fed / alone[slower]
    log("  bench.py's step fed by the pipeline: %.1f images/s (%.2f ms a "
        "step; rounds %s); resident batch %.1f images/s (%.2f ms; rounds "
        "%s); the pipeline alone %.1f images/s; fed / slower side alone "
        "(%s) %.3f [%s, host cores %d]" % (
            fed, ov["fed"]["step_ms"],
            fmt(ov["fed"]["rounds_images_per_s"], "%.1f"),
            ov["resident"]["images_per_s"], ov["resident"]["step_ms"],
            fmt(ov["resident"]["rounds_images_per_s"], "%.1f"),
            pipe["uint8"]["images_per_s"], slower,
            ov["fed_over_slower_side"], card, os.cpu_count()))
    log_profile("one fed bf16 step", ov["profile_fed_step"], card)
    if not ov["finite"]:
        failures.append("bench.py's step fed by the pipeline: losses %s"
                        % ov["losses"])
    if failures:
        raise AssertionError("imagenet: " + "; ".join(failures))
    return out


def kv_phase(torch, kv, device, seed):
    """K9 and K10 against their plain versions at decode shapes: every
    dtype, positions 0 and T-1, windows straddling the end, out-of-range
    positions, counts 0..K; the whole cache bit-identical to the plain
    version's and, outside the written rows, to its input.  Times beside
    the one-hot blend the kernels replace, one index_put_ and the bound."""
    gen = torch.Generator(device="cpu").manual_seed(seed + 11)
    d, K = DECODER["d"], KV_WINDOW
    rows_out = []
    for n in KV_SLOTS:
        for T in KV_T:
            for dname in ("float32", "float16", "bfloat16"):
                dt = getattr(torch, dname)
                es = torch.tensor([], dtype=dt).element_size()
                cache = torch.randn(n, T, d, generator=gen).to(dt)
                row = torch.randn(n, d, generator=gen).to(dt)
                rows = torch.randn(n, K, d, generator=gen).to(dt)
                edges = [0, T - 1, T - 2, T - K + 1, T + 7, -3]
                pos = torch.tensor([edges[i] if i < len(edges) else
                                    int(torch.randint(0, T, (1,),
                                                      generator=gen))
                                    for i in range(n)], dtype=torch.float32)
                count = torch.tensor([i % (K + 1) for i in range(n)],
                                     dtype=torch.float32)
                # which rows each write may touch, computed on the host
                p_row = pos.long().clamp(0, T - 1)
                w_row = torch.zeros(n, T, dtype=torch.bool)
                w_row[torch.arange(n), p_row] = True
                w_rows = torch.zeros(n, T, dtype=torch.bool)
                acc = []
                for i in range(n):
                    for j in range(int(count[i])):
                        if 0 <= int(pos[i]) + j < T:
                            w_rows[i, int(pos[i]) + j] = True
                            acc.append((i, j, int(pos[i]) + j))
                cache, row, rows = (t.to(device) for t in (cache, row, rows))
                pos, count = pos.to(device), count.to(device)
                for name, kern, plain, args, written in (
                        ("cache_write_row", kv.cache_write_row,
                         kv.cache_write_row_plain, (row, pos), w_row),
                        ("cache_write_rows", kv.cache_write_rows,
                         kv.cache_write_rows_plain, (rows, pos, count),
                         w_rows)):
                    got = kern(cache.clone(), *args)
                    want = plain(cache.clone(), *args)
                    again = kern(cache.clone(), *args)
                    torch.cuda.synchronize()
                    written = written.to(device)
                    if not (torch.equal(got, want) and torch.equal(got, again)
                            and torch.equal(got[~written],
                                            cache[~written])):
                        raise AssertionError(
                            "%s slots %d T %d %s: the cache differs from "
                            "the plain version's or outside its rows"
                            % (name, n, T, dname))
                    ar = torch.arange(n, device=device)
                    if name == "cache_write_row":
                        moved = 2 * n * d * es + 4 * n
                        ii, pp = ar, pos.long().clamp(0, T - 1)
                        vals = row
                        oh = (p_row.to(device)[:, None] == torch.arange(
                            T, device=device)).to(dt)[..., None]
                        src = row[:, None, :]
                    else:
                        moved = 2 * len(acc) * d * es + 8 * n
                        ii = torch.tensor([a[0] for a in acc],
                                          device=device, dtype=torch.long)
                        jj = torch.tensor([a[1] for a in acc],
                                          device=device, dtype=torch.long)
                        pp = torch.tensor([a[2] for a in acc],
                                          device=device, dtype=torch.long)
                        vals = rows[ii, jj]
                        oh = None
                    buf = cache.clone()
                    if oh is not None:
                        # the graph's blend: one_hot, 1 - oh, two products
                        # and the sum, over the whole cache
                        blend = lambda: buf * (1.0 - oh) + src * oh  # noqa
                    else:
                        def blend():
                            c = buf
                            for j in range(K):
                                pj = (pos.long() + j)[:, None]
                                ohj = ((pj == torch.arange(T, device=device))
                                       * (count[:, None] > j)).to(dt)
                                ohj = ohj[..., None]
                                c = c * (1.0 - ohj) \
                                    + rows[:, j:j + 1] * ohj
                            return c
                    r = {"kernel": name, "slots": n, "T": T, "d": d,
                         "dtype": dname, "window": K if oh is None else 1,
                         "bitwise_equal": True, "max_abs_err": 0.0,
                         "ms": time_ms(torch, lambda: kern(buf, *args)),
                         "plain_ms": time_ms(torch,
                                             lambda: plain(buf, *args)),
                         "blend_ms": time_ms(torch, blend),
                         "library_ms": time_ms(
                             torch, lambda: buf.index_put_((ii, pp), vals)),
                         "bytes": moved,
                         "bound_ms": 1e3 * moved / HBM_BYTES_S,
                         "bound_by": "bytes"}
                    rows_out.append(r)
                    log("  %-16s slots %2d T %4d %-8s bitwise  kernel %.4f "
                        "ms  plain %.4f ms  blend %.4f ms  index_put_ %.4f "
                        "ms  bound %.6f ms (bytes)"
                        % (name, n, T, dname, r["ms"], r["plain_ms"],
                           r["blend_ms"], r["library_ms"], r["bound_ms"]))
    return rows_out


def launches_per_step(k, draft_blocks=1):
    """(K9, K10) launches per decode step the graphs imply: K9 writes K and
    V of each of the target's blocks (12 at 6 blocks) and, speculating,
    of each draft block too, at each of the k + 1 window positions; K10
    commits each target and draft cache once per speculative step."""
    caches = 2 * DECODER["layers"]
    if not k:
        return caches, 0
    caches += 2 * draft_blocks
    return caches * (k + 1), caches


def decode_jobs(seed):
    """decode_bench.make_jobs's recipe (1-token prompts, geometric output
    lengths of mean 16, capped into the slot), with DECODE_PROMPTED of the
    requests given 4-16-token prompts so that teacher forcing runs."""
    import numpy as np
    rng = np.random.default_rng(seed + 1)
    cap, vocab = DECODER["max_len"] - 1, DECODER["vocab"]
    jobs = []
    for _ in range(DECODE_REQUESTS):
        n = int(min(cap, rng.geometric(1.0 / DECODE_MEAN_NEW)))
        jobs.append(([int(rng.integers(vocab))], max(1, n)))
    for i in rng.choice(DECODE_REQUESTS, DECODE_PROMPTED, replace=False):
        extra = rng.integers(vocab, size=int(rng.integers(3, 16)))
        jobs[i] = (jobs[i][0] + [int(t) for t in extra], jobs[i][1])
    return jobs


def decode_run(mt, target, t_info, draft, d_info, params, jobs, k,
               wrappers, **engine_kw):
    """Serve ``jobs`` through a warm DecodeEngine on cuda:0 at spec width
    ``k`` (``engine_kw``: further DecodeEngine arguments, a sampler);
    every launch counter is set to 0 after the warmup and read at the
    end.  Returns (token lists, finish reasons, stats, wall seconds,
    launches, the served step graph)."""
    eng = mt.serving.DecodeEngine(
        target, params, {}, t_info, num_slots=DECODE_SLOTS,
        max_len=DECODER["max_len"], ctx=mt.gpu(0), default_deadline_ms=0,
        draft_sym=draft if k else None, draft_arg_params=params,
        draft_state_info=d_info, spec_k=k, **engine_kw)
    try:
        eng.warmup()
        for w in wrappers:
            w.launches = 0
        t0 = time.perf_counter()
        futs = [eng.submit(p, max_new_tokens=n) for p, n in jobs]
        res = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        launches = {w.__name__: w.launches for w in wrappers}
        st = eng.stats()["decode"]
        served = eng.served_sym
    finally:
        eng.close()
    return ([list(r.tokens) for r in res], [r.finish_reason for r in res],
            st, wall, launches, served)


def decode_phase(torch, mt, fu, nn, kv, seed, card):
    """The attention decoder served by DecodeEngine on cuda:0 at k = 0, 2
    and 4 with the 1-block draft, and at k = 4 with the target as its own
    draft (every proposal accepted, so K10 commits whole windows); each
    stream held against greedy_decode through the kernels, the engine with
    the plain scatter, the engine with selection off and the other runs;
    launch counts held against the graphs; timed and one step profiled."""
    target, t_info, draft, d_info, np_params = build_spec_models(
        mt, seed=seed, **DECODER)
    params = mt.convert.params_from_numpy(np_params, {},
                                          device=mt.gpu(0))[0]
    jobs = decode_jobs(seed)
    wrappers = kernel_wrappers(fu, nn, kv)
    # name -> (k, draft graph, its state info, its blocks)
    plan = {"k=%d" % k: (k, draft, d_info, 1) for k in (0,) + SPEC_KS}
    k_max = max(SPEC_KS)
    plan["k=%d, self-draft" % k_max] = (k_max, target, t_info,
                                        DECODER["layers"])
    runs = {name: decode_run(mt, target, t_info, dr, di, params, jobs, k,
                             wrappers)
            for name, (k, dr, di, _b) in plan.items()}
    streams, reasons, _st, _w, _l, served = runs["k=0"]
    ops = [line.strip() for line in served.tojson().splitlines()
           if '"op"' in line]
    n_k9 = sum('"_cache_write_row"' in o for o in ops)
    if n_k9 != launches_per_step(0)[0] or any('"one_hot"' in o for o in ops):
        raise AssertionError("the served step graph holds %d "
                             "_cache_write_row (want %d) or a one_hot"
                             % (n_k9, launches_per_step(0)[0]))
    # the references: greedy_decode through the kernels, the engine with
    # the plain scatter and with selection off
    prog = mt.serving.StepProgram(served, params, {}, t_info, DECODE_SLOTS,
                                  ctx=mt.gpu(0))
    # the engine caps max_new_tokens at max_len - len(prompt)
    want_len = [min(n, DECODER["max_len"] - len(p)) for p, n in jobs]
    greedy = [list(mt.serving.greedy_decode(prog, p, n))
              for (p, _n), n in zip(jobs, want_len)]
    checks = {"greedy_decode": greedy}
    other_runs = {}
    for k in (0, k_max):
        with replaced(kv, "cache_write_row", kv.cache_write_row_plain), \
                replaced(kv, "cache_write_rows", kv.cache_write_rows_plain):
            other_runs["plain scatter, k=%d" % k] = decode_run(
                mt, target, t_info, draft, d_info, params, jobs, k,
                wrappers)
        os.environ["MXNET_OPT_SELECT_KERNELS"] = "0"
        try:
            other_runs["selection off, k=%d" % k] = decode_run(
                mt, target, t_info, draft, d_info, params, jobs, k,
                wrappers)
        finally:
            os.environ.pop("MXNET_OPT_SELECT_KERNELS")
    for name, run in other_runs.items():
        checks[name] = run[0]
    for name in plan:
        if name != "k=0":
            checks["engine, %s" % name] = runs[name][0]
    if [len(s) for s in streams] != want_len \
            or set(reasons) != {"length"} \
            or not all(0 <= t < DECODER["vocab"] for s in streams for t in s):
        raise AssertionError("decode k=0: lengths %s, reasons %s"
                             % ([len(s) for s in streams], set(reasons)))
    for name, other in checks.items():
        if other != streams:
            bad = [i for i, (a, b) in enumerate(zip(other, streams))
                   if a != b]
            raise AssertionError("decode: %d streams of %s differ from the "
                                 "k=0 engine's, first request %d"
                                 % (len(bad), name, bad[0]))
    out = {"jobs": len(jobs), "prompted": DECODE_PROMPTED,
           "tokens": sum(want_len), "checks": sorted(checks), "runs": {},
           "streams": [[int(t) for t in s] for s in streams]}
    for name, (k, _dr, _di, blocks) in plan.items():
        _s, _r, st, wall, launches, _sv = runs[name]
        steps = st["steps"]
        for kname, per in zip(("cache_write_row", "cache_write_rows"),
                              launches_per_step(k, blocks)):
            if launches[kname] != per * steps:
                raise AssertionError("%s: %s launched %d times in %d steps, "
                                     "not %d per step"
                                     % (name, kname, launches[kname], steps,
                                        per))
        others = {n: c for n, c in launches.items()
                  if n not in ("cache_write_row", "cache_write_rows") and c}
        if others:
            raise AssertionError("decode launched %s" % others)
        spec = st["spec"]
        ana, opt = st["analysis"], st["optimizer"]
        verdicts = (ana["step_verdict"], ana["draft_verdict"])
        if verdicts != ("row-local", "row-local" if k else None):
            raise AssertionError("%s: step and draft verdicts %s"
                                 % (name, verdicts))
        if not (opt["accepted"] and opt["selection"]
                and "verdict gate" in opt["gate"]) \
                or (k and not (spec["commit_accepted"]
                               and spec["commit_selection"])):
            raise AssertionError("%s: the selection was not adopted "
                                 "through the verdict gate: %s %s"
                                 % (name, opt, spec))
        out["runs"][name] = {
            "k": k, "steps": steps, "wall_s": wall,
            "tokens_per_s": st["tokens_generated"] / wall,
            "step_ms_p50": st["step_ms"]["p50"],
            "step_ms_p99": st["step_ms"]["p99"],
            "accept_rate": spec.get("accept_rate"),
            "tokens_per_step": spec.get("tokens_per_step"),
            "launches": launches,
            "analysis": {"step_verdict": verdicts[0],
                         "draft_verdict": verdicts[1],
                         "rewrites": opt["rewrites"],
                         "selection": len(opt["selection"]),
                         "commit_selection": len(spec.get(
                             "commit_selection") or [])}}
        log("  %s: %d requests, %d tokens in %d steps, %.3f s: %.1f "
            "tokens/s, step p50 %.3f ms p99 %.3f ms, accept rate %s, tokens "
            "per slot-step %s; K9 %d (%d/step), K10 %d; verdicts %s, %d "
            "rewrites through the verdict gate [%s]"
            % (name, len(jobs), st["tokens_generated"], steps, wall,
               out["runs"][name]["tokens_per_s"], st["step_ms"]["p50"],
               st["step_ms"]["p99"], fmt_opt(spec.get("accept_rate")),
               fmt_opt(spec.get("tokens_per_step")),
               launches["cache_write_row"], launches_per_step(k, blocks)[0],
               launches["cache_write_rows"], verdicts, opt["rewrites"],
               card))
    out["reference_runs"] = {}
    for name, (_s, _r, st, wall, _l, _sv) in other_runs.items():
        out["reference_runs"][name] = {
            "steps": st["steps"], "wall_s": wall,
            "tokens_per_s": st["tokens_generated"] / wall,
            "step_ms_p50": st["step_ms"]["p50"],
            "step_ms_p99": st["step_ms"]["p99"]}
        log("  reference run, %s: %.1f tokens/s, step p50 %.3f ms p99 %.3f "
            "ms [%s]" % (name, st["tokens_generated"] / wall,
                         st["step_ms"]["p50"], st["step_ms"]["p99"], card))
    if out["runs"]["k=%d, self-draft" % k_max]["accept_rate"] != 1.0:
        raise AssertionError("the target as its own draft did not accept "
                             "every proposal")
    log("  every stream equals the k=0 engine's: %s"
        % "; ".join(sorted(checks)))
    out["profile"] = {}
    for k in (0, k_max):
        out["profile"]["k=%d" % k] = profile_decode_step(
            torch, mt, target, t_info, draft, d_info, params, k)
        prof = out["profile"]["k=%d" % k]
        log_profile("one decode step, k=%d, 8 live slots" % k, prof, card)
        if k:
            log("  its working copies of the caches: %.1f MB, %.4f ms [%s]"
                % (prof["working_copies_bytes"] / 1e6,
                   prof["working_copies_ms"], card))
    return out


def profile_decode_step(torch, mt, target, t_info, draft, d_info, params, k):
    """One engine step on the card as the scheduler runs it (the served
    graph, 8 live slots at positions 40..47, host vectors in, ids out),
    profiled over a few repetitions."""
    import numpy as np
    eng = mt.serving.DecodeEngine(
        target, params, {}, t_info, num_slots=DECODE_SLOTS,
        max_len=DECODER["max_len"], ctx=mt.gpu(0), start=False,
        draft_sym=draft if k else None, draft_arg_params=params,
        draft_state_info=d_info, spec_k=k)
    prog = eng.program
    state = {"s": prog.init_states()}
    n = DECODE_SLOTS
    tok = np.arange(n, dtype=np.float32) * 7
    pos = 40.0 + np.arange(n, dtype=np.float32)
    ones = np.ones(n, np.float32)

    def step():
        if k:
            _t, _c, state["s"] = prog.step_spec(tok, pos, ones, ones,
                                                state["s"])
        else:
            _t, state["s"] = prog.step(tok, pos, ones, state["s"])
    prof = profile_calls(torch, step, 5)
    if k:
        # the speculative chains' working copies of the caches, one per
        # cache per step (serving/decode.py step_spec)
        caches = list(state["s"].values())
        prof["working_copies_ms"] = time_ms(
            torch, lambda: [c.clone() for c in caches])
        prof["working_copies_bytes"] = sum(c.numel() * c.element_size()
                                           for c in caches)
    eng.close()
    return prof


def _unit_inputs(rng, n, side, c):
    """Seeded inputs of one fused unit in the op's order: NHWC data, the
    nine parameters (He-scaled weights) and the six moving statistics."""
    cq = c // 4

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype("float32")

    def pos(k):
        return rng.uniform(0.5, 1.5, k).astype("float32")
    return [r(n, side, side, c), pos(c), r(c, scale=0.1),
            r(cq, 1, 1, c, scale=(2.0 / c) ** 0.5), pos(cq),
            r(cq, scale=0.1), r(cq, 3, 3, cq, scale=(2.0 / (9 * cq)) ** 0.5),
            pos(cq), r(cq, scale=0.1), r(c, 1, 1, cq, scale=(2.0 / cq) ** 0.5),
            r(c, scale=0.1), pos(c), r(cq, scale=0.1), pos(cq),
            r(cq, scale=0.1), pos(cq)]


def imperative_phase(torch, mt, fu, nn, kv, seed, card):
    """The fused unit at the four ResNet-50 stage shapes at batch 32
    through the imperative frontend in 4d mode: ``mt.nd.
    _contrib_FusedBottleneckUnit`` under ``autograd.record()``, then
    ``backward()``.  Launches counted; output and the ten gradients held
    bit for bit against the same unit bound as a symbol through
    ``Executor.backward`` (the same kernels in the same order)."""
    import numpy as np
    wrappers = kernel_wrappers(fu, nn, kv)
    rng = np.random.default_rng(seed + 13)
    cases = [(c, _unit_inputs(rng, TRAIN_BATCH, side, c))
             for (_hw, c, _u), side in zip(STAGES, STAGE_HW)]
    results = []
    with c3_mode("4d"), mt.gpu(0):
        staged = [(c, [mt.nd.array(a) for a in ins]) for c, ins in cases]
        torch.cuda.synchronize()
        for k in wrappers:
            k.launches = 0
        t0 = time.perf_counter()
        for c, arrs in staged:
            for a in arrs[:10]:
                a.attach_grad()
            with mt.autograd.record():
                out = mt.nd._contrib_FusedBottleneckUnit(
                    *arrs, num_filter=c, layout="NHWC")
            out.backward()
            results.append((out, arrs))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in wrappers}
        # the same units bound as symbols
        rows = []
        for (c, ins), (out, arrs), side in zip(cases, results, STAGE_HW):
            sym = mt.sym._contrib_FusedBottleneckUnit(
                mt.sym.Variable("data"), num_filter=c, layout="NHWC",
                name="unit")
            names = sym.list_arguments()
            ex = sym.bind(mt.gpu(0), {n: mt.nd.array(a)
                                      for n, a in zip(names, ins)},
                          aux_states={n: mt.nd.array(a) for n, a in zip(
                              sym.list_auxiliary_states(), ins[10:])})
            ex_out = ex.forward(is_train=True)[0]
            ex.backward()
            torch.cuda.synchronize()
            pairs = [("output", out, ex_out)] + [
                (n, a.grad, ex.grad_dict[n]) for n, a in zip(names, arrs)]
            differ = [n for n, p, q in pairs
                      if not torch.equal(p._data, q._data)]
            finite = all(bool(torch.isfinite(p._data).all())
                         for _n, p, _q in pairs)
            rows.append({"stage": len(rows) + 1, "c": c, "side": side,
                         "differ": differ, "finite": finite})
            log("  stage %d (%d x %d x %d x %d): output and %d gradients "
                "%s the Executor's" % (len(rows), TRAIN_BATCH, side, side, c,
                                       len(pairs) - 1,
                                       "bit-equal to" if not differ else
                                       "DIFFER from"))
            del ex, ex_out
    log("  4 units forward and backward in %.3f s of host wall; launches %s "
        "[%s]" % (wall, launches, card))
    _launch_check("imperative, 4d", launches, UNIT_LAUNCHES, len(cases))
    bad = [r for r in rows if r["differ"] or not r["finite"]]
    if bad:
        raise AssertionError("the imperative unit differs from the "
                             "Executor's: %s" % bad)
    c, arrs = staged[0]

    def unit_step():
        with mt.autograd.record():
            out = mt.nd._contrib_FusedBottleneckUnit(
                *arrs, num_filter=c, layout="NHWC")
        out.backward()
    with c3_mode("4d"):
        prof = profile_calls(torch, unit_step, 3)
    log_profile("one imperative stage-1 unit, forward and backward", prof,
                card)
    return {"units": len(cases), "batch": TRAIN_BATCH, "launches": launches,
            "wall_s": wall, "stages": rows, "profile_stage1_unit": prof}


def rtc_phase(torch, mt, fu, nn, kv, seed, card):
    """K11: CUDA C++ written at run time (RTC_SOURCE), compiled by
    ``rtc.CudaModule`` and installed by ``rtc.register_kernel_op``.
    ``add_one`` over 16M float32 through ``mt.nd``, a bound symbol and
    ``mt.nd`` from a second thread, each bit-equal to ``x + 1``; the swish
    pair (``vjp=``) through ``Executor.backward`` against torch autograd
    on the formula.  Launches counted; timed beside ``x + 1`` and the
    bound."""
    import numpy as np
    wrappers = kernel_wrappers(fu, nn, kv)
    t0 = time.perf_counter()
    module = mt.rtc.CudaModule(RTC_SOURCE,
                               exports=("add_one", "swish_fwd", "swish_bwd"))
    compile_s = time.perf_counter() - t0
    k_add = module.get_kernel("add_one", "const float *x, float *y, int n")
    k_fwd = module.get_kernel(
        "swish_fwd", "const float *x, float *y, float *s, float beta, int n")
    k_bwd = module.get_kernel(
        "swish_bwd", "const float *x, const float *s, const float *g, "
        "float *dx, float beta, int n")

    def dims(n):
        return ((n + 255) // 256,), (256,)

    def on_card(t):
        return t.device.type == "cuda"

    def add_one(x):
        if not on_card(x):          # shape inference (meta), or the CPU
            return x + 1.0
        y = torch.empty_like(x)
        k_add.launch([x, y, x.numel()], mt.Context.of(x.device),
                     *dims(x.numel()))
        return y

    def swish_fwd(x, beta=1.0):
        if not on_card(x):
            s = torch.sigmoid(beta * x)
            return x * s, (x, s)
        x = x.contiguous()
        y, s = torch.empty_like(x), torch.empty_like(x)
        k_fwd.launch([x, y, s, beta, x.numel()], mt.Context.of(x.device),
                     *dims(x.numel()))
        return y, (x, s)

    def swish_bwd(res, g, beta=1.0):
        x, s = res
        g = g.contiguous()
        dx = torch.empty_like(x)
        k_bwd.launch([x, s, g, dx, beta, x.numel()], mt.Context.of(x.device),
                     *dims(x.numel()))
        return (dx,)

    mt.rtc.register_kernel_op("rtc_add_one", add_one)
    mt.rtc.register_kernel_op(
        "rtc_swish", lambda x, beta=1.0: swish_fwd(x, beta)[0],
        vjp=(swish_fwd, swish_bwd), params={"beta": mt.ops.P(float, 1.0)})
    rng = np.random.default_rng(seed + 17)
    x_np = rng.standard_normal(RTC_N).astype(np.float32)
    xs_np = rng.standard_normal(RTC_SWISH_SHAPE).astype(np.float32)
    g_np = rng.standard_normal(RTC_SWISH_SHAPE).astype(np.float32)
    beta = 1.5
    with mt.gpu(0):
        x = mt.nd.array(x_np)
        xs, g = mt.nd.array(xs_np), mt.nd.array(g_np)
        torch.cuda.synchronize()
        # the main path, counted
        for k in wrappers:
            k.launches = 0
        y_nd = mt.nd.rtc_add_one(x)
        ex = mt.sym.rtc_add_one(mt.sym.Variable("data")).bind(
            mt.gpu(0), {"data": x})
        y_sym = ex.forward()[0]
        other = {}

        def second_thread():
            other["y"] = mt.nd.rtc_add_one(x)
            torch.cuda.synchronize()
        th = threading.Thread(target=second_thread)
        th.start()
        th.join(timeout=300)
        assert not th.is_alive()
        sex = mt.sym.rtc_swish(mt.sym.Variable("data"), beta=beta).bind(
            mt.gpu(0), {"data": xs})
        s_out = sex.forward(is_train=True)[0]
        sex.backward(out_grads=[g])
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in wrappers}
    want = x._data + 1.0
    equal = {"nd": torch.equal(y_nd._data, want),
             "symbol": torch.equal(y_sym._data, want),
             "second thread": "y" in other
             and torch.equal(other["y"]._data, want)}
    max_abs_err = max(float((y._data - want).abs().max())
                      for y in (y_nd, y_sym, other.get("y", y_nd)))
    xt = xs._data.detach().clone().requires_grad_(True)
    ref = xt * torch.sigmoid(beta * xt)
    ref.backward(g._data)
    swish_err = rel_err(s_out._data, ref.detach())
    swish_grad_err = rel_err(sex.grad_dict["data"]._data, xt.grad)
    log("  CudaModule compiled 3 kernels in %.2f s; add_one bit-equal to x "
        "+ 1: %s; swish forward rel err %.2e, gradient rel err %.2e; "
        "launches %s" % (compile_s, equal, swish_err, swish_grad_err,
                         launches["CudaKernel"]))
    _launch_check("rtc", launches, {"CudaKernel": 5}, 1)
    if not all(equal.values()):
        raise AssertionError("add_one differs from x + 1: %s" % equal)
    if swish_grad_err > RTC_SWISH_RTOL or swish_err > RTC_SWISH_RTOL:
        raise AssertionError("swish through the runtime kernels: forward "
                             "%.3g, gradient %.3g over %.3g" % (
                                 swish_err, swish_grad_err, RTC_SWISH_RTOL))
    prof = profile_calls(torch, lambda: mt.nd.rtc_add_one(x), 5)
    log_profile("one mt.nd.rtc_add_one over 16M float32", prof, card)
    buf = torch.empty_like(x._data)
    n = RTC_N
    ms = time_ms(torch, lambda: k_add.launch(
        [x._data, buf, n], mt.gpu(0), *dims(n)))
    plain_ms = time_ms(torch, lambda: x._data + 1.0)
    library_ms = time_ms(torch, lambda: torch.add(x._data, 1.0))
    nbytes = 2 * 4 * n
    row = {"n": n, "compile_s": compile_s, "bitwise_equal": equal,
           "swish_rel_err": swish_err, "swish_grad_rel_err": swish_grad_err,
           "launches": launches, "max_abs_err": max_abs_err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "bytes": nbytes,
           "bound_ms": 1e3 * nbytes / HBM_BYTES_S, "bound_by": "bytes",
           "profile_nd_call": prof}
    log("  add_one over %d float32: kernel %.4f ms  plain %.4f ms  x + 1 "
        "%.4f ms  bound %.4f ms (bytes) [%s]" % (
            n, ms, plain_ms, library_ms, row["bound_ms"], card))
    return row


def mnist_data():
    """examples/train_mnist.py's synthetic stand-in (2000 images of 28x28
    from 10 prototypes, noise 0.25, ``default_rng(0)``), made as the
    example makes it: (train x, train y, validation x, validation y)."""
    import numpy as np
    rng = np.random.default_rng(0)
    protos = [np.kron(rng.random((7, 7)).astype(np.float32),
                      np.ones((4, 4), np.float32)) for _ in range(10)]
    x, y = [], []
    for k, pr in enumerate(protos):
        for _ in range(200):
            x.append(np.clip(pr + rng.normal(0, 0.25, (28, 28)), 0, 1))
            y.append(k)
    x = np.stack(x)[:, None].astype(np.float32) - 0.5
    y = np.asarray(y, np.float32)
    order = rng.permutation(len(y))
    x, y = x[order], y[order]
    n = int(len(y) * 0.9)
    return x[:n], y[:n], x[n:], y[n:]


def mnist_fit(mt, module, train, val, callbacks):
    """``examples/common.py``'s ``fit`` with train_mnist.py's defaults
    (--optimizer sgd, --num-epochs 5, --lr 0.05, --momentum 0.9, --wd
    1e-4, --batch-size 64, Xavier, kvstore local, a Speedometer every 20
    batches; no checkpoint prefix) and ``callbacks`` after the
    Speedometer."""
    module.fit(train, eval_data=val, num_epoch=MNIST_EPOCHS,
               kvstore="local", optimizer="sgd",
               optimizer_params={"learning_rate": MNIST_LR, "momentum": 0.9,
                                 "wd": 1e-4},
               initializer=mt.init.Xavier(),
               batch_end_callback=[mt.callback.Speedometer(MNIST_BATCH, 20)]
               + list(callbacks))


def lenet_weights(sym, seed):
    """Xavier (uniform, avg, magnitude 3) weights and zero biases for
    LeNet at batch MNIST_BATCH, drawn on the host from ``seed``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    shapes, _, _ = sym.infer_shape(data=(MNIST_BATCH, 1, 28, 28))
    args = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name.endswith("_weight"):
            fan = (shape[0] + shape[1]) * np.prod(shape[2:]) / 2.0
            lim = np.sqrt(3.0 / fan)
            args[name] = rng.uniform(-lim, lim, shape).astype(np.float32)
        elif name.endswith("_bias"):
            args[name] = np.zeros(shape, np.float32)
    return args


def batch_loss(mod, batch):
    """The mean cross-entropy of the module's softmax on ``batch``, in f64
    on the host (probabilities floored at 1e-30, so a diverging run's
    loss stays finite)."""
    import numpy as np
    probs = mod.get_outputs()[0].asnumpy().astype(np.float64)
    labels = batch.label[0].asnumpy().astype(np.int64)
    return float(-np.log(np.maximum(probs[np.arange(len(labels)), labels],
                                    1e-30)).mean())


def opt_run(torch, mt, sym, name, args, x, y, ctx, f64=False, epochs=1,
            module=None, begin_epoch=0, **fit_kwargs):
    """Optimizer ``name`` (MNIST_OPTIMIZERS) through ``Module.fit`` on
    ``ctx`` from the host weights ``args`` (None: the module's own, as
    ``Module.load`` gives them), over (x, y) in order at batch
    MNIST_BATCH for ``epochs`` epochs from ``begin_epoch``: (each step's
    loss, the parameters after step 1 as f64 numpy, the module).  ``f64``
    widens the executor's arrays to float64 first (the control run)."""
    import numpy as np
    losses, first = [], {}

    def on_batch(param):
        losses.append(batch_loss(mod, param.locals["batch"]))
        if not first:
            first.update((k, mod._exec.arg_dict[k].asnumpy().astype(
                np.float64)) for k in mod._param_names)
    mod = module or mt.mod.Module(sym, context=ctx)
    train = mt.io.NDArrayIter(x, y, MNIST_BATCH,
                              label_name="softmax_label")
    if f64:
        mod.bind(train.provide_data, train.provide_label)
        mod.init_params(arg_params={k: mt.nd.array(v, ctx=ctx)
                                    for k, v in args.items()})
        ex = mod._exec
        for d in (ex.arg_dict, ex.grad_dict, ex.aux_dict):
            for v in d.values():
                v._data = v._data.double()
    kind, _, variant = name.partition("-")
    params = dict(MNIST_OPTIMIZERS[name], wd=1e-4)
    mod.fit(train, num_epoch=begin_epoch + epochs, begin_epoch=begin_epoch,
            kvstore="local", optimizer=kind, optimizer_params=params,
            arg_params=None if args is None else {
                k: mt.nd.array(v, ctx=ctx) for k, v in args.items()},
            batch_end_callback=on_batch, **fit_kwargs)
    return losses, first, mod


def opt_reading(card, cpu):
    """One optimizer's card run against its CPU run (or the CPU run
    against its f64 control): the largest loss difference over the steps
    relative to the first step's loss (the losses fall to 1e-5), the worst
    parameter's largest difference after step 1 over its largest
    magnitude, the share of parameter elements after step 1
    within MNIST_AGREE of their parameter's largest magnitude, and whether
    the loss fell (the last MNIST_WINDOW steps' mean under the first's)."""
    import numpy as np
    (cl, cp), (rl, rp) = card, cpu
    loss_err = max(abs(a - b) for a, b in zip(cl, rl)) / abs(rl[0])
    param_err, agree, total = 0.0, 0, 0
    for k, ref in rp.items():
        scale = float(np.abs(ref).max()) or 1.0
        diff = np.abs(cp[k] - ref) / scale
        param_err = max(param_err, float(diff.max()))
        agree += int((diff <= MNIST_AGREE).sum())
        total += diff.size
    w = MNIST_WINDOW
    return {"loss_rel_err": loss_err, "param_rel_err": param_err,
            "agree_share": agree / total,
            "falls": float(np.mean(cl[-w:])) < float(np.mean(cl[:w]))}


def adam_without_bias_correction(self, index, weight, grad, state):
    """A planted fault: Adam's update at the bare rate."""
    self._update_count(index)
    mean, var = state
    from mxnet_tpu_torch.ndarray import adam_update
    adam_update(weight, grad, mean, var, out=weight, beta1=self.beta1,
                beta2=self.beta2, epsilon=self.epsilon,
                **self._common_attrs(index))


def nag_as_plain_momentum(self, index, weight, grad, state):
    """A planted fault: NAG's step without the look-ahead, mom = momentum
    * mom + g; w -= lr * mom."""
    import torch
    self._update_count(index)
    lr, wd = self._get_lr(index), self._get_wd(index)
    with torch.no_grad():
        w = weight._data
        g = grad._data * self.rescale_grad + wd * w
        state._data.mul_(self.momentum).add_(g)
        w.add_(-lr * state._data)


def same_sgld_noise(torch, mt, seed):
    """Inside the block SGLD draws its noise on the host from one
    generator seeded with ``seed`` and moves it to the weight's device,
    so a card run and a CPU run add the same noise."""
    gen = torch.Generator().manual_seed(seed)

    def noise(self, weight, lr):
        return torch.empty(weight.shape, dtype=torch.float32).normal_(
            0.0, lr ** 0.5, generator=gen).to(weight._data)
    return replaced(mt.optimizer.SGLD, "_noise", noise)


def opt_limits(control):
    """The card-against-CPU limits of one optimizer from its control (the
    CPU run against the same run in f64): MNIST_CONTROL_FACTOR times each
    reading, floored at MNIST_LOSS_FLOOR and MNIST_PARAM_FLOOR, and at
    most MNIST_AGREE_FLOOR of the elements off where the control had
    none."""
    f = MNIST_CONTROL_FACTOR
    return {"loss_rel_err": max(f * control["loss_rel_err"],
                                MNIST_LOSS_FLOOR),
            "param_rel_err": max(f * control["param_rel_err"],
                                 MNIST_PARAM_FLOOR),
            "agree_share": 1.0 - max(f * (1.0 - control["agree_share"]),
                                     MNIST_AGREE_FLOOR)}


def opt_failures(name, reading, limits):
    """What of ``reading`` (card against CPU) is outside ``limits``: the
    losses always; the step-1 parameters elementwise, or for the sign
    optimizers by the share of elements that agree; the loss must fall
    except for Test."""
    bad = []
    if reading["loss_rel_err"] > limits["loss_rel_err"]:
        bad.append("loss")
    if name in MNIST_SIGN_OPTIMIZERS:
        if reading["agree_share"] < limits["agree_share"]:
            bad.append("agree_share")
    elif reading["param_rel_err"] > limits["param_rel_err"]:
        bad.append("param")
    if name != "test" and not reading["falls"]:
        bad.append("falls")
    return bad


def mnist_phase(torch, mt, fu, nn, kv, seed, card):
    """examples/train_mnist.py's path on cuda:0: the example's run, every
    optimizer on the card against the port on the CPU (beside its f64
    control, with two planted faults), a checkpoint with optimizer states
    resumed bit for bit, and a Monitor's stats against the CPU's."""
    import numpy as np
    dev = mt.gpu(0)
    x, y, vx, vy = mnist_data()
    sym = mt.models.get_lenet()
    out = {"batch": MNIST_BATCH, "epochs": MNIST_EPOCHS,
           "train_images": len(y), "val_images": len(vy)}
    failures = []

    # the example's run: LeNet, SGD, 5 epochs, its iterators
    mt.random.seed(seed)
    train = mt.io.NDArrayIter(x, y, MNIST_BATCH, shuffle=True,
                              label_name="softmax_label")
    val = mt.io.NDArrayIter(vx, vy, MNIST_BATCH, label_name="softmax_label")
    steps = []

    def on_batch(param):
        steps.append((param.epoch, param.nbatch, time.perf_counter(),
                      dict(param.eval_metric.get_name_value())["accuracy"]))
    mod = mt.mod.Module(sym, context=dev)
    wrappers = kernel_wrappers(fu, nn, kv)
    for k in wrappers:
        k.launches = 0
    t0 = time.perf_counter()
    mnist_fit(mt, mod, train, val, [on_batch])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    acc = mt.metric.Accuracy()
    val.reset()
    mod.score(val, acc)
    val_acc = float(acc.get()[1])
    epoch_acc = [float([s[3] for s in steps if s[0] == e][-1])
                 for e in range(MNIST_EPOCHS)]
    intervals = [1e3 * (b[2] - a[2]) for a, b in zip(steps, steps[1:])
                 if a[0] == b[0]]
    train.reset()
    batch = next(iter(train))
    prof = profile_calls(torch, lambda: (mod.forward_backward(batch),
                                         mod.update()), 5)
    out["example"] = {
        "epoch_train_accuracy": epoch_acc, "val_accuracy": val_acc,
        "jax_val_accuracy": MNIST_JAX_VAL_ACC, "fit_s": fit_s,
        "steps": len(steps), "step_ms_within_epochs": intervals,
        "median_step_ms": _median(intervals), "profile_step": prof,
        "launches": {k.__name__: k.launches for k in wrappers}}
    log("  the example: LeNet on %s, SGD, batch %d, %d epochs of %d steps: "
        "training accuracy by epoch %s, final validation accuracy %.4f "
        "(the JAX package %.4f); median step %.3f ms, fit %.2f s [%s]" % (
            dev, MNIST_BATCH, MNIST_EPOCHS, len(steps) // MNIST_EPOCHS,
            fmt(epoch_acc, "%.4f"), val_acc, MNIST_JAX_VAL_ACC,
            out["example"]["median_step_ms"], fit_s, card))
    log_profile("one LeNet training step, batch %d" % MNIST_BATCH, prof,
                card)
    if abs(val_acc - MNIST_JAX_VAL_ACC) > MNIST_ACC_TOL:
        failures.append("example: validation accuracy %.4f, the JAX "
                        "package's %.4f" % (val_acc, MNIST_JAX_VAL_ACC))
    if any(out["example"]["launches"].values()):
        failures.append("example: hand-written kernels launched %s"
                        % out["example"]["launches"])

    # every optimizer: the card against the CPU, beside the CPU's f64
    # control, from the same host weights over the same batches
    args = lenet_weights(sym, seed)
    n = MNIST_OPT_STEPS * MNIST_BATCH
    ox, oy = x[:n], y[:n]
    out["optimizers"] = {}
    t0 = time.perf_counter()
    for name in MNIST_OPTIMIZERS:
        runs = {}
        for what, ctx, f64 in (("card", dev, False), ("cpu", mt.cpu(), False),
                               ("f64", mt.cpu(), True)):
            with same_sgld_noise(torch, mt, seed):
                losses, first, _ = opt_run(torch, mt, sym, name, args, ox,
                                           oy, ctx, f64=f64)
            runs[what] = (losses, first)
        control = opt_reading(runs["cpu"], runs["f64"])
        limits = opt_limits(control)
        reading = opt_reading(runs["card"], runs["cpu"])
        bad = opt_failures(name, reading, limits)
        out["optimizers"][name] = {"card_vs_cpu": reading,
                                   "control": control, "limits": limits,
                                   "losses": runs["card"][0],
                                   "failing": bad}
        log("  %-16s card against CPU: loss %.2e, step-1 parameters %.2e, "
            "agreeing %.6f (limits %.2e, %.2e, %.6f; f64 control %.2e, "
            "%.2e, %.6f); loss %.4f -> %.4f%s" % (
                name, reading["loss_rel_err"], reading["param_rel_err"],
                reading["agree_share"], limits["loss_rel_err"],
                limits["param_rel_err"], limits["agree_share"],
                control["loss_rel_err"], control["param_rel_err"],
                control["agree_share"], runs["card"][0][0],
                float(np.mean(runs["card"][0][-MNIST_WINDOW:])),
                "" if not bad else "  FAILS %s" % bad))
        if bad:
            failures.append("optimizer %s: %s outside the limits" % (name,
                                                                     bad))
        if name in MNIST_FAULTS:
            cls, fault, what = MNIST_FAULTS[name]
            with replaced(getattr(mt.optimizer, cls), "update",
                          globals()[fault]):
                losses, first, _ = opt_run(torch, mt, sym, name, args, ox,
                                           oy, dev)
            fr = opt_reading((losses, first), runs["cpu"])
            fbad = opt_failures(name, fr, limits)
            out["optimizers"][name]["planted_fault"] = dict(fr,
                                                            failing=fbad)
            log("  %-16s planted fault (%s): loss %.2e, step-1 parameters "
                "%.2e: %s" % (name, what, fr["loss_rel_err"],
                              fr["param_rel_err"],
                              "fails %s" % fbad if fbad else "PASSES"))
            if not fbad:
                failures.append("optimizer %s: the planted fault passed"
                                % name)
    # SGLD's own noise, from the card's generator
    w = mt.nd.zeros((1000, 1000), ctx=dev)
    mt.random.seed(seed)
    draw = mt.optimizer.SGLD()._noise(w, 1e-4)
    out["sgld_noise_std"] = float(draw.std())
    if draw.device != w._data.device or abs(float(draw.std()) / 1e-2 - 1) \
            > 0.01:
        failures.append("SGLD's noise on the card: std %.5f on %s"
                        % (float(draw.std()), draw.device))
    out["optimizers_s"] = time.perf_counter() - t0

    # a checkpoint with optimizer states after epoch 1, resumed in a fresh
    # module, against the run that was not interrupted (cuDNN
    # deterministic: the same bits)
    saved_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            prefix = os.path.join(tmp, "lenet")
            whole, _, wmod = opt_run(torch, mt, sym, "sgd", args, ox, oy,
                                     dev, epochs=2)
            mod1 = mt.mod.Module(sym, context=dev)
            opt_run(torch, mt, sym, "sgd", args, ox, oy, dev, module=mod1,
                    epoch_end_callback=(
                        mt.callback.module_checkpoint(
                            mod1, prefix, save_optimizer_states=True)))
            files = sorted(os.listdir(tmp))
            mod2 = mt.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                      context=dev)
            resumed, _, mod2 = opt_run(torch, mt, sym, "sgd", None, ox, oy,
                                       dev, module=mod2, begin_epoch=1)
    finally:
        torch.backends.cudnn.deterministic = saved_det
    wp, rp = wmod.get_params()[0], mod2.get_params()[0]
    same = (whole[MNIST_OPT_STEPS:] == resumed
            and all(_same_bits(wp[k], rp[k]) for k in wp))
    out["resume"] = {"files": files, "bit_equal": same,
                     "losses_whole": whole[MNIST_OPT_STEPS:],
                     "losses_resumed": resumed}
    log("  resumed from %s after epoch 1 (with optimizer states): epoch 2's "
        "losses and parameters equal the uninterrupted run's bit for bit: "
        "%s" % (files, same))
    if not same or "lenet-0001.states" not in files:
        failures.append("resume: files %s, bit-equal %s" % (files, same))

    # a Monitor for two steps, on the card and on the CPU: the outputs (the
    # softmax's mean |p| is 1/10 whatever the weights), then with
    # monitor_all the arguments too (the weights as each step finds them)
    out["monitor"] = {}
    for monitor_all in (False, True):
        rows = {}
        for what, ctx in (("card", dev), ("cpu", mt.cpu())):
            mon = mt.Monitor(1, pattern=".*", monitor_all=monitor_all)
            rows[what] = seen = []
            mon.toc_print = lambda mon=mon, seen=seen: seen.extend(mon.toc())
            opt_run(torch, mt, sym, "sgd", args, ox[:2 * MNIST_BATCH],
                    oy[:2 * MNIST_BATCH], ctx, monitor=mon)
        names = [r[:2] for r in rows["card"]]
        stat_err = max(abs(float(a[2]) - float(b[2]))
                       / max(abs(float(b[2])), 1e-30)
                       for a, b in zip(rows["card"], rows["cpu"]))
        out["monitor"]["all" if monitor_all else "outputs"] = {
            "rows_card": rows["card"], "rows_cpu": rows["cpu"],
            "stat_rel_err": stat_err}
        log("  Monitor(1, '.*', monitor_all=%s) over 2 steps: %d stats %s; "
            "card against CPU %.2e" % (monitor_all, len(names),
                                       sorted({r[1] for r in rows["card"]}),
                                       stat_err))
        want = 2 * (len(sym.list_arguments()) + 1 if monitor_all else 1)
        if names != [r[:2] for r in rows["cpu"]] or len(names) != want \
                or stat_err > MNIST_MONITOR_RTOL:
            failures.append("monitor: card %s, CPU %s" % (rows["card"],
                                                          rows["cpu"]))
    if failures:
        raise AssertionError("mnist: " + "; ".join(failures))
    return out


# phase 13, Gluon: the model zoo's ResNet-50 v2 (BASELINE.json config 3)
# at its published widths, NCHW, trained through Gluon's Trainer
# imperatively and hybridized from the same weights on the same batches;
# then the fused symbolic ResNet-50 (NHWC, fused units) as a SymbolBlock,
# served and trained through Gluon's CachedOp and autograd
GLUON_FAMILY, GLUON_CLASSES, GLUON_IMAGE = "resnet50_v2", 1000, 224
GLUON_BATCH, GLUON_STEPS = 64, 3
GLUON_SGD = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
# the SymbolBlock's serve and train batches; the launches of each kernel
# in one serve forward per 3x3 mode and in one training step
GLUON_SERVE_BATCH, GLUON_TRAIN_BATCH = 8, 32
GLUON_SERVE_LAUNCHES = {mode: dict.fromkeys(names, 12)
                        for mode, names in SERVE_KERNELS.items()}
GLUON_TRAIN_LAUNCHES = TRAIN_LAUNCHES["2d"]


def fused_resnet_symbol(mt):
    """The fused symbolic ResNet-50 the SymbolBlock wraps, and its input
    side."""
    return mt.models.get_resnet_symbol(num_layers=50, layout="NHWC",
                                       unit_impl="fused"), 224


def gluon_train(torch, mt, net, batches, hybrid, card, profile=False):
    """GLUON_STEPS Trainer steps of the Gluon ``net`` (on cuda:0, weights
    set) over ``batches`` (host arrays) with SoftmaxCrossEntropyLoss:
    per-step loss (mean) and host wall at the step's end, step 1's
    gradients and every BatchNorm's moving statistics after each step (on
    the host), the peak memory, and one profiled step."""
    ctx = mt.gpu(0)
    if hybrid:
        net.hybridize()
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd", dict(GLUON_SGD))
    params = net.collect_params()
    stats_names = [k for k in params.keys()
                   if k.endswith(("running_mean", "running_var"))]
    data = [(mt.nd.array(x, ctx=ctx), mt.nd.array(y, ctx=ctx))
            for x, y in batches]

    def step(xs, ys):
        with mt.autograd.record():
            loss = loss_fn(net(xs), ys)
        loss.backward()
        trainer.step(xs.shape[0])
        return loss
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ends, stats, grads = [], [], [], None
    t0 = time.perf_counter()
    for xs, ys in data:
        loss = step(xs, ys)
        losses.append(float(loss.asnumpy().mean()))
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        if grads is None:
            grads = {k: p.grad()._data.to("cpu", copy=True)
                     for k, p in params.items() if p.grad_req != "null"}
        stats.append({k: params[k].data()._data.to("cpu", copy=True)
                      for k in stats_names})
    peak = torch.cuda.max_memory_allocated()
    prof = profile_calls(torch, lambda: step(*data[0]), 2) if profile \
        else None
    return {"losses": losses, "step_s": [b - a for a, b in
                                         zip([t0] + ends, ends)],
            "grads": grads, "stats": stats, "peak": peak, "profile": prof}


def gluon_module_grads(torch, mt, net, weights, batch):
    """Step 1's gradients again, through the port's Module: the net's
    symbol composed with the loss, bound on the card with the same weights
    and fed the same batch."""
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    sym = loss_fn(net(mt.sym.var("data")), mt.sym.var("label"))
    x, y = batch
    mod = mt.mod.Module(sym, data_names=("data",), label_names=("label",),
                        context=mt.gpu(0))
    mod.bind(data_shapes=[("data", x.shape)], label_shapes=[("label",
                                                             y.shape)])
    full = {net.prefix + k: v for k, v in weights.items()}
    args = set(sym.list_arguments())
    arg_nd, aux_nd = mt.convert.params_from_numpy(
        {k: v for k, v in full.items() if k in args},
        {k: v for k, v in full.items() if k not in args}, device=mt.gpu(0))
    mod.init_params(arg_params=arg_nd, aux_params=aux_nd)
    mod.forward_backward(mt.io.DataBatch(
        [mt.nd.array(x, ctx=mt.gpu(0))], [mt.nd.array(y, ctx=mt.gpu(0))]))
    torch.cuda.synchronize()
    return {k: g._data.to("cpu", copy=True)
            for k, g in mod._exec.grad_dict.items() if k not in ("data",
                                                                 "label")}


def symbol_block_phase(torch, mt, fu, nn, kv, seed, card):
    """The fused symbolic ResNet-50 as a SymbolBlock: a predict-mode
    forward at GLUON_SERVE_BATCH against Predictor in both 3x3 modes, bit
    for bit, and one training step under autograd.record() at
    GLUON_TRAIN_BATCH (MXNET_CONV1X1_FUSED_BWD=1) against the Executor's
    gradients, bit for bit (cuDNN deterministic for the whole block);
    each counted.  A planted fault at K5's launch (its dW zeroed) must
    fail the training check."""
    import numpy as np
    wrappers = kernel_wrappers(fu, nn, kv)
    sym, side = fused_resnet_symbol(mt)
    args, aux = mt.convert.random_params(sym, {"data": (1, side, side, 3)},
                                         seed=seed + 30)
    rng = np.random.default_rng(seed + 31)
    xs = rng.standard_normal((GLUON_SERVE_BATCH, side, side, 3)) \
        .astype(np.float32)
    xt = rng.standard_normal((GLUON_TRAIN_BATCH, side, side, 3)) \
        .astype(np.float32)
    yt = rng.integers(0, 1000, GLUON_TRAIN_BATCH).astype(np.float32)
    ctx = mt.gpu(0)

    def block():
        blk = mt.gluon.SymbolBlock(sym, [mt.sym.var("data"),
                                         mt.sym.var("softmax_label")])
        for k, p in blk.collect_params().items():
            p._load_init(mt.nd.array({**args, **aux}[k], ctx=mt.cpu()), ctx)
        return blk

    def counted(fn):
        torch.cuda.synchronize()
        for k in wrappers:
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k.__name__: k.launches for k in wrappers}
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        for mode in ("2d", "4d"):
            with c3_mode("4d" if mode == "4d" else "auto"):
                pred = mt.Predictor(sym, *mt.convert.params_from_numpy(
                    args, aux, device=ctx),
                    {"data": xs.shape}, ctx=ctx)
                want = torch.from_numpy(pred.forward(data=xs).get_output(0))
                blk = block()
                x_nd = mt.nd.array(xs, ctx=ctx)
                label = mt.nd.zeros((GLUON_SERVE_BATCH,), ctx=ctx)
                got, launches = counted(lambda: blk(x_nd, label))
                got = got._data.to("cpu", copy=True)
                equal = torch.equal(got, want)
                log("  SymbolBlock forward at batch %d, %s: %s Predictor's "
                    "(max |diff| %.3g); launches %s" % (
                        GLUON_SERVE_BATCH, mode,
                        "bit-equal to" if equal else "DIFFERS from",
                        float((got - want).abs().max()), launches))
                _launch_check("gluon SymbolBlock serve, %s" % mode, launches,
                              GLUON_SERVE_LAUNCHES[mode], 1)
                if not equal:
                    raise AssertionError("the SymbolBlock's %s forward "
                                         "differs from Predictor's" % mode)
                out["serve_" + mode] = {"launches": launches,
                                        "bit_equal": equal}
                del pred, blk
        os.environ["MXNET_CONV1X1_FUSED_BWD"] = "1"
        ex = sym.bind(ctx, {**{k: mt.nd.array(v, ctx=ctx)
                               for k, v in args.items()},
                            "data": mt.nd.array(xt, ctx=ctx),
                            "softmax_label": mt.nd.array(yt, ctx=ctx)},
                      aux_states={k: mt.nd.array(v, ctx=ctx)
                                  for k, v in aux.items()})
        ex.forward(is_train=True)
        ex.backward()
        want = {k: ex.grad_dict[k]._data.to("cpu", copy=True) for k in args}
        del ex

        def train_step(blk):
            x_nd, y_nd = mt.nd.array(xt, ctx=ctx), mt.nd.array(yt, ctx=ctx)

            def run():
                with mt.autograd.record():
                    o = blk(x_nd, y_nd)
                o.backward()
            _, launches = counted(run)
            params = blk.collect_params()
            return ({k: params[k].grad()._data.to("cpu", copy=True)
                     for k in args}, launches)
        runs = {"kernels": train_step(block())}
        with replaced(fu, "launch", _dw_zeroed("fu_mm_bwd")(fu.launch)):
            runs["fault: K5 dW zeroed"] = train_step(block())
    finally:
        os.environ.pop("MXNET_CONV1X1_FUSED_BWD", None)
        torch.backends.cudnn.deterministic = False
    for name, (grads, launches) in runs.items():
        differ = [k for k in want if not torch.equal(grads[k], want[k])]
        worst = max(float((grads[k] - want[k]).abs().max()) for k in want)
        log("  SymbolBlock training step, %s: %d of %d gradients differ "
            "from the Executor's (max |diff| %.3g); launches %s"
            % (name, len(differ), len(want), worst, launches))
        if name.startswith("fault"):
            if not differ:
                raise AssertionError("%s passed the SymbolBlock training "
                                     "check" % name)
            continue
        _launch_check("gluon SymbolBlock train", launches,
                      GLUON_TRAIN_LAUNCHES, 1)
        if differ:
            raise AssertionError("the SymbolBlock's gradients differ from "
                                 "the Executor's: %s" % differ[:5])
        out["train"] = {"launches": launches, "differ": differ}
    return out


def gluon_phase(torch, mt, fu, nn, kv, seed, card):
    """Phase 13.  (a) ``gluon.model_zoo.vision.resnet50_v2(classes=1000)``
    at 224x224 NCHW, batch 64, weights from ``seed`` (numpy, through
    ``convert.gluon_params_from_numpy``), trained GLUON_STEPS steps
    imperatively and GLUON_STEPS hybridized on the same seeded batches:
    step 1's loss, every gradient and the moving statistics after each
    step held bit for bit, hybridized against imperative (cuDNN
    deterministic in both), and step 1's gradients against the same
    net's symbol bound through Module; then each mode timed over steps
    2..GLUON_STEPS, its peak memory read and one step profiled.  (b)
    ``symbol_block_phase``.  Kernel launches: (b)'s runs."""
    import numpy as np
    wrappers = kernel_wrappers(fu, nn, kv)
    zoo = mt.gluon.model_zoo.vision
    shape = (1, 3, GLUON_IMAGE, GLUON_IMAGE)
    net0 = getattr(zoo, GLUON_FAMILY)(classes=GLUON_CLASSES,
                                      prefix="resnet_")
    weights = mt.convert.gluon_random_params(net0, shape, seed=seed + 20)
    rng = np.random.default_rng(seed + 21)
    batches = [(rng.standard_normal((GLUON_BATCH, 3, GLUON_IMAGE,
                                     GLUON_IMAGE)).astype(np.float32),
                rng.integers(0, GLUON_CLASSES, GLUON_BATCH)
                .astype(np.float32)) for _ in range(GLUON_STEPS)]
    for k in wrappers:
        k.launches = 0
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for hybrid in (False, True):
            net = getattr(zoo, GLUON_FAMILY)(classes=GLUON_CLASSES,
                                             prefix="resnet_")
            mt.convert.gluon_params_from_numpy(net, weights, ctx=mt.gpu(0))
            runs[hybrid] = gluon_train(torch, mt, net, batches, hybrid, card)
            del net
            torch.cuda.empty_cache()
        net = getattr(zoo, GLUON_FAMILY)(classes=GLUON_CLASSES,
                                         prefix="resnet_")
        mod_grads = gluon_module_grads(torch, mt, net, weights, batches[0])
        del net
    finally:
        torch.backends.cudnn.deterministic = False
    zoo_launches = {k.__name__: k.launches for k in wrappers}
    imp, hyb = runs[False], runs[True]
    grad_differ = [k for k in imp["grads"]
                   if not torch.equal(imp["grads"][k], hyb["grads"][k])]
    stat_differ = [(i + 1, k) for i, (a, b) in
                   enumerate(zip(imp["stats"], hyb["stats"]))
                   for k in a if not torch.equal(a[k], b[k])]
    mod_differ = [k for k in hyb["grads"]
                  if not torch.equal(mod_grads[k], hyb["grads"][k])]
    mod_err = max(float((mod_grads[k] - hyb["grads"][k]).abs().max())
                  for k in hyb["grads"])
    log("  %s, batch %d, %d steps each: losses imperative %s, hybridized "
        "%s" % (GLUON_FAMILY, GLUON_BATCH, GLUON_STEPS, fmt(imp["losses"]),
                fmt(hyb["losses"])))
    log("  hybridized against imperative: step-1 loss %s, %d of %d "
        "gradients differ, %d moving statistics differ over %d steps; "
        "Module's step-1 gradients: %d differ from the hybridized (max "
        "|diff| %.3g)" % ("equal" if imp["losses"][0] == hyb["losses"][0]
                          else "DIFFERS", len(grad_differ), len(imp["grads"]),
                          len(stat_differ), GLUON_STEPS, len(mod_differ),
                          mod_err))
    failures = []
    if imp["losses"][0] != hyb["losses"][0] or grad_differ or stat_differ:
        failures.append("hybridized differs from imperative: loss %s/%s, "
                        "gradients %s, statistics %s"
                        % (imp["losses"][0], hyb["losses"][0],
                           grad_differ[:3], stat_differ[:3]))
    if mod_differ:
        failures.append("Module's gradients differ: %s" % mod_differ[:3])
    if not all(np.isfinite(r["losses"]).all() for r in runs.values()):
        failures.append("non-finite loss")
    # timing and profile, cuDNN free to choose, from the same weights
    out = {"family": GLUON_FAMILY, "batch": GLUON_BATCH,
           "steps": GLUON_STEPS, "zoo_launches": zoo_launches}
    for hybrid in (False, True):
        mode = "hybridized" if hybrid else "imperative"
        net = getattr(zoo, GLUON_FAMILY)(classes=GLUON_CLASSES,
                                         prefix="resnet_")
        mt.convert.gluon_params_from_numpy(net, weights, ctx=mt.gpu(0))
        r = gluon_train(torch, mt, net, batches, hybrid, card, profile=True)
        del net
        torch.cuda.empty_cache()
        step_ms = sorted(1e3 * s for s in r["step_s"][1:])
        median = _median(step_ms)
        log("  %s: losses %s; median step (2..%d) %.2f ms, %.1f images/s, "
            "first step %.2f s, max_memory_allocated %.2f GB [%s]" % (
                mode, fmt(r["losses"]), GLUON_STEPS, median,
                GLUON_BATCH * 1e3 / median, r["step_s"][0],
                r["peak"] / 1e9, card))
        log_profile("one %s training step" % mode, r["profile"], card)
        out[mode] = {"losses": r["losses"], "step_ms_2_to_n": step_ms,
                     "median_step_ms": median,
                     "images_per_s": GLUON_BATCH * 1e3 / median,
                     "first_step_s": r["step_s"][0],
                     "max_memory_allocated": r["peak"],
                     "profile_step": r["profile"]}
    out["checks"] = {"grad_differ": grad_differ, "stat_differ": stat_differ,
                     "module_differ": mod_differ,
                     "module_max_abs_diff": mod_err}
    torch.cuda.empty_cache()
    out["symbol_block"] = sb = symbol_block_phase(torch, mt, fu, nn, kv,
                                                  seed, card)
    out["launches"] = {name: sum(r["launches"][name] for r in sb.values())
                       for name in sb["train"]["launches"]}
    if failures:
        raise AssertionError("gluon: " + "; ".join(failures))
    return out


# examples/rnn_ptb.py at its own widths (--num-hidden 200 --num-embed 200
# --num-layers 2, batch 32, buckets 10-40, lr 1.0), over its synthetic
# corpus; PTB's vocabulary through models/lstm_lm.py's fused op
RNN_HIDDEN, RNN_EMBED, RNN_LAYERS, RNN_BATCH = 200, 200, 2, 32
RNN_BUCKETS = [10, 20, 30, 40]
RNN_LR, RNN_EPOCHS = 1.0, 2         # the example's 10 epochs cut to 2
RNN_GRAD_RTOL = 1e-3                # step 1 on the card against the CPU
PTB_VOCAB, PTB_SENTENCES, PTB_LENGTHS, PTB_ZIPF = 10000, 2000, (6, 40), 1.2
PTB_LR = 0.1
PTB_LOSS_RTOL, PTB_GRAD_RTOL = 1e-5, 1e-4   # fused against unrolled
GLUON_RNN_SHAPE = (40, 32, 200)             # (T, N, C), TNC
GLUON_RNN_TOL = 1e-5                        # the layer against its cells


def synthetic_corpus(n=2000, vocab_size=64, seed=0):
    """examples/rnn_ptb.py's ``synthetic_corpus``, copied (the example
    imports the JAX package): a Markov-chain language of ``n`` sentences
    of 6-29 tokens over ids 1..vocab_size-1."""
    import numpy as np
    rng = np.random.default_rng(seed)
    trans = rng.dirichlet(np.ones(vocab_size - 1) * 0.1,
                          size=vocab_size - 1)
    out = []
    for _ in range(n):
        ln = int(rng.integers(6, 30))
        s = [int(rng.integers(1, vocab_size))]
        for _ in range(ln - 1):
            s.append(int(rng.choice(vocab_size - 1,
                                    p=trans[s[-1] - 1])) + 1)
        out.append(s)
    return out, {i: i for i in range(vocab_size)}


def zipf_corpus(seed):
    """PTB_SENTENCES sentences of PTB_LENGTHS tokens, their ids
    Zipf-distributed over 1..PTB_VOCAB-1 (the example's Markov chain would
    need a PTB_VOCAB^2 matrix)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.integers(PTB_LENGTHS[0], PTB_LENGTHS[1] + 1, PTB_SENTENCES)
    ids = (rng.zipf(PTB_ZIPF, int(lens.sum())) - 1) % (PTB_VOCAB - 1) + 1
    cuts = np.cumsum(lens)[:-1]
    return [[int(t) for t in s] for s in np.split(ids, cuts)]


def lstm_stack(mt):
    """The example's SequentialRNNCell of RNN_LAYERS LSTMCells."""
    stack = mt.rnn.SequentialRNNCell()
    for i in range(RNN_LAYERS):
        stack.add(mt.rnn.LSTMCell(RNN_HIDDEN, prefix="lstm_l%d_" % i))
    return stack


def example_sym_gen(mt, stack, vocab, head="example"):
    """examples/rnn_ptb.py's ``sym_gen`` over ``stack`` at ``vocab``; with
    head="lm" the loss head of models/lstm_lm.py (SoftmaxOutput without
    ignore_label), so that it computes what the fused model does."""
    def sym_gen(seq_len):
        data = mt.sym.Variable("data")
        label = mt.sym.Variable("softmax_label")
        embed = mt.sym.Embedding(data, input_dim=vocab,
                                 output_dim=RNN_EMBED, name="embed")
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = mt.sym.Reshape(outputs, shape=(-1, RNN_HIDDEN))
        pred = mt.sym.FullyConnected(pred, num_hidden=vocab, name="pred")
        label_f = mt.sym.Reshape(label, shape=(-1,))
        if head == "lm":
            out = mt.sym.SoftmaxOutput(pred, label_f, name="softmax")
        else:
            out = mt.sym.SoftmaxOutput(pred, label_f, name="softmax",
                                       use_ignore=True, ignore_label=0,
                                       normalization="valid")
        return out, ("data",), ("softmax_label",)
    return sym_gen


def fused_sym_gen(mt, vocab):
    def sym_gen(seq_len):
        return mt.models.lstm_lm_symbol(seq_len, vocab_size=vocab,
                                        num_embed=RNN_EMBED,
                                        num_hidden=RNN_HIDDEN,
                                        num_layers=RNN_LAYERS)
    return sym_gen


FUSED_STATES = ("lstm_init_h", "lstm_init_c")


def bucket_fit(torch, mt, sym_gen, it, weights, lr, epochs, card,
               state_names=()):
    """``BucketingModule.fit`` on cuda:0 from ``weights`` (host arrays;
    Xavier for the rest) with ``Perplexity(ignore_label=0)``: per-epoch
    perplexity, per-step (bucket, non-padding tokens, seconds), step 1's
    batch and gradients, the module, the fit's wall and peak memory (and
    the peak above what was allocated when the fit began: earlier phases
    leave arrays behind)."""
    import numpy as np
    ctx = mt.gpu(0)
    mod = mt.mod.BucketingModule(sym_gen,
                                 default_bucket_key=it.default_bucket_key,
                                 context=ctx, state_names=list(state_names))
    steps, ppl, first = [], {}, {}
    last = [None]

    def on_batch(param):
        now = time.perf_counter()
        batch = param.locals["batch"]
        steps.append((batch.bucket_key,
                      int(np.count_nonzero(batch.data[0].asnumpy())),
                      now - last[0]))
        last[0] = now
        ppl[param.epoch] = float(param.eval_metric.get()[1])
        if not first:
            ex = mod._curr_module._exec
            first["batch"] = batch
            first["grads"] = {k: ex.grad_dict[k]._data.to("cpu", copy=True)
                              for k in weights}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = last[0] = time.perf_counter()
    mod.fit(it, num_epoch=epochs,
            eval_metric=mt.metric.Perplexity(ignore_label=0),
            initializer=mt.init.Xavier(),
            arg_params={k: mt.nd.array(v, ctx=ctx)
                        for k, v in weights.items()},
            optimizer_params={"learning_rate": lr},
            batch_end_callback=[mt.callback.Speedometer(RNN_BATCH, 50),
                                on_batch])
    torch.cuda.synchronize()
    return {"mod": mod, "steps": steps, "ppl": [ppl[e] for e in
                                                sorted(ppl)],
            "first": first, "fit_s": time.perf_counter() - t0,
            "peak": torch.cuda.max_memory_allocated(), "base": base}


def step_reading(torch, mt, run, it, card, what):
    """Step ms by bucket (each bucket's first step, which binds it, left
    out), non-padding tokens/s over those steps, and one profiled step
    of the largest bucket that had batches (the example's corpus has no
    sentence for bucket 40); logged beside the card."""
    by_bucket = {}
    seen = set()
    tokens = secs = 0.0
    for key, ntok, s in run["steps"]:
        if key not in seen:
            seen.add(key)
            continue
        by_bucket.setdefault(key, []).append(1e3 * s)
        tokens += ntok
        secs += s
    medians = {k: _median(sorted(v)) for k, v in sorted(by_bucket.items())}
    it.reset()
    top = max(key for key, _, _ in run["steps"])
    big = next(b for b in it if b.bucket_key == top)
    mod = run["mod"]
    prof = profile_calls(torch, lambda: (mod.forward_backward(big),
                                         mod.update()), 3)
    rate = tokens / secs if secs else None
    log("  %s: %d steps in %.2f s, perplexity by epoch %s; median step ms "
        "by bucket %s; %.1f non-padding tokens/s; max_memory_allocated "
        "%.3f GB, %.3f GB above the fit's start [%s]" % (
            what, len(run["steps"]), run["fit_s"], fmt(run["ppl"], "%.3f"),
            {k: round(v, 3) for k, v in medians.items()}, rate or 0.0,
            run["peak"] / 1e9, (run["peak"] - run["base"]) / 1e9, card))
    log_profile("one %s step at bucket %d" % (what, big.bucket_key), prof,
                card)
    return {"steps": len(run["steps"]), "fit_s": run["fit_s"],
            "perplexity_by_epoch": run["ppl"],
            "median_step_ms_by_bucket": medians,
            "step_ms_by_bucket": by_bucket,
            "non_padding_tokens_per_s": rate,
            "max_memory_allocated": run["peak"],
            "peak_above_start": run["peak"] - run["base"],
            "profile_step": prof}


def module_grads(torch, mt, sym_gen, weights, batch, ctx, state_names=()):
    """One forward/backward of ``batch`` through a BucketingModule on
    ``ctx`` from ``weights``: (the outputs, {name: gradient}) on the
    host."""
    mod = mt.mod.BucketingModule(sym_gen, default_bucket_key=batch.bucket_key,
                                 context=ctx, state_names=list(state_names))
    mod.bind(batch.provide_data, batch.provide_label)
    mod.init_params(arg_params={k: mt.nd.array(v, ctx=ctx)
                                for k, v in weights.items()})
    mod.forward_backward(batch)
    ex = mod._curr_module._exec
    return (ex.outputs[0]._data.to("cpu", copy=True),
            {k: ex.grad_dict[k]._data.to("cpu", copy=True)
             for k in weights})


def rel_l2(torch, got, want):
    """Relative L2 of dicts of tensors, over all of them together."""
    num = sum(float((got[k].double() - want[k].double()).norm()) ** 2
              for k in want)
    den = sum(float(want[k].double().norm()) ** 2 for k in want)
    return (num / den) ** 0.5


def lm_loss(torch, probs, batch):
    """The mean cross-entropy of SoftmaxOutput's probabilities against the
    batch's labels, in f64."""
    lab = batch.label[0]._data.reshape(-1).long()
    p = probs.double()[torch.arange(lab.numel()), lab]
    return float(-p.clamp_min(1e-30).log().mean())


def swapped_if(mt, cell, blob):
    """``blob`` (a host array) with the i and f gate blocks of layer 0's
    i2h and h2h weights and biases swapped: a planted fault."""
    import numpy as np
    bad = blob.copy()
    entries, _ = cell._blob_entries(RNN_EMBED)
    where = {name: (shape, off) for name, shape, off in entries}
    for group in ("i2h", "h2h"):
        for kind in ("weight", "bias"):
            (shape, oi) = where["lstm_l0_%s_i_%s" % (group, kind)]
            (_, of) = where["lstm_l0_%s_f_%s" % (group, kind)]
            n = int(np.prod(shape))
            bad[oi:oi + n], bad[of:of + n] = blob[of:of + n], blob[oi:oi + n]
    return bad


def fused_vs_unrolled(torch, mt, weights, batch, ctx, blob=None):
    """One batch through models/lstm_lm.py's fused graph (its packed
    ``lstm_parameters``, or ``blob``) and through the example's unrolled
    LSTMCells with the same weights (FusedRNNCell.unpack_weights, then the
    cells' pack_weights) and the fused model's head: (loss relative
    error, worst per-gate/per-array gradient relative L2, {name: rel})."""
    fw = dict(weights)
    if blob is not None:
        fw["lstm_parameters"] = blob
    probs_f, grads_f = module_grads(torch, mt, fused_sym_gen(mt, PTB_VOCAB),
                                   fw, batch, ctx, FUSED_STATES)
    cell = mt.rnn.FusedRNNCell(RNN_HIDDEN, num_layers=RNN_LAYERS,
                               mode="lstm", prefix="lstm_")
    stack = lstm_stack(mt)
    per_gate = mt.convert.rnn_params_to_numpy(cell, {
        "lstm_parameters": mt.nd.array(weights["lstm_parameters"],
                                       ctx=mt.cpu())})
    unrolled_w = {k: v.asnumpy() for k, v in mt.convert.rnn_params_from_numpy(
        stack, per_gate, device=mt.cpu()).items()}
    unrolled_w.update({k: v for k, v in weights.items()
                       if k != "lstm_parameters"})
    probs_u, grads_u = module_grads(
        torch, mt, example_sym_gen(mt, stack, PTB_VOCAB, head="lm"),
        unrolled_w, batch, ctx)

    def gates(c, grads, name_filter):
        nd = {k: mt.nd.NDArray(v) for k, v in grads.items()
              if name_filter(k)}
        return {k: v._data for k, v in c.unpack_weights(nd).items()}
    gf = gates(cell, grads_f, lambda k: k == "lstm_parameters")
    gu = gates(stack, grads_u, lambda k: k.startswith("lstm_l"))
    for k in ("embed_weight", "pred_weight", "pred_bias"):
        gf[k], gu[k] = grads_f[k], grads_u[k]
    assert sorted(gf) == sorted(gu)
    rels = {k: rel_l2(torch, {k: gf[k]}, {k: gu[k]}) for k in gu}
    lf, lu = lm_loss(torch, probs_f, batch), lm_loss(torch, probs_u, batch)
    return abs(lf - lu) / abs(lu), max(rels.values()), rels, (lf, lu)


def gluon_rnn_check(torch, mt, seed, card):
    """(c) ``gluon.rnn.LSTM(200, num_layers=2)`` on (40, 32, 200) TNC:
    imperative and hybridized (a Block: the same eager path) forward and
    backward bit for bit; the same weights as two LSTMCells (the layer's
    ``_unfuse``) unrolled imperatively and hybridized (a CachedOp a step),
    which agree bit for bit, against the layer within GLUON_RNN_TOL."""
    import numpy as np
    ctx = mt.gpu(0)
    T, N, C = GLUON_RNN_SHAPE
    rng = np.random.default_rng(seed + 50)
    x = rng.standard_normal(GLUON_RNN_SHAPE).astype(np.float32)
    cot = rng.standard_normal((T, N, RNN_HIDDEN)).astype(np.float32)
    weights = None

    def run(kind, hybrid):
        nonlocal weights
        layer = mt.gluon.rnn.LSTM(RNN_HIDDEN, num_layers=RNN_LAYERS,
                                  prefix="lstm_")
        if weights is None:
            weights = mt.convert.gluon_random_params(layer, GLUON_RNN_SHAPE,
                                                     seed=seed + 51)
        mt.convert.gluon_params_from_numpy(layer, weights, ctx=ctx)
        block = layer if kind == "layer" else layer._unfuse()
        if hybrid:
            block.hybridize()
        xs = mt.nd.array(x, ctx=ctx)
        xs.attach_grad()
        with mt.autograd.record():
            if kind == "layer":
                y = block(xs)
            else:
                y, _ = block.unroll(T, xs, layout="TNC", merge_outputs=True)
            loss = (y * mt.nd.array(cot, ctx=ctx)).sum()
        loss.backward()
        torch.cuda.synchronize()
        grads = {k: p.grad()._data.to("cpu", copy=True)
                 for k, p in layer.collect_params().items()}
        grads["data"] = xs.grad._data.to("cpu", copy=True)
        return y._data.detach().to("cpu", copy=True), grads
    runs = {(k, h): run(k, h) for k in ("layer", "cells")
            for h in (False, True)}

    def same(a, b):
        return torch.equal(a[0], b[0]) and all(
            torch.equal(a[1][k], b[1][k]) for k in a[1])
    layer_bits = same(runs["layer", False], runs["layer", True])
    cell_bits = same(runs["cells", False], runs["cells", True])
    ly, lg = runs["layer", False]
    cy, cg = runs["cells", False]
    y_err = float((ly - cy).abs().max())
    g_err = max(float((lg[k] - cg[k]).abs().max())
                / max(float(cg[k].abs().max()), 1e-30) for k in cg)
    log("  (c) gluon.rnn.LSTM(%d, num_layers=%d) on %s TNC: hybridized %s "
        "imperative; its LSTMCells hybridized %s imperative; layer against "
        "cells: output max |diff| %.3g, gradients max |diff| / max |g| "
        "%.3g (limit %g) [%s]" % (
            RNN_HIDDEN, RNN_LAYERS, GLUON_RNN_SHAPE,
            "bit-equal to" if layer_bits else "DIFFERS from",
            "bit-equal to" if cell_bits else "DIFFER from", y_err, g_err,
            GLUON_RNN_TOL, card))
    failures = []
    if not layer_bits:
        failures.append("the hybridized LSTM layer differs from the "
                        "imperative one")
    if not cell_bits:
        failures.append("the hybridized LSTMCells differ from the "
                        "imperative ones")
    if y_err > GLUON_RNN_TOL or g_err > GLUON_RNN_TOL:
        failures.append("the LSTM layer differs from its cells: %.3g, %.3g"
                        % (y_err, g_err))
    return {"layer_bit_equal": layer_bits, "cells_bit_equal": cell_bits,
            "layer_vs_cells_max_abs": y_err,
            "layer_vs_cells_grad_rel": g_err}, failures


def rnn_phase(torch, mt, fu, nn, kv, seed, card):
    """Phase 14.  (a) examples/rnn_ptb.py's run at its widths over its
    synthetic corpus: BucketingModule over two unrolled LSTMCells, 2
    epochs; perplexity must fall, and step 1's gradients must be within
    RNN_GRAD_RTOL of the port's CPU run from the same weights and batch.
    (b) PTB's vocabulary through models/lstm_lm.py's fused RNN op over a
    Zipf corpus, one epoch; one batch of bucket 40 fused against the
    example's unrolled cells with the same weights, and with the i and f
    gate blocks swapped (a planted fault that must fail).  (c)
    ``gluon_rnn_check``.  No hand-written kernel runs on this path: every
    launch counter must read 0."""
    import numpy as np
    ctx = mt.gpu(0)
    wrappers = kernel_wrappers(fu, nn, kv)
    for k in wrappers:
        k.launches = 0
    failures = []
    out = {}

    # (a) the example
    sentences, _ = synthetic_corpus()
    vocab = 64
    it = mt.rnn.BucketSentenceIter(sentences, RNN_BATCH, buckets=RNN_BUCKETS,
                                   invalid_label=0)
    stack = lstm_stack(mt)
    sym_gen = example_sym_gen(mt, stack, vocab)
    mt.random.seed(seed)
    draw = mt.mod.BucketingModule(sym_gen,
                                  default_bucket_key=it.default_bucket_key,
                                  context=ctx)
    draw.bind(it.provide_data, it.provide_label)
    draw.init_params(initializer=mt.init.Xavier())
    weights = {k: v.asnumpy() for k, v in draw.get_params()[0].items()}
    del draw
    run = bucket_fit(torch, mt, sym_gen, it, weights, RNN_LR, RNN_EPOCHS,
                     card)
    batch = run["first"]["batch"]
    _, cpu_grads = module_grads(torch, mt, sym_gen, weights, batch,
                                mt.cpu())
    grad_rel = rel_l2(torch, run["first"]["grads"], cpu_grads)
    out["example"] = step_reading(torch, mt, run, it, card,
                                  "examples/rnn_ptb.py")
    out["example"].update(step1_grad_rel_l2=grad_rel,
                          step1_bucket=batch.bucket_key,
                          buckets_bound=sorted(run["mod"]._buckets))
    ppl = run["ppl"]
    log("  (a) step 1 (bucket %d): gradients on the card against the CPU's "
        "from the same weights, relative L2 over all %d parameters %.3g "
        "(limit %g); buckets bound %s" % (
            batch.bucket_key, len(cpu_grads), grad_rel, RNN_GRAD_RTOL,
            sorted(run["mod"]._buckets)))
    if not ppl[-1] < ppl[0]:
        failures.append("(a) perplexity did not fall: %s" % ppl)
    if not grad_rel <= RNN_GRAD_RTOL:
        failures.append("(a) step 1's gradients %.3g from the CPU's"
                        % grad_rel)
    if sorted(run["mod"]._buckets) != RNN_BUCKETS:
        failures.append("(a) buckets bound %s" % sorted(run["mod"]._buckets))
    del run
    torch.cuda.empty_cache()

    # (b) PTB's vocabulary through the fused op
    ptb = mt.rnn.BucketSentenceIter(zipf_corpus(seed + 40), RNN_BATCH,
                                    buckets=RNN_BUCKETS, invalid_label=0)
    fsym = fused_sym_gen(mt, PTB_VOCAB)
    args, _ = mt.convert.random_params(
        fsym(max(RNN_BUCKETS))[0],
        {"data": (RNN_BATCH, max(RNN_BUCKETS)),
         "softmax_label": (RNN_BATCH, max(RNN_BUCKETS))}, seed=seed + 41)
    for k in FUSED_STATES:
        args.pop(k)
    big = next(b for b in ptb if b.bucket_key == max(RNN_BUCKETS))
    ptb.reset()
    loss_rel, grad_worst, rels, losses = fused_vs_unrolled(torch, mt, args,
                                                           big, ctx)
    cell = mt.rnn.FusedRNNCell(RNN_HIDDEN, num_layers=RNN_LAYERS,
                               mode="lstm", prefix="lstm_")
    f_loss, f_grad, _, _ = fused_vs_unrolled(
        torch, mt, args, big, ctx,
        blob=swapped_if(mt, cell, args["lstm_parameters"]))
    log("  (b) fused LSTM (models/lstm_lm.py, vocab %d) against the "
        "example's unrolled LSTMCells, one batch of bucket %d: loss %.7f "
        "vs %.7f, relative %.3g (limit %g); worst gradient relative L2 %.3g "
        "(limit %g) over %d arrays [%s]" % (
            PTB_VOCAB, big.bucket_key, losses[0], losses[1], loss_rel,
            PTB_LOSS_RTOL, grad_worst, PTB_GRAD_RTOL, len(rels), card))
    log("  (b) fault: the i and f gate blocks of layer 0 swapped in the "
        "blob: loss relative %.3g, worst gradient %.3g" % (f_loss, f_grad))
    if loss_rel > PTB_LOSS_RTOL or grad_worst > PTB_GRAD_RTOL:
        failures.append("(b) fused differs from unrolled: loss %.3g, "
                        "gradient %.3g" % (loss_rel, grad_worst))
    if f_loss <= PTB_LOSS_RTOL and f_grad <= PTB_GRAD_RTOL:
        failures.append("(b) the swapped-gate fault passed")
    mt.random.seed(seed + 42)
    prun = bucket_fit(torch, mt, fsym, ptb, args, PTB_LR, 1, card,
                      state_names=FUSED_STATES)
    out["ptb"] = step_reading(torch, mt, prun, ptb, card,
                              "models/lstm_lm.py fused, vocab %d"
                              % PTB_VOCAB)
    out["ptb"].update(fused_vs_unrolled={
        "loss_rel": loss_rel, "worst_grad_rel_l2": grad_worst,
        "grad_rel_l2": rels, "losses": losses,
        "fault_loss_rel": f_loss, "fault_worst_grad_rel_l2": f_grad})
    if not np.isfinite(prun["ppl"]).all():
        failures.append("(b) perplexity not finite: %s" % prun["ppl"])
    del prun
    torch.cuda.empty_cache()

    # (c) Gluon
    out["gluon"], more = gluon_rnn_check(torch, mt, seed, card)
    failures += more
    out["launches"] = {k.__name__: k.launches for k in wrappers}
    log("  launches of the hand-written kernels in this phase: %s"
        % out["launches"])
    if any(out["launches"].values()):
        failures.append("hand-written kernels launched: %s"
                        % out["launches"])
    if failures:
        raise AssertionError("rnn: " + "; ".join(failures))
    return out


SSD_NETWORK, SSD_CLASSES, SSD_IMAGE = "vgg16_reduced", 20, 300
SSD_BATCH, SSD_PAD = 32, 24         # examples/train_ssd.py's defaults
SSD_RECORDS, SSD_EPOCHS = 256, 3    # 8 batches an epoch
SSD_STORED = (320, 400)             # sides of the stored JPEGs
SSD_MEAN = (123.68, 116.779, 103.939)
SSD_SGD = {"learning_rate": 0.004, "momentum": 0.9, "wd": 1e-4}
SSD_PARAMS = 25167662               # vgg16_reduced, 20 classes
SSD_CHECK_IMAGES, SSD_DETECT_IMAGES = 4, 2
SSD_GRAD_FACTOR = 10                # limit: 10x the CPU's f32 error
SSD_LOC_ATOL, SSD_DET_ATOL = 1e-5, 1e-5
SSD_DETECT_REPS = 5


def write_det_records(mt, prefix, n, seed):
    """``n`` seeded JPEG detection records, each side in SSD_STORED: a
    smooth random background and 1-8 filled boxes, each in its class's
    colour (classes 0..SSD_CLASSES-1), labels packed by
    ``pack_det_label``."""
    import numpy as np
    rio = mt.recordio
    rng = np.random.default_rng(seed)
    colours = rng.integers(0, 256, (SSD_CLASSES, 3))
    w = rio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    try:
        for i in range(n):
            h, wd = rng.integers(SSD_STORED[0], SSD_STORED[1] + 1, 2)
            small = rng.integers(0, 256, (h // 40 + 1, wd // 40 + 1, 3))
            img = np.kron(small, np.ones((40, 40, 1)))[:h, :wd]
            objs = []
            for _ in range(rng.integers(1, 9)):
                cls = int(rng.integers(0, SSD_CLASSES))
                bw, bh = rng.uniform(0.1, 0.6, 2)
                x0, y0 = rng.uniform(0, 1 - bw), rng.uniform(0, 1 - bh)
                img[int(y0 * h):int((y0 + bh) * h),
                    int(x0 * wd):int((x0 + bw) * wd)] = colours[cls]
                objs.append([cls, x0, y0, x0 + bw, y0 + bh])
            label = mt.image.pack_det_label(np.array(objs))
            w.write_idx(i, rio.pack_img(rio.IRHeader(0, label, i, 0),
                                        img.astype(np.uint8), quality=95))
    finally:
        w.close()
    return prefix + ".rec"


def ssd_iter(mt, rec, seed):
    """examples/train_ssd.py's iterator over ``rec``: 300x300, batch 32,
    24 label rows, mirror, crop with probability 0.5, shuffle, its means,
    the threaded pool with one thread per host core."""
    args = dict(path_imgrec=rec, data_shape=(3, SSD_IMAGE, SSD_IMAGE),
                batch_size=SSD_BATCH, label_pad_count=SSD_PAD,
                rand_mirror=True, rand_crop_prob=0.5, shuffle=True,
                preprocess_threads=os.cpu_count(), seed=seed,
                data_name="data", label_name="label")
    args.update(zip(("mean_r", "mean_g", "mean_b"), SSD_MEAN))
    return mt.io.ImageDetRecordIter(**args)


def class_ce(torch, outs):
    """The masked class cross-entropy of one SSD training step (as
    tests/test_ssd.py computes it), on the device: -log p over the anchors
    whose cls_target is not ignored."""
    probs, labels = outs[0]._data, outs[2]._data
    mask = labels >= 0
    p = probs.gather(1, labels.clamp_min(0).long()[:, None])[:, 0]
    return -(p.clamp(1e-8, 1).log() * mask).sum() / mask.sum()


def ssd_fit(torch, mt, sym, it, weights, card):
    """examples/train_ssd.py's ``fit`` on cuda:0 from ``weights`` (host
    arrays, carried by ``convert.params_from_numpy``): SGD with the
    example's settings, kvstore local, ``Loss`` over loc_loss_output
    (the default "acc" raises: three outputs, one label).  Returns the
    module, per-step seconds and class cross-entropies, the first
    batch's first SSD_CHECK_IMAGES images and labels, the fit's wall and
    peak memory (and the peak above what was allocated when it began)."""
    ctx = mt.gpu(0)
    args, _ = mt.convert.params_from_numpy(weights, {}, device=ctx)
    n_params = sum(v.size for v in args.values())
    if n_params != SSD_PARAMS:
        raise AssertionError("ssd: params_from_numpy carried %d parameters, "
                             "not %d" % (n_params, SSD_PARAMS))
    mod = mt.mod.Module(sym, context=ctx, data_names=("data",),
                        label_names=("label",))
    steps, ces, first = [], [], {}
    last = [None]

    def on_batch(param):
        now = time.perf_counter()
        steps.append(now - last[0])
        last[0] = now
        ces.append(class_ce(torch, mod.get_outputs()))
        if not first:
            batch = param.locals["batch"]
            first["x"] = batch.data[0].asnumpy()[:SSD_CHECK_IMAGES]
            first["y"] = batch.label[0].asnumpy()[:SSD_CHECK_IMAGES]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = last[0] = time.perf_counter()
    mod.fit(it, num_epoch=SSD_EPOCHS, kvstore="local", optimizer="sgd",
            optimizer_params=SSD_SGD, initializer=mt.init.Xavier(),
            eval_metric=mt.metric.Loss(output_names=["loc_loss_output"]),
            arg_params=args, batch_end_callback=on_batch)
    torch.cuda.synchronize()
    return {"mod": mod, "steps": steps, "n_params": n_params,
            "ce": [float(c) for c in ces], "first": first,
            "fit_s": time.perf_counter() - t0,
            "peak": torch.cuda.max_memory_allocated(), "base": base}


def ssd_check_symbol(mt, sym):
    """The train graph's three outputs, then MultiBoxTarget's loc_target
    and loc_mask."""
    inner = sym.get_internals()
    return mt.sym.Group([sym[i] for i in range(3)] + [
        inner["multibox_target_output0"], inner["multibox_target_output1"]])


def ssd_step(torch, mt, sym, weights, x, y, ctx, dtype):
    """One training forward and backward of ``sym`` through the Executor
    on ``ctx`` in ``dtype``: (outputs, {name: gradient}) on the host in
    float64."""
    args = {k: mt.nd.array(v, ctx=ctx, dtype=dtype)
            for k, v in weights.items()}
    args["data"] = mt.nd.array(x, ctx=ctx, dtype=dtype)
    args["label"] = mt.nd.array(y, ctx=ctx, dtype=dtype)
    req = {n: "null" if n in ("data", "label") else "write"
           for n in sym.list_arguments()}
    ex = sym.bind(ctx, args=args, grad_req=req)
    outs = ex.forward(is_train=True)
    ex.backward()
    return ([o._data.to("cpu", torch.float64) for o in outs],
            {k: ex.grad_dict[k]._data.to("cpu", torch.float64)
             for k in weights})


def ssd_target_reading(torch, got, want):
    """MultiBoxTarget on two runs: anchors whose cls_target differs
    (only negatives against ignored ones, the mining ties, are allowed),
    loc_mask equal, loc_target's largest difference."""
    cls_g, cls_w = got[2], want[2]
    diff = cls_g != cls_w
    ties = diff & (cls_g <= 0) & (cls_w <= 0)
    return {"mining_ties_flipped": int(ties.sum()),
            "other_cls_target_diffs": int((diff & ~ties).sum()),
            "loc_mask_diffs": int((got[4] != want[4]).sum()),
            "loc_target_max_abs": float((got[3] - want[3]).abs().max())}


def ssd_grad_check(torch, mt, sym, weights, x, y, card):
    """(b): one step of the first SSD_CHECK_IMAGES images on the card and
    on the CPU from the same weights; the limit on the gradients is
    SSD_GRAD_FACTOR times a control, the CPU's float32 step against its
    float64 step.  Then the same with ``_encode_box``'s x and y swapped
    on the card: a planted fault that must fail."""
    from mxnet_tpu_torch.ops import contrib_det
    import numpy as np
    csym = ssd_check_symbol(mt, sym)
    cpu32 = ssd_step(torch, mt, csym, weights, x, y, mt.cpu(), np.float32)
    cpu64 = ssd_step(torch, mt, csym, weights, x, y, mt.cpu(), np.float64)
    control = rel_l2(torch, cpu32[1], cpu64[1])
    limit = SSD_GRAD_FACTOR * control

    def reading(run):
        r = {"grad_rel_l2": rel_l2(torch, run[1], cpu32[1]),
             "grad_rel_l2_f64": rel_l2(torch, run[1], cpu64[1])}
        r.update(ssd_target_reading(torch, run[0], cpu32[0]))
        r["fails"] = [k for k, bad in (
            ("gradients", not r["grad_rel_l2"] <= limit),
            ("cls_target", r["other_cls_target_diffs"] > 0),
            ("loc_mask", r["loc_mask_diffs"] > 0),
            ("loc_target", not r["loc_target_max_abs"] <= SSD_LOC_ATOL))
            if bad]
        return r
    card_run = reading(ssd_step(torch, mt, csym, weights, x, y, mt.gpu(0),
                                np.float32))
    encode = contrib_det._encode_box

    def swapped(anchor, gt, variances):
        return encode(anchor[..., [1, 0, 3, 2]], gt[..., [1, 0, 3, 2]],
                      variances)
    with replaced(contrib_det, "_encode_box", swapped):
        fault = reading(ssd_step(torch, mt, csym, weights, x, y, mt.gpu(0),
                                 np.float32))
    ctrl_ties = ssd_target_reading(torch, cpu64[0], cpu32[0])
    log("  (b) step 1 of %d images, card against the CPU from the same "
        "weights: gradients relative L2 %.3g (against f64 %.3g), limit %.3g "
        "= %d x the control (the CPU's f32 step against its f64 step, "
        "%.3g); MultiBoxTarget: %d anchors flipped by mining ties (control "
        "%d), %d other cls_target and %d loc_mask differences, loc_target "
        "within %.3g (limit %g) [%s]" % (
            len(x), card_run["grad_rel_l2"], card_run["grad_rel_l2_f64"],
            limit, SSD_GRAD_FACTOR, control,
            card_run["mining_ties_flipped"],
            ctrl_ties["mining_ties_flipped"],
            card_run["other_cls_target_diffs"], card_run["loc_mask_diffs"],
            card_run["loc_target_max_abs"], SSD_LOC_ATOL, card))
    log("  (b) fault: _encode_box with x and y swapped on the card: "
        "gradients %.3g, loc_target %.3g; fails on %s" % (
            fault["grad_rel_l2"], fault["loc_target_max_abs"],
            fault["fails"] or "nothing"))
    failures = ["(b) the card's step fails on %s" % card_run["fails"]] \
        if card_run["fails"] else []
    if not fault["fails"]:
        failures.append("(b) the swapped-encode fault passed")
    return {"control_grad_rel_l2": control, "limit": limit,
            "control_mining_ties_flipped": ctrl_ties["mining_ties_flipped"],
            "card": card_run, "fault": fault}, failures


def kept_match(got, want, atol):
    """Kept detections (class id >= 0) of one image, card against CPU:
    each card row matched to an unused CPU row of the same class with
    score and box within ``atol``.  Rows of nearly equal score may come
    in either order.  Returns (kept on the card, kept on the CPU, rows
    matched, rows matched at another position)."""
    import numpy as np
    g = got[got[:, 0] >= 0]
    w = want[want[:, 0] >= 0]
    used = np.zeros(len(w), bool)
    matched = moved = 0
    for i, row in enumerate(g):
        close = (~used) & (w[:, 0] == row[0]) \
            & (np.abs(w[:, 1:] - row[1:]).max(axis=1) <= atol)
        if close.any():
            j = int(np.argmax(close))
            used[j] = True
            matched += 1
            moved += j != i
    return len(g), len(w), matched, moved


def ssd_detect(torch, mt, trained, x, n_anchors, card):
    """(c): the detect graph with the trained weights through
    ``Predictor`` on cuda:0 at batch SSD_BATCH, nms_topk 400: its output,
    ms per batch, MultiBoxDetection's and its NMS loop's ms on the same
    inputs, peak memory; held against the CPU ``Predictor`` on
    SSD_DETECT_IMAGES images."""
    from mxnet_tpu_torch.ops import contrib_det
    from mxnet_tpu_torch.ops.registry import invoke
    ctx = mt.gpu(0)
    dsym = mt.models.get_ssd_symbol(SSD_NETWORK, num_classes=SSD_CLASSES,
                                    mode="detect")
    params = {k: v for k, v in trained.items()
              if k in dsym.list_arguments()}
    shape = {"data": (SSD_BATCH, 3, SSD_IMAGE, SSD_IMAGE)}
    xd = mt.nd.array(x, ctx=ctx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    pred = mt.Predictor(dsym, params, {}, shape, ctx=ctx)
    out = pred.forward(data=xd).get_output(0)
    secs = []
    for _ in range(SSD_DETECT_REPS):
        t0 = time.perf_counter()
        pred.forward(data=xd)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    inner = dsym.get_internals()
    heads = mt.Predictor(mt.sym.Group([
        inner[n] for n in ("cls_prob_output", "multibox_loc_pred_output",
                           "multibox_anchors_output")]), params, {}, shape,
        ctx=ctx)
    heads.forward(data=xd)
    ins = [o._data for o in heads._exec.outputs]
    attrs = {"nms_threshold": 0.45, "nms_topk": 400, "clip": True,
             "force_suppress": False}

    def op_ms():
        ts = []
        for _ in range(SSD_DETECT_REPS):
            t0 = time.perf_counter()
            invoke("_contrib_MultiBoxDetection", attrs, *ins)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return 1e3 * _median(ts)
    full = op_ms()
    with replaced(contrib_det, "nms_keep", lambda keep, suppress: keep):
        without = op_ms()
    detect_ms = 1e3 * _median(secs)
    with mt.cpu():
        cpu_params = {k: v.as_in_context(mt.cpu()) for k, v in params.items()}
        cpu_pred = mt.Predictor(
            dsym, cpu_params, {},
            {"data": (SSD_DETECT_IMAGES, 3, SSD_IMAGE, SSD_IMAGE)},
            ctx=mt.cpu())
        want = cpu_pred.forward(data=x[:SSD_DETECT_IMAGES]).get_output(0)
    matches = [kept_match(out[i], want[i], SSD_DET_ATOL)
               for i in range(SSD_DETECT_IMAGES)]
    r = {"shape": list(out.shape), "detect_ms": detect_ms,
         "images_per_s": SSD_BATCH / (detect_ms / 1e3),
         "multibox_detection_ms": full, "nms_loop_ms": full - without,
         "nms_share": (full - without) / detect_ms,
         "max_memory_allocated": peak, "peak_above_start": peak - base,
         "kept": [int((out[i][:, 0] >= 0).sum()) for i in range(len(out))],
         "cpu_match": matches}
    log("  (c) detect: Predictor on %s at batch %d, nms_topk 400: output %s, "
        "%.3f ms a batch (%.1f images/s), MultiBoxDetection %.3f ms of it, "
        "its NMS loop %.3f ms (share of the batch %.3f); max_memory_"
        "allocated %.3f GB, %.3f GB above the start; kept per image %s "
        "[%s]" % (SSD_NETWORK, SSD_BATCH, tuple(out.shape), detect_ms,
                  r["images_per_s"], full, r["nms_loop_ms"], r["nms_share"],
                  peak / 1e9, (peak - base) / 1e9, r["kept"][:8], card))
    log("  (c) against the CPU Predictor on %d images: (kept on the card, "
        "on the CPU, matched within %g, matched at another position) %s"
        % (SSD_DETECT_IMAGES, SSD_DET_ATOL, matches))
    failures = []
    if tuple(out.shape) != (SSD_BATCH, n_anchors, 6):
        failures.append("(c) output %s" % (tuple(out.shape),))
    if not all(g == w == m for g, w, m, _ in matches):
        failures.append("(c) detections differ from the CPU's: %s" % matches)
    if not sum(r["kept"]):
        failures.append("(c) nothing detected")
    return r, failures


def ssd_phase(torch, mt, fu, nn, kv, seed, card):
    """Phase 15.  examples/train_ssd.py's path: (a) ``Module.fit`` of the
    SSD train graph over ``io.ImageDetRecordIter``; (b)
    ``ssd_grad_check``; (c) ``ssd_detect``.  No hand-written kernel
    runs on this path: every launch counter must read 0."""
    import numpy as np
    ctx = mt.gpu(0)
    wrappers = kernel_wrappers(fu, nn, kv)
    for k in wrappers:
        k.launches = 0
    failures = []
    sym = mt.models.get_ssd_symbol(SSD_NETWORK, num_classes=SSD_CLASSES,
                                   mode="train")
    n_anchors = sym.infer_shape(data=(1, 3, SSD_IMAGE, SSD_IMAGE),
                                label=(1, SSD_PAD, 5))[1][0][2]
    with tempfile.TemporaryDirectory(prefix="ssd") as tmp:
        t0 = time.perf_counter()
        rec = write_det_records(mt, os.path.join(tmp, "train"), SSD_RECORDS,
                                seed + 50)
        write_s = time.perf_counter() - t0
        it = ssd_iter(mt, rec, seed)
        mt.random.seed(seed)
        draw = mt.mod.Module(sym, context=ctx, data_names=("data",),
                             label_names=("label",))
        draw.bind(it.provide_data, it.provide_label)
        draw.init_params(initializer=mt.init.Xavier())
        weights = {k: v.asnumpy() for k, v in draw.get_params()[0].items()}
        del draw
        run = ssd_fit(torch, mt, sym, it, weights, card)
        mod = run["mod"]
        it.reset()
        batch = next(iter(it))
        x = batch.data[0].asnumpy()
        prof = profile_calls(torch, lambda: (mod.forward_backward(batch),
                                             mod.update()), 3)
        it.close()
    steps = run["steps"][1:]
    med = _median(steps)
    out = {"records": SSD_RECORDS, "write_s": write_s,
           "steps": len(run["steps"]), "fit_s": run["fit_s"],
           "step_ms": [1e3 * s for s in run["steps"]],
           "median_step_ms": 1e3 * med, "images_per_s": SSD_BATCH / med,
           "class_ce": run["ce"], "n_params": run["n_params"],
           "max_memory_allocated": run["peak"],
           "peak_above_start": run["peak"] - run["base"],
           "profile_step": prof}
    log("  (a) %d JPEG records written in %.2f s; Module.fit of %s (%d "
        "parameters, %d classes + background, %d anchors) at batch %d: %d "
        "steps in %.2f s, median step %.3f ms (%.1f images/s); class "
        "cross-entropy %.4f at step 1, %.4f at the last; max_memory_"
        "allocated %.3f GB, %.3f GB above the fit's start [%s]" % (
            SSD_RECORDS, write_s, SSD_NETWORK, run["n_params"], SSD_CLASSES,
            n_anchors, SSD_BATCH, len(run["steps"]),
            run["fit_s"], 1e3 * med, SSD_BATCH / med, run["ce"][0],
            run["ce"][-1], run["peak"] / 1e9,
            (run["peak"] - run["base"]) / 1e9, card))
    log_profile("one SSD training step", prof, card)
    if not np.isfinite(run["ce"]).all() or not run["ce"][-1] < run["ce"][0]:
        failures.append("(a) the class loss did not fall: %s"
                        % fmt(run["ce"], "%.4f"))
    first = run["first"]
    trained = {k: v.as_in_context(ctx)
               for k, v in mod.get_params()[0].items()}
    del mod, run
    torch.cuda.empty_cache()
    out["grad_check"], more = ssd_grad_check(torch, mt, sym, weights,
                                             first["x"], first["y"], card)
    failures += more
    out["detect"], more = ssd_detect(torch, mt, trained, x, n_anchors, card)
    failures += more
    out["launches"] = {k.__name__: k.launches for k in wrappers}
    log("  launches of the hand-written kernels in this phase: %s"
        % out["launches"])
    if any(out["launches"].values()):
        failures.append("hand-written kernels launched: %s"
                        % out["launches"])
    if failures:
        raise AssertionError("ssd: " + "; ".join(failures))
    return out


_SOURCES = {
    "fu_mm_fwd": ("mm_fwd", "mxnet_tpu/ops/fused_unit.py:376"),
    "fu_c3_fwd2d": ("c3_fwd2d", "mxnet_tpu/ops/fused_unit.py:457"),
    "fu_c3_fwd4d": ("c3_fwd4d", "mxnet_tpu/ops/fused_unit.py:419"),
    "fu_mm_skip_fwd": ("mm_skip_fwd", "mxnet_tpu/ops/fused_unit.py:400"),
    "fu_mm_bwd": ("mm_bwd", "mxnet_tpu/ops/fused_unit.py:523"),
    "fu_c3_bwd2d": ("c3_bwd2d", "mxnet_tpu/ops/fused_unit.py:483"),
    "fu_c3_bwd4d": ("c3_bwd4d", "mxnet_tpu/ops/fused_unit.py:568"),
    "nn_conv1x1_bwd": ("conv1x1_bwd", "mxnet_tpu/ops/nn.py:212"),
    "cache_write_row": ("cache_write_row", "mxnet_tpu/ops/cache.py:84"),
    "cache_write_rows": ("cache_write_rows", "mxnet_tpu/ops/cache.py:163"),
    "rtc_add_one": ("CudaKernel", "mxnet_tpu/rtc.py:23"),
}
FWD_WRAPPERS = ("mm_fwd", "c3_fwd2d", "c3_fwd4d", "mm_skip_fwd")
# the loop each fused-unit and 1x1 kernel runs on (mxnet_tpu_torch/csrc/)
_LOOPS = dict.fromkeys(("fu_mm_fwd", "fu_mm_skip_fwd", "fu_c3_fwd2d",
                        "fu_mm_bwd", "fu_c3_bwd2d", "nn_conv1x1_bwd"),
                       "fu_mma.cuh, tensor cores")
_LOOPS.update(dict.fromkeys(("fu_c3_fwd4d", "fu_c3_bwd4d"),
                            "fu_halo.cuh, tensor cores, resident halo"))


def kernel_table(rows, bwd_rows, kv_rows, serve, train, bench, imagenet,
                 decode, imp, rtc, gluon, rnn, ssd, serving):
    """One entry per kernel.  K1-K4: times per ResNet-50 forward at batch
    8 (each stage's shape weighted by its number of fused units) and
    launches in the serve phase of their mode (K4: 4d); K5-K8: times per
    training step at batch 32 and launches in the train phase of their
    mode (K7: 4d); K9, K10: times of one launch at the decode engine's
    shape (8 slots, max_len 128, d 200) and launches in the decode runs
    at k = 0, 2 and 4 together; K11: one add_one launch over 16M float32
    and launches in the rtc phase.  All float32; errors are the largest
    over the shapes.  Every entry also gives its launches per serve batch
    and training step in both modes, per bf16 step of bench.py's (each
    config of the bench phase), in each ImageNet fit (4 steps and 2
    validation batches; plain and fused) with the fused fit's errors
    against the plain versions, per decode step, per imperative unit and
    in the rtc phase, in the gluon phase's SymbolBlock runs (a serve
    forward in each 3x3 mode and a training step), in the rnn and ssd
    phases (none) and in each run of the serving phase
    (``launches_in_serving_phase``); K1-K8 also their
    bfloat16 times (kernel, library
    and bound) at the same shapes, and K2-K8 their kernel and library
    times in both dtypes with the L2 cache flushed before each call; K1-K8
    name the tensor-core loop they run on (``loop``)."""
    table = []
    for name, (wrapper, replaces) in _SOURCES.items():
        decode_launches = sum(r["launches"][wrapper]
                              for r in decode["runs"].values())
        per_decode = {name: r["launches"][wrapper] / r["steps"]
                      for name, r in decode["runs"].items()}
        source = "mxnet_tpu_torch/csrc/%s.cu" % name
        if wrapper == "CudaKernel":
            source = "mxnet_tpu_torch/rtc.py"
            entry = {"launches": rtc["launches"][wrapper],
                     "per": "one add_one launch, %d float32" % rtc["n"],
                     "kernel_source": "chip_smoke.py RTC_SOURCE"}
            entry.update((k, rtc[k]) for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"))
        elif wrapper in ("cache_write_row", "cache_write_rows"):
            sel = [r for r in kv_rows if r["kernel"] == wrapper]
            main = [r for r in sel if r["slots"] == DECODE_SLOTS
                    and r["T"] == DECODER["max_len"]
                    and r["dtype"] == "float32"][0]
            long_t = [r for r in sel if r["slots"] == DECODE_SLOTS
                      and r["T"] == max(KV_T)
                      and r["dtype"] == "float32"][0]
            entry = {
                "launches": decode_launches,
                "per": "one launch, %d slots, max_len %d, d %d, float32"
                       % (DECODE_SLOTS, DECODER["max_len"], DECODER["d"]),
                "max_abs_err": max(r["max_abs_err"] for r in sel),
                "ms": main["ms"], "plain_ms": main["plain_ms"],
                "bound_ms": main["bound_ms"], "bound_by": "bytes",
                "library_ms": main["library_ms"],
                "blend_ms": main["blend_ms"],
                "ms_max_len_%d" % max(KV_T): long_t["ms"],
                "blend_ms_max_len_%d" % max(KV_T): long_t["blend_ms"],
            }
        else:
            fwd = wrapper in FWD_WRAPPERS
            mode = "4d" if wrapper in ("c3_fwd4d", "c3_bwd4d") else "2d"
            if fwd:
                every = [r for r in rows if r["kernel"] == name
                         and not r["variant"]]
                weight = "units_per_forward"
                run = serve[mode]
            else:
                every = [r for r in bwd_rows if r["kernel"] == name]
                weight = "units_per_step"
                run = train if mode == "2d" else train["4d"]
            sel = [r for r in every if r["dtype"] == "float32"]
            sel16 = [r for r in every if r["dtype"] == "bfloat16"]

            def total(key, rs=sel):
                return sum(r[key] * r[weight] for r in rs)
            ops = total("flops") / PEAK_FLOPS["float32"]
            mem = total("bytes") / HBM_BYTES_S
            entry = {
                "launches": run["launches"][wrapper],
                "per": ("serve forward, batch 8" if fwd
                        else "train step, batch 32")
                + (", MXNET_FUSED_UNIT_C3=4d" if mode == "4d" else ""),
                "max_abs_err": max(r["max_abs_err"] for r in sel),
                "ms": total("ms"), "plain_ms": total("plain_ms"),
                "bound_ms": total("bound_ms"),
                "bound_by": "operations" if ops >= mem else "bytes",
                "library_ms": total("library_ms"),
                "bf16_ms": total("ms", sel16),
                "bf16_library_ms": total("library_ms", sel16),
                "bf16_bound_ms": total("bound_ms", sel16),
            }
            if "ms_l2_flushed" in sel[0]:
                entry.update((pre + key, total(key, rs)) for pre, rs in (
                    ("", sel), ("bf16_", sel16)) for key in (
                        "ms_l2_flushed", "library_ms_l2_flushed"))
            entry["loop"] = _LOOPS[name]
        table.append(dict({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches_per_serve_batch":
                serve["2d"]["launches"][wrapper] / serve["2d"]["batches"],
            "launches_per_serve_batch_4d":
                serve["4d"]["launches"][wrapper] / serve["4d"]["batches"],
            "launches_per_train_step":
                train["launches"][wrapper] / train["steps"],
            "launches_per_train_step_4d":
                train["4d"]["launches"][wrapper] / train["steps"],
            "launches_per_bench_step": {
                cfg: r["launches"][wrapper] / (BENCH_WARMUP + BENCH_STEPS)
                for cfg, r in bench["configs"].items()},
            "bench_rel_errs": {
                cfg: r["kernel_rel_errs"][wrapper]["rel_errs"]
                for cfg, r in bench["configs"].items()
                if wrapper in r["kernel_rel_errs"]},
            "launches_in_imagenet_fit": {
                impl: r["launches"][wrapper]
                for impl, r in imagenet["fits"].items()},
            "imagenet_fit_f64_errs": {
                k: imagenet["fits"]["fused"]["kernel_rel_errs"][wrapper][k]
                for k in ("kernel_f64", "plain_f64")}
            if wrapper in imagenet["fits"]["fused"]["kernel_rel_errs"]
            else None,
            "launches_per_decode_step": per_decode,
            "launches_per_imperative_unit":
                imp["launches"][wrapper] / imp["units"],
            "launches_in_rtc_phase": rtc["launches"][wrapper],
            "launches_in_gluon_phase": gluon["launches"][wrapper],
            "launches_in_rnn_phase": rnn["launches"][wrapper],
            "launches_in_ssd_phase": ssd["launches"][wrapper],
            "launches_in_serving_phase": {
                run: launches[wrapper]
                for run, launches in serving["launches"].items()}},
            **entry))
    return table


def fmt_opt(v):
    return "n/a" if v is None else "%.4f" % v


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--train-steps", type=int, default=6)
    ap.add_argument("--json", metavar="PATH",
                    help="also write every measurement to this file")
    ap.add_argument("--phase", type=int, choices=range(4, 19),
                    metavar="N",
                    help="run phases 1-3 and then phase N alone (4-18; "
                         "16 and 17 also run phase 9, whose decoder they "
                         "read); no kernel table")
    opts = ap.parse_args()
    if opts.train_steps < 2:
        sys.exit("chip_smoke: --train-steps must be at least 2")

    def want(n):
        return opts.phase is None or opts.phase == n

    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA card is visible; this script runs on "
                 "the card only")
    if not os.path.isdir(os.path.join(ROOT, "mxnet_tpu_torch")):
        sys.exit("chip_smoke: run it from a checkout that holds the "
                 "mxnet_tpu_torch package")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import cuda_build
    from mxnet_tpu_torch.ops import cache as kv
    from mxnet_tpu_torch.ops import fused_unit as fu
    from mxnet_tpu_torch.ops import nn

    t_start = time.perf_counter()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log("[1] card: %s | torch %s, CUDA %s, %s" % (
        card, torch.__version__, torch.version.cuda, name))

    t0 = time.perf_counter()
    cuda_build.build()
    build_s = time.perf_counter() - t0
    log("[2] kernels built in %.2f s" % build_s)
    for kname, (secs, out) in sorted(cuda_build.build_log.items()):
        log("  %s: nvcc %.2f s" % (kname, secs))
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log("    " + line.strip())

    log("[3] kernels against their plain versions: forward at batch %d, "
        "backward at batch %d" % (BATCH, TRAIN_BATCH))
    device = torch.device("cuda", 0)
    rows = kernel_phase(torch, fu, device, opts.seed)
    bwd_rows = bwd_kernel_phase(torch, fu, nn, device, opts.seed)

    serve = {}
    for mode in ("2d", "4d") if want(4) else ():
        log("[4%s] serve ResNet-50 224x224 from a checkpoint on %s, the "
            "units' 3x3 %s" % ("a" if mode == "2d" else "b", name,
                               "in the row layout (K3)" if mode == "2d"
                               else "on 4D tiles (K4, "
                               "MXNET_FUSED_UNIT_C3=4d)"))
        with c3_mode("4d" if mode == "4d" else "auto"):
            sv = serve[mode] = serve_phase(torch, mt, fu, nn, kv, opts.seed,
                                           opts.requests, opts.clients,
                                           mode)
        log("  %d requests from %d clients in %d batches (occupancy %.3f): "
            "latency p50 %.2f ms, p99 %.2f ms, max %.2f ms, %.1f images/s; "
            "max |prob - plain| %.3g; launches %s [%s]" % (
                sv["requests"], sv["clients"], sv["batches"],
                sv["batch_occupancy"], sv["latency_p50_ms"],
                sv["latency_p99_ms"], sv["latency_max_ms"],
                sv["images_per_s"], sv["max_abs_err"], sv["launches"], card))
        steady, prof = sv["steady"], sv["profile_batch8"]
        log("  same traffic again: %d batches, latency p50 %.2f ms, p99 %.2f "
            "ms, max %.2f ms, %.1f images/s [%s]" % (
                steady["batches"], steady["latency_p50_ms"],
                steady["latency_p99_ms"], steady["latency_max_ms"],
                steady["images_per_s"], card))
        log_profile("one batch-8 forward, %s" % mode, prof, card)

    train = bench = imagenet = kv_rows = decode = imp = rtc = mnist = None
    gluon = rnn = ssd = analysis = serving = telemetry = None
    if want(5):
        log("[5] train ResNet-50 224x224 through Module.fit on %s, batch "
            "%d, %d steps, the units' 3x3 in the row layout (K3/K6) and on "
            "4D tiles (K4/K7)" % (name, TRAIN_BATCH, opts.train_steps))
        train = train_phase(torch, mt, fu, nn, kv, opts.seed,
                            opts.train_steps, card)

    if want(6):
        log("[6] bench.py's step: ResNet-50 224x224 in bfloat16 at batch "
            "%d through bench_step.TrainStep on %s, stem fused, %s"
            % (BENCH_BATCH, name, ", ".join(BENCH_CONFIGS)))
        bench = bench_phase(torch, mt, fu, nn, kv, opts.seed, card)

    if want(7):
        log("[7] examples/train_imagenet.py: ImageRecordIter over raw "
            "records and Module.fit of ResNet-50 224x224 in f32 at batch %d "
            "on %s, unit_impl plain and fused; bench.py's step fed by the "
            "pipeline" % (IMAGENET_BATCH, name))
        imagenet = imagenet_phase(torch, mt, fu, nn, kv, opts.seed, card)

    if want(8):
        log("[8] K9/K10 against their plain versions: slots %s, max_len "
            "%s, d %d, window %d" % (KV_SLOTS, KV_T, DECODER["d"],
                                     KV_WINDOW))
        kv_rows = kv_phase(torch, kv, device, opts.seed)

    if want(9) or opts.phase in (16, 17):
        log("[9] decode: the attention decoder (vocab %d, d %d, %d blocks, "
            "max_len %d) through DecodeEngine on %s, %d slots, %d requests, "
            "k = 0, %s" % (DECODER["vocab"], DECODER["d"],
                           DECODER["layers"], DECODER["max_len"], name,
                           DECODE_SLOTS, DECODE_REQUESTS,
                           ", ".join(map(str, SPEC_KS))))
        decode = decode_phase(torch, mt, fu, nn, kv, opts.seed, card)

    if want(10):
        log("[10] the imperative path: mt.nd._contrib_FusedBottleneckUnit "
            "at the four stage shapes at batch %d under autograd.record(), "
            "4d, against the Executor" % TRAIN_BATCH)
        imp = imperative_phase(torch, mt, fu, nn, kv, opts.seed, card)

    if want(11):
        log("[11] rtc: CUDA C++ written at run time through rtc.CudaModule "
            "and register_kernel_op")
        rtc = rtc_phase(torch, mt, fu, nn, kv, opts.seed, card)

    if want(12):
        log("[12] examples/train_mnist.py: LeNet through Module.fit on %s, "
            "batch %d, every optimizer against the port on the CPU, a "
            "resumed checkpoint, a Monitor" % (name, MNIST_BATCH))
        mnist = mnist_phase(torch, mt, fu, nn, kv, opts.seed, card)

    if want(13):
        log("[13] Gluon: model_zoo %s (%d classes, %dx%d NCHW) trained "
            "imperatively and hybridized on %s at batch %d; the fused "
            "symbolic ResNet-50 as a SymbolBlock"
            % (GLUON_FAMILY, GLUON_CLASSES, GLUON_IMAGE, GLUON_IMAGE, name,
               GLUON_BATCH))
        gluon = gluon_phase(torch, mt, fu, nn, kv, opts.seed, card)

    if want(14):
        log("[14] RNN: examples/rnn_ptb.py's bucketed LSTM (hidden %d, "
            "embed %d, %d layers, batch %d, buckets %s) through "
            "BucketingModule on %s; PTB's vocabulary (%d) through the fused "
            "RNN op; gluon.rnn.LSTM" % (RNN_HIDDEN, RNN_EMBED, RNN_LAYERS,
                                        RNN_BATCH, RNN_BUCKETS, name,
                                        PTB_VOCAB))
        t0 = time.perf_counter()
        rnn = rnn_phase(torch, mt, fu, nn, kv, opts.seed, card)
        rnn["phase_s"] = time.perf_counter() - t0
        log("  phase 14 took %.1f s" % rnn["phase_s"])

    if want(15):
        log("[15] SSD: examples/train_ssd.py's %s (%d classes, %dx%d, batch "
            "%d) through io.ImageDetRecordIter and Module.fit on %s; the "
            "card's step against the CPU's; the detect graph through "
            "Predictor" % (SSD_NETWORK, SSD_CLASSES, SSD_IMAGE, SSD_IMAGE,
                           SSD_BATCH, name))
        t0 = time.perf_counter()
        ssd = ssd_phase(torch, mt, fu, nn, kv, opts.seed, card)
        ssd["phase_s"] = time.perf_counter() - t0
        log("  phase 15 took %.1f s" % ssd["phase_s"])

    if want(16):
        log("[16] analysis: the verifier, shapes, retrace, padding, FLOP "
            "and memory passes and the optimizer, through ServingEngine "
            "(ResNet-50 224x224, fused units) and DecodeEngine (phase 9's "
            "decoder) on %s" % name)
        analysis = analysis_phase(torch, mt, fu, nn, kv, opts.seed, card,
                                  decode)

    if want(17):
        log("[17] the rest of serving on %s: ResNet-50 under shed-oldest, "
            "the pad probe and the memory preflight; sequence buckets (the "
            "LSTM LM at PTB's widths, the seq softmax's masking repair); "
            "the decoder under TemperatureSampler at k = 0, %s; bucketed "
            "prefill" % (name, ", ".join(map(str, SPEC_KS))))
        serving = serving_phase(torch, mt, fu, nn, kv, opts.seed, card,
                                decode)

    if want(18):
        log("[18] telemetry on %s: the fused ResNet-50 served with the "
            "HTTP server on port 0 and every route scraped; phase 5's fit "
            "with its step phases and MFU; phase 9's decoder at k = %s; a "
            "torch.profiler capture and dump_profile(); telemetry on "
            "against off" % (name, ", ".join(map(str, TELEMETRY_KS))))
        telemetry = telemetry_phase(torch, mt, fu, nn, kv, opts.seed, card)

    table = None
    if opts.phase is None:
        table = kernel_table(rows, bwd_rows, kv_rows, serve, train, bench,
                             imagenet, decode, imp, rtc, gluon, rnn, ssd,
                             serving)
    if opts.json:
        os.makedirs(os.path.dirname(os.path.abspath(opts.json)),
                    exist_ok=True)
        with open(opts.json, "w") as f:
            json.dump({"card": card, "device": name,
                       "torch": torch.__version__, "cuda": torch.version.cuda,
                       "build_s": build_s, "kernel_rows": rows,
                       "bwd_kernel_rows": bwd_rows, "serve": serve,
                       "train": train, "bench": bench,
                       "imagenet": imagenet,
                       "kv_rows": kv_rows,
                       "decode": decode, "imperative": imp, "rtc": rtc,
                       "mnist": mnist, "gluon": gluon, "rnn": rnn,
                       "ssd": ssd, "analysis": analysis,
                       "serving": serving, "telemetry": telemetry,
                       "kernels": table,
                       "seconds": time.perf_counter() - t_start}, f, indent=1)
    log("[19] done in %.1f s" % (time.perf_counter() - t_start))
    log(card)
    if table is not None:
        log(json.dumps({"kernels": table}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


# phase 16: the static-analysis core and the gates it drives
ANALYSIS_IMAGE = 224
ANALYSIS_SERVE_BATCH = 32
ANALYSIS_FLOP_BATCH = 256
ANALYSIS_FLOP_RTOL = 0.10       # the JAX package's bar against XLA


def analysis_serve(torch, mt, wrappers, sym, args, aux, xs, optimize):
    """``xs`` as one batch through a ServingEngine on cuda:0 (max_batch
    len(xs)) with MXNET_SERVE_OPTIMIZE on or off; the launch counters are
    set to 0 just before the requests and read after.  Returns (outputs,
    engine, launches, stats, peak allocated bytes from before the
    engine's parameters to after the batch); fails when the optimizer
    is on and the engine did not adopt an accepted plan (a crash or a
    rejection serves the unoptimized graph with a warning)."""
    import warnings
    import numpy as np
    with env_vars({"MXNET_SERVE_OPTIMIZE": "1" if optimize else "0",
                   "MXNET_ANALYSIS_STRICT": None}):
        targs, taux = mt.convert.params_from_numpy(args, aux,
                                                   device=mt.cpu())
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            eng = mt.ServingEngine(sym, targs, taux, {"data": xs.shape[1:]},
                                   ctx=mt.gpu(0),
                                   policy=mt.serving.BucketPolicy(len(xs)),
                                   batch_timeout_ms=1000.0, start=False)
        try:
            failed = [str(w.message) for w in caught
                      if "optimization crashed" in str(w.message)
                      or "optimization rejected" in str(w.message)]
            plan = eng.opt_plan
            if optimize and (failed or plan is None or not plan.accepted):
                raise AssertionError("the engine served the unoptimized "
                                     "graph: plan %s, warnings %s" % (
                                         plan and plan.reason, failed))
            for w in wrappers:
                w.launches = 0
            futs = [eng.submit(x) for x in xs]
            eng.start()
            outs = np.stack([f.result(timeout=600) for f in futs])
            launches = {w.__name__: w.launches for w in wrappers}
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            st = eng.stats()
        finally:
            eng.close()
    return outs, eng, launches, st, peak


def folding_head(mt, classes=1000, features=2048):
    """ResNet-50's classifier over its pooled features, planted with what
    the default passes rewrite: a per-class scale built from creation ops
    (``exp`` of a ramp, plus zeros: ``algebraic`` drops the add, ``fold``
    bakes the rest on the engine's device, ``dce`` sweeps the ramp) and
    the same ``tanh`` twice (``cse`` merges them)."""
    S = mt.sym
    fc = S.FullyConnected(S.Variable("data"), num_hidden=classes, name="fc")
    ramp = S.reshape(S._arange(start=0, stop=classes), shape=(1, classes))
    scale = S.exp(ramp * -0.003, name="scale") + S.zeros((1, classes))
    both = S.tanh(fc, name="t1") + S.tanh(fc, name="t2")
    return S.softmax(S.broadcast_mul(both, scale), axis=-1, name="prob")


def analysis_fold(torch, mt, wrappers, seed, card):
    """(a), second graph: ``folding_head`` served with the optimizer on
    and off.  The plan must fold, merge and sweep, the two runs' bits
    must agree, and the baked constant must be the card's ``exp``; the
    count of its elements that a fold on the CPU would have moved is
    printed."""
    import numpy as np
    sym = folding_head(mt)
    rng = np.random.default_rng(seed + 7)
    args = {"fc_weight": (rng.standard_normal((1000, 2048)) * 0.02)
            .astype(np.float32),
            "fc_bias": np.zeros(1000, np.float32)}
    xs = rng.standard_normal((ANALYSIS_SERVE_BATCH, 2048)).astype(np.float32)
    runs = {}
    for optimize in (True, False):
        outs, eng, launches, st, _peak = analysis_serve(
            torch, mt, wrappers, sym, args, {}, xs, optimize)
        runs[optimize] = outs
        if any(launches.values()) or st["batches"] != 1 \
                or eng._verdicts != {"batch": "row-local"}:
            raise AssertionError("folding head: launches %s, %d batches, "
                                 "verdicts %s" % (launches, st["batches"],
                                                  eng._verdicts))
        if optimize:
            plan, served = eng.opt_plan, eng.served_sym
    kinds = sorted({a.pass_name for a in plan.actions} - {"fuse"})
    if kinds != ["algebraic", "cse", "dce", "fold"]:
        raise AssertionError("folding head: the plan rewrote by %s" % kinds)
    if not np.array_equal(runs[True], runs[False]):
        raise AssertionError("folding head: the optimizer changed the "
                             "served bits")

    def baked(graph):
        node = next(n for n in mt.symbol.symbol._topo(graph._outputs)
                    if n.op is not None and n.op.name == "_constant")
        return np.asarray(node.attrs["value"], np.float32)
    on_card = baked(served)
    ramp = torch.arange(0, 1000, dtype=torch.float32)
    want = torch.exp(ramp.to(mt.gpu(0).device) * -0.003).cpu().numpy()
    if not np.array_equal(on_card, want):
        raise AssertionError("folding head: the baked scale is not the "
                             "card's exp")
    cpu_plan = mt.analysis.optimize_graph(
        sym, data_shapes={"data": xs.shape}, device="cpu")
    moved = int((baked(cpu_plan.symbol) != on_card).sum())
    out = {"rewrites": len(plan.rewrites), "passes": kinds,
           "nodes": [plan.nodes_before, plan.nodes_after],
           "cpu_fold_would_move": moved}
    log("  folding head, %d requests: plan %d -> %d nodes by %s, the "
        "scale baked on the card (a fold on the CPU would move %d of its "
        "1000 values); probabilities equal bit for bit, optimizer on and "
        "off [%s]" % (len(xs), plan.nodes_before, plan.nodes_after,
                      ", ".join(kinds), moved, card))
    return out


def analysis_flops(torch, mt, seed, card):
    """(c) and half of (d): count_flops of the plain ResNet-50 step beside
    FlopCounterMode over one eager step on the card, and the step's
    predicted peak beside its measured one."""
    import numpy as np
    from torch.utils.flop_counter import FlopCounterMode
    side, batch = ANALYSIS_IMAGE, ANALYSIS_FLOP_BATCH
    sym = mt.models.get_resnet_symbol(
        num_classes=1000, num_layers=50, image_shape=(3, side, side),
        layout="NHWC", stem="conv7", unit_impl="plain")
    shapes = {"data": (batch, side, side, 3), "softmax_label": (batch,)}
    t0 = time.perf_counter()
    flops = mt.analysis.count_flops(sym, shapes, training=True)
    count_s = time.perf_counter() - t0
    step = mt.bench_step.TrainStep(sym, dtype=torch.bfloat16, lr=BENCH_LR)
    dtypes = {n: "bfloat16" for n in step.param_names + ["data"]}
    predicted = mt.analysis.predict_peak_bytes(sym, shapes, dtypes=dtypes,
                                               training=True)
    args, aux = mt.convert.random_params(sym, {"data": (1, side, side, 3)},
                                         seed=seed)
    dev = mt.gpu(0).device
    rng = np.random.default_rng(seed + 5)
    u8 = torch.from_numpy(rng.integers(0, 256, shapes["data"],
                                       dtype=np.uint8)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 1000, batch)
                              .astype(np.float32)).to(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = tuple(torch.from_numpy(args[n]).to(dev, torch.bfloat16)
                   for n in step.param_names)
    auxs = tuple(torch.from_numpy(aux[n]).to(dev) for n in step.aux_names)
    with FlopCounterMode(display=False) as counter:
        loss, grads, params, auxs = step(u8, labels, params, auxs)
        torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated()
    counted = counter.get_total_flops()
    if not bool(torch.isfinite(loss)):
        raise AssertionError("the plain step's loss is not finite")
    del grads, params, auxs
    torch.cuda.empty_cache()
    gap = (flops["total"] - counted) / counted
    log("  FLOPs of one training step, batch %d: count_flops %.4f "
        "GFLOP (fwd %.4f, bwd %.4f, %.4f modeled, %.2f s to count), "
        "FlopCounterMode %.4f GFLOP, count/counter - 1 = %+.4f (limit "
        "%.2f) [%s]" % (batch, flops["total"] / 1e9, flops["fwd"] / 1e9,
                        flops["bwd"] / 1e9, flops["modeled_fraction"],
                        count_s, counted / 1e9, gap, ANALYSIS_FLOP_RTOL,
                        card))
    if abs(gap) > ANALYSIS_FLOP_RTOL:
        raise AssertionError("count_flops %.4g against FlopCounterMode "
                             "%.4g" % (flops["total"], counted))
    return {"batch": batch, "count_flops_gflop": flops["total"] / 1e9,
            "fwd_gflop": flops["fwd"] / 1e9, "bwd_gflop": flops["bwd"] / 1e9,
            "modeled_fraction": flops["modeled_fraction"],
            "flop_counter_gflop": counted / 1e9, "gap": gap,
            "count_s": count_s,
            "memory": {"predicted_bytes": predicted,
                       "measured_bytes": measured,
                       "ratio": measured / predicted}}


def slot_mixing_step(mt, vocab=16, d=8):
    """A decode step whose next state adds every slot's state: a planted
    cross-position step."""
    import numpy as np
    tok, s = mt.sym.Variable("token"), mt.sym.Variable("s")
    emb = mt.sym.Embedding(tok, input_dim=vocab, output_dim=d, name="emb")
    s2 = mt.sym.broadcast_add(s + emb, mt.sym.sum(s, axis=0, keepdims=True),
                              name="mix")
    logits = mt.sym.FullyConnected(s2, num_hidden=vocab, name="out_fc")
    rng = np.random.default_rng(0)
    params = {"emb_weight": rng.standard_normal((vocab, d)),
              "out_fc_weight": rng.standard_normal((vocab, d)),
              "out_fc_bias": np.zeros(vocab)}
    params = mt.convert.params_from_numpy(
        {k: v.astype(np.float32) for k, v in params.items()}, {},
        device=mt.gpu(0))[0]
    return mt.sym.Group([logits, s2]), params, [{"name": "s",
                                                 "shape": (d,)}]


def analysis_faults(torch, mt, seed, card):
    """(e): the planted faults the gates must catch."""
    import warnings
    import numpy as np
    mix = mt.sym.softmax(mt.sym.Variable("data"), axis=0, name="mix")
    policy = mt.serving.BucketPolicy(8)
    out = {}
    with env_vars({"MXNET_ANALYSIS_STRICT": "1"}):
        try:
            mt.ServingEngine(mix, {}, {}, {"data": (16,)}, ctx=mt.gpu(0),
                             policy=policy, start=False).close()
            out["serve_strict_raised"] = False
        except mt.analysis.AnalysisError as e:
            out["serve_strict_raised"] = "[padding]" in str(e)
        step, params, info = slot_mixing_step(mt)
        try:
            mt.serving.DecodeEngine(step, params, {}, info, num_slots=4,
                                    max_len=8, ctx=mt.gpu(0),
                                    start=False).close()
            out["decode_strict_raised"] = False
        except mt.analysis.AnalysisError as e:
            out["decode_strict_raised"] = "SLOT axis" in str(e)
    with env_vars({"MXNET_ANALYSIS_STRICT": None}), \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng = mt.ServingEngine(mix, {}, {}, {"data": (16,)}, ctx=mt.gpu(0),
                               policy=policy, batch_timeout_ms=50.0,
                               start=False)
    try:
        xs = np.random.default_rng(seed + 6).standard_normal(
            (8, 16)).astype(np.float32)
        futs = [eng.submit(x) for x in xs]
        eng.start()
        got = np.stack([f.result(timeout=120) for f in futs])
        st = eng.stats()
    finally:
        eng.close()
    pred = mt.Predictor(mix, {}, {}, {"data": (1, 16)}, ctx=mt.gpu(0))
    want = np.stack([pred.forward(data=x[None]).get_output(0)[0]
                     for x in xs])
    out["serve_warned"] = any("max_batch=1" in str(w.message)
                              for w in caught)
    out["serve_max_batch"] = st["max_batch"]
    out["serve_batches"] = st["batches"]
    out["serve_equals_predictor"] = bool(np.array_equal(got, want))
    log("  planted faults: softmax over the batch axis under strict "
        "raised %s; without strict warned %s, max_batch %d, %d batches for "
        "%d requests, answers equal a batch-1 Predictor's %s; a slot-mixing "
        "decode step under strict raised %s [%s]" % (
            out["serve_strict_raised"], out["serve_warned"],
            out["serve_max_batch"], out["serve_batches"], len(xs),
            out["serve_equals_predictor"], out["decode_strict_raised"],
            card))
    if not (out["serve_strict_raised"] and out["decode_strict_raised"]
            and out["serve_warned"] and out["serve_max_batch"] == 1
            and out["serve_batches"] == len(xs)
            and out["serve_equals_predictor"]):
        raise AssertionError("a planted fault got through: %s" % out)
    return out


def analysis_phase(torch, mt, fu, nn, kv, seed, card, decode):
    """Phase 16 (see the module docstring): (a)-(e); ``decode`` is phase
    9's result, whose runs hold (b)."""
    import numpy as np
    t_phase = time.perf_counter()
    wrappers = kernel_wrappers(fu, nn, kv)
    side, batch = ANALYSIS_IMAGE, ANALYSIS_SERVE_BATCH
    sym = mt.models.get_resnet_symbol(
        num_classes=1000, num_layers=50, image_shape=(3, side, side),
        layout="NHWC", unit_impl="fused")
    n_fused = sym.tojson().count('"_contrib_FusedBottleneckUnit"')
    args, aux = mt.convert.random_params(sym, {"data": (1, side, side, 3)},
                                         seed=seed)
    xs = np.random.default_rng(seed + 4).standard_normal(
        (batch, side, side, 3)).astype(np.float32)
    out = {"serve": {}}
    runs = {}
    for optimize in (True, False):
        t0 = time.perf_counter()
        outs, eng, launches, st, peak = analysis_serve(
            torch, mt, wrappers, sym, args, aux, xs, optimize)
        name = "optimizer on" if optimize else "optimizer off"
        runs[name] = outs
        report = eng.analysis_report
        plan = eng.opt_plan
        counts = {sev: len(report.by_severity(sev))
                  for sev in ("error", "warning", "info")}
        want = {k: n_fused * st["batches"] if k in SERVE_KERNELS["2d"]
                else 0 for k in launches}
        if launches != want or st["batches"] != 1:
            raise AssertionError("%s: launches %s in %d batches, not %s"
                                 % (name, launches, st["batches"], want))
        if eng._verdicts != {"batch": "row-local"}:
            raise AssertionError("%s: the batch verdict is %s"
                                 % (name, eng._verdicts))
        if not (np.isfinite(outs).all() and outs.shape == (batch, 1000)):
            raise AssertionError("%s: outputs %s" % (name, outs.shape))
        out["serve"][name] = {
            "verdicts": dict(eng._verdicts), "report": counts,
            "plan": None if plan is None else {
                "accepted": plan.accepted, "reason": plan.reason,
                "rewrites": len(plan.rewrites),
                "actions": [list(a) for a in plan.actions],
                "nodes": [plan.nodes_before, plan.nodes_after]},
            "launches": {k: v for k, v in launches.items() if v},
            "batches": st["batches"], "peak_bytes": peak,
            "engine_s": time.perf_counter() - t0}
        log("  serve, %s: batch verdict %s; report %s; %d batch, launches "
            "%s; peak allocated %s [%s]" % (
                name, eng._verdicts["batch"], counts, st["batches"],
                {k: v for k, v in launches.items() if v},
                mt.analysis.memory.format_bytes(peak), card))
        if plan is not None:
            for line in plan.describe().splitlines():
                log("    " + line)
    if not np.array_equal(runs["optimizer on"], runs["optimizer off"]):
        raise AssertionError("the optimizer changed the served bits")
    np.testing.assert_allclose(runs["optimizer on"].sum(1), 1.0, rtol=1e-4)
    predicted = mt.analysis.predict_peak_bytes(
        sym, {"data": (batch, side, side, 3)})
    measured = out["serve"]["optimizer on"]["peak_bytes"]
    out["serve"]["memory"] = {"predicted_bytes": predicted,
                              "measured_bytes": measured,
                              "ratio": measured / predicted}
    log("  served probabilities equal bit for bit, optimizer on and off")
    out["fold"] = analysis_fold(torch, mt, wrappers, seed, card)

    # (b): phase 9 served the decoder through the gated pipeline and
    # held its verdicts, selections, launches and streams
    out["decode"] = {name: run["analysis"]
                     for name, run in decode["runs"].items()}
    log("  (b) decode, from phase 9: %s" % "; ".join(
        "%s: verdicts %s/%s, %d rewrites, %d selections" % (
            name, a["step_verdict"], a["draft_verdict"], a["rewrites"],
            a["selection"]) for name, a in out["decode"].items()))

    log("  (c) FLOPs and (d) memory")
    out["flops"] = analysis_flops(torch, mt, seed, card)
    budget = mt.analysis.device_memory_budget()
    total = torch.cuda.get_device_properties(0).total_memory
    if not budget or budget > total:
        raise AssertionError("device_memory_budget %s, card %d"
                             % (budget, total))
    out["memory"] = {"serve_forward": out["serve"]["memory"],
                     "train_step": out["flops"]["memory"],
                     "device_budget_bytes": budget,
                     "device_total_bytes": total}
    for what, m in (("serve forward, batch %d, f32" % batch,
                     out["serve"]["memory"]),
                    ("plain training step, batch %d, bf16"
                     % ANALYSIS_FLOP_BATCH, out["flops"]["memory"])):
        log("  memory, %s: predict_peak_bytes %s, max_memory_allocated %s, "
            "measured / predicted %.3f [%s]" % (
                what, mt.analysis.memory.format_bytes(m["predicted_bytes"]),
                mt.analysis.memory.format_bytes(m["measured_bytes"]),
                m["ratio"], card))
    log("  device_memory_budget %s of %s [%s]" % (
        mt.analysis.memory.format_bytes(budget),
        mt.analysis.memory.format_bytes(total), card))

    log("  (e) planted faults")
    out["faults"] = analysis_faults(torch, mt, seed, card)
    out["phase_s"] = time.perf_counter() - t_phase
    log("  phase 16 took %.1f s" % out["phase_s"])
    log(json.dumps({"analysis": {
        "serve": {k: {"verdicts": v["verdicts"], "report": v["report"],
                      "rewrites": v["plan"] and v["plan"]["rewrites"],
                      "launches": v["launches"]}
                  for k, v in out["serve"].items() if k != "memory"},
        "fold": out["fold"], "decode": out["decode"],
        "flops": {k: v for k, v in out["flops"].items() if k != "memory"},
        "memory": out["memory"], "faults": out["faults"],
        "phase_s": out["phase_s"]}}))
    return out


# phase 17: the rest of serving
SERVING_IMAGE = 224
SHED_REQUESTS, SHED_MAX_QUEUE = 32, 4
PROBE_REQUESTS = 5
LM = dict(vocab=10000, embed=200, hidden=200, layers=2)
LM_BUCKETS = (10, 20, 30, 40)       # examples/rnn_ptb.py --buckets
LM_MAX_BATCH, LM_REQUESTS, LM_LENGTHS = 8, 32, (3, 40)
LM_TOL = 1e-6                       # of the largest probability
SEQ_SOFTMAX_WIDTH = 200
SAMPLER = dict(temperature=0.8, top_k=40)
SAMPLING_REQUESTS = 32
PREFILL_MODEL = dict(vocab=10000, d=200)
PREFILL_REQUESTS, PREFILL_PROMPTS, PREFILL_NEW = 32, (4, 24), (4, 16)


def counted(wrappers, fn):
    """``fn()`` with every launch counter set to 0 just before and read
    just after; returns (its result, {kernel: launches})."""
    for w in wrappers:
        w.launches = 0
    out = fn()
    return out, {w.__name__: w.launches for w in wrappers}


def _no_launches(what, launches):
    if any(launches.values()):
        raise AssertionError("%s launched %s" % (
            what, {k: v for k, v in launches.items() if v}))


def _fused_launches(what, launches, dispatches, n_fused):
    """K1-K3 launch once per fused unit (12 in ResNet-50) per dispatch,
    nothing else runs."""
    want = {k: n_fused * dispatches if k in SERVE_KERNELS["2d"] else 0
            for k in launches}
    if launches != want:
        raise AssertionError("%s: launches %s for %d dispatches, not %s"
                             % (what, launches, dispatches, want))


def serving_resnet(torch, mt, fu, nn, wrappers, seed, card):
    """(a): the fused ResNet-50 of phase 4 under shed-oldest, through the
    pad probe, and its memory preflight beside the allocator."""
    import numpy as np
    side = SERVING_IMAGE
    shape = (side, side, 3)
    sym = mt.models.get_resnet_symbol(
        num_classes=1000, num_layers=50, image_shape=(3, side, side),
        layout="NHWC", unit_impl="fused")
    n_fused = sym.tojson().count('"_contrib_FusedBottleneckUnit"')
    args, aux = mt.convert.random_params(sym, {"data": (1,) + shape},
                                         seed=seed)
    xs = np.random.default_rng(seed + 17).standard_normal(
        (SHED_REQUESTS,) + shape).astype(np.float32)
    targs, taux = mt.convert.params_from_numpy(args, aux, device=mt.cpu())
    out = {}
    eng = mt.ServingEngine(sym, targs, taux, {"data": shape}, ctx=mt.gpu(0),
                           policy=mt.serving.BucketPolicy(BATCH),
                           max_queue=SHED_MAX_QUEUE,
                           overload_policy="shed-oldest",
                           batch_timeout_ms=50.0, start=False)
    try:
        eng.warmup()
        futs = [eng.submit(x) for x in xs]

        def serve():
            eng.start()
            return [f.exception(timeout=600) for f in futs]
        errs, launches = counted(wrappers, serve)
        st = eng.stats()
        shed = [i for i, e in enumerate(errs)
                if isinstance(e, mt.serving.ServerOverloadError)]
        kept = [i for i, e in enumerate(errs) if e is None]
        if shed != list(range(SHED_REQUESTS - SHED_MAX_QUEUE)) \
                or kept != list(range(SHED_REQUESTS - SHED_MAX_QUEUE,
                                      SHED_REQUESTS)) \
                or (st["shed"], st["rejected"]) \
                != (SHED_REQUESTS - SHED_MAX_QUEUE, 0):
            raise AssertionError("shed-oldest: shed %s, kept %s, stats %s"
                                 % (shed, kept, {k: st[k] for k in (
                                     "shed", "rejected", "admitted")}))
        _fused_launches("shed-oldest", launches, st["batches"], n_fused)
        survivors = np.stack([futs[i].result() for i in kept])
        # the memory preflight's watermark beside the allocator's, one
        # warm program at a time: the engine's resident parameters plus
        # the dispatch's own high-water mark
        plan = eng.memory_plan
        if not plan or plan["budget_ok"] is not True:
            raise AssertionError("the memory preflight refused: %s" % plan)
        resident = sum(t.numel() * t.element_size() for t in
                       list(eng._cache._params.values()) + eng._cache._aux)
        rows = []
        for bb in eng._policy.batch_buckets():
            feeds = {"data": np.zeros((bb,) + shape, np.float32)}
            gc.collect()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            eng._on_device_thread(eng._cache.run, feeds)
            torch.cuda.synchronize()
            measured = resident + torch.cuda.max_memory_allocated() - before
            predicted = mt.analysis.predict_peak_bytes(
                eng.served_sym, {"data": (bb,) + shape})
            rows.append({"program": "b%d" % bb, "predicted_bytes": predicted,
                         "measured_bytes": measured,
                         "ratio": measured / predicted})
    finally:
        eng.close()
    ref_args, ref_aux = mt.convert.params_from_numpy(args, aux,
                                                     device=mt.gpu(0))
    pred = mt.Predictor(sym, ref_args, ref_aux,
                        {"data": (len(kept),) + shape}, ctx=mt.gpu(0))
    with plain_kernels(fu, nn):
        ref = pred.forward(data=xs[kept]).get_output(0)
    np.testing.assert_allclose(survivors, ref, rtol=SERVE_RTOL,
                               atol=SERVE_ATOL)
    out["shed"] = {"requests": SHED_REQUESTS, "max_queue": SHED_MAX_QUEUE,
                   "shed": st["shed"], "rejected": st["rejected"],
                   "batches": st["batches"], "launches": launches,
                   "max_abs_err": float(np.abs(survivors - ref).max())}
    log("  (a) shed-oldest, max_queue %d: %d requests staged, %d shed with "
        "ServerOverloadError, %d rejected; the %d survivors in %d batch, "
        "max |prob - plain Predictor| %.3g (rtol %g, atol %g); K1-K3 %s "
        "[%s]" % (SHED_MAX_QUEUE, SHED_REQUESTS, st["shed"], st["rejected"],
                  len(kept), st["batches"], out["shed"]["max_abs_err"],
                  SERVE_RTOL, SERVE_ATOL,
                  [launches[k] for k in SERVE_KERNELS["2d"]], card))
    out["memory"] = {"predicted_peak_bytes": plan["predicted_peak_bytes"],
                     "offender": plan["offender"],
                     "budget_bytes": plan["budget_bytes"], "programs": rows}
    fb = mt.analysis.memory.format_bytes
    log("  memory preflight: warm set %s (program %s), budget %s, nothing "
        "refused; per warm program, predicted / max_memory_allocated: %s "
        "[%s]" % (fb(plan["predicted_peak_bytes"]), plan["offender"],
                  fb(plan["budget_bytes"]), ", ".join(
                      "%s %s / %s (%.2f)" % (r["program"],
                                             fb(r["predicted_bytes"]),
                                             fb(r["measured_bytes"]),
                                             r["ratio"]) for r in rows),
                  card))

    # the pad probe: silent on ResNet-50 (its fused units are row-local)
    with env_vars({"MXNET_SERVE_PAD_CHECK": "1"}):
        eng = mt.ServingEngine(sym, targs, taux, {"data": shape},
                               ctx=mt.gpu(0),
                               policy=mt.serving.BucketPolicy(BATCH),
                               batch_timeout_ms=50.0, start=False)
    try:
        eng.warmup()
        futs = [eng.submit(x) for x in xs[:PROBE_REQUESTS]]

        def serve():
            eng.start()
            return [f.result(timeout=600) for f in futs]
        probed, launches = counted(wrappers, serve)
        st = eng.stats()
    finally:
        eng.close()
    # two dispatches a batch: the given pads, then the sentinel's
    _fused_launches("pad probe", launches, 2 * st["batches"], n_fused)
    probed = np.stack(probed)
    pred = mt.Predictor(sym, ref_args, ref_aux,
                        {"data": (PROBE_REQUESTS,) + shape}, ctx=mt.gpu(0))
    with plain_kernels(fu, nn):
        ref = pred.forward(data=xs[:PROBE_REQUESTS]).get_output(0)
    np.testing.assert_allclose(probed, ref, rtol=SERVE_RTOL, atol=SERVE_ATOL)
    # ... and it catches a graph that mixes the batch, analysis off
    mix = mt.sym.softmax(mt.sym.Variable("data"), axis=0, name="mix")
    with env_vars({"MXNET_SERVE_PAD_CHECK": "1", "MXNET_ANALYSIS_ON": "0"}):
        bad = mt.ServingEngine(mix, {}, {}, {"data": (1000,)},
                               ctx=mt.gpu(0),
                               policy=mt.serving.BucketPolicy(BATCH),
                               batch_timeout_ms=50.0, start=False)
    try:
        futs = [bad.submit(x) for x in np.random.default_rng(
            seed + 21).standard_normal((3, 1000)).astype(np.float32)]
        bad.start()
        caught = [str(f.exception(timeout=120)) for f in futs]
    finally:
        bad.close()
    if not all("contamination" in m for m in caught):
        raise AssertionError("the pad probe let softmax(axis=0) through: %s"
                             % caught)
    out["pad_probe"] = {"requests": PROBE_REQUESTS, "batches": st["batches"],
                        "launches": launches,
                        "max_abs_err": float(np.abs(probed - ref).max()),
                        "contamination_caught": len(caught)}
    log("  pad probe (MXNET_SERVE_PAD_CHECK=1): ResNet-50, %d requests in %d "
        "batch, silent, max |prob - plain| %.3g, K1-K3 %s (two dispatches a "
        "batch); softmax(axis=0) with the analysis off: all %d requests "
        "failed with contamination [%s]"
        % (PROBE_REQUESTS, st["batches"], out["pad_probe"]["max_abs_err"],
           [launches[k] for k in SERVE_KERNELS["2d"]], len(caught), card))
    return out


def lm_symbol(S, vocab, embed, hidden, layers):
    """``models/lstm_lm.py``'s language model as a served graph: begin
    states made in the graph from the input by ``_begin_state`` (expanded
    to (layers, N, hidden)), the fused time-major LSTM,
    ``FullyConnected(flatten=False)`` (no Reshape folds the batch into
    time) and a label-free softmax."""
    data = S.Variable("data")
    emb = S.Embedding(data, input_dim=vocab, output_dim=embed, name="embed")
    states = [S.broadcast_axis(S.expand_dims(
        S._begin_state(data, num_hidden=hidden, name=n), axis=0),
        axis=0, size=layers) for n in ("h0", "c0")]
    out = S.RNN(S.transpose(emb, axes=(1, 0, 2)),
                S.Variable("lstm_parameters"), *states, state_size=hidden,
                num_layers=layers, mode="lstm", name="lstm")
    pred = S.FullyConnected(S.transpose(out, axes=(1, 0, 2)),
                            num_hidden=vocab, flatten=False, name="pred")
    return S.softmax(pred, axis=-1, name="prob")


def seq_serve(torch, mt, wrappers, sym, args, xs, data_shape, what):
    """Stage ``xs`` on a warm seq-bucketed engine on cuda:0 and serve
    them; returns (engine, outputs, stats, programs after warmup,
    launches, warnings)."""
    import warnings
    policy = mt.serving.BucketPolicy(LM_MAX_BATCH, seq_axis=0,
                                     seq_buckets=LM_BUCKETS)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng = mt.ServingEngine(sym, args, {}, {"data": data_shape},
                               ctx=mt.gpu(0), policy=policy,
                               batch_timeout_ms=50.0, start=False)
    try:
        warm = eng.warmup()
        futs = [eng.submit(x) for x in xs]

        def serve():
            eng.start()
            return [f.result(timeout=600) for f in futs]
        outs, launches = counted(wrappers, serve)
        st = eng.stats()
    finally:
        eng.close()
    _no_launches(what, launches)
    return eng, outs, st, warm, launches, [str(w.message) for w in caught]


def _reshaped_reference(mt, pred, xs):
    return [pred.reshape({"data": (1,) + x.shape}).forward(
        data=x[None]).get_output(0)[0] for x in xs]


def serving_seq(torch, mt, wrappers, seed, card):
    """(b): the LSTM language model at PTB's widths per request with
    examples/rnn_ptb.py's buckets, and the seq-axis softmax with the
    masking repair on and off."""
    import numpy as np
    rng = np.random.default_rng(seed + 18)
    lo, hi = LM_LENGTHS
    lengths = rng.integers(lo, hi + 1, LM_REQUESTS)
    sym = lm_symbol(mt.sym, **LM)
    args = mt.convert.random_params(sym, {"data": (1, hi)}, seed=seed)[0]
    args = mt.convert.params_from_numpy(args, {}, device=mt.gpu(0))[0]
    xs = [rng.integers(0, LM["vocab"], n).astype(np.float32)
          for n in lengths]
    eng, outs, st, warm, _l, msgs = seq_serve(torch, mt, wrappers, sym, args,
                                              xs, (hi,), "LSTM LM")
    # the JAX package's padding pass has no rule for _begin_state and reads
    # FullyConnected(flatten=False) as contracting the padded seq axis: it
    # drops the seq buckets and the batching (ROADMAP Queue C), and the
    # port gives the same verdicts
    if eng._verdicts != {"batch": "cross-position", "seq": "cross-position"} \
            or eng._policy.seq_buckets or st["max_batch"] != 1 \
            or st["batches"] != LM_REQUESTS \
            or not any("disabling seq buckets" in m for m in msgs):
        raise AssertionError("LSTM LM: verdicts %s, seq buckets %s, %d "
                             "batches at max_batch %d" % (
                                 eng._verdicts, eng._policy.seq_buckets,
                                 st["batches"], st["max_batch"]))
    built = st["compile_count"] - warm
    if built != len(set(lengths) - {hi}) or st["retraces"]:
        raise AssertionError("LSTM LM: %d programs built for %d lengths, %d "
                             "retraces" % (built, len(set(lengths)),
                                           st["retraces"]))
    pred = mt.Predictor(sym, args, {}, {"data": (1, hi)}, ctx=mt.gpu(0))
    refs = _reshaped_reference(mt, pred, xs)
    err = max(float(np.abs(o - r).max()) for o, r in zip(outs, refs))
    scale = max(float(np.abs(r).max()) for r in refs)
    for x, o in zip(xs, outs):
        if o.shape != (len(x), LM["vocab"]) or not np.isfinite(o).all():
            raise AssertionError("LSTM LM output %s for length %d"
                                 % (o.shape, len(x)))
    if err > LM_TOL * scale:
        raise AssertionError("LSTM LM: max |out - Predictor| %.3g" % err)
    out = {"lstm_lm": {"requests": LM_REQUESTS,
                       "lengths": sorted(set(int(n) for n in lengths)),
                       "verdicts": dict(eng._verdicts),
                       "programs_warm": warm, "programs_built": built,
                       "max_abs_err": err,
                       "memory": eng.memory_plan and {
                           k: eng.memory_plan[k] for k in (
                               "predicted_peak_bytes", "offender")}}}
    log("  (b) LSTM LM (vocab %d, %d embed, %d hidden, %d layers), %d "
        "requests of lengths %d-%d, seq buckets %s, max_batch %d: verdicts "
        "%s, as the JAX package's (no padding rule for _begin_state; "
        "FullyConnected(flatten=False) read as contracting seq), so the seq "
        "buckets and the batching are dropped: %d batches, %d exact-length "
        "programs built after warmup, each output within %.3g of a "
        "Predictor reshaped to its length (limit %g of the largest) [%s]"
        % (LM["vocab"], LM["embed"], LM["hidden"], LM["layers"],
           LM_REQUESTS, lo, hi, LM_BUCKETS, LM_MAX_BATCH, eng._verdicts,
           st["batches"], built, err, LM_TOL, card))

    # the seq-axis softmax: repaired and served from the grid, or dropped
    soft = mt.sym.softmax(mt.sym.Variable("data"), axis=1, name="attn")
    sx = [rng.standard_normal((n, SEQ_SOFTMAX_WIDTH)).astype(np.float32)
          for n in lengths]
    pred = mt.Predictor(soft, {}, {}, {"data": (1, hi, SEQ_SOFTMAX_WIDTH)},
                        ctx=mt.gpu(0))
    refs = _reshaped_reference(mt, pred, sx)
    grid = len(LM_BUCKETS) * len(mt.serving.BucketPolicy(
        LM_MAX_BATCH).batch_buckets())
    for repair in (True, False):
        with env_vars({"MXNET_SERVE_REPAIR": "1" if repair else "0"}):
            eng, outs, st, warm, _l, msgs = seq_serve(
                torch, mt, wrappers, soft, {}, sx, (hi, SEQ_SOFTMAX_WIDTH),
                "seq softmax")
        err = max(float(np.abs(o - r).max() / np.abs(r).max())
                  for o, r in zip(outs, refs))
        if any(o.shape != x.shape for o, x in zip(outs, sx)) \
                or err > LM_TOL:
            raise AssertionError("seq softmax, repair %s: relative error "
                                 "%.3g" % (repair, err))
        buckets = list(eng._policy.seq_buckets)
        if repair and not (st["repairs"]["applied"]
                           and warm == st["compile_count"] <= grid
                           and buckets == list(LM_BUCKETS)
                           and st["batches"] < LM_REQUESTS):
            raise AssertionError("seq softmax, repair on: seq buckets %s, %s"
                                 % (buckets, {k: st[k] for k in (
                                     "repairs", "compile_count",
                                     "batches")}))
        if not repair and (buckets or st["repairs"]["applied"]):
            raise AssertionError("seq softmax, repair off: seq buckets %s, "
                                 "%s" % (buckets, st["repairs"]))
        name = "seq_softmax_repair_%s" % ("on" if repair else "off")
        out[name] = {"programs_warm": warm,
                     "programs": st["compile_count"],
                     "batches": st["batches"],
                     "repairs": st["repairs"]["applied"],
                     "valid_length_input":
                         st["repairs"]["valid_length_input"],
                     "seq_buckets": buckets,
                     "max_rel_err": err}
        log("  seq softmax over (T, %d), %d requests, MXNET_SERVE_REPAIR=%d: "
            "%d masks spliced (valid lengths %r), seq buckets %s, %d programs "
            "(%d warm, grid %d), %d batches, largest error %.3g of the "
            "exact softmax [%s]"
            % (SEQ_SOFTMAX_WIDTH, LM_REQUESTS, repair,
               st["repairs"]["applied"],
               st["repairs"]["valid_length_input"], buckets,
               st["compile_count"], warm, grid, st["batches"], err, card))
    return out


def sampling_jobs(seed):
    return decode_jobs(seed)[:SAMPLING_REQUESTS]


def serving_sampling(torch, mt, fu, nn, kv, seed, card, decode):
    """(c): phase 9's decoder under TemperatureSampler at k = 0, 2 and 4
    (the 1-block draft): seeded replays bit for bit in two engines,
    top_k=1 equal to phase 9's greedy streams, K9 and K10 launches as the
    graphs imply."""
    wrappers = kernel_wrappers(fu, nn, kv)
    target, t_info, draft, d_info, np_params = build_spec_models(
        mt, seed=seed, **DECODER)
    params = mt.convert.params_from_numpy(np_params, {},
                                          device=mt.gpu(0))[0]
    jobs = sampling_jobs(seed)
    want_len = [min(n, DECODER["max_len"] - len(p)) for p, n in jobs]

    def sampler(**kw):
        return mt.serving.TemperatureSampler(**dict(SAMPLER, seed=seed,
                                                    **kw))
    out = {"requests": len(jobs), "runs": {}}
    for k in (0,) + SPEC_KS:
        runs = [decode_run(mt, target, t_info, draft, d_info, params, jobs,
                           k, wrappers, sampler=sampler())
                for _ in range(2)]
        streams, reasons, st, wall, launches, _sv = runs[0]
        if runs[1][0] != streams:
            raise AssertionError("k=%d: two engines with seed %d drew "
                                 "different streams" % (k, seed))
        if [len(s) for s in streams] != want_len \
                or not all(0 <= t < DECODER["vocab"]
                           for s in streams for t in s):
            raise AssertionError("k=%d: stream lengths %s" % (
                k, [len(s) for s in streams]))
        for lname, per in zip(("cache_write_row", "cache_write_rows"),
                              launches_per_step(k)):
            for run in runs:
                if run[4][lname] != per * run[2]["steps"]:
                    raise AssertionError(
                        "k=%d: %s launched %d times in %d steps, not %d per "
                        "step" % (k, lname, run[4][lname], run[2]["steps"],
                                  per))
        spec = st["spec"]
        out["runs"]["k=%d" % k] = {
            "steps": st["steps"], "wall_s": wall,
            "tokens_per_s": st["tokens_generated"] / wall,
            "accept_rate": spec.get("accept_rate"),
            "tokens_per_step": spec.get("tokens_per_step"),
            "launches": launches,
            "memory_predicted_bytes": st["memory"].get(
                "predicted_peak_bytes")}
        log("  (c) temperature %.1f, top_k %d, seed %d, k=%d: %d requests, "
            "%d tokens in %d steps, %.3f s: %.1f tokens/s, accept rate %s, "
            "tokens per slot-step %s; a second engine replayed every stream "
            "bit for bit; K9 %d (%d/step), K10 %d [%s]"
            % (SAMPLER["temperature"], SAMPLER["top_k"], seed, k, len(jobs),
               st["tokens_generated"], st["steps"], wall,
               st["tokens_generated"] / wall, fmt_opt(spec.get(
                   "accept_rate")), fmt_opt(spec.get("tokens_per_step")),
               launches["cache_write_row"], launches_per_step(k)[0],
               launches["cache_write_rows"], card))
    # the target as its own draft: p == q, so every proposal passes
    k = min(SPEC_KS)
    streams, _r, st, wall, launches, _sv = decode_run(
        mt, target, t_info, target, t_info, params, jobs, k, wrappers,
        sampler=sampler())
    per = launches_per_step(k, DECODER["layers"])
    if st["spec"]["accept_rate"] != 1.0 \
            or [len(s) for s in streams] != want_len \
            or (launches["cache_write_row"], launches["cache_write_rows"]) \
            != (per[0] * st["steps"], per[1] * st["steps"]):
        raise AssertionError("self-draft k=%d: accept rate %s, launches %s "
                             "in %d steps" % (k, st["spec"]["accept_rate"],
                                              launches, st["steps"]))
    out["runs"]["k=%d, self-draft" % k] = {
        "steps": st["steps"], "wall_s": wall,
        "tokens_per_s": st["tokens_generated"] / wall,
        "accept_rate": st["spec"]["accept_rate"],
        "tokens_per_step": st["spec"]["tokens_per_step"],
        "launches": launches}
    log("  (c) the target as its own draft, k=%d: %d tokens in %d steps, "
        "%.1f tokens/s, accept rate %s, tokens per slot-step %s; K9 %d "
        "(%d/step), K10 %d [%s]"
        % (k, st["tokens_generated"], st["steps"],
           st["tokens_generated"] / wall, fmt_opt(st["spec"]["accept_rate"]),
           fmt_opt(st["spec"]["tokens_per_step"]),
           launches["cache_write_row"], per[0], launches["cache_write_rows"],
           card))
    greedy = decode["streams"][:len(jobs)]
    top1 = decode_run(mt, target, t_info, draft, d_info, params, jobs, 2,
                      wrappers, sampler=sampler(top_k=1))[0]
    if top1 != greedy:
        raise AssertionError("TemperatureSampler(top_k=1) at k=2 differs "
                             "from phase 9's greedy streams")
    out["top_k_1_equals_greedy"] = True
    log("  TemperatureSampler(%.1f, top_k=1) at k=2: every stream equals "
        "phase 9's greedy stream" % SAMPLER["temperature"])
    return out


def build_prefill_model(mt, vocab, d, seed):
    """``perf/decode_bench.py``'s build_prefill_model, built with the port:
    an additive state ``s' = s + emb(token)``; its prefill graph masks the
    padded prompt with the live length and sums.  Returns (step, prefill,
    numpy params, state_info)."""
    import numpy as np
    S = mt.sym
    tok, s = S.Variable("token"), S.Variable("s")
    s2 = s + S.Embedding(tok, input_dim=vocab, output_dim=d, name="emb")
    step = S.Group([S.FullyConnected(s2, num_hidden=vocab, name="out_fc"),
                    s2])
    pemb = S.Embedding(S.Variable("prompt"), input_dim=vocab, output_dim=d,
                       name="emb")
    srow = S.sum(S.SequenceMask(pemb, use_sequence_length=True,
                                sequence_length=S.Variable("plen"), axis=1),
                 axis=1)
    prefill = S.Group([S.FullyConnected(srow, num_hidden=vocab,
                                        name="out_fc"), srow])
    rng = np.random.default_rng(seed)
    params = {"emb_weight": rng.standard_normal((vocab, d)).astype(
        np.float32),
              "out_fc_weight": rng.standard_normal((vocab, d)).astype(
                  np.float32),
              "out_fc_bias": np.zeros((vocab,), np.float32)}
    return step, prefill, params, [{"name": "s", "shape": (d,)}]


def prefill_run(torch, mt, wrappers, step, prefill, np_params, info, jobs,
                np_draft=None, **engine_kw):
    """Serve ``jobs`` staged on a warm DecodeEngine on cuda:0 (the first
    iteration seats a full pool); returns (tokens, decode stats, memory
    plan, peak allocated bytes from before the parameters' upload to the
    end, launches)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = mt.convert.params_from_numpy(np_params, {},
                                          device=mt.gpu(0))[0]
    if np_draft is not None:
        engine_kw["draft_arg_params"] = mt.convert.params_from_numpy(
            np_draft, {}, device=mt.gpu(0))[0]
    eng = mt.serving.DecodeEngine(
        step, params, {}, info, num_slots=DECODE_SLOTS,
        max_len=DECODER["max_len"], ctx=mt.gpu(0), default_deadline_ms=0,
        prefill_sym=prefill, start=False, **engine_kw)
    try:
        eng.warmup()
        futs = [eng.submit(p, max_new_tokens=n) for p, n in jobs]

        def serve():
            eng.start()
            return [list(f.result(timeout=600).tokens) for f in futs]
        toks, launches = counted(wrappers, serve)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        st = eng.stats()["decode"]
    finally:
        eng.close()
    return toks, st, eng.memory_plan, peak, launches


def serving_prefill(torch, mt, fu, nn, kv, seed, card):
    """(d): bucketed prefill, coalesced, serial and teacher-forced, and in
    front of speculative decode."""
    import numpy as np
    wrappers = kernel_wrappers(fu, nn, kv)
    step, prefill, np_params, info = build_prefill_model(
        mt, seed=seed, **PREFILL_MODEL)
    rng = np.random.default_rng(seed + 19)
    jobs = [([int(t) for t in rng.integers(0, PREFILL_MODEL["vocab"],
                                           int(rng.integers(*PREFILL_PROMPTS)
                                               + 1))],
             int(rng.integers(*PREFILL_NEW) + 1))
            for _ in range(PREFILL_REQUESTS)]
    runs = {}
    for name, env, pf in (("coalesced", None, prefill),
                          ("serial", "0", prefill),
                          ("teacher-forced", None, None)):
        with env_vars({"MXNET_DECODE_COALESCE_PREFILL": env}):
            runs[name] = prefill_run(torch, mt, wrappers, step, pf,
                                     np_params, info, jobs)
        _no_launches("prefill " + name, runs[name][4])
    toks = runs["coalesced"][0]
    for name, run in runs.items():
        if run[0] != toks:
            raise AssertionError("prefill: the %s run's tokens differ from "
                                 "the coalesced run's" % name)
    if [len(t) for t in toks] != [n for _p, n in jobs]:
        raise AssertionError("prefill: lengths %s" % [len(t) for t in toks])
    steps = {name: run[1]["steps"] for name, run in runs.items()}
    if not steps["coalesced"] < steps["teacher-forced"]:
        raise AssertionError("prefill: %s step dispatches" % steps)
    # prefill in front of speculative decode, against greedy_decode
    drng = np.random.default_rng(seed + 20)
    dparams = {k: v + drng.standard_normal(v.shape).astype(np.float32)
               * np.float32(0.3) for k, v in np_params.items()}
    spec_toks, spec_st, _p, _m, launches = prefill_run(
        torch, mt, wrappers, step, prefill, np_params, info, jobs,
        np_draft=dparams, spec_k=2, draft_sym=step, draft_state_info=info)
    _no_launches("prefill, spec k=2", launches)
    params = mt.convert.params_from_numpy(np_params, {},
                                          device=mt.gpu(0))[0]
    prog = mt.serving.StepProgram(step, params, {}, info, DECODE_SLOTS,
                                  ctx=mt.gpu(0))
    greedy = [list(mt.serving.greedy_decode(prog, p, n)) for p, n in jobs]
    del prog
    if spec_toks != greedy or toks != greedy:
        raise AssertionError("prefill: spec k=2 or coalesced tokens differ "
                             "from greedy_decode's")
    out = {"requests": len(jobs), "runs": {}}
    fb = mt.analysis.memory.format_bytes
    for name, (_t, st, plan, peak, _l) in list(runs.items()) + [
            ("coalesced, spec k=2", (spec_toks, spec_st, _p, _m, launches))]:
        out["runs"][name] = {
            "steps": st["steps"], "prefill_dispatches":
                st["prefill_dispatches"],
            "programs": st["programs_built"],
            "accept_rate": st["spec"].get("accept_rate"),
            "memory": {"predicted_bytes": plan["predicted_peak_bytes"],
                       "offender": plan["offender"],
                       "measured_bytes": peak,
                       "ratio": peak / plan["predicted_peak_bytes"]}}
        log("  (d) %s: %d requests (prompts %d-%d tokens), %d step "
            "dispatches, %d prefill dispatches, %d programs; memory "
            "preflight %s (%s) beside max_memory_allocated %s (%.2f)%s [%s]"
            % (name, len(jobs), PREFILL_PROMPTS[0], PREFILL_PROMPTS[1],
               st["steps"], st["prefill_dispatches"], st["programs_built"],
               fb(plan["predicted_peak_bytes"]), plan["offender"], fb(peak),
               peak / plan["predicted_peak_bytes"],
               "" if not st["spec"].get("enabled") else
               ", accept rate %s" % fmt_opt(st["spec"]["accept_rate"]),
               card))
    log("  coalesced, serial and teacher-forced give the same tokens, and "
        "so does prefill with spec k=2: greedy_decode's")
    return out


def serving_phase(torch, mt, fu, nn, kv, seed, card, decode):
    """Phase 17 (see the module docstring): (a)-(d); ``decode`` is phase
    9's result, whose greedy streams (c) is held against."""
    t_phase = time.perf_counter()
    wrappers = kernel_wrappers(fu, nn, kv)
    out = {"resnet": serving_resnet(torch, mt, fu, nn, wrappers, seed, card),
           "seq": serving_seq(torch, mt, wrappers, seed, card),
           "sampling": serving_sampling(torch, mt, fu, nn, kv, seed, card,
                                        decode),
           "prefill": serving_prefill(torch, mt, fu, nn, kv, seed, card)}
    out["launches"] = {
        "shed-oldest": out["resnet"]["shed"]["launches"],
        "pad probe": out["resnet"]["pad_probe"]["launches"]}
    out["launches"].update(("sampling, " + name, r["launches"])
                           for name, r in out["sampling"]["runs"].items())
    out["phase_s"] = time.perf_counter() - t_phase
    log("  phase 17 took %.1f s" % out["phase_s"])
    log(json.dumps({"serving": {
        "shed": {k: v for k, v in out["resnet"]["shed"].items()
                 if k != "launches"},
        "memory": out["resnet"]["memory"],
        "seq": out["seq"],
        "sampling": {k: {kk: vv for kk, vv in r.items() if kk != "launches"}
                     for k, r in out["sampling"]["runs"].items()},
        "prefill": out["prefill"]["runs"],
        "phase_s": out["phase_s"]}}))
    return out


# phase 18: the telemetry plane and the profiler on the card
TELEMETRY_IMAGE = 224
TELEMETRY_REQUESTS = 32
TELEMETRY_CLIENTS = 4
TELEMETRY_PAIRS = 10            # (e): on/off turn pairs, order alternating
TELEMETRY_BURSTS = 6            # (e): bursts of the requests x 4 a turn
TELEMETRY_DECODE_REPEAT = 3     # (e): a decode turn serves the jobs x 3
TELEMETRY_TRAIN_STEPS = 16      # (b) and (e): steps a fit turn takes
TELEMETRY_KS = (0, 2)
TELEMETRY_PHASE_SHARE = 0.95    # phases' self-times over the step wall
TELEMETRY_ROUTES = ("/metrics", "/metrics.json", "/traces", "/alerts",
                    "/history?series=mxnet_serve_requests_total",
                    "/timeline", "/timeline?format=chrome", "/healthz")


def _http(port, path, nbytes=None):
    """(status, body bytes) of one GET on the local telemetry server."""
    import urllib.request
    with urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                                timeout=30) as r:
        return r.status, (r.read(nbytes) if nbytes else r.read())


def _series(doc, name, **labels):
    """{label tuple: value, or (count, sum) of a histogram} of one family
    of a ``Registry.collect()`` document, the series matching
    ``labels``."""
    fam = doc.get(name)
    out = {}
    for s in (fam or {}).get("series", ()):
        lab = s.get("labels") or {}
        if all(lab.get(k) == v for k, v in labels.items()):
            out[tuple(sorted(lab.items()))] = (
                (s["count"], s["sum"]) if fam["kind"] == "histogram"
                else s["value"])
    return out


def _total(doc, name, **labels):
    """The sum of a family's matching series: values, or histogram
    observation counts."""
    vals = _series(doc, name, **labels).values()
    return sum(v[0] if isinstance(v, tuple) else v for v in vals)


def _hist_sum(doc, name, **labels):
    return sum(v[1] for v in _series(doc, name, **labels).values())


def _delta(after, before, name, **labels):
    return _total(after, name, **labels) - _total(before, name, **labels)


@contextlib.contextmanager
def telemetry_switch(mt, on):
    """Telemetry pinned on or off inside the block."""
    mt.telemetry.set_enabled(on)
    try:
        yield
    finally:
        mt.telemetry.set_enabled(None)


def _staged(eng, xs):
    """Stage ``xs`` on the stopped engine, then start it: the batches form
    the same way on every engine.  Returns the answers."""
    futs = [eng.submit(x) for x in xs]
    eng.start()
    return [f.result(timeout=600) for f in futs]


def _telemetry_threads():
    """Names of the telemetry plane's live threads (server, recorder,
    snapshotter)."""
    return sorted(t.name for t in threading.enumerate()
                  if t.name.startswith("mxnet-telemetry"))


def _turn_order(i):
    """(e): pair ``i``'s two settings, the first alternating, so a drift
    of the card over the pairs falls on both settings alike."""
    return ("on", "off") if i % 2 == 0 else ("off", "on")


def _off_turn_check(mt, what, calls):
    """(e): a turn with telemetry off ran with no thread of the plane alive
    and moved no instrument (``calls``: ``instrument_calls()`` at its
    start)."""
    threads = _telemetry_threads()
    moved = mt.telemetry.registry().instrument_calls() - calls
    if threads or moved:
        raise AssertionError("%s with telemetry off: threads %s alive, %d "
                             "instrument calls" % (what, threads, moved))


def _serve_turn(mt, engine, setting, xs):
    """(e): one serving turn on a fresh engine: with telemetry on, the HTTP
    server started and the engine's recorder sampling; with it off,
    nothing of the plane alive.  TELEMETRY_BURSTS bursts of ``xs`` from
    TELEMETRY_CLIENTS clients; the engine is closed (and the server
    stopped) before the next turn, so no turn pays for the other
    setting's threads."""
    tm = mt.telemetry
    lat, wall = [], 0.0
    with telemetry_switch(mt, setting == "on"):
        if setting == "on":
            tm.start_server(0, host="127.0.0.1")
        calls = tm.registry().instrument_calls()
        eng = engine()
        try:
            eng.warmup()
            eng.start()
            for _ in range(TELEMETRY_BURSTS):
                _f, w, l_ms = send_requests(eng, xs, TELEMETRY_CLIENTS)
                wall += w
                lat.extend(l_ms)
            if setting == "off":
                _off_turn_check(mt, "a serving turn", calls)
        finally:
            eng.close()
            if setting == "on":
                tm.stop_server()
    lat.sort()
    return {"latency_p50_ms": percentile(lat, 50),
            "latency_p99_ms": percentile(lat, 99),
            "images_per_s": len(lat) / wall, "window_s": wall}


def _sign_p(diffs):
    """Two-sided sign test: the chance of at least this many differences
    of one sign among the nonzero ones, were on and off alike."""
    import math
    pos, neg = sum(d > 0 for d in diffs), sum(d < 0 for d in diffs)
    n, k = pos + neg, max(pos, neg)
    if not n:
        return 1.0
    return min(1.0, 2.0 * sum(math.comb(n, i) for i in range(k, n + 1))
               / 2.0 ** n)


def _cost(pairs, key):
    """(e): one metric over the pairs ({"on": turn, "off": turn} each):
    each setting's median, each pair's on-off difference in percent of
    its off and their median, least and most, and whether the pairs
    resolve a cost: a sign test at p < 0.05 (9 of 10 pairs of one sign);
    else the cost lies inside the spread."""
    diffs = [100.0 * (p["on"][key] - p["off"][key]) / p["off"][key]
             for p in pairs]
    p = _sign_p(diffs)
    return {"on": _median([q["on"][key] for q in pairs]),
            "off": _median([q["off"][key] for q in pairs]),
            "pair_diffs_pct": diffs, "median_pct": _median(diffs),
            "min_pct": min(diffs), "max_pct": max(diffs), "sign_p": p,
            "resolved": p < 0.05}


def priced_ledger(torch, mt, xs, seed):
    """(a): the efficiency ledger of the plain graph of phase 4's model
    (which ``count_flops`` prices) over one staged batch of ``xs``, held
    against ``count_flops`` of the served graph at that batch; returns
    the FLOPs."""
    side = TELEMETRY_IMAGE
    shape = (side, side, 3)
    sym = mt.models.get_resnet_symbol(
        num_classes=1000, num_layers=50, image_shape=(3, side, side),
        layout="NHWC")
    args, aux = mt.convert.random_params(sym, {"data": (1,) + shape},
                                         seed=seed)
    targs, taux = mt.convert.params_from_numpy(args, aux, device=mt.cpu())
    eng = mt.ServingEngine(sym, targs, taux, {"data": shape},
                           ctx=mt.gpu(0),
                           policy=mt.serving.BucketPolicy(len(xs)),
                           batch_timeout_ms=50.0, start=False)
    try:
        _staged(eng, xs)
        st = eng.stats()
        want = int(round(mt.analysis.count_flops(
            eng.served_sym, {"data": (len(xs),) + shape})["total"]))
    finally:
        eng.close()
    ledger = st["efficiency"]["flops"]
    if st["batches"] != 1 or not ledger["total"] == ledger["useful"] \
            == want > 0 or st["efficiency"]["unpriced_dispatches"]:
        raise AssertionError("the plain graph's FLOPs ledger %s in %d "
                             "batches, count_flops %d" % (ledger,
                                                          st["batches"], want))
    return want


def telemetry_serve(torch, mt, fu, nn, wrappers, seed, card):
    """(a) the fused ResNet-50 of phase 4 served with telemetry on and the
    server on port 0: every route scraped, the counters against stats(),
    a served request's span tree, the memory gauge against the
    allocator, the fused graph left unpriced and the plain graph's FLOPs
    ledger against count_flops, K1-K3 12 times a batch, the probabilities
    bit-equal to an engine with telemetry off;
    (d) one served batch under a torch.profiler capture; (e) serving's
    latency and rate with telemetry on and off, in pairs of turns, each
    turn on an engine of its own."""
    import numpy as np
    tm = mt.telemetry
    side = TELEMETRY_IMAGE
    shape = (side, side, 3)
    sym = mt.models.get_resnet_symbol(
        num_classes=1000, num_layers=50, image_shape=(3, side, side),
        layout="NHWC", unit_impl="fused")
    n_fused = sym.tojson().count('"_contrib_FusedBottleneckUnit"')
    args, aux = mt.convert.random_params(sym, {"data": (1,) + shape},
                                         seed=seed)
    xs = np.random.default_rng(seed + 18).standard_normal(
        (TELEMETRY_REQUESTS,) + shape).astype(np.float32)
    targs, taux = mt.convert.params_from_numpy(args, aux, device=mt.cpu())

    def engine():
        return mt.ServingEngine(sym, targs, taux, {"data": shape},
                                ctx=mt.gpu(0),
                                policy=mt.serving.BucketPolicy(BATCH),
                                batch_timeout_ms=50.0, start=False)
    out = {}
    engines = []
    try:
        # telemetry off first, before any server or recorder thread
        # collects: the off engine must move no instrument at all
        with telemetry_switch(mt, False):
            off = engine()
            engines.append(off)
            off.warmup()
            if off._tm is not None or off._eff is not None:
                raise AssertionError("an engine built with telemetry off "
                                     "holds instruments")
            calls = tm.registry().instrument_calls()
            outs_off = _staged(off, xs)
            if tm.registry().instrument_calls() != calls:
                raise AssertionError("telemetry off moved instruments")
        srv = tm.start_server(0, host="127.0.0.1")
        # the default trace retention: the tail sampler keeps the first
        # requests while its top-K fills, so served requests have trees
        on = engine()
        engines.append(on)
        on.warmup()
        label = on._tm.engine_label
        before = tm.registry().collect()
        outs_on, launches = counted(wrappers, lambda: _staged(on, xs))
        torch.cuda.synchronize()
        st = on.stats()
        tm.get_recorder().sample_now()
        routes = {}
        for path in TELEMETRY_ROUTES:
            status, body = _http(srv.port, path)
            routes[path] = status
            if status != 200:
                raise AssertionError("GET %s answered %d" % (path, status))
        sse = b"retry: 3000\n\n"
        status, head = _http(srv.port, "/events?keepalive=0.05", len(sse))
        routes["/events"] = status
        if (status, head) != (200, sse):
            raise AssertionError("GET /events answered %d %r"
                                 % (status, head))
        doc = json.loads(_http(srv.port, "/metrics.json")[1])["metrics"]
        peak = torch.cuda.max_memory_allocated(0)
        after = tm.registry().collect()
        ids = json.loads(_http(srv.port, "/traces")[1])["traces"]
        served = [t for t in ids if t["name"] == "serve.request"]
        status, body = _http(srv.port, "/traces/%s" % served[-1]["trace_id"])
        tree = json.loads(body)
        spans = [c["name"] for c in tree["root"]["children"]]
        _fused_launches("telemetry on", launches, st["batches"], n_fused)
        if not all(np.array_equal(a, b) for a, b in zip(outs_on, outs_off)):
            raise AssertionError("probabilities differ with telemetry on "
                                 "and off")
        counts = {
            "requests": _delta(after, before, "mxnet_serve_requests_total"),
            "batches": _delta(after, before, "mxnet_serve_batches_total"),
            "latency_count": _delta(after, before,
                                    "mxnet_serve_request_latency_ms")}
        want = {"requests": st["requests_served"],
                "batches": st["batches"],
                "latency_count": st["requests_served"]}
        if counts != want or st["requests_served"] != len(xs):
            raise AssertionError("registry %s against stats() %s"
                                 % (counts, want))
        gauge = _total(doc, "mxnet_serve_memory_measured_peak_bytes",
                       engine=label)
        if not 0 < gauge == peak:
            raise AssertionError("memory gauge %r against "
                                 "max_memory_allocated %d" % (gauge, peak))
        if spans != ["queue-wait", "coalesce", "pad", "dispatch", "unpad"]:
            raise AssertionError("a served request's spans: %s" % spans)
        # the fused units fall to count_flops's default rule, so the
        # efficiency plane leaves the fused graph unpriced: an empty FLOPs
        # ledger, every dispatch counted as unpriced
        ledger = st["efficiency"]["flops"]
        unpriced = (st["efficiency"]["unpriced_dispatches"],
                    _delta(after, before,
                           "mxnet_serve_unpriced_dispatches_total",
                           engine=label))
        if any(ledger.values()) \
                or _total(doc, "mxnet_serve_flops_total", engine=label) \
                or unpriced != (st["batches"], st["batches"]):
            raise AssertionError("the fused graph's FLOPs ledger %s, "
                                 "unpriced dispatches %s of %d batches"
                                 % (ledger, unpriced, st["batches"]))
        flops = priced_ledger(torch, mt, xs[:BATCH], seed)
        out["a"] = {"routes": routes, "counts": counts,
                    "memory_gauge_bytes": gauge, "trace_spans": spans,
                    "unpriced_dispatches": unpriced[0],
                    "plain_graph_flops": flops, "launches": launches,
                    "engine": label}
        log("  (a) routes %s; requests %d, batches %d, latency count %d = "
            "stats(); memory gauge %d = max_memory_allocated; the fused "
            "graph unpriced (%d dispatches), the plain graph's ledger %d "
            "FLOPs = count_flops; spans %s; launches %s; probabilities "
            "bit-equal off [%s]"
            % (routes, counts["requests"], counts["batches"],
               counts["latency_count"], gauge, unpriced[0], flops, spans,
               launches, card))
        # (d) one served batch under a torch.profiler capture
        with tempfile.TemporaryDirectory() as tmp:
            mt.profiler.start_xla_trace(tmp)

            def one_batch():
                return [f.result(timeout=600)
                        for f in [on.submit(x) for x in xs[:BATCH]]]
            _r, cap_launches = counted(wrappers, one_batch)
            path = mt.profiler.stop_xla_trace()
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        kernels = [e["name"] for e in events
                   if e.get("cat") == "kernel" and "mma_kernel" in e["name"]]
        fwd = sum(cap_launches[k] for k in SERVE_KERNELS["2d"])
        if not kernels or len(kernels) < fwd or fwd < n_fused * 3:
            raise AssertionError("the capture holds %d mma_kernel events for "
                                 "%d K1-K3 launches" % (len(kernels), fwd))
        out["d_capture"] = {"mma_kernel_events": len(kernels),
                            "k1_k3_launches": fwd,
                            "kernel_names": sorted(set(kernels))[:3]}
        log("  (d) torch.profiler capture of one batch: %d CUDA events of "
            "fmma::mma_kernel for %d K1-K3 launches" % (len(kernels), fwd))
    finally:
        for eng in engines:
            eng.close()
        tm.stop_server()
    # (e) serving on and off in pairs of turns, each on an engine of its own
    burst = np.concatenate([xs] * 4)
    pairs = []
    for i in range(TELEMETRY_PAIRS):
        pairs.append({setting: _serve_turn(mt, engine, setting, burst)
                      for setting in _turn_order(i)})
    out["e_serve_pairs"] = pairs
    out["e_serve"] = {k: _cost(pairs, k) for k in
                      ("latency_p50_ms", "latency_p99_ms", "images_per_s")}
    return out


def _fit_steps(torch, mt, sym, args, aux, x, y, steps):
    """``steps`` SGD steps of Module.fit on cuda:0 (K8 on, as phase 5);
    returns (host stamps at each step's end, the program-build count at
    each step's end, the parameters on the host)."""
    from mxnet_tpu_torch.executor import xla_traces_ever
    stamps, builds = [], []

    def on_batch(param):
        stamps.append(time.perf_counter())
        builds.append(xla_traces_ever())
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    arg_nd, aux_nd = mt.convert.params_from_numpy(args, aux,
                                                  device=mt.gpu(0))
    stamps.append(time.perf_counter())
    mod.fit(mt.io.NDArrayIter(x, y, batch_size=TRAIN_BATCH),
            eval_metric=["acc", "ce"], optimizer="sgd",
            optimizer_params=SGD, kvstore="local", num_epoch=steps,
            arg_params=arg_nd, aux_params=aux_nd,
            batch_end_callback=on_batch)
    params = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    return stamps, builds, params, mod


def telemetry_fit(torch, mt, fu, nn, wrappers, seed, card):
    """(b) phase 5's fit with telemetry on: the phases' self-times against
    the step wall, the fused graph left unpriced (no FLOPs or MFU gauge)
    and MFU from count_flops of the plain graph and the card's peak, the
    program-build counter flat after step 1, the launches; every fit with
    telemetry off gives the same parameters bit for bit (cuDNN
    deterministic in all); (d) the profiler's ring over one Executor
    step; (e) the step time on and off in pairs of fits."""
    import numpy as np
    tm = mt.telemetry
    side = TELEMETRY_IMAGE
    kw = dict(num_classes=1000, num_layers=50, image_shape=(3, side, side),
              layout="NHWC")
    sym = mt.models.get_resnet_symbol(unit_impl="fused", **kw)
    args, aux = mt.convert.random_params(sym, {"data": (1, side, side, 3)},
                                         seed=seed)
    rng = np.random.default_rng(seed + 2)
    x = rng.standard_normal((TRAIN_BATCH, side, side, 3)).astype(np.float32)
    y = rng.integers(0, 1000, TRAIN_BATCH).astype(np.float32)
    steps = TELEMETRY_TRAIN_STEPS
    runs = []                   # (setting, stamps, builds, launches, ...)
    p_first = None
    torch.backends.cudnn.deterministic = True
    try:
        with env_vars({"MXNET_CONV1X1_FUSED_BWD": "1"}):
            for i in range(TELEMETRY_PAIRS):
                for setting in _turn_order(i):
                    with telemetry_switch(mt, setting == "on"):
                        before = tm.registry().collect()
                        calls = tm.registry().instrument_calls()
                        (stamps, builds, params, mod), launches = counted(
                            wrappers, lambda: _fit_steps(torch, mt, sym, args,
                                                         aux, x, y, steps))
                        if setting == "off":
                            _off_turn_check(mt, "a fit", calls)
                        after = tm.registry().collect()
                    _launch_check("fit with telemetry %s" % setting, launches,
                                  TRAIN_LAUNCHES["2d"], steps)
                    if p_first is None:
                        p_first = params
                    elif sorted(params) != sorted(p_first) or not all(
                            np.array_equal(params[k], p_first[k])
                            for k in p_first):
                        raise AssertionError("fit parameters differ with "
                                             "telemetry on and %s" % setting)
                    runs.append((setting, stamps, builds, launches, before,
                                 after))
                    if len(runs) == 1:
                        ring = _profiler_ring(mt, mod, x, y)
                    del mod, params
                    gc.collect()
                    torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    setting, stamps, builds, launches, before, after = runs[0]
    assert setting == "on"
    if len(builds) != steps or len(set(builds)) != 1:
        raise AssertionError("program builds at each step's end %s: not "
                             "flat after step 1" % builds)
    step_s = _hist_sum(after, "mxnet_train_step_seconds", loop="fit") \
        - _hist_sum(before, "mxnet_train_step_seconds", loop="fit")
    phases = {}
    for key, (count, total) in _series(
            after, "mxnet_train_step_phase_seconds", loop="fit").items():
        prev = _series(before, "mxnet_train_step_phase_seconds",
                       loop="fit").get(key, (0, 0.0))
        phases[dict(key)["phase"]] = (count - prev[0], total - prev[1])
    n_steps = _delta(after, before, "mxnet_train_steps_total", loop="fit")
    share = sum(t for _c, t in phases.values()) / step_s
    if n_steps != steps or sorted(phases) != sorted(
            ("data_wait", "h2d", "fwd_bwd", "optimizer", "metric")) \
            or any(c != steps for c, _t in phases.values()) \
            or not TELEMETRY_PHASE_SHARE <= share <= 1.0:
        raise AssertionError("steps %d, phases %s, their share of the step "
                             "wall %.4f" % (n_steps, phases, share))
    compiles = _delta(after, before, "mxnet_train_step_compiles_total",
                      loop="fit")
    # the fused units fall to count_flops's default rule, so the plane
    # leaves the fused graph unpriced; MFU here is count_flops of the plain
    # graph of the same model (phase 16 holds it against FlopCounterMode)
    shapes = {"data": x.shape, "softmax_label": y.shape}
    fused_price = tm.goodput.analytic_flops(sym, shapes, training=True)
    flops = mt.analysis.count_flops(mt.models.get_resnet_symbol(**kw),
                                    shapes, training=True)["total"]
    gauge_flops = _total(after, "mxnet_train_step_flops", loop="fit")
    gauge_mfu = _total(after, "mxnet_train_mfu", loop="fit")
    peak = mt.telemetry.peak_flops_for(torch.device("cuda", 0))
    name = torch.cuda.get_device_name(0)
    if ("H100 80GB HBM3" in name or "H100 SXM" in name) \
            and peak != 989e12:
        raise AssertionError("peak_flops_for(%s) = %r" % (name, peak))
    pairs = []
    for i in range(TELEMETRY_PAIRS):
        pair = {}
        for setting, st, *_rest in runs[2 * i:2 * i + 2]:
            walls = [b - a for a, b in zip(st[1:], st[2:])]
            pair[setting] = {"step_ms": _median(walls) * 1e3,
                             "window_s": sum(walls)}
        pairs.append(pair)
    cost = {"step_ms": _cost(pairs, "step_ms")}
    mfu = flops / (cost["step_ms"]["on"] / 1e3 * peak) if peak else None
    if fused_price is not None or gauge_flops or gauge_mfu or compiles != 1:
        raise AssertionError("the fused graph priced at %r, step FLOPs gauge "
                             "%r, MFU gauge %r, compiling steps %r"
                             % (fused_price, gauge_flops, gauge_mfu,
                                compiles))
    if not {"forward", "forward_backward", "update"} <= set(ring):
        raise AssertionError("the profiler's ring holds %s" % ring)
    out = {"phases_s": {k: t for k, (_c, t) in phases.items()},
           "step_s": step_s, "phase_share": share, "step_flops": flops,
           "peak_flops": peak, "mfu": mfu, "builds": builds,
           "launches": launches, "e_fit_pairs": pairs, "e_fit": cost,
           "step_walls_ms": [(b - a) * 1e3
                             for a, b in zip(stamps, stamps[1:])],
           "profiler_ring": ring}
    log("  (b) %d steps: phases %s of %.4f s step wall (share %.4f); the "
        "fused graph unpriced (no FLOPs or MFU gauge); the plain graph's "
        "count_flops %.6g a step, MFU %s against %s; program builds %s; "
        "launches %s; parameters bit-equal on and off in %d fits [%s]"
        % (steps, {k: round(t, 5) for k, t in out["phases_s"].items()},
           step_s, share, flops,
           "%.5f" % mfu if mfu is not None else "not measured",
           "%.0f TFLOP/s" % (peak / 1e12) if peak else "no peak",
           builds, launches, len(runs), card))
    log("  (d) dump_profile() holds %s" % ring)
    return out


def _profiler_ring(mt, mod, x, y):
    """(d): the event names ``dump_profile()`` writes for one Executor
    step of ``mod`` under the profiler."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "profile.json")
        mt.profiler.profiler_set_config(filename=path)
        mt.profiler.profiler_set_state("run")
        try:
            batch = mt.io.DataBatch(data=[mt.nd.array(x, ctx=mt.cpu())],
                                    label=[mt.nd.array(y, ctx=mt.cpu())])
            mod.forward_backward(batch)
            mod.update()
            mod.forward(batch, is_train=False)
            mod.get_outputs()[0].asnumpy()
        finally:
            mt.profiler.profiler_set_state("stop")
            mt.profiler.dump_profile()
            mt.profiler.profiler_set_config(filename="profile.json")
        with open(path) as f:
            return sorted({e["name"] for e in json.load(f)["traceEvents"]})


def telemetry_decode(torch, mt, fu, nn, kv, wrappers, seed, card):
    """(c) phase 9's decoder at k = 0 and 2 with telemetry on: the token
    and step counters against stats(), K9/K10 as the graphs imply; every
    run with telemetry off gives the same tokens; (e) tokens/s on and off
    in pairs of runs after one untimed run (the first decode engine of a
    process pays the card's one-time costs), each pair serving the jobs
    TELEMETRY_DECODE_REPEAT times."""
    tm = mt.telemetry
    target, t_info, draft, d_info, np_params = build_spec_models(
        mt, seed=seed, **DECODER)
    params = mt.convert.params_from_numpy(np_params, {},
                                          device=mt.gpu(0))[0]
    jobs = decode_jobs(seed)
    window = jobs * TELEMETRY_DECODE_REPEAT
    plan = [("k=0 untimed", 0, "off", jobs)]
    for i in range(TELEMETRY_PAIRS):
        plan += [("k=0 %s %d" % (setting, i), 0, setting, window)
                 for setting in _turn_order(i)]
    plan.append(("k=2", 2, "on", jobs))
    out = {"runs": {}}
    pairs = [{} for _ in range(TELEMETRY_PAIRS)]
    streams = {}
    for name, k, setting, run_jobs in plan:
        with telemetry_switch(mt, setting == "on"):
            before = tm.registry().collect()
            calls = tm.registry().instrument_calls()
            toks, _r, st, wall, launches, _sv = decode_run(
                mt, target, t_info, draft, d_info, params, run_jobs, k,
                wrappers)
            if setting == "off":
                _off_turn_check(mt, name, calls)
            after = tm.registry().collect()
        # a request's tokens do not depend on the requests beside it
        streams[name] = [toks[i::len(jobs)] for i in range(len(jobs))]
        steps = st["steps"]
        for kname, per in zip(("cache_write_row", "cache_write_rows"),
                              launches_per_step(k)):
            if launches[kname] != per * steps:
                raise AssertionError("%s: %s launched %d times in %d steps"
                                     % (name, kname, launches[kname], steps))
        got = {"tokens": _delta(after, before,
                                "mxnet_serve_decode_tokens_total"),
               "steps": _delta(after, before,
                               "mxnet_serve_decode_steps_total")}
        want = ({"tokens": st["tokens_generated"], "steps": steps}
                if setting == "on" else {"tokens": 0, "steps": 0})
        if got != want:
            raise AssertionError("%s: registry %s against %s"
                                 % (name, got, want))
        rate = st["tokens_generated"] / wall
        if run_jobs is window:
            pairs[int(name.split()[-1])][setting] = {"tokens_per_s": rate,
                                                     "window_s": wall}
        out["runs"][name] = {"k": k, "telemetry": setting, "steps": steps,
                             "tokens": st["tokens_generated"],
                             "tokens_per_s": rate, "launches": launches}
    first = [reps[0] for reps in streams["k=0 untimed"]]
    for name, got in streams.items():
        if any(r != first[i] for i, reps in enumerate(got) for r in reps):
            raise AssertionError("decode streams of %s differ from the "
                                 "untimed run's" % name)
    out["e_decode_pairs"] = pairs
    out["e_decode"] = {"tokens_per_s": _cost(pairs, "tokens_per_s")}
    log("  (c) %s [%s]" % ({n: (r["steps"], r["tokens"],
                                round(r["tokens_per_s"], 1))
                            for n, r in out["runs"].items()
                            if not n.startswith("k=0 o")}, card))
    return out


def telemetry_phase(torch, mt, fu, nn, kv, seed, card):
    """Phase 18 (see the module docstring): (a)-(e)."""
    t_phase = time.perf_counter()
    wrappers = kernel_wrappers(fu, nn, kv)
    if not mt.telemetry.enabled():
        raise AssertionError("telemetry is off (MXNET_TELEMETRY_ON=0): "
                             "phase 18 needs it on")
    out = {"serve": telemetry_serve(torch, mt, fu, nn, wrappers, seed,
                                    card),
           "fit": telemetry_fit(torch, mt, fu, nn, wrappers, seed, card),
           "decode": telemetry_decode(torch, mt, fu, nn, kv, wrappers, seed,
                                      card)}
    cost = {"serve_" + k: v for k, v in out["serve"]["e_serve"].items()}
    cost["decode_tokens_per_s"] = out["decode"]["e_decode"]["tokens_per_s"]
    cost["fit_step_ms"] = out["fit"]["e_fit"]["step_ms"]
    out["cost"] = cost
    out["phase_s"] = time.perf_counter() - t_phase
    log("  (e) on against off, %d pairs of turns, medians [%s]:"
        % (TELEMETRY_PAIRS, card))
    for k, c in cost.items():
        log("    %-24s on %10.4f  off %10.4f  pairs %+.2f%% (%+.2f%% to "
            "%+.2f%%), sign test p %.4f: %s"
            % (k, c["on"], c["off"], c["median_pct"], c["min_pct"],
               c["max_pct"], c["sign_p"],
               "resolved" if c["resolved"] else "unresolved"))
    log("  phase 18 took %.1f s" % out["phase_s"])
    log(json.dumps({"telemetry": {
        "cost_on_off": cost, "phase_share": out["fit"]["phase_share"],
        "mfu": out["fit"]["mfu"], "peak_flops": out["fit"]["peak_flops"],
        "serve_plain_graph_flops": out["serve"]["a"]["plain_graph_flops"],
        "memory_gauge_bytes": out["serve"]["a"]["memory_gauge_bytes"],
        "capture": out["serve"]["d_capture"],
        "decode": {n: {k: v for k, v in r.items() if k != "launches"}
                   for n, r in out["decode"]["runs"].items()
                   if not n.startswith("k=0 o")},
        "phase_s": out["phase_s"]}}))
    return out


def fmt(vals, spec="%.5f"):
    return "[" + ", ".join(spec % v for v in vals) + "]"


def log_profile(what, prof, card):
    log("  %s: host wall %.3f ms, device busy %.3f ms, idle share %s [%s]"
        % (what, prof["wall_ms"], prof["device_busy_ms"],
           "not measured" if prof["device_idle_share"] is None
           else "%.3f" % prof["device_idle_share"], card))
    for kname, ms in prof["top_device_ms"]:
        log("    %8.4f ms  %s" % (ms, kname[:100]))


if __name__ == "__main__":
    main()

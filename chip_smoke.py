#!/usr/bin/env python3
"""Drive the PyTorch port's SSD300 and DeepSpeech2 serving paths, its
DeepSpeech2 CTC training path, its SSD300 training path, its SSD input
path from JPEG records and SSD online serving through ``ServingRuntime``
once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the four CUDA kernels and the nvJPEG codec compiled with
   ``nvcc`` for sm_90a from ``analytics_zoo_tpu_torch/csrc``, and the
   host library of the input path with ``g++`` (in parallel, cached by
   source hash),
   each with its ptxas report; a register spill in K3 or K4 fails;
3. K1 (NMS sweep) against its plain PyTorch version at the SSD300 unfused
   shape (batch 8 → 160 rows × 512 candidates): random, tie-heavy,
   sparse and non-prefix-valid rows; then rows of several engine tiles
   (4 × 1536, 2 × 13000: random, and 1536 non-prefix-valid); keep masks
   must be equal;
4. K2 (fused DetectionOutput) against its plain version at SSD300
   (batch 8, P=8732, 21 classes; dense untrained and trained-like int8-tie
   confidences) and SSD512 geometry (P=24564), SSD512 at nms_topk 1000
   (two engine tiles a row), and SSD300 with five int8 score levels (the
   nms_topk boundary inside a run of equal scores): classes equal, scores
   within 1e-6, boxes within 1e-5;
4b. K3 (persistent-RNN forward) against its plain version, TF32 off: the
   DS2 shape (B=8, T=1500, H=1760, clipped ReLU) all valid and ragged,
   GRU and LSTM at B=8, T=200, H=512, the DS2 shape with bf16 weights,
   B=3, T=11, H=6 tanh masked, B=12 ragged at the DS2 width (two
   passes of 8 rows), the column slice of W in shared memory (GRU at
   H=1200, vanilla at H=1900) and in L2 (LSTM at H=1760), and an odd
   grid that runs without clusters (GRU at H=97); ``ys`` and the carry
   within a relative max-abs error of 1e-4 (fp32) or 2e-2 (bf16
   weights); each case's W source as the fit predicts, and every source
   launched; two launches at the DS2 shape bit-equal;
4c. K4 (persistent-RNN backward) against its plain version on random
   cotangents of both outputs, from the same saved carries: the DS2
   shape all valid and ragged, GRU and LSTM at B=8, T=200, H=512, B=3,
   T=11, H=6 tanh with ``time_block=3``, the DS2 shape with bf16
   weights, B=12, the column slice in L2 (H=1900) and the odd grid;
   d_pre, d_w, d_b and d_h0 within a relative L2 error of ``K4_TOL``
   (the relative max-abs error is reported beside it); at the clipped
   ReLU cases, every entry where the two take different branches within
   ``KINK_TOL`` of a kink and d_pre outside those entries' reach within
   ``K4_BRANCH_TOL``; K3's
   saved carries ``cs`` against the plain version's
   within K3's tolerance, and equal bit for bit to K3's own outputs at
   each block start; two launches at the DS2 shape bit-equal;
5. serving: ``SSDPredictor`` around a seeded random ``SSDVgg(21, 300)``
   answers 4 staged uint8 batches of 8 through ``backend="auto"`` (K2)
   and one through ``"pallas"`` (K1), with every launch counter set to 0
   just before and read just after; then "fused", "pallas" and the plain
   path must agree on one forward's (loc, probs), and the card's forward
   must agree with a CPU forward of the same weights;
5b. ds2_serving: ``DeepSpeech2Pipeline`` around a seeded random
   ``make_ds2_model(hidden=1760, n_rnn_layers=3, rnn_engine="pallas")``
   transcribes 10 seeded synthetic utterances (3-70 s, 17 segments of
   30 s, 3 batches of 8) with K3's launch counter set to 0 just before
   and read just after (6 launches a batch); transcripts over the
   alphabet; then on one batch the "pallas" and "blocked" engines, and
   the card's forward against a CPU forward of one segment;
5c. ds2_train: the same model in training through ``Optimizer`` with
   ``Adam(3e-4)`` and ``ds2_ctc_criterion`` on ``load_asr_train_set``
   batches of 8 seeded synthetic utterances of 3-30 s with random labels
   over the 29 characters, bucketed at 1000/2000/3000 frames: 3 distinct
   batches, then 5 steps on one 3000-frame batch (1500 frames after the
   conv), with K3's and K4's launch counters set to 0 just before and
   read just after (6 each a step); every loss finite and the repeated
   batch's falling; then, on one batch cut to 600 frames and a 1-layer
   model, the loss and every gradient of the "pallas" and "blocked"
   engines, and of the card and the CPU, within ``DS2_GRAD_TOL``;
6. timings with CUDA events at the main path's shapes: each kernel and
   its plain version, the forwards and the end-to-end batches; K1 and K2
   on dense and trained-like scores, K2 by launch (``k2_ms_by_kernel``,
   ``torch.profiler``: select and merge) and K2's and K1's blocks by
   phase (``detout_block_us``: the kernels' ``%globaltimer`` stamps);
   where a
   K3 and a K4 step goes at the DS2 shape (``k3_step_us``,
   ``k4_step_us``: the delivery, product, cell math and barrier from the
   kernels' step-phase stamps); K4 by ``time_block``; a DS2
   train step by the host clock, and one under ``torch.profiler``, split
   into the upload, forward and loss, backward and update, with the
   device's busy share of that step;
6b. ssd_train: a seeded ``SSDVgg(21, 300)`` (TF32 off) — one MultiBoxLoss
   and every gradient at batch 2 on the card and on the CPU (the loss
   within ``SSD_GRAD_TOL``, each gradient against an fp64 CPU computation
   as ``SSD_GRAD_TOL`` says), and ``match_priors`` and the negatives
   mining keeps equal on the card and the CPU (random logits, all-zero
   logits, two gts sharing a best prior); then ``train_ssd`` with the
   reference's ``TrainParams(max_epoch=1)`` (bf16, SGD
   under Plateau, updates skipped above a loss of 50) on 6 seeded
   batches of 32, validating on 2 batches of 8, every launch counter set
   to 0 just before and read just after (K2 once a validation batch, no
   other kernel; a fallback warning is an error); every loss finite; the
   validation detections against the CPU "xla" path on the same outputs
   (classes equal, scores within 1e-6, boxes within 1e-5); one bf16
   step against one fp32 step from the same weights on one batch: the
   loss within ``SSD_BF16_TOL``, the update of the weights within
   ``SSD_BF16_UPDATE_TOL`` (and each tensor's within
   ``SSD_BF16_UPDATE_TENSOR_TOL``), and the loss after it finite;
   then a ``timing`` line: the train step of 32 by the host clock (median
   of ``SSD_TIMED_STEPS``), the step's upload of one batch alone by the
   host clock (median of 3), one step under ``torch.profiler`` split into
   the upload, forward and loss (and ``multibox_loss`` inside it),
   backward and update, validation by the batch of 8, and the steps'
   peak memory;
6c. ssd_input: the SSD input path from records. 256 seeded shapes
   images at 300 rendered by ``data/synthetic.py`` and encoded through
   the card's codec (named in the line: nvJPEG where the machine has no
   libjpeg header) into 4 shards; the native reader and the pure-Python
   one give the same records; every record decodes to (300, 300, 3), a
   corrupt one to None; the codec's q92 round trip of 4 rendered images
   at least ``CODEC_PSNR_MIN`` dB.  ``load_train_set_device`` (batch 32,
   canvas 512, bgr) into ``train_ssd`` with its augment as
   ``device_transform`` and ``TrainParams(prefetch=2)``: one epoch of 6
   batches, validating through ``load_val_set`` on 16 records in
   batches of 8 (8 from the first shard at 300², 8 rendered at 412² and
   360 x 720, each one's im_info showing it resized to 300², not
   dropped), every launch counter set to 0 just before and read
   just after (K2 once a validation batch, no other kernel; a fallback
   warning is an error), the validation detections against the CPU
   "xla" path.  ``make_device_augment`` on the card against the CPU on
   one staged batch of 32 within ``AUG_CARD_TOL``; the batches
   ``device_prefetch(size=2)`` delivers bit-equal to synchronous
   uploads; after CUDA is initialised, ``ParallelLoader`` refusing
   worker processes on the decode chain (nvJPEG needs CUDA), and its
   stream over the staging chain of decoded images byte-identical at 0,
   2 and min(8, nproc / 2) workers; ``SSDPredictor.predict`` on the
   16 validation records through ``serving_chain(uint8=True)`` (each
   resized, as in validation), its launch counters
   set to 0 just before and read just after (K2 twice), equal to
   ``detect_batch`` on the same staged batches; cv2 never imported.
   Then a ``timing`` line: the host input rate of
   ``load_train_set_device`` at 0 and min(8, nproc / 2) workers, the
   staging chain's by workers, decode per image, the augment per batch
   (CUDA events), the pinning and the pinned upload of one staged batch,
   the step of 32 fed from records with prefetch 2 (median of 6 after 2)
   and fed the same batches resident on the card, one profiled step
   split into upload, device_transform, forward and loss, backward and
   update, and ``predict(records)`` per batch of 8 (over the 16, and
   a batch of the 300² records and one of the others apart), with the
   host resize of a 412² or 360 x 720 image to 300²;
6d. ssd_serving: SSD online serving at full width (SSD300, 21 classes,
   batch 8, ``DetectionOutputParam`` defaults, seeded weights).
   ``ssd_serving_tiers`` (fp, int8 weights, int8 with ``keep_topk`` 50)
   behind ``ServingRuntime(n_replicas=2, max_batch=8,
   queue_capacity=64)`` on the monotonic clock: 64 seeded float32
   requests submitted, then ``drain()``, every launch counter set to 0
   just before and read just after (K2 once a batch, K1 never); every
   request done, the accounting balanced, no fence, failure or shed; the
   rows equal to the fp predictor called directly.  Each rung forced in
   turn through ``pump(force=True)`` in ``SERVE_WINDOWS`` interleaved
   windows of one batch (ms a batch, the readback included; K2 once a
   window on every rung), each rung's rows equal to its predictor's, the
   fp rung's within K2's tolerances of the CPU "xla" path on the same
   forward outputs.  The int8 modes: the weight-only rung against fp32
   on the dequantized weights within ``DEQUANT_TOL``; the forwards of
   fp32 (TF32 off), bf16, the weight-only rung and
   ``SSDPredictor(quantize="int8")`` by CUDA events; the card's int32
   accumulators equal to the plain float64 version on ``INT8_LAYERS``,
   each layer timed in int8, fp32 and bf16; the weights' bytes on the
   card, fp32 against int8, each predictor built from a CPU model.  A
   predictor with ``DetectionOutputParam(approx_topk=True)``: K1 and no
   K2 in a ``torch.profiler`` trace and by the counters, the rows equal to
   the fused path's.  An overload burst (``BURST_ROUNDS`` of 3 batches'
   worth of submits against a queue of 2): its sheds, the ladder's
   transitions and the tiers that served, the accounting balanced, no
   request failed and no replica fenced;
7. the ``kernels`` line, then the device line last.

Exits non-zero, printing no result, when no CUDA device is present or
the port's package is not beside this script.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import subprocess
import sys
import time

# H100 SXM data-sheet peaks (dense): HBM bytes/s, fp32 outside the
# tensor cores (the kernels' IoU and compare arithmetic)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# operations of one IoU test as the kernels write it: 4 min/max, 2 widths,
# 2 clamps, 1 product, 3 for the area, 3 for the union, 1 divide, 1 compare
IOU_OPS = 17
BATCH = 8
# DS2 serving: the reference's serialized width, 30 s segments; 3-70 s
# utterances give 17 segments of 30 s, 3 batches of 8
DS2_HIDDEN = 1760
DS2_SECONDS = (3, 12, 25, 31, 45, 58, 70, 8, 20, 64)
# log-prob agreement of two DS2 forwards whose products sum in another
# order (K3 against the blocked loop, the card against the CPU)
DS2_LOGP_TOL = 1e-3
# K3 check cases: name, cell, activation, B, T, H, ragged lengths, w type
K3_CASES = [
    ("ds2", "vanilla", "clipped_relu", 8, 1500, 1760, False, "float32"),
    ("ds2_ragged", "vanilla", "clipped_relu", 8, 1500, 1760, True, "float32"),
    ("gru", "gru", "relu", 8, 200, 512, True, "float32"),
    ("lstm", "lstm", "relu", 8, 200, 512, True, "float32"),
    ("ds2_bf16_w", "vanilla", "clipped_relu", 8, 1500, 1760, False,
     "bfloat16"),
    ("nonaligned", "vanilla", "tanh", 3, 11, 6, True, "float32"),
    # two passes of 8 batch rows, the second ragged and half empty; tanh,
    # whose derivative has no kink, so the check sees the two passes and
    # not where a clipped ReLU's argument rounds across 0 (``K4_TOL``)
    ("ds2_b12", "vanilla", "tanh", 12, 1500, 1760, True, "float32"),
    # the column slice of W off the register path: in shared memory (K3;
    # K4 refuses the GRU, its row slice does not fit), and in L2 (K3's
    # LSTM, which K4 refuses; K4 at H=1900, where K3 takes shared memory)
    ("gru_shared", "gru", "relu", 8, 200, 1200, True, "float32"),
    ("lstm_l2", "lstm", "relu", 8, 200, 1760, True, "float32"),
    ("vanilla_l2", "vanilla", "tanh", 8, 200, 1900, True, "float32"),
    # one column a block, an odd grid of 97 blocks: no clusters
    ("odd_grid", "gru", "relu", 5, 40, 97, True, "float32"),
]
# K4 check cases: the K3 cases it takes, with the steps between saved
# carries
K4_CASES = [case + (3 if case[0] == "nonaligned" else 8,)
            for case in K3_CASES if case[0] not in ("gru_shared", "lstm_l2")]
# K4 against its plain version, relative L2 error by weight type.  The two
# recompute each block's forward in another summation order; where a
# clipped ReLU's argument lies within that rounding of 0 (a few of the
# 21M DS2 entries, more with bf16 weights, whose h rounds to bf16 at
# different values now and then), they take different branches and that
# d_pre entry differs by its whole cotangent, which then runs back
# through the chain.  Such isolated kinks dominate a max-abs error, not
# the L2 one: 2e-7 to 4e-6 measured without one, while a wrong gate, a
# stale h or a missed barrier moves it by 1e-2 or more
K4_TOL = {"float32": 1e-3, "bfloat16": 2e-2}
# the witness of that (``kink_witness``): each entry where the two take
# different branches has its argument within KINK_TOL of a kink (the two
# recomputes differ by ~1e-6 there), and d_pre outside what those entries
# reach back to (their rows, at their steps and before) agrees within
# K4_BRANCH_TOL relative L2, as K4 does in the cases without a kink
KINK_TOL = 1e-4
K4_BRANCH_TOL = 1e-5
# DS2 training on one reduced batch: loss and gradients of two
# computations of the same step (another summation order through the
# conv, the projections, K3/K4 or the blocked loop, and the CTC loss),
# each gradient's relative L2 error (robust to the clipped-ReLU kinks of
# ``K4_TOL``); a bias in front of a BN, whose gradient is 0 up to
# rounding, is held to the model's largest gradient norm instead
DS2_GRAD_TOL = 1e-3
# synthetic DS2 training set: 48 utterances of 3-30 s, evenly spread, in
# 8-utterance buckets of <= 1000, 2000 and 3000 frames
DS2_TRAIN_SECONDS = tuple(3.0 + 27.0 * i / 47 for i in range(48))
DS2_BUCKETS = (1000, 2000, 3000)


# SSD300 training at the reference's TrainParams batch: 6 batches of 32
# seeded images to train on, 2 of 8 to validate
SSD_TRAIN_BATCH, SSD_TRAIN_BATCHES = 32, 6
SSD_VAL_BATCH, SSD_VAL_BATCHES = 8, 2
# one MultiBoxLoss and its gradients on the card against the CPU, fp32,
# TF32 off, batch 2: the loss, and all the gradients as one vector, within
# SSD_GRAD_TOL relative (L2); each gradient's relative L2 error against an
# fp64 CPU computation of the same step within SSD_GRAD_TOL, or within
# twice the CPU fp32 result's own error where that is larger: the first
# layers' weight gradients sum 180,000 terms with heavy cancellation, and
# there fp32 itself is ~2e-3 from fp64 (conv1_1 measured 2.2e-3 on the
# CPU), so no two fp32 summation orders agree within 1e-3 a tensor
SSD_GRAD_TOL = 1e-3
# the bf16 train step's loss (autocast over fp32 weights) against the
# fp32 step's on the same weights and batch, relative
SSD_BF16_TOL = 2e-2
# the bf16 step's update (the change of the fp32 weights after one SGD
# step) against the fp32 step's, relative L2: all tensors as one vector
# (measured 8.3e-3; a wrong update of the right direction but scaled by
# 1 + e reads e), and the worst tensor (measured 8.4e-2, extra.conv7_1's
# bias; the median tensor 1.3e-2); NVIDIA H100 80GB HBM3, 700.00 W
SSD_BF16_UPDATE_TOL = 2e-2
SSD_BF16_UPDATE_TENSOR_TOL = 0.2
# host-clock train steps: 2 of warm-up, then the timed ones (median)
SSD_WARMUP_STEPS, SSD_TIMED_STEPS = 2, 6
# the SSD input path from records: shapes images at 300 in shards, train
# batches of 32 staged on the canvas of 512, 6 of them an epoch; the first
# 16 records of shard 0 validate in batches of 8 and are served in
# batches of 8
INPUT_IMAGES, INPUT_SHARDS, INPUT_BATCH, INPUT_STEPS = 256, 4, 32, 6
INPUT_VAL, INPUT_VAL_BATCH = 16, 8
# images the host input rates are timed over (4 batches)
INPUT_RATE_IMAGES = 128
# nvJPEG's q92 round trip of a rendered image: PSNR floor, dB
CODEC_PSNR_MIN = 35.0
# make_device_augment on the card against the CPU on one staged batch,
# max-abs in pixel levels: the same fp32 elementwise ops, the two
# products summed in another order (TF32 off)
AUG_CARD_TOL = 1e-3
# SSD serving through ServingRuntime: seeded requests, each rung forced
# in interleaved windows of one batch, the overload burst's rounds of 3
# batches' worth of submits against a queue of 2
SERVE_REQUESTS, SERVE_WINDOWS, BURST_ROUNDS = 64, 5, 12
# the int8 x int8 layers held equal to the plain version: conv1_2 (the
# largest im2col), fc6 (dilation 6), a conf head (N = 84, padded to 88)
# and conv6_2 (stride 2)
INT8_LAYERS = ("vgg.conv1_2", "vgg.fc6", "conf_0", "extra.conv6_2")
# the weight-only rung against fp32 on the dequantized weights: the same
# weights and the same convolutions, relative max-abs
DEQUANT_TOL = 1e-5


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rows_err(got, want) -> float:
    """Fail unless detection rows agree: classes equal, scores ≤ 1e-6,
    boxes ≤ 1e-5.  Returns the largest absolute difference."""
    import torch

    got, want = got.float().cpu(), want.float().cpu()
    if not torch.equal(got[..., 0], want[..., 0]):
        bad = (got[..., 0] != want[..., 0]).nonzero()[:5].tolist()
        raise AssertionError(f"class ids differ at {bad}")
    ds = (got[..., 1] - want[..., 1]).abs().max().item()
    db = (got[..., 2:] - want[..., 2:]).abs().max().item()
    if ds > 1e-6 or db > 1e-5:
        raise AssertionError(f"score err {ds} (tol 1e-6), box err {db} "
                             "(tol 1e-5)")
    return max(ds, db)


def sweep_planes(rng, C, K, kind):
    """(C,K) score-sorted candidate planes for K1."""
    import numpy as np

    xy = rng.rand(C, K, 2)
    boxes = np.concatenate([xy, xy + rng.rand(C, K, 2) * 0.3 + 0.02], -1)
    valid = np.ones((C, K), np.float32)
    if kind == "ties":              # runs of identical boxes: IoU exactly 1
        boxes[:, 1::2] = boxes[:, 0::2]
    if kind == "sparse":            # short valid prefixes, as in serving
        valid = (np.arange(K)[None] < rng.randint(0, 40, (C, 1))
                 ).astype(np.float32)
    if kind == "non_prefix":        # invalid lanes scattered through a row
        valid = (rng.rand(C, K) < 0.6).astype(np.float32)
    boxes = boxes.astype(np.float32)
    return [np.ascontiguousarray(boxes[..., i]) for i in range(4)] + [valid]


def sweep_ops(keep, valid) -> int:
    """IoU tests the greedy sweep needs on this data: each kept candidate
    against the candidates after it up to the row's last valid lane."""
    import torch

    K = keep.shape[1]
    lanes = torch.arange(K, device=keep.device)
    n_valid = torch.where(valid > 0, lanes + 1, 0).amax(1, keepdim=True)
    later = (n_valid - lanes - 1).clamp(min=0)
    return int(((keep > 0) * later).sum().item()) * IOU_OPS


def detout_work(loc, conf, priors, variances, param):
    """(bytes, operations) the fused DetectionOutput needs on these
    inputs: every input read once and the output written once; the
    decode (20 ops a prior), the confidence filter (1 a score), ranking
    the candidates (n·log2 n compares a row), one IoU test of each kept
    candidate against each candidate ranked after it inside the row's
    nms_topk window, and the merge (keep_topk·log2 C_fg)."""
    import torch

    from analytics_zoo_tpu_torch.ops.pallas_detout import (foreground_ids,
                                                           fused_keep_plain)

    B, P, C = conf.shape
    _, keep = fused_keep_plain(loc, conf, priors, variances, param)
    fg = torch.as_tensor(foreground_ids(C, param.background_id),
                         device=conf.device)
    s = conf.index_select(2, fg).transpose(1, 2)
    valid = s > param.conf_thresh
    n_valid = valid.sum(-1)
    n_pop = n_valid.clamp(max=param.nms_topk)
    # rank of each prior in its row's descending stable order
    order = torch.sort(torch.where(valid, s, float("-inf")), dim=-1,
                       descending=True, stable=True)[1]
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(P, device=conf.device).expand_as(order))
    later = (n_pop[..., None] - rank - 1).clamp(min=0)
    iou_tests = int(((keep > 0) * later).sum().item())
    nv = n_valid.double().clamp(min=2)
    ops = (B * P * 20 + B * len(fg) * P
           + int((nv * torch.log2(nv)).sum().item())
           + iou_tests * IOU_OPS
           + B * param.keep_topk * max(1, math.ceil(math.log2(len(fg)))))
    nbytes = 4 * (loc.numel() + conf.numel() + 8 * P
                  + B * param.keep_topk * 6)
    return nbytes, ops


def bound(nbytes: int, ops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def synthetic_conf(rng, B, P, C, regime):
    """Softmax confidences: "dense" (untrained, near uniform) or
    "trained" (background-dominated, a few hot priors, int8-quantized so
    scores tie in bulk)."""
    import numpy as np

    logits = rng.randn(B, P, C).astype(np.float32)
    if regime == "trained":
        logits[..., 0] += 7.0
        hot = rng.rand(B, P) < 0.05
        logits[..., 1:] += np.where(hot[..., None], 9.0, 0.0)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    conf = e / e.sum(-1, keepdims=True)
    if regime == "trained":
        conf = np.round(conf * 127.0) / 127.0
    return conf.astype(np.float32)


def rnn_inputs(rng, dev, cell, B, T, H, ragged, wdt):
    """K3 inputs at DS2's activation scale: unit-variance projections
    (what the BN before each BiRNN gives), lecun-scaled h2h weights,
    zero bias and carry; ``ragged`` draws per-row lengths in [T/2, T]."""
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.ops.pallas_rnn import CELL_CARRY, CELL_GATES

    k, C = CELL_GATES[cell], CELL_CARRY[cell]
    pre = rng.randn(B, T, k * H).astype(np.float32)
    w = (rng.randn(H, k * H) / np.sqrt(H)).astype(np.float32)
    n = (rng.randint(T // 2, T + 1, B) if ragged else np.full(B, T)
         ).astype(np.int32)
    return (torch.from_numpy(pre).to(dev),
            torch.from_numpy(w).to(dev).to(wdt),
            torch.zeros(k * H, device=dev), torch.zeros(C, B, H, device=dev),
            torch.from_numpy(n).to(dev))


def rnn_work(pre, w, b, h0, n):
    """(bytes, operations) of one K3 call on these inputs: pre, w, b, h0
    and n read once, ys and the carry written once; 2·H·k·H operations a
    valid (row, step) for the product (masked steps do no work)."""
    B, T, kH = pre.shape
    H = w.shape[0]
    nbytes = (pre.numel() * pre.element_size() + w.numel() * w.element_size()
              + 4 * (b.numel() + 2 * h0.numel() + B + B * T * H))
    return nbytes, 2 * H * kH * int(n.sum().item())


def rnn_bwd_work(pre, w, b, n, cs, g_ys, g_cf):
    """(bytes, operations) of one K4 call on these inputs: pre, g_ys, cs,
    w, b, g_cf and n read once, d_pre, d_w, d_b and d_h0 written once;
    three products of 2·H·k·H operations a valid (row, step): the
    recompute, the dh chain and dW (masked steps do no work)."""
    B, T, kH = pre.shape
    H = w.shape[0]
    nbytes = (4 * (2 * pre.numel() + g_ys.numel() + cs.numel()
                   + 2 * b.numel() + 2 * g_cf.numel() + B)
              + 2 * w.numel() * w.element_size())
    return nbytes, 3 * 2 * H * kH * int(n.sum().item())


def rnn_step_split(k4_inputs, h0):
    """Where a step goes, from one K3 and one K4 launch at the DS2 shape
    with the step-phase stamps on (``pallas_rnn.step_split_us``): µs a
    step of the delivery of h, the product, the cell math and the
    barrier, for K3 and for each chain of K4."""
    import torch

    from analytics_zoo_tpu_torch.ops import pallas_rnn

    cfg, pre, w, b, n, cs, g_ys, g_cf = k4_inputs
    B, T, _ = pre.shape
    H = w.shape[0]
    stamps = torch.zeros(pallas_rnn.STAMP_WORDS, dtype=torch.int64,
                         device=pre.device)
    ys = torch.empty((B, T, H), device=pre.device)
    cf = torch.empty_like(h0)
    pallas_rnn._launch_persistent_rnn(cfg, pre, w, b, h0, n, ys, cf, None,
                                      stamps)
    torch.cuda.synchronize()
    k3 = pallas_rnn.step_split_us(stamps, 0, "forward")
    stamps.zero_()
    pallas_rnn._launch_persistent_rnn_bwd(*k4_inputs, stamps=stamps)
    torch.cuda.synchronize()
    return k3, {"recompute": pallas_rnn.step_split_us(stamps, 0, "forward"),
                "dh": pallas_rnn.step_split_us(stamps, 1, "dh")}


def cudnn_relu_rnn(pre, w, b):
    """cuDNN's relu RNN (``torch.nn.RNN``) on the hoisted projections,
    fed through an identity input weight: the nearest library call to
    K3.  Not the same function (relu, not clipped at 20)."""
    import torch

    H = w.shape[0]
    rnn = torch.nn.RNN(H, H, nonlinearity="relu", batch_first=True).to(
        pre.device)
    with torch.no_grad():
        rnn.weight_ih_l0.copy_(torch.eye(H))
        rnn.bias_ih_l0.zero_()
        rnn.weight_hh_l0.copy_(w.float().t())
        rnn.bias_hh_l0.copy_(b)
    return rnn


def cudnn_relu_rnn_bwd_ms(pre, w, b, g_ys) -> float:
    """The nearest library yardstick of K4: cuDNN's relu RNN forward and
    backward (the gradients of the input and of every weight) on the same
    projections, minus its forward alone."""
    import torch

    rnn = cudnn_relu_rnn(pre, w, b)
    x = pre.detach().requires_grad_()
    weights = list(rnn.parameters())

    def fwd():
        return rnn(x)[0]

    def fwd_bwd():
        torch.autograd.grad(fwd(), [x] + weights, g_ys)

    return cuda_ms(fwd_bwd, 5, 1) - cuda_ms(fwd, 5, 1)


def ds2_train_set(seed):
    """Seeded synthetic utterances of ``DS2_TRAIN_SECONDS`` with random
    labels over the 28 characters (2 a second of audio plus 5), padded
    into the (samples, sample_lengths, labels) arrays of
    ``load_asr_train_set``."""
    import numpy as np

    utts = synthetic_utterances(DS2_TRAIN_SECONDS, seed)
    lengths = np.array([len(u) for u in utts.values()], np.int64)
    samples = np.zeros((len(utts), lengths.max()), np.float32)
    rng = np.random.RandomState(seed)
    n_label = (2 * np.asarray(DS2_TRAIN_SECONDS) + 5).astype(int)
    labels = np.zeros((len(utts), n_label.max()), np.int32)
    for i, u in enumerate(utts.values()):
        samples[i, :len(u)] = u
        labels[i, :n_label[i]] = rng.randint(1, 29, n_label[i])
    return samples, lengths, labels


def loss_and_grads(model, batch, criterion):
    """One training forward and backward of ``model`` on ``batch`` (on
    the model's device): the loss and each parameter's gradient."""
    from analytics_zoo_tpu_torch.parallel.train import to_device

    dev = next(model.parameters()).device
    batch = to_device(batch, dev)
    model.train()
    model.zero_grad(set_to_none=True)
    loss = criterion(model(*batch["input"]), batch)
    loss.backward()
    grads = {k: p.grad.detach().cpu()
             for k, p in model.named_parameters()}
    return loss.item(), grads


def grads_err(got, want):
    """Each gradient's relative L2 error: against its own norm, or the
    model's largest for a bias in front of a BN (``conv1``, ``proj{i}``),
    whose gradient is 0 up to rounding."""
    top = max(g.norm().item() for g in want.values())
    errs = {}
    for k, g in want.items():
        before_bn = k.endswith(".bias") and k.split(".")[0].startswith(
            ("conv1", "proj"))
        errs[k] = (got[k] - g).norm().item() / (
            top if before_bn else g.norm().item())
    return errs


def profile_train_step(fn, top: int = 8):
    """One call of ``fn`` (a train step of ``make_train_step``) under
    ``torch.profiler``, every number read from that one trace (its chrome
    export): the device time of each kernel, summed by name (ms, the
    ``top`` largest); the device time of the kernels launched inside each
    of the step's ranges (``upload``, ``forward_loss``, ``backward``,
    ``update``, and ``multibox_loss`` inside ``forward_loss`` where the
    criterion is SSD's), summed over every instance of a range (one a
    microbatch), a kernel going to the range that holds its launch on the
    host clock, whatever thread launched it (autograd runs the backward on
    a thread of its own); the step's span, from the start of its ``train_step``
    range to the end of its last kernel; and the share of that span in
    which the device ran something (overlapping kernels counted once,
    so the share is at most 1)."""
    import os
    import tempfile

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
            trace = json.load(f)["traceEvents"]
    ranges, launch_us, device = {}, {}, []
    for e in trace:
        cat, args = e.get("cat"), e.get("args", {})
        if cat == "user_annotation" and e["name"].startswith(
                ("train_step", "multibox_loss")):
            ranges.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e["dur"]))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launch_us[args["correlation"]] = e["ts"]
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((e["ts"], e["ts"] + e["dur"], e["name"],
                           args.get("correlation")))
    ((t0, t1),) = ranges["train_step"]
    device = [d for d in device if t0 <= launch_us.get(d[3], -1) <= t1]
    span_us = max([t1] + [d[1] for d in device]) - t0
    by_name, parts = {}, {}
    for start, end, name, corr in device:
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + (end - start) / 1e3
        for part, spans in ranges.items():
            if part != "train_step" and any(
                    r0 <= launch_us[corr] <= r1 for r0, r1 in spans):
                key = part.split(".", 1)[-1]
                parts[key] = parts.get(key, 0.0) + (end - start) / 1e3
    busy_us, cur0, cur1 = 0.0, None, None
    for start, end, _, _ in sorted(device):
        if cur1 is None or start > cur1:
            busy_us += 0.0 if cur1 is None else cur1 - cur0
            cur0, cur1 = start, end
        else:
            cur1 = max(cur1, end)
    busy_us += 0.0 if cur1 is None else cur1 - cur0
    ranked = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:top])
    return {"span_ms": span_us / 1e3, "kernel_ms": sum(by_name.values()),
            "busy_share": busy_us / span_us, "kernel_ms_by_part": parts,
            "kernel_ms_by_name": ranked}


def cudnn_relu_rnn_ms(pre, w, b) -> float:
    """cuDNN's relu RNN (``torch.nn.RNN``) on the hoisted projections,
    fed through an identity input weight: the nearest library call to
    K3.  Not the same function (relu, not clipped at 20)."""
    import torch

    rnn = cudnn_relu_rnn(pre, w, b)
    with torch.inference_mode():
        return cuda_ms(lambda: rnn(pre), 5, 1)


def synthetic_utterances(seconds, seed):
    """Seeded 16 kHz audio: a few drifting tones under noise."""
    import numpy as np

    rng = np.random.RandomState(seed)
    out = {}
    for i, sec in enumerate(seconds):
        t = np.arange(int(sec * 16000)) / 16000.0
        x = 0.02 * rng.randn(t.size)
        for _ in range(3):
            f0, df = rng.uniform(100, 3000), rng.uniform(-50, 50)
            x += 0.1 * np.sin(2 * np.pi * (f0 + df * t) * t)
        out[f"utt{i}"] = x.astype(np.float32)
    return out


def kernel_ms_by_name(fn, match: str = "rnn"):
    """Device ms of each kernel whose name holds ``match`` in one call of
    ``fn``, from ``torch.profiler`` (K4's sweep and its dW/db launch)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = (getattr(ev, "device_time_total", None)
              or getattr(ev, "cuda_time_total", 0))
        if match in ev.key:
            out[ev.key[:60]] = us / 1e3
    return out


def check_no_spills(ptxas) -> None:
    """Fail if ptxas spilled registers in K3 or K4: their column slice of
    W is meant to live in registers, and a spill moves it to local
    memory."""
    import re

    for name in ("persistent_rnn", "persistent_rnn_bwd"):
        spilled = [ln for ln in ptxas.get(name, [])
                   if any(int(x) for x in re.findall(
                       r"(\d+) bytes spill", ln))]
        if spilled:
            raise AssertionError(f"{name}: ptxas spilled: {spilled}")


def check_repeatable(name, fn) -> None:
    """Fail unless two launches of ``fn`` give bit-equal outputs."""
    import torch

    first, again = fn(), fn()
    if not all(torch.equal(x, y) for x, y in zip(first, again)):
        raise AssertionError(f"{name}: two launches differ")


def kink_witness(cfg, pre, w, b, n, cs, got_dpre, want_dpre):
    """Where K4 and its plain version take different branches of the
    clipped ReLU (one d_pre entry 0, the other above 1e-3 of the rms:
    smaller ones are rounding around a cotangent of 0 and stay in the
    error below), how far the plain recompute's argument lies from the
    nearest kink (0 or 20) there, and the relative L2 error of d_pre
    outside what those entries reach back to: a row's steps up to its
    last such entry.  The first 8 such entries are listed as (row, step,
    column, argument, K4's d_pre, the plain d_pre)."""
    import torch

    B, T, _ = pre.shape
    U = cfg.time_block
    wf, bf = w.float(), b.float()
    z = torch.empty_like(pre)
    steps = torch.arange(T, device=pre.device)
    for blk in range(cs.shape[0]):              # as the plain version does
        h = cs[blk, -1]
        for t in range(blk * U, min(T, blk * U + U)):
            z[:, t] = pre[:, t] + (h.to(w.dtype).float() @ wf + bf)
            h = torch.where((n > t)[:, None], z[:, t].clamp(0.0, 20.0), h)
    valid = (steps[None, :] < n[:, None])[..., None]
    big = torch.maximum(got_dpre.abs(), want_dpre.abs()) > (
        1e-3 * want_dpre.square().mean().sqrt())
    flips = valid & big & ((got_dpre == 0) != (want_dpre == 0))
    kink = torch.minimum(z.abs(), (z - 20.0).abs())
    last = torch.where(flips.any(-1), steps[None, :], -1).amax(1)
    outside = steps[None, :] > last[:, None]
    diff = (got_dpre - want_dpre)[outside]
    at = flips.nonzero()[:8]
    return {"flips": int(flips.sum().item()),
            "flip_max_kink_distance": (kink[flips].max().item()
                                       if flips.any() else 0.0),
            "flip_entries": [[*map(int, i), z[tuple(i)].item(),
                              got_dpre[tuple(i)].item(),
                              want_dpre[tuple(i)].item()]
                             for i in at.tolist()],
            "share_outside": outside.float().mean().item(),
            "d_pre_rel_l2_outside": (diff.norm() / want_dpre[outside].norm(
                ).clamp(min=1e-12)).item()}


def ssd_batch(rng, B, max_gt=100):
    """A seeded SSD300 batch in the collate layout of the reference's
    ``RoiImageToBatch``: mean-subtracted float images, ``im_info``, and
    1-10 random gt boxes an image (sides of 5-95% of the image, so that
    every head's priors match some) padded to ``max_gt`` under a mask."""
    import numpy as np

    from analytics_zoo_tpu_torch.data import pad_ragged
    from analytics_zoo_tpu_torch.pipelines.ssd import BGR_MEANS

    images = (rng.randint(0, 256, (B, 300, 300, 3), dtype=np.uint8)
              .astype(np.float32) - np.float32(BGR_MEANS))
    boxes, labels = [], []
    for _ in range(B):
        n = rng.randint(1, 11)
        wh = rng.rand(n, 2) * 0.9 + 0.05
        xy = rng.rand(n, 2) * (1.0 - wh)
        boxes.append(np.concatenate([xy, xy + wh], 1))
        labels.append(rng.randint(1, 21, (n, 1)))
    bboxes, mask = pad_ragged(boxes, max_gt)
    lab, _ = pad_ragged(labels, max_gt)
    return {"input": images,
            "im_info": np.tile(np.float32([300, 300, 1, 1]), (B, 1)),
            "target": {"bboxes": bboxes, "labels": lab[..., 0].astype(
                np.int32), "difficult": np.zeros_like(mask), "mask": mask}}


def ssd_loss_and_grads(model, batch, criterion):
    """One training forward and backward of an SSD on ``batch`` (on the
    model's device, in its parameters' type; the criterion matches and
    mines in fp32 whatever that type): the MultiBoxLoss and each
    parameter's gradient."""
    import torch

    p = next(model.parameters())
    model.train()
    model.zero_grad(set_to_none=True)
    loss = criterion(model(torch.from_numpy(batch["input"]).to(
        p.device, p.dtype)), batch["target"])
    loss.backward()
    return loss.item(), {k: p.grad.detach().cpu()
                         for k, p in model.named_parameters()}


def ssd_train_phase(dev, smi, rng):
    """The SSD300 training path on the card (phase ``ssd_train``, then a
    ``timing`` line); returns K2's launch count of its run."""
    import statistics

    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.models.ssd import (SSDVgg, build_priors,
                                                    ssd300_config)
    from analytics_zoo_tpu_torch.ops.multibox_loss import (
        MultiBoxLoss, MultiBoxLossParam, match_priors, mine_hard_examples)
    from analytics_zoo_tpu_torch.parallel import (SGD, create_train_state,
                                                  make_eval_step,
                                                  make_train_step, validate)
    from analytics_zoo_tpu_torch.parallel.train import to_device
    from analytics_zoo_tpu_torch.pipelines import ssd as ssd_pipe

    cpu = torch.device("cpu")
    priors, variances = build_priors(ssd300_config())
    criterion = MultiBoxLoss(priors, variances)

    # 1. the card against the CPU: one loss and every gradient at batch 2
    # (same seeded weights), both against fp64 on the CPU; then matching
    # and mining on three inputs
    small = ssd_batch(rng, 2)
    loss_g, grads_g = ssd_loss_and_grads(SSDVgg(21, 300, device=dev, seed=0),
                                         small, criterion)
    loss_c, grads_c = ssd_loss_and_grads(SSDVgg(21, 300, device=cpu, seed=0),
                                         small, criterion)
    _, grads_64 = ssd_loss_and_grads(
        SSDVgg(21, 300, device=cpu, seed=0).double(), small, criterion)

    def rel_l2(got, want):
        return {k: ((got[k].double() - w).norm()
                    / w.norm().clamp(min=1e-30)).item()
                for k, w in want.items()}

    grad_err = rel_l2(grads_g, grads_c)
    all_err = rel_l2(*({"all": torch.cat([g.flatten() for g in gr.values()])}
                       for gr in (grads_g, grads_c)))["all"]
    card_64, cpu_64 = rel_l2(grads_g, grads_64), rel_l2(grads_c, grads_64)
    over = {k: (card_64[k], cpu_64[k]) for k in grads_64
            if card_64[k] > max(SSD_GRAD_TOL, 2 * cpu_64[k])}
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    masks_equal, kept = {}, {}
    for case in ("random_logits", "zero_logits", "shared_best_prior"):
        tgt = ssd_batch(rng, 4)["target"]
        if case == "shared_best_prior":      # the later gt wins the prior
            tgt["mask"][0, :2] = 1.0
            tgt["labels"][0, :2] = (3, 7)
            tgt["bboxes"][0, 0] = priors[4000]
            tgt["bboxes"][0, 1] = priors[4000] + np.float32(
                [0.002, 0.0, 0.002, 0.0])
        logits = (np.zeros((4, priors.shape[0], 21), np.float32)
                  if case == "zero_logits" else
                  rng.randn(4, priors.shape[0], 21).astype(np.float32))
        got = []
        for d in (dev, cpu):
            m, pos, iou = match_priors(
                *(torch.from_numpy(a).to(d) for a in (
                    priors, tgt["bboxes"], tgt["mask"])))
            logp = torch.log_softmax(torch.from_numpy(logits).to(d), -1)
            negs = [mine_hard_examples(logp, pos, iou, MultiBoxLossParam(
                mining=mode)) for mode in ("sort", "topk")]
            got.append([t.cpu() for t in (m, pos, *negs)])
        masks_equal[case] = all(torch.equal(a, b) for a, b in zip(*got))
        if case == "shared_best_prior":
            masks_equal[case] &= int(got[0][0][0, 4000]) == 1
        kept[case] = {"positives": int(got[0][1].sum()),
                      "negatives": int(got[0][2].sum())}
    if not (all(masks_equal.values()) and loss_err <= SSD_GRAD_TOL
            and all_err <= SSD_GRAD_TOL and not over):
        raise AssertionError(f"SSD card vs CPU: loss {loss_err}, all "
                             f"gradients {all_err}; gradients (card, CPU) "
                             f"against fp64 {over} (tol {SSD_GRAD_TOL} or "
                             f"twice the CPU's); matching and mining equal "
                             f"{masks_equal}")

    # 2. train_ssd: one epoch of the reference's TrainParams (bf16,
    # Plateau), validating through K2; a fallback warning is an error
    train_set = [ssd_batch(rng, SSD_TRAIN_BATCH)
                 for _ in range(SSD_TRAIN_BATCHES)]
    val_set = [ssd_batch(rng, SSD_VAL_BATCH) for _ in range(SSD_VAL_BATCHES)]
    model = SSDVgg(21, 300, device=dev, seed=0)
    params = ssd_pipe.TrainParams(max_epoch=1)
    opt, seen, launches, train_s = recorded_train_ssd(train_set, val_set,
                                                      params, model)

    # 3. every loss finite; K2 once a validation batch; the validation
    # detections against the CPU "xla" path on the same outputs
    losses, val_err, val_kept = check_train_ssd_run(
        opt, seen, launches, SSD_TRAIN_BATCHES, SSD_VAL_BATCHES)

    # 4. one bf16 step against one fp32 step from the same weights on the
    # same batch: the loss, the update (the change of the fp32 weights),
    # and the loss on that batch after the update
    first, after, moved = {}, {}, {}
    for cd in (None, "bf16"):
        m = SSDVgg(21, 300, device=dev, seed=0)
        start = {k: p.detach().clone() for k, p in m.named_parameters()}
        sgd = SGD(params.learning_rate, momentum=params.momentum,
                  weight_decay=params.weight_decay)
        step = make_train_step(m, criterion, sgd, skip_loss_above=50.0,
                               compute_dtype=cd)
        state, metrics = step(create_train_state(m, sgd), train_set[0])
        key = cd or "fp32"
        first[key] = metrics["loss"].item()
        moved[key] = {k: (p.detach() - start[k]).double()
                      for k, p in m.named_parameters()}
        after[key] = step(state, train_set[0])[1]["loss"].item()
        del m, step, state, start
    bf16_err = abs(first["bf16"] - first["fp32"]) / abs(first["fp32"])
    update_err = {k: ((moved["bf16"][k] - d).norm()
                      / d.norm().clamp(min=1e-30)).item()
                  for k, d in moved["fp32"].items()}
    update_err_all = (
        torch.cat([(moved["bf16"][k] - d).flatten()
                   for k, d in moved["fp32"].items()]).norm()
        / torch.cat([d.flatten() for d in moved["fp32"].values()]).norm()
    ).item()
    worst_update = max(update_err, key=update_err.get)
    del moved
    if not (bf16_err <= SSD_BF16_TOL
            and update_err_all <= SSD_BF16_UPDATE_TOL
            and update_err[worst_update] <= SSD_BF16_UPDATE_TENSOR_TOL
            and all(math.isfinite(x) for x in after.values())):
        raise AssertionError(
            f"SSD bf16 step against fp32: loss {first} (tol "
            f"{SSD_BF16_TOL}), update {update_err_all} (tol "
            f"{SSD_BF16_UPDATE_TOL}), worst tensor {worst_update} "
            f"{update_err[worst_update]} (tol "
            f"{SSD_BF16_UPDATE_TENSOR_TOL}), loss after it {after}")
    emit("ssd_train", batch=SSD_TRAIN_BATCH, steps=len(losses),
         losses=losses, skipped_steps=sum(x > 50.0 for x in losses),
         compute_dtype=params.compute_dtype, lr_scale=opt.optim.lr_scale,
         validation=opt.val_history, launches=launches,
         validation_batches=len(seen), validation_detections=val_kept,
         validation_rows_max_abs_err=val_err, train_ssd_s=train_s,
         loss_rel_err_card_vs_cpu=loss_err,
         grad_rel_l2_card_vs_cpu_all=all_err,
         grad_rel_l2_card_vs_cpu_max=max(grad_err.values()),
         grad_rel_l2_card_vs_cpu=grad_err,
         grad_rel_l2_vs_fp64={k: [card_64[k], cpu_64[k]] for k in card_64},
         tolerance=SSD_GRAD_TOL,
         matching_and_mining_equal_card_vs_cpu=masks_equal,
         matching_and_mining_counts=kept, first_step_loss=first,
         loss_after_first_update=after,
         bf16_loss_rel_err=bf16_err, bf16_tolerance=SSD_BF16_TOL,
         bf16_update_rel_l2_all=update_err_all,
         bf16_update_rel_l2_worst=[worst_update, update_err[worst_update]],
         bf16_update_rel_l2=update_err,
         bf16_update_tolerance=[SSD_BF16_UPDATE_TOL,
                                SSD_BF16_UPDATE_TENSOR_TOL])

    # 5. timing: host-clock steps of 32 (bf16, as train_ssd runs them),
    # one profiled step, validation by the batch, peak memory
    sgd = SGD(params.learning_rate, momentum=params.momentum,
              weight_decay=params.weight_decay)
    step = make_train_step(model, criterion, sgd, skip_loss_above=50.0,
                           compute_dtype=params.compute_dtype)
    state = create_train_state(model, sgd)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for i in range(SSD_WARMUP_STEPS + SSD_TIMED_STEPS):
        t0 = time.perf_counter()
        state, _ = step(state, train_set[i % len(train_set)])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    timed = step_ms[SSD_WARMUP_STEPS:]
    upload_ms = []                   # the step's upload alone, host clock
    for _ in range(3):
        t0 = time.perf_counter()
        to_device(train_set[0], dev)
        torch.cuda.synchronize()
        upload_ms.append((time.perf_counter() - t0) * 1e3)
    trace = profile_train_step(lambda: step(state, train_set[0]))
    evaluator = ssd_pipe.SSDMeanAveragePrecision()
    eval_step = make_eval_step(model, compute_dtype=params.compute_dtype)
    model.eval()
    validate(model, val_set, [evaluator], eval_step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    validate(model, val_set, [evaluator], eval_step)
    val_ms = (time.perf_counter() - t0) * 1e3 / len(val_set)
    emit("timing", nvidia_smi=smi,
         ssd_train_step_ms=statistics.median(timed),
         ssd_train_step_ms_each=step_ms, ssd_train_batch=SSD_TRAIN_BATCH,
         ssd_train_images_per_s=(SSD_TRAIN_BATCH * 1e3
                                 / statistics.median(timed)),
         ssd_train_step_profiled=trace,
         ssd_train_upload_ms=statistics.median(upload_ms),
         ssd_validation_ms_per_batch=val_ms,
         ssd_validation_batch=SSD_VAL_BATCH, ssd_train_peak_gb=peak_gb)
    return {"k2_launches": launches["fused_detection_output"]}


def recorded_train_ssd(train_set, val_set, params, model, **kw):
    """``train_ssd`` with its ``Optimizer`` and each validation batch's
    (loc, probs, detections) recorded, every launch counter set to 0 just
    before and read just after, a fallback warning an error.  Returns
    (the optimizer, the validation records, the launches, seconds)."""
    import warnings

    import torch

    from analytics_zoo_tpu_torch.ops import (pallas_detout, pallas_nms,
                                             pallas_rnn)
    from analytics_zoo_tpu_torch.pipelines import ssd as ssd_pipe

    runs, seen = [], []

    class RecordingOptimizer(ssd_pipe.Optimizer):
        def optimize(self):
            runs.append(self)
            return super().optimize()

    class RecordingMAP(ssd_pipe.SSDMeanAveragePrecision):
        def detect(self, output):
            dets = super().detect(output)
            # the same softmax on the same logits: the probabilities K2 read
            seen.append((output[0].cpu(),
                         torch.softmax(output[1], dim=-1).cpu(), dets.cpu()))
            return dets

    counters = (pallas_nms.nms_sweep, pallas_detout.fused_detection_output,
                pallas_rnn.persistent_rnn, pallas_rnn.persistent_rnn_bwd)
    patched = (ssd_pipe.Optimizer, ssd_pipe.SSDMeanAveragePrecision)
    ssd_pipe.Optimizer, ssd_pipe.SSDMeanAveragePrecision = (RecordingOptimizer,
                                                            RecordingMAP)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*falling back")
            torch.cuda.synchronize()
            for counter in counters:
                counter.launches = 0
            t0 = time.perf_counter()
            ssd_pipe.train_ssd(train_set, val_set, params, model=model, **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {c.__name__: c.launches for c in counters}
    finally:
        ssd_pipe.Optimizer, ssd_pipe.SSDMeanAveragePrecision = patched
    (opt,) = runs
    return opt, seen, launches, seconds


def check_train_ssd_run(opt, seen, launches, steps, val_batches):
    """Every loss finite, ``steps`` steps; K2 once a validation batch and
    no other kernel; the validation detections against the CPU "xla"
    path on the same outputs.  Returns (losses, the rows' max error, the
    detections kept)."""
    import torch

    from analytics_zoo_tpu_torch.models.ssd import (build_priors,
                                                    ssd300_config)
    from analytics_zoo_tpu_torch.ops.detection_output import (
        DetectionOutputParam, detection_output)

    losses = [m["loss"].item() for m in opt.history]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"SSD training losses {losses}")
    if (launches["fused_detection_output"] < val_batches
            or launches["fused_detection_output"] != len(seen)
            or any(v for k, v in launches.items()
                   if k != "fused_detection_output")):
        raise AssertionError(f"SSD training: validation of {len(seen)} "
                             f"batches launched {launches}")
    priors, variances = build_priors(ssd300_config())
    xla = DetectionOutputParam(n_classes=21, backend="xla")
    pri_c, var_c = torch.from_numpy(priors), torch.from_numpy(variances)
    val_err = max(rows_err(dets, detection_output(loc, probs, pri_c, var_c,
                                                  xla))
                  for loc, probs, dets in seen)
    val_kept = sum(int((d[..., 1] > 0).sum()) for _, _, d in seen)
    return losses, val_err, val_kept


def first_batches(iterable, n):
    """The first ``n`` items of one pass over ``iterable``, the pass's
    iterator closed after (a loader epoch's workers, a prefetch thread)."""
    it = iter(iterable)
    try:
        return [b for _, b in zip(range(n), it)]
    finally:
        if hasattr(it, "close"):
            it.close()


class FirstBatches:
    """Each epoch of ``dataset`` cut to its first ``n`` batches."""

    def __init__(self, dataset, n):
        self.dataset, self.n = dataset, n

    def __iter__(self):
        it = iter(self.dataset)
        try:
            for _, b in zip(range(self.n), it):
                yield b
        finally:
            if hasattr(it, "close"):
                it.close()


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def check_resized(im_info, sizes, what) -> None:
    """Each record's im_info shows it resized from its own (h, w) to 300²:
    a record the chain dropped would carry the default scales of 1."""
    import numpy as np

    want = np.array([[300, 300, 300 / h, 300 / w] for h, w in sizes],
                    np.float32)
    if im_info.shape != want.shape or not np.allclose(im_info, want,
                                                      rtol=1e-6):
        raise AssertionError(f"{what}: im_info {im_info.tolist()} for "
                             f"sizes {sizes}")


def ssd_input_phase(dev, smi):
    """The SSD input path on the card (phase ``ssd_input``, then a
    ``timing`` line); returns K2's launches by path."""
    import os
    import shutil
    import statistics
    import tempfile

    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.data import (DataSet, FnTransformer,
                                              ParallelLoader, SSDByteRecord,
                                              device_prefetch, native,
                                              read_records, read_ssd_records,
                                              write_ssd_records)
    from analytics_zoo_tpu_torch.data.synthetic import (
        generate_shapes_records, render_shapes_image)
    from analytics_zoo_tpu_torch.models.ssd import (SSDVgg, build_priors,
                                                    ssd300_config)
    from analytics_zoo_tpu_torch.ops import pallas_detout, pallas_nms
    from analytics_zoo_tpu_torch.ops.multibox_loss import MultiBoxLoss
    from analytics_zoo_tpu_torch.parallel import (SGD, create_train_state,
                                                  make_train_step)
    from analytics_zoo_tpu_torch.parallel.train import to_device
    from analytics_zoo_tpu_torch.pipelines import ssd as ssd_pipe
    from analytics_zoo_tpu_torch.transform.vision import (
        DeviceAugBatch, DeviceAugParam, DeviceAugPrepare, ImageFeature,
        RoiLabel, RoiNormalize, make_device_augment)
    from analytics_zoo_tpu_torch.transform.vision.augmentation import (
        resize_bilinear)

    codec = native.codec_for(dev)
    tmp = tempfile.mkdtemp(prefix="ssd_input-")
    try:
        # 1. records: render, encode through the codec, write 4 shards;
        # the native reader against the pure-Python one; every decode
        t0 = time.perf_counter()
        paths = generate_shapes_records(os.path.join(tmp, "train"),
                                        n_images=INPUT_IMAGES,
                                        num_shards=INPUT_SHARDS, seed=0,
                                        device=dev)
        records_s = time.perf_counter() - t0
        pattern = os.path.join(tmp, "train-*")
        pure = sorted(p for path in paths for p in read_records(path))
        with native.NativeRecordReader(paths, n_threads=INPUT_SHARDS) as rd:
            threaded = sorted(rd)
        if threaded != pure or len(pure) != INPUT_IMAGES:
            raise AssertionError(f"native reader: {len(threaded)} records, "
                                 f"pure-Python {len(pure)}, equal "
                                 f"{threaded == pure}")
        recs = list(read_ssd_records(paths))
        t0 = time.perf_counter()
        decoded = [native.decode_jpeg(r.data, codec) for r in recs]
        decode_ms = (time.perf_counter() - t0) * 1e3 / len(recs)
        if any(d is None or d.shape != (300, 300, 3) for d in decoded):
            raise AssertionError("a record did not decode to (300, 300, 3)")
        corrupt = [native.decode_jpeg(b, codec)
                   for b in (recs[0].data[:40], b"not a jpeg")]
        if any(c is not None for c in corrupt):
            raise AssertionError("a corrupt JPEG decoded")
        psnr = []
        for seed in range(4):
            img, _ = render_shapes_image(np.random.RandomState(1000 + seed))
            back = native.decode_jpeg(native.encode_jpeg(img, 92, codec),
                                      codec)
            mse = np.mean((back.astype(np.float64) - img) ** 2)
            psnr.append(10 * math.log10(255.0 ** 2 / mse))
        if min(psnr) < CODEC_PSNR_MIN:
            raise AssertionError(f"{codec} q92 round trip PSNR {psnr} dB "
                                 f"(floor {CODEC_PSNR_MIN})")
        # validation and serving records: half from the first shard at
        # 300², half rendered at other sizes (412², and 360² side by side
        # as 360 x 720), so the card's Resize resamples (and imports no cv2)
        val_rng = np.random.RandomState(1)
        other = []
        for i in range(INPUT_VAL // 2):
            img, gt = render_shapes_image(val_rng, 360 if i % 2 else 412)
            if i % 2:
                img = np.concatenate([img, img], axis=1)
            other.append(SSDByteRecord(native.encode_jpeg(img, 92, codec),
                                       f"other/{i}.jpg", gt))
        val_recs = recs[:INPUT_VAL // 2] + other
        (val_path,) = write_ssd_records(val_recs, os.path.join(tmp, "val"),
                                        1)
        val_sizes = [native.decode_jpeg(r.data, codec).shape[:2]
                     for r in val_recs]

        # 2. train_ssd from the records through the device augmentation,
        # prefetch 2, validating from records through K2
        param = ssd_pipe.PreProcessParam(batch_size=INPUT_BATCH)
        train_set, augment = ssd_pipe.load_train_set_device(pattern, param,
                                                            device=dev)
        val_param = ssd_pipe.PreProcessParam(batch_size=INPUT_VAL_BATCH)
        val_set = ssd_pipe.load_val_set(val_path, val_param, device=dev)
        params = ssd_pipe.TrainParams(max_epoch=1, prefetch=2)
        model = SSDVgg(21, 300, device=dev, seed=0)
        opt, seen, launches, train_s = recorded_train_ssd(
            FirstBatches(train_set, INPUT_STEPS), val_set, params, model,
            device_transform=augment)
        losses, val_err, val_kept = check_train_ssd_run(
            opt, seen, launches, INPUT_STEPS, INPUT_VAL // INPUT_VAL_BATCH)
        if opt.prefetch != 2:
            raise AssertionError(f"the Optimizer's prefetch {opt.prefetch}")
        val_info = np.concatenate([b["im_info"] for b in val_set])
        check_resized(val_info, val_sizes, "load_val_set")

        # 3. the augmentation on the card against the CPU, one staged
        # batch of a seeded loader
        (staged,) = first_batches(ParallelLoader(
            ssd_pipe.load_train_set_device(pattern, param, device=dev)[0],
            0, base_seed=7), 1)
        card = augment(staged)["input"].cpu()
        cpu = make_device_augment(DeviceAugParam(), device="cpu")(
            staged)["input"]
        aug_err = (card - cpu).abs().max().item()
        if not aug_err <= AUG_CARD_TOL:
            raise AssertionError(f"device augment card vs CPU {aug_err} "
                                 f"(tol {AUG_CARD_TOL})")

        # 4. prefetch: what device_prefetch delivers is bit-equal to
        # synchronous uploads of the same host batches
        host = first_batches(ParallelLoader(
            ssd_pipe.load_train_set_device(pattern, param, device=dev)[0],
            0, base_seed=8), 4)
        fetched = [[x.cpu() for x in tree_leaves(b)]
                   for b in device_prefetch(iter(host), dev, size=2)]
        synced = [[x.cpu() for x in tree_leaves(to_device(b, dev))]
                  for b in host]
        prefetch_equal = (len(fetched) == len(synced) == 4 and all(
            torch.equal(a, b) for fa, fb in zip(fetched, synced)
            for a, b in zip(fa, fb)))
        if not prefetch_equal:
            raise AssertionError("device_prefetch batches differ from "
                                 "synchronous uploads")

        # 5. the loader after CUDA is initialised: the decode chain's
        # workers would need CUDA (nvJPEG), so it is refused; the staging
        # chain over decoded images is byte-identical at 0 and 2 workers
        workers = min(8, (os.cpu_count() or 2) // 2)
        try:
            ssd_pipe.load_train_set_device(
                pattern, ssd_pipe.PreProcessParam(
                    batch_size=INPUT_BATCH, worker_processes=workers),
                device=dev)
            refusal = None
        except ValueError as e:
            refusal = str(e)
        if codec == "nvjpeg" and not (refusal and "nvJPEG" in refusal):
            raise AssertionError(f"decode chain in forked workers: "
                                 f"{refusal}")
        items = [(d, r.gt, r.path) for d, r in zip(decoded, recs)]

        def to_feature(item):
            mat, gt, path = item
            f = ImageFeature(path=path)
            f.mat = mat
            f["label"] = RoiLabel.from_gt_matrix(gt)
            return f

        def staging_set():
            return (DataSet.from_list(items)
                    .transform(FnTransformer(to_feature))
                    .transform(RoiNormalize())
                    .transform(DeviceAugPrepare(DeviceAugParam()))
                    .transform(DeviceAugBatch(INPUT_BATCH)))

        # the rate over the epoch, and past its first batch (the workers'
        # fork and first group are paid once an epoch)
        streams, staging_rate = {}, {}
        for n in sorted({0, 2, workers}):
            loader = ParallelLoader(staging_set(), n, base_seed=11)
            t0 = time.perf_counter()
            streams[n], t_first = [], None
            for b in loader:
                t_first = t_first or time.perf_counter()
                streams[n].append([np.asarray(x) for x in tree_leaves(b)])
            t_end = time.perf_counter()
            staging_rate[n] = {
                "images_per_s": INPUT_IMAGES / (t_end - t0),
                "first_batch_s": t_first - t0,
                "after_first_images_per_s": ((INPUT_IMAGES - INPUT_BATCH)
                                             / (t_end - t_first)),
                "spills": loader.spills}
        loader_equal = all(
            len(streams[n]) == len(streams[0]) == INPUT_IMAGES
            // INPUT_BATCH and all(
                a.dtype == b.dtype and np.array_equal(a, b)
                for sa, sb in zip(streams[0], streams[n])
                for a, b in zip(sa, sb))
            for n in streams)
        if not loader_equal:
            raise AssertionError("ParallelLoader streams differ by workers")
        del streams

        # 6. serving from records through the uint8 chain and K2
        pred = ssd_pipe.SSDPredictor(SSDVgg(21, 300, device=dev, seed=0),
                                     ssd_pipe.PreProcessParam(
                                         batch_size=INPUT_VAL_BATCH),
                                     device=dev)
        served_recs = val_recs
        pred.predict(served_recs[:INPUT_VAL_BATCH])         # warm-up
        torch.cuda.synchronize()
        pallas_detout.fused_detection_output.launches = 0
        pallas_nms.nms_sweep.launches = 0
        t0 = time.perf_counter()
        served = pred.predict(served_recs)
        torch.cuda.synchronize()
        predict_ms = ((time.perf_counter() - t0) * 1e3
                      / (INPUT_VAL // INPUT_VAL_BATCH))
        predict_launches = {
            "fused_detection_output":
                pallas_detout.fused_detection_output.launches,
            "nms_sweep": pallas_nms.nms_sweep.launches}
        want, served_info = [], []
        for b in ssd_pipe.serving_chain(pred.param, uint8=True, device=dev)(
                served_recs):
            n = b.pop("n_valid", INPUT_VAL_BATCH)
            served_info.append(b["im_info"][:n])
            want.extend(pred.detect_batch(b)[:n])
        check_resized(np.concatenate(served_info), val_sizes,
                      "serving_chain")
        served_equal = len(served) == len(want) == INPUT_VAL and all(
            np.array_equal(a, b) for a, b in zip(served, want))
        if (not served_equal or predict_launches["fused_detection_output"]
                < INPUT_VAL // INPUT_VAL_BATCH):
            raise AssertionError(f"predict(records): equal to detect_batch "
                                 f"{served_equal}, launches "
                                 f"{predict_launches}")
        if "cv2" in sys.modules:
            raise AssertionError("the card's input path imported cv2")
        emit("ssd_input", codec=codec, images=INPUT_IMAGES,
             shards=INPUT_SHARDS, records_s=records_s,
             native_reader_equal=True, decode_ms_per_image=decode_ms,
             corrupt_decodes_none=True, codec_q92_psnr_db=psnr,
             codec_psnr_floor_db=CODEC_PSNR_MIN, batch=INPUT_BATCH,
             steps=len(losses), losses=losses, prefetch=opt.prefetch,
             validation=opt.val_history, launches=launches,
             validation_batches=len(seen),
             validation_detections=val_kept,
             validation_rows_max_abs_err=val_err, train_ssd_s=train_s,
             augment_card_vs_cpu_max_abs=aug_err,
             augment_tolerance=AUG_CARD_TOL,
             prefetch_bit_equal=prefetch_equal,
             loader_workers=sorted(staging_rate),
             loader_streams_identical=loader_equal,
             loader_decode_chain_refusal=refusal,
             predict_records=len(served), predict_launches=predict_launches,
             predict_equal_detect_batch=served_equal,
             validation_and_served_sizes=sorted(set(val_sizes)),
             cv2_imported=False)

        # 7. timing
        predict_by_size = {}
        for name, part in (("300", val_recs[:INPUT_VAL // 2]),
                           ("412_and_360x720", other)):
            t0 = time.perf_counter()
            pred.predict(part)
            torch.cuda.synchronize()
            predict_by_size[name] = ((time.perf_counter() - t0) * 1e3
                                     / (len(part) // INPUT_VAL_BATCH))
        larger = [native.decode_jpeg(r.data, codec) for r in other]
        t0 = time.perf_counter()
        for mat in larger:
            resize_bilinear(mat, 300, 300)
        resize_ms = (time.perf_counter() - t0) * 1e3 / len(larger)
        dev_batch = to_device(staged, dev)
        augment_ms = cuda_ms(lambda: augment(dev_batch), reps=10)
        pin_ms, upload_ms = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            pinned = [torch.from_numpy(np.ascontiguousarray(x)).pin_memory()
                      for x in tree_leaves(staged)]
            pin_ms.append((time.perf_counter() - t0) * 1e3)
            upload_ms.append(cuda_ms(lambda: [x.to(dev, non_blocking=True)
                                              for x in pinned],
                                     reps=1, warmup=1))
        staged_mb = sum(x.nbytes for x in tree_leaves(staged)) / 1e6
        host_rate = {}
        for n in (0, workers):
            try:
                ds, _ = ssd_pipe.load_train_set_device(
                    pattern, ssd_pipe.PreProcessParam(
                        batch_size=INPUT_BATCH, worker_processes=n),
                    device=dev)
            except ValueError as e:
                host_rate[f"workers_{n}"] = f"refused: {e}"
                continue
            t0 = time.perf_counter()
            got = first_batches(ds, INPUT_RATE_IMAGES // INPUT_BATCH)
            host_rate[f"workers_{n}"] = (len(got) * INPUT_BATCH
                                         / (time.perf_counter() - t0))
        sgd = SGD(params.learning_rate, momentum=params.momentum,
                  weight_decay=params.weight_decay)
        priors, variances = build_priors(ssd300_config())
        step = make_train_step(model, MultiBoxLoss(priors, variances), sgd,
                               skip_loss_above=50.0,
                               compute_dtype=params.compute_dtype,
                               device_transform=augment)
        state = create_train_state(model, sgd)
        fed_ms, resident = [], []
        torch.cuda.synchronize()
        t_prev = time.perf_counter()
        for batch in device_prefetch(iter(ssd_pipe.load_train_set_device(
                pattern, param, device=dev)[0]), dev, size=2,
                close_source=True):
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            t = time.perf_counter()
            fed_ms.append((t - t_prev) * 1e3)
            t_prev = t
            resident.append(batch)
        resident_ms = []
        for batch in resident:
            t0 = time.perf_counter()
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            resident_ms.append((time.perf_counter() - t0) * 1e3)
        trace = profile_train_step(lambda: step(state, resident[0]))
        del resident
        emit("timing", nvidia_smi=smi, ssd_input_codec=codec,
             ssd_input_host_images_per_s=host_rate,
             ssd_input_staging_images_per_s_by_workers=staging_rate,
             ssd_input_decode_ms_per_image=decode_ms,
             ssd_input_augment_ms=augment_ms,
             ssd_input_staged_batch_mb=staged_mb,
             ssd_input_pin_ms=statistics.median(pin_ms),
             ssd_input_pinned_upload_ms=statistics.median(upload_ms),
             ssd_input_step_ms=statistics.median(fed_ms[SSD_WARMUP_STEPS:]),
             ssd_input_step_ms_each=fed_ms,
             ssd_input_step_images_per_s=(
                 INPUT_BATCH * 1e3
                 / statistics.median(fed_ms[SSD_WARMUP_STEPS:])),
             ssd_input_step_ms_device_resident=statistics.median(
                 resident_ms[SSD_WARMUP_STEPS:]),
             ssd_input_step_profiled=trace,
             ssd_input_train_ssd_s=train_s,
             ssd_input_predict_ms_per_batch=predict_ms,
             ssd_input_predict_ms_per_batch_by_sizes=predict_by_size,
             ssd_input_resize_ms_per_image=resize_ms,
             ssd_input_predict_batch=INPUT_VAL_BATCH)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"validation": launches["fused_detection_output"],
            "predict": predict_launches["fused_detection_output"]}


def rel_err(got, want) -> float:
    """Relative max-abs error of ``got`` against ``want``."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-12)).item()


def ssd_serving_phase(dev, smi):
    """SSD online serving through ``ServingRuntime`` on the card (phase
    ``ssd_serving``); returns K1's and K2's launches on its path."""
    import statistics

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from analytics_zoo_tpu_torch.models.ssd import build_ssd_vgg
    from analytics_zoo_tpu_torch.ops import pallas_detout, pallas_nms
    from analytics_zoo_tpu_torch.ops.detection_output import (
        DetectionOutputParam, detection_output)
    from analytics_zoo_tpu_torch.pipelines.ssd import (BGR_MEANS,
                                                       PreProcessParam,
                                                       SSDPredictor,
                                                       ssd_serving_tiers)
    from analytics_zoo_tpu_torch.resilience.errors import ServerOverloaded
    from analytics_zoo_tpu_torch.serving import (LadderPolicy, MonotonicClock,
                                                 ServingRuntime)
    from analytics_zoo_tpu_torch.utils import quantize

    rng = np.random.RandomState(31)

    def images(n):
        """Seeded requests: random pixels, mean-subtracted, float32."""
        return [rng.randint(0, 256, (300, 300, 3)).astype(np.float32)
                - np.float32(BGR_MEANS) for _ in range(n)]

    def zero_counters():
        pallas_nms.nms_sweep.launches = 0
        pallas_detout.fused_detection_output.launches = 0

    def read_counters():
        torch.cuda.synchronize()
        return {"nms_sweep": pallas_nms.nms_sweep.launches,
                "fused_detection_output":
                    pallas_detout.fused_detection_output.launches}

    model = build_ssd_vgg(21, 300, device=dev, seed=0)
    param = PreProcessParam(batch_size=BATCH, resolution=300)
    tiers = ssd_serving_tiers(model, param, device=dev)
    # each rung's predictor, called directly below
    preds = [t.device_program()[0].__self__ for t in tiers]
    win = np.stack(images(BATCH))
    for t in tiers:                                 # cuDNN / cuBLAS warm-up
        t.forward({"input": win})

    # -- 1. requests through the runtime: the slice's main path ----------
    rt = ServingRuntime(tiers, n_replicas=2, max_batch=BATCH,
                        queue_capacity=SERVE_REQUESTS,
                        default_deadline_s=3600.0, clock=MonotonicClock())
    requests = images(SERVE_REQUESTS)
    zero_counters()
    t0 = time.perf_counter()
    for x in requests:
        rt.submit({"input": x})
    rt.drain()
    launches = read_counters()
    served_s = time.perf_counter() - t0
    acct = rt.accounting()
    served = rt.snapshot()["metrics"]
    fences = [e for e in rt.pool.events if e["kind"] == "replica_fenced"]
    if (acct["by_state"] != {"done": SERVE_REQUESTS} or acct["unaccounted"]
            or fences or served["failed"] or served["shed_total"]):
        raise AssertionError(f"runtime: accounting {acct}, fences {fences}, "
                             f"metrics {served}")
    if (launches["fused_detection_output"] != served["batches"]
            or launches["nms_sweep"]):
        raise AssertionError(f"runtime: {served['batches']} batches "
                             f"launched {launches} (want K2 once each)")
    rows = np.stack([r.result for r in rt.requests])
    if rows.shape != (SERVE_REQUESTS, 200, 6) or not np.isfinite(rows).all():
        raise AssertionError(f"runtime rows {rows.shape}")
    if not (np.isin(rows[..., 0], np.arange(-1, 21)).all()
            and (rows[..., 1] >= 0).all() and (rows[..., 1] <= 1).all()):
        raise AssertionError("runtime: class ids or scores out of range")
    direct = np.concatenate([
        preds[0].detect_normalized(np.stack(requests[i:i + BATCH]))
        .cpu().numpy() for i in range(0, SERVE_REQUESTS, BATCH)])
    if not np.array_equal(rows, direct):
        raise AssertionError("runtime rows differ from the fp predictor's")

    # -- 2. each rung forced in turn, in interleaved windows -------------
    rung_ms = {t.name: [] for t in tiers}
    rung_launches = {t.name: {} for t in tiers}
    rung_rows = {}
    for _ in range(SERVE_WINDOWS):
        for i, t in enumerate(tiers):
            rt.ladder.tier = i
            for x in win:
                rt.submit({"input": x})
            torch.cuda.synchronize()
            zero_counters()
            t0 = time.perf_counter()
            if rt.pump(force=True) != 1:
                raise AssertionError(f"rung {t.name}: not one batch")
            rung_ms[t.name].append((time.perf_counter() - t0) * 1e3)
            for k, v in read_counters().items():
                rung_launches[t.name][k] = rung_launches[t.name].get(k, 0) + v
            done = rt.requests[-BATCH:]
            if {r.tier for r in done} != {i}:
                raise AssertionError(f"rung {t.name} served at tiers "
                                     f"{[r.tier for r in done]}")
            rung_rows[t.name] = np.stack([r.result for r in done])
    if any(n != {"nms_sweep": 0, "fused_detection_output": SERVE_WINDOWS}
           for n in rung_launches.values()):
        raise AssertionError(f"forced rungs launched {rung_launches} (want "
                             f"K2 once a window on every rung)")
    for pred, t in zip(preds, tiers):
        want = pred.detect_normalized(win).cpu().numpy()
        if not np.array_equal(rung_rows[t.name], want):
            raise AssertionError(f"rung {t.name}: rows through the runtime "
                                 "differ from its predictor's")
    topk_rows = rung_rows[tiers[2].name]
    if topk_rows.shape != (BATCH, 50, 6):
        raise AssertionError(f"int8_topk50 rows {topk_rows.shape}")
    x8 = torch.from_numpy(win).to(dev)
    with torch.inference_mode():
        loc, conf = preds[0]._eval_step(x8)
        probs = torch.softmax(conf, -1)
    plain = detection_output(
        loc.cpu(), probs.cpu(), preds[0]._priors.cpu(),
        preds[0]._variances.cpu(),
        dataclasses.replace(preds[0].post, backend="xla"))
    fp_vs_plain = rows_err(torch.from_numpy(rung_rows["fp"]), plain)

    # -- 3. the int8 modes -----------------------------------------------
    qparams = quantize.quantize_params(model)
    deq_model = build_ssd_vgg(21, 300, device=dev, seed=0)
    deq_model.load_state_dict(quantize.dequantize_params(qparams))
    deq = SSDPredictor(deq_model, param, device=dev)
    int8 = SSDPredictor(model, param, quantize="int8", device=dev)
    bf16 = SSDPredictor(model, param, compute_dtype="bf16", device=dev)
    forwards = {"fp32": preds[0], "bf16": bf16, "int8_weight": preds[1],
                "int8_dequantized_fp32": deq, "int8_compute": int8}
    outs = {}
    with torch.inference_mode():
        for name, pred in forwards.items():
            outs[name] = pred._eval_step(x8)
    weight_only_err = max(rel_err(a, b) for a, b in zip(
        outs["int8_weight"], outs["int8_dequantized_fp32"]))
    if weight_only_err > DEQUANT_TOL:
        raise AssertionError(f"weight-only rung against fp32 on the "
                             f"dequantized weights: {weight_only_err} "
                             f"(tol {DEQUANT_TOL})")
    vs_fp32 = {name: {"loc": rel_err(o[0], outs["fp32"][0]),
                      "conf": rel_err(o[1], outs["fp32"][1])}
               for name, o in outs.items() if name != "fp32"}
    quantize.int8_matmul.launches = 0
    forward_ms = {}
    with torch.inference_mode():
        for name, pred in forwards.items():
            forward_ms[name] = cuda_ms(lambda: pred._eval_step(x8), 10)
    gemms_per_forward = quantize.int8_matmul.launches // 12
    # each rung and the other modes end to end: a batch of 8, readback
    # included, host clock
    e2e_ms = {}
    for name, pred in (("int8_compute", int8), ("bf16", bf16)):
        pred.detect_normalized(win).cpu()
        t0 = time.perf_counter()
        for _ in range(5):
            pred.detect_normalized(win).cpu()
        e2e_ms[name] = (time.perf_counter() - t0) * 1e3 / 5
    # the card's int32 accumulators against the plain float64 version on
    # the activations the fp model feeds these layers
    caps = {}
    hooks = [model.get_submodule(n).register_forward_hook(
        lambda m, inp, out, n=n: caps.__setitem__(n, inp[0].detach()))
        for n in INT8_LAYERS]
    with torch.inference_mode():
        model(x8)
    for h in hooks:
        h.remove()
    int8_layers = {}
    for n in INT8_LAYERS:
        m = int8.model.get_submodule(n)
        geo = (m.stride, m.padding, m.dilation)
        qa, _ = quantize.quantize_activation(caps[n])
        got = quantize.int8_conv2d(qa, m.weight_q, *geo)
        want = quantize.int8_conv2d_plain(qa, m.weight_q, *geo)
        if not torch.equal(got, want):
            raise AssertionError(f"int8 conv {n}: accumulators differ from "
                                 f"the plain version by "
                                 f"{(got - want).abs().max().item()}")
        w32 = m.weight()
        x32, xbf = caps[n], caps[n].to(torch.bfloat16)
        int8_layers[n] = {
            "input": list(caps[n].shape), "weight": list(m.weight_q.shape),
            "gemm_mnk": [got.numel() // got.shape[1], got.shape[1],
                         m.weight_q[0].numel()],
            "equal": True,
            "int8_ms": cuda_ms(lambda: quantize.int8_conv2d(
                qa, m.weight_q, *geo), 10),
            "quantize_activation_ms": cuda_ms(
                lambda: quantize.quantize_activation(caps[n]), 10),
            "fp32_ms": cuda_ms(lambda: torch.nn.functional.conv2d(
                x32, w32, None, *geo), 10),
            "bf16_ms": cuda_ms(lambda: torch.nn.functional.conv2d(
                xbf, w32.to(torch.bfloat16), None, *geo), 10)}
    # weights on the card: fp32 against int8, each built from a CPU model
    cpu_model = build_ssd_vgg(21, 300, device="cpu", seed=0)
    weight_mb = {}
    for name, kw in (("fp32", {}), ("int8", {"quantize": True})):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        pred = SSDPredictor(copy.deepcopy(cpu_model), param, device=dev,
                            **kw)
        torch.cuda.synchronize()
        weight_mb[name] = {
            "peak": (torch.cuda.max_memory_allocated() - base) / 1e6,
            "held": (torch.cuda.memory_allocated() - base) / 1e6,
            "tensors": sum(t.numel() * t.element_size() for t in
                           list(pred.model.parameters())
                           + list(pred.model.buffers())) / 1e6}
        del pred

    # -- 4. approx_topk: the unfused path, K1 ----------------------------
    approx = SSDPredictor(model, param,
                          post=DetectionOutputParam(approx_topk=True),
                          device=dev)
    approx.detect_normalized(win)
    zero_counters()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = approx.detect_normalized(win)
        torch.cuda.synchronize()
    approx_launches = read_counters()
    traced = {k: sum(ev.count for ev in prof.key_averages() if k in ev.key)
              for k in ("nms_sweep_kernel", "select_kernel", "merge_kernel")}
    if not (traced["nms_sweep_kernel"] > 0 and approx_launches["nms_sweep"] > 0
            and traced["select_kernel"] == traced["merge_kernel"] == 0
            and approx_launches["fused_detection_output"] == 0):
        raise AssertionError(f"approx_topk: traced {traced}, counted "
                             f"{approx_launches} (want K1 > 0, K2 0)")
    approx_err = rows_err(got, preds[0].detect_normalized(win))

    # -- 5. a short overload burst ---------------------------------------
    burst = ServingRuntime(tiers, n_replicas=2, max_batch=BATCH,
                           queue_capacity=2 * BATCH, default_deadline_s=0.25,
                           decision_every=2,
                           ladder_policy=LadderPolicy(down_after=1,
                                                      up_after=2),
                           clock=MonotonicClock())
    rejected = 0
    for _ in range(BURST_ROUNDS):
        for j in range(3 * BATCH):
            try:
                burst.submit({"input": win[j % BATCH]})
            except ServerOverloaded:
                rejected += 1
        burst.pump()
    burst.drain()
    burst_acct = burst.accounting()
    burst_metrics = burst.snapshot()["metrics"]
    burst_fences = [e for e in burst.pool.events
                    if e["kind"] == "replica_fenced"]
    # sheds and ladder steps depend on timing; a failed request or a
    # fence does not: Replica.forward turns any fault into a failover
    if burst_acct["unaccounted"] or burst_metrics["failed"] or burst_fences:
        raise AssertionError(f"overload burst: accounting {burst_acct}, "
                             f"failed {burst_metrics['failed']}, fences "
                             f"{burst_fences}")
    served_by_tier = {}
    for r in burst.requests:
        if r.state == "done":
            served_by_tier[r.tier] = served_by_tier.get(r.tier, 0) + 1

    emit("ssd_serving", nvidia_smi=smi, requests=SERVE_REQUESTS,
         n_replicas=2, batches=served["batches"], launches=launches,
         served_s=served_s, accounting=acct,
         fences=len(fences), failed=served["failed"],
         shed=served["shed_total"],
         latency_p50_s=served["latency_by_tier"]["0"]["p50_s"],
         latency_p99_s=served["latency_by_tier"]["0"]["p99_s"],
         rung_ms_per_batch={k: statistics.median(v)
                            for k, v in rung_ms.items()},
         rung_ms_windows=rung_ms, rung_launches=rung_launches,
         rung_speed_vs_fp={k: statistics.median(v)
                           / statistics.median(rung_ms["fp"])
                           for k, v in rung_ms.items()},
         tier_speed_hints=[t.speed for t in tiers],
         fp_rows_vs_cpu_plain=fp_vs_plain,
         weight_only_vs_dequantized_fp32=weight_only_err,
         weight_only_tolerance=DEQUANT_TOL,
         forward_rel_err_vs_fp32=vs_fp32, forward_ms_per_batch=forward_ms,
         e2e_ms_per_batch=e2e_ms, int8_gemms_per_forward=gemms_per_forward,
         int8_layers=int8_layers, weight_mb=weight_mb,
         approx_topk={"traced": traced, "launches": approx_launches,
                      "rows_max_abs_err_vs_fused": approx_err},
         burst={"rejected": rejected, "accounting": burst_acct,
                "failed": burst_metrics["failed"],
                "fences": len(burst_fences),
                "shed_by_cause": burst_metrics["shed_by_cause"],
                "transitions": burst.ladder.events,
                "served_by_tier": served_by_tier},
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return {"k2_launches": launches["fused_detection_output"],
            "k1_launches": approx_launches["nms_sweep"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    from analytics_zoo_tpu_torch.models.ssd import (build_priors,
                                                    build_ssd_vgg,
                                                    ssd300_config,
                                                    ssd512_config)
    from analytics_zoo_tpu_torch.ops import (pallas_detout, pallas_nms,
                                             pallas_rnn)
    from analytics_zoo_tpu_torch.ops.detection_output import (
        DetectionOutputParam, detection_output, sweep_candidates)
    from analytics_zoo_tpu_torch.parallel import (Adam, Optimizer, Trigger,
                                                  create_train_state,
                                                  make_eval_step,
                                                  make_train_step)
    from analytics_zoo_tpu_torch.pipelines.deepspeech2 import (
        DeepSpeech2Pipeline, DS2Param, ds2_ctc_criterion, ds2_padding_metric,
        load_asr_train_set, make_ds2_model)
    from analytics_zoo_tpu_torch.transform.audio import featurize
    from analytics_zoo_tpu_torch.pipelines.ssd import (PreProcessParam,
                                                       SSDPredictor,
                                                       run_serving_loop)
    from analytics_zoo_tpu_torch.transform.audio import ALPHABET
    from analytics_zoo_tpu_torch.utils import cuda_build

    dev = torch.device("cuda")
    rng = np.random.RandomState(0)

    # -- 1. device --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, torch_name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # -- 2. build ---------------------------------------------------------
    # the kernels and the nvJPEG codec with nvcc, the host library of the
    # input path (record reader; libjpeg where its header is) with g++,
    # all at once
    import threading

    from analytics_zoo_tpu_torch.data import native

    t0 = time.perf_counter()
    host_lib = []
    host_build = threading.Thread(
        target=lambda: host_lib.append(native.build_host_library()))
    host_build.start()
    libs = cuda_build.build_kernels(cuda_build.KERNEL_SOURCES
                                    + cuda_build.CODEC_SOURCES)
    host_build.join()
    if not host_lib:
        raise AssertionError("the g++ build of azrecord.cpp failed")
    build_s = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in cuda_build.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln]
             for n in libs}
    emit("build", seconds=round(build_s, 3),
         libraries={n: str(p.name) for n, p in libs.items()}, ptxas=ptxas,
         host_library=host_lib[0].name,
         host_library_libjpeg=native.has_libjpeg_header())
    check_no_spills(ptxas)

    # -- 3. K1 against its plain version ----------------------------------
    k1_err = 0.0
    for rows, K, kind in [(BATCH * 20, 512, k) for k in
                          ("random", "ties", "sparse", "non_prefix")] + [
            (4, 1536, "random"), (4, 1536, "ties"), (4, 1536, "non_prefix"),
            (2, 13000, "random")]:
        planes = [torch.from_numpy(p).to(dev)
                  for p in sweep_planes(rng, rows, K, kind)]
        got = pallas_nms.nms_sweep(*planes)
        torch.cuda.synchronize()
        want = pallas_nms.nms_sweep_plain(*planes)
        err = (got - want).abs().max().item()
        if err != 0:
            raise AssertionError(f"K1 keep mask differs ({kind}): {err}")
        k1_err = max(k1_err, err)
        emit("k1_check", case=kind, rows=rows, k=K,
             tile=pallas_nms.sweep_tile(K), kept=int(got.sum().item()),
             max_abs_err=err)

    # -- 4. K2 against its plain version ----------------------------------
    k2_err = 0.0
    post = DetectionOutputParam(n_classes=21)
    for res, cfg in ((300, ssd300_config()), (512, ssd512_config())):
        pri, var = (torch.from_numpy(a).to(dev) for a in build_priors(cfg))
        P = pri.shape[0]
        for regime in ("dense", "trained"):
            loc = torch.from_numpy((rng.randn(BATCH, P, 4) * 0.5)
                                   .astype(np.float32)).to(dev)
            conf = torch.from_numpy(synthetic_conf(rng, BATCH, P, 21,
                                                   regime)).to(dev)
            got = pallas_detout.fused_detection_output(loc, conf, pri, var,
                                                       param=post)
            torch.cuda.synchronize()
            want = pallas_detout.fused_detection_output_plain(loc, conf, pri,
                                                              var, post)
            err = rows_err(got, want)
            k2_err = max(k2_err, err)
            emit("k2_check", resolution=res, priors=P, regime=regime,
                 kept=int((got[..., 1] > 0).sum().item()), max_abs_err=err)
            if res == 300 and regime == "trained":
                trained_inputs = (loc, conf)
    # SSD512 at nms_topk 1000 (two engine tiles a row); SSD300 scores of
    # five int8 levels, so each row's nms_topk-th score lies inside a run
    # of equal scores
    for res, cfg, regime, topk in ((512, ssd512_config(), "dense", 1000),
                                   (300, ssd300_config(), "tie_levels",
                                    400)):
        pri, var = (torch.from_numpy(a).to(dev) for a in build_priors(cfg))
        P = pri.shape[0]
        post_k = dataclasses.replace(post, nms_topk=topk)
        loc = torch.from_numpy((rng.randn(BATCH, P, 4) * 0.5)
                               .astype(np.float32)).to(dev)
        conf = (torch.from_numpy(synthetic_conf(rng, BATCH, P, 21, regime))
                if regime == "dense" else torch.from_numpy(
                    (rng.randint(2, 7, (BATCH, P, 21)) / 127.0)
                    .astype(np.float32))).to(dev)
        got = pallas_detout.fused_detection_output(loc, conf, pri, var,
                                                   param=post_k)
        torch.cuda.synchronize()
        want = pallas_detout.fused_detection_output_plain(loc, conf, pri,
                                                          var, post_k)
        err = rows_err(got, want)
        k2_err = max(k2_err, err)
        emit("k2_check", resolution=res, priors=P, regime=regime,
             nms_topk=topk, tile=pallas_detout.select_tile(P, topk),
             kept=int((got[..., 1] > 0).sum().item()), max_abs_err=err)

    # -- 4b. K3 against its plain version --------------------------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    props = torch.cuda.get_device_properties(dev)

    def w_source_as_fit(case, H, cell, wdt, backward, got):
        """Fail unless the launcher kept W's column slice where the fit
        says it goes on this card."""
        want = pallas_rnn.hopper_w_source(
            H, cell, props.multi_processor_count,
            props.shared_memory_per_block_optin, backward,
            torch.finfo(wdt).bits // 8)
        if got != want:
            raise AssertionError(f"{case}: W slice in {got}, the fit says "
                                 f"{want}")
        return got

    k3_err, k3_sources = 0.0, set()
    for case, cell, act, B, T, H, ragged, wdt in K3_CASES:
        wdt = getattr(torch, wdt)
        inputs = rnn_inputs(rng, dev, cell, B, T, H, ragged, wdt)
        ys, cf = pallas_rnn.persistent_rnn(*inputs, cell=cell,
                                           activation=act)
        torch.cuda.synchronize()
        k3_sources.add(w_source_as_fit(case, H, cell, wdt, False,
                                       pallas_rnn.persistent_rnn.w_source))
        want_ys, want_cf = pallas_rnn.persistent_rnn_plain(
            pallas_rnn.RnnKernelConfig(cell, act), *inputs)
        tol = 2e-2 if wdt == torch.bfloat16 else 1e-4
        errs = {}
        for what, got, want in (("ys", ys, want_ys), ("carry", cf, want_cf)):
            err = (got - want).abs().max().item()
            rel = err / max(want.abs().max().item(), 1e-6)
            if not rel <= tol:
                raise AssertionError(f"K3 {case} {what}: relative max-abs "
                                     f"error {rel} (tol {tol})")
            errs[what] = err
            errs[f"{what}_rel"] = rel
            k3_err = max(k3_err, err)
        emit("k3_check", case=case, cell=cell, activation=act, B=B, T=T,
             H=H, weights=str(wdt).split(".")[-1],
             w_source=pallas_rnn.persistent_rnn.w_source,
             grid=pallas_rnn.rnn_geometry(H, cell,
                                          props.multi_processor_count).G,
             valid_steps=int(inputs[4].sum().item()), tolerance_rel=tol,
             max_abs_err_ys=errs["ys"], max_abs_err_carry=errs["carry"],
             rel_err_ys=errs["ys_rel"], rel_err_carry=errs["carry_rel"])
        if case == "ds2":
            ds2_inputs = inputs
            check_repeatable("K3 ds2", lambda: pallas_rnn.persistent_rnn(
                *inputs, cell=cell, activation=act))
    if k3_sources != {"registers", "shared", "l2"}:
        raise AssertionError(f"K3 cases took W from {k3_sources} only")

    # -- 4c. K4 against its plain version, and K3's saved carries ---------
    k4_err, k4_sources = 0.0, set()
    for case, cell, act, B, T, H, ragged, wdt, tb in K4_CASES:
        wdt = getattr(torch, wdt)
        pre, w, b, h0, n = rnn_inputs(rng, dev, cell, B, T, H, ragged, wdt)
        cfg = pallas_rnn.RnnKernelConfig(cell, act, tb)
        ys, _, cs = pallas_rnn.persistent_rnn_fwd(cfg, pre, w, b, h0, n,
                                                  save_residuals=True)
        torch.cuda.synchronize()
        want_cs = pallas_rnn.persistent_rnn_plain(cfg, pre, w, b, h0, n,
                                                  save_residuals=True)[2]
        cs_rel = ((cs - want_cs).abs().max() / want_cs.abs().max().clamp(
            min=1e-6)).item()
        if not cs_rel <= (2e-2 if wdt == torch.bfloat16 else 1e-4):
            raise AssertionError(f"K3 cs {case}: relative error {cs_rel}")
        # each saved h is the output of the row's last valid step before
        # the block start (or h0 before any): the same floats
        for blk in range(cs.shape[0]):
            last = torch.clamp(torch.minimum(n.long(), torch.tensor(
                blk * tb, device=dev)) - 1, min=-1)
            h_then = torch.where(
                (last >= 0)[:, None],
                ys[torch.arange(B, device=dev), last.clamp(min=0)], h0[-1])
            if not torch.equal(cs[blk, -1], h_then):
                raise AssertionError(f"K3 cs {case}: block {blk} is not the "
                                     "carry K3 computed")
        k = pallas_rnn.CELL_GATES[cell]
        g_ys = torch.from_numpy(rng.randn(B, T, H).astype(np.float32)).to(dev)
        g_cf = torch.from_numpy(rng.randn(*h0.shape).astype(np.float32)
                                ).to(dev)
        got = pallas_rnn.persistent_rnn_bwd(cfg, pre, w, b, n, cs, g_ys, g_cf)
        torch.cuda.synchronize()
        k4_sources.add(w_source_as_fit(case, H, cell, wdt, True,
                                       pallas_rnn.persistent_rnn_bwd.w_source))
        want = pallas_rnn.persistent_rnn_bwd_plain(cfg, pre, w, b, n, cs,
                                                   g_ys, g_cf)
        errs = {}
        for what, g_, w_ in zip(("d_pre", "d_w", "d_b", "d_h0"), got, want):
            g_, w_ = g_.float(), w_.float()
            err = (g_ - w_).abs().max().item()
            errs[what] = err
            errs[what + "_rel"] = err / max(w_.abs().max().item(), 1e-6)
            errs[what + "_rel_l2"] = ((g_ - w_).norm() / w_.norm().clamp(
                min=1e-12)).item()
            tol = K4_TOL[str(wdt).split(".")[-1]]
            if not errs[what + "_rel_l2"] <= tol:
                raise AssertionError(f"K4 {case} {what}: relative L2 error "
                                     f"{errs[what + '_rel_l2']} (tol {tol})")
            k4_err = max(k4_err, err)
        kinks = None
        if act == "clipped_relu" and wdt == torch.float32:
            kinks = kink_witness(cfg, pre, w, b, n, cs, got[0], want[0])
            if not (kinks["flip_max_kink_distance"] <= KINK_TOL
                    and kinks["d_pre_rel_l2_outside"] <= K4_BRANCH_TOL):
                raise AssertionError(f"K4 {case}: branches differ away "
                                     f"from a kink, or d_pre outside them "
                                     f"does: {kinks} (tol {KINK_TOL}, "
                                     f"{K4_BRANCH_TOL})")
        emit("k4_check", case=case, cell=cell, activation=act, B=B, T=T,
             H=H, k=k, time_block=tb, weights=str(wdt).split(".")[-1],
             w_source=pallas_rnn.persistent_rnn_bwd.w_source,
             valid_steps=int(n.sum().item()), cs_rel_err=cs_rel,
             tolerance_rel_l2=tol, kinks=kinks, **errs)
        if case == "ds2":
            k4_inputs, k4_h0 = (cfg, pre, w, b, n, cs, g_ys, g_cf), h0
            check_repeatable("K4 ds2", lambda: pallas_rnn.persistent_rnn_bwd(
                *k4_inputs))
    if k4_sources != {"split", "l2"}:
        raise AssertionError(f"K4 cases took W from {k4_sources} only")

    # -- 5. serving: the main path ----------------------------------------
    model = build_ssd_vgg(21, 300, device=dev, seed=0)
    param = PreProcessParam(batch_size=BATCH, resolution=300)
    predictor = SSDPredictor(model, param, device=dev)
    unfused = copy.copy(predictor)
    unfused.post = dataclasses.replace(predictor.post, backend="pallas")

    def staged(seed):
        r = np.random.RandomState(seed)
        sizes = r.randint(200, 640, (BATCH, 2)).astype(np.float32)
        info = np.concatenate([np.full((BATCH, 2), 300, np.float32),
                               300.0 / sizes], 1)
        return {"input": r.randint(0, 256, (BATCH, 300, 300, 3))
                .astype(np.uint8), "im_info": info}

    batches = [staged(100 + i) for i in range(4)]
    predictor.detect_batch(staged(99))              # cuDNN warm-up
    torch.cuda.synchronize()
    pallas_nms.nms_sweep.launches = 0
    pallas_detout.fused_detection_output.launches = 0
    served = run_serving_loop([dict(b) for b in batches],
                              predictor._detect_device,
                              lambda t: t.cpu().numpy())
    served_unfused = unfused.detect_batch(dict(batches[0]))
    torch.cuda.synchronize()
    launches = {"nms_sweep": pallas_nms.nms_sweep.launches,
                "fused_detection_output":
                    pallas_detout.fused_detection_output.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    out = np.stack(served)
    if out.shape != (4 * BATCH, 200, 6) or not np.isfinite(out).all():
        raise AssertionError(f"bad detections {out.shape}")
    if not (np.isin(out[..., 0], np.arange(-1, 21)).all()
            and (out[..., 1] >= 0).all() and (out[..., 1] <= 1).all()):
        raise AssertionError("class ids or scores out of range")
    if not np.isfinite(served_unfused).all():
        raise AssertionError("unfused path gave non-finite detections")

    x = (torch.from_numpy(batches[0]["input"]).to(dev).float()
         - torch.tensor(param.pixel_means, device=dev))
    with torch.inference_mode():
        loc, conf = model(x)
        probs = torch.softmax(conf, -1)
    pri, var = predictor._priors, predictor._variances
    backs = {b: detection_output(loc, probs, pri, var,
                                 dataclasses.replace(predictor.post,
                                                     backend=b))
             for b in ("fused", "pallas", "xla")}
    agree = max(rows_err(backs["fused"], backs["xla"]),
                rows_err(backs["pallas"], backs["xla"]))
    # the card's forward against a CPU forward of the same seeded weights
    cpu_model = build_ssd_vgg(21, 300, device="cpu", seed=0)
    with torch.inference_mode():
        cl, cc = cpu_model(x[:1].cpu())
    fwd_err = max(((loc[:1].cpu() - cl).abs().max() / cl.abs().max()).item(),
                  ((conf[:1].cpu() - cc).abs().max() / cc.abs().max()).item())
    if fwd_err > 1e-4:
        raise AssertionError(f"card forward vs CPU forward: {fwd_err}")
    emit("serving", batches=len(batches), batch=BATCH,
         detections=int((out[..., 1] > 0).sum()), launches=launches,
         backends_max_abs_err=agree, forward_rel_err_vs_cpu=fwd_err,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)

    # -- 5b. DS2 serving: the second main path ---------------------------
    ds2 = make_ds2_model(hidden=DS2_HIDDEN, n_rnn_layers=3,
                         rnn_engine="pallas", seed=0, device=dev)
    pipe = DeepSpeech2Pipeline(ds2, DS2Param(batch_size=BATCH), device=dev)
    utts = synthetic_utterances(DS2_SECONDS, seed=7)
    n_seg = sum(-(-len(u) // pipe.segmenter.segment_size)
                for u in utts.values())
    n_batches = -(-n_seg // BATCH)
    pipe.transcribe_samples({"warm": utts["utt0"]})     # cuBLAS/cuFFT warm-up
    torch.cuda.synchronize()
    pallas_rnn.persistent_rnn.launches = 0
    texts = pipe.transcribe_samples(utts)
    torch.cuda.synchronize()
    k3_launches = pallas_rnn.persistent_rnn.launches
    if k3_launches != 6 * n_batches:
        raise AssertionError(f"K3 launched {k3_launches} times for "
                             f"{n_batches} batches (want {6 * n_batches})")
    if sorted(texts) != sorted(utts) or any(
            set(t) - set(ALPHABET) for t in texts.values()):
        raise AssertionError(f"bad transcripts {texts}")

    # one batch: pallas against blocked, and the card against the CPU
    segs = [s for a, u in utts.items() for s in pipe.segmenter.segment(u, a)]
    batch, n_valid = pipe._pack_batch(segs[:BATCH])
    feats = pipe._make_featurizer()(batch, n_valid)
    lp = pipe._eval_step(feats)
    blocked = make_ds2_model(hidden=DS2_HIDDEN, n_rnn_layers=3,
                             rnn_engine="blocked", seed=0, device=dev)
    lp_blocked = make_eval_step(blocked)(feats)
    engines_err = (lp - lp_blocked).abs().max().item()
    argmax_agree = (lp.argmax(-1) == lp_blocked.argmax(-1)).float().mean(
        ).item()
    cpu_ds2 = make_ds2_model(hidden=DS2_HIDDEN, n_rnn_layers=3,
                             rnn_engine="pallas", seed=0, device="cpu")
    lp_cpu = make_eval_step(cpu_ds2)(feats[:1].cpu())
    cpu_err = (lp[:1].cpu() - lp_cpu).abs().max().item()
    if not (engines_err <= DS2_LOGP_TOL and cpu_err <= DS2_LOGP_TOL
            and argmax_agree >= 0.99):
        raise AssertionError(
            f"DS2 log-probs: pallas vs blocked {engines_err}, card vs CPU "
            f"{cpu_err} (tol {DS2_LOGP_TOL}); argmax agreement "
            f"{argmax_agree} (want >= 0.99)")
    if tuple(lp.shape) != (BATCH, 1500, 29) or not torch.isfinite(lp).all():
        raise AssertionError(f"bad DS2 log-probs {tuple(lp.shape)}")
    emit("ds2_serving", utterances=len(utts), audio_s=sum(DS2_SECONDS),
         segments=n_seg, batches=n_batches, launches={
             "persistent_rnn": k3_launches},
         chars=sum(len(t) for t in texts.values()),
         logp_max_abs_err_pallas_vs_blocked=engines_err,
         argmax_agreement_pallas_vs_blocked=argmax_agree,
         logp_max_abs_err_card_vs_cpu=cpu_err, tolerance=DS2_LOGP_TOL)

    # -- 5c. DS2 training: the third main path ---------------------------
    samples, sample_lengths, labels = ds2_train_set(seed=13)
    train_set = load_asr_train_set(samples, labels,
                                   sample_lengths=sample_lengths,
                                   batch_size=BATCH, seed=0,
                                   bucket_edges=DS2_BUCKETS)
    train_batches = list(train_set)
    long_batch = next(b for b in train_batches
                      if b["input"][0].shape[1] == DS2_BUCKETS[-1])
    criterion = ds2_ctc_criterion()
    train_model = make_ds2_model(hidden=DS2_HIDDEN, n_rnn_layers=3,
                                 rnn_engine="pallas", seed=0, device=dev)

    def optimizer(data, steps):
        return (Optimizer(train_model, data, criterion,
                          metric_fn=ds2_padding_metric)
                .set_optim_method(Adam(3e-4))
                .set_end_when(Trigger.max_iteration(steps)))

    torch.cuda.synchronize()
    pallas_rnn.persistent_rnn.launches = 0
    pallas_rnn.persistent_rnn_bwd.launches = 0
    distinct = optimizer(train_set, 3)
    distinct.optimize()
    repeated = optimizer([long_batch] * 5, 5)
    repeated.optimize()
    torch.cuda.synchronize()
    train_launches = {"persistent_rnn": pallas_rnn.persistent_rnn.launches,
                      "persistent_rnn_bwd":
                          pallas_rnn.persistent_rnn_bwd.launches}
    n_steps = len(distinct.history) + len(repeated.history)
    if n_steps != 8 or any(v != 6 * n_steps
                           for v in train_launches.values()):
        raise AssertionError(f"DS2 training: {n_steps} steps launched "
                             f"{train_launches} (want 6 each a step)")
    losses = [m["loss"].item() for m in distinct.history + repeated.history]
    rep_losses = losses[3:]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"DS2 training losses {losses}")
    if not rep_losses[-1] < rep_losses[0]:
        raise AssertionError(f"DS2 loss on the repeated batch did not "
                             f"fall: {rep_losses}")
    # one batch cut to 600 frames (300 after the conv), a 1-layer model:
    # "pallas" against "blocked" on the card, the card against the CPU
    feats_long, n_long = long_batch["input"]
    n_cut = np.minimum(n_long, 600).astype(np.int32)
    small = {"input": (feats_long[:, :600], n_cut), "n_frames": n_cut,
             "labels": long_batch["labels"],
             "label_mask": long_batch["label_mask"]}
    one_layer = {e: make_ds2_model(hidden=DS2_HIDDEN, n_rnn_layers=1,
                                   rnn_engine=e, seed=1, device=dev)
                 for e in ("pallas", "blocked")}
    loss_p, grads_p = loss_and_grads(one_layer["pallas"], small, criterion)
    loss_b, grads_b = loss_and_grads(one_layer["blocked"], small, criterion)
    cpu_model = make_ds2_model(hidden=DS2_HIDDEN, n_rnn_layers=1,
                               rnn_engine="pallas", seed=1, device="cpu")
    loss_c, grads_c = loss_and_grads(cpu_model, small, criterion)
    engines = {"loss": abs(loss_p - loss_b) / abs(loss_b),
               **grads_err(grads_p, grads_b)}
    card_cpu = {"loss": abs(loss_p - loss_c) / abs(loss_c),
                **grads_err(grads_p, grads_c)}
    if max(*engines.values(), *card_cpu.values()) > DS2_GRAD_TOL:
        raise AssertionError(f"DS2 training step: pallas vs blocked "
                             f"{engines}, card vs CPU {card_cpu} (tol "
                             f"{DS2_GRAD_TOL})")
    emit("ds2_train", hidden=DS2_HIDDEN, layers=3, batch=BATCH,
         utterances=len(samples), batches=len(train_batches),
         bucket_frames=[int(b["input"][0].shape[1])
                        for b in train_batches],
         steps=n_steps, launches=train_launches, losses=losses,
         padding_efficiency=[m["padding_efficiency"].item()
                             for m in distinct.history],
         rel_err_pallas_vs_blocked=engines, rel_err_card_vs_cpu=card_cpu,
         tolerance=DS2_GRAD_TOL)

    # -- 6. timings at the main path's shapes -----------------------------
    boxes, top, valid, _ = sweep_candidates(loc, probs, pri, var,
                                            predictor.post)
    B, Cf, k = top.shape
    planes = [boxes[..., i].reshape(B * Cf, k).contiguous()
              for i in range(4)] + [valid.reshape(B * Cf, k)]
    keep = pallas_nms.nms_sweep(*planes)
    k1_ms = cuda_ms(lambda: pallas_nms.nms_sweep(*planes), 50)
    k1_plain_ms = cuda_ms(lambda: pallas_nms.nms_sweep_plain(*planes), 3, 1)
    k1_bound, k1_by = bound(6 * planes[0].numel() * 4,
                            sweep_ops(keep, planes[4]))

    def k2(l, c):
        return pallas_detout.fused_detection_output(l, c, pri, var,
                                                    param=predictor.post)

    k2_ms = cuda_ms(lambda: k2(loc, probs), 20)
    k2_plain_ms = cuda_ms(lambda: pallas_detout.fused_detection_output_plain(
        loc, probs, pri, var, predictor.post), 2, 1)
    k2_bound, k2_by = bound(*detout_work(loc, probs, pri, var,
                                         predictor.post))
    t_loc, t_conf = trained_inputs
    k2_trained_ms = cuda_ms(lambda: k2(t_loc, t_conf), 20)
    k2_trained_bound, k2_trained_by = bound(*detout_work(
        t_loc, t_conf, pri, var, predictor.post))
    # K2 by launch (select, merge), both regimes; K1 on the trained-like
    # scores' candidates
    k2_ms_by_kernel = {
        "dense": kernel_ms_by_name(lambda: k2(loc, probs), match="kernel"),
        "trained_like": kernel_ms_by_name(lambda: k2(t_loc, t_conf),
                                          match="kernel")}
    block_us = pallas_detout.block_phases_us(loc, probs, pri, var,
                                             predictor.post, planes)
    t_boxes, _, t_valid, _ = sweep_candidates(t_loc, t_conf, pri, var,
                                              predictor.post)
    t_planes = [t_boxes[..., i].reshape(B * Cf, k).contiguous()
                for i in range(4)] + [t_valid.reshape(B * Cf, k)]
    t_keep = pallas_nms.nms_sweep(*t_planes)
    k1_trained_ms = cuda_ms(lambda: pallas_nms.nms_sweep(*t_planes), 50)
    k1_trained_bound, k1_trained_by = bound(6 * t_planes[0].numel() * 4,
                                            sweep_ops(t_keep, t_planes[4]))
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(x), 10)
    for b in batches:                                 # host-clock e2e
        predictor.detect_batch(dict(b))
    torch.cuda.synchronize()
    reps = 12
    t0 = time.perf_counter()
    for i in range(reps):
        predictor.detect_batch(dict(batches[i % len(batches)]))
    e2e_ms = (time.perf_counter() - t0) * 1e3 / reps
    # K3 at the DS2 shape (all frames valid, as serving forwards padded
    # segments), its plain version, and cuDNN's relu RNN on the same
    # hoisted projections as the nearest library yardstick
    def k3():
        return pallas_rnn.persistent_rnn(*ds2_inputs, cell="vanilla",
                                         activation="clipped_relu")

    k3_ms = cuda_ms(k3, 5, 1)
    k3_plain_ms = cuda_ms(lambda: pallas_rnn.persistent_rnn_plain(
        pallas_rnn.RnnKernelConfig("vanilla", "clipped_relu"), *ds2_inputs),
        2, 1)
    k3_bound, k3_by = bound(*rnn_work(*ds2_inputs))
    k3_nearest_ms = cudnn_relu_rnn_ms(*ds2_inputs[:3])
    feat_ms = cuda_ms(lambda: pipe._make_featurizer()(batch, n_valid), 10)
    ds2_fwd_ms = cuda_ms(lambda: pipe._eval_step(feats), 3, 1)
    argmax_read_ms = cuda_ms(lambda: lp.argmax(-1).cpu(), 10)
    e2e_utts = synthetic_utterances((30,) * BATCH, seed=11)  # 8 x 30 s
    pipe.transcribe_samples(e2e_utts)
    torch.cuda.synchronize()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        pipe.transcribe_samples(e2e_utts)
    ds2_e2e_ms = (time.perf_counter() - t0) * 1e3 / reps
    audio_s = 30.0 * BATCH
    # K4 at the DS2 shape, its plain version, cuDNN's relu RNN backward as
    # the nearest yardstick, and K3 saving its carries
    k4_cfg, pre, w, b, n, cs, g_ys, g_cf = k4_inputs
    k4_ms = cuda_ms(lambda: pallas_rnn.persistent_rnn_bwd(*k4_inputs), 5, 1)
    k4_plain_ms = cuda_ms(lambda: pallas_rnn.persistent_rnn_bwd_plain(
        *k4_inputs), 2, 1)
    k4_bound, k4_by = bound(*rnn_bwd_work(pre, w, b, n, cs, g_ys, g_cf))
    k4_nearest_ms = cudnn_relu_rnn_bwd_ms(pre, w, b, g_ys)
    k3_residuals_ms = cuda_ms(lambda: pallas_rnn.persistent_rnn_fwd(
        k4_cfg, *ds2_inputs, save_residuals=True), 5, 1)
    # where a step of each goes (step-phase stamps), K4's two launches
    k3_step_us, k4_step_us = rnn_step_split(k4_inputs, k4_h0)
    k4_ms_by_kernel = kernel_ms_by_name(
        lambda: pallas_rnn.persistent_rnn_bwd(*k4_inputs))
    # K4 with fewer, longer time blocks: both W slices stay resident, so
    # only the scratch changes
    k4_ms_by_time_block = {k4_cfg.time_block: k4_ms}
    for tb in (16, 32):
        cfg_tb = k4_cfg._replace(time_block=tb)
        cs_tb = pallas_rnn.persistent_rnn_fwd(cfg_tb, *ds2_inputs,
                                              save_residuals=True)[2]
        k4_ms_by_time_block[tb] = cuda_ms(
            lambda: pallas_rnn.persistent_rnn_bwd(cfg_tb, pre, w, b, n, cs_tb,
                                                  g_ys, g_cf), 3, 1)
    # one DS2 train step on a 3000-frame (1500 after the conv) batch: host
    # clock around the step; then the same step under the profiler, split
    # into its parts; the host featurize of its 8 utterances of up to
    # 30 s by the host clock
    step = make_train_step(train_model, criterion, Adam(3e-4),
                           metric_fn=ds2_padding_metric)
    state = create_train_state(train_model, Adam(3e-4))
    state, _ = step(state, long_batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = step(state, long_batch)
    torch.cuda.synchronize()
    train_step_ms = (time.perf_counter() - t0) * 1e3
    step_trace = profile_train_step(lambda: step(state, long_batch))
    longest = np.argsort(sample_lengths)[-BATCH:]
    t0 = time.perf_counter()
    for i in longest:
        featurize(samples[i, :sample_lengths[i]])
    train_featurize_ms = (time.perf_counter() - t0) * 1e3
    emit("timing", nvidia_smi=smi, forward_ms=fwd_ms,
         e2e_ms_per_batch=e2e_ms, images_per_s=BATCH * 1e3 / e2e_ms,
         k2_trained_like_ms=k2_trained_ms,
         k2_trained_like_bound_ms=k2_trained_bound,
         k2_trained_like_bound_by=k2_trained_by,
         k2_ms_by_kernel=k2_ms_by_kernel, detout_block_us=block_us,
         k1_rows=B * Cf, k1_k=k, k1_kept=int(keep.sum().item()),
         k1_trained_like_ms=k1_trained_ms,
         k1_trained_like_bound_ms=k1_trained_bound,
         k1_trained_like_bound_by=k1_trained_by,
         k1_trained_like_kept=int(t_keep.sum().item()),
         k3_ms=k3_ms, k3_bound_ms=k3_bound, k3_bound_by=k3_by,
         k3_plain_ms=k3_plain_ms, k3_nearest_library_ms=k3_nearest_ms,
         ds2_featurize_ms=feat_ms, ds2_forward_ms_per_batch=ds2_fwd_ms,
         ds2_k3_share_of_forward=6 * k3_ms / ds2_fwd_ms,
         ds2_argmax_readback_ms=argmax_read_ms,
         ds2_e2e_ms_per_batch=ds2_e2e_ms,
         ds2_audio_s_per_batch=audio_s,
         ds2_audio_seconds_per_second=audio_s * 1e3 / ds2_e2e_ms,
         k4_ms=k4_ms, k4_bound_ms=k4_bound, k4_bound_by=k4_by,
         k4_plain_ms=k4_plain_ms, k4_nearest_library_ms=k4_nearest_ms,
         k3_residuals_ms=k3_residuals_ms,
         k4_ms_by_time_block=k4_ms_by_time_block,
         k3_step_us=k3_step_us, k4_step_us=k4_step_us,
         k4_ms_by_kernel=k4_ms_by_kernel,
         ds2_train_step_ms=train_step_ms,
         ds2_train_step_frames=int(long_batch["input"][0].shape[1]),
         ds2_train_step_loss=metrics["loss"].item(),
         ds2_train_step_profiled=step_trace,
         ds2_train_featurize_host_ms=train_featurize_ms,
         ds2_train_peak_gb=torch.cuda.max_memory_allocated() / 1e9)

    # -- 6b. SSD training: the fourth main path, and its timings ----------
    ssd_train = ssd_train_phase(dev, smi, np.random.RandomState(21))

    # -- 6c. the SSD input path from records: the fifth main path --------
    ssd_input = ssd_input_phase(dev, smi)

    # -- 6d. SSD online serving through the runtime: the sixth -----------
    ssd_serving = ssd_serving_phase(dev, smi)

    # -- 7. kernels, then the device line last ----------------------------
    kernels = [
        {"name": "nms_sweep", "route": "cuda",
         "source": "analytics_zoo_tpu_torch/csrc/nms_sweep.cu",
         "replaces": "analytics_zoo_tpu/ops/pallas_nms.py:91",
         "launches": launches["nms_sweep"] + ssd_serving["k1_launches"],
         "launches_by_path": {
             "ssd_serving": launches["nms_sweep"],
             "ssd_serving_approx_topk": ssd_serving["k1_launches"]},
         "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "fused_detection_output", "route": "cuda",
         "source": "analytics_zoo_tpu_torch/csrc/detection_output.cu",
         "replaces": "analytics_zoo_tpu/ops/pallas_detout.py:242",
         "launches": (launches["fused_detection_output"]
                      + ssd_train["k2_launches"] + ssd_input["validation"]
                      + ssd_input["predict"] + ssd_serving["k2_launches"]),
         "launches_by_path": {
             "ssd_serving": launches["fused_detection_output"],
             "ssd_serving_runtime": ssd_serving["k2_launches"],
             "ssd_train_validation": ssd_train["k2_launches"],
             "ssd_input_validation": ssd_input["validation"],
             "ssd_input_predict": ssd_input["predict"]},
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None},
        {"name": "persistent_rnn", "route": "cuda",
         "source": "analytics_zoo_tpu_torch/csrc/persistent_rnn.cu",
         "replaces": "analytics_zoo_tpu/ops/pallas_rnn.py:266",
         "launches": k3_launches + train_launches["persistent_rnn"],
         "launches_by_path": {"ds2_serving": k3_launches,
                              "ds2_train": train_launches["persistent_rnn"]},
         "max_abs_err": k3_err, "ms": k3_ms,
         "plain_ms": k3_plain_ms, "bound_ms": k3_bound, "bound_by": k3_by,
         # no PyTorch call computes a clipped-ReLU recurrence; cuDNN's
         # relu RNN on the same projections is the nearest yardstick
         "library_ms": None, "nearest_library_ms": k3_nearest_ms,
         "residuals_ms": k3_residuals_ms,
         "w_source": pallas_rnn.persistent_rnn.w_source},
        {"name": "persistent_rnn_bwd", "route": "cuda",
         "source": "analytics_zoo_tpu_torch/csrc/persistent_rnn_bwd.cu",
         "replaces": "analytics_zoo_tpu/ops/pallas_rnn.py:434",
         "launches": train_launches["persistent_rnn_bwd"],
         "max_abs_err": k4_err, "ms": k4_ms, "plain_ms": k4_plain_ms,
         "bound_ms": k4_bound, "bound_by": k4_by,
         # no PyTorch call computes this backward; cuDNN's relu RNN
         # backward on the same projections is the nearest yardstick
         "library_ms": None, "nearest_library_ms": k4_nearest_ms,
         "w_source": pallas_rnn.persistent_rnn_bwd.w_source},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

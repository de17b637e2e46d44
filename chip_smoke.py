#!/usr/bin/env python3
"""Drive the PyTorch port's SSD300 and DeepSpeech2 serving paths, its
DeepSpeech2 CTC training path, its SSD300 training path, its SSD input
path from JPEG records, SSD and DeepSpeech2 online serving through
``ServingRuntime``, DeepSpeech2 streaming sessions, the multiplexed
pool, Faster-RCNN VGG16 serving and training, graphs built from Caffe
deploy nets, the SSD AlexNet and MobileNet variants, the fraud,
recommendation and sentiment pipelines with their pool, DeepSpeech2
training checkpointed and resumed after a crash, SSD serving across a
live weight swap, and DeepSpeech2 and SSD300 trained data and tensor
parallel by two ranks sharing the card, once on one NVIDIA GPU.

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
6e. ds2_online: DeepSpeech2 online serving at the width of 5b
   (hidden 1760, 3 layers, ``rnn_engine="pallas"``, seeded weights).
   K3 at the streaming blocks' geometry (B = 1, T in ``K3_STREAM_T``,
   H = 1760, clipped ReLU, a random carry as ``h0``) against its plain
   version (relative max-abs 1e-4), the carry the last step's fp32
   output, two launches bit-equal.  ``ds2_serving_tiers`` (beam16,
   beam4, greedy) behind ``ServingRuntime(n_replicas=2, max_batch=8,
   bucket_edges=[1000, 2000, 3000], queue_capacity=64)`` on the
   monotonic clock, the ladder pinned to greedy: ``DS2_ONLINE_REQUESTS``
   seeded utterances of 3-30 s featurized on the host, then ``drain()``,
   K3's counter set to 0 just before and read just after (6 a batch);
   every request done, no fence, failure or shed; each row's valid
   log-probs within ``STREAM_RTOL``/``STREAM_ATOL`` of the utterance
   forwarded alone at its own length, each served transcript its row's,
   and every frame whose argmax differs from the alone forward's within
   that bound of a tie.  Each rung forced in turn through ``pump(force=True)`` in
   ``DS2_RUNG_WINDOWS`` interleaved windows of one batch of 8 utterances
   of 3-10 s (the 1000 edge): ms a batch, the forward's ms (CUDA events)
   and each decoder's host ms, the served transcripts its decoder's.
   ``StreamingDS2`` over the unidirectional model at ``chunk_frames=100``
   on two 20 s utterances in 1 s chunks, K3's counter around it (3 a
   block): the streamed log-probs against the whole utterance's forward
   within ``STREAM_RTOL``/``STREAM_ATOL``, the transcripts equal, ms a
   block (p50, p99) and the real-time factor.  The multiplexed pool,
   ``ServingRuntime(models=[...], n_replicas=2, max_batch=8)``: SSD300
   over ``ssd_serving_tiers`` with ``model_slos("ssd")``, greedy DS2 at
   the three edges with ``model_slos("ds2")`` and DS2 sessions
   (``ds2_streaming_tiers``, edge 16000 samples); ``FLEET_SSD``
   requests, ``FLEET_DS2`` utterances and ``FLEET_SESSIONS`` sessions of
   10-30 s in 1 s chunks submitted interleaved, then ``drain()``, the
   counters around it: every request done, no batch holding two models,
   every session closed and none failed, each session's pieces equal to
   a direct ``StreamingDS2``, K2 once an SSD batch and K3 6 times a DS2
   batch plus 3 times a streaming block; each model's p50, p99, batches
   and weight;
6f. frcnn_serving: Faster-RCNN VGG16 serving at full width (the
   py-faster-rcnn VGG16 trunk, 9 anchors, 6000/300 proposals, 7 x 7 ROI
   pooling, fc6/fc7 of 4096, 21 classes, ``FrcnnPostParam`` defaults,
   fp32 on the 512² canvas, batch 8, seeded weights); every launch
   counter set to 0 at its start and read at its end: no K1-K4 launch
   (the path runs none of the four, as in the reference).  Each stage on
   the card against the CPU on one image: the trunk, the RPN's scores
   and deltas and the heads (fed the CPU's pooled map) within
   ``FRCNN_STAGE_TOL`` relative max-abs; the proposal fed the CPU's
   scores and deltas, its kept indices equal unless the first differing
   decision's IoU, score or size margin is under ``FRCNN_MARGIN``
   (counted and printed); ``roi_pool`` fed the CPU's map and ROIs,
   bit-equal; the post-processing fed the CPU's probabilities and
   boxes, rows equal.  ``FrcnnPredictor.predict`` on 4 batches of 8
   shapes records of ``FRCNN_RECORD_SIZES`` (nvJPEG, cv2 unimportable,
   ``AspectScaleCanvas`` resampling on the card's route), equal to
   ``detect_batch`` on the same staged batches, detections in range.
   ``detect_batch`` by the host clock (median of ``FRCNN_TIMED``), split
   with CUDA events into upload, trunk, rpn, proposal (its NMS rounds
   apart), roi_pool, heads, post (its NMS rounds apart) and readback;
   one batch under ``torch.profiler``: kernel ms by stage, launches and
   the device's busy share.  ``frcnn_serving_tiers`` (fp, int8) behind
   ``ServingRuntime(n_replicas=2, max_batch=8)``: ``FRCNN_REQUESTS``
   requests, then ``drain()``, no fence, failure or shed, the rows the
   fp predictor's; each rung forced in ``FRCNN_WINDOWS`` interleaved
   windows of one batch (ms a batch), each rung's rows its predictor's,
   the int8 rung's detections against fp's with the largest score
   difference;
6g. frcnn_train: Faster-RCNN VGG16 training at the reference bench's
   configuration (21 classes, ``ProposalParam(2000, 128)``, the 512²
   canvas, batch 8, 4 gt boxes an image, seeded shapes images and
   weights); every launch counter set to 0 at its start and read at its
   end: no K1-K4 launch (asserted).  At batch 2, dropout off, the card
   against the CPU on the same weights: the card's forward fed the CPU's
   proposals (its proposal op held to the CPU's on the CPU's RPN
   outputs, kept indices equal unless a decision's margin is under
   ``FRCNN_MARGIN``), the sampled targets of both on the CPU's outputs
   EQUAL, the loss within ``FRCNN_LOSS_TOL``, each gradient under the
   CPU's upstream gradient within ``FRCNN_GRAD_TOL`` (the trunk's within
   ``FRCNN_TRUNK_GRAD_TOL``).  ``train_frcnn`` over one epoch of
   ``FRCNN_TRAIN_BATCHES`` batches: the epoch hook once, every loss
   finite; ``FRCNN_REPEAT`` steps on one batch, its loss falling; one
   bf16 step against one fp32 step from the same weights (the loss
   within ``FRCNN_BF16_TOL``, the update's cosine at least
   ``FRCNN_BF16_COS``).  Then a ``timing`` line: the step by the host
   clock (median of ``FRCNN_TRAIN_TIMED`` after 2), one step under
   ``torch.profiler`` split into upload, forward and loss (the proposal
   and its NMS rounds apart), backward and update, with its launches and
   the device's busy share, and the steps' peak memory;
6h. caffe_graph: ``build_caffe_graph`` on the SSD300 deploy net
   (``ssd300_deploy_prototxt``, the SSD-Caffe release's) and on
   py-faster-rcnn's VGG16 deploy net (``frcnn_vgg16_deploy_prototxt``:
   the Python proposal layer, ROIPooling), each on a seeded caffemodel
   written by ``save_caffemodel`` and loaded into the graph
   (``load_caffe_weights``) and into ``SSDVgg`` (``load_ssd_vgg_caffe``)
   or ``FasterRcnnVgg`` (``load_frcnn_vgg_caffe``), every blob used; on a
   batch of 8 shapes images the SSD graph's detections (K2 once a
   forward) against ``SSDVgg``'s with K2's tolerances, and the
   Faster-RCNN graph's proposals equal to ``FasterRcnnVgg``'s, its class
   probabilities and box deltas within ``FRCNN_STAGE_TOL``; then a
   ``timing`` line: each graph's forward and its model's (CUDA events);
6i. ssd_variants: ``SSDAlexNet`` and ``SSDMobileNet`` (21 classes, seeded)
   through ``SSDPredictor`` with ``backend="auto"`` on
   ``VARIANT_BATCHES`` batches of 8 shapes images, the counters set to 0
   just before and read just after: K2 once a batch, K1 never; the rows
   against the plain path's with K2's tolerances; then a ``timing``
   line: ``detect_batch`` by the host clock (median of
   ``VARIANT_TIMED``) and the forward (CUDA events);
6j. the model-zoo long tail, each phase with K1-K4's launch counters
   set to 0 at its start and asserted 0 at its end (none of these paths
   reaches a kernel, as in the reference), then its ``timing`` line;
   TF32 off. ``fraud``: a seeded frame at creditcard.csv's shape
   (``FRAUD_ROWS`` rows, ``time``, 28 PCA-like components and
   ``amount``, ``FRAUD_POSITIVES`` frauds) through
   ``run_fraud_pipeline`` with ``FRAUD_MODELS`` models of
   ``FRAUD_EPOCHS`` epoch (cut from the reference's 20 x 10; the line
   says so): every loss finite, the AUPRC printed; one ``FraudMLP``
   loss and its gradients on the card against the CPU from the same
   weights within ``ZOO_LOSS_TOL`` / ``ZOO_GRAD_TOL``;
   ``ZOO_REQUESTS`` scaled rows through ``ServingRuntime(
   fraud_serving_tiers(...), n_replicas=2, max_batch=8)``, all done, the
   rows the fp tier's, each rung forced in ``ZOO_WINDOWS`` windows
   (``rung_speed_vs_fp``); the timing line: the step of 64 (median of
   50), each epoch, serving p50/p99. ``rec``: ``NeuralCF`` and
   ``WideAndDeep`` at MovieLens-1M's counts (6,040 users, 3,952 items,
   dim 20, GMF 8, hidden (40, 20), 5 classes, 1000 cross buckets) on
   batches of ``REC_BATCH`` Zipf(1.3) ids: the dedup, naive and onehot
   forwards and table gradients within ``LOOKUP_TOL``, the dedup
   backward repeated bit for bit, ``sparse_adam_apply`` equal to a
   dense ``Adam`` step on the touched rows; ``train_recommender`` for
   200 steps with ``MAE`` and ``Loss`` validated before and after, the
   loss falling; card vs CPU loss and gradients of both models;
   ``ZOO_REQUESTS`` (user, item) pair requests through the runtime, all
   done; the timing line: the step of 256, each lookup's forward and
   forward + backward by mode (CUDA events), serving p50/p99.
   ``sentiment``: ``make_sentiment_model`` at its defaults (vocab
   20,000, dim 100, hidden 128, ``seq_len`` 128) for each of the five
   heads and a frozen-table GRU: card vs CPU forward, loss and
   gradients at batch 8 (``SENT_GRAD_TOL``); ``train_sentiment`` for 20
   steps of 64 on the GRU head, the loss falling; the fp and int8 rungs
   through the runtime, the int8 rows within ``SENT_INT8_TOL`` of fp's;
   the timing line: each head's forward and train step at 64 x 128 (the
   recurrent heads run the blocked scan, 128 steps a batch).
   ``zoo_pool``: the three families on one ``ServingRuntime(models=
   [...], n_replicas=2, max_batch=8)``, ``ZOO_POOL_REQUESTS``
   interleaved requests, none failed, no batch holding two models, the
   per-model accounting; then a ``timing`` line of the four phases'
   seconds;
6k. ds2_resume: the 5c model (hidden 1760, 3 layers, "pallas") trained
   through ``Optimizer`` on one epoch of ``RESUME_STEPS`` 5c batches of
   8, snapshots every ``RESUME_EVERY`` iterations (``step_N``,
   ``keep_last=2``): run A straight; run B under ``run_resilient`` from
   the same seed and weights, a ``FaultInjector`` failing it before
   batch ``RESUME_FAIL_AT``, the second attempt resuming from that
   snapshot; K3's and K4's counts at 0 just before A and read after each
   run: 6 each an executed step, ``RESUME_STEPS`` steps in each run (a
   resume repeats none); a second straight run's spread from A, which
   fails past ``RESUME_CEIL``; B's losses, parameters, batch statistics
   and Adam slots against A's within ``RESUME_TOL``, or
   ``RESUME_SPREAD`` times the spread, never past ``RESUME_CEIL``
   (max-abs, max-relative and bit-equality printed); the newest snapshot
   truncated, a fresh resume lands on the older one at its iteration,
   takes no step and equals the crashed attempt's state bit for bit;
   ``train_ssd`` with
   ``TrainParams(checkpoint_path=...)`` for one epoch of 2 resident
   synthetic batches of 8 writes a ``latest`` snapshot that verifies,
   and ``set_resume`` restores it onto the card equal; the snapshot's
   bytes, the save seconds by phase (device to host, ``torch.save``,
   sha256, publish), verify and restore seconds and peak GB.  Then
   ``ds2_legacy``: ``rnn_engine="legacy"`` against ``"blocked"`` on one
   batch cut to ``LEGACY_FRAMES`` frames, 1 layer, the log-prob
   max-abs difference within ``DS2_LOGP_TOL`` and each forward's ms;
   ``ds2_loader``: ``load_asr_train_set(worker_processes=2)`` on this
   host against the serial 5c batches, array for array;
6l. ssd_swap: SSD300 (21 classes, seed 0) on ``ServingRuntime(models=
   [ModelConfig(ssd_serving_tiers, weights_to_tiers=...)],
   n_replicas=2, max_batch=8)``; seed-1 weights published with
   ``checkpoint.save(step=1)`` and swapped in with a 0.25 canary
   (``canary_min=8``, a divergence budget of 1e9, ``lkg_after=1``)
   while ``SWAP_REQUESTS`` requests arrive, K1's and K2's counts at 0
   just before and read after ``SWAP_REQUESTS`` more: the rollout
   completes, both replicas installed once, every request done, the
   rows afterwards equal ``SSDPredictor(seed-1 model)``'s, ``serve-lkg``
   promoted, K2 launched for every live forward, the install warm-ups
   and at least one mirrored forward, K1 never; a second publish with a
   divergence budget of 1e-6 (every row mirrored) trips the canary and
   rolls back before any drain, the rows still seed-1's; a corrupt
   publish raises ``CheckpointCorrupt`` and starts no rollout;
   load+verify and rollout seconds, each install's seconds, request
   p50/p99 before, during and after, peak GB; then a ``timing`` line of
   the two phases' seconds;
6m. dist_dp: ``DIST_WORLD`` ranks, each a process ``utils.engine.spawn``
   starts (it and this script import the port only), on the one card
   over gloo (``DIST_BACKEND``; NCCL refuses two ranks of a communicator
   on one device); each rank first probes which collectives gloo takes
   on CUDA tensors (printed; ``DIST_NEEDS`` must pass).  DS2 at the
   widths above (``rnn_engine="pallas"``): ``train_ds2(mesh=
   create_mesh((2,)))`` for ``DIST_DS2_STEPS`` steps on global batches
   of 8 × ``DIST_DS2_FRAMES`` frames, counters at 0 just before and read
   just after (6 K3 and 6 K4 launches a step on every rank), the first
   step's loss against the one-process step on the same rows within
   ``DIST_LOSS_TOL``, its gradients (each rank's averaged ``.grad``)
   within ``DIST_GRAD_TOL`` as ``grads_err`` holds them, the step's ms
   on each rank (host clock, the first step and the gradient tap left
   out) against the one-process step's, and the flat gradient
   all-reduce alone; SSD300 fp32: ``train_ssd`` for ``DIST_SSD_STEPS``
   steps of ``DIST_SSD_BATCH`` with a validation of ``DIST_SSD_VAL``
   images (K2 on every rank's rows, the results merged), the first
   step's loss and gradients (as one vector) against the one-process
   step's, the merged detections EQUAL to this process's of the same
   halves, and against its batch of 8 (``DIST_MATCH_MIN``,
   ``DIST_SCORE_TOL``; the mAP printed);
6n. dist_tp: the choice (world ``DIST_TP_WORLD`` over gloo, whose
   ``DIST_NEEDS`` dist_dp probed) printed; on a ("data", "model") mesh
   of (1, 2): ``train_ssd(tp="megatron")`` for ``DIST_TP_STEPS`` steps
   of ``DIST_TP_SSD_BATCH`` with a validation of ``DIST_SSD_VAL`` images
   through K2, each rank's detections against the one-process
   validation of the gathered weights (``DIST_MATCH_MIN``,
   ``DIST_SCORE_TOL``), and ``train_ds2(param_rules=default_tp_rules())`` for
   ``DIST_TP_STEPS`` steps (K3/K4 take the h2h weights gathered whole),
   the first losses and gradients against the unsharded steps; then a
   world-1 NCCL group: an all-reduce on the card and a data-parallel
   step over the one-rank mesh;
6o. dist_seq: ``DIST_WORLD`` ranks on a ("sequence",) mesh, the probe
   first (``DIST_NEEDS``, ``all_to_all`` the sequence exchanges' one
   collective).  DS2 at the widths above (``rnn_engine="pallas"``):
   ``sequence_parallel_forward`` of 8 × ``SEQ_FRAMES`` frames, counters
   at 0 just before and read just after (K3 6 a rank: a chunk's kernel
   runs in the rank's own round only), the log-probs against this
   process's whole-T forward within ``SEQ_LOGP_TOL``;
   ``DeepSpeech2Pipeline(sequence_mesh=)`` on one ``SEQ_UTT_S`` s
   utterance, its transcript EQUAL to this process's;
   ``train_ds2(sequence_parallel=True)`` for ``SEQ_TRAIN_STEPS`` steps of
   8 × ``SEQ_TRAIN_FRAMES`` frames (K3 and K4 6 a step a rank), the first
   loss within ``SEQ_LOSS_TOL`` and every gradient within
   ``SEQ_GRAD_TOL`` of this process's; the ms of a forward and of a step
   by rank against this process's, and one more step with every
   collective synchronized and timed (the collectives' share);
6p. dist_attn: ``AttentionASR`` at the reference's defaults on 8 ×
   ``ATTN_FRAMES`` frames, the probe first: ``RingAttentionLayer`` on a
   ("data", "sequence") mesh of (1, 2) against ``full_attention`` in
   this process (``ATTN_RING_TOL``), the encoder and head on a rank's
   T-block (one gather a forward, at the exit, and one hop a layer,
   counted), its ms and peak GB by rank; ``ATTN_RING_STEPS`` ring
   training steps (``make_train_step`` on that mesh), the first loss
   against this process's whole step (``DIST_LOSS_TOL``), ms and peak GB
   by rank against this process's; ``make_pipeline_forward_fn`` on
   ("pipe",) of 2 at depth ``ATTN_PIPE_DEPTH`` with ``ATTN_PIPE_MICRO``
   microbatches against the unpipelined model (``ATTN_PIPE_TOL``) and
   one training step's loss (``ATTN_LOSS_TOL``); two experts one a rank
   on ("expert",) of 2 at a capacity that admits every token, the
   routing (expert ids; slots, a sender's bucket offset by the earlier
   senders' tokens) EQUAL to the dense path's and the log-probs within
   ``ATTN_MOE_TOL``; no K1-K4 launch;
6q. telemetry: the telemetry spine and the anomaly ladder.  DS2 at the
   widths above (``rnn_engine="pallas"``, Adam) on ``TELEMETRY_STEPS``
   batches of 8 × ``DIST_DS2_FRAMES`` frames, those at
   ``TELEMETRY_NAN`` with a seeded NaN feature: first one step of
   ``make_train_step(skip_unhealthy=True)`` on a poisoned batch leaves
   the parameters, Adam's slots and every buffer bit-equal on the card,
   its word naming sections; then ``Optimizer`` with ``set_checkpoint``,
   ``set_anomaly_policy(AnomalyPolicy(rollback_after=2,
   promote_after=1))`` and ``set_observability``, counters at 0 just
   before and read just after: one skip, a rollback to the ``lkg`` slot
   (the parameters equal to the snapshot's) after the two-batch episode,
   the forensics bundles' batch fingerprints equal to the host batches',
   ``span_conservation`` clean over the ``train-`` traces, one
   ``train_step`` span an executed step and the checkpoint's spans, 6 K3
   and 6 K4 launches an executed step; a second run with
   ``max_rollbacks=0`` raises ``TrainingDiverged`` and writes the black
   box; a clean step's ms and peak GB armed (sentinel and spans) against
   un-armed, in interleaved windows.  The poisoned batch's health word
   on the card equals the word one step of the same model on the CPU
   gives for it (K3 and K4 propagate a NaN as their plain versions do).
   SSD300 on ``ServingRuntime(
   n_replicas=2, max_batch=8, obs=Observability())``:
   ``TELEMETRY_REQUESTS`` requests with one replica's forward crashing
   once (a fence, the black-box dump, a failover): every completed
   request's critical path tiles its root span within
   ``CONSERVATION_TOL_S``, the ``TraceStore``'s served, shed and failed
   counts equal ``ServingMetrics``', every registry name renders in
   ``render_prometheus`` and resolves in ``CATALOG``, K2 once a batch;
   p50/p99 with ``obs=`` and without in interleaved windows (K2 equal),
   and the tail-attribution rows.  ``train_ssd`` with
   ``TrainParams(log_dir=...)``: 2 steps of ``TELEMETRY_SSD_BATCH`` and
   one validation batch of 8 (K2), the event files read back (tags,
   steps, values equal to the run's);
6r. dist_spatial: ``train_ssd(tp="spatial")`` on a ("data", "model")
   mesh of (1, 2), the image rows over the two ranks (each layer's halo
   rows fetched from the rank that holds them), SSD300 at batch
   ``SPATIAL_SSD_BATCH``, 2 steps and a validation of 8 through K2 on
   every rank: the first step's loss and gradients against one
   process's (``DIST_LOSS_TOL``, ``DIST_GRAD_TOL``), the validation rows
   ``SPATIAL_MATCH_MIN`` matched; ms a step by rank, the row fetches' ms
   and share of a step, K2's launches by rank;
6s. dist_serve: on a ("data",) mesh of 2, SSD300 ``detect_batch`` of 8
   (K2 on each rank's 4 rows) and DS2's 8 × 30 s (K3 six times a rank),
   each rank's rows EQUAL to this process's of its half and the
   transcripts EQUAL; then ``SERVE_REQUESTS`` SSD requests through
   ``ServingRuntime(specs=)`` on rank 0 with ``serve_follower`` on rank
   1 and a hot swap half-way: 0 failed, the swap built on both ranks,
   the rows matched to a one-process runtime's (``DIST_MATCH_MIN``),
   p50/p99 against it; the launches by rank; the sharded calls'
   guarded gather against a gather per output on the same rows
   (``guarded_gather_ms``);
6v. accuracy: ``examples/train_shapes_e2e`` at the reference's defaults
   (SSD300 from scratch on 800 rendered-shapes records, validation
   through K2 every epoch, an end at mAP 0.9 or epoch 30),
   then ``tools/eval_quantized_ssd`` on its weights (fp, int8 weight-only,
   int8 × int8, bf16 through K2; fp_approx_topk and ``--backend pallas``
   through K1): the final mAP above ``ACCURACY_MIN_MAP``, the K1 and K2
   rungs within ``ACCURACY_K1_K2_TOL``, the deltas reported, K1 and K2
   held to their plain versions and timed on the trained detections;
6w. examples: the ten other command-line examples (``examples_phase``);
6x. tools: ``tools/profile_serve`` at the reference's defaults (SSD300,
   batch 128, bg-bias 8, bf16) for ``fused`` (K2's "decode", "select"
   and "full" stages) and ``pallas`` (K1), ``export_serving --verify``
   (SSD300 and DS2 at hidden 1760), ``convert_caffe`` (npz and
   ``--build``), a ``seqfile_to_azr`` round trip, ``serve_drill``,
   ``obs_drill`` and ``az_trace --drill`` at full size with the
   sentinel, every report linted; then each K2 stage on the backbone's
   loc/conf against its plain version (``TOOLS_PROBE_TOL``), its ms and
   bound (``tools_profile``, ``tools`` and ``timing`` lines);
6u. analyze: the source rules, the kernel-bearing programs with the sync
   debug mode armed, and the sync gate (``SYNC_TARGETS``: 0 debug-mode
   syncs; a seeded ``rec/train`` step twice bit-equal);
7. a ``timing`` line of the whole script's seconds, the ``kernels``
   line, then the device line last.

Exits non-zero, printing no result, when no CUDA device is present or
the port's package is not beside this script.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
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
# DS2 online serving: requests of 3-30 s through the runtime at the
# training buckets; each rung forced in windows of one batch of 3-10 s
# (the 1000 edge); two 20 s streams in 1 s chunks at StreamingDS2's
# block of 100 frames; the multiplexed pool's SSD requests, DS2
# utterances and sessions of 10-30 s
DS2_ONLINE_REQUESTS, DS2_RUNG_WINDOWS = 24, 3
DS2_STREAM_SECONDS = (20, 20)
STREAM_CHUNK, STREAM_BLOCK = 16000, 100
FLEET_SSD, FLEET_DS2, FLEET_SESSIONS = 32, 16, 8
# K3 at the streaming blocks' geometry: B = 1 and the output frames of
# the first (48), a steady (50) and the flush block (52)
K3_STREAM_T = (48, 50, 52)
# two forwards of one utterance through differently shaped programs: a
# served row's valid log-probs against the utterance forwarded alone at
# its own length (another batch size takes other GEMM and convolution
# kernels, whose sums run in another order: 7.2e-5 max-abs, 0.33 of the
# bound, NVIDIA H100 80GB HBM3, 700.00 W), and streamed
# log-probs against the whole-utterance forward; the reference's bound
# for the streaming case (tests/test_streaming_ds2.py), |a - b| <=
# atol + rtol * |b|
STREAM_RTOL, STREAM_ATOL = 1e-4, 1e-5
# the DS2 runtime's wedge bound: a beam16 batch of 8 rows of up to 10 s is
# seconds of Python decode that scale with the host's core (2.0-2.9 s on
# the host of an NVIDIA H100 80GB HBM3, 700.00 W), which is its work and
# not a wedge
DS2_WEDGE_S = 120.0
# Faster-RCNN VGG16 serving at the reference's full width (the py-faster-
# rcnn VGG16 trunk, 9 anchors, 6000/300 proposals, 7 x 7 ROI pooling,
# fc6/fc7 of 4096, 21 classes, FrcnnPostParam defaults) on the 512²
# canvas of FrcnnPredictor's default PreProcessParam, batch 8: record
# batches served through predict(records), detect_batch timed (median of
# FRCNN_TIMED after 2), requests through the runtime and each rung forced
# in FRCNN_WINDOWS interleaved windows of one batch
FRCNN_RESOLUTION, FRCNN_RECORD_BATCHES = 512, 4
FRCNN_TIMED, FRCNN_REQUESTS, FRCNN_WINDOWS = 7, 32, 5
# the records' original sizes (h, w): non-square and square, larger and
# smaller than the canvas, so AspectScaleCanvas resamples every one
FRCNN_RECORD_SIZES = ((375, 500), (500, 375), (333, 500), (480, 640),
                      (512, 512), (300, 450), (640, 427), (256, 384))
# a stage on the card against the CPU on the same inputs, fp32, TF32
# off: relative max-abs error of the trunk's map, the RPN's scores and
# deltas and the heads' probabilities and deltas (the SSD forward's
# bound); a proposal decision (the next kept candidate) whose IoU or
# score margin lies within FRCNN_MARGIN of the threshold or of the
# competing candidate may go either way on two platforms
FRCNN_STAGE_TOL = 1e-4
FRCNN_MARGIN = 1e-5
# the model's FrcnnParam: None is FrcnnParam(), the full width (a CPU
# rehearsal of the phase sets a small one)
FRCNN_PARAM = None
# Faster-RCNN training at the reference bench's configuration
# (bench.py bench_frcnn_train: FrcnnParam(num_classes=21,
# proposal=ProposalParam(2000, 128)) on the 512² canvas, batch 8, 4 gt
# boxes an image): train_frcnn over one epoch of FRCNN_TRAIN_BATCHES
# seeded shapes batches, FRCNN_REPEAT steps on one batch, the step timed
# (median of FRCNN_TRAIN_TIMED after 2); FRCNN_TRAIN_PARAM None is the
# bench's (a CPU rehearsal sets a small one)
FRCNN_TRAIN_RES, FRCNN_TRAIN_BATCH, FRCNN_TRAIN_GT = 512, 8, 4
FRCNN_TRAIN_BATCHES, FRCNN_REPEAT, FRCNN_TRAIN_TIMED = 6, 5, 5
FRCNN_TRAIN_PARAM = None
# its loss and gradients on the card against the CPU at batch 2, fp32,
# TF32 off, dropout off, each side's gradient under the CPU's upstream
# gradient: the loss relative; each gradient's relative L2 error, the
# RPN's and the heads' within FRCNN_GRAD_TOL, the trunk's within
# FRCNN_TRUNK_GRAD_TOL: the two platforms' maps differ by ~1e-6, so a
# 2 x 2 max pool or an ROI bin whose two largest values lie closer sends
# its gradient to the other element (on the CPU one such pool window
# moves conv4_3's kernel gradient by 4.5e-4 and conv1_1's by 6.7e-3,
# tests/test_torch_frcnn_train.py)
FRCNN_LOSS_TOL = 1e-5
FRCNN_GRAD_TOL = 1e-3
FRCNN_TRUNK_GRAD_TOL = 2e-2
# the bf16 step (autocast over fp32 weights) against the fp32 step from
# the same weights, batch and dropout masks: the loss relative, and the
# update (the change of the weights over all tensors) by its cosine with
# fp32's.  Not by its distance: the proposal ranks bf16 RPN scores, so
# the heads see other ROIs and the sampling other anchors, and the
# updates differ by 0.056 relative L2 at this configuration (cosine
# 0.9985, the loss 7.0e-3 apart; NVIDIA H100 80GB HBM3, 700.00 W) and by
# 0.32 (cosine 0.948) in a CPU rehearsal at 128 px
FRCNN_BF16_TOL = 5e-2
FRCNN_BF16_COS = 0.99
# SSDAlexNet and SSDMobileNet served: batches of 8, host-clock timed
# batches
VARIANT_BATCHES, VARIANT_TIMED = 2, 5
# the Faster-RCNN VGG16 deploy net's ROI pooling (7, py-faster-rcnn's; a
# CPU rehearsal sets a small one), its proposal layer's ProposalParam()
CAFFE_FRCNN_POOLED = 7


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
    """Each tensor's relative L2 error: against its own norm, or the
    largest of ``want``'s for a bias in front of a BN (``conv1``,
    ``proj{i}``, past an Adam slot's ``mu.``/``nu.`` prefix), whose
    gradient is 0 up to rounding."""
    top = max(w.float().norm().item() for w in want.values())
    errs = {}
    for k, w in want.items():
        module = k.removeprefix("mu.").removeprefix("nu.")
        before_bn = k.endswith(".bias") and module.startswith(
            ("conv1", "proj"))
        errs[k] = (got[k].float() - w.float()).norm().item() / (
            top if before_bn else max(w.float().norm().item(), 1e-30))
    return errs


def profile_train_step(fn, top: int = 8, root: str = "train_step",
                       nested=("multibox_loss",)):
    """One call of ``fn`` (a train step of ``make_train_step``) under
    ``torch.profiler``, every number read from that one trace (its chrome
    export): the device time of each kernel, summed by name (ms, the
    ``top`` largest); the device time of the kernels launched inside each
    of the step's ranges (``upload``, ``forward_loss``, ``backward``,
    ``update``, and the ranges whose names start with one of ``nested``:
    ``multibox_loss`` inside ``forward_loss`` where the criterion is
    SSD's), summed over every instance of a range (one a
    microbatch), a kernel going to the range that holds its launch on the
    host clock, whatever thread launched it (autograd runs the backward on
    a thread of its own); the step's span, from the start of its ``train_step``
    range to the end of its last kernel; and the share of that span in
    which the device ran something (overlapping kernels counted once,
    so the share is at most 1), and the kernels launched in it.  ``root``
    names the step's range and prefixes its parts' (``root.part``)."""
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
                (root,) + tuple(nested)):
            ranges.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e["dur"]))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launch_us[args["correlation"]] = e["ts"]
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((e["ts"], e["ts"] + e["dur"], e["name"],
                           args.get("correlation")))
    ((t0, t1),) = ranges[root]
    device = [d for d in device if t0 <= launch_us.get(d[3], -1) <= t1]
    span_us = max([t1] + [d[1] for d in device]) - t0
    by_name, parts = {}, {}
    for start, end, name, corr in device:
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + (end - start) / 1e3
        for part, spans in ranges.items():
            if part != root and any(
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
            "kernel_ms_by_name": ranked,
            "launches": sum(1 for d in device if d[2] and not d[2].startswith(
                ("Memcpy", "Memset")))}


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
        w32 = m.weight
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


def host_ms(fn) -> float:
    """Host-clock ms of one call of ``fn`` (which ends in a readback)."""
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def record_batches(rt):
    """Wrap ``rt._dispatch`` to keep each batch's model, affinity, rids,
    models of its requests and (for DS2) its padded input."""
    seen = []
    orig = rt._dispatch

    def record(batch):
        x = batch.batch.get("input")
        seen.append({"model": batch.model, "affinity": batch.affinity,
                     "rids": [r.rid for r in batch.requests],
                     "models": sorted({r.model for r in batch.requests}),
                     "n_valid": batch.n_valid, "edge": str(batch.edge),
                     "input": (x.copy() if "n_frames" in batch.batch
                               else None),
                     "n_frames": batch.batch.get("n_frames")})
        orig(batch)

    rt._dispatch = record
    return seen


def check_served(rt, what, n):
    """Every request done, the accounting balanced, no fence, failure or
    shed; returns the metrics snapshot."""
    acct = rt.accounting()
    metrics = rt.snapshot()["metrics"]
    fences = [e for e in rt.pool.events if e["kind"] == "replica_fenced"]
    if (acct["by_state"] != {"done": n} or acct["unaccounted"] or fences
            or metrics["failed"] or metrics["shed_total"]):
        raise AssertionError(f"{what}: accounting {acct}, fences {fences}, "
                             f"metrics {metrics}")
    return metrics


def ds2_online_phase(dev, smi):
    """DS2 online serving on the card (phases ``ds2_online_k3``,
    ``ds2_online``, ``ds2_streaming`` and ``fleet``); returns the
    launches of K2 and K3 on its paths and K3's largest error at the
    streaming geometry."""
    import statistics

    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.models.deepspeech2 import (
        ds2_valid_out_frames)
    from analytics_zoo_tpu_torch.models.ssd import build_ssd_vgg
    from analytics_zoo_tpu_torch.obs import model_slos
    from analytics_zoo_tpu_torch.ops import pallas_detout, pallas_rnn
    from analytics_zoo_tpu_torch.pipelines.deepspeech2 import (
        DS2Param, StreamingDS2, ds2_serving_tiers, ds2_streaming_tiers,
        make_ds2_model)
    from analytics_zoo_tpu_torch.pipelines.ssd import (BGR_MEANS,
                                                       PreProcessParam,
                                                       ssd_serving_tiers)
    from analytics_zoo_tpu_torch.serving import (ModelConfig,
                                                 MonotonicClock,
                                                 ServingRuntime)
    from analytics_zoo_tpu_torch.transform.audio import (beam_search_decode,
                                                         best_path_decode,
                                                         featurize)

    rng = np.random.RandomState(41)
    H = DS2_HIDDEN

    def k3_count():
        torch.cuda.synchronize()
        return pallas_rnn.persistent_rnn.launches

    # -- 1. K3 at the streaming geometry: B = 1, a carried h0 ------------
    k3_err = 0.0
    for T in K3_STREAM_T:
        pre, w, b, _, n = rnn_inputs(rng, dev, "vanilla", 1, T, H, False,
                                     torch.float32)
        h0 = torch.from_numpy(rng.rand(1, 1, H).astype(np.float32)
                              * 5.0).to(dev)
        args = (pre, w, b, h0, n)
        ys, cf = pallas_rnn.persistent_rnn(*args, cell="vanilla",
                                           activation="clipped_relu")
        torch.cuda.synchronize()
        want_ys, want_cf = pallas_rnn.persistent_rnn_plain(
            pallas_rnn.RnnKernelConfig("vanilla", "clipped_relu"), *args)
        errs = {}
        for what, got, want in (("ys", ys, want_ys), ("carry", cf, want_cf)):
            err = (got - want).abs().max().item()
            rel = err / max(want.abs().max().item(), 1e-6)
            if not rel <= 1e-4:
                raise AssertionError(f"K3 stream T={T} {what}: relative "
                                     f"max-abs error {rel} (tol 1e-4)")
            errs[what], errs[what + "_rel"] = err, rel
            k3_err = max(k3_err, err)
        if cf.dtype != torch.float32 or not torch.equal(cf[0], ys[:, -1]):
            raise AssertionError(f"K3 stream T={T}: the carry is not the "
                                 "last step's fp32 output")
        check_repeatable(f"K3 stream T={T}", lambda: pallas_rnn.persistent_rnn(
            *args, cell="vanilla", activation="clipped_relu"))
        k3_ms = cuda_ms(lambda: pallas_rnn.persistent_rnn(
            *args, cell="vanilla", activation="clipped_relu"), 20)
        k3_bound, k3_by = bound(*rnn_work(*args))
        emit("ds2_online_k3", B=1, T=T, H=H, activation="clipped_relu",
             h0="random", w_source=pallas_rnn.persistent_rnn.w_source,
             max_abs_err_ys=errs["ys"], max_abs_err_carry=errs["carry"],
             rel_err_ys=errs["ys_rel"], rel_err_carry=errs["carry_rel"],
             tolerance_rel=1e-4, repeatable=True, ms=k3_ms,
             bound_ms=k3_bound, bound_by=k3_by)

    # -- 2. DS2 requests through the runtime ---------------------------
    ds2 = make_ds2_model(hidden=H, n_rnn_layers=3, rnn_engine="pallas",
                         seed=0, device=dev)
    tiers = ds2_serving_tiers(ds2, DS2Param(decoder="beam", beam_width=16),
                              device=dev)
    eval_step = tiers[0].device_program()[0]

    def forward(x, n):
        return eval_step((torch.from_numpy(np.ascontiguousarray(x)).to(dev),
                          torch.from_numpy(np.asarray(n, np.int32)).to(dev)))

    for e in DS2_BUCKETS:                   # cuDNN / cuBLAS per edge
        forward(np.zeros((BATCH, e, 13), np.float32), [e] * BATCH)
    seconds = [float(s) for s in rng.uniform(3, 30, DS2_ONLINE_REQUESTS)]
    feats = [featurize(x) for x in synthetic_utterances(seconds,
                                                        seed=43).values()]
    rt = ServingRuntime(tiers, n_replicas=2, max_batch=BATCH,
                        bucket_edges=list(DS2_BUCKETS), queue_capacity=64,
                        default_deadline_s=3600.0,
                        wedge_timeout_s=DS2_WEDGE_S, clock=MonotonicClock())
    greedy = len(tiers) - 1
    rt.ladder.tier = greedy
    batches = record_batches(rt)
    pallas_rnn.persistent_rnn.launches = 0
    t0 = time.perf_counter()
    for f in feats:
        rt.submit({"input": f}, length=f.shape[0])
    rt.drain()
    online_launches = k3_count()
    served_s = time.perf_counter() - t0
    metrics = check_served(rt, "DS2 runtime", DS2_ONLINE_REQUESTS)
    if online_launches != 6 * len(batches):
        raise AssertionError(f"DS2 runtime: {len(batches)} batches launched "
                             f"K3 {online_launches} times (want 6 each)")
    if {r.tier for r in rt.requests} != {greedy}:
        raise AssertionError("DS2 runtime: the ladder left greedy")
    # each row's valid log-probs against the utterance alone at its length
    by_rid = {r.rid: r for r in rt.requests}
    row_err, row_ratio, flips, near_ties, text_diffs = 0.0, 0.0, 0, 0, 0
    for bt in batches:
        lp = forward(bt["input"], bt["n_frames"])
        for i, rid in enumerate(bt["rids"]):
            f = feats[rid]
            v = ds2_valid_out_frames(f.shape[0])
            alone = forward(f[None], [f.shape[0]])[0, :v]
            row = lp[i, :v]
            diff = (row - alone).abs()
            allowed = STREAM_ATOL + STREAM_RTOL * alone.abs()
            row_err = max(row_err, diff.max().item())
            row_ratio = max(row_ratio, (diff / allowed).max().item())
            served = str(by_rid[rid].result)
            if served != best_path_decode(row.cpu().numpy()):
                raise AssertionError(f"DS2 runtime request {rid}: the served "
                                     "transcript is not its row's")
            if served != best_path_decode(alone.cpu().numpy()):
                # a frame may flip its argmax only where the top two lie
                # within what the two forwards may move them apart
                text_diffs += 1
                top2 = torch.topk(alone, 2, dim=-1).values
                differ = row.argmax(-1) != alone.argmax(-1)
                margin = (top2[:, 0] - top2[:, 1])[differ]
                room = 2 * (STREAM_ATOL + STREAM_RTOL * top2[:, 0].abs())
                flips += int(differ.sum().item())
                near_ties += int((margin <= room[differ]).sum().item())
    if row_ratio > 1.0 or near_ties != flips:
        raise AssertionError(f"DS2 runtime rows against alone forwards: "
                             f"max-abs {row_err}, {row_ratio} of the bound "
                             f"(rtol {STREAM_RTOL}, atol {STREAM_ATOL}); "
                             f"{flips} argmax flips, {near_ties} of them "
                             "within the bound of a tie")
    chars = sum(len(str(r.result)) for r in rt.requests)
    emit("ds2_online", nvidia_smi=smi, requests=DS2_ONLINE_REQUESTS,
         audio_s=sum(seconds), n_replicas=2, bucket_edges=list(DS2_BUCKETS),
         batches=len(batches),
         batch_edges=[bt["edge"] for bt in batches],
         batch_fill=[bt["n_valid"] for bt in batches],
         launches={"persistent_rnn": online_launches}, served_s=served_s,
         latency_p50_s=metrics["latency_by_tier"][str(greedy)]["p50_s"],
         latency_p99_s=metrics["latency_by_tier"][str(greedy)]["p99_s"],
         fences=0, failed=metrics["failed"], shed=metrics["shed_total"],
         tier=tiers[greedy].name, chars=chars,
         rows_max_abs_err_vs_alone=row_err,
         rows_err_share_of_bound=row_ratio, rtol=STREAM_RTOL,
         atol=STREAM_ATOL,
         transcripts_differing_from_alone=text_diffs,
         argmax_flips=flips, argmax_flips_within_tolerance=near_ties)

    # -- 3. each rung forced in turn, in interleaved windows -----------
    win_s = [float(s) for s in rng.uniform(3, 10, BATCH)]
    win = [featurize(x) for x in synthetic_utterances(win_s,
                                                      seed=47).values()]
    edge = DS2_BUCKETS[0]
    x_win = np.zeros((BATCH, edge, 13), np.float32)
    for i, f in enumerate(win):
        x_win[i, :f.shape[0]] = f
    n_win = np.asarray([f.shape[0] for f in win], np.int32)
    decoders = {t.name: (best_path_decode if t.name == "greedy" else
                         (lambda lp, w=int(t.name[4:]): beam_search_decode(
                             lp, beam_width=w))) for t in tiers}
    # each window: the rung served through the runtime, then the host
    # decode of the same rows by its decoder alone, the transcripts equal
    lp_win = forward(x_win, n_win).cpu().numpy()
    rung_ms = {t.name: [] for t in tiers}
    decode_ms = {t.name: [] for t in tiers}
    for _ in range(DS2_RUNG_WINDOWS):
        for i, t in enumerate(tiers):
            rt.ladder.tier = i
            for f in win:
                rt.submit({"input": f}, length=f.shape[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if rt.pump(force=True) != 1:
                raise AssertionError(f"rung {t.name}: not one batch")
            rung_ms[t.name].append((time.perf_counter() - t0) * 1e3)
            done = rt.requests[-BATCH:]
            if {r.tier for r in done} != {i}:
                raise AssertionError(f"rung {t.name} served at tiers "
                                     f"{[r.tier for r in done]}")
            t0 = time.perf_counter()
            want = [decoders[t.name](lp_win[j, :ds2_valid_out_frames(n)])
                    for j, n in enumerate(n_win)]
            decode_ms[t.name].append((time.perf_counter() - t0) * 1e3)
            if [str(r.result) for r in done] != want:
                raise AssertionError(f"rung {t.name}: served transcripts "
                                     "differ from its decoder's")
    check_served(rt, "DS2 runtime with the rungs",
                 DS2_ONLINE_REQUESTS
                 + DS2_RUNG_WINDOWS * len(tiers) * BATCH)
    fwd_ms = cuda_ms(lambda: forward(x_win, n_win), 5)
    # one of the forward's six K3 launches at this edge (all rows full)
    k3_args = rnn_inputs(rng, dev, "vanilla", BATCH, edge // 2, H, False,
                         torch.float32)
    k3_edge_ms = cuda_ms(lambda: pallas_rnn.persistent_rnn(
        *k3_args, cell="vanilla", activation="clipped_relu"), 5)
    emit("ds2_online", nvidia_smi=smi, step="rungs", edge=edge,
         audio_s=sum(win_s), windows=DS2_RUNG_WINDOWS,
         rung_ms_per_batch={k: statistics.median(v)
                            for k, v in rung_ms.items()},
         rung_ms_windows=rung_ms,
         forward_ms_per_batch=fwd_ms, k3_ms_at_edge=k3_edge_ms,
         decode_ms_per_batch={k: statistics.median(v)
                              for k, v in decode_ms.items()},
         decode_ms_windows=decode_ms,
         tier_speed_hints=[t.speed for t in tiers],
         chars={t.name: sum(len(str(r.result)) for r in rt.requests
                            if r.tier == i and r.rid >= DS2_ONLINE_REQUESTS)
                // DS2_RUNG_WINDOWS for i, t in enumerate(tiers)})

    # -- 4. streaming, direct ------------------------------------------
    uni = make_ds2_model(hidden=H, n_rnn_layers=3, bidirectional=False,
                         rnn_engine="pallas", seed=0, device=dev)
    warm = StreamingDS2(uni, chunk_frames=STREAM_BLOCK, device=dev)
    warm.accept(np.zeros(3 * STREAM_CHUNK, np.float32))
    warm.flush()                         # first, steady and flush blocks
    streams = synthetic_utterances(DS2_STREAM_SECONDS, seed=53)
    block_ms, stream_s, blocks = [], [], 0
    pallas_rnn.persistent_rnn.launches = 0
    results = []
    for x in streams.values():
        stream = StreamingDS2(uni, chunk_frames=STREAM_BLOCK,
                              keep_log_probs=True, device=dev)
        busy = 0.0
        calls = [lambda c=x[k:k + STREAM_CHUNK]: stream.accept(c)
                 for k in range(0, len(x), STREAM_CHUNK)] + [stream.flush]
        for call in calls:
            before = len(stream._pieces)
            t0 = time.perf_counter()
            call()
            dt = time.perf_counter() - t0
            busy += dt
            ran = len(stream._pieces) - before
            if ran:
                block_ms.extend([dt * 1e3 / ran] * ran)
        blocks += len(stream._pieces)
        stream_s.append(busy)
        results.append((x, stream))
    stream_launches = k3_count()
    if stream_launches != 3 * blocks:
        raise AssertionError(f"streaming: {blocks} blocks launched K3 "
                             f"{stream_launches} times (want 3 each)")
    stream_err = []
    for x, stream in results:
        with torch.inference_mode():
            whole = uni(torch.from_numpy(featurize(x)[None]).to(dev))[0]
        whole = whole.cpu().numpy()
        got = stream.log_probs
        if got.shape != whole.shape or not np.allclose(
                got, whole, rtol=STREAM_RTOL, atol=STREAM_ATOL):
            raise AssertionError(
                f"streamed log-probs {got.shape} against the whole "
                f"utterance's {whole.shape}: max-abs "
                f"{np.abs(got - whole).max() if got.shape == whole.shape else None}")
        if stream.transcript != best_path_decode(whole):
            raise AssertionError("streamed transcript differs from the "
                                 "whole utterance's")
        stream_err.append(float(np.abs(got - whole).max()))
    # a steady block's forward on the card, and a 1 s chunk's host
    # featurize
    steady = StreamingDS2(uni, chunk_frames=STREAM_BLOCK, device=dev)
    ext = torch.zeros((1, STREAM_BLOCK + StreamingDS2._CTX, 13), device=dev)
    block_fwd_ms = cuda_ms(lambda: steady._apply(ext, steady._h), 20)
    chunk = next(iter(streams.values()))[:STREAM_CHUNK]
    featurize_ms = statistics.median(
        host_ms(lambda: steady._featurize_new(chunk)) for _ in range(10))
    emit("ds2_streaming", nvidia_smi=smi, seconds=list(DS2_STREAM_SECONDS),
         chunk_samples=STREAM_CHUNK, chunk_frames=STREAM_BLOCK,
         blocks=blocks, launches={"persistent_rnn": stream_launches},
         block_ms_p50=float(np.percentile(block_ms, 50)),
         block_ms_p99=float(np.percentile(block_ms, 99)),
         block_forward_ms=block_fwd_ms, chunk_featurize_ms=featurize_ms,
         host_s_per_stream=stream_s,
         real_time_factor=[s / b for s, b in zip(DS2_STREAM_SECONDS,
                                                 stream_s)],
         logp_max_abs_err_vs_whole=stream_err, rtol=STREAM_RTOL,
         atol=STREAM_ATOL, transcripts_equal=True)

    # -- 5. the multiplexed pool: SSD, DS2 and DS2 sessions ------------
    ssd_model = build_ssd_vgg(21, 300, device=dev, seed=0)
    ssd_tiers = ssd_serving_tiers(ssd_model, PreProcessParam(
        batch_size=BATCH, resolution=300), device=dev)
    images = [rng.randint(0, 256, (300, 300, 3)).astype(np.float32)
              - np.float32(BGR_MEANS) for _ in range(FLEET_SSD)]
    for t in ssd_tiers:                  # cuDNN warm-up on every rung
        t.forward({"input": np.stack(images[:BATCH])})
    ds2_s = [float(s) for s in rng.uniform(3, 30, FLEET_DS2)]
    ds2_feats = [featurize(x) for x in synthetic_utterances(
        ds2_s, seed=59).values()]
    sess_s = [int(s) for s in rng.randint(10, 31, FLEET_SESSIONS)]
    sess_audio = list(synthetic_utterances(sess_s, seed=61).values())
    chunks = [[x[k:k + STREAM_CHUNK] for k in range(0, len(x), STREAM_CHUNK)]
              for x in sess_audio]
    fleet = ServingRuntime(models=[
        ModelConfig("ssd", tiers=ssd_tiers, length_key=None,
                    slos=model_slos("ssd")),
        ModelConfig("ds2", tiers=ds2_serving_tiers(ds2, DS2Param(),
                                                   device=dev),
                    bucket_edges=list(DS2_BUCKETS), slos=model_slos("ds2")),
        ModelConfig("ds2-stream", streaming=True,
                    tiers=ds2_streaming_tiers(uni, chunk_frames=STREAM_BLOCK,
                                              device=dev),
                    tier_factory=lambda rid: ds2_streaming_tiers(
                        uni, chunk_frames=STREAM_BLOCK, device=dev),
                    pad_key="input", length_key="n_samples",
                    bucket_edges=[STREAM_CHUNK], chunk_deadline_s=3600.0)],
        n_replicas=2, max_batch=BATCH, queue_capacity=512,
        default_deadline_s=3600.0, clock=MonotonicClock())
    seen = record_batches(fleet)
    sids = [fleet.open_session("ds2-stream") for _ in chunks]
    pieces = [[] for _ in chunks]
    pallas_rnn.persistent_rnn.launches = 0
    pallas_detout.fused_detection_output.launches = 0
    t0 = time.perf_counter()
    for i in range(max(FLEET_SSD, FLEET_DS2, *map(len, chunks))):
        if i < FLEET_SSD:
            fleet.submit({"input": images[i]}, model="ssd")
        if i < FLEET_DS2:
            f = ds2_feats[i]
            fleet.submit({"input": f}, length=f.shape[0], model="ds2")
        for s, cs in enumerate(chunks):
            if i < len(cs):
                pieces[s].append(fleet.submit_chunk(
                    sids[s], {"input": cs[i]}, length=len(cs[i]),
                    final=(i == len(cs) - 1)))
        fleet.pump()
    fleet.drain()
    fleet_k3 = k3_count()
    fleet_k2 = pallas_detout.fused_detection_output.launches
    fleet_s = time.perf_counter() - t0
    n_req = FLEET_SSD + FLEET_DS2 + sum(map(len, chunks))
    check_served(fleet, "fleet", n_req)
    snap = fleet.snapshot()
    if any(len(b["models"]) != 1 or b["models"] != [b["model"]]
           for b in seen):
        raise AssertionError("fleet: a batch held two models")
    if snap["sessions"] != {"opened": FLEET_SESSIONS, "open": 0,
                            "failed": 0}:
        raise AssertionError(f"fleet sessions {snap['sessions']}")
    n_batches = {m: sum(b["model"] == m for b in seen)
                 for m in fleet.models}
    fleet_blocks = 0
    for s, cs in enumerate(chunks):
        direct = StreamingDS2(uni, chunk_frames=STREAM_BLOCK, device=dev)
        want = [direct.accept(c) for c in cs]
        want[-1] += direct.flush()
        fleet_blocks += len(direct._pieces)
        if [str(r.result) for r in pieces[s]] != want:
            raise AssertionError(f"fleet session {s}: served pieces differ "
                                 "from a direct StreamingDS2")
    if fleet_k2 != n_batches["ssd"]:
        raise AssertionError(f"fleet: {n_batches['ssd']} SSD batches "
                             f"launched K2 {fleet_k2} times")
    if fleet_k3 != 6 * n_batches["ds2"] + 3 * fleet_blocks:
        raise AssertionError(f"fleet: K3 {fleet_k3} launches for "
                             f"{n_batches['ds2']} DS2 batches and "
                             f"{fleet_blocks} streaming blocks")
    per_model = {}
    reg = fleet.metrics.registry
    for m in fleet.models:
        lat = reg.histogram(f"serve/latency_s/model={m}/tier=0").snapshot()
        per_model[m] = {"requests": snap["models"][m]["outcomes"][
            "completed"], "batches": n_batches[m],
            "latency_p50_s": lat["p50"], "latency_p99_s": lat["p99"],
            "weight": snap["models"][m]["weight"],
            "tier": snap["models"][m]["ladder"]["tier"]}
    emit("fleet", nvidia_smi=smi, n_replicas=2, served_s=fleet_s,
         requests=n_req, models=per_model, sessions=snap["sessions"],
         session_seconds=sess_s, streaming_blocks=fleet_blocks,
         launches={"persistent_rnn": fleet_k3,
                   "fused_detection_output": fleet_k2},
         session_replicas=sorted({b["affinity"] for b in seen
                                  if b["affinity"] is not None}),
         slo_decisions=snap["slo"]["decisions"], slo_trips=snap["slo"]["trips"],
         fences=0, failed=0, shed=0)
    return {"k3_err": k3_err, "k3": {"ds2_online": online_launches,
                                     "ds2_streaming": stream_launches,
                                     "fleet": fleet_k3},
            "k2_fleet": fleet_k2}


class StageEvents:
    """``with stages("trunk"): ...`` records a pair of CUDA events around
    the block; :meth:`ms` sums each stage's device time (ms) after a
    synchronize.  Nested stages are timed inside their parent."""

    def __init__(self):
        self.spans = []

    def __call__(self, name):
        import contextlib

        import torch

        @contextlib.contextmanager
        def span():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            yield
            b.record()
            self.spans.append((name, a, b))
        return span()

    def ms(self):
        import torch

        torch.cuda.synchronize()
        out = {}
        for name, a, b in self.spans:
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


def frcnn_staged(pred, batch, stage):
    """``FrcnnPredictor.detect_batch`` step by step, each step inside
    ``stage(name)`` (``StageEvents`` or a profiler range), the NMS of the
    proposal layer and of the post-processing in nested stages of their
    own: upload, trunk, rpn, proposal (⊃ proposal_nms), roi_pool, heads,
    post (⊃ post_nms), readback.  Returns what ``detect_batch`` returns."""
    import numpy as np
    import torch

    import importlib

    from analytics_zoo_tpu_torch.models.faster_rcnn import decode_frcnn_boxes
    from analytics_zoo_tpu_torch.ops.roi_pool import roi_pool_batch

    # the modules (the package exports a function named ``proposal``)
    frcnn_ops = importlib.import_module("analytics_zoo_tpu_torch.ops.frcnn")
    proposal_ops = importlib.import_module(
        "analytics_zoo_tpu_torch.ops.proposal")

    net, dev = pred.detector.frcnn, pred.device
    p = net.param
    orig = {proposal_ops: proposal_ops.nms_batched,
            frcnn_ops: frcnn_ops.nms_batched}

    def nms_in(name, fn):
        def wrapped(*args, **kw):
            with stage(name):
                return fn(*args, **kw)
        return wrapped

    proposal_ops.nms_batched = nms_in("proposal_nms", orig[proposal_ops])
    frcnn_ops.nms_batched = nms_in("post_nms", orig[frcnn_ops])
    try:
        im_info = np.asarray(batch["im_info"], np.float32)
        scale_h = np.maximum(im_info[:, 2], 1e-8)
        scale_w = np.maximum(im_info[:, 3], 1e-8)
        with torch.inference_mode():
            with stage("upload"):
                x = torch.as_tensor(batch["input"]).to(dev)
                x = x.to(torch.float32) - pred._means
                info = torch.as_tensor(np.stack(
                    [im_info[:, 0], im_info[:, 1],
                     ((scale_h + scale_w) * 0.5).astype(np.float32)], 1)
                    ).to(dev)
            with stage("trunk"):
                feat = net.vgg(x.permute(0, 3, 1, 2))
            with stage("rpn"):
                scores, deltas = net.rpn(feat)
            with stage("proposal"):
                rois, mask = proposal_ops.proposal(
                    scores, deltas,
                    net.anchors(feat.shape[2], feat.shape[3], dev),
                    info[:, 0], info[:, 1], info[:, 2], param=p.proposal)
            with stage("roi_pool"):
                pooled = roi_pool_batch(
                    feat.permute(0, 2, 3, 1).contiguous(), rois, mask,
                    pooled_h=p.pooled, pooled_w=p.pooled,
                    spatial_scale=1.0 / p.feat_stride)
            with stage("heads"):
                probs, bbox_deltas = net.heads(pooled)
            with stage("post"):
                dets = frcnn_ops.frcnn_postprocess(
                    probs * mask[..., None],
                    decode_frcnn_boxes(rois, bbox_deltas, info),
                    pred.detector.post)
            with stage("readback"):
                return pred._rescale(dets, scale_h, scale_w)
    finally:
        for mod, fn in orig.items():
            mod.nms_batched = fn


def kept_indices(boxes, rois, mask):
    """The decoded candidate each valid ROI copies (nearest in L1),
    numpy rows."""
    import numpy as np

    return [int(np.abs(boxes - r).sum(1).argmin()) for r in rois[mask > 0]]


def proposal_near_ties(got, want, boxes, scores, min_sz, thresh):
    """Walk two kept-index lists of one image; at the first decision
    where they differ, the margins that decided it: each candidate's
    largest IoU with the boxes kept before it against ``thresh``, the two
    candidates' score gap, and each one's size against ``min_sz``
    (relative).  Returns (position, smallest margin), or None where the
    lists are equal."""
    import numpy as np

    if got == want:
        return None
    i = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    cands = got[i:i + 1] + want[i:i + 1]
    kept = boxes[want[:i]]

    def iou(b, others):
        if not len(others):
            return 0.0
        ix = (np.minimum(b[2], others[:, 2]) - np.maximum(b[0], others[:, 0])
              + 1).clip(min=0)
        iy = (np.minimum(b[3], others[:, 3]) - np.maximum(b[1], others[:, 1])
              + 1).clip(min=0)
        inter = ix * iy
        area = lambda x: (x[..., 2] - x[..., 0] + 1) * (x[..., 3] - x[..., 1]
                                                         + 1)
        return float((inter / (area(b) + area(others) - inter)).max())

    margins = [abs(iou(boxes[c], kept) - thresh) for c in cands]
    if len(cands) == 2:
        margins.append(abs(float(scores[cands[0]] - scores[cands[1]])))
    for c in cands:
        w = boxes[c, 2] - boxes[c, 0] + 1
        h = boxes[c, 3] - boxes[c, 1] + 1
        margins.append(float(min(abs(w - min_sz), abs(h - min_sz)) / min_sz))
    return i, min(margins)


def match_detections(a, b, iou_min=0.5):
    """Greedy match of two images' detection rows (class equal, pixel IoU
    ≥ ``iou_min``, highest score first): (matched share of ``a``'s valid
    rows, largest score difference over the matches)."""
    va, vb = a[a[:, 1] > 0], b[b[:, 1] > 0]
    used, diffs = set(), []
    for row in va:
        best, best_iou = None, iou_min
        for j, other in enumerate(vb):
            if j in used or other[0] != row[0]:
                continue
            ix = max(0.0, min(row[4], other[4]) - max(row[2], other[2]) + 1)
            iy = max(0.0, min(row[5], other[5]) - max(row[3], other[3]) + 1)
            inter = ix * iy
            union = ((row[4] - row[2] + 1) * (row[5] - row[3] + 1)
                     + (other[4] - other[2] + 1) * (other[5] - other[3] + 1)
                     - inter)
            if union > 0 and inter / union >= best_iou:
                best, best_iou = j, inter / union
        if best is not None:
            used.add(best)
            diffs.append(abs(float(row[1] - vb[best][1])))
    return (len(diffs) / max(len(va), 1),
            max(diffs) if diffs else None)


def frcnn_serving_phase(dev, smi):
    """Faster-RCNN VGG16 serving on the card at full width (phase
    ``frcnn_serving``); returns the launches of K1-K4 over the whole phase
    (the path reaches none of them)."""
    import statistics

    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.data import native
    from analytics_zoo_tpu_torch.data.records import SSDByteRecord
    from analytics_zoo_tpu_torch.data.synthetic import render_shapes_image
    from analytics_zoo_tpu_torch.models.faster_rcnn import (
        FasterRcnnDetector, FrcnnParam, decode_frcnn_boxes)
    from analytics_zoo_tpu_torch.ops import (pallas_detout, pallas_nms,
                                             pallas_rnn)
    from analytics_zoo_tpu_torch.ops.bbox import (bbox_transform_inv,
                                                  clip_boxes)
    from analytics_zoo_tpu_torch.ops.frcnn import frcnn_postprocess
    from analytics_zoo_tpu_torch.ops.proposal import proposal
    from analytics_zoo_tpu_torch.ops.roi_pool import roi_pool_batch
    from analytics_zoo_tpu_torch.pipelines.frcnn import (FRCNN_BGR_MEANS,
                                                         FrcnnPredictor,
                                                         frcnn_serving_tiers)
    from analytics_zoo_tpu_torch.pipelines.ssd import (PreProcessParam,
                                                       serving_chain)
    from analytics_zoo_tpu_torch.serving import (MonotonicClock,
                                                 ServingRuntime)
    from analytics_zoo_tpu_torch.transform.vision import AspectScaleCanvas

    counters = (pallas_nms.nms_sweep, pallas_detout.fused_detection_output,
                pallas_rnn.persistent_rnn, pallas_rnn.persistent_rnn_bwd)
    for k in counters:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.RandomState(51)
    res = FRCNN_RESOLUTION
    means = np.float32(FRCNN_BGR_MEANS)
    cpu_det = FasterRcnnDetector(FRCNN_PARAM or FrcnnParam(), device="cpu",
                                 seed=0)
    det = copy.deepcopy(cpu_det).to(dev)
    p = det.param
    n_params = sum(t.numel() for t in det.parameters())

    # -- 1. each stage on the card against the CPU, one image -------------
    img, _ = render_shapes_image(rng, res)
    x_c = torch.from_numpy(img.astype(np.float32) - means)[None]
    info_c = torch.tensor([[res, res, 1.0]])
    stage_err = {}
    with torch.inference_mode():
        feat_c = cpu_det.frcnn.vgg(x_c.permute(0, 3, 1, 2))
        feat_g = det.frcnn.vgg(x_c.to(dev).permute(0, 3, 1, 2))
        stage_err["trunk"] = rel_err(feat_g.cpu(), feat_c)
        s_c, d_c = cpu_det.frcnn.rpn(feat_c)
        s_g, d_g = det.frcnn.rpn(feat_c.to(dev))
        stage_err["rpn_scores"] = rel_err(s_g.cpu(), s_c)
        stage_err["rpn_deltas"] = rel_err(d_g.cpu(), d_c)
        h, w = feat_c.shape[2:]
        anchors = cpu_det.frcnn.anchors(h, w, "cpu")
        r_c, m_c = proposal(s_c, d_c, anchors, info_c[:, 0], info_c[:, 1],
                            info_c[:, 2], param=p.proposal)
        r_g, m_g = proposal(s_c.to(dev), d_c.to(dev), anchors.to(dev),
                            info_c[:, 0].to(dev), info_c[:, 1].to(dev),
                            info_c[:, 2].to(dev), param=p.proposal)
        boxes = clip_boxes(bbox_transform_inv(anchors, d_c[0]), res - 1.0,
                           res - 1.0).numpy()
        kept_c = kept_indices(boxes, r_c[0].numpy(), m_c[0].numpy())
        kept_g = kept_indices(boxes, r_g[0].cpu().numpy(),
                              m_g[0].cpu().numpy())
        tie = proposal_near_ties(kept_g, kept_c, boxes, s_c[0].numpy(),
                                 p.proposal.min_size * 1.0,
                                 p.proposal.nms_thresh)
        if tie is not None and not tie[1] < FRCNN_MARGIN:
            raise AssertionError(f"proposal: kept indices differ at "
                                 f"{tie[0]} with a margin of {tie[1]} "
                                 f"(tol {FRCNN_MARGIN})")
        if tie is None:
            roi_err = (r_g.cpu() - r_c).abs().max().item()
            if roi_err > 1e-3:
                raise AssertionError(f"proposal ROIs card vs CPU {roi_err}")
        else:
            roi_err = None
        feat_nhwc = feat_c.permute(0, 2, 3, 1).contiguous()
        pool_c = roi_pool_batch(feat_nhwc, r_c, m_c, p.pooled, p.pooled,
                                1.0 / p.feat_stride)
        pool_g = roi_pool_batch(feat_nhwc.to(dev), r_c.to(dev), m_c.to(dev),
                                p.pooled, p.pooled, 1.0 / p.feat_stride)
        if not torch.equal(pool_g.cpu(), pool_c):
            raise AssertionError("roi_pool card vs CPU not bit-equal")
        pr_c, bd_c = cpu_det.frcnn.heads(pool_c)
        pr_g, bd_g = det.frcnn.heads(pool_c.to(dev))
        stage_err["heads_probs"] = rel_err(pr_g.cpu(), pr_c)
        stage_err["heads_deltas"] = rel_err(bd_g.cpu(), bd_c)
        if not max(stage_err.values()) <= FRCNN_STAGE_TOL:
            raise AssertionError(f"stages card vs CPU {stage_err} (tol "
                                 f"{FRCNN_STAGE_TOL})")
        probs_c = pr_c * m_c[..., None]
        boxes_c = decode_frcnn_boxes(r_c, bd_c, info_c)
        post_c = frcnn_postprocess(probs_c, boxes_c, det.post)
        post_g = frcnn_postprocess(probs_c.to(dev), boxes_c.to(dev), det.post)
        post_err = rows_err(post_g, post_c)
        post_rows = int((post_c[..., 1] > 0).sum().item())
    check = {"stage_rel_err": stage_err, "tolerance": FRCNN_STAGE_TOL,
             "proposal_kept": len(kept_c),
             "proposal_near_ties": 0 if tie is None else 1,
             "proposal_first_difference": tie,
             "proposal_roi_max_abs_err": roi_err,
             "roi_pool_bit_equal": True,
             "post_rows_max_abs_err": post_err, "post_rows": post_rows}
    del cpu_det, feat_c, pool_c, pool_g, feat_g

    # -- 2. predict(records): 4 batches of 8 of mixed sizes ---------------
    codec = native.codec_for(dev)
    recs = []
    for i in range(FRCNN_RECORD_BATCHES * BATCH):
        oh, ow = FRCNN_RECORD_SIZES[i % len(FRCNN_RECORD_SIZES)]
        img, gt = render_shapes_image(rng, max(oh, ow))
        recs.append(SSDByteRecord(native.encode_jpeg(
            np.ascontiguousarray(img[:oh, :ow]), 92, codec), f"f{i}.jpg",
            gt))
    param = PreProcessParam(batch_size=BATCH, resolution=res,
                            pixel_means=FRCNN_BGR_MEANS)
    pred = FrcnnPredictor(det, param, device=dev)
    # cv2 unimportable while the card's path decodes, resizes and serves
    cv2_module = sys.modules.get("cv2")
    sys.modules["cv2"] = None
    try:
        pred.predict(recs[:BATCH])                  # cuDNN / cuBLAS warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served = pred.predict(recs)
        predict_s = time.perf_counter() - t0
        staged = list(serving_chain(
            param, uint8=True, resize=AspectScaleCanvas(res, device=dev),
            device=dev)(recs))
    finally:
        if cv2_module is None:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = cv2_module
    direct = np.concatenate([pred.detect_batch(b) for b in staged])
    if len(served) != len(recs) or not np.array_equal(np.stack(served),
                                                      direct):
        raise AssertionError("predict(records) differs from detect_batch "
                             "on the same staged batches")
    kept_rows = 0
    for i, d in enumerate(served):
        oh, ow = FRCNN_RECORD_SIZES[i % len(FRCNN_RECORD_SIZES)]
        v = d[d[:, 1] > 0]
        kept_rows += len(v)
        if not (d.shape == (det.post.max_per_image, 6)
                and np.isfinite(d).all()
                and np.isin(d[:, 0], np.arange(-1, p.num_classes)).all()
                and (v[:, 0] >= 1).all() and (v[:, 1] <= 1).all()
                and (v[:, 2:] >= 0).all()
                and (v[:, [2, 4]] <= ow + 1e-3).all()
                and (v[:, [3, 5]] <= oh + 1e-3).all()):
            raise AssertionError(f"record {i}: detections out of range")

    # -- 3. detect_batch timed, and split by stage ------------------------
    batch = staged[0]
    for _ in range(2):
        pred.detect_batch(batch)
    host = []
    for _ in range(FRCNN_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pred.detect_batch(batch)
        host.append((time.perf_counter() - t0) * 1e3)
    split = []
    for _ in range(5):
        ev = StageEvents()
        t0 = time.perf_counter()
        staged_out = frcnn_staged(pred, batch, ev)
        host_ms = (time.perf_counter() - t0) * 1e3
        split.append(dict(ev.ms(), host_total=host_ms))
        if not np.array_equal(staged_out, out):
            raise AssertionError("the staged forward differs from "
                                 "detect_batch")
    split_ms = {k: statistics.median(s[k] for s in split) for k in split[0]}
    split_ms["proposal_other"] = split_ms["proposal"] - split_ms[
        "proposal_nms"]
    split_ms["post_other"] = split_ms["post"] - split_ms["post_nms"]
    from torch.profiler import record_function

    def profiled():
        with record_function("frcnn_batch"):
            frcnn_staged(pred, batch,
                         lambda n: record_function(f"frcnn_batch.{n}"))

    trace = profile_train_step(profiled, root="frcnn_batch")
    launches_per_batch = trace.pop("launches")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # -- 4. the runtime: fp and int8 rungs ---------------------------------
    tiers = frcnn_serving_tiers(det, param, device=dev)
    preds = [t.device_program()[0].__self__ for t in tiers]
    canvases = [rng.randint(0, 256, (res, res, 3)).astype(np.float32)
                - means for _ in range(FRCNN_REQUESTS)]
    win = np.stack(canvases[:BATCH])
    for t in tiers:
        t.forward({"input": win})
    rt = ServingRuntime(tiers, n_replicas=2, max_batch=BATCH,
                        queue_capacity=FRCNN_REQUESTS,
                        default_deadline_s=3600.0, clock=MonotonicClock())
    t0 = time.perf_counter()
    for x in canvases:
        rt.submit({"input": x})
    rt.drain()
    torch.cuda.synchronize()
    runtime_s = time.perf_counter() - t0
    metrics = check_served(rt, "frcnn runtime", FRCNN_REQUESTS)
    rows = np.stack([r.result for r in rt.requests])
    unit = np.tile(np.array([[res, res, 1.0, 1.0]], np.float32), (BATCH, 1))
    want = np.concatenate([preds[0].detect_batch(
        {"input": np.stack(canvases[i:i + BATCH]), "im_info": unit})
        for i in range(0, FRCNN_REQUESTS, BATCH)])
    if not np.array_equal(rows, want):
        raise AssertionError("runtime rows differ from the fp predictor's")
    rung_ms = {t.name: [] for t in tiers}
    rung_rows = {}
    for _ in range(FRCNN_WINDOWS):
        for i, t in enumerate(tiers):
            rt.ladder.tier = i
            for x in win:
                rt.submit({"input": x})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if rt.pump(force=True) != 1:
                raise AssertionError(f"rung {t.name}: not one batch")
            rung_ms[t.name].append((time.perf_counter() - t0) * 1e3)
            done = rt.requests[-BATCH:]
            if {r.tier for r in done} != {i}:
                raise AssertionError(f"rung {t.name} served at tiers "
                                     f"{[r.tier for r in done]}")
            rung_rows[t.name] = np.stack([r.result for r in done])
    check_served(rt, "frcnn rungs", FRCNN_REQUESTS
                 + FRCNN_WINDOWS * len(tiers) * BATCH)
    for pr, t in zip(preds, tiers):
        if not np.array_equal(rung_rows[t.name], pr.detect_batch(
                {"input": win, "im_info": unit})):
            raise AssertionError(f"rung {t.name}: rows differ from its "
                                 "predictor's")
    fp_rows, q_rows = rung_rows["fp"], rung_rows["int8"]
    matched = [match_detections(a, b) for a, b in zip(fp_rows, q_rows)]
    same_pos = fp_rows[..., 0] == q_rows[..., 0]
    int8_vs_fp = {
        "rows_same_class_at_same_position": float(same_pos.mean()),
        "max_score_diff_same_position": float(np.abs(
            fp_rows[..., 1] - q_rows[..., 1])[same_pos].max()),
        "matched_share_by_image": [m[0] for m in matched],
        "max_score_diff_matched": max((m[1] for m in matched
                                       if m[1] is not None), default=None),
        "kept_rows_fp": int((fp_rows[..., 1] > 0).sum()),
        "kept_rows_int8": int((q_rows[..., 1] > 0).sum())}
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in counters}
    if any(launches.values()):
        raise AssertionError(f"the Faster-RCNN path launched {launches}: "
                             "it reaches none of K1-K4")
    lat = metrics["latency_by_tier"]["0"]
    emit("frcnn_serving", nvidia_smi=smi, resolution=res, batch=BATCH,
         num_classes=p.num_classes, proposal=dataclasses.asdict(p.proposal),
         post=dataclasses.asdict(det.post), parameters=n_params,
         stage_checks=check,
         records={"batches": FRCNN_RECORD_BATCHES, "images": len(recs),
                  "sizes": FRCNN_RECORD_SIZES, "codec": codec,
                  "kept_rows": kept_rows, "predict_s": predict_s,
                  "predict_ms_per_batch": predict_s * 1e3
                  / FRCNN_RECORD_BATCHES, "cv2_importable": False},
         detect_batch_ms=statistics.median(host), detect_batch_ms_all=host,
         split_ms=split_ms, profiled_batch=trace,
         launches_per_batch=launches_per_batch, peak_gb=peak_gb,
         runtime={"requests": FRCNN_REQUESTS, "n_replicas": 2,
                  "batches": metrics["batches"], "served_s": runtime_s,
                  "latency_p50_s": lat["p50_s"], "latency_p99_s": lat["p99_s"],
                  "fences": 0, "failed": metrics["failed"],
                  "shed": metrics["shed_total"]},
         rung_ms_per_batch={k: statistics.median(v)
                            for k, v in rung_ms.items()},
         rung_ms_windows=rung_ms,
         rung_speed_vs_fp={k: statistics.median(v)
                           / statistics.median(rung_ms["fp"])
                           for k, v in rung_ms.items()},
         tier_speed_hints=[t.speed for t in tiers], int8_vs_fp=int8_vs_fp,
         kernel_launches=launches,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    return launches


def frcnn_shapes_batch(rng, B, res=None, n_gt=None):
    """``B`` shapes images (``data/synthetic.py``) of ``n_gt`` shapes
    each on the ``res``² canvas, in the SSD collate layout
    ``frcnn_train_batches`` takes: mean-subtracted pixels and normalized
    gt boxes (x1, y1, x2, y2) with their labels under a mask."""
    import numpy as np

    from analytics_zoo_tpu_torch.data.synthetic import render_shapes_image
    from analytics_zoo_tpu_torch.pipelines.frcnn import FRCNN_BGR_MEANS

    res = res or FRCNN_TRAIN_RES
    n_gt = n_gt or FRCNN_TRAIN_GT
    images, boxes, labels = [], [], []
    while len(images) < B:
        img, gt = render_shapes_image(rng, res, max_shapes=n_gt)
        if len(gt) != n_gt:
            continue
        images.append(img.astype(np.float32) - np.float32(FRCNN_BGR_MEANS))
        boxes.append(gt[:, 2:] / np.float32(res))
        labels.append(gt[:, 0].astype(np.int32))
    return {"input": np.stack(images),
            "target": {"bboxes": np.stack(boxes), "labels": np.stack(labels),
                       "mask": np.ones((B, n_gt), np.float32)}}


def frcnn_train_param():
    """The reference bench's training configuration (``bench.py``
    ``bench_frcnn_train``), or the rehearsal's."""
    from analytics_zoo_tpu_torch.models.faster_rcnn import FrcnnParam
    from analytics_zoo_tpu_torch.ops.proposal import ProposalParam

    return FRCNN_TRAIN_PARAM or FrcnnParam(
        num_classes=21, proposal=ProposalParam(pre_nms_topn=2000,
                                               post_nms_topn=128))


def frcnn_grads_vs_cpu(model_c, model_g, batch):
    """Faster-RCNN's training loss and gradients on the card against the
    CPU, dropout off, on the same weights and batch.  The card's forward
    takes the CPU's proposals (its own proposal op is held to the CPU's
    on the CPU's RPN outputs apart: kept indices equal unless the first
    differing decision's margin is under ``FRCNN_MARGIN``), so both sides
    pool the same ROIs.  The sampled targets of both on the CPU's outputs
    are equal; each side's loss is on its own outputs; each parameter's
    gradient is under the same upstream gradient (the CPU's, of the loss
    with respect to the RPN's and the heads' outputs), so a sampling
    decision two platforms' outputs tip differently does not move the
    comparison.  Returns (the CPU's loss, the loss's relative error, the
    targets' equality, each gradient's relative L2 error, the proposal's
    near-tie margins by image)."""
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.models import faster_rcnn
    from analytics_zoo_tpu_torch.ops.bbox import (bbox_transform_inv,
                                                  clip_boxes)
    from analytics_zoo_tpu_torch.ops.frcnn_train import (frcnn_training_loss,
                                                         head_targets,
                                                         rpn_targets)
    from analytics_zoo_tpu_torch.parallel.train import to_device
    from analytics_zoo_tpu_torch.pipelines.frcnn import frcnn_forward_fn

    keys = ("rpn_cls_logits", "rpn_deltas", "cls_logits", "bbox_deltas")
    plain, seen = faster_rcnn.proposal, {}

    def capture(*a, **kw):
        seen["args"], seen["kw"] = a, kw
        seen["out"] = plain(*a, **kw)
        return seen["out"]

    def replay(*a, **kw):
        return tuple(t.to(a[0].device) for t in seen["out"])

    res = {}
    try:
        for side, model, fn in (("cpu", model_c, capture),
                                ("card", model_g, replay)):
            faster_rcnn.proposal = fn
            dev = next(model.parameters()).device
            b = to_device(batch, dev)
            model.train()
            out = frcnn_forward_fn(model, b["input"], False)
            res[side] = (model, out, frcnn_training_loss(out, b), b)
    finally:
        faster_rcnn.proposal = plain
    _, out_c, loss_c, b_c = res["cpu"]
    _, out_g, loss_g, b_g = res["card"]
    dev = b_g["im_info"].device

    # the card's proposal op on the CPU's RPN outputs
    a, kw = seen["args"], seen["kw"]
    with torch.no_grad():
        r_g, m_g = plain(*(t.to(dev) for t in a), **kw)
    scores, deltas, anchors, im_h, im_w, scale = a
    margins = {}
    for i in range(scores.shape[0]):
        boxes = clip_boxes(bbox_transform_inv(anchors, deltas[i]),
                           im_h[i] - 1.0, im_w[i] - 1.0).numpy()
        r_c, m_c = seen["out"][0][i].numpy(), seen["out"][1][i].numpy()
        tie = proposal_near_ties(
            kept_indices(boxes, r_g[i].cpu().numpy(), m_g[i].cpu().numpy()),
            kept_indices(boxes, r_c, m_c), boxes, scores[i].numpy(),
            kw["param"].min_size * float(scale[i]), kw["param"].nms_thresh)
        if tie is not None:
            if not tie[1] < FRCNN_MARGIN:
                raise AssertionError(f"Faster-RCNN train: the card's "
                                     f"proposal differs at {tie[0]} with a "
                                     f"margin of {tie[1]} (tol "
                                     f"{FRCNN_MARGIN})")
            margins[i] = tie
    # the targets on the card from the CPU's outputs, against the CPU's
    tgt, info = b_c["target"], b_c["im_info"]
    bg = 1.0 - torch.softmax(out_c["cls_logits"].detach(), -1)[..., 0]
    args = {"rpn": (out_c["anchors"], tgt["bboxes"], tgt["mask"],
                    info[:, 0], info[:, 1], out_c["fg_scores"].detach()),
            "head": (out_c["rois"], out_c["roi_mask"], tgt["bboxes"],
                     tgt["labels"], tgt["mask"], bg)}
    targets_equal = {}
    for name, fn in (("rpn", rpn_targets), ("head", head_targets)):
        want = fn(*args[name])
        got = fn(*(t.to(dev) for t in args[name]))
        # labels and weights; the box targets are floats
        targets_equal[name] = all(torch.equal(got[i].cpu(), want[i])
                                  for i in (0, 1, 3))
    upstream = torch.autograd.grad(loss_c, [out_c[k] for k in keys],
                                   retain_graph=True)
    grads = {}
    for side, (model, out, _, _) in res.items():
        params = dict(model.named_parameters())
        g = torch.autograd.grad(
            [out[k] for k in keys], list(params.values()),
            [u.to(out[keys[0]].device) for u in upstream])
        grads[side] = {k: v.detach().double().cpu()
                       for k, v in zip(params, g)}
    errs = {k: ((grads["card"][k] - w).norm()
                / w.norm().clamp(min=1e-30)).item()
            for k, w in grads["cpu"].items()}
    loss_err = abs(loss_g.item() - loss_c.item()) / abs(loss_c.item())
    return (loss_c.item(), loss_err, targets_equal, errs,
            {i: [int(t[0]), t[1]] for i, t in margins.items()})


def frcnn_train_phase(dev, smi):
    """Faster-RCNN VGG16 training on the card (phase ``frcnn_train``, then
    a ``timing`` line); returns the launches of K1-K4 over the whole
    phase (the path reaches none of them)."""
    import importlib
    import statistics

    import numpy as np
    import torch

    import analytics_zoo_tpu_torch.parallel as parallel
    from analytics_zoo_tpu_torch.models import faster_rcnn
    from analytics_zoo_tpu_torch.ops import (pallas_detout, pallas_nms,
                                             pallas_rnn)
    from analytics_zoo_tpu_torch.ops.frcnn_train import frcnn_training_loss
    from analytics_zoo_tpu_torch.parallel import (SGD, create_train_state,
                                                  make_train_step)
    from analytics_zoo_tpu_torch.pipelines.frcnn import (frcnn_forward_fn,
                                                         frcnn_train_batches,
                                                         train_frcnn)

    # the package exports the function ``proposal`` under the module's name
    proposal_mod = importlib.import_module(
        "analytics_zoo_tpu_torch.ops.proposal")
    counters = (pallas_nms.nms_sweep, pallas_detout.fused_detection_output,
                pallas_rnn.persistent_rnn, pallas_rnn.persistent_rnn_bwd)
    for k in counters:
        k.launches = 0
    rng = np.random.RandomState(61)
    res, B = FRCNN_TRAIN_RES, FRCNN_TRAIN_BATCH
    param = frcnn_train_param()
    cpu = torch.device("cpu")

    # 1. the card against the CPU at batch 2, dropout off
    cpu_model = faster_rcnn.FasterRcnnVgg(param, device=cpu, seed=0)
    card_model = copy.deepcopy(cpu_model).to(dev)
    small = next(iter(frcnn_train_batches([frcnn_shapes_batch(rng, 2)],
                                          res)))
    loss_c, loss_err, targets_equal, grad_err, near_ties = (
        frcnn_grads_vs_cpu(cpu_model, card_model, small))
    over = {k: e for k, e in grad_err.items()
            if e > (FRCNN_TRUNK_GRAD_TOL if k.startswith("vgg.")
                    else FRCNN_GRAD_TOL)}
    if not (all(targets_equal.values()) and loss_err <= FRCNN_LOSS_TOL
            and not over):
        raise AssertionError(
            f"Faster-RCNN train card vs CPU: targets equal {targets_equal}, "
            f"loss {loss_err} (tol {FRCNN_LOSS_TOL}), gradients over "
            f"tolerance {over}")
    del cpu_model, card_model

    # 2. train_frcnn: one epoch of shapes batches, the epoch hook, no
    # kernel launched; then steps on one repeated batch
    train_set = [frcnn_shapes_batch(rng, B) for _ in range(FRCNN_TRAIN_BATCHES)]
    runs, hooks = [], []

    class RecordingOptimizer(parallel.Optimizer):
        def optimize(self):
            runs.append(self)
            return super().optimize()

    model = faster_rcnn.FasterRcnnVgg(param, device=dev, seed=0)
    patched, parallel.Optimizer = parallel.Optimizer, RecordingOptimizer
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_frcnn(model, train_set, res, epochs=1,
                    epoch_hook=lambda loop, state: hooks.append(
                        (loop.epoch, state.step)))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    finally:
        parallel.Optimizer = patched
    (opt,) = runs
    losses = [m["loss"].item() for m in opt.history]
    batches = list(frcnn_train_batches(train_set, res))
    sgd = SGD(1e-3, momentum=0.9)
    step = make_train_step(model, lambda out, b: frcnn_training_loss(out, b),
                           sgd, grad_clip_norm=10.0,
                           forward_fn=frcnn_forward_fn)
    state = create_train_state(model, sgd)
    repeated = []
    for _ in range(FRCNN_REPEAT):
        state, metrics = step(state, batches[0])
        repeated.append(metrics["loss"].item())
    launches = {k.__name__: k.launches for k in counters}
    if not (len(losses) == FRCNN_TRAIN_BATCHES and hooks == [(1, len(losses))]
            and all(math.isfinite(x) for x in losses + repeated)
            and repeated[-1] < repeated[0] and not any(launches.values())):
        raise AssertionError(
            f"train_frcnn: losses {losses}, epoch hook {hooks}, repeated "
            f"batch {repeated}, launches {launches}")

    # 3. one bf16 step against one fp32 step from the same weights (and the
    # same dropout masks: each model's generator starts from the seed)
    first, moved = {}, {}
    for cd in (None, "bf16"):
        m = faster_rcnn.FasterRcnnVgg(param, device=dev, seed=0)
        start = {k: p.detach().clone() for k, p in m.named_parameters()}
        sgd = SGD(1e-3, momentum=0.9)
        st = make_train_step(m, lambda out, b: frcnn_training_loss(out, b),
                             sgd, grad_clip_norm=10.0, compute_dtype=cd,
                             forward_fn=frcnn_forward_fn)
        _, metrics = st(create_train_state(m, sgd), batches[1])
        first[cd or "fp32"] = metrics["loss"].item()
        moved[cd or "fp32"] = {k: (p.detach() - start[k]).double()
                               for k, p in m.named_parameters()}
        del m, st, start
    bf16_err = abs(first["bf16"] - first["fp32"]) / abs(first["fp32"])
    d16, d32 = (torch.cat([m[k].flatten() for k in moved["fp32"]])
                for m in (moved["bf16"], moved["fp32"]))
    update_err = ((d16 - d32).norm() / d32.norm()).item()
    update_cos = (d16 @ d32 / (d16.norm() * d32.norm())).item()
    del moved, d16, d32
    if not (bf16_err <= FRCNN_BF16_TOL and update_cos >= FRCNN_BF16_COS
            and math.isfinite(first["bf16"])):
        raise AssertionError(
            f"Faster-RCNN bf16 step against fp32: loss {first} (tol "
            f"{FRCNN_BF16_TOL}), update cosine {update_cos} (at least "
            f"{FRCNN_BF16_COS}), relative L2 {update_err}")
    emit("frcnn_train", resolution=res, batch=B, gt_per_image=FRCNN_TRAIN_GT,
         classes=param.num_classes,
         proposal=[param.proposal.pre_nms_topn, param.proposal.post_nms_topn],
         n_params=sum(p.numel() for p in model.parameters()),
         epoch_losses=losses, epoch_hook=hooks, train_frcnn_s=train_s,
         repeated_batch_losses=repeated, launches=launches,
         card_vs_cpu={"batch": 2, "loss": loss_c, "loss_rel_err": loss_err,
                      "loss_tolerance": FRCNN_LOSS_TOL,
                      "targets_equal": targets_equal,
                      "proposal_near_ties": near_ties,
                      "grad_rel_l2_max": max(grad_err.values()),
                      "grad_rel_l2": grad_err,
                      "grad_tolerance": [FRCNN_GRAD_TOL,
                                         FRCNN_TRUNK_GRAD_TOL]},
         bf16_first_loss=first, bf16_loss_rel_err=bf16_err,
         bf16_update_rel_l2=update_err, bf16_update_cosine=update_cos,
         bf16_tolerance=[FRCNN_BF16_TOL, FRCNN_BF16_COS])

    # 4. timing: host-clock steps (fp32, as train_frcnn runs them), one
    # profiled step with the proposal and its NMS rounds as ranges,
    # peak memory
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for i in range(2 + FRCNN_TRAIN_TIMED):
        t0 = time.perf_counter()
        state, _ = step(state, batches[i % len(batches)])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    timed = step_ms[2:]
    plain_proposal, plain_nms = faster_rcnn.proposal, proposal_mod.nms_batched

    def ranged(name, fn):
        def call(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)
        return call

    faster_rcnn.proposal = ranged("frcnn_proposal", plain_proposal)
    proposal_mod.nms_batched = ranged("frcnn_proposal_nms", plain_nms)
    try:
        trace = profile_train_step(lambda: step(state, batches[0]),
                                   nested=("frcnn_proposal",))
    finally:
        faster_rcnn.proposal = plain_proposal
        proposal_mod.nms_batched = plain_nms
    emit("timing", nvidia_smi=smi,
         frcnn_train_step_ms=statistics.median(timed),
         frcnn_train_step_ms_each=step_ms, frcnn_train_batch=B,
         frcnn_train_images_per_s=B * 1e3 / statistics.median(timed),
         frcnn_train_step_profiled=trace, frcnn_train_peak_gb=peak_gb)
    return {k.__name__: k.launches for k in counters}


def seeded_caffe_net(graph, rng):
    """A caffemodel for ``graph`` (a ``CaffeGraph``) with seeded blobs in
    Caffe's layouts: LeCun-normal convolution and InnerProduct weights,
    small biases, Normalize scales of 10-30."""
    import numpy as np

    from analytics_zoo_tpu_torch.utils.caffe import CaffeLayer, CaffeNet

    types = {s.name: s.type for s in graph.specs}
    layers = []
    for name, mod in graph.named_children():
        sd = mod.state_dict()
        if types[name] == "Normalize":
            blobs = [(10.0 + 20.0 * rng.random_sample(
                sd["scale"].shape[0])).astype(np.float32)]
        else:
            w = sd["weight"]
            blobs = [(rng.standard_normal(tuple(w.shape))
                      / np.sqrt(w[0].numel())).astype(np.float32),
                     (rng.standard_normal(w.shape[0]) * 0.01).astype(
                         np.float32)]
        layers.append(CaffeLayer(name, types[name], blobs=blobs))
    return CaffeNet(name="seeded", layers=layers)


def ssd300_deploy_prototxt() -> str:
    """The SSD300 VGG16 deploy net (the SSD-Caffe release's
    ``VGG_VOC0712_SSD_300x300`` deploy.prototxt: its layer names, types
    and parameters, 21 classes)."""
    heads = [("conv4_3_norm", 30, 60, (2,), 8), ("fc7", 60, 111, (2, 3), 16),
             ("conv6_2", 111, 162, (2, 3), 32),
             ("conv7_2", 162, 213, (2, 3), 64),
             ("conv8_2", 213, 264, (2,), 100),
             ("conv9_2", 264, 315, (2,), 300)]
    k = {1: 4, 2: 6}

    def conv(name, bottom, out, kernel, stride=1, pad=0, dilation=1):
        extra = "".join(f" {n}: {v}" for n, v, d in (
            ("pad", pad, 0), ("stride", stride, 1),
            ("dilation", dilation, 1)) if v != d)
        return (f'layer {{ name: "{name}" type: "Convolution" bottom: '
                f'"{bottom}" top: "{name}" convolution_param {{ num_output: '
                f'{out} kernel_size: {kernel}{extra} }} }}\n')

    def relu(name, blob):
        return (f'layer {{ name: "{name}" type: "ReLU" bottom: "{blob}" '
                f'top: "{blob}" }}\n')

    def pool(name, bottom, kernel, stride, pad=0):
        pad_s = f" pad: {pad}" if pad else ""
        return (f'layer {{ name: "{name}" type: "Pooling" bottom: '
                f'"{bottom}" top: "{name}" pooling_param {{ pool: MAX '
                f'kernel_size: {kernel} stride: {stride}{pad_s} }} }}\n')

    p = ['name: "VGG_VOC0712_SSD_300x300_deploy"\ninput: "data"\n'
         'input_shape { dim: 1 dim: 3 dim: 300 dim: 300 }\n']
    bottom = "data"
    for blk, n, ch in ((1, 2, 64), (2, 2, 128), (3, 3, 256), (4, 3, 512),
                       (5, 3, 512)):
        for i in range(1, n + 1):
            p.append(conv(f"conv{blk}_{i}", bottom, ch, 3, pad=1))
            p.append(relu(f"relu{blk}_{i}", f"conv{blk}_{i}"))
            bottom = f"conv{blk}_{i}"
        p.append(pool(f"pool{blk}", bottom, 2, 2) if blk < 5
                 else pool("pool5", bottom, 3, 1, pad=1))
        bottom = f"pool{blk}"
    p += [conv("fc6", bottom, 1024, 3, pad=6, dilation=6), relu("relu6", "fc6"),
          conv("fc7", "fc6", 1024, 1), relu("relu7", "fc7")]
    bottom = "fc7"
    for name, ch, kern, s, pad in (
            ("conv6_1", 256, 1, 1, 0), ("conv6_2", 512, 3, 2, 1),
            ("conv7_1", 128, 1, 1, 0), ("conv7_2", 256, 3, 2, 1),
            ("conv8_1", 128, 1, 1, 0), ("conv8_2", 256, 3, 1, 0),
            ("conv9_1", 128, 1, 1, 0), ("conv9_2", 256, 3, 1, 0)):
        p += [conv(name, bottom, ch, kern, stride=s, pad=pad),
              relu(f"{name}_relu", name)]
        bottom = name
    p.append('layer { name: "conv4_3_norm" type: "Normalize" bottom: '
             '"conv4_3" top: "conv4_3_norm" norm_param { across_spatial: '
             'false scale_filler { type: "constant" value: 20 } '
             'channel_shared: false } }\n')
    for src, mn, mx, ars, step in heads:
        for kind, ch in (("loc", 4), ("conf", 21)):
            head = f"{src}_mbox_{kind}"
            p.append(conv(head, src, k[len(ars)] * ch, 3, pad=1))
            p.append(f'layer {{ name: "{head}_perm" type: "Permute" bottom: '
                     f'"{head}" top: "{head}_perm" permute_param {{ order: 0 '
                     'order: 2 order: 3 order: 1 } }\n')
            p.append(f'layer {{ name: "{head}_flat" type: "Flatten" bottom: '
                     f'"{head}_perm" top: "{head}_flat" flatten_param {{ '
                     'axis: 1 } }\n')
        ar_s = " ".join(f"aspect_ratio: {a}" for a in ars)
        p.append(f'layer {{ name: "{src}_mbox_priorbox" type: "PriorBox" '
                 f'bottom: "{src}" bottom: "data" top: "{src}_mbox_priorbox" '
                 f'prior_box_param {{ min_size: {mn} max_size: {mx} {ar_s} '
                 'flip: true clip: false variance: 0.1 variance: 0.1 '
                 f'variance: 0.2 variance: 0.2 step: {step} offset: 0.5 }} '
                 '}\n')
    for kind in ("loc", "conf", "priorbox"):
        bots = " ".join(f'bottom: "{s}_mbox_{kind}{"" if kind == "priorbox" else "_flat"}"'
                        for s, *_ in heads)
        p.append(f'layer {{ name: "mbox_{kind}" type: "Concat" {bots} top: '
                 f'"mbox_{kind}" concat_param {{ axis: '
                 f'{2 if kind == "priorbox" else 1} }} }}\n')
    p.append('layer { name: "mbox_conf_reshape" type: "Reshape" bottom: '
             '"mbox_conf" top: "mbox_conf_reshape" reshape_param { shape { '
             'dim: 0 dim: -1 dim: 21 } } }\n'
             'layer { name: "mbox_conf_softmax" type: "Softmax" bottom: '
             '"mbox_conf_reshape" top: "mbox_conf_softmax" softmax_param { '
             'axis: 2 } }\n'
             'layer { name: "mbox_conf_flatten" type: "Flatten" bottom: '
             '"mbox_conf_softmax" top: "mbox_conf_flatten" flatten_param { '
             'axis: 1 } }\n'
             'layer { name: "detection_out" type: "DetectionOutput" bottom: '
             '"mbox_loc" bottom: "mbox_conf_flatten" bottom: "mbox_priorbox" '
             'top: "detection_out" detection_output_param { num_classes: 21 '
             'share_location: true background_label_id: 0 nms_param { '
             'nms_threshold: 0.45 top_k: 400 } code_type: CENTER_SIZE '
             'keep_top_k: 200 confidence_threshold: 0.01 } }\n')
    return "".join(p)


def frcnn_vgg16_deploy_prototxt(resolution: int = 512, pooled: int = 7,
                                classes: int = 21) -> str:
    """py-faster-rcnn's VGG16 ``test.prototxt`` (its layer names and types,
    ``rpn_conv/3x3`` and the Python proposal layer included) at a fixed
    ``resolution``² input."""
    p = ['name: "VGG_ILSVRC_16_layers"\ninput: "data"\n'
         f'input_shape {{ dim: 1 dim: 3 dim: {resolution} dim: '
         f'{resolution} }}\ninput: "im_info"\ninput_shape {{ dim: 1 dim: 3 '
         '}\n']
    bottom = "data"
    for blk, n, ch in ((1, 2, 64), (2, 2, 128), (3, 3, 256), (4, 3, 512),
                       (5, 3, 512)):
        for i in range(1, n + 1):
            name = f"conv{blk}_{i}"
            p.append(f'layer {{ name: "{name}" type: "Convolution" bottom: '
                     f'"{bottom}" top: "{name}" convolution_param {{ '
                     f'num_output: {ch} pad: 1 kernel_size: 3 }} }}\n'
                     f'layer {{ name: "relu{blk}_{i}" type: "ReLU" bottom: '
                     f'"{name}" top: "{name}" }}\n')
            bottom = name
        if blk < 5:
            p.append(f'layer {{ name: "pool{blk}" type: "Pooling" bottom: '
                     f'"{bottom}" top: "pool{blk}" pooling_param {{ pool: MAX '
                     'kernel_size: 2 stride: 2 } }\n')
            bottom = f"pool{blk}"
    p.append(
        'layer { name: "rpn_conv/3x3" type: "Convolution" bottom: "conv5_3" '
        'top: "rpn/output" convolution_param { num_output: 512 kernel_size: '
        '3 pad: 1 stride: 1 } }\n'
        'layer { name: "rpn_relu/3x3" type: "ReLU" bottom: "rpn/output" top: '
        '"rpn/output" }\n'
        'layer { name: "rpn_cls_score" type: "Convolution" bottom: '
        '"rpn/output" top: "rpn_cls_score" convolution_param { num_output: '
        '18 kernel_size: 1 pad: 0 stride: 1 } }\n'
        'layer { name: "rpn_bbox_pred" type: "Convolution" bottom: '
        '"rpn/output" top: "rpn_bbox_pred" convolution_param { num_output: '
        '36 kernel_size: 1 pad: 0 stride: 1 } }\n'
        'layer { bottom: "rpn_cls_score" top: "rpn_cls_score_reshape" name: '
        '"rpn_cls_score_reshape" type: "Reshape" reshape_param { shape { '
        'dim: 0 dim: 2 dim: -1 dim: 0 } } }\n'
        'layer { name: "rpn_cls_prob" type: "Softmax" bottom: '
        '"rpn_cls_score_reshape" top: "rpn_cls_prob" }\n'
        'layer { name: "rpn_cls_prob_reshape" type: "Reshape" bottom: '
        '"rpn_cls_prob" top: "rpn_cls_prob_reshape" reshape_param { shape { '
        'dim: 0 dim: 18 dim: -1 dim: 0 } } }\n'
        'layer { name: "proposal" type: "Python" bottom: '
        '"rpn_cls_prob_reshape" bottom: "rpn_bbox_pred" bottom: "im_info" '
        'top: "rois" python_param { module: "rpn.proposal_layer" layer: '
        '"ProposalLayer" param_str: "\'feat_stride\': 16" } }\n'
        'layer { name: "roi_pool5" type: "ROIPooling" bottom: "conv5_3" '
        f'bottom: "rois" top: "pool5" roi_pooling_param {{ pooled_w: '
        f'{pooled} pooled_h: {pooled} spatial_scale: 0.0625 }} }}\n')
    bottom = "pool5"
    for i in (6, 7):
        p.append(f'layer {{ name: "fc{i}" type: "InnerProduct" bottom: '
                 f'"{bottom}" top: "fc{i}" inner_product_param {{ '
                 'num_output: 4096 } }\n'
                 f'layer {{ name: "relu{i}" type: "ReLU" bottom: "fc{i}" '
                 f'top: "fc{i}" }}\n'
                 f'layer {{ name: "drop{i}" type: "Dropout" bottom: "fc{i}" '
                 f'top: "fc{i}" dropout_param {{ dropout_ratio: 0.5 }} }}\n')
        bottom = f"fc{i}"
    p.append(f'layer {{ name: "cls_score" type: "InnerProduct" bottom: '
             f'"fc7" top: "cls_score" inner_product_param {{ num_output: '
             f'{classes} }} }}\n'
             f'layer {{ name: "bbox_pred" type: "InnerProduct" bottom: "fc7" '
             f'top: "bbox_pred" inner_product_param {{ num_output: '
             f'{4 * classes} }} }}\n'
             'layer { name: "cls_prob" type: "Softmax" bottom: "cls_score" '
             'top: "cls_prob" }\n')
    return "".join(p)


def caffe_graph_phase(dev, smi):
    """``build_caffe_graph`` on the card (phase ``caffe_graph``, then a
    ``timing`` line): the SSD300 deploy net against ``SSDVgg`` and the
    Faster-RCNN VGG16 deploy net against ``FasterRcnnVgg``, each pair on
    one seeded caffemodel.  Returns K2's launches of the graph's timed
    forwards."""
    import os
    import tempfile

    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.data.synthetic import render_shapes_image
    from analytics_zoo_tpu_torch.models.faster_rcnn import (FasterRcnnVgg,
                                                            FrcnnParam)
    from analytics_zoo_tpu_torch.models.ssd import (SSDVgg, build_priors,
                                                    ssd300_config)
    from analytics_zoo_tpu_torch.ops import pallas_detout
    from analytics_zoo_tpu_torch.ops.detection_output import detection_output
    from analytics_zoo_tpu_torch.pipelines.frcnn import FRCNN_BGR_MEANS
    from analytics_zoo_tpu_torch.pipelines.ssd import BGR_MEANS
    from analytics_zoo_tpu_torch.utils import caffe

    k2 = pallas_detout.fused_detection_output
    rng = np.random.RandomState(71)
    tmp = tempfile.mkdtemp(prefix="caffe_graph-")
    out = {}

    def images(res, means):
        return torch.from_numpy(np.stack([
            render_shapes_image(rng, res)[0].astype(np.float32)
            - np.float32(means) for _ in range(BATCH)])).to(dev)

    def loaded(graph, model, loader, name, **kw):
        path = os.path.join(tmp, f"{name}.caffemodel")
        t0 = time.perf_counter()
        caffe.save_caffemodel(path, seeded_caffe_net(graph, rng))
        new, rep = caffe.load_caffe_weights(graph, path)
        new_m, rep_m = loader(model, path, **kw)
        seconds = time.perf_counter() - t0
        if rep["missing"] or rep["unused"] or rep_m["missing"] or rep_m[
                "unused"]:
            raise AssertionError(f"{name}: caffemodel import {rep} {rep_m}")
        graph.load_state_dict(new)
        model.load_state_dict(new_m)
        os.remove(path)
        return len(rep["loaded"]), seconds

    # 1. SSD300: the deploy graph and SSDVgg on one caffemodel, batch 8
    t0 = time.perf_counter()
    graph = caffe.build_caffe_graph(caffe.parse_prototxt(
        ssd300_deploy_prototxt()), device=dev)
    build_s = time.perf_counter() - t0
    model = SSDVgg(21, 300, device=dev)
    n_loaded, import_s = loaded(graph, model, caffe.load_ssd_vgg_caffe,
                                "ssd300")
    x = images(300, BGR_MEANS)
    priors, variances = (torch.from_numpy(a).to(dev)
                         for a in build_priors(ssd300_config()))
    with torch.inference_mode():
        k2.launches = 0
        got = graph(x)
        torch.cuda.synchronize()
        graph_launches = k2.launches
        loc, conf = model(x)
        want = detection_output(loc, torch.softmax(conf, -1), priors,
                                variances)
    err = rows_err(got, want)
    if graph_launches != 1:
        raise AssertionError(f"SSD300 deploy graph: K2 launched "
                             f"{graph_launches} times a forward")
    with torch.inference_mode():
        graph_ms = cuda_ms(lambda: graph(x), 5)
        ssdvgg_ms = cuda_ms(lambda: detection_output(
            *(lambda lc: (lc[0], torch.softmax(lc[1], -1)))(model(x)),
            priors, variances), 5)
    out["ssd300"] = {"layers": len(graph.specs), "params_loaded": n_loaded,
                     "build_s": build_s, "caffemodel_s": import_s,
                     "detections": int((got[..., 1] > 0).sum()),
                     "rows_max_abs_err": err,
                     "k2_launches_a_forward": graph_launches,
                     "graph_ms": graph_ms, "ssdvgg_ms": ssdvgg_ms}
    del graph, model

    # 2. Faster-RCNN VGG16: the deploy graph (Python proposal, ROIPooling)
    # and FasterRcnnVgg on one caffemodel (fc6 permuted CHW → HWC by
    # load_frcnn_vgg_caffe), batch 8 on the 512² canvas
    res = FRCNN_RESOLUTION
    param = FrcnnParam(pooled=CAFFE_FRCNN_POOLED)
    t0 = time.perf_counter()
    graph = caffe.build_caffe_graph(caffe.parse_prototxt(
        frcnn_vgg16_deploy_prototxt(res, param.pooled, param.num_classes)),
        device=dev)
    build_s = time.perf_counter() - t0
    model = FasterRcnnVgg(param, device=dev)
    n_loaded, import_s = loaded(graph, model, caffe.load_frcnn_vgg_caffe,
                                "frcnn", pooled=param.pooled)
    seen = {}

    def proposal_layer(g, spec, ins, louts, ctx):
        result = caffe._python_proposal(g, spec, ins, louts, ctx)
        seen["rois"] = result[0]
        return result

    graph.registry["Python"] = proposal_layer
    x = images(res, FRCNN_BGR_MEANS)
    info = torch.tensor([[res, res, 1.0]], device=dev).expand(BATCH, 3)
    with torch.inference_mode():
        k2.launches = 0
        bbox, prob = graph(x)
        rois, mask, probs, deltas = model(x, info)
    rois5, gmask = seen["rois"]
    stage = {"rois_px": (rois5[:, 1:] - rois.reshape(-1, 4)).abs().max()
             .item(),
             "cls_prob": rel_err(prob, probs.reshape(prob.shape)),
             "bbox_pred": rel_err(bbox, deltas.reshape(bbox.shape))}
    if not (torch.equal(gmask, mask.reshape(-1)) and stage["rois_px"] <= 1e-3
            and stage["cls_prob"] <= FRCNN_STAGE_TOL
            and stage["bbox_pred"] <= FRCNN_STAGE_TOL and k2.launches == 0):
        raise AssertionError(f"Faster-RCNN deploy graph against "
                             f"FasterRcnnVgg: masks equal "
                             f"{torch.equal(gmask, mask.reshape(-1))}, "
                             f"{stage} (tol 1e-3 px, {FRCNN_STAGE_TOL}), K2 "
                             f"{k2.launches}")
    with torch.inference_mode():
        frcnn_graph_ms = cuda_ms(lambda: graph(x), 3)
        frcnn_model_ms = cuda_ms(lambda: model(x, info), 3)
    out["frcnn_vgg16"] = {"layers": len(graph.specs),
                          "params_loaded": n_loaded, "build_s": build_s,
                          "caffemodel_s": import_s,
                          "proposals": int(gmask.sum()), **stage,
                          "tolerance": FRCNN_STAGE_TOL,
                          "graph_ms": frcnn_graph_ms,
                          "faster_rcnn_vgg_ms": frcnn_model_ms}
    del graph, model
    os.rmdir(tmp)
    emit("caffe_graph", batch=BATCH, **out)
    emit("timing", nvidia_smi=smi,
         caffe_graph_ssd300_ms_per_batch=graph_ms,
         ssdvgg_ms_per_batch=ssdvgg_ms,
         caffe_graph_frcnn_ms_per_batch=frcnn_graph_ms,
         faster_rcnn_vgg_ms_per_batch=frcnn_model_ms)
    return {"k2_launches": graph_launches}


def ssd_variants_phase(dev, smi):
    """``SSDAlexNet`` and ``SSDMobileNet`` served through ``SSDPredictor``
    on the card (phase ``ssd_variants``, then a ``timing`` line); returns
    K2's launches of the served batches."""
    import statistics

    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.data.synthetic import render_shapes_image
    from analytics_zoo_tpu_torch.models import SSDAlexNet, SSDMobileNet
    from analytics_zoo_tpu_torch.ops import pallas_detout, pallas_nms
    from analytics_zoo_tpu_torch.ops.detection_output import (
        DetectionOutputParam)
    from analytics_zoo_tpu_torch.pipelines.ssd import (PreProcessParam,
                                                       SSDPredictor)

    k1, k2 = pallas_nms.nms_sweep, pallas_detout.fused_detection_output
    rng = np.random.RandomState(81)
    param = PreProcessParam(batch_size=BATCH)
    batches = [{"input": np.stack([render_shapes_image(rng, 300)[0]
                                   for _ in range(BATCH)]),
                "im_info": np.tile(np.float32([300, 300, 1, 1]), (BATCH, 1))}
               for _ in range(VARIANT_BATCHES)]
    out, timing, launches = {}, {}, 0
    for name, model in (("alexnet", SSDAlexNet(21, device=dev, seed=0)),
                        ("mobilenet", SSDMobileNet(21, device=dev, seed=0))):
        pred = SSDPredictor(model, param, device=dev)
        plain = SSDPredictor(model, param, DetectionOutputParam(
            n_classes=21, backend="xla"), device=dev)
        k1.launches = k2.launches = 0
        got = [pred.detect_batch(b) for b in batches]
        n = k2.launches
        if n != len(batches) or k1.launches:
            raise AssertionError(f"{name}: K2 launched {n} times, K1 "
                                 f"{k1.launches}, for {len(batches)} "
                                 "batches")
        launches += n
        err = max(rows_err(torch.from_numpy(g),
                           torch.from_numpy(plain.detect_batch(b)))
                  for g, b in zip(got, batches))
        ms = [host_ms(lambda: pred.detect_batch(batches[0]))
              for _ in range(VARIANT_TIMED)]
        x = torch.from_numpy(batches[0]["input"]).to(dev).float()
        with torch.inference_mode():
            fwd_ms = cuda_ms(lambda: model(x), 10)
        out[name] = {"priors": int(pred._priors.shape[0]),
                     "n_params": sum(p.numel() for p in model.parameters()),
                     "k2_launches": n, "rows_max_abs_err": err,
                     "detections": int(sum((g[..., 1] > 0).sum()
                                           for g in got))}
        timing[name] = {"detect_batch_ms": statistics.median(ms),
                        "detect_batch_ms_each": ms, "forward_ms": fwd_ms}
    emit("ssd_variants", batch=BATCH, batches=len(batches), **out)
    emit("timing", nvidia_smi=smi, ssd_variants=timing)
    return {"k2_launches": launches}


# ---------------------------------------------------------------------------
# The model-zoo long tail: fraud, recommendation, sentiment, their pool
# ---------------------------------------------------------------------------

# the Kaggle creditcard.csv's shape: rows, frauds, two days of seconds
FRAUD_ROWS = 284_807
FRAUD_POSITIVES = 492
FRAUD_SECONDS = 172_792
# run_fraud_pipeline cut from the reference's 20 models x 10 epochs
FRAUD_MODELS = 2
FRAUD_EPOCHS = 1
# MovieLens-1M's counts and the recommenders' widths
ML1M_USERS = 6040
ML1M_ITEMS = 3952
REC_BATCH = 256
REC_ZIPF = 1.3
REC_TRAIN_BATCHES = 50
REC_TRAIN_EPOCHS = 4           # 200 steps
# make_sentiment_model's defaults, and the batch
SENT_VOCAB = 20_000
SENT_DIM = 100
SENT_HIDDEN = 128
SENT_SEQ = 128
SENT_BATCH = 64
SENT_TRAIN_BATCHES = 4
SENT_TRAIN_EPOCHS = 5          # 20 steps
# card against CPU, TF32 off, the same weights and batch: the loss within
# ZOO_LOSS_TOL relative, each gradient within ZOO_GRAD_TOL relative L2
# (fp32 products summed in another order; CUDA's and the CPU's exp, log
# and tanh differ by an ulp); the sentiment heads' recurrences run 128
# steps, which carry those differences through every step: SENT_GRAD_TOL
ZOO_LOSS_TOL = 1e-5
ZOO_GRAD_TOL = 1e-4
SENT_GRAD_TOL = 1e-3
# the three lookups' forwards and table gradients on the card
LOOKUP_TOL = 1e-5
# the weight-only int8 rung's probabilities against the fp rung's
SENT_INT8_TOL = 5e-2
# requests a family through the runtime, windows a rung, pool requests
ZOO_REQUESTS = 64
ZOO_WINDOWS = 5
ZOO_POOL_REQUESTS = 96


def kernel_counters():
    """K1-K4, whose ``launches`` the zoo phases hold at 0."""
    from analytics_zoo_tpu_torch.ops import (pallas_detout, pallas_nms,
                                             pallas_rnn)

    return (pallas_nms.nms_sweep, pallas_detout.fused_detection_output,
            pallas_rnn.persistent_rnn, pallas_rnn.persistent_rnn_bwd)


def zero_kernel_counters():
    for k in kernel_counters():
        k.launches = 0


def no_kernel_launches(what):
    """K1-K4's launches since :func:`zero_kernel_counters`; any raises."""
    got = {k.__name__: k.launches for k in kernel_counters()}
    if any(got.values()):
        raise AssertionError(f"{what}: launched {got}; the path runs none "
                             "of K1-K4")
    return got


def fraud_frame(seed):
    """A seeded frame at creditcard.csv's shape: ``time`` (sorted seconds
    over two days), ``V1``..``V28`` (PCA components of falling variance)
    and ``amount`` (log-normal): 29 inputs; 492 ``label`` 1 rows, shifted
    along the first ten components so a model can find them."""
    import numpy as np

    rng = np.random.RandomState(seed)
    n = FRAUD_ROWS
    label = np.zeros(n, np.int64)
    label[rng.choice(n, FRAUD_POSITIVES, replace=False)] = 1
    v = (rng.randn(n, 28) * np.linspace(2.0, 0.3, 28)).astype(np.float32)
    v[label == 1, :10] += rng.randn(10).astype(np.float32) * 2.0
    frame = {"time": np.sort(rng.uniform(0, FRAUD_SECONDS, n)),
             "amount": rng.lognormal(3.0, 1.5, n).astype(np.float32),
             "label": label}
    frame.update({f"V{i + 1}": v[:, i] for i in range(28)})
    return frame, [f"V{i + 1}" for i in range(28)] + ["amount"]


def card_vs_cpu(cpu_model, card_model, inputs, target, criterion):
    """One loss and its gradients on the CPU and the card from the same
    weights and batch (eval mode: no dropout): ``(loss, loss relative
    error, {parameter: gradient relative L2 error})``."""
    import torch

    out = {}
    for name, m in (("cpu", cpu_model), ("card", card_model)):
        m.evaluate()
        m.zero_grad()
        loss = criterion(m(*inputs), torch.as_tensor(target,
                                                      device=m.device))
        loss.backward()
        out[name] = (loss.item(), {n: p.grad.detach().cpu() for n, p in
                                   m.module.named_parameters()})
    (lc, gc), (lg, gg) = out["cpu"], out["card"]
    errs = {n: ((gg[n] - gc[n]).norm() / gc[n].norm().clamp_min(1e-30)
                ).item() for n in gc}
    return lc, abs(lg - lc) / max(abs(lc), 1e-30), errs


def twin(make, dev, *args, **kwargs):
    """``make(...)`` on the CPU, and a copy of its weights on ``dev``."""
    cpu = make(*args, device="cpu", **kwargs)
    card = make(*args, device=dev, **kwargs)
    card.load_weights(cpu.module.state_dict())
    return cpu, card


def rung_windows(rt, tiers, make_window):
    """Each rung forced in turn through ``pump(force=True)`` in
    ``ZOO_WINDOWS`` interleaved windows of one batch: ms a batch by rung
    (host clock, the readback included) and each window's rows."""
    import torch

    ms = {t.name: [] for t in tiers}
    rows = {t.name: [] for t in tiers}
    for w in range(ZOO_WINDOWS):
        payloads = make_window(w)
        for i, t in enumerate(tiers):
            rt.ladder.tier = i
            for p in payloads:
                rt.submit(p)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if rt.pump(force=True) != 1:
                raise AssertionError(f"rung {t.name}: not one batch")
            ms[t.name].append((time.perf_counter() - t0) * 1e3)
            done = rt.requests[-len(payloads):]
            if {r.tier for r in done} != {i}:
                raise AssertionError(f"rung {t.name} served at tiers "
                                     f"{[r.tier for r in done]}")
            rows[t.name].append([r.result for r in done])
    return ms, rows


def serve_requests(tiers, payloads, what):
    """``payloads`` through ``ServingRuntime(tiers, n_replicas=2,
    max_batch=8)`` on the monotonic clock, then ``drain()``: every request
    done; returns the runtime, its rows, and the seconds it took with the
    requests' latency p50 and p99 (ms)."""
    import numpy as np

    from analytics_zoo_tpu_torch.serving import MonotonicClock, ServingRuntime

    rt = ServingRuntime(tiers, n_replicas=2, max_batch=BATCH,
                        queue_capacity=len(payloads), length_key=None,
                        default_deadline_s=3600.0, clock=MonotonicClock())
    t0 = time.perf_counter()
    for p in payloads:
        rt.submit(p)
    rt.drain()
    served_s = time.perf_counter() - t0
    check_served(rt, what, len(payloads))
    lat = rt.snapshot()["metrics"]["latency_by_tier"]["0"]
    return rt, np.stack([np.asarray(r.result) for r in rt.requests]), {
        "served_s": served_s, "p50_ms": lat["p50_s"] * 1e3,
        "p99_ms": lat["p99_s"] * 1e3}


def step_ms(step, state, batches, n):
    """Median host-clock ms of ``n`` train steps (after one of warm-up),
    each ending in a synchronize; returns (median, state)."""
    import statistics

    import torch

    state, _ = step(state, batches[0])
    times = []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batches[i % len(batches)])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), state


def fraud_phase(dev, smi):
    """Fraud detection on the card (phase ``fraud``, then a ``timing``
    line); returns the trained model and K1-K4's launches (none)."""
    import statistics

    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.core.criterion import ClassNLLCriterion
    from analytics_zoo_tpu_torch.core.module import Model
    from analytics_zoo_tpu_torch.models import FraudMLP
    from analytics_zoo_tpu_torch.parallel import (Adam, create_train_state,
                                                  make_train_step)
    from analytics_zoo_tpu_torch.pipelines import fraud

    zero_kernel_counters()
    frame, cols = fraud_frame(71)
    runs = []

    class Recorded(fraud.Optimizer):
        def optimize(self):
            t0 = time.perf_counter()
            out = super().optimize()
            torch.cuda.synchronize()
            runs.append((self, time.perf_counter() - t0))
            return out

    plain = fraud.Optimizer
    fraud.Optimizer = Recorded
    try:
        t0 = time.perf_counter()
        result = fraud.run_fraud_pipeline(frame, cols, n_models=FRAUD_MODELS,
                                          epochs=FRAUD_EPOCHS, device=dev)
        pipeline_s = time.perf_counter() - t0
    finally:
        fraud.Optimizer = plain
    losses = [torch.stack([m["loss"] for m in opt.history]).cpu().numpy()
              for opt, _ in runs]
    if len(runs) != FRAUD_MODELS or not all(np.isfinite(x).all()
                                            for x in losses):
        raise AssertionError(f"fraud: {len(runs)} models trained, finite "
                             f"losses {[np.isfinite(x).all() for x in losses]}")

    # one MLPClassifier step's loss and gradients, card against CPU
    x = np.random.RandomState(72).randn(64, 29).astype(np.float32)
    y = (np.arange(64) % 7 == 0).astype(np.int64)

    def make(device):
        return Model(FraudMLP(), device=device).build(
            0, np.zeros((1, 29), np.float32))

    cpu_m, card_m = twin(make, dev)
    loss, loss_err, grad_err = card_vs_cpu(cpu_m, card_m, (x,), y,
                                           ClassNLLCriterion())
    if loss_err > ZOO_LOSS_TOL or max(grad_err.values()) > ZOO_GRAD_TOL:
        raise AssertionError(f"fraud card vs CPU: loss {loss_err}, "
                             f"gradients {grad_err}")

    # the trained model served through the runtime, on the pipeline's
    # assembled and scaled features
    features = fraud.FramePipeline([
        fraud.VectorAssembler(cols), fraud.StandardScaler()]).fit_transform(
            frame)["features"]
    model = runs[0][0].model
    tiers = fraud.fraud_serving_tiers(model)
    rows_in = features[np.random.RandomState(73).choice(
        len(features), ZOO_REQUESTS, replace=False)]
    rt, served, serve_time = serve_requests(
        tiers, [{"input": r} for r in rows_in], "fraud")
    direct = tiers[0].forward({"input": rows_in})
    serve_err = float(np.abs(served - direct).max())
    if serve_err > 1e-5:
        raise AssertionError(f"fraud: served rows {serve_err} from direct")
    rung_ms, _ = rung_windows(rt, tiers, lambda w: [
        {"input": r} for r in rows_in[w * BATCH:(w + 1) * BATCH]])
    launches = no_kernel_launches("fraud")

    step = make_train_step(card_m, ClassNLLCriterion(), Adam(5e-3))
    batches = [{"input": x, "target": y}]
    med, _ = step_ms(step, create_train_state(card_m, Adam(5e-3)), batches,
                     50)
    epochs_s = [s for _, s in runs]
    speed = {t: statistics.median(v) for t, v in rung_ms.items()}
    emit("fraud", rows=FRAUD_ROWS, positives=FRAUD_POSITIVES, inputs=29,
         n_models=FRAUD_MODELS, epochs=FRAUD_EPOCHS,
         cut="run_fraud_pipeline with 2 models x 1 epoch, from the "
             "reference's 20 models x 10 epochs",
         auprc=result.auprc, best_threshold=result.best_threshold,
         precision=result.precision, recall=result.recall,
         steps_per_model=[len(x) for x in losses],
         first_last_loss=[[float(x[0]), float(x[-1])] for x in losses],
         pipeline_s=pipeline_s,
         card_vs_cpu={"loss": loss, "loss_rel_err": loss_err,
                      "grad_rel_l2": grad_err,
                      "tolerance": [ZOO_LOSS_TOL, ZOO_GRAD_TOL]},
         served=ZOO_REQUESTS, served_rows_max_abs_err=serve_err,
         rung_speed_vs_fp=speed["int8"] / speed["fp"],
         launches=launches)
    emit("timing", nvidia_smi=smi, fraud={
        "train_step_ms": med, "batch": 64,
        "epoch_s": epochs_s,
        "epoch_steps": [len(x) for x in losses],
        "step_ms_in_epoch": [s * 1e3 / len(x)
                             for s, x in zip(epochs_s, losses)],
        **serve_time,
        "rung_ms_per_batch": speed, "rung_ms_each": rung_ms})
    return model, launches


def rec_ids(rng, n):
    """``n`` users and items drawn as the bench draws them: Zipf(1.3)
    modulo the vocabulary."""
    import numpy as np

    return ((rng.zipf(REC_ZIPF, n) % ML1M_USERS).astype(np.int32),
            (rng.zipf(REC_ZIPF, n) % ML1M_ITEMS).astype(np.int32))


def rec_ratings(seed, n):
    """Seeded ratings 1..5 from a rank-4 user x item affinity, on Zipf
    ids."""
    import numpy as np

    rng = np.random.RandomState(seed)
    u_f = np.random.RandomState(0).randn(ML1M_USERS, 4)
    i_f = np.random.RandomState(1).randn(ML1M_ITEMS, 4)
    users, items = rec_ids(rng, n)
    score = (u_f[users] * i_f[items]).sum(1) + 0.3 * rng.randn(n)
    ratings = np.clip(np.round(3 + score), 1, 5).astype(np.int32)
    return users, items, ratings


def rec_phase(dev, smi):
    """NeuralCF and Wide&Deep on the card (phase ``rec``, then a
    ``timing`` line); returns the trained NeuralCF and K1-K4's launches
    (none)."""
    import statistics

    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.core.criterion import ClassNLLCriterion
    from analytics_zoo_tpu_torch.ops import embedding as emb
    from analytics_zoo_tpu_torch.parallel import (MAE, Adam, Loss,
                                                  create_train_state,
                                                  make_train_step,
                                                  sparse_adam_apply, validate)
    from analytics_zoo_tpu_torch.pipelines import recommendation as rec

    zero_kernel_counters()
    rng = np.random.RandomState(81)
    users, items = rec_ids(rng, REC_BATCH)
    tu, ti = (torch.as_tensor(v, device=dev).long() for v in (users, items))
    widths = dict(n_users=ML1M_USERS, n_items=ML1M_ITEMS, embedding_dim=20,
                  hidden=(40, 20), n_classes=5)
    makers = {"ncf": lambda **k: rec.make_ncf_model(
                  mf_embedding_dim=8, **widths, **k),
              "wide_deep": lambda **k: rec.make_wide_deep_model(
                  cross_buckets=1000, **widths, **k)}

    # 1. the three lookups on the card: forwards and table gradients
    w = torch.as_tensor(rng.randn(REC_BATCH, 5).astype(np.float32),
                        device=dev)
    lookup_err, repeat_equal = {}, True
    for name, make in makers.items():
        models = {m: make(lookup=m, device=dev) for m in emb.LOOKUP_MODES}
        for m in models.values():
            m.load_weights(models["dedup"].module.state_dict())
        res = {}
        for mode, m in models.items():
            m.zero_grad()
            out = m(tu, ti)
            (out * w).sum().backward()
            res[mode] = (out.detach(), {n: p.grad.clone() for n, p in
                                        m.module.named_parameters()
                                        if n.endswith("embedding")})
        m = models["dedup"]
        m.zero_grad()
        (m(tu, ti) * w).sum().backward()
        repeat_equal &= all(torch.equal(p.grad, res["dedup"][1][n])
                            for n, p in m.module.named_parameters()
                            if n.endswith("embedding"))
        ref_out, ref_g = res["onehot"]
        lookup_err[name] = {mode: max(
            [(o - ref_out).abs().max().item()]
            + [(g[n] - ref_g[n]).abs().max().item() for n in ref_g])
            for mode, (o, g) in res.items() if mode != "onehot"}
    worst = max(v for d in lookup_err.values() for v in d.values())
    if worst > LOOKUP_TOL or not repeat_equal:
        raise AssertionError(f"rec lookups: {lookup_err}, dedup backward "
                             f"repeats bit for bit: {repeat_equal}")

    # 2. sparse_adam_apply against a dense Adam step on the touched rows
    table = torch.as_tensor(rng.randn(ML1M_USERS, 20).astype(np.float32),
                            device=dev)
    grad = emb.embedding_grad_rows(tu, torch.as_tensor(
        rng.randn(REC_BATCH, 20).astype(np.float32), device=dev))
    zeros = torch.zeros_like(table)
    new, mu, nu, _ = sparse_adam_apply(table, zeros, zeros,
                                       torch.zeros((), dtype=torch.int32,
                                                   device=dev),
                                       grad, learning_rate=1e-3)
    dense = torch.nn.Parameter(table.clone())
    adam = Adam(1e-3)
    state = adam.init([dense])
    adam.update([dense], [emb.sparse_rows_to_dense(grad, ML1M_USERS)],
                state, 1e-3)
    touched = grad.ids[:int(grad.count)]
    sparse_equal = (torch.equal(new[touched], dense[touched])
                    and torch.equal(mu[touched], state["mu"][0][touched])
                    and torch.equal(nu[touched], state["nu"][0][touched]))
    if not sparse_equal:
        raise AssertionError("sparse_adam_apply differs from the dense Adam "
                             "step on the touched rows")

    # 3. train_recommender: 200 steps, validated before and after
    tr = rec.rating_batches(*rec_ratings(82, REC_BATCH * REC_TRAIN_BATCHES),
                            REC_BATCH)
    val = rec.rating_batches(*rec_ratings(83, REC_BATCH * 4), REC_BATCH)
    model = makers["ncf"](device=dev)
    methods = [MAE(), Loss(ClassNLLCriterion())]
    before = {r.name: r.result() for r in validate(model, val, methods)}
    runs = []

    class Recorded(rec.Optimizer):
        def optimize(self):
            out = super().optimize()
            runs.append(self)
            return out

    plain = rec.Optimizer
    rec.Optimizer = Recorded
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec.train_recommender(model, tr, epochs=REC_TRAIN_EPOCHS)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    finally:
        rec.Optimizer = plain
    losses = torch.stack([m["loss"] for m in runs[0].history]).cpu().numpy()
    after = {r.name: r.result() for r in validate(model, val, methods)}
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    if (len(losses) != REC_TRAIN_BATCHES * REC_TRAIN_EPOCHS
            or not np.isfinite(losses).all() or not last < first
            or not after["Loss"] < before["Loss"]):
        raise AssertionError(f"rec training: {len(losses)} steps, loss "
                             f"{first} -> {last}, validation {before} -> "
                             f"{after}")

    # 4. card against CPU: loss and gradients, both models
    batch = tr[0]
    grads = {}
    for name, make in makers.items():
        cpu_m, card_m = twin(lambda device: make(device=device), dev)
        loss, loss_err, grad_err = card_vs_cpu(cpu_m, card_m,
                                               batch["input"],
                                               batch["target"],
                                               ClassNLLCriterion())
        grads[name] = {"loss": loss, "loss_rel_err": loss_err,
                       "grad_rel_l2_max": max(grad_err.values())}
        if loss_err > ZOO_LOSS_TOL or max(grad_err.values()) > ZOO_GRAD_TOL:
            raise AssertionError(f"rec {name} card vs CPU: loss {loss_err},"
                                 f" gradients {grad_err}")

    # 5. pair requests through the runtime
    tiers = rec.rec_serving_tiers(model)
    pu, pi = rec_ids(np.random.RandomState(84), ZOO_REQUESTS)
    pairs = [{"input": np.array([u, i], np.int32)} for u, i in zip(pu, pi)]
    rt, served, serve_time = serve_requests(tiers, pairs, "rec")
    direct = tiers[0].forward({"input": (pu, pi)})
    serve_err = float(np.abs(served - direct).max())
    if serve_err > 1e-5:
        raise AssertionError(f"rec: served rows {serve_err} from direct")
    rung_ms, _ = rung_windows(rt, tiers,
                              lambda k: pairs[k * BATCH:(k + 1) * BATCH])
    launches = no_kernel_launches("rec")

    # 6. timing: the step, the lookups by mode, serving
    step = make_train_step(model, ClassNLLCriterion(), Adam(1e-3))
    med, _ = step_ms(step, create_train_state(model, Adam(1e-3)), tr, 50)
    table = model.module.user_embed.embedding
    g = torch.ones((REC_BATCH, 20), device=dev)
    lookup_ms = {}
    for mode in emb.LOOKUP_MODES:
        def fwd():
            with torch.no_grad():
                emb.sharded_embedding_lookup(table, tu, mode=mode)

        def fwd_bwd():
            t = table.detach().requires_grad_()
            (emb.sharded_embedding_lookup(t, tu, mode=mode) * g).sum(
            ).backward()
        lookup_ms[mode] = {"forward": cuda_ms(fwd, 50),
                           "forward_backward": cuda_ms(fwd_bwd, 50)}
    speed = {t: statistics.median(v) for t, v in rung_ms.items()}
    stats = emb.lookup_stats(users)
    emit("rec", users=ML1M_USERS, items=ML1M_ITEMS, embedding_dim=20,
         mf_embedding_dim=8, hidden=[40, 20], classes=5, cross_buckets=1000,
         batch=REC_BATCH, zipf=REC_ZIPF, lookup_stats=stats,
         lookups_max_abs_err_vs_onehot=lookup_err,
         lookup_tolerance=LOOKUP_TOL, dedup_backward_repeats=repeat_equal,
         sparse_adam_equals_dense_on_touched_rows=sparse_equal,
         touched_rows=int(grad.count),
         train_steps=len(losses), train_s=train_s,
         loss_first_last_20=[first, last], validation_before=before,
         validation_after=after, card_vs_cpu=grads,
         card_vs_cpu_tolerance=[ZOO_LOSS_TOL, ZOO_GRAD_TOL],
         served=ZOO_REQUESTS, served_rows_max_abs_err=serve_err,
         rung_speed_vs_fp=speed["int8"] / speed["fp"], launches=launches)
    emit("timing", nvidia_smi=smi, rec={
        "train_step_ms": med, "batch": REC_BATCH,
        "lookup_ms_by_mode": lookup_ms, "lookup_table": [ML1M_USERS, 20],
        **serve_time,
        "rung_ms_per_batch": speed, "rung_ms_each": rung_ms})
    return model, launches


def review_tokens(seed, n):
    """Seeded reviews of ``SENT_SEQ`` tokens over the whole vocabulary,
    a fifth of them sentiment words: ids 0-49 in a positive review, 50-99
    in a negative one."""
    import numpy as np

    rng = np.random.RandomState(seed)
    labels = (rng.rand(n) < 0.5).astype(np.float32)
    words = rng.randint(0, 50, (n, SENT_SEQ)) + 50 * (labels[:, None] < 1)
    tokens = np.where(rng.rand(n, SENT_SEQ) < 0.2, words,
                      rng.randint(0, SENT_VOCAB, (n, SENT_SEQ)))
    return tokens.astype(np.int32), labels


def sentiment_phase(dev, smi):
    """SentimentNet's five heads and the frozen table on the card (phase
    ``sentiment``, then a ``timing`` line); returns the trained GRU model
    and K1-K4's launches (none)."""
    import statistics

    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.core.criterion import BCECriterion
    from analytics_zoo_tpu_torch.models.simple import HEADS
    from analytics_zoo_tpu_torch.parallel import (Adam, create_train_state,
                                                  make_train_step)
    from analytics_zoo_tpu_torch.pipelines import sentiment as sent

    zero_kernel_counters()
    glove = np.random.RandomState(91).randn(SENT_VOCAB, SENT_DIM).astype(
        np.float32) * 0.1
    cases = {h: dict(head=h) for h in HEADS}
    cases["gru-frozen"] = dict(head="gru", embeddings=glove)
    tokens, labels = review_tokens(92, SENT_BATCH * SENT_TRAIN_BATCHES)
    batches = sent.review_batches(tokens, labels, SENT_BATCH)
    small = tokens[:BATCH], labels[:BATCH]
    x = torch.as_tensor(batches[0]["input"], device=dev)
    checks, timing = {}, {}
    for name, kw in cases.items():
        cpu_m, card_m = twin(sent.make_sentiment_model, dev, **kw)
        loss, loss_err, grad_err = card_vs_cpu(cpu_m, card_m, (small[0],),
                                               small[1], BCECriterion())
        with torch.no_grad():
            fwd_err = (card_m(small[0]).cpu() - cpu_m(small[0])).abs().max(
            ).item()
        checks[name] = {"loss": loss, "loss_rel_err": loss_err,
                        "forward_max_abs_err": fwd_err,
                        "grad_rel_l2_max": max(grad_err.values())}
        if (loss_err > ZOO_LOSS_TOL or fwd_err > ZOO_LOSS_TOL
                or max(grad_err.values()) > SENT_GRAD_TOL):
            raise AssertionError(f"sentiment {name} card vs CPU: "
                                 f"{checks[name]}, gradients {grad_err}")
        card_m.evaluate()

        def forward():
            with torch.inference_mode():
                card_m(x)
        step = make_train_step(card_m, BCECriterion(), Adam(1e-3))
        med, _ = step_ms(step, create_train_state(card_m, Adam(1e-3)),
                         batches, 5)
        timing[name] = {"forward_ms": cuda_ms(forward, 5),
                        "train_step_ms": med}
        del cpu_m, card_m, step

    # train_sentiment on the GRU head: 20 steps
    model = sent.make_sentiment_model(head="gru", device=dev)
    runs = []

    class Recorded(sent.Optimizer):
        def optimize(self):
            out = super().optimize()
            runs.append(self)
            return out

    plain = sent.Optimizer
    sent.Optimizer = Recorded
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sent.train_sentiment(model, batches, epochs=SENT_TRAIN_EPOCHS)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    finally:
        sent.Optimizer = plain
    losses = torch.stack([m["loss"] for m in runs[0].history]).cpu().numpy()
    n = SENT_TRAIN_BATCHES
    first, last = float(losses[:n].mean()), float(losses[-n:].mean())
    if (len(losses) != n * SENT_TRAIN_EPOCHS
            or not np.isfinite(losses).all() or not last < first):
        raise AssertionError(f"sentiment training: {len(losses)} steps, "
                             f"loss by epoch {first} -> {last}")

    # the fp and int8 rungs through the runtime
    tiers = sent.sentiment_serving_tiers(model, seq_len=SENT_SEQ)
    req_tokens, _ = review_tokens(93, ZOO_REQUESTS)
    payloads = [{"input": t} for t in req_tokens]
    rt, served, serve_time = serve_requests(tiers, payloads, "sentiment")
    direct = tiers[0].forward({"input": req_tokens})
    serve_err = float(np.abs(served - direct).max())
    if serve_err > 1e-5:
        raise AssertionError(f"sentiment: served rows {serve_err} from "
                             "direct")
    rung_ms, rows = rung_windows(rt, tiers, lambda k: payloads[
        k * BATCH:(k + 1) * BATCH])
    int8_err = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                   for wa, wb in zip(rows["int8"], rows["fp"])
                   for a, b in zip(wa, wb))
    if int8_err > SENT_INT8_TOL:
        raise AssertionError(f"sentiment int8 rung {int8_err} from fp")
    launches = no_kernel_launches("sentiment")
    speed = {t: statistics.median(v) for t, v in rung_ms.items()}
    emit("sentiment", vocab=SENT_VOCAB, embedding_dim=SENT_DIM,
         hidden=SENT_HIDDEN, seq_len=SENT_SEQ, batch=SENT_BATCH,
         heads=sorted(cases), card_vs_cpu=checks, card_vs_cpu_batch=BATCH,
         tolerance=[ZOO_LOSS_TOL, SENT_GRAD_TOL], train_head="gru",
         train_steps=len(losses), train_s=train_s,
         loss_first_last_epoch=[first, last], served=ZOO_REQUESTS,
         served_rows_max_abs_err=serve_err, int8_vs_fp_max_abs=int8_err,
         int8_tolerance=SENT_INT8_TOL,
         rung_speed_vs_fp=speed["int8"] / speed["fp"], launches=launches)
    emit("timing", nvidia_smi=smi, sentiment={
        "by_head": timing, "batch": SENT_BATCH, "seq_len": SENT_SEQ,
        "recurrence": "blocked scan, 128 steps a batch (gru, lstm, "
                      "bilstm both ways, cnn-lstm)",
        **serve_time,
        "rung_ms_per_batch": speed, "rung_ms_each": rung_ms})
    return model, launches


def zoo_pool_phase(dev, smi, fraud_model, rec_model, sent_model):
    """The three families on one multiplexed ``ServingRuntime`` (phase
    ``zoo_pool``); returns K1-K4's launches (none)."""
    import numpy as np

    from analytics_zoo_tpu_torch.pipelines import (fraud_serving_tiers,
                                                   rec_serving_tiers,
                                                   sentiment_serving_tiers)
    from analytics_zoo_tpu_torch.serving import (ModelConfig, MonotonicClock,
                                                 ServingRuntime)

    zero_kernel_counters()
    rng = np.random.RandomState(101)
    pool = ServingRuntime(models=[
        ModelConfig("fraud", tiers=fraud_serving_tiers(fraud_model),
                    length_key=None),
        ModelConfig("rec", tiers=rec_serving_tiers(rec_model),
                    length_key=None),
        ModelConfig("sentiment", tiers=sentiment_serving_tiers(
            sent_model, seq_len=SENT_SEQ), length_key=None)],
        n_replicas=2, max_batch=BATCH, queue_capacity=ZOO_POOL_REQUESTS,
        default_deadline_s=3600.0, clock=MonotonicClock())
    seen = record_batches(pool)
    users, items = rec_ids(rng, ZOO_POOL_REQUESTS)
    tokens, _ = review_tokens(102, ZOO_POOL_REQUESTS)
    feats = rng.randn(ZOO_POOL_REQUESTS, 29).astype(np.float32)
    t0 = time.perf_counter()
    for i in range(ZOO_POOL_REQUESTS):
        name = ("fraud", "rec", "sentiment")[i % 3]
        payload = {"fraud": feats[i],
                   "rec": np.array([users[i], items[i]], np.int32),
                   "sentiment": tokens[i]}[name]
        pool.submit({"input": payload}, model=name)
        pool.pump()
    pool.drain()
    served_s = time.perf_counter() - t0
    check_served(pool, "zoo_pool", ZOO_POOL_REQUESTS)
    if any(len(b["models"]) != 1 for b in seen):
        raise AssertionError("zoo_pool: a batch held two models")
    snap = pool.snapshot()
    reg = pool.metrics.registry
    per_model = {}
    for m in pool.models:
        lat = reg.histogram(f"serve/latency_s/model={m}/tier=0").snapshot()
        per_model[m] = {"requests": snap["models"][m]["outcomes"],
                        "batches": sum(b["model"] == m for b in seen),
                        "latency_p50_ms": lat["p50"] * 1e3,
                        "latency_p99_ms": lat["p99"] * 1e3,
                        "weight": snap["models"][m]["weight"],
                        "tier": snap["models"][m]["ladder"]["tier"]}
    launches = no_kernel_launches("zoo_pool")
    emit("zoo_pool", nvidia_smi=smi, n_replicas=2,
         requests=ZOO_POOL_REQUESTS, served_s=served_s, models=per_model,
         accounting=pool.accounting(), launches=launches)
    return launches


# ---------------------------------------------------------------------------
# Checkpoints, resume and the live weight swap
# ---------------------------------------------------------------------------

# the straight run's and the crashed run's iterations, the snapshot
# cadence and the fault's global batch index
RESUME_STEPS = 6
RESUME_EVERY = 2
RESUME_FAIL_AT = 4
# the resumed run against the straight one: each parameter, batch
# statistic and Adam slot within K4's fp32 relative L2 error (against its
# own norm, or the model's largest for a bias in front of a BN, whose
# gradient is 0 up to rounding), or within RESUME_SPREAD times what a
# second straight run differs by, where that is larger, and never past
# RESUME_CEIL: on the card two straight runs are not bit-equal either
# (PyTorch documents the CUDA CTC loss's backward as nondeterministic;
# two straight runs on an H100 differed by 5.0e-3 to 7.7e-3), and a
# spread past RESUME_CEIL fails the phase as a run-to-run fault
RESUME_TOL = 1e-3
RESUME_SPREAD = 4.0
RESUME_CEIL = 2e-2
# the frames of the legacy-against-blocked batch (the 5c cut)
LEGACY_FRAMES = 600
# requests through the swap, and after it
SWAP_REQUESTS = 64


def max_abs_rel(got, want):
    """The largest absolute and relative difference over two dicts of
    tensors, and whether every tensor is bit-equal."""
    import torch

    diffs = [(got[k].float() - w.float(), w.float()) for k, w in want.items()]
    return (max(d.abs().max().item() for d, _ in diffs),
            max((d.abs() / w.abs().clamp_min(1e-12)).max().item()
                for d, w in diffs),
            all(torch.equal(got[k], w) for k, w in want.items()))


def ds2_resume_phase(dev, smi, train_batches, samples, sample_lengths,
                     labels):
    """DS2 training checkpointed and resumed after a crash on the card
    (phase ``ds2_resume``), with the ``ds2_legacy`` and ``ds2_loader``
    lines; returns K3's and K4's launches on the path."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.models.ssd import build_ssd_vgg
    from analytics_zoo_tpu_torch.ops import pallas_rnn
    from analytics_zoo_tpu_torch.parallel import (SGD, Adam, FaultInjector,
                                                  Optimizer, Trigger,
                                                  make_eval_step,
                                                  run_resilient)
    from analytics_zoo_tpu_torch.parallel import checkpoint as ckpt
    from analytics_zoo_tpu_torch.pipelines.deepspeech2 import (
        ds2_ctc_criterion, ds2_padding_metric, load_asr_train_set,
        make_ds2_model)
    from analytics_zoo_tpu_torch.pipelines.ssd import TrainParams, train_ssd

    root = tempfile.mkdtemp()
    try:
        # one epoch of RESUME_STEPS batches, the same list every attempt
        # (a reshuffled epoch would differ between the two runs)
        epoch = (list(train_batches) * RESUME_STEPS)[:RESUME_STEPS]
        criterion = ds2_ctc_criterion()

        def optimizer(data, path, end=RESUME_STEPS):
            opt = (Optimizer(make_ds2_model(
                       hidden=DS2_HIDDEN, n_rnn_layers=3,
                       rnn_engine="pallas", seed=0, device=dev),
                       data, criterion, metric_fn=ds2_padding_metric)
                   .set_optim_method(Adam(3e-4))
                   .set_end_when(Trigger.max_iteration(end)))
            if path is not None:
                opt.set_checkpoint(path, Trigger.several_iteration(
                    RESUME_EVERY), overwrite=False, keep_last=2)
            return opt

        def compare(got, want):
            """Losses, state and slots of run ``got`` against ``want``."""
            def parts(o):
                names = [n for n, _ in o.model.named_parameters()]
                return [o.model.state_dict()] + [
                    {f"{k}.{n}": t for n, t in
                     zip(names, o._last_state.opt_state[k])}
                    for k in ("mu", "nu")]

            (sd_g, *sl_g), (sd_w, *sl_w) = parts(got), parts(want)
            errs = {}
            for g, w in zip([sd_g, *sl_g], [sd_w, *sl_w]):
                errs.update(grads_err(g, w))    # each kind against its own
            la = [m["loss"].item() for m in want.history]
            lb = [m["loss"].item() for m in got.history]
            errs["loss"] = max(abs(a - b) / abs(a) for a, b in zip(la, lb))
            top = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
            sd_abs, sd_rel, eq_sd = max_abs_rel(sd_g, sd_w)
            sl_abs, sl_rel, eq_sl = max_abs_rel({**sl_g[0], **sl_g[1]},
                                                {**sl_w[0], **sl_w[1]})
            return {"worst_rel_l2": top[0][1], "worst": dict(top),
                    "state_max_abs_diff": sd_abs,
                    "state_max_rel_diff": sd_rel, "state_bit_equal": eq_sd,
                    "slots_max_abs_diff": sl_abs,
                    "slots_max_rel_diff": sl_rel, "slots_bit_equal": eq_sl,
                    "losses_bit_equal": la == lb}

        def counts():
            torch.cuda.synchronize()
            return {"persistent_rnn": pallas_rnn.persistent_rnn.launches,
                    "persistent_rnn_bwd":
                        pallas_rnn.persistent_rnn_bwd.launches}

        torch.cuda.reset_peak_memory_stats()
        dir_a, dir_b = os.path.join(root, "a"), os.path.join(root, "b")
        # -- the main path: counts at 0 just before, read just after ------
        torch.cuda.synchronize()
        pallas_rnn.persistent_rnn.launches = 0
        pallas_rnn.persistent_rnn_bwd.launches = 0
        run_a = optimizer(epoch, dir_a)
        run_a.optimize()
        save_s = dict(ckpt.last_save_s)
        launches_a = counts()
        attempts = []

        def build():
            data = (FaultInjector(epoch, fail_at=RESUME_FAIL_AT)
                    if not attempts else epoch)
            opt = optimizer(data, dir_b)
            attempts.append(opt)
            return opt

        run_resilient(build, dir_b, max_restarts=1)
        launches_ab = counts()
        launches_b = {k: launches_ab[k] - launches_a[k] for k in launches_a}
        # a second straight run, no snapshots: the card's run-to-run spread
        run_a2 = optimizer(epoch, None)
        run_a2.optimize()
        steps_a = len(run_a.history)
        steps_b = sum(len(o.history) for o in attempts)
        for name, steps, got in (("straight", steps_a, launches_a),
                                 ("resumed", steps_b, launches_b)):
            if steps != RESUME_STEPS or any(v != 6 * steps
                                            for v in got.values()):
                raise AssertionError(
                    f"ds2_resume {name} run: {steps} executed steps "
                    f"launched {got} (want {RESUME_STEPS} steps, 6 of "
                    f"each a step)")
        if [len(o.history) for o in attempts] != [
                RESUME_FAIL_AT, RESUME_STEPS - RESUME_FAIL_AT]:
            raise AssertionError(f"ds2_resume attempts ran "
                                 f"{[len(o.history) for o in attempts]}")
        # B against A: losses, parameters and batch statistics, slots
        losses_a = [m["loss"].item() for m in run_a.history]
        losses_b = [m["loss"].item() for o in attempts for m in o.history]
        final = attempts[-1]
        final.history = [m for o in attempts for m in o.history]
        resumed = compare(final, run_a)
        spread = compare(run_a2, run_a)
        tol = min(RESUME_CEIL,
                  max(RESUME_TOL, RESUME_SPREAD * spread["worst_rel_l2"]))
        if (not all(np.isfinite(losses_a))
                or spread["worst_rel_l2"] > RESUME_CEIL
                or resumed["worst_rel_l2"] > tol):
            raise AssertionError(
                f"ds2_resume: resumed against straight {resumed}, two "
                f"straight runs {spread} (tol {tol}); losses {losses_b} vs "
                f"{losses_a}")
        # the fallback: a truncated newest snapshot resumes from the older
        newest, _man = ckpt.newest_intact(dir_b)
        snap_bytes = sum(os.path.getsize(os.path.join(newest, f))
                         for f in ("manifest.json", "data/state.pt"))
        with open(os.path.join(newest, "data", "state.pt"), "r+b") as f:
            f.truncate(os.path.getsize(f.name) // 2)
        older, older_man = ckpt.newest_intact(dir_b)
        t0 = time.perf_counter()
        ckpt.verify_snapshot(older)
        verify_s = time.perf_counter() - t0
        # restore alone: the older snapshot onto the card beside run A's
        # tensors (what a resume loads before it copies into the module)
        target = {"model": run_a.model.state_dict(), "step": 0,
                  "opt_state": run_a._last_state.opt_state}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.load(older, target=target, verify=False)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        # a resume that ends where it lands: the older snapshot restored,
        # no step taken, bit-equal to the crashed attempt's state there
        fallback = optimizer(epoch, dir_b, end=RESUME_FAIL_AT).set_resume()
        fallback.optimize()
        launches = counts()
        resumed_at = older_man["meta"]["iteration"]
        *_, fb_equal = max_abs_rel(fallback.model.state_dict(),
                                   attempts[0].model.state_dict())
        if (os.path.basename(newest) != f"step_{RESUME_STEPS}"
                or os.path.basename(older) != f"step_{RESUME_FAIL_AT}"
                or resumed_at != RESUME_FAIL_AT or fallback.history
                or fallback._last_state.step != RESUME_FAIL_AT
                or not fb_equal):
            raise AssertionError(
                f"ds2_resume fallback: newest {newest}, older {older} at "
                f"iteration {resumed_at}, {len(fallback.history)} steps, "
                f"restored bit-equal {fb_equal}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # the SSD entry point: train_ssd writes a snapshot every epoch and
        # set_resume restores it onto the card
        rng = np.random.RandomState(41)
        ssd_batches = [ssd_batch(rng, BATCH) for _ in range(2)]
        ssd_dir = os.path.join(root, "ssd")
        ssd_model = train_ssd(ssd_batches, None, TrainParams(
            max_epoch=1, checkpoint_path=ssd_dir),
            model=build_ssd_vgg(21, 300, device=dev, seed=0))
        ssd_snap, ssd_man = ckpt.newest_intact(ssd_dir)
        ckpt.verify_snapshot(ssd_snap)
        fresh = build_ssd_vgg(21, 300, device=dev, seed=5)
        params = TrainParams()
        (Optimizer(fresh, ssd_batches, lambda out, b: out[0].sum())
         .set_optim_method(SGD(params.learning_rate,
                               momentum=params.momentum,
                               weight_decay=params.weight_decay))
         .set_resume(ssd_dir).set_end_when(Trigger.max_epoch(1))
         .optimize())
        ssd_equal = all(
            a.device.type == dev.type and torch.equal(a, b)
            for a, b in zip(fresh.state_dict().values(),
                            ssd_model.state_dict().values()))
        if (os.path.basename(ssd_snap) != "latest"
                or ssd_man["meta"]["iteration"] != 2 or not ssd_equal):
            raise AssertionError(f"train_ssd checkpoint: {ssd_snap} "
                                 f"{ssd_man['meta']}, restored equal "
                                 f"{ssd_equal}")
        emit("ds2_resume", nvidia_smi=smi, hidden=DS2_HIDDEN, layers=3,
             batch=BATCH, steps=RESUME_STEPS, fail_at=RESUME_FAIL_AT,
             checkpoint_every=RESUME_EVERY,
             executed_steps={"straight": steps_a, "resumed": steps_b,
                             "fallback": len(fallback.history)},
             launches={"straight": launches_a, "resumed": launches_b,
                       "path": launches},
             losses_straight=losses_a, losses_resumed=losses_b,
             resumed_vs_straight=resumed, straight_vs_straight=spread,
             tolerance=tol,
             fallback={"corrupted": os.path.basename(newest),
                       "resumed_from": os.path.basename(older),
                       "at_iteration": resumed_at,
                       "restored_bit_equal": fb_equal},
             snapshot_bytes=snap_bytes, save_s=save_s,
             verify_s=verify_s, restore_s=restore_s, peak_gb=peak_gb,
             ssd_entry={"snapshot": os.path.basename(ssd_snap),
                        "meta_iteration": ssd_man["meta"]["iteration"],
                        "restored_on_card_equal": ssd_equal})

        # -- ds2_legacy: the per-step engine against blocked, 1 layer ----
        feats = next(b for b in train_batches
                     if b["input"][0].shape[1] == DS2_BUCKETS[-1])
        x = torch.from_numpy(feats["input"][0][:, :LEGACY_FRAMES]).to(dev)
        nets = {e: make_ds2_model(hidden=DS2_HIDDEN, n_rnn_layers=1,
                                  rnn_engine=e, seed=1, device=dev)
                for e in ("legacy", "blocked")}
        steps = {e: make_eval_step(m) for e, m in nets.items()}
        lp = {e: s(x) for e, s in steps.items()}
        legacy_err = (lp["legacy"] - lp["blocked"]).abs().max().item()
        ms = {e: cuda_ms(lambda s=s: s(x), 3, 1) for e, s in steps.items()}
        if legacy_err > DS2_LOGP_TOL:
            raise AssertionError(f"ds2_legacy: legacy vs blocked log-probs "
                                 f"{legacy_err} (tol {DS2_LOGP_TOL})")
        emit("ds2_legacy", nvidia_smi=smi, hidden=DS2_HIDDEN, layers=1,
             batch=BATCH, frames=LEGACY_FRAMES,
             logp_max_abs_diff=legacy_err, tolerance=DS2_LOGP_TOL,
             forward_ms=ms)

        # -- ds2_loader: two forked workers against the serial stream -----
        t0 = time.perf_counter()
        forked = list(load_asr_train_set(
            samples, labels, sample_lengths=sample_lengths,
            batch_size=BATCH, seed=0, bucket_edges=DS2_BUCKETS,
            worker_processes=2))
        forked_s = time.perf_counter() - t0
        if len(forked) != len(train_batches):
            raise AssertionError(f"ds2_loader: {len(forked)} batches from "
                                 f"2 workers, {len(train_batches)} serial")
        arrays = 0
        for g, w in zip(forked, train_batches):
            for k in w:
                for a, b in zip(*(v if isinstance(v, tuple) else (v,)
                                  for v in (g[k], w[k]))):
                    if not np.array_equal(a, b):
                        raise AssertionError(f"ds2_loader: {k} differs")
                    arrays += 1
        emit("ds2_loader", workers=2, batches=len(forked), arrays=arrays,
             equal=True, seconds=forked_s)
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def ssd_swap_phase(dev, smi):
    """SSD300 serving across live weight swaps on the card (phase
    ``ssd_swap``); returns K1's and K2's launches on the path."""
    import shutil
    import statistics
    import tempfile

    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.models.ssd import build_ssd_vgg
    from analytics_zoo_tpu_torch.obs.slo import model_slos
    from analytics_zoo_tpu_torch.ops import pallas_detout, pallas_nms
    from analytics_zoo_tpu_torch.parallel import checkpoint as ckpt
    from analytics_zoo_tpu_torch.pipelines.ssd import (BGR_MEANS,
                                                       PreProcessParam,
                                                       SSDPredictor,
                                                       ssd_serving_tiers)
    from analytics_zoo_tpu_torch.resilience.errors import CheckpointCorrupt
    from analytics_zoo_tpu_torch.serving import (ModelConfig,
                                                 MonotonicClock,
                                                 ServingRuntime)

    rng = np.random.RandomState(43)
    param = PreProcessParam(batch_size=BATCH, resolution=300)
    installs = []

    def images(n):
        return [rng.randint(0, 256, (300, 300, 3)).astype(np.float32)
                - np.float32(BGR_MEANS) for _ in range(n)]

    def weights_to_tiers(state, rid):
        """The rungs on a module that holds the loaded state, on the
        card."""
        t0 = time.perf_counter()
        m = build_ssd_vgg(21, 300, device=dev, seed=0)
        m.load_state_dict(state)
        tiers = ssd_serving_tiers(m, param, device=dev)
        k2 = pallas_detout.fused_detection_output.launches
        for t in tiers:            # cuDNN / cuBLAS for the new module
            t.forward({"input": warm})
        torch.cuda.synchronize()
        installs.append({"rid": rid, "s": time.perf_counter() - t0,
                         "k2_warmup": pallas_detout.fused_detection_output
                         .launches - k2})
        return tiers

    def serve(rt, xs):
        """Submit one request at a time and pump: the swap advances
        between batches.  Returns the requests."""
        reqs = []
        for x in xs:
            reqs.append(rt.submit({"input": x}))
            rt.pump()
        rt.drain()
        rt.pump(force=True)
        return reqs

    def latency_ms(reqs):
        lat = sorted((r.completed_t - r.arrival_t) * 1e3 for r in reqs)
        return {"p50": statistics.median(lat),
                "p99": lat[min(len(lat) - 1, int(0.99 * len(lat)))]}

    def counters():
        torch.cuda.synchronize()
        return {"nms_sweep": pallas_nms.nms_sweep.launches,
                "fused_detection_output":
                    pallas_detout.fused_detection_output.launches}

    root = tempfile.mkdtemp()
    try:
        warm = np.stack(images(BATCH))
        model0 = build_ssd_vgg(21, 300, device=dev, seed=0)
        tiers0 = ssd_serving_tiers(model0, param, device=dev)
        for t in tiers0:
            t.forward({"input": warm})
        cfg = ModelConfig(name="ssd", tiers=tiers0,
                          weights_to_tiers=weights_to_tiers,
                          length_key=None, max_batch=BATCH,
                          default_deadline_s=3600.0,
                          slos=model_slos("ssd", miss_budget=0.9,
                                          shed_budget=0.9))
        rt = ServingRuntime(models=[cfg], n_replicas=2, max_batch=BATCH,
                            queue_capacity=4 * SWAP_REQUESTS,
                            default_deadline_s=3600.0,
                            clock=MonotonicClock())
        base = os.path.join(root, "ssd")
        model1 = build_ssd_vgg(21, 300, device=dev, seed=1)
        snap1 = ckpt.save(base, model1.state_dict(), step=1)
        t0 = time.perf_counter()        # what hot_swap does first
        ckpt.load(snap1, verify=True, device=dev)
        torch.cuda.synchronize()
        load_verify_s = time.perf_counter() - t0
        before = serve(rt, images(SWAP_REQUESTS))

        # -- the main path: counts at 0 just before, read just after ------
        torch.cuda.reset_peak_memory_stats()
        pallas_nms.nms_sweep.launches = 0
        pallas_detout.fused_detection_output.launches = 0
        t0 = time.perf_counter()
        rt.hot_swap(snap1, canary_fraction=0.25, canary_min=BATCH,
                    divergence_budget=1e9, lkg_after=1, device=dev)
        during = serve(rt, images(SWAP_REQUESTS))
        rollout_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        probe = images(BATCH)
        after = serve(rt, probe + images(SWAP_REQUESTS - BATCH))
        launches = counters()
        live = 2 * SWAP_REQUESTS // BATCH       # the "during" and "after"
        warmups = sum(i["k2_warmup"] for i in installs)
        mirror_forwards = launches["fused_detection_output"] - live - warmups
        swap = rt.snapshot()["swap"]
        acct = rt.accounting()
        installed = [e["replica"] for e in rt.pool.events
                     if e["kind"] == "swap_installed"]
        mirrored = rt.metrics.registry.counter(
            "serve/canary/mirrored/model=ssd").value
        # the rows the fp rung serves: normalized detections of the batch
        want = SSDPredictor(model1, param, device=dev).detect_normalized(
            np.stack(probe)).cpu()
        got = torch.from_numpy(np.stack([r.result for r in after[:BATCH]]))
        new_err = rows_err(got, want)
        lkg = ckpt.tier_snapshot(base, "serve-lkg")
        if (swap["completed"] != 1 or swap["rollbacks"]
                or sorted(installed) != [0, 1]
                or acct["by_state"] != {"done": acct["submitted"]}
                or acct["unaccounted"] or rt.snapshot()["metrics"]["failed"]
                or swap["lkg_promotions"] != 1 or lkg is None
                or not 1 <= mirror_forwards <= live
                or launches["nms_sweep"]):
            raise AssertionError(
                f"ssd_swap rollout: {swap}, installed {installed}, "
                f"accounting {acct}, launches {launches}, serve-lkg {lkg}")

        # -- a tight divergence budget: the canary trips, rolls back ------
        snap2 = ckpt.save(base, build_ssd_vgg(21, 300, device=dev,
                                              seed=2).state_dict(), step=2)
        drains = sum(e["kind"] == "swap_drain" for e in rt.pool.events)
        # every row mirrored: the seeded 0.25 gate selects request ids in
        # runs, and none of this window's
        rt.hot_swap(snap2, canary_fraction=1.0, canary_min=BATCH,
                    divergence_budget=1e-6, device=dev)
        tripped = serve(rt, probe + images(SWAP_REQUESTS - BATCH))
        swap2 = rt.snapshot()["swap"]
        trip_err = rows_err(torch.from_numpy(
            np.stack([r.result for r in tripped[:BATCH]])), want)
        if (swap2["trips"] != 1 or swap2["rollbacks"] != 1
                or swap2["history"][-1]["outcome"] != "rolled_back"
                or sum(e["kind"] == "swap_drain" for e in rt.pool.events)
                != drains):
            raise AssertionError(f"ssd_swap canary trip: {swap2}")

        # -- a corrupt publish is refused before any drain ----------------
        snap3 = ckpt.save(base, model1.state_dict(), step=3)
        full = os.path.join(snap3, "data", "state.pt")
        with open(full, "r+b") as f:
            f.seek(os.path.getsize(full) // 2)
            byte = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([byte[0] ^ 0xFF]))
        try:
            rt.hot_swap(snap3, device=dev)
        except CheckpointCorrupt as e:
            corrupt = type(e).__name__
        else:
            raise AssertionError("ssd_swap: a corrupt publish was taken")
        if rt.swap_active or rt.snapshot()["swap"]["rollouts"] != 2:
            raise AssertionError("ssd_swap: the corrupt publish started a "
                                 "rollout")
        acct = rt.accounting()
        if acct["by_state"] != {"done": acct["submitted"]}:
            raise AssertionError(f"ssd_swap accounting {acct}")
        emit("ssd_swap", nvidia_smi=smi, classes=21, batch=BATCH,
             replicas=2, requests=acct["submitted"],
             rollout={"completed": swap["completed"], "installed":
                      installed, "mirrored": mirrored,
                      "failed": rt.snapshot()["metrics"]["failed"],
                      "lkg_promotions": swap["lkg_promotions"],
                      "new_rows_max_abs_err": new_err},
             canary_trip={"trips": swap2["trips"],
                          "rollbacks": swap2["rollbacks"],
                          "reason": swap2["history"][-1].get("reason"),
                          "rows_max_abs_err_vs_previous": trip_err},
             corrupt_publish=corrupt, launches=launches,
             k2_live_forwards=live, k2_mirror_forwards=mirror_forwards,
             k2_install_warmups=warmups,
             load_verify_s=load_verify_s, rollout_s=rollout_s,
             install_s=installs, latency_ms_before=latency_ms(before),
             latency_ms_during=latency_ms(during),
             latency_ms_after=latency_ms(after), peak_gb=peak_gb,
             accounting=acct)
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# 6m/6n. data- and tensor-parallel training on torch.distributed
# ---------------------------------------------------------------------------

# ranks on the one card, each a process started by ``engine.spawn`` that
# imports the port and this script only; they share the card over gloo
# (NCCL refuses two ranks of one communicator on one device)
DIST_WORLD = 2
DIST_BACKEND = "gloo"
# the collectives the port's sharded steps call on CUDA tensors: the
# gradient and row-layer all_reduce, the weights' first placement a
# broadcast, the column outputs' and gathered weights' all_gather
# (parallel/tensor.py), and the all_to_all_single with a split size a
# peer under every exchange of parallel/sequence.py (ppermute, the halo,
# the scans' carries, all_to_all).  The card's gloo takes all four
# (probed in dist_dp, dist_seq and dist_attn, each failing if it does
# not), so dist_tp, dist_seq and dist_attn run at world 2 over gloo
DIST_NEEDS = ("all_reduce", "broadcast", "all_gather", "all_to_all")
DIST_TP_WORLD = 2
# DS2 at the widths above, 3 steps on global batches of 8 × 1000 frames
DIST_DS2_FRAMES, DIST_DS2_STEPS = 1000, 3
# SSD300, fp32: 2 steps of 32 (16 a rank), validation of 8 (4 a rank)
DIST_SSD_BATCH, DIST_SSD_STEPS, DIST_SSD_VAL = 32, 2, 8
# tensor parallel: SSD300 2 steps of 8, DS2 2 steps of the DS2 batches
DIST_TP_SSD_BATCH, DIST_TP_STEPS = 8, 2
# the first step's loss against the one-process step on the same rows,
# relative; its gradients relative L2 (DS2 each tensor as grads_err
# holds it, K4's fp32 tolerance; SSD all of them as one vector, as
# SSD_GRAD_TOL holds a card step against the CPU's)
DIST_LOSS_TOL = 1e-5
DIST_GRAD_TOL = 1e-3
# the merged validation against the one-process validation of the same
# weights: the rows EQUAL (rows_err) to this process's detections of the
# same rank-sized halves, in rank order; against the one-process batch of
# 8, each image's rows matched greedily (class equal, box within
# DIST_BOX_TOL), at least DIST_MATCH_MIN of them, their scores within
# DIST_SCORE_TOL.  A forward of 4 images rounds some logits otherwise
# than one of 8, which reorders near-equal scores of the random weights
# at the keep_topk cut and in the greedy suppression (the first run: 196
# of 200 rows of the worst image matched).  The megatron run's
# detections of its 8 images (each rank forwards all of them: the data
# axis is 1 wide) are held to the one-process batch of 8 the same way.
# The mAP is printed, not held: on random weights it is 0 on both sides
DIST_MATCH_MIN = 0.95
DIST_SCORE_TOL = 1e-5
DIST_BOX_TOL = 1e-4
DIST_TIMEOUT = 300


def dist_ds2_batches(seed, steps=None):
    """``steps`` (``DIST_DS2_STEPS``) global batches of 8 utterances of
    at most 10 s, bucketed at 1000 frames, with random labels."""
    import numpy as np

    from analytics_zoo_tpu_torch.pipelines.deepspeech2 import (
        load_asr_train_set)

    samples, lengths, labels = ds2_train_set(seed)
    short = np.nonzero(lengths <= 160 * DIST_DS2_FRAMES - 400)[0]
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps or DIST_DS2_STEPS):
        pick = rng.choice(short, BATCH, replace=False)
        ds = load_asr_train_set(samples[pick], labels[pick],
                                batch_size=BATCH, shuffle=False,
                                sample_lengths=lengths[pick],
                                bucket_edges=[DIST_DS2_FRAMES])
        out.append(next(iter(ds)))
    return out


class GradTap:
    """The batches of a list, one epoch each ``iter``; before the second
    the model's ``.grad`` (the first step's gradient, averaged over the
    data ranks) gathered whole to the host, and a synchronized host
    stamp before each batch and after the last.  The tap comes before
    the second stamp, so it falls in the first interval, which
    ``stamps_ms`` leaves out with the first step."""

    def __init__(self, batches, model, specs=None):
        self.batches, self.model, self.specs = batches, model, specs
        self.grads, self.stamps = None, []

    def __iter__(self):
        import torch

        for i, b in enumerate(self.batches):
            if i == 1:
                self.grads = tap_grads(self.model, self.specs)
            torch.cuda.synchronize()
            self.stamps.append(time.perf_counter())
            yield b
        torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())


def tap_grads(model, specs=None):
    """Every parameter's ``.grad`` as whole host arrays (shards gathered,
    a collective)."""
    named = {k: p.grad for k, p in model.named_parameters()}
    if specs is None:
        return {k: g.detach().cpu().numpy() for k, g in named.items()}
    from analytics_zoo_tpu_torch.parallel.tensor import spec_of

    return specs.gather(named, specs={
        k: spec_of(p) for k, p in model.named_parameters()})


def stamps_ms(stamps) -> float:
    """The median step of a ``GradTap``'s stamps in ms, the first
    interval (the warm-up step and the gradient tap) left out when there
    are others."""
    import numpy as np

    steps = 1e3 * np.diff(stamps)
    return float(np.median(steps[1:] if len(steps) > 1 else steps))


def vector_rel(got, want) -> float:
    """All of ``got`` against all of ``want`` as one vector, relative L2."""
    import numpy as np

    num = sum(float(np.sum((got[k].astype(np.float64) - w) ** 2))
              for k, w in want.items())
    den = sum(float(np.sum(np.asarray(w, np.float64) ** 2))
              for w in want.values())
    return (num / max(den, 1e-300)) ** 0.5


def probe_gloo():
    """Which collectives this rank's gloo group takes on CUDA tensors:
    ``{name: "ok" | the error}``."""
    import torch
    import torch.distributed as dist

    from analytics_zoo_tpu_torch.parallel import sequence
    from analytics_zoo_tpu_torch.parallel import tensor as tensor_lib

    dev = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size()
    ctx = tensor_lib.AxisCtx(None, dist.get_rank(), world)
    out = {}
    calls = {
        "all_reduce": lambda: dist.all_reduce(torch.ones(4, device=dev)),
        "broadcast": lambda: dist.broadcast(torch.ones(4, device=dev), 0),
        # the call the parallel layers make
        "all_gather": lambda: tensor_lib.all_gather_dim(
            torch.ones(4, device=dev), 0, ctx),
        # the sequence exchanges' call: uneven splits (rank 0 sends, the
        # last receives, the others neither)
        "all_to_all": lambda: sequence.ppermute(
            torch.ones(4, device=dev), dist.group.WORLD, [(0, world - 1)]),
    }
    for name in DIST_NEEDS:
        try:
            calls[name]()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:   # the probe's answer, printed; not a path
            out[name] = f"{type(e).__name__}: {str(e)[:120]}"
        dist.barrier()
    return out


def launch_counts():
    return {k.__name__: k.launches for k in kernel_counters()}


def dist_child(task, **kw):
    """One rank of a multi-rank phase (``engine.spawn`` target)."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return {"dp": dist_dp_rank, "tp": dist_tp_rank,
            "nccl": dist_nccl_rank, "seq": dist_seq_rank,
            "attn": dist_attn_rank, "spatial": dist_spatial_rank,
            "serve": dist_serve_rank, "sdc": dist_sdc_rank,
            "slice": dist_slice_rank, "examples": examples_rank}[task](**kw)


class recording_optimizer:
    """``with recording_optimizer(pipeline_module) as runs:`` — each
    ``Optimizer`` the pipeline's entry point builds, kept in ``runs``."""

    def __init__(self, module):
        self.module, self.runs = module, []

    def __enter__(self):
        runs, base = self.runs, self.module.Optimizer

        class Recording(base):
            def optimize(self):
                runs.append(self)
                return super().optimize()

        self.patched = base
        self.module.Optimizer = Recording
        return runs

    def __exit__(self, *exc):
        self.module.Optimizer = self.patched


def dist_ds2_rank(batches, rules, mesh_shape, axes, seed):
    """``train_ds2`` over a mesh on the DS2 batches: losses, the first
    step's gathered gradients (rank 0), step stamps, K3/K4 launches, and
    the flat gradient all-reduce alone (host clock, median of 3)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    from analytics_zoo_tpu_torch.parallel import tensor as tensor_lib
    from analytics_zoo_tpu_torch.parallel.specs import SpecSet
    from analytics_zoo_tpu_torch.pipelines import deepspeech2 as ds2_pipe
    from analytics_zoo_tpu_torch.utils import engine

    mesh = mesh_lib.create_mesh(mesh_shape, axes)
    param_rules = tensor_lib.default_tp_rules() if rules else None
    model = ds2_pipe.make_ds2_model(hidden=DS2_HIDDEN, n_rnn_layers=3,
                                    rnn_engine="pallas",
                                    device=engine.device(), seed=seed)
    specs = SpecSet(mesh, rules=param_rules)
    tap = GradTap(batches, model, specs)
    zero_kernel_counters()
    with recording_optimizer(ds2_pipe) as runs:
        ds2_pipe.train_ds2(model, tap, epochs=1, mesh=mesh,
                           param_rules=param_rules)
    torch.cuda.synchronize()
    launches = launch_counts()
    losses = [float(m["loss"]) for m in runs[0].history]
    n_params = sum(p.numel() for p in model.parameters())
    ar_ms = None
    group = specs.data_group()
    if group is not None:
        flat = torch.zeros(n_params + 1, device=engine.device())
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist.all_reduce(flat, group=group)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ar_ms = float(np.median(times))
    sharded = tensor_lib.sharded_param_count(model)
    grads = tap.grads if dist.get_rank() == 0 else None
    del model, runs
    torch.cuda.empty_cache()
    return {"grads": grads, "stamps": tap.stamps, "launches": launches,
            "all_reduce_ms": ar_ms, "n_params": n_params,
            "sharded_params": sharded, "losses": losses}


def dist_ssd_rank(train, val, tp, mesh_shape, axes):
    """``train_ssd`` (fp32) over a mesh: losses, the first step's gathered
    gradients and the trained weights (rank 0), this rank's validation
    detections, the merged mAP, the launches, step stamps."""
    import torch
    import torch.distributed as dist

    from analytics_zoo_tpu_torch.models.ssd import SSDVgg
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    from analytics_zoo_tpu_torch.parallel.specs import SpecSet
    from analytics_zoo_tpu_torch.pipelines import ssd as ssd_pipe
    from analytics_zoo_tpu_torch.utils import engine

    mesh = mesh_lib.create_mesh(mesh_shape, axes)
    model = SSDVgg(21, 300, device=engine.device(), seed=0)
    specs = SpecSet(mesh)
    tap = GradTap(train, model, specs)
    params = ssd_pipe.TrainParams(max_epoch=1, compute_dtype=None,
                                  prefetch=0)
    opt, seen, launches, seconds = recorded_train_ssd(
        tap, val, params, model, mesh=mesh, tp=tp)
    weights = specs.gather(model)
    rank0 = dist.get_rank() == 0
    out = {"losses": [float(m["loss"]) for m in opt.history],
           "grads": tap.grads if rank0 else None,
           "weights": weights if rank0 else None,
           "detections": [d.numpy() for _, _, d in seen],
           "val_history": opt.val_history, "launches": launches,
           "stamps": tap.stamps, "seconds": seconds}
    del model, opt
    torch.cuda.empty_cache()
    return out


def checked_probe():
    """``probe_gloo()``, failing when gloo refuses one of DIST_NEEDS."""
    probe = probe_gloo()
    missing = [c for c in DIST_NEEDS if probe[c] != "ok"]
    if missing:
        raise AssertionError(f"gloo on CUDA tensors refuses {missing}: "
                             f"{probe}")
    return probe


def dist_dp_rank(ds2_batches, ssd_train, ssd_val, seed):
    import torch.distributed as dist

    out = {"probe": checked_probe(), "backend": dist.get_backend()}
    out["ds2"] = dist_ds2_rank(ds2_batches, False, (DIST_WORLD,), ("data",),
                               seed)
    out["ssd"] = dist_ssd_rank(ssd_train, ssd_val, None, (DIST_WORLD,),
                               ("data",))
    return out


def dist_tp_rank(ds2_batches, ssd_train, ssd_val, seed):
    import torch.distributed as dist

    shape, axes = (1, DIST_TP_WORLD), ("data", "model")
    out = {"backend": dist.get_backend()}
    out["ssd"] = dist_ssd_rank(ssd_train, ssd_val, "megatron", shape, axes)
    out["ds2"] = dist_ds2_rank(ds2_batches, True, shape, axes, seed)
    out["analyze"] = dist_tp_analyze_rank(ds2_batches[0], shape, axes, seed)
    return out


def dist_tp_analyze_rank(batch, shape, axes, seed):
    """The program engine's collective inventory in dist_tp's group: one
    tensor-parallel DS2 step (``default_tp_rules``, K3 and K4) audited
    against its own ``SpecSet``, and the same step against a ``SpecSet``
    declared over a data-only mesh.  Host round-trips are not held here
    (``hot=False``): gloo takes CUDA tensors through the host by design.
    ``{"declared": [...], "data_only": [...]}`` of ``(rule, waived,
    message)``."""
    from analytics_zoo_tpu_torch.analysis.program import (AuditProgram,
                                                          BuiltProgram,
                                                          audit_program)
    from analytics_zoo_tpu_torch.parallel import Adam
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    from analytics_zoo_tpu_torch.parallel import tensor as tensor_lib
    from analytics_zoo_tpu_torch.parallel.specs import SpecSet
    from analytics_zoo_tpu_torch.parallel.train import (create_train_state,
                                                        make_train_step,
                                                        to_device)
    from analytics_zoo_tpu_torch.pipelines import deepspeech2 as ds2_pipe
    from analytics_zoo_tpu_torch.utils import engine

    dev = engine.device()
    tp_mesh = mesh_lib.create_mesh(shape, axes)
    data_only = SpecSet(mesh_lib.create_mesh((DIST_TP_WORLD,), ("data",)))
    batch = to_device(batch, dev)

    model = ds2_pipe.make_ds2_model(hidden=DS2_HIDDEN, n_rnn_layers=3,
                                    rnn_engine="pallas", device=dev,
                                    seed=seed)
    specs = SpecSet(tp_mesh, rules=tensor_lib.default_tp_rules())
    specs.place_state(model)
    optim = Adam(1e-4)
    step = make_train_step(model, ds2_pipe.ds2_ctc_criterion(), optim,
                           specs=specs)
    state = create_train_state(model, optim)
    out = {}
    # the same step twice: against its own declaration, then a data-only one
    for key, declared in (("declared", specs), ("data_only", data_only)):
        got = audit_program(AuditProgram(
            f"ds2-tp/train:{key}",
            lambda: BuiltProgram(fn=step, args=(state, batch),
                                 specs=declared, hot=False)))
        out[key] = [(v.rule, v.waived, v.message) for v in got]
    return out


def dist_nccl_rank():
    """World 1 over NCCL: the group starts, an all_reduce on the card,
    and one data-parallel step of a small model over the one-rank mesh."""
    import torch
    import torch.distributed as dist
    from torch import nn

    from analytics_zoo_tpu_torch.parallel import SGD, mesh as mesh_lib
    from analytics_zoo_tpu_torch.parallel.specs import SpecSet
    from analytics_zoo_tpu_torch.parallel.train import (create_train_state,
                                                        make_train_step)
    from analytics_zoo_tpu_torch.core.criterion import MSECriterion
    from analytics_zoo_tpu_torch.utils import engine

    dev = engine.device()
    x = torch.arange(4.0, device=dev)
    dist.all_reduce(x)
    mesh = mesh_lib.create_mesh((1,), ("data",))
    model = nn.Linear(8, 2).to(dev)
    optim = SGD(0.1)
    step = make_train_step(model, MSECriterion(), optim,
                           specs=SpecSet(mesh))
    state, metrics = step(create_train_state(model, optim), {
        "input": torch.ones(4, 8), "target": torch.zeros(4, 2)})
    return {"backend": dist.get_backend(), "all_reduce": x.tolist(),
            "loss": float(metrics["loss"])}


def match_rows(got, want):
    """Greedy match of two images' valid detection rows (class equal,
    box within DIST_BOX_TOL, highest score first): (matched share of
    ``want``'s rows, largest score difference over the matches)."""
    import numpy as np

    vg, vw = got[got[:, 1] > 0], want[want[:, 1] > 0]
    used, diffs = set(), []
    for row in vw:
        for j, other in enumerate(vg):
            if (j not in used and other[0] == row[0]
                    and np.abs(other[2:] - row[2:]).max() <= DIST_BOX_TOL):
                used.add(j)
                diffs.append(abs(float(other[1] - row[1])))
                break
    return len(diffs) / max(len(vw), 1), max(diffs) if diffs else 0.0


def settled_share(got, want, margin):
    """The share of ``want``'s valid rows scored more than ``margin``
    above its image's lowest kept score (where ``keep_topk`` cut the
    image's rows; every row otherwise) that ``match_rows`` finds in
    ``got``, over the images: the rows a perturbation of the scores by
    less than ``margin`` cannot push past the cut."""
    import numpy as np

    hits = total = 0
    for g, w in zip(got, want):
        vw = w[w[:, 1] > 0]
        cut = vw[:, 1].min() if len(vw) == len(w) else -np.inf
        settled = vw[vw[:, 1] > cut + margin]
        share, _ = match_rows(g, settled)
        hits += share * len(settled)
        total += len(settled)
    return hits / max(total, 1)


def match_images(got, want):
    """``match_rows`` of every image: (the smallest matched share, the
    mean share, the largest score difference)."""
    import numpy as np

    shares, score_err = [], 0.0
    for g, w in zip(got, want):
        share, d = match_rows(g, w)
        shares.append(share)
        score_err = max(score_err, d)
    return min(shares), float(np.mean(shares)), score_err


def dist_reference(dev, ds2_batches, ssd_train, seed, ssd_tp_batch=None):
    """The one-process steps the multi-rank ones are held to: DS2's and
    SSD300's first-step loss and gradients on the same global batches,
    and one more DS2 step timed by the host clock."""
    import torch

    from analytics_zoo_tpu_torch.models.ssd import (SSDVgg, build_priors,
                                                    config_for)
    from analytics_zoo_tpu_torch.ops.multibox_loss import (MultiBoxLoss,
                                                           MultiBoxLossParam)
    from analytics_zoo_tpu_torch.parallel import (SGD, Adam,
                                                  create_train_state,
                                                  make_train_step)
    from analytics_zoo_tpu_torch.pipelines import deepspeech2 as ds2_pipe

    out = {}
    model = ds2_pipe.make_ds2_model(hidden=DS2_HIDDEN, n_rnn_layers=3,
                                    rnn_engine="pallas", device=dev,
                                    seed=seed)
    step = make_train_step(model, ds2_pipe.ds2_ctc_criterion(blank_id=0),
                           Adam(3e-4), metric_fn=ds2_pipe.ds2_padding_metric)
    state = create_train_state(model, Adam(3e-4))
    state, metrics = step(state, ds2_batches[0])
    out["ds2_loss"] = metrics["loss"].item()
    out["ds2_grads"] = tap_grads(model)
    times = []
    for b in ds2_batches[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["ds2_step_ms"] = times
    del model, state, step
    priors, variances = build_priors(config_for(300))
    crit = MultiBoxLoss(priors, variances, MultiBoxLossParam(n_classes=21))
    for name, batch in (("ssd", ssd_train[0]), ("ssd_tp", ssd_tp_batch)):
        if batch is None:
            continue
        model = SSDVgg(21, 300, device=dev, seed=0)
        step = make_train_step(model, crit, SGD(1e-3, momentum=0.9),
                               skip_loss_above=50.0)
        state = create_train_state(model, SGD(1e-3, momentum=0.9))
        state, metrics = step(state, batch)
        out[f"{name}_loss"] = metrics["loss"].item()
        out[f"{name}_grads"] = tap_grads(model)
        # a second step, timed (the first picks the convolutions' kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        out[f"{name}_step_ms"] = (time.perf_counter() - t0) * 1e3
        del model, state, step
    torch.cuda.empty_cache()
    return out


def one_process_validation(dev, weights, val):
    """The trained weights validated in this process: (detections of every
    image, the detections of each batch forwarded in DIST_WORLD halves,
    mAP)."""
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.models.ssd import SSDVgg
    from analytics_zoo_tpu_torch.parallel import make_eval_step, validate
    from analytics_zoo_tpu_torch.pipelines.ssd import SSDMeanAveragePrecision

    model = SSDVgg(21, 300, device=dev, seed=0)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           weights.items()})
    model.eval()
    method = SSDMeanAveragePrecision(n_classes=21, resolution=300)
    eval_step = make_eval_step(model)
    def detect(x):
        return method.detect(eval_step(torch.from_numpy(x).to(dev))).cpu()

    dets = [detect(b["input"]).numpy() for b in val]
    halves = [torch.cat([detect(x) for x in np.split(b["input"],
                                                     DIST_WORLD)])
              for b in val]
    (result,) = validate(model, val, [method])
    return dets, halves, result.result()


def check_losses(what, got, want):
    err = abs(got - want) / max(abs(want), 1e-30)
    if not err <= DIST_LOSS_TOL:
        raise AssertionError(f"{what}: first-step loss {got} against the "
                             f"one-process {want} (rel {err:.3g}, tol "
                             f"{DIST_LOSS_TOL})")
    return err


def dist_dp_phase(dev, smi, seed=31):
    """dist_dp: DS2 and SSD300 trained data parallel by DIST_WORLD ranks on
    the one card over gloo, against the one-process steps."""
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.utils import engine

    t_phase = time.perf_counter()
    rng = np.random.RandomState(seed)
    ds2_batches = dist_ds2_batches(seed)
    ssd_train = [ssd_batch(rng, DIST_SSD_BATCH)
                 for _ in range(DIST_SSD_STEPS)]
    ssd_val = [ssd_batch(rng, DIST_SSD_VAL)]
    t0 = time.perf_counter()
    ranks = engine.spawn(os.path.abspath(__file__) + ":dist_child",
                         DIST_WORLD, dict(task="dp", ds2_batches=ds2_batches,
                                          ssd_train=ssd_train,
                                          ssd_val=ssd_val, seed=seed),
                         timeout=DIST_TIMEOUT, backend=DIST_BACKEND,
                         local_ranks=[0] * DIST_WORLD)
    spawn_s = time.perf_counter() - t0
    ref = dist_reference(dev, ds2_batches, ssd_train, seed)
    ds2 = [r["ds2"] for r in ranks]
    ssd = [r["ssd"] for r in ranks]
    # DS2: loss, gradients, K3/K4 on every rank's rows
    ds2_loss_err = check_losses("dist_dp ds2", ds2[0]["losses"][0],
                                ref["ds2_loss"])
    if any(r["losses"] != ds2[0]["losses"] for r in ds2):
        raise AssertionError(f"dist_dp ds2: the ranks' global losses differ "
                             f"{[r['losses'] for r in ds2]}")
    errs = grads_err({k: torch.from_numpy(v) for k, v in
                      ds2[0]["grads"].items()},
                     {k: torch.from_numpy(v) for k, v in
                      ref["ds2_grads"].items()})
    ds2_grad_err = max(errs.values())
    if not ds2_grad_err <= DIST_GRAD_TOL:
        worst = max(errs, key=errs.get)
        raise AssertionError(f"dist_dp ds2: first-step gradient {worst} rel "
                             f"L2 {ds2_grad_err:.3g} (tol {DIST_GRAD_TOL})")
    want = 6 * DIST_DS2_STEPS
    for r, x in enumerate(ds2):
        if (x["launches"]["persistent_rnn"] != want
                or x["launches"]["persistent_rnn_bwd"] != want):
            raise AssertionError(f"dist_dp ds2 rank {r}: launches "
                                 f"{x['launches']}, want {want} K3 and K4")
    dp_ms = [stamps_ms(x["stamps"]) for x in ds2]
    one_ms = float(np.median(ref["ds2_step_ms"]))
    # SSD300: loss, gradients (one vector), the merged validation
    ssd_loss_err = check_losses("dist_dp ssd", ssd[0]["losses"][0],
                                ref["ssd_loss"])
    ssd_grad_err = vector_rel(ssd[0]["grads"], ref["ssd_grads"])
    if not ssd_grad_err <= DIST_GRAD_TOL:
        raise AssertionError(f"dist_dp ssd: first-step gradients rel L2 "
                             f"{ssd_grad_err:.3g} (tol {DIST_GRAD_TOL})")
    per_tensor = max(
        float(np.linalg.norm(ssd[0]["grads"][k] - w)
              / max(np.linalg.norm(w), 1e-30))
        for k, w in ref["ssd_grads"].items())
    for r, x in enumerate(ssd):
        if x["launches"]["fused_detection_output"] < 1 or any(
                v for k, v in x["launches"].items()
                if k != "fused_detection_output"):
            raise AssertionError(f"dist_dp ssd rank {r}: validation "
                                 f"launched {x['launches']}")
        if (len(x["detections"]) != 1
                or x["detections"][0].shape[0] != DIST_SSD_VAL // DIST_WORLD):
            raise AssertionError(f"dist_dp ssd rank {r}: validated "
                                 f"{[d.shape for d in x['detections']]}")
    merged = np.concatenate([x["detections"][0] for x in ssd])
    ref_dets, ref_halves, ref_map = one_process_validation(
        dev, ssd[0]["weights"], ssd_val)
    halves_err = rows_err(torch.from_numpy(merged), ref_halves[0])
    match_min, match_mean, score_err = match_images(
        merged, np.concatenate(ref_dets))
    dp_map = [x["val_history"][-1] for x in ssd]
    map_name = next(k for k in dp_map[0] if k != "iteration")
    map_err = max(abs(m[map_name] - ref_map) for m in dp_map)
    if match_min < DIST_MATCH_MIN or score_err > DIST_SCORE_TOL:
        raise AssertionError(f"dist_dp ssd validation: matched {match_min}"
                             f" (min {DIST_MATCH_MIN}), score err "
                             f"{score_err} (tol {DIST_SCORE_TOL})")
    ssd_dp_ms = [stamps_ms(x["stamps"]) for x in ssd]
    k2 = sum(x["launches"]["fused_detection_output"] for x in ssd)
    emit("dist_dp", nvidia_smi=smi, world=DIST_WORLD,
         backend=ranks[0]["backend"], gloo_on_cuda=ranks[0]["probe"],
         ds2_losses=ds2[0]["losses"], ds2_loss_rel_err=ds2_loss_err,
         ds2_grad_rel_l2_max=ds2_grad_err,
         ds2_launches_by_rank=[x["launches"] for x in ds2],
         ds2_step_ms_by_rank=dp_ms, ds2_one_process_step_ms=one_ms,
         ds2_all_reduce_ms=ds2[0]["all_reduce_ms"],
         ds2_all_reduce_share=ds2[0]["all_reduce_ms"] / dp_ms[0],
         ds2_grad_bytes=4 * (ds2[0]["n_params"] + 1),
         ssd_losses=ssd[0]["losses"], ssd_loss_rel_err=ssd_loss_err,
         ssd_grad_rel_l2=ssd_grad_err, ssd_grad_rel_l2_worst_tensor=per_tensor,
         ssd_step_ms_by_rank=ssd_dp_ms,
         ssd_one_process_step_ms=ref["ssd_step_ms"],
         ssd_val_rows_vs_halves_err=halves_err,
         ssd_val_matched_min=match_min, ssd_val_matched_mean=match_mean,
         ssd_val_score_err=score_err,
         ssd_val_map=dp_map[0][map_name], ssd_one_process_map=ref_map,
         ssd_val_map_err=map_err,
         ssd_launches_by_rank=[x["launches"] for x in ssd],
         spawn_s=spawn_s, phase_s=time.perf_counter() - t_phase)
    return {"persistent_rnn": sum(x["launches"]["persistent_rnn"]
                                  for x in ds2),
            "persistent_rnn_bwd": sum(x["launches"]["persistent_rnn_bwd"]
                                      for x in ds2),
            "fused_detection_output": k2,
            "nms_sweep": sum(x["launches"]["nms_sweep"] for x in ssd + ds2)}


def dist_tp_phase(dev, smi, seed=37):
    """dist_tp: ``train_ssd(tp="megatron")`` and ``train_ds2(param_rules=
    default_tp_rules())`` on a ("data", "model") mesh of (1,
    DIST_TP_WORLD) over gloo, against the unsharded steps; then a world-1
    NCCL group."""
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.utils import engine

    t_phase = time.perf_counter()
    print(json.dumps({"phase": "dist_tp_choice", "world": DIST_TP_WORLD,
                      "backend": DIST_BACKEND, "collectives": DIST_NEEDS,
                      "why": "the sharded steps' collectives are these, "
                             "which dist_dp's probe found gloo takes on "
                             "CUDA tensors"}), flush=True)
    rng = np.random.RandomState(seed)
    ds2_batches = dist_ds2_batches(seed)[:DIST_TP_STEPS]
    ssd_train = [ssd_batch(rng, DIST_TP_SSD_BATCH)
                 for _ in range(DIST_TP_STEPS)]
    ssd_val = [ssd_batch(rng, DIST_SSD_VAL)]
    ranks = engine.spawn(os.path.abspath(__file__) + ":dist_child",
                         DIST_TP_WORLD, dict(task="tp",
                                             ds2_batches=ds2_batches,
                                             ssd_train=ssd_train,
                                             ssd_val=ssd_val, seed=seed),
                         timeout=DIST_TIMEOUT, backend=DIST_BACKEND,
                         local_ranks=[0] * DIST_TP_WORLD)
    ref = dist_reference(dev, ds2_batches, [ssd_train[0]], seed)
    ds2 = [r["ds2"] for r in ranks]
    ssd = [r["ssd"] for r in ranks]
    ds2_loss_err = check_losses("dist_tp ds2", ds2[0]["losses"][0],
                                ref["ds2_loss"])
    errs = grads_err({k: torch.from_numpy(v) for k, v in
                      ds2[0]["grads"].items()},
                     {k: torch.from_numpy(v) for k, v in
                      ref["ds2_grads"].items()})
    ds2_grad_err = max(errs.values())
    ssd_loss_err = check_losses("dist_tp ssd", ssd[0]["losses"][0],
                                ref["ssd_loss"])
    ssd_grad_err = vector_rel(ssd[0]["grads"], ref["ssd_grads"])
    if not (ds2_grad_err <= DIST_GRAD_TOL and ssd_grad_err <= DIST_GRAD_TOL):
        raise AssertionError(f"dist_tp: first-step gradients rel L2 ds2 "
                             f"{ds2_grad_err:.3g}, ssd {ssd_grad_err:.3g} "
                             f"(tol {DIST_GRAD_TOL})")
    want = 6 * DIST_TP_STEPS
    for r, x in enumerate(ds2):
        if (x["launches"]["persistent_rnn"] != want
                or x["launches"]["persistent_rnn_bwd"] != want
                or x["sharded_params"] == 0):
            raise AssertionError(f"dist_tp ds2 rank {r}: launches "
                                 f"{x['launches']}, sharded "
                                 f"{x['sharded_params']}")
    for r, x in enumerate(ssd):
        if x["launches"]["fused_detection_output"] < 1:
            raise AssertionError(f"dist_tp ssd rank {r}: {x['launches']}")
        if (len(x["detections"]) != 1
                or x["detections"][0].shape[0] != DIST_SSD_VAL):
            raise AssertionError(f"dist_tp ssd rank {r}: validated "
                                 f"{[d.shape for d in x['detections']]}")
    # the megatron validation: every rank's detections of all 8 images
    # against this process's of the gathered weights
    ref_dets, _, ref_map = one_process_validation(
        dev, ssd[0]["weights"], ssd_val)
    tp_match = [match_images(x["detections"][0], np.concatenate(ref_dets))
                for x in ssd]
    match_min = min(m[0] for m in tp_match)
    score_err = max(m[2] for m in tp_match)
    if match_min < DIST_MATCH_MIN or score_err > DIST_SCORE_TOL:
        raise AssertionError(f"dist_tp ssd validation: matched {match_min} "
                             f"(min {DIST_MATCH_MIN}), score err {score_err}"
                             f" (tol {DIST_SCORE_TOL})")
    ranks_diff = max(float(np.abs(x["detections"][0]
                                  - ssd[0]["detections"][0]).max())
                     for x in ssd)
    tp_map = [x["val_history"][-1] for x in ssd]
    map_name = next(k for k in tp_map[0] if k != "iteration")
    t0 = time.perf_counter()
    (nccl,) = engine.spawn(os.path.abspath(__file__) + ":dist_child", 1,
                           dict(task="nccl"), timeout=DIST_TIMEOUT)
    if nccl["backend"] != "nccl" or nccl["all_reduce"] != [0.0, 1.0, 2.0,
                                                           3.0]:
        raise AssertionError(f"dist_tp: world-1 NCCL gave {nccl}")
    nccl_s = time.perf_counter() - t0
    emit("dist_tp", nvidia_smi=smi, world=DIST_TP_WORLD,
         mesh={"data": 1, "model": DIST_TP_WORLD},
         backend=ranks[0]["backend"],
         ds2_losses=ds2[0]["losses"], ds2_loss_rel_err=ds2_loss_err,
         ds2_grad_rel_l2_max=ds2_grad_err,
         ds2_sharded_params=ds2[0]["sharded_params"],
         ds2_launches_by_rank=[x["launches"] for x in ds2],
         ds2_step_ms_by_rank=[stamps_ms(x["stamps"]) for x in ds2],
         ssd_losses=ssd[0]["losses"], ssd_loss_rel_err=ssd_loss_err,
         ssd_grad_rel_l2=ssd_grad_err,
         ssd_step_ms_by_rank=[stamps_ms(x["stamps"]) for x in ssd],
         ssd_one_process_step_ms=ref["ssd_step_ms"],
         ssd_val_matched_min=match_min,
         ssd_val_matched_mean=min(m[1] for m in tp_match),
         ssd_val_score_err=score_err, ssd_val_ranks_max_diff=ranks_diff,
         ssd_val_map=tp_map[0][map_name], ssd_one_process_map=ref_map,
         ssd_launches_by_rank=[x["launches"] for x in ssd],
         nccl_world1=nccl, nccl_s=nccl_s,
         phase_s=time.perf_counter() - t_phase)
    return {"persistent_rnn": sum(x["launches"]["persistent_rnn"]
                                  for x in ds2),
            "persistent_rnn_bwd": sum(x["launches"]["persistent_rnn_bwd"]
                                      for x in ds2),
            "fused_detection_output": sum(
                x["launches"]["fused_detection_output"] for x in ssd),
            "nms_sweep": sum(x["launches"]["nms_sweep"] for x in ssd + ds2),
            "analyze": [r["analyze"] for r in ranks]}


# ---------------------------------------------------------------------------
# 6o/6p. sequence, pipeline and expert parallelism over two ranks
# ---------------------------------------------------------------------------

# DS2 on a ("sequence",) mesh: the forward of 8 × 30 s, one 60 s
# utterance through the pipeline, 2 training steps of 8 × 1000 frames
# (fixed length: the time-sharded forward takes no n_frames)
SEQ_FRAMES, SEQ_UTT_S = 3000, 60
SEQ_TRAIN_FRAMES, SEQ_TRAIN_STEPS = 1000, 2
# the log-probs against one process's whole-T forward, max-abs (K3's
# fp32 tolerance); each gradient, relative L2 (K4's fp32 tolerance, as
# grads_err holds it); the first loss as DIST_LOSS_TOL holds it
SEQ_LOGP_TOL = 1e-4
SEQ_GRAD_TOL = 1e-3
# AttentionASR at the reference's defaults on 8 × 3000 frames; the
# pipeline at depth 2 over 2 stages; two experts, capacity factor 2 (the
# per-pair capacity then holds every token of a rank's block)
ATTN_KW = dict(dim=128, depth=4, num_heads=4, n_alphabet=29, n_mels=13,
               conv_channels=32)
ATTN_FRAMES = 3000
ATTN_PIPE_DEPTH, ATTN_PIPE_MICRO = 2, 4
ATTN_CAPACITY_FACTOR = 2.0
# the ring model's training steps on the (1, 2) ("data", "sequence")
# mesh (the encoder and head on a rank's T-block), and this process's
# whole steps: the first loss as DIST_LOSS_TOL holds it
ATTN_RING_STEPS = 3
# ring against full attention, the pipeline against the unpipelined
# model, the MoE against the dense path: log-probs max-abs (the step's
# loss as DIST_LOSS_TOL holds it)
ATTN_RING_TOL = 2e-5
ATTN_PIPE_TOL = 1e-5
ATTN_MOE_TOL = 1e-5


def seq_train_batches(seed):
    """SEQ_TRAIN_STEPS fixed-length batches of 8 utterances of at most
    10 s, featurized to SEQ_TRAIN_FRAMES frames, random labels."""
    import numpy as np

    from analytics_zoo_tpu_torch.pipelines.deepspeech2 import (
        load_asr_train_set)

    samples, lengths, labels = ds2_train_set(seed)
    short = np.nonzero(lengths <= 160 * SEQ_TRAIN_FRAMES - 400)[0]
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(SEQ_TRAIN_STEPS):
        pick = rng.choice(short, BATCH, replace=False)
        ds = load_asr_train_set(samples[pick], labels[pick],
                                batch_size=BATCH, shuffle=False,
                                utt_length=SEQ_TRAIN_FRAMES)
        out.append(next(iter(ds)))
    return out


class collective_clock:
    """``with collective_clock() as ms:`` — every ``all_to_all_single``,
    ``all_gather_into_tensor`` and ``all_reduce`` of this process (or the
    collectives ``names`` names) synchronized on both sides and its host
    ms appended to ``ms``."""

    NAMES = ("all_to_all_single", "all_gather_into_tensor", "all_reduce")

    def __init__(self, names=NAMES):
        self.names = names

    def __enter__(self):
        import torch
        import torch.distributed as dist

        self.ms, self.saved = [], {n: getattr(dist, n) for n in self.names}

        def timed(fn):
            def call(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                self.ms.append((time.perf_counter() - t0) * 1e3)
                return out
            return call

        for n, fn in self.saved.items():
            setattr(dist, n, timed(fn))
        return self.ms

    def __exit__(self, *exc):
        import torch.distributed as dist

        for n, fn in self.saved.items():
            setattr(dist, n, fn)


def peak_gb(fn):
    """``(fn(), the peak GB this process's allocator held while it ran,
    above what it held when ``fn`` began)``: tensors that earlier phases
    left alive do not count."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 1e9


def timed_ms(fn, reps: int = 1):
    """(the first result, the least host ms) of ``reps`` calls of
    ``fn()``, each between two synchronizes."""
    import torch

    out, best = None, float("inf")
    for i in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
        out = got if i == 0 else out
    return out, best


def dist_seq_rank(x, utt, batches, seed):
    """DS2 over a ("sequence",) mesh: the forward (its K3 launches, a
    second one timed), the pipeline's transcript, ``train_ds2`` with its
    first loss, gradients (rank 0), stamps and launches, then one more
    step with its collectives timed."""
    import torch
    import torch.distributed as dist

    from analytics_zoo_tpu_torch.models.deepspeech2 import (
        make_sequence_parallel_forward_fn, sequence_parallel_forward)
    from analytics_zoo_tpu_torch.parallel import (Adam, create_train_state,
                                                  make_train_step)
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    from analytics_zoo_tpu_torch.pipelines import deepspeech2 as ds2_pipe
    from analytics_zoo_tpu_torch.utils import engine

    probe = checked_probe()
    dev = engine.device()
    mesh = mesh_lib.create_mesh((DIST_WORLD,), ("sequence",))
    model = ds2_pipe.make_ds2_model(hidden=DS2_HIDDEN, n_rnn_layers=3,
                                    rnn_engine="pallas", device=dev,
                                    seed=seed)
    xd = torch.from_numpy(x).to(dev)
    out = {"probe": probe, "backend": dist.get_backend()}
    with torch.no_grad():
        zero_kernel_counters()
        logp = sequence_parallel_forward(model, xd, mesh)
        out["forward_launches"] = launch_counts()
        _, out["forward_ms"] = timed_ms(
            lambda: sequence_parallel_forward(model, xd, mesh), 3)
    out["logp"] = logp.cpu().numpy() if dist.get_rank() == 0 else None
    zero_kernel_counters()
    pipe = ds2_pipe.DeepSpeech2Pipeline(
        model, ds2_pipe.DS2Param(segment_seconds=SEQ_UTT_S, batch_size=1),
        sequence_mesh=mesh, device=dev)
    out["text"] = pipe.transcribe_samples({"u": utt})["u"]
    out["pipeline_launches"] = launch_counts()
    out["utt_length"] = pipe.utt_length
    tap = GradTap(batches, model)
    zero_kernel_counters()
    with recording_optimizer(ds2_pipe) as runs:
        ds2_pipe.train_ds2(model, tap, epochs=1, mesh=mesh,
                           sequence_parallel=True)
    torch.cuda.synchronize()
    out["train_launches"] = launch_counts()
    out["losses"] = [float(m["loss"]) for m in runs[0].history]
    out["grads"] = tap.grads if dist.get_rank() == 0 else None
    out["stamps"] = tap.stamps
    # one more step, every collective synchronized and timed
    optim = Adam(3e-4)
    step = make_train_step(
        model, ds2_pipe.ds2_ctc_criterion(blank_id=0), optim, mesh=mesh,
        forward_fn=make_sequence_parallel_forward_fn(model, mesh))
    state = create_train_state(model, optim)
    with collective_clock() as ms:
        _, out["clocked_step_ms"] = timed_ms(lambda: step(state, batches[0]))
    out["collective_ms"] = sum(ms)
    out["collective_calls"] = len(ms)
    del model, runs, step, state
    torch.cuda.empty_cache()
    return out


def route_recorder(expert_mod):
    """Patch ``expert_mod.route_top1`` to record each call's (expert id,
    slot) a token (-1 for a dropped token); returns (records, restore)."""
    import torch

    base, records = expert_mod.route_top1, []

    def route(x, gate_kernel, capacity, *earlier):
        dispatch, scale = base(x, gate_kernel, capacity, *earlier)
        kept = dispatch.sum((1, 2)) > 0
        ids = torch.where(kept, dispatch.sum(2).argmax(1), -1)
        slots = torch.where(kept, dispatch.sum(1).argmax(1), -1)
        records.append((ids.cpu().numpy(), slots.cpu().numpy()))
        return dispatch, scale

    expert_mod.route_top1 = route
    return records, lambda: setattr(expert_mod, "route_top1", base)


def attn_batch(seed):
    """8 × ATTN_FRAMES frames of features and random labels."""
    import numpy as np

    rng = np.random.RandomState(seed)
    labels = rng.randint(1, 29, (BATCH, 40)).astype(np.int32)
    return {"input": rng.randn(BATCH, ATTN_FRAMES, 13).astype(np.float32),
            "labels": labels,
            "label_mask": np.ones(labels.shape, np.float32)}


def dist_attn_rank(batch, seed):
    """AttentionASR three ways over two ranks: ring attention on (1, 2)
    ("data", "sequence") (a forward with its peak and collectives, then
    training steps), GPipe on ("pipe",) with one training step, and
    expert parallel MoE on ("expert",) with its routing recorded."""
    import torch
    import torch.distributed as dist

    from analytics_zoo_tpu_torch.models.attention import (
        AttentionASR, make_pipeline_forward_fn)
    from analytics_zoo_tpu_torch.parallel import (Adam, create_train_state,
                                                  expert, make_train_step)
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    from analytics_zoo_tpu_torch.parallel.sequence import RingAttentionLayer
    from analytics_zoo_tpu_torch.pipelines.deepspeech2 import (
        ds2_ctc_criterion)
    from analytics_zoo_tpu_torch.utils import engine

    probe = checked_probe()
    dev = engine.device()
    rank0 = dist.get_rank() == 0
    x = torch.from_numpy(batch["input"]).to(dev)
    out = {"probe": probe}
    zero_kernel_counters()
    mesh = mesh_lib.create_mesh((1, DIST_WORLD), ("data", "sequence"))
    model = AttentionASR(**ATTN_KW, attention_fn=RingAttentionLayer(mesh),
                         device=dev, seed=seed)
    with torch.no_grad():
        (ring, out["ring_ms"]), out["ring_peak_gb"] = peak_gb(
            lambda: timed_ms(lambda: model(x), 3))
        with collective_clock(("all_gather_into_tensor",)) as gathers, \
                collective_clock(("all_to_all_single",)) as hops:
            model(x)
    out["ring_forward_gathers"], out["ring_forward_hops"] = (len(gathers),
                                                            len(hops))
    out["ring"] = ring.cpu().numpy() if rank0 else None
    # the ring's training step: the first loss, the least ms of
    # ATTN_RING_STEPS steps and their peak
    optim = Adam(3e-4)
    step = make_train_step(model, ds2_ctc_criterion(blank_id=0), optim,
                           mesh=mesh)
    state = create_train_state(model, optim)
    ((_, metrics), out["ring_step_ms"]), out["ring_step_peak_gb"] = peak_gb(
        lambda: timed_ms(lambda: step(state, batch), ATTN_RING_STEPS))
    out["ring_loss"] = float(metrics["loss"])
    del step, state
    pmesh = mesh_lib.create_mesh((DIST_WORLD,), ("pipe",))
    pmodel = AttentionASR(**dict(ATTN_KW, depth=ATTN_PIPE_DEPTH),
                          device=dev, seed=seed)
    fwd = make_pipeline_forward_fn(pmodel, pmesh, n_micro=ATTN_PIPE_MICRO)
    with torch.no_grad():
        piped, out["pipe_ms"] = timed_ms(lambda: fwd(pmodel, x, False), 3)
    out["pipe"] = piped.cpu().numpy() if rank0 else None
    # the first step's loss; the least time of it and two more steps
    optim = Adam(3e-4)
    step = make_train_step(pmodel, ds2_ctc_criterion(blank_id=0), optim,
                           mesh=pmesh, forward_fn=fwd)
    state = create_train_state(pmodel, optim)
    (_, metrics), out["pipe_step_ms"] = timed_ms(lambda: step(state, batch),
                                                 3)
    out["pipe_loss"] = float(metrics["loss"])
    emesh = mesh_lib.create_mesh((DIST_WORLD,), ("expert",))
    mmodel = AttentionASR(**ATTN_KW, n_experts=DIST_WORLD,
                          expert_mesh=emesh,
                          capacity_factor=ATTN_CAPACITY_FACTOR, device=dev,
                          seed=seed)
    records, restore = route_recorder(expert)
    try:
        with torch.no_grad():
            moe = mmodel(x)
    finally:
        restore()
    with torch.no_grad():
        _, out["moe_ms"] = timed_ms(lambda: mmodel(x), 2)
    out["moe"] = moe.cpu().numpy() if rank0 else None
    out["routes"] = records
    out["launches"] = launch_counts()
    del model, pmodel, mmodel, step
    torch.cuda.empty_cache()
    return out


def dist_seq_phase(dev, smi, seed=41):
    """dist_seq: DS2 time-sharded over DIST_WORLD ranks on the one card
    (gloo), against this process's whole-T forward, transcript and
    training."""
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.pipelines import deepspeech2 as ds2_pipe
    from analytics_zoo_tpu_torch.utils import engine

    t_phase = time.perf_counter()
    rng = np.random.RandomState(seed)
    x = rng.randn(BATCH, SEQ_FRAMES, 13).astype(np.float32)
    utt = synthetic_utterances((SEQ_UTT_S,), seed)["utt0"]
    batches = seq_train_batches(seed)
    t0 = time.perf_counter()
    ranks = engine.spawn(os.path.abspath(__file__) + ":dist_child",
                         DIST_WORLD, dict(task="seq", x=x, utt=utt,
                                          batches=batches, seed=seed),
                         timeout=DIST_TIMEOUT, backend=DIST_BACKEND,
                         local_ranks=[0] * DIST_WORLD)
    spawn_s = time.perf_counter() - t0
    print(json.dumps({"phase": "dist_seq_probe",
                      "gloo_on_cuda": ranks[0]["probe"],
                      "backend": ranks[0]["backend"]}), flush=True)
    # this process: the whole-T forward, the transcript, the training
    model = ds2_pipe.make_ds2_model(hidden=DS2_HIDDEN, n_rnn_layers=3,
                                    rnn_engine="pallas", device=dev,
                                    seed=seed)
    xd = torch.from_numpy(x).to(dev)
    with torch.no_grad():
        want, one_fwd_ms = timed_ms(lambda: model(xd), 4)
    want = want.cpu().numpy()
    one_text = ds2_pipe.DeepSpeech2Pipeline(
        model, ds2_pipe.DS2Param(segment_seconds=SEQ_UTT_S, batch_size=1),
        device=dev).transcribe_samples({"u": utt})["u"]
    tap = GradTap(batches, model)
    with recording_optimizer(ds2_pipe) as runs:
        ds2_pipe.train_ds2(model, tap, epochs=1)
    one_losses = [float(m["loss"]) for m in runs[0].history]
    del model, runs
    torch.cuda.empty_cache()
    logp_err = float(np.abs(ranks[0]["logp"] - want).max())
    if not logp_err <= SEQ_LOGP_TOL:
        raise AssertionError(f"dist_seq: log-probs max-abs {logp_err:.3g} "
                             f"(tol {SEQ_LOGP_TOL})")
    want_k3 = 6
    for r, x_r in enumerate(ranks):
        got = x_r["forward_launches"]
        if got["persistent_rnn"] != want_k3 or got["persistent_rnn_bwd"]:
            raise AssertionError(f"dist_seq rank {r}: the forward launched "
                                 f"{got}, want {want_k3} K3 and no K4")
        got = x_r["pipeline_launches"]
        if got["persistent_rnn"] != want_k3:
            raise AssertionError(f"dist_seq rank {r}: the pipeline's one "
                                 f"batch launched {got}")
        got = x_r["train_launches"]
        if (got["persistent_rnn"] != 6 * SEQ_TRAIN_STEPS
                or got["persistent_rnn_bwd"] != 6 * SEQ_TRAIN_STEPS):
            raise AssertionError(f"dist_seq rank {r}: training launched "
                                 f"{got}, want {6 * SEQ_TRAIN_STEPS} K3 and "
                                 f"K4")
        if x_r["text"] != one_text:
            raise AssertionError(f"dist_seq rank {r}: transcript differs "
                                 f"from one process's: {x_r['text']!r} vs "
                                 f"{one_text!r}")
        if x_r["losses"] != ranks[0]["losses"]:
            raise AssertionError(f"dist_seq: the ranks' losses differ "
                                 f"{[y['losses'] for y in ranks]}")
    loss_err = check_losses("dist_seq ds2", ranks[0]["losses"][0],
                            one_losses[0])
    errs = grads_err({k: torch.from_numpy(v) for k, v in
                      ranks[0]["grads"].items()},
                     {k: torch.from_numpy(v) for k, v in tap.grads.items()})
    worst = max(errs, key=errs.get)
    if not errs[worst] <= SEQ_GRAD_TOL:
        raise AssertionError(f"dist_seq: first-step gradient {worst} rel L2 "
                             f"{errs[worst]:.3g} (tol {SEQ_GRAD_TOL})")
    step_ms = [stamps_ms(x_r["stamps"]) for x_r in ranks]
    emit("dist_seq", nvidia_smi=smi, world=DIST_WORLD,
         mesh={"sequence": DIST_WORLD}, frames=SEQ_FRAMES,
         logp_max_abs_err=logp_err,
         forward_launches_by_rank=[x_r["forward_launches"] for x_r in ranks],
         forward_ms_by_rank=[x_r["forward_ms"] for x_r in ranks],
         one_process_forward_ms=one_fwd_ms,
         pipeline_utt_length=ranks[0]["utt_length"],
         transcript_equal=True, transcript_chars=len(one_text),
         losses=ranks[0]["losses"], one_process_losses=one_losses,
         loss_rel_err=loss_err, grad_rel_l2_max=errs[worst],
         grad_worst_tensor=worst,
         train_launches_by_rank=[x_r["train_launches"] for x_r in ranks],
         step_ms_by_rank=step_ms,
         one_process_step_ms=stamps_ms(tap.stamps),
         clocked_step_ms_by_rank=[x_r["clocked_step_ms"] for x_r in ranks],
         collective_ms_by_rank=[x_r["collective_ms"] for x_r in ranks],
         collective_share_by_rank=[x_r["collective_ms"] / x_r[
             "clocked_step_ms"] for x_r in ranks],
         collective_calls=ranks[0]["collective_calls"],
         spawn_s=spawn_s, phase_s=time.perf_counter() - t_phase)
    return {name: sum(x_r[k][name] for x_r in ranks
                      for k in ("forward_launches", "pipeline_launches",
                                "train_launches"))
            for name in ranks[0]["train_launches"]}


def routes_equal(dense, ep_by_rank):
    """Each MoE call's dense routing against the expert-parallel ranks':
    a token's expert equal, and its slot the rank-local slot plus the
    tokens of earlier senders that chose the same expert."""
    import numpy as np

    for call, (ids, slots) in enumerate(dense):
        parts = [ranks[call] for ranks in ep_by_rank]
        if not np.array_equal(ids, np.concatenate([p[0] for p in parts])):
            return False
        offset = np.zeros(ids.max() + 2, np.int64)
        want = []
        for p_ids, p_slots in parts:
            want.append(np.where(p_ids >= 0, p_slots + offset[p_ids], -1))
            offset += np.bincount(p_ids[p_ids >= 0],
                                  minlength=offset.size)[:offset.size]
        if not np.array_equal(slots, np.concatenate(want)):
            return False
    return True


def dist_attn_phase(dev, smi, seed=43):
    """dist_attn: AttentionASR's ring attention, GPipe and expert-parallel
    MoE over DIST_WORLD ranks on the one card, against this process's
    full, unpipelined and dense runs."""
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.models.attention import AttentionASR
    from analytics_zoo_tpu_torch.parallel import (Adam, create_train_state,
                                                  expert, make_train_step)
    from analytics_zoo_tpu_torch.pipelines.deepspeech2 import (
        ds2_ctc_criterion)
    from analytics_zoo_tpu_torch.utils import engine

    t_phase = time.perf_counter()
    batch = attn_batch(seed)
    t0 = time.perf_counter()
    ranks = engine.spawn(os.path.abspath(__file__) + ":dist_child",
                         DIST_WORLD, dict(task="attn", batch=batch,
                                          seed=seed),
                         timeout=DIST_TIMEOUT, backend=DIST_BACKEND,
                         local_ranks=[0] * DIST_WORLD)
    spawn_s = time.perf_counter() - t0
    print(json.dumps({"phase": "dist_attn_probe",
                      "gloo_on_cuda": ranks[0]["probe"]}), flush=True)
    x = torch.from_numpy(batch["input"]).to(dev)
    zero_kernel_counters()
    with torch.no_grad():
        model = AttentionASR(**ATTN_KW, device=dev, seed=seed)
        (full, full_ms), full_peak = peak_gb(
            lambda: timed_ms(lambda: model(x), 3))
    optim = Adam(3e-4)
    step = make_train_step(model, ds2_ctc_criterion(blank_id=0), optim)
    state = create_train_state(model, optim)
    ((_, metrics), full_step_ms), full_step_peak = peak_gb(
        lambda: timed_ms(lambda: step(state, batch), ATTN_RING_STEPS))
    full_loss = float(metrics["loss"])
    no_kernel_launches("dist_attn one-process steps")
    del step, state
    with torch.no_grad():
        pmodel = AttentionASR(**dict(ATTN_KW, depth=ATTN_PIPE_DEPTH),
                              device=dev, seed=seed)
        plain, plain_ms = timed_ms(lambda: pmodel(x), 3)
        mmodel = AttentionASR(**ATTN_KW, n_experts=DIST_WORLD,
                              capacity_factor=ATTN_CAPACITY_FACTOR,
                              device=dev, seed=seed)
        records, restore = route_recorder(expert)
        try:
            dense = mmodel(x)
        finally:
            restore()
        _, dense_ms = timed_ms(lambda: mmodel(x), 2)
    optim = Adam(3e-4)
    step = make_train_step(pmodel, ds2_ctc_criterion(blank_id=0), optim)
    state = create_train_state(pmodel, optim)
    (_, metrics), one_step_ms = timed_ms(lambda: step(state, batch), 3)
    one_loss = float(metrics["loss"])
    errs = {"ring": float(np.abs(ranks[0]["ring"] - full.cpu().numpy())
                          .max()),
            "pipe": float(np.abs(ranks[0]["pipe"] - plain.cpu().numpy())
                          .max()),
            "moe": float(np.abs(ranks[0]["moe"] - dense.cpu().numpy())
                         .max())}
    del model, pmodel, mmodel, step
    torch.cuda.empty_cache()
    tols = {"ring": ATTN_RING_TOL, "pipe": ATTN_PIPE_TOL,
            "moe": ATTN_MOE_TOL}
    for k, tol in tols.items():
        if not errs[k] <= tol:
            raise AssertionError(f"dist_attn {k}: log-probs max-abs "
                                 f"{errs[k]:.3g} (tol {tol})")
    loss_err = check_losses("dist_attn pipe", ranks[0]["pipe_loss"],
                            one_loss)
    if any(r["pipe_loss"] != ranks[0]["pipe_loss"] for r in ranks):
        raise AssertionError("dist_attn pipe: the ranks' losses differ")
    ring_loss_err = check_losses("dist_attn ring step",
                                 ranks[0]["ring_loss"], full_loss)
    if any(r["ring_loss"] != ranks[0]["ring_loss"] for r in ranks):
        raise AssertionError("dist_attn ring step: the ranks' losses "
                             "differ")
    hops = ATTN_KW["depth"] * (DIST_WORLD - 1)
    for r, x_r in enumerate(ranks):
        if (x_r["ring_forward_gathers"], x_r["ring_forward_hops"]) != (1,
                                                                       hops):
            raise AssertionError(
                f"dist_attn rank {r}: the ring forward ran "
                f"{x_r['ring_forward_gathers']} gathers and "
                f"{x_r['ring_forward_hops']} hops, want 1 (the exit's) and "
                f"{hops}")
    routed = routes_equal(records, [r["routes"] for r in ranks])
    if not routed or len(records) != ATTN_KW["depth"]:
        raise AssertionError(f"dist_attn moe: routing differs from the "
                             f"dense path's ({len(records)} calls)")
    dropped = int(sum((ids < 0).sum() for ids, _ in records))
    for r, x_r in enumerate(ranks):
        if any(x_r["launches"].values()):
            raise AssertionError(f"dist_attn rank {r}: launched "
                                 f"{x_r['launches']}")
    emit("dist_attn", nvidia_smi=smi, world=DIST_WORLD, frames=ATTN_FRAMES,
         model=ATTN_KW, ring_max_abs_err=errs["ring"],
         ring_ms_by_rank=[r["ring_ms"] for r in ranks],
         ring_peak_gb_by_rank=[r["ring_peak_gb"] for r in ranks],
         one_process_full_ms=full_ms, one_process_full_peak_gb=full_peak,
         ring_forward_gathers=ranks[0]["ring_forward_gathers"],
         ring_forward_hops=ranks[0]["ring_forward_hops"],
         ring_steps=ATTN_RING_STEPS, ring_loss=ranks[0]["ring_loss"],
         one_process_full_loss=full_loss, ring_loss_rel_err=ring_loss_err,
         ring_step_ms_by_rank=[r["ring_step_ms"] for r in ranks],
         ring_step_peak_gb_by_rank=[r["ring_step_peak_gb"] for r in ranks],
         one_process_full_step_ms=full_step_ms,
         one_process_full_step_peak_gb=full_step_peak,
         pipe_depth=ATTN_PIPE_DEPTH, pipe_micro=ATTN_PIPE_MICRO,
         pipe_max_abs_err=errs["pipe"],
         pipe_ms_by_rank=[r["pipe_ms"] for r in ranks],
         one_process_unpipelined_ms=plain_ms,
         pipe_loss=ranks[0]["pipe_loss"], one_process_loss=one_loss,
         pipe_loss_rel_err=loss_err,
         pipe_step_ms_by_rank=[r["pipe_step_ms"] for r in ranks],
         one_process_step_ms=one_step_ms,
         moe_experts=DIST_WORLD, moe_capacity_factor=ATTN_CAPACITY_FACTOR,
         moe_routing_equal=True, moe_calls=len(records),
         moe_dropped_tokens=dropped, moe_max_abs_err=errs["moe"],
         moe_ms_by_rank=[r["moe_ms"] for r in ranks],
         one_process_dense_ms=dense_ms,
         launches_by_rank=[r["launches"] for r in ranks],
         spawn_s=spawn_s, phase_s=time.perf_counter() - t_phase)
    return {name: sum(r["launches"][name] for r in ranks)
            for name in ranks[0]["launches"]}

# ---------------------------------------------------------------------------
# 6r/6s. SSD over a mesh: spatial training, sharded serving, two ranks
# ---------------------------------------------------------------------------

# train_ssd(tp="spatial") on a ("data", "model") mesh of (1, 2): the image
# rows over the two ranks, SSD300 at batch 32, fp32, 2 steps, a validation
# of 8 through K2 on every rank; the first step's loss and gradients as
# dist_tp holds megatron's (DIST_LOSS_TOL, DIST_GRAD_TOL), each rank's
# validation rows against this process's: at least SPATIAL_MATCH_MIN
# matched a image, the scores within DIST_SCORE_TOL
SPATIAL_SSD_BATCH, SPATIAL_STEPS, SPATIAL_VAL = 32, 2, 8
SPATIAL_MATCH_MIN = 0.995
# the steps' learning rate: at TrainParams' 0.0035 two steps from random
# weights saturate the scores (every kept score >= 0.9958 in a CPU
# rehearsal at batch 2) and blow up the loc logits, so that a logit
# perturbation of 1e-6 moves decoded boxes by up to 4e-3 and the
# validation would measure the conditioning of a diverged model
SPATIAL_LR = 1e-4
# the validation's logits on each rank against this process's forward of
# the same weights, max-abs over the largest: each layer convolves a
# block of rows (cuDNN may pick another algorithm for it); two steps at
# TrainParams' lr make the weights jumpy, so this is the 1e-4 that
# tests/test_torch_ssd_train.py holds such steps to.  The rows: each
# rank's K2 rows EQUAL to the plain version on its own logits; against
# this process's validation, SPATIAL_MATCH_MIN of the rows scored more
# than DIST_SCORE_TOL above their image's keep_topk cut matched
# (settled_share: on random weights many scores tie near the cut, and a
# logit perturbation of 1e-6 reorders them there), the whole rows'
# shares printed
SPATIAL_LOGIT_TOL = 1e-4
# sharded serving on a ("data",) mesh of 2: SSD300 batch 8 (K2 on each
# rank's 4 rows), DS2 8 × 30 s (K3 six times a rank), then SERVE_REQUESTS
# SSD requests through ServingRuntime(specs=) with the follower and one
# hot swap; the rows EQUAL (rows_err) to this process's of the same
# halves, and against the whole batch matched as DIST_MATCH_MIN; the DS2
# log-probs within DS2_LOGP_TOL of this process's halves, the transcripts
# EQUAL
SERVE_DS2_FRAMES = 3000
SERVE_REQUESTS = 64


def dist_spatial_rank(train, val):
    """``train_ssd(tp="spatial")`` (fp32) on (1, DIST_TP_WORLD): losses,
    the first step's gradients and trained weights (rank 0), the
    validation rows, launches, stamps; then one more step with its row
    fetches (every ``all_to_all_single``, forward and backward) and all
    its collectives timed."""
    import torch
    import torch.distributed as dist

    from analytics_zoo_tpu_torch.models.ssd import (SSDVgg, build_priors,
                                                    config_for)
    from analytics_zoo_tpu_torch.ops.multibox_loss import (MultiBoxLoss,
                                                           MultiBoxLossParam)
    from analytics_zoo_tpu_torch.parallel import (SGD, create_train_state,
                                                  make_train_step)
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    from analytics_zoo_tpu_torch.parallel.specs import (SpecSet,
                                                        pipeline_specs)
    from analytics_zoo_tpu_torch.pipelines import ssd as ssd_pipe
    from analytics_zoo_tpu_torch.utils import engine

    mesh = mesh_lib.create_mesh((1, DIST_TP_WORLD), ("data", "model"))
    model = SSDVgg(21, 300, device=engine.device(), seed=0)
    tap = GradTap(train, model, SpecSet(mesh))
    params = ssd_pipe.TrainParams(max_epoch=1, compute_dtype=None,
                                  prefetch=0, learning_rate=SPATIAL_LR)
    opt, seen, launches, seconds = recorded_train_ssd(
        tap, val, params, model, mesh=mesh, tp="spatial")
    rank0 = dist.get_rank() == 0
    out = {"losses": [float(m["loss"]) for m in opt.history],
           "grads": tap.grads if rank0 else None,
           "weights": SpecSet(mesh).gather(model) if rank0 else None,
           "detections": [d.numpy() for _, _, d in seen],
           "validation": [tuple(t.numpy() for t in v) for v in seen],
           "val_history": opt.val_history, "launches": launches,
           "stamps": tap.stamps, "seconds": seconds}
    specs = pipeline_specs("ssd", mesh=mesh, tp="spatial")
    out["rows"] = int(specs.place_batch(train[0])["input"].shape[1])
    priors, variances = build_priors(config_for(300))
    crit = MultiBoxLoss(priors, variances, MultiBoxLossParam(n_classes=21))
    step = make_train_step(model, crit, SGD(1e-3, momentum=0.9),
                           skip_loss_above=50.0, specs=specs)
    state = create_train_state(model, SGD(1e-3, momentum=0.9))
    with collective_clock(("all_to_all_single",)) as fetch_ms:
        _, out["fetch_clocked_step_ms"] = timed_ms(
            lambda: step(state, train[0]))
    with collective_clock() as all_ms:
        _, out["clocked_step_ms"] = timed_ms(lambda: step(state, train[0]))
    out["fetch_ms"], out["fetch_calls"] = sum(fetch_ms), len(fetch_ms)
    out["collective_ms"], out["collective_calls"] = sum(all_ms), len(all_ms)
    del model, opt, step, state
    torch.cuda.empty_cache()
    return out


def one_process_logits(dev, weights, batch):
    """(loc, probs) of ``batch`` by this process's SSD300 on ``weights``."""
    import torch

    from analytics_zoo_tpu_torch.models.ssd import SSDVgg
    from analytics_zoo_tpu_torch.parallel import make_eval_step

    model = SSDVgg(21, 300, device=dev, seed=0)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           weights.items()})
    loc, conf = make_eval_step(model.eval())(
        torch.from_numpy(batch["input"]).to(dev))
    return (loc.cpu().numpy(), torch.softmax(conf, -1).cpu().numpy())


def plain_detections(dev, loc, probs):
    """K2's plain version on the given logits, on the card."""
    import torch

    from analytics_zoo_tpu_torch.models.ssd import build_priors, config_for
    from analytics_zoo_tpu_torch.ops import pallas_detout
    from analytics_zoo_tpu_torch.ops.detection_output import (
        DetectionOutputParam)

    pri, var = (torch.from_numpy(a).to(dev)
                for a in build_priors(config_for(300)))
    return pallas_detout.fused_detection_output_plain(
        torch.from_numpy(loc).to(dev), torch.from_numpy(probs).to(dev),
        pri, var, DetectionOutputParam(n_classes=21))


def dist_spatial_phase(dev, smi, seed=53):
    """dist_spatial: ``train_ssd(tp="spatial")`` on a ("data", "model")
    mesh of (1, DIST_TP_WORLD) over gloo, against the unsharded step and
    validation."""
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.models.ssd import (SSDVgg, build_priors,
                                                    config_for)
    from analytics_zoo_tpu_torch.ops.multibox_loss import (MultiBoxLoss,
                                                           MultiBoxLossParam)
    from analytics_zoo_tpu_torch.parallel import (SGD, create_train_state,
                                                  make_train_step)
    from analytics_zoo_tpu_torch.utils import engine

    t_phase = time.perf_counter()
    rng = np.random.RandomState(seed)
    train = [ssd_batch(rng, SPATIAL_SSD_BATCH) for _ in range(SPATIAL_STEPS)]
    val = [ssd_batch(rng, SPATIAL_VAL)]
    ranks = engine.spawn(os.path.abspath(__file__) + ":dist_child",
                         DIST_TP_WORLD, dict(task="spatial", train=train,
                                             val=val),
                         timeout=DIST_TIMEOUT, backend=DIST_BACKEND,
                         local_ranks=[0] * DIST_TP_WORLD)
    # this process: the first step's loss and gradients, a second step
    # timed
    priors, variances = build_priors(config_for(300))
    crit = MultiBoxLoss(priors, variances, MultiBoxLossParam(n_classes=21))
    model = SSDVgg(21, 300, device=dev, seed=0)
    step = make_train_step(model, crit, SGD(1e-3, momentum=0.9),
                           skip_loss_above=50.0)
    state = create_train_state(model, SGD(1e-3, momentum=0.9))
    state, m = step(state, train[0])
    ref_loss, ref_grads = m["loss"].item(), tap_grads(model)
    _, ref_step_ms = timed_ms(lambda: step(state, train[0]))
    del model, step, state
    torch.cuda.empty_cache()
    loss_err = check_losses("dist_spatial", ranks[0]["losses"][0], ref_loss)
    grad_err = vector_rel(ranks[0]["grads"], ref_grads)
    if not grad_err <= DIST_GRAD_TOL:
        raise AssertionError(f"dist_spatial: first-step gradients rel L2 "
                             f"{grad_err:.3g} (tol {DIST_GRAD_TOL})")
    for r, x in enumerate(ranks):
        if x["losses"] != ranks[0]["losses"]:
            raise AssertionError(f"dist_spatial rank {r}: losses "
                                 f"{x['losses']} against rank 0's "
                                 f"{ranks[0]['losses']}")
        if (x["launches"]["fused_detection_output"] < 1
                or x["launches"]["nms_sweep"]
                or len(x["detections"]) != 1
                or x["detections"][0].shape[0] != SPATIAL_VAL):
            raise AssertionError(f"dist_spatial rank {r}: launches "
                                 f"{x['launches']}, validated "
                                 f"{[d.shape for d in x['detections']]}")
    ref_dets, _, ref_map = one_process_validation(dev, ranks[0]["weights"],
                                                  val)
    # the logits each rank's K2 read against this process's forward of the
    # same weights, and K2's rows against its plain version on them
    ref_logits = one_process_logits(dev, ranks[0]["weights"], val[0])
    logit_err, k2_err = 0.0, 0.0
    for x in ranks:
        (loc, probs, dets), = x["validation"]
        for got, want in ((loc, ref_logits[0]), (probs, ref_logits[1])):
            logit_err = max(logit_err, float(
                np.abs(got - want).max() / np.abs(want).max()))
        k2_err = max(k2_err, rows_err(torch.from_numpy(dets),
                                      plain_detections(dev, loc, probs)))
    want = np.concatenate(ref_dets)
    match = [match_images(x["detections"][0], want) for x in ranks]
    match_min = min(m[0] for m in match)
    match_mean = min(m[1] for m in match)
    score_err = max(m[2] for m in match)
    settled = min(settled_share(x["detections"][0], want, DIST_SCORE_TOL)
                  for x in ranks)
    if (not logit_err <= SPATIAL_LOGIT_TOL or settled < SPATIAL_MATCH_MIN
            or score_err > DIST_SCORE_TOL):
        raise AssertionError(f"dist_spatial validation: logits rel "
                             f"{logit_err:.3g} (tol {SPATIAL_LOGIT_TOL}), "
                             f"settled rows matched {settled} (min "
                             f"{SPATIAL_MATCH_MIN}), all rows min "
                             f"{match_min}, mean {match_mean}, score err "
                             f"{score_err} (tol {DIST_SCORE_TOL})")
    sp_map = ranks[0]["val_history"][-1]
    map_name = next(k for k in sp_map if k != "iteration")
    emit("dist_spatial", nvidia_smi=smi, world=DIST_TP_WORLD,
         mesh={"data": 1, "model": DIST_TP_WORLD},
         rows_by_rank=[x["rows"] for x in ranks],
         losses=ranks[0]["losses"], loss_rel_err=loss_err,
         grad_rel_l2=grad_err,
         step_ms_by_rank=[stamps_ms(x["stamps"]) for x in ranks],
         one_process_step_ms=ref_step_ms,
         fetch_ms_by_rank=[x["fetch_ms"] for x in ranks],
         fetch_calls=ranks[0]["fetch_calls"],
         fetch_share_by_rank=[x["fetch_ms"] / x["fetch_clocked_step_ms"]
                              for x in ranks],
         fetch_clocked_step_ms_by_rank=[x["fetch_clocked_step_ms"]
                                        for x in ranks],
         collective_ms_by_rank=[x["collective_ms"] for x in ranks],
         collective_calls=ranks[0]["collective_calls"],
         collective_share_by_rank=[x["collective_ms"] / x["clocked_step_ms"]
                                   for x in ranks],
         val_logits_rel_err=logit_err, val_k2_rows_err_vs_plain=k2_err,
         val_settled_matched=settled,
         val_matched_min=match_min, val_matched_mean=match_mean,
         val_score_err=score_err, val_map=sp_map[map_name],
         one_process_map=ref_map,
         launches_by_rank=[x["launches"] for x in ranks],
         phase_s=time.perf_counter() - t_phase)
    return {k: sum(x["launches"][k] for x in ranks)
            for k in ranks[0]["launches"]}


def dist_serve_rank(ssd_input, ssd_info, ds2_x, ds2_n, requests, seed):
    """Sharded serving on a ("data",) mesh of DIST_WORLD: SSD300's
    ``detect_batch`` and DS2's log-probs and greedy transcripts, each
    with its launches; then rank 0 serves ``requests`` through
    ``ServingRuntime(specs=)`` over ``ssd_serving_tiers(specs=)`` with a
    hot swap half-way, the others ``serve_follower``."""
    import shutil
    import statistics
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from analytics_zoo_tpu_torch.models.ssd import SSDVgg
    from analytics_zoo_tpu_torch.parallel import checkpoint as ckpt
    from analytics_zoo_tpu_torch.parallel import make_eval_step
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    from analytics_zoo_tpu_torch.parallel.specs import pipeline_specs
    from analytics_zoo_tpu_torch.pipelines import deepspeech2 as ds2_pipe
    from analytics_zoo_tpu_torch.pipelines.ssd import (PreProcessParam,
                                                       SSDPredictor,
                                                       ssd_serving_tiers)
    from analytics_zoo_tpu_torch.serving import (ModelConfig,
                                                 MonotonicClock,
                                                 ServingRuntime)
    from analytics_zoo_tpu_torch.serving.follower import serve_follower
    from analytics_zoo_tpu_torch.utils import engine

    dev = engine.device()
    mesh = mesh_lib.create_mesh((DIST_WORLD,), ("data",))
    lead = dist.get_rank() == 0
    out = {"backend": dist.get_backend()}
    param = PreProcessParam(batch_size=BATCH, resolution=300)
    ssd_specs = pipeline_specs("ssd", mesh=mesh)
    # -- SSD300 detect_batch: K2 on this rank's rows ----------------------
    pred = SSDPredictor(SSDVgg(21, 300, device=dev, seed=0), param,
                        specs=ssd_specs, device=dev)
    batch = {"input": ssd_input, "im_info": ssd_info}
    pred.detect_batch(batch)                # cuDNN's choice, K2 warm
    torch.cuda.synchronize()
    zero_kernel_counters()
    out["ssd_rows"], out["ssd_ms"] = timed_ms(
        lambda: pred.detect_batch(batch))
    out["ssd_launches"] = launch_counts()
    del pred
    out["gather_ms"] = guarded_gather_ms(mesh, seed)
    # -- DS2 8 × 30 s: K3 on this rank's rows -----------------------------
    model = ds2_pipe.make_ds2_model(hidden=DS2_HIDDEN, n_rnn_layers=3,
                                    rnn_engine="pallas", device=dev,
                                    seed=seed)
    ds2_specs = pipeline_specs("ds2", mesh=mesh)
    ds2_specs.place_state(model)
    eval_step = make_eval_step(model, specs=ds2_specs)
    args = (torch.from_numpy(ds2_x).to(dev), torch.from_numpy(ds2_n).to(dev))
    zero_kernel_counters()
    logp = eval_step(args)
    torch.cuda.synchronize()
    out["ds2_launches"] = launch_counts()
    _, out["ds2_ms"] = timed_ms(lambda: eval_step(args), 3)
    out["ds2_logp"] = logp.cpu().numpy() if lead else None
    (greedy,) = ds2_pipe.ds2_serving_tiers(
        model, ds2_pipe.DS2Param(decoder="greedy"), specs=ds2_specs,
        device=dev)
    out["ds2_texts"] = greedy.forward({"input": ds2_x, "n_frames": ds2_n})
    del model, eval_step, greedy, logp
    torch.cuda.empty_cache()
    # -- SSD requests through ServingRuntime(specs=), a hot swap ----------
    warm = np.stack(requests[:BATCH])

    def weights_to_tiers(state, rid):
        m = SSDVgg(21, 300, device=dev, seed=0)
        m.load_state_dict(state)
        tiers = ssd_serving_tiers(m, param, specs=ssd_specs, device=dev)
        return tiers

    tiers0 = ssd_serving_tiers(SSDVgg(21, 300, device=dev, seed=0), param,
                               specs=ssd_specs, device=dev)
    for t in tiers0:                  # cuDNN's choice on each rank
        t.forward({"input": warm})
    cfg = ModelConfig(name="ssd", tiers=tiers0,
                      weights_to_tiers=weights_to_tiers, length_key=None,
                      max_batch=BATCH, default_deadline_s=3600.0)
    torch.cuda.synchronize()
    zero_kernel_counters()
    if not lead:
        out["follower"] = serve_follower(ssd_specs, models=[cfg],
                                         device=dev)
        torch.cuda.synchronize()
        out["runtime_launches"] = launch_counts()
        return out
    root = tempfile.mkdtemp()
    try:
        snap = ckpt.save(os.path.join(root, "ssd"),
                         SSDVgg(21, 300, device=dev, seed=1).state_dict(),
                         step=1)
        rt = ServingRuntime(models=[cfg], n_replicas=2, max_batch=BATCH,
                            queue_capacity=4 * len(requests),
                            default_deadline_s=3600.0, specs=ssd_specs,
                            clock=MonotonicClock())
        reqs = []
        half = len(requests) // 2
        t0 = time.perf_counter()
        for k, x in enumerate(requests):
            if k == half:
                rt.hot_swap(snap, canary_fraction=0.0, device=dev)
            reqs.append(rt.submit({"input": x}, model="ssd"))
            if len(reqs) % BATCH == 0:
                rt.pump(force=True)
        rt.drain()
        for _ in range(10):
            rt.pump(force=True)
            if not rt.swap_active:
                break
        out["runtime_s"] = time.perf_counter() - t0
        rt.close()
        torch.cuda.synchronize()
        out["runtime_launches"] = launch_counts()
        lat = sorted((r.completed_t - r.arrival_t) * 1e3 for r in reqs)
        out["latency_ms"] = {"p50": statistics.median(lat),
                             "p99": lat[min(len(lat) - 1,
                                            int(0.99 * len(lat)))]}
        out["rows"] = [np.asarray(r.result) if r.result is not None
                       else None for r in reqs]
        out["accounting"] = rt.accounting()
        out["failed"] = rt.snapshot()["metrics"]["failed"]
        out["swap"] = rt.snapshot()["swap"]
        out["mesh"] = rt.snapshot()["mesh"]
        out["installed"] = [e["replica"] for e in rt.pool.events
                            if e["kind"] == "swap_installed"]
        out["swap_at"] = half
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def guarded_gather_ms(mesh, seed):
    """The sharded calls' guarded gather (``gather_rows_guarded``: a
    header of each rank's failure flag and byte count, then the outputs'
    bytes in one gather) against a gather per output, on this rank's
    rows of SSD300's two sharded programs at BATCH: K2's detections
    (rows, 200, 6) and the eval step's (loc, conf).  Both must give the
    same tensors; the least ms of 20 calls, in the order plain, guarded,
    guarded, plain."""
    import torch

    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    from analytics_zoo_tpu_torch.parallel import tensor as tensor_lib
    from analytics_zoo_tpu_torch.parallel.specs import gather_rows_guarded
    from analytics_zoo_tpu_torch.utils import engine

    dev = engine.device()
    ctx = tensor_lib.axis_ctx(mesh, mesh_lib.data_axis(mesh))
    gen = torch.Generator(device=dev).manual_seed(seed + ctx.index)
    rows = BATCH // DIST_WORLD
    cases = {"detections": [(rows, 200, 6)],
             "loc_conf": [(rows, 8732, 4), (rows, 8732, 21)]}
    out = {}
    for name, shapes in cases.items():
        ys = [torch.randn(s, generator=gen, device=dev) for s in shapes]
        runs = {"plain": lambda: [tensor_lib.all_gather_dim(y, 0, ctx)
                                  for y in ys],
                "guarded": lambda: gather_rows_guarded(lambda: ys, ctx)}
        for a, b in zip(runs["plain"](), runs["guarded"]()):
            if not torch.equal(a, b):
                raise AssertionError(f"guarded gather of {name} differs "
                                     f"from the plain gather")
        ms = {"plain": [], "guarded": []}
        for k in ("plain", "guarded", "guarded", "plain"):
            ms[k].append(timed_ms(runs[k], 20)[1])
        out[name] = {k + "_ms": min(v) for k, v in ms.items()}
    return out


def dist_serve_phase(dev, smi, seed=59):
    """dist_serve: SSD300 and DS2 served by DIST_WORLD ranks on the one
    card over gloo (each rank its rows, the rows gathered back), and SSD
    requests through ``ServingRuntime(specs=)`` with the follower and a
    hot swap, against this process."""
    import statistics

    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.models.ssd import SSDVgg
    from analytics_zoo_tpu_torch.parallel import make_eval_step
    from analytics_zoo_tpu_torch.pipelines import deepspeech2 as ds2_pipe
    from analytics_zoo_tpu_torch.pipelines.ssd import (BGR_MEANS,
                                                       PreProcessParam,
                                                       SSDPredictor,
                                                       ssd_serving_tiers)
    from analytics_zoo_tpu_torch.serving import (ModelConfig,
                                                 MonotonicClock,
                                                 ServingRuntime)
    from analytics_zoo_tpu_torch.utils import engine

    t_phase = time.perf_counter()
    rng = np.random.RandomState(seed)

    def images(n):
        return [rng.randint(0, 256, (300, 300, 3)).astype(np.float32)
                - np.float32(BGR_MEANS) for _ in range(n)]

    ssd_input = np.stack(images(BATCH))
    ssd_info = np.tile(np.float32([[300, 300, 1.0, 1.0]]), (BATCH, 1))
    ds2_x = rng.randn(BATCH, SERVE_DS2_FRAMES, 13).astype(np.float32)
    ds2_n = np.full(BATCH, SERVE_DS2_FRAMES, np.int32)
    requests = images(SERVE_REQUESTS)
    ranks = engine.spawn(os.path.abspath(__file__) + ":dist_child",
                         DIST_WORLD, dict(task="serve", ssd_input=ssd_input,
                                          ssd_info=ssd_info, ds2_x=ds2_x,
                                          ds2_n=ds2_n, requests=requests,
                                          seed=seed),
                         timeout=DIST_TIMEOUT, backend=DIST_BACKEND,
                         local_ranks=[0] * DIST_WORLD)
    lead = ranks[0]
    param = PreProcessParam(batch_size=BATCH, resolution=300)
    # -- SSD300: each rank's rows against this process's of its half -----
    pred = SSDPredictor(SSDVgg(21, 300, device=dev, seed=0), param,
                        device=dev)
    half = BATCH // DIST_WORLD
    halves = np.concatenate([pred.detect_batch(
        {"input": ssd_input[i:i + half], "im_info": ssd_info[i:i + half]})
        for i in range(0, BATCH, half)])
    pred.detect_batch({"input": ssd_input, "im_info": ssd_info})
    whole, ssd_one_ms = timed_ms(lambda: pred.detect_batch(
        {"input": ssd_input, "im_info": ssd_info}))
    del pred
    def normalized(rows):           # detect_batch's boxes are in pixels
        rows = np.array(rows, np.float32)
        rows[..., 2:] /= 300.0
        return torch.from_numpy(rows)

    ssd_err = max(rows_err(normalized(x["ssd_rows"]), normalized(halves))
                  for x in ranks)
    ssd_match = match_images(normalized(lead["ssd_rows"]).numpy(),
                             normalized(whole).numpy())
    if ssd_match[0] < DIST_MATCH_MIN or ssd_match[2] > DIST_SCORE_TOL:
        raise AssertionError(f"dist_serve ssd against the whole batch: "
                             f"{ssd_match}")
    for r, x in enumerate(ranks):
        if (x["ssd_launches"]["fused_detection_output"] != 1
                or x["ssd_launches"]["nms_sweep"]
                or x["ds2_launches"]["persistent_rnn"] != 6):
            raise AssertionError(f"dist_serve rank {r}: ssd launches "
                                 f"{x['ssd_launches']}, ds2 "
                                 f"{x['ds2_launches']}")
    # -- DS2: the log-probs of each half, the transcripts -----------------
    model = ds2_pipe.make_ds2_model(hidden=DS2_HIDDEN, n_rnn_layers=3,
                                    rnn_engine="pallas", device=dev,
                                    seed=seed)
    eval_step = make_eval_step(model)
    x_d = torch.from_numpy(ds2_x).to(dev)
    n_d = torch.from_numpy(ds2_n).to(dev)
    want_logp = torch.cat([eval_step((x_d[i:i + half], n_d[i:i + half]))
                           for i in range(0, BATCH, half)]).cpu().numpy()
    _, ds2_one_ms = timed_ms(lambda: eval_step((x_d, n_d)), 3)
    logp_err = float(np.abs(lead["ds2_logp"] - want_logp).max())
    (greedy,) = ds2_pipe.ds2_serving_tiers(
        model, ds2_pipe.DS2Param(decoder="greedy"), device=dev)
    want_texts = greedy.forward({"input": ds2_x, "n_frames": ds2_n})
    del model, eval_step, greedy
    torch.cuda.empty_cache()
    if not logp_err <= DS2_LOGP_TOL or any(
            x["ds2_texts"] != want_texts for x in ranks):
        raise AssertionError(f"dist_serve ds2: log-probs max-abs "
                             f"{logp_err} (tol {DS2_LOGP_TOL}), texts "
                             f"equal {[x['ds2_texts'] == want_texts for x in ranks]}")
    # -- the runtime: every request done, rows as one process's ----------
    acct = lead["accounting"]
    follower = ranks[1]["follower"]
    if (acct["by_state"] != {"done": SERVE_REQUESTS} or lead["failed"]
            or lead["swap"]["completed"] != 1 or lead["swap"]["rollbacks"]
            or sorted(lead["installed"]) != [0, 1] or follower["failed"]
            or follower["build"] != 3):
        raise AssertionError(f"dist_serve runtime: accounting {acct}, "
                             f"failed {lead['failed']}, swap "
                             f"{lead['swap']}, follower {follower}")
    # the one-process runtime on the same requests, the same swap
    tiers0 = ssd_serving_tiers(SSDVgg(21, 300, device=dev, seed=0), param,
                               device=dev)
    warm = np.stack(requests[:BATCH])
    for t in tiers0:
        t.forward({"input": warm})

    def weights_to_tiers(state, rid):
        m = SSDVgg(21, 300, device=dev, seed=0)
        m.load_state_dict(state)
        return ssd_serving_tiers(m, param, device=dev)

    import shutil
    import tempfile

    from analytics_zoo_tpu_torch.parallel import checkpoint as ckpt
    root = tempfile.mkdtemp()
    try:
        snap = ckpt.save(os.path.join(root, "ssd"),
                         SSDVgg(21, 300, device=dev, seed=1).state_dict(),
                         step=1)
        rt = ServingRuntime(models=[ModelConfig(
            name="ssd", tiers=tiers0, weights_to_tiers=weights_to_tiers,
            length_key=None, max_batch=BATCH, default_deadline_s=3600.0)],
            n_replicas=2, max_batch=BATCH,
            queue_capacity=4 * SERVE_REQUESTS, default_deadline_s=3600.0,
            clock=MonotonicClock())
        reqs = []
        for k, x in enumerate(requests):
            if k == lead["swap_at"]:
                rt.hot_swap(snap, canary_fraction=0.0, device=dev)
            reqs.append(rt.submit({"input": x}, model="ssd"))
            if len(reqs) % BATCH == 0:
                rt.pump(force=True)
        rt.drain()
        for _ in range(10):
            rt.pump(force=True)
            if not rt.swap_active:
                break
    finally:
        shutil.rmtree(root, ignore_errors=True)
    lat = sorted((r.completed_t - r.arrival_t) * 1e3 for r in reqs)
    one_latency = {"p50": statistics.median(lat),
                   "p99": lat[min(len(lat) - 1, int(0.99 * len(lat)))]}
    want_rows = np.stack([np.asarray(r.result) for r in reqs])
    got_rows = np.stack(lead["rows"])
    rt_match = match_images(got_rows, want_rows)
    if rt_match[0] < DIST_MATCH_MIN or rt_match[2] > DIST_SCORE_TOL:
        raise AssertionError(f"dist_serve runtime rows against one "
                             f"process's: {rt_match}")
    rt_equal = float(np.mean([np.array_equal(g, w) for g, w
                              in zip(got_rows, want_rows)]))
    emit("dist_serve", nvidia_smi=smi, world=DIST_WORLD,
         mesh={"data": DIST_WORLD}, backend=lead["backend"],
         ssd_batch=BATCH, ssd_rows_err_vs_halves=ssd_err,
         ssd_matched_vs_whole_min=ssd_match[0],
         ssd_score_err_vs_whole=ssd_match[2],
         ssd_ms_by_rank=[x["ssd_ms"] for x in ranks],
         ssd_one_process_ms=ssd_one_ms,
         gather_ms_by_rank=[x["gather_ms"] for x in ranks],
         ds2_batch=BATCH, ds2_frames=SERVE_DS2_FRAMES,
         ds2_logp_max_abs_err_vs_halves=logp_err,
         ds2_texts_equal=True,
         ds2_ms_by_rank=[x["ds2_ms"] for x in ranks],
         ds2_one_process_ms=ds2_one_ms,
         runtime_requests=SERVE_REQUESTS, runtime_accounting=acct,
         runtime_failed=lead["failed"], runtime_swap={
             "completed": lead["swap"]["completed"],
             "installed": lead["installed"], "at_request": lead["swap_at"]},
         runtime_mesh=lead["mesh"], follower=follower,
         runtime_rows_matched_min=rt_match[0],
         runtime_rows_score_err=rt_match[2],
         runtime_rows_equal_share=rt_equal,
         latency_ms=lead["latency_ms"], one_process_latency_ms=one_latency,
         runtime_s=lead["runtime_s"],
         ssd_launches_by_rank=[x["ssd_launches"] for x in ranks],
         ds2_launches_by_rank=[x["ds2_launches"] for x in ranks],
         runtime_launches_by_rank=[x["runtime_launches"] for x in ranks],
         phase_s=time.perf_counter() - t_phase)
    return {k: sum(x[part][k] for x in ranks
                   for part in ("ssd_launches", "ds2_launches",
                                "runtime_launches"))
            for k in lead["ssd_launches"]}


# -- 6q. the telemetry spine and the anomaly ladder ---------------------------

TELEMETRY_STEPS = 8
TELEMETRY_NAN = (2, 4, 5)       # batches 3, 5 and 6: a skip, then a rollback
TELEMETRY_WINDOWS = 3           # interleaved timing windows a side
TELEMETRY_WINDOW_STEPS = 4
TELEMETRY_REQUESTS = 64
TELEMETRY_BURST = 16            # requests submitted between pumps
TELEMETRY_SSD_BATCH = 32


def poison_ds2(batch, rng):
    """``batch`` with one seeded feature of one valid frame NaN (a copy)."""
    import numpy as np

    feats, n = batch["input"]
    feats = feats.copy()
    i = rng.randint(feats.shape[0])
    feats[i, rng.randint(int(n[i])), rng.randint(feats.shape[2])] = np.nan
    return dict(batch, input=(feats, n))


def ds2_ladder_run(dev, batches, root, policy, obs):
    """``Optimizer`` over ``batches`` with a checkpoint every 4
    iterations, ``policy`` and ``obs`` armed, the counters at 0 just
    before and read just after.  Returns (the optimizer, the raised
    ``TrainingDiverged`` or None, the launches, seconds)."""
    import torch

    from analytics_zoo_tpu_torch.parallel.optim import Adam, Trigger
    from analytics_zoo_tpu_torch.parallel.train import Optimizer
    from analytics_zoo_tpu_torch.pipelines.deepspeech2 import (
        ds2_ctc_criterion, make_ds2_model)
    from analytics_zoo_tpu_torch.resilience.errors import TrainingDiverged

    model = make_ds2_model(hidden=DS2_HIDDEN, n_rnn_layers=3,
                           rnn_engine="pallas", seed=0, device=dev)
    opt = (Optimizer(model, batches, ds2_ctc_criterion())
           .set_optim_method(Adam(3e-4))
           .set_checkpoint(os.path.join(root, "ckpt"),
                           Trigger.several_iteration(4))
           .set_anomaly_policy(policy).set_observability(obs)
           .set_end_when(Trigger.max_epoch(1)))
    torch.cuda.synchronize()
    zero_kernel_counters()
    err = None
    t0 = time.perf_counter()
    try:
        opt.optimize()
    except TrainingDiverged as e:
        err = e
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return (opt, err, {k.__name__: k.launches for k in kernel_counters()},
            seconds)


def telemetry_phase(dev, smi, seed=47):
    """The telemetry spine and the anomaly ladder on the card (phase
    ``telemetry``): DS2 training under the ladder (K3, K4), SSD300
    serving with spans (K2), ``train_ssd`` with summaries (K2).  Returns
    each kernel's launches on the path."""
    import json
    import shutil
    import statistics
    import tempfile

    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.models.ssd import build_ssd_vgg
    from analytics_zoo_tpu_torch.obs import (Observability, TraceStore,
                                             attribution_rows, lookup,
                                             render_prometheus,
                                             span_conservation)
    from analytics_zoo_tpu_torch.obs.exporters import _prom_name
    from analytics_zoo_tpu_torch.obs.trace import CONSERVATION_TOL_S
    from analytics_zoo_tpu_torch.ops import pallas_detout
    from analytics_zoo_tpu_torch.parallel.optim import Adam, Trigger
    from analytics_zoo_tpu_torch.parallel.summary import read_events
    from analytics_zoo_tpu_torch.parallel.train import (Optimizer,
                                                        create_train_state,
                                                        make_train_step)
    from analytics_zoo_tpu_torch.pipelines.deepspeech2 import (
        ds2_ctc_criterion, make_ds2_model)
    from analytics_zoo_tpu_torch.pipelines.ssd import (BGR_MEANS,
                                                       PreProcessParam,
                                                       TrainParams,
                                                       ssd_serving_tiers,
                                                       train_ssd)
    from analytics_zoo_tpu_torch.resilience.anomaly import (
        AnomalyPolicy, batch_fingerprint, decode_health, health_sections)
    from analytics_zoo_tpu_torch.serving import (MonotonicClock,
                                                 ServingRuntime)
    from analytics_zoo_tpu_torch.serving.request import DEFAULT_MODEL

    rng = np.random.RandomState(seed)
    clean = dist_ds2_batches(seed, steps=TELEMETRY_STEPS)
    batches = [poison_ds2(b, rng) if k in TELEMETRY_NAN else b
               for k, b in enumerate(clean)]
    criterion = ds2_ctc_criterion()
    root = tempfile.mkdtemp()
    try:
        # -- 1. one skipped step, bit for bit on the card ------------------
        model = make_ds2_model(hidden=DS2_HIDDEN, n_rnn_layers=3,
                               rnn_engine="pallas", seed=0, device=dev)
        sections = health_sections(model)
        adam = Adam(3e-4)
        step = make_train_step(model, criterion, adam, skip_unhealthy=True)
        state, m = step(create_train_state(model, adam), batches[0])
        word0 = int(m["health"])
        before = {k: v.clone() for k, v in model.state_dict().items()}
        slots = {k: ([t.clone() for t in v] if isinstance(v, list)
                     else v.clone()) for k, v in state.opt_state.items()}
        state, m = step(state, batches[TELEMETRY_NAN[0]])
        word = int(m["health"])
        health = decode_health(word, sections)
        after = model.state_dict()
        unequal = [k for k, v in before.items()
                   if not torch.equal(v, after[k])]
        unequal += [f"{k}/{i}" for k, v in slots.items()
                    for i, (a, b) in enumerate(
                        zip(v, state.opt_state[k]) if isinstance(v, list)
                        else [(v, state.opt_state[k])])
                    if not torch.equal(a, b)]
        if (word0 or not word or unequal or not health["bad_sections"]
                or not set(health["bad_sections"]) <= set(sections)):
            raise AssertionError(f"telemetry skip: words {word0}, {word} "
                                 f"({health}), changed {unequal}")
        del model, state, step, before, slots, after
        # the poisoned batch's word on the card and on the CPU: one step
        # of the same seeded model (K3/K4 there, their plain versions here)
        nan_words = {}
        for where in (dev, torch.device("cpu")):
            model = make_ds2_model(hidden=DS2_HIDDEN, n_rnn_layers=3,
                                   rnn_engine="pallas", seed=0, device=where)
            step = make_train_step(model, criterion, Adam(3e-4),
                                   health_check=True)
            _, m = step(create_train_state(model, Adam(3e-4)),
                        batches[TELEMETRY_NAN[0]])
            nan_words[where.type] = int(m["health"])
            del model, step, m
        if not nan_words["cuda"] == nan_words["cpu"] == word:
            raise AssertionError(
                f"telemetry: the NaN batch's word on the card "
                f"{nan_words['cuda']:#x} "
                f"({decode_health(nan_words['cuda'], sections)}), on the "
                f"CPU {nan_words['cpu']:#x}, the skipped step's {word:#x}")

        # -- 2. the ladder: a skip, then a rollback to the lkg slot --------
        box = os.path.join(root, "blackbox.jsonl")
        obs = Observability(dump_path=box)
        policy = AnomalyPolicy(rollback_after=2, promote_after=1,
                               forensics_dir=os.path.join(root, "f"))
        opt, err, launches, ladder_s = ds2_ladder_run(
            dev, batches, os.path.join(root, "ladder"), policy, obs)
        sent = opt._anomaly
        stats = sent.stats()
        steps = len(opt.history)
        rollbacks = [e for e in sent.events if e["kind"] == "rollback"]
        bundles = []
        for path in sent.forensics_paths:
            with open(path) as f:
                bundles.append(json.load(f))
        want_hash = [batch_fingerprint(batches[TELEMETRY_NAN[0]]),
                     batch_fingerprint(batches[TELEMETRY_NAN[1]])]
        spans = obs.recorder.events("span")
        train_spans = [e for e in spans if e["name"] == "train_step"]
        saves = [e for e in spans if e["name"] == "checkpoint_save"]
        cons = span_conservation(obs.recorder.events(),
                                 trace_prefix="train-")
        finite = all(torch.isfinite(p).all().item()
                     for p in opt.model.parameters())
        counters = obs.registry.snapshot()["counters"]
        if (err is not None or steps != TELEMETRY_NAN[2] + 1
                or stats["bad_steps"] != 3 or stats["rollbacks"] != 1
                or len(rollbacks) != 1 or rollbacks[0]["tier"] != "lkg"
                or rollbacks[0]["params_match_snapshot"] is not True
                or [b["batch_hash"] for b in bundles] != want_hash
                or any(not b["health"]["bad_sections"] for b in bundles)
                or not cons["ok"] or len(train_spans) != steps
                or len(saves) != 1 or not finite
                or counters.get("train/anomaly/rollbacks") != 1
                or counters.get("train/dispatch/steps") != steps
                or launches["persistent_rnn"] != 6 * steps
                or launches["persistent_rnn_bwd"] != 6 * steps
                or launches["nms_sweep"]
                or launches["fused_detection_output"]):
            raise AssertionError(
                f"telemetry ladder: error {err}, {steps} steps, stats "
                f"{stats}, rollbacks {rollbacks}, bundles "
                f"{[b['batch_hash'] for b in bundles]} vs {want_hash}, "
                f"conservation {cons}, {len(train_spans)} step spans, "
                f"{len(saves)} saves, finite {finite}, counters "
                f"{counters}, launches {launches}")
        ds2_launches = dict(launches)
        ladder = {"steps": steps, "stats": stats,
                  "events": [e["kind"] for e in sent.events],
                  "rollback": rollbacks[0],
                  "forensics": [{k: b[k] for k in (
                      "step", "iteration", "batch_in_epoch", "health_word",
                      "batch_hash")} | {"bad_sections": sorted(
                          b["health"]["bad_sections"])} for b in bundles],
                  "span_statuses": [e["status"] for e in train_spans],
                  "checkpoint_spans": len(saves), "conservation": cons,
                  "counters": counters, "launches": launches,
                  "seconds": ladder_s}
        del opt

        # -- 3. an empty rollback budget: diverged, the black box written --
        box2 = os.path.join(root, "diverged.jsonl")
        obs2 = Observability(dump_path=box2)
        policy2 = AnomalyPolicy(rollback_after=2, promote_after=1,
                                max_rollbacks=0,
                                forensics_dir=os.path.join(root, "f2"))
        diverge = [batches[0], batches[TELEMETRY_NAN[1]],
                   batches[TELEMETRY_NAN[2]], batches[1]]
        opt2, err2, launches2, _ = ds2_ladder_run(
            dev, diverge, os.path.join(root, "diverge"), policy2, obs2)
        steps2 = len(opt2.history)
        with open(box2) as f:
            last = json.loads(f.read().splitlines()[-1])
        if (err2 is None or steps2 != 3
                or [d["reason"] for d in obs2.recorder.dumps]
                != ["training_diverged"]
                or last["kind"] != "training_diverged"
                or launches2["persistent_rnn"] != 6 * steps2
                or launches2["persistent_rnn_bwd"] != 6 * steps2):
            raise AssertionError(f"telemetry diverge: {err2!r} after "
                                 f"{steps2} steps, dumps "
                                 f"{obs2.recorder.dumps}, last {last}, "
                                 f"launches {launches2}")
        for k, v in launches2.items():
            ds2_launches[k] += v
        del opt2

        # -- 4. a clean step armed against un-armed, interleaved -----------
        model = make_ds2_model(hidden=DS2_HIDDEN, n_rnn_layers=3,
                               rnn_engine="pallas", seed=0, device=dev)
        window = [b for k, b in enumerate(clean)
                  if k not in TELEMETRY_NAN][:TELEMETRY_WINDOW_STEPS]

        def timed(armed):
            opt = (Optimizer(model, window, criterion)
                   .set_optim_method(Adam(3e-4))
                   .set_end_when(Trigger.max_epoch(1)))
            if armed:
                opt.set_anomaly_policy(AnomalyPolicy())
                opt.set_observability(Observability())
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            opt.optimize()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / len(window)
            if armed and any(int(h["health"]) for h in opt.history):
                raise AssertionError("telemetry timing: a clean step's "
                                     "word is not 0")
            return ms, torch.cuda.max_memory_allocated() / 1e9

        timed(False)                            # warm-up
        step_ms = {"unarmed": [], "armed": []}
        peak_gb = {"unarmed": [], "armed": []}
        for w in range(TELEMETRY_WINDOWS):
            for armed in ((False, True) if w % 2 == 0 else (True, False)):
                ms, gb = timed(armed)
                key = "armed" if armed else "unarmed"
                step_ms[key].append(ms)
                peak_gb[key].append(gb)
        del model
        emit("telemetry", nvidia_smi=smi, part="ds2_ladder",
             hidden=DS2_HIDDEN, layers=3, batch=BATCH,
             frames=DIST_DS2_FRAMES, batches=TELEMETRY_STEPS,
             nan_batches=list(TELEMETRY_NAN), skip_word=word,
             nan_word_card=nan_words["cuda"], nan_word_cpu=nan_words["cpu"],
             skip_health=health, skip_bit_equal=True, sections=sections,
             ladder=ladder, diverged=str(err2)[:200],
             diverged_steps=steps2, black_box_events=len(
                 obs2.recorder.events()),
             step_ms=step_ms, peak_gb=peak_gb,
             armed_over_unarmed=statistics.median(step_ms["armed"])
             / statistics.median(step_ms["unarmed"]),
             launches=ds2_launches)

        # -- 5. SSD300 serving with spans -----------------------------------
        ssd = build_ssd_vgg(21, 300, device=dev, seed=0)
        tiers = ssd_serving_tiers(
            ssd, PreProcessParam(batch_size=BATCH, resolution=300),
            device=dev)
        requests = [rng.randint(0, 256, (300, 300, 3)).astype(np.float32)
                    - np.float32(BGR_MEANS)
                    for _ in range(TELEMETRY_REQUESTS)]
        for t in tiers:
            t.forward({"input": np.stack(requests[:BATCH])})

        def serve(obs, crash=False):
            rt = ServingRuntime(tiers, n_replicas=2, max_batch=BATCH,
                                queue_capacity=2 * TELEMETRY_REQUESTS,
                                default_deadline_s=3600.0,
                                clock=MonotonicClock(), obs=obs)
            if crash:
                # replica 1's forward crashes on its second batch: a fence
                # and a failover to replica 0
                fns = rt.pool.replica_by_rid(1).forward_fns[DEFAULT_MODEL]
                fwd, calls = fns[0], [0]

                def crashing(batch):
                    calls[0] += 1
                    if calls[0] == 2:
                        raise RuntimeError("injected forward crash")
                    return fwd(batch)

                fns[0] = crashing
            torch.cuda.synchronize()
            pallas_detout.fused_detection_output.launches = 0
            for i in range(0, TELEMETRY_REQUESTS, TELEMETRY_BURST):
                for x in requests[i:i + TELEMETRY_BURST]:
                    rt.submit({"input": x})
                rt.pump()
            rt.drain()
            torch.cuda.synchronize()
            k2 = pallas_detout.fused_detection_output.launches
            lat = sorted((r.completed_t - r.arrival_t) * 1e3
                         for r in rt.requests)
            return rt, k2, lat

        ssd_box = os.path.join(root, "serving.jsonl")
        obs3 = Observability(dump_path=ssd_box)
        zero_kernel_counters()
        rt, k2, _ = serve(obs3, crash=True)
        serve_launches = {k.__name__: k.launches for k in kernel_counters()}
        metrics = rt.metrics.snapshot()
        store = TraceStore.from_recorder(obs3.recorder)
        cons3 = store.critical_path_conservation(CONSERVATION_TOL_S)
        by_status = {st: len(store.requests(st))
                     for st in ("done", "shed", "timeout", "failed")}
        prom = render_prometheus(obs3.registry)
        names = sorted(obs3.registry.metrics())
        series = {line.split("{")[0].split(" ")[0]
                  for line in prom.splitlines() if not line.startswith("#")}
        unrendered = [n for n in names if not series & {
            _prom_name(n)[0] + suffix
            for suffix in ("", "_total", "_sum", "_count")}]
        uncatalogued = [n for n in names if not lookup(n)]
        fences = store.events_of("replica_fenced")
        failovers = store.events_of("failover")
        if (not cons3["ok"] or cons3["checked"] != TELEMETRY_REQUESTS
                or by_status["done"] != metrics["completed"]
                or by_status["shed"] + by_status["timeout"]
                != metrics["shed_total"]
                or by_status["failed"] != metrics["failed"]
                or metrics["completed"] != TELEMETRY_REQUESTS
                or len(fences) != 1 or len(failovers) != 1
                or "replica_fenced" not in [d["reason"]
                                            for d in obs3.recorder.dumps]
                or not os.path.exists(ssd_box) or unrendered
                or uncatalogued or k2 != metrics["batches"]
                or serve_launches["nms_sweep"]
                or serve_launches["persistent_rnn"]):
            raise AssertionError(
                f"telemetry serving: conservation {cons3}, by status "
                f"{by_status}, metrics {metrics}, fences {fences}, "
                f"failovers {failovers}, dumps {obs3.recorder.dumps}, "
                f"unrendered {unrendered}, uncatalogued {uncatalogued}, "
                f"K2 {k2} for {metrics['batches']} batches")
        moved = [store.critical_path(f"req-{r}")
                 for r in failovers[0]["requests"]]
        k2_serving = k2
        # obs= on against off, interleaved windows
        lat = {"on": [], "off": []}
        k2_by = {"on": [], "off": []}
        for w in range(TELEMETRY_WINDOWS):
            for on in ((False, True) if w % 2 == 0 else (True, False)):
                ob = Observability() if on else None
                rt_w, k2_w, lat_w = serve(ob)
                key = "on" if on else "off"
                lat[key].append({"p50": lat_w[len(lat_w) // 2],
                                 "p99": lat_w[min(len(lat_w) - 1, int(
                                     0.99 * len(lat_w)))]})
                k2_by[key].append(k2_w)
                k2_serving += k2_w
                if on:
                    last_store = TraceStore.from_recorder(ob.recorder)
        if len(set(k2_by["on"] + k2_by["off"])) != 1:
            raise AssertionError(f"telemetry serving: K2 launches with obs "
                                 f"{k2_by['on']}, without {k2_by['off']}")
        report = last_store.tail_attribution()
        emit("telemetry", nvidia_smi=smi, part="ssd_serving",
             requests=TELEMETRY_REQUESTS, burst=TELEMETRY_BURST,
             replicas=2, max_batch=BATCH, by_status=by_status,
             metrics={k: metrics[k] for k in ("completed", "failed",
                                              "shed_total", "batches",
                                              "redispatched_batches")},
             conservation=cons3, fence_dump=obs3.recorder.dumps,
             failover_paths=[{"trace": cp["trace"],
                              "segments_ms": {k: v * 1e3 for k, v in
                                              cp["segments"].items()}}
                             for cp in moved[:2]],
             prometheus_lines=len(prom.splitlines()),
             metric_names=len(names), latency_ms=lat, k2_by_window=k2_by,
             tail_attribution=report,
             attribution_rows=[r for _, r in attribution_rows(report)])
        for _, row in attribution_rows(report):
            print(f"telemetry attribution ({smi}): {row}", flush=True)
        del tiers, ssd

        # -- 6. train_ssd with summaries -------------------------------------
        train_set = [ssd_batch(rng, TELEMETRY_SSD_BATCH) for _ in range(2)]
        val_set = [ssd_batch(rng, BATCH)]
        params = TrainParams(max_epoch=1, log_dir=os.path.join(root, "tb"))
        seen = []
        run = Optimizer.optimize

        def optimize(self):
            seen.append(self)
            return run(self)

        Optimizer.optimize = optimize
        try:
            torch.cuda.synchronize()
            zero_kernel_counters()
            t0 = time.perf_counter()
            train_ssd(train_set, val_set, params,
                      model=build_ssd_vgg(21, 300, device=dev, seed=0))
            torch.cuda.synchronize()
            tb_s = time.perf_counter() - t0
            tb_launches = {k.__name__: k.launches
                           for k in kernel_counters()}
        finally:
            Optimizer.optimize = run
        (opt3,) = seen
        logs = os.path.join(root, "tb", params.job_name)
        got = [(e["step"], t, v) for e in read_events(
            os.path.join(logs, "train")) for t, v in e["scalars"].items()]
        want = [(i + 1, t, np.float32(v)) for i, mm in enumerate(
            opt3.history) for t, v in (("Loss", mm["loss"].item()),
                                       ("LearningRate", mm["lr"]))]
        val = [(e["step"], e["scalars"]) for e in read_events(
            os.path.join(logs, "validation")) if e["scalars"]]
        if ([(s, t, np.float32(v)) for s, t, v in got] != want
                or len(got) != 4 or len(val) != 1 or val[0][0] != 2
                or "MeanAveragePrecision" not in val[0][1]
                or tb_launches["fused_detection_output"] != len(val_set)
                or tb_launches["persistent_rnn"]):
            raise AssertionError(f"telemetry train_ssd summaries: {got} "
                                 f"vs {want}, validation {val}, launches "
                                 f"{tb_launches}")
        emit("telemetry", nvidia_smi=smi, part="train_ssd_summaries",
             batch=TELEMETRY_SSD_BATCH, steps=len(opt3.history),
             train_tags=sorted({t for _, t, _ in got}),
             train_steps=sorted({s for s, _, _ in got}),
             validation=val, seconds=tb_s, launches=tb_launches)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"nms_sweep": 0,
            "fused_detection_output": k2_serving
            + tb_launches["fused_detection_output"],
            "persistent_rnn": ds2_launches["persistent_rnn"],
            "persistent_rnn_bwd": ds2_launches["persistent_rnn_bwd"]}


# -- 6t. the serving fleet under chaos, the SDC sentinel, mesh slices ---------

# the fleet: SSD300 (batch 8, K2) and DS2 at hidden 1760 (K3; greedy) on
# one multiplexed runtime in the parallel service model: replicas serve
# concurrently on a virtual clock whose service model is a uniform
# FLEET_SERVICE_S a batch (the real forwards run on the card, their
# card time is printed beside), a burst of FLEET_BURST requests at
# FLEET_BURST_RATE a second (one DS2 utterance of up to 30 s in every
# FLEET_DS2_EVERY), then a quiet SSD tail of FLEET_TAIL at FLEET_TAIL_RATE
FLEET_SERVICE_S = 0.03
FLEET_BURST, FLEET_BURST_RATE, FLEET_DS2_EVERY = 96, 1500.0, 6
FLEET_TAIL, FLEET_TAIL_RATE = 160, 40.0
FLEET_DEADLINE_S = {"ssd": 0.25, "ds2": 1.0}
# the drive's clock step while nothing is due: the batcher flushes a
# batch that is not full only once it is urgent, so the clock may not
# jump over that instant
FLEET_TICK_S = 0.005
# the rows of a served SSD batch against the same batch through its rung
# again (the same kernels on the same input), max-abs
FLEET_ROWS_TOL = 1e-5
# dist_sdc: DS2 at hidden 1760 data parallel over SDC_WORLD ranks on the
# one card (gloo), global batches of SDC_ROWS utterances of 10 s (3 and
# 2 ranks both divide them); the audit every step; un-armed for
# SDC_CLEAN steps, then a bit flipped on rank 2 before batch SDC_FLIP_AT
SDC_WORLD, SDC_ROWS, SDC_CLEAN, SDC_FLIP_AT = 3, 6, 2, 2
SDC_AUDIT_REPS = 5
# dist_slice: SSD300 served by one width-2 slice of the 2 ranks
SLICE_REQUESTS = 64


def fleet_service(model, edge, n, tier):
    return FLEET_SERVICE_S


def fleet_drive(rt, clock, images, ds2_feats):
    """The fleet's traffic on ``rt`` (a parallel-service runtime on
    ``clock``): the burst, then the quiet tail, each request submitted at
    its arrival instant, the clock advanced toward the next arrival or
    pool event (by at most FLEET_TICK_S) when nothing is due; then a
    drain.  Returns the requests."""
    arrivals, t, ds2_i = [], 0.0, 0
    for i in range(FLEET_BURST):
        t += 1.0 / FLEET_BURST_RATE
        if i % FLEET_DS2_EVERY == FLEET_DS2_EVERY - 1 \
                and ds2_i < len(ds2_feats):
            arrivals.append((t, "ds2", ds2_i))
            ds2_i += 1
        else:
            arrivals.append((t, "ssd", i % len(images)))
    for i in range(FLEET_TAIL):
        t += 1.0 / FLEET_TAIL_RATE
        arrivals.append((t, "ssd", i % len(images)))
    reqs, i = [], 0
    while i < len(arrivals):
        now = clock.now()
        if now < arrivals[i][0]:
            if rt.pump() == 0:
                ev = rt.next_event_t()
                target = (arrivals[i][0] if ev is None
                          else min(ev, arrivals[i][0]))
                clock.advance(max(min(target - now, FLEET_TICK_S), 1e-9))
            continue
        while i < len(arrivals) and clock.now() >= arrivals[i][0]:
            _, model, k = arrivals[i]
            if model == "ssd":
                payload, length = {"input": images[k]}, None
            else:
                payload = {"input": ds2_feats[k]}
                length = ds2_feats[k].shape[0]
            reqs.append(rt.submit(payload, model=model, length=length,
                                  deadline_s=FLEET_DEADLINE_S[model]))
            i += 1
        rt.pump()
    for _ in range(100_000):
        if len(rt.queue) == 0:
            break
        if rt.pump() == 0:
            ev = rt.next_event_t()
            clock.advance(max(min((ev - clock.now()) if ev is not None
                                  else FLEET_TICK_S, FLEET_TICK_S), 1e-9))
    rt.drain()
    return reqs


def fleet_runtime(ssd_tiers, ds2_tiers):
    """The fleet's runtime: SSD and DS2 on 2 replicas under a device
    budget of 4, the autoscaler, the chaos schedule (replica 0 crashes
    and then wedges in the burst, replica 1 turns into a slow device
    from the 17th dispatch on) and the health sentinel's straggler
    ladder."""
    from analytics_zoo_tpu_torch.obs import model_slos
    from analytics_zoo_tpu_torch.resilience.chaos import (ChaosMonkey,
                                                          FaultSpec)
    from analytics_zoo_tpu_torch.resilience.health import (HealthPolicy,
                                                           HealthSentinel)
    from analytics_zoo_tpu_torch.serving import (Autoscaler,
                                                 AutoscalePolicy,
                                                 ModelConfig, ServingRuntime,
                                                 VirtualClock)

    clock = VirtualClock()
    monkey = ChaosMonkey([
        FaultSpec("replica_crash", 3, batches=3, detail={"replica": 0}),
        FaultSpec("slow_forward", 10, batches=6,
                  detail={"replica": 0, "delay_s": 2.0}),
        FaultSpec("slow_device", 16, batches=10 ** 6,
                  detail={"replica": 1, "slow_x": 5.0})])
    sentinel = HealthSentinel(HealthPolicy(
        straggler_factor=2.0, straggler_alpha=0.5, flag_after=2,
        warmup_obs=1, max_evictions=1))
    scaler = Autoscaler(AutoscalePolicy(min_replicas=2, max_replicas=4,
                                        grow_after=1, shrink_after=4,
                                        cooldown=1, device_budget=4))
    rt = ServingRuntime(
        models=[ModelConfig("ssd", tiers=ssd_tiers, length_key=None,
                            slos=model_slos("ssd")),
                ModelConfig("ds2", tiers=ds2_tiers,
                            bucket_edges=list(DS2_BUCKETS),
                            slos=model_slos("ds2"))],
        n_replicas=2, max_batch=BATCH, queue_capacity=512, clock=clock,
        service_time=fleet_service, parallel_replicas=True,
        fence_budget_s=0.5, restart_s=0.2, decision_every=1,
        autoscaler=scaler, chaos=monkey, health=sentinel, device_budget=4,
        slo_params=dict(fast_window_s=0.25, slow_window_s=1.0,
                        time_scale=1.0))
    return rt, clock, monkey, sentinel, scaler


def record_inputs(rt):
    """Wrap ``rt._dispatch`` to keep each batch's model, tier, rids and a
    copy of its input dict."""
    import numpy as np

    seen = []
    orig = rt._dispatch

    def record(batch):
        seen.append({"model": batch.model, "tier": batch.tier,
                     "rids": [r.rid for r in batch.requests],
                     "batch": {k: np.array(v, copy=True)
                               for k, v in batch.batch.items()}})
        orig(batch)

    rt._dispatch = record
    return seen


def fleet_check(rt, reqs, seen, monkey, sentinel, scaler, what):
    """The fleet's invariants: every request terminal and none failed
    (each chaos failure fails over once; a request whose deadline passes
    in the queue is shed, not failed), the slow device quarantined with
    the budget lowered once, the pool grown and shrunk, every served row
    in a recorded batch; returns the summary."""
    acct = rt.accounting()
    snap = rt.snapshot()
    kinds = [e["kind"] for e in rt.pool.events]
    quarantined = [e for e in rt.pool.events
                   if e["kind"] == "replica_quarantined"]
    fenced = sorted({e["replica"] for e in rt.pool.events
                     if e["kind"] == "replica_fenced"})
    if acct["unaccounted"] or acct["by_state"].get("failed", 0) \
            or snap["metrics"]["failed"]:
        raise AssertionError(f"{what}: accounting {acct}")
    if [e["replica"] for e in quarantined] != [1] \
            or quarantined[0]["device_budget"] != 3 \
            or rt.pool.device_budget != 3 \
            or sentinel.stats()["quarantines"] != 1 \
            or scaler.evicted_devices != 1:
        raise AssertionError(f"{what}: quarantines {quarantined}, budget "
                             f"{rt.pool.device_budget}, sentinel "
                             f"{sentinel.stats()}")
    if fenced != [0] or kinds.count("failover") < 2 \
            or sorted(monkey.fired_kinds()) != ["replica_crash",
                                                "slow_device",
                                                "slow_forward"]:
        raise AssertionError(f"{what}: fenced {fenced}, pool {kinds}, chaos "
                             f"{monkey.fired_kinds()}")
    if scaler.grows < 1 or scaler.shrinks < 1:
        raise AssertionError(f"{what}: autoscaler {scaler.snapshot()}")
    if sum(len(b["rids"]) for b in seen) != acct["by_state"].get("done"):
        raise AssertionError(f"{what}: {len(seen)} batches held "
                             f"{sum(len(b['rids']) for b in seen)} rows "
                             f"for {acct['by_state']}")
    return {"accounting": acct, "grows": scaler.grows,
            "shrinks": scaler.shrinks, "decisions": scaler.decisions,
            "quarantined": [e["replica"] for e in quarantined],
            "fenced": fenced, "failovers": kinds.count("failover"),
            "pool_size": rt.pool.size, "device_budget":
                rt.pool.device_budget,
            "batches": {m: sum(b["model"] == m for b in seen)
                        for m in ("ssd", "ds2")},
            "tiers": sorted({(b["model"], b["tier"]) for b in seen}),
            "chaos_events": len(monkey.events),
            "health": sentinel.stats(),
            "health_events": [e["kind"] for e in sentinel.events]}


def fleet_latency(reqs):
    import numpy as np

    lat = {}
    for m in ("ssd", "ds2"):
        x = [r.completed_t - r.arrival_t for r in reqs if r.model == m]
        lat[m] = {"p50_s": float(np.percentile(x, 50)),
                  "p99_s": float(np.percentile(x, 99)), "n": len(x)}
    return lat


def fleet_chaos_phase(dev, smi, seed=67):
    """fleet_chaos: SSD300 (K2) and DS2 at hidden 1760 (K3) on one
    multiplexed runtime in the parallel service model, with the
    autoscaler, chaos, the health sentinel and a device budget; each
    served batch's rows against the same batch through its rung again.
    Returns the launches of K2 and K3 in the drive."""
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.models.ssd import build_ssd_vgg
    from analytics_zoo_tpu_torch.ops import pallas_detout, pallas_rnn
    from analytics_zoo_tpu_torch.pipelines.deepspeech2 import (
        DS2Param, ds2_serving_tiers, make_ds2_model)
    from analytics_zoo_tpu_torch.pipelines.ssd import (BGR_MEANS,
                                                       PreProcessParam,
                                                       ssd_serving_tiers)
    from analytics_zoo_tpu_torch.transform.audio import featurize

    t_phase = time.perf_counter()
    rng = np.random.RandomState(seed)
    ssd_tiers = ssd_serving_tiers(build_ssd_vgg(21, 300, device=dev, seed=0),
                                  PreProcessParam(batch_size=BATCH,
                                                  resolution=300),
                                  device=dev)
    ds2 = make_ds2_model(hidden=DS2_HIDDEN, n_rnn_layers=3,
                         rnn_engine="pallas", seed=0, device=dev)
    ds2_tiers = ds2_serving_tiers(ds2, DS2Param(decoder="greedy"),
                                  device=dev)
    images = [rng.randint(0, 256, (300, 300, 3)).astype(np.float32)
              - np.float32(BGR_MEANS) for _ in range(2 * BATCH)]
    n_ds2 = FLEET_BURST // FLEET_DS2_EVERY
    seconds = [float(s) for s in rng.uniform(3, 30, n_ds2)]
    ds2_feats = [featurize(x) for x in synthetic_utterances(
        seconds, seed=seed).values()]
    for t in ssd_tiers:                     # cuDNN's choice on every rung
        t.forward({"input": np.stack(images[:BATCH])})
    for e in DS2_BUCKETS:
        ds2_tiers[0].forward({"input": np.zeros((BATCH, e, 13), np.float32),
                              "n_frames": np.full(BATCH, e, np.int32)})
    rt, clock, monkey, sentinel, scaler = fleet_runtime(ssd_tiers, ds2_tiers)
    seen = record_inputs(rt)
    torch.cuda.synchronize()
    zero_kernel_counters()
    t0 = time.perf_counter()
    reqs = fleet_drive(rt, clock, images, ds2_feats)
    torch.cuda.synchronize()
    drive_s = time.perf_counter() - t0
    launches = launch_counts()
    summary = fleet_check(rt, reqs, seen, monkey, sentinel, scaler,
                          "fleet_chaos")
    n_ssd, n_ds2b = summary["batches"]["ssd"], summary["batches"]["ds2"]
    if launches["fused_detection_output"] != n_ssd \
            or launches["persistent_rnn"] != 6 * n_ds2b \
            or launches["nms_sweep"] or launches["persistent_rnn_bwd"]:
        raise AssertionError(f"fleet_chaos: {n_ssd} SSD and {n_ds2b} DS2 "
                             f"batches launched {launches}")
    # each batch's rows against the same batch through its rung again
    by_rid = {r.rid: r for r in rt.requests}
    tiers = {"ssd": ssd_tiers, "ds2": ds2_tiers}
    rows_err, texts_equal, fwd_ms = 0.0, 0, {"ssd": [], "ds2": []}
    for b in seen:
        t1 = time.perf_counter()
        again = tiers[b["model"]][b["tier"]].forward(dict(b["batch"]))
        fwd_ms[b["model"]].append((time.perf_counter() - t1) * 1e3)
        for i, rid in enumerate(b["rids"]):
            got = by_rid[rid].result
            if b["model"] == "ds2":
                if str(got) != str(again[i]):
                    raise AssertionError(f"fleet_chaos request {rid}: the "
                                         "served transcript differs")
                texts_equal += 1
            else:
                err = float(np.abs(np.asarray(got, np.float64)
                                   - np.asarray(again[i], np.float64)).max())
                rows_err = max(rows_err, err)
    if rows_err > FLEET_ROWS_TOL:
        raise AssertionError(f"fleet_chaos: SSD rows differ from the same "
                             f"batch again by {rows_err} (tol "
                             f"{FLEET_ROWS_TOL})")
    emit("fleet_chaos", nvidia_smi=smi, models=["ssd", "ds2"],
         ssd_batch=BATCH, ds2_hidden=DS2_HIDDEN,
         ds2_seconds_max=max(seconds), requests=len(reqs),
         service_model_s=FLEET_SERVICE_S, burst=FLEET_BURST,
         burst_rate=FLEET_BURST_RATE, tail=FLEET_TAIL,
         tail_rate=FLEET_TAIL_RATE, virtual_latency=fleet_latency(reqs),
         launches=launches, rows_max_abs_err=rows_err,
         rows_tolerance=FLEET_ROWS_TOL, ds2_texts_equal=texts_equal,
         card_forward_ms_median={m: float(np.median(v)) if v else None
                                 for m, v in fwd_ms.items()},
         drive_s=drive_s, phase_s=time.perf_counter() - t_phase, **summary)
    return launches


def sdc_batches(seed):
    """Global DS2 batches of SDC_ROWS utterances of 10 s (1000 frames),
    with random labels."""
    import numpy as np

    rng = np.random.RandomState(seed)
    out = []
    for _ in range(SDC_CLEAN + 6):
        n = np.full(SDC_ROWS, 1000, np.int32)
        labels = rng.randint(1, 29, (SDC_ROWS, 40)).astype(np.int32)
        mask = (np.arange(40)[None]
                < rng.randint(20, 41, SDC_ROWS)[:, None])
        out.append({"input": (rng.randn(SDC_ROWS, 1000, 13)
                              .astype(np.float32), n),
                    "n_frames": n, "labels": labels,
                    "label_mask": mask.astype(np.float32)})
    return out


def sdc_optimizer(mesh, root, data, steps):
    from analytics_zoo_tpu_torch.parallel import SGD, Optimizer, Trigger
    from analytics_zoo_tpu_torch.pipelines.deepspeech2 import (
        ds2_ctc_criterion, make_ds2_model)
    from analytics_zoo_tpu_torch.resilience.anomaly import AnomalyPolicy
    from analytics_zoo_tpu_torch.resilience.health import HealthPolicy
    from analytics_zoo_tpu_torch.utils import engine

    model = make_ds2_model(hidden=DS2_HIDDEN, n_rnn_layers=3,
                           rnn_engine="pallas", seed=0,
                           device=engine.device())
    return (Optimizer(model, data, ds2_ctc_criterion(), mesh=mesh)
            .set_optim_method(SGD(1e-4))
            .set_checkpoint(root, Trigger.several_iteration(2),
                            overwrite=False, keep_last=2)
            .set_anomaly_policy(AnomalyPolicy(rollback_after=3,
                                              promote_after=2,
                                              max_rollbacks=2))
            .set_health_policy(HealthPolicy(audit_every=1))
            .set_end_when(Trigger.max_iteration(steps)))


def dist_sdc_rank(batches, root):
    """One rank of dist_sdc: the audit over the un-armed steps, then the
    armed run to its DeviceQuarantine, the eviction, and the survivors'
    steps from the last-known-good tier; each part's launches."""
    import statistics

    import torch
    import torch.distributed as dist

    from analytics_zoo_tpu_torch.parallel import checkpoint as ckpt
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    from analytics_zoo_tpu_torch.parallel.elastic import (
        resume_after_quarantine)
    from analytics_zoo_tpu_torch.resilience.chaos import (ChaosMonkey,
                                                          FaultSpec)
    from analytics_zoo_tpu_torch.resilience.errors import DeviceQuarantine

    mesh = mesh_lib.create_mesh((SDC_WORLD,), ("data",))
    out = {"rank": dist.get_rank()}
    zero_kernel_counters()
    clean = sdc_optimizer(mesh, os.path.join(root, "clean"), batches,
                          SDC_CLEAN)
    clean.optimize()
    torch.cuda.synchronize()
    out["clean"] = clean._health.stats()
    out["clean_launches"] = launch_counts()
    # the audit's time at this width: the fold on the card and the gather
    audit = clean._audit_fn
    ms = []
    for _ in range(SDC_AUDIT_REPS):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        audit(clean.model)
        ms.append((time.perf_counter() - t0) * 1e3)
    out["audit_ms"] = statistics.median(ms)
    out["params"] = sum(p.numel() for p in clean.model.parameters())
    del clean
    armed_root = os.path.join(root, "armed")
    monkey = ChaosMonkey([FaultSpec("bit_flip", SDC_FLIP_AT,
                                    detail={"replica": 2, "bit": 7})])
    opt = sdc_optimizer(mesh, armed_root, monkey.dataset(batches), 50)
    zero_kernel_counters()
    err = None
    with monkey:
        try:
            opt.optimize()
        except DeviceQuarantine as e:
            err = e
    torch.cuda.synchronize()
    out["armed_launches"] = launch_counts()
    out["raised"] = [type(err).__name__, getattr(err, "device", None)]
    out["divergence"] = [e for e in opt._health.events
                         if e["kind"] == "audit_divergence"]
    lkg = ckpt.lkg_snapshot(armed_root)
    out["lkg_iteration"] = int(lkg[1]["meta"]["iteration"]) if lkg else None
    del opt
    zero_kernel_counters()
    survivors = resume_after_quarantine(
        err, mesh, armed_root, os.path.join(root, "evicted"),
        lambda m, r: sdc_optimizer(m, r, batches,
                                   out["lkg_iteration"] + 2))
    if survivors is None:
        out["evicted"] = True
        return out
    survivors.optimize()
    torch.cuda.synchronize()
    out["evicted"] = False
    out["width"] = survivors.specs.data_axis_size
    out["survivor_steps"] = len(survivors.history)
    out["survivor_losses"] = [float(m["loss"]) for m in survivors.history]
    out["survivor_audits"] = survivors._health.stats()
    out["survivor_launches"] = launch_counts()
    return out


def dist_sdc_phase(dev, smi, seed=71):
    """dist_sdc: DS2 at hidden 1760 data parallel on SDC_WORLD ranks
    under the parity audit: un-armed every audit ok, then a bit flip on
    rank 2 raises DeviceQuarantine(device=2) on every rank, rank 2 leaves
    and ranks 0-1 take two steps from the last-known-good tier."""
    import shutil
    import tempfile

    import numpy as np

    from analytics_zoo_tpu_torch.utils import engine

    t_phase = time.perf_counter()
    batches = sdc_batches(seed)
    root = tempfile.mkdtemp()
    try:
        ranks = engine.spawn(os.path.abspath(__file__) + ":dist_child",
                             SDC_WORLD, dict(task="sdc", batches=batches,
                                             root=root),
                             timeout=DIST_TIMEOUT, backend=DIST_BACKEND,
                             local_ranks=[0] * SDC_WORLD)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for r in ranks:
        div = r["divergence"]
        if (r["clean"]["audits"] != SDC_CLEAN
                or r["clean"]["audit_divergences"]
                or r["raised"] != ["DeviceQuarantine", 2]
                or len(div) != 1 or div[0]["minority"] != [2]
                or len(set(div[0]["fingerprints"])) != 2):
            raise AssertionError(f"dist_sdc rank {r['rank']}: clean "
                                 f"{r['clean']}, raised {r['raised']}, "
                                 f"divergence {div}")
        if r["clean_launches"]["persistent_rnn"] != 6 * SDC_CLEAN \
                or r["clean_launches"]["persistent_rnn_bwd"] \
                != 6 * SDC_CLEAN:
            raise AssertionError(f"dist_sdc rank {r['rank']}: clean launches "
                                 f"{r['clean_launches']}")
    if [r["evicted"] for r in ranks] != [False, False, True]:
        raise AssertionError(f"dist_sdc: evicted {[r['evicted'] for r in ranks]}")
    for r in ranks[:2]:
        if (r["width"] != 2 or r["survivor_steps"] != 2
                or r["survivor_audits"]["audit_divergences"]
                or r["survivor_audits"]["audits"] != 2
                or not all(np.isfinite(r["survivor_losses"]))
                or r["survivor_launches"]["persistent_rnn"] != 12
                or r["survivor_launches"]["persistent_rnn_bwd"] != 12):
            raise AssertionError(f"dist_sdc survivor {r['rank']}: {r}")
    if ranks[0]["survivor_losses"] != ranks[1]["survivor_losses"]:
        raise AssertionError("dist_sdc: the survivors' losses differ")
    emit("dist_sdc", nvidia_smi=smi, world=SDC_WORLD, hidden=DS2_HIDDEN,
         rows=SDC_ROWS, frames=1000, params=ranks[0]["params"],
         clean_audits=ranks[0]["clean"],
         detected_at_step=ranks[0]["divergence"][0]["step"],
         flip_armed_before_batch=SDC_FLIP_AT,
         fingerprints=ranks[0]["divergence"][0]["fingerprints"],
         raised=[r["raised"] for r in ranks],
         lkg_iteration=ranks[0]["lkg_iteration"],
         survivors_width=ranks[0]["width"],
         survivor_losses=ranks[0]["survivor_losses"],
         audit_ms_by_rank=[r["audit_ms"] for r in ranks],
         launches_by_rank=[{part: r.get(part + "_launches")
                            for part in ("clean", "armed", "survivor")}
                           for r in ranks],
         phase_s=time.perf_counter() - t_phase)
    total = {k: 0 for k in ranks[0]["clean_launches"]}
    for r in ranks:
        for part in ("clean", "armed", "survivor"):
            for k, v in (r.get(part + "_launches") or {}).items():
                total[k] += v
    return total


def dist_slice_rank(requests):
    """One rank of dist_slice: SSD300's rungs on this rank's slice (the
    whole 2-rank mesh, one width-2 replica); rank 0 serves the requests
    through ``ServingRuntime(slice_width=2, device_budget=2)``, tries a
    second slice, and returns the rows; rank 1 follows."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from analytics_zoo_tpu_torch.models.ssd import SSDVgg
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    from analytics_zoo_tpu_torch.parallel.specs import pipeline_specs
    from analytics_zoo_tpu_torch.pipelines.ssd import (PreProcessParam,
                                                       ssd_serving_tiers)
    from analytics_zoo_tpu_torch.serving import (MonotonicClock,
                                                 ServingRuntime,
                                                 serve_follower,
                                                 SliceLayout)
    from analytics_zoo_tpu_torch.utils import engine

    dev = engine.device()
    mesh = mesh_lib.create_mesh((DIST_WORLD,), ("data",))
    layout = SliceLayout(pipeline_specs("ssd", mesh=mesh), DIST_WORLD)
    tiers = ssd_serving_tiers(SSDVgg(21, 300, device=dev, seed=0),
                              PreProcessParam(batch_size=BATCH,
                                              resolution=300),
                              specs=layout.specs, device=dev)
    warm = np.stack(requests[:BATCH])
    for t in tiers:                 # every rank: cuDNN's choice, each rung
        t.forward({"input": warm})
    torch.cuda.synchronize()
    zero_kernel_counters()
    if dist.get_rank() != 0:
        out = {"follower": serve_follower(layout.specs, tiers=tiers)}
        torch.cuda.synchronize()
        out["launches"] = launch_counts()
        return out
    rt = ServingRuntime(tiers, n_replicas=1, max_batch=BATCH,
                        queue_capacity=4 * len(requests), length_key=None,
                        default_deadline_s=3600.0, clock=MonotonicClock(),
                        wedge_timeout_s=DS2_WEDGE_S,
                        specs=layout.specs, slice_width=DIST_WORLD,
                        device_budget=DIST_WORLD)
    reqs = []
    t0 = time.perf_counter()
    for x in requests:
        reqs.append(rt.submit({"input": x}))
        if len(reqs) % BATCH == 0:
            rt.pump(force=True)
    rt.drain()
    served_s = time.perf_counter() - t0
    acts = rt.pool.resize(2)
    snap = rt.snapshot()
    rt.close()
    torch.cuda.synchronize()
    return {"rows": [np.asarray(r.result) for r in reqs],
            "accounting": rt.accounting(), "failed": snap["metrics"]["failed"],
            "grown": acts["grown"],
            "clamped": [e for e in rt.pool.events
                        if e["kind"] == "resize_budget_clamped"],
            "slices": snap["slices"], "served_s": served_s,
            "kinds": [type(r).__name__ for r in rt.pool.replicas],
            "first_error": next((e["error"] for e in rt.pool.events
                                 if e["kind"] == "replica_fenced"), None),
            "launches": launch_counts()}


def dist_slice_phase(dev, smi, seed=73):
    """dist_slice: SSD300 requests through one width-2 mesh slice of the
    2 ranks under device_budget=2; a second slice refused by the budget;
    the rows against one process's runtime over the same requests."""
    import numpy as np

    from analytics_zoo_tpu_torch.models.ssd import SSDVgg
    from analytics_zoo_tpu_torch.pipelines.ssd import (BGR_MEANS,
                                                       PreProcessParam,
                                                       ssd_serving_tiers)
    from analytics_zoo_tpu_torch.serving import (MonotonicClock,
                                                 ServingRuntime)
    from analytics_zoo_tpu_torch.utils import engine

    t_phase = time.perf_counter()
    rng = np.random.RandomState(seed)
    requests = [rng.randint(0, 256, (300, 300, 3)).astype(np.float32)
                - np.float32(BGR_MEANS) for _ in range(SLICE_REQUESTS)]
    ranks = engine.spawn(os.path.abspath(__file__) + ":dist_child",
                         DIST_WORLD, dict(task="slice", requests=requests),
                         timeout=DIST_TIMEOUT, backend=DIST_BACKEND,
                         local_ranks=[0] * DIST_WORLD)
    lead, follower = ranks[0], ranks[1]["follower"]
    clamped = lead["clamped"]
    if (lead["accounting"]["by_state"] != {"done": SLICE_REQUESTS}
            or lead["failed"] or lead["grown"] or len(clamped) != 1
            or clamped[0]["device_budget"] != DIST_WORLD
            or clamped[0]["width"] != DIST_WORLD
            or lead["kinds"] != ["ReplicaSlice"]
            or lead["slices"]["devices_used"] != DIST_WORLD
            or follower["failed"] or follower["run"] < 1):
        raise AssertionError(f"dist_slice: {lead['accounting']}, clamped "
                             f"{clamped}, slices {lead['slices']}, follower "
                             f"{follower}, first error {lead['first_error']}")
    tiers = ssd_serving_tiers(SSDVgg(21, 300, device=dev, seed=0),
                              PreProcessParam(batch_size=BATCH,
                                              resolution=300), device=dev)
    for t in tiers:
        t.forward({"input": np.stack(requests[:BATCH])})
    rt = ServingRuntime(tiers, n_replicas=1, max_batch=BATCH,
                        queue_capacity=4 * SLICE_REQUESTS, length_key=None,
                        default_deadline_s=3600.0, clock=MonotonicClock(),
                        wedge_timeout_s=DS2_WEDGE_S)
    reqs = []
    for x in requests:
        reqs.append(rt.submit({"input": x}))
        if len(reqs) % BATCH == 0:
            rt.pump(force=True)
    rt.drain()
    want = np.stack([np.asarray(r.result) for r in reqs])
    got = np.stack(lead["rows"])
    matched = match_images(got, want)
    if matched[0] < DIST_MATCH_MIN or matched[2] > DIST_SCORE_TOL:
        raise AssertionError(f"dist_slice rows against one process's: "
                             f"{matched}")
    launches = {k: lead["launches"][k] + ranks[1]["launches"][k]
                for k in lead["launches"]}
    if launches["fused_detection_output"] < 1:
        raise AssertionError(f"dist_slice: launches {launches}")
    emit("dist_slice", nvidia_smi=smi, world=DIST_WORLD,
         slice_width=DIST_WORLD, device_budget=DIST_WORLD,
         requests=SLICE_REQUESTS, accounting=lead["accounting"],
         resize_refused=clamped[0], slices=lead["slices"],
         follower=follower, rows_matched_min=matched[0],
         rows_matched_mean=matched[1], rows_score_err=matched[2],
         rows_equal_share=float(np.mean([np.array_equal(g, w)
                                         for g, w in zip(got, want)])),
         served_s=lead["served_s"],
         launches_by_rank=[lead["launches"], ranks[1]["launches"]],
         phase_s=time.perf_counter() - t_phase)
    return launches


# ---------------------------------------------------------------------------
# 6v. accuracy: SSD300 trained from scratch on the rendered shapes through
# the port's entry points, then the quantized-mAP tool on its weights
# ---------------------------------------------------------------------------

#: the reference's bar on the final VOC07 mAP (examples/train_shapes_e2e.py)
ACCURACY_MIN_MAP = 0.5
#: K1's and K2's rungs: both hold their keep masks equal to their plain
#: versions, so their mAPs agree
ACCURACY_K1_K2_TOL = 1e-6


def accuracy_phase(dev, smi, kernel_ms=None):
    """accuracy: ``examples/train_shapes_e2e.run`` at the reference's
    defaults (800 + 200 shapes records, ``SSDVgg(4, 300)``, bf16 Adam 3e-4,
    device augmentation, validation through K2 and a snapshot every epoch,
    an end at mAP 0.9 or epoch 30), then
    ``tools/eval_quantized_ssd.run`` on the weights it saved: ``--approx``
    on the fused backend (the rungs fp, int8_weight_only, int8_compute
    and bf16 through K2, fp_approx_topk through K1) and again with
    ``--backend pallas`` (every rung through K1).  Fails where the final
    mAP is not above ``ACCURACY_MIN_MAP``, where the fp rungs of K1 and
    K2 differ by more than ``ACCURACY_K1_K2_TOL`` or where a rung raises;
    the int8 and bf16 deltas are reported.  K1 and K2 are then held to
    their plain versions (K1's keep mask equal, K2's rows by ``rows_err``)
    and timed on the trained model's detections of 8 validation images,
    printed beside ``kernel_ms``, this run's K1/K2 ms on SSD300's random and
    trained-like scores.  Returns the phase's launches."""
    import tempfile

    import torch

    from analytics_zoo_tpu_torch.examples import train_shapes_e2e
    from analytics_zoo_tpu_torch.models.ssd import build_priors, config_for
    from analytics_zoo_tpu_torch.ops import pallas_detout, pallas_nms
    from analytics_zoo_tpu_torch.ops.detection_output import (
        DetectionOutputParam, sweep_candidates)
    from analytics_zoo_tpu_torch.pipelines import (PreProcessParam,
                                                   load_val_set)
    from analytics_zoo_tpu_torch.tools import eval_quantized_ssd as tool

    t0 = time.perf_counter()
    zero_kernel_counters()
    with tempfile.TemporaryDirectory() as tmp:
        params = os.path.join(tmp, "ssd_shapes.pt")
        argv = ["--params-out", params, "--device", str(dev)]
        args = train_shapes_e2e.build_parser().parse_args(argv)
        report, details = train_shapes_e2e.run(args, tmp)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = launch_counts()
        model = details["model"]
        runs = {}
        for backend in ("fused", "pallas"):
            targv = ["--params", params, "--backend", backend, "--device",
                     str(dev), "--out", os.path.join(tmp, f"{backend}.json")]
            if backend == "fused":
                targv.append("--approx")
            runs[backend] = tool.run(tool.build_parser().parse_args(targv))
        torch.cuda.synchronize()
        launches = launch_counts()
        phase_s = time.perf_counter() - t0

        # K1 and K2 on the trained model's detections of 8 val images
        n = len(details["ap_per_class"]) + 1
        pre = PreProcessParam(batch_size=BATCH, resolution=300, max_gt=8)
        batch = next(iter(load_val_set(os.path.join(tmp, "val-*.azr"), pre,
                                       device=dev)))
        x = torch.as_tensor(batch["input"], device=dev)
        with torch.inference_mode():
            loc, conf = model.module(x)
            probs = torch.softmax(conf, -1)
        priors, variances = build_priors(config_for(300))
        pri = torch.as_tensor(priors, device=dev)
        var = torch.as_tensor(variances, device=dev)
        post = DetectionOutputParam(n_classes=n)
        dets = pallas_detout.fused_detection_output(loc, probs, pri, var,
                                                    param=post)
        torch.cuda.synchronize()
        k2_err = rows_err(dets, pallas_detout.fused_detection_output_plain(
            loc, probs, pri, var, post))
        k2_ms = cuda_ms(lambda: pallas_detout.fused_detection_output(
            loc, probs, pri, var, param=post), 20)
        k2_bound, k2_by = bound(*detout_work(loc, probs, pri, var, post))
        boxes, top, valid, _ = sweep_candidates(loc, probs, pri, var, post)
        B, Cf, k = top.shape
        planes = [boxes[..., i].reshape(B * Cf, k).contiguous()
                  for i in range(4)] + [valid.reshape(B * Cf, k)]
        keep = pallas_nms.nms_sweep(*planes)
        torch.cuda.synchronize()
        k1_err = (keep.float() - pallas_nms.nms_sweep_plain(*planes).float()
                  ).abs().max().item()
        if k1_err != 0:
            raise AssertionError(f"accuracy: K1's keep mask differs from its "
                                 f"plain version on the trained detections "
                                 f"({k1_err})")
        k1_ms = cuda_ms(lambda: pallas_nms.nms_sweep(*planes), 50)
        k1_bound, k1_by = bound(6 * planes[0].numel() * 4,
                                sweep_ops(keep, planes[4]))
        kept = int(keep.sum().item())

    (fused, fused_maps), (pallas, pallas_maps) = runs["fused"], runs["pallas"]
    k1_k2 = {"fp_fused_vs_pallas": abs(fused_maps["fp"] - pallas_maps["fp"]),
             "fp_fused_vs_approx_topk": abs(fused_maps["fp"]
                                            - fused_maps["fp_approx_topk"])}
    print(json.dumps({"accuracy": {
        "epochs": details["epochs"], "epochs_max": args.epochs,
        "final_map": details["final_map"],
        "ap_per_class": details["ap_per_class"],
        "val_map_by_epoch": [h.get("MeanAveragePrecision")
                             for h in details["val_history"]],
        "report": report,
        "rungs": {"fused": fused_maps, "pallas": pallas_maps},
        "deltas": {k: v for k, v in fused.items()
                   if k.startswith("delta_")},
        "deltas_pallas": {k: v for k, v in pallas.items()
                          if k.startswith("delta_")},
        "k1_vs_k2_map": k1_k2,
        "launches": {"train": train_launches, "phase": launches},
        "trained_detections": {
            "batch": int(B), "rows": int(B * Cf), "candidates": int(k),
            "k1_kept": kept, "k1_max_abs_err": k1_err,
            "k2_max_abs_err": k2_err, "k1_ms": k1_ms, "k1_bound_ms": k1_bound,
            "k1_bound_by": k1_by, "k2_ms": k2_ms, "k2_bound_ms": k2_bound,
            "k2_bound_by": k2_by},
        "ssd300_scores_ms": kernel_ms or {},
        "train_s": train_s, "phase_s": phase_s,
        "nvidia_smi": smi}}), flush=True)
    if not details["final_map"] > ACCURACY_MIN_MAP:
        raise AssertionError(f"accuracy: final mAP {details['final_map']} "
                             f"not above {ACCURACY_MIN_MAP}")
    if max(k1_k2.values()) > ACCURACY_K1_K2_TOL:
        raise AssertionError(f"accuracy: K1 and K2 rungs differ {k1_k2} "
                             f"(tol {ACCURACY_K1_K2_TOL})")
    if not (launches["nms_sweep"] and launches["fused_detection_output"]):
        raise AssertionError(f"accuracy: launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# 6w. the command-line examples on the card: DS2 training, inference and
# long audio (K3, K4), AttentionASR, Faster-RCNN predict and shapes
# training, the zoo, the augmentation demo (K1-K4 none)
# ---------------------------------------------------------------------------

#: DS2 at full width for one training epoch of 2 synthetic batches, and
#: for inference over EXAMPLES_WAVS seeded 30 s wavs in one batch of 8
EXAMPLES_DS2_FULL = ("--hidden", "1760")
EXAMPLES_WAVS = 8
EXAMPLES_WAV_S = 30
#: K3's fp32 tolerance (PERF.md §6): the pallas run's log-probs against
#: the blocked loop's, relative L2
EXAMPLES_K3_TOL = 1e-4
#: train_frcnn_shapes cut from its 20 epochs to fit the phase
EXAMPLES_FRCNN_EPOCHS = 2
#: fraud_detection cut from 20 bagged models x 10 epochs (some 147,000
#: eager steps of a 29-10-2 MLP, 681 s on the card) to fit the phase
EXAMPLES_FRAUD_CUT = ("--models", "4", "--epochs", "1",
                      "--threshold-from", "2", "--threshold-to", "4")
EXAMPLES_JPEGS = 8
EXAMPLES_FRCNN_SIZE = 512
EXAMPLES_RANKS = 2


def write_wav(path, samples, rate=16000) -> None:
    """16-bit mono PCM through the standard library's ``wave``."""
    import wave

    import numpy as np

    pcm = np.clip(np.round(samples * 32767.0), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def examples_rank(name, argv):
    """One rank of a multi-rank example: its ``run`` with the counts
    zeroed just before, and this rank's launches just after."""
    import importlib

    import torch

    mod = importlib.import_module(f"analytics_zoo_tpu_torch.examples.{name}")
    args = mod.build_parser().parse_args(argv)
    zero_kernel_counters()
    out = mod.run(args)
    torch.cuda.synchronize()
    launches = launch_counts()
    if isinstance(out, tuple):
        out = out[0]
    return {"out": out, "launches": launches}


def examples_phase(dev, smi):
    """examples: each ported example's ``run`` (what its ``main`` runs,
    less the printing) on the card, on data made here, the counts set to
    0 just before each and read just after, a line each:
    ``train_ds2`` at its defaults through K3/K4 and one epoch at hidden
    1760 × 3 layers; ``ds2_inference`` at hidden 1760 over 8 seeded 30 s
    wavs through K3 and through the blocked loop (log-probs within
    ``EXAMPLES_K3_TOL``, transcripts equal); ``long_audio_asr`` and
    ``train_attention_asr --variant ring`` on two ranks over gloo;
    ``train_attention_asr`` full and moe; ``predict_frcnn`` on its demo
    batch and on 8 rendered JPEGs at 512²; ``train_frcnn_shapes`` cut to
    ``EXAMPLES_FRCNN_EPOCHS``; ``fraud_detection`` cut to
    ``EXAMPLES_FRAUD_CUT``, ``recommender`` and ``sentiment`` at their
    defaults; ``image_augmentation`` on a rendered
    JPEG.  Fails where an example raises, a report's device is not the
    card, or a launch count is not what its path implies (K3 and K4 in
    DS2 training, K3 in DS2 inference and on each long-audio rank, none
    of K1-K4 elsewhere).  Returns the phase's launches."""
    import tempfile

    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.data import native
    from analytics_zoo_tpu_torch.data.synthetic import render_shapes_image
    from analytics_zoo_tpu_torch.examples import (
        ds2_inference, fraud_detection, image_augmentation, predict_frcnn,
        recommender, sentiment, train_attention_asr, train_ds2,
        train_frcnn_shapes)
    from analytics_zoo_tpu_torch import parallel
    from analytics_zoo_tpu_torch.examples.common import device_name
    from analytics_zoo_tpu_torch.transform.audio import read_audio
    from analytics_zoo_tpu_torch.utils import engine

    t_phase = time.perf_counter()
    card = device_name(dev)
    codec = native.codec_for(dev)
    names = ("nms_sweep", "fused_detection_output", "persistent_rnn",
             "persistent_rnn_bwd")
    total = dict.fromkeys(names, 0)
    d = ["--device", str(dev)]

    def add(launches):
        for k in names:
            total[k] += launches[k]

    def counted(fn):
        zero_kernel_counters()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        launches = launch_counts()
        add(launches)
        return out, launches, time.perf_counter() - t0

    def expect(what, launches, k3=False, k4=False):
        want = {"nms_sweep": False, "fused_detection_output": False,
                "persistent_rnn": k3, "persistent_rnn_bwd": k4}
        got = {k: launches[k] > 0 for k in names}
        if got != want:
            raise AssertionError(f"examples: {what} launched {launches}; "
                                 f"its path implies {want}")

    def on_card(what, report):
        if report["device"] != card or report["backend"] != dev.type:
            raise AssertionError(f"examples: {what} reported "
                                 f"{report['device']!r} on "
                                 f"{report['backend']!r}, not {card!r}")

    def parse(mod, argv):
        return mod.build_parser().parse_args(list(argv) + d)

    def spawn(name, argv):
        t0 = time.perf_counter()
        ranks = engine.spawn(os.path.abspath(__file__) + ":dist_child",
                             EXAMPLES_RANKS,
                             dict(task="examples", name=name,
                                  argv=list(argv) + d),
                             timeout=DIST_TIMEOUT, device=dev.type,
                             backend=DIST_BACKEND,
                             local_ranks=[0] * EXAMPLES_RANKS)
        for r in ranks:
            add(r["launches"])
        return ranks, time.perf_counter() - t0

    lines = {}
    with tempfile.TemporaryDirectory() as tmp:
        # -- DS2 training, defaults through K3/K4, then at full width --
        (rep, _), l, s = counted(lambda: train_ds2.run(parse(
            train_ds2, ["--rnn-engine", "pallas"])))
        on_card("train_ds2", rep)
        expect("train_ds2", l, k3=True, k4=True)
        (full, _), lf, sf = counted(lambda: train_ds2.run(parse(
            train_ds2, [*EXAMPLES_DS2_FULL, "--rnn-layers", "3",
                        "--batches", "2", "--epochs", "1",
                        "--rnn-engine", "pallas"])))
        on_card("train_ds2 full width", full)
        expect("train_ds2 full width", lf, k3=True, k4=True)
        lines["train_ds2"] = {
            "cer": rep["cer"], "beam_cer": rep["beam_cer"],
            "exact_sequence_acc": rep["exact_sequence_acc"],
            "launches": l, "s": s,
            "full_width": {"hidden": 1760, "rnn_layers": 3, "batches": 2,
                           "epochs": 1, "cer": full["cer"], "launches": lf,
                           "s": sf}}

        # -- DS2 inference at full width: K3 against the blocked loop --
        wav_dir = os.path.join(tmp, "wavs")
        os.makedirs(wav_dir)
        utts = synthetic_utterances([EXAMPLES_WAV_S] * EXAMPLES_WAVS, 0)
        for uid, x in utts.items():
            write_wav(os.path.join(wav_dir, f"{uid}.wav"), x)
        inf_argv = ["-d", wav_dir, *EXAMPLES_DS2_FULL, "--layers", "3",
                    "-s", str(EXAMPLES_WAV_S), "-b", str(EXAMPLES_WAVS)]
        k3_run, lk, sk = counted(lambda: ds2_inference.run(parse(
            ds2_inference, inf_argv + ["--rnn-engine", "pallas"])))
        expect("ds2_inference pallas", lk, k3=True)
        plain_run, lp, sp = counted(lambda: ds2_inference.run(parse(
            ds2_inference, inf_argv + ["--rnn-engine", "blocked"])))
        expect("ds2_inference blocked", lp)
        k3_pipe, plain_pipe = k3_run["pipeline"], plain_run["pipeline"]
        for pipe in (k3_pipe, plain_pipe):
            if pipe.device.type != dev.type:
                raise AssertionError(f"examples: ds2_inference on "
                                     f"{pipe.device}")
        for (k, a), b in zip(k3_pipe.model.state_dict().items(),
                             plain_pipe.model.state_dict().values()):
            if not torch.equal(a, b):
                raise AssertionError(f"examples: ds2_inference engines' "
                                     f"weights differ at {k}")
        segments = []
        for path in sorted(k3_run["transcripts"]):
            samples, _ = read_audio(path)
            segments.extend(k3_pipe.segmenter.segment(samples, path))
        feats = torch.from_numpy(k3_pipe._featurize_device(segments)).to(dev)
        with torch.inference_mode():
            lp_k3 = k3_pipe._eval_step(feats).double()
            lp_plain = plain_pipe._eval_step(feats).double()
        rel = (torch.linalg.vector_norm(lp_k3 - lp_plain)
               / torch.linalg.vector_norm(lp_plain)).item()
        same = k3_run["transcripts"] == plain_run["transcripts"]
        lines["ds2_inference"] = {
            "wavs": EXAMPLES_WAVS, "seconds": EXAMPLES_WAV_S,
            "hidden": 1760, "layers": 3, "logp_rel_l2": rel,
            "tol": EXAMPLES_K3_TOL, "transcripts_equal": same,
            "transcript_chars": [len(t) for t in
                                 k3_run["transcripts"].values()],
            "launches_pallas": lk, "launches_blocked": lp,
            "s_pallas": sk, "s_blocked": sp}
        if not (rel <= EXAMPLES_K3_TOL and same):
            raise AssertionError(f"examples: ds2_inference K3 against the "
                                 f"blocked loop: {lines['ds2_inference']}")
        del k3_run, plain_run, k3_pipe, plain_pipe, feats
        torch.cuda.empty_cache()

        # -- long audio: chunked and sequence-parallel on two ranks --
        ranks, s = spawn("long_audio_asr", ["--rnn-engine", "pallas"])
        for i, r in enumerate(ranks):
            expect(f"long_audio_asr rank {i}", r["launches"], k3=True)
        lines["long_audio_asr"] = {
            "ranks": EXAMPLES_RANKS, "audio_s": ranks[0]["out"]["audio_s"],
            "chunked": ranks[0]["out"]["chunked"],
            "seqpar": ranks[0]["out"]["seqpar"],
            "seqpar_same_on_ranks": len({r["out"]["seqpar"]
                                         for r in ranks}) == 1,
            "chunked_s": [r["out"]["chunked_s"] for r in ranks],
            "seqpar_s": [r["out"]["seqpar_s"] for r in ranks],
            "launches_by_rank": [r["launches"] for r in ranks], "s": s}

        # -- AttentionASR: full and moe here, ring on two ranks --
        attn = {}
        for variant in ("full", "moe"):
            (rep, _), l, s = counted(lambda: train_attention_asr.run(parse(
                train_attention_asr, ["--variant", variant])))
            on_card(f"train_attention_asr {variant}", rep)
            expect(f"train_attention_asr {variant}", l)
            attn[variant] = {"cer": rep["cer"], "beam_cer": rep["beam_cer"],
                             "s": s}
        ranks, s = spawn("train_attention_asr", ["--variant", "ring"])
        for i, r in enumerate(ranks):
            on_card(f"train_attention_asr ring rank {i}", r["out"])
            expect(f"train_attention_asr ring rank {i}", r["launches"])
        attn["ring"] = {"cer": ranks[0]["out"]["cer"],
                        "beam_cer": ranks[0]["out"]["beam_cer"],
                        "mesh": ranks[0]["out"]["mesh"], "s": s}
        lines["train_attention_asr"] = attn

        # -- Faster-RCNN: the demo batch, then 8 rendered JPEGs --
        fargs = ["--size", str(EXAMPLES_FRCNN_SIZE)]
        demo, l, s = counted(lambda: predict_frcnn.run(parse(
            predict_frcnn, fargs)))
        expect("predict_frcnn demo", l)
        det = demo["detector"]
        img_dir = os.path.join(tmp, "jpegs")
        os.makedirs(img_dir)
        rng = np.random.RandomState(0)
        for i in range(EXAMPLES_JPEGS):
            img, _ = render_shapes_image(rng, EXAMPLES_FRCNN_SIZE)
            with open(os.path.join(img_dir, f"shape{i}.jpg"), "wb") as f:
                f.write(native.encode_jpeg(img, codec=codec))
        folder, lj, sj = counted(lambda: predict_frcnn.run(parse(
            predict_frcnn, fargs + ["--image-dir", img_dir]), detector=det))
        expect("predict_frcnn images", lj)
        if next(det.parameters()).device.type != dev.type:
            raise AssertionError("examples: predict_frcnn off the card")
        conf = predict_frcnn.build_parser().get_default("conf")
        lines["predict_frcnn"] = {
            "size": EXAMPLES_FRCNN_SIZE,
            "demo_ms_per_batch": demo["ms"], "demo_batch": 2,
            "images_ms_per_batch": folder["ms"],
            "images_batch": EXAMPLES_JPEGS,
            "detections_by_image": {
                n: int((dt[:, 1] >= conf).sum())
                for n, dt in zip(folder["names"], folder["detections"])},
            "s": s + sj}
        del demo, folder, det
        torch.cuda.empty_cache()

        # -- Faster-RCNN trained on shapes, cut to a few epochs --
        with recording_optimizer(parallel) as runs:
            (rep, _), l, s = counted(lambda: train_frcnn_shapes.run(parse(
                train_frcnn_shapes, [
                    "--epochs", str(EXAMPLES_FRCNN_EPOCHS), "--params-out",
                    os.path.join(tmp, "frcnn.pt")]), tmp))
        on_card("train_frcnn_shapes", rep)
        expect("train_frcnn_shapes", l)
        losses = [float(h["loss"]) for h in runs[0].history]
        lines["train_frcnn_shapes"] = {
            "cut": f"--epochs {EXAMPLES_FRCNN_EPOCHS} of 20",
            "loss_first": losses[0], "loss_last": losses[-1],
            "steps": len(losses), "map": rep["final_map_voc07"],
            "ap_per_class": rep["ap_per_class"], "s": s}
        torch.cuda.empty_cache()

        # -- the zoo at the examples' defaults --
        rep, l, s = counted(lambda: fraud_detection.run(parse(
            fraud_detection, EXAMPLES_FRAUD_CUT)))
        on_card("fraud_detection", rep)
        expect("fraud_detection", l)
        lines["fraud_detection"] = {"cut": " ".join(EXAMPLES_FRAUD_CUT),
                                    "auprc": rep["auprc"],
                                    "precision": rep["precision"],
                                    "recall": rep["recall"], "s": s}
        rep, l, s = counted(lambda: recommender.run(parse(recommender, [])))
        on_card("recommender", rep)
        expect("recommender", l)
        lines["recommender"] = {"model": rep["model"],
                                "mae_stars": rep["mae_stars"], "s": s}
        rep, l, s = counted(lambda: sentiment.run(parse(sentiment, [])))
        on_card("sentiment", rep)
        expect("sentiment", l)
        lines["sentiment"] = {"head": rep["head"],
                              "accuracy": rep["accuracy"], "s": s}

        # -- the augmentation demo on one rendered JPEG --
        src = os.path.join(tmp, "shape.jpg")
        img, _ = render_shapes_image(np.random.RandomState(1), 300)
        with open(src, "wb") as f:
            f.write(native.encode_jpeg(img, codec=codec))
        out_dir = os.path.join(tmp, "aug")
        written, l, s = counted(lambda: image_augmentation.run(parse(
            image_augmentation, ["-f", src, "-o", out_dir])))
        expect("image_augmentation", l)
        decoded = {}
        for name, path in written.items():
            with open(path, "rb") as f:
                m = native.decode_jpeg(f.read(), codec)
            decoded[name] = None if m is None else list(m.shape)
        if len(written) != 9 or any(v is None for v in decoded.values()):
            raise AssertionError(f"examples: image_augmentation wrote "
                                 f"{decoded}")
        lines["image_augmentation"] = {"files": len(written),
                                       "decoded": decoded, "s": s}

    print(json.dumps({"examples": {
        **lines, "launches": total,
        "phase_s": time.perf_counter() - t_phase,
        "nvidia_smi": smi}}), flush=True)
    return total


# ---------------------------------------------------------------------------
# 6u. az-analyze on the card: the source rules, and the program audit of
# the kernel-bearing targets with the sync debug mode armed
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# 6x. the tools on the card: profile_serve at its defaults (K2 by stage, K1
# on "pallas"), export_serving, convert_caffe, seqfile_to_azr, and the
# serve / telemetry / az_trace drills at their full sizes
# ---------------------------------------------------------------------------

#: K2's stage probes against their plain versions, relative: both sum in
#: float64 and cast to float32 once, so they may differ in the last bit
TOOLS_PROBE_TOL = 1e-6
TOOLS_DS2_HIDDEN = 1760


def stage_bound(stage, loc, conf, priors, variances, post):
    """(ms, by) of the least time K2's ``stage`` could take on these
    inputs: "decode" reads loc, priors and variances once, writes the
    probes and decodes and sums every prior (22 operations a prior);
    "select" is the fused work without the merge plus that decode;
    "full" ``detout_work``."""
    B, P, _ = conf.shape
    decode_ops = B * P * 22
    if stage == "decode":
        return bound(4 * (loc.numel() + 8 * P + B * post.keep_topk * 6),
                     decode_ops)
    nbytes, ops = detout_work(loc, conf, priors, variances, post)
    if stage == "select":
        merge = B * post.keep_topk * max(1, math.ceil(math.log2(
            max(conf.shape[2] - 1, 2))))
        return bound(nbytes, ops - merge + decode_ops)
    return bound(nbytes, ops)


def tools_phase(dev, smi):
    """tools: the port's command-line tools on the card, each through its
    ``run``/``main`` as ``python -m`` calls it.  K1-K4's counts are zeroed
    just before and read just after the tools run (``profile_serve`` at
    the reference's defaults, SSD300, 21 classes, batch 128, bg-bias 8,
    bf16, for ``--backend fused`` (K2's "decode", "select" and "full") and
    ``pallas`` (K1); ``export_serving --verify`` for SSD300 at 21 classes
    and DS2 at hidden ``TOOLS_DS2_HIDDEN``; ``convert_caffe`` of a seeded
    SSD300 caffemodel (``ssd300_deploy_prototxt``), to the ``--ssd 300``
    npz and ``--build``; a ``seqfile_to_azr`` round trip of 16 shapes
    records; ``serve_drill``, ``obs_drill`` (its overhead A/B timed on the
    card) and ``az_trace --drill`` at their full sizes, ``az_trace
    --sentinel`` against the drill's own report, ``check_artifacts`` over
    every report).  Then, launches outside the count: each K2 stage on
    the backbone's loc/conf against its plain version (probes within
    ``TOOLS_PROBE_TOL`` relative, "full" rows by ``rows_err``), its ms
    (CUDA events) and bound; the npz loaded into ``SSDVgg`` with nothing
    missing; the built graph's detections EQUAL to the graph loaded from
    the caffemodel directly.  Fails on any ``checks`` entry false, a
    replay that is not byte-identical, a verify past its bound, or a
    tool's non-zero exit.  Prints a ``tools`` line, a ``tools_profile``
    line and a ``timing`` line; returns the counted launches."""
    import os
    import tempfile

    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.core.module import Model
    from analytics_zoo_tpu_torch.data.records import read_ssd_records
    from analytics_zoo_tpu_torch.data.synthetic import generate_shapes_records
    from analytics_zoo_tpu_torch.models import DeepSpeech2, SSDVgg
    from analytics_zoo_tpu_torch.ops import pallas_detout
    from analytics_zoo_tpu_torch.tools import (az_trace, check_artifacts,
                                               convert_caffe, export_serving,
                                               obs_drill, profile_serve,
                                               seqfile_to_azr, serve_drill)
    from analytics_zoo_tpu_torch.utils import caffe
    from analytics_zoo_tpu_torch.utils.convert import load_weights_by_name

    k2 = pallas_detout.fused_detection_output
    t_phase = time.perf_counter()
    seconds = {}
    tmp = tempfile.mkdtemp(prefix="tools-")
    # the seeded SSD300 caffemodel convert_caffe reads (building the graph
    # runs it once on zeros: a K2 launch outside the count)
    rng = np.random.RandomState(83)
    proto = os.path.join(tmp, "deploy.prototxt")
    with open(proto, "w") as f:
        f.write(ssd300_deploy_prototxt())
    graph = caffe.build_caffe_graph(caffe.parse_prototxt(proto), device=dev)
    caffemodel = os.path.join(tmp, "ssd300.caffemodel")
    caffe.save_caffemodel(caffemodel, seeded_caffe_net(graph, rng))
    del graph
    zero_kernel_counters()
    k2.launches_by_stage = dict.fromkeys(pallas_detout.STAGES, 0)

    # -- the tools, counted --------------------------------------------------
    profiles, by_backend, details = {}, {}, None
    for backend in ("fused", "pallas"):
        t0 = time.perf_counter()
        before = launch_counts()
        out = os.path.join(tmp, f"SERVE_PROFILE_{backend}_torch.json")
        args = profile_serve.build_parser().parse_args(
            ["--backend", backend, "--device", str(dev), "--out", out])
        report, det = profile_serve.run(args)
        with open(out, "w") as f:
            json.dump(report, f)
        torch.cuda.synchronize()
        profiles[backend] = report
        by_backend[backend] = {k: v - before[k]
                               for k, v in launch_counts().items()}
        if backend == "fused":
            details = det
        seconds[f"profile_serve_{backend}"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    exports = {}
    for arch, module, extra in (
            ("ssd300", SSDVgg(21, 300, device=dev), ["--classes", "21"]),
            ("ds2", DeepSpeech2(hidden=TOOLS_DS2_HIDDEN, device=dev),
             ["--hidden", str(TOOLS_DS2_HIDDEN)])):
        model_file = os.path.join(tmp, f"{arch}.pt")
        Model(module, device=dev).save(model_file)
        del module
        rep = export_serving.run(export_serving.build_parser().parse_args(
            ["--model-file", model_file, "--arch", arch, "--out",
             os.path.join(tmp, f"{arch}_int8.npz"), "--verify", "--device",
             str(dev), *extra]))
        exports[arch] = {"quantized_mb": rep["quantized_bytes"] / 1e6,
                         "fp32_mb": rep["fp32_bytes"] / 1e6,
                         "disk_mb": rep["disk_bytes"] / 1e6,
                         "verify": rep["verify"]}
    seconds["export_serving"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    npz = os.path.join(tmp, "ssd300_vgg.npz")
    if convert_caffe.main([caffemodel, "--ssd", "300", "-o", npz]) != 0:
        raise AssertionError("convert_caffe --ssd 300 failed")
    built_path = os.path.join(tmp, "ssd300_graph.pt")
    built = convert_caffe.run(convert_caffe.build_parser().parse_args(
        [caffemodel, "--prototxt", proto, "--build", "-o", built_path,
         "--device", str(dev)]))
    seconds["convert_caffe"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    shards = generate_shapes_records(os.path.join(tmp, "shapes"),
                                     n_images=16, num_shards=2, seed=5,
                                     device=dev)
    records = list(read_ssd_records(shards))
    seq = os.path.join(tmp, "shapes.seq")
    seqfile_to_azr.write_sequence_file(
        seq, [seqfile_to_azr.encode_reference_record(r) for r in records])
    if seqfile_to_azr.main([seq, "-o", os.path.join(tmp, "back"), "-p",
                            "3"]) != 0:
        raise AssertionError("seqfile_to_azr failed")
    back = list(read_ssd_records(sorted(
        os.path.join(tmp, n) for n in os.listdir(tmp)
        if n.startswith("back-"))))
    key = lambda r: os.path.basename(r.path)  # noqa: E731
    round_trip = (len(back) == len(records) and all(
        a.data == b.data and key(a) == key(b) and np.array_equal(a.gt, b.gt)
        for a, b in zip(sorted(records, key=key), sorted(back, key=key))))
    seconds["seqfile_to_azr"] = time.perf_counter() - t0

    drills = {}
    t0 = time.perf_counter()
    sd_out = os.path.join(tmp, "SERVE_DRILL_torch.json")
    if serve_drill.main(["--device", str(dev), "--out", sd_out]) != 0:
        raise AssertionError("serve_drill failed")
    with open(sd_out) as f:
        drills["serve_drill"] = json.load(f)
    seconds["serve_drill"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    od_out = os.path.join(tmp, "TELEMETRY_DRILL_torch.json")
    if obs_drill.main(["--device", str(dev), "--out", od_out]) != 0:
        raise AssertionError("obs_drill failed")
    with open(od_out) as f:
        drills["obs_drill"] = json.load(f)
    seconds["obs_drill"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    az_out = os.path.join(tmp, "AZ_TRACE_torch.json")
    flight = os.path.join(tmp, "flight.jsonl")
    if az_trace.main(["--drill", "--device", str(dev), "--out", az_out,
                      "--flight-out", flight]) != 0:
        raise AssertionError("az_trace --drill failed")
    with open(az_out) as f:
        drills["az_trace"] = json.load(f)
    sentinel = az_trace.main(["--sentinel", az_out, "--device", str(dev)])
    query = az_trace.main(["--flight", flight, "--attribute",
                           "--slo-report"])
    seconds["az_trace"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = launch_counts()
    by_stage = dict(k2.launches_by_stage)
    lint = check_artifacts.check_artifacts(tmp)

    # -- checks, launches not counted ----------------------------------------
    loc, conf = details["loc"], details["conf"]
    pri, var, post = details["priors"], details["variances"], details["post"]
    stages = {}
    for stage in pallas_detout.STAGES:
        got = k2(loc, conf, pri, var, param=post, stage=stage)
        torch.cuda.synchronize()
        want = pallas_detout.fused_detection_output_plain(
            loc, conf, pri, var, post, stage=stage)
        if stage == "full":
            err = rows_err(got, want)
            rel = None
        else:
            if not torch.equal(got, got[:, :1, :1].expand_as(got)):
                raise AssertionError(f"K2 {stage}: a probe block holds "
                                     "more than one value")
            err = (got - want).abs().max().item()
            rel = err / max(want.abs().max().item(), 1e-30)
            if not rel <= TOOLS_PROBE_TOL:
                raise AssertionError(f"K2 {stage} probe: relative error "
                                     f"{rel} (tol {TOOLS_PROBE_TOL})")
        again = k2(loc, conf, pri, var, param=post, stage=stage)
        torch.cuda.synchronize()
        b_ms, b_by = stage_bound(stage, loc, conf, pri, var, post)
        stages[stage] = {
            "max_abs_err": err, "rel_err": rel,
            "repeat_bit_equal": bool(torch.equal(got, again)),
            "probe_image0": None if stage == "full"
            else got[0, 0, 0].item(),
            "plain_probe_image0": None if stage == "full"
            else want[0, 0, 0].item(),
            "ms": cuda_ms(lambda: k2(loc, conf, pri, var, param=post,
                                     stage=stage), 20),
            "plain_ms": cuda_ms(lambda: pallas_detout.
                                fused_detection_output_plain(
                                    loc, conf, pri, var, post, stage=stage),
                                1, 1),
            "bound_ms": b_ms, "bound_by": b_by}
        if not stages[stage]["repeat_bit_equal"]:
            raise AssertionError(f"K2 {stage}: two launches differ")
    ssd_state = SSDVgg(21, 300, device=dev).state_dict()
    _, rep = load_weights_by_name(ssd_state, dict(np.load(npz)))
    x = torch.from_numpy(np.random.RandomState(3).rand(2, 300, 300, 3)
                         .astype(np.float32) * 255 - 120).to(dev)
    direct = caffe.build_caffe_graph(caffe.parse_prototxt(proto), device=dev)
    direct.load_state_dict(caffe.load_caffe_weights(direct, caffemodel)[0])
    rebuilt = caffe.build_caffe_graph(caffe.parse_prototxt(proto),
                                      device=dev)
    rebuilt.load_state_dict(torch.load(built_path, map_location=dev))
    with torch.inference_mode():
        graph_equal = bool(torch.equal(rebuilt(x), direct(x)))
    del direct, rebuilt

    checks = {
        "profiles_launched_k2_by_stage": all(by_stage.values()),
        "pallas_profile_launched_k1": by_backend["pallas"]["nms_sweep"] > 0,
        "fused_profile_launched_no_k1": by_backend["fused"]["nms_sweep"] == 0,
        "no_k3_k4": not (launches["persistent_rnn"]
                         or launches["persistent_rnn_bwd"]),
        "export_verify_within_bound": all(
            c["rel"] < export_serving.VERIFY_REL_MAX
            for e in exports.values() for c in e["verify"].values()),
        "caffe_npz_loads_ssdvgg_whole": not (rep["missing"]
                                             or rep["unused"]),
        "caffe_build_loaded_whole": not (built["report"]["missing"]
                                         or built["report"]["unused"]),
        "caffe_built_graph_equal": graph_equal,
        "seqfile_round_trip_equal": round_trip,
        "artifacts_lint_clean": lint == [],
        "az_trace_sentinel_clean": sentinel == 0,
        "az_trace_query_ok": query == 0,
        **{f"{name}_checks_ok": d["checks"]["ok"] and d["verdict"] == "PASS"
           for name, d in drills.items()},
        "serve_drill_replay_identical":
            drills["serve_drill"]["checks"]["replay_identical_from_seed"],
        "obs_drill_replay_identical":
            drills["obs_drill"]["serve_trace"]["replay_identical"],
        "az_trace_replay_identical":
            drills["az_trace"]["serve_trace"]["replay_identical"]
            and drills["az_trace"]["checks"]["analysis_replay_identical"],
    }
    failed = sorted(k for k, v in checks.items() if not v)
    fused = profiles["fused"]
    emit("tools_profile", nvidia_smi=smi, batch=fused["batch"],
         priors=fused["priors"],
         valid_candidates=fused["valid_candidates_per_class_row"],
         ms_fused=fused["ms"], ms_pallas=profiles["pallas"]["ms"],
         ladder=fused["detout_coherence"],
         ladder_pallas=profiles["pallas"]["detout_coherence"],
         k2_block_split_us=fused["k2_block_split_us"], stages=stages,
         launches=launches, k2_launches_by_stage=by_stage,
         launches_by_backend=by_backend)
    emit("tools", checks=checks, exports=exports,
         lint=lint, caffe_loaded=len(built["report"]["loaded"]),
         seqfile_records=len(records),
         drills={name: {"accounting": (d["drill"]["accounting"]
                                       if name == "serve_drill" else
                                       d["serve_trace"]["accounting"]),
                        "checks": d["checks"]}
                 for name, d in drills.items()},
         obs_overhead=drills["obs_drill"]["obs_overhead"])
    if failed:
        raise AssertionError(f"tools: checks failed {failed}")
    for name in os.listdir(tmp):
        os.remove(os.path.join(tmp, name))
    os.rmdir(tmp)
    emit("timing", nvidia_smi=smi, tools_phase_s=time.perf_counter()
         - t_phase, tools_s=seconds)
    return {**launches, "k2_by_stage": by_stage}


def rec_step_repeats(dev) -> bool:
    """A seeded ``rec/train`` step (the dedup lookups' segment-sum
    backward) built and run twice: its parameters, buffers and Adam
    slots after the step bit-equal."""
    import torch
    from torch.utils import _pytree as pytree

    from analytics_zoo_tpu_torch.analysis.targets import sync_audit_suite

    runs = []
    for _ in range(2):
        built = sync_audit_suite(device=dev, names=("rec/train",)
                                 )[0].build()
        built.fn(*built.args)
        torch.cuda.synchronize()
        runs.append([t.detach().cpu() for t in pytree.tree_leaves(
            built.donate_state()) if isinstance(t, torch.Tensor)])
    return len(runs[0]) == len(runs[1]) and all(
        torch.equal(a, b) for a, b in zip(*runs))


def analyze_phase(dev, smi, dist_tp):
    """analyze: ``run_source_engine`` over the port, then the program
    engine over ``analysis.targets.kernel_audit_suite`` on the card (each
    program run once, the sync debug mode armed): every target must
    record its kernels (K1 in ``ssd/serve:*``, K2 in ``ssd-fused/serve:*``,
    K3 in ``ds2/serve:*``, K3 and K4 in ``ds2-pallas/train``), and no
    violation may stand un-waived.  ``dist_tp``'s ranks audited the
    collective inventory of their tensor-parallel DS2 step: clean against
    its own ``SpecSet``, firing against a data-only one.

    The sync gate (ROADMAP F6): ``sync_audit_suite``'s programs
    (``SYNC_TARGETS``: SSD's train, eval and validation, the rec,
    Wide&Deep and sentiment train steps, Faster-RCNN's train step and
    int8 rung) are audited the same way and must show 0 debug-mode
    syncs; a seeded ``rec/train`` step run twice leaves bit-equal
    parameters and Adam slots (its segment sums in order).  Returns the
    phase's kernel launches."""
    import torch

    from analytics_zoo_tpu_torch.analysis import (format_violation,
                                                  run_source_engine)
    from analytics_zoo_tpu_torch.analysis.program import run_program_engine
    from analytics_zoo_tpu_torch.analysis.targets import (KERNEL_TARGETS,
                                                          SYNC_TARGETS,
                                                          expected_kernels,
                                                          kernel_audit_suite,
                                                          sync_audit_suite)

    t0 = time.perf_counter()
    source = run_source_engine()
    source_s = time.perf_counter() - t0
    zero_kernel_counters()
    results = {}
    program = run_program_engine(kernel_audit_suite(device=dev), results)
    sync_results = {}
    program += run_program_engine(sync_audit_suite(device=dev),
                                  sync_results)
    torch.cuda.synchronize()
    launches = launch_counts()
    rec_repeat = rec_step_repeats(dev)
    violations = source + program
    unwaived = [format_violation(v) for v in violations if not v.waived]
    missing = {name: sorted(set(expected_kernels(name)) - set(r.kernels))
               for name, r in results.items()
               if set(expected_kernels(name)) - set(r.kernels)}
    absent = [p for p in KERNEL_TARGETS
              if not any(n.startswith(p) for n in results)]
    tp = dist_tp["analyze"]
    tp_declared = [f for r in tp for f in r["declared"]]
    tp_fired = [sorted({rule for rule, _, _ in r["data_only"]}) for r in tp]
    print(json.dumps({"analyze": {
        "programs": len(results),
        "violations": {"unwaived": unwaived,
                       "waived": [format_violation(v) for v in violations
                                  if v.waived]},
        "kernels": {n: r.kernels for n, r in results.items()},
        "sync_debug": {n: r.debug_syncs for n, r in results.items()},
        "sync_targets": {n: r.debug_syncs for n, r in sync_results.items()},
        "rec_train_repeat_bit_equal": rec_repeat,
        "launches": launches,
        "dist_tp_collectives": {"declared": tp_declared,
                                "data_only_rules": tp_fired},
        "source_s": source_s, "phase_s": time.perf_counter() - t0,
        "nvidia_smi": smi}}), flush=True)
    if unwaived or missing or absent:
        raise AssertionError(f"analyze: un-waived {unwaived}, kernels "
                             f"missing {missing}, targets absent {absent}")
    synced = {n: r.debug_syncs for n, r in sync_results.items()
              if r.debug_syncs}
    if synced or sorted(sync_results) != sorted(SYNC_TARGETS):
        raise AssertionError(f"analyze: debug-mode syncs {synced} in the "
                             f"sync gate's targets {sorted(sync_results)}")
    if not rec_repeat:
        raise AssertionError("analyze: two seeded rec/train steps differ")
    if tp_declared or tp_fired != [["collective-inventory"]] * len(tp):
        raise AssertionError(f"analyze: dist_tp's collective inventory "
                             f"{tp_declared} on the declared mesh, rules "
                             f"{tp_fired} on the data-only one")
    return launches


def main() -> int:
    t_script = time.perf_counter()
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

    # -- 6e. DS2 online serving, streaming and the multiplexed pool ------
    ds2_online = ds2_online_phase(dev, smi)
    k3_err = max(k3_err, ds2_online["k3_err"])

    # -- 6f. Faster-RCNN serving: reaches none of the four kernels --------
    frcnn = frcnn_serving_phase(dev, smi)

    # -- 6g. Faster-RCNN training: reaches none of the four kernels -------
    frcnn_train = frcnn_train_phase(dev, smi)

    # -- 6h. build_caffe_graph: the SSD300 deploy net through K2 ----------
    caffe_graph = caffe_graph_phase(dev, smi)

    # -- 6i. the SSD AlexNet and MobileNet variants through K2 ------------
    variants = ssd_variants_phase(dev, smi)

    # -- 6j. the model-zoo long tail: reaches none of the four kernels ----
    zoo_s, zoo = {}, {}
    t0 = time.perf_counter()
    fraud_model, zoo["fraud"] = fraud_phase(dev, smi)
    zoo_s["fraud"] = time.perf_counter() - t0
    rec_model, zoo["rec"] = rec_phase(dev, smi)
    zoo_s["rec"] = time.perf_counter() - t0 - sum(zoo_s.values())
    sent_model, zoo["sentiment"] = sentiment_phase(dev, smi)
    zoo_s["sentiment"] = time.perf_counter() - t0 - sum(zoo_s.values())
    zoo["zoo_pool"] = zoo_pool_phase(dev, smi, fraud_model, rec_model,
                                     sent_model)
    zoo_s["zoo_pool"] = time.perf_counter() - t0 - sum(zoo_s.values())
    emit("timing", nvidia_smi=smi, zoo_phases_s=zoo_s,
         zoo_total_s=time.perf_counter() - t0)

    def zoo_paths(name):
        return {path: counts[name] for path, counts in zoo.items()}

    # -- 6k. DS2 training checkpointed, crashed and resumed: K3 and K4 ----
    t0 = time.perf_counter()
    resume = ds2_resume_phase(dev, smi, train_batches, samples,
                              sample_lengths, labels)
    resume_s = time.perf_counter() - t0

    # -- 6l. SSD serving across live weight swaps: K2 ---------------------
    swap = ssd_swap_phase(dev, smi)
    emit("timing", nvidia_smi=smi, ds2_resume_phase_s=resume_s,
         ssd_swap_phase_s=time.perf_counter() - t0 - resume_s)

    # -- 6m. data-parallel DS2 (K3, K4) and SSD300 (K2) over two ranks ----
    dist_dp = dist_dp_phase(dev, smi)

    # -- 6n. tensor-parallel SSD300 and DS2 over two ranks; NCCL at 1 ----
    dist_tp = dist_tp_phase(dev, smi)

    # -- 6o. DS2 time-sharded over two ranks: K3 a chunk, K4 under grad --
    dist_seq = dist_seq_phase(dev, smi)

    # -- 6p. AttentionASR: ring attention, GPipe, expert-parallel MoE -----
    dist_attn = dist_attn_phase(dev, smi)

    # -- 6r. SSD300 trained with its image rows over two ranks (K2) -----
    dist_spatial = dist_spatial_phase(dev, smi)

    # -- 6s. SSD300 (K2) and DS2 (K3) served over two ranks; the runtime
    # with its follower ------------------------------------------------
    dist_serve = dist_serve_phase(dev, smi)

    # -- 6q. telemetry: DS2 under the anomaly ladder (K3, K4), SSD300
    # serving with spans and train_ssd with summaries (K2) ---------------
    t0 = time.perf_counter()
    telemetry = telemetry_phase(dev, smi)
    emit("timing", nvidia_smi=smi,
         telemetry_phase_s=time.perf_counter() - t0)

    # -- 6t. the serving fleet under chaos (K2, K3), the SDC sentinel over
    # three ranks (K3, K4), a width-2 mesh slice serving SSD300 (K2) ------
    t0 = time.perf_counter()
    fleet_chaos = fleet_chaos_phase(dev, smi)
    fleet_s = time.perf_counter() - t0
    dist_sdc = dist_sdc_phase(dev, smi)
    sdc_s = time.perf_counter() - t0 - fleet_s
    dist_slice = dist_slice_phase(dev, smi)
    emit("timing", nvidia_smi=smi, fleet_chaos_phase_s=fleet_s,
         dist_sdc_phase_s=sdc_s,
         dist_slice_phase_s=time.perf_counter() - t0 - fleet_s - sdc_s)
    fleet_paths = {"fleet_chaos": fleet_chaos, "dist_sdc": dist_sdc,
                   "dist_slice": dist_slice}

    # -- 6v. SSD300 trained on the shapes to its mAP, the quantized-mAP
    # tool on its weights (K2 in validation and the fused rungs, K1 in
    # the pallas rungs) ------------------------------------------------
    fleet_paths["accuracy"] = accuracy_phase(dev, smi, {
        "k1_random_ms": k1_ms, "k1_trained_like_ms": k1_trained_ms,
        "k2_dense_ms": k2_ms, "k2_trained_like_ms": k2_trained_ms})

    # -- 6w. the command-line examples (K3/K4 in DS2's, none elsewhere) --
    fleet_paths["examples"] = examples_phase(dev, smi)

    # -- 6x. the tools: profile_serve (K2 by stage, K1), the drills -------
    tools = tools_phase(dev, smi)
    fleet_paths["tools"] = tools

    # -- 6u. az-analyze on the card (K1-K4 in their targets' programs) ---
    analyze = analyze_phase(dev, smi, dist_tp)
    fleet_paths["analyze"] = analyze

    def fleet_counts(name):
        return {path: counts[name] for path, counts in fleet_paths.items()}

    # -- 7. the script's seconds, the kernels, then the device line last --
    emit("timing", nvidia_smi=smi, script_s=time.perf_counter() - t_script)
    kernels = [
        {"name": "nms_sweep", "route": "cuda",
         "source": "analytics_zoo_tpu_torch/csrc/nms_sweep.cu",
         "replaces": "analytics_zoo_tpu/ops/pallas_nms.py:91",
         "launches": (launches["nms_sweep"] + ssd_serving["k1_launches"]
                      + swap["nms_sweep"] + dist_dp["nms_sweep"]
                      + dist_tp["nms_sweep"]
                      + sum(fleet_counts("nms_sweep").values())),
         "launches_by_path": {
             "ssd_serving": launches["nms_sweep"],
             "ds2_resume": 0, "ssd_swap": swap["nms_sweep"],
             "dist_dp": dist_dp["nms_sweep"], "dist_tp": dist_tp["nms_sweep"],
             "dist_spatial": dist_spatial["nms_sweep"],
             "dist_serve": dist_serve["nms_sweep"],
             "dist_seq": dist_seq["nms_sweep"],
             "dist_attn": dist_attn["nms_sweep"],
             "telemetry": telemetry["nms_sweep"],
             "ssd_serving_approx_topk": ssd_serving["k1_launches"],
             "frcnn_serving": frcnn["nms_sweep"],
             "frcnn_train": frcnn_train["nms_sweep"],
             **zoo_paths("nms_sweep"), **fleet_counts("nms_sweep")},
         "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "fused_detection_output", "route": "cuda",
         "source": "analytics_zoo_tpu_torch/csrc/detection_output.cu",
         "replaces": "analytics_zoo_tpu/ops/pallas_detout.py:242",
         "launches": (launches["fused_detection_output"]
                      + ssd_train["k2_launches"] + ssd_input["validation"]
                      + ssd_input["predict"] + ssd_serving["k2_launches"]
                      + ds2_online["k2_fleet"] + caffe_graph["k2_launches"]
                      + variants["k2_launches"]
                      + swap["fused_detection_output"]
                      + dist_dp["fused_detection_output"]
                      + dist_tp["fused_detection_output"]
                      + dist_spatial["fused_detection_output"]
                      + dist_serve["fused_detection_output"]
                      + telemetry["fused_detection_output"]
                      + sum(fleet_counts("fused_detection_output")
                            .values())),
         "launches_by_path": {
             "ssd_serving": launches["fused_detection_output"],
             "ds2_resume": 0, "ssd_swap": swap["fused_detection_output"],
             "dist_dp": dist_dp["fused_detection_output"],
             "dist_tp": dist_tp["fused_detection_output"],
             "dist_spatial": dist_spatial["fused_detection_output"],
             "dist_serve": dist_serve["fused_detection_output"],
             "dist_seq": dist_seq["fused_detection_output"],
             "dist_attn": dist_attn["fused_detection_output"],
             "telemetry": telemetry["fused_detection_output"],
             "ssd_serving_runtime": ssd_serving["k2_launches"],
             "fleet": ds2_online["k2_fleet"],
             "ssd_train_validation": ssd_train["k2_launches"],
             "ssd_input_validation": ssd_input["validation"],
             "ssd_input_predict": ssd_input["predict"],
             "caffe_graph": caffe_graph["k2_launches"],
             "ssd_variants": variants["k2_launches"],
             "frcnn_serving": frcnn["fused_detection_output"],
             "frcnn_train": frcnn_train["fused_detection_output"],
             **zoo_paths("fused_detection_output"),
             **fleet_counts("fused_detection_output")},
         "launches_by_stage_tools": tools["k2_by_stage"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None},
        {"name": "persistent_rnn", "route": "cuda",
         "source": "analytics_zoo_tpu_torch/csrc/persistent_rnn.cu",
         "replaces": "analytics_zoo_tpu/ops/pallas_rnn.py:266",
         "launches": (k3_launches + train_launches["persistent_rnn"]
                      + sum(ds2_online["k3"].values())
                      + resume["persistent_rnn"] + dist_dp["persistent_rnn"]
                      + dist_tp["persistent_rnn"]
                      + dist_seq["persistent_rnn"]
                      + dist_serve["persistent_rnn"]
                      + telemetry["persistent_rnn"]
                      + sum(fleet_counts("persistent_rnn").values())),
         "launches_by_path": {"ds2_serving": k3_launches,
                              "ds2_train": train_launches["persistent_rnn"],
                              "ds2_resume": resume["persistent_rnn"],
                              "dist_dp": dist_dp["persistent_rnn"],
                              "dist_tp": dist_tp["persistent_rnn"],
                              "dist_seq": dist_seq["persistent_rnn"],
                              "dist_spatial": dist_spatial["persistent_rnn"],
                              "dist_serve": dist_serve["persistent_rnn"],
                              "dist_attn": dist_attn["persistent_rnn"],
                              "telemetry": telemetry["persistent_rnn"],
                              "ssd_swap": 0,
                              **ds2_online["k3"],
                              "frcnn_serving": frcnn["persistent_rnn"],
                              "frcnn_train": frcnn_train["persistent_rnn"],
                              **zoo_paths("persistent_rnn"),
                              **fleet_counts("persistent_rnn")},
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
         "launches": (train_launches["persistent_rnn_bwd"]
                      + resume["persistent_rnn_bwd"]
                      + dist_dp["persistent_rnn_bwd"]
                      + dist_tp["persistent_rnn_bwd"]
                      + dist_seq["persistent_rnn_bwd"]
                      + telemetry["persistent_rnn_bwd"]
                      + sum(fleet_counts("persistent_rnn_bwd").values())),
         "launches_by_path": {
             "ds2_train": train_launches["persistent_rnn_bwd"],
             "ds2_resume": resume["persistent_rnn_bwd"], "ssd_swap": 0,
             "dist_dp": dist_dp["persistent_rnn_bwd"],
             "dist_tp": dist_tp["persistent_rnn_bwd"],
             "dist_seq": dist_seq["persistent_rnn_bwd"],
             "dist_spatial": dist_spatial["persistent_rnn_bwd"],
             "dist_serve": dist_serve["persistent_rnn_bwd"],
             "dist_attn": dist_attn["persistent_rnn_bwd"],
             "telemetry": telemetry["persistent_rnn_bwd"],
             "frcnn_serving": frcnn["persistent_rnn_bwd"],
             "frcnn_train": frcnn_train["persistent_rnn_bwd"],
             **zoo_paths("persistent_rnn_bwd"),
             **fleet_counts("persistent_rnn_bwd")},
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

"""DeepSpeech2 pipelines (counterpart of ``pipelines/deepspeech2.py``).

Batch transcription: audio → TimeSegmenter chunks tagged ``(audio_id,
audio_seq)`` → featurize → forward → CTC decode → re-join per utterance
in ``audio_seq`` order → WER/CER.  Training: ``load_asr_train_set`` (host
featurize, optionally length-bucketed) → ``train_ds2`` (CTC loss, Adam,
the recurrences through K3 and K4 on the card).  Online serving:
``ds2_serving_tiers`` (one featurized utterance a request) and
``ds2_streaming_tiers`` (sessions of raw-sample chunks through
:class:`StreamingDS2`) behind ``serving.ServingRuntime``.

All segments are zero-padded to ``segment_seconds`` and forwarded in
groups of ``batch_size``.  The padded segments go through the model
WITHOUT ``n_frames``, as in the reference.  The greedy, device-featurize
path runs featurize → forward → argmax on the card for one batch and
reads back only the (B, T') ids, with a window of batches in flight.

With ``sequence_mesh=`` the pipeline forwards through
``models.deepspeech2.sequence_parallel_forward`` (the time axis cut over
the mesh's ``sequence`` axis; every rank of the mesh runs the same
call), and ``train_ds2(sequence_parallel=True)`` trains through it.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.core.criterion import CTCCriterion
from analytics_zoo_tpu_torch.data import (BucketBatcher, DataSet,
                                          FnTransformer)
from analytics_zoo_tpu_torch.data.prefetch import overlap_window
from analytics_zoo_tpu_torch.models.deepspeech2 import (DeepSpeech2,
                                                        ds2_valid_out_frames)
from analytics_zoo_tpu_torch.parallel.optim import Adam, Trigger
from analytics_zoo_tpu_torch.parallel.train import Optimizer, make_eval_step
from analytics_zoo_tpu_torch.transform.audio import (
    ALPHABET,
    SAMPLE_RATE,
    WINDOW_SIZE,
    WINDOW_STRIDE,
    ASREvaluator,
    TimeSegmenter,
    VocabDecoder,
    beam_search_decode,
    best_path_decode,
    dft_specgram,
    featurize,
    frame_signal,
    ids_to_text,
    make_featurizer_device,
    mel_features,
    mel_filterbank_matrix,
    read_audio,
)
from analytics_zoo_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("analytics_zoo_tpu_torch")


@dataclasses.dataclass
class DS2Param:
    """Reference ``util/Param.scala:17-34``: segment seconds, batching,
    featurize placement and decoder."""

    segment_seconds: int = 30
    batch_size: int = 8
    n_mels: int = 13
    vocab: Optional[Sequence[str]] = None
    # featurize on the card as one batched chain instead of host numpy
    device_featurize: bool = True
    # 'greedy' (best path) | 'beam' (prefix beam search)
    decoder: str = "greedy"
    beam_width: int = 16

    @property
    def utt_length(self) -> int:
        # uttLength = segment·100 frames (reference InferenceExample.scala:58)
        return self.segment_seconds * 100


class DeepSpeech2Pipeline:
    """segment → featurize → forward → decode → re-join.  The model is
    moved to ``device`` (the GPU unless ``device="cpu"``).

    ``sequence_mesh`` (a mesh with a ``sequence`` axis, every rank of it
    running this pipeline on the same utterances) switches the forward
    to ``models.deepspeech2.sequence_parallel_forward``: ``utt_length``
    rounds up to a multiple of 2·n_seq, a ``data`` axis cuts each batch
    (a short last batch padded to ``batch_size``) and gathers the
    log-probs back, and the split (featurize, forward, decode) path
    runs."""

    def __init__(self, model: nn.Module, param: DS2Param = DS2Param(),
                 sequence_mesh=None, device=None, clock=None):
        from analytics_zoo_tpu_torch.utils.clock import as_now_fn

        self.device = resolve_device(device)
        # eval timing reads the one injected clock, as the reference's
        # (pipelines/deepspeech2.py:82)
        self._now = as_now_fn(clock)
        self.model = model.to(self.device).eval()
        self.param = param
        self.segmenter = TimeSegmenter(
            segment_size=SAMPLE_RATE * param.segment_seconds)
        self.utt_length = param.utt_length
        self._pad_to_batch = False
        if sequence_mesh is not None:
            self._eval_step = self._sequence_eval_step(sequence_mesh)
        else:
            self._eval_step = make_eval_step(self.model)
        # the fused greedy path covers the one-rank forward
        self._fused_ok = sequence_mesh is None
        self.vocab_decoder = (VocabDecoder(param.vocab)
                              if param.vocab else None)
        self._dev_featurizer = None      # built at first use

    def _sequence_eval_step(self, mesh) -> Callable:
        """The time-sharded forward of a batch: this rank's rows of a
        ``data`` axis, the log-probs gathered back over it."""
        from analytics_zoo_tpu_torch.models.deepspeech2 import (
            sequence_parallel_forward)
        from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
        from analytics_zoo_tpu_torch.parallel.sequence import gather_blocks

        names = mesh_lib.axis_names(mesh)
        if "sequence" not in names:
            raise ValueError(f"sequence_mesh needs a 'sequence' axis, got "
                             f"{names}")
        # even chunks a rank for the stride-2 conv front-end
        mult = 2 * mesh_lib.axis_size(mesh, "sequence")
        self.utt_length = -(-self.utt_length // mult) * mult
        batch_axis = "data" if "data" in names else None
        # the data axis cuts each batch: a short one is padded
        self._pad_to_batch = batch_axis is not None
        data_group = mesh_lib.axis_group(mesh, "data")

        @torch.no_grad()
        def step(x):
            x = torch.as_tensor(x, device=self.device)
            start, per = mesh_lib.local_data_slice(x.shape[0], mesh)
            out = sequence_parallel_forward(
                self.model, x[start:start + per], mesh,
                batch_axis=batch_axis)
            return gather_blocks(out, data_group, axis=0)

        return step

    def _make_featurizer(self) -> Callable:
        """The one construction site of the device featurizer: the split
        path and the fused greedy path featurize identically."""
        if self._dev_featurizer is None:
            self._dev_featurizer = make_featurizer_device(
                self.segmenter.segment_size, utt_length=self.utt_length,
                n_mels=self.param.n_mels, device=self.device)
        return self._dev_featurizer

    def _pack_batch(self, chunk: List[dict]) -> Tuple[np.ndarray, np.ndarray]:
        """Zero-pad a chunk of segments to one (batch_size, segment
        samples) array plus each row's valid sample count."""
        batch = np.zeros((self.param.batch_size, self.segmenter.segment_size),
                         np.float32)
        n_valid = np.zeros((self.param.batch_size,), np.int32)
        for i, s in enumerate(chunk):
            x = s["samples"]
            batch[i, :len(x)] = x
            n_valid[i] = len(x)
        return batch, n_valid

    def _featurize_device(self, segments: List[dict]) -> np.ndarray:
        """Featurize in fixed ``batch_size`` batches (the last zero-padded)
        on the card, with the host chain's frame masking."""
        featurizer = self._make_featurizer()
        bs = self.param.batch_size
        out = np.zeros((len(segments), self.utt_length, self.param.n_mels),
                       np.float32)
        for start in range(0, len(segments), bs):
            chunk = segments[start:start + bs]
            batch, n_valid = self._pack_batch(chunk)
            out[start:start + len(chunk)] = (
                featurizer(batch, n_valid)[:len(chunk)].cpu().numpy())
        return out

    def _greedy_ids(self, samples, n_valid) -> torch.Tensor:
        """One batch on the card: featurize → forward → per-frame argmax.
        Returns the (B, T') ids without waiting for them."""
        feats = self._make_featurizer()(samples, n_valid)
        return torch.argmax(self._eval_step(feats), dim=-1)

    def _decode(self, log_probs: np.ndarray) -> str:
        if self.param.decoder == "beam":
            return beam_search_decode(log_probs,
                                      beam_width=self.param.beam_width)
        return best_path_decode(log_probs)

    def _transcribe_fused(self, segments: List[dict]) -> List[str]:
        """Greedy + device featurize: one batch at a time on the card, a
        bounded window in flight, int ids read back."""
        bs = self.param.batch_size
        texts: List[str] = []

        def dispatch(start):
            chunk = segments[start:start + bs]
            batch, n_valid = self._pack_batch(chunk)
            return self._greedy_ids(batch, n_valid), len(chunk)

        def consume(token):
            ids, n_real = token
            ids = ids.cpu().numpy()
            texts.extend(ids_to_text(ids[j]) for j in range(n_real))

        overlap_window(range(0, len(segments), bs), dispatch, consume)
        return texts

    def transcribe_samples(self, utterances: Dict[str, np.ndarray]
                           ) -> Dict[str, str]:
        """{audio_id: samples} → {audio_id: transcript}."""
        segments: List[dict] = []
        for audio_id, samples in utterances.items():
            segments.extend(self.segmenter.segment(samples, audio_id))

        if (segments and self._fused_ok and self.param.device_featurize
                and self.param.decoder == "greedy"):
            texts = self._transcribe_fused(segments)
        else:
            if not segments:
                feats = np.zeros((0, self.utt_length, self.param.n_mels),
                                 np.float32)
            elif self.param.device_featurize:
                feats = self._featurize_device(segments)
            else:
                feats = np.stack([
                    featurize(s["samples"], utt_length=self.utt_length,
                              n_mels=self.param.n_mels)
                    for s in segments])
            texts = []
            for i in range(0, len(segments), self.param.batch_size):
                chunk = feats[i:i + self.param.batch_size]
                n_real = chunk.shape[0]
                if self._pad_to_batch and n_real < self.param.batch_size:
                    pad = np.zeros((self.param.batch_size - n_real,)
                                   + chunk.shape[1:], chunk.dtype)
                    chunk = np.concatenate([chunk, pad])
                log_probs = self._eval_step(
                    torch.from_numpy(chunk).to(self.device)).cpu().numpy()
                texts.extend(self._decode(lp) for lp in log_probs[:n_real])

        # re-join by (audio_id, audio_seq) (reference InferenceEvaluate
        # groupBy(audio_id).sort(audio_seq) concat)
        joined: Dict[str, List[Tuple[int, str]]] = {}
        for seg, text in zip(segments, texts):
            joined.setdefault(seg["audio_id"], []).append(
                (seg["audio_seq"], text))
        out = {}
        for audio_id, parts in joined.items():
            text = " ".join(t for _, t in sorted(parts)).strip()
            if self.vocab_decoder is not None:
                text = self.vocab_decoder(text)
            out[audio_id] = text
        return out

    def transcribe_files(self, paths: Sequence[str]) -> Dict[str, str]:
        utts = {}
        for p in paths:
            samples, rate = read_audio(p)
            if rate != SAMPLE_RATE:
                raise ValueError(f"{p}: expected {SAMPLE_RATE} Hz, got {rate}")
            utts[p] = samples
        return self.transcribe_samples(utts)

    def evaluate(self, utterances: Dict[str, np.ndarray],
                 transcripts: Dict[str, str]) -> ASREvaluator:
        """WER/CER over labeled utterances (reference InferenceEvaluate)."""
        t0 = self._now()
        hyps = self.transcribe_samples(utterances)
        ev = ASREvaluator()
        for audio_id, ref in transcripts.items():
            ev.add(ref.upper(), hyps.get(audio_id, ""))
        dt = self._now() - t0
        logger.info("DS2 eval: %d utterances in %.2fs (%.2f utt/sec), "
                    "WER=%.4f CER=%.4f", len(transcripts), dt,
                    len(transcripts) / max(dt, 1e-9), ev.wer, ev.cer)
        return ev


def make_ds2_model(hidden: int = 1024, n_rnn_layers: int = 3,
                   n_mels: int = 13, seed: int = 0,
                   bidirectional: bool = True,
                   rnn_engine: Optional[str] = None,
                   device=None) -> DeepSpeech2:
    """A seeded, randomly initialised :class:`DeepSpeech2` in eval mode
    on ``device``.  ``rnn_engine="pallas"`` runs the recurrences through
    the persistent-RNN kernels (K3, and K4 for the gradient); ``None`` is
    the blocked loop."""
    return DeepSpeech2(hidden=hidden, n_rnn_layers=n_rnn_layers,
                       n_mels=n_mels, bidirectional=bidirectional,
                       rnn_engine=rnn_engine, device=device, seed=seed)


def ds2_ctc_criterion(blank_id: int = 0) -> Callable:
    """CTC criterion for DS2 batches: a bucketed batch carries per-row
    ``n_frames``, whose valid OUTPUT frames after the stride-2 conv are
    ``ceil(n/2)``; frames past them are masked out of the loss."""
    ctc = CTCCriterion(blank_id=blank_id)

    def criterion(log_probs, batch):
        logit_mask = None
        if isinstance(batch, dict) and "n_frames" in batch:
            out_n = ds2_valid_out_frames(
                torch.as_tensor(batch["n_frames"], device=log_probs.device
                                ).long())
            T = log_probs.shape[1]
            logit_mask = (torch.arange(T, device=log_probs.device)[None, :]
                          < out_n[:, None]).float()
        return ctc(log_probs, batch["labels"], logit_mask=logit_mask,
                   label_mask=batch.get("label_mask"))

    return criterion


def ds2_padding_metric(batch) -> Dict[str, torch.Tensor]:
    """``make_train_step`` ``metric_fn``: valid / padded input frames of a
    length-bucketed batch (nothing for fixed-shape batches)."""
    if not (isinstance(batch, dict) and "n_frames" in batch):
        return {}
    x = batch["input"]
    x = x[0] if isinstance(x, (tuple, list)) else x
    n = torch.as_tensor(batch["n_frames"])
    return {"padding_efficiency":
            n.float().sum() / (x.shape[0] * x.shape[1])}


def load_asr_train_set(samples: np.ndarray, labels: np.ndarray,
                       label_lengths: Optional[np.ndarray] = None,
                       batch_size: int = 8,
                       utt_length: Optional[int] = None,
                       n_mels: int = 13, shuffle: bool = True,
                       seed: int = 0, worker_processes: int = 0,
                       sample_lengths: Optional[np.ndarray] = None,
                       bucket_edges: Optional[Sequence[int]] = None,
                       param=None):
    """DataSet of host-featurized CTC train batches from raw waveforms.

    ``samples``: (N, S) float32 waveforms; ``labels``: (N, L) int32
    (0-padded); ``label_lengths``: (N,) true lengths (defaults to counting
    nonzero labels).  Batches: ``{"input", "labels", "label_mask"}``.

    With ``bucket_edges`` (frame counts), ragged waveforms
    (``sample_lengths``: true per-row sample counts) are featurized at
    their true length and batched into the smallest fitting bucket
    (``data.bucket.BucketBatcher``); batches then carry ``"input":
    (features, n_frames)`` for the model's mask, plus top-level
    ``n_frames`` for the CTC logit mask and ``padding_efficiency``.

    ``worker_processes > 0`` fans the host featurize (the per-sample
    loop) out to that many forked worker processes through
    ``data.parallel.ParallelLoader`` (shared-memory rings,
    order-preserving, seeded from ``seed``): the batches equal
    ``worker_processes=0``'s, array for array.  ``param`` (a
    ``pipelines.ssd.PreProcessParam``) supplies ``batch_size``,
    ``worker_processes``, ``loader_seed`` and ``bucket_edges`` in one
    object."""
    if param is not None:
        batch_size = param.batch_size
        worker_processes = param.worker_processes
        seed = param.loader_seed
        if getattr(param, "bucket_edges", None):
            bucket_edges = param.bucket_edges

    samples = np.asarray(samples, np.float32)
    labels = np.asarray(labels, np.int32)
    if label_lengths is None:
        label_lengths = (labels != 0).sum(axis=1).astype(np.int32)
    if sample_lengths is None:
        sample_lengths = np.full((len(samples),), samples.shape[1], np.int64)
    sample_lengths = np.asarray(sample_lengths, np.int64)
    L = labels.shape[1]
    base = DataSet.from_arrays(samples=samples, labels=labels,
                               n_label=label_lengths,
                               n_sample=sample_lengths,
                               shuffle=shuffle, seed=seed)

    if bucket_edges is None:
        def feat(s):
            x = featurize(s["samples"], utt_length=utt_length, n_mels=n_mels)
            mask = (np.arange(L) < s["n_label"]).astype(np.float32)
            return {"input": x.astype(np.float32), "labels": s["labels"],
                    "label_mask": mask}

        return (base.transform(FnTransformer(feat))
                .batch(batch_size, num_workers=worker_processes,
                       base_seed=seed))

    # truncating frames but not labels could leave CTC no alignment
    max_frames = (int(sample_lengths.max()) - WINDOW_SIZE) \
        // WINDOW_STRIDE + 1
    if max_frames > max(bucket_edges):
        raise ValueError(
            f"bucket_edges[-1]={max(bucket_edges)} < the longest "
            f"utterance's {max_frames} frames — add a covering last "
            "edge (or pre-segment the audio); truncating frames but "
            "not labels can make the CTC loss infeasible")

    def feat_ragged(s):
        x = featurize(s["samples"][:int(s["n_sample"])], utt_length=None,
                      n_mels=n_mels)
        mask = (np.arange(L) < s["n_label"]).astype(np.float32)
        return {"input": x.astype(np.float32),
                "n_frames": np.int32(x.shape[0]),
                "labels": s["labels"], "label_mask": mask}

    def pack(batch):
        return {"input": (batch["input"], batch["n_frames"]),
                "n_frames": batch["n_frames"],
                "labels": batch["labels"],
                "label_mask": batch["label_mask"]}

    ds = (base.transform(FnTransformer(feat_ragged))
          .transform(BucketBatcher(batch_size, bucket_edges,
                                   length_key="n_frames", pad_key="input"))
          .transform(FnTransformer(pack)))
    if worker_processes > 0:
        return ds.parallel(worker_processes, base_seed=seed)
    return ds


def train_ds2(model: DeepSpeech2, dataset, epochs: int = 10,
              lr: float = 3e-4, mesh=None,
              checkpoint_path: Optional[str] = None, param_rules=None,
              sequence_parallel: bool = False, specs=None) -> DeepSpeech2:
    """CTC training for DS2 on the model's device: ``dataset`` yields
    batches ``{"input": (B,T,n_mels), "labels": (B,L) int32,
    "label_mask": (B,L)}``, or length-bucketed ones with ``"input":
    (features, n_frames)`` and ``"n_frames"``
    (``load_asr_train_set(bucket_edges=...)``), whose padding the model
    and the loss mask; their metrics gain ``padding_efficiency``.  Adam at
    ``lr`` for ``epochs`` epochs, with a snapshot every epoch under
    ``checkpoint_path`` when given.  The recurrence engine is the model's:
    ``make_ds2_model(rnn_engine="pallas")`` trains through K3 and K4.

    ``mesh`` (``parallel.mesh.create_mesh``) trains data parallel: every
    rank runs this call on the same global batches and trains on its rows
    (K3 and K4 on each rank's rows), the batch norms' statistics global;
    ``param_rules`` (``parallel.tensor.default_tp_rules``) shards the
    weights over a data × model mesh.  Both are sugar for ``specs=
    pipeline_specs("ds2", mesh=mesh, param_rules=...)``.

    ``sequence_parallel=True`` (the mesh must carry a ``sequence`` axis,
    e.g. ``create_mesh((2, 2), ("data", "sequence"))``) trains with the
    time axis cut over it: the step's forward is
    ``models.deepspeech2.sequence_parallel_forward`` with global-batch
    BN statistics, and the CTC loss reads the log-probs gathered back
    over T.  Batches are fixed-length (``bucket_edges=None``).

    ``model`` may also be another CTC acoustic model (``models.attention
    .AttentionASR``) called on the features alone."""
    if specs is not None and (mesh is not None or param_rules is not None):
        raise ValueError("pass specs= OR (mesh=, param_rules=), not both")
    if specs is None and (mesh is not None or param_rules is not None):
        from analytics_zoo_tpu_torch.parallel.specs import pipeline_specs
        specs = pipeline_specs("ds2", mesh=mesh, param_rules=param_rules)
    forward_fn = None
    if sequence_parallel:
        from analytics_zoo_tpu_torch.models.deepspeech2 import (
            make_sequence_parallel_forward_fn)
        from analytics_zoo_tpu_torch.parallel.mesh import axis_names

        names = axis_names(specs.mesh) if specs is not None else None
        if names is None or "sequence" not in names:
            raise ValueError("sequence_parallel=True needs a mesh with a "
                             f"'sequence' axis, got {names}")
        forward_fn = make_sequence_parallel_forward_fn(
            model, specs.mesh, batch_axis="data" if "data" in names
            else None)
    opt = (Optimizer(model, dataset, ds2_ctc_criterion(blank_id=0),
                     metric_fn=ds2_padding_metric, specs=specs,
                     forward_fn=forward_fn)
           .set_optim_method(Adam(lr))
           .set_end_when(Trigger.max_epoch(epochs)))
    if checkpoint_path:
        opt.set_checkpoint(checkpoint_path, Trigger.every_epoch())
    return opt.optimize()


class StreamingDS2:
    """Stateful streaming ASR: feed successive sample chunks, get
    incremental transcript pieces.

    Exactness contract: the emitted log-probs equal the batch forward of
    the same (unidirectional) model over the whole utterance, because
    every boundary carries its true state:

    - featurization (host numpy): a 240-sample window-overlap residue
      carries across chunks, so the frames are the whole utterance's;
    - conv front-end (kernel 11, stride 2, SAME(5, 5) in batch mode): the
      stream starts with 5 zero context frames (the left SAME pad),
      carries the last 9 real mel frames between blocks, and ``flush()``
      appends the 5-zero right pad; the model runs the conv VALID on the
      extended block, so output indices line up;
    - RNN layers: the hidden state of each layer carried across blocks,
      on the model's device (``DeepSpeech2(bidirectional=False)`` called
      with ``carry=`` and ``return_carry=True``; K3 with its ``h0`` under
      ``rnn_engine="pallas"``); only the log-probs are read back;
    - decoding: greedy CTC with the collapse state (previous argmax id)
      carried, so repeats spanning a boundary collapse correctly.

    Blocks are fixed: ``chunk_frames`` mel frames (remainder buffered),
    so the forward sees three shapes: the first block, the steady block
    and the flush block (padded to the steady shape, its emissions cut
    to the true remaining count).  Latency: ``chunk_frames`` frames of
    10 ms plus the conv's 5-frame lookahead.  The model is moved to
    ``device`` (the GPU unless ``device="cpu"``)."""

    _CTX = 9            # real mel frames carried between blocks
    _PAD = 5            # zero frames standing in for SAME padding at ends

    def __init__(self, model: DeepSpeech2, n_mels: int = 13,
                 chunk_frames: int = 100, keep_log_probs: bool = False,
                 device=None):
        if getattr(model, "bidirectional", True):
            raise ValueError("streaming needs DeepSpeech2(bidirectional="
                             "False) — the backward pass needs the future")
        if chunk_frames < 6 or chunk_frames % 2:
            raise ValueError("chunk_frames must be even and >= 6")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.n_mels = n_mels
        self.chunk_frames = chunk_frames
        # retain emitted per-frame log-probs (exactness testing, lattice
        # consumers); unbounded for endless streams, so off by default
        self.keep_log_probs = keep_log_probs
        self._fb = mel_filterbank_matrix(n_mels, WINDOW_SIZE)
        self.reset()

    def reset(self) -> None:
        self._samples = np.zeros((0,), np.float32)
        self._frames = np.zeros((0, self.n_mels), np.float32)
        self._ctx: Optional[np.ndarray] = None     # None = stream start
        self._h = {"h": tuple(
            torch.zeros((1, self.model.hidden), device=self.device)
            for _ in range(self.model.n_rnn_layers))}
        self._prev_id = 0                          # CTC collapse carry
        self._pieces: List[str] = []
        self._log_probs: List[np.ndarray] = []
        self._total_frames = 0                     # real mel frames seen
        self._emitted = 0                          # output frames emitted
        self._finished = False

    # -- internals ---------------------------------------------------------
    def _apply(self, x: torch.Tensor, carry):
        """One block through the model: ``(log_probs, carry)``."""
        with torch.inference_mode():
            return self.model(x, carry=carry, return_carry=True)

    def _featurize_new(self, samples: np.ndarray) -> np.ndarray:
        """Consume buffered samples into mel frames, keeping the
        window-overlap residue (window 400, stride 160: 240 overlap)."""
        self._samples = np.concatenate([self._samples, samples])
        n = max((len(self._samples) - WINDOW_SIZE) // WINDOW_STRIDE + 1, 0)
        if n == 0:
            return np.zeros((0, self.n_mels), np.float32)
        take = WINDOW_SIZE + WINDOW_STRIDE * (n - 1)
        frames = frame_signal(self._samples[:take])
        self._samples = self._samples[WINDOW_STRIDE * n:]
        return mel_features(dft_specgram(frames), n_mels=self.n_mels,
                            fb=self._fb)

    def _run(self, ext: np.ndarray, n_emit: Optional[int] = None) -> str:
        log_probs, self._h = self._apply(
            torch.from_numpy(ext[None]).to(self.device), self._h)
        lp = log_probs[0].cpu().numpy()
        if n_emit is not None:
            lp = lp[:n_emit]
        self._emitted += lp.shape[0]
        if self.keep_log_probs:
            self._log_probs.append(lp)
        return self._decode(lp)

    def _update_ctx(self, real_frames: np.ndarray) -> None:
        """ctx = the last 9 real frames of the stream (zero-left-padded
        while fewer have been seen)."""
        prev = (self._ctx if self._ctx is not None
                else np.zeros((self._CTX, self.n_mels), np.float32))
        self._ctx = np.concatenate([prev, real_frames])[-self._CTX:]

    def _decode(self, log_probs: np.ndarray) -> str:
        out = []
        for t in np.argmax(log_probs, axis=-1):
            if t != self._prev_id and t != 0:
                out.append(ALPHABET[int(t)])
            self._prev_id = int(t)
        piece = "".join(out)
        self._pieces.append(piece)
        return piece

    # -- public API --------------------------------------------------------
    def accept(self, samples: np.ndarray) -> str:
        """Feed raw samples; returns the transcript piece decoded from any
        completed fixed-size frame blocks (possibly "")."""
        if self._finished:
            raise RuntimeError("stream finished — call reset() first")
        frames = self._featurize_new(np.asarray(samples, np.float32))
        if frames.shape[0]:
            self._frames = np.concatenate([self._frames, frames])
            self._total_frames += frames.shape[0]
        pieces = []
        C = self.chunk_frames
        while self._frames.shape[0] >= C:
            chunk, self._frames = self._frames[:C], self._frames[C:]
            if self._ctx is None:
                ext = np.concatenate(
                    [np.zeros((self._PAD, self.n_mels), np.float32), chunk])
            else:
                ext = np.concatenate([self._ctx, chunk])
            self._update_ctx(chunk)
            pieces.append(self._run(ext))
        return "".join(pieces)

    def flush(self) -> str:
        """End of stream: process the buffered frames and the right SAME
        pad, padded up to the steady block shape (emissions cut to the
        true remaining count, so the tail stays exact)."""
        if self._finished:
            return ""
        self._finished = True
        r = self._frames.shape[0]
        ctx = (np.zeros((self._PAD, self.n_mels), np.float32)
               if self._ctx is None else self._ctx)
        # one flush shape whatever the remainder: r <= C - 1 (accept
        # drains full blocks) and ctx is 5 or 9 frames, so pad >= PAD
        target = self.chunk_frames + self._CTX + self._PAD
        pad = target - ctx.shape[0] - r
        assert pad >= self._PAD, (pad, r)
        ext = np.concatenate([ctx, self._frames,
                              np.zeros((pad, self.n_mels), np.float32)])
        self._frames = np.zeros((0, self.n_mels), np.float32)
        expected_total = (self._total_frames + 1) // 2
        n_emit = max(expected_total - self._emitted, 0)
        return self._run(ext, n_emit=n_emit) if n_emit else ""

    @property
    def transcript(self) -> str:
        return "".join(self._pieces)

    @property
    def log_probs(self) -> np.ndarray:
        """Concatenated emitted log-probs (requires keep_log_probs)."""
        if not self._log_probs:
            return np.zeros((0, 0), np.float32)
        return np.concatenate(self._log_probs, axis=0)


def ds2_serving_tiers(model: DeepSpeech2, param: Optional[DS2Param] = None,
                      degraded_beam: Optional[int] = None, specs=None,
                      device=None) -> List:
    """Degradation rungs for ``serving.ServingRuntime``: the prefix-beam
    width is DS2's counterpart of the SSD ladder's NMS top-K, decode work
    cut under overload at a bounded, explicit quality cost.

    Requests carry one featurized utterance (``{"input": (n_frames,
    n_mels) float32}``, ``length=n_frames``); the batcher pads the time
    axis to a bucket edge and hands the forward ``{"input": (B, edge,
    n_mels), "n_frames": (B,)}``.  The forward runs the model on
    ``device`` (the GPU unless ``device="cpu"``; K3 six times a batch
    under ``rnn_engine="pallas"``) with ``n_frames``, so that a row's
    padding reaches neither direction of its recurrences, reads the
    log-probs back and decodes only ``ds2_valid_out_frames(n)`` frames a
    row, on the host.  (The reference forwards the padded rows without
    ``n_frames``: its transcript of a row shorter than its edge depends
    on the edge.)

    Tiers, cheapest last: prefix beam of ``param.beam_width``, a reduced
    beam (``degraded_beam``, default ``max(4, width // 4)``), greedy best
    path.  With ``param.decoder == "greedy"`` the ladder is the one
    greedy tier.  ``device_program()`` gives ``(eval_step,
    example_args)``, the forward every rung shares.  ``specs`` (e.g.
    ``pipeline_specs("ds2", mesh=mesh)``): the model is placed by
    ``specs.place_state`` and the forward is ``make_eval_step(specs=)``'s,
    each rank running its rows (K3 on them) and the log-probs gathered
    back; every rank builds the tiers and calls a rung with the same
    batch, and decodes the whole batch."""
    from analytics_zoo_tpu_torch.serving.ladder import ServingTier

    param = param or DS2Param()
    dev = resolve_device(device)
    model = model.to(dev).eval()
    if specs is not None:
        specs.place_state(model)
    eval_step = make_eval_step(model, specs=specs)

    def device_program(edge: int = 64):
        return eval_step, ((torch.zeros((1, edge, param.n_mels),
                                        device=dev),
                            torch.full((1,), edge, dtype=torch.int32,
                                       device=dev)),)

    def forward_with(decode: Callable[[np.ndarray], str]):
        def forward(batch: Dict) -> List[str]:
            feats = np.asarray(batch["input"], np.float32)
            n_frames = batch.get("n_frames")
            if n_frames is None:
                n_frames = np.full((feats.shape[0],), feats.shape[1],
                                   np.int32)
            log_probs = eval_step((
                torch.from_numpy(feats).to(dev),
                torch.from_numpy(np.asarray(n_frames, np.int32)).to(dev))
            ).cpu().numpy()
            texts: List[str] = []
            for i in range(feats.shape[0]):
                n = int(n_frames[i])
                if n <= 0:          # batch-axis padding row
                    texts.append("")
                    continue
                texts.append(decode(log_probs[i, :ds2_valid_out_frames(n)]))
            return texts
        return forward

    if param.decoder == "greedy":
        return [ServingTier("greedy", forward_with(best_path_decode),
                            speed=1.0, quality_note="best-path decode",
                            device_program=device_program)]
    width = param.beam_width
    low = degraded_beam if degraded_beam is not None else max(4, width // 4)
    return [
        ServingTier(f"beam{width}",
                    forward_with(lambda lp: beam_search_decode(
                        lp, beam_width=width)),
                    speed=1.0,
                    quality_note=f"prefix beam search, width {width}",
                    device_program=device_program),
        ServingTier(f"beam{low}",
                    forward_with(lambda lp: beam_search_decode(
                        lp, beam_width=low)),
                    speed=0.85,
                    quality_note=f"reduced beam width {low} (bounded "
                                 "WER cost under overload)",
                    device_program=device_program),
        ServingTier("greedy", forward_with(best_path_decode), speed=0.7,
                    quality_note="best-path decode (no beam) — the "
                                 "cheapest rung",
                    device_program=device_program),
    ]


def ds2_streaming_tiers(model: DeepSpeech2, n_mels: int = 13,
                        chunk_frames: int = 100, device=None) -> List:
    """One replica's tier instances for streaming ASR sessions: a
    stateful forward that owns this replica's session store,
    ``{session id: StreamingDS2}``, so the carry lives on the pinned
    replica.

    Batch contract (what a ``ModelConfig(streaming=True)`` plan
    assembles): ``{"input": (B, edge) float32 raw samples, "n_samples":
    (B,) true lengths, "session": (B,) int64 ids (-1 padding), "final":
    (B,) int8 flush flags}``.  Each row goes to its session's
    :class:`StreamingDS2` (one forward at B = 1 a block); a ``final``
    row appends the stream's flush tail and retires the session.
    ``evict_session`` drops a dead session's stream.  Use as the
    per-replica factory::

        ModelConfig(name="ds2-stream", streaming=True,
                    tiers=ds2_streaming_tiers(model),
                    tier_factory=lambda rid: ds2_streaming_tiers(model),
                    pad_key="input", length_key="n_samples",
                    bucket_edges=[16000])
    """
    from analytics_zoo_tpu_torch.serving.ladder import ServingTier

    dev = resolve_device(device)
    model = model.to(dev).eval()
    store: Dict[int, StreamingDS2] = {}

    def forward(batch: Dict) -> List[str]:
        sessions = batch["session"]
        final = batch["final"]
        lens = batch.get("n_samples")
        texts: List[str] = []
        for i in range(len(sessions)):
            sid = int(sessions[i])
            if sid < 0:             # batch-axis padding row
                texts.append("")
                continue
            stream = store.get(sid)
            if stream is None:
                stream = StreamingDS2(model, n_mels=n_mels,
                                      chunk_frames=chunk_frames, device=dev)
                store[sid] = stream
            n = (int(lens[i]) if lens is not None
                 else batch["input"].shape[1])
            piece = (stream.accept(np.asarray(batch["input"][i][:n],
                                              np.float32))
                     if n > 0 else "")
            if int(final[i]):
                piece += stream.flush()
                store.pop(sid, None)
            texts.append(piece)
        return texts

    def device_program():
        """The steady block's forward (carry in, carry out)."""
        stream = StreamingDS2(model, n_mels=n_mels, chunk_frames=chunk_frames,
                              device=dev)
        ext = torch.zeros((1, chunk_frames + StreamingDS2._CTX, n_mels),
                          device=dev)
        return stream._apply, (ext, stream._h)

    return [ServingTier(
        "stream", forward, speed=1.0,
        quality_note=f"stateful streaming session ({chunk_frames}-frame "
                     f"blocks, exact to the whole-utterance forward)",
        device_program=device_program,
        evict_session=lambda sid: store.pop(sid, None))]

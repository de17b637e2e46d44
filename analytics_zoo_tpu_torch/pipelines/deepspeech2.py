"""DeepSpeech2 pipelines (counterpart of ``pipelines/deepspeech2.py``).

Serving: audio → TimeSegmenter chunks tagged ``(audio_id, audio_seq)`` →
featurize → forward → CTC decode → re-join per utterance in
``audio_seq`` order → WER/CER.  Training: ``load_asr_train_set`` (host
featurize, optionally length-bucketed) → ``train_ds2`` (CTC loss, Adam,
the recurrences through K3 and K4 on the card).

All segments are zero-padded to ``segment_seconds`` and forwarded in
groups of ``batch_size``.  The padded segments go through the model
WITHOUT ``n_frames``, as in the reference.  The greedy, device-featurize
path runs featurize → forward → argmax on the card for one batch and
reads back only the (B, T') ids, with a window of batches in flight.

Not ported yet (ROADMAP.md Queue 1 items 8, 9, 12 and 13):
``StreamingDS2``, the serving tiers, the sequence-parallel forward and
training, sharded training, the multiprocess loader and checkpoints.
"""

from __future__ import annotations

import dataclasses
import logging
import time
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
    SAMPLE_RATE,
    WINDOW_SIZE,
    WINDOW_STRIDE,
    ASREvaluator,
    TimeSegmenter,
    VocabDecoder,
    beam_search_decode,
    best_path_decode,
    featurize,
    ids_to_text,
    make_featurizer_device,
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
    moved to ``device`` (the GPU unless ``device="cpu"``)."""

    def __init__(self, model: nn.Module, param: DS2Param = DS2Param(),
                 sequence_mesh=None, device=None):
        if sequence_mesh is not None:
            raise NotImplementedError(
                "the sequence-parallel DS2 forward is not ported yet "
                "(ROADMAP.md Queue 1 item 12)")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.param = param
        self.segmenter = TimeSegmenter(
            segment_size=SAMPLE_RATE * param.segment_seconds)
        self.utt_length = param.utt_length
        self._eval_step = make_eval_step(self.model)
        self.vocab_decoder = (VocabDecoder(param.vocab)
                              if param.vocab else None)
        self._dev_featurizer = None      # built at first use

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

        if (segments and self.param.device_featurize
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
                chunk = torch.from_numpy(
                    feats[i:i + self.param.batch_size]).to(self.device)
                log_probs = self._eval_step(chunk).cpu().numpy()
                texts.extend(self._decode(lp) for lp in log_probs)

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
        t0 = time.monotonic()
        hyps = self.transcribe_samples(utterances)
        ev = ASREvaluator()
        for audio_id, ref in transcripts.items():
            ev.add(ref.upper(), hyps.get(audio_id, ""))
        dt = time.monotonic() - t0
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
                       bucket_edges: Optional[Sequence[int]] = None
                       ) -> DataSet:
    """DataSet of host-featurized CTC train batches from raw waveforms.

    ``samples``: (N, S) float32 waveforms; ``labels``: (N, L) int32
    (0-padded); ``label_lengths``: (N,) true lengths (defaults to counting
    nonzero labels).  Batches: ``{"input", "labels", "label_mask"}``.

    With ``bucket_edges`` (frame counts), ragged waveforms
    (``sample_lengths``: true per-row sample counts) are featurized at
    their true length and batched into the smallest fitting bucket
    (``data.bucket.BucketBatcher``); batches then carry ``"input":
    (features, n_frames)`` for the model's mask, plus top-level
    ``n_frames`` for the CTC logit mask and ``padding_efficiency``.  The
    multiprocess loader (``worker_processes > 0``) is not ported
    (ROADMAP.md Queue 1 item 8)."""
    if worker_processes > 0:
        raise NotImplementedError(
            "load_asr_train_set(worker_processes > 0): the multiprocess "
            "loader is not ported yet (ROADMAP.md Queue 1 item 8)")

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

        return base.transform(FnTransformer(feat)).batch(batch_size)

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

    return (base.transform(FnTransformer(feat_ragged))
            .transform(BucketBatcher(batch_size, bucket_edges,
                                     length_key="n_frames",
                                     pad_key="input"))
            .transform(FnTransformer(pack)))


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
    ``lr`` for ``epochs`` epochs.  The recurrence engine is the model's:
    ``make_ds2_model(rnn_engine="pallas")`` trains through K3 and K4."""
    if mesh is not None or specs is not None or param_rules is not None:
        raise NotImplementedError(
            "train_ds2: sharded training (mesh, specs, param_rules) is not "
            "ported yet (ROADMAP.md Queue 1 item 12)")
    if sequence_parallel:
        raise NotImplementedError(
            "train_ds2(sequence_parallel=True) is not ported yet "
            "(ROADMAP.md Queue 1 item 12)")
    if checkpoint_path:
        raise NotImplementedError(
            "train_ds2(checkpoint_path=...): checkpoints are not ported yet "
            "(ROADMAP.md Queue 1 item 12)")
    return (Optimizer(model, dataset, ds2_ctc_criterion(blank_id=0),
                      metric_fn=ds2_padding_metric)
            .set_optim_method(Adam(lr))
            .set_end_when(Trigger.max_epoch(epochs))
            .optimize())

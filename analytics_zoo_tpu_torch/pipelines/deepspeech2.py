"""DeepSpeech2 inference pipeline (counterpart of the serving half of
``pipelines/deepspeech2.py``): audio → TimeSegmenter chunks tagged
``(audio_id, audio_seq)`` → featurize → forward → CTC decode → re-join
per utterance in ``audio_seq`` order → WER/CER.

All segments are zero-padded to ``segment_seconds`` and forwarded in
groups of ``batch_size``.  The padded segments go through the model
WITHOUT ``n_frames``, as in the reference.  The greedy, device-featurize
path runs featurize → forward → argmax on the card for one batch and
reads back only the (B, T') ids, with a window of batches in flight.

Not ported yet (ROADMAP.md Queue 1 items 9 and 12): ``StreamingDS2``,
the serving tiers, CTC training and the sequence-parallel forward.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.data.prefetch import overlap_window
from analytics_zoo_tpu_torch.models.deepspeech2 import DeepSpeech2
from analytics_zoo_tpu_torch.parallel.train import make_eval_step
from analytics_zoo_tpu_torch.transform.audio import (
    SAMPLE_RATE,
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
    the persistent-RNN kernel K3; ``None`` is the blocked loop."""
    return DeepSpeech2(hidden=hidden, n_rnn_layers=n_rnn_layers,
                       n_mels=n_mels, bidirectional=bidirectional,
                       rnn_engine=rnn_engine, device=device, seed=seed)

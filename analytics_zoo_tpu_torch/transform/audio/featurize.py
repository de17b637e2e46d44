"""Audio featurization (counterpart of ``transform/audio/featurize.py``):
Hann window 400 / stride 160 → magnitude rFFT → 13-filter mel bank → log,
padded or cropped to ``utt_length`` frames.

The host chain (:func:`featurize`) is the reference's numpy, copied;
:func:`make_featurizer_device` runs the same chain on a batch of
segments on the card.  Its FFT and filterbank product are library calls,
as the reference leaves them to XLA outside any kernel.  Constants: 16
kHz, window 400, stride 160, 13 mels, ``utt_length`` = seconds · 100.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from analytics_zoo_tpu_torch.utils.device import resolve_device

SAMPLE_RATE = 16000
WINDOW_SIZE = 400
WINDOW_STRIDE = 160
N_MELS = 13


def frame_signal(samples: np.ndarray, window_size: int = WINDOW_SIZE,
                 stride: int = WINDOW_STRIDE) -> np.ndarray:
    """(T,) samples → (n_frames, window_size) Hann-windowed frames
    (reference ``Windower``)."""
    samples = np.asarray(samples, np.float32)
    n = max((len(samples) - window_size) // stride + 1, 0)
    if n == 0:
        return np.zeros((0, window_size), np.float32)
    idx = np.arange(window_size)[None, :] + stride * np.arange(n)[:, None]
    frames = samples[idx]
    window = np.hanning(window_size).astype(np.float32)
    return frames * window


def dft_specgram(frames: np.ndarray) -> np.ndarray:
    """(n_frames, W) → (n_frames, W//2+1) magnitude spectrum (reference
    ``DFTSpecgram``: keep windowSize/2+1 bins)."""
    return np.abs(np.fft.rfft(frames, axis=-1)).astype(np.float32)


def mel_filterbank_matrix(n_mels: int = N_MELS, n_fft: int = WINDOW_SIZE,
                          sample_rate: int = SAMPLE_RATE,
                          f_min: float = 0.0,
                          f_max: Optional[float] = None) -> np.ndarray:
    """(n_bins, n_mels) triangular mel filter matrix."""
    f_max = f_max or sample_rate / 2.0
    n_bins = n_fft // 2 + 1

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    mels = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    freqs = mel_to_hz(mels)
    bins = np.floor((n_fft + 1) * freqs / sample_rate).astype(int)
    bins = np.clip(bins, 0, n_bins - 1)
    fb = np.zeros((n_bins, n_mels), np.float32)
    for m in range(1, n_mels + 1):
        left, center, right = bins[m - 1], bins[m], bins[m + 1]
        for k in range(left, center):
            if center > left:
                fb[k, m - 1] = (k - left) / (center - left)
        for k in range(center, right):
            if right > center:
                fb[k, m - 1] = (right - k) / (right - center)
    return fb


def mel_features(spec: np.ndarray, n_mels: int = N_MELS,
                 utt_length: Optional[int] = None,
                 fb: Optional[np.ndarray] = None) -> np.ndarray:
    """(n_frames, n_bins) power spectrum → (n_frames*, n_mels) log-mel,
    padded/cropped to ``utt_length`` frames (reference
    ``MelFrequencyFilterBank``: pad with zeros, crop from the front)."""
    if fb is None:
        fb = mel_filterbank_matrix(n_mels, (spec.shape[1] - 1) * 2)
    mel = np.log(np.maximum(spec @ fb, 1e-10)).astype(np.float32)
    if utt_length is not None:
        n = mel.shape[0]
        if n >= utt_length:
            mel = mel[:utt_length]
        else:
            mel = np.pad(mel, ((0, utt_length - n), (0, 0)))
    return mel


def transpose_flip(mel: np.ndarray) -> np.ndarray:
    """Min-max normalize to [0, 255] and emit (n_mels, T) model layout
    (reference ``TransposeFlip``: normalize + flip + transpose)."""
    lo, hi = float(mel.min()), float(mel.max())
    scaled = (mel - lo) / max(hi - lo, 1e-10) * 255.0
    return np.ascontiguousarray(scaled.T[::-1]).astype(np.float32)


def featurize(samples: np.ndarray, utt_length: Optional[int] = None,
              n_mels: int = N_MELS) -> np.ndarray:
    """samples (T,) → (n_frames, n_mels) log-mel features — the full
    reference chain Windower → DFTSpecgram → MelFrequencyFilterBank, in
    the (T, F) layout the DeepSpeech2 model consumes."""
    frames = frame_signal(samples)
    spec = dft_specgram(frames)
    return mel_features(spec, n_mels=n_mels, utt_length=utt_length)


def make_featurizer_device(segment_samples: int,
                           utt_length: Optional[int] = None,
                           n_mels: int = N_MELS, device=None):
    """Batched featurization on ``device`` (the GPU unless
    ``device="cpu"``).  Returns ``fn(samples (B, segment_samples),
    n_valid (B,)) → (B, utt_length, n_mels)`` float32 on that device.
    ``n_valid`` is each row's true sample count (rows are zero-padded to
    ``segment_samples``); frames past a row's valid frame count are
    zeroed, as the host chain pads with zeros after the log."""
    dev = resolve_device(device)
    n = max((segment_samples - WINDOW_SIZE) // WINDOW_STRIDE + 1, 0)
    out_len = utt_length if utt_length is not None else n
    idx = (torch.arange(WINDOW_SIZE, device=dev)[None, :]
           + WINDOW_STRIDE * torch.arange(n, device=dev)[:, None])
    window = torch.from_numpy(np.hanning(WINDOW_SIZE).astype(np.float32)
                              ).to(dev)
    fb = torch.from_numpy(mel_filterbank_matrix(n_mels, WINDOW_SIZE)).to(dev)
    frame_idx = torch.arange(n, device=dev)

    def run(samples, n_valid) -> torch.Tensor:
        samples = torch.as_tensor(samples, dtype=torch.float32).to(dev)
        frames = samples[:, idx] * window                   # (B, n, W)
        spec = torch.fft.rfft(frames, dim=-1).abs()         # (B, n, W//2+1)
        mel = torch.log(torch.clamp(spec @ fb, min=1e-10))  # (B, n, n_mels)
        n_valid = torch.as_tensor(n_valid).to(dev, torch.int64)
        frames_valid = torch.clamp(
            torch.div(n_valid - WINDOW_SIZE, WINDOW_STRIDE,
                      rounding_mode="floor") + 1, min=0)
        mask = frame_idx[None, :] < frames_valid[:, None]
        mel = torch.where(mask[..., None], mel, torch.zeros_like(mel))
        if n >= out_len:
            return mel[:, :out_len]
        return torch.nn.functional.pad(mel, (0, 0, 0, out_len - n))

    return run


@dataclasses.dataclass
class TimeSegmenter:
    """Split long audio into ≤ ``segment_size``-sample chunks tagged with
    ``(audio_id, seq)`` so transcripts re-join in order (reference
    ``TimeSegmenter.scala:11``)."""

    segment_size: int = SAMPLE_RATE * 30

    def segment(self, samples: np.ndarray, audio_id: str):
        out = []
        for seq, start in enumerate(range(0, len(samples), self.segment_size)):
            out.append({
                "audio_id": audio_id,
                "audio_seq": seq,
                "samples": np.asarray(samples[start:start + self.segment_size],
                                      np.float32),
            })
        return out

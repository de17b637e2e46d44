"""Audio file readers (counterpart of ``transform/audio/readers.py``):
WAV through the standard library, FLAC through the optional
``soundfile`` package, both as float32 samples and their rate."""

from __future__ import annotations

import wave
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Decode a PCM WAV file → (float32 samples in [-1, 1], sample_rate)."""
    with wave.open(path, "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        channels = w.getnchannels()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if channels > 1:
        data = data.reshape(-1, channels).mean(axis=1)
    return data, rate


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """Decode FLAC through ``soundfile`` where it is installed."""
    try:
        import soundfile  # optional dependency
    except ImportError as e:
        raise ImportError(
            "FLAC decoding requires the optional 'soundfile' package; "
            "convert to WAV or install soundfile") from e
    data, rate = soundfile.read(path, dtype="float32")
    if data.ndim > 1:
        data = data.mean(axis=1)
    return data.astype(np.float32), rate


def read_audio(path: str) -> Tuple[np.ndarray, int]:
    if path.lower().endswith(".flac"):
        return read_flac(path)
    return read_wav(path)

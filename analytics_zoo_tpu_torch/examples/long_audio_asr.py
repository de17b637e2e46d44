"""Long-audio ASR: sequence-parallel DS2 against the reference's lossy
chunking (counterpart of ``examples/long_audio_asr.py``).

The reference's only long-audio mechanism is ``TimeSegmenter``: chop the
waveform into fixed segments, transcribe each and re-join the text
(``deepspeech2/.../TimeSegmenter.scala:11``).  Chunking loses
cross-boundary context.  This example runs both paths on one long
utterance with one set of weights:

1. chunked: ``DeepSpeech2Pipeline`` with a short ``segment_seconds``;
2. sequence-parallel: one forward over the whole utterance with the time
   axis cut over the ranks of a ``("sequence",)`` mesh
   (``models/deepspeech2.py::sequence_parallel_forward``: the conv halo
   and the recurrences' carries exchanged between ranks), so a rank
   holds O(T/n) activations.

Ranks are ``torchrun``'s (``MASTER_ADDR``/``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``; one rank when none is set), each running
this module on the same utterance; ``--sequence-devices 0`` means
``WORLD_SIZE``.  Two ranks on one card share it over gloo::

    torchrun --nproc-per-node 2 -m \\
        analytics_zoo_tpu_torch.examples.long_audio_asr --rnn-engine pallas

or, from Python, ``utils.engine.spawn`` with ``local_ranks=[0, 0]`` and
``backend="gloo"`` on a target that calls :func:`main`.  On the CPU add
``--device cpu`` (gloo).  ``--rnn-engine pallas`` runs each rank's
chunk of the recurrences through K3.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from typing import Dict

import numpy as np

from analytics_zoo_tpu_torch.examples.common import (add_device_argument,
                                                     add_rnn_engine_argument,
                                                     init_ranks, lead_rank)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Long-audio sequence-parallel ASR")
    p.add_argument("--audio", default=None,
                   help="wav/flac file; synthetic tone sweep if unset")
    p.add_argument("--seconds", type=float, default=30.0,
                   help="synthetic utterance length")
    p.add_argument("--segment-seconds", type=int, default=5,
                   help="chunked-path segment size")
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--sequence-devices", type=int, default=0,
                   help="sequence-axis size (0 = all ranks)")
    add_device_argument(p)
    add_rnn_engine_argument(p)
    return p


def utterance(args) -> np.ndarray:
    """``--audio``'s samples, or the reference's synthetic tone sweep."""
    from analytics_zoo_tpu_torch.transform.audio import SAMPLE_RATE, read_audio

    if args.audio:
        samples, rate = read_audio(args.audio)
        if rate != SAMPLE_RATE:
            raise SystemExit(f"expected {SAMPLE_RATE} Hz, got {rate}")
        return samples
    t = np.arange(int(args.seconds * SAMPLE_RATE)) / SAMPLE_RATE
    sweep = np.sin(2 * np.pi * (200 + 30 * t) * t).astype(np.float32)
    return 0.1 * sweep


def run(args) -> Dict:
    """Both paths on this rank: the transcripts, their seconds, the
    utterance's length and the sequence axis' width."""
    import torch.distributed as dist

    from analytics_zoo_tpu_torch.parallel import create_mesh
    from analytics_zoo_tpu_torch.pipelines.deepspeech2 import (
        DS2Param, DeepSpeech2Pipeline, make_ds2_model)
    from analytics_zoo_tpu_torch.transform.audio import SAMPLE_RATE

    dev = init_ranks(args.device)
    world = dist.get_world_size()
    n_seq = args.sequence_devices or world
    if n_seq != world:
        raise SystemExit(f"--sequence-devices {n_seq}: the sequence axis "
                         f"spans every rank ({world}); start {n_seq} ranks")
    mesh = create_mesh((n_seq,), axis_names=("sequence",))
    samples = utterance(args)

    # one shared model: both paths decode with identical weights
    param_chunk = DS2Param(segment_seconds=args.segment_seconds,
                           batch_size=4)
    model = make_ds2_model(hidden=args.hidden, n_rnn_layers=1,
                           rnn_engine=args.rnn_engine, device=dev)

    t0 = time.perf_counter()
    chunked = DeepSpeech2Pipeline(model, param_chunk, device=dev
                                  ).transcribe_samples({"utt": samples})["utt"]
    t_chunk = time.perf_counter() - t0

    # sequence-parallel: segment only to the whole utterance's length
    # (rounded to the mesh multiple inside the pipeline)
    whole = DS2Param(segment_seconds=int(np.ceil(len(samples) / SAMPLE_RATE)),
                     batch_size=1)
    pipe_sp = DeepSpeech2Pipeline(model, whole, sequence_mesh=mesh,
                                  device=dev)
    t0 = time.perf_counter()
    seqpar = pipe_sp.transcribe_samples({"utt": samples})["utt"]
    t_sp = time.perf_counter() - t0
    return {"audio_s": len(samples) / SAMPLE_RATE, "samples": len(samples),
            "sequence_devices": n_seq, "rank": dist.get_rank(),
            "chunked": chunked, "chunked_s": t_chunk,
            "seqpar": seqpar, "seqpar_s": t_sp}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    r = run(args)
    if lead_rank():
        print(f"audio: {r['audio_s']:.1f}s ({r['samples']} samples)")
        print(f"chunked  ({args.segment_seconds}s segments): "
              f"{r['chunked_s']:.1f}s  -> {r['chunked'][:60]!r}")
        print(f"seq-par  (T sharded over {r['sequence_devices']} ranks): "
              f"{r['seqpar_s']:.1f}s  -> {r['seqpar'][:60]!r}")
        print("note: untrained demo weights — transcripts are noise; the "
              "point is the execution paths (chunk-and-rejoin vs one "
              "sharded forward)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

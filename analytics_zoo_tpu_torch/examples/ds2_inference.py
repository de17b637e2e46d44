"""DeepSpeech2 inference entry point (counterpart of
``examples/ds2_inference.py``; reference ``deepspeech2/example/
InferenceExample.scala`` and ``InferenceEvaluate.scala``): wav files →
transcripts, or a LibriSpeech-style mapping file → WER/CER, through
``DeepSpeech2Pipeline`` (segment, featurize on the card, forward, greedy
decode, re-join).

    python -m analytics_zoo_tpu_torch.examples.ds2_inference -d clips/ \\
        --model ds2.pt --rnn-engine pallas

``--model`` is a ``Model.save`` file (a ``torch.save`` state dict of the
``DeepSpeech2``); without it the weights are random from seed 0.
``--rnn-engine pallas`` runs the recurrence through the persistent-RNN
kernel (K3) and raises where it does not fit.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Dict

from analytics_zoo_tpu_torch.examples.common import (add_device_argument,
                                                     add_rnn_engine_argument)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DS2 transcription / evaluation")
    p.add_argument("-d", "--data", required=True,
                   help="wav file, folder of wavs, or mapping.txt "
                        "(lines: <wav path>\\t<transcript>)")
    p.add_argument("-m", "--model", default=None,
                   help="Model.save() file (random weights if omitted)")
    p.add_argument("-s", "--segment", type=int, default=30,
                   help="segment seconds (reference TimeSegmenter)")
    p.add_argument("-b", "--batch-size", type=int, default=8)
    p.add_argument("--hidden", type=int, default=1024)
    p.add_argument("--layers", type=int, default=3)
    p.add_argument("--vocab", default=None, help="vocab.txt for VocabDecoder")
    add_device_argument(p)
    add_rnn_engine_argument(p)
    return p


def make_pipeline(args):
    """The seeded (or ``--model``-loaded) DS2 in its pipeline."""
    from analytics_zoo_tpu_torch.core.module import Model
    from analytics_zoo_tpu_torch.pipelines.deepspeech2 import (
        DS2Param, DeepSpeech2Pipeline, make_ds2_model)
    from analytics_zoo_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    vocab = None
    if args.vocab:
        with open(args.vocab) as f:
            vocab = [line.strip() for line in f if line.strip()]
    model = make_ds2_model(hidden=args.hidden, n_rnn_layers=args.layers,
                           rnn_engine=args.rnn_engine, device=dev)
    if args.model:
        Model(model, device=dev).load(args.model)
    return DeepSpeech2Pipeline(
        model, DS2Param(segment_seconds=args.segment,
                        batch_size=args.batch_size, vocab=vocab),
        device=dev)


def run(args, pipe=None) -> Dict:
    """Transcripts by path (``{"transcripts": ...}``), or a mapping
    file's ``{"wer": ..., "cer": ...}``; the pipeline under
    ``"pipeline"``."""
    from analytics_zoo_tpu_torch.transform.audio import read_audio

    pipe = pipe or make_pipeline(args)
    if os.path.isfile(args.data) and args.data.endswith(".txt"):
        utts, refs = {}, {}
        with open(args.data) as f:
            for line in f:
                path, ref = line.rstrip("\n").split("\t", 1)
                utts[path], _ = read_audio(path)
                refs[path] = ref
        ev = pipe.evaluate(utts, refs)
        return {"wer": ev.wer, "cer": ev.cer, "pipeline": pipe}
    if os.path.isdir(args.data):
        paths = sorted(os.path.join(args.data, q)
                       for q in os.listdir(args.data)
                       if q.lower().endswith((".wav", ".flac")))
    else:
        paths = [args.data]
    return {"transcripts": pipe.transcribe_files(paths), "pipeline": pipe}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    out = run(args)
    if "wer" in out:
        print(f"WER = {out['wer']:.4f}  CER = {out['cer']:.4f}")
        return 0
    for path, text in out["transcripts"].items():
        print(f"{path}: {text}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

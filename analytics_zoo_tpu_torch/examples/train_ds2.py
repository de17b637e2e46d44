"""Train DeepSpeech2 with CTC (counterpart of ``examples/train_ds2.py``).

Without ``--data-dir``, trains on the reference's synthetic tone→label
task: each class is a pure tone painted into half of the time axis of
mel-like frames, and the model learns to emit the class tokens — a
self-contained check of the CTC training path, scored on held-out
utterances by greedy and prefix-beam CER
(``transform/audio/decoders.py::evaluate_ctc_decoders``).

With ``--data-dir``, expects ``<dir>/mapping.txt`` lines ``<wav-path>
<TRANSCRIPT>`` (LibriSpeech-style) read through ``read_audio``,
``featurize`` and ``TranscriptVectorizer``; the last batch is held out.

    python -m analytics_zoo_tpu_torch.examples.train_ds2 --epochs 10 \\
        --rnn-engine pallas --out ACCURACY_torch.md

Training is ``pipelines/deepspeech2.py::train_ds2`` on the card.
``--rnn-engine pallas`` runs the recurrence through the persistent-RNN
kernels (K3 in the forward, K4 in the backward) and raises where they do
not fit; the default is the blocked loop, as the reference's.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Dict, Tuple

import numpy as np

from analytics_zoo_tpu_torch.examples.common import (add_device_argument,
                                                     add_rnn_engine_argument,
                                                     append_report,
                                                     report_device)


def synthetic_batches(n_batches, batch_size, utt_length=100, n_mels=13,
                      n_tokens=4, seed=0):
    """Tone-like synthetic features with per-frame class structure (the
    reference's draws, in its order)."""
    rng = np.random.RandomState(seed)
    batches = []
    for _ in range(n_batches):
        labels = rng.randint(1, n_tokens, size=(batch_size, 2)).astype(np.int32)
        x = rng.randn(batch_size, utt_length, n_mels).astype(np.float32) * 0.1
        # paint each label's signature into a half of the time axis
        half = utt_length // 2
        for b in range(batch_size):
            for k in range(2):
                sl = slice(k * half, (k + 1) * half)
                x[b, sl, labels[b, k] % n_mels] += 2.0
        batches.append({
            "input": x,
            "labels": labels,
            "label_mask": np.ones_like(labels, np.float32),
        })
    return batches


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train DeepSpeech2 (CTC)")
    p.add_argument("--data-dir", default=None,
                   help="dir with mapping.txt + audio; synthetic if unset")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--batches", type=int, default=8,
                   help="synthetic training batches per epoch")
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--rnn-layers", type=int, default=1)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--out", default=None,
                   help="append a JSON accuracy report to this md file")
    add_device_argument(p)
    add_rnn_engine_argument(p)
    return p


def mapping_batches(data_dir: str, batch_size: int):
    """``<data_dir>/mapping.txt`` → (training batches, held-out batches,
    whether the held-out batch is a training one): 1000-frame features
    and padded label ids, the last batch held out when there are two."""
    from analytics_zoo_tpu_torch.transform.audio import (
        ALPHABET, TranscriptVectorizer, featurize, read_audio)

    vec = TranscriptVectorizer(ALPHABET)
    feats, ids_rows, mask_rows = [], [], []
    with open(os.path.join(data_dir, "mapping.txt")) as f:
        for line in f:
            path, _, text = line.strip().partition(" ")
            samples, _ = read_audio(os.path.join(data_dir, path))
            feats.append(featurize(samples, utt_length=1000))
            ids, mask = vec(text)
            ids_rows.append(ids)
            mask_rows.append(mask)
    x, lab, mask = np.stack(feats), np.stack(ids_rows), np.stack(mask_rows)
    batches = [{"input": x[i:i + batch_size],
                "labels": lab[i:i + batch_size],
                "label_mask": mask[i:i + batch_size]}
               for i in range(0, len(x) - batch_size + 1, batch_size)]
    if len(batches) > 1:
        return batches[:-1], batches[-1:], False
    return batches, batches, True


def log_probs_fn(model, device):
    """``inputs → (B, T/2, 29)`` log-probs of ``model`` in eval mode on
    ``device``, for ``evaluate_ctc_decoders``."""
    import torch

    def forward(x):
        model.eval()
        with torch.inference_mode():
            return model(torch.as_tensor(np.asarray(x), device=device))

    return forward


def run(args) -> Tuple[Dict, object]:
    """The training and the held-out evaluation: ``(report, model)``."""
    from analytics_zoo_tpu_torch.pipelines.deepspeech2 import (make_ds2_model,
                                                               train_ds2)
    from analytics_zoo_tpu_torch.transform.audio import evaluate_ctc_decoders
    from analytics_zoo_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if args.data_dir:
        batches, heldout, heldout_is_train = mapping_batches(
            args.data_dir, args.batch_size)
    else:
        batches = synthetic_batches(args.batches, args.batch_size,
                                    utt_length=100, n_tokens=4)
        heldout = synthetic_batches(2, args.batch_size, seed=123)
        heldout_is_train = False

    model = make_ds2_model(hidden=args.hidden, n_rnn_layers=args.rnn_layers,
                           rnn_engine=args.rnn_engine, device=dev)
    train_ds2(model, batches, epochs=args.epochs, lr=args.lr,
              checkpoint_path=args.checkpoint)

    # held-out eval: greedy and prefix-beam decoders, token edit distance
    m = evaluate_ctc_decoders(log_probs_fn(model, dev), heldout)
    cer_field = "train_set_cer" if heldout_is_train else "cer"
    report = {
        "task": ("LibriSpeech-style dir" if args.data_dir
                 else "synthetic tone→token CTC (held-out)"),
        cer_field: m["cer"],
        "exact_sequence_acc": m["exact_sequence_acc"],
        "beam_" + cer_field: m["beam_cer"],
        "beam_exact_sequence_acc": m["beam_exact_sequence_acc"],
        "sequences": m["sequences"],
        "epochs": args.epochs,
        "rnn_engine": args.rnn_engine,
        **report_device(dev),
    }
    return report, model


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    report, _ = run(args)
    print(json.dumps(report))
    if args.out:
        append_report(args.out, "DeepSpeech2 CTC training, PyTorch port",
                      "analytics_zoo_tpu_torch.examples.train_ds2", report)
    return 0


if __name__ == "__main__":
    sys.exit(main())

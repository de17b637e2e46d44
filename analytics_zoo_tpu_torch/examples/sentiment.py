"""Sentiment analysis (counterpart of ``examples/sentiment.py``; reference
``apps/sentimentAnalysis/sentiment.ipynb``): embeddings and a selectable
GRU / LSTM / BiLSTM / CNN / CNN-LSTM head, BCE loss and Adam through the
``Optimizer``, held-out Top1 accuracy through ``parallel/train.py::
validate``, on the reference's synthetic IMDB-style token sequences.

    python -m analytics_zoo_tpu_torch.examples.sentiment --head gru \\
        --out ACCURACY_torch.md
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import Dict

import numpy as np

from analytics_zoo_tpu_torch.examples.common import (add_device_argument,
                                                     append_report,
                                                     init_ranks,
                                                     report_device)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train a sentiment classifier")
    p.add_argument("--head", default="cnn",
                   choices=("gru", "lstm", "bilstm", "cnn", "cnn-lstm"))
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--seq-len", type=int, default=100)
    p.add_argument("--vocab", type=int, default=5000)
    p.add_argument("--embedding-dim", type=int, default=64)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--samples", type=int, default=4096)
    p.add_argument("--out", default=None,
                   help="append a JSON accuracy report to this md file")
    add_device_argument(p)
    return p


def synthetic_reviews(samples: int, seq_len: int, vocab: int):
    """The reference's IMDB stand-in, draw for draw: two token
    distributions with sentiment-marker tokens mixed in.  Returns
    ``(tokens int32 (n, seq_len), labels float32 (n,))``."""
    rng = np.random.RandomState(0)
    n = samples
    labels = rng.randint(0, 2, n).astype(np.float32)
    tokens = rng.randint(10, vocab, (n, seq_len))
    markers = np.where(labels[:, None] > 0,
                       rng.randint(2, 6, (n, seq_len)),
                       rng.randint(6, 10, (n, seq_len)))
    mask = rng.rand(n, seq_len) < 0.15
    tokens = np.where(mask, markers, tokens).astype(np.int32)
    return tokens, labels


class BinaryAccuracy:
    """Top1 accuracy of a sigmoid output at 0.5."""

    name = "Top1Accuracy"

    def __call__(self, output, batch):
        from analytics_zoo_tpu_torch.parallel import ValidationResult

        if hasattr(output, "detach"):
            output = output.detach().cpu().numpy()
        pred = (np.asarray(output) > 0.5).astype(np.float32)
        tgt = np.asarray(batch["target"])
        return ValidationResult(float((pred == tgt).sum()), tgt.size,
                                self.name)


def run(args) -> Dict:
    """Training and the held-out accuracy: the report."""
    from analytics_zoo_tpu_torch.core.criterion import BCECriterion
    from analytics_zoo_tpu_torch.core.module import Model
    from analytics_zoo_tpu_torch.data import DataSet
    from analytics_zoo_tpu_torch.models import SentimentNet
    from analytics_zoo_tpu_torch.parallel import (Adam, Optimizer, Trigger,
                                                  create_mesh, validate)

    dev = init_ranks(args.device)
    tokens, labels = synthetic_reviews(args.samples, args.seq_len, args.vocab)
    split = int(args.samples * 0.8)
    train = DataSet.from_arrays(input=tokens[:split], target=labels[:split],
                                shuffle=True).batch(args.batch_size)
    val = DataSet.from_arrays(input=tokens[split:], target=labels[split:]
                              ).batch(args.batch_size)

    model = Model(SentimentNet(vocab_size=args.vocab,
                               embedding_dim=args.embedding_dim,
                               hidden=args.hidden, head=args.head),
                  device=dev)
    model.build(0, np.zeros((2, args.seq_len), np.int32))
    (Optimizer(model.module, train, BCECriterion(), mesh=create_mesh())
     .set_optim_method(Adam(1e-3))
     .set_validation(Trigger.every_epoch(), val, [BinaryAccuracy()])
     .set_end_when(Trigger.max_epoch(args.epochs))
     .optimize())

    res = validate(model.module, val, [BinaryAccuracy()])
    if not res:
        raise SystemExit("held-out set produced no batches — lower "
                         "--batch-size")
    return {
        "task": "synthetic IMDB-style sentiment (held-out)",
        "head": args.head,
        "accuracy": res[0].result(),
        "samples": args.samples,
        "epochs": args.epochs,
        **report_device(dev),
    }


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    report = {k: round(v, 4) if isinstance(v, float) else v
              for k, v in run(args).items()}
    print(json.dumps(report))
    if args.out:
        append_report(args.out, f"Sentiment ({args.head} head), PyTorch port",
                      "analytics_zoo_tpu_torch.examples.sentiment", report)
    return 0


if __name__ == "__main__":
    sys.exit(main())

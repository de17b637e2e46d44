"""Train AttentionASR (transformer CTC) with held-out CER (counterpart of
``examples/train_attention_asr.py``), on ``train_ds2``'s synthetic
tone→token task and through ``pipelines/deepspeech2.py::train_ds2``.

Three variants share one harness and one task:

- ``full``: the plain ``full_attention`` encoder;
- ``ring``: the same architecture with ``RingAttentionLayer`` on a
  (data × sequence) mesh of every rank: each rank holds a block of the
  time axis, the k/v blocks rotate between ranks, and training runs end
  to end through the ``Optimizer``.  Ranks are ``torchrun``'s (see
  ``long_audio_asr``); the sequence axis is ``WORLD_SIZE``;
- ``moe``: Mixture-of-Experts feed-forward blocks (``MoEFeedForward``,
  top-1 routing, the dense path).

    python -m analytics_zoo_tpu_torch.examples.train_attention_asr \\
        --variant full --out ACCURACY_torch.md
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Dict, Tuple

from analytics_zoo_tpu_torch.examples.common import (add_device_argument,
                                                     append_report,
                                                     init_ranks, lead_rank,
                                                     report_device)
from analytics_zoo_tpu_torch.examples.train_ds2 import (log_probs_fn,
                                                        synthetic_batches)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train AttentionASR (CTC)")
    p.add_argument("--variant", choices=("full", "ring", "moe"),
                   default="full")
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--batches", type=int, default=8)
    p.add_argument("--dim", type=int, default=32)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--heads", type=int, default=2)
    p.add_argument("--experts", type=int, default=4)
    p.add_argument("--utt-length", type=int, default=96,
                   help="frames; /2 after the conv must divide the "
                        "sequence axis for --variant ring")
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--out", default=None,
                   help="append a JSON accuracy report to this md file")
    add_device_argument(p)
    return p


def run(args) -> Tuple[Dict, object]:
    """The training and the held-out evaluation: ``(report, model)``."""
    from analytics_zoo_tpu_torch.models import AttentionASR
    from analytics_zoo_tpu_torch.pipelines.deepspeech2 import train_ds2
    from analytics_zoo_tpu_torch.transform.audio import evaluate_ctc_decoders
    from analytics_zoo_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    mesh = None
    kwargs = dict(dim=args.dim, depth=args.depth, num_heads=args.heads)
    if args.variant == "ring":
        import torch.distributed as dist

        from analytics_zoo_tpu_torch.parallel import create_mesh
        from analytics_zoo_tpu_torch.parallel.sequence import (
            RingAttentionLayer)

        def refuse_off_axis(n_seq):
            # refusing to degrade silently: a sequence=1 "ring" run would
            # record a ring-attention accuracy claim a single-program run
            # produced
            if (args.utt_length // 2) % n_seq:
                raise SystemExit(
                    f"--variant ring: post-conv length "
                    f"{args.utt_length // 2} must divide the {n_seq} ranks "
                    f"— pick --utt-length as a multiple of {2 * n_seq}")

        # the axis is every rank: each refuses before it joins the group
        refuse_off_axis(int(os.environ.get("WORLD_SIZE", 1)))
        dev = init_ranks(args.device)
        n_seq = dist.get_world_size()
        refuse_off_axis(n_seq)
        mesh = create_mesh((1, n_seq), axis_names=("data", "sequence"))
        kwargs["attention_fn"] = RingAttentionLayer(mesh)
    elif args.variant == "moe":
        kwargs["n_experts"] = args.experts

    batches = synthetic_batches(args.batches, args.batch_size,
                                utt_length=args.utt_length, n_tokens=4)
    heldout = synthetic_batches(2, args.batch_size,
                                utt_length=args.utt_length, seed=123)

    model = AttentionASR(**kwargs, device=dev, seed=0)
    train_ds2(model, batches, epochs=args.epochs, lr=args.lr, mesh=mesh)

    # held-out CER, greedy and prefix-beam (the train_ds2 harness's metric)
    report = {
        "task": "synthetic tone→token CTC (held-out)",
        "model": f"attention_asr/{args.variant}",
        **evaluate_ctc_decoders(log_probs_fn(model, dev), heldout),
        "epochs": args.epochs,
        **report_device(dev),
    }
    if mesh is not None:
        report["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return report, model


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    report, _ = run(args)
    if not lead_rank():
        return 0
    print(json.dumps(report))
    if args.out:
        append_report(args.out, f"AttentionASR ({args.variant}), PyTorch port",
                      "analytics_zoo_tpu_torch.examples.train_attention_asr",
                      report)
    return 0


if __name__ == "__main__":
    sys.exit(main())

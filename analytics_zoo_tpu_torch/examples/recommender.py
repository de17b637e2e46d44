"""Recommender (counterpart of ``examples/recommender.py``; reference
``apps/recommendation/recommender-explicit-feedback.ipynb``): Neural CF
or Wide&Deep over 5 rating classes, ClassNLL and Adam through the
``Optimizer``, MAE and loss validation, held-out MAE through
``parallel/train.py::validate``, then top-K items for one user.

    python -m analytics_zoo_tpu_torch.examples.recommender \\
        --model wide_and_deep --out ACCURACY_torch.md

The synthetic explicit feedback is the reference's, draw for draw.
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
    p = argparse.ArgumentParser(description="Train a neural CF recommender")
    p.add_argument("--users", type=int, default=200)
    p.add_argument("--items", type=int, default=300)
    p.add_argument("--ratings", type=int, default=20000)
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--model", choices=("ncf", "wide_and_deep"),
                   default="ncf")
    p.add_argument("--seed", type=int, default=0,
                   help="controls data generation AND model init — re-run "
                        "over several seeds to test the ncf vs "
                        "wide_and_deep ordering against seed noise")
    p.add_argument("--out", default=None,
                   help="append a JSON accuracy report to this md file")
    add_device_argument(p)
    return p


def synthetic_ratings(args) -> Dict[str, np.ndarray]:
    """The reference's synthetic explicit feedback: a latent-factor term,
    per-user and per-item biases and per-pair quirks on a popularity-
    skewed pool of repeated (user, item) events, cut into 1..5 stars
    (0..4).  Returns ``users``, ``items``, ``stars`` and the pool size."""
    rng = np.random.RandomState(args.seed)
    u_lat = rng.randn(args.users, 8)
    i_lat = rng.randn(args.items, 8)
    u_bias = rng.randn(args.users) * 0.8
    i_bias = rng.randn(args.items) * 0.8
    pool = min(4000, args.users * args.items)       # distinct (u,i) events
    pool_u = rng.randint(0, args.users, pool)
    pool_i = rng.randint(0, args.items, pool)
    pair_quirk = rng.randn(pool) * 3.0
    popularity = 1.0 / np.arange(1, pool + 1)       # zipf-ish re-serving
    popularity /= popularity.sum()
    ev = rng.choice(pool, args.ratings, p=popularity)
    users, items = pool_u[ev], pool_i[ev]
    raw = (0.5 * np.sum(u_lat[users] * i_lat[items], axis=1)
           + u_bias[users] + i_bias[items] + pair_quirk[ev])
    stars = np.clip(np.digitize(raw, np.quantile(raw, [0.2, 0.4, 0.6, 0.8])),
                    0, 4).astype(np.int32)          # 0..4 = 1..5 stars
    return {"users": users, "items": items, "stars": stars, "pool": pool}


def rating_batches(data, lo: int, hi: int, shuffle: bool, batch_size: int):
    """The reference's batches of rows ``[lo, hi)``: shuffled by a
    ``RandomState(epoch)`` each pass when ``shuffle``, the last partial
    batch dropped."""
    users, items, stars = data["users"], data["items"], data["stars"]
    idx_all = np.arange(lo, hi)
    state = {"epoch": 0}

    class _DS:
        def __iter__(self):
            idx = idx_all.copy()
            if shuffle:
                np.random.RandomState(state["epoch"]).shuffle(idx)
                state["epoch"] += 1
            for i in range(0, len(idx) - batch_size + 1, batch_size):
                sel = idx[i:i + batch_size]
                yield {"input": (users[sel], items[sel]),
                       "target": stars[sel]}
    return _DS()


def run(args) -> Dict:
    """Training, the held-out MAE and the top-K list: the report, with
    ``top_items`` and ``pred_stars``."""
    import torch

    from analytics_zoo_tpu_torch.core.criterion import ClassNLLCriterion
    from analytics_zoo_tpu_torch.core.module import Model
    from analytics_zoo_tpu_torch.models import NeuralCF, WideAndDeep
    from analytics_zoo_tpu_torch.parallel import (MAE, Adam, Loss, Optimizer,
                                                  Trigger, create_mesh,
                                                  validate)

    dev = init_ranks(args.device)
    data = synthetic_ratings(args)
    split = int(args.ratings * 0.9)

    def batches(lo, hi, shuffle):
        return rating_batches(data, lo, hi, shuffle, args.batch_size)

    if args.model == "wide_and_deep":
        # cross table sized ~2x the distinct-pair pool: hash collisions
        # would otherwise blend unrelated pairs' quirks
        net = WideAndDeep(n_users=args.users, n_items=args.items,
                          cross_buckets=2 * data["pool"])
    else:
        net = NeuralCF(n_users=args.users, n_items=args.items)
    model = Model(net, device=dev)
    model.build(args.seed, np.zeros(2, np.int32), np.zeros(2, np.int32))
    crit = ClassNLLCriterion()
    (Optimizer(model.module, batches(0, split, True), crit,
               mesh=create_mesh())
     .set_optim_method(Adam(2e-3))
     .set_validation(Trigger.every_epoch(),
                     batches(split, args.ratings, False),
                     [MAE(), Loss(crit)])
     .set_end_when(Trigger.max_epoch(args.epochs))
     .optimize())

    res = validate(model.module, batches(split, args.ratings, False), [MAE()])
    if not res:
        raise SystemExit("held-out set produced no batches — lower "
                         "--batch-size")

    # top-K recommendation for one user (the notebook's predict_class)
    uid = 0
    all_items = np.arange(args.items)
    model.module.eval()
    with torch.inference_mode():
        scores = model.module(
            torch.full((args.items,), uid, device=dev),
            torch.as_tensor(all_items, device=dev)).cpu().numpy()
    pred_star = scores.argmax(axis=1)
    expect = np.exp(scores) @ np.arange(5)
    order = np.argsort(-expect)[:args.topk]
    return {
        "task": "synthetic MovieLens-style explicit feedback (held-out)",
        "model": args.model,
        "mae_stars": res[0].result(),
        "ratings": args.ratings,
        "epochs": args.epochs,
        "seed": args.seed,
        **report_device(dev),
        "top_items": [int(i) for i in order],
        "pred_stars": [int(pred_star[i]) + 1 for i in order],
    }


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    r = run(args)
    top = list(zip(r.pop("top_items"), r.pop("pred_stars")))
    report = {k: round(v, 4) if isinstance(v, float) else v
              for k, v in r.items()}
    print(json.dumps(report))
    if args.out:
        append_report(args.out, f"Recommender ({args.model}), PyTorch port",
                      "analytics_zoo_tpu_torch.examples.recommender", report)
    print(f"top-{args.topk} items for user 0: "
          + ", ".join(f"item {i} (pred {s}★)" for i, s in top))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time AttentionASR over a two-rank ``sequence`` axis on one card, through
whichever ``analytics_zoo_tpu_torch`` comes first on the path, so that two
trees can be compared on one card in one run:

    (cd OLD_TREE && PYTHONPATH=. python3 NEW/analytics_zoo_tpu_torch/tools/time_ring.py)
    PYTHONPATH=. python3 analytics_zoo_tpu_torch/tools/time_ring.py

Run the two in turns (old, new, new, old), each from its own tree's root:
the ranks start with ``python -m``, which puts the working directory
first on the path (``forward_gathers`` tells the trees apart: one gather
a forward where the encoder runs on T-blocks, one a layer before).  Two
ranks share the card over
gloo, on a (1, 2) ("data", "sequence") mesh with ``RingAttentionLayer``,
at the reference's AttentionASR width (dim 128, depth 4, 4 heads) on 8 ×
3000 seeded frames, fp32, TF32 off.  Uses only calls every tree since the
ring's port has (``AttentionASR``, ``RingAttentionLayer``,
``make_train_step``).  Prints one JSON line: the package's directory, the
card's name and power limit, and by rank the ring forward's least ms of 3
(no autograd) and its peak GB, the float all-gathers and ring hops of one
forward, and the least ms of 3 training steps (Adam), their peak GB and
the first loss.
"""

import json
import os
import subprocess
import sys
import time

BATCH, FRAMES, REPS, SEED = 8, 3000, 3, 43
KW = dict(dim=128, depth=4, num_heads=4, n_alphabet=29, n_mels=13,
          conv_channels=32)


def _measured(fn, reps):
    """(the first result, the least host ms of ``reps`` calls, the peak
    GB over them)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, best = None, float("inf")
    for i in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
        out = got if i == 0 else out
    return out, best, torch.cuda.max_memory_allocated() / 1e9


def rank(batch):
    """One rank: the ring forward, its collectives, the training steps."""
    import torch
    import torch.distributed as dist

    from analytics_zoo_tpu_torch.models.attention import AttentionASR
    from analytics_zoo_tpu_torch.parallel import (Adam, create_train_state,
                                                  make_train_step)
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    from analytics_zoo_tpu_torch.parallel.sequence import RingAttentionLayer
    from analytics_zoo_tpu_torch.pipelines.deepspeech2 import (
        ds2_ctc_criterion)
    from analytics_zoo_tpu_torch.utils import engine

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = engine.device()
    mesh = mesh_lib.create_mesh((1, 2), ("data", "sequence"))
    model = AttentionASR(**KW, attention_fn=RingAttentionLayer(mesh),
                         device=dev, seed=SEED)
    x = torch.from_numpy(batch["input"]).to(dev)
    out = {}
    with torch.no_grad():
        _, out["forward_ms"], out["forward_peak_gb"] = _measured(
            lambda: model(x), REPS)
        calls = {"all_gather_into_tensor": 0, "all_to_all_single": 0}
        saved = {n: getattr(dist, n) for n in calls}

        def counted(name):
            def call(*args, **kwargs):
                calls[name] += 1
                return saved[name](*args, **kwargs)
            return call

        for n in calls:
            setattr(dist, n, counted(n))
        try:
            model(x)
        finally:
            for n, fn in saved.items():
                setattr(dist, n, fn)
    out["forward_gathers"] = calls["all_gather_into_tensor"]
    out["forward_hops"] = calls["all_to_all_single"]
    optim = Adam(3e-4)
    step = make_train_step(model, ds2_ctc_criterion(blank_id=0), optim,
                           mesh=mesh)
    state = create_train_state(model, optim)
    (_, metrics), out["step_ms"], out["step_peak_gb"] = _measured(
        lambda: step(state, batch), REPS)
    out["loss"] = float(metrics["loss"])
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_ring: no CUDA device", file=sys.stderr)
        return 2
    import analytics_zoo_tpu_torch
    from analytics_zoo_tpu_torch.utils import engine

    rng = np.random.RandomState(SEED)
    labels = rng.randint(1, 29, (BATCH, 40)).astype(np.int32)
    batch = {"input": rng.randn(BATCH, FRAMES, 13).astype(np.float32),
             "labels": labels,
             "label_mask": np.ones(labels.shape, np.float32)}
    ranks = engine.spawn(os.path.abspath(__file__) + ":rank", 2,
                         {"batch": batch}, timeout=600, backend="gloo",
                         local_ranks=[0, 0])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    keys = ranks[0].keys()
    print(json.dumps(dict(
        {"tool": "time_ring",
         "package": os.path.dirname(analytics_zoo_tpu_torch.__file__),
         "nvidia_smi": smi, "frames": FRAMES, "model": KW},
        **{f"{k}_by_rank": [r[k] for r in ranks] for k in keys})),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Probe and time the collective under ``parallel/sequence.py``'s
exchanges, ``dist.all_to_all_single``, on CUDA tensors over gloo, two
ranks sharing one card:

    PYTHONPATH=. python3 analytics_zoo_tpu_torch/tools/probe_exchange.py

Each rank runs, on ``cuda:0``: an even exchange of 4 floats, an uneven
one (rank 0 sends 3 floats to rank 1, the rest of the splits 0), five
timed even exchanges of 8 × 1760 floats (a DS2 batch's carry; host clock
between two synchronizes), and an ``all_gather_into_tensor``.  Prints
the card's name and power limit, the torch and CUDA versions, then one
JSON line: each rank's ``{case: ["ok", result] | [the error]}``.
"""

import json
import os
import subprocess
import sys
import time


def child():
    """One rank's cases (``engine.spawn`` target)."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    r, n = dist.get_rank(), dist.get_world_size()
    out = {}

    def run(name, fn):
        try:
            v = fn()
            torch.cuda.synchronize()
            out[name] = ["ok", v]
        except Exception as e:   # the probe's answer, printed
            out[name] = [f"{type(e).__name__}: {str(e)[:200]}"]
        dist.barrier()

    def even():
        x = torch.arange(4, device=dev, dtype=torch.float32) + 10 * r
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x)
        return y.tolist()

    def uneven():
        x = torch.arange(3, device=dev, dtype=torch.float32) + 10 * r
        ins = [0, 3] if r == 0 else [0, 0]
        outs = [3, 0] if r == 1 else [0, 0]
        y = torch.empty(sum(outs), device=dev)
        dist.all_to_all_single(y, x[:sum(ins)], outs, ins)
        return y.tolist()

    def timed():
        x = torch.randn(8 * 1760, device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
        y = torch.empty_like(x)
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist.all_to_all_single(y, x)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms

    def gather():
        x = torch.ones(4, device=dev) * r
        y = torch.empty(4 * n, device=dev)
        dist.all_gather_into_tensor(y, x)
        return y.tolist()

    for name, fn in (("even", even), ("uneven", uneven), ("big_ms", timed),
                     ("all_gather_into_tensor", gather)):
        run(name, fn)
    return out


def main() -> int:
    import torch

    from analytics_zoo_tpu_torch.utils import engine

    if not torch.cuda.is_available():
        print("probe_exchange: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(torch.__version__, torch.version.cuda, flush=True)
    ranks = engine.spawn(os.path.abspath(__file__) + ":child", 2, {},
                         timeout=120, backend="gloo", local_ranks=[0, 0])
    print(json.dumps(ranks), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time K3 and K4 at the DeepSpeech2 shape through the wrappers of
whichever ``analytics_zoo_tpu_torch`` comes first on the path, so that
two trees can be compared on one card in one session:

    PYTHONPATH=OLD_TREE python3 analytics_zoo_tpu_torch/tools/time_rnn.py
    PYTHONPATH=.        python3 analytics_zoo_tpu_torch/tools/time_rnn.py

Run the two in turns (old, new, new, old).  Uses only the wrappers'
public calls (``persistent_rnn_fwd``, ``persistent_rnn_bwd``), which every
tree since K4's port has.  Inputs are seeded: B=8, T=1500, H=1760,
clipped ReLU, fp32, all steps valid, ``time_block`` 8.  Prints one JSON
line: the package's directory, the card's name and power limit, K3 and
K4 in ms (CUDA events, the mean of 5 launches after one), and the norm
and a sha256 of each output, equal across trees when the results are.
"""

import hashlib
import json
import subprocess
import sys

B, T, H, TIME_BLOCK, REPS = 8, 1500, 1760, 8, 5


def cuda_ms(fn, reps: int = REPS) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_rnn: no CUDA device", file=sys.stderr)
        return 2
    import analytics_zoo_tpu_torch
    from analytics_zoo_tpu_torch.ops import pallas_rnn

    dev = torch.device("cuda")
    rng = np.random.RandomState(0)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale)
                                .astype(np.float32)).to(dev)

    pre = randn(B, T, H)
    w = randn(H, H, scale=1.0 / np.sqrt(H))
    b = torch.zeros(H, device=dev)
    h0 = torch.zeros(1, B, H, device=dev)
    n = torch.full((B,), T, dtype=torch.int32, device=dev)
    g_ys, g_cf = randn(B, T, H), randn(1, B, H)
    cfg = pallas_rnn.RnnKernelConfig("vanilla", "clipped_relu", TIME_BLOCK)

    ys, _, cs = pallas_rnn.persistent_rnn_fwd(cfg, pre, w, b, h0, n,
                                              save_residuals=True)
    grads = pallas_rnn.persistent_rnn_bwd(cfg, pre, w, b, n, cs, g_ys, g_cf)
    k3_ms = cuda_ms(lambda: pallas_rnn.persistent_rnn_fwd(cfg, pre, w, b,
                                                          h0, n))
    k4_ms = cuda_ms(lambda: pallas_rnn.persistent_rnn_bwd(
        cfg, pre, w, b, n, cs, g_ys, g_cf))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    outs = dict(zip(("ys", "d_pre", "d_w", "d_b", "d_h0"),
                    (ys,) + tuple(grads)))
    norms = {k: v.double().norm().item() for k, v in outs.items()}
    sha = {k: hashlib.sha256(v.detach().cpu().contiguous().numpy()
                             .tobytes()).hexdigest()[:16]
           for k, v in outs.items()}
    print(json.dumps({"package": analytics_zoo_tpu_torch.__path__[0],
                      "nvidia_smi": smi, "k3_ms": k3_ms, "k4_ms": k4_ms,
                      "norms": norms, "sha256": sha}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

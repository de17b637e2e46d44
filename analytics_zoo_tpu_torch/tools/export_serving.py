"""Export a trained model as an int8 serving artifact (counterpart of
``tools/export_serving.py``)::

    train (a checkpoint snapshot / a Model.save file)
      → quantize (utils.quantize, per-channel int8 weights)
      → one .npz artifact (~4x smaller)
      → make_quantized_forward at serve time.

Usage::

    python -m analytics_zoo_tpu_torch.tools.export_serving \\
        --checkpoint ckpts/run1 --arch ssd300 --classes 21 \\
        --out ssd300_int8.npz [--verify]
    python -m analytics_zoo_tpu_torch.tools.export_serving \\
        --model-file model.pt --arch ds2 --out ds2_int8.npz

``--checkpoint`` is a ``parallel.checkpoint`` snapshot (an
``Optimizer``'s: the module's state dict under ``"model"``, or a bare
state dict); ``--model-file`` a ``Model.save`` file (a ``torch.save``
state dict).  The artifact is the reference's format
(``utils.quantize.save_quantized_npz``); load it back with
``load_quantized_npz`` + ``make_quantized_forward``.  ``--verify``
compares the quantized forward with the fp32 one on the reference's zero
input and on a seeded uniform one, and fails past the reference's bound
(relative max-abs error 0.1), every output of the model held (SSD's
``(loc, conf)`` pair: the reference's check cannot take a pair, whose
two shapes ``np.asarray`` refuses).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.examples.common import add_device_argument

#: the reference's bound on the quantized output's relative error
VERIFY_REL_MAX = 0.1


def build_model(arch: str, classes: int, hidden: int, device):
    """The ``Model`` of ``--arch`` on ``device`` (weights from seed 0,
    replaced by the caller's)."""
    from analytics_zoo_tpu_torch.core.module import Model
    from analytics_zoo_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if arch in ("ssd300", "ssd512"):
        from analytics_zoo_tpu_torch.models import SSDVgg
        res = 300 if arch == "ssd300" else 512
        return Model(SSDVgg(num_classes=classes, resolution=res, device=dev),
                     device=dev)
    if arch == "ds2":
        from analytics_zoo_tpu_torch.models import DeepSpeech2
        return Model(DeepSpeech2(hidden=hidden, device=dev), device=dev)
    raise SystemExit(f"unknown --arch {arch!r}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Export int8 serving artifact")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--checkpoint",
                     help="parallel.checkpoint snapshot (directory)")
    src.add_argument("--model-file", help="Model.save() file")
    p.add_argument("--arch", required=True,
                   choices=("ssd300", "ssd512", "ds2"))
    p.add_argument("--classes", type=int, default=21)
    p.add_argument("--resolution", type=int, default=300)
    p.add_argument("--hidden", type=int, default=1024)
    p.add_argument("--out", required=True)
    p.add_argument("--min-size", type=int, default=4096,
                   help="smallest tensor (elements) worth quantizing")
    p.add_argument("--verify", action="store_true",
                   help="forward the quantized artifact and compare "
                        "against the fp32 model")
    add_device_argument(p)
    return p


def load_source(model, args) -> None:
    """Copy the weights of ``--model-file`` or ``--checkpoint`` in."""
    if args.model_file:
        model.load(args.model_file)
        return
    from analytics_zoo_tpu_torch.parallel import checkpoint as ckpt

    state = ckpt.load(args.checkpoint, device=model.device)
    if isinstance(state, dict) and "model" in state:
        # an Optimizer snapshot: parameters and buffers (BatchNorm's
        # running statistics among them) under "model"
        state = state["model"]
    model.load_weights(state)


def _outputs(out) -> Tuple[torch.Tensor, ...]:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def verify(model, path: str, arch: str, resolution: int
           ) -> Dict[str, Dict]:
    """The artifact's forward against the fp32 model's on the reference's
    zero input and on a seeded uniform one (on zeros only the biases
    reach the outputs): by input, the max-abs error over every output and
    that over the largest |ref| (``rel``)."""
    from analytics_zoo_tpu_torch.utils.quantize import (
        load_quantized_npz, make_quantized_forward)

    dev = model.device
    back = {k: v.to(dev) for k, v in load_quantized_npz(path).items()}
    fwd = make_quantized_forward(model.module)
    shape = ((1, resolution, resolution, 3) if arch.startswith("ssd")
             else (1, 100, model.module.n_mels))
    seeded = np.random.RandomState(0).uniform(-1, 1, shape)
    out = {}
    for name, x in (("zeros", torch.zeros(shape, device=dev)),
                    ("seeded", torch.as_tensor(seeded, dtype=torch.float32,
                                               device=dev))):
        got = _outputs(fwd(back, x))
        with torch.inference_mode():
            want = _outputs(model.module(x))
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        scale = max(float(w.abs().max()) for w in want)
        out[name] = {"max_abs_err": err, "rel": err / (scale + 1e-9),
                     "shapes": [list(g.shape) for g in got]}
    return out


def run(args) -> Dict:
    from analytics_zoo_tpu_torch.utils.quantize import (quantize_params,
                                                        quantized_nbytes,
                                                        save_quantized_npz)

    model = build_model(args.arch, args.classes, args.hidden, args.device)
    load_source(model, args)
    model.eval()
    qparams = quantize_params(model.module, min_size=args.min_size)
    qb, fb = quantized_nbytes(qparams)
    out_path = save_quantized_npz(args.out, qparams)
    disk = os.path.getsize(out_path)
    print(f"wrote {out_path}: {qb / 1e6:.1f} MB on the card "
          f"(fp32 {fb / 1e6:.1f} MB, {fb / max(qb, 1):.2f}x), "
          f"{disk / 1e6:.1f} MB on disk (compressed)")
    report = {"path": out_path, "quantized_bytes": qb, "fp32_bytes": fb,
              "disk_bytes": disk}
    if args.verify:
        check = verify(model, out_path, args.arch, args.resolution)
        for name, c in check.items():
            print(f"verify ({name} input): max abs err "
                  f"{c['max_abs_err']:.5f} (rel {c['rel']:.4f}) on shapes "
                  f"{c['shapes']}")
            if not c["rel"] < VERIFY_REL_MAX:
                raise AssertionError(f"quantized output diverged ({name} "
                                     f"input)")
        report["verify"] = check
    return report


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())

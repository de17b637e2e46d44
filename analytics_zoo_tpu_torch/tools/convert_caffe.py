"""Convert Caffe artifacts to the port's formats (counterpart of
``tools/convert_caffe.py``): a ``.caffemodel`` (and optionally a deploy
``.prototxt``) becomes either

- a name-keyed ``.npz`` weight archive for
  ``utils.convert.load_weights_by_name`` / the SSD pipelines (the
  reference's archive, key for key and array for array), or
- with ``--build``, a ``torch.save`` state dict of the ``CaffeGraph``
  built from the prototxt with the caffemodel's weights loaded (the
  reference writes its flax variables as msgpack; load this one with
  ``build_caffe_graph(...).load_state_dict(torch.load(path))``).

Examples::

    python -m analytics_zoo_tpu_torch.tools.convert_caffe model.caffemodel \\
        -o weights.npz
    python -m analytics_zoo_tpu_torch.tools.convert_caffe model.caffemodel \\
        --ssd 300 -o ssd_vgg.npz
    python -m analytics_zoo_tpu_torch.tools.convert_caffe model.caffemodel \\
        --prototxt deploy.prototxt --build --input-shape 1,300,300,3 \\
        -o model.pt
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

from analytics_zoo_tpu_torch.examples.common import add_device_argument


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("caffemodel", help=".caffemodel binary")
    ap.add_argument("-o", "--output", required=True,
                    help="output path (.npz, or a torch state dict with "
                         "--build)")
    ap.add_argument("--prototxt", help="deploy prototxt (for --build)")
    ap.add_argument("--ssd", type=int, choices=(300, 512), default=None,
                    help="apply the SSD-VGG head rename for this resolution")
    ap.add_argument("--build", action="store_true",
                    help="build the graph of --prototxt, load the weights "
                         "into it, and save its state dict")
    ap.add_argument("--input-shape", default="1,300,300,3",
                    help="NHWC example input for --build")
    add_device_argument(ap)
    return ap


def run(args) -> Dict:
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.utils.caffe import (
        build_caffe_graph, caffe_weight_dict, load_caffe_weights,
        parse_prototxt, read_caffemodel, ssd_vgg_rename)

    net = read_caffemodel(args.caffemodel)
    weights = caffe_weight_dict(net)
    print(f"read {args.caffemodel}: net={net.name!r}, "
          f"{len(net.layers)} layers, {len(weights)} weight arrays")

    if args.build:
        if not args.prototxt:
            raise SystemExit("--build requires --prototxt")
        shape = tuple(int(d) for d in args.input_shape.split(","))
        graph = build_caffe_graph(parse_prototxt(args.prototxt),
                                  input_shape=shape, device=args.device)
        state, report = load_caffe_weights(graph, args.caffemodel)
        graph.load_state_dict(state)
        print(f"loaded {len(report['loaded'])} params, "
              f"missing {len(report['missing'])}, "
              f"unused {len(report['unused'])}")
        torch.save(graph.state_dict(), args.output)
        print(f"wrote {args.output}")
        return {"graph": graph, "report": report}

    if args.ssd:
        rename = ssd_vgg_rename(args.ssd)
        weights = {rename(k): v for k, v in weights.items()}
    np.savez(args.output, **{k: np.asarray(v) for k, v in weights.items()})
    print(f"wrote {args.output} ({len(weights)} arrays)")
    return {"weights": weights}


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())

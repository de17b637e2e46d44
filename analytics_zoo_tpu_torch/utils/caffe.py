"""Caffe weight import: ``.caffemodel`` / ``.prototxt`` parsing and the
by-name weight copy into a model's ``state_dict`` (the port's counterpart
of the weight-import half of ``utils/caffe.py``).

``read_caffemodel`` → ``caffe_weight_dict`` (name-keyed numpy, Caffe
layouts) → ``utils.convert.load_weights_by_name``, the reference's
``CaffeLoader.load`` (copy pretrained weights by layer name into an
existing model).  Caffe's OIHW convolutions and ``(out, in)`` dense
weights are torch's layouts already; the one fixup is Faster-RCNN's fc6,
whose rows read Caffe's CHW flatten of the pooled map while the port
flattens it HWC (``models/faster_rcnn.py``).

Parsing uses the wire-format codec in ``utils.protowire``: no protobuf
bindings.  :func:`build_caffe_graph` (the reference's ``loadCaffe``)
builds a runnable module from a deploy prototxt through a registry of
converters, one a Caffe layer type; its parameters are named after the
Caffe layers, so ``load_caffe_weights`` restores a caffemodel into it.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.core.layers import (SeededGenerators,
                                                lecun_normal_)
from analytics_zoo_tpu_torch.utils import protowire as pw

# ---------------------------------------------------------------------------
# caffemodel (binary) parsing
# ---------------------------------------------------------------------------

# V1LayerParameter.LayerType enum → readable type string (upstream caffe.proto
# enum values; only informational — weight copy is keyed by layer *name*).
_V1_LAYER_TYPES = {
    0: "None", 1: "Accuracy", 2: "BNLL", 3: "Concat", 4: "Convolution",
    5: "Data", 6: "Dropout", 7: "EuclideanLoss", 8: "Flatten", 9: "HDF5Data",
    10: "HDF5Output", 11: "Im2col", 12: "ImageData", 13: "InfogainLoss",
    14: "InnerProduct", 15: "LRN", 16: "MultinomialLogisticLoss",
    17: "Pooling", 18: "ReLU", 19: "Sigmoid", 20: "Softmax",
    21: "SoftmaxWithLoss", 22: "Split", 23: "TanH", 24: "WindowData",
    25: "Eltwise", 26: "Power", 27: "SigmoidCrossEntropyLoss",
    28: "HingeLoss", 29: "MemoryData", 30: "ArgMax", 31: "Threshold",
    32: "DummyData", 33: "Slice", 34: "MVN", 35: "AbsVal", 36: "Silence",
    37: "ContrastiveLoss", 38: "Exp", 39: "Deconvolution",
}


@dataclasses.dataclass
class CaffeLayer:
    """One parsed layer: identity + learned blobs (numpy, caffe layouts)."""

    name: str
    type: str
    bottoms: List[str] = dataclasses.field(default_factory=list)
    tops: List[str] = dataclasses.field(default_factory=list)
    blobs: List[np.ndarray] = dataclasses.field(default_factory=list)
    phase: Optional[int] = None  # 0 = TRAIN, 1 = TEST


@dataclasses.dataclass
class CaffeNet:
    name: str = ""
    layers: List[CaffeLayer] = dataclasses.field(default_factory=list)

    def layer(self, name: str) -> CaffeLayer:
        for l in self.layers:
            if l.name == name:
                return l
        raise KeyError(name)


def _parse_blob(buf) -> np.ndarray:
    """BlobProto → ndarray (shape from BlobShape, else legacy NCHW dims)."""
    shape: List[int] = []
    legacy = [0, 0, 0, 0]  # num, channels, height, width
    data: Optional[np.ndarray] = None
    loose: List[float] = []
    for field, wire, value in pw.iter_fields(buf):
        if field == 7 and wire == pw.WIRETYPE_LEN:  # shape
            for f2, w2, v2 in pw.iter_fields(value):
                if f2 == 1:
                    if w2 == pw.WIRETYPE_LEN:
                        shape.extend(pw.packed_varints(v2))
                    else:
                        shape.append(int(v2))
        elif field == 5:  # data (repeated float)
            if wire == pw.WIRETYPE_LEN:
                data = pw.packed_floats(value)
            else:
                loose.append(pw.fixed32_float(value))
        elif field == 8 and wire == pw.WIRETYPE_LEN:  # double_data
            data = pw.packed_doubles(value).astype(np.float32)
        elif field in (1, 2, 3, 4) and wire == pw.WIRETYPE_VARINT:
            legacy[field - 1] = int(value)
    if data is None:
        data = np.asarray(loose, dtype=np.float32)
    if not shape:
        # legacy pre-BlobShape header: always 4-D num/channels/height/width
        # (vectors arrive as (1,1,1,N), FC weights as (1,1,out,in) —
        # canonicalized per layer type in caffe_weight_dict)
        shape = [d for d in legacy if d] or [data.size]
    return np.asarray(data, dtype=np.float32).reshape(shape)


def _parse_layer(buf, v1: bool) -> CaffeLayer:
    layer = CaffeLayer(name="", type="")
    name_f, type_f, bottom_f, top_f, blobs_f = (
        (4, 5, 2, 3, 6) if v1 else (1, 2, 3, 4, 7))
    for field, wire, value in pw.iter_fields(buf):
        if field == name_f:
            layer.name = pw.as_string(value)
        elif field == type_f:
            if v1:
                layer.type = _V1_LAYER_TYPES.get(int(value), f"V1_{value}")
            else:
                layer.type = pw.as_string(value)
        elif field == bottom_f:
            layer.bottoms.append(pw.as_string(value))
        elif field == top_f:
            layer.tops.append(pw.as_string(value))
        elif field == blobs_f:
            layer.blobs.append(_parse_blob(value))
        elif not v1 and field == 10 and wire == pw.WIRETYPE_VARINT:
            layer.phase = int(value)
    return layer


def parse_net_parameter(buf: bytes) -> CaffeNet:
    """NetParameter bytes → CaffeNet (handles V1 ``layers`` and V2 ``layer``)."""
    net = CaffeNet()
    for field, wire, value in pw.iter_fields(buf):
        if field == 1 and wire == pw.WIRETYPE_LEN:
            net.name = pw.as_string(value)
        elif field == 2 and wire == pw.WIRETYPE_LEN:  # V1 layers
            net.layers.append(_parse_layer(value, v1=True))
        elif field == 100 and wire == pw.WIRETYPE_LEN:  # V2 layer
            net.layers.append(_parse_layer(value, v1=False))
    return net


def read_caffemodel(path: str) -> CaffeNet:
    with open(path, "rb") as f:
        return parse_net_parameter(f.read())


def save_caffemodel(path: str, net: CaffeNet, v1: bool = False) -> None:
    """Write a NetParameter binary (tests + export back to Caffe format)."""
    enc = pw.Encoder()
    if net.name:
        enc.string(1, net.name)
    for layer in net.layers:
        sub = pw.Encoder()
        if v1:
            for b in layer.bottoms:
                sub.string(2, b)
            for t in layer.tops:
                sub.string(3, t)
            sub.string(4, layer.name)
            type_ids = {v: k for k, v in _V1_LAYER_TYPES.items()}
            if layer.type not in type_ids:
                raise ValueError(
                    f"layer type {layer.type!r} has no V1 enum value "
                    f"(SSD-fork layers require v1=False)")
            sub.varint(5, type_ids[layer.type])
            blob_field = 6
        else:
            sub.string(1, layer.name)
            sub.string(2, layer.type)
            for b in layer.bottoms:
                sub.string(3, b)
            for t in layer.tops:
                sub.string(4, t)
            blob_field = 7
        for blob in layer.blobs:
            benc = pw.Encoder()
            shape_enc = pw.Encoder().packed_varints(1, blob.shape)
            benc.message(7, shape_enc)
            benc.packed_floats(5, np.asarray(blob, np.float32).ravel())
            sub.message(blob_field, benc)
        enc.message(2 if v1 else 100, sub)
    with open(path, "wb") as f:
        f.write(enc.tobytes())


# ---------------------------------------------------------------------------
# prototxt (protobuf text format) parsing
# ---------------------------------------------------------------------------


def _tokenize_prototxt(text: str) -> List[str]:
    tokens: List[str] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "#":
            while i < n and text[i] != "\n":
                i += 1
        elif c in " \t\r\n,;":
            i += 1
        elif c in "{}:":
            tokens.append(c)
            i += 1
        elif c == '"' or c == "'":
            q = c
            i += 1
            start = i
            out = []
            while i < n and text[i] != q:
                if text[i] == "\\" and i + 1 < n:
                    out.append(text[start:i])
                    i += 1
                    out.append(text[i])
                    start = i + 1
                i += 1
            out.append(text[start:i])
            tokens.append('"' + "".join(out))
            i += 1
        else:
            start = i
            while i < n and text[i] not in " \t\r\n,;{}:#":
                i += 1
            tokens.append(text[start:i])
    return tokens


def _coerce(tok: str) -> Any:
    if tok.startswith('"'):
        return tok[1:]
    low = tok.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok  # enum identifier (MAX, TEST, ...)


def _parse_message(tokens: List[str], pos: int) -> Tuple[Dict[str, Any], int]:
    msg: Dict[str, Any] = {}

    def put(key: str, value: Any) -> None:
        if key in msg:
            if not isinstance(msg[key], list):
                msg[key] = [msg[key]]
            msg[key].append(value)
        else:
            msg[key] = value

    n = len(tokens)
    while pos < n:
        tok = tokens[pos]
        if tok == "}":
            return msg, pos + 1
        key = tok
        pos += 1
        if pos < n and tokens[pos] == ":":
            pos += 1
        if pos < n and tokens[pos] == "{":
            sub, pos = _parse_message(tokens, pos + 1)
            put(key, sub)
        else:
            put(key, _coerce(tokens[pos]))
            pos += 1
    return msg, pos


def parse_prototxt(text_or_path: str) -> Dict[str, Any]:
    """Protobuf text format → nested dict; repeated keys become lists.

    Equivalent of the reference's prototxt read
    (``CaffeLoader.scala`` ``loadBinary``/text path).
    """
    text = text_or_path
    if "\n" not in text_or_path and (
            text_or_path.endswith(".prototxt") or text_or_path.endswith(".txt")):
        with open(text_or_path) as f:
            text = f.read()
    msg, _ = _parse_message(_tokenize_prototxt(text), 0)
    return msg


def _aslist(v: Any) -> List[Any]:
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


def net_layers(netdef: Mapping[str, Any]) -> List[Dict[str, Any]]:
    """Layer dicts of a parsed prototxt (V2 ``layer`` or V1 ``layers``)."""
    return _aslist(netdef.get("layer") or netdef.get("layers"))


# ---------------------------------------------------------------------------
# weight extraction ("load" mode)
# ---------------------------------------------------------------------------


def caffe_weight_dict(net: CaffeNet) -> Dict[str, np.ndarray]:
    """Name-keyed weight dict for ``utils.convert.load_weights_by_name``.

    Per-type blob conventions (reference ``LayerConverter.scala`` copies the
    same positions): Convolution/InnerProduct/Deconvolution → weight[, bias];
    BatchNorm → moving mean/var rescaled by the scale factor blob;
    Scale → scale[, bias]; Normalize (SSD fork) → per-channel scale vector.
    """
    out: Dict[str, np.ndarray] = {}
    for layer in net.layers:
        if not layer.blobs:
            continue
        name, t = layer.name, layer.type
        blobs = layer.blobs
        if t in ("Convolution", "Deconvolution"):
            out[f"{name}/weight"] = blobs[0]
            if len(blobs) > 1:
                out[f"{name}/bias"] = blobs[1].ravel()
        elif t == "InnerProduct":
            w = blobs[0]
            # legacy V1 blobs carry FC weights as (1,1,out,in)
            out[f"{name}/weight"] = w.reshape(w.shape[-2], w.shape[-1])
            if len(blobs) > 1:
                out[f"{name}/bias"] = blobs[1].ravel()
        elif t == "BatchNorm":
            factor = float(blobs[2].ravel()[0]) if len(blobs) > 2 else 1.0
            inv = 0.0 if factor == 0 else 1.0 / factor
            out[f"{name}/moving_mean"] = blobs[0].ravel() * inv
            out[f"{name}/moving_var"] = blobs[1].ravel() * inv
        elif t == "Scale":
            out[f"{name}/scale"] = blobs[0].ravel()
            if len(blobs) > 1:
                out[f"{name}/bias"] = blobs[1].ravel()
        elif t == "Normalize":
            out[f"{name}/scale"] = blobs[0].ravel()
        else:
            for i, b in enumerate(blobs):
                out[f"{name}/blob_{i}"] = b
    return out


def ssd_vgg_rename(resolution: int = 300) -> Callable[[str], str]:
    """Source-key rename: Caffe-SSD layer names → the port's SSDVgg.

    The Caffe SSD nets name their heads ``{source}_mbox_loc/conf`` over
    sources (conv4_3_norm, fc7, conv6_2, …); ``models.ssd.SSDVgg`` names
    them ``loc_{i}``/``conf_{i}`` and puts the conv4_3 L2-scale under
    ``conv4_3_norm/cmul/weight`` (reference name tables:
    ``ssd/model/SSDVgg.scala:58-70``, converter registration
    ``CaffeLoader.scala:588``).
    """
    sources = ["conv4_3_norm", "fc7", "conv6_2", "conv7_2", "conv8_2",
               "conv9_2"]
    if resolution == 512:
        sources.append("conv10_2")
    mapping: Dict[str, str] = {"conv4_3_norm/scale": "conv4_3_norm/cmul/weight"}
    for i, s in enumerate(sources):
        for kind in ("weight", "bias"):
            mapping[f"{s}_mbox_loc/{kind}"] = f"loc_{i}/{kind}"
            mapping[f"{s}_mbox_conf/{kind}"] = f"conf_{i}/{kind}"

    def rename(key: str) -> str:
        return mapping.get(key, key)

    return rename


def load_caffe_weights(state: Any, caffemodel_path: str,
                       rename: Optional[Callable[[str], str]] = None,
                       strict: bool = False
                       ) -> Tuple[Dict[str, Any], Dict[str, list]]:
    """``CaffeLoader.load``: the weights of a caffemodel into ``state`` (a
    module or its ``state_dict``) by layer name.  Returns ``(state_dict,
    report)`` as :func:`~analytics_zoo_tpu_torch.utils.convert.
    load_weights_by_name`; load it with ``model.load_state_dict``."""
    from analytics_zoo_tpu_torch.utils.convert import load_weights_by_name

    net = read_caffemodel(caffemodel_path)
    return load_weights_by_name(state, caffe_weight_dict(net), rename=rename,
                                strict=strict)


def load_ssd_vgg_caffe(state: Any, caffemodel_path: str,
                       resolution: int = 300, strict: bool = False
                       ) -> Tuple[Dict[str, Any], Dict[str, list]]:
    """Pretrained Caffe-SSD weights → a ``models.ssd.SSDVgg`` state."""
    return load_caffe_weights(state, caffemodel_path,
                              rename=ssd_vgg_rename(resolution),
                              strict=strict)


def chw_dense_to_hwc(weight: np.ndarray, h: int, w: int, c: int) -> np.ndarray:
    """Permute a Caffe InnerProduct weight's input axis from CHW flatten
    order to the port's HWC flatten order.

    Caffe flattens a (C, H, W) blob as ``c·H·W + y·W + x``; the port
    flattens ``(H, W, C)`` as ``y·W·C + x·C + c``.  A dense weight
    imported by name alone would pair every input element with the wrong
    column.  ``weight`` is (out, in) or (in, out); the permuted array
    keeps the same shape.
    """
    if weight.shape[0] == h * w * c:            # (in, out)
        return (weight.reshape(c, h, w, -1).transpose(1, 2, 0, 3)
                .reshape(h * w * c, -1))
    if weight.shape[-1] == h * w * c:           # (out, in): Caffe, torch
        return (weight.reshape(-1, c, h, w).transpose(0, 2, 3, 1)
                .reshape(weight.shape[0], h * w * c))
    raise ValueError(f"no axis of {weight.shape} matches {h}x{w}x{c}")


def load_frcnn_vgg_caffe(state: Any, caffemodel_path: str,
                         pooled: int = 7, pool_channels: int = 512,
                         strict: bool = False
                         ) -> Tuple[Dict[str, Any], Dict[str, list]]:
    """A py-faster-rcnn VGG16 caffemodel → a ``models.faster_rcnn`` state
    (``FasterRcnnVgg`` or ``FasterRcnnDetector``): the by-name copy plus
    the one fixup a name cannot express — fc6 reads the ROI-pooled
    (7, 7, 512) map, flattened CHW by Caffe and HWC by the port, so its
    input axis is permuted with :func:`chw_dense_to_hwc`."""
    from analytics_zoo_tpu_torch.models.faster_rcnn import frcnn_vgg_rename
    from analytics_zoo_tpu_torch.utils.convert import load_weights_by_name

    src = caffe_weight_dict(read_caffemodel(caffemodel_path))
    key = "fc6/weight"
    if key in src:
        src[key] = chw_dense_to_hwc(src[key], pooled, pooled, pool_channels)
    return load_weights_by_name(state, src, rename=frcnn_vgg_rename(),
                                strict=strict)


# ---------------------------------------------------------------------------
# graph building ("loadCaffe" mode)
# ---------------------------------------------------------------------------
#
# Layouts.  The reference holds feature maps NHWC and tags each tensor with
# its physical layout; here a feature map is held NCHW, so a Caffe axis
# indexes it directly:
#   "map"    a 4-D feature map (the reference's "nhwc"), held NCHW;
#   "nhwc_p" a map permuted to NHWC by a Permute (0, 2, 3, 1), held NHWC as
#            in the reference;
#   "nchw"   a 4-D tensor in Caffe's own axis order (Reshape, Permute);
#   "flat", "priors" (a ``_Priors``), "rois" (a ``_Rois``).
# A "map" the graph returns goes out NHWC, as the reference's does.


@dataclasses.dataclass(frozen=True)
class _Spec:
    """Static per-layer build spec."""

    name: str
    type: str
    bottoms: Tuple[str, ...]
    tops: Tuple[str, ...]
    params: Mapping[str, Any]


def _layer_specs(netdef: Mapping[str, Any]) -> List[_Spec]:
    specs = []
    for ld in net_layers(netdef):
        phase = None
        for rule in _aslist(ld.get("include")):
            if isinstance(rule, Mapping) and "phase" in rule:
                phase = rule["phase"]
        if phase == "TRAIN":
            continue  # deploy graphs keep TEST + phase-less layers
        specs.append(_Spec(
            name=str(ld.get("name", "")),
            type=str(ld.get("type", "")),
            bottoms=tuple(_aslist(ld.get("bottom"))),
            tops=tuple(_aslist(ld.get("top"))),
            params=ld,
        ))
    return specs


def _map_axis(axis: int, layout: str, ndim: int) -> int:
    """Caffe (NCHW-semantic) axis → physical axis of the port's tensor:
    the same axis, since maps are held NCHW (only negative axes are
    resolved)."""
    return axis + ndim if axis < 0 else axis


class _Priors(tuple):
    """Marker: (priors (P,4), variances (P,4)) flowing through the graph."""


class _Rois(tuple):
    """Marker: (rois (B·R, 5) [batch index, x1, y1, x2, y2], validity
    (B·R,)), image-major."""


_SKIP_TYPES = ("Input", "Data", "DummyData", "Silence", "Accuracy")


def _declared_input_shape(netdef: Mapping[str, Any]) -> Optional[Tuple]:
    """The data input's NCHW shape as the prototxt declares it
    (``input_shape { dim … }`` or ``input_dim``), else None."""
    shapes = _aslist(netdef.get("input_shape"))
    if shapes and isinstance(shapes[0], Mapping):
        dims = [int(d) for d in _aslist(shapes[0].get("dim"))]
    else:
        dims = [int(d) for d in _aslist(netdef.get("input_dim"))][:4]
    return tuple(dims) if len(dims) == 4 else None


class CaffeGraph(nn.Module):
    """A Caffe deploy net as a module: ``forward(x, train=False)`` takes
    NHWC input (a 2-D input is taken as it is) and returns the graph's
    output (a tuple when several tops are never consumed), each equal to
    the reference graph's: a feature-map output comes back NHWC.

    Layers with weights are created, on the input's device, the first
    time the graph runs (shapes follow from the input), drawn from the
    graph's generator (seed 0) as flax initialises them (LeCun-normal
    kernels, zero biases); :func:`build_caffe_graph` runs the graph once
    on zeros of the declared input shape, so a built graph has its
    parameters.  Each is a submodule named after its Caffe layer (Caffe
    names may hold ``/``).  ``train=True`` applies Dropout layers with
    masks from the graph's generator."""

    def __init__(self, specs: List[_Spec], entry: str,
                 output_names: List[str], has_im_info: bool,
                 registry: Mapping[str, Callable]):
        super().__init__()
        self.specs = specs
        self.entry = entry
        self.output_names = output_names
        self.has_im_info = has_im_info
        self.registry = dict(registry)
        # initialisation on the CPU, dropout masks on the input's device
        self.generator = SeededGenerators(0)
        self._priors: Dict[Tuple, Any] = {}

    def layer(self, name: str, make: Callable[[], nn.Module],
              device) -> nn.Module:
        """The submodule of Caffe layer ``name``, made by ``make()`` (on the
        CPU, initialised from the graph's generator) and moved to
        ``device`` the first time it is asked for."""
        if name not in self._modules:
            if hasattr(self, name):
                raise ValueError(f"Caffe layer name {name!r} clashes with "
                                 "an attribute of the graph module")
            # parameters made inside an inference-mode forward must
            # still be trainable
            with torch.inference_mode(False), torch.no_grad():
                m = make()
                gen = self.generator("cpu")
                for sub in m.modules():
                    if isinstance(sub, (nn.Conv2d, nn.Linear)):
                        lecun_normal_(sub.weight, sub.weight[0].numel(),
                                      generator=gen)
                        if sub.bias is not None:
                            sub.bias.zero_()
            self.add_module(name, m.to(device))
        return self._modules[name]

    def priors(self, key: Tuple, make: Callable[[], Any]):
        """A PriorBox layer's constant, made once a shape and device."""
        if key not in self._priors:
            self._priors[key] = make()
        return self._priors[key]

    def forward(self, x: torch.Tensor, train: bool = False):
        from analytics_zoo_tpu_torch.core import layers as L
        from analytics_zoo_tpu_torch.ops.detection_output import (
            DetectionOutputParam, detection_output)
        from analytics_zoo_tpu_torch.ops.priorbox import (PriorBoxParam,
                                                          prior_box)

        x = torch.as_tensor(x)
        input_shape = tuple(x.shape)
        if x.ndim == 4:
            # a view: the convolutions see the NHWC memory as a
            # channels-last NCHW map, as the port's models' do
            x = x.permute(0, 3, 1, 2)
        tensors: Dict[str, Any] = {self.entry: x}
        layouts: Dict[str, str] = {self.entry: "map" if x.ndim == 4
                                   else "flat"}
        # Faster-RCNN deploy graphs declare a second input im_info
        # (h, w, scale); for a fixed-shape graph it is a constant of the
        # data input's shape, one row an image
        if self.has_im_info and x.ndim == 4:
            tensors["im_info"] = torch.tensor(
                [[input_shape[1], input_shape[2], 1.0]],
                dtype=torch.float32, device=x.device).expand(
                    input_shape[0], 3)
            layouts["im_info"] = "flat"
        ctx = dict(L=L, PriorBoxParam=PriorBoxParam, prior_box=prior_box,
                   DetectionOutputParam=DetectionOutputParam,
                   detection_output=detection_output, map_axis=_map_axis,
                   Priors=_Priors, Rois=_Rois, train=train,
                   input_shape=input_shape, device=x.device)
        for s in self.specs:
            if s.type in _SKIP_TYPES:
                continue
            fn = self.registry.get(s.type)
            if fn is None:
                raise NotImplementedError(
                    f"no converter for Caffe layer type {s.type!r} "
                    f"(layer {s.name!r}); pass custom={{...}}")
            ins = [tensors[b] for b in s.bottoms]
            in_layouts = [layouts.get(b, "flat") for b in s.bottoms]
            outs, out_layout = fn(self, s, ins, in_layouts, ctx)
            # only plain lists signal multi-output (tuples, the markers
            # included, are single values)
            if not isinstance(outs, list):
                outs = [outs]
            tops = s.tops or (s.name,)
            for t, o in zip(tops, list(outs) * max(1, len(tops))):
                tensors[t] = o
                layouts[t] = out_layout

        finals = [_to_reference_layout(tensors[t], layouts[t])
                  for t in self.output_names]
        return finals[0] if len(finals) == 1 else tuple(finals)


def _to_reference_layout(x, layout: str):
    """A graph output as the reference holds it: a map NHWC."""
    if layout == "map" and isinstance(x, torch.Tensor) and x.ndim == 4:
        return x.permute(0, 2, 3, 1)
    return x


def build_caffe_graph(netdef: Mapping[str, Any],
                      custom: Optional[Mapping[str, Callable]] = None, *,
                      input_shape: Optional[Tuple[int, ...]] = None,
                      device=None) -> CaffeGraph:
    """Parsed deploy prototxt → :class:`CaffeGraph` (the reference's
    ``CaffeLoader.createCaffeModel``) on ``device`` (the GPU unless
    ``device="cpu"``).

    The graph's parameters are created by one run on zeros of
    ``input_shape`` (NHWC), or of the prototxt's declared input (its
    NCHW ``input_shape``/``input_dim``, taken at batch 1) when that is
    not given; with neither, they appear on the graph's first call.
    Then ``load_caffe_weights(graph, model.caffemodel)`` restores
    pretrained weights by layer name.

    ``custom`` extends or overrides the converter registry (the
    reference's per-loader converters, ``CaffeLoader.scala:588,599``):
    ``fn(graph, spec, inputs, in_layouts, ctx) → (output(s), layout)``."""
    from analytics_zoo_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    specs = _layer_specs(netdef)
    # ordered; the data input is the first declared non-im_info input
    input_names = [str(n) for n in _aslist(netdef.get("input"))]
    input_names = ([n for n in input_names if n != "im_info"]
                   + [n for n in input_names if n == "im_info"])
    registry: Dict[str, Callable] = dict(_CONVERTERS)
    if custom:
        registry.update(custom)

    # im_info may be declared as a legacy top-level `input:` or as a
    # modern `layer { type: "Input" }` top: both get the constant
    has_im_info = "im_info" in input_names or any(
        s.type == "Input" and "im_info" in s.tops for s in specs)

    # A name is an output iff its final production is never consumed
    # downstream; tracking (name, producer) events keeps in-place layers
    # (bottom == top, e.g. ReLU) from hiding their result.
    entry = next(iter(input_names), None)
    if entry is None:
        for s in specs:
            if s.type in _SKIP_TYPES[:3] and s.tops:
                tops = [t for t in s.tops if t != "im_info"]
                if tops:
                    entry = tops[0]
                    break
    entry = entry or "data"
    last_producer: Dict[str, int] = {entry: -1}
    consumed_events = set()
    skipped_tops = set()
    for idx, s in enumerate(specs):
        # skip-type layers neither consume (Accuracy is pruned, so the
        # tensor it eats is still an output) nor materialize their tops
        # (a Data layer's 'label' never exists at run time)
        if s.type not in _SKIP_TYPES:
            for b in s.bottoms:
                if b in last_producer:
                    consumed_events.add((b, last_producer[b]))
        for t in (s.tops or (s.name,)):
            last_producer[t] = idx
            if s.type in _SKIP_TYPES:
                skipped_tops.add(t)
            else:
                skipped_tops.discard(t)
    output_names = [
        name for name, idx in last_producer.items()
        if (name, idx) not in consumed_events and idx >= 0
        and name not in skipped_tops
    ] or [entry]

    graph = CaffeGraph(specs, entry, output_names, has_im_info, registry)
    if input_shape is None:
        declared = _declared_input_shape(netdef)
        if declared is not None:
            _, c, h, w = declared
            input_shape = (1, h, w, c)
    if input_shape is not None:
        with torch.no_grad():
            graph(torch.zeros(tuple(input_shape), device=dev))
    return graph


# -- converter registry -------------------------------------------------------
# Each converter: fn(graph, spec, inputs, in_layouts, ctx)
#                 → (output(s), out_layout)


def _cparam(spec: _Spec, *names, default=None):
    node: Any = spec.params
    for nm in names:
        if not isinstance(node, Mapping) or nm not in node:
            return default
        node = node[nm]
    return node


def _to_map(x, layout: str):
    """A 4-D tensor as an NCHW map (an "nhwc_p" tensor is permuted back;
    "nchw" already is one)."""
    if layout == "nhwc_p" and x.ndim == 4:
        return x.permute(0, 3, 1, 2)
    return x


def _conv(graph, spec, ins, louts, ctx):
    p = spec.params.get("convolution_param", {})
    kh = int(p.get("kernel_h", 0) or _aslist(p.get("kernel_size", 1))[0])
    kw = int(p.get("kernel_w", 0) or _aslist(p.get("kernel_size", 1))[-1])
    sh = int(p.get("stride_h", 0) or _aslist(p.get("stride", 1))[0])
    sw = int(p.get("stride_w", 0) or _aslist(p.get("stride", 1))[-1])
    ph = int(p.get("pad_h", 0) or _aslist(p.get("pad", 0))[0])
    pw_ = int(p.get("pad_w", 0) or _aslist(p.get("pad", 0))[-1])
    dil = int(_aslist(p.get("dilation", 1))[0])
    x = _to_map(ins[0], louts[0])
    conv = graph.layer(spec.name, lambda: nn.Conv2d(
        x.shape[1], int(p["num_output"]), (kh, kw), stride=(sh, sw),
        padding=(ph, pw_), dilation=dil, groups=int(p.get("group", 1)),
        bias=bool(p.get("bias_term", True))), x.device)
    return conv(x), "map"


def _relu(graph, spec, ins, louts, ctx):
    slope = float(_cparam(spec, "relu_param", "negative_slope", default=0.0))
    x = ins[0]
    y = torch.where(x > 0, x, slope * x) if slope else F.relu(x)
    return y, louts[0]


def _pool(graph, spec, ins, louts, ctx):
    L = ctx["L"]
    p = spec.params.get("pooling_param", {})
    x = _to_map(ins[0], louts[0])
    if p.get("global_pooling"):
        if p.get("pool", "MAX") == "MAX":
            return x.amax(dim=(2, 3), keepdim=True), "map"
        return x.mean(dim=(2, 3), keepdim=True), "map"
    kh = int(p.get("kernel_h", 0) or p.get("kernel_size", 2))
    kw = int(p.get("kernel_w", 0) or p.get("kernel_size", 2))
    sh = int(p.get("stride_h", 0) or p.get("stride", 1))
    sw = int(p.get("stride_w", 0) or p.get("stride", 1))
    ph = int(p.get("pad_h", 0) or p.get("pad", 0))
    pw_ = int(p.get("pad_w", 0) or p.get("pad", 0))
    cls = (L.SpatialAveragePooling if p.get("pool") == "AVE"
           else L.SpatialMaxPooling)
    # caffe pooling is ceil-mode by default
    return cls(kernel_size=(kh, kw), stride=(sh, sw), padding=(ph, pw_),
               ceil_mode=True)(x), "map"


def _inner_product(graph, spec, ins, louts, ctx):
    p = spec.params.get("inner_product_param", {})
    x = ins[0]
    if x.ndim > 2:
        # Caffe flattens C, H, W: a map is held NCHW, so the plain flatten
        # lines imported (out, C·H·W) weights up
        x = x.reshape(x.shape[0], -1)
    fc = graph.layer(spec.name, lambda: nn.Linear(
        x.shape[1], int(p["num_output"]),
        bias=bool(p.get("bias_term", True))), x.device)
    return fc(x), "flat"


def _lrn(graph, spec, ins, louts, ctx):
    p = spec.params.get("lrn_param", {})
    size = int(p.get("local_size", 5))
    alpha = float(p.get("alpha", 1.0))
    beta = float(p.get("beta", 0.75))
    k = float(p.get("k", 1.0))
    x = _to_map(ins[0], louts[0])
    half = size // 2
    padded = F.pad(x * x, (0, 0, 0, 0, half, half))
    C = x.shape[1]
    acc = sum(padded[:, i:i + C] for i in range(size))
    return x / (k + alpha / size * acc) ** beta, "map"


def _dropout(graph, spec, ins, louts, ctx):
    if not ctx["train"]:
        return ins[0], louts[0]
    rate = float(_cparam(spec, "dropout_param", "dropout_ratio", default=0.5))
    return ctx["L"].dropout(ins[0], rate,
                            graph.generator(ins[0].device)), louts[0]


def _softmax(graph, spec, ins, louts, ctx):
    axis = int(_cparam(spec, "softmax_param", "axis", default=1))
    x = ins[0]
    return torch.softmax(x, dim=_map_axis(axis, louts[0], x.ndim)), louts[0]


def _concat(graph, spec, ins, louts, ctx):
    if all(isinstance(i, _Priors) for i in ins):
        return _Priors((torch.cat([i[0] for i in ins], dim=0),
                        torch.cat([i[1] for i in ins], dim=0))), "priors"
    axis = int(_cparam(spec, "concat_param", "axis", default=1))
    return torch.cat(list(ins), dim=_map_axis(axis, louts[0],
                                              ins[0].ndim)), louts[0]


def _flatten(graph, spec, ins, louts, ctx):
    # a map is held NCHW, Caffe's flatten order; an "nhwc_p" tensor
    # flattens in its own (NHWC) order, as in the reference
    x = ins[0]
    return x.reshape(x.shape[0], -1), "flat"


def _permute(graph, spec, ins, louts, ctx):
    order = tuple(int(v) for v in _aslist(
        _cparam(spec, "permute_param", "order", default=[0, 1, 2, 3])))
    x = ins[0]
    if x.ndim == 4 and louts[0] == "map" and order == (0, 2, 3, 1):
        # the SSD head pattern: logical NCHW → NHWC
        return x.permute(order), "nhwc_p"
    # a map is held in Caffe's order; any other tensor is permuted as
    # the reference holds it
    return x.permute(order), "nchw"


def _reshape(graph, spec, ins, louts, ctx):
    shape_msg = _cparam(spec, "reshape_param", "shape", default={})
    dims = [int(d) for d in _aslist(shape_msg.get("dim", []))]
    x = ins[0]
    new = [x.shape[i] if d == 0 else d for i, d in enumerate(dims)]
    return x.reshape(new), ("nchw" if len(new) == 4 else "flat")


def _eltwise(graph, spec, ins, louts, ctx):
    op = _cparam(spec, "eltwise_param", "operation", default="SUM")
    xs = [_to_map(x, l) for x, l in zip(ins, louts)]
    if op == "PROD":
        out = xs[0]
        for x in xs[1:]:
            out = out * x
    elif op == "MAX":
        out = xs[0]
        for x in xs[1:]:
            out = torch.maximum(out, x)
    else:
        coeffs = [float(c) for c in _aslist(
            _cparam(spec, "eltwise_param", "coeff", default=[]))]
        out = 0.0
        for i, x in enumerate(xs):
            out = out + (coeffs[i] if i < len(coeffs) else 1.0) * x
    return out, "map" if xs[0].ndim == 4 else louts[0]


def _channel_dim(x, layout: str) -> int:
    """The channel dim: 1 of a map or an "nchw" tensor, else the last."""
    return 1 if layout in ("map", "nchw") and x.ndim == 4 else x.ndim - 1


class _ChannelParams(nn.Module):
    """Per-channel parameters named as ``caffe_weight_dict`` keys them
    (``moving_mean``/``moving_var`` of BatchNorm, ``scale``/``bias`` of
    Scale and Normalize), with their initial values."""

    def __init__(self, **init: Tuple[int, float]):
        super().__init__()
        for name, (c, value) in init.items():
            self.register_parameter(name, nn.Parameter(
                torch.full((c,), float(value))))


def _per_channel(v: torch.Tensor, x, dim: int) -> torch.Tensor:
    shape = [1] * x.ndim
    shape[dim] = -1
    return v.view(shape)


def _batch_norm(graph, spec, ins, louts, ctx):
    x = ins[0]
    dim = _channel_dim(x, louts[0])
    eps = float(_cparam(spec, "batch_norm_param", "eps", default=1e-5))
    c = x.shape[dim]
    p = graph.layer(spec.name, lambda: _ChannelParams(
        moving_mean=(c, 0.0), moving_var=(c, 1.0)), x.device)
    y = ((x - _per_channel(p.moving_mean, x, dim))
         / torch.sqrt(_per_channel(p.moving_var, x, dim) + eps))
    return y, louts[0]


def _scale(graph, spec, ins, louts, ctx):
    x = ins[0]
    dim = _channel_dim(x, louts[0])
    c = x.shape[dim]
    init = {"scale": (c, 1.0)}
    if _cparam(spec, "scale_param", "bias_term", default=False):
        init["bias"] = (c, 0.0)
    p = graph.layer(spec.name, lambda: _ChannelParams(**init), x.device)
    y = x * _per_channel(p.scale, x, dim)
    if "bias" in init:
        y = y + _per_channel(p.bias, x, dim)
    return y, louts[0]


def _normalize(graph, spec, ins, louts, ctx):
    L = ctx["L"]
    x = _to_map(ins[0], louts[0])
    init = float(_cparam(spec, "norm_param", "scale_filler", "value",
                         default=20.0))
    p = graph.layer(spec.name, lambda: _ChannelParams(
        scale=(x.shape[1], init)), x.device)
    # NormalizeScale's arithmetic: the L2 normalization, then the scale
    return L.Normalize(dim=1)(x) * p.scale.view(1, -1, 1, 1), "map"


def _prior_box(graph, spec, ins, louts, ctx):
    p = spec.params.get("prior_box_param", {})
    feat = ins[0]
    img_h, img_w = ctx["input_shape"][1:3]
    fh, fw = ((feat.shape[1], feat.shape[2]) if louts[0] == "nhwc_p"
              else (feat.shape[2], feat.shape[3]))
    param = ctx["PriorBoxParam"](
        min_sizes=[float(v) for v in _aslist(p.get("min_size", []))],
        max_sizes=[float(v) for v in _aslist(p.get("max_size", []))],
        aspect_ratios=[float(v) for v in _aslist(p.get("aspect_ratio", []))],
        flip=bool(p.get("flip", True)),
        clip=bool(p.get("clip", False)),
        variances=tuple(float(v) for v in _aslist(
            p.get("variance", [0.1, 0.1, 0.2, 0.2]))) or (0.1,) * 4,
        step=float(p["step"]) if "step" in p else None,
        offset=float(p.get("offset", 0.5)),
    )

    def make():
        pri, var = ctx["prior_box"]((fh, fw), (img_h, img_w), param)
        return _Priors((torch.as_tensor(pri, device=ctx["device"]),
                        torch.as_tensor(var, device=ctx["device"])))

    return graph.priors((spec.name, fh, fw, img_h, img_w,
                         str(ctx["device"])), make), "priors"


def _detection_output(graph, spec, ins, louts, ctx):
    p = spec.params.get("detection_output_param", {})
    n_classes = int(p.get("num_classes", 21))
    loc, conf, priors = ins[0], ins[1], ins[2]
    if not isinstance(priors, _Priors):
        raise ValueError(f"DetectionOutput {spec.name!r} expects a "
                         "PriorBox(+Concat) bottom")
    loc = loc.reshape(loc.shape[0], -1, 4)
    conf = conf.reshape(conf.shape[0], -1, n_classes)
    nmsp = p.get("nms_param", {})
    param = ctx["DetectionOutputParam"](
        n_classes=n_classes,
        background_id=int(p.get("background_label_id", 0)),
        conf_thresh=float(p.get("confidence_threshold", 0.01)),
        nms_thresh=float(nmsp.get("nms_threshold", 0.45)),
        nms_topk=int(nmsp.get("top_k", 400)),
        keep_topk=int(p.get("keep_top_k", 200)),
        share_location=bool(p.get("share_location", True)),
    )
    # backend "auto": the fused kernel K2 on a card, the plain path here
    return ctx["detection_output"](loc, conf, priors[0], priors[1],
                                   param), "flat"


def _power(graph, spec, ins, louts, ctx):
    p = spec.params.get("power_param", {})
    power = float(p.get("power", 1.0))
    scale = float(p.get("scale", 1.0))
    shift = float(p.get("shift", 0.0))
    y = (shift + scale * ins[0])
    if power != 1.0:
        y = y ** power
    return y, louts[0]


_UNARY = {"Sigmoid": torch.sigmoid, "TanH": torch.tanh, "AbsVal": torch.abs,
          "Exp": torch.exp, "Log": torch.log,
          "BNLL": lambda x: torch.log1p(torch.exp(x))}


def _unary(fn_name: str) -> Callable:
    def conv(graph, spec, ins, louts, ctx):
        return _UNARY[fn_name](ins[0]), louts[0]
    return conv


def _parse_param_str(pp: Mapping[str, Any]) -> Dict[str, Any]:
    """Loose parse of a Python layer's ``param_str`` ("'feat_stride': 16")."""
    out: Dict[str, Any] = {}
    for k, v in re.findall(r"['\"]?(\w+)['\"]?\s*:\s*([\d.]+)",
                           str(pp.get("param_str", ""))):
        out[k] = float(v) if "." in v else int(v)
    return out


def _python_proposal(graph, spec, ins, louts, ctx):
    """Faster-RCNN "Python" proposal layer → the batched proposal op
    (reference ``common/caffe/PythonConverter.scala:28``).  Bottoms: the
    RPN class probabilities (B, 2A, H, W), box deltas (B, 4A, H, W) and
    im_info, one row an image (or one for all).  Each image keeps
    ``ProposalParam()``'s 300; the ROIs carry their image's index."""
    from analytics_zoo_tpu_torch.ops.anchor import (generate_base_anchors,
                                                    shift_anchors)
    from analytics_zoo_tpu_torch.ops.proposal import ProposalParam, proposal

    pp = spec.params.get("python_param", {})
    layer = str(pp.get("layer", ""))
    if ("Proposal" not in layer
            and str(pp.get("module", "")) != "rpn.proposal_layer"):
        raise NotImplementedError(
            f"Python layer {layer!r} has no converter (layer {spec.name!r})")
    if len(ins) < 3:
        raise ValueError(
            f"Python proposal layer {spec.name!r} needs bottoms "
            f"(scores, deltas, im_info), got {len(ins)}")
    opts = _parse_param_str(pp)
    scores = _to_map(ins[0], louts[0])
    deltas = _to_map(ins[1], louts[1])
    B, four_a, feat_h, feat_w = deltas.shape
    n_anchors = four_a // 4
    # the anchor base window is 16 px whatever feat_stride says
    # (py-faster-rcnn's proposal layer keeps generate_anchors()'s default)
    anchors = shift_anchors(
        generate_base_anchors(base_size=int(opts.get("base_size", 16))),
        feat_h, feat_w, feat_stride=int(opts.get("feat_stride", 16)))
    if anchors.shape[0] != feat_h * feat_w * n_anchors:
        raise ValueError(f"anchor count {anchors.shape[0]} != grid "
                         f"{feat_h}x{feat_w}x{n_anchors} (layer "
                         f"{spec.name!r})")
    # (y, x, anchor) order, the order shift_anchors tiles
    fg = scores[:, n_anchors:].permute(0, 2, 3, 1).reshape(B, -1)
    dl = deltas.permute(0, 2, 3, 1).reshape(B, -1, 4)
    info = ins[2].to(torch.float32).expand(B, -1)
    with torch.no_grad():
        rois, mask = proposal(fg, dl, torch.as_tensor(anchors,
                                                      device=fg.device),
                              info[:, 0], info[:, 1], info[:, 2],
                              ProposalParam())
    idx = torch.arange(B, dtype=rois.dtype, device=rois.device)
    idx = idx.view(B, 1, 1).expand(B, rois.shape[1], 1)
    rois5 = torch.cat([idx, rois], dim=-1).reshape(-1, 5)
    return _Rois((rois5, mask.reshape(-1))), "rois"


def _roi_pooling(graph, spec, ins, louts, ctx):
    """Caffe ROIPooling → :func:`ops.roi_pool.roi_pool_batch` (reference
    ``common/caffe/RoiPoolingConverter.scala:28``); the (B·R, C, PH, PW)
    output is a map."""
    from analytics_zoo_tpu_torch.ops.roi_pool import roi_pool_batch

    p = spec.params.get("roi_pooling_param", {})
    feat = _to_map(ins[0], louts[0])
    B = feat.shape[0]
    rois_in = ins[1]
    if isinstance(rois_in, _Rois):
        rois5, mask = rois_in
    elif B == 1:
        rois5, mask = rois_in, None
    else:
        raise ValueError(f"ROIPooling {spec.name!r}: plain ROIs over a "
                         f"batch of {B}; give it a proposal layer's")
    out = roi_pool_batch(
        feat.permute(0, 2, 3, 1).contiguous(),
        rois5[:, 1:5].reshape(B, -1, 4),
        None if mask is None else mask.reshape(B, -1),
        pooled_h=int(p.get("pooled_h", 7)),
        pooled_w=int(p.get("pooled_w", 7)),
        spatial_scale=float(p.get("spatial_scale", 1.0 / 16.0)))
    return out.reshape(-1, *out.shape[2:]).permute(0, 3, 1, 2), "map"


def _split(graph, spec, ins, louts, ctx):
    return [ins[0]] * max(1, len(spec.tops)), louts[0]


def _slice(graph, spec, ins, louts, ctx):
    p = spec.params.get("slice_param", {})
    x = ins[0]
    axis = _map_axis(int(p.get("axis", 1)), louts[0], x.ndim)
    points = [int(v) for v in _aslist(p.get("slice_point", []))]
    pieces = torch.tensor_split(x, points if points
                                else max(1, len(spec.tops)), dim=axis)
    return list(pieces), louts[0]


_CONVERTERS: Dict[str, Callable] = {
    "Convolution": _conv,
    "ReLU": _relu,
    "Pooling": _pool,
    "InnerProduct": _inner_product,
    "LRN": _lrn,
    "Dropout": _dropout,
    "Softmax": _softmax,
    "Concat": _concat,
    "Flatten": _flatten,
    "Permute": _permute,
    "Reshape": _reshape,
    "Eltwise": _eltwise,
    "BatchNorm": _batch_norm,
    "Scale": _scale,
    "Normalize": _normalize,
    "PriorBox": _prior_box,
    "DetectionOutput": _detection_output,
    "Power": _power,
    "Sigmoid": _unary("Sigmoid"),
    "TanH": _unary("TanH"),
    "AbsVal": _unary("AbsVal"),
    "Exp": _unary("Exp"),
    "Log": _unary("Log"),
    "BNLL": _unary("BNLL"),
    "Split": _split,
    "Slice": _slice,
    "Python": _python_proposal,
    "ROIPooling": _roi_pooling,
}

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
bindings.  Building a runnable model from the net definition
(``build_caffe_graph``, the reference's ``loadCaffe``) is not ported yet
(ROADMAP.md Queue 1 item 10).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

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

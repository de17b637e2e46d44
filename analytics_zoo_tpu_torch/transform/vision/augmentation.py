"""Image augmentations: color and geometric ops over BGR numpy mats
(counterpart of ``transform/vision/augmentation.py``), the host chain the
reference runs when it does not augment on the device.

The ops call OpenCV as the reference does, importing ``cv2`` inside the
functions that need it, so importing this module needs no cv2.  The ops
of the card's path never call it: ``BytesToMat`` decodes through the
port's JPEG codec (``data/native.py``), ``HFlip`` mirrors with numpy
(what ``cv2.flip(mat, 1)`` computes), and ``Resize``, ``AspectScale``
and ``AspectScaleCanvas`` on a CUDA pipeline resample INTER_LINEAR with
``resize_bilinear`` in numpy; to the mat's own size ``Resize`` copies,
as ``cv2.resize`` does.  Random decisions come from
``self.rng``, the per-sample stream ``data.transformer.sample_random``,
in the reference's order.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.data.transformer import (RandomTransformer,
                                                      sample_random)
from analytics_zoo_tpu_torch.transform.vision.image import (FeatureTransformer,
                                                            ImageFeature)


# ---------------------------------------------------------------------------
# Decode / convert
# ---------------------------------------------------------------------------


class BytesToMat(FeatureTransformer):
    """Decode jpg bytes → BGR mat, recording original dims; a record that
    does not decode marks the feature invalid.  ``codec`` is the port's
    JPEG codec (``data.native``): ``"nvjpeg"`` on a CUDA device (the
    default), ``"libjpeg"`` with ``device="cpu"``; built or loaded here,
    so a codec that cannot raises at construction."""

    def __init__(self, to_float: bool = True, device=None):
        # to_float=False keeps the decoded uint8 mat — the device-side
        # augmentation path (``DeviceAugPrepare``) stages uint8 canvases
        from analytics_zoo_tpu_torch.data import native
        from analytics_zoo_tpu_torch.utils.device import resolve_device

        super().__init__()
        self.to_float = to_float
        self.codec = native.codec_for(resolve_device(device))
        native.check_codec(self.codec)

    def transform(self, feature: ImageFeature) -> ImageFeature:
        from analytics_zoo_tpu_torch.data import native

        if not feature.is_valid:
            return feature
        try:
            mat = native.decode_jpeg(feature["bytes"], self.codec)
            if mat is None:
                raise ValueError("JPEG decode failed")
            feature.mat = mat.astype(np.float32) if self.to_float else mat
            feature["original_width"] = mat.shape[1]
            feature["original_height"] = mat.shape[0]
        except (KeyError, ValueError):
            # a record without bytes or that does not decode; a codec
            # failure (RuntimeError) propagates
            feature.is_valid = False
            feature.mat = None
        return feature


class MatToFloats(FeatureTransformer):
    """mat → float array (+ optional per-channel mean subtract); invalid
    features yield a zero array of the expected shape so batches stay
    rectangular."""

    def __init__(self, mean: Optional[Sequence[float]] = None,
                 valid_height: int = 300, valid_width: int = 300):
        super().__init__()
        self.mean = None if mean is None else np.asarray(mean, np.float32)
        self.valid_height = valid_height
        self.valid_width = valid_width

    def transform(self, feature: ImageFeature) -> ImageFeature:
        if feature.is_valid and feature.mat is not None:
            floats = feature.mat.astype(np.float32)
            if self.mean is not None:
                floats = floats - self.mean
        else:
            floats = np.zeros((self.valid_height, self.valid_width, 3), np.float32)
        feature["floats"] = floats
        return feature


# ---------------------------------------------------------------------------
# Color ops  (statics usable directly; transformer wrappers randomize)
# ---------------------------------------------------------------------------


class Brightness(FeatureTransformer):
    """Add uniform delta ∈ [low, high]."""

    def __init__(self, delta_low: float = -32.0, delta_high: float = 32.0):
        super().__init__()
        self.low, self.high = delta_low, delta_high
        self.rng = sample_random()

    def transform_mat(self, feature: ImageFeature) -> None:
        delta = self.rng.uniform(self.low, self.high)
        feature.mat = feature.mat.astype(np.float32) + delta


class Contrast(FeatureTransformer):
    """Scale by alpha ∈ [low, high]."""

    def __init__(self, delta_low: float = 0.5, delta_high: float = 1.5):
        super().__init__()
        self.low, self.high = delta_low, delta_high
        self.rng = sample_random()

    def transform_mat(self, feature: ImageFeature) -> None:
        alpha = self.rng.uniform(self.low, self.high)
        feature.mat = feature.mat.astype(np.float32) * alpha


def _to_hsv(mat: np.ndarray, cv2_free: bool = False) -> np.ndarray:
    """BGR → 8-bit HSV (H in [0, 180)) as ``cv2.cvtColor`` makes it;
    ``cv2_free`` computes it in numpy with cv2's own fixed-point tables
    (``RGB2HSV_b``: S and H scaled by 2^12 reciprocals and rounded)."""
    u8 = np.clip(mat, 0, 255).astype(np.uint8)
    if not cv2_free:
        import cv2

        return cv2.cvtColor(u8, cv2.COLOR_BGR2HSV)
    b, g, r = (u8[..., i].astype(np.int64) for i in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    s = (diff * _SDIV[v] + (1 << 11)) >> 12
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + (1 << 11)) >> 12
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


#: cv2's division tables for 8-bit HSV: 255·2^12 / v and 180·2^12 / (6·d)
_SDIV = np.concatenate([[0], np.rint((255 << 12) / np.arange(1, 256))]
                       ).astype(np.int64)
_HDIV = np.concatenate([[0], np.rint((180 << 12) / (6.0 * np.arange(1, 256)))]
                       ).astype(np.int64)
#: the hexcone's sectors: which of (v, v(1-s), v(1-sf), v(1-s(1-f)))
#: each of B, G, R takes
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])


def _from_hsv(hsv: np.ndarray, cv2_free: bool = False) -> np.ndarray:
    """8-bit HSV → float BGR (whole levels) as ``cv2.cvtColor`` makes it;
    ``cv2_free`` computes the hexcone in float32 numpy, within a level of
    cv2's (``HSV_TOL``)."""
    if not cv2_free:
        import cv2

        return cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR).astype(np.float32)
    f = hsv.astype(np.float32)
    h = f[..., 0] * np.float32(6.0 / 180.0)
    s = f[..., 1] * np.float32(1.0 / 255.0)
    v = f[..., 2]
    sector = np.floor(h).astype(np.int64)
    frac = h - sector.astype(np.float32)
    tab = np.stack([v, v * (1 - s), v * (1 - s * frac),
                    v * (1 - s * (1 - frac))], -1)
    bgr = np.take_along_axis(tab, _SECTORS[sector % 6], -1)
    return np.clip(np.rint(bgr), 0, 255).astype(np.float32)


#: the cv2-free HSV route against cv2's, in levels of a BGR channel after
#: a Saturation or Hue op: the 8-bit HSV mat is cv2's exactly; the way
#: back rounds cv2's hexcone in float32 by its own operation order, one
#: level apart at most.  The bound is for one op: a second HSV op after
#: it (``ColorJitter`` with saturation and hue both on) converts inputs
#: already a level apart, and a level of B, G or R can move H by several
#: of its units, so such a chain can end a few levels from cv2's
HSV_TOL = 1


def _hsv_route(device) -> bool:
    """True where Saturation and Hue convert without cv2 (a CUDA
    pipeline, whose card has no cv2); ``None`` keeps cv2, as before."""
    return device is not None and _resize_route(device)


class Saturation(FeatureTransformer):
    """Scale the HSV S channel.  ``device``: a CUDA pipeline converts
    to and from HSV without cv2 (within ``HSV_TOL`` of it), the CPU or
    None through cv2."""

    def __init__(self, delta_low: float = 0.5, delta_high: float = 1.5,
                 device=None):
        super().__init__()
        self.low, self.high = delta_low, delta_high
        self.cv2_free = _hsv_route(device)
        self.rng = sample_random()

    def transform_mat(self, feature: ImageFeature) -> None:
        alpha = self.rng.uniform(self.low, self.high)
        if abs(alpha - 1.0) < 1e-3:
            return
        hsv = _to_hsv(feature.mat, self.cv2_free).astype(np.float32)
        hsv[..., 1] = np.clip(hsv[..., 1] * alpha, 0, 255)
        feature.mat = _from_hsv(hsv.astype(np.uint8), self.cv2_free)


class Hue(FeatureTransformer):
    """Shift the HSV H channel by delta ∈ [low, high] (OpenCV's H units).
    ``device`` picks the conversion as ``Saturation``'s."""

    def __init__(self, delta_low: float = -18.0, delta_high: float = 18.0,
                 device=None):
        super().__init__()
        self.low, self.high = delta_low, delta_high
        self.cv2_free = _hsv_route(device)
        self.rng = sample_random()

    def transform_mat(self, feature: ImageFeature) -> None:
        delta = self.rng.uniform(self.low, self.high)
        hsv = _to_hsv(feature.mat, self.cv2_free).astype(np.float32)
        # delta applies directly to OpenCV's [0,180) H channel, matching the
        # reference's convertTo(..., 1, delta) on the HSV mat
        hsv[..., 0] = np.mod(hsv[..., 0] + delta, 180.0)
        feature.mat = _from_hsv(hsv.astype(np.uint8), self.cv2_free)


class ChannelOrder(FeatureTransformer):
    """Randomly permute the 3 channels."""

    def __init__(self):
        super().__init__()
        self.rng = sample_random()

    def transform_mat(self, feature: ImageFeature) -> None:
        perm = list(range(3))
        self.rng.shuffle(perm)
        feature.mat = feature.mat[..., perm]


class ChannelNormalize(FeatureTransformer):
    """(x - mean) / std per channel."""

    def __init__(self, mean: Sequence[float], std: Sequence[float] = (1, 1, 1)):
        super().__init__()
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def transform_mat(self, feature: ImageFeature) -> None:
        feature.mat = (feature.mat.astype(np.float32) - self.mean) / self.std


class PixelNormalizer(FeatureTransformer):
    """Subtract a per-pixel mean image."""

    def __init__(self, means: np.ndarray):
        super().__init__()
        self.means = means.astype(np.float32)

    def transform_mat(self, feature: ImageFeature) -> None:
        feature.mat = feature.mat.astype(np.float32) - self.means


class ColorJitter(FeatureTransformer):
    """Random-prob composition of brightness/contrast/saturation/hue/
    channel-order in one of Caffe-SSD's two fixed orders, or fully
    shuffled.  Whether each op applies is drawn by its
    ``RandomTransformer``'s own generator, as in the reference.
    ``device`` picks the HSV conversion, as ``Saturation``'s."""

    def __init__(self, brightness_prob: float = 0.5, brightness_delta: float = 32,
                 contrast_prob: float = 0.5, contrast_lower: float = 0.5,
                 contrast_upper: float = 1.5, hue_prob: float = 0.5,
                 hue_delta: float = 18, saturation_prob: float = 0.5,
                 saturation_lower: float = 0.5, saturation_upper: float = 1.5,
                 random_order_prob: float = 0.0, shuffle: bool = False,
                 device=None):
        super().__init__()
        self.brightness = RandomTransformer(
            Brightness(-brightness_delta, brightness_delta), brightness_prob)
        self.contrast = RandomTransformer(
            Contrast(contrast_lower, contrast_upper), contrast_prob)
        self.saturation = RandomTransformer(
            Saturation(saturation_lower, saturation_upper, device=device),
            saturation_prob)
        self.hue = RandomTransformer(Hue(-hue_delta, hue_delta,
                                         device=device), hue_prob)
        self.channel_order = RandomTransformer(ChannelOrder(),
                                               random_order_prob)
        self.shuffle = shuffle
        self.rng = sample_random()

    def transform(self, feature: ImageFeature) -> ImageFeature:
        if not feature.is_valid:
            return feature
        order1 = [self.brightness, self.contrast, self.saturation, self.hue,
                  self.channel_order]
        order2 = [self.brightness, self.saturation, self.hue, self.contrast,
                  self.channel_order]
        ops = list(order1)
        if self.shuffle:
            self.rng.shuffle(ops)
        else:
            ops = order1 if self.rng.random() < 0.5 else order2
        for op in ops:
            feature = op.transform(feature)
        return feature


# ---------------------------------------------------------------------------
# Geometric ops
# ---------------------------------------------------------------------------

# cv2.INTER_LINEAR, INTER_CUBIC, INTER_AREA, INTER_NEAREST, INTER_LANCZOS4
_INTERP_MODES = [1, 2, 3, 0, 4]
INTER_LINEAR = 1


def _linear_taps(n_out: int, n_in: int):
    """The two source indices and the second one's weight for each of
    ``n_out`` outputs along one axis, with cv2's INTER_LINEAR geometry
    (source x = (i + 0.5) · n_in / n_out - 0.5, clamped at the borders)."""
    x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    x0 = np.floor(x)
    t = x - x0
    low = x0 < 0
    t[low], x0[low] = 0.0, 0.0
    high = x0 >= n_in - 1
    t[high], x0[high] = 0.0, n_in - 1
    i0 = x0.astype(np.intp)
    return i0, np.minimum(i0 + 1, n_in - 1), t.astype(np.float32)


def resize_bilinear(mat: np.ndarray, width: int, height: int) -> np.ndarray:
    """(H, W, C) → (height, width, C) by a separable bilinear resample in
    numpy, ``cv2.resize``'s INTER_LINEAR in float32: a uint8 mat comes
    back uint8, within a level of cv2's fixed-point result; any other
    comes back float32."""
    iy0, iy1, ty = _linear_taps(height, mat.shape[0])
    ix0, ix1, tx = _linear_taps(width, mat.shape[1])
    src = mat.astype(np.float32)
    rows = src[iy0] * (1 - ty[:, None, None]) + src[iy1] * ty[:, None, None]
    out = (rows[:, ix0] * (1 - tx[None, :, None])
           + rows[:, ix1] * tx[None, :, None])
    if mat.dtype == np.uint8:
        return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)
    return out


class Resize(FeatureTransformer):
    """Resize to fixed (w, h) with a cv2 interpolation mode; ``interp=-1``
    picks a random mode per image (the SSD train chain).  The route
    follows ``device`` (the GPU unless given), as ``BytesToMat``'s codec
    does: on a CUDA pipeline INTER_LINEAR is ``resize_bilinear`` in numpy,
    so the card's serving and validation chains import no cv2; on the
    CPU, and for the other modes, ``cv2.resize`` as the reference.  A mat
    already of that size is copied, as ``cv2.resize`` does."""

    def __init__(self, width: int, height: int, interp: int = INTER_LINEAR,
                 device=None):
        super().__init__()
        self.width_, self.height_, self.interp = width, height, interp
        self.numpy_linear = _resize_route(device)
        self.rng = sample_random()

    def transform_mat(self, feature: ImageFeature) -> None:
        interp = (self.interp if self.interp >= 0
                  else self.rng.choice(_INTERP_MODES))
        if feature.mat.shape[:2] == (self.height_, self.width_):
            feature.mat = feature.mat.copy()
        elif self.numpy_linear and interp == INTER_LINEAR:
            feature.mat = resize_bilinear(feature.mat, self.width_,
                                          self.height_)
        else:
            import cv2

            feature.mat = cv2.resize(feature.mat, (self.width_, self.height_),
                                     interpolation=interp)


def _resize_route(device) -> bool:
    """True where INTER_LINEAR runs as :func:`resize_bilinear` (a CUDA
    pipeline, whose card has no cv2), False for ``cv2.resize``."""
    from analytics_zoo_tpu_torch.utils.device import resolve_device

    return resolve_device(device).type == "cuda"


def _resize_linear(mat: np.ndarray, width: int, height: int,
                   numpy_linear: bool) -> np.ndarray:
    """INTER_LINEAR to (width, height) by the route ``numpy_linear``
    picks."""
    if numpy_linear:
        return resize_bilinear(mat, width, height)
    import cv2

    return cv2.resize(mat, (width, height))


class AspectScale(FeatureTransformer):
    """Scale the short side to ``min_size`` capped so the long side stays
    ≤ ``max_size``, optionally rounding dims to a multiple (Faster-RCNN
    style).  The resize follows ``device`` (the GPU unless given), as
    ``Resize``'s: ``resize_bilinear`` on a CUDA pipeline, ``cv2.resize``
    on the CPU."""

    def __init__(self, min_size: int, scale_multiple_of: int = 1,
                 max_size: int = 1000, device=None):
        super().__init__()
        self.min_size = min_size
        self.scale_multiple_of = scale_multiple_of
        self.max_size = max_size
        self.numpy_linear = _resize_route(device)

    def _scale(self, h: int, w: int) -> float:
        short, long = min(h, w), max(h, w)
        scale = self.min_size / short
        if scale * long > self.max_size:
            scale = self.max_size / long
        return scale

    def transform_mat(self, feature: ImageFeature) -> None:
        h, w = feature.mat.shape[:2]
        scale = self._scale(h, w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        if self.scale_multiple_of > 1:
            m = self.scale_multiple_of
            nh = int(np.ceil(nh / m) * m)
            nw = int(np.ceil(nw / m) * m)
        feature.mat = _resize_linear(feature.mat, nw, nh, self.numpy_linear)
        feature["scale"] = scale


class AspectScaleCanvas(FeatureTransformer):
    """Aspect-preserving resize into one fixed square canvas: scale =
    canvas/max(h, w), resize, paste top-left into a ``canvas``×``canvas``
    field of ``fill``.  Both axes share one scale factor, recorded in
    ``im_info`` so detections project back to original pixels.  The
    resize follows ``device``, as ``AspectScale``'s."""

    def __init__(self, canvas: int, fill: int = 0, device=None):
        super().__init__()
        self.canvas = canvas
        self.fill = fill
        self.numpy_linear = _resize_route(device)

    def transform_mat(self, feature: ImageFeature) -> None:
        h, w = feature.mat.shape[:2]
        scale = self.canvas / max(h, w)
        nh = max(int(round(h * scale)), 1)
        nw = max(int(round(w * scale)), 1)
        resized = _resize_linear(feature.mat, nw, nh, self.numpy_linear)
        out = np.full((self.canvas, self.canvas) + resized.shape[2:],
                      self.fill, dtype=resized.dtype)
        out[:nh, :nw] = resized
        feature.mat = out
        feature["scale"] = scale
        # explicit im_info: the padded mat is canvas-sized, so the
        # height/width-ratio default would misreport the scales
        feature["im_info"] = np.array(
            [nh, nw, nh / max(feature.original_height(), 1),
             nw / max(feature.original_width(), 1)], np.float32)


class RandomAspectScale(AspectScale):
    """AspectScale with min_size drawn from ``scales``."""

    def __init__(self, scales: Sequence[int], scale_multiple_of: int = 1,
                 max_size: int = 1000, device=None):
        super().__init__(scales[0], scale_multiple_of, max_size,
                         device=device)
        self.scales = list(scales)
        self.rng = sample_random()

    def transform_mat(self, feature: ImageFeature) -> None:
        self.min_size = self.rng.choice(self.scales)
        super().transform_mat(feature)


class HFlip(FeatureTransformer):
    """Horizontal mirror (what ``cv2.flip(mat, 1)`` computes)."""

    def transform_mat(self, feature: ImageFeature) -> None:
        feature.mat = np.ascontiguousarray(feature.mat[:, ::-1])


class Expand(FeatureTransformer):
    """Zoom-out: paste the image on a larger canvas filled with channel
    means (BGR), recording the normalized expand bbox for label
    re-projection."""

    def __init__(self, means: Sequence[float] = (104.0, 117.0, 123.0),
                 max_expand_ratio: float = 4.0,
                 min_expand_ratio: float = 1.0):
        super().__init__()
        self.means = np.asarray(means, np.float32)
        self.min_ratio = min_expand_ratio
        self.max_ratio = max_expand_ratio
        self.rng = sample_random()

    def transform_mat(self, feature: ImageFeature) -> None:
        ratio = self.rng.uniform(self.min_ratio, self.max_ratio)
        if ratio < 1.0 + 1e-6:
            return
        h, w = feature.mat.shape[:2]
        nh, nw = int(h * ratio), int(w * ratio)
        off_x = int(self.rng.uniform(0, nw - w))
        off_y = int(self.rng.uniform(0, nh - h))
        canvas = np.empty((nh, nw, 3), np.float32)
        canvas[:] = self.means
        canvas[off_y:off_y + h, off_x:off_x + w] = feature.mat
        feature.mat = canvas
        # normalized expand box of the original image inside the canvas
        feature["expand_bbox"] = np.array(
            [-off_x / w, -off_y / h, (nw - off_x) / w, (nh - off_y) / h],
            np.float32)


class Filler(FeatureTransformer):
    """Fill a normalized rect with a constant."""

    def __init__(self, x1: float, y1: float, x2: float, y2: float,
                 value: Sequence[float] = (255, 255, 255)):
        super().__init__()
        self.rect = (x1, y1, x2, y2)
        self.value = np.asarray(value, np.float32)

    def transform_mat(self, feature: ImageFeature) -> None:
        h, w = feature.mat.shape[:2]
        x1, y1, x2, y2 = self.rect
        feature.mat[int(y1 * h):int(y2 * h), int(x1 * w):int(x2 * w)] = self.value


class Crop(FeatureTransformer):
    """Crop to a bbox from one of three sources: a fixed normalized bbox, a feature key holding one, or a generator fn.
    Records ``crop_bbox`` (normalized) for ROI re-projection."""

    def __init__(self, bbox: Optional[Sequence[float]] = None,
                 roi_key: Optional[str] = None,
                 bbox_fn: Optional[Callable[[ImageFeature], Sequence[float]]] = None,
                 normalized: bool = True):
        super().__init__()
        self.bbox = bbox
        self.roi_key = roi_key
        self.bbox_fn = bbox_fn
        self.normalized = normalized

    def _get_bbox(self, feature: ImageFeature):
        if self.bbox is not None:
            return self.bbox
        if self.roi_key is not None:
            return np.asarray(feature[self.roi_key], np.float32).reshape(-1)[:4]
        return self.bbox_fn(feature)

    def transform_mat(self, feature: ImageFeature) -> None:
        h, w = feature.mat.shape[:2]
        x1, y1, x2, y2 = [float(v) for v in self._get_bbox(feature)]
        if self.normalized:
            x1, x2 = x1 * w, x2 * w
            y1, y2 = y1 * h, y2 * h
        xi1, yi1 = max(int(round(x1)), 0), max(int(round(y1)), 0)
        xi2, yi2 = min(int(round(x2)), w), min(int(round(y2)), h)
        feature.mat = np.ascontiguousarray(feature.mat[yi1:yi2, xi1:xi2])
        # record the CLIPPED box so RoiCrop projects labels into the
        # actual pixel frame
        feature["crop_bbox"] = np.array(
            [xi1 / w, yi1 / h, xi2 / w, yi2 / h], np.float32)


class CenterCrop(Crop):
    """Centered fixed-size crop."""

    def __init__(self, crop_width: int, crop_height: int):
        def center(feature: ImageFeature):
            h, w = feature.mat.shape[:2]
            x1 = (w - crop_width) / 2.0
            y1 = (h - crop_height) / 2.0
            return (x1, y1, x1 + crop_width, y1 + crop_height)

        super().__init__(bbox_fn=center, normalized=False)


class RandomCrop(Crop):
    """Random fixed-size crop."""

    def __init__(self, crop_width: int, crop_height: int):
        def rand(feature: ImageFeature):
            h, w = feature.mat.shape[:2]
            x1 = self.rng.uniform(0, max(w - crop_width, 0))
            y1 = self.rng.uniform(0, max(h - crop_height, 0))
            return (x1, y1, x1 + crop_width, y1 + crop_height)

        super().__init__(bbox_fn=rand, normalized=False)
        self.rng = sample_random()

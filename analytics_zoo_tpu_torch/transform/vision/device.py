"""Device-side augmentation (counterpart of ``transform/vision/device.py``),
the bgr wire.

* **Host** (per image, ``DeviceAugPrepare``): the geometry decisions
  (expand ratio and offset, the 7-sampler constrained crop, the flip
  coin, the color jitter parameters) and the label projections, then one
  uint8 paste into a fixed staging canvas.  An image larger than the
  canvas is first shrunk by a separable bilinear resample in numpy (no
  cv2).
* **Device** (``make_device_augment``, batched torch ops over the whole
  batch): the color jitter (brightness, contrast, saturation and hue in
  the reference's two orders, through float HSV), crop + resize + flip
  as a bilinear resample ``Wy @ img @ Wxᵀ`` with the channel-mean border
  added analytically, and the mean subtraction.

The two products run outside any kernel of the reference, so they stay
``torch.bmm`` here, fp32 with TF32 off.  The yuv420 wire and the packed
staging are not ported (ROADMAP.md deferred item e).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.data.transformer import sample_random
from analytics_zoo_tpu_torch.transform.vision.augmentation import (
    resize_bilinear)
from analytics_zoo_tpu_torch.transform.vision.image import (FeatureTransformer,
                                                            ImageFeature)
from analytics_zoo_tpu_torch.transform.vision.roi import (
    RoiLabel,
    meet_emit_center_constraint,
    project_bbox,
)
from analytics_zoo_tpu_torch.transform.vision.sampler import (
    BatchSampler,
    generate_batch_samples,
    standard_samplers,
)

logger = logging.getLogger("analytics_zoo_tpu_torch")

BGR_MEANS = (104.0, 117.0, 123.0)


def _refuse_wire(wire_format: str, pack: bool) -> None:
    if wire_format not in ("bgr", "yuv420"):
        raise ValueError(f"unknown wire_format {wire_format!r}; expected "
                         "'bgr' or 'yuv420'")
    if wire_format != "bgr" or pack:
        raise NotImplementedError(
            f"wire_format={wire_format!r}, pack={pack}: the yuv420 wire "
            "and the packed staging are not ported yet (ROADMAP.md "
            "deferred item e); the bgr wire is")


@dataclasses.dataclass
class DeviceAugParam:
    """Knobs mirroring the canonical SSD train chain."""

    resolution: int = 300
    canvas_size: int = 512          # fixed host→device staging canvas
    pixel_means: Sequence[float] = BGR_MEANS
    # the staged pixels' wire: "bgr" (the uint8 canvas as it is); the
    # reference's "yuv420" and pack=True are refused (deferred item e)
    wire_format: str = "bgr"
    pack: bool = False

    def __post_init__(self):
        _refuse_wire(self.wire_format, self.pack)
    expand_prob: float = 0.5
    max_expand_ratio: float = 4.0
    hflip_prob: float = 0.5
    brightness_prob: float = 0.5
    brightness_delta: float = 32.0
    contrast_prob: float = 0.5
    contrast_range: Sequence[float] = (0.5, 1.5)
    saturation_prob: float = 0.5
    saturation_range: Sequence[float] = (0.5, 1.5)
    hue_prob: float = 0.5
    hue_delta: float = 18.0


class DeviceAugPrepare(FeatureTransformer):
    """Host half: geometry and labels → staging arrays.

    Consumes an ImageFeature after ``RecordToFeature >> BytesToMat >>
    RoiNormalize`` and emits a dict of fixed-shape numpy arrays the
    device half consumes.  Draws from ``self.rng``, the per-sample stream
    ``data.transformer.sample_random``, in the reference's order."""

    def __init__(self, param: DeviceAugParam,
                 samplers: Optional[List[BatchSampler]] = None):
        super().__init__()
        self.p = param
        self.samplers = samplers or standard_samplers()
        self.rng = sample_random()

    def transform(self, feature: ImageFeature) -> Optional[Dict]:
        """A record that fails here is dropped with a warning, never
        killing the epoch."""
        try:
            return self._transform(feature)
        except Exception:                                   # noqa: BLE001
            logger.warning("DeviceAugPrepare failed for %s — dropping",
                           feature.get("path", "<unknown>"), exc_info=True)
            return None

    def _transform(self, feature: ImageFeature) -> Optional[Dict]:
        if not feature.is_valid:
            logger.warning("DeviceAugPrepare: %s did not decode — dropping",
                           feature.get("path", "<unknown>"))
            return None
        p = self.p
        rng = self.rng
        mat = feature.mat
        if mat.dtype != np.uint8:
            mat = np.clip(mat, 0, 255).astype(np.uint8)
        h, w = mat.shape[:2]
        label: RoiLabel = feature.label

        # --- pre-downscale so the image fits the staging canvas ----------
        if max(h, w) > p.canvas_size:
            s = p.canvas_size / max(h, w)
            mat = resize_bilinear(mat, max(1, int(w * s)), max(1, int(h * s)))
            h, w = mat.shape[:2]   # labels are normalized — unaffected

        # --- expand (zoom-out) decision: label math only ------------------
        # the mean-filled canvas is never built; the device sampler's
        # mean-border fill realises it
        ox = oy = 0.0
        ew, eh = float(w), float(h)
        if rng.random() < p.expand_prob:
            ratio = rng.uniform(1.0, p.max_expand_ratio)
            if ratio > 1.0 + 1e-6:
                ew, eh = w * ratio, h * ratio
                ox = rng.uniform(0, ew - w)
                oy = rng.uniform(0, eh - h)
                expand_box = np.array([-ox / w, -oy / h, (ew - ox) / w,
                                       (eh - oy) / h], np.float32)
                if label.size():
                    boxes, valid = project_bbox(expand_box, label.bboxes)
                    new = label.select(valid)
                    new.bboxes = boxes[valid]
                    label = new

        # --- constrained random crop (7 SSD samplers) ---------------------
        crop = np.array([0.0, 0.0, 1.0, 1.0], np.float32)  # of expanded frame
        boxes = generate_batch_samples(label, self.samplers, rng)
        if boxes:
            crop = boxes[rng.randrange(len(boxes))]
            if label.size():
                projected, valid = project_bbox(crop, label.bboxes)
                valid &= meet_emit_center_constraint(crop, label.bboxes)
                new = label.select(valid)
                new.bboxes = projected[valid]
                label = new

        # --- flip decision -------------------------------------------------
        flip = rng.random() < p.hflip_prob
        if flip and label.size():
            b = label.bboxes.copy()
            b[:, 0], b[:, 2] = 1.0 - label.bboxes[:, 2], 1.0 - label.bboxes[:, 0]
            label = RoiLabel(label.labels, b, label.difficult)

        # source rect of the crop in ORIGINAL image pixel coords (may
        # extend beyond [0,w)×[0,h): outside = channel-mean fill)
        rect = np.array([crop[0] * ew - ox, crop[1] * eh - oy,
                         crop[2] * ew - ox, crop[3] * eh - oy], np.float32)

        # --- color jitter parameters ---------------------------------------
        rr = rng.random
        jitter = np.zeros(5, np.float32)
        jitter[0] = rr()                                    # order coin
        jitter[1] = (rng.uniform(-p.brightness_delta, p.brightness_delta)
                     if rr() < p.brightness_prob else 0.0)
        jitter[2] = (rng.uniform(*p.contrast_range)
                     if rr() < p.contrast_prob else 1.0)
        jitter[3] = (rng.uniform(*p.saturation_range)
                     if rr() < p.saturation_prob else 1.0)
        jitter[4] = (rng.uniform(-p.hue_delta, p.hue_delta)
                     if rr() < p.hue_prob else 0.0)

        canvas = np.zeros((p.canvas_size, p.canvas_size, 3), np.uint8)
        canvas[:h, :w] = mat
        return {
            "canvas": canvas,
            "rect": rect,
            "size": np.array([h, w], np.float32),
            "flip": np.float32(1.0 if flip else 0.0),
            "jitter": jitter,
            "label": label,
            "im_info": np.array([p.resolution, p.resolution, 1.0, 1.0],
                                np.float32),
        }


class DeviceAugBatch(FeatureTransformer):
    """Collate DeviceAugPrepare dicts into a staged batch: ``{"aug":
    {canvas, rect, size, flip, jitter}, "im_info", "target": {bboxes,
    labels, difficult, mask}}`` (the ``RoiImageToBatch`` counterpart of
    the device path).  ``pack=True`` is refused (deferred item e)."""

    def __init__(self, batch_size: int, max_gt: int = 100,
                 drop_remainder: bool = True, pack: bool = False):
        super().__init__()
        _refuse_wire("bgr", pack)
        self.batch_size = batch_size
        self.max_gt = max_gt
        self.drop_remainder = drop_remainder
        self.pack = pack

    def apply_iter(self, it):
        buf: List[Dict] = []
        for d in it:
            if d is None:
                continue
            buf.append(d)
            if len(buf) == self.batch_size:
                yield self.collate(buf)
                buf = []
        if buf and not self.drop_remainder:
            yield self.collate(buf)

    def collate(self, ds: List[Dict]) -> Dict:
        from analytics_zoo_tpu_torch.data.dataset import pad_ragged

        boxes = [d["label"].bboxes for d in ds]
        labels = [d["label"].labels.reshape(-1, 1) for d in ds]
        diff = [d["label"].difficult.reshape(-1, 1) for d in ds]
        b, mask = pad_ragged(boxes, self.max_gt)
        l, _ = pad_ragged(labels, self.max_gt)
        dd, _ = pad_ragged(diff, self.max_gt)
        aug = {k: np.stack([d[k] for d in ds])
               for k in ("canvas", "rect", "size", "flip", "jitter")}
        return {
            "aug": aug,
            "im_info": np.stack([d["im_info"] for d in ds]),
            "target": {
                "bboxes": b, "labels": l[..., 0].astype(np.int32),
                "difficult": dd[..., 0], "mask": mask,
            },
        }


# ---------------------------------------------------------------------------
# device half (batched torch ops)
# ---------------------------------------------------------------------------


def _div(a, k: float):
    """``a / k`` by a true division on every device: PyTorch's CUDA
    division by a Python number multiplies by its reciprocal, which
    rounds differently from the CPU's (and the reference's) division."""
    import torch

    return a / torch.tensor(k, dtype=a.dtype, device=a.device)


def _bgr_to_hsv(img):
    """Float BGR (0..255) → OpenCV-convention HSV (H in [0,180))."""
    import torch

    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = v - mn
    safe_c = torch.where(c > 0, c, torch.ones_like(c))
    h = torch.where(
        v == r, (g - b) / safe_c,
        torch.where(v == g, 2.0 + (b - r) / safe_c, 4.0 + (r - g) / safe_c))
    h = torch.where(c > 0, torch.remainder(h * 30.0, 180.0),
                    torch.zeros_like(h))                    # 60°/2 per unit
    s = torch.where(v > 0, c / torch.where(v > 0, v, torch.ones_like(v))
                    * 255.0, torch.zeros_like(v))
    return h, s, v


def _hsv_to_bgr(h, s, v):
    import torch

    c = _div(v * s, 255.0)
    hp = _div(h, 30.0)                                     # [0, 6)
    x = c * (1.0 - torch.abs(torch.remainder(hp, 2.0) - 1.0))
    m = v - c
    i = torch.remainder(torch.floor(hp).to(torch.int32), 6)
    z = torch.zeros_like(c)

    def pick(*vals):
        out = vals[5]
        for k in (4, 3, 2, 1, 0):
            out = torch.where(i == k, vals[k], out)
        return out

    r = pick(c, x, z, z, x, c)
    g = pick(x, c, c, x, z, z)
    b = pick(z, z, x, c, c, x)
    return torch.stack([b + m, g + m, r + m], dim=-1)


def _jitter(img, jitter):
    """The reference's ColorJitter over a batch (B, H, W, 3): brightness,
    then {contrast → saturation/hue | saturation/hue → contrast} by the
    order coin; channel-order has prob 0 in the canonical chain."""
    import torch

    col = jitter[:, None, None, :]
    order, bright, alpha_c, alpha_s, hue_d = (col[..., k] for k in range(5))
    x = img + bright[..., None]
    # one HSV pass for both orders: contrast before it for order 1,
    # after it for order 2
    first = (order < 0.5)[..., None]
    z = torch.where(first, x * alpha_c[..., None], x)
    h, s, v = _bgr_to_hsv(torch.clamp(z, 0, 255))
    s = torch.clamp(s * alpha_s, 0, 255)
    h = torch.remainder(h + hue_d, 180.0)
    w = _hsv_to_bgr(h, s, v)
    return torch.where(first, w, w * alpha_c[..., None])


def _sample(img, rect, size, flip, out_res, means):
    """Bilinear crop + resize + flip with channel-mean border over a batch
    (B, S, S, 3) → (B, R, R, 3): ``Wy @ img @ Wxᵀ`` with hat-function
    weights (≤2 nonzeros a row), taps beyond the image carrying zero
    weight, and the mean added as ``mean · (1 − row_weight ⊗ col_weight)``
    (weights and validity are separable)."""
    import torch

    B, S = img.shape[0], img.shape[1]
    dev = img.device
    h, w = size[:, 0:1], size[:, 1:2]
    x1, y1, x2, y2 = (rect[:, k:k + 1] for k in range(4))
    grid = torch.arange(out_res, device=dev, dtype=torch.float32)[None, :]
    xs = x1 + (grid + 0.5) * _div(x2 - x1, out_res) - 0.5   # (B, R)
    ys = y1 + (grid + 0.5) * _div(y2 - y1, out_res) - 0.5
    # flip = reversed output columns = reversed sample positions
    xs = torch.where(flip[:, None] > 0.5, xs.flip(-1), xs)
    taps = torch.arange(S, device=dev, dtype=torch.float32)
    wy = torch.clamp(1.0 - torch.abs(ys[:, :, None] - taps), min=0.0)
    wx = torch.clamp(1.0 - torch.abs(xs[:, :, None] - taps), min=0.0)
    # taps beyond the image extent (canvas padding or outside) → mean
    wy = wy * (taps[None, None, :] < h[:, :, None])
    wx = wx * (taps[None, None, :] < w[:, :, None])
    border = 1.0 - wy.sum(-1)[:, :, None] * wx.sum(-1)[:, None, :]
    core = torch.bmm(wy, img.reshape(B, S, S * 3))          # (B, R, S*3)
    core = core.reshape(B, out_res, S, 3).permute(0, 1, 3, 2)
    core = torch.bmm(core.reshape(B, out_res * 3, S), wx.transpose(1, 2))
    # NHWC-contiguous, the layout the model's convolutions take without
    # a conversion (a permuted view here makes every step's network run
    # in NCHW behind layout copies)
    core = core.reshape(B, out_res, 3, out_res).permute(0, 1, 3, 2)
    return core.contiguous() + border[..., None] * means


def make_device_augment(param: DeviceAugParam, compute_dtype=None,
                        device=None) -> Callable[[Dict], Dict]:
    """The batch augmentation ``out = fn(batch)``: ``batch["aug"]``'s
    staging arrays (numpy or tensors) become ``out["input"]`` (B, res,
    res, 3), mean-subtracted, on ``device`` (the GPU unless given, or the
    tensors' own device); the other keys pass through.  Runs in fp32
    with TF32 off; ``compute_dtype`` casts the result.  Pass it as
    ``device_transform=`` to the train step or ``train_ssd``."""
    import torch

    from analytics_zoo_tpu_torch.parallel.train import (resolve_compute_dtype,
                                                        to_device)
    from analytics_zoo_tpu_torch.utils.device import resolve_device

    _refuse_wire(param.wire_format, param.pack)
    cdtype = resolve_compute_dtype(compute_dtype)
    default_dev = resolve_device(device)
    means_host = torch.tensor(param.pixel_means, dtype=torch.float32)
    res = param.resolution

    def augment(batch: Dict) -> Dict:
        aug = batch["aug"]
        canvas = aug["canvas"]
        dev = (canvas.device if isinstance(canvas, torch.Tensor)
               and device is None else default_dev)
        aug = to_device(aug, dev)
        means = means_host.to(dev)
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            img = _jitter(aug["canvas"].to(torch.float32),
                          aug["jitter"].to(torch.float32))
            out_img = _sample(img, aug["rect"], aug["size"], aug["flip"],
                              res, means) - means
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        out = {k: v for k, v in batch.items() if k != "aug"}
        out["input"] = out_img if cdtype is None else out_img.to(cdtype)
        return out

    return augment

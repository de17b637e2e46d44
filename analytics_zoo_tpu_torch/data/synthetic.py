"""Rendered-shapes detection dataset (counterpart of ``data/synthetic.py``):
real JPEGs with known ground truth, written as ``.azr`` shards, drawn in
numpy (no cv2) and encoded through the port's codec.

The generator makes the reference's ``RandomState`` draws in the
reference's order, so for a seed the gt matrices EQUAL the reference's.
The pixels follow cv2's operations in numpy (bicubic resize with cv2's
a = -0.75 and half-pixel centres, the fixed 5-tap [1 4 6 4 1]/16
Gaussian with reflect-101 borders, filled rectangle, ellipse and
triangle), not cv2's fixed-point rasterizer, so they are close to the
reference's, not equal (``tests/test_torch_ssd_input.py`` pins the
agreement).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from analytics_zoo_tpu_torch.data.records import (SSDByteRecord,
                                                  write_ssd_records)

SHAPE_CLASSES = ("__background__", "rectangle", "ellipse", "triangle")


def _cubic_weights(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) weights of cv2's INTER_CUBIC along one axis (A =
    -0.75, source x = (i + 0.5) · n_in / n_out - 0.5, replicated border)."""
    a = -0.75
    x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    x0 = np.floor(x)
    t = x - x0
    w = np.zeros((n_out, n_in))
    for k in range(-1, 3):
        d = np.abs(t - k)
        wk = np.where(d <= 1, ((a + 2) * d - (a + 3)) * d * d + 1,
                      np.where(d < 2, ((a * d - 5 * a) * d + 8 * a) * d
                               - 4 * a, 0.0))
        idx = np.clip(x0 + k, 0, n_in - 1).astype(int)
        np.add.at(w, (np.arange(n_out), idx), wk)
    return w


def _resize_cubic(img: np.ndarray, size: int) -> np.ndarray:
    wy = _cubic_weights(size, img.shape[0])
    wx = _cubic_weights(size, img.shape[1])
    tmp = np.tensordot(wy, img.astype(np.float64), axes=(1, 0))  # (y,w,c)
    out = np.tensordot(tmp, wx, axes=(1, 1)).transpose(0, 2, 1)  # (y,x,c)
    return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)


def _gaussian5(img: np.ndarray) -> np.ndarray:
    """cv2.GaussianBlur(img, (5, 5), 0): the fixed [1 4 6 4 1]/16 taps
    each way, reflect-101 borders."""
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    x = img.astype(np.float64)
    h, w = x.shape[:2]
    p = np.pad(x, ((2, 2), (0, 0), (0, 0)), mode="reflect")
    x = sum(k[j] * p[j:j + h] for j in range(5))
    p = np.pad(x, ((0, 0), (2, 2), (0, 0)), mode="reflect")
    x = sum(k[j] * p[:, j:j + w] for j in range(5))
    return np.clip(np.floor(x + 0.5), 0, 255).astype(np.uint8)


def _fill_triangle(img, pts, color) -> None:
    """Fill the triangle ``pts`` (x, y) over the pixel centres it covers,
    its edges included."""
    (ax, ay), (bx, by), (cx, cy) = [(float(x), float(y)) for x, y in pts]
    h, w = img.shape[:2]
    y0, y1 = max(int(min(ay, by, cy)), 0), min(int(max(ay, by, cy)), h - 1)
    x0, x1 = max(int(min(ax, bx, cx)), 0), min(int(max(ax, bx, cx)), w - 1)
    if y1 < y0 or x1 < x0:
        return
    yy, xx = np.mgrid[y0:y1 + 1, x0:x1 + 1].astype(np.float64)

    def side(px, py, qx, qy):
        return (qx - px) * (yy - py) - (qy - py) * (xx - px)

    s1, s2, s3 = side(ax, ay, bx, by), side(bx, by, cx, cy), side(cx, cy,
                                                                   ax, ay)
    inside = (((s1 >= 0) & (s2 >= 0) & (s3 >= 0))
              | ((s1 <= 0) & (s2 <= 0) & (s3 <= 0)))
    img[y0:y1 + 1, x0:x1 + 1][inside] = color


def render_shapes_image(rng: np.random.RandomState, resolution: int = 300,
                        max_shapes: int = 3,
                        n_classes: int = len(SHAPE_CLASSES) - 1,
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """One image: textured background + 1..max_shapes colored shapes.
    Returns (BGR uint8 image, gt matrix (N, 6) of (label, difficult, x1,
    y1, x2, y2) in pixel coords — the ``SSDByteRecord`` layout)."""
    res = resolution
    # low-frequency textured background (so JPEG statistics are realistic)
    base = rng.randint(0, 120, (res // 10, res // 10, 3), np.uint8)
    img = _gaussian5(_resize_cubic(base, res))

    n = rng.randint(1, max_shapes + 1)
    gt: List[List[float]] = []
    yy, xx = np.mgrid[0:res, 0:res]
    for _ in range(n):
        cls = rng.randint(1, n_classes + 1)
        size = rng.randint(res // 6, res // 2)
        x1 = rng.randint(0, res - size)
        y1 = rng.randint(0, res - size)
        w = size
        h = rng.randint(int(size * 0.6), size + 1)
        y1 = min(y1, res - h)
        x2, y2 = x1 + w, y1 + h
        # bright, saturated color (BGR) — contrasts the dark background
        color = np.array([int(c) for c in rng.randint(140, 256, 3)],
                         np.uint8)
        if cls == 1:                      # rectangle, corners included
            img[y1:y2 + 1, x1:x2 + 1] = color
        elif cls == 2:                    # ellipse
            cx, cy = (x1 + x2) // 2, (y1 + y2) // 2
            ax, ay = max(w // 2, 1), max(h // 2, 1)
            inside = (((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2) <= 1.0
            img[inside] = color
        else:                             # triangle
            _fill_triangle(img, [((x1 + x2) // 2, y1), (x1, y2 - 1),
                                 (x2 - 1, y2 - 1)], color)
        gt.append([float(cls), 0.0, float(x1), float(y1),
                   float(x2 - 1), float(y2 - 1)])
    return img, np.asarray(gt, np.float32)


def generate_shapes_records(prefix: str, n_images: int = 800,
                            resolution: int = 300, num_shards: int = 4,
                            seed: int = 0, max_shapes: int = 3,
                            jpeg_quality: int = 92,
                            device=None) -> List[str]:
    """Render → JPEG-encode → write ``.azr`` shards; returns the shard
    paths.  The codec is the one of ``device`` (nvJPEG on the GPU, the
    default; libjpeg with ``device="cpu"``)."""
    from analytics_zoo_tpu_torch.data import native
    from analytics_zoo_tpu_torch.utils.device import resolve_device

    codec = native.codec_for(resolve_device(device))
    native.check_codec(codec)
    rng = np.random.RandomState(seed)
    records = []
    for i in range(n_images):
        img, gt = render_shapes_image(rng, resolution, max_shapes)
        records.append(SSDByteRecord(
            data=native.encode_jpeg(img, jpeg_quality, codec=codec),
            path=f"shapes/{i:06d}.jpg", gt=gt))
    return write_ssd_records(records, prefix, num_shards)

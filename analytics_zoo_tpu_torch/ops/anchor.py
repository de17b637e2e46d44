"""Faster-RCNN anchors, precomputed on the host (counterpart of
``ops/anchor.py``).

The port's own copy, numpy only and kept line for line so the anchors
are bit-equal: base anchors from ratios × scales around a 16-px window,
shifted over the feature map; a constant copied to the device once per
model, as the SSD priors are.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def generate_base_anchors(base_size: int = 16,
                          ratios: Sequence[float] = (0.5, 1.0, 2.0),
                          scales: Sequence[float] = (8, 16, 32)) -> np.ndarray:
    """(len(ratios)·len(scales), 4) anchors centered on the base window."""
    base = np.array([0, 0, base_size - 1, base_size - 1], np.float32)
    ratio_anchors = _ratio_enum(base, np.asarray(ratios, np.float32))
    return np.vstack([
        _scale_enum(ratio_anchors[i], np.asarray(scales, np.float32))
        for i in range(ratio_anchors.shape[0])
    ])


def _whctrs(anchor):
    w = anchor[2] - anchor[0] + 1
    h = anchor[3] - anchor[1] + 1
    return w, h, anchor[0] + 0.5 * (w - 1), anchor[1] + 0.5 * (h - 1)


def _mkanchors(ws, hs, x_ctr, y_ctr):
    ws = ws[:, None]
    hs = hs[:, None]
    return np.hstack([
        x_ctr - 0.5 * (ws - 1), y_ctr - 0.5 * (hs - 1),
        x_ctr + 0.5 * (ws - 1), y_ctr + 0.5 * (hs - 1),
    ]).astype(np.float32)


def _ratio_enum(anchor, ratios):
    w, h, x, y = _whctrs(anchor)
    size = w * h
    ws = np.round(np.sqrt(size / ratios))
    hs = np.round(ws * ratios)
    return _mkanchors(ws, hs, x, y)


def _scale_enum(anchor, scales):
    w, h, x, y = _whctrs(anchor)
    return _mkanchors(w * scales, h * scales, x, y)


def shift_anchors(base_anchors: np.ndarray, feat_h: int, feat_w: int,
                  feat_stride: int = 16) -> np.ndarray:
    """Tile base anchors over the feature map → (H·W·A, 4), row-major
    over (y, x), anchors innermost."""
    sx = np.arange(feat_w) * feat_stride
    sy = np.arange(feat_h) * feat_stride
    gx, gy = np.meshgrid(sx, sy)
    shifts = np.stack([gx.ravel(), gy.ravel(), gx.ravel(), gy.ravel()],
                      axis=1).astype(np.float32)          # (HW, 4)
    return (shifts[:, None, :] + base_anchors[None, :, :]).reshape(-1, 4)

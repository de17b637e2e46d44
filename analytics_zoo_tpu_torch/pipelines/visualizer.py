"""Detection visualization (counterpart of ``pipelines/visualizer.py``;
reference ``common/dataset/roiimage/Visualizer.scala:31,85``): draw
class and score boxes on images with cv2, and a text dump of detections.
Host only.  Only :func:`vis_detection` needs cv2, and imports it when
called (the card's machine may lack it): the text dump imports without
it."""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.pipelines.voc import VOC_CLASSES

_COLORS = [
    (255, 56, 56), (50, 205, 50), (65, 105, 225), (255, 165, 0),
    (186, 85, 211), (0, 206, 209), (255, 105, 180), (154, 205, 50),
]


def vis_detection(image: np.ndarray, detections: np.ndarray,
                  class_names: Sequence[str] = VOC_CLASSES,
                  conf_thresh: float = 0.3,
                  out_path: Optional[str] = None) -> np.ndarray:
    """Draw (K, 6) detections (cls, score, x1, y1, x2, y2 in pixels) on a
    BGR image; optionally save (reference ``visDetection``).  Raises
    ``ImportError`` where cv2 is not installed."""
    import cv2

    canvas = np.ascontiguousarray(image.astype(np.uint8))
    for row in np.asarray(detections):
        cls, score = int(row[0]), float(row[1])
        if cls < 0 or score < conf_thresh:
            continue
        x1, y1, x2, y2 = [int(round(v)) for v in row[2:6]]
        color = _COLORS[cls % len(_COLORS)]
        cv2.rectangle(canvas, (x1, y1), (x2, y2), color, 2)
        name = (class_names[cls] if 0 <= cls < len(class_names)
                else str(cls))
        label = f"{name} {score:.2f}"
        (tw, th), _ = cv2.getTextSize(label, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        cv2.rectangle(canvas, (x1, max(y1 - th - 6, 0)),
                      (x1 + tw + 2, max(y1, th + 6)), color, -1)
        cv2.putText(canvas, label, (x1 + 1, max(y1 - 4, th)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 1,
                    cv2.LINE_AA)
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        cv2.imwrite(out_path, canvas)
    return canvas


def result_to_string(detections: np.ndarray,
                     class_names: Sequence[str] = VOC_CLASSES,
                     conf_thresh: float = 0.0) -> str:
    """Text dump of detections (reference ``BboxUtil.resultToString``)."""
    lines = []
    for row in np.asarray(detections):
        cls, score = int(row[0]), float(row[1])
        if cls < 0 or score < conf_thresh:
            continue
        name = class_names[cls] if 0 <= cls < len(class_names) else str(cls)
        lines.append(f"{name} {score:.4f} "
                     + " ".join(f"{v:.1f}" for v in row[2:6]))
    return "\n".join(lines)

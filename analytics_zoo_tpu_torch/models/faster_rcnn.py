"""Faster-RCNN VGG16 detector in PyTorch (counterpart of
``models/faster_rcnn.py``): trunk → RPN → proposal → ROI pool → heads,
and with :class:`FasterRcnnDetector` the per-class post-processing, in
one module.

The public input is NHWC ``(B, H, W, 3)`` BGR mean-subtracted pixels and
``im_info`` ``(B, 3)`` rows ``(height, width, scale)``; inside,
convolutions run NCHW, as ``models/ssd.py`` does.  The RPN heads keep
Caffe's channel layout (``rpn_cls_score`` is ``[bg × A, fg × A]``,
``rpn_bbox_pred`` anchor-major × 4), so the proposal scores come out in
the reference's ``h·w·A`` order.

The ROI-pooled map is flattened **HWC** into fc6, as in the reference:
:func:`~analytics_zoo_tpu_torch.ops.roi_pool.roi_pool_batch` gathers
channel vectors, so its ``(R, 7, 7, C)`` output feeds fc6 without a
transpose.  A flax fc6 kernel therefore bridges by a plain transpose
(``utils.convert.frcnn_params_from_jax``) and a Caffe fc6, whose rows
read a CHW flatten, is permuted on import
(``utils.caffe.load_frcnn_vgg_caffe``).

Layer names follow the reference's (``vgg.conv1_1`` … ``rpn_conv_3x3``,
``fc6``, ``cls_score``; ``frcnn.`` in front inside the detector).

Training (approximate joint training, ``ops/frcnn_train.py``):
``train=True`` applies dropout 0.5 after fc6 and fc7 with masks drawn from
the model's own ``torch.Generator`` on the input's device, seeded with
``seed`` (so a seeded model's steps repeat), ``extra_rois`` (the gt
boxes) join the proposals, and
``train_outputs=True`` returns the raw RPN and head outputs the loss
takes.  The proposal runs without autograd and in fp32 under autocast,
and the ROIs carry no gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.core.layers import (SeededGenerators, dropout,
                                                lecun_normal_)
from analytics_zoo_tpu_torch.ops.anchor import (generate_base_anchors,
                                                shift_anchors)
from analytics_zoo_tpu_torch.ops.bbox import bbox_transform_inv, clip_boxes
from analytics_zoo_tpu_torch.ops.frcnn import (FrcnnPostParam,
                                               frcnn_postprocess)
from analytics_zoo_tpu_torch.ops.proposal import ProposalParam, proposal
from analytics_zoo_tpu_torch.ops.roi_pool import roi_pool_batch
from analytics_zoo_tpu_torch.utils.device import host_constant, resolve_device

# (name, in, out) of the 3x3 pad-1 convs, a 2x2 max pool after each stage
_STAGES = (
    (("conv1_1", 3, 64), ("conv1_2", 64, 64)),
    (("conv2_1", 64, 128), ("conv2_2", 128, 128)),
    (("conv3_1", 128, 256), ("conv3_2", 256, 256), ("conv3_3", 256, 256)),
    (("conv4_1", 256, 512), ("conv4_2", 512, 512), ("conv4_3", 512, 512)),
    (("conv5_1", 512, 512), ("conv5_2", 512, 512), ("conv5_3", 512, 512)),
)


class FrcnnVggTrunk(nn.Module):
    """VGG16 conv1_1 … conv5_3 at stride 16 (the py-faster-rcnn layout),
    NCHW in and out."""

    def __init__(self):
        super().__init__()
        for stage in _STAGES:
            for name, cin, cout in stage:
                self.add_module(name, nn.Conv2d(cin, cout, 3, padding=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, stage in enumerate(_STAGES):
            for name, *_ in stage:
                x = F.relu(getattr(self, name)(x))
            if i < len(_STAGES) - 1:
                x = F.max_pool2d(x, 2, 2)
        return x


@dataclasses.dataclass(frozen=True)
class FrcnnParam:
    """Assembly knobs: the VGG flavour's 9-anchor RPN and
    py-faster-rcnn's test-time proposal settings."""

    num_classes: int = 21
    anchor_ratios: Sequence[float] = (0.5, 1.0, 2.0)
    anchor_scales: Sequence[float] = (8, 16, 32)
    feat_stride: int = 16
    pooled: int = 7
    proposal: ProposalParam = ProposalParam(pre_nms_topn=6000,
                                            post_nms_topn=300)

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_ratios) * len(self.anchor_scales)


class FasterRcnnVgg(nn.Module):
    """Trunk + RPN + proposal + ROI pool + classification heads.

    ``forward(x, im_info)`` returns ``(rois, roi_mask, cls_probs,
    bbox_deltas)``: rois (B, R, 4) pixel boxes zeroed where padded,
    roi_mask (B, R), cls_probs (B, R, C) softmax probabilities,
    bbox_deltas (B, R, C·4) per-class regression deltas.

    Built on ``device`` (the GPU unless ``device="cpu"``) with weights
    drawn from ``torch.Generator().manual_seed(seed)``: LeCun-normal
    kernels (flax's default, truncated at two standard deviations), zero
    biases."""

    def __init__(self, param: FrcnnParam = FrcnnParam(), *, device=None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.param = param
        A, C, P = param.num_anchors, param.num_classes, param.pooled
        self.vgg = FrcnnVggTrunk()
        self.rpn_conv_3x3 = nn.Conv2d(512, 512, 3, padding=1)
        self.rpn_cls_score = nn.Conv2d(512, 2 * A, 1)
        self.rpn_bbox_pred = nn.Conv2d(512, 4 * A, 1)
        self.fc6 = nn.Linear(P * P * 512, 4096)
        self.fc7 = nn.Linear(4096, 4096)
        self.cls_score = nn.Linear(4096, C)
        self.bbox_pred = nn.Linear(4096, 4 * C)
        self._anchors: Dict[Tuple, torch.Tensor] = {}
        self.dropout_generator = SeededGenerators(seed)
        self._init_weights(seed)
        self.to(dev)
        self.eval()

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                lecun_normal_(m.weight, m.weight[0].numel(), generator=gen)
                m.bias.zero_()

    def anchors(self, h: int, w: int, device) -> torch.Tensor:
        """The (h·w·A, 4) anchors of an h × w feature map, on
        ``device`` (a host constant, copied once a shape, no host
        sync)."""
        key = (h, w, str(device))
        if key not in self._anchors:
            p = self.param
            # a constant of the reference's program
            # (models/faster_rcnn.py:135), copied without a host sync
            self._anchors[key] = host_constant(shift_anchors(
                generate_base_anchors(ratios=p.anchor_ratios,
                                      scales=p.anchor_scales),
                h, w, p.feat_stride), device)
        return self._anchors[key]

    def _rpn(self, feat: torch.Tensor):
        """NCHW trunk features → (scores (B, h·w·A), deltas (B, h·w·A, 4),
        [bg, fg] logits (B, h·w·A, 2)), all in the reference's
        (y, x, anchor) order."""
        B, _, h, w = feat.shape
        A = self.param.num_anchors
        y = F.relu(self.rpn_conv_3x3(feat))
        # Caffe channel layout: [bg × A, fg × A]
        cls_pair = self.rpn_cls_score(y).view(B, 2, A, h, w)
        fg = torch.softmax(cls_pair, dim=1)[:, 1]                # (B,A,h,w)
        scores = fg.permute(0, 2, 3, 1).reshape(B, -1)
        deltas = self.rpn_bbox_pred(y).permute(0, 2, 3, 1).reshape(B, -1, 4)
        logits = cls_pair.permute(0, 3, 4, 2, 1).reshape(B, -1, 2)
        return scores, deltas, logits

    def rpn(self, feat: torch.Tensor):
        """NCHW trunk features → (scores (B, h·w·A), deltas
        (B, h·w·A, 4)) in the reference's (y, x, anchor) order."""
        scores, deltas, _ = self._rpn(feat)
        return scores, deltas

    def _head_logits(self, pooled: torch.Tensor, train: bool = False):
        """(B, R, P, P, 512) pooled maps → (cls_logits, bbox_deltas);
        ``train`` drops out half after fc6 and fc7 (flax ``Dropout(0.5)``:
        the kept scaled by 2)."""
        flat = pooled.reshape(*pooled.shape[:2], -1)             # HWC order
        y = F.relu(self.fc6(flat))
        if train:
            gen = self.dropout_generator(y.device)
            y = dropout(y, 0.5, gen)
        y = F.relu(self.fc7(y))
        if train:
            y = dropout(y, 0.5, gen)
        return self.cls_score(y), self.bbox_pred(y)

    def heads(self, pooled: torch.Tensor):
        """(B, R, P, P, 512) pooled maps → (cls_probs, bbox_deltas)."""
        cls_logits, bbox_deltas = self._head_logits(pooled)
        return torch.softmax(cls_logits, dim=-1), bbox_deltas

    def forward(self, x: torch.Tensor, im_info, train: bool = False,
                extra_rois=None, extra_rois_mask=None,
                train_outputs: bool = False):
        """``extra_rois`` (B, G, 4) with ``extra_rois_mask`` (B, G) (all
        valid when left out) join the proposals before pooling: the gt
        boxes, py-faster-rcnn's way of having foreground ROIs early in
        training.  ``train_outputs=True`` returns the dict
        :func:`~analytics_zoo_tpu_torch.ops.frcnn_train.
        frcnn_training_loss` takes: ``rpn_cls_logits`` (B, h·w·A, 2),
        ``rpn_deltas``, ``fg_scores``, ``anchors``, ``rois``, ``roi_mask``,
        ``cls_logits`` and ``bbox_deltas``."""
        p = self.param
        feat = self.vgg(x.permute(0, 3, 1, 2))                  # (B,512,h,w)
        dev = feat.device
        info = torch.as_tensor(im_info, dtype=torch.float32, device=dev)
        scores, deltas, rpn_logits = self._rpn(feat)
        anchors = self.anchors(feat.shape[2], feat.shape[3], dev)
        with torch.no_grad(), torch.autocast(dev.type, enabled=False):
            rois, roi_mask = proposal(
                scores.detach().float(), deltas.detach().float(), anchors,
                info[:, 0], info[:, 1], info[:, 2], param=p.proposal)
        if extra_rois is not None:
            extra = torch.as_tensor(extra_rois, dtype=torch.float32,
                                    device=dev).detach()
            extra_mask = (torch.ones(extra.shape[:-1], device=dev)
                          if extra_rois_mask is None else
                          torch.as_tensor(extra_rois_mask, device=dev)
                          .detach().to(roi_mask.dtype))
            rois = torch.cat([rois, extra], dim=1)
            roi_mask = torch.cat([roi_mask, extra_mask], dim=1)
        pooled = roi_pool_batch(
            feat.permute(0, 2, 3, 1).contiguous(), rois, roi_mask,
            pooled_h=p.pooled, pooled_w=p.pooled,
            spatial_scale=1.0 / p.feat_stride)
        cls_logits, bbox_deltas = self._head_logits(pooled, train)
        if train_outputs:
            return {"rpn_cls_logits": rpn_logits, "rpn_deltas": deltas,
                    "fg_scores": scores, "anchors": anchors, "rois": rois,
                    "roi_mask": roi_mask, "cls_logits": cls_logits,
                    "bbox_deltas": bbox_deltas}
        return rois, roi_mask, torch.softmax(cls_logits, dim=-1), bbox_deltas


def decode_frcnn_boxes(rois: torch.Tensor, bbox_deltas: torch.Tensor,
                       im_info) -> torch.Tensor:
    """Per-class box regression and a clip to the image: rois (…,R,4),
    bbox_deltas (…,R,C·4), im_info (…,3) rows (height, width, scale) →
    (…,R,C·4) pixel boxes, the layout :func:`frcnn_postprocess` takes."""
    R = rois.shape[-2]
    deltas = bbox_deltas.reshape(*bbox_deltas.shape[:-1], -1, 4)
    info = torch.as_tensor(im_info, dtype=torch.float32, device=rois.device)
    boxes = clip_boxes(bbox_transform_inv(rois[..., None, :], deltas),
                       (info[..., 0] - 1.0)[..., None, None],
                       (info[..., 1] - 1.0)[..., None, None])   # (…,R,C,4)
    return boxes.reshape(*boxes.shape[:-3], R, -1)


class FasterRcnnDetector(nn.Module):
    """Faster-RCNN with its post-processing: NHWC pixels and ``im_info``
    → padded ``(B, max_per_image, 6)`` detections ``(class, score, x1,
    y1, x2, y2)`` in the input's pixels."""

    def __init__(self, param: FrcnnParam = FrcnnParam(),
                 post: FrcnnPostParam = FrcnnPostParam(), *, device=None,
                 seed: int = 0):
        super().__init__()
        self.frcnn = FasterRcnnVgg(param, device=device, seed=seed)
        self.param = param
        self.post = dataclasses.replace(post, n_classes=param.num_classes)

    def forward(self, x: torch.Tensor, im_info) -> torch.Tensor:
        info = torch.as_tensor(im_info, dtype=torch.float32, device=x.device)
        rois, roi_mask, cls_probs, bbox_deltas = self.frcnn(x, info)
        cls_probs = cls_probs * roi_mask[..., None]     # padded ROIs score 0
        return frcnn_postprocess(
            cls_probs, decode_frcnn_boxes(rois, bbox_deltas, info),
            self.post)


def frcnn_vgg_rename():
    """Caffe py-faster-rcnn layer names → this module's names
    (``rpn_conv/3x3`` becomes ``rpn_conv_3x3``; everything else maps
    1:1).  Use with ``utils.caffe.load_caffe_weights``."""
    mapping = {"rpn_conv/3x3/weight": "rpn_conv_3x3/weight",
               "rpn_conv/3x3/bias": "rpn_conv_3x3/bias"}

    def rename(key: str) -> str:
        return mapping.get(key, key)

    return rename

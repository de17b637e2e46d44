"""SSD-VGG object detector in PyTorch (counterpart of ``models/ssd.py``).

The public input is NHWC ``(B, H, W, 3)``, as in the reference; inside,
convolutions run NCHW.  The head outputs are flattened in the reference's
NHWC order (``permute(0, 2, 3, 1)`` before the reshape), so ``(loc, conf)``
line up prior for prior with the priors of :func:`build_priors`.

Layer names follow the reference's flax names (``vgg.conv1_1``,
``extra.conv6_1``, ``conv4_3_norm.cmul``, ``loc_0``, ``conf_0`` …), so
``utils.convert.ssd_params_from_jax`` maps a flax params tree onto the
``state_dict`` key for key.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.core.layers import NormalizeScale
from analytics_zoo_tpu_torch.ops.detection_output import (
    DetectionOutputParam, detection_output)
from analytics_zoo_tpu_torch.ops.priorbox import (PriorBoxParam,
                                                  concat_priors, prior_box)
from analytics_zoo_tpu_torch.utils import spmd
from analytics_zoo_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    resolution: int
    feature_shapes: Sequence[int]
    min_sizes: Sequence[float]
    max_sizes: Sequence[float]
    aspect_ratios: Sequence[Sequence[float]]
    steps: Sequence[int]


def ssd300_config(dataset: str = "pascal") -> SSDConfig:
    if dataset == "coco":
        mins = (21, 45, 99, 153, 207, 261)
        maxs = (45, 99, 153, 207, 261, 315)
    else:
        mins = (30, 60, 111, 162, 213, 264)
        maxs = (60, 111, 162, 213, 264, 315)
    return SSDConfig(
        resolution=300,
        feature_shapes=(38, 19, 10, 5, 3, 1),
        min_sizes=mins,
        max_sizes=maxs,
        aspect_ratios=((2,), (2, 3), (2, 3), (2, 3), (2,), (2,)),
        steps=(8, 16, 32, 64, 100, 300),
    )


def ssd512_config(dataset: str = "pascal") -> SSDConfig:
    if dataset == "coco":
        mins = (20.48, 51.2, 133.12, 215.04, 296.96, 378.88, 460.8)
        maxs = (51.2, 133.12, 215.04, 296.96, 378.88, 460.8, 542.72)
    else:
        mins = (35.84, 76.8, 153.6, 230.4, 307.2, 384.0, 460.8)
        maxs = (76.8, 153.6, 230.4, 307.2, 384.0, 460.8, 537.6)
    return SSDConfig(
        resolution=512,
        feature_shapes=(64, 32, 16, 8, 4, 2, 1),
        min_sizes=mins,
        max_sizes=maxs,
        aspect_ratios=((2,), (2, 3), (2, 3), (2, 3), (2, 3), (2,), (2,)),
        steps=(8, 16, 32, 64, 128, 256, 512),
    )


def config_for(resolution: int, dataset: str = "pascal") -> SSDConfig:
    return (ssd300_config(dataset) if resolution == 300
            else ssd512_config(dataset))


def _cell_param(config: SSDConfig, i: int) -> PriorBoxParam:
    return PriorBoxParam(min_sizes=[config.min_sizes[i]],
                         max_sizes=[config.max_sizes[i]],
                         aspect_ratios=list(config.aspect_ratios[i]),
                         flip=True, clip=False, step=config.steps[i])


def build_priors(config: SSDConfig) -> Tuple[np.ndarray, np.ndarray]:
    """(P,4) priors + (P,4) variances for the whole model."""
    return concat_priors([
        prior_box((fs, fs), (config.resolution, config.resolution),
                  _cell_param(config, i))
        for i, fs in enumerate(config.feature_shapes)])


def num_priors_per_cell(config: SSDConfig) -> List[int]:
    return [_cell_param(config, i).num_priors
            for i in range(len(config.feature_shapes))]


# (name, in, out, kernel, stride, pad, dilation)
_VGG = (
    ("conv1_1", 3, 64, 3, 1, 1, 1), ("conv1_2", 64, 64, 3, 1, 1, 1),
    ("conv2_1", 64, 128, 3, 1, 1, 1), ("conv2_2", 128, 128, 3, 1, 1, 1),
    ("conv3_1", 128, 256, 3, 1, 1, 1), ("conv3_2", 256, 256, 3, 1, 1, 1),
    ("conv3_3", 256, 256, 3, 1, 1, 1),
    ("conv4_1", 256, 512, 3, 1, 1, 1), ("conv4_2", 512, 512, 3, 1, 1, 1),
    ("conv4_3", 512, 512, 3, 1, 1, 1),
    ("conv5_1", 512, 512, 3, 1, 1, 1), ("conv5_2", 512, 512, 3, 1, 1, 1),
    ("conv5_3", 512, 512, 3, 1, 1, 1),
    ("fc6", 512, 1024, 3, 1, 6, 6), ("fc7", 1024, 1024, 1, 1, 0, 1),
)
_EXTRA_COMMON = (
    ("conv6_1", 1024, 256, 1, 1, 0, 1), ("conv6_2", 256, 512, 3, 2, 1, 1),
    ("conv7_1", 512, 128, 1, 1, 0, 1), ("conv7_2", 128, 256, 3, 2, 1, 1),
    ("conv8_1", 256, 128, 1, 1, 0, 1),
)
_EXTRA_300 = (
    ("conv8_2", 128, 256, 3, 1, 0, 1), ("conv9_1", 256, 128, 1, 1, 0, 1),
    ("conv9_2", 128, 256, 3, 1, 0, 1),
)
_EXTRA_512 = (
    ("conv8_2", 128, 256, 3, 2, 1, 1), ("conv9_1", 256, 128, 1, 1, 0, 1),
    ("conv9_2", 128, 256, 3, 2, 1, 1), ("conv10_1", 256, 128, 1, 1, 0, 1),
    ("conv10_2", 128, 256, 4, 1, 1, 1),
)
# which extra convs emit a source feature map
_EXTRA_SOURCES = ("conv6_2", "conv7_2", "conv8_2", "conv9_2", "conv10_2")


def _add_convs(module: nn.Module, spec) -> None:
    for name, cin, cout, k, s, p, d in spec:
        module.add_module(name, nn.Conv2d(cin, cout, k, stride=s, padding=p,
                                          dilation=d))


# the trunk, read by VGGBase.forward and spatial_forward: a conv (ReLU
# after it), a max pool (kernel, stride, padding, ceil mode), or the
# conv4_3 source.  Caffe's pool3 is ceil mode (75 → 38: the reference
# pads (0, 1) with -inf, which is what ceil mode does); pool5 is 3x3,
# stride 1, padding 1.
_TRUNK = ("conv1_1", "conv1_2", (2, 2, 0, False), "conv2_1", "conv2_2",
          (2, 2, 0, False), "conv3_1", "conv3_2", "conv3_3", (2, 2, 0, True),
          "conv4_1", "conv4_2", "conv4_3", "source", (2, 2, 0, False),
          "conv5_1", "conv5_2", "conv5_3", (3, 1, 1, False), "fc6", "fc7")


class VGGBase(nn.Module):
    """VGG16 trunk through conv5_3 + dilated fc6/fc7.  Returns (conv4_3,
    fc7) feature maps."""

    def __init__(self):
        super().__init__()
        _add_convs(self, _VGG)

    def forward(self, x):
        for op in _TRUNK:
            if op == "source":
                conv4_3 = x
            elif isinstance(op, tuple):
                k, stride, pad, ceil = op
                x = F.max_pool2d(x, k, stride, pad, ceil_mode=ceil)
            else:
                x = F.relu(getattr(self, op)(x))
        return conv4_3, x


class ExtraLayers(nn.Module):
    """conv6_1 … conv9_2 (… conv10_2 for 512) extra feature stages."""

    def __init__(self, resolution: int = 300):
        super().__init__()
        self.spec = _EXTRA_COMMON + (_EXTRA_300 if resolution == 300
                                     else _EXTRA_512)
        _add_convs(self, self.spec)

    def forward(self, x):
        feats = []
        for name, *_ in self.spec:
            x = F.relu(getattr(self, name)(x))
            if name in _EXTRA_SOURCES:
                feats.append(x)
        return feats


def _source_channels(resolution: int) -> List[int]:
    return [512, 1024, 512, 256, 256, 256] + (
        [] if resolution == 300 else [256])


def add_multibox_heads(module: nn.Module, channels: Sequence[int],
                       priors_per_cell: Sequence[int],
                       num_classes: int) -> None:
    """``loc_i``/``conf_i`` 3 × 3 convolutions over each source."""
    for i, (ch, k) in enumerate(zip(channels, priors_per_cell)):
        module.add_module(f"loc_{i}", nn.Conv2d(ch, k * 4, 3, padding=1))
        module.add_module(f"conf_{i}",
                          nn.Conv2d(ch, k * num_classes, 3, padding=1))


def multibox_heads(module: nn.Module, sources: Sequence[torch.Tensor],
                   num_classes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The heads over the NCHW sources, each flattened in NHWC order, as
    the reference's heads, and joined (the reference's
    ConcatTable/JoinTable, ``SSD.scala:196,213``): (loc (B, P, 4), conf
    (B, P, C))."""
    B = sources[0].shape[0]
    locs, confs = [], []
    for i, src in enumerate(sources):
        loc = getattr(module, f"loc_{i}")(src).permute(0, 2, 3, 1)
        conf = getattr(module, f"conf_{i}")(src).permute(0, 2, 3, 1)
        locs.append(loc.reshape(B, -1, 4))
        confs.append(conf.reshape(B, -1, num_classes))
    return torch.cat(locs, dim=1), torch.cat(confs, dim=1)


class SSDVgg(nn.Module):
    """SSD300/512-VGG16: NHWC images → raw ``(loc (B,P,4), conf (B,P,C))``.

    Built on ``device`` (the GPU unless ``device="cpu"``) with weights
    drawn from ``torch.Generator().manual_seed(seed)``: LeCun-normal
    kernels, zero biases, the conv4_3 scale at 20."""

    def __init__(self, num_classes: int = 21, resolution: int = 300,
                 dataset: str = "pascal", *, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        if resolution not in (300, 512):
            raise ValueError(f"resolution must be 300 or 512, got {resolution}")
        self.num_classes = num_classes
        self.resolution = resolution
        self.dataset = dataset
        self.vgg = VGGBase()
        self.extra = ExtraLayers(resolution)
        self.conv4_3_norm = NormalizeScale(512, scale=20.0)
        add_multibox_heads(self, _source_channels(resolution),
                           num_priors_per_cell(self.config), num_classes)
        self._init_weights(seed)
        self.to(dev)
        self.eval()

    @property
    def config(self) -> SSDConfig:
        return config_for(self.resolution, self.dataset)

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * fan_in ** -0.5)
                m.bias.zero_()

    def forward(self, x: torch.Tensor):
        group = spmd.row_group()
        if group is not None:
            return spatial_forward(self, x, group)
        x = x.permute(0, 3, 1, 2)
        conv4_3, fc7 = self.vgg(x)
        sources = [self.conv4_3_norm(conv4_3), fc7] + self.extra(fc7)
        return multibox_heads(self, sources, self.num_classes)


class _RowBlocks:
    """An NCHW activation cut by rows over a group: this rank's block
    ``t`` of a ``height``-row map whose ranks hold ``parts``."""

    def __init__(self, t, parts, height, group):
        self.t, self.parts, self.height, self.group = t, parts, height, group

    def layer(self, fn, k: int, s: int, p: int, d: int = 1,
              ceil: bool = False, fill: float = 0.0) -> "_RowBlocks":
        """``fn`` (a conv or a pool with no padding along H) on the rows
        that this rank's output block needs, fetched from their owners
        (``fill`` past the image's edges).  The output's rows are
        ``row_blocks`` of its height.  An empty output block runs ``fn``
        on ``fill`` rows and keeps none, so that every rank's autograd
        graph holds the same operations."""
        from analytics_zoo_tpu_torch.parallel.sequence import (
            fetch_rows, group_rank, row_blocks)

        span = d * (k - 1) + 1
        h = self.height + 2 * p - span
        out_h = (-(-h // s) if ceil else h // s) + 1
        if ceil and (out_h - 1) * s >= self.height + p:
            out_h -= 1
        out = row_blocks(out_h, len(self.parts))
        wants = [(a * s - p, (b - 1) * s - p + span) if b > a else (0, 0)
                 for a, b in out]
        x = fetch_rows(self.t, self.group, self.parts, wants, fill)
        a, b = out[group_rank(self.group)]
        short = list(x.shape)
        short[2] = span - x.shape[2] if b == a else 0
        x = torch.cat([x, x.new_full(short, fill)], 2)
        return _RowBlocks(fn(x).narrow(2, 0, b - a), out, out_h, self.group)

    def conv(self, conv: nn.Conv2d, relu: bool = True) -> "_RowBlocks":
        (k, _), (s, sw), (p, pw), (d, dw) = (conv.kernel_size, conv.stride,
                                             conv.padding, conv.dilation)

        def fn(x):
            y = F.conv2d(x, conv.weight, conv.bias, (s, sw), (0, pw),
                         (d, dw))
            return F.relu(y) if relu else y

        return self.layer(fn, k, s, p, d)

    def pool(self, k: int, s: int, p: int, ceil: bool) -> "_RowBlocks":
        return self.layer(lambda x: F.max_pool2d(x, k, s, (0, p),
                                                 ceil_mode=ceil),
                          k, s, p, ceil=ceil, fill=float("-inf"))

    def whole(self) -> torch.Tensor:
        """The whole map on every rank, rows in the global order."""
        from analytics_zoo_tpu_torch.parallel.sequence import gather_rows
        return gather_rows(self.t, self.group, self.parts, 2)


def spatial_forward(model: "SSDVgg", x: torch.Tensor, group
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:class:`SSDVgg`'s forward on this rank's block of the image rows
    (``x`` NHWC, rows ``row_blocks(resolution, n)[rank]`` of the
    ``group``'s ``n`` ranks), weights whole on every rank: each conv and
    pool fetches the input rows its output rows need (its kernel,
    stride, padding and dilation decide which; zeros, or ``-inf`` under
    a pool, past the edges) and runs with no padding along H; the
    heads' outputs are gathered along H and flattened as the unsharded
    forward flattens them.  Returns the whole ``(loc, conf)`` on every
    rank; a rank's parameter gradients are its rows' share (the step
    sums them over ``group``)."""
    from analytics_zoo_tpu_torch.parallel.sequence import (group_rank,
                                                           group_size,
                                                           row_blocks)

    parts = row_blocks(model.resolution, group_size(group))
    a, b = parts[group_rank(group)]
    if x.shape[1] != b - a:
        raise ValueError(f"spatial forward: rows {a}..{b} of "
                         f"{model.resolution} expected on this rank, got "
                         f"{x.shape[1]}")
    rows = _RowBlocks(x.permute(0, 3, 1, 2), parts, model.resolution, group)
    sources = []
    for op in _TRUNK:
        if op == "source":
            sources.append(_RowBlocks(model.conv4_3_norm(rows.t), rows.parts,
                                      rows.height, group))
        elif isinstance(op, tuple):
            rows = rows.pool(*op)
        else:
            rows = rows.conv(getattr(model.vgg, op))
    sources.append(rows)
    for name, *_ in model.extra.spec:
        rows = rows.conv(getattr(model.extra, name))
        if name in _EXTRA_SOURCES:
            sources.append(rows)
    B = x.shape[0]
    locs, confs = [], []
    for i, src in enumerate(sources):
        loc = src.conv(getattr(model, f"loc_{i}"), relu=False).whole()
        conf = src.conv(getattr(model, f"conf_{i}"), relu=False).whole()
        locs.append(loc.permute(0, 2, 3, 1).reshape(B, -1, 4))
        confs.append(conf.permute(0, 2, 3, 1).reshape(B, -1,
                                                      model.num_classes))
    return torch.cat(locs, dim=1), torch.cat(confs, dim=1)


def build_ssd_vgg(num_classes: int = 21, resolution: int = 300,
                  dataset: str = "pascal", *, device=None,
                  seed: int = 0) -> SSDVgg:
    """A seeded, randomly initialised :class:`SSDVgg` in eval mode."""
    return SSDVgg(num_classes, resolution, dataset, device=device, seed=seed)


class SSDDetector(nn.Module):
    """SSD + DetectionOutput: NHWC images → (B, keep_topk, 6) detections
    (the reference runs DetectionOutput as the model's top layer)."""

    def __init__(self, num_classes: int = 21, resolution: int = 300,
                 dataset: str = "pascal",
                 post: Optional[DetectionOutputParam] = None, *,
                 device=None, seed: int = 0):
        super().__init__()
        self.ssd = SSDVgg(num_classes, resolution, dataset, device=device,
                          seed=seed)
        self.post = dataclasses.replace(post or DetectionOutputParam(),
                                        n_classes=num_classes)
        priors, variances = build_priors(self.ssd.config)
        dev = next(self.ssd.parameters()).device
        self.register_buffer("priors", torch.as_tensor(priors, device=dev))
        self.register_buffer("variances",
                             torch.as_tensor(variances, device=dev))

    def forward(self, x):
        loc, conf = self.ssd(x)
        probs = torch.softmax(conf, dim=-1)
        return detection_output(loc, probs, self.priors, self.variances,
                                self.post)

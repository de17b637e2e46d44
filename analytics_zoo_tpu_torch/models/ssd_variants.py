"""SSD backbone variants, AlexNet and MobileNet (counterpart of
``models/ssd_variants.py``).

As ``models/ssd.py``: NHWC images in, NCHW convolutions inside, the
multibox heads flattened in NHWC order, so ``(loc (B, P, 4), conf
(B, P, C))`` line up with the variant's priors (``build_priors(model.
config)``), which ``SSDPredictor`` takes from the model.  Layer names are
the reference's (``conv1`` … ``conv8_2``; ``conv0``, ``ds1.dw``,
``ds1.pw`` …; ``loc_i``, ``conf_i``), so a flax tree bridges by
``utils.convert.ssd_alexnet_params_from_jax`` /
``ssd_mobilenet_params_from_jax``.  Weights are drawn from
``torch.Generator().manual_seed(seed)``: LeCun-normal kernels and zero
biases, flax's defaults.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.core.layers import lecun_normal_
from analytics_zoo_tpu_torch.models.ssd import (SSDConfig, add_multibox_heads,
                                                multibox_heads,
                                                num_priors_per_cell)
from analytics_zoo_tpu_torch.utils.device import resolve_device


def alexnet_ssd_config() -> SSDConfig:
    """AlexNet-SSD300: conv5 (18²) + 3 extra stages + a global head."""
    return SSDConfig(
        resolution=300,
        feature_shapes=(18, 9, 5, 3, 1),
        min_sizes=(30, 78, 126, 174, 222),
        max_sizes=(78, 126, 174, 222, 270),
        aspect_ratios=((2,), (2, 3), (2, 3), (2,), (2,)),
        steps=(17, 34, 60, 100, 300),
    )


def mobilenet_ssd_config() -> SSDConfig:
    """MobileNet-SSD300 (chuanqi305-style scales)."""
    return SSDConfig(
        resolution=300,
        feature_shapes=(19, 10, 5, 3, 2, 1),
        min_sizes=(60, 105, 150, 195, 240, 285),
        max_sizes=(105, 150, 195, 240, 285, 330),
        aspect_ratios=((2,), (2, 3), (2, 3), (2, 3), (2, 3), (2, 3)),
        steps=(16, 30, 60, 100, 150, 300),
    )


def _conv(cin: int, cout: int, k: int = 3, s: int = 1, p: int = 1,
          groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=s, padding=p, groups=groups)


@torch.no_grad()
def _init_weights(module: nn.Module, seed: int) -> None:
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            lecun_normal_(m.weight, m.weight[0].numel(), generator=gen)
            m.bias.zero_()


def _pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """flax ``max_pool((3, 3), (2, 2), padding=((0, 1), (0, 1)))``: one
    -inf row and column after the map."""
    return F.max_pool2d(F.pad(x, (0, 1, 0, 1), value=float("-inf")), 3, 2)


class SSDAlexNet(nn.Module):
    """AlexNet-backbone SSD300 (reference ``SSDAlexNet.scala``): NHWC
    images → ``(loc, conf)``."""

    _TRUNK = (("conv1", 3, 64, 11, 4, 5), ("conv2", 64, 192, 5, 1, 2),
              ("conv3", 192, 384, 3, 1, 1), ("conv4", 384, 256, 3, 1, 1),
              ("conv5", 256, 256, 3, 1, 1), ("conv6_1", 256, 512, 1, 1, 0),
              ("conv6_2", 512, 512, 3, 2, 1), ("conv7_1", 512, 128, 1, 1, 0),
              ("conv7_2", 128, 256, 3, 2, 1), ("conv8_1", 256, 128, 1, 1, 0),
              ("conv8_2", 128, 256, 3, 1, 0))

    def __init__(self, num_classes: int = 21, *, device=None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        for name, cin, cout, k, s, p in self._TRUNK:
            self.add_module(name, _conv(cin, cout, k, s, p))
        add_multibox_heads(self, (256, 512, 256, 256, 256),
                           num_priors_per_cell(self.config), num_classes)
        _init_weights(self, seed)
        self.to(dev)
        self.eval()

    @property
    def config(self) -> SSDConfig:
        return alexnet_ssd_config()

    def forward(self, x: torch.Tensor):
        def conv(x, name):
            return F.relu(getattr(self, name)(x))

        x = _pool_3x3_s2(conv(x.permute(0, 3, 1, 2), "conv1"))    # 37
        x = _pool_3x3_s2(conv(x, "conv2"))                       # 18
        for name in ("conv3", "conv4", "conv5"):
            x = conv(x, name)
        sources: List[torch.Tensor] = [x]                        # 18
        for stage in ("conv6", "conv7", "conv8"):                # 9, 5, 3
            x = conv(conv(x, f"{stage}_1"), f"{stage}_2")
            sources.append(x)
        sources.append(x.mean(dim=(2, 3), keepdim=True))         # pool6: 1
        return multibox_heads(self, sources, self.num_classes)


class _DWSeparable(nn.Module):
    """Depthwise-separable block (the MobileNet unit): a 3 × 3 depthwise
    convolution (``groups=in_ch``), ReLU, a 1 × 1 convolution, ReLU."""

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.dw = _conv(in_ch, in_ch, 3, stride, 1, groups=in_ch)
        self.pw = _conv(in_ch, features, 1, 1, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.pw(F.relu(self.dw(x))))


class SSDMobileNet(nn.Module):
    """MobileNet-backbone SSD300 (the reference model zoo's
    MobileNet-300-VOC entry): NHWC images → ``(loc, conf)``."""

    def __init__(self, num_classes: int = 21, width_mult: float = 1.0, *,
                 device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.width_mult = width_mult

        def w(f):
            return max(int(f * width_mult), 8)

        self.conv0 = _conv(3, w(32), 3, 2, 1)                            # 150
        blocks = [("ds1", w(64), 1), ("ds2", w(128), 2), ("ds3", w(128), 1),
                  ("ds4", w(256), 2), ("ds5", w(256), 1), ("ds6", w(512), 2)]
        blocks += [(f"ds7_{i}", w(512), 1) for i in range(5)]
        blocks += [("ds12", w(1024), 2), ("ds13", w(1024), 1)]
        self._blocks = [name for name, *_ in blocks]
        cin = w(32)
        for name, f, s in blocks:
            self.add_module(name, _DWSeparable(cin, f, s))
            cin = f
        self._extras = (("conv14", 256, 512), ("conv15", 128, 256),
                        ("conv16", 128, 256), ("conv17", 64, 128))
        for name, f1, f2 in self._extras:
            self.add_module(f"{name}_1", _conv(cin, f1, 1, 1, 0))
            self.add_module(f"{name}_2", _conv(f1, f2, 3, 2, 1))
            cin = f2
        add_multibox_heads(self, (w(512), w(1024), 512, 256, 256, 128),
                           num_priors_per_cell(self.config), num_classes)
        _init_weights(self, seed)
        self.to(dev)
        self.eval()

    @property
    def config(self) -> SSDConfig:
        return mobilenet_ssd_config()

    def forward(self, x: torch.Tensor):
        x = F.relu(self.conv0(x.permute(0, 3, 1, 2)))
        sources: List[torch.Tensor] = []
        for name in self._blocks:
            x = getattr(self, name)(x)
            if name in ("ds7_4", "ds13"):                  # 19, 10
                sources.append(x)
        for name, *_ in self._extras:                      # 5, 3, 2, 1
            x = F.relu(getattr(self, f"{name}_1")(x))
            x = F.relu(getattr(self, f"{name}_2")(x))
            sources.append(x)
        return multibox_heads(self, sources, self.num_classes)

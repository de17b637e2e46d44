"""Device policy, kernel build, weight import (the flax bridges and the
Caffe importer with its wire-format codec) for the port."""

from analytics_zoo_tpu_torch.utils import caffe, protowire
from analytics_zoo_tpu_torch.utils.device import resolve_device

__all__ = ["caffe", "protowire", "resolve_device"]

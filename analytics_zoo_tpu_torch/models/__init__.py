"""Models of the port."""

from analytics_zoo_tpu_torch.models.ssd import (
    SSDConfig,
    SSDDetector,
    SSDVgg,
    build_priors,
    build_ssd_vgg,
    num_priors_per_cell,
    ssd300_config,
    ssd512_config,
)

__all__ = [k for k in dir() if not k.startswith("_")]

"""Device policy, kernel build and weight import for the port."""

from analytics_zoo_tpu_torch.utils.device import resolve_device

__all__ = ["resolve_device"]

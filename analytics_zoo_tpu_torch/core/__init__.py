"""Layers of the port (PyTorch ``nn.Module``s)."""

from analytics_zoo_tpu_torch.core.layers import CMul, Normalize, NormalizeScale

__all__ = ["CMul", "Normalize", "NormalizeScale"]

"""Pipelines of the port; only SSD serving so far."""

from analytics_zoo_tpu_torch.pipelines.ssd import (PreProcessParam,
                                                   SSDPredictor,
                                                   run_serving_loop)

__all__ = ["PreProcessParam", "SSDPredictor", "run_serving_loop"]

"""Pipelines of the port: SSD and DeepSpeech2 serving."""

from analytics_zoo_tpu_torch.pipelines.deepspeech2 import (DS2Param,
                                                           DeepSpeech2Pipeline,
                                                           make_ds2_model)
from analytics_zoo_tpu_torch.pipelines.ssd import (PreProcessParam,
                                                   SSDPredictor,
                                                   run_serving_loop)

__all__ = ["DS2Param", "DeepSpeech2Pipeline", "PreProcessParam",
           "SSDPredictor", "make_ds2_model", "run_serving_loop"]

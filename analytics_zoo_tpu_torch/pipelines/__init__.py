"""Pipelines of the port: SSD serving, DeepSpeech2 serving and CTC
training."""

from analytics_zoo_tpu_torch.pipelines.deepspeech2 import (
    DS2Param, DeepSpeech2Pipeline, ds2_ctc_criterion, ds2_padding_metric,
    load_asr_train_set, make_ds2_model, train_ds2)
from analytics_zoo_tpu_torch.pipelines.ssd import (PreProcessParam,
                                                   SSDPredictor,
                                                   run_serving_loop)

__all__ = ["DS2Param", "DeepSpeech2Pipeline", "PreProcessParam",
           "SSDPredictor", "ds2_ctc_criterion", "ds2_padding_metric",
           "load_asr_train_set", "make_ds2_model", "run_serving_loop",
           "train_ds2"]

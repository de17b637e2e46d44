"""Pipelines of the port: SSD serving, validation and training,
DeepSpeech2 serving and CTC training, and detection evaluation."""

from analytics_zoo_tpu_torch.pipelines.deepspeech2 import (
    DS2Param, DeepSpeech2Pipeline, ds2_ctc_criterion, ds2_padding_metric,
    load_asr_train_set, make_ds2_model, train_ds2)
from analytics_zoo_tpu_torch.pipelines.evaluation import (
    CocoMeanAveragePrecision, DetectionResult, MeanAveragePrecision,
    PascalVocEvaluator)
from analytics_zoo_tpu_torch.pipelines.ssd import (PreProcessParam,
                                                   SSDMeanAveragePrecision,
                                                   SSDPredictor, TrainParams,
                                                   Validator,
                                                   run_serving_loop,
                                                   train_ssd)

__all__ = ["CocoMeanAveragePrecision", "DS2Param", "DeepSpeech2Pipeline",
           "DetectionResult", "MeanAveragePrecision", "PascalVocEvaluator",
           "PreProcessParam", "SSDMeanAveragePrecision", "SSDPredictor",
           "TrainParams", "Validator", "ds2_ctc_criterion",
           "ds2_padding_metric", "load_asr_train_set", "make_ds2_model",
           "run_serving_loop", "train_ds2", "train_ssd"]

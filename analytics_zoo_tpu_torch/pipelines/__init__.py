"""Pipelines of the port: the SSD input path, serving (with its
``ServingRuntime`` rungs), validation and training, DeepSpeech2
serving and CTC training, detection evaluation and the VOC/COCO
readers."""

from analytics_zoo_tpu_torch.pipelines.deepspeech2 import (
    DS2Param, DeepSpeech2Pipeline, ds2_ctc_criterion, ds2_padding_metric,
    load_asr_train_set, make_ds2_model, train_ds2)
from analytics_zoo_tpu_torch.pipelines.evaluation import (
    CocoMeanAveragePrecision, DetectionResult, MeanAveragePrecision,
    PascalVocEvaluator)
from analytics_zoo_tpu_torch.pipelines.ssd import (
    PreProcessParam, RecordToFeature, RoiImageToBatch,
    SSDMeanAveragePrecision, SSDPredictor, TrainParams, Uint8ToBatch,
    Validator, load_train_set, load_train_set_device, load_val_set,
    run_serving_loop, serving_chain, ssd_serving_tiers, train_ssd,
    train_transformer, val_transformer)
from analytics_zoo_tpu_torch.pipelines.voc import (VOC_CLASSES, Coco,
                                                   PascalVoc, get_imdb,
                                                   parse_voc_annotation,
                                                   to_ssd_records)

__all__ = [k for k in dir() if not k.startswith("_")]

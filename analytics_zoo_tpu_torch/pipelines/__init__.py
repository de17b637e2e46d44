"""Pipelines of the port: the SSD input path, serving (with its
``ServingRuntime`` rungs), validation and training, Faster-RCNN serving
(with its rungs) and training, DeepSpeech2 transcription, online and
streaming serving and CTC training, detection evaluation and the VOC/COCO
readers, the column pipelines, and fraud detection, recommendation and
sentiment analysis with their rungs.  ``pipelines.visualizer`` imports
cv2 and is not imported here."""

from analytics_zoo_tpu_torch.pipelines.deepspeech2 import (
    DS2Param, DeepSpeech2Pipeline, StreamingDS2, ds2_ctc_criterion,
    ds2_padding_metric, ds2_serving_tiers, ds2_streaming_tiers,
    load_asr_train_set, make_ds2_model, train_ds2)
from analytics_zoo_tpu_torch.pipelines.evaluation import (
    CocoMeanAveragePrecision, DetectionResult, MeanAveragePrecision,
    PascalVocEvaluator)
from analytics_zoo_tpu_torch.pipelines.frame import (
    Bagging, Frame, FramePipeline, FuncTransformer, Stage, StandardScaler,
    StratifiedSampler, VectorAssembler, time_ordered_split)
from analytics_zoo_tpu_torch.pipelines.fraud import (
    FraudResult, MLPClassifier, auprc, fraud_serving_tiers, precision_recall,
    run_fraud_pipeline)
from analytics_zoo_tpu_torch.pipelines.recommendation import (
    make_ncf_model, make_wide_deep_model, predict_ratings, rating_batches,
    rec_serving_tiers, train_recommender)
from analytics_zoo_tpu_torch.pipelines.sentiment import (
    make_sentiment_model, review_batches, sentiment_serving_tiers,
    train_sentiment)
from analytics_zoo_tpu_torch.pipelines.frcnn import (
    FRCNN_BGR_MEANS, FrcnnPredictor, frcnn_forward_fn, frcnn_serving_tiers,
    frcnn_train_batches, train_frcnn)
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

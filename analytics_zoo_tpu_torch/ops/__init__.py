"""Ops on tensors: PriorBox, box math, NMS, DetectionOutput,
MultiBoxLoss, the Faster-RCNN anchors, proposal, ROI pooling,
post-processing and training targets and losses, the embedding lookups
(dedup'd, naive, one-hot) and their sparse gradient, and the kernels K1
(``pallas_nms``), K2 (``pallas_detout``), K3 and K4 (``pallas_rnn``)."""

from analytics_zoo_tpu_torch.ops import bbox
from analytics_zoo_tpu_torch.ops.anchor import (generate_base_anchors,
                                                shift_anchors)
from analytics_zoo_tpu_torch.ops.detection_output import (
    DetectionOutputParam,
    detection_output,
    detection_output_single,
    scale_detections,
)
from analytics_zoo_tpu_torch.ops.embedding import (
    LOOKUP_MODES, DedupEmbed, SparseRows, dedup_lookup, embedding_grad_rows,
    lookup_stats, naive_lookup, onehot_lookup, publish_lookup_stats,
    sharded_embedding_lookup, sparse_rows_to_dense)
from analytics_zoo_tpu_torch.ops.frcnn import (FrcnnPostParam,
                                               frcnn_postprocess)
from analytics_zoo_tpu_torch.ops.frcnn_train import (FrcnnLossParam,
                                                     frcnn_training_loss,
                                                     head_targets,
                                                     rpn_targets)
from analytics_zoo_tpu_torch.ops.multibox_loss import (MultiBoxLoss,
                                                       MultiBoxLossParam,
                                                       match_priors)
from analytics_zoo_tpu_torch.ops.nms import nms
from analytics_zoo_tpu_torch.ops.pallas_detout import fused_detection_output
from analytics_zoo_tpu_torch.ops.pallas_nms import nms_sweep
from analytics_zoo_tpu_torch.ops.pallas_rnn import (persistent_rnn,
                                                    persistent_rnn_bwd)
from analytics_zoo_tpu_torch.ops.priorbox import (
    PriorBoxParam,
    concat_priors,
    prior_box,
)
from analytics_zoo_tpu_torch.ops.proposal import ProposalParam, proposal
from analytics_zoo_tpu_torch.ops.roi_pool import roi_pool, roi_pool_batch

__all__ = [k for k in dir() if not k.startswith("_")]

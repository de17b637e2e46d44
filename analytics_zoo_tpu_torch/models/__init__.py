"""Models of the port: SSD and its variants, DeepSpeech2, the attention
models, Faster-RCNN and the small families (fraud, recommendation,
sentiment)."""

from analytics_zoo_tpu_torch.models.attention import (
    AttentionASR,
    LongContextEncoder,
    MoEFeedForward,
    MultiHeadSelfAttention,
    TransformerBlock,
)
from analytics_zoo_tpu_torch.models.deepspeech2 import (
    DeepSpeech2,
    SequenceBN,
    ds2_valid_out_frames,
    sequence_parallel_forward,
)
from analytics_zoo_tpu_torch.models.faster_rcnn import (
    FasterRcnnDetector,
    FasterRcnnVgg,
    FrcnnParam,
    FrcnnVggTrunk,
    decode_frcnn_boxes,
    frcnn_vgg_rename,
)
from analytics_zoo_tpu_torch.models.simple import (
    FraudMLP,
    NeuralCF,
    SentimentNet,
    WideAndDeep,
)
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
from analytics_zoo_tpu_torch.models.ssd_variants import (
    SSDAlexNet,
    SSDMobileNet,
    alexnet_ssd_config,
    mobilenet_ssd_config,
    multibox_heads,
)

__all__ = [k for k in dir() if not k.startswith("_")]

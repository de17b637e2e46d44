"""Vision transforms (counterpart of ``transform/vision``): ImageFeature
and FeatureTransformer, the host augmentation ops, the ROI label
co-transforms, the SSD batch samplers and the device augmentation."""

from analytics_zoo_tpu_torch.transform.vision.image import (
    FeatureTransformer,
    ImageFeature,
    SealForWire,
)
from analytics_zoo_tpu_torch.transform.vision.augmentation import (
    AspectScale,
    AspectScaleCanvas,
    Brightness,
    BytesToMat,
    CenterCrop,
    ChannelNormalize,
    ChannelOrder,
    ColorJitter,
    Contrast,
    Crop,
    Expand,
    Filler,
    HFlip,
    Hue,
    MatToFloats,
    PixelNormalizer,
    RandomAspectScale,
    RandomCrop,
    Resize,
    Saturation,
)
from analytics_zoo_tpu_torch.transform.vision.roi import (
    RoiCrop,
    RoiExpand,
    RoiHFlip,
    RoiLabel,
    RoiNormalize,
    jaccard_overlap,
    meet_emit_center_constraint,
    project_bbox,
)
from analytics_zoo_tpu_torch.transform.vision.sampler import (
    BatchSampler,
    RandomSampler,
    generate_batch_samples,
    standard_samplers,
)
from analytics_zoo_tpu_torch.transform.vision.device import (
    DeviceAugBatch,
    DeviceAugParam,
    DeviceAugPrepare,
    make_device_augment,
)

__all__ = [k for k in dir() if not k.startswith("_")]

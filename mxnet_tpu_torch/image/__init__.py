"""The image data pipeline: host-side decode and augmentation feeding the
card (counterpart of ``mxnet_tpu/image``).

Augmenters are numpy (and, for decode and resize, cv2 or PIL) functions
of an explicit ``numpy.random.Generator``.  ``detection`` holds the
detection iterators, which crop and mirror the boxes with the images.
"""
from .image import (
    imdecode, imread, imresize, resize_short, fixed_crop, center_crop,
    random_crop, random_size_crop, color_normalize,
    Augmenter, SequentialAug, RandomOrderAug, ResizeAug, ForceResizeAug,
    CenterCropAug, RandomCropAug, RandomSizedCropAug, HorizontalFlipAug,
    BrightnessJitterAug, ContrastJitterAug, SaturationJitterAug,
    HueJitterAug, ColorJitterAug, LightingAug, ColorNormalizeAug,
    RandomGrayAug, CastAug, CreateAugmenter,
    ImageIter,
)
from .iter import ImageRecordIterImpl, ImageRecordUInt8Iter
from .detection import (ImageDetRecordIterImpl, ImageDetRecordIter,
                        ImageDetIter, parse_det_label, pack_det_label)

__all__ = [
    "imdecode", "imread", "imresize", "resize_short", "fixed_crop",
    "center_crop", "random_crop", "random_size_crop", "color_normalize",
    "Augmenter", "SequentialAug", "RandomOrderAug", "ResizeAug",
    "ForceResizeAug", "CenterCropAug", "RandomCropAug", "RandomSizedCropAug",
    "HorizontalFlipAug", "BrightnessJitterAug", "ContrastJitterAug",
    "SaturationJitterAug", "HueJitterAug", "ColorJitterAug", "LightingAug",
    "ColorNormalizeAug", "RandomGrayAug", "CastAug", "CreateAugmenter",
    "ImageIter", "ImageRecordIterImpl", "ImageRecordUInt8Iter",
    "ImageDetRecordIterImpl", "ImageDetRecordIter", "ImageDetIter",
    "parse_det_label", "pack_det_label",
]

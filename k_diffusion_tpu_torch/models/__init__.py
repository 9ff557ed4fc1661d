from . import (flops, image_transformer_v1, image_transformer_v2, image_v1,
               inception_v3)
from .image_transformer_v1 import ImageTransformerDenoiserModelV1
from .image_transformer_v2 import ImageTransformerDenoiserModelV2
from .image_v1 import ImageDenoiserModelV1

__all__ = ["flops", "image_transformer_v1", "image_transformer_v2",
           "image_v1", "inception_v3", "ImageTransformerDenoiserModelV1",
           "ImageTransformerDenoiserModelV2", "ImageDenoiserModelV1"]

from . import flops, image_transformer_v2
from .image_transformer_v2 import ImageTransformerDenoiserModelV2

__all__ = ["flops", "image_transformer_v2", "ImageTransformerDenoiserModelV2"]

"""The augment wrapper of the U-Net (counterpart of
``augment_wrapper_model_fn`` in k_diffusion_tpu/augmentation.py). The
augmentation pipeline itself comes with the port of data loading."""

import torch


def augment_wrapper_model_fn(inner_model):
    """Adapts a ``mapping_cond`` model (the U-Net) to take ``aug_cond`` (b,
    9) by packing it into ``mapping_cond``: zeros when ``aug_cond`` is not
    given, placed before any ``mapping_cond`` of the caller."""

    def model_fn(x, sigma, aug_cond=None, mapping_cond=None, **kwargs):
        if aug_cond is None:
            aug_cond = torch.zeros((x.shape[0], 9), dtype=x.dtype,
                                   device=x.device)
        if mapping_cond is None:
            mapping_cond = aug_cond
        else:
            mapping_cond = torch.cat([aug_cond, mapping_cond], dim=1)
        return inner_model(x, sigma, mapping_cond=mapping_cond, **kwargs)

    return model_fn

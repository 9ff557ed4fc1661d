"""EMA parameter averaging (counterpart of k_diffusion_tpu/utils/ema.py).

The JAX package returns a new tree; here the average is updated in place
with one multi-tensor pass over the parameter list, which is what the
reference does with ``lerp_``."""

import torch


@torch.no_grad()
def ema_update(params, averaged_params, decay):
    """``averaged += (1 - decay) * (params - averaged)`` in place, over two
    equally long lists of tensors."""
    params, averaged_params = list(params), list(averaged_params)
    if len(params) != len(averaged_params):
        raise ValueError(f"{len(params)} params but {len(averaged_params)} "
                         "averages")
    torch._foreach_lerp_(averaged_params, params, 1.0 - decay)



def ema_update_dict(values, updates, decay):
    """The host-side EMA of a dict of Python floats, in place: a new key
    takes its value."""
    for k, v in updates.items():
        if k not in values:
            values[k] = v
        else:
            values[k] *= decay
            values[k] += (1 - decay) * v
    return values

"""Array helpers (counterpart of k_diffusion_tpu/utils/array.py)."""


def append_dims(x, target_dims):
    """Appends singleton dims to the end of a tensor until it has
    ``target_dims`` dims."""
    dims_to_append = target_dims - x.ndim
    if dims_to_append < 0:
        raise ValueError(
            f"input has {x.ndim} dims but target_dims is {target_dims}, "
            "which is less")
    return x[(...,) + (None,) * dims_to_append]

"""Analytic FLOP count (counterpart of k_diffusion_tpu/models/flops.py,
which imports jax when it is imported). The count follows the reference
k-diffusion counter: Linear matmuls and attention only, in multiply-adds, so
one forward's FLOPs are twice ``analytic_transformer_flops``."""

import math


def op_linear(x_shape, out_features):
    """prod(input shape) * out_features (reference flops.py:40-41, where
    weight[0] is the torch Linear's out_features)."""
    return math.prod(x_shape) * out_features


def op_attention(q_shape, k_shape, v_shape):
    """prod(batch dims) * s_q * s_k * (d_q + d_v) (reference flops.py:44-48)."""
    *b, s_q, d_q = q_shape
    *_, s_k, d_k = k_shape
    *_, s_v, d_v = v_shape
    return math.prod(b) * s_q * s_k * (d_q + d_v)


def op_natten(q_shape, kernel_size):
    """prod(all but head dim) * 2*d * k^2 (reference flops.py:51-54; d_q ==
    d_v for self-attention)."""
    *q_rest, d = q_shape
    return math.prod(q_rest) * (d + d) * kernel_size ** 2


def analytic_transformer_flops(config, batch=1):
    """Analytic forward FLOPs for an image_transformer_v2 config, counting
    exactly the ops the reference's counter sees (Linear matmuls + attention;
    not norms/rope/elementwise). Returns FLOPs for a ``batch``-image forward."""
    m = config["model"]
    if m["type"] != "image_transformer_v2":
        raise ValueError("the analytic count covers image_transformer_v2")
    size = m["input_size"]
    patch = m["patch_size"]
    patch = patch if isinstance(patch, (list, tuple)) else [patch, patch]
    h = size[0] // patch[0]
    w = size[1] // patch[1]
    c_in = m["input_channels"]
    widths = m["widths"]
    depths = m["depths"]
    d_ffs = m["d_ffs"]
    self_attns = m["self_attns"]
    mw = m["mapping_width"]
    md_ff = m["mapping_d_ff"]
    total = 0

    # patch_in (TokenMerge)
    total += op_linear((batch, h, w, c_in * patch[0] * patch[1]), widths[0])
    # time/aug in_proj
    total += 2 * op_linear((batch, mw), mw)
    # mapping network: per block up (GEGLU: out 2*d_ff) + down
    for _ in range(m["mapping_depth"]):
        total += op_linear((batch, mw), md_ff * 2)
        total += op_linear((batch, md_ff), mw)

    def level_flops(width, d_ff, attn, hh, ww, n_layers, up_and_down):
        fl = 0
        n_pass = 2 if up_and_down else 1
        for _ in range(n_layers * n_pass):
            has_attn = attn["type"] != "none"
            if has_attn:
                # AdaRMSNorm mapping_linear + qkv + out projections
                fl += op_linear((batch, mw), width)
                fl += op_linear((batch, hh, ww, width), width * 3)
                fl += op_linear((batch, hh, ww, width), width)
                d_head = attn.get("d_head", 64)
                n_heads = width // d_head
                s = hh * ww
                if attn["type"] == "global":
                    fl += op_attention((batch, n_heads, s, d_head),
                                       (batch, n_heads, s, d_head),
                                       (batch, n_heads, s, d_head))
                elif attn["type"] == "neighborhood":
                    fl += op_natten((batch, hh, ww, n_heads, d_head),
                                    attn.get("kernel_size", 7))
                elif attn["type"] == "shifted-window":
                    ws = attn["window_size"]
                    nwin = (hh // ws) * (ww // ws)
                    fl += op_attention((batch, n_heads, hh // ws, ww // ws, ws * ws, d_head),
                                       (batch, n_heads, hh // ws, ww // ws, ws * ws, d_head),
                                       (batch, n_heads, hh // ws, ww // ws, ws * ws, d_head))
            # FF block: AdaRMSNorm + GEGLU up + down
            fl += op_linear((batch, mw), width)
            fl += op_linear((batch, hh, ww, width), d_ff * 2)
            fl += op_linear((batch, hh, ww, d_ff), width)
        return fl

    hh, ww = h, w
    for i in range(len(widths)):
        last = i == len(widths) - 1
        total += level_flops(widths[i], d_ffs[i], self_attns[i], hh, ww,
                             depths[i], up_and_down=not last)
        if not last:
            # merge / split projections
            total += op_linear((batch, hh // 2, ww // 2, widths[i] * 4), widths[i + 1])
            total += op_linear((batch, hh // 2, ww // 2, widths[i + 1]), widths[i] * 4)
            hh, ww = hh // 2, ww // 2

    # out head (TokenSplitWithoutSkip)
    total += op_linear((batch, h, w, widths[0]),
                       m["input_channels"] * patch[0] * patch[1])
    return total

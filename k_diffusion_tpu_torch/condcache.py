"""Precomputed conditioning for sampling the HDiT on a fixed sigma schedule
(counterpart of k_diffusion_tpu/condcache.py).

Once the schedule is fixed, everything the HDiT derives from its
conditioning is known before the loop: the mapping network's output and
every layer's AdaRMSNorm scale ``proj(cond) + 1``. ``precompute_cond_scales``
computes them once per schedule sigma into one (steps, batch, total) table,
laid out by ``image_transformer_v2.cond_scale_layout``; each scale comes
from the same product at the same shape and dtype as the layer's own, so the
table equals what the layers compute, bit for bit. ``ScheduledModel`` (the
JAX package's ``scheduled_inner_fn``) is the model with the table: a call
looks up the row of its sigma and passes it as
``cond_scales``, and the kernels K1 and K4 read each layer's (b, d) block of
the row through its row stride, with no copy. A cached call runs no mapping
network (no K5 launch) and no scale projection.

Where the JAX package snaps an off-schedule sigma to the nearest row, the
port raises: the lookup runs on the device and records a sigma with no row,
and ``ScheduledModel.check`` (which ``sample`` calls when the sampler
returns) reads that flag once and raises naming the sigma. Only samplers
that evaluate the model at schedule sigmas alone may use the cache:
``SCHEDULE_POINT_SAMPLERS``. Forward-only.
"""

import torch

from .models import image_transformer_v2 as itv2

# the samplers whose model calls all fall on the schedule's sigmas (the
# JAX package keeps this list in sample.py): no churn, no mid-interval
# stages; heun's second stage is at the next schedule sigma, and the port's
# heun takes its last step, to sigma 0, with no second call
SCHEDULE_POINT_SAMPLERS = frozenset({"lms", "euler", "euler_ancestral",
                                     "heun", "dpmpp_2m", "dpmpp_2m_sde",
                                     "dpmpp_3m_sde"})


@torch.no_grad()
def precompute_cond_scales(model, sigmas, batch, aug_cond=None,
                           class_cond=None):
    """The AdaRMSNorm scale table of a sigma schedule.

    ``model``: an ``ImageTransformerDenoiserModelV2``; ``sigmas``: the
    sigmas the sampler will evaluate the model at (for the fixed-step
    samplers the schedule without its terminal 0); ``batch``: the sampling
    batch; ``aug_cond`` (batch, 9) and ``class_cond`` (batch,), if given,
    are baked into the table. One mapping network call (one K5 launch on
    the card) per sigma, then each layer's scale product as the layer runs
    it. Returns (sigma_table (steps,) float32, scales_table (steps, batch,
    total) in the model's compute dtype), on the model's device."""
    device = model.time_in_proj.kernel.device
    sigma_table = sigmas.detach().to(device, torch.float32).reshape(-1)
    layout, total = itv2.cond_scale_layout(model.levels)
    rows = []
    for s in sigma_table.tolist():
        cond = model(None, torch.full((batch,), s, device=device),
                     aug_cond=aug_cond, class_cond=class_cond, cond_only=True)
        pieces, pos = [], 0

        def emit(piece, off):
            nonlocal pos
            if off > pos:  # alignment padding, never read
                pieces.append(piece.new_ones((batch, off - pos)))
            pieces.append(piece)
            pos = off + piece.shape[-1]

        for name, (attn_off, ff_off) in layout.items():
            layer = getattr(model, name)
            if attn_off is not None:
                # SelfAttentionBlock's site: norm(cond, compute dtype)
                emit(layer.self_attn.norm(cond, model.dtype), attn_off)
            # FeedForwardBlock's site: norm(cond, cond's dtype)
            emit(layer.ff.norm(cond, cond.dtype), ff_off)
        if total > pos:
            pieces.append(pieces[-1].new_ones((batch, total - pos)))
        if len({p.dtype for p in pieces}) != 1:
            raise ValueError("the attention and feed-forward scales differ "
                             f"in dtype ({sorted({str(p.dtype) for p in pieces})}"
                             "): no one table holds both as the layers use them")
        rows.append(torch.cat(pieces, dim=-1))
    return sigma_table, torch.stack(rows)


class ScheduledModel:
    """The HDiT with its conditioning precomputed for a schedule: call it
    as the model, ``(x, sigma) -> output``, with ``sigma`` (b,) one of the
    schedule's sigmas (as the samplers pass them); it equals ``model(x,
    sigma, aug_cond=..., class_cond=...)`` bit for bit. The row is found on
    the device, with no host read; a sigma with no row is recorded, and
    ``check`` raises for it."""

    def __init__(self, model, sigmas, batch, aug_cond=None, class_cond=None):
        self.model = model
        self.sigma_table, self.scales_table = precompute_cond_scales(
            model, sigmas, batch, aug_cond=aug_cond, class_cond=class_cond)
        # the first sigma that found no row (nan while there is none)
        self.miss = torch.full((1,), float("nan"),
                               device=self.sigma_table.device)

    def __call__(self, x, sigma):
        # index_select, not indexing with a tensor, which reads it to the
        # host
        s0 = sigma.reshape(-1)[:1].to(torch.float32)
        dist = (self.sigma_table - s0).abs()
        idx = torch.argmin(dist).reshape(1)
        hit = (dist.index_select(0, idx) == 0) & (sigma == s0).all()
        self.miss = torch.where(hit | ~torch.isnan(self.miss), self.miss, s0)
        with torch.no_grad():
            return self.model(x, sigma, cond_scales=self.scales_table
                              .index_select(0, idx)[0])

    def check(self):
        """Raises if a call was given a sigma off the schedule (one host
        read)."""
        miss = self.miss.item()
        if miss == miss:  # not nan
            raise ValueError(
                f"sigma {miss!r} is not in the schedule the cond table was "
                "made for: condcache evaluates the model at schedule sigmas "
                f"only ({', '.join(sorted(SCHEDULE_POINT_SAMPLERS))})")


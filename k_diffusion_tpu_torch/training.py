"""The training step: optimizer, train state and one step of
sample sigmas -> noise -> loss -> backward -> clip -> AdamW (or 8-bit
AdamW, or SGD) -> EMA
(counterpart of k_diffusion_tpu/training.py).

The JAX package jits one pure function of (state, batch, key); here the
step is eager PyTorch that updates the model, the optimizer and the EMA
copy in place. Draws (sigmas, noise, class dropout, dropout masks) come
from the ``torch.Generator`` passed to each step. Under data parallelism
each rank runs the step on its rows of the global batch and averages the
gradients with an explicit all-reduce (``parallel.all_mean_``), as the
JAX step's ``shard_map`` path does with ``pmean``.

Left out, and why:
- ``flatopt.py``, the JAX package's default AdamW for the flagship, packs
  every parameter into one flat vector so that XLA on a TPU issues a few
  large elementwise ops instead of one chain per leaf. It computes the same
  update as the per-leaf optax chain; here ``torch.optim.AdamW`` runs the
  same update as one multi-tensor pass (fused on CUDA).
- The folded image layout of the loss (``layout.folded_model_fn``) avoids
  TPU relayout copies and gives a bitwise-identical loss; it has no
  counterpart here.
"""

import copy
from dataclasses import dataclass

import torch

from . import config as config_mod, parallel, sampling
from .models import image_transformer_v1, image_transformer_v2, image_v1
from .optim8bit import AdamW8bit
from .utils import ema_update

GROUPS = ("wd", "no_wd", "mapping_wd", "mapping_no_wd")


@dataclass
class TrainState:
    """``step`` counts the updates made; ``optimizer`` updates ``model``'s
    parameters; ``ema_model`` holds the EMA copy (no grad, eval mode)."""
    step: int
    model: torch.nn.Module
    optimizer: "GroupedOptimizer"
    ema_model: torch.nn.Module


class GroupedOptimizer:
    """The JAX package's optimizer: global-norm clipping, then AdamW,
    8-bit AdamW or SGD over the four groups {wd, no_wd} x {lr, lr *
    mapping_lr_scale}; ``labels`` maps each parameter name to its group (a
    family whose taxonomy has two groups leaves the mapping groups empty).

    Each group's lr is ``schedule(step) * scale``, set before each update:
    optax evaluates the schedule at the count before the increment. The
    clip follows optax's ``clip_by_global_norm``: gradients are scaled by
    ``max_norm / norm`` when ``norm > max_norm`` (``clip_grad_norm_`` would
    divide by ``norm + 1e-6``).

    ``kind`` "adamw" is ``torch.optim.AdamW`` (fused on the card);
    "adam8bit" is ``optim8bit.AdamW8bit``; "sgd" is ``torch.optim.SGD``
    with ``momentum`` and ``nesterov``, no dampening, and the weight decay
    added to the clipped gradient before the momentum, as the JAX package
    chains ``add_decayed_weights`` before ``optax.sgd``."""

    def __init__(self, model, labels, lr_schedule, betas, eps, weight_decay,
                 mapping_lr_scale=1 / 3, max_grad_norm=1.0, kind="adamw",
                 momentum=0.0, nesterov=False):
        named = dict(model.named_parameters())
        scales = {"wd": (1.0, weight_decay), "no_wd": (1.0, 0.0),
                  "mapping_wd": (mapping_lr_scale, weight_decay),
                  "mapping_no_wd": (mapping_lr_scale, 0.0)}
        groups = []
        for label in GROUPS:
            params = [p for n, p in named.items() if labels[n] == label]
            if params:
                lr_scale, wd = scales[label]
                groups.append({"params": params, "lr_scale": lr_scale,
                               "weight_decay": wd, "name": label})
        fused = next(model.parameters()).device.type == "cuda"
        many = {"fused": fused, "foreach": None if fused else True}
        if kind == "adamw":
            self.optimizer = torch.optim.AdamW(
                groups, lr=lr_schedule(0), betas=tuple(betas), eps=eps, **many)
        elif kind == "adam8bit":
            self.optimizer = AdamW8bit(groups, lr=lr_schedule(0), betas=betas,
                                       eps=eps)
        elif kind == "sgd":
            # optax's trace at momentum 0 is the identity, nesterov or not;
            # torch refuses nesterov without momentum
            self.optimizer = torch.optim.SGD(
                groups, lr=lr_schedule(0), momentum=momentum,
                nesterov=nesterov and momentum > 0, **many)
        else:
            raise ValueError(f"Invalid optimizer type {kind!r}")
        self.lr_schedule = lr_schedule
        self.max_grad_norm = max_grad_norm
        self.params = [p for g in groups for p in g["params"]]

    @torch.no_grad()
    def clip_grads(self):
        """Scales the gradients in place as optax's clip_by_global_norm
        does; returns the global norm before clipping (a tensor)."""
        grads = [p.grad for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        if self.max_grad_norm is not None:
            factor = torch.where(norm < self.max_grad_norm, 1.0,
                                 self.max_grad_norm / norm)
            torch._foreach_mul_(grads, factor)
        return norm

    def step(self, count):
        """Clips, then makes update number ``count`` (0-based) with the
        schedule's lr at ``count``. Returns the pre-clip gradient norm."""
        norm = self.clip_grads()
        lr = self.lr_schedule(count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr * group["lr_scale"]
        self.optimizer.step()
        return norm

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)

    def group_names(self):
        return [g["name"] for g in self.optimizer.param_groups]

    def state_dict(self):
        """The wrapped optimizer's state (each parameter's moments or
        momentum and step count, its groups' settings) and the group
        names."""
        return {"groups": self.group_names(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state_dict):
        """Restores ``state_dict()``'s state into an optimizer over the same
        groups; the moments go to the parameters' device. The state is
        copied: torch's ``load_state_dict`` keeps the given tensors where
        their device and dtype already fit, and two optimizers would then
        update one set of moments."""
        if state_dict["groups"] != self.group_names():
            raise ValueError(f"optimizer state for groups "
                             f"{state_dict['groups']}; this optimizer has "
                             f"{self.group_names()}")
        self.optimizer.load_state_dict(copy.deepcopy(state_dict["optimizer"]))


# the param taxonomy of each model family
_PARAM_LABELS = {"image_v1": image_v1.param_group_labels,
                 "image_transformer_v1": image_transformer_v1.param_group_labels,
                 "image_transformer_v2": image_transformer_v2.param_group_labels}


def make_optimizer(config, model, mapping_lr_scale=1 / 3, max_grad_norm=1.0):
    """The grouped optimizer of the config's ``optimizer`` (``type`` adamw,
    adam8bit or sgd) and ``lr_sched`` sections over ``model``'s
    parameters, grouped by the param taxonomy of the config's model family
    (4 groups for the HDiT, 2 for the U-Net)."""
    opt_config = config["optimizer"]
    labels = _PARAM_LABELS[config["model"]["type"]](model)
    return GroupedOptimizer(
        model, labels, config_mod.make_lr_schedule(config),
        opt_config["betas"], opt_config["eps"],
        opt_config["weight_decay"], mapping_lr_scale, max_grad_norm,
        kind=opt_config["type"], momentum=opt_config.get("momentum", 0.0),
        nesterov=opt_config.get("nesterov", False))


def init_train_state(model, optimizer):
    """Step 0 with an EMA copy of ``model`` (its own tensors, no grad)."""
    ema_model = copy.deepcopy(model).eval().requires_grad_(False)
    return TrainState(step=0, model=model, optimizer=optimizer,
                      ema_model=ema_model)


def _sq_norm(grads):
    return torch.stack(torch._foreach_norm(grads)).square().sum()


def make_train_step(denoiser_factory, sample_density, *, num_classes=0,
                    cond_dropout_rate=0.0, stratified=True, compute_gns=False,
                    world=1, rank=0):
    """Returns ``step(state, batch, generator, ema_decay, noise=None,
    class_drop=None) -> metrics``.

    ``batch`` is a dict with leading dims [accum, batch]: ``reals`` (A, B,
    H, W, C) and optionally ``aug_cond`` (A, B, 9), ``class_cond`` (A, B)
    int, ``mapping_cond`` (A, B, D), and ``cross_cond`` (A, B, S, D) with
    ``cross_cond_padding`` (A, B, S), each passed to the model. Per step: sigmas for all A * B images from ``sample_density``
    (stratified over them when ``stratified``), then per microbatch noise
    from ``generator`` (or the given ``noise``, (A, B, H, W, C)) and, with
    ``class_cond`` and a ``cond_dropout_rate`` above 0, one uniform per
    label from ``generator`` (or the given ``class_drop``, (A, B) bool):
    a label whose draw is below the rate becomes ``num_classes``, the
    unconditional class, as the JAX step drops it. Then the mean
    ``Denoiser.loss`` and its gradient, accumulated over the A
    microbatches and averaged; then the optimizer (clip + AdamW) and the
    EMA update with ``ema_decay``. The dropout masks come from
    ``generator`` too. ``metrics`` holds tensors: ``loss`` and, with
    ``compute_gns``, the small- and big-batch gradient squared norms.

    With ``world`` ranks, this one ``rank``, B is the rank's batch and the
    global batch is W * B. Every rank passes a generator in the same state:
    the sigmas (A, W * B), stratified over the global batch, the noise and
    the class-dropout uniforms are drawn at the global batch, and the
    given ``noise`` and ``class_drop`` are global too; each rank takes its
    rows (``parallel.local_rows``). So the step computes what one process
    computes at batch W * B, up to the order in which the gradients are
    summed. The dropout masks come from a generator of the rank's own,
    seeded from ``generator``'s seed and the rank (JAX's per-shard
    ``fold_in``). After each microbatch's gradient the step all-reduces
    the gradient and the loss to their means over the ranks
    (``parallel.all_mean_``); with ``compute_gns`` the small-batch signal
    is each rank's squared norm before the reduce, averaged over the ranks
    (B images a microbatch). At world 1 nothing is reduced and every draw
    is as above."""
    shared = world > 1

    def local(t):
        return parallel.local_rows(t, rank, world) if shared else t

    def drop_classes(classes, generator, class_drop):
        if cond_dropout_rate <= 0:
            return classes
        if class_drop is None:
            class_drop = torch.rand((world * classes.shape[0],),
                                    generator=generator,
                                    device=classes.device) < cond_dropout_rate
        return torch.where(local(class_drop), num_classes, classes)

    def step(state, batch, generator, ema_decay, noise=None, class_drop=None):
        model = state.model
        reals = batch["reals"]
        a_steps, b = reals.shape[:2]
        model.train()
        sigmas = sample_density(
            (a_steps * world * b,), stratified=(0, 1) if stratified else None,
            generator=generator, device=reals.device).reshape(
            a_steps, world * b)
        dropout_generator = generator
        if shared:
            dropout_generator = torch.Generator(reals.device).manual_seed(
                sampling.fold_in(generator.initial_seed(), rank))
        params = state.optimizer.params
        grads, loss_sum, sqn_small = None, 0.0, 0.0
        for i in range(a_steps):
            extra = {"generator": dropout_generator}
            for key in ("aug_cond", "mapping_cond", "cross_cond",
                        "cross_cond_padding"):
                if key in batch:
                    extra[key] = batch[key][i]
            mb_noise = (noise[i] if noise is not None else torch.randn(
                (world * b, *reals.shape[2:]), generator=generator,
                device=reals.device, dtype=reals.dtype))
            if "class_cond" in batch:
                extra["class_cond"] = drop_classes(
                    batch["class_cond"][i], generator,
                    None if class_drop is None else class_drop[i])
            den = denoiser_factory(model)
            loss = den.loss(reals[i], local(mb_noise), local(sigmas[i]),
                            **extra).mean()
            mb_grads = list(torch.autograd.grad(loss, params))
            loss = loss.detach()
            sqn = _sq_norm(mb_grads) if compute_gns else None
            if shared:
                parallel.all_mean_(
                    mb_grads + [loss] + ([sqn] if compute_gns else []))
            if compute_gns:
                sqn_small = sqn_small + sqn
            if grads is None:
                grads = mb_grads
            else:
                torch._foreach_add_(grads, mb_grads)
            loss_sum = loss_sum + loss
        if a_steps > 1:
            torch._foreach_div_(grads, a_steps)
        for p, g in zip(params, grads):
            # autograd.grad keeps the strides the backward made (a U-Net
            # conv kernel's gradient comes back permuted); the fused AdamW
            # takes only the parameter's own dense layout, which
            # .backward() would have given it
            p.grad = g.contiguous()
        metrics = {"loss": loss_sum / a_steps}
        if compute_gns:
            metrics["grad_sq_norm_small"] = sqn_small / a_steps
            metrics["grad_sq_norm_big"] = _sq_norm(grads)
        state.optimizer.step(state.step)
        state.optimizer.zero_grad()
        ema_update(model.parameters(), state.ema_model.parameters(),
                   ema_decay)
        state.step += 1
        return metrics

    return step

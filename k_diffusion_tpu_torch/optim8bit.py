"""Blockwise 8-bit AdamW (counterpart of k_diffusion_tpu/optim8bit.py).

Both Adam moments are kept as int8 with one float32 scale per block of
``block`` (2048) elements of the flattened, zero-padded parameter: linear
symmetric quantization, scale = absmax / 127 (1 for an all-zero block),
values rounded half to even as ``jnp.round`` does. Each update
dequantizes, runs the AdamW math in float32 with the bias correction of
the step count, and quantizes again; weight decay is decoupled, added to
the Adam step before the learning rate, as optax's ``add_decayed_weights``
in the JAX package's ``adamw8bit`` chain. The JAX package computes this in
plain ``jnp`` with no Pallas kernel, so plain PyTorch is the port here.
"""

import torch


def quantize(x, block):
    """(q, scale): ``x`` flattened, zero-padded to whole blocks, as int8
    (n_blocks, block) and float32 (n_blocks, 1) absmax / 127 scales."""
    flat = x.reshape(-1).float()
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % block))
    blocks = flat.reshape(-1, block)
    absmax = blocks.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, 1.0)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q, scale, shape):
    """The float32 tensor of ``shape`` that ``quantize`` stored."""
    n = torch.Size(shape).numel()
    return (q.float() * scale).reshape(-1)[:n].reshape(shape)


class AdamW8bit(torch.optim.Optimizer):
    """AdamW with int8 blockwise moments (JAX ``optim8bit.adamw8bit``).
    Each parameter's state: ``step`` (float32, the update count),
    ``mu``/``nu`` (int8 blocks) and ``mu_scale``/``nu_scale`` (float32)."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, block=2048):
        super().__init__(params, {"lr": lr, "betas": tuple(betas), "eps": eps,
                                  "weight_decay": weight_decay,
                                  "block": block})

    def load_state_dict(self, state_dict):
        super().load_state_dict(state_dict)
        # torch's loader casts each state tensor to its parameter's dtype:
        # the moments go back to int8 (whole numbers, exact)
        for state in self.state.values():
            for name in ("mu", "nu"):
                if name in state:
                    state[name] = state[name].to(torch.int8)

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            eps, wd, block = group["eps"], group["weight_decay"], group["block"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), device=p.device)
                    zeros = torch.zeros_like(p, dtype=torch.float32)
                    for name in ("mu", "nu"):
                        state[name], state[f"{name}_scale"] = quantize(zeros,
                                                                       block)
                state["step"] += 1
                count = state["step"]
                g = p.grad.float()
                mu = dequantize(state["mu"], state["mu_scale"], p.shape)
                nu = dequantize(state["nu"], state["nu_scale"], p.shape)
                mu = b1 * mu + (1 - b1) * g
                nu = b2 * nu + (1 - b2) * g * g
                mu_hat = mu / (1 - b1 ** count)
                nu_hat = nu / (1 - b2 ** count)
                update = mu_hat / (torch.sqrt(nu_hat) + eps)
                if wd:
                    update = update + wd * p
                p.add_(update * -group["lr"])
                state["mu"], state["mu_scale"] = quantize(mu, block)
                state["nu"], state["nu_scale"] = quantize(nu, block)

"""Gradient noise scale (McCandlish et al., arXiv:1812.06162; counterpart
of k_diffusion_tpu/gns.py). The train step reports the mean squared norm
of its microbatch gradients and the squared norm of their mean
(``make_train_step(compute_gns=True)``); this host-side estimator turns
each pair into an estimate and smooths it with an EMA."""


class GradientNoiseScale:
    """Estimates GNS = trace(Sigma) / |G|^2 from paired (small, large)
    batch gradient squared norms, with EMA smoothing."""

    def __init__(self, beta=0.9998, eps=1e-8):
        self.beta = beta
        self.eps = eps
        self.ema_sq_norm = 0.0
        self.ema_var = 0.0
        self.beta_cumprod = 1.0
        self.gradient_noise_scale = float("nan")

    def state_dict(self):
        return dict(self.__dict__.items())

    def load_state_dict(self, state_dict):
        self.__dict__.update(state_dict)

    def update(self, sq_norm_small_batch, sq_norm_large_batch,
               n_small_batch, n_large_batch):
        """``sq_norm_small_batch``: the mean squared 2-norm of the
        microbatch gradients; ``sq_norm_large_batch``: the squared 2-norm
        of their mean. Returns the smoothed GNS."""
        if n_large_batch <= n_small_batch:
            raise ValueError(
                f"GNS needs a small batch strictly smaller than the large "
                f"one (got n_small={n_small_batch}, n_large={n_large_batch});"
                f" use --grad-accum-steps > 1")
        est_sq_norm = (n_large_batch * sq_norm_large_batch
                       - n_small_batch * sq_norm_small_batch) \
            / (n_large_batch - n_small_batch)
        est_var = (sq_norm_small_batch - sq_norm_large_batch) \
            / (1 / n_small_batch - 1 / n_large_batch)
        self.ema_sq_norm = (self.beta * self.ema_sq_norm
                            + (1 - self.beta) * est_sq_norm)
        self.ema_var = self.beta * self.ema_var + (1 - self.beta) * est_var
        self.beta_cumprod *= self.beta
        self.gradient_noise_scale = max(self.ema_var, self.eps) \
            / max(self.ema_sq_norm, self.eps)
        return self.gradient_noise_scale

    def get_gns(self):
        return self.gradient_noise_scale

    def get_stats(self):
        """Debiased (squared mean, variance) estimates."""
        return (self.ema_sq_norm / (1 - self.beta_cumprod),
                self.ema_var / (1 - self.beta_cumprod))

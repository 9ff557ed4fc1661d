"""LR and EMA schedules as pure closed-form functions of the step count
(counterpart of k_diffusion_tpu/utils/schedules.py). Each LR schedule is a
``step -> lr`` function on Python numbers; the training step sets it on the
optimizer's param groups before each update."""


def _warmup_factor(step, warmup):
    # exponential warmup 1 - warmup ** (step + 1); warmup = 0 disables it
    return 1.0 if warmup == 0.0 else 1.0 - warmup ** (step + 1.0)


def _check_warmup(warmup):
    if not 0.0 <= warmup < 1:
        raise ValueError("Invalid value for warmup")


def inverse_lr(base_lr, inv_gamma=1.0, power=1.0, warmup=0.0, min_lr=0.0):
    """Inverse decay schedule with exponential warmup."""
    _check_warmup(warmup)

    def schedule(step):
        lr_mult = (1.0 + step / inv_gamma) ** -power
        return _warmup_factor(step, warmup) * max(min_lr, base_lr * lr_mult)

    return schedule


def exponential_lr(base_lr, num_steps, decay=0.5, warmup=0.0, min_lr=0.0):
    """Continuous exponential decay by ``decay`` every ``num_steps`` steps."""
    _check_warmup(warmup)

    def schedule(step):
        lr_mult = (decay ** (1.0 / num_steps)) ** step
        return _warmup_factor(step, warmup) * max(min_lr, base_lr * lr_mult)

    return schedule


def constant_lr_with_warmup(base_lr, warmup=0.0):
    """Constant schedule with exponential warmup."""
    _check_warmup(warmup)

    def schedule(step):
        return _warmup_factor(step, warmup) * base_lr

    return schedule


class EMAWarmup:
    """Inverse-decay EMA warmup schedule. ``get_value`` is a pure function
    of ``last_epoch``, so the schedule checkpoints as one int."""

    def __init__(self, inv_gamma=1.0, power=1.0, min_value=0.0, max_value=1.0,
                 start_at=0, last_epoch=0):
        self.inv_gamma = inv_gamma
        self.power = power
        self.min_value = min_value
        self.max_value = max_value
        self.start_at = start_at
        self.last_epoch = last_epoch

    def state_dict(self):
        return dict(self.__dict__.items())

    def load_state_dict(self, state_dict):
        self.__dict__.update(state_dict)

    def get_value(self):
        epoch = max(0, self.last_epoch - self.start_at)
        value = 1 - (1 + epoch / self.inv_gamma) ** -self.power
        return min(self.max_value, max(self.min_value, value))

    def step(self):
        self.last_epoch += 1

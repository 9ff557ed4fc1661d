"""One rank of tests/test_torch_parallel.py's two-process runs of the
port's data parallelism on the CPU (gloo), and the one-process references
the test holds them against.

    python tests/torch_parallel_worker.py RANK WORLD PORT OUT_DIR

Each rank joins a gloo group at ``tcp://localhost:PORT`` and runs, on
configs/config_test_tiny.json's model (seeded weights, its zero-init
projections filled with seeded noise, dropout off):
- ``steps_a{1,2}``: 2 train steps of its rows of a seeded global batch of
  8 (A = 1 and A = 2), recording each step's loss, the noise, sigma and
  class rows its microbatches used, and the params and EMA after;
- ``strata``: one A = 2 step whose density returns its stratified uniform
  draws as sigmas, recording the sigma rows used;
- ``gns``: one step with ``compute_gns`` and unstratified sigmas;
- ``jax``: one step from ``OUT_DIR/jax_inputs.pt`` (converted weights,
  EMA, batch and the JAX step's sigmas, noise and class drops, injected);
- ``features``: ``evaluation.compute_features`` over a table of rows;
- ``mesh``: ``parallel.make_mesh``'s axis and size.
It writes ``OUT_DIR/rank{RANK}.pt``. Imports nothing of JAX.
"""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import k_diffusion_tpu_torch as KT  # noqa: E402
from k_diffusion_tpu_torch import parallel, sampling, utils  # noqa: E402

TINY = ROOT / "configs" / "config_test_tiny.json"
GLOBAL_BATCH, STEPS, EMA_DECAY, SEED = 8, 2, 0.5, 3
# AdamW's first update is lr * g / (|g| + eps) per element: at the config's
# eps of 1e-8 an element whose gradient is ~1e-10 moves by an amount a
# rounding of its gradient decides (tests/test_torch_train.py's STEP_EPS)
STEP_EPS = 1e-4


def tiny_config():
    config = KT.config.load_config(TINY)
    config["optimizer"]["eps"] = STEP_EPS
    return config


def fill_zero_init(model, g):
    """Seeded noise into the HDiT's zero-initialised projections, without
    which the model returns c_skip * x and most gradients are 0."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("out_proj.kernel", "down_proj.kernel",
                              "patch_out.proj.kernel", "mapping_linear.kernel")):
                p.copy_(torch.randn(p.shape, generator=g) / p.shape[0] ** 0.5)


def make_state(config, weights=None, ema=None):
    model = KT.config.make_model(config, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    if weights is None:
        fill_zero_init(model, torch.Generator().manual_seed(1))
    else:
        model.load_state_dict(weights)
    state = KT.training.init_train_state(
        model, KT.training.make_optimizer(config, model))
    if ema is not None:
        state.ema_model.load_state_dict(ema)
    return state


def global_batch(accum):
    """Seeded (A, 8, ...) reals, aug_cond and class labels."""
    g = torch.Generator().manual_seed(100 + accum)
    n = GLOBAL_BATCH // accum
    return {"reals": torch.randn((accum, n, 32, 32, 3), generator=g),
            "aug_cond": torch.randn((accum, n, 9), generator=g) * 0.1,
            "class_cond": torch.randint(0, 4, (accum, n), generator=g)}


def rows(batch, rank, world):
    """This rank's rows of each (A, W * B, ...) entry: (A, B, ...)."""
    return {k: parallel.local_rows(v.transpose(0, 1), rank, world)
            .transpose(0, 1).contiguous() for k, v in batch.items()}


class Recording:
    """A denoiser factory that records the noise, sigma and class labels
    each ``loss`` call is given."""

    def __init__(self, factory):
        self.factory = factory
        self.calls = []

    def __call__(self, model):
        den = self.factory(model)
        calls = self.calls

        class Den:
            def loss(self, reals, noise, sigma, **extra):
                calls.append({"noise": noise.clone(), "sigma": sigma.clone(),
                              "class_cond": extra["class_cond"].clone()})
                return den.loss(reals, noise, sigma, **extra)

        return Den()


def state_tensors(state):
    return {"params": {k: v.clone() for k, v in
                       state.model.state_dict().items()},
            "ema": {k: v.clone() for k, v in
                    state.ema_model.state_dict().items()}}


def run_steps(accum, rank=0, world=1, steps=STEPS, density=None, **kw):
    """``steps`` train steps of this rank's rows of ``global_batch``;
    returns the losses, the first step's recorded draws, metrics and the
    state's tensors."""
    config = tiny_config()
    state = make_state(config)
    if world > 1:
        parallel.replicate(state.model)
    recording = Recording(KT.config.make_denoiser_wrapper(config))
    step = KT.training.make_train_step(
        recording, density or KT.config.make_sample_density(config["model"]),
        num_classes=4, cond_dropout_rate=0.5, world=world, rank=rank, **kw)
    batch = rows(global_batch(accum), rank, world)
    losses, metrics = [], []
    for i in range(steps):
        gen = torch.Generator().manual_seed(sampling.fold_in(SEED, i))
        m = step(state, batch, gen, EMA_DECAY)
        losses.append(float(m["loss"]))
        metrics.append({k: float(v) for k, v in m.items()})
    draws = recording.calls[:accum]
    return {"losses": losses, "metrics": metrics, "draws": draws,
            **state_tensors(state)}


def uniform_density(shape, stratified=None, generator=None, device=None):
    """The stratified U(0, 1) draw itself, as sigmas."""
    return utils.uniform_maybe_stratified(shape, stratified, generator,
                                          device)


def run_injected(inputs, rank=0, world=1):
    """One step from the JAX step's weights, EMA, batch and draws (the
    sigmas (A, B), noise (A, B, H, W, C) and class drops (A, B) of the
    global batch)."""
    config = tiny_config()
    state = make_state(config, inputs["weights"], inputs["ema"])
    sigmas = inputs["sigmas"]
    step = KT.training.make_train_step(
        KT.config.make_denoiser_wrapper(config),
        lambda shape, stratified=None, generator=None, device=None:
        sigmas.reshape(shape),
        num_classes=4, cond_dropout_rate=inputs["cond_dropout_rate"],
        world=world, rank=rank)
    m = step(state, rows(inputs["batch"], rank, world),
             torch.Generator().manual_seed(0), inputs["ema_decay"],
             noise=inputs["noise"], class_drop=inputs["class_drop"])
    return {"loss": float(m["loss"]), **state_tensors(state)}


def feature_table(n):
    return torch.arange(n * 6, dtype=torch.float32).reshape(n, 6)


def run_features(n, batch_size, rank=0, world=1):
    """compute_features over rows of ``feature_table``: each round, every
    rank takes the next ``cur`` rows after the ranks before it."""
    table = feature_table(2 * n)
    offset = [0]

    def sample_fn(cur):
        start = offset[0] + rank * cur
        offset[0] += world * cur
        return table[start:start + cur]

    weight = torch.linspace(-1, 1, 6 * 5).reshape(6, 5)
    return KT.evaluation.compute_features(sample_fn, lambda x: x @ weight, n,
                                          batch_size)


def main():
    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], Path(sys.argv[4]))
    torch.set_num_threads(2)
    parallel.initialize_distributed(
        backend="gloo", init_method=f"tcp://localhost:{port}",
        world_size=world, rank=rank)
    mesh = parallel.make_mesh()
    result = {
        "rank": parallel.process_index(), "world": parallel.process_count(),
        "mesh": {"names": list(mesh.mesh_dim_names), "size": mesh.size()},
        "steps_a1": run_steps(1, rank, world),
        "steps_a2": run_steps(2, rank, world),
        "strata": run_steps(2, rank, world, steps=1,
                            density=uniform_density)["draws"],
        "gns": run_steps(1, rank, world, steps=1, stratified=False,
                         compute_gns=True)["metrics"][0],
        "features": run_features(13, 4, rank, world),
    }
    inputs = out / "jax_inputs.pt"
    if inputs.exists():
        result["jax"] = run_injected(torch.load(inputs, weights_only=True),
                                     rank, world)
    torch.save(result, out / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

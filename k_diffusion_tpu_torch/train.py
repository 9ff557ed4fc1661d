"""Trains a Karras et al. (2022) diffusion model (counterpart of the JAX
package's train.py).

    python -m k_diffusion_tpu_torch.train \\
        --config configs/config_oxford_flowers.json --batch-size 32 \\
        --name run

Builds the config's model on the card (bfloat16 compute; ``--device cpu``
runs the kernels' plain versions on the CPU in float32), reads the config's
dataset through a prefetching loader, augments each batch on the device,
and trains through ``training.make_train_step`` (class-conditioning
dropout, gradient accumulation, clip + AdamW, EMA). Every 25 steps it
prints the loss and the images/s since the last print, over the step
bodies alone (the seconds the checkpoint's ``elapsed`` adds up, as the JAX
trainer keeps them) and with the waits for the loader; ``main`` returns
the last such window ({"steps", "images", "body_s", "wait_s"}). Every ``--demo-every`` steps it samples the EMA model
(DPM++(2M) SDE, eta 0, Heun, 50 steps) into ``{name}_demo_{step:08}.png``;
every ``--save-every`` steps, and at ``--end-step``, it writes
``{name}_{step:08}.ckpt`` and points ``{name}_state.json`` at it. A run
whose ``{name}_state.json`` exists resumes from it. Every
``--evaluate-every`` steps it samples ``--evaluate-n`` images from the EMA
model as the demo does and writes their FID and KID against the training
set's (``evaluation``, InceptionV3 from the local cache) to
``{name}_metrics.csv``; ``--evaluate-only`` evaluates once and returns.
Without the extractor's weights it says "Evaluation disabled" and trains,
as the JAX trainer does.

Each step's draws come from generators seeded by ``sampling.fold_in``:
the step from (seed + 3, step), the augmentation from (seed + 2, step),
the demo from (seed, step), as the JAX trainer folds its keys. With the
loader's epoch and position restored, a resumed run draws and reads
exactly what the uninterrupted run would have.

Data parallel: under ``python -m torch.distributed.run --nproc_per_node
N -m k_diffusion_tpu_torch.train ...`` each process is one rank
(``parallel``; NCCL with one card a rank, ``cuda:LOCAL_RANK``, or gloo
with ``--device cpu``). ``--batch-size`` is the global batch, which must
divide by N: each rank reads its stride of every epoch at batch
``batch_size // N`` and runs the step on it, which draws at the global
batch, takes its rows and all-reduces the gradients
(``training.make_train_step``). The augmentation's generator also folds
in the rank. The demo's and the evaluation's noise is drawn at the global
batch and split over the ranks, and their samples and features are
gathered. Only rank 0 prints and writes files, but every rank writes its
share of an ``--checkpoint-format orbax`` checkpoint
(``checkpoint.save_checkpoint_sharded``: ``torch.distributed.checkpoint``
in the background, ``{name}_{step:08}.orbax``).
"""

import argparse
import math
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from . import (augmentation, checkpoint, config as config_mod, data,
               evaluation, gns as gns_mod, guidance, parallel, sampling,
               training, utils)


class StarvationMonitor:
    """Warns when the input pipeline cannot feed the device: ``record(wait_s,
    step_s)`` each step; ``check()`` at the print cadence returns a warning
    (and resets its window) when more than ``threshold`` of the wall time
    went to waiting for the loader."""

    def __init__(self, threshold=0.25, min_steps=10):
        self.threshold = threshold
        self.min_steps = min_steps
        self.wait_s = 0.0
        self.step_s = 0.0
        self.n = 0

    def record(self, wait_s, step_s):
        self.wait_s += max(0.0, wait_s)
        self.step_s += max(0.0, step_s)
        self.n += 1

    def check(self):
        if self.n < self.min_steps:
            return None
        total = self.wait_s + self.step_s
        frac = self.wait_s / total if total > 0 else 0.0
        step_s, n = self.step_s, self.n
        self.wait_s = self.step_s = 0.0
        self.n = 0
        if frac <= self.threshold:
            return None
        loader_rate = n / total if total else 0.0
        device_rate = n / step_s if step_s else float("inf")
        return (f"WARNING: input pipeline is starving the device: "
                f"{frac:.0%} of wall time spent waiting on the data loader "
                f"({loader_rate:.2f} batches/s fed vs {device_rate:.2f} "
                f"batches/s consumed). Raise --num-workers, store the "
                f"images at the model's size, or add host cores.")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--batch-size", type=int, default=64,
                   help="the batch size")
    p.add_argument("--checkpointing", action="store_true",
                   help="enable gradient checkpointing")
    p.add_argument("--checkpoint-format", type=str, default="torch",
                   choices=["torch", "orbax"],
                   help="torch = one torch.save file; orbax = a sharded "
                        "torch.distributed.checkpoint directory that every "
                        "rank writes in the background (not Orbax's "
                        "format; the JAX trainer's flag and file name)")
    p.add_argument("--remat-levels",
                   type=lambda s: int(s) if s.isdigit() else s, nargs="*",
                   default=None,
                   help="hourglass levels to remat under --checkpointing "
                        "(default all; e.g. '0' remats the high-resolution "
                        "level, 'down_0' only its down stack)")
    p.add_argument("--config", type=str, required=True,
                   help="the configuration file")
    p.add_argument("--demo-every", type=int, default=500,
                   help="save a demo grid every this many steps")
    p.add_argument("--end-step", type=int, default=None,
                   help="the step to end training at")
    p.add_argument("--evaluate-every", type=int, default=10000,
                   help="evaluate every this many steps")
    p.add_argument("--evaluate-n", type=int, default=2000,
                   help="the number of samples to draw to evaluate")
    p.add_argument("--evaluate-only", action="store_true",
                   help="evaluate instead of training")
    p.add_argument("--evaluate-with", type=str, default="inception",
                   choices=["inception", "clip", "dinov2"],
                   help="the feature extractor to use for evaluation")
    p.add_argument("--clip-model", type=str,
                   default="openai/clip-vit-base-patch16",
                   help="the CLIP model to use to evaluate")
    p.add_argument("--dinov2-model", type=str, default="facebook/dinov2-large",
                   help="the DINOv2 model to use to evaluate")
    p.add_argument("--gns", action="store_true",
                   help="measure the gradient noise scale (disables "
                        "stratified sampling)")
    p.add_argument("--grad-accum-steps", type=int, default=1,
                   help="the number of gradient accumulation steps")
    p.add_argument("--lr", type=float, help="the learning rate")
    p.add_argument("--mixed-precision", type=str, default="bf16",
                   choices=["no", "bf16"],
                   help="the compute precision on the card: bf16, or no "
                        "(float32 with TF32 products; every model). The "
                        "CPU computes in float32")
    p.add_argument("--name", type=str, default="model",
                   help="the name of the run")
    p.add_argument("--num-workers", type=int, default=8,
                   help="the number of data loader threads")
    p.add_argument("--reset-ema", action="store_true", help="reset the EMA")
    p.add_argument("--resume", type=str, help="the checkpoint to resume from")
    p.add_argument("--resume-inference", type=str,
                   help="the inference checkpoint to resume from")
    p.add_argument("--sample-n", type=int, default=64,
                   help="the number of images to sample for demo grids")
    p.add_argument("--save-every", type=int, default=10000,
                   help="save every this many steps")
    p.add_argument("--profile-dir", type=str,
                   help="write a torch.profiler trace of steps 10-15 here")
    p.add_argument("--seed", type=int, help="the random seed")
    p.add_argument("--device", type=str, default=None,
                   help="the device (default: the current CUDA device)")
    p.add_argument("--wandb-entity", type=str, help="the wandb entity name")
    p.add_argument("--wandb-group", type=str, help="the wandb group name")
    p.add_argument("--wandb-project", type=str,
                   help="the wandb project name (not ported yet)")
    return p.parse_args(argv)


def check_ported(args):
    """Raises NotImplementedError for a flag the port does not run yet,
    naming where it waits in ROADMAP.md."""
    waits = [
        (args.wandb_project, "--wandb-project",
         "queue 1, item 8 (wandb logging)"),
    ]
    for given, flag, item in waits:
        if given:
            raise NotImplementedError(
                f"{flag} is not ported yet: ROADMAP.md {item}")


def float32_on_the_card():
    """``--mixed-precision no`` on the card: float32 compute, which every
    model the port builds takes (``config.card_dtypes``: each kernel on its
    path has a float32 form), with TF32 on for cuBLAS and cuDNN, as the
    upstream PyTorch trainer runs float32 (the float32 kernels use the TF32
    tensor cores too)."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    return torch.float32


def to_device(array, device):
    """A numpy batch array on ``device``, copied from pinned memory to the
    card."""
    t = torch.from_numpy(array)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def main(argv=None):
    args = parse_args(argv)
    check_ported(args)
    cpu = args.device is not None and torch.device(args.device).type == "cpu"
    joined = parallel.initialize_distributed(backend="gloo" if cpu else None)
    try:
        return run(args)
    finally:
        checkpoint.wait_for_checkpoints()
        if joined:
            dist.destroy_process_group()


def run(args):
    world, rank = parallel.process_count(), parallel.process_index()
    is_main = parallel.is_main_process()

    def log(*values, **kwargs):
        if is_main:
            print(*values, **kwargs)

    log(f"World: {world} process(es)", flush=True)
    device = utils.default_device(args.device)
    config = config_mod.load_config(args.config)
    model_config = config["model"]
    dtype = utils.compute_dtype(device)
    if device.type == "cuda" and args.mixed_precision == "no":
        dtype = float32_on_the_card()
    log(f"Device: {device}, compute dtype {dtype}", flush=True)

    dataset_config = config["dataset"]
    if args.lr is not None:
        config["optimizer"]["lr"] = args.lr
    seed = args.seed if args.seed is not None else 42
    size = model_config["input_size"]
    size = size if isinstance(size, (list, tuple)) else [size, size]
    channels = model_config["input_channels"]
    num_classes = dataset_config["num_classes"]
    sigma_min, sigma_max = model_config["sigma_min"], model_config["sigma_max"]
    accum = args.grad_accum_steps
    if args.gns and world == 1 and accum < 2:
        raise ValueError("--gns needs a small batch distinct from the large "
                         "one: run on more than one process or set "
                         "--grad-accum-steps > 1")
    if args.batch_size % world:
        raise ValueError(f"--batch-size {args.batch_size} (the global batch) "
                         f"does not divide over the {world} processes")
    # a rank's batch: the GNS small batch, and each microbatch's size
    local_batch = args.batch_size // world

    model = config_mod.make_model(
        config, dtype=dtype, device=device,
        generator=torch.Generator(device).manual_seed(seed),
        checkpointing=args.checkpointing, remat_levels=args.remat_levels)
    if world > 1:
        parallel.replicate(model)
    log(f"Parameters: {sum(p.numel() for p in model.parameters()):,}")

    train_set = data.make_dataset(dataset_config, size[0],
                                  config_dir=Path(args.config).parent)
    log(f"Number of items in dataset: {len(train_set):,}")
    train_dl = data.DataLoader(train_set, local_batch * accum, seed=seed,
                               num_workers=args.num_workers,
                               process_index=rank, process_count=world)
    if not len(train_dl):
        raise ValueError(f"{len(train_set)} items make no batch of "
                         f"{local_batch * accum} on each of {world} "
                         f"processes")
    augment_prob = model_config["augment_prob"]
    aug_pipe = augmentation.KarrasAugmentationPipeline(
        augment_prob, disable_all=augment_prob == 0)

    state = training.init_train_state(
        model, training.make_optimizer(config, model))
    ema_sched = config_mod.make_ema_sched(config)
    denoiser_factory = config_mod.make_denoiser_wrapper(config)
    host = {"epoch": 0, "step": 0, "batch_in_epoch": 0, "elapsed": 0.0,
            "ema_stats": {}, "ema_sched": ema_sched.state_dict(),
            "gns_stats": None, "config": config}
    gns_stats = gns_mod.GradientNoiseScale() if args.gns else None

    if args.resume and not Path(args.resume).exists():
        raise FileNotFoundError(f"--resume {args.resume}: no such file")
    ckpt_path = args.resume or checkpoint.latest_checkpoint(args.name)
    if ckpt_path and Path(ckpt_path).exists():
        log(f"Resuming from {ckpt_path}...")
        state, host = checkpoint.load_checkpoint(ckpt_path, state)
        host["config"] = config  # the current run's config wins
        ema_sched.load_state_dict(host["ema_sched"])
        # the data order: the epoch's shuffle and the position in it
        train_dl.epoch = host["epoch"]
        train_dl.start_batch = host.get("batch_in_epoch", 0)
        if args.gns and host.get("gns_stats"):
            gns_stats.load_state_dict(host["gns_stats"])
    if args.reset_ema:
        state.model.load_state_dict(state.ema_model.state_dict())
        ema_sched = config_mod.make_ema_sched(config)
    if args.resume_inference:
        log(f"Loading {args.resume_inference}...")
        weights, _ = checkpoint.load_inference(args.resume_inference)
        state.model.load_state_dict(weights)
        state.ema_model.load_state_dict(weights)

    train_step = training.make_train_step(
        denoiser_factory, config_mod.make_sample_density(model_config),
        num_classes=num_classes,
        cond_dropout_rate=dataset_config["cond_dropout_rate"],
        stratified=not args.gns, compute_gns=args.gns, world=world,
        rank=rank)

    def generator(seed_, step):
        return torch.Generator(device).manual_seed(
            sampling.fold_in(seed_, step))

    def local(t):
        return parallel.local_rows(t, rank, world) if world > 1 else t

    @torch.no_grad()
    def demo(step):
        """Every rank draws the global noise and classes; each samples its
        rows where the ranks divide ``--sample-n``, else all of them (as
        the JAX trainer's ``shard_sampler``), and rank 0 writes the
        gathered grid."""
        log("Sampling...")
        gen = generator(seed, step)
        n = args.sample_n
        split = world > 1 and n % world == 0
        x = torch.randn((n, size[0], size[1], channels), generator=gen,
                        device=device) * sigma_max
        sigmas = sampling.get_sigmas_karras(50, sigma_min, sigma_max,
                                            rho=7.0, device=device)
        extra = ({"class_cond": torch.randint(0, num_classes, (n,),
                                              generator=gen, device=device)}
                 if num_classes else {})
        if split:
            x, extra = local(x), {k: local(v) for k, v in extra.items()}
        x_0 = sampling.sample_dpmpp_2m_sde(
            denoiser_factory(state.ema_model), x, sigmas, extra_args=extra,
            eta=0.0, solver_type="heun")
        if split:
            x_0 = parallel.all_gather_rows(x_0)
        if not is_main:
            return
        filename = f"{args.name}_demo_{step:08}.png"
        utils.to_png(utils.make_grid(x_0, nrow=math.ceil(n ** 0.5)),
                     filename)
        print(f"Saved {filename}")

    # evaluation (FID, KID)
    evaluate_enabled = args.evaluate_every > 0 and args.evaluate_n > 0
    extractor = None
    if evaluate_enabled:
        kw = {"device": device}
        if args.evaluate_with == "clip":
            kw["model_name"] = args.clip_model
        elif args.evaluate_with == "dinov2":
            kw["model_name"] = args.dinov2_model
        try:
            extractor = evaluation.make_extractor(args.evaluate_with, **kw)
        except Exception as e:
            if is_main:
                traceback.print_exc()
            log(f"Evaluation disabled (feature extractor unavailable: {e})",
                flush=True)
            evaluate_enabled = False
    reals_features = None
    if evaluate_enabled:
        log("Computing features for reals...")
        # a loader of its own over the training set: the first batches of
        # the training order (this rank's stride), which the training
        # loader reads unchanged
        reals_dl = data.DataLoader(train_set, local_batch, seed=seed,
                                   num_workers=args.num_workers,
                                   process_index=rank, process_count=world)

        def reals():
            while True:
                yield from reals_dl

        real_iter = reals()
        reals_features = evaluation.compute_features(
            lambda n: to_device(next(real_iter)["image"][:n], device) * 2 - 1,
            extractor, args.evaluate_n, local_batch)
    metrics_log = (utils.CSVLogger(f"{args.name}_metrics.csv",
                                   ["step", "time", "loss", "fid", "kid"])
                   if is_main else None)

    @torch.no_grad()
    def evaluate(step):
        """FID and KID of ``--evaluate-n`` EMA samples (DPM++(2M) SDE, eta
        0, Heun, 50 Karras steps, through the CFG wrapper at scale 1, as
        the JAX trainer samples) against the reals' features; one row of
        ``{name}_metrics.csv``. Each rank samples its rows of a batch drawn
        at the global batch."""
        if not evaluate_enabled:
            return
        log("Evaluating...")
        sigmas = sampling.get_sigmas_karras(50, sigma_min, sigma_max,
                                            rho=7.0, device=device)
        den = guidance.make_cfg_model_fn(denoiser_factory(state.ema_model),
                                         1.0, num_classes)
        calls = [0]

        def sample_fn(n):
            calls[0] += 1
            gen = generator(seed + 1, step * 1000 + calls[0])
            b = world * local_batch
            x = torch.randn((b, size[0], size[1], channels), generator=gen,
                            device=device) * sigma_max
            extra = ({"class_cond": torch.randint(0, num_classes, (b,),
                                                  generator=gen,
                                                  device=device)}
                     if num_classes else {})
            x, extra = local(x), {k: local(v) for k, v in extra.items()}
            return sampling.sample_dpmpp_2m_sde(
                den, x, sigmas, extra_args=extra, eta=0.0,
                solver_type="heun")[:n]

        fakes_features = evaluation.compute_features(
            sample_fn, extractor, args.evaluate_n, local_batch)
        fid = float(evaluation.fid(fakes_features, reals_features))
        kid = float(evaluation.kid(fakes_features, reals_features))
        if not is_main:
            return
        print(f"FID: {fid:g}, KID: {kid:g}", flush=True)
        metrics_log.write(step, host["elapsed"],
                          host["ema_stats"].get("loss", float("nan")), fid,
                          kid)

    def save(step):
        host["step"] = step
        host["ema_sched"] = ema_sched.state_dict()
        host["gns_stats"] = gns_stats.state_dict() if gns_stats else None
        if args.checkpoint_format == "orbax":
            # every rank writes its share, in the background; the pointer
            # moves once the save has committed
            filename = f"{args.name}_{step:08}.orbax"
            log(f"Saving to {filename}...")
            checkpoint.save_checkpoint_sharded(filename, state, host)
            if is_main:
                checkpoint.write_state_json_after_commit(args.name, filename)
            return
        if not is_main:
            return
        filename = f"{args.name}_{step:08}.ckpt"
        print(f"Saving to {filename}...")
        checkpoint.save_checkpoint(filename, state, host)
        checkpoint.write_state_json(args.name, filename)

    def due(every, step):
        return every > 0 and step > 0 and step % every == 0

    if args.evaluate_only:
        if not evaluate_enabled:
            raise ValueError(
                "--evaluate-only requested but evaluation is disabled")
        evaluate(host["step"])
        return None

    step = host["step"]
    epoch = host["epoch"]
    batch_in_epoch = host.get("batch_in_epoch", 0)
    losses_since_last_print = []
    gns_pending = []

    def drain_gns():
        for sqn_small, sqn_big in gns_pending:
            gns_stats.update(float(sqn_small), float(sqn_big),
                             local_batch, args.batch_size * accum)
        gns_pending.clear()

    starvation = StarvationMonitor()
    # images and seconds since the last print: step bodies, and loader
    # waits (the wait for a batch, not the prints, demos and saves)
    window = dict.fromkeys(("steps", "images", "body_s", "wait_s"), 0)
    last_window = None
    t_loop_end = None
    profiler = None
    try:
        while True:
            for batch in train_dl:
                t0 = time.perf_counter()
                data_wait = t0 - t_loop_end if t_loop_end is not None else 0.0
                batch_in_epoch += 1
                host["batch_in_epoch"] = batch_in_epoch
                images = to_device(batch["image"], device)
                aug_gen = generator(seed + 2, step)
                if world > 1:  # each rank's images get draws of their own
                    aug_gen = generator(aug_gen.initial_seed(), rank)
                reals, _, aug_cond = aug_pipe.apply(
                    aug_pipe.draw(images.shape[0], aug_gen), images)
                dev_batch = {
                    "reals": reals.reshape(accum, local_batch,
                                           *reals.shape[1:]),
                    "aug_cond": aug_cond.reshape(accum, local_batch, 9)}
                if num_classes and "class" in batch:
                    dev_batch["class_cond"] = to_device(
                        batch["class"], device).long().reshape(
                        accum, local_batch)

                if args.profile_dir and step == 10 and is_main:
                    activities = [torch.profiler.ProfilerActivity.CPU]
                    if device.type == "cuda":
                        activities.append(torch.profiler.ProfilerActivity.CUDA)
                    profiler = torch.profiler.profile(activities=activities)
                    profiler.start()
                ema_decay = ema_sched.get_value()
                metrics = train_step(state, dev_batch,
                                     generator(seed + 3, step), ema_decay)
                if profiler is not None and step == 15:
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    profiler.stop()
                    Path(args.profile_dir).mkdir(parents=True, exist_ok=True)
                    trace = Path(args.profile_dir) / f"trace_{step:08}.json"
                    profiler.export_chrome_trace(str(trace))
                    profiler = None
                    print(f"Saved profiler trace to {trace}")

                losses_since_last_print.append((metrics["loss"], ema_decay))
                ema_sched.step()
                if args.gns:
                    gns_pending.append((metrics["grad_sq_norm_small"],
                                        metrics["grad_sq_norm_big"]))
                if device.type == "cuda" and (
                        step % 25 == 0 or step + 1 == args.end_step
                        or due(args.demo_every, step + 1)
                        or due(args.save_every, step + 1)
                        or (evaluate_enabled
                            and due(args.evaluate_every, step + 1))):
                    # the queued steps finish inside the timed body, so
                    # that ``elapsed`` holds their device time
                    torch.cuda.synchronize(device)
                t_body_end = time.perf_counter()
                host["elapsed"] += t_body_end - t0
                starvation.record(data_wait, t_body_end - t0)
                window["steps"] += 1
                window["images"] += world * images.shape[0]
                window["body_s"] += t_body_end - t0
                window["wait_s"] += data_wait

                if step % 25 == 0:
                    for dev_loss, decay in losses_since_last_print:
                        utils.ema_update_dict(host["ema_stats"],
                                              {"loss": float(dev_loss)},
                                              decay ** (1 / accum))
                    loss_vals = [float(l) for l, _ in losses_since_last_print]
                    losses_since_last_print.clear()
                    drain_gns()
                    gns_str = (f", gns: {gns_stats.get_gns():g}" if args.gns
                               else "")
                    last_window = dict(window)
                    window.update(dict.fromkeys(window, 0))
                    wall = last_window["body_s"] + last_window["wait_s"]
                    log(f"Epoch: {epoch}, step: {step}, loss: "
                        f"{sum(loss_vals) / len(loss_vals):g}, avg loss: "
                        f"{host['ema_stats']['loss']:g}{gns_str}, "
                        f"images/s: "
                        f"{last_window['images'] / last_window['body_s']:g} "
                        f"({last_window['images'] / wall:g} with loader "
                        f"waits, {last_window['wait_s'] / wall:.1%} "
                        f"waiting)", flush=True)
                    warn = starvation.check()
                    if warn:
                        log(warn, flush=True)

                step += 1
                host["step"] = step
                if due(args.demo_every, step):
                    demo(step)
                if evaluate_enabled and due(args.evaluate_every, step):
                    evaluate(step)
                if step == args.end_step or due(args.save_every, step):
                    if args.gns:
                        drain_gns()  # the estimator up to date in the file
                    save(step)
                if step == args.end_step:
                    log("Done!")
                    return last_window
                t_loop_end = time.perf_counter()
            epoch += 1
            host["epoch"] = epoch
            batch_in_epoch = 0
            host["batch_in_epoch"] = 0
    except KeyboardInterrupt:
        pass
    finally:
        if profiler is not None:
            profiler.stop()


if __name__ == "__main__":
    main()

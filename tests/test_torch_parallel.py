"""The port's data parallelism (k_diffusion_tpu_torch.parallel, the
rank-sliced train step, the loader's strides, gathered features, sharded
checkpoints and the trainer under torchrun) on the CPU with gloo.

Two ranks run as two subprocesses (tests/torch_parallel_worker.py), as
tests/test_distributed.py runs the JAX package's two processes; each
writes its results, and the tests hold them against one process at the
global batch, against each other and against the JAX step's
``make_train_step(mesh=...)`` on the 8 CPU devices of tests/conftest.py."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k_diffusion_tpu as K
from k_diffusion_tpu import layout as j_layout, parallel as j_parallel
from k_diffusion_tpu.models import image_transformer_v2 as j_itv2
from k_diffusion_tpu_torch import (checkpoint, convert, data, gns, parallel,
                                   train as t_train, utils)
from k_diffusion_tpu_torch.utils import image as t_image
from tests import torch_parallel_worker as worker

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
# tests/test_distributed.py's bounds for the sharded step against one device
LOSS_RTOL, STATE_ATOL = 1e-5, 2e-6
DROP_RATE = 0.5


def subprocess_env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    return env


def run_all(cmds, cwd, timeout=300):
    """Starts every command at once; fails with each one's output unless
    all exit 0."""
    procs = [subprocess.Popen(cmd, cwd=cwd, env=subprocess_env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-6000:]
    return outs


def randomized(params, seed):
    """Seeded noise into every Dense kernel (the zero-initialised ones
    included); scales perturbed; FourierFeatures bases kept."""
    rng = np.random.default_rng(seed)

    def fill(path, p):
        p = np.asarray(p)
        name = path[-1].key
        if name == "basis":
            return p
        noise = rng.standard_normal(p.shape).astype(np.float32)
        if name == "kernel":
            return noise / np.sqrt(p.shape[0])
        return p * (1 + 0.1 * noise)

    return jax.tree_util.tree_map_with_path(fill, params)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_step(tmp_path_factory):
    """One step of JAX's ``make_train_step(mesh=...)`` over the 8 CPU
    devices: config_test_tiny from randomized params at a global batch of
    8 (one image a device), class dropout at 0.5. Its weights, EMA,
    batch and draws (reproduced from its key, as tests/test_torch_train.py
    reproduces them) go to ``jax_inputs.pt`` for the port's ranks.
    Returns (directory, loss, params after, EMA after)."""
    out = tmp_path_factory.mktemp("parallel")
    config = K.config.load_config(worker.TINY)
    config["optimizer"]["eps"] = worker.STEP_EPS
    model = K.config.make_model(config)
    params = randomized(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), jnp.ones((1,)),
        class_cond=jnp.zeros((1,), jnp.int32))["params"], 21)
    ema = jax.tree_util.tree_map_with_path(
        lambda path, p: jnp.array(p) * (1.0 if path[-1].key == "basis"
                                        else 0.9), params)
    opt = K.training.make_optimizer(config, j_itv2.param_group_labels(params))
    state = K.training.TrainState(step=jnp.int32(0), params=params,
                                  opt_state=opt.init(params), ema_params=ema)
    density = K.config.make_sample_density(config["model"])
    mesh = j_parallel.make_mesh(jax.devices()[:8])
    step = K.training.make_train_step(
        model, K.config.make_denoiser_wrapper(config), density, opt,
        num_classes=4, cond_dropout_rate=DROP_RATE, mesh=mesh,
        data_axis=j_parallel.DATA_AXIS)
    batch = {k: v.numpy() for k, v in worker.global_batch(1).items()}
    batch["class_cond"] = batch["class_cond"].astype(np.int32)
    key = jax.random.PRNGKey(23)
    ema_before = to_numpy(ema)
    with mesh:
        sharding = jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(None, j_parallel.DATA_AXIS))
        new_state, metrics = step(
            j_parallel.replicate(state, mesh),
            {k: jax.device_put(v, sharding) for k, v in batch.items()}, key,
            worker.EMA_DECAY)
    b = worker.GLOBAL_BATCH
    k_sigma, k_loop = jax.random.split(key)
    sigmas = np.asarray(density(k_sigma, (b,), stratified=(0, 1)))
    k_noise, k_drop, _ = jax.random.split(jax.random.fold_in(k_loop, 0), 3)
    reals = batch["reals"][0]
    noise = np.asarray(jax.random.normal(
        k_noise, j_layout.fold_images(jnp.asarray(reals)).shape)).reshape(
        reals.shape)
    drops = np.asarray(jax.random.uniform(k_drop, (b,))) < DROP_RATE
    assert drops.any() and not drops.all()
    torch.save({
        "weights": convert.state_dict_from_jax(to_numpy(params)),
        "ema": convert.state_dict_from_jax(ema_before),
        "batch": {k: torch.from_numpy(v).long() if k == "class_cond"
                  else torch.from_numpy(v) for k, v in batch.items()},
        "sigmas": torch.from_numpy(sigmas)[None],
        "noise": torch.from_numpy(noise)[None],
        "class_drop": torch.from_numpy(drops)[None],
        "ema_decay": worker.EMA_DECAY, "cond_dropout_rate": DROP_RATE},
        out / "jax_inputs.pt")
    return (out, float(metrics["loss"]),
            convert.flatten(to_numpy(new_state.params)),
            convert.flatten(to_numpy(new_state.ema_params)))


@pytest.fixture(scope="module")
def ranks(jax_step):
    """The two ranks' results (tests/torch_parallel_worker.py)."""
    out = jax_step[0]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    run_all([[sys.executable, str(REPO / "tests" / "torch_parallel_worker.py"),
              str(r), str(WORLD), str(port), str(out)] for r in range(WORLD)],
            REPO)
    return [torch.load(out / f"rank{r}.pt", weights_only=True)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def single():
    """One process at the global batch of 8, A = 1 and A = 2."""
    return {a: worker.run_steps(a) for a in (1, 2)}


def assert_state_close(got, want, atol=STATE_ATOL):
    for kind in ("params", "ema"):
        for name, t in got[kind].items():
            np.testing.assert_allclose(t.numpy(), np.asarray(want[kind][name]),
                                       rtol=0, atol=atol, err_msg=name)


def assert_bit_equal(a, b):
    for kind in ("params", "ema"):
        for name, t in a[kind].items():
            assert torch.equal(t, b[kind][name]), (kind, name)


@pytest.mark.parametrize("accum", [1, 2])
def test_two_ranks_match_one_process_at_the_global_batch(ranks, single,
                                                         accum):
    """2 ranks at 4 images against 1 process at 8, same weights and seed,
    2 steps: losses within rtol 1e-5, params and EMA within 2e-6, and the
    two ranks' params and EMA bit for bit equal."""
    want = single[accum]
    for r in ranks:
        got = r[f"steps_a{accum}"]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LOSS_RTOL)
        assert_state_close(got, want)
    assert ranks[0][f"steps_a{accum}"]["losses"] == \
        ranks[1][f"steps_a{accum}"]["losses"]
    assert_bit_equal(ranks[0][f"steps_a{accum}"], ranks[1][f"steps_a{accum}"])


def test_two_ranks_match_the_jax_mesh_step(jax_step, ranks):
    """The 2-rank step from the converted weights, with the JAX mesh step's
    sigmas, noise and class drops injected at the global batch, against
    that step: loss rtol 1e-5, params and EMA within 2e-6; the ranks bit
    for bit equal."""
    _, loss, params, ema = jax_step
    for r in ranks:
        np.testing.assert_allclose(r["jax"]["loss"], loss, rtol=LOSS_RTOL)
        assert_state_close(r["jax"], {"params": params, "ema": ema})
    assert_bit_equal(ranks[0]["jax"], ranks[1]["jax"])


@pytest.mark.parametrize("accum", [1, 2])
def test_each_rank_draws_its_rows_of_the_global_draw(ranks, single, accum):
    """Each microbatch's noise, sigmas and (dropped) class labels on rank r
    are rows 4r to 4r + 4 of the one-process draw at the global batch."""
    n = worker.GLOBAL_BATCH // accum // WORLD
    for r, result in enumerate(ranks):
        for got, want in zip(result[f"steps_a{accum}"]["draws"],
                             single[accum]["draws"]):
            for key in ("noise", "sigma", "class_cond"):
                assert torch.equal(got[key], want[key][r * n:(r + 1) * n]), key
    classes = torch.cat([d["class_cond"] for d in single[accum]["draws"]])
    assert (classes == 4).any() and (classes < 4).any()


def test_stratified_sigmas_cover_the_global_strata(ranks):
    """With a density that returns its stratified uniforms, the sigma rows
    the ranks used over both microbatches fill each of the A * W * B = 8
    strata of the global batch once."""
    u = torch.cat([torch.cat([r["strata"][i]["sigma"] for r in ranks])
                   for i in range(2)])
    assert sorted((u * u.numel()).floor().long().tolist()) == list(range(8))


def test_gns_takes_each_rank_before_the_reduce(ranks):
    """At W = 2 the small-batch signal is each rank's gradient before the
    all-reduce, so it exceeds the reduced gradient's squared norm (JAX
    test_gns_dp_shard_small_differs_from_big); the estimator takes it."""
    for r in ranks:
        small, big = (r["gns"]["grad_sq_norm_small"],
                      r["gns"]["grad_sq_norm_big"])
        assert small > big > 0, (small, big)
    assert ranks[0]["gns"] == ranks[1]["gns"]
    estimator = gns.GradientNoiseScale()
    assert np.isfinite(estimator.update(small, big, 4, 8))


def test_features_gathered_over_two_ranks_equal_one_process(ranks):
    """compute_features at n = 13, batch 4: each rank holds the matrix one
    process computes (rounds of 4 + 4 and 3 + 3 rows, trimmed to 13)."""
    want = worker.run_features(13, 4)
    assert want.shape == (13, 5)
    for r in ranks:
        assert torch.equal(r["features"], want)


def test_group_and_mesh(ranks):
    """Each worker joined a group of 2 at its rank; make_mesh is 1-D over
    both, its axis "data"."""
    assert [(r["rank"], r["world"]) for r in ranks] == [(0, 2), (1, 2)]
    assert all(r["mesh"] == {"names": ["data"], "size": 2} for r in ranks)


def test_no_group_without_torchrun(monkeypatch):
    """Without torchrun's environment or an address, initialize_distributed
    does nothing and every function sees one process at rank 0."""
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    assert parallel.initialize_distributed() is False
    assert (parallel.process_index(), parallel.process_count(),
            parallel.is_main_process()) == (0, 1, True)
    t = torch.arange(12).reshape(6, 2)
    assert torch.equal(parallel.local_rows(t, 1, 3), t[2:4])
    assert torch.equal(parallel.local_rows(t, 0, 1), t)
    with pytest.raises(ValueError, match="do not split over 4 ranks"):
        parallel.local_rows(t, 0, 4)
    with pytest.raises(ValueError, match="for rank 1"):
        parallel.local_rows(t, 1, 1)


def test_default_device_under_torchrun(monkeypatch):
    """With no device named, a rank under torchrun takes cuda:LOCAL_RANK."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert utils.default_device() == torch.device("cuda", 3)
    assert utils.default_device("cpu") == torch.device("cpu")


class Items:
    """A dataset whose item i is its index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"image": np.full((1,), i, np.float32), "class": i % 3}


def indices(loader):
    return [batch["image"][:, 0].astype(int).tolist() for batch in loader]


def test_loader_strides_partition_each_epoch():
    """Two processes' loaders over 23 items at batch 3: each reads its
    stride of the same shuffle, trimmed to 11 items (3 batches), the two
    disjoint, as the JAX loader's strides; a per-rank start_batch resumes
    mid-epoch at the same batches."""
    from k_diffusion_tpu import data as j_data
    dataset = Items(23)
    for epoch in range(2):
        seen = []
        for rank in range(2):
            loader = data.DataLoader(dataset, 3, seed=5, num_workers=2,
                                     process_index=rank, process_count=2)
            j_loader = j_data.DataLoader(dataset, 3, seed=5, num_workers=2,
                                         process_index=rank, process_count=2)
            loader.epoch = j_loader.epoch = epoch
            got = indices(loader)
            assert got == [b["image"][:, 0].astype(int).tolist()
                           for b in j_loader]
            assert len(loader) == 3 and len(got) == 3
            order = np.random.RandomState(5 + epoch).permutation(23)
            assert sum(got, []) == order[rank::2][:9].tolist()
            seen += sum(got, [])
            resumed = data.DataLoader(dataset, 3, seed=5, num_workers=2,
                                      process_index=rank, process_count=2)
            resumed.epoch, resumed.start_batch = epoch, 2
            assert indices(resumed) == got[2:]
        assert len(set(seen)) == 18


def tiny_state(seed=0):
    config = worker.tiny_config()
    model = worker.KT.config.make_model(
        config, device="cpu", generator=torch.Generator().manual_seed(seed))
    return worker.KT.training.init_train_state(
        model, worker.KT.training.make_optimizer(config, model))


def trained_state():
    """config_test_tiny after one step: its optimizer holds moments."""
    config = worker.tiny_config()
    state = worker.make_state(config)
    step = worker.KT.training.make_train_step(
        worker.KT.config.make_denoiser_wrapper(config),
        worker.KT.config.make_sample_density(config["model"]), num_classes=4)
    step(state, worker.rows(worker.global_batch(1), 0, 1),
         torch.Generator().manual_seed(0), 0.5)
    return state


def flat_state(state):
    import torch.utils._pytree as pytree
    return pytree.tree_flatten(
        {"model": state.model.state_dict(),
         "ema": state.ema_model.state_dict(),
         "optimizer": state.optimizer.state_dict(), "step": state.step})


def assert_same_state(a, b):
    (la, sa), (lb, sb) = flat_state(a), flat_state(b)
    assert sa == sb
    for x, y in zip(la, lb):
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x == y), (x, y)


def test_sharded_checkpoint_round_trip(tmp_path):
    """save_checkpoint_sharded then load_checkpoint (a directory goes to
    load_checkpoint_sharded) into a differently seeded state: the model,
    the EMA, every optimizer moment and the step bit for bit, and the host
    dict; the host sidecar loads with weights_only."""
    state = trained_state()
    host = {"epoch": 2, "batch_in_epoch": 5, "ema_stats": {"loss": 0.5},
            "gns_stats": None}
    for async_save in (True, False):
        path = checkpoint.save_checkpoint_sharded(
            tmp_path / f"run_{async_save}.orbax", state, host,
            async_save=async_save)
        checkpoint.wait_for_checkpoints()
        assert path.is_dir()
        assert torch.load(f"{path}_host.pt", weights_only=True)["host"] == host
        loaded, got_host = checkpoint.load_checkpoint(path, tiny_state(9))
        assert got_host == host
        assert_same_state(loaded, state)


def test_state_json_pointer_waits_for_the_commit(tmp_path):
    """The {name}_state.json pointer keeps naming the last whole
    checkpoint while a save is in flight; the next save's wait, or
    wait_for_checkpoints, moves it (JAX
    test_state_json_pointer_deferred_until_commit)."""
    state = trained_state()
    name = tmp_path / "run"
    p0 = checkpoint.save_checkpoint_sharded(tmp_path / "a.orbax", state,
                                            {"step": 1})
    checkpoint.wait_for_checkpoints()
    checkpoint.write_state_json(name, p0)
    p1 = checkpoint.save_checkpoint_sharded(tmp_path / "b.orbax", state,
                                            {"step": 2})
    checkpoint.write_state_json_after_commit(name, p1)
    assert checkpoint.latest_checkpoint(name) == str(p0)
    p2 = checkpoint.save_checkpoint_sharded(tmp_path / "c.orbax", state,
                                            {"step": 3})
    assert checkpoint.latest_checkpoint(name) == str(p1)
    checkpoint.write_state_json_after_commit(name, p2)
    checkpoint.wait_for_checkpoints()
    assert checkpoint.latest_checkpoint(name) == str(p2)
    _, host = checkpoint.load_checkpoint(checkpoint.latest_checkpoint(name),
                                         tiny_state(9))
    assert host == {"step": 3}


def test_nonzero_rank_writes_nothing(tmp_path, monkeypatch, capsys):
    """train.main with the rank monkeypatched to 1 trains, samples its
    demos and saves nothing: no checkpoint, demo, CSV or pointer, and no
    output (JAX test_train_cli_nonzero_rank_writes_nothing)."""
    monkeypatch.setattr(parallel, "process_index", lambda: 1)
    monkeypatch.chdir(tmp_path)
    t_train.main(["--config", str(worker.TINY), "--device", "cpu",
                  "--batch-size", "4", "--end-step", "3", "--demo-every", "2",
                  "--save-every", "2", "--evaluate-every", "0",
                  "--sample-n", "4", "--num-workers", "1",
                  "--name", str(tmp_path / "run")])
    assert sorted(p.name for p in tmp_path.iterdir()) == []
    assert capsys.readouterr().out == ""


def torchrun(name, *flags):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(WORLD), "-m", "k_diffusion_tpu_torch.train",
            "--config", str(worker.TINY), "--device", "cpu",
            "--batch-size", "8", "--num-workers", "1", "--sample-n", "4",
            "--evaluate-every", "0", "--checkpoint-format", "orbax", "--gns",
            "--name", str(name), *flags]


def test_trainer_under_torchrun_resumes_bit_identically(tmp_path):
    """python -m torch.distributed.run --nproc_per_node 2 on the trainer,
    --device cpu, --checkpoint-format orbax, --gns with no accumulation:
    a 4-step run (saves at 2 and 4, a demo at 4 from both ranks' samples)
    and a run stopped at 2 and resumed from its state pointer to 4 end
    with bit-equal checkpoints; only rank 0 printed and wrote the pointer,
    the demo and the host files."""
    full, split = tmp_path / "full", tmp_path / "split"
    out_full, out_split = run_all(
        [torchrun(full, "--end-step", "4", "--save-every", "2",
                  "--demo-every", "4"),
         torchrun(split, "--end-step", "2", "--save-every", "2",
                  "--demo-every", "0")], tmp_path)
    out_resumed, = run_all([torchrun(split, "--end-step", "4", "--save-every",
                                     "2", "--demo-every", "0")], tmp_path)
    for out in (out_full, out_split, out_resumed):
        assert out.count("World: 2 process(es)") == 1, out
    assert f"Resuming from {split}_00000002.orbax" in out_resumed
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted([
        "full_00000002.orbax", "full_00000002.orbax_host.pt",
        "full_00000004.orbax", "full_00000004.orbax_host.pt",
        "full_demo_00000004.png", "full_metrics.csv", "full_state.json",
        "split_00000002.orbax", "split_00000002.orbax_host.pt",
        "split_00000004.orbax", "split_00000004.orbax_host.pt",
        "split_metrics.csv", "split_state.json"])
    assert checkpoint.latest_checkpoint(split) == f"{split}_00000004.orbax"
    assert t_image.from_png(f"{full}_demo_00000004.png").shape == (64, 64, 3)
    got, host = checkpoint.load_checkpoint(f"{split}_00000004.orbax",
                                           tiny_state(7))
    want, want_host = checkpoint.load_checkpoint(f"{full}_00000004.orbax",
                                                 tiny_state(8))
    assert_same_state(got, want)
    assert np.isfinite(host["gns_stats"]["gradient_noise_scale"])
    for key in ("step", "epoch", "batch_in_epoch", "gns_stats", "ema_sched"):
        assert host[key] == want_host[key], key


# ---- every kernel launches on its tensors' card -----------------------------

class Guard:
    """Stands in for ``torch.cuda.device``: records the device entered."""
    current = None

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        self.outer, Guard.current = Guard.current, self.device

    def __exit__(self, *exc):
        Guard.current = self.outer


class FakeLibrary:
    """Stands in for a kernel library: each C entry point records the
    device the guard holds when it is called and returns 0; an occupancy
    query's count (a ``ctypes.byref`` argument) comes back as 1."""

    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, entry):
        def call(*args):
            for arg in args:
                if type(arg).__name__ == "CArgObject":
                    arg._obj.value = 1
            self.calls.append((entry, Guard.current))
            return 0
        return call


def bf16(*shape, dtype=torch.bfloat16):
    return torch.randn(shape).to(dtype)


def f32(*shape):
    return bf16(*shape, dtype=torch.float32)


def launch_cases():
    """Each C entry point that launches kernels -> a call of its wrapper
    at a small shape the wrapper takes."""
    from k_diffusion_tpu_torch.ops.kernels import (
        flash, fused_ffn, fused_mapping, fused_qkv, global_packed, na2d)
    x, pos, scale = bf16(1, 8, 8, 64), torch.zeros(8, 8, 2), bf16(1, 64)
    qkv = (x, pos, scale, f32(64, 192), torch.ones(2), 2)
    grads = [bf16(1, 8, 8, 64) for _ in range(3)]
    ffn = (bf16(1, 64, 64), scale, f32(64, 256), f32(128, 64))
    maps = [bf16(1, 8, 8, 64) for _ in range(5)]
    heads = [bf16(1, 8, 8, 2, 32) for _ in range(5)]
    seq = [bf16(1, 16, 64) for _ in range(5)]
    flat = [bf16(1, 4, 2, 32) for _ in range(5)]
    flat32 = [f32(1, 4, 2, 32) for _ in range(5)]
    proj = [bf16(1, 8, 8, 128) for _ in range(4)]
    # the float32 forms' operands
    qkv32 = (f32(1, 8, 8, 64), pos, f32(1, 64), f32(64, 192), torch.ones(2), 2)
    ffn32 = (f32(1, 64, 64), f32(1, 64), f32(64, 256), f32(128, 64))
    seq32 = [f32(1, 16, 64) for _ in range(5)]
    maps32 = [f32(1, 8, 8, 64) for _ in range(5)]
    heads32 = [f32(1, 8, 8, 2, 32) for _ in range(5)]
    return {
        "kdt_fused_qkv": lambda: fused_qkv.prologue_forward(*qkv),
        "kdt_fused_qkv_bwd": lambda: fused_qkv.prologue_backward(*qkv, *grads),
        "kdt_ffn_fwd": lambda: fused_ffn.ffn_forward(*ffn),
        "kdt_ffn_bwd": lambda: fused_ffn.ffn_backward(*ffn, bf16(1, 64, 64)),
        "kdt_mapping": lambda: fused_mapping.mapping_forward(
            bf16(2, 64), torch.ones(64), torch.ones(64),
            [(torch.ones(64), f32(64, 256), f32(128, 64))]),
        "kdt_na2d_packed": lambda: na2d.packed_forward(*maps[:3], 1, 7),
        "kdt_na2d_packed_bwd": lambda: na2d.packed_backward(
            *maps[:4], f32(1, 1, 8, 8), maps[4], 1, 7),
        "kdt_na2d_overlap_add": lambda: na2d.overlap_add(
            f32(1, 1, 1, na2d.HALO_KEYS, 64), f32(1, 1, 1, na2d.HALO_KEYS, 64),
            8, 8, 7),
        "kdt_na2d_heads": lambda: na2d.heads_forward(*heads[:3], 7),
        "kdt_na2d_heads_bwd": lambda: na2d.heads_backward(
            *heads[:4], f32(1, 2, 8, 8), heads[4], 7),
        "kdt_na2d_proj": lambda: na2d.proj_forward(*proj, f32(128, 128), 2,
                                                   7),
        "kdt_global_packed": lambda: global_packed.packed_forward(*seq[:3], 1),
        "kdt_global_packed_bwd": lambda: global_packed.packed_backward(
            *seq[:4], f32(1, 1, 16), seq[4], 1),
        "kdt_flash_fwd": lambda: flash.flash_forward(*flat[:3]),
        "kdt_flash_bwd": lambda: flash.flash_backward(
            *flat[:4], f32(1, 2, 4), flat[4]),
        "kdt_flash_fwd_f32": lambda: flash.flash_forward(*flat32[:3]),
        "kdt_flash_bwd_f32": lambda: flash.flash_backward(
            *flat32[:4], f32(1, 2, 4), flat32[4]),
        "kdt_fused_qkv_f32": lambda: fused_qkv.prologue_forward(*qkv32),
        "kdt_fused_qkv_bwd_f32": lambda: fused_qkv.prologue_backward(
            *qkv32, *(f32(1, 8, 8, 64) for _ in range(3))),
        "kdt_ffn_fwd_f32": lambda: fused_ffn.ffn_forward(*ffn32),
        "kdt_ffn_fwd_f32_wide": lambda: fused_ffn.ffn_forward(
            f32(1, 64, 192), f32(1, 192), f32(192, 512), f32(256, 192)),
        "kdt_ffn_bwd_f32": lambda: fused_ffn.ffn_backward(*ffn32,
                                                          f32(1, 64, 64)),
        "kdt_mapping_f32": lambda: fused_mapping.mapping_forward(
            f32(2, 64), torch.ones(64), torch.ones(64),
            [(torch.ones(64), f32(64, 256), f32(128, 64))],
            dtype=torch.float32),
        "kdt_global_packed_f32": lambda: global_packed.packed_forward(
            *seq32[:3], 1),
        "kdt_global_packed_bwd_f32": lambda: global_packed.packed_backward(
            *seq32[:4], f32(1, 1, 16), seq32[4], 1),
        "kdt_na2d_packed_f32": lambda: na2d.packed_forward(*maps32[:3], 1, 7),
        "kdt_na2d_packed_bwd_f32": lambda: na2d.packed_backward(
            *maps32[:4], f32(1, 1, 8, 8), maps32[4], 1, 7),
        "kdt_na2d_heads_f32": lambda: na2d.heads_forward(*heads32[:3], 7),
        "kdt_na2d_heads_bwd_f32": lambda: na2d.heads_backward(
            *heads32[:4], f32(1, 2, 8, 8), heads32[4], 7),
        "kdt_na2d_proj_f32": lambda: na2d.proj_forward(
            *(f32(1, 8, 8, 128) for _ in range(4)), f32(128, 128), 2, 7),
        "kdt_na2d_overlap_add_f32": lambda: na2d.overlap_add(
            f32(1, 1, 1, na2d.HALO_KEYS, 64), f32(1, 1, 1, na2d.HALO_KEYS, 64),
            8, 8, 7, dtype=torch.float32),
    }


LAUNCHES = sorted(launch_cases())


def test_every_launch_entry_point_is_covered():
    """The cases below name every C entry point that the kernel modules
    launch through ``_build.launch``."""
    import re
    sources = (REPO / "k_diffusion_tpu_torch" / "ops" / "kernels").glob("*.py")
    named = {m for path in sources for m in re.findall(
        r'_build\.launch\(\s*lib, "(kdt_\w+)"', path.read_text())}
    assert named == set(LAUNCHES)


@pytest.mark.parametrize("entry", LAUNCHES)
def test_kernel_launches_under_its_tensors_device(entry, monkeypatch):
    """Every wrapper calls its kernel under ``torch.cuda.device(<its
    input's device>)``, and its occupancy queries under the device they
    ask about, so that a rank on cuda:N launches on cuda:N whatever its
    current device is. One card cannot show it: on the CPU the wrapper's
    launch path runs with the library, the CUDA checks and the guard
    stood in for."""
    from k_diffusion_tpu_torch.ops.kernels import (
        COUNTERS, _build, fused_ffn, fused_mapping, fused_qkv)
    calls = []
    for module, attr in COUNTERS.values():
        monkeypatch.setattr(module, attr, getattr(module, attr))
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(_build, "load", lambda name, **_: FakeLibrary(calls))
    monkeypatch.setattr(_build, "require_cuda", lambda x, what: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: None)
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    cached = (fused_qkv._blocks_per_sm, fused_ffn._clusters,
              fused_ffn._clusters_f32, fused_mapping.cluster_size,
              fused_mapping.f32_plan)
    for fn in cached:
        fn.cache_clear()
    try:
        launch_cases()[entry]()
    finally:
        for fn in cached:
            fn.cache_clear()
    assert calls and all(device is not None for _, device in calls), calls
    assert calls[-1] == (entry, torch.device("cpu")), calls

"""The port's training entry point and its companions, in-process on the
CPU, as tests/test_cli_chain.py runs the JAX package's: ``python -m
k_diffusion_tpu_torch.train`` on configs/config_test_tiny.json (synthetic
data, 4 classes with dropout, augmentation at 0.12), a resumed run against
an uninterrupted one (bit for bit), then convert_for_inference ->
config_from_inference -> sample -> make_grid; the checkpointing flags, the
ViT and a U-Net with a variance head through the entry point; FID and KID
into the metrics CSV with random Inception weights in a temporary cache,
and "Evaluation disabled" without them; and the flags and devices that
raise."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import k_diffusion_tpu_torch as KT
from k_diffusion_tpu_torch import checkpoint
from k_diffusion_tpu_torch import config_from_inference as t_config_from_inference
from k_diffusion_tpu_torch import convert_for_inference as t_convert
from k_diffusion_tpu_torch import make_grid as t_make_grid
from k_diffusion_tpu_torch import sample as t_sample
from k_diffusion_tpu_torch import train as t_train
from k_diffusion_tpu_torch.utils import image as t_image
from test_torch_float32 import na_head_dim_128

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TINY = str(REPO / "configs" / "config_test_tiny.json")


def train(name, *flags):
    return t_train.main(["--config", TINY, "--device", "cpu", "--batch-size", "4",
                  "--num-workers", "1", "--sample-n", "4", "--name",
                  str(name), *flags])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """An uninterrupted 4-step run (saves and demos at 2 and 4), and a run
    stopped at 2 and resumed to 4 through its ``_state.json``."""
    tmp = tmp_path_factory.mktemp("train_cli")
    train(tmp / "full", "--end-step", "4", "--save-every", "2",
          "--demo-every", "2")
    train(tmp / "split", "--end-step", "2", "--save-every", "2",
          "--demo-every", "0")
    train(tmp / "split", "--end-step", "4", "--save-every", "2",
          "--demo-every", "0")
    return tmp


def test_train_reports_its_rate_since_the_last_print(tmp_path, capsys):
    """The 25-step print carries images/s over the step bodies and with the
    loader's waits; main returns that window: steps 1-25 of a 27-step run
    (the print at 0 opens it, the one at 25 closes it)."""
    window = train(tmp_path / "rate", "--end-step", "27", "--save-every",
                   "0", "--demo-every", "0", "--evaluate-every", "0")
    assert window["steps"] == 25 and window["images"] == 25 * 4
    assert window["body_s"] > 0 and window["wait_s"] >= 0
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("Epoch:")]
    assert len(lines) == 2 and all("images/s: " in l and "with loader waits"
                                   in l for l in lines)


def load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def test_train_writes_checkpoints_state_and_demos(runs):
    for step in (2, 4):
        assert (runs / f"full_{step:08}.ckpt").exists()
        demo = t_image.from_png(runs / f"full_demo_{step:08}.png")
        assert demo.shape == (64, 64, 3)  # 4 samples of 32 x 32, 2 a row
    assert checkpoint.latest_checkpoint(runs / "full") == \
        str(runs / "full_00000004.ckpt")
    payload = load(runs / "full_00000004.ckpt")
    host = payload["host"]
    assert payload["step"] == host["step"] == 4
    assert host["config"]["model"]["type"] == "image_transformer_v2"
    assert host["epoch"] == 0 and host["batch_in_epoch"] == 4
    assert host["elapsed"] > 0 and np.isfinite(host["ema_stats"]["loss"])
    assert host["ema_sched"]["last_epoch"] == 4


def test_resume_equals_the_uninterrupted_run(runs):
    """The resumed run's step-4 checkpoint against the uninterrupted
    run's: params, EMA, every optimizer moment and step count, bit for
    bit; the host state equal but for the elapsed seconds."""
    a, b = load(runs / "full_00000004.ckpt"), load(runs / "split_00000004.ckpt")
    for key in ("model", "model_ema"):
        assert a[key].keys() == b[key].keys()
        for name in a[key]:
            assert torch.equal(a[key][name], b[key][name]), (key, name)
    sa, sb = a["optimizer"]["optimizer"]["state"], b["optimizer"]["optimizer"]["state"]
    assert sa.keys() == sb.keys() and len(sa) > 0
    for i in sa:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[i][key], sb[i][key]), (i, key)
    assert a["optimizer"]["optimizer"]["param_groups"] == \
        b["optimizer"]["optimizer"]["param_groups"]
    ha, hb = dict(a["host"]), dict(b["host"])
    ha.pop("elapsed"), hb.pop("elapsed")
    assert ha == hb
    # the 2-step checkpoint differs from the 4-step one: the steps trained
    c = load(runs / "split_00000002.ckpt")
    assert not all(torch.equal(c["model"][n], a["model"][n]) for n in a["model"])


def test_chain(runs, tmp_path, monkeypatch):
    """convert_for_inference (EMA, bfloat16) -> config_from_inference ->
    the sample entry point on the CPU -> make_grid."""
    monkeypatch.chdir(tmp_path)
    ckpt = runs / "full_00000004.ckpt"
    inference = t_convert.main([str(ckpt), str(tmp_path / "model.safetensors")])
    weights, config = checkpoint.load_inference(inference)
    ema = load(ckpt)["model_ema"]
    assert weights.keys() == ema.keys()
    for name, w in weights.items():
        assert w.dtype == torch.bfloat16
        assert torch.equal(w, ema[name].to(torch.bfloat16)), name
    cfg_out = t_config_from_inference.main([str(inference),
                                            str(tmp_path / "config.json")])
    assert json.loads(cfg_out.read_text()) == config == load(ckpt)["host"]["config"]
    paths = t_sample.main(["--checkpoint", str(inference), "--config",
                           str(cfg_out), "--device", "cpu", "-n", "4",
                           "--batch-size", "4", "--steps", "5",
                           "--prefix", "out"])
    assert [p.name for p in paths] == [f"out_{i:05}.png" for i in range(4)]
    grid = t_make_grid.main([*map(str, paths), "-o", "grid.png"])
    pixels = t_image.from_png(grid)
    assert pixels.shape == (64, 64, 3)
    assert np.array_equal(pixels[:32, 32:], t_image.from_png(paths[1]))


def test_gns_with_accumulation(tmp_path):
    """--gns with two microbatches: the estimator is saved, finite."""
    train(tmp_path / "gns", "--end-step", "2", "--grad-accum-steps", "2",
          "--gns", "--demo-every", "0", "--save-every", "0")
    stats = load(tmp_path / "gns_00000002.ckpt")["host"]["gns_stats"]
    assert np.isfinite(stats["gradient_noise_scale"])
    with pytest.raises(ValueError, match="grad-accum-steps"):
        train(tmp_path / "gns1", "--end-step", "1", "--gns")


def test_resume_inference_reset_ema_and_profile(runs, tmp_path):
    """--resume-inference starts from an inference file's weights (another
    seed's init would be far from them); --reset-ema restarts the model
    from a checkpoint's EMA; --profile-dir writes a trace of steps
    10-15. One update at the warm-up lr moves a weight by ~1e-5."""
    def far(a, b):
        return max((a[n].float() - b[n].float()).abs().max().item() for n in a)

    inference = t_convert.main([str(runs / "full_00000004.ckpt"),
                                str(tmp_path / "m.safetensors")])
    weights, _ = checkpoint.load_inference(inference)
    train(tmp_path / "inf", "--end-step", "1", "--seed", "7",
          "--resume-inference", str(inference), "--demo-every", "0")
    model = load(tmp_path / "inf_00000001.ckpt")["model"]
    assert far(model, weights) < 1e-3
    # a checkpoint whose EMA is far from its model (four steps leave them
    # close)
    halved = load(runs / "full_00000004.ckpt")
    halved["model_ema"] = {n: t * 0.5 for n, t in halved["model_ema"].items()}
    torch.save(halved, tmp_path / "halved.ckpt")
    train(tmp_path / "reset", "--end-step", "5", "--reset-ema", "--resume",
          str(tmp_path / "halved.ckpt"), "--demo-every", "0")
    model = load(tmp_path / "reset_00000005.ckpt")["model"]
    assert far(model, halved["model_ema"]) < 1e-3
    assert far(halved["model"], halved["model_ema"]) > 0.1
    train(tmp_path / "prof", "--end-step", "16", "--save-every", "0",
          "--demo-every", "0", "--profile-dir", str(tmp_path / "trace"))
    trace = json.loads((tmp_path / "trace" / "trace_00000015.json").read_text())
    assert trace["traceEvents"]


@pytest.mark.parametrize("flags", [["--checkpointing"],
                                   ["--checkpointing", "--remat-levels", "0"]])
def test_checkpointing_flags_train_as_the_plain_run(runs, tmp_path, flags):
    """--checkpointing (every level) and --remat-levels (a digit is a level
    index: 0 is config_test_tiny's one level) train 2 steps and save, to
    the same weights as the run without them, bit for bit."""
    train(tmp_path / "remat", "--end-step", "2", "--save-every", "2",
          "--demo-every", "0", *flags)
    want = load(runs / "full_00000002.ckpt")
    got = load(tmp_path / "remat_00000002.ckpt")
    for key in ("model", "model_ema"):
        assert got[key].keys() == want[key].keys()
        for name, value in want[key].items():
            assert torch.equal(got[key][name], value), (key, name)


VIT = {"type": "image_transformer_v1", "input_channels": 3,
       "input_size": [16, 16], "patch_size": 2, "depth": 2, "width": 128,
       "dropout_rate": 0.1}
UNET = {"type": "image_v1", "input_channels": 3, "input_size": [16, 16],
        "mapping_out": 64, "depths": [1, 1], "channels": [32, 64],
        "self_attn_depths": [False, True], "has_variance": True,
        "dropout_rate": 0.05, "augment_prob": 0.12}


@pytest.mark.parametrize("model", [VIT, UNET], ids=["vit", "unet_variance"])
def test_model_families_train_through_the_entry_point(tmp_path, model):
    """The ViT (class-conditional, dropout on) and a U-Net with the
    variance head (DenoiserWithVariance, the augment wrapper) train 2 steps
    on synthetic data, save, and sample a demo grid."""
    config = json.loads(Path(TINY).read_text())
    if model["type"] == "image_v1":  # the U-Net takes no classes
        config["dataset"]["num_classes"] = 0
    config["model"] = {**model, "sigma_data": 0.5, "sigma_min": 1e-2,
                       "sigma_max": 80,
                       "sigma_sample_density": {"type": "lognormal",
                                                "mean": -1.2, "std": 1.2}}
    path = tmp_path / "config.json"
    path.write_text(json.dumps(config))
    t_train.main(["--config", str(path), "--device", "cpu", "--batch-size",
                  "4", "--num-workers", "1", "--sample-n", "4", "--name",
                  str(tmp_path / "run"), "--end-step", "2", "--save-every",
                  "2", "--demo-every", "2"])
    payload = load(tmp_path / "run_00000002.ckpt")
    assert payload["host"]["config"]["model"]["type"] == model["type"]
    assert np.isfinite(payload["host"]["ema_stats"]["loss"])
    demo = t_image.from_png(tmp_path / "run_demo_00000002.png")
    assert demo.shape == (32, 32, 3)


@pytest.mark.parametrize("flags,item", [
    (["--wandb-project", "p"], "queue 1, item 8"),
])
def test_unported_flags_raise(tmp_path, flags, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        t_train.main(["--config", TINY, "--name", str(tmp_path / "x"),
                      "--device", "cpu", *flags])
    assert not list(tmp_path.iterdir())


def test_mixed_precision_no_trains_na_head_dim_128(tmp_path):
    """The flagship with head dim 128 at its neighborhood levels (no config
    ships one) takes ``--mixed-precision no``: ``config.card_dtypes`` gives
    it float32 on the card (where the trainer turns TF32 on), and on the
    CPU, narrowed to 32 x 32 at patch 2 with one layer a level, the trainer
    takes 2 float32 steps with that flag and saves a finite loss."""
    config = na_head_dim_128()
    assert KT.config.card_dtypes(config) == (
        (torch.bfloat16, torch.float32), None)
    config["model"].update(
        input_size=[32, 32], patch_size=[2, 2], widths=[128, 256, 256],
        depths=[1, 1, 1], d_ffs=[256, 512, 512], mapping_width=64,
        mapping_d_ff=128, augment_prob=0.0)
    config["dataset"] = {"type": "synthetic", "length": 8}
    path = tmp_path / "na128.json"
    path.write_text(json.dumps(config))
    t_train.main(["--config", str(path), "--device", "cpu",
                  "--mixed-precision", "no", "--batch-size", "2",
                  "--num-workers", "1", "--name", str(tmp_path / "run"),
                  "--end-step", "2", "--save-every", "2", "--demo-every", "0",
                  "--evaluate-every", "0"])
    payload = load(tmp_path / "run_00000002.ckpt")
    assert payload["host"]["config"]["model"]["self_attns"][0]["d_head"] == 128
    assert np.isfinite(payload["host"]["ema_stats"]["loss"])


def write_random_inception_npz(path, seed=0):
    """Random InceptionV3W weights in the layout that
    scripts/convert_inception_weights.py writes: architecture-ordered
    (name, OIHW kernel or 1-d norm parameter) pairs; He-scaled kernels, so
    that the features keep the input's variation through 94 ReLU layers."""
    from k_diffusion_tpu_torch.models import inception_v3
    rng = np.random.RandomState(seed)
    arrays = {}
    for i, (cout, cin, kh, kw) in enumerate(inception_v3.conv_shape_order()):
        arrays[f"layers.{i}.weight"] = rng.normal(
            0.0, (2.0 / (kh * kw * cin)) ** 0.5,
            (cout, cin, kh, kw)).astype(np.float32)
        arrays[f"layers.{i}.scale"] = np.ones(cout, np.float32)
        arrays[f"layers.{i}.bias"] = np.zeros(cout, np.float32)
        arrays[f"layers.{i}.running_mean"] = np.zeros(cout, np.float32)
        arrays[f"layers.{i}.running_var"] = np.ones(cout, np.float32)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **arrays)


@pytest.fixture
def inception_cache(tmp_path, monkeypatch):
    """A cache holding random Inception weights as the .npz export."""
    write_random_inception_npz(
        tmp_path / "cache" / "k-diffusion" / "inception-2015-12-05.npz")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))


def metrics_rows(name):
    lines = Path(f"{name}_metrics.csv").read_text().splitlines()
    assert lines[0] == "step,time,loss,fid,kid"
    return [[float(v) for v in line.split(",")] for line in lines[1:]]


def test_train_evaluates_into_the_metrics_csv(tmp_path, inception_cache,
                                              capsys):
    """--evaluate-every 2 on a 4-step run: FID and KID of 4 EMA samples
    against 4 reals at steps 2 and 4, finite, one CSV row each."""
    train(tmp_path / "run", "--end-step", "4", "--save-every", "0",
          "--demo-every", "0", "--evaluate-every", "2", "--evaluate-n", "4")
    rows = metrics_rows(tmp_path / "run")
    assert [r[0] for r in rows] == [2, 4]
    for step, elapsed, loss, fid, kid in rows:
        assert elapsed > 0 and np.isfinite([loss, fid, kid]).all()
        assert fid > 0
    out = capsys.readouterr().out
    assert "Computing features for reals..." in out
    assert out.count("FID: ") == 2


def test_evaluate_only_writes_one_row(tmp_path, inception_cache):
    assert train(tmp_path / "run", "--evaluate-only",
                 "--evaluate-n", "4") is None
    rows = metrics_rows(tmp_path / "run")
    assert len(rows) == 1 and rows[0][0] == 0
    assert np.isfinite(rows[0][3:]).all()
    assert not list(tmp_path.glob("run_*.ckpt"))


@pytest.mark.parametrize("extractor,named", [
    ("inception", "Inception weights not found"),
    ("clip", "openai/clip-vit-base-patch16"),
    ("dinov2", "facebook/dinov2-large")])
def test_evaluation_is_disabled_without_weights(tmp_path, monkeypatch,
                                                capsys, extractor, named):
    """An extractor whose weights are absent: the JAX trainer's message,
    naming what is missing, and training goes on; --evaluate-only then
    raises."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "empty"))
    train(tmp_path / "run", "--end-step", "1", "--save-every", "0",
          "--demo-every", "0", "--evaluate-every", "1", "--evaluate-n", "4",
          "--evaluate-with", extractor)
    out = capsys.readouterr().out
    assert "Evaluation disabled (feature extractor unavailable: " in out
    assert named in out and "FID: " not in out
    assert metrics_rows(tmp_path / "run") == []
    with pytest.raises(ValueError, match="evaluation is disabled"):
        train(tmp_path / "run", "--evaluate-only", "--evaluate-with",
              extractor)


def test_missing_resume_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no such file"):
        train(tmp_path / "x", "--resume", str(tmp_path / "x_00000002.ckpt"))


def test_no_card_raises(tmp_path, monkeypatch):
    """With no --device the trainer runs on the card, and raises where
    there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_train.main(["--config", TINY, "--name", str(tmp_path / "x")])

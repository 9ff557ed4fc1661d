"""The port's data pipeline (k_diffusion_tpu_torch/data.py and the PNG
reader of utils/image.py) against the JAX package's on the CPU: the
loader's batch order, the datasets' images (exact where nothing is
resampled), the resize against Pillow's bicubic (at most 2/255), PNG
read-back for every colour type and row filter, and the formats that
raise. The test writes every file it reads from seeded numpy data."""

import gzip
import pickle
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from k_diffusion_tpu import data as j_data
from k_diffusion_tpu import utils as j_utils
from k_diffusion_tpu_torch import data as t_data
from k_diffusion_tpu_torch.utils import image as t_image

torch.set_num_threads(2)

# Pillow's bicubic works in fixed point, torch's in float: an output pixel
# may round to the neighbouring level
RESIZE_TOL = 2 / 255


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def write_png(path, pixels, filters, color=None, depth=8, interlace=0,
              idat_parts=1):
    """Writes uint8 (h, w, c) ``pixels`` as a PNG with row ``filters[y %
    len(filters)]`` (0 None, 1 Sub, 2 Up, 3 Avg, 4 Paeth), each computed
    from the original bytes as an encoder does; the IDAT stream split into
    ``idat_parts`` chunks."""
    h, w, c = pixels.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c] if color is None else color
    rows = pixels.reshape(h, w * c).astype(np.int16)
    out = []
    for y in range(h):
        x = rows[y]
        up = rows[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(c, np.int16), x[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int16), up[:-c]])
        kind = filters[y % len(filters)]
        pred = [0, left, up, (left + up) // 2, _paeth(left, up, upleft)][kind]
        out.append(bytes([kind]) + ((x - pred) % 256).astype(np.uint8).tobytes())
    stream = zlib.compress(b"".join(out))
    step = -(-len(stream) // idat_parts)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                     + b"".join(_chunk(b"IDAT", stream[i:i + step])
                                for i in range(0, len(stream), step))
                     + _chunk(b"IEND", b""))
    return path


def pixels(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


# ---- PNG ----------------------------------------------------------------

@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [4, 3, 2, 1, 0]])
def test_png_read_back_exact(tmp_path, channels, filters):
    """Every colour type under every row filter (and all five mixed, the
    stream in three IDAT chunks): the pixels back exactly, and equal to
    Pillow's reading of the file."""
    x = pixels(channels, (13, 17, channels))
    path = write_png(tmp_path / "x.png", x, filters,
                     idat_parts=3 if len(filters) > 1 else 1)
    got = t_image.from_png(path)
    assert got.dtype == np.uint8 and np.array_equal(got, x)
    pil = np.asarray(Image.open(path))
    assert np.array_equal(got, pil.reshape(got.shape))


def test_png_written_by_pillow_and_to_png(tmp_path):
    """Pillow's encoder picks its own filters per row; to_png writes None
    rows. Both read back exactly."""
    x = pixels(5, (40, 31, 3))
    Image.fromarray(x).save(tmp_path / "pil.png", optimize=True)
    assert np.array_equal(t_image.from_png(tmp_path / "pil.png"), x)
    t_image.to_png(torch.from_numpy(x).float() / 127.5 - 1,
                   tmp_path / "ours.png")
    assert np.array_equal(t_image.from_png(tmp_path / "ours.png"), x)


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("row_filter", [0, 1, 2, 3, 4])
def test_to_png_row_filters(tmp_path, channels, row_filter):
    """to_png under each row filter: the file equals the test's own
    encoder's, and both from_png and Pillow read the pixels back exactly."""
    x = pixels(10 + channels, (11, 19, channels))
    path = t_image.to_png(torch.from_numpy(x).float() / 127.5 - 1,
                          tmp_path / "x.png", row_filter)
    want = write_png(tmp_path / "w.png", x, [row_filter])
    assert path.read_bytes() == want.read_bytes()
    assert np.array_equal(t_image.from_png(path), x)
    assert np.array_equal(np.asarray(Image.open(path)).reshape(x.shape), x)


def test_unsupported_pngs_raise(tmp_path):
    Image.fromarray(pixels(6, (8, 8, 3))).convert("P").save(tmp_path / "p.png")
    with pytest.raises(ValueError, match="palette"):
        t_image.from_png(tmp_path / "p.png")
    Image.fromarray(pixels(7, (8, 8)).astype(np.uint16) * 257).save(
        tmp_path / "d16.png")
    with pytest.raises(ValueError, match="bit depth 16"):
        t_image.from_png(tmp_path / "d16.png")
    write_png(tmp_path / "i.png", pixels(8, (8, 8, 3)), [0], interlace=1)
    with pytest.raises(ValueError, match="interlaced"):
        t_image.from_png(tmp_path / "i.png")
    (tmp_path / "n.png").write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="not a PNG"):
        t_image.from_png(tmp_path / "n.png")
    good = write_png(tmp_path / "c.png", pixels(9, (8, 8, 3)), [0]).read_bytes()
    (tmp_path / "c.png").write_bytes(good[:40] + bytes([good[40] ^ 1])
                                     + good[41:])
    with pytest.raises(ValueError, match="CRC"):
        t_image.from_png(tmp_path / "c.png")


def test_make_grid_matches_jax():
    x = np.random.default_rng(10).standard_normal((7, 5, 6, 3)).astype(np.float32)
    for nrow, padding in ((3, 0), (2, 1), (8, 2)):
        want = j_utils.make_grid(x, nrow=nrow, padding=padding, pad_value=0.5)
        got = t_image.make_grid(torch.from_numpy(x), nrow=nrow,
                                padding=padding, pad_value=0.5)
        assert np.array_equal(got.numpy(), want)


# ---- resize -----------------------------------------------------------------

@pytest.mark.parametrize("shape,size", [
    ((50, 70, 3), 32), ((300, 200, 3), 64), ((20, 30, 3), 64),
    ((33, 33, 1), 28), ((64, 64, 3), 64), ((45, 120, 3), 40)])
def test_resize_center_crop_matches_pillow(shape, size):
    """The JAX package's Pillow BICUBIC resize + center crop against the
    port's antialiased bicubic in torch, on seeded noise (the steepest
    input): at most 2/255 apart; an image already at its size is the same
    image."""
    x = pixels(11, shape)
    pil = Image.fromarray(x[..., 0] if shape[-1] == 1 else x)
    want = j_data._resize_center_crop(pil, size)
    got = t_data.resize_center_crop(x, size)
    assert got.shape == want.shape == (size, size, shape[-1])
    err = np.abs(got - want).max()
    assert err <= RESIZE_TOL + 1e-7, err
    if shape[:2] == (size, size):
        assert err == 0


# ---- datasets ---------------------------------------------------------------

@pytest.mark.parametrize("num_classes,channels", [(0, 3), (10, 3), (4, 1)])
def test_synthetic_dataset_matches_jax(num_classes, channels):
    want = j_data.SyntheticDataset(24, channels, num_classes, 50, seed=3)
    got = t_data.SyntheticDataset(24, channels, num_classes, 50, seed=3)
    assert len(got) == len(want)
    for i in (0, 1, 17, 49):
        a, b = got[i], want[i]
        assert a.keys() == b.keys()
        assert np.array_equal(a["image"], b["image"])
        assert a.get("class") == b.get("class")


def _write_idx(path, array, gz):
    body = struct.pack(">HBB", 0, 8, array.ndim) + struct.pack(
        f">{array.ndim}I", *array.shape) + array.tobytes()
    if gz:
        with gzip.open(str(path) + ".gz", "wb") as f:
            f.write(body)
    else:
        path.write_bytes(body)


@pytest.mark.parametrize("gz", [False, True])
def test_mnist_matches_jax(tmp_path, gz):
    """Raw IDX files (plain and gzipped, under raw/): exact at 28, the
    resize at 32 within 2/255."""
    raw = tmp_path / "raw"
    raw.mkdir()
    _write_idx(raw / "train-images-idx3-ubyte", pixels(12, (20, 28, 28)), gz)
    _write_idx(raw / "train-labels-idx1-ubyte",
               pixels(13, (20,)) % 10, gz)
    for size, tol in ((28, 0.0), (32, RESIZE_TOL + 1e-7)):
        want = j_data.MNISTDataset(tmp_path, size)
        got = t_data.MNISTDataset(tmp_path, size)
        assert len(got) == len(want) == 20
        for i in (0, 7, 19):
            assert got[i]["class"] == want[i]["class"]
            assert got[i]["image"].shape == want[i]["image"].shape == (size, size, 1)
            assert np.abs(got[i]["image"] - want[i]["image"]).max() <= tol


def test_cifar10_matches_jax(tmp_path):
    """Five pickled batches of the python format: exact at 32, the resize
    at 24 within 2/255."""
    base = tmp_path / "cifar-10-batches-py"
    base.mkdir()
    for i in range(1, 6):
        with open(base / f"data_batch_{i}", "wb") as f:
            pickle.dump({b"data": pixels(20 + i, (4, 3072)),
                         b"labels": list(range(i, i + 4))}, f)
    for size, tol in ((32, 0.0), (24, RESIZE_TOL + 1e-7)):
        want = j_data.CIFAR10Dataset(tmp_path, size)
        got = t_data.CIFAR10Dataset(tmp_path, size)
        assert len(got) == len(want) == 20
        for i in range(0, 20, 3):
            assert got[i]["class"] == want[i]["class"]
            assert np.abs(got[i]["image"] - want[i]["image"]).max() <= tol


def test_image_folders_match_jax(tmp_path):
    """imagefolder and imagefolder-class over PNGs of every colour type (some
    at the size, some resized): the same order, classes and images, exact
    where nothing is resampled."""
    for k, (cls, shape) in enumerate([("b", (16, 16, 3)), ("a", (16, 16, 1)),
                                      ("a", (16, 16, 4)), ("b", (20, 24, 2)),
                                      ("c", (40, 30, 3))]):
        (tmp_path / cls).mkdir(exist_ok=True)
        write_png(tmp_path / cls / f"{k}.png", pixels(30 + k, shape), [k % 5])
    for t_cls, j_cls in ((t_data.FolderOfImages, j_data.FolderOfImages),
                         (t_data.ImageFolderWithClasses,
                          j_data.ImageFolderWithClasses)):
        want, got = j_cls(tmp_path, 16), t_cls(tmp_path, 16)
        assert len(got) == len(want) == 5
        for i in range(5):
            a, b = got[i], want[i]
            assert a.get("class") == b.get("class")
            assert a["image"].shape == b["image"].shape == (16, 16, 3)
            resized = Image.open(want.image_path(i)).size != (16, 16)
            assert np.abs(a["image"] - b["image"]).max() <= (
                RESIZE_TOL + 1e-7 if resized else 0.0)


@pytest.mark.parametrize("name", ["x.jpg", "x.JPEG", "x.webp", "x.bmp"])
def test_other_formats_raise(tmp_path, name):
    (tmp_path / "a").mkdir()
    write_png(tmp_path / "a" / "ok.png", pixels(40, (8, 8, 3)), [0])
    (tmp_path / "a" / name).write_bytes(b"\xff\xd8\xff")
    fmt = name.split(".")[1].upper()
    for cls in (t_data.FolderOfImages, t_data.ImageFolderWithClasses):
        with pytest.raises(ValueError, match=f"{fmt} images wait for a decoder"):
            cls(tmp_path, 8)


def test_make_dataset(tmp_path):
    with pytest.raises(NotImplementedError, match="datasets package"):
        t_data.make_dataset({"type": "huggingface", "location": "x/y"}, 32)
    with pytest.raises(ValueError, match="Invalid dataset type"):
        t_data.make_dataset({"type": "lmdb"}, 32)
    ds = t_data.make_dataset({"type": "synthetic", "num_classes": 3,
                              "length": 9}, 16)
    assert len(ds) == 9 and ds[0]["image"].shape == (16, 16, 3)
    (tmp_path / "custom.py").write_text(
        "def get_dataset(config, size):\n"
        "    return [{'image': size, 'config': config}]\n")
    ds = t_data.make_dataset({"type": "custom", "location": "custom.py",
                              "config": {"k": 1}}, 12, config_dir=tmp_path)
    assert ds == [{"image": 12, "config": {"k": 1}}]


# ---- the loader -------------------------------------------------------------

class Indices:
    """Item i is an image holding i, with class i % 7."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"image": np.full((2, 2, 1), i, np.float32), "class": i % 7}


def order(loader):
    return [(b["image"][:, 0, 0, 0].astype(int).tolist(), b["class"].tolist())
            for b in loader]


@pytest.mark.parametrize("start_batch", [0, 3, 10, 11])
def test_loader_order_matches_jax(start_batch):
    """Three epochs of 103 items in batches of 10 (drop-last) with the same
    seed: the same indices and classes in every batch, the epoch counter
    advancing; ``start_batch`` skips that many batches of the next epoch
    only."""
    want = j_data.DataLoader(Indices(103), 10, seed=5, num_workers=3)
    got = t_data.DataLoader(Indices(103), 10, seed=5, num_workers=3)
    assert len(got) == len(want) == 10
    for loader in (want, got):
        loader.epoch = 2
        loader.start_batch = start_batch
    for _ in range(3):
        a, b = order(got), order(want)
        assert a == b and got.epoch == want.epoch
    assert len(a) == 10 and got.epoch == 5
    batch = next(iter(got))
    assert batch["image"].dtype == np.float32 and batch["class"].dtype == np.int32


def test_loader_raises_what_a_worker_raised():
    class Broken(Indices):
        def __getitem__(self, i):
            if i == 3:
                raise OSError("unreadable item 3")
            return super().__getitem__(i)

    with pytest.raises(OSError, match="item 3"):
        for _ in t_data.DataLoader(Broken(20), 4, num_workers=2):
            pass
